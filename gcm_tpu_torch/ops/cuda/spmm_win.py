"""Sink-window bucketed SpMM (counterpart of the experiment
benchmarks/spmm_variants.py::pallas_win and its bucket_by_sink_window):

    out[b, k*128 + r] = sum over the lanes e of segment k, in lane order,
                        with sink_e - k*128 = r and 0 <= src_e < N,
                        of w_e * x[b, src_e]

over an edge list routed by `bucket_by_sink_window` into one segment of
`cap` lanes per window of W_WIN = 128 sink rows: bedges [B,2,n_win*cap]
int32, bweights [B,n_win*cap], segment k in lanes k*cap .. k*cap+cap-1,
empty lanes -1 with weight 0, n_win = N / 128. As in the Pallas kernel's
one-hots, a source outside 0..N-1 and a sink outside its segment's window
add nothing. float32 computes each message w * x and each add rounded once;
bfloat16 rounds x to bf16 as it is read and each message to bf16 before the
float32 sum, the two rounding points of the experiment's bf16 matmuls.

`spmm_win` launches csrc/spmm_win.cu for CUDA tensors, or raises, and takes
the plain version, `spmm_win_plain`, only for CPU tensors. Forward only, as
in JAX (the experiment has no gradient). The layout helper is plain torch.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from gcm_tpu_torch.ops import _build
from gcm_tpu_torch.ops.cuda._launch import (
    check_cuda, check_forward_only, check_rc, ptr, refuse_export, stream_of)
from gcm_tpu_torch.ops.cuda.spmm import _is_bf16, spmm_onehot_dtype_plain
from gcm_tpu_torch.ops.scatter import bucket_rank, edge_mask

W_WIN = 128  # sink rows per window
E_BLK = 512  # the Pallas kernel's lane block: a larger cap is whole blocks


def bucket_by_sink_window(edges, weights, num_nodes: int, win: int = W_WIN,
                          cap: int | None = None):
    """Padded edge list [B,2,E] -> (bedges [B,2,n_win*cap] int32, bweights
    [B,n_win*cap], counts [B,n_win] int32), n_win = num_nodes // win. A
    valid lane (sink and source >= 0) with its sink in window k goes to
    segment k at its rank among that window's lanes in lane order; lanes
    past cap are dropped, and counts holds every valid lane of the window.
    cap defaults to E (nothing is dropped)."""
    B, _, E = edges.shape
    n_win = num_nodes // win
    cap = E if cap is None else cap
    if n_win < 1 or cap < 1:
        raise ValueError(f"need num_nodes >= win and cap >= 1; got "
                         f"num_nodes={num_nodes} win={win} cap={cap}")
    dev = edges.device
    sink = edges[:, 0, :].long()
    ok = edge_mask(edges) & (sink < n_win * win)
    key = torch.where(ok, sink // win, n_win)
    rank = bucket_rank(key).long()
    # one flat buffer for all batches, its trash slot after them
    base = torch.arange(B, device=dev)[:, None] * (n_win * cap)
    dest = torch.where(ok & (rank < cap), base + key * cap + rank,
                       B * n_win * cap)
    be = torch.full((2, B * n_win * cap + 1), -1, dtype=torch.int32,
                    device=dev)
    be[0, dest] = edges[:, 0, :].to(torch.int32)
    be[1, dest] = edges[:, 1, :].to(torch.int32)
    bw = torch.zeros(B * n_win * cap + 1, dtype=weights.dtype, device=dev)
    bw[dest] = weights
    counts = torch.zeros((B, n_win + 1), dtype=torch.int32, device=dev)
    counts.scatter_add_(1, key, torch.ones_like(key, dtype=torch.int32))
    bedges = be[:, :-1].reshape(2, B, n_win * cap).transpose(0, 1)
    return (bedges.contiguous(), bw[:-1].view(B, n_win * cap),
            counts[:, :n_win].contiguous())


def window_overflow(counts, cap: int) -> str | None:
    """A message if any window held more than cap lanes (the bucketing
    dropped some), else None."""
    most = int(torch.as_tensor(counts).max()) if counts.numel() else 0
    return (f"sink-window overflow: max window count {most} > cap {cap}"
            if most > cap else None)


def check_layout(x, bedges, bweights, num_nodes: int, cap: int) -> None:
    """The window layout's shape contract: N a positive multiple of 128 (the
    Pallas kernel leaves the rows past the last whole window unwritten), a
    cap above 512 a multiple of 512 (the Pallas kernel's lane blocks), and
    n_win*cap lanes."""
    if x.dim() != 3 or x.shape[1] != num_nodes:
        raise ValueError(f"x {tuple(x.shape)} must be [B, {num_nodes}, F]")
    if num_nodes < W_WIN or num_nodes % W_WIN:
        raise ValueError(f"num_nodes={num_nodes} must be a positive multiple "
                         f"of {W_WIN}")
    if cap < 1 or (cap > E_BLK and cap % E_BLK):
        raise ValueError(f"cap={cap} must be in 1..{E_BLK} or a multiple of "
                         f"{E_BLK}")
    B = x.shape[0]
    lanes = num_nodes // W_WIN * cap
    if tuple(bedges.shape) != (B, 2, lanes) or \
            tuple(bweights.shape) != (B, lanes):
        raise ValueError(f"bedges must be [{B}, 2, {lanes}] and bweights "
                         f"[{B}, {lanes}] for N={num_nodes}, cap={cap}; got "
                         f"{tuple(bedges.shape)} and "
                         f"{tuple(bweights.shape)}")


def in_window(bedges, num_nodes: int, cap: int):
    """bedges with the sink of every lane outside its segment's window set
    to -1: the edge list whose SpMM is the windowed one."""
    B = bedges.shape[0]
    n_win = num_nodes // W_WIN
    e = bedges.reshape(B, 2, n_win, cap)
    lo = torch.arange(n_win, device=bedges.device)[:, None] * W_WIN
    sink = torch.where((e[:, 0] >= lo) & (e[:, 0] < lo + W_WIN), e[:, 0], -1)
    return torch.stack([sink, e[:, 1]], 1).reshape(B, 2, -1)


def spmm_win_plain(x, bedges, bweights, num_nodes: int, cap: int,
                   dtype=torch.float32, depth: int | None = None):
    """The kernel's function in plain PyTorch, each output summed in lane
    order as the kernel sums it: the one-hot SpMM of the lanes that stay in
    their window. depth: the most lanes into one sink, which the caller may
    know (ops/scatter.py::in_order_slots); else found with a host wait."""
    return spmm_onehot_dtype_plain(x, in_window(bedges, num_nodes, cap),
                                   bweights, dtype, depth)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("spmm_win")
    vp, ip = ctypes.c_void_p, ctypes.c_int
    lib.gcm_spmm_win.argtypes = [vp, vp, vp, vp, ip, ip, ip, ip, ip, ip, vp]
    lib.gcm_spmm_win.restype = ip
    return lib


def spmm_win(x, bedges, bweights, num_nodes: int, cap: int,
             dtype=torch.float32):
    """x [B,N,F], bedges/bweights from `bucket_by_sink_window` at this cap
    -> [B,N,F] float32, forward only. CUDA tensors launch the kernel (or
    raise); CPU tensors take the plain version."""
    refuse_export("spmm_win")
    bf16 = _is_bf16(dtype)
    check_layout(x, bedges, bweights, num_nodes, cap)
    check_forward_only(x, bweights)
    if x.device.type == "cpu":
        return spmm_win_plain(x, bedges, bweights, num_nodes, cap, dtype)
    B, N, F = x.shape
    if not 1 <= B <= 65535 or F < 1:
        raise ValueError(f"the kernel takes 1 <= B <= 65535 and F >= 1; got "
                         f"B={B} F={F}")
    dev = x.device
    lanes = bedges.shape[2]
    check_cuda("x", x, (B, N, F), dev)
    check_cuda("bedges", bedges, (B, 2, lanes), dev, torch.int32)
    check_cuda("bweights", bweights, (B, lanes), dev)
    out = torch.empty((B, N, F), device=dev, dtype=torch.float32)
    rc = _lib().gcm_spmm_win(ptr(x), ptr(bedges), ptr(bweights), ptr(out),
                             B, N, F, cap, int(bf16), dev.index,
                             stream_of(dev))
    check_rc("spmm_win", rc)
    spmm_win.launches += 1
    return out


spmm_win.launches = 0  # kernel launches, for callers to read and reset
