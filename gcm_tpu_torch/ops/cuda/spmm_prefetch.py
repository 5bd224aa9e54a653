"""Per-edge SpMM over sink-block buckets (counterpart of
gcm_tpu/ops/pallas/spmm_prefetch.py):

    out[b, j*S + sl_k] += w_k * x[b, src_k]   for the K slots k of block j

with S = num_nodes / n_blocks. `bucket_edges_sink_blocks` gives each sink
block its edges, in lane order, with the sink local to the block: sl, src
[B,n_blocks,K] int32 and w [B,n_blocks,K] (empty slots sl = -1, src = 0,
w = 0), and counts the edges dropped past K. The TPU kernel left an index
out of range undefined; here a source is clamped into 0..N-1 (as its
interpret mode and gather_nodes do) and a slot whose local sink lies
outside 0..S-1 adds nothing, where the interpret mode wrote the block's
last row. Each row is summed in float32 slot after slot, as the TPU
kernel added it; the kernel sorts a block's slots by local sink (stably) and
sums each row in that order, for any number of rows per block.

`spmm_prefetch_bucketed` launches csrc/spmm_prefetch.cu for CUDA tensors,
or raises, and takes the plain version, `spmm_prefetch_plain`, only for
CPU tensors; `spmm_prefetch` buckets and calls it. Forward only, as in the
JAX package (which gave it no gradient).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from gcm_tpu_torch.ops import _build
from gcm_tpu_torch.ops.cuda._launch import (
    check_cuda, check_forward_only, check_rc, ptr, refuse_export, stream_of)
from gcm_tpu_torch.ops.scatter import in_order_slots, in_order_sum


def spmm_prefetch_plain(x, sl, src, w, num_nodes: int,
                        depth: int | None = None):
    """The kernel's function in plain PyTorch, each row summed slot after
    slot in float32 as the kernel sums it. depth: the most slots into one
    row, which the caller may know; else found with a host wait."""
    B, N, F = x.shape
    nblk, K = sl.shape[1], sl.shape[2]
    S = num_nodes // nblk
    ok = (sl >= 0) & (sl < S)
    rows = torch.clamp(src.long(), 0, N - 1).reshape(B, -1, 1)
    msgs = torch.gather(x, 1, rows.expand(-1, -1, F))
    msgs = msgs * w.reshape(B, -1, 1).to(x.dtype)
    j = torch.arange(nblk, device=x.device)[:, None]
    dest = torch.where(ok, j * S + sl.long(), -1).reshape(B, -1)
    return in_order_sum(msgs, in_order_slots(dest, num_nodes, depth))


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("spmm_prefetch")
    vp, ip = ctypes.c_void_p, ctypes.c_int
    lib.gcm_spmm_prefetch_f32.argtypes = [vp, vp, vp, vp, vp, ip, ip, ip, ip,
                                          ip, ip, ip, vp]
    lib.gcm_spmm_prefetch_f32.restype = ip
    return lib


def _launch(x, sl, src, w, num_nodes):
    B, N, F = x.shape
    nblk, K = sl.shape[1], sl.shape[2]
    S = num_nodes // nblk
    if not 1 <= B <= 65535 or min(N, F, K) < 1 or nblk > 65535:
        raise ValueError(f"the kernel takes 1 <= B, n_blocks <= 65535 and N,"
                         f" F, K >= 1; got B={B} n_blocks={nblk} N={N} F={F}"
                         f" K={K}")
    dev = x.device
    check_cuda("x", x, (B, N, F), dev)
    check_cuda("sl", sl, (B, nblk, K), dev, torch.int32)
    check_cuda("src", src, (B, nblk, K), dev, torch.int32)
    check_cuda("w", w, (B, nblk, K), dev)
    out = torch.empty((B, num_nodes, F), device=dev, dtype=torch.float32)
    rc = _lib().gcm_spmm_prefetch_f32(ptr(x), ptr(sl), ptr(src), ptr(w),
                                      ptr(out), B, N, F, S, nblk, K,
                                      dev.index, stream_of(dev))
    check_rc("spmm_prefetch", rc)
    spmm_prefetch.launches += 1
    return out


def spmm_prefetch_bucketed(x, sl, src, w, num_nodes: int):
    """x [B,N,F] and the slots of `bucket_edges_sink_blocks` ->
    [B,num_nodes,F]. CUDA tensors launch the kernel (or raise); CPU tensors
    take the plain version."""
    if x.dim() != 3 or sl.dim() != 3 or sl.shape[0] != x.shape[0]:
        raise ValueError(f"x must be [B, N, F] and sl [B, n_blocks, K], got "
                         f"{tuple(x.shape)} and {tuple(sl.shape)}")
    nblk = sl.shape[1]
    if nblk < 1 or num_nodes % nblk:
        raise ValueError(f"num_nodes={num_nodes} must be a multiple of "
                         f"n_blocks={nblk}")
    check_forward_only(x, w)
    if x.device.type == "cpu":
        return spmm_prefetch_plain(x, sl, src, w, num_nodes)
    return _launch(x, sl, src, w, num_nodes)


def spmm_prefetch(x, edges, weights, num_nodes: int | None = None,
                  n_blocks: int = 4):
    """out[b, i] = sum over e with sink_e = i of w_e * x[b, src_e], through
    the sink-block buckets (lossless: K = E). x [B,N,F], edges [B,2,E],
    weights [B,E] -> [B,num_nodes,F]."""
    refuse_export("spmm_prefetch")
    if num_nodes is None:
        num_nodes = x.shape[1]
    sl, src, w, _ = bucket_edges_sink_blocks(edges, weights, num_nodes,
                                             n_blocks)
    return spmm_prefetch_bucketed(x, sl, src, w, num_nodes)


spmm_prefetch.launches = 0  # kernel launches, for callers to read and reset


def bucket_edges_sink_blocks(edges, weights, num_nodes: int, n_blocks: int,
                             cap: int | None = None):
    """Padded edge list [B,2,E] -> (sl, src [B,n_blocks,K] int32, w
    [B,n_blocks,K], dropped [B] int32), K = min(cap or E, E). A valid edge
    (sink and source >= 0) goes to block clamp(sink // S, 0, n_blocks-1),
    the blocks' edges in lane order; sl = sink - j*S, -1 in empty slots.
    dropped counts the valid edges past K."""
    B, _, E = edges.shape
    K = min(E if cap is None else cap, E)
    S = num_nodes // n_blocks
    sink = edges[:, 0, :]
    valid = (sink >= 0) & (edges[:, 1, :] >= 0)
    blk = torch.where(valid, torch.clamp(sink // S, 0, n_blocks - 1),
                      n_blocks)
    sls, srcs, ws = [], [], []
    kept = torch.zeros(B, dtype=torch.int32, device=edges.device)
    for j in range(n_blocks):
        m = blk == j
        # a stable sort of "not in block j" puts block j's lanes first, in
        # lane order
        order = torch.argsort((~m).to(torch.int8), dim=-1,
                              stable=True)[:, :K]
        ok = torch.gather(m, 1, order)
        sls.append(torch.where(ok, torch.gather(sink, 1, order) - j * S, -1))
        srcs.append(torch.where(ok, torch.gather(edges[:, 1, :], 1, order),
                                0))
        ws.append(torch.where(ok, torch.gather(weights, 1, order), 0.0))
        kept += ok.sum(-1, dtype=torch.int32)
    total = valid.sum(-1, dtype=torch.int32)
    return (torch.stack(sls, 1).to(torch.int32),
            torch.stack(srcs, 1).to(torch.int32), torch.stack(ws, 1),
            total - kept)
