"""Pair-window bucketed SpMM (counterpart of gcm_tpu/ops/pallas/spmm2.py):

    out[b, i] = sum over lanes e with sink_e = i of w_e * x[b, src_e]

over an edge list grouped into (sink window ks, source window kc) pair
buckets of W = 128 nodes by `bucket_edges_pairs`: bedges [B,2,P*cap] int32,
bweights [B,P*cap], P = (N/W)^2, bucket p = ks*nw + kc in lanes
p*cap .. p*cap+cap-1, empty lanes -1 with weight 0. Edges beyond a bucket's
capacity are dropped; `check_bucket_overflow` raises on the counts. As in
the Pallas kernel, a lane adds only to a sink inside its bucket's sink
window (a sink of N or more drops out) and reads its source clamped into
the source window (a source of N or more reads row N - 1): the edge-list
kernel (ops/cuda/spmm.py) drops such a source instead.

Precision 'f32x2' computes in float32 (the TPU's hi+lo bf16 pair
approximated a float32 sum); 'bf16' rounds each message w * x to bf16
before a float32 sum, as the TPU kernel's single bf16 pass did. Both add in
lane order, the kernel and its plain version alike.

`spmm_pairs_T(xT, ...)` is the kernel's entry in the transposed [B,F,N]
layout of the JAX package, forward only; `spmm_pairs(x, ...)` takes
[B,N,F] and is differentiable in x and bweights: its backward launches the
same kernel on the `transpose_pairs` layout for dx and takes dw, the
gather-dot sum_f g[sink] * x[src], from the edge weight-gradient kernel
(ops/cuda/edge_grad.py; XLA computed it in the JAX package). CUDA tensors
launch csrc/spmm_pairs.cu, or raise; CPU tensors take the plain version,
`spmm_pairs_plain`. The layout helpers are plain torch, as they were XLA.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from gcm_tpu_torch.ops import _build
from gcm_tpu_torch.ops.cuda._launch import (
    check_cuda, check_forward_only, check_rc, ptr, refuse_export, stream_of)
from gcm_tpu_torch.ops.cuda.edge_grad import edge_weight_grad
from gcm_tpu_torch.ops.scatter import (bucket_rank, edge_mask, in_order_slots,
                                      in_order_sum)

W = 128  # node window
PRECISIONS = ("f32x2", "bf16")


def check_layout(N: int, cap: int) -> None:
    """The pair layout's shape contract (spmm_seg's layout too)."""
    if N < W or N % W:
        raise ValueError(f"num_nodes={N} must be a positive multiple of {W}")
    if cap < W or cap % W:
        raise ValueError(f"cap={cap} must be a positive multiple of {W}")


def _check_precision(precision: str) -> bool:
    """True for the bf16 mode."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; one of "
                         f"{PRECISIONS}")
    return precision == "bf16"


def spmm_pairs_plain(x, bedges, bweights, cap: int, precision="f32x2",
                     depth: int | None = None):
    """x [B,N,F] -> [B,N,F], in plain (differentiable) PyTorch, each output
    summed in lane order as the kernel sums it. depth: the most lanes into
    one sink, which the caller may know (ops/scatter.py::in_order_slots);
    else found with a host wait."""
    bf16 = _check_precision(precision)
    B, N, F = x.shape
    nw = N // W
    e5 = bedges.reshape(B, 2, nw, nw, cap).long()
    ks = torch.arange(nw, device=x.device)[:, None, None]
    kc = torch.arange(nw, device=x.device)[None, :, None]
    sink = e5[:, 0]
    ok = (sink >= ks * W) & (sink < ks * W + W)
    src = kc * W + torch.clamp(e5[:, 1] - kc * W, 0, W - 1)
    msgs = torch.gather(x, 1, src.reshape(B, -1, 1).expand(-1, -1, F))
    msgs = msgs * bweights.reshape(B, -1, 1).to(x.dtype)
    if bf16:
        msgs = msgs.to(torch.bfloat16).to(x.dtype)
    dest = torch.where(ok, sink, -1).reshape(B, -1)
    return in_order_sum(msgs, in_order_slots(dest, N, depth))


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("spmm_pairs")
    vp, ip = ctypes.c_void_p, ctypes.c_int
    lib.gcm_spmm_pairs.argtypes = [vp, vp, vp, vp, ip, ip, ip, ip, ip, ip, vp]
    lib.gcm_spmm_pairs.restype = ip
    return lib


def _check_args(x, bedges, bweights, cap):
    if x.dim() != 3:
        raise ValueError(f"x must be [B, N, F], got {tuple(x.shape)}")
    B, N, F = x.shape
    check_layout(N, cap)
    lanes = (N // W) ** 2 * cap
    if tuple(bedges.shape) != (B, 2, lanes) or \
            tuple(bweights.shape) != (B, lanes):
        raise ValueError(f"bedges must be [{B}, 2, {lanes}] and bweights "
                         f"[{B}, {lanes}] for N={N}, cap={cap}; got "
                         f"{tuple(bedges.shape)} and {tuple(bweights.shape)}")


def _launch(x, bedges, bweights, cap, bf16):
    B, N, F = x.shape
    if not 1 <= B <= 65535:
        raise ValueError(f"the kernel takes 1 <= B <= 65535, got B={B}")
    lanes = bedges.shape[2]
    dev = x.device
    check_cuda("x", x, (B, N, F), dev)
    check_cuda("bedges", bedges, (B, 2, lanes), dev, torch.int32)
    check_cuda("bweights", bweights, (B, lanes), dev)
    out = torch.empty((B, N, F), device=dev, dtype=torch.float32)
    rc = _lib().gcm_spmm_pairs(ptr(x), ptr(bedges), ptr(bweights), ptr(out),
                               B, N, F, cap, int(bf16), dev.index,
                               stream_of(dev))
    check_rc("spmm_pairs", rc)
    spmm_pairs.launches += 1
    return out


def _forward(x, bedges, bweights, cap, precision):
    bf16 = _check_precision(precision)
    _check_args(x, bedges, bweights, cap)
    if x.device.type == "cpu":
        return spmm_pairs_plain(x, bedges, bweights, cap, precision)
    return _launch(x, bedges, bweights, cap, bf16)


def spmm_pairs_T(xT, bedges, bweights, cap: int, precision="f32x2"):
    """Transposed-layout entry, forward only: xT [B,F,N] -> outT [B,F,N]."""
    check_forward_only(xT, bweights)
    x = xT.transpose(1, 2).contiguous()
    return _forward(x, bedges, bweights, cap, precision).transpose(1, 2)


class _SpmmPairs(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bedges, bweights, num_nodes, cap, precision):
        ctx.save_for_backward(x, bedges, bweights)
        ctx.layout = (num_nodes, cap, precision)
        return _forward(x, bedges, bweights, cap, precision)

    @staticmethod
    def backward(ctx, g):
        x, bedges, bweights = ctx.saved_tensors
        num_nodes, cap, precision = ctx.layout
        g = g.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            fe, fw = transpose_pairs(bedges, bweights, num_nodes, cap)
            dx = _forward(g, fe, fw, cap, precision)
        if ctx.needs_input_grad[2]:
            dw = edge_weight_grad(g, x, bedges).to(bweights.dtype)
        return dx, None, dw, None, None, None


def spmm_pairs(x, bedges, bweights, num_nodes: int, cap: int,
               precision: str = "f32x2"):
    """x [B,N,F], bedges/bweights from `bucket_edges_pairs` -> [B,N,F].
    Differentiable in x and bweights. N = num_nodes and cap must be
    multiples of 128. CUDA tensors launch the kernel (or raise); CPU
    tensors take the plain version."""
    refuse_export("spmm_pairs")
    if x.dim() != 3 or x.shape[1] != num_nodes:
        raise ValueError(f"x {tuple(x.shape)} must be [B, {num_nodes}, F]")
    return _SpmmPairs.apply(x, bedges, bweights, num_nodes, cap, precision)


spmm_pairs.launches = 0  # kernel launches, for callers to read and reset


def bucket_edges_pairs(edges, weights, num_nodes: int, cap: int):
    """Padded edge list [B,2,E] -> (bedges [B,2,P*cap] int32, bweights
    [B,P*cap], counts [B,P] int32), P = (num_nodes/W)^2. Each valid edge
    (sink and source >= 0) goes to bucket (sink // W, src // W), both
    clamped into 0..nw-1, at its rank among the bucket's edges in lane
    order; edges past a bucket's cap are dropped, and counts holds every
    valid edge of the bucket."""
    check_layout(num_nodes, cap)
    B, _, E = edges.shape
    nw = num_nodes // W
    P = nw * nw
    dev = edges.device
    valid = edge_mask(edges)
    sink = edges[:, 0, :].long()
    src = edges[:, 1, :].long()
    ks = torch.clamp(sink // W, 0, nw - 1)
    kc = torch.clamp(src // W, 0, nw - 1)
    pair = torch.where(valid, ks * nw + kc, P)
    rank = bucket_rank(pair).long()
    # one flat buffer for all batches, its trash slot after them
    base = torch.arange(B, device=dev)[:, None] * (P * cap)
    dest = torch.where(valid & (rank < cap), base + pair * cap + rank,
                       B * P * cap)
    be = torch.full((2, B * P * cap + 1), -1, dtype=torch.int32, device=dev)
    be[0, dest] = edges[:, 0, :].to(torch.int32)
    be[1, dest] = edges[:, 1, :].to(torch.int32)
    bw = torch.zeros(B * P * cap + 1, dtype=weights.dtype, device=dev)
    bw[dest] = weights
    counts = torch.zeros((B, P + 1), dtype=torch.int32, device=dev)
    counts.scatter_add_(1, pair, torch.ones_like(pair, dtype=torch.int32))
    bedges = be[:, :-1].reshape(2, B, P * cap).transpose(0, 1).contiguous()
    return bedges, bw[:-1].view(B, P * cap), counts[:, :P].contiguous()


def check_bucket_overflow(counts, cap: int) -> None:
    """Raise if any pair bucket held more than cap edges (some were
    dropped by the bucketing)."""
    c = torch.as_tensor(counts)
    if bool((c > cap).any()):
        raise ValueError(
            f"pair-bucket overflow: max bucket count {int(c.max())} > cap "
            f"{cap}; raise cap (or aggregate with ops.dispatch.spmm)")


def transpose_pairs(bedges, bweights, num_nodes: int, cap: int):
    """The bucketed layout of the transposed graph (sink and source
    swapped): pair (ks, kc) -> (kc, ks), a reshape with no re-bucketing."""
    B = bedges.shape[0]
    nw = num_nodes // W
    e5 = bedges.reshape(B, 2, nw, nw, cap).flip(1).transpose(2, 3)
    w4 = bweights.reshape(B, nw, nw, cap).transpose(1, 2)
    return e5.reshape(B, 2, -1).contiguous(), w4.reshape(B, -1).contiguous()
