"""Sink-sorted segmented SpMM (counterpart of gcm_tpu/ops/pallas/spmm_seg.py):

    out[b, i] = sum over lanes e with sink_e = i of w_e * x[b, src_e]

over the pair buckets of ops/cuda/spmm2.py (W = 128, capacity cap), with
the edges of each bucket sorted by sink and cut into chunks of 128 lanes.
`bucket_edges_segments` builds that layout and the tables begin/end
[B,P,cap/128,W] int32 that give each sink lane of the bucket's sink window
its segment [begin, end) inside each chunk. The sum reads the sources, the
weights and the tables, never the sink row, as the Pallas kernel does; a
source outside its bucket's source window is clamped into it. Edges beyond
a bucket's capacity are dropped (the totals are returned for the check).

`spmm_seg_T(xT, ...)` is the kernel's entry in the transposed [B,F,N]
layout of the JAX package, forward only; `spmm_seg(x, ...)` takes [B,N,F]
and is differentiable in x and bweights. Its backward takes dx through
ops/dispatch.py::spmm on the flipped edge list (on the card the
spmm_edge_list kernel) and dw from the edge weight-gradient kernel
(ops/cuda/edge_grad.py). CUDA tensors launch csrc/spmm_seg.cu, or raise; CPU tensors
take the plain version, `spmm_seg_plain`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from gcm_tpu_torch.ops import _build
from gcm_tpu_torch.ops.cuda._launch import (
    check_cuda, check_forward_only, check_rc, ptr, refuse_export, stream_of)
from gcm_tpu_torch.ops.cuda.edge_grad import edge_weight_grad
from gcm_tpu_torch.ops.cuda.spmm2 import W, check_layout
from gcm_tpu_torch.ops.scatter import bucket_rank, edge_mask, in_order_sum

C = 128  # lanes per chunk


def spmm_seg_plain(x, bedges, bweights, begin, end, cap: int,
                   depth: int | None = None):
    """x [B,N,F] -> [B,N,F], in plain (differentiable) PyTorch, each sink
    summed in the kernel's order: its segment [max(begin, 0), min(end, C))
    of every chunk of its window's buckets, kc ascending, chunks in order.
    depth: the most lanes into one sink, which the caller may know; else
    found with a host wait."""
    B, N, F = x.shape
    nw, nch = N // W, cap // C
    kc = torch.arange(nw, device=x.device)[None, :, None]
    src = bedges[:, 1, :].reshape(B, nw, nw, cap).long()
    src = kc * W + torch.clamp(src - kc * W, 0, W - 1)
    msgs = torch.gather(x, 1, src.reshape(B, -1, 1).expand(-1, -1, F))
    msgs = msgs * bweights.reshape(B, -1, 1).to(x.dtype)
    return in_order_sum(msgs, _segment_slots(begin, end, N, cap, depth))


def _segment_slots(begin, end, num_nodes: int, cap: int,
                  depth: int | None = None):
    """The lanes each sink's segments cover, in the kernel's order, as
    ops/scatter.py::in_order_slots gives them: [B, N, depth] int64, padded
    with the lane count."""
    B, P, nch, _ = begin.shape
    nw = num_nodes // W
    lo = torch.clamp(begin.long(), min=0)
    lens = torch.clamp(torch.clamp(end.long(), max=C) - lo, min=0)
    chunk0 = torch.arange(P * nch, device=begin.device).reshape(P, nch, 1) * C
    first = chunk0 + lo  # the segment's first lane

    def by_sink(t):  # [B, ks, kc, nch, s] -> [B, ks*W + s, (kc, nch)]
        t = t.reshape(B, nw, nw, nch, W).permute(0, 1, 4, 2, 3)
        return t.reshape(B, num_nodes, nw * nch)

    lens, first = by_sink(lens), by_sink(first)
    ends = torch.cumsum(lens, dim=-1)
    if depth is None:
        depth = int(ends[..., -1].max())
    pos = torch.arange(depth, device=begin.device).expand(B, num_nodes, depth)
    seg = torch.searchsorted(ends, pos.contiguous(), right=True)
    k = torch.clamp(seg, max=nw * nch - 1)
    lane = (torch.gather(first, 2, k) + pos
            - torch.gather(ends - lens, 2, k))
    return torch.where(seg < nw * nch, lane, P * cap)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("spmm_seg")
    vp, ip = ctypes.c_void_p, ctypes.c_int
    lib.gcm_spmm_seg_f32.argtypes = [vp, vp, vp, vp, vp, vp, ip, ip, ip, ip,
                                     ip, vp]
    lib.gcm_spmm_seg_f32.restype = ip
    return lib


def _check_args(x, bedges, bweights, begin, end, cap):
    if x.dim() != 3:
        raise ValueError(f"x must be [B, N, F], got {tuple(x.shape)}")
    B, N, F = x.shape
    check_layout(N, cap)
    P = (N // W) ** 2
    want = {"bedges": (B, 2, P * cap), "bweights": (B, P * cap),
            "begin": (B, P, cap // C, W), "end": (B, P, cap // C, W)}
    for name, t in zip(want, (bedges, bweights, begin, end)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name}: expected shape {want[name]} for "
                             f"N={N}, cap={cap}, got {tuple(t.shape)}")


def _launch(x, bedges, bweights, begin, end, cap):
    B, N, F = x.shape
    if not 1 <= B <= 65535:
        raise ValueError(f"the kernel takes 1 <= B <= 65535, got B={B}")
    dev = x.device
    check_cuda("x", x, (B, N, F), dev)
    check_cuda("bedges", bedges, tuple(bedges.shape), dev, torch.int32)
    check_cuda("bweights", bweights, tuple(bweights.shape), dev)
    check_cuda("begin", begin, tuple(begin.shape), dev, torch.int32)
    check_cuda("end", end, tuple(end.shape), dev, torch.int32)
    out = torch.empty((B, N, F), device=dev, dtype=torch.float32)
    rc = _lib().gcm_spmm_seg_f32(ptr(x), ptr(bedges), ptr(bweights),
                                 ptr(begin), ptr(end), ptr(out), B, N, F,
                                 cap, dev.index, stream_of(dev))
    check_rc("spmm_seg", rc)
    spmm_seg.launches += 1
    return out


def _forward(x, bedges, bweights, begin, end, cap):
    _check_args(x, bedges, bweights, begin, end, cap)
    if x.device.type == "cpu":
        return spmm_seg_plain(x, bedges, bweights, begin, end, cap)
    return _launch(x, bedges, bweights, begin, end, cap)


def spmm_seg_T(xT, bedges, bweights, begin, end, cap: int):
    """Transposed-layout entry, forward only: xT [B,F,N] -> outT [B,F,N]."""
    check_forward_only(xT, bweights)
    x = xT.transpose(1, 2).contiguous()
    return _forward(x, bedges, bweights, begin, end, cap).transpose(1, 2)


class _SpmmSeg(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bedges, bweights, begin, end, cap):
        ctx.save_for_backward(x, bedges, bweights)
        return _forward(x, bedges, bweights, begin, end, cap)

    @staticmethod
    def backward(ctx, g):
        from gcm_tpu_torch.ops.dispatch import spmm

        x, bedges, bweights = ctx.saved_tensors
        g = g.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            flipped = bedges.flip(1).contiguous()  # sink <-> source
            dx = spmm(g, flipped, bweights)
        if ctx.needs_input_grad[2]:
            dw = edge_weight_grad(g, x, bedges).to(bweights.dtype)
        return dx, None, dw, None, None, None


def spmm_seg(x, bedges, bweights, begin, end, num_nodes: int, cap: int):
    """x [B,N,F] and the layout of `bucket_edges_segments` -> [B,N,F].
    Differentiable in x and bweights. N = num_nodes and cap must be
    multiples of 128. CUDA tensors launch the kernel (or raise); CPU
    tensors take the plain version."""
    refuse_export("spmm_seg")
    if x.dim() != 3 or x.shape[1] != num_nodes:
        raise ValueError(f"x {tuple(x.shape)} must be [B, {num_nodes}, F]")
    return _SpmmSeg.apply(x, bedges, bweights, begin, end, cap)


spmm_seg.launches = 0  # kernel launches, for callers to read and reset


def bucket_edges_segments(edges, weights, num_nodes: int, cap: int):
    """Padded edge list [B,2,E] -> (bedges [B,2,P*cap] int32, bweights
    [B,P*cap], begin, end [B,P,cap/128,W] int32, totals [B,P] int32): the
    pair buckets of `bucket_edges_pairs`, each sorted by (local) sink with
    ties in lane order, edges past cap dropped; end = the inclusive running
    count of each chunk's edges per sink lane, begin = end - count; totals
    counts every valid edge of a bucket."""
    check_layout(num_nodes, cap)
    B, _, E = edges.shape
    nw = num_nodes // W
    P = nw * nw
    nch = cap // C
    dev = edges.device
    valid = edge_mask(edges)
    sink = edges[:, 0, :].long()
    src = edges[:, 1, :].long()
    ks = torch.clamp(sink // W, 0, nw - 1)
    kc = torch.clamp(src // W, 0, nw - 1)
    pair = torch.where(valid, ks * nw + kc, P)
    sl = torch.where(valid, sink - ks * W, W)
    order = torch.argsort(pair * (W + 1) + sl, dim=-1, stable=True)

    def take(a):
        return torch.gather(a, 1, order)

    pair_s, sl_s, valid_s = take(pair), take(sl), take(valid)
    w_s = take(weights)
    rank = bucket_rank(pair_s).long()
    ok = valid_s & (rank < cap)
    base = torch.arange(B, device=dev)[:, None] * (P * cap)
    dest = torch.where(ok, base + pair_s * cap + rank, B * P * cap)
    be = torch.full((2, B * P * cap + 1), -1, dtype=torch.int32, device=dev)
    be[0, dest] = take(sink).to(torch.int32)
    be[1, dest] = take(src).to(torch.int32)
    bw = torch.zeros(B * P * cap + 1, dtype=weights.dtype, device=dev)
    bw[dest] = w_s
    # edges per (pair, chunk, sink lane); a local sink of W or more (a sink
    # of N or more) lands in the next lanes' counts or past the end, whose
    # counts are dropped
    key = (pair_s * nch + rank // C) * W + sl_s
    key = torch.where(ok, torch.clamp(key, max=P * nch * W), P * nch * W)
    cnt = torch.zeros((B, P * nch * W + 1), dtype=torch.int32, device=dev)
    cnt.scatter_add_(1, key, torch.ones_like(key, dtype=torch.int32))
    cnt = cnt[:, :-1].reshape(B, P, nch, W)
    end = torch.cumsum(cnt, dim=-1, dtype=torch.int32)
    begin = end - cnt
    tot = torch.zeros((B, P + 1), dtype=torch.int32, device=dev)
    tot.scatter_add_(1, pair, valid.to(torch.int32))
    bedges = be[:, :-1].reshape(2, B, P * cap).transpose(0, 1).contiguous()
    return (bedges, bw[:-1].view(B, P * cap), begin, end,
            tot[:, :P].contiguous())
