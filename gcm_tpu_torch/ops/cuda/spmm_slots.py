"""Sink-slot SpMM, the degree-bounded aggregation (counterpart of
gcm_tpu/ops/pallas/spmm_slots.py).

Layout (from `bucket_sink_slots`): the N nodes fall in nw = N / W windows
of W = 128. For each of the P = nw * nw pairs p = sw * nw + kc (sink window
sw, source window kc), each sink lane owns k source slots: srcs [B,P,k,W]
int32 (source index local to window kc) and ws [B,P,k,W] (0 in an empty
slot). Edges beyond a (sink, source window) bucket's k slots are dropped;
`check_slot_overflow` raises on the counts, and a selector with a
structural degree bound (TemporalEdge: k = len(hops)) never overflows.

`spmm_slots(x, srcs, ws, num_nodes, k)` -> [B,N,F] launches the
hand-written CUDA kernel (csrc/spmm_slots.cu) for CUDA tensors, or raises,
and takes the plain PyTorch version, `spmm_slots_plain`, only for CPU
tensors. Both do the same multiplies and adds in the same order, one
rounding each, so their results are bitwise equal. The layout helpers are
plain torch, as they were XLA in the JAX package.

`spmm_slots` is differentiable in x and ws, as JAX's custom VJP: a tracked
call goes through `_SpmmSlots`, whose backward rebuilds the edge list of the
layout (`layout_edges`, JAX's `_layout_edges`: a slot of weight 0 is no
edge), takes dx from the spmm_edge_list kernel on the flipped edges and dw,
only where ws carries a gradient, from
`ops/cuda/edge_grad.py::edge_weight_grad` in the layout's shape.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from gcm_tpu_torch.ops import _build
from gcm_tpu_torch.ops.cuda._launch import (
    check_cuda, check_rc, needs_grad, ptr, refuse_export, stream_of)
from gcm_tpu_torch.ops.cuda.edge_grad import edge_weight_grad
from gcm_tpu_torch.ops.cuda.spmm import spmm_edge_list
from gcm_tpu_torch.ops.scatter import bucket_rank

W = 128  # node window


def spmm_slots_plain(x, srcs, ws, k: int):
    """Sums in the kernel's order: over source windows ascending, the k
    slots of each summed first, acc + w * x one rounding per operation. A
    slot whose local source is outside 0..W-1 adds weight 0 times the
    window's row 0: nothing, for finite x."""
    B, N, F = x.shape
    nw = N // W
    xw = x.reshape(B, nw, W, F)
    s5 = srcs.reshape(B, nw, nw, k, W).long()
    w5 = ws.reshape(B, nw, nw, k, W).to(x.dtype)
    out = torch.zeros((B, nw, W, F), dtype=x.dtype, device=x.device)
    for kc in range(nw):
        win = xw[:, kc]                                  # [B, W, F]
        acc = torch.zeros_like(out)
        for c in range(k):
            s = s5[:, :, kc, c, :]                       # [B, nw, W]
            ok = (s >= 0) & (s < W)
            g = torch.gather(win, 1, torch.where(ok, s, 0).reshape(B, -1, 1)
                             .expand(-1, -1, F)).reshape(B, nw, W, F)
            acc = acc + torch.where(ok, w5[:, :, kc, c, :], 0.0)[..., None] * g
        out = out + acc
    return out.reshape(B, N, F)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("spmm_slots")
    vp, ip = ctypes.c_void_p, ctypes.c_int
    lib.gcm_spmm_slots_f32.argtypes = [vp, vp, vp, vp, ip, ip, ip, ip, ip,
                                       vp]
    lib.gcm_spmm_slots_f32.restype = ip
    return lib


def _launch(x, srcs, ws, k):
    if x.dim() != 3:
        raise ValueError(f"x must be [B, N, F], got {tuple(x.shape)}")
    B, N, F = x.shape
    if not 1 <= B <= 65535 or F < 1 or k < 1:
        raise ValueError(f"the kernel takes 1 <= B <= 65535, F >= 1 and "
                         f"k >= 1; got B={B} F={F} k={k}")
    nw = N // W
    dev = x.device
    check_cuda("x", x, (B, N, F), dev)
    check_cuda("srcs", srcs, (B, nw * nw, k, W), dev, torch.int32)
    check_cuda("ws", ws, (B, nw * nw, k, W), dev)
    out = torch.empty((B, N, F), device=dev, dtype=torch.float32)
    rc = _lib().gcm_spmm_slots_f32(ptr(x), ptr(srcs), ptr(ws), ptr(out), B,
                                   N, F, k, dev.index, stream_of(dev))
    check_rc("spmm_slots", rc)
    spmm_slots.launches += 1
    return out


def _forward(x, srcs, ws, k):
    if x.device.type == "cpu":
        return spmm_slots_plain(x, srcs, ws, k)
    return _launch(x, srcs, ws, k)


def layout_edges(srcs, ws, num_nodes: int):
    """The padded edge list [B,2,P*k*W] int32 of a slot layout and its
    weights [B,P*k*W] (JAX's `_layout_edges`): slot (p, c, lane) is the edge
    from source (p % nw) * W + srcs to sink (p // nw) * W + lane, and a slot
    of weight 0 is the sentinel -1."""
    B, P, k, _ = srcs.shape
    nw = num_nodes // W
    p = torch.arange(P, device=srcs.device)[None, :, None, None]
    lane = torch.arange(W, device=srcs.device)[None, None, None, :]
    valid = ws != 0.0
    sink = torch.where(valid, (p // nw) * W + lane, -1)
    src = torch.where(valid, (p % nw) * W + srcs, -1)
    edges = torch.stack([sink.reshape(B, -1), src.reshape(B, -1)], dim=1)
    return edges.to(torch.int32), ws.reshape(B, -1)


class _SpmmSlots(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, srcs, ws, num_nodes, k):
        ctx.num_nodes = num_nodes
        ctx.save_for_backward(x, srcs, ws)
        return _forward(x, srcs, ws, k)

    @staticmethod
    def backward(ctx, g):
        x, srcs, ws = ctx.saved_tensors
        g = g.contiguous()
        edges, flat_w = layout_edges(srcs, ws, ctx.num_nodes)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = spmm_edge_list(g, edges.flip(1).contiguous(), flat_w)
        if ctx.needs_input_grad[2]:
            dw = edge_weight_grad(g, x, edges).reshape(ws.shape).to(ws.dtype)
        return dx, None, dw, None, None


def spmm_slots(x, srcs, ws, num_nodes: int, k: int):
    """x [B,N,F], srcs/ws [B,P,k,W] from `bucket_sink_slots` -> [B,N,F].
    N = num_nodes must be a multiple of 128. Differentiable in x and ws.
    CUDA tensors launch the kernel (or raise); CPU tensors take the plain
    version."""
    refuse_export("spmm_slots")
    if x.shape[1] != num_nodes or num_nodes % W or num_nodes < W:
        raise ValueError(f"x has {x.shape[1]} nodes; the slot layout needs "
                         f"num_nodes={num_nodes}, a multiple of {W}")
    if needs_grad(x, ws):
        return _SpmmSlots.apply(x, srcs, ws, num_nodes, k)
    return _forward(x, srcs, ws, k)


spmm_slots.launches = 0  # kernel launches, for callers to read and reset


def bucket_sink_slots(edges, weights, num_nodes: int, k: int):
    """Padded edge list [B,2,E] -> the sink-slot layout: srcs [B,P,k,W]
    int32 local source indices, ws [B,P,k,W], counts [B,N,nw] int32 (the
    occupancy of each (sink, source window) bucket). Empty slots have
    weight 0. Edges beyond a bucket's k slots are dropped."""
    B, _, E = edges.shape
    nw = num_nodes // W
    P = nw * nw
    dev = edges.device
    snk = edges[:, 0, :].long()
    src = edges[:, 1, :].long()
    valid = (snk >= 0) & (src >= 0)
    kc = torch.clamp(src // W, 0, nw - 1)
    keyid = torch.where(valid, snk * nw + kc, num_nodes * nw)
    myrank = bucket_rank(keyid).long()
    p = torch.clamp(snk // W, 0, nw - 1) * nw + kc
    lane = torch.where(valid, snk, 0) % W
    # one flat buffer for all batches, its trash slot after them, so the
    # layout comes out contiguous (as the kernel takes it)
    size = P * k * W
    base = torch.arange(B, device=dev)[:, None] * size
    dest = torch.where(valid & (myrank < k),
                       base + (p * k + myrank) * W + lane, B * size)
    srcs = torch.zeros(B * size + 1, dtype=torch.int32, device=dev)
    srcs[dest] = (torch.where(valid, src, 0) % W).to(torch.int32)
    ws = torch.zeros(B * size + 1, dtype=weights.dtype, device=dev)
    ws[dest] = torch.where(valid, weights, 0.0)
    cnt = torch.zeros((B, num_nodes * nw + 1), dtype=torch.int32, device=dev)
    cnt.scatter_add_(1, torch.clamp(keyid, max=num_nodes * nw),
                     torch.ones_like(keyid, dtype=torch.int32))
    return (srcs[:-1].view(B, P, k, W), ws[:-1].view(B, P, k, W),
            cnt[:, :-1].reshape(B, num_nodes, nw))


def check_slot_overflow(counts, k: int) -> None:
    """Raise if any (sink, source window) bucket holds more than k edges."""
    c = torch.as_tensor(counts)
    if bool((c > k).any()):
        raise ValueError(
            f"sink-slot overflow: max bucket count {int(c.max())} > k={k}; "
            f"raise k (or aggregate with ops.dispatch.spmm)")
