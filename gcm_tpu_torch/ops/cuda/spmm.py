"""Padded-edge-list SpMM (counterpart of gcm_tpu/ops/pallas/spmm.py):

    out[b, i] = sum over lanes e with sink_e = i of w_e * x[b, src_e]

x [B,N,F] float32, edges [B,2,E] int32 (row 0 sink, row 1 source), weights
[B,E] float32. A lane adds nothing unless 0 <= sink < N and 0 <= src < N,
so the -1 sentinel drops out. `spmm_edge_list` launches the hand-written
CUDA kernel (csrc/spmm.cu) for CUDA tensors, or raises, and takes the plain
PyTorch version, `spmm_edge_list_plain`, only for CPU tensors.

`spmm_edge_list` is differentiable in x and weights (the edges are index
data), as JAX's `ops/dispatch.py::spmm`: a tracked call goes through
`_SpmmEdgeList`, whose backward takes dx from the same kernel on the flipped
edges (sink and source swapped) and dw, only where the weights carry a
gradient, from `ops/cuda/edge_grad.py::edge_weight_grad`.

`spmm_onehot_dtype(x, edges, weights, dtype)` is the counterpart of the
one-hot SpMM experiment benchmarks/spmm_variants.py::pallas_onehot_dtype,
with its own launch count: float32 is the function above; bfloat16 rounds x
to bf16 as it reads it and each weighted message to bf16 before the f32
sum, in the bf16 entry of the same kernel. It has no backward (none in
the JAX package either) and refuses tracked inputs.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from gcm_tpu_torch.ops import _build
from gcm_tpu_torch.ops.cuda._launch import (
    check_cuda, check_forward_only, check_rc, needs_grad, ptr, refuse_export,
    stream_of)
from gcm_tpu_torch.ops.cuda.edge_grad import edge_weight_grad
from gcm_tpu_torch.ops.scatter import in_order_slots, in_order_sum

PRECISIONS = ("default", "f32x2", "highest")


def _is_bf16(dtype) -> bool:
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"dtype must be torch.float32 or torch.bfloat16, "
                         f"got {dtype}")
    return dtype == torch.bfloat16


def _edge_sum(x, edges, weights, bf16: bool, depth):
    """The kernel's sums, in lane order: f32 products and adds; bf16: x and
    each message rounded to bf16, the adds in float32."""
    N, F = x.shape[1:]
    sink = edges[:, 0, :].long()
    src = edges[:, 1, :].long()
    valid = (sink >= 0) & (sink < N) & (src >= 0) & (src < N)
    msgs = torch.gather(x, 1, torch.where(valid, src, 0)[..., None]
                        .expand(-1, -1, F))
    if bf16:
        msgs = msgs.to(torch.bfloat16).to(x.dtype)
    msgs = msgs * weights[..., None].to(x.dtype)
    if bf16:
        msgs = msgs.to(torch.bfloat16).to(x.dtype)
    slots = in_order_slots(torch.where(valid, sink, -1), N, depth)
    return in_order_sum(msgs, slots)


def spmm_edge_list_plain(x, edges, weights, depth: int | None = None):
    """The kernel's function in plain PyTorch, each output summed in lane
    order. depth: the most lanes into one sink, which the caller may know
    (see ops/scatter.py::in_order_slots); else found with a host wait."""
    return _edge_sum(x, edges, weights, False, depth)


def spmm_onehot_dtype_plain(x, edges, weights, dtype=torch.float32,
                            depth: int | None = None):
    return _edge_sum(x, edges, weights, _is_bf16(dtype), depth)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("spmm")
    vp, ip = ctypes.c_void_p, ctypes.c_int
    lib.gcm_spmm_edge_list_f32.argtypes = [vp, vp, vp, vp, ip, ip, ip, ip,
                                           ip, vp]
    lib.gcm_spmm_edge_list_f32.restype = ip
    lib.gcm_spmm_onehot_bf16.argtypes = lib.gcm_spmm_edge_list_f32.argtypes
    lib.gcm_spmm_onehot_bf16.restype = ip
    return lib


def _launch(x, edges, weights, counter, bf16=False):
    if x.dim() != 3 or edges.dim() != 3 or edges.shape[1] != 2:
        raise ValueError(f"x must be [B, N, F] and edges [B, 2, E], got "
                         f"{tuple(x.shape)} and {tuple(edges.shape)}")
    B, N, F = x.shape
    E = edges.shape[2]
    if not 1 <= B <= 65535 or min(N, F, E) < 1:
        raise ValueError(f"the kernel takes 1 <= B <= 65535 and N, F, E >= 1;"
                         f" got B={B} N={N} F={F} E={E}")
    dev = x.device
    check_cuda("x", x, (B, N, F), dev)
    check_cuda("edges", edges, (B, 2, E), dev, torch.int32)
    check_cuda("weights", weights, (B, E), dev)
    out = torch.empty((B, N, F), device=dev, dtype=torch.float32)
    entry = (_lib().gcm_spmm_onehot_bf16 if bf16
             else _lib().gcm_spmm_edge_list_f32)
    rc = entry(ptr(x), ptr(edges), ptr(weights), ptr(out), B, N, F, E,
               dev.index, stream_of(dev))
    check_rc(counter.__name__, rc)
    counter.launches += 1
    return out


def _edge_list(x, edges, weights):
    if x.device.type == "cpu":
        return spmm_edge_list_plain(x, edges, weights)
    return _launch(x, edges, weights, spmm_edge_list)


class _SpmmEdgeList(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, edges, weights):
        ctx.save_for_backward(x, edges, weights)
        return _edge_list(x, edges, weights)

    @staticmethod
    def backward(ctx, g):
        x, edges, weights = ctx.saved_tensors
        g = g.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _edge_list(g, edges.flip(1).contiguous(), weights)
        if ctx.needs_input_grad[2]:
            dw = edge_weight_grad(g, x, edges).to(weights.dtype)
        return dx, None, dw


def spmm_edge_list(x, edges, weights, precision: str = "default"):
    """x [B,N,F], edges [B,2,E], weights [B,E] -> [B,N,F]. Differentiable
    in x and weights.

    precision: 'default', 'f32x2' or 'highest', the JAX kernel's modes. All
    three compute in float32 here, each product and each add rounded once.
    On the TPU 'default' and 'f32x2' were bf16 approximations of a float32
    sum; float32 is at least as exact as any of them.
    CUDA tensors launch the kernel (or raise); CPU tensors take the plain
    version."""
    refuse_export("spmm_edge_list")
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; one of "
                         f"{PRECISIONS}")
    if needs_grad(x, weights):
        return _SpmmEdgeList.apply(x, edges, weights)
    return _edge_list(x, edges, weights)


spmm_edge_list.launches = 0  # kernel launches, for callers to read and reset


def spmm_onehot_dtype(x, edges, weights, dtype=torch.float32):
    """x [B,N,F], edges [B,2,E], weights [B,E] -> [B,N,F] float32.

    dtype torch.float32: spmm_edge_list's function; torch.bfloat16: x
    rounded to bf16 as read and each message w * x rounded to bf16 before
    the f32 sum, as the one-hot experiment's bf16 matmuls round. CUDA
    tensors launch the kernel (or raise); CPU tensors take the plain
    version."""
    refuse_export("spmm_onehot_dtype")
    bf16 = _is_bf16(dtype)
    check_forward_only(x, weights)
    if x.device.type == "cpu":
        return spmm_onehot_dtype_plain(x, edges, weights, dtype)
    return _launch(x, edges, weights, spmm_onehot_dtype, bf16)


spmm_onehot_dtype.launches = 0
