"""Edge weight-gradient, the dw of every SpMM backward (the gather-dot of
gcm_tpu/ops/dispatch.py::_spmm_bwd, which the slot, pair and segment
backwards of the JAX package repeat):

    dw[b, e] = sum over f of g[b, sink_e, f] * x[b, src_e, f]

on the lanes where sink_e >= 0 and src_e >= 0, with both indices clamped
into 0..N-1 as `gather_nodes` clamps them, and 0 on every other lane. So a
source of N or more reads row N - 1, as JAX's dw does, though the forward
kernels drop such a lane.

The order of the sum is fixed, the same in the kernel and its plain version,
so the two agree bitwise: column f goes to part f % 32; each part adds its
columns in ascending order (one rounding per product and per add), and the
32 parts are added by halves (part p + part p + 16, then p + 8, ... , 1).

`edge_weight_grad` launches the hand-written CUDA kernel (csrc/edge_grad.cu)
for CUDA tensors, or raises, and takes the plain version,
`edge_weight_grad_plain`, only for CPU tensors. Neither input carries a
gradient through it: it is itself a backward.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from gcm_tpu_torch.ops import _build
from gcm_tpu_torch.ops.cuda._launch import check_cuda, check_rc, ptr, stream_of
from gcm_tpu_torch.ops.scatter import edge_mask, gather_nodes

PARTS = 32  # the kernel's warp width


def edge_weight_grad_plain(g, x, edges):
    """g, x [B,N,F], edges [B,2,E] -> dw [B,E], in the kernel's order."""
    B, E = edges.shape[0], edges.shape[2]
    prod = gather_nodes(g, edges[:, 0, :]) * gather_nodes(x, edges[:, 1, :])
    prod = F.pad(prod, (0, -prod.shape[-1] % PARTS)).reshape(
        B, E, -1, PARTS)
    acc = torch.zeros((B, E, PARTS), dtype=prod.dtype, device=prod.device)
    for c in range(prod.shape[2]):
        acc = acc + prod[:, :, c]
    while acc.shape[-1] > 1:
        half = acc.shape[-1] // 2
        acc = acc[..., :half] + acc[..., half:]
    return torch.where(edge_mask(edges), acc[..., 0], 0.0)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("edge_grad")
    vp, ip = ctypes.c_void_p, ctypes.c_int
    lib.gcm_edge_weight_grad_f32.argtypes = [vp, vp, vp, vp, ip, ip, ip, ip,
                                             ip, vp]
    lib.gcm_edge_weight_grad_f32.restype = ip
    return lib


def _launch(g, x, edges):
    if x.dim() != 3 or edges.dim() != 3 or edges.shape[1] != 2:
        raise ValueError(f"x must be [B, N, F] and edges [B, 2, E], got "
                         f"{tuple(x.shape)} and {tuple(edges.shape)}")
    B, N, F_ = x.shape
    E = edges.shape[2]
    if not 1 <= B <= 65535 or min(N, F_, E) < 1:
        raise ValueError(f"the kernel takes 1 <= B <= 65535 and N, F, E >= 1;"
                         f" got B={B} N={N} F={F_} E={E}")
    dev = x.device
    check_cuda("g", g, (B, N, F_), dev)
    check_cuda("x", x, (B, N, F_), dev)
    check_cuda("edges", edges, (B, 2, E), dev, torch.int32)
    dw = torch.empty((B, E), device=dev, dtype=torch.float32)
    rc = _lib().gcm_edge_weight_grad_f32(ptr(g), ptr(x), ptr(edges), ptr(dw),
                                         B, N, F_, E, dev.index,
                                         stream_of(dev))
    check_rc("edge_weight_grad", rc)
    edge_weight_grad.launches += 1
    return dw


def edge_weight_grad(g, x, edges):
    """g (the output's cotangent) and x [B,N,F], edges [B,2,E] -> dw [B,E].
    CUDA tensors launch the kernel (or raise); CPU tensors take the plain
    version."""
    if x.device.type == "cpu":
        return edge_weight_grad_plain(g, x, edges)
    return _launch(g.contiguous(), x, edges)


edge_weight_grad.launches = 0  # kernel launches, for callers to read and reset
