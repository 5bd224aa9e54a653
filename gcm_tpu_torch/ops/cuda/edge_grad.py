"""Edge weight-gradient, the dw of every SpMM backward (the gather-dot of
gcm_tpu/ops/dispatch.py::_spmm_bwd, which the slot, pair and segment
backwards of the JAX package repeat):

    dw[b, e] = sum over f of g[b, sink_e, f] * x[b, src_e, f]

on the lanes where sink_e >= 0 and src_e >= 0, with both indices clamped
into 0..N-1 as `gather_nodes` clamps them, and 0 on every other lane. So a
source of N or more reads row N - 1, as JAX's dw does, though the forward
kernels drop such a lane.

The order of the sum is fixed by F alone, the same in the kernel on every
plan and in its plain version, so the two agree bitwise: column f goes to
part f % 32; each part adds its columns in ascending order from 0 (one
rounding per product and per add), and the 32 parts are added by halves
(part p + part p + 16 for p < 16, then p + 8, p + 4, p + 2, p + 1). The
kernel (csrc/edge_grad.cu) gives a lane eight threads, thread t holding
parts 4t .. 4t + 3 (its float4 of each 32 columns), so its first three
halvings are shuffles and its last two adds in one thread; calls of fewer
than 16,384 lanes (B * E), or with N * F of 2^31 or more, take a warp a
lane, thread t holding part t.

`edge_weight_grad` launches the hand-written CUDA kernel for CUDA tensors,
or raises, and takes the plain version, `edge_weight_grad_plain`, only for
CPU tensors. One call is one kernel, counted on `edge_weight_grad.launches`.
Neither input carries a gradient through it: it is itself a backward.
`edge_weight_grad_plan` reports how the kernel splits a call's work (tiles
of sink rows, splits of each element's lanes, or a warp a lane); no plan
changes a result.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from gcm_tpu_torch.ops import _build
from gcm_tpu_torch.ops.cuda._launch import (check_cuda, check_rc, ptr, refuse_export, stream_of)
from gcm_tpu_torch.ops.scatter import edge_mask, gather_nodes

PARTS = 32  # the order's parts: column f goes to part f % 32


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
    lib.gcm_edge_weight_grad_f32_plan.argtypes = [vp, vp, vp, vp, ip, ip, ip,
                                                  ip, ip, ip, ip, vp]
    lib.gcm_edge_weight_grad_f32_plan.restype = ip
    lib.gcm_edge_weight_grad_plan.argtypes = [ip, ip, ip, ip, ip, ip, ip,
                                              ctypes.POINTER(ctypes.c_int)]
    lib.gcm_edge_weight_grad_plan.restype = ip
    return lib


PLAN_KEYS = ("rows", "tiles", "splits", "span", "lanes_in_flight", "tiled")


def edge_weight_grad_plan(B, N, F, E, device, tile_bytes=0, splits=0):
    """The kernel's plan for a call (csrc/edge_grad.cu::plan): sink rows a
    tile, tiles, splits of each element's lanes, lanes a split, lanes a
    group of eight threads carries at once, and whether the call is tiled
    (0: a warp a lane). tile_bytes (the most g bytes a tile holds) or
    splits above 0 asks for the tiled kernel with them, tile_bytes < 0 for
    a warp a lane; both 0 take the planner's choice."""
    out = (ctypes.c_int * len(PLAN_KEYS))()
    rc = _lib().gcm_edge_weight_grad_plan(B, N, F, E, tile_bytes, splits,
                                          torch.device(device).index or 0,
                                          out)
    check_rc("edge_weight_grad_plan", rc)
    return dict(zip(PLAN_KEYS, out))


def _launch(g, x, edges, tile_bytes=0, splits=0):
    """Launches the kernel; tile_bytes and splits other than 0 replace the
    planner's choice, as in `edge_weight_grad_plan` (to check and time
    other plans)."""
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
    rc = _lib().gcm_edge_weight_grad_f32_plan(
        ptr(g), ptr(x), ptr(edges), ptr(dw), B, N, F_, E, tile_bytes, splits,
        dev.index, stream_of(dev))
    check_rc("edge_weight_grad", rc)
    edge_weight_grad.launches += 1
    return dw


def edge_weight_grad(g, x, edges):
    """g (the output's cotangent) and x [B,N,F], edges [B,2,E] -> dw [B,E].
    CUDA tensors launch the kernel (or raise); CPU tensors take the plain
    version."""
    refuse_export("edge_weight_grad")
    if x.device.type == "cpu":
        return edge_weight_grad_plain(g, x, edges)
    return _launch(g.contiguous(), x, edges)


edge_weight_grad.launches = 0  # kernel launches, for callers to read and reset
