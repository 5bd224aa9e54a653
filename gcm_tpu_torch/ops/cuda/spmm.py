"""Padded-edge-list SpMM (counterpart of gcm_tpu/ops/pallas/spmm.py):

    out[b, i] = sum over lanes e with sink_e = i of w_e * x[b, src_e]

x [B,N,F] float32, edges [B,2,E] int32 (row 0 sink, row 1 source), weights
[B,E] float32. A lane adds nothing unless 0 <= sink < N and 0 <= src < N,
so the -1 sentinel drops out. `spmm_edge_list` launches the hand-written
CUDA kernel (csrc/spmm.cu) for CUDA tensors, or raises, and takes the plain
PyTorch version, `spmm_edge_list_plain`, only for CPU tensors. Forward
only.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from gcm_tpu_torch.ops import _build
from gcm_tpu_torch.ops.cuda._launch import (check_cuda, check_forward_only,
                                            check_rc, ptr, stream_of)

PRECISIONS = ("default", "f32x2", "highest")


def spmm_edge_list_plain(x, edges, weights):
    B, N, F = x.shape
    sink = edges[:, 0, :].long()
    src = edges[:, 1, :].long()
    valid = (sink >= 0) & (sink < N) & (src >= 0) & (src < N)
    msgs = torch.gather(x, 1, torch.where(valid, src, 0)[..., None]
                        .expand(-1, -1, F))
    msgs = torch.where(valid[..., None], msgs * weights[..., None].to(x.dtype),
                       0.0)
    out = torch.zeros((B, N + 1, F), dtype=x.dtype, device=x.device)
    out.scatter_add_(1, torch.where(valid, sink, N)[..., None]
                     .expand(-1, -1, F), msgs)
    return out[:, :N]


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("spmm")
    vp, ip = ctypes.c_void_p, ctypes.c_int
    lib.gcm_spmm_edge_list_f32.argtypes = [vp, vp, vp, vp, ip, ip, ip, ip,
                                           ip, vp]
    lib.gcm_spmm_edge_list_f32.restype = ip
    return lib


def _launch(x, edges, weights):
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
    rc = _lib().gcm_spmm_edge_list_f32(ptr(x), ptr(edges), ptr(weights),
                                       ptr(out), B, N, F, E, dev.index,
                                       stream_of(dev))
    check_rc("spmm_edge_list", rc)
    spmm_edge_list.launches += 1
    return out


def spmm_edge_list(x, edges, weights, precision: str = "default"):
    """x [B,N,F], edges [B,2,E], weights [B,E] -> [B,N,F].

    precision: 'default', 'f32x2' or 'highest', the JAX kernel's modes. All
    three compute with float32 FMAs here. On the TPU 'default' and 'f32x2'
    were bf16 approximations; float32 is at least as exact as any of them.
    CUDA tensors launch the kernel (or raise); CPU tensors take the plain
    version."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; one of "
                         f"{PRECISIONS}")
    check_forward_only(x, weights)
    if x.device.type == "cpu":
        return spmm_edge_list_plain(x, edges, weights)
    return _launch(x, edges, weights)


spmm_edge_list.launches = 0  # kernel launches, for callers to read and reset
