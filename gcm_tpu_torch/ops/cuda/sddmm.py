"""Thresholded score row (counterpart of gcm_tpu/ops/pallas/sddmm.py):

    out[b, j] = score(curr[b], nodes[b, j]) < threshold and j < num_nodes[b]

curr [B,F] float32, nodes [B,N,F] float32, num_nodes [B] int32 -> bool
[B,N], the row the CosineEdge and SpatialEdge selectors write into
adjacency row num_nodes[b]. mode 'euclidean' scores sqrt(sum_f (q_f -
n_f)^2), 'cosine' (q . n) / (max(|q|, 1e-8) * max(|n|, 1e-8)).

`sddmm_threshold_row` launches the hand-written CUDA kernel
(csrc/sddmm.cu) for CUDA tensors, or raises, and takes the plain PyTorch
version, `sddmm_threshold_row_plain`, only for CPU tensors. Both sum over
features in order, one rounding per operation, so the card's masks are
bitwise equal to the CPU's. Forward only.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from gcm_tpu_torch.ops import _build
from gcm_tpu_torch.ops.cuda._launch import (check_cuda, check_forward_only,
                                            check_rc, ptr, stream_of)

MODES = ("euclidean", "cosine")
EPS = 1e-8
MAX_B, MAX_N, MAX_F = 65535, 1 << 24, 1 << 16


def _threshold(threshold) -> float:
    """The threshold as the float32 value both versions compare against."""
    return float(np.float32(threshold))


def sddmm_threshold_row_plain(curr, nodes, num_nodes, threshold,
                              mode: str = "euclidean"):
    """A loop over features of separate elementwise operations: the kernel's
    arithmetic, operation for operation."""
    B, N, F = nodes.shape
    acc = torch.zeros((B, N), dtype=nodes.dtype, device=nodes.device)
    if mode == "euclidean":
        for f in range(F):
            d = curr[:, f, None] - nodes[:, :, f]
            acc = acc + d * d
        score = torch.sqrt(acc)
    else:
        qq = torch.zeros((B, 1), dtype=nodes.dtype, device=nodes.device)
        nn = torch.zeros_like(acc)
        for f in range(F):
            q, n = curr[:, f, None], nodes[:, :, f]
            acc = acc + q * n
            qq = qq + q * q
            nn = nn + n * n
        score = acc / (torch.clamp_min(torch.sqrt(qq), EPS)
                       * torch.clamp_min(torch.sqrt(nn), EPS))
    past = torch.arange(N, device=nodes.device)[None, :] < num_nodes[:, None]
    return (score < _threshold(threshold)) & past


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("sddmm")
    vp, ip = ctypes.c_void_p, ctypes.c_int
    lib.gcm_sddmm_threshold_row_f32.argtypes = [vp, vp, vp, ctypes.c_float,
                                                ip, vp, ip, ip, ip, ip, vp]
    lib.gcm_sddmm_threshold_row_f32.restype = ip
    return lib


def _launch(curr, nodes, num_nodes, threshold, mode):
    if nodes.dim() != 3:
        raise ValueError(f"nodes must be [B, N, F], got {tuple(nodes.shape)}")
    B, N, F = nodes.shape
    if not (1 <= B <= MAX_B and 1 <= N <= MAX_N and 1 <= F <= MAX_F):
        raise ValueError(f"the kernel takes 1 <= B <= {MAX_B}, 1 <= N <= "
                         f"{MAX_N} and 1 <= F <= {MAX_F}; got B={B} N={N} "
                         f"F={F}")
    dev = nodes.device
    check_cuda("curr", curr, (B, F), dev)
    check_cuda("nodes", nodes, (B, N, F), dev)
    check_cuda("num_nodes", num_nodes, (B,), dev, torch.int32)
    out = torch.empty((B, N), device=dev, dtype=torch.uint8)
    rc = _lib().gcm_sddmm_threshold_row_f32(
        ptr(curr), ptr(nodes), ptr(num_nodes), _threshold(threshold),
        int(mode == "cosine"), ptr(out), B, N, F, dev.index, stream_of(dev))
    check_rc("sddmm_threshold_row", rc)
    sddmm_threshold_row.launches += 1
    return out.view(torch.bool)


def sddmm_threshold_row(curr, nodes, num_nodes, threshold,
                        mode: str = "euclidean"):
    """curr [B,F], nodes [B,N,F], num_nodes [B] int32, threshold a scalar ->
    bool [B,N]. CUDA tensors launch the kernel (or raise); CPU tensors take
    the plain version."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; one of {MODES}")
    check_forward_only(curr, nodes)
    if all(t.device.type == "cpu" for t in (curr, nodes, num_nodes)):
        return sddmm_threshold_row_plain(curr, nodes, num_nodes, threshold,
                                         mode)
    return _launch(curr, nodes, num_nodes, threshold, mode)


sddmm_threshold_row.launches = 0  # kernel launches, for callers to read and reset
