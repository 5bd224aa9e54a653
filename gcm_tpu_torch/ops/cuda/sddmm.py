"""Thresholded score row (counterpart of gcm_tpu/ops/pallas/sddmm.py):

    out[b, j] = score(curr[b], nodes[b, j]) < threshold and j < num_nodes[b]

curr [B,F] float32, nodes [B,N,F] float32, num_nodes [B] int32 -> bool
[B,N], the row the CosineEdge and SpatialEdge selectors write into
adjacency row num_nodes[b]. mode 'euclidean' scores sqrt(sum_f (q_f -
n_f)^2), 'cosine' (q . n) / (max(|q|, 1e-8) * max(|n|, 1e-8)).

Two entries launch the one hand-written CUDA kernel (csrc/sddmm.cu):
`sddmm_threshold_row` takes curr as a tensor of its own, and
`sddmm_threshold_row_current` takes the selectors' current node,
curr[b] = nodes[b, clip(num_nodes[b], 0, N - 1), curr_cols], and scores
nodes[:, :, cols], both read in place by the kernel. For CUDA tensors each
launches the kernel (or raises); CPU tensors take the plain PyTorch
versions. Both sum over features in order, one rounding per operation, so
the card's masks are bitwise equal to the CPU's. Both entries count their
launches on `sddmm_threshold_row.launches`. Forward only. Each entry is
also a torch.library op (`gcm::sddmm_threshold_row`,
`gcm::sddmm_threshold_row_current`, the column slices as [start, stop,
step]), so that serve/export.py can export a step that scores through
them; a call reaches the op only while torch.export traces it
(`_launch.py::exporting`), and the op holds the same device rule.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from gcm_tpu_torch.ops import _build
from gcm_tpu_torch.ops.cuda._launch import (check_cuda, check_forward_only,
                                            check_op_device, check_rc,
                                            exporting, ptr, stream_of)

MODE_COSINE = "cosine"

MODES = ("euclidean", "cosine")
EPS = 1e-8
MAX_B, MAX_N, MAX_F = 65535, 1 << 24, 1 << 16


def _threshold(threshold) -> float:
    """The threshold as the float32 value both versions compare against."""
    return float(np.float32(threshold))


def _check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; one of {MODES}")


def current_node(nodes, num_nodes):
    """nodes[b, clip(num_nodes[b], 0, N - 1)], [B, F]: the node a distance
    selector scores the others against."""
    B, N = nodes.shape[0], nodes.shape[1]
    idx = torch.clamp(num_nodes, 0, N - 1).long()
    return nodes[torch.arange(B, device=nodes.device), idx]


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


def _slices(cols, curr_cols) -> tuple[slice, slice]:
    cols = slice(None) if cols is None else cols
    return cols, cols if curr_cols is None else curr_cols


def sddmm_threshold_row_current_plain(nodes, num_nodes, threshold,
                                      mode: str = "euclidean", cols=None,
                                      curr_cols=None):
    """The current node gathered and both column ranges sliced, then the
    plain loop: the explicit path's arithmetic."""
    cols, curr_cols = _slices(cols, curr_cols)
    return sddmm_threshold_row_plain(
        current_node(nodes, num_nodes)[:, curr_cols], nodes[:, :, cols],
        num_nodes, threshold, mode)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("sddmm")
    vp, ip, lp = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.gcm_sddmm_threshold_row_f32.argtypes = [
        vp, lp, lp, vp, lp, lp, vp, ctypes.c_float, ip, vp, ip, ip, ip, ip,
        vp]
    lib.gcm_sddmm_threshold_row_f32.restype = ip
    return lib


def _run(dev, curr, curr_sb, curr_sn, nodes, node_sb, node_sn, num_nodes, B,
         N, F, threshold, mode):
    """Launches the kernel on `dev` with column pointers and strides (in
    floats) that the caller has checked."""
    if not (1 <= B <= MAX_B and 1 <= N <= MAX_N and 1 <= F <= MAX_F):
        raise ValueError(f"the kernel takes 1 <= B <= {MAX_B}, 1 <= N <= "
                         f"{MAX_N} and 1 <= F <= {MAX_F}; got B={B} N={N} "
                         f"F={F}")
    check_cuda("num_nodes", num_nodes, (B,), dev, torch.int32)
    out = torch.empty((B, N), device=dev, dtype=torch.bool)  # 0 / 1 bytes
    rc = _lib().gcm_sddmm_threshold_row_f32(
        curr, curr_sb, curr_sn, nodes, node_sb, node_sn, ptr(num_nodes),
        _threshold(threshold), int(mode == "cosine"), ptr(out), B, N, F,
        dev.index, stream_of(dev))
    check_rc("sddmm_threshold_row", rc)
    sddmm_threshold_row.launches += 1
    return out


def _launch(curr, nodes, num_nodes, threshold, mode):
    if nodes.dim() != 3:
        raise ValueError(f"nodes must be [B, N, F], got {tuple(nodes.shape)}")
    B, N, F = nodes.shape
    dev = nodes.device
    check_cuda("curr", curr, (B, F), dev)
    check_cuda("nodes", nodes, (B, N, F), dev)
    return _run(dev, ptr(curr), F, 0, ptr(nodes), N * F, F, num_nodes, B, N,
                F, threshold, mode)


def sddmm_threshold_row(curr, nodes, num_nodes, threshold,
                        mode: str = "euclidean"):
    """curr [B,F], nodes [B,N,F], num_nodes [B] int32, threshold a scalar ->
    bool [B,N]. CUDA tensors launch the kernel (or raise); CPU tensors take
    the plain version."""
    _check_mode(mode)
    check_forward_only(curr, nodes)
    check_op_device("sddmm_threshold_row", curr, nodes, num_nodes)
    if exporting():
        return _row_op(curr, nodes, num_nodes, _threshold(threshold),
                       mode == MODE_COSINE)
    return _row(curr, nodes, num_nodes, threshold, mode)


def _row(curr, nodes, num_nodes, threshold, mode):
    if all(t.device.type == "cpu" for t in (curr, nodes, num_nodes)):
        return sddmm_threshold_row_plain(curr, nodes, num_nodes, threshold,
                                         mode)
    return _launch(curr, nodes, num_nodes, threshold, mode)


@torch.library.custom_op("gcm::sddmm_threshold_row", mutates_args=())
def _row_op(curr: torch.Tensor, nodes: torch.Tensor, num_nodes: torch.Tensor,
            threshold: float, cosine: bool) -> torch.Tensor:
    return _row(curr, nodes, num_nodes, threshold, MODES[int(cosine)])


@_row_op.register_fake
def _row_fake(curr, nodes, num_nodes, threshold, cosine):
    return nodes.new_empty(nodes.shape[:2], dtype=torch.bool)


sddmm_threshold_row.launches = 0  # kernel launches, for callers to read and reset


def _column_range(sl: slice, F: int) -> tuple[int, int] | None:
    """(start, width) of a slice of F columns, None for a step other than 1."""
    start, stop, step = sl.indices(F)
    return (start, max(0, stop - start)) if step == 1 else None


def _launch_current(nodes, num_nodes, threshold, mode, cols, curr_cols):
    if nodes.dim() != 3:
        raise ValueError(f"nodes must be [B, N, F], got {tuple(nodes.shape)}")
    if nodes.device.type != "cuda":
        raise ValueError(f"nodes: the kernel takes CUDA tensors, got "
                         f"{nodes.device}")
    if nodes.dtype != torch.float32:
        raise ValueError(f"nodes: the kernel takes torch.float32, got "
                         f"{nodes.dtype}")
    B, N, F = nodes.shape
    a, c = _column_range(cols, F), _column_range(curr_cols, F)
    if a is None or c is None or nodes.stride(-1) != 1:
        # the two column ranges, side by side in one contiguous copy
        scored, current = nodes[:, :, cols], nodes[:, :, curr_cols]
        nodes = torch.cat([scored, current], dim=-1)
        a = (0, scored.shape[-1])
        c = (scored.shape[-1], current.shape[-1])
    if a[1] != c[1]:
        raise ValueError(f"the scored columns {cols} and the current node's "
                         f"{curr_cols} differ in width: {a[1]} and {c[1]}")
    base, item = nodes.data_ptr(), nodes.element_size()
    sb, sn = nodes.stride(0), nodes.stride(1)
    return _run(nodes.device, ctypes.c_void_p(base + item * c[0]), sb, sn,
                ctypes.c_void_p(base + item * a[0]), sb, sn, num_nodes, B, N,
                a[1], threshold, mode)


def sddmm_threshold_row_current(nodes, num_nodes, threshold,
                                mode: str = "euclidean", cols=None,
                                curr_cols=None):
    """nodes [B,N,F], num_nodes [B] int32, threshold a scalar, cols and
    curr_cols slices of the features (None: all; curr_cols None: cols) ->
    bool [B,N], the row of curr[b] = nodes[b, clip(num_nodes[b], 0, N - 1),
    curr_cols] against nodes[:, :, cols]. The kernel reads both through
    nodes' batch and row strides; a slice with a step other than 1, or a
    last dimension that is not contiguous, is first copied. CUDA tensors
    launch the kernel (or raise); CPU tensors take the plain version."""
    _check_mode(mode)
    check_forward_only(nodes)
    check_op_device("sddmm_threshold_row", nodes, num_nodes)
    cols, curr_cols = _slices(cols, curr_cols)
    if exporting():
        F = nodes.shape[-1]
        return _current_op(nodes, num_nodes, _threshold(threshold),
                           mode == MODE_COSINE, _slice_ints(cols, F),
                           _slice_ints(curr_cols, F))
    return _current(nodes, num_nodes, threshold, mode, cols, curr_cols)


def _current(nodes, num_nodes, threshold, mode, cols, curr_cols):
    if nodes.device.type == "cpu" and num_nodes.device.type == "cpu":
        return sddmm_threshold_row_current_plain(nodes, num_nodes, threshold,
                                                 mode, cols, curr_cols)
    return _launch_current(nodes, num_nodes, threshold, mode, cols,
                           curr_cols)


def _slice_ints(sl: slice, F: int) -> list[int]:
    """[start, stop, step] with slice(*those) selecting what `sl` selects
    of F columns (a stop before column 0 as -F - 1, not -1)."""
    start, stop, step = sl.indices(F)
    return [start, stop if stop >= 0 else -F - 1, step]


@torch.library.custom_op("gcm::sddmm_threshold_row_current", mutates_args=())
def _current_op(nodes: torch.Tensor, num_nodes: torch.Tensor,
                threshold: float, cosine: bool, cols: list[int],
                curr_cols: list[int]) -> torch.Tensor:
    return _current(nodes, num_nodes, threshold, MODES[int(cosine)],
                    slice(*cols), slice(*curr_cols))


@_current_op.register_fake
def _current_fake(nodes, num_nodes, threshold, cosine, cols, curr_cols):
    return nodes.new_empty(nodes.shape[:2], dtype=torch.bool)
