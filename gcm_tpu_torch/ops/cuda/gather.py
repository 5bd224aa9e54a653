"""Three gathers (counterparts of the three Pallas kernels of the capability
probe benchmarks/spmm_variants.py::probe_dynamic_gather), at any shape:

    take_rows(x [R,C], idx [M])        -> [M,C]  x[i]      (k_rows)
    take_lanes(x [R,C], idx [R,M])     -> [R,M]  x[r, i]   (k_lanes)
    take_rows_loop(x [R,C], idx [M])   -> [M,C]  x[i']     (k_dyn_rows)

x float32, idx int32. take_rows and take_lanes follow jnp.take's default
mode, as the probe's kernels compute in Pallas's interpret mode: an index i
in -D..-1 (D the size of the gathered dimension) wraps to i + D, and one
outside -D..D-1 gives NaN. take_rows_loop follows the dynamic-slice rule of
the probe's loop of row slices: i < 0 becomes i + R, then i' is clamped
into 0..R-1.

Each launches its kernel of csrc/gather.cu for CUDA tensors, or raises, and
takes its plain version (`*_plain`) only for CPU tensors. They only copy,
so kernel and plain version agree bit for bit. No gradient (the probe had
none).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from gcm_tpu_torch.ops import _build
from gcm_tpu_torch.ops.cuda._launch import (
    check_cuda, check_forward_only, check_rc, ptr, refuse_export, stream_of)


def _wrap_or_fill(idx, size: int):
    """(wrapped index with the fills at 0, mask of the kept lanes)."""
    i = idx.long()
    ok = (i >= -size) & (i < size)
    return torch.where(ok, torch.where(i < 0, i + size, i), 0), ok


def take_rows_plain(x, idx):
    i, ok = _wrap_or_fill(idx, x.shape[0])
    return torch.where(ok[:, None], x.index_select(0, i), float("nan"))


def take_lanes_plain(x, idx):
    i, ok = _wrap_or_fill(idx, x.shape[1])
    return torch.where(ok, torch.gather(x, 1, i), float("nan"))


def take_rows_loop_plain(x, idx):
    R = x.shape[0]
    i = idx.long()
    return x.index_select(0, torch.where(i < 0, i + R, i).clamp(0, R - 1))


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("gather")
    vp, ip, lp = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    for entry in ("gcm_take_rows", "gcm_take_lanes", "gcm_take_rows_loop"):
        fn = getattr(lib, entry)
        fn.argtypes = [vp, vp, vp, lp, lp, lp, ip, vp]
        fn.restype = ip
    return lib


def _check(name, x, idx, lanes: bool):
    """x [R,C] (R, C >= 1) and idx [M] (or [R,M] for lanes) -> out shape."""
    if x.dim() != 2 or min(x.shape) < 1:
        raise ValueError(f"{name}: x must be [R, C] with R, C >= 1, got "
                         f"{tuple(x.shape)}")
    if lanes and (idx.dim() != 2 or idx.shape[0] != x.shape[0]):
        raise ValueError(f"{name}: idx must be [{x.shape[0]}, M], got "
                         f"{tuple(idx.shape)}")
    if not lanes and idx.dim() != 1:
        raise ValueError(f"{name}: idx must be [M], got {tuple(idx.shape)}")
    check_forward_only(x)
    return tuple(idx.shape) if lanes else (idx.shape[0], x.shape[1])


def _launch(wrapper, entry: str, x, idx, shape):
    dev = x.device
    check_cuda("x", x, tuple(x.shape), dev)
    check_cuda("idx", idx, tuple(idx.shape), dev, torch.int32)
    out = torch.empty(shape, device=dev, dtype=torch.float32)
    if out.numel():  # an empty gather launches nothing
        rc = getattr(_lib(), entry)(ptr(x), ptr(idx), ptr(out), x.shape[0],
                                    x.shape[1], idx.shape[-1], dev.index,
                                    stream_of(dev))
        check_rc(wrapper.__name__, rc)
        wrapper.launches += 1
    return out


def take_rows(x, idx):
    """x [R,C], idx [M] -> [M,C]: jnp.take(x, idx, axis=0). CUDA tensors
    launch the kernel (or raise); CPU tensors take the plain version."""
    refuse_export("take_rows")
    shape = _check("take_rows", x, idx, lanes=False)
    if x.device.type == "cpu":
        return take_rows_plain(x, idx)
    return _launch(take_rows, "gcm_take_rows", x, idx, shape)


def take_lanes(x, idx):
    """x [R,C], idx [R,M] -> [R,M]: jnp.take_along_axis(x, idx, axis=1).
    CUDA tensors launch the kernel (or raise); CPU tensors take the plain
    version."""
    refuse_export("take_lanes")
    shape = _check("take_lanes", x, idx, lanes=True)
    if x.device.type == "cpu":
        return take_lanes_plain(x, idx)
    return _launch(take_lanes, "gcm_take_lanes", x, idx, shape)


def take_rows_loop(x, idx):
    """x [R,C], idx [M] -> [M,C]: out[j] = x[idx[j]] row after row, the
    index wrapped once and clamped. CUDA tensors launch the kernel (or
    raise); CPU tensors take the plain version."""
    refuse_export("take_rows_loop")
    shape = _check("take_rows_loop", x, idx, lanes=False)
    if x.device.type == "cpu":
        return take_rows_loop_plain(x, idx)
    return _launch(take_rows_loop, "gcm_take_rows_loop", x, idx, shape)


take_rows.launches = 0  # kernel launches, for callers to read and reset
take_lanes.launches = 0
take_rows_loop.launches = 0
