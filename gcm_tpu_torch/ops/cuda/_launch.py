"""Checks and argument marshalling shared by the kernel wrappers."""

from __future__ import annotations

import ctypes

import torch

ACT_CODES = {None: 0, "tanh": 1, "relu": 2}


def apply_act(h: torch.Tensor, act) -> torch.Tensor:
    if act == "tanh":
        return torch.tanh(h)
    if act == "relu":
        return torch.relu(h)
    if act is None:
        return h
    raise ValueError(f"unsupported activation {act}")


def check_forward_only(*tensors: torch.Tensor) -> None:
    """The kernels have no backward yet: refuse inputs autograd would track."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            "the gcm_tpu_torch kernels are forward only; call under "
            "torch.no_grad() (their autograd Functions come with training)")


def check_cuda_f32(name: str, t: torch.Tensor, shape: tuple,
                   device: torch.device) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: the kernel takes CUDA tensors, got {t.device}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name}: the kernel takes float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_aligned16(name: str, t: torch.Tensor) -> None:
    """The kernel reads adjacency rows as float4: 16-byte aligned data."""
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary")


def check_sizes(B: int, N: int, widths) -> None:
    """The shapes the kernel takes (csrc/dense_gnn.cu::valid_stack)."""
    if not 1 <= B <= 65535:
        raise ValueError(f"batch {B} outside 1..65535")
    if N % 16 or not 16 <= N <= 1024:
        raise ValueError(f"graph size {N} must be a multiple of 16 in 16..1024")
    if not 1 <= len(widths) - 1 <= 4:
        raise ValueError(f"{len(widths) - 1} layers; the kernel takes 1..4")
    if any(not 1 <= w <= 128 for w in widths):
        raise ValueError(f"feature widths {list(widths)} must be in 1..128")


def ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def stream_of(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check_rc(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {rc}")
