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


def needs_grad(*tensors) -> bool:
    """True where autograd tracks one of `tensors` (None allowed): the
    wrapper then goes through its autograd Function; otherwise it calls its
    launcher directly, with no autograd node and no saved tensors."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def check_forward_only(*tensors: torch.Tensor) -> None:
    """Refuse inputs autograd would track, for the kernels that have no
    backward (none in the JAX package either)."""
    if needs_grad(*tensors):
        raise NotImplementedError(
            "this gcm_tpu_torch kernel is forward only, as its JAX "
            "counterpart is; call it under torch.no_grad()")


def check_cuda(name: str, t: torch.Tensor, shape: tuple,
               device: torch.device, dtype=torch.float32) -> None:
    """t is a contiguous CUDA tensor on `device` of `dtype` and `shape`."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: the kernel takes CUDA tensors, got {t.device}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: the kernel takes {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_aligned16(name: str, t: torch.Tensor) -> None:
    """The kernel reads adjacency rows as float4: 16-byte aligned data."""
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary")


GRID = 16  # the dense kernels' row tile


def check_sizes(B: int, N: int, widths) -> None:
    """The shapes the kernel takes (csrc/dense_gnn.cu::valid_stack); the
    wrappers pad a graph size off the grid first (`pad_graph`)."""
    if not 1 <= B <= 65535:
        raise ValueError(f"batch {B} outside 1..65535")
    if N % GRID or not GRID <= N <= 1024:
        raise ValueError(f"graph size {N} must be a multiple of {GRID} in "
                         f"{GRID}..1024")
    if not 1 <= len(widths) - 1 <= 4:
        raise ValueError(f"{len(widths) - 1} layers; the kernel takes 1..4")
    if any(not 1 <= w <= 128 for w in widths):
        raise ValueError(f"feature widths {list(widths)} must be in 1..128")


def grid_rows(N: int) -> int:
    """N rounded up to the dense kernels' row tile."""
    return -(-N // GRID) * GRID


def pad_graph(x: torch.Tensor, adj: torch.Tensor, g=None):
    """x [B, N, F], adj [B, N, N] (and a cotangent g [B, N, F_out]) padded
    to N' = grid_rows(N) rows: zero rows for x and g, zero rows and columns
    for adj. Exact for the dense stack: a padded column of adj is zero, so
    no real row reads a padded row; in the backward the padded rows get a
    zero cotangent at the last layer and, through adj^T's zero rows and
    their own zero gz, at every layer below, so they add nothing to dW or
    db. `unpad_rows` / `unpad_adj` take the real part back. N' == N
    returns the inputs themselves."""
    N = x.shape[1]
    P = grid_rows(N) - N
    if P == 0:
        return (x, adj) if g is None else (x, adj, g)
    x = torch.nn.functional.pad(x, (0, 0, 0, P))
    adj = torch.nn.functional.pad(adj, (0, P, 0, P))
    if g is None:
        return x, adj
    return x, adj, torch.nn.functional.pad(g, (0, 0, 0, P))


def unpad_rows(t: torch.Tensor | None, N: int):
    """The first N rows of a [B, N', F] result (None passes through)."""
    return t if t is None or t.shape[1] == N else t[:, :N].contiguous()


def unpad_adj(t: torch.Tensor | None, N: int):
    """The real [B, N, N] block of a padded adjacency gradient."""
    return t if t is None or t.shape[1] == N else t[:, :N, :N].contiguous()


def ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def stream_of(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check_rc(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {rc}")
