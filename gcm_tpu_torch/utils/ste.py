"""Straight-through estimators and sparse / hard softmax activations
(counterpart of gcm_tpu/utils/ste.py).

The stochastic functions take their Gumbel noise either as `noise=` (a
tensor of the logits' shape) or draw it from an explicit `generator=`:
torch cannot reproduce JAX's random bits, so a test hands both frameworks
the same noise. `noise_for` draws the noise a selector consumes in one step
from the shape it declares (`noise_shape`).
"""

from __future__ import annotations

import torch


class _STE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return (x > 0).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g


def ste(x: torch.Tensor) -> torch.Tensor:
    """Binary step with a straight-through gradient: (x > 0) as x's dtype
    forward, identity backward."""
    return _STE.apply(x)


def straight_through(y_hard: torch.Tensor, y_soft: torch.Tensor):
    """`y_hard` forward, `y_soft`'s gradient backward."""
    return y_hard - y_soft.detach() + y_soft


def sparsemax(logits: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Sparsemax (Martins & Astudillo 2016), the Euclidean projection onto
    the simplex, sort-based and fixed-shape."""
    logits = logits.movedim(axis, -1)
    d = logits.shape[-1]
    z_sorted = torch.sort(logits, dim=-1, descending=True).values
    z_cumsum = torch.cumsum(z_sorted, dim=-1)
    k = torch.arange(1, d + 1, dtype=logits.dtype, device=logits.device)
    support = 1.0 + k * z_sorted > z_cumsum
    k_z = support.sum(dim=-1, keepdim=True).to(logits.dtype)
    tau_sum = torch.gather(z_cumsum, -1,
                           torch.clamp(k_z.long() - 1, min=0))
    tau = (tau_sum - 1.0) / torch.clamp_min(k_z, 1.0)
    out = torch.clamp_min(logits - tau, 0.0)
    return out.movedim(-1, axis)


def spardmax(logits, axis: int = -1, cutoff: float = 0.0):
    """Hard sparsemax with a straight-through gradient."""
    y_soft = sparsemax(logits, axis=axis)
    return straight_through((y_soft > cutoff).to(logits.dtype), y_soft)


def hardmax(logits, axis: int = -1, cutoff: float = 0.2):
    """Hard softmax with a straight-through gradient."""
    y_soft = torch.softmax(logits, dim=axis)
    return straight_through((y_soft > cutoff).to(logits.dtype), y_soft)


def sample_gumbel(shape, generator: torch.Generator, device=None,
                  dtype=torch.float32) -> torch.Tensor:
    """Standard Gumbel(0, 1) noise, -log(-log(u)) with u uniform in
    [tiny, 1), drawn on the generator's device and moved to `device`."""
    u = torch.rand(shape, generator=generator, device=generator.device,
                   dtype=dtype)
    u = torch.clamp_min(u, torch.finfo(dtype).tiny)
    return (-torch.log(-torch.log(u))).to(device)


def _gumbel(logits, generator, noise):
    if noise is not None:
        if tuple(noise.shape) != tuple(logits.shape):
            raise ValueError(f"noise of shape {tuple(noise.shape)} for logits "
                             f"of shape {tuple(logits.shape)}")
        return noise.to(logits.dtype)
    if generator is None:
        raise ValueError("a stochastic function needs generator= or noise=")
    return sample_gumbel(logits.shape, generator, logits.device, logits.dtype)


def _one_hot_argmax(y_soft, axis):
    idx = torch.argmax(y_soft, dim=axis, keepdim=True)
    return torch.zeros_like(y_soft).scatter_(axis, idx, 1.0)


def gumbel_softmax(logits, tau=1.0, hard: bool = False, axis: int = -1, *,
                   generator: torch.Generator | None = None,
                   noise: torch.Tensor | None = None):
    """softmax((logits + gumbel) / tau); with hard=True the one-hot argmax
    with a straight-through gradient."""
    y_soft = torch.softmax((logits + _gumbel(logits, generator, noise)) / tau,
                           dim=axis)
    if not hard:
        return y_soft
    return straight_through(_one_hot_argmax(y_soft, axis), y_soft)


def masked_softmax(logits, mask, axis: int = -1, tau=1.0):
    """Softmax over the entries where `mask` is True; the others get 0, and
    a row with no such entry is all zeros."""
    finfo = torch.finfo(logits.dtype)
    z = torch.where(mask, logits / tau, finfo.min)
    z = z - torch.amax(z, dim=axis, keepdim=True).detach()
    e = torch.where(mask, torch.exp(z), 0.0)
    denom = torch.sum(e, dim=axis, keepdim=True)
    return e / torch.clamp_min(denom, finfo.tiny)


def masked_gumbel_softmax(logits, mask, axis: int = -1, tau=1.0,
                          hard: bool = False, *,
                          generator: torch.Generator | None = None,
                          noise: torch.Tensor | None = None):
    """Gumbel-softmax over the masked-in entries: the noise is added to the
    logits, then the sum divided by tau."""
    g = _gumbel(logits, generator, noise)
    return masked_tempered_softmax(logits + g, mask, axis=axis, tau=tau,
                                   hard=hard)


def masked_tempered_softmax(logits, mask, axis: int = -1, tau=1.0,
                            hard: bool = False):
    """Deterministic tempered softmax over the masked-in entries."""
    y_soft = masked_softmax(logits, mask, axis=axis, tau=tau)
    if not hard:
        return y_soft
    y_hard = _one_hot_argmax(y_soft, axis) * mask.to(y_soft.dtype)
    return straight_through(y_hard, y_soft)


def diff_or(tensors) -> torch.Tensor:
    """Differentiable OR over {0, 1} tensors."""
    res = torch.zeros_like(tensors[0])
    for t in tensors:
        res = res + t - res * t
    return res


def noise_shape(selector, B: int, N: int):
    """The shape of the Gumbel noise `selector` consumes in one step over a
    [B, N]-node graph: None when it draws none."""
    fn = getattr(selector, "noise_shape", None)
    return None if fn is None else fn(B, N)


def noise_for(shape, generator: torch.Generator | None, device):
    """Gumbel noise for a declared noise shape: None for none, a tensor for
    a shape tuple, a list for a list of shapes (an EdgeChain's)."""
    if shape is None:
        return None
    if isinstance(shape, list):
        return [noise_for(s, generator, device) for s in shape]
    if generator is None:
        raise ValueError("a stochastic edge selector needs generator= or "
                         "noise=")
    return sample_gumbel(shape, generator, device)


def grad_preserving_ones(values: torch.Tensor) -> torch.Tensor:
    """`v / v.detach()`: 1.0 forward, d/dv = 1/v backward. Sets new edge
    weights to exactly 1.0 while keeping a gradient path into what
    produced them."""
    return values / values.detach()
