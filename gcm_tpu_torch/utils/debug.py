"""Observability helpers (counterpart of gcm_tpu/utils/debug.py)."""

from __future__ import annotations

import torch


def grad_norms(module, prefix: str = "grad_norm") -> dict:
    """Per-parameter L2 norms of the gradients in `.grad`, as a flat
    {f"{prefix}/{path}": scalar tensor} keyed by each parameter's path in
    the JAX parameter tree (e.g. "grad_norm/core/gnn/0/lin_rel/kernel"),
    so that a logger sees the JAX package's names. A parameter with no
    gradient counts 0. The norms stay on the device."""
    # imported here: weights.py knows every module's layout, the RL
    # trainers (which import this) included
    from gcm_tpu_torch.weights import jax_paths

    named = dict(module.named_parameters())
    out = {}
    for name, path in jax_paths(module).items():
        g = named[name].grad
        out[f"{prefix}/{path}"] = (torch.zeros((), device=named[name].device)
                                   if g is None
                                   else torch.sqrt(torch.sum(torch.square(g))))
    return out
