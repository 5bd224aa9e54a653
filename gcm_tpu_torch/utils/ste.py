"""Straight-through helpers (counterpart of gcm_tpu/utils/ste.py). Only the
weight normalisation that SparseGCM uses is ported so far."""

from __future__ import annotations

import torch


def grad_preserving_ones(values: torch.Tensor) -> torch.Tensor:
    """`v / v.detach()`: 1.0 forward, d/dv = 1/v backward. Sets new edge
    weights to exactly 1.0 while keeping a gradient path into what
    produced them."""
    return values / values.detach()
