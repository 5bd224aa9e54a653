"""Positional encoders for the memory graph (counterpart of
gcm_tpu/models/positional.py). The sin/cos table is a parameter, as in the
JAX package; 'cat' mode's reprojection Linear is made at construction, so
`feat_dim` is given up front.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from gcm_tpu_torch.device import resolve_device
from gcm_tpu_torch.nn.module import Linear


def sincos_table(max_len: int, feat_dim: int, dtype=torch.float32,
                 device=None) -> torch.Tensor:
    """Transformer sin/cos table [max_len, d_model], d_model = feat_dim
    rounded up to even."""
    d_model = int(math.ceil(feat_dim / 2) * 2)
    position = torch.arange(max_len, dtype=dtype, device=device)[:, None]
    div_term = torch.exp(torch.arange(0, d_model, 2, dtype=dtype,
                                      device=device)
                         * (-math.log(10000.0) / d_model))
    pe = torch.zeros((max_len, d_model), dtype=dtype, device=device)
    pe[:, 0::2] = torch.sin(position * div_term)
    pe[:, 1::2] = torch.cos(position * div_term)
    return pe


def _valid_rows(x, num_nodes):
    """[B, N, 1] bool: row i <= num_nodes[b]."""
    N = x.shape[1]
    return (torch.arange(N, device=x.device)[None, :]
            <= num_nodes[:, None])[..., None]


class PositionalEncoding(nn.Module):
    """mode='add': x[b, i] += pe[i] for the rows i <= num_nodes[b].
    mode='cat': those rows become [pe[i, :cat_dim], reproject(x[b, i])],
    the features reprojected to feat_dim - cat_dim."""

    def __init__(self, max_len: int = 5000, mode: str = "add",
                 cat_dim: int = 8, feat_dim: int | None = None, *,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        if mode not in ("add", "cat"):
            raise ValueError(f"unknown mode {mode!r}")
        if feat_dim is None:
            raise ValueError("feat_dim is required")
        device = resolve_device(device)
        self.max_len = max_len
        self.mode = mode
        self.cat_dim = cat_dim
        self.feat_dim = feat_dim
        self.pe = nn.Parameter(sincos_table(max_len, feat_dim, device=device))
        self.reproject = (Linear(feat_dim, feat_dim - cat_dim, device=device,
                                 generator=generator)
                          if mode == "cat" else None)

    def forward(self, x, num_nodes, positions=None):
        """positions: optional [B, N] table index per row in place of the
        row index (a node's position within its episode)."""
        B, N, F = x.shape

        def rows(width):
            if positions is None:
                return self.pe[None, :N, :width].expand(B, N, width)
            safe = torch.clamp(positions, 0, self.pe.shape[0] - 1).long()
            return self.pe[safe, :width]

        valid = _valid_rows(x, num_nodes)
        if self.mode == "add":
            return torch.where(valid, x + rows(F), x)
        cat = torch.cat([rows(self.cat_dim), self.reproject(x)], dim=-1)
        return torch.where(valid, cat, x)


class RelativePositionalEncoding(nn.Module):
    """Adds the table rolled so that the current node num_nodes[b] sits at
    position 0: x[b, i] += pe[(i - num_nodes[b]) mod max_len] for the rows
    i <= num_nodes[b]."""

    def __init__(self, max_len: int = 5000, feat_dim: int | None = None, *,
                 device=None):
        super().__init__()
        if feat_dim is None:
            raise ValueError("feat_dim is required")
        self.max_len = max_len
        self.feat_dim = feat_dim
        self.pe = nn.Parameter(sincos_table(
            max_len, feat_dim, device=resolve_device(device)))

    def forward(self, x, num_nodes):
        N, F = x.shape[1], x.shape[2]
        idx = torch.remainder(
            torch.arange(N, device=x.device)[None, :]
            - num_nodes[:, None].long(), self.pe.shape[0])
        return torch.where(_valid_rows(x, num_nodes), x + self.pe[idx, :F], x)
