"""Temporal back-edge selector, dense API (counterpart of
gcm_tpu/edges/temporal.py): wires the just-inserted node num_nodes[b] to the
nodes `hop` steps in the past, or, with learned=True, adds to its adjacency
row a learned mask over the last `learning_window` slots: spardmax of the
`window` logits (deterministic) or the OR of `num_samples` hard Gumbel
samples. adj[b, sink, source] convention.

Dense selector API: selector(nodes, adj, weights, num_nodes, noise=None) ->
(adj, weights); `noise_shape(B, N)` is the Gumbel noise one step consumes.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from gcm_tpu_torch.device import resolve_device
from gcm_tpu_torch.utils.ste import diff_or, gumbel_softmax, spardmax


class TemporalBackedge(nn.Module):
    def __init__(self, hops: Sequence[int] = (1,), direction: str = "forward",
                 learned: bool = False, learning_window: int = 10,
                 deterministic: bool = False, num_samples: int = 3, *,
                 device=None):
        super().__init__()
        if direction not in ("forward", "backward", "both"):
            raise ValueError(f"unknown direction {direction!r}")
        self.hops = tuple(hops)
        self.direction = direction
        self.learned = learned
        self.learning_window = learning_window
        self.deterministic = deterministic
        self.num_samples = num_samples
        self.window = (nn.Parameter(torch.ones(
            learning_window, device=resolve_device(device)))
            if learned else None)

    def noise_shape(self, B: int, N: int):
        if not self.learned or self.deterministic:
            return None
        return (self.num_samples, B, self.learning_window)

    def _learned_update(self, num_nodes, N: int, noise=None):
        """The [B, N] addition to adjacency row num_nodes[b]: the learned
        mask over the last learning_window slots."""
        W = self.learning_window
        B = num_nodes.shape[0]
        window = self.window
        cand = torch.arange(W, device=window.device)[None, :] \
            < torch.clamp(num_nodes, max=W)[:, None]
        logits = torch.where(cand, window[None, :],
                             torch.finfo(window.dtype).min)
        if self.deterministic:
            mask = spardmax(logits, axis=-1)
        else:
            if noise is None:
                raise ValueError("a stochastic learned TemporalBackedge needs "
                                 "noise of shape (num_samples, B, window)")
            mask = diff_or([gumbel_softmax(logits, hard=True, noise=n)
                            for n in noise])
        mask = mask * cand.to(mask.dtype)
        if N > W:
            mask = torch.cat([mask, mask.new_zeros((B, N - W))], dim=-1)
        return torch.where((num_nodes > 0)[:, None], mask, 0.0)

    def _deterministic(self, adj, num_nodes):
        B, N = adj.shape[0], adj.shape[1]
        b_idx = torch.arange(B, device=adj.device)
        adj = adj.clone()
        for hop in self.hops:
            valid = num_nodes >= hop
            row = torch.clamp(num_nodes, 0, N - 1).long()
            col = torch.clamp(num_nodes - hop, 0, N - 1).long()
            if self.direction in ("forward", "both"):
                old = adj[b_idx, row, col]
                adj[b_idx, row, col] = torch.where(valid, 1.0, old)
            if self.direction in ("backward", "both"):
                old = adj[b_idx, col, row]
                adj[b_idx, col, row] = torch.where(valid, 1.0, old)
        return adj

    def forward(self, nodes, adj, weights, num_nodes, noise=None):
        del nodes
        if not self.learned:
            return self._deterministic(adj, num_nodes), weights
        B, N = adj.shape[0], adj.shape[1]
        b_idx = torch.arange(B, device=adj.device)
        row = torch.clamp(num_nodes, 0, N - 1).long()
        adj = adj.clone()
        adj[b_idx, row, :] += self._learned_update(num_nodes, N, noise)
        return adj, weights
