"""Temporal back-edge selector, dense API (counterpart of
gcm_tpu/edges/temporal.py): wires the just-inserted node num_nodes[b] to the
nodes `hop` steps in the past. adj[b, sink, source] convention.

Dense selector API: selector(nodes, adj, weights, num_nodes) -> (adj,
weights).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn


class TemporalBackedge(nn.Module):
    def __init__(self, hops: Sequence[int] = (1,), direction: str = "forward",
                 learned: bool = False):
        super().__init__()
        if direction not in ("forward", "backward", "both"):
            raise ValueError(f"unknown direction {direction!r}")
        if learned:
            raise NotImplementedError(
                "learned temporal edges need the straight-through estimators "
                "(utils/ste.py), which are not ported yet")
        self.hops = tuple(hops)
        self.direction = direction

    def forward(self, nodes, adj, weights, num_nodes):
        del nodes
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
        return adj, weights
