"""Temporal edge selector, sparse (time-batched) API (counterpart of
gcm_tpu/edges/sparse_temporal.py): connect each newly inserted node
T[b] + i, i < taus[b], to the node `hop` steps before it, for each hop.
Edges need source >= 0 and sink > 0.

Sparse selector API: `selector(nodes, T, taus, t, seg_mask=None,
generator=None, noise=None)` returns (grid [B, t, N], aux), where
grid[b, i, j] = w means an edge sink T[b] + i <- source j of weight w (0:
no edge). A grid has one lane per (sink, source) pair, so a call never
emits a duplicate edge. `emit_edges` gives the same edges without the
grid. A stochastic selector draws its Gumbel noise from `generator`, or
takes it as `noise` (the shape of its logits); the deterministic ones take
neither.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn


class TemporalEdge(nn.Module):
    def __init__(self, hops: Sequence[int] = (1,)):
        super().__init__()
        self.hops = tuple(hops)

    def reach_bound_per_hop(self) -> int:
        """Every edge this selector emits steps back at most max(hops) ids,
        so the k-hop reachable set around t output nodes has at most
        t + k * max(hops) members (for a state whose whole edge history
        came from this selector)."""
        return max(self.hops) if self.hops else 0

    def forward(self, nodes, T, taus, t: int, seg_mask=None, generator=None,
                noise=None):
        B, N, _ = nodes.shape
        i = torch.arange(t, device=nodes.device)[None, :]
        sink = T[:, None] + i                                  # [B, t]
        new_valid = i < taus[:, None]
        grid = torch.zeros((B, t, N), dtype=nodes.dtype, device=nodes.device)
        src_iota = torch.arange(N, device=nodes.device)[None, None, :]
        for hop in self.hops:
            source = sink - hop
            ok = new_valid & (source >= 0) & (sink > 0)
            onehot = (src_iota == source[..., None]) & ok[..., None]
            grid = torch.maximum(grid, onehot.to(nodes.dtype))
        if seg_mask is not None:
            # episode-aware replay: no edge crosses an episode boundary
            grid = grid * seg_mask.to(grid.dtype)
        return grid, {}

    def emit_edges(self, nodes, T, taus, t: int, seg_mask=None,
                   generator=None, noise=None):
        """The grid-free path: the K = t * len(hops) edges directly, in the
        grid path's order (per new node i, sources ascending, i.e. hops
        descending). Returns (new_edges [B, 2, K] int32, weights [B, K],
        valid [B, K], aux)."""
        B = nodes.shape[0]
        i = torch.arange(t, device=nodes.device)[None, :]
        sink_t = (T[:, None] + i).to(torch.int32)             # [B, t]
        new_valid = i < taus[:, None]
        sinks, srcs, valids = [], [], []
        for h in sorted(self.hops, reverse=True):
            src = sink_t - h
            ok = new_valid & (src >= 0) & (sink_t > 0)
            if seg_mask is not None:
                # same-episode constraint: seg_mask[b, i, src]
                safe = torch.clamp(src, 0, seg_mask.shape[-1] - 1).long()
                ok = ok & torch.gather(seg_mask, 2, safe[:, :, None])[:, :, 0]
            sinks.append(sink_t)
            srcs.append(src)
            valids.append(ok)
        # interleave per i: [B, t, H] -> [B, t * H]
        st_ = torch.stack(sinks, dim=-1).reshape(B, -1)
        sr_ = torch.stack(srcs, dim=-1).reshape(B, -1)
        ok_ = torch.stack(valids, dim=-1).reshape(B, -1)
        new_e = torch.stack([torch.where(ok_, st_, -1),
                             torch.where(ok_, sr_, -1)], dim=1)
        w = torch.ones((B, new_e.shape[-1]), dtype=nodes.dtype,
                       device=nodes.device)
        return new_e, w, ok_, {}
