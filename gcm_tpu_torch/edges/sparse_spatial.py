"""Spatial edge selectors and the selector chain, sparse (time-batched) API
(counterpart of gcm_tpu/edges/sparse_spatial.py): each new node is wired
to causally earlier nodes by the distance between position slices, over
one batched masked distance grid [B, t, N].

kNN is taken among the causal candidates (the reference takes it over all
nodes and then drops the non-causal edges, which can lose most of them).
The distance is computed in the JAX package's order (differences,
squares, sum, square root), so that ties and the k-th value fall where
JAX's do.
"""

from __future__ import annotations

import torch
from torch import nn


def _causal_grid_mask(T, taus, t: int, N: int):
    """cand[b, i, j] = (i < taus[b]) and (j < T[b] + i): the source before
    the sink, sinks only among the new nodes."""
    dev = T.device
    i = torch.arange(t, device=dev)[None, :]
    j = torch.arange(N, device=dev)[None, None, :]
    sink = T[:, None] + i
    return (i < taus[:, None])[..., None] & (j < torch.clamp(sink, 0, N)
                                             [..., None])


def _pos_dist_grid(nodes, T, t: int, position_slice: slice):
    """dist[b, i, j] = || pos(sink T[b] + i) - pos(j) ||."""
    N = nodes.shape[1]
    pos = nodes[:, :, position_slice]                        # [B, N, P]
    i = torch.arange(t, device=nodes.device)[None, :]
    sink = torch.clamp(T[:, None] + i, 0, N - 1).long()
    sink_pos = torch.gather(pos, 1, sink[..., None].expand(
        -1, -1, pos.shape[-1]))                              # [B, t, P]
    diff = sink_pos[:, :, None, :] - pos[:, None, :, :]      # [B, t, N, P]
    return torch.sqrt(torch.clamp((diff * diff).sum(-1), min=0.0))


class SpatialRadiusEdge(nn.Module):
    """An edge where ||pos_sink - pos_source|| < radius, among causal
    pairs."""

    def __init__(self, position_slice: slice, radius: float = 0.25,
                 causal: bool = True):
        super().__init__()
        if not causal:
            raise ValueError("the non-causal mode is not supported")
        self.position_slice = position_slice
        self.radius = radius

    def forward(self, nodes, T, taus, t: int, seg_mask=None, generator=None,
                noise=None):
        """Deterministic: `generator` and `noise` are not used."""
        cand = _causal_grid_mask(T, taus, t, nodes.shape[1])
        if seg_mask is not None:
            cand = cand & seg_mask
        dist = _pos_dist_grid(nodes, T, t, self.position_slice)
        return (cand & (dist < self.radius)).to(nodes.dtype), {}


class SpatialKNNEdge(nn.Module):
    """The k nearest causal sources of each new node (every source tied
    with the k-th nearest too)."""

    def __init__(self, position_slice: slice, k: int, causal: bool = True):
        super().__init__()
        if not causal:
            raise ValueError("the non-causal mode is not supported")
        self.position_slice = position_slice
        self.k = k

    def forward(self, nodes, T, taus, t: int, seg_mask=None, generator=None,
                noise=None):
        """Deterministic: `generator` and `noise` are not used. Under
        seg_mask, kNN is taken among the same-episode candidates."""
        N = nodes.shape[1]
        cand = _causal_grid_mask(T, taus, t, N)
        if seg_mask is not None:
            cand = cand & seg_mask
        dist = _pos_dist_grid(nodes, T, t, self.position_slice)
        dm = torch.where(cand, dist, torch.finfo(dist.dtype).max)
        kk = min(self.k, N)
        kth = torch.sort(dm, dim=-1).values[..., kk - 1:kk]
        return ((dm <= kth) & cand).to(nodes.dtype), {}


class SparseEdgeChain(nn.Module):
    """Sparse selectors chained: their grids are summed (SparseGCM's weight
    normalization maps any positive sum to one weight-1 edge) and each
    one's aux keys are prefixed with its index. `noise`, where given, is a
    list with one entry per selector."""

    def __init__(self, selectors):
        super().__init__()
        self.selectors = nn.ModuleList(selectors)

    def forward(self, nodes, T, taus, t: int, seg_mask=None, generator=None,
                noise=None):
        noise = noise or [None] * len(self.selectors)
        grid, aux = None, {}
        for idx, (sel, n) in enumerate(zip(self.selectors, noise)):
            g, a = sel(nodes, T, taus, t, seg_mask=seg_mask,
                       generator=generator, noise=n)
            grid = g if grid is None else grid + g
            for k, v in a.items():
                aux[f"{idx}/{k}"] = v
        return grid, aux
