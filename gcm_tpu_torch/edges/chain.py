"""Chaining of edge selectors (counterpart of gcm_tpu/edges/chain.py): each
selector gets the adjacency the previous one produced, and its own part of
the step's noise."""

from __future__ import annotations

from torch import nn

from gcm_tpu_torch.utils.ste import noise_shape


class EdgeChain(nn.Module):
    def __init__(self, selectors):
        super().__init__()
        self.selectors = nn.ModuleList(selectors)

    def noise_shape(self, B: int, N: int):
        """The noise each selector consumes in one step, as a list."""
        return [noise_shape(s, B, N) for s in self.selectors]

    def forward(self, nodes, adj, weights, num_nodes, noise=None):
        noise = noise or [None] * len(self.selectors)
        for s, n in zip(self.selectors, noise):
            adj, weights = s(nodes, adj, weights, num_nodes, noise=n)
        return adj, weights
