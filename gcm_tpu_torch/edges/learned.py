"""Learned (differentiable) edge selector, dense API (counterpart of
gcm_tpu/edges/learned.py): an MLP scores every (current || past node) pair;
the logits go through spardmax (deterministic) or a Gumbel softmax
thresholded at 1 / (1 + num_edge_samples) (stochastic), and the edges merge
into adjacency row num_nodes[b] through a straight-through step of the sum,
so that chained selectors' gradients do not accumulate. Slots that are not
past nodes get the logit -1e10.
"""

from __future__ import annotations

import torch
from torch import nn

from gcm_tpu_torch.nn.module import MLP, LayerNorm, Linear
from gcm_tpu_torch.utils.ste import gumbel_softmax, spardmax, ste


def default_edge_network(input_size: int, init: str = "torch", *,
                         device=None,
                         generator: torch.Generator | None = None) -> MLP:
    """The reference's scorer: Linear(2F, F), ReLU, LayerNorm, Linear(F, F),
    ReLU, LayerNorm, Linear(F, 1)."""
    F = input_size
    return MLP([
        Linear(2 * F, F, init=init, device=device, generator=generator),
        torch.relu, LayerNorm(F, device=device),
        Linear(F, F, init=init, device=device, generator=generator),
        torch.relu, LayerNorm(F, device=device),
        Linear(F, 1, init=init, device=device, generator=generator),
    ])


class LearnedEdge(nn.Module):
    def __init__(self, input_size: int = 0, model: MLP | None = None,
                 num_edge_samples: int = 5, deterministic: bool = False, *,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        if not (input_size or model):
            raise ValueError("give input_size or model")
        self.deterministic = deterministic
        self.num_edge_samples = num_edge_samples
        self.edge_network = model if model is not None else \
            default_edge_network(input_size, device=device,
                                 generator=generator)

    def noise_shape(self, B: int, N: int):
        return None if self.deterministic else (B, N)

    def edges(self, nodes, num_nodes, noise=None):
        """(edge values [B, N], candidate mask [B, N]) for row num_nodes[b]."""
        B, N = nodes.shape[0], nodes.shape[1]
        idx = torch.clamp(num_nodes, 0, N - 1).long()
        curr = nodes[torch.arange(B, device=nodes.device), idx]
        net_in = torch.cat([curr[:, None, :].expand_as(nodes), nodes], dim=-1)
        logits = self.edge_network(net_in)[..., 0]
        cand = torch.arange(N, device=nodes.device)[None, :] \
            < num_nodes[:, None]
        shaped = torch.where(cand, logits, -1e10)
        if self.deterministic:
            return spardmax(shaped, axis=-1), cand
        soft = gumbel_softmax(shaped, axis=-1, noise=noise)
        return ste(soft - 1.0 / (1 + self.num_edge_samples)), cand

    def forward(self, nodes, adj, weights, num_nodes, noise=None):
        B, N = adj.shape[0], adj.shape[1]
        edges, cand = self.edges(nodes, num_nodes, noise)
        b_idx = torch.arange(B, device=adj.device)
        row = torch.clamp(num_nodes, 0, N - 1).long()
        old_row = adj[b_idx, row]
        adj = adj.clone()
        adj[b_idx, row] = torch.where(cand, ste(edges + old_row), old_row)
        return adj, weights
