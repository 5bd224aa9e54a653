"""Fully-connected-past edge selector, dense API (counterpart of
gcm_tpu/edges/dense.py): connects the current node num_nodes[b] both ways
to every past node, plus a self edge."""

from __future__ import annotations

import torch
from torch import nn


class DenseEdge(nn.Module):
    def forward(self, nodes, adj, weights, num_nodes, noise=None):
        del nodes, noise
        N = adj.shape[1]
        iota = torch.arange(N, device=adj.device)
        r, c = iota[None, :, None], iota[None, None, :]
        i = num_nodes[:, None, None]
        # adj[b, i, :i+1] = 1 (with the self edge) and adj[b, :i, i] = 1
        hit = ((r == i) & (c <= i)) | ((c == i) & (r < i))
        return torch.where(hit, 1.0, adj), weights
