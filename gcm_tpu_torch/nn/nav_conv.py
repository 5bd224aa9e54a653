"""Pose-aware graph convolution for navigation GNNs (counterpart of
gcm_tpu/nn/nav_conv.py): messages conditioned on the pose of the source
relative to the sink,

    m[i] = sum_j adj[i, j] * MLP(x_j | (pos_j - pos_i) | (rot_j - rot_i))
    out[i] = lin_root(x_i) + m[i]

in plain PyTorch, as the JAX package computes it outside any kernel: one
broadcast pairwise tensor [B, V, V, .] and the MLP's products over it.
"""

from __future__ import annotations

import torch
from torch import nn

from gcm_tpu_torch.device import resolve_device
from gcm_tpu_torch.nn.module import Linear


class NavRelPosConv(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, pos_dim: int = 2,
                 rot_dim: int = 1, hidden: int | None = None, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        device = resolve_device(device)
        self.in_dim = in_dim
        self.out_dim = out_dim
        self.pos_dim = pos_dim
        self.rot_dim = rot_dim
        h = hidden or out_dim
        kw = dict(device=device, generator=generator)
        self.msg1 = Linear(in_dim + pos_dim + rot_dim, h, **kw)
        self.msg2 = Linear(h, out_dim, **kw)
        self.lin_root = Linear(in_dim, out_dim, use_bias=False, **kw)

    def messages(self, x_src, adj, pos_src, pos_sink, rot_src, rot_sink):
        """sum_j adj[.., i, j] * MLP(x_j | pos_j - pos_i | rot_j - rot_i)
        for sinks i of pos_sink [B, S, P] over sources j of x_src
        [B, V, F] (adj [B, S, V]) -> [B, S, out]."""
        B, S, V = adj.shape
        rel_pos = pos_src[:, None, :, :] - pos_sink[:, :, None, :]
        rel_rot = rot_src[:, None, :, :] - rot_sink[:, :, None, :]
        x_j = x_src[:, None, :, :].expand(B, S, V, x_src.shape[-1])
        msg_in = torch.cat([x_j, rel_pos, rel_rot], dim=-1)
        m = self.msg2(torch.relu(self.msg1(msg_in)))
        m = m * adj[..., None].to(m.dtype)
        return m.sum(dim=2)

    def forward(self, x, adj_mask, pos, rot):
        """x [B, V, F], adj_mask [B, V, V] (j -> i), pos [B, V, P], rot
        [B, V, R] -> [B, V, out]."""
        return self.messages(x, adj_mask, pos, pos, rot, rot) \
            + self.lin_root(x)


class NavPoseGNN(nn.Module):
    """A stack of NavRelPosConv layers and activations with the NavGCM GNN
    signature gnn(x, adj_mask, pos, rot, valid, T, taus)."""

    def __init__(self, layers):
        super().__init__()
        self.layers = list(layers)
        self.blocks = nn.ModuleList(
            [m for m in self.layers if isinstance(m, nn.Module)])

    def forward(self, x, adj_mask, pos, rot, valid=None, T=None, taus=None):
        for layer in self.layers:
            x = (layer(x, adj_mask, pos, rot)
                 if isinstance(layer, NavRelPosConv) else layer(x))
        return x
