"""Shape and dtype contracts of the public model calls (counterpart of
gcm_tpu/utils/validation.py), checked on the host before any work."""

from __future__ import annotations

import torch


class ShapeError(ValueError):
    pass


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ShapeError(msg)


def check_sparse_inputs(x, taus, state, graph_size: int, max_edges: int):
    """SparseGCM forward contract."""
    nodes, edges, weights, t, _num_edges = state
    _check(x.dim() == 3, f"x must be [B, t, feat], got {tuple(x.shape)}")
    B, _, F = x.shape
    N = graph_size
    _check(tuple(taus.shape) == (B,),
           f"taus must be [B={B}], got {tuple(taus.shape)}")
    _check(not taus.dtype.is_floating_point and taus.dtype != torch.bool,
           f"taus must be integer, got {taus.dtype}")
    _check(tuple(nodes.shape) == (B, N, F),
           f"nodes must be [B={B}, N={N}, F={F}], got {tuple(nodes.shape)}")
    _check(tuple(edges.shape) == (B, 2, max_edges),
           f"edges must be [B, 2, E={max_edges}], got {tuple(edges.shape)}")
    _check(tuple(weights.shape) == (B, max_edges),
           f"weights must be [B, E={max_edges}], got {tuple(weights.shape)}")
    _check(tuple(t.shape) == (B,), f"t must be [B={B}], got {tuple(t.shape)}")
