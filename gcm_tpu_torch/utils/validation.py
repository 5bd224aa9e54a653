"""Shape and dtype contracts of the public model calls (counterpart of
gcm_tpu/utils/validation.py), checked on the host before any work."""

from __future__ import annotations

import torch


class ShapeError(ValueError):
    pass


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ShapeError(msg)


def check_dense_inputs(x, state, graph_size: int):
    """DenseGCM step contract."""
    _check(hasattr(state, "num_nodes"),
           f"DenseGCM expects a DenseGraphState (has num_nodes); got "
           f"{type(state).__name__}")
    nodes, adj, weights, num_nodes = state
    _check(x.dim() == 2, f"x must be [B, feat], got {tuple(x.shape)}")
    B, F = x.shape
    N = graph_size
    _check(tuple(nodes.shape) == (B, N, F),
           f"nodes must be [B={B}, N={N}, F={F}], got {tuple(nodes.shape)}")
    _check(tuple(adj.shape) == (B, N, N),
           f"adj must be [B={B}, N={N}, N={N}], got {tuple(adj.shape)}")
    _check(weights.numel() == 0 or tuple(weights.shape) == (B, N, N),
           f"weights must be numel-0 or [B, N, N], got "
           f"{tuple(weights.shape)}")
    _check(tuple(num_nodes.shape) == (B,),
           f"num_nodes must be [B={B}], got {tuple(num_nodes.shape)}")
    _check(not num_nodes.dtype.is_floating_point
           and num_nodes.dtype != torch.bool,
           f"num_nodes must be integer, got {num_nodes.dtype}")
    _check(x.dtype.is_floating_point, f"x must be floating, got {x.dtype}")


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
