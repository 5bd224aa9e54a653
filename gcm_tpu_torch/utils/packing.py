"""State packing codec for the RL-framework boundary (counterpart of
gcm_tpu/utils/packing.py): a SparseGraphState crosses as fixed-shape
tensors (nodes, edges [B,2,E] with `edge_fill`, weights [B,1,E] with
`weight_fill`, T), valid edges compacted to the front in their stored
order."""

from __future__ import annotations

import torch

from gcm_tpu_torch.core.graph_state import SparseGraphState
from gcm_tpu_torch.ops.scatter import edge_mask, nonzero_padded, take_along


def pack_hidden(state: SparseGraphState, max_edges: int,
                edge_fill: int = -1, weight_fill: float = 1.0):
    """SparseGraphState -> (nodes, edges [B,2,max_edges], weights
    [B,1,max_edges], T)."""
    nodes, edges, weights, T, _num_edges = state
    B, _, E = edges.shape
    k = min(E, max_edges)
    idx, ok, _ = nonzero_padded(edge_mask(edges), k)
    out_e = torch.full((B, 2, max_edges), edge_fill, dtype=edges.dtype,
                       device=edges.device)
    out_w = torch.full((B, 1, max_edges), weight_fill, dtype=weights.dtype,
                       device=weights.device)
    out_e[:, 0, :k] = torch.where(ok, take_along(edges[:, 0, :], idx), edge_fill)
    out_e[:, 1, :k] = torch.where(ok, take_along(edges[:, 1, :], idx), edge_fill)
    out_w[:, 0, :k] = torch.where(ok, take_along(weights, idx), weight_fill)
    return nodes, out_e, out_w, T


def unpack_hidden(packed, max_edges: int | None = None) -> SparseGraphState:
    """(nodes, edges, weights, T) -> SparseGraphState. Lanes with a negative
    sink or source are invalid. `max_edges` sets the state's edge capacity
    (the packed width by default)."""
    nodes, edges, weights, T = packed
    B, _, E = edges.shape
    cap = max_edges or E
    valid = edge_mask(edges)
    k = min(E, cap)
    idx, ok, _ = nonzero_padded(valid, k)
    out_e = torch.full((B, 2, cap), -1, dtype=torch.int32,
                       device=edges.device)
    out_w = torch.ones((B, cap), dtype=weights.dtype, device=weights.device)
    out_e[:, 0, :k] = torch.where(ok, take_along(edges[:, 0, :], idx), -1) \
        .to(torch.int32)
    out_e[:, 1, :k] = torch.where(ok, take_along(edges[:, 1, :], idx), -1) \
        .to(torch.int32)
    out_w[:, :k] = torch.where(ok, take_along(weights[:, 0, :], idx), 1.0)
    num_edges = valid.sum(dim=-1, dtype=torch.int32)
    return SparseGraphState(nodes, out_e, out_w, T.to(torch.int32), num_edges)
