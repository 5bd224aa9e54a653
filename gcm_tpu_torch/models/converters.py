"""Dense <-> sparse graph format converters (counterpart of
gcm_tpu/models/converters.py): dense_to_sparse followed by sparse_to_dense
gives the adjacency back."""

from __future__ import annotations

import torch

from gcm_tpu_torch.ops.scatter import edge_mask, nonzero_padded


def dense_to_sparse(adj, max_edges: int | None = None):
    """[B, N, N] adjacency -> padded edge list [B, 2, E] (sink, source) and
    weights [B, E] holding the adjacency values. E defaults to N * N
    (lossless); max_edges caps it."""
    B, N, _ = adj.shape
    E = max_edges or N * N
    flat = adj.reshape(B, N * N)
    idx, valid, _ = nonzero_padded(flat > 0, min(E, N * N))
    sink = torch.where(valid, idx // N, -1).to(torch.int32)
    src = torch.where(valid, idx % N, -1).to(torch.int32)
    w = torch.where(valid, torch.gather(flat, 1, idx.long()), 0.0)
    edges = torch.stack([sink, src], dim=1)
    if edges.shape[-1] < E:
        pad = E - edges.shape[-1]
        edges = torch.nn.functional.pad(edges, (0, pad), value=-1)
        w = torch.nn.functional.pad(w, (0, pad))
    return edges, w


def sparse_to_dense(edges, weights, num_nodes: int):
    """Padded edge list -> dense [B, N, N] adjacency holding the weights;
    duplicate edges add up, as a COO to_dense does."""
    B, _, E = edges.shape
    valid = edge_mask(edges)
    sink = edges[:, 0, :].long()
    sink = torch.where(valid & (sink < num_nodes), sink, num_nodes)
    src = torch.clamp(edges[:, 1, :].long(), 0, num_nodes - 1)
    w = (torch.ones((B, E), dtype=torch.float32, device=edges.device)
         if weights is None else weights)
    w = torch.where(valid, w, 0.0)
    adj = torch.zeros((B, (num_nodes + 1) * num_nodes), dtype=w.dtype,
                      device=edges.device)
    adj.scatter_add_(1, sink * num_nodes + src, w)
    return adj.reshape(B, num_nodes + 1, num_nodes)[:, :num_nodes]
