"""Fixed-shape coalesce of padded edge lists (counterpart of
gcm_tpu/ops/coalesce.py): a sort and a segment reduction that merge
duplicate (sink, source) pairs and keep the shapes fixed."""

from __future__ import annotations

import torch

from gcm_tpu_torch.ops.scatter import edge_mask

_REDUCE = {"min": "amin", "max": "amax"}


def coalesce_edges(edges, weights, num_nodes: int, reduce: str = "sum"):
    """Sort a padded edge list by (sink, source) and merge duplicates.
    edges [B, 2, E] (sink, source; -1 sentinel), weights [B, E]; reduce
    'sum' | 'mean' | 'min' | 'max' over the duplicates' weights. Returns
    (edges, weights, num_edges): unique edges at the front, ascending,
    -1 after them."""
    if reduce not in ("sum", "mean", "min", "max"):
        raise ValueError(f"unknown reduce: {reduce}")
    B, _, E = edges.shape
    dev = edges.device
    valid = edge_mask(edges)
    big = num_nodes * (num_nodes + 2)  # larger than any valid key
    key = torch.where(valid, edges[:, 0, :].long() * (num_nodes + 1)
                      + edges[:, 1, :].long(), big)
    order = torch.argsort(key, dim=-1, stable=True)
    key_s = torch.gather(key, 1, order)
    w_s = torch.gather(weights, 1, order)
    valid_s = torch.gather(valid, 1, order)

    first = torch.cat([torch.ones((B, 1), dtype=torch.bool, device=dev),
                       key_s[:, 1:] != key_s[:, :-1]], dim=-1) & valid_s
    seg = torch.cumsum(first.long(), dim=-1) - 1
    seg = torch.where(valid_s, seg, E)  # invalid lanes: trash segment

    if reduce in ("sum", "mean"):
        reduced = torch.zeros((B, E + 1), dtype=weights.dtype, device=dev)
        reduced.scatter_add_(1, seg, torch.where(valid_s, w_s, 0.0))
        if reduce == "mean":
            cnt = torch.zeros_like(reduced)
            cnt.scatter_add_(1, seg, valid_s.to(weights.dtype))
            reduced = reduced / torch.clamp(cnt, min=1.0)
    else:
        reduced = torch.zeros((B, E + 1), dtype=weights.dtype, device=dev)
        reduced.scatter_reduce_(1, seg, w_s, _REDUCE[reduce],
                                include_self=False)

    # unique edges (first occurrences) to the front
    comp_order = torch.argsort((~first).to(torch.int32), dim=-1, stable=True)
    uniq = torch.gather(first, 1, comp_order)
    key_u = torch.gather(key_s, 1, comp_order)
    sink_u = torch.where(uniq, key_u // (num_nodes + 1), -1)
    src_u = torch.where(uniq, key_u % (num_nodes + 1), -1)
    seg_u = torch.gather(seg, 1, comp_order)
    w_u = torch.where(uniq, torch.gather(reduced, 1, torch.clamp(seg_u,
                                                                 max=E)), 0.0)
    out_edges = torch.stack([sink_u, src_u], dim=1).to(edges.dtype)
    num_edges = first.sum(dim=-1, dtype=torch.int32)
    return out_edges, w_u.to(weights.dtype), num_edges
