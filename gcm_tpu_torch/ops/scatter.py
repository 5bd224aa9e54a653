"""Fixed-shape masked scatter/gather primitives over padded edge lists
(counterpart of gcm_tpu/ops/scatter.py).

Conventions:
- Edge lists are padded: `edges [B, 2, E]` int32, row 0 = sink, row 1 =
  source (`adj[b, sink, source]`); unused lanes hold the sentinel -1.
- Every op keeps its shapes fixed: an invalid lane is routed to a trash row
  or column (index N, or E for edge slots) of a buffer padded by one, which
  is dropped afterwards. So duplicate writes only ever meet in the trash.
  The ops that rewrite state (`row_set`, `rows_set`, `append_edges`) keep
  that one trash slot after the whole flattened buffer, so what they return
  is contiguous, as the kernels take it.

Index tensors stay int32 in the state; they become int64 only where torch
indexes with them. `//` and `%` on tensors are floor operations, as in jnp.

`edge_scatter_add` is the XLA-side aggregation of the JAX package, kept for
parity: it clamps an out-of-range source to N - 1. The spmm kernels
(ops/cuda/spmm.py) instead drop any lane whose sink or source is outside
0..N-1.

The sums use `scatter_add_`, which on a CUDA tensor adds with atomics in no
fixed order (and, unlike `index_put_` with accumulate, never waits for the
host): there `edge_scatter_add` and `edge_weight_scatter_add` may differ in
the last bit between runs; `edge_scatter_count` sums ones and stays exact.
The plain versions of the spmm kernels instead add in lane order through
`in_order_slots` and `in_order_sum`, as the kernels do, so that a kernel
and its plain version agree bitwise.
"""

from __future__ import annotations

import torch


def take_along(a, idx):
    """a[b, idx[b, k]] for a [B, M] and idx [B, K] of any integer type."""
    return torch.gather(a, 1, idx.long())


def _flat_set(target, dim_len, lead, idx, ok, values):
    """A contiguous copy of target [B, *lead, L, ...] with
    target[b, *lead, idx[b, ...]] = values where ok; other writes go to one
    trash slot after the flattened buffer. `lead` holds the (broadcastable)
    indices of the axes between the batch and the written one."""
    B = target.shape[0]
    inner = tuple(target.shape[2 + len(lead):])
    flat = torch.cat([target.reshape((-1,) + inner),
                      torch.zeros((1,) + inner, dtype=target.dtype,
                                  device=target.device)])
    pos = torch.arange(B, device=target.device).reshape(
        (B,) + (1,) * (idx.dim() - 1))
    for ax, li in enumerate(lead):
        pos = pos * target.shape[1 + ax] + li
    pos = pos * dim_len + idx.long()
    flat[torch.where(ok, pos, flat.shape[0] - 1)] = values.to(target.dtype)
    return flat[:-1].view(target.shape)


def row_set(target, row_idx, values, mask=None):
    """target[b, row_idx[b]] = values[b] (where mask[b]), fixed-shape.
    target [B, N, ...]; row_idx [B]; values [B, ...]."""
    N = target.shape[1]
    ok = (row_idx >= 0) & (row_idx < N)
    if mask is not None:
        ok = ok & mask
    return _flat_set(target, N, (), row_idx, ok, values)


def rows_set(target, row_idx, values, mask):
    """target[b, row_idx[b, k]] = values[b, k] where mask[b, k].
    target [B, N, ...]; row_idx [B, K]; values [B, K, ...]; mask [B, K]."""
    N = target.shape[1]
    return _flat_set(target, N, (), row_idx,
                     mask & (row_idx >= 0) & (row_idx < N), values)


def edge_mask(edges):
    """Validity mask [B, E] of a padded edge list (sentinel -1: invalid)."""
    return (edges[:, 0, :] >= 0) & (edges[:, 1, :] >= 0)


def gather_nodes(x, idx):
    """x[b, idx[b, k]] with idx clamped into 0..N-1. x [B, N, F], idx
    [B, K] -> [B, K, F]."""
    N = x.shape[1]
    safe = torch.clamp(idx.long(), 0, N - 1)
    return torch.gather(x, 1, safe[..., None].expand(-1, -1, x.shape[2]))


def _sink_or_trash(edges, valid, num_nodes):
    """The sink of each valid lane; N for an invalid lane or a sink past
    the graph (JAX drops such an out-of-range scatter)."""
    sink = edges[:, 0, :].long()
    return torch.where(valid & (sink < num_nodes), sink, num_nodes)


def edge_scatter_add(x, edges, weights=None, num_nodes=None):
    """out[b, i] = sum over e with sink_e = i of w_e * x[b, src_e], with the
    source clamped into range. x [B, N, F]; edges [B, 2, E]; weights [B, E]
    or None -> [B, num_nodes or N, F]."""
    B, N, F = x.shape
    if num_nodes is None:
        num_nodes = N
    valid = edge_mask(edges)
    sink = _sink_or_trash(edges, valid, num_nodes)
    msgs = gather_nodes(x, edges[:, 1, :])
    if weights is not None:
        msgs = msgs * weights[..., None].to(x.dtype)
    msgs = torch.where(valid[..., None], msgs, 0.0)
    out = torch.zeros((B, num_nodes + 1, F), dtype=x.dtype, device=x.device)
    out.scatter_add_(1, sink[..., None].expand(-1, -1, F), msgs)
    return out[:, :num_nodes]


def edge_scatter_count(edges, num_nodes: int):
    """In-degree per sink node, [B, N] float32."""
    B = edges.shape[0]
    valid = edge_mask(edges)
    sink = _sink_or_trash(edges, valid, num_nodes)
    deg = torch.zeros((B, num_nodes + 1), dtype=torch.float32,
                      device=edges.device)
    deg.scatter_add_(1, sink, valid.to(torch.float32))
    return deg[:, :num_nodes]


def edge_weight_scatter_add(edges, weights, num_nodes: int):
    """Weighted in-degree per sink node, [B, N]."""
    B = edges.shape[0]
    valid = edge_mask(edges)
    sink = _sink_or_trash(edges, valid, num_nodes)
    w = torch.where(valid, weights, 0.0)
    deg = torch.zeros((B, num_nodes + 1), dtype=weights.dtype,
                      device=edges.device)
    deg.scatter_add_(1, sink, w)
    return deg[:, :num_nodes]


def edge_scatter_max(x, edges, num_nodes=None, fill: float = 0.0):
    """Max over in-neighbours' features; sinks with no edges get `fill`."""
    B, N, F = x.shape
    if num_nodes is None:
        num_nodes = N
    valid = edge_mask(edges)
    sink = _sink_or_trash(edges, valid, num_nodes)
    msgs = gather_nodes(x, edges[:, 1, :])
    neg = torch.finfo(x.dtype).min
    msgs = torch.where(valid[..., None], msgs, neg)
    out = torch.full((B, num_nodes + 1, F), neg, dtype=x.dtype,
                     device=x.device)
    out.scatter_reduce_(1, sink[..., None].expand(-1, -1, F), msgs, "amax",
                        include_self=True)
    out = out[:, :num_nodes]
    return torch.where(out == neg, fill, out)


def bucket_rank(keyid):
    """Per-lane rank within its key group: the count of earlier lanes with
    the same key. keyid [B, E] int -> [B, E] int32."""
    B, E = keyid.shape
    order = torch.argsort(keyid, dim=-1, stable=True)
    ks = torch.gather(keyid, 1, order)
    pos = torch.arange(E, device=keyid.device)[None, :].expand(B, E)
    first = torch.cat([torch.ones((B, 1), dtype=torch.bool,
                                  device=keyid.device),
                       ks[:, 1:] != ks[:, :-1]], dim=-1)
    seg_start = torch.cummax(torch.where(first, pos, -1), dim=1).values
    rank = torch.empty_like(pos)
    rank.scatter_(1, order, pos - seg_start)  # back to lane order
    return rank.to(torch.int32)


def in_order_slots(dest, num_rows: int, depth: int | None = None):
    """The lanes of each row in lane order: dest [B, L] gives each lane's
    row (one outside 0..num_rows-1 adds to none) -> slots [B, num_rows,
    depth] int64, padded with L. depth is the most lanes into one row; left
    None it is found, with one host wait. A larger one pads more; a smaller
    one loses lanes."""
    B, L = dest.shape
    ok = (dest >= 0) & (dest < num_rows)
    key = torch.where(ok, dest.long(), num_rows)
    rank = bucket_rank(key).long()
    if depth is None:
        depth = int(torch.where(ok, rank + 1, 0).max()) if L else 0
    keep = ok & (rank < depth)
    slots = torch.full((B, num_rows + 1, depth + 1), L, dtype=torch.long,
                       device=dest.device)
    lane = torch.arange(L, device=dest.device).expand(B, L)
    slots[torch.arange(B, device=dest.device)[:, None],
          torch.where(keep, key, num_rows),
          torch.where(keep, rank, depth)] = lane  # the rest in the trash
    return slots[:, :num_rows, :depth]


def in_order_sum(msgs, slots):
    """out[b, r] = ((0 + msgs[b, slots[b, r, 0]]) + msgs[b, slots[b, r, 1]])
    + ..., one add at a time in msgs' dtype, a slot of L adding nothing.
    msgs [B, L, F], slots [B, R, D] -> [B, R, F]. Every output is summed in
    this one order, so the result is bitwise the same on any device and in
    every run (a scatter_add_ on a CUDA tensor adds in no fixed order)."""
    B, L, F = msgs.shape
    padded = torch.cat([msgs, msgs.new_zeros((B, 1, F))], dim=1)
    out = msgs.new_zeros((B, slots.shape[1], F))
    for d in range(slots.shape[2]):
        out = out + torch.gather(padded, 1,
                                 slots[:, :, d, None].expand(-1, -1, F))
    return out


def nonzero_padded(mask, k: int):
    """Indices of the True entries of mask [B, M], in their original order,
    padded to k per batch. Returns (idx [B, k] int32, valid [B, k] bool,
    count [B] int32). True entries beyond k are dropped. Invalid lanes hold
    the indices of the first False entries, ascending, as the JAX package's
    `lax.top_k` gives them: a stable descending sort breaks ties toward
    lower indices in the same way."""
    M = mask.shape[-1]
    if k > M:  # extra lanes are invalid padding
        pad = torch.zeros(mask.shape[:-1] + (k - M,), dtype=mask.dtype,
                          device=mask.device)
        mask = torch.cat([mask, pad], dim=-1)
    v, idx = torch.sort(mask.to(torch.int32), dim=-1, descending=True,
                        stable=True)
    count = mask.sum(dim=-1, dtype=torch.int32)
    return idx[..., :k].to(torch.int32), v[..., :k] > 0, count


def append_edges(edges, weights, num_edges, new_edges, new_weights,
                 new_valid):
    """Append each batch's valid new edges at its cursor num_edges[b].
    edges [B, 2, E]; weights [B, E]; num_edges [B]; new_edges [B, 2, K];
    new_weights [B, K]; new_valid [B, K]. Writes past capacity go to the
    trash column. Returns (edges, weights, num_edges, overflowed [B])."""
    B, _, E = edges.shape
    pos = torch.cumsum(new_valid.to(torch.int32), dim=-1) - 1
    dest = num_edges[:, None].long() + pos
    ok = new_valid & (dest < E)
    row = torch.arange(2, device=edges.device)[None, :, None]
    edges = _flat_set(edges, E, (row,), dest[:, None, :],
                      ok[:, None, :], new_edges)
    weights = _flat_set(weights, E, (), dest, ok, new_weights)
    n_new = new_valid.sum(dim=-1, dtype=num_edges.dtype)
    overflowed = num_edges + n_new > E
    num_edges = torch.clamp(num_edges + n_new, max=E)
    return edges, weights, num_edges, overflowed
