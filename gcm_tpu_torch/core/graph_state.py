"""The recurrent graph-memory states and their fixed-shape update ops
(counterpart of gcm_tpu/core/graph_state.py).

- `DenseGraphState`: nodes [B,N,F], adj [B,N,N], weights [B,N,N] or a
  size-0 placeholder, num_nodes [B] int32.
- `SparseGraphState`: nodes [B,N,F], edges [B,2,E] int32 (row 0 sink, row 1
  source, -1 in unused lanes), weights [B,E], t [B] int32 (nodes in the
  graph), num_edges [B] int32 (valid edges).

Raggedness lives in `num_nodes`, `t` and the sentinels, never in shapes.
The ops return new tensors and leave their inputs as they were.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F


class DenseGraphState(NamedTuple):
    nodes: torch.Tensor      # [B, N, F] float
    adj: torch.Tensor        # [B, N, N] float
    weights: torch.Tensor    # [B, N, N] float, or shape (0,) when unused
    num_nodes: torch.Tensor  # [B] int32


class SparseGraphState(NamedTuple):
    nodes: torch.Tensor      # [B, N, F] float
    edges: torch.Tensor      # [B, 2, E] int32 (sink, source), -1 sentinel
    weights: torch.Tensor    # [B, E] float
    t: torch.Tensor          # [B] int32, nodes in the graph before a call
    num_edges: torch.Tensor  # [B] int32, valid edges


def dense_initial_state(B: int, graph_size: int, feat: int,
                        edge_weights: bool = False, dtype=torch.float32,
                        device=None) -> DenseGraphState:
    """Zero-initialised dense hidden state."""
    N = graph_size
    return DenseGraphState(
        nodes=torch.zeros((B, N, feat), dtype=dtype, device=device),
        adj=torch.zeros((B, N, N), dtype=dtype, device=device),
        weights=torch.zeros((B, N, N) if edge_weights else (0,), dtype=dtype,
                            device=device),
        num_nodes=torch.zeros((B,), dtype=torch.int32, device=device),
    )


def sparse_initial_state(B: int, graph_size: int, feat: int, max_edges: int,
                         edge_fill: int = -1, weight_fill: float = 1.0,
                         dtype=torch.float32, device=None) -> SparseGraphState:
    """Empty sparse hidden state: edges hold `edge_fill`, weights
    `weight_fill` (the packed form's fills)."""
    return SparseGraphState(
        nodes=torch.zeros((B, graph_size, feat), dtype=dtype, device=device),
        edges=torch.full((B, 2, max_edges), edge_fill, dtype=torch.int32,
                         device=device),
        weights=torch.full((B, max_edges), weight_fill, dtype=dtype,
                           device=device),
        t=torch.zeros((B,), dtype=torch.int32, device=device),
        num_edges=torch.zeros((B,), dtype=torch.int32, device=device),
    )


def dense_wrap_overflow(state: DenseGraphState) -> DenseGraphState:
    """Ring-buffer wraparound, batch-selective: where num_nodes + 1 > N, drop
    node 0 (its row and column), shift the rest down by one, free the last
    row and decrement num_nodes. Other batch elements are untouched."""
    nodes, adj, weights, num_nodes = state
    N = nodes.shape[1]
    over = num_nodes + 1 > N
    om = over[:, None, None]
    nodes = torch.where(om, F.pad(nodes[:, 1:], (0, 0, 0, 1)), nodes)
    adj = torch.where(om, F.pad(adj[:, 1:, 1:], (0, 1, 0, 1)), adj)
    if weights.numel() > 0:
        weights = torch.where(om, F.pad(weights[:, 1:, 1:], (0, 1, 0, 1)),
                              weights)
    num_nodes = torch.where(over, num_nodes - 1, num_nodes)
    return DenseGraphState(nodes, adj, weights, num_nodes)


def dense_insert(state: DenseGraphState, x: torch.Tensor) -> DenseGraphState:
    """Insert x [B, F] at row num_nodes[b]. Does not bump num_nodes: the
    model does that at the end of its step."""
    nodes, adj, weights, num_nodes = state
    nodes = nodes.clone()
    nodes[torch.arange(x.shape[0], device=x.device), num_nodes.long()] = \
        x.to(nodes.dtype)
    return DenseGraphState(nodes, adj, weights, num_nodes)


# --- episode-boundary reset protocol ---------------------------------------
# Each state class registers how its memory is wiped when an episode ends.
# A per-class registry, not field-name sniffing: a state type whose fields
# need sentinel fills cannot be zero-reset by accident, because unregistered
# types raise.

_RESET_REGISTRY: dict[type, object] = {}


def register_reset(cls):
    """Decorator: register fn(state, mask_for) -> state as the episode reset
    for `cls`. mask_for(t) returns the [B, 1, ...] broadcastable done mask
    for tensor t, or None for a tensor without a batch axis."""

    def deco(fn):
        _RESET_REGISTRY[cls] = fn
        return fn

    return deco


def zero_reset(state, mask_for):
    """Generic reset: every batch-leading tensor is zeroed where done."""

    def leaf(t):
        m = mask_for(t)
        return t if m is None else torch.where(m, torch.zeros_like(t), t)

    return type(state)(*(leaf(t) for t in state))


def reset_where(state, done: torch.Tensor):
    """Reset the memory of batch elements where done[b] is True, with the
    state class's registered reset. Raises TypeError for unregistered
    classes."""
    fn = _RESET_REGISTRY.get(type(state))
    if fn is None:
        raise TypeError(
            f"no episode reset registered for {type(state).__name__}; "
            "register one with gcm_tpu_torch.core.graph_state.register_reset")
    done = done.to(torch.bool)

    def mask_for(t):
        if t.dim() == 0 or t.shape[0] != done.shape[0]:
            return None
        return done.reshape((-1,) + (1,) * (t.dim() - 1))

    return fn(state, mask_for)


@register_reset(DenseGraphState)
def _reset_dense(state, mask_for):
    return zero_reset(state, mask_for)


@register_reset(SparseGraphState)
def _reset_sparse(state, mask_for):
    """Restore the initial fills: edge sentinel -1, weight 1.0."""
    nodes, edges, weights, t, num_edges = state
    return SparseGraphState(
        nodes=torch.where(mask_for(nodes), 0.0, nodes),
        edges=torch.where(mask_for(edges), -1, edges),
        weights=torch.where(mask_for(weights), 1.0, weights),
        t=torch.where(mask_for(t), 0, t),
        num_edges=torch.where(mask_for(num_edges), 0, num_edges),
    )


def node_validity_mask(num_nodes: torch.Tensor, N: int,
                       inclusive: bool = False) -> torch.Tensor:
    """[B, N] mask of the rows < num_nodes (<= where inclusive)."""
    iota = torch.arange(N, device=num_nodes.device)[None, :]
    if inclusive:
        return iota <= num_nodes[:, None]
    return iota < num_nodes[:, None]
