"""The dense recurrent graph-memory state and its fixed-shape update ops
(counterpart of gcm_tpu/core/graph_state.py, dense half).

`DenseGraphState`: nodes [B,N,F], adj [B,N,N], weights [B,N,N] or a size-0
placeholder, num_nodes [B] int32. Raggedness lives in `num_nodes`, never in
shapes. The ops return new tensors and leave their inputs as they were.
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
