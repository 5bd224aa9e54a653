"""DenseGCM, the dense-graph associative memory core (counterpart of
gcm_tpu/models/dense_gcm.py). One step:

1. ring-buffer wraparound where num_nodes + 1 > graph_size,
2. insert the raw observation at row num_nodes[b],
3. edge selectors on the raw nodes,
4. the preprocessor over all N rows of a copy,
5. the GNN over the dense graph,
6. belief = features of the just-inserted node,
7. num_nodes += 1.

The node buffer stores raw observations [B, N, obs]; the preprocessor runs
over every row at every step. With `fused_step` (the default, as in the JAX
package) steps 1-3 compose into one rewrite of each array
(`_call_fused`); both forms give the same result. Forward only: call under
torch.no_grad().
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from gcm_tpu_torch.core.graph_state import (
    DenseGraphState, dense_initial_state, dense_insert, dense_wrap_overflow,
    reset_where)
from gcm_tpu_torch.device import resolve_device
from gcm_tpu_torch.edges.temporal import TemporalBackedge


class _RowColAcc:
    """Accumulates the fused step's writes to adjacency row and column
    num_nodes[b] as (value, written-mask) pairs, so the final rewrite falls
    back to the post-wrap base wherever nothing was written."""

    def __init__(self, B, N, dtype, device):
        self.row = torch.zeros((B, N), dtype=dtype, device=device)
        self.col = torch.zeros((B, N), dtype=dtype, device=device)
        self.row_m = torch.zeros((B, N), dtype=torch.bool, device=device)
        self.col_m = torch.zeros((B, N), dtype=torch.bool, device=device)

    def set_row(self, mask, value):
        self.row = torch.where(mask, value, self.row)
        self.row_m = self.row_m | mask

    def set_col(self, mask, value):
        self.col = torch.where(mask, value, self.col)
        self.col_m = self.col_m | mask


def _dense_selector_row_col(sel, acc: _RowColAcc, num_nodes, N: int):
    """Records into `acc` the writes `sel` would make to adjacency row and
    column num_nodes[b]. Only TemporalBackedge is ported."""
    if not isinstance(sel, TemporalBackedge):
        raise NotImplementedError(
            f"fused dense step: selector {type(sel).__name__} is not ported")
    iota = torch.arange(N, device=num_nodes.device)[None, :]
    for hop in sel.hops:
        ok = num_nodes >= hop
        hit = (iota == torch.clamp(num_nodes - hop, 0, N - 1)[:, None]) \
            & ok[:, None]
        if sel.direction in ("forward", "both"):
            acc.set_row(hit, 1.0)
        if sel.direction in ("backward", "both"):
            acc.set_col(hit, 1.0)


class DenseGCM(nn.Module):
    def __init__(self, gnn, preprocessor=None, edge_selectors=None,
                 graph_size: int = 128, pooled: bool = False,
                 edge_weights: bool = False, fused_step: bool = True, *,
                 device=None):
        super().__init__()
        if pooled:
            raise NotImplementedError("pooled beliefs are not ported yet")
        self.device = resolve_device(device)
        self.gnn = gnn.to(self.device)
        self.preprocessor = (None if preprocessor is None
                             else preprocessor.to(self.device))
        self.edge_selectors = edge_selectors
        self.graph_size = graph_size
        self.edge_weights = edge_weights
        self.fused_step = fused_step

    def initial_state(self, B: int, feat: int,
                      dtype=torch.float32) -> DenseGraphState:
        """Zero hidden state; `feat` is the observation width."""
        return dense_initial_state(B, self.graph_size, feat,
                                   edge_weights=self.edge_weights, dtype=dtype,
                                   device=self.device)

    def forward(self, x: torch.Tensor, state: DenseGraphState):
        """x [B, obs] -> (belief [B, F_out], new state)."""
        if self.fused_step:
            return self._call_fused(x, state)
        B = x.shape[0]
        state = dense_wrap_overflow(state)
        state = dense_insert(state, x)
        nodes, adj, weights, num_nodes = state
        dirty_nodes = nodes
        if self.edge_selectors is not None:
            adj, weights = self.edge_selectors(dirty_nodes, adj, weights,
                                               num_nodes)
        if self.preprocessor is not None:
            dirty_nodes = self.preprocessor(dirty_nodes)
        node_feats = self.gnn(dirty_nodes, adj, weights)
        mx = node_feats[torch.arange(B, device=x.device), num_nodes.long()]
        return mx, DenseGraphState(nodes, adj, weights, num_nodes + 1)

    def _call_fused(self, x, state: DenseGraphState):
        """Wraparound shift, node insert and every selector write composed
        into one select per array, at the logical index num_nodes[b]."""
        nodes, adj, weights, num_nodes = state
        B = x.shape[0]
        N = self.graph_size
        over = num_nodes + 1 > N
        num2 = torch.where(over, num_nodes - 1, num_nodes)
        om = over[:, None, None]
        i_eq = torch.arange(N, device=x.device)[None, :] == num2[:, None]

        nodes = torch.where(om, F.pad(nodes[:, 1:], (0, 0, 0, 1)), nodes)
        nodes = torch.where(i_eq[..., None], x[:, None, :].to(nodes.dtype),
                            nodes)
        dirty_nodes = nodes

        acc = _RowColAcc(B, N, adj.dtype, adj.device)
        if self.edge_selectors is not None:
            _dense_selector_row_col(self.edge_selectors, acc, num2, N)
        if self.preprocessor is not None:
            dirty_nodes = self.preprocessor(dirty_nodes)

        base = torch.where(om, F.pad(adj[:, 1:, 1:], (0, 1, 0, 1)), adj)
        adj = torch.where(i_eq[:, :, None] & acc.row_m[:, None, :],
                          acc.row[:, None, :],
                          torch.where(i_eq[:, None, :] & acc.col_m[:, :, None],
                                      acc.col[:, :, None], base))
        if weights.numel() > 0:
            weights = torch.where(
                om, F.pad(weights[:, 1:, 1:], (0, 1, 0, 1)), weights)

        node_feats = self.gnn(dirty_nodes, adj, weights)
        mx = node_feats[torch.arange(B, device=x.device), num2.long()]
        return mx, DenseGraphState(nodes, adj, weights, num2 + 1)

    def scan(self, xs: torch.Tensor, state: DenseGraphState, dones=None,
             remat: bool = False, unroll: int | None = None):
        """Run the recurrence over a trajectory xs [B, T, obs] -> (beliefs
        [B, T, F_out], final state). dones [B, T]: the memory of batch b is
        wiped after the step where dones[b, t] is True. `remat` and
        `unroll` are accepted only at their defaults."""
        if remat is not False:
            raise NotImplementedError("remat is not ported yet")
        if unroll is not None:
            raise NotImplementedError("unroll is not ported yet")
        outs = []
        for t in range(xs.shape[1]):
            out, state = self(xs[:, t], state)
            if dones is not None:
                state = reset_where(state, dones[:, t])
            outs.append(out)
        return torch.stack(outs, dim=1), state
