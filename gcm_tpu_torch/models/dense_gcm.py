"""DenseGCM, the dense-graph associative memory core (counterpart of
gcm_tpu/models/dense_gcm.py). One step:

1. ring-buffer wraparound where num_nodes + 1 > graph_size,
2. insert the raw observation at row num_nodes[b],
3. edge selectors on the raw nodes,
4. the preprocessor over all N rows of a copy,
5. aux edge selectors on the preprocessed (optionally positionally
   encoded) nodes,
6. the GNN over the dense graph,
7. belief = features of the just-inserted node (with `pooled`, the GNN's
   whole output),
8. num_nodes += 1.

The node buffer stores raw observations [B, N, obs]; the preprocessor runs
over every row at every step. With `fused_step` (the default, as in the JAX
package) steps 1-3 compose into one rewrite of each array
(`_call_fused`) wherever every selector has a fused form
(`dense_fused_supported`); both forms give the same result. Stochastic
selectors take Gumbel noise drawn from an explicit torch.Generator, or given
as `noise=`. Dense selector API: selector(nodes, adj, weights, num_nodes,
noise=None) -> (adj, weights). Differentiable end to end: `scan` is what
make_dense_supervised_step (train/train_step.py) trains through, with
`remat=True` recomputing each step in the backward (torch.utils.checkpoint).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from gcm_tpu_torch.core.graph_state import (
    DenseGraphState, dense_initial_state, dense_insert, dense_wrap_overflow,
    reset_where)
from gcm_tpu_torch.device import resolve_device
from gcm_tpu_torch.edges.chain import EdgeChain
from gcm_tpu_torch.edges.dense import DenseEdge
from gcm_tpu_torch.edges.distance import Distance
from gcm_tpu_torch.edges.learned import LearnedEdge
from gcm_tpu_torch.edges.temporal import TemporalBackedge
from gcm_tpu_torch.utils.ste import noise_for, noise_shape, ste
from gcm_tpu_torch.utils.validation import check_dense_inputs

FAST_CORES = "ROADMAP Queue 1 item 7 (the fast cores)"


class _RowColAcc:
    """Accumulates the fused step's writes to adjacency row and column
    num_nodes[b] as (value, written-mask) pairs, so the final rewrite falls
    back to the post-wrap base wherever nothing was written. Selectors that
    read the old row (LearnedEdge, the learned TemporalBackedge) get it from
    `cur_row`, which gathers the base row once, through `base_row_fn`."""

    def __init__(self, B, N, dtype, device, base_row_fn):
        self.row = torch.zeros((B, N), dtype=dtype, device=device)
        self.col = torch.zeros((B, N), dtype=dtype, device=device)
        self.row_m = torch.zeros((B, N), dtype=torch.bool, device=device)
        self.col_m = torch.zeros((B, N), dtype=torch.bool, device=device)
        self._base_row_fn = base_row_fn
        self._base_row = None

    def cur_row(self):
        """Row num_nodes[b] as written so far (the base where unwritten)."""
        if self._base_row is None:
            self._base_row = self._base_row_fn()
        return torch.where(self.row_m, self.row, self._base_row)

    def set_row(self, mask, value):
        self.row = torch.where(mask, value, self.row)
        self.row_m = self.row_m | mask

    def set_col(self, mask, value):
        self.col = torch.where(mask, value, self.col)
        self.col_m = self.col_m | mask

    def set_row_full(self, value):
        self.row = value
        self.row_m = torch.ones_like(self.row_m)


def _dense_selector_row_col(sel, nodes, acc: _RowColAcc, num_nodes, noise):
    """Records into `acc` the writes `sel` would make to adjacency row and
    column num_nodes[b], for the fused step's one rewrite."""
    N = nodes.shape[1]
    iota = torch.arange(N, device=nodes.device)[None, :]
    past = iota < num_nodes[:, None]

    if isinstance(sel, EdgeChain):
        for s, n in zip(sel.selectors, noise or [None] * len(sel.selectors)):
            _dense_selector_row_col(s, nodes, acc, num_nodes, n)
    elif isinstance(sel, TemporalBackedge) and sel.learned:
        # adds to the whole row
        acc.set_row_full(acc.cur_row()
                         + sel._learned_update(num_nodes, N, noise))
    elif isinstance(sel, TemporalBackedge):
        for hop in sel.hops:
            ok = num_nodes >= hop
            hit = (iota == torch.clamp(num_nodes - hop, 0, N - 1)[:, None]) \
                & ok[:, None]
            if sel.direction in ("forward", "both"):
                acc.set_row(hit, 1.0)
            if sel.direction in ("backward", "both"):
                acc.set_col(hit, 1.0)
    elif isinstance(sel, DenseEdge):
        acc.set_row(iota <= num_nodes[:, None], 1.0)  # with the self edge
        acc.set_col(past, 1.0)
    elif isinstance(sel, Distance):
        mask = sel.row_mask(nodes, num_nodes)
        acc.set_row(mask, 1.0)
        if sel.bidirectional:
            acc.set_col(mask, 1.0)
    elif isinstance(sel, LearnedEdge):
        edges, cand = sel.edges(nodes, num_nodes, noise)
        old_row = acc.cur_row()
        acc.set_row_full(torch.where(cand, ste(edges + old_row), old_row))
    else:
        raise NotImplementedError(
            f"fused dense step: unsupported selector {type(sel).__name__}")


def dense_fused_supported(model) -> bool:
    """Can the fused step run this model's selectors? Other selectors run
    in the unfused step."""

    def ok(sel):
        if isinstance(sel, EdgeChain):
            return all(ok(s) for s in sel.selectors)
        return isinstance(sel, (TemporalBackedge, DenseEdge, Distance,
                                LearnedEdge))

    return all(s is None or ok(s)
               for s in (model.edge_selectors, model.aux_edge_selectors))


class DenseGCM(nn.Module):
    def __init__(self, gnn, preprocessor=None, edge_selectors=None,
                 aux_edge_selectors=None, graph_size: int = 128,
                 pooled: bool = False, positional_encoder=None,
                 edge_weights: bool = False, validate: bool = False,
                 fused_step: bool = True, *, device=None):
        super().__init__()
        self.device = resolve_device(device)

        def to_device(m):
            return m.to(self.device) if isinstance(m, nn.Module) else m

        self.gnn = to_device(gnn)
        self.preprocessor = to_device(preprocessor)
        self.edge_selectors = to_device(edge_selectors)
        self.aux_edge_selectors = to_device(aux_edge_selectors)
        self.positional_encoder = to_device(positional_encoder)
        self.graph_size = graph_size
        self.pooled = pooled
        self.edge_weights = edge_weights
        self.validate = validate
        self.fused_step = fused_step

    def initial_state(self, B: int, feat: int,
                      dtype=torch.float32) -> DenseGraphState:
        """Zero hidden state; `feat` is the observation width."""
        return dense_initial_state(B, self.graph_size, feat,
                                   edge_weights=self.edge_weights, dtype=dtype,
                                   device=self.device)

    def step_noise(self, B: int, generator: torch.Generator | None = None):
        """The Gumbel noise one step's stochastic selectors consume, drawn
        from `generator`: {"edge_selectors": ..., "aux_edge_selectors":
        ...}, None where a selector draws none. Raises when a selector is
        stochastic and there is no generator."""
        N = self.graph_size
        return {name: noise_for(noise_shape(getattr(self, name), B, N),
                                generator, self.device)
                for name in ("edge_selectors", "aux_edge_selectors")}

    def forward(self, x: torch.Tensor, state: DenseGraphState,
                generator: torch.Generator | None = None, noise=None):
        """x [B, obs] -> (belief [B, F_out], new state); with pooled=True
        the belief is the GNN's whole output (e.g. [B, N, F_out]).
        Stochastic selectors draw their noise from `generator`, or take it
        from `noise` (a `step_noise` dict). validate=True checks the shapes
        first (raises ShapeError)."""
        if self.validate:
            check_dense_inputs(x, state, self.graph_size)
        if noise is None:
            noise = self.step_noise(x.shape[0], generator)
        if self.fused_step and dense_fused_supported(self):
            return self._call_fused(x, state, noise=noise)
        B = x.shape[0]
        state = dense_wrap_overflow(state)
        state = dense_insert(state, x)
        nodes, adj, weights, num_nodes = state
        dirty_nodes = nodes
        if self.edge_selectors is not None:
            adj, weights = self.edge_selectors(
                dirty_nodes, adj, weights, num_nodes,
                noise=noise["edge_selectors"])
        if self.preprocessor is not None:
            dirty_nodes = self.preprocessor(dirty_nodes)
        if self.aux_edge_selectors is not None:
            enc = dirty_nodes
            if self.positional_encoder is not None:
                enc = self.positional_encoder(dirty_nodes, num_nodes)
            adj, weights = self.aux_edge_selectors(
                enc, adj, weights, num_nodes,
                noise=noise["aux_edge_selectors"])
        node_feats = self.gnn(dirty_nodes, adj, weights)
        mx = node_feats if self.pooled else \
            node_feats[torch.arange(B, device=x.device), num_nodes.long()]
        return mx, DenseGraphState(nodes, adj, weights, num_nodes + 1)

    def _call_fused(self, x, state: DenseGraphState,
                    generator: torch.Generator | None = None, noise=None):
        """Wraparound shift, node insert and every selector write composed
        into one select per array, at the logical index num_nodes[b]."""
        if noise is None:
            noise = self.step_noise(x.shape[0], generator)
        nodes, adj, weights, num_nodes = state
        B = x.shape[0]
        N = self.graph_size
        b_idx = torch.arange(B, device=x.device)
        over = num_nodes + 1 > N
        num2 = torch.where(over, num_nodes - 1, num_nodes)
        om = over[:, None, None]
        i_eq = torch.arange(N, device=x.device)[None, :] == num2[:, None]

        nodes = torch.where(om, F.pad(nodes[:, 1:], (0, 0, 0, 1)), nodes)
        nodes = torch.where(i_eq[..., None], x[:, None, :].to(nodes.dtype),
                            nodes)
        dirty_nodes = nodes

        def base_row_fn():  # row num2 of the post-wrap adjacency
            row = adj[b_idx, torch.clamp(num2, 0, N - 1).long(), :]
            return torch.where(over[:, None], 0.0, row)

        acc = _RowColAcc(B, N, adj.dtype, adj.device, base_row_fn)
        if self.edge_selectors is not None:
            _dense_selector_row_col(self.edge_selectors, dirty_nodes, acc,
                                    num2, noise["edge_selectors"])
        if self.preprocessor is not None:
            dirty_nodes = self.preprocessor(dirty_nodes)
        if self.aux_edge_selectors is not None:
            enc = dirty_nodes
            if self.positional_encoder is not None:
                enc = self.positional_encoder(dirty_nodes, num2)
            _dense_selector_row_col(self.aux_edge_selectors, enc, acc, num2,
                                    noise["aux_edge_selectors"])

        base = torch.where(om, F.pad(adj[:, 1:, 1:], (0, 1, 0, 1)), adj)
        adj = torch.where(i_eq[:, :, None] & acc.row_m[:, None, :],
                          acc.row[:, None, :],
                          torch.where(i_eq[:, None, :] & acc.col_m[:, :, None],
                                      acc.col[:, :, None], base))
        if weights.numel() > 0:
            weights = torch.where(
                om, F.pad(weights[:, 1:, 1:], (0, 1, 0, 1)), weights)

        node_feats = self.gnn(dirty_nodes, adj, weights)
        mx = node_feats if self.pooled else node_feats[b_idx, num2.long()]
        return mx, DenseGraphState(nodes, adj, weights, num2 + 1)

    def scan(self, xs: torch.Tensor, state: DenseGraphState, dones=None,
             remat: bool = False, unroll: int | None = None,
             generator: torch.Generator | None = None, noise=None):
        """Run the recurrence over a trajectory xs [B, T, obs] -> (beliefs
        [B, T, F_out], final state). dones [B, T]: the memory of batch b is
        wiped after the step where dones[b, t] is True. Stochastic selectors
        draw from `generator`, or take noise[t] (a `step_noise` dict) at
        step t. remat=True keeps no step's intermediates for the backward
        but its inputs, and recomputes the step there (one checkpoint a
        step, with the step's noise drawn before it, so the recomputation
        sees the same noise). remat="reverse" (the reversible backward)
        raises until it is ported; any other non-bool remat raises
        ValueError. `unroll` is accepted only at its default: it
        is a compile knob of XLA's scan with no meaning in eager PyTorch."""
        if unroll is not None:
            raise NotImplementedError(
                "unroll is an XLA scan compile knob with no eager meaning")
        if remat == "reverse":
            raise NotImplementedError(
                f"remat='reverse' (the reversible backward) waits for "
                f"{FAST_CORES}")
        if not isinstance(remat, bool):
            raise ValueError(f"remat must be True, False or 'reverse', not "
                             f"{remat!r}")
        outs = []
        for t in range(xs.shape[1]):
            step_noise = (self.step_noise(xs.shape[0], generator)
                          if noise is None else noise[t])
            if remat:
                out, state = checkpoint(self, xs[:, t], state, None,
                                        step_noise, use_reentrant=False)
            else:
                out, state = self(xs[:, t], state, noise=step_noise)
            if dones is not None:
                state = reset_where(state, dones[:, t])
            outs.append(out)
        return torch.stack(outs, dim=1), state
