"""RingDenseGCM, DenseGCM with ring-pointer storage (counterpart of
gcm_tpu/models/ring_gcm.py).

It gives the same beliefs as DenseGCM (graph convolution is permutation
equivariant), but stores the node of step t at slot t mod N instead of
shifting the buffer once the memory is full: eviction zeroes one row and
one column of the adjacency, where DenseGCM's wraparound moves all of it.

Slot geometry: after t steps the cursor is p = t mod N. A slot s holds age
a(s) = (p - s) mod N (0 = the node inserted this step); the valid past
slots are 1 <= a(s) <= min(t, N - 1). DenseGCM's logical row of slot s is
r(s) = min(t + 1, N) - 1 - a(s), which only the positional encoder and the
learned TemporalBackedge read.

Edge selectors run in slot space: TemporalBackedge (every direction,
learned or not), DenseEdge, the Distance family (CosineEdge and SpatialEdge
through the sddmm_threshold_row kernel's explicit entry, scored against
the node at slot p and ANDed with the valid past slots, as JAX ANDs its
distances; EuclideanEdge in plain PyTorch), LearnedEdge and EdgeChain. As
in the JAX package, the ring applies no `Distance.window` mask, so with a
windowed Distance selector the ring and DenseGCM differ.

With `fused_step` (the default, as JAX's config.RING_FUSED_STEP) the
eviction, the insert and every selector's writes compose into one select
per array (`_call_fused`); the unfused step writes each selector's row and
column in turn. Both give the same result. Stochastic selectors take their
Gumbel noise from `generator=` or `noise=` (a `step_noise` dict). The ring
draws the learned TemporalBackedge's noise over its N slots, [num_samples,
B, N], as the JAX ring does.

`window()` is the scan-free forward of models/ring_window.py, with its
card-measured gates `window_profitable` and `window_applicable`;
`scan(remat="reverse")` (the reversible backward) belongs to the fast
cores of ROADMAP Queue 1 item 7 and raises until then.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from gcm_tpu_torch.core.graph_state import (register_reset, reset_where,
                                            zero_reset)
from gcm_tpu_torch.device import resolve_device
from gcm_tpu_torch.edges.chain import EdgeChain
from gcm_tpu_torch.edges.dense import DenseEdge
from gcm_tpu_torch.edges.distance import (CosineEdge, Distance, EuclideanEdge,
                                          SpatialEdge)
from gcm_tpu_torch.edges.learned import LearnedEdge
from gcm_tpu_torch.edges.temporal import TemporalBackedge
from gcm_tpu_torch.models.dense_gcm import FAST_CORES
from gcm_tpu_torch.models.positional import PositionalEncoding
from gcm_tpu_torch.ops.cuda.sddmm import sddmm_threshold_row
from gcm_tpu_torch.ops.distance import euclidean_score
from gcm_tpu_torch.utils.ste import (diff_or, gumbel_softmax, noise_for,
                                     spardmax, ste)
from gcm_tpu_torch.utils.validation import check_ring_inputs


class RingGraphState(NamedTuple):
    nodes: torch.Tensor    # [B, N, F] slot-indexed
    adj: torch.Tensor      # [B, N, N] slot-indexed
    weights: torch.Tensor  # [B, N, N], or shape (0,) when unused
    t: torch.Tensor        # [B] int32, steps taken


@register_reset(RingGraphState)
def _reset_ring(state, mask_for):
    return zero_reset(state, mask_for)


def _learned_temporal(sel) -> bool:
    if isinstance(sel, EdgeChain):
        return any(_learned_temporal(s) for s in sel.selectors)
    return isinstance(sel, TemporalBackedge) and sel.learned


def ring_noise_shape(sel, B: int, N: int):
    """The Gumbel noise `sel` consumes in one ring step: a LearnedEdge's
    [B, N], a stochastic learned TemporalBackedge's [num_samples, B, N]
    (over slots, not its window), a list for a chain, else None."""
    if sel is None:
        return None
    if isinstance(sel, EdgeChain):
        return [ring_noise_shape(s, B, N) for s in sel.selectors]
    if isinstance(sel, TemporalBackedge) and sel.learned \
            and not sel.deterministic:
        return (sel.num_samples, B, N)
    if isinstance(sel, LearnedEdge) and not sel.deterministic:
        return (B, N)
    return None


class RingDenseGCM(nn.Module):
    """DenseGCM's constructor and parameters; the state is a
    RingGraphState, slot-permuted relative to DenseGraphState.
    adj_dtype=torch.bfloat16 stores the adjacency in bf16: exact for the
    selectors whose edges are 0 or 1 (the conv reads it as the node dtype),
    refused for a learned TemporalBackedge, whose rows are fractional."""

    def __init__(self, gnn, preprocessor=None, edge_selectors=None,
                 aux_edge_selectors=None, graph_size: int = 128,
                 pooled: bool = False, positional_encoder=None,
                 edge_weights: bool = False, validate: bool = False,
                 adj_dtype=None, fused_step: bool = True, *, device=None):
        super().__init__()
        self.device = resolve_device(device)
        if adj_dtype is not None and any(
                s is not None and _learned_temporal(s)
                for s in (edge_selectors, aux_edge_selectors)):
            raise ValueError(
                "adj_dtype: a learned TemporalBackedge writes fractional "
                "(spardmax) edge values, which a narrow adjacency dtype "
                "would round; keep the default float32")
        if positional_encoder is not None and not isinstance(
                positional_encoder, PositionalEncoding):
            raise ValueError("the ring core takes a PositionalEncoding "
                             "('add' or 'cat'), not "
                             f"{type(positional_encoder).__name__}")

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
        self.adj_dtype = adj_dtype
        self.fused_step = fused_step

    def initial_state(self, B: int, feat: int,
                      dtype=torch.float32) -> RingGraphState:
        """Zero hidden state; `feat` is the observation width."""
        N, dev = self.graph_size, self.device
        return RingGraphState(
            nodes=torch.zeros((B, N, feat), dtype=dtype, device=dev),
            adj=torch.zeros((B, N, N), dtype=self.adj_dtype or dtype,
                            device=dev),
            weights=torch.zeros((B, N, N) if self.edge_weights else (0,),
                                dtype=dtype, device=dev),
            t=torch.zeros((B,), dtype=torch.int32, device=dev))

    def step_noise(self, B: int, generator: torch.Generator | None = None):
        """The Gumbel noise one step's stochastic selectors consume, drawn
        from `generator` ({"edge_selectors": ..., "aux_edge_selectors":
        ...}, None where a selector draws none)."""
        N = self.graph_size
        return {name: noise_for(ring_noise_shape(getattr(self, name), B, N),
                                generator, self.device)
                for name in ("edge_selectors", "aux_edge_selectors")}

    # -- slot geometry -----------------------------------------------------
    def _geometry(self, t):
        """(cursor p, past_count, age [B, N], valid_past [B, N])."""
        N = self.graph_size
        p = torch.remainder(t, N)
        past_count = torch.clamp(t, max=N - 1)
        slots = torch.arange(N, device=t.device)[None, :]
        age = torch.remainder(p[:, None] - slots, N)
        valid_past = (age >= 1) & (age <= past_count[:, None])
        return p, past_count, age, valid_past

    def _logical_rows(self, t, age):
        """DenseGCM's row index of each slot, [B, N] (junk where the slot
        holds no node)."""
        count = torch.clamp(t + 1, max=self.graph_size)
        return count[:, None] - 1 - age

    # -- selectors in slot space, as the row and column of slot p ---------
    def _selector_row_col(self, sel, nodes, row, col, t, noise):
        """The [B, N] contents of adjacency row p and column p after `sel`
        on top of (row, col): what the JAX ring's selectors write."""
        N = self.graph_size
        B = nodes.shape[0]
        p, past_count, age, valid_past = self._geometry(t)
        iota = torch.arange(N, device=nodes.device)[None, :]
        b_idx = torch.arange(B, device=nodes.device)

        if isinstance(sel, EdgeChain):
            for s, n in zip(sel.selectors,
                            noise or [None] * len(sel.selectors)):
                row, col = self._selector_row_col(s, nodes, row, col, t, n)
            return row, col
        if isinstance(sel, TemporalBackedge) and sel.learned:
            return row + self._learned_temporal_update(sel, t, noise), col
        if isinstance(sel, TemporalBackedge):
            for hop in sel.hops:
                ok = past_count >= hop
                hit = (iota == torch.remainder(p - hop, N)[:, None]) \
                    & ok[:, None]
                if sel.direction in ("forward", "both"):
                    row = torch.where(hit, 1.0, row)
                if sel.direction in ("backward", "both"):
                    col = torch.where(hit, 1.0, col)
            return row, col
        if isinstance(sel, DenseEdge):
            return (torch.where(valid_past | (age == 0), 1.0, row),
                    torch.where(valid_past, 1.0, col))
        if isinstance(sel, Distance):
            mask = self._distance_row(sel, nodes, p) & valid_past
            row = torch.where(mask, 1.0, row)
            if sel.bidirectional:
                col = torch.where(mask, 1.0, col)
            return row, col
        if isinstance(sel, LearnedEdge):
            curr = nodes[b_idx, p.long()]
            net_in = torch.cat([curr[:, None, :].expand_as(nodes), nodes],
                               dim=-1)
            logits = sel.edge_network(net_in)[..., 0]
            shaped = torch.where(valid_past, logits, -1e10)
            if sel.deterministic:
                edges = spardmax(shaped, axis=-1)
            else:
                soft = gumbel_softmax(shaped, axis=-1, noise=noise)
                edges = ste(soft - 1.0 / (1 + sel.num_edge_samples))
            return torch.where(valid_past, ste(edges + row), row), col
        raise NotImplementedError(
            f"ring core: unsupported selector {type(sel).__name__}")

    def _distance_row(self, sel, nodes, p):
        """score(node at slot p, node j) < threshold over every slot j, on
        the (learned-scaled) nodes; the mask carries no gradient."""
        B, N = nodes.shape[0], nodes.shape[1]
        scored = (nodes / sel.dist_param if sel.learned else nodes).detach()
        curr = scored[torch.arange(B, device=nodes.device), p.long()]
        every = torch.full((B,), N, dtype=torch.int32, device=nodes.device)
        if isinstance(sel, CosineEdge):
            return sddmm_threshold_row(curr, scored.contiguous(), every,
                                       sel.max_distance, "cosine")
        if isinstance(sel, SpatialEdge):
            return sddmm_threshold_row(
                curr[:, sel.a_pose_slice].contiguous(),
                scored[:, :, sel.b_pose_slice].contiguous(), every,
                sel.max_distance, "euclidean")
        if isinstance(sel, EuclideanEdge):
            return euclidean_score(curr, scored) < sel.max_distance
        raise NotImplementedError(
            f"ring core: unsupported distance {type(sel).__name__}")

    def _learned_temporal_update(self, sel, t, noise):
        """The learned TemporalBackedge's [B, N] addition to row p: the
        window parameter indexed by each slot's logical row r(s), over the
        slots with r(s) < min(past_count, window)."""
        _, past_count, age, valid_past = self._geometry(t)
        W = sel.learning_window
        window = sel.window
        r = self._logical_rows(t, age)
        cand = valid_past & (r < torch.clamp(past_count, max=W)[:, None]) \
            & (r >= 0)
        logits = torch.where(cand, window[torch.clamp(r, 0, W - 1).long()],
                             torch.finfo(window.dtype).min)
        if sel.deterministic:
            mask = spardmax(logits, axis=-1)
        else:
            if noise is None:
                raise ValueError("a stochastic learned TemporalBackedge "
                                 "needs noise of shape (num_samples, B, N)")
            mask = diff_or([gumbel_softmax(logits, hard=True, noise=n)
                            for n in noise])
        mask = mask * cand.to(mask.dtype)
        return torch.where((past_count > 0)[:, None], mask, 0.0)

    def _positional(self, x, t):
        """The positional encoder at DenseGCM's logical rows r(s), on the
        valid slots (the past and slot p)."""
        enc = self.positional_encoder
        _, _, age, valid_past = self._geometry(t)
        r = self._logical_rows(t, age)
        valid = (valid_past | (age == 0))[..., None]
        rows = torch.clamp(r, 0, enc.pe.shape[0] - 1).long()
        if enc.mode == "add":
            return torch.where(valid, x + enc.pe[rows, :x.shape[-1]], x)
        out = torch.cat([enc.pe[rows, :enc.cat_dim], enc.reproject(x)],
                        dim=-1)
        return torch.where(valid, out, x)

    def _selectors(self, nodes, t, noise, apply):
        """Steps 3-5 of a step: edge selectors on the raw nodes, the
        preprocessor, aux selectors on the (encoded) preprocessed nodes;
        `apply(sel, nodes, noise)` records each selector's writes.
        Returns the preprocessed nodes."""
        if self.edge_selectors is not None:
            apply(self.edge_selectors, nodes, noise["edge_selectors"])
        if self.preprocessor is not None:
            nodes = self.preprocessor(nodes)
        if self.aux_edge_selectors is not None:
            enc = nodes
            if self.positional_encoder is not None:
                enc = self._positional(nodes, t)
            apply(self.aux_edge_selectors, enc, noise["aux_edge_selectors"])
        return nodes

    # -- one timestep ------------------------------------------------------
    def forward(self, x: torch.Tensor, state: RingGraphState,
                generator: torch.Generator | None = None, noise=None):
        """x [B, obs] -> (belief [B, F_out] at slot p, new state); with
        pooled=True the GNN's whole output."""
        if self.validate:
            check_ring_inputs(x, state, self.graph_size)
        if noise is None:
            noise = self.step_noise(x.shape[0], generator)
        if self.fused_step:
            return self._call_fused(x, state, noise)
        nodes, adj, weights, t = state
        B, N = x.shape[0], self.graph_size
        b_idx = torch.arange(B, device=x.device)
        p = self._geometry(t)[0].long()
        adj, nodes = adj.clone(), nodes.clone()
        adj[b_idx, p, :] = 0.0
        adj[b_idx, :, p] = 0.0
        if weights.numel() > 0:
            weights = weights.clone()
            weights[b_idx, p, :] = 0.0
            weights[b_idx, :, p] = 0.0
        nodes[b_idx, p] = x.to(nodes.dtype)

        def apply(sel, feats, n):
            # one selector's writes: row p, then column p, (p, p) from row
            nonlocal adj
            row, col = self._selector_row_col(
                sel, feats, adj[b_idx, p], adj[b_idx, :, p], t, n)
            adj = adj.clone()
            adj[b_idx, p, :] = row.to(adj.dtype)
            col = torch.where(torch.arange(N, device=x.device)[None, :]
                              == p[:, None], adj[b_idx, :, p], col)
            adj[b_idx, :, p] = col.to(adj.dtype)

        dirty = self._selectors(nodes, t, noise, apply)
        node_feats = self.gnn(dirty, adj, weights)
        mx = node_feats if self.pooled else node_feats[b_idx, p]
        return mx, RingGraphState(nodes, adj, weights, t + 1)

    def _call_fused(self, x, state: RingGraphState, noise):
        """The insert as one [B, N, F] select and the eviction plus every
        selector's writes as one [B, N, N] select: adj_new[b, i, j] reads
        only adj[b, i, j] and the [B, N] row and column of slot p."""
        nodes, adj, weights, t = state
        B, N = x.shape[0], self.graph_size
        p = self._geometry(t)[0]
        i_eq_p = torch.arange(N, device=x.device)[None, :] == p[:, None]
        nodes = torch.where(i_eq_p[..., None],
                            x[:, None, :].to(nodes.dtype), nodes)
        acc = {"row": torch.zeros((B, N), dtype=adj.dtype, device=x.device),
               "col": torch.zeros((B, N), dtype=adj.dtype, device=x.device)}

        def apply(sel, feats, n):
            acc["row"], acc["col"] = self._selector_row_col(
                sel, feats, acc["row"], acc["col"], t, n)

        dirty = self._selectors(nodes, t, noise, apply)
        # (p, p) comes from the row, as the unfused step writes it last
        row, col = acc["row"].to(adj.dtype), acc["col"].to(adj.dtype)
        adj = torch.where(i_eq_p[:, :, None], row[:, None, :],
                          torch.where(i_eq_p[:, None, :], col[:, :, None],
                                      adj))
        if weights.numel() > 0:
            weights = torch.where(i_eq_p[:, :, None] | i_eq_p[:, None, :],
                                  0.0, weights)
        node_feats = self.gnn(dirty, adj, weights)
        mx = node_feats if self.pooled else \
            node_feats[torch.arange(B, device=x.device), p.long()]
        return mx, RingGraphState(nodes, adj, weights, t + 1)

    def scan(self, xs: torch.Tensor, state: RingGraphState, dones=None,
             remat=False, unroll: int | None = None,
             generator: torch.Generator | None = None, noise=None):
        """The recurrence over xs [B, T, obs] -> (beliefs [B, T, F_out],
        final state). dones [B, T] wipe batch b's memory after the step
        where dones[b, t]. Stochastic selectors draw from `generator` or
        take noise[t] at step t. remat=True recomputes each step in the
        backward (one checkpoint a step); an int K checkpoints chunks of K
        steps (T % K == 0), keeping only the state at chunk boundaries.
        Every choice gives the same forward. `unroll` (an XLA scan knob)
        is accepted only at its default."""
        if unroll is not None:
            raise NotImplementedError(
                "unroll is an XLA scan compile knob with no eager meaning")
        if remat == "reverse":
            raise NotImplementedError(
                f"remat='reverse' (the reversible backward) waits for "
                f"{FAST_CORES}")
        B, T = xs.shape[0], xs.shape[1]
        noises = [self.step_noise(B, generator) if noise is None
                  else noise[t] for t in range(T)]

        def run(state, t0, t1):
            outs = []
            for t in range(t0, t1):
                out, state = self(xs[:, t], state, noise=noises[t])
                if dones is not None:
                    state = reset_where(state, dones[:, t])
                outs.append(out)
            return outs, state

        if isinstance(remat, int) and not isinstance(remat, bool):
            K = remat
            if K < 1 or T % K:
                raise ValueError(f"chunked remat: T={T} must be divisible "
                                 f"by the chunk size K={K}")
            outs = []
            for t0 in range(0, T, K):
                chunk, state = checkpoint(run, state, t0, t0 + K,
                                          use_reentrant=False)
                outs += chunk
            return torch.stack(outs, dim=1), state
        if remat:
            outs = []
            for t in range(T):
                chunk, state = checkpoint(run, state, t, t + 1,
                                          use_reentrant=False)
                outs += chunk
            return torch.stack(outs, dim=1), state
        outs, state = run(state, 0, T)
        return torch.stack(outs, dim=1), state

    def window(self, xs, state, dones=None, chunk=None):
        """The scan-free whole-trajectory forward (models/ring_window.py):
        the scan's beliefs up to float-accumulation order and its final
        state. Falls back to `scan` on dones or on a structure the window
        does not support (window_supported). chunk= overrides the
        memory-bounded chunk length (ring_window.max_chunk_len)."""
        from gcm_tpu_torch.models.ring_window import (ring_window,
                                                      window_supported)

        if dones is not None or not window_supported(self):
            return self.scan(xs, state, dones=dones)
        return ring_window(self, xs, state, chunk=chunk)

    def window_profitable(self, mode: str = "forward") -> bool:
        """The whole-trajectory call's gate: always the window. On the card
        it beat the ring scan, forward and in a training step, at every
        graph size measured (chip_smoke.py's fast phase, "gates" line;
        PERF.md §6): the scan is a loop of launches a step."""
        del mode
        return True

    def window_applicable(self, dones=None) -> bool:
        """Whether `window` runs the window and not its scan fallback: no
        dones (a reset breaks the kill-cumsum's fixed slot lifetimes) and a
        supported structure. A caller that passes unroll/remat to the scan
        asks this first, since the fallback drops them."""
        from gcm_tpu_torch.models.ring_window import window_supported

        return dones is None and window_supported(self)
