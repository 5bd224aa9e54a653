"""BandedRingGCM and BandedScoredGCM, the banded fast cores (counterpart of
gcm_tpu/models/banded_gcm.py).

When the only edge selector is a deterministic forward TemporalBackedge,
the memory graph is banded: slot s has in-edges exactly from the slots
(s - h) mod N. `BandedRingGCM` never builds the [B, N, N] adjacency: a
layer's aggregate is a masked roll of its input, O(hops * N * F) instead of
the O(N^2 * F) adj @ x, and the state is (nodes, t). It gives DenseGCM's
beliefs for edge_selectors=TemporalBackedge(hops, direction) and a
DenseGraphConv('add' | 'mean') + tanh/relu stack.

Edge rule in slot space: the edge (sink s, source (s - h) mod N) exists iff
the sink had at least h predecessors when it was inserted,
min(t_insert, N - 1) >= h with t_insert = t - age(s), and the source is
still alive, age(s) + h <= min(t, N - 1).

`BandedScoredGCM` stores the adjacency as a band [B, N, w]: band[b, s, k-1]
is the edge (sink s <- source (s - k) mod N) recorded when s was inserted,
scored by a Distance selector against the last w nodes and/or set by fixed
temporal hops. It gives DenseGCM's beliefs for
[TemporalBackedge(hops)] + [Distance(..., window=w)].

Both have `window()`, a scan-free forward over a whole trajectory: the
node features are raw observations, so the belief at step i is a fixed
temporal stencil of the inputs, and every step is computed at once over the
stencil's ages. These cores reach no TPU kernel: their ops are rolls,
masked sums, gathers and `conv_project`, plain PyTorch on either device.
The scored core's scan and window gather its w offsets and reduce them in
one einsum, where JAX adds them one by one: the same values up to float
reassociation.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from gcm_tpu_torch.core.graph_state import (register_reset, reset_where,
                                            zero_reset)
from gcm_tpu_torch.device import resolve_device
from gcm_tpu_torch.edges.distance import (CosineEdge, EuclideanEdge,
                                          SpatialEdge)
from gcm_tpu_torch.nn.dense_conv import (DenseGNN, conv_project,
                                         plan_conv_stack)
from gcm_tpu_torch.ops.distance import (cosine_score, euclidean_score,
                                        euclidean_score_per_step,
                                        spatial_score)
from gcm_tpu_torch.utils.contracts import Float, checked


class BandedState(NamedTuple):
    nodes: torch.Tensor  # [B, N, F] slot-indexed raw observations
    t: torch.Tensor      # [B] int32


@register_reset(BandedState)
def _reset_banded(state, mask_for):
    return zero_reset(state, mask_for)


class BandedScoredState(NamedTuple):
    nodes: torch.Tensor  # [B, N, F] slot-indexed raw observations
    band: torch.Tensor   # [B, N, w] edge values per (sink slot, offset)
    t: torch.Tensor      # [B] int32


@register_reset(BandedScoredState)
def _reset_banded_scored(state, mask_for):
    return zero_reset(state, mask_for)


def _gather_rows(seq, idx):
    """seq [B, T, D] at idx [B, ...] along axis 1 -> [B, ..., D]."""
    B, D = seq.shape[0], seq.shape[-1]
    flat = idx.reshape(B, -1).long()
    out = torch.gather(seq, 1, flat[..., None].expand(B, flat.shape[1], D))
    return out.reshape(*idx.shape, D)


def _window_time(t0, T, dones):
    """Within-episode step count t_eff [B, T] (the scan's state.t, which
    dones reset to 0) and the last reset step r_last [B] (-1 if none, None
    when dones is None)."""
    B = t0.shape[0]
    i = torch.arange(T, dtype=t0.dtype, device=t0.device)[None, :]
    if dones is None:
        return t0[:, None] + i, None
    d = dones.to(t0.dtype)
    starts = torch.cat([torch.zeros((B, 1), dtype=t0.dtype,
                                    device=t0.device), d[:, :-1]], dim=1)
    cand = torch.where(starts > 0, i, -1)
    last_start = torch.cummax(cand, dim=1).values
    t_eff = torch.where(last_start >= 0, i - last_start, t0[:, None] + i)
    r_last = torch.where(dones.to(torch.bool), i, -1).max(dim=1).values
    return t_eff, r_last


def _ring_final(buf0, rows_seq, t0, N, r_last):
    """Final ring-buffer contents after writing rows_seq[:, i] at the slot
    the step-i insert lands on. A slot holds its newest write; a done at
    step r (the reset runs after the insert) wipes every write at steps
    <= r and restarts the slot counter at 0. Pure gathers and selects, so
    exactly the scan's state. Returns (buf_F, t_F)."""
    T = rows_seq.shape[1]
    s_iota = torch.arange(N, dtype=t0.dtype, device=t0.device)[None, :]
    if r_last is None:
        t_F = t0 + T
        o = torch.remainder(t_F[:, None] - 1 - s_iota, N)
        tau = t_F[:, None] - 1 - o  # [B, N] global time of the content
        idx = torch.clamp(tau - t0[:, None], 0, T - 1)
        gathered = _gather_rows(rows_seq, idx).to(buf0.dtype)
        return torch.where((tau >= t0[:, None])[..., None], gathered,
                           buf0), t_F
    had_reset = r_last >= 0
    t_F = torch.where(had_reset, T - 1 - r_last, t0 + T).to(t0.dtype)
    # counter value carried at window step j: start_ctr + j
    start_ctr = torch.where(had_reset, -(r_last + 1), t0)
    o = torch.remainder(t_F[:, None] - 1 - s_iota, N)
    ctr = t_F[:, None] - 1 - o  # counter value of the slot's newest write
    j = ctr - start_ctr[:, None]  # the window step that wrote it
    written = (ctr >= 0) & (j >= 0)
    gathered = _gather_rows(rows_seq, torch.clamp(j, 0, T - 1))
    kept = torch.where(had_reset[:, None, None], torch.zeros_like(buf0),
                       buf0)
    return torch.where(written[..., None], gathered.to(buf0.dtype),
                       kept), t_F


def _raw_at_ages(ages, xs, buf0, t0, N):
    """The step-i view of the ring content at each age a of `ages` (a
    list): xs[i - a] inside the window, the buffer row of slot
    (t0 + i - a) mod N before it -> [B, T, len(ages), D]. Valid only where
    the caller's alive mask (a <= t_eff) holds."""
    T = xs.shape[1]
    dev = xs.device
    a = torch.as_tensor(ages, dtype=t0.dtype, device=dev)[None, :]
    i = torch.arange(T, dtype=t0.dtype, device=dev)[:, None]
    j = i - a  # [T, A]
    B = xs.shape[0]
    inside = _gather_rows(xs, torch.clamp(j, min=0)[None].expand(B, -1, -1))
    slot = torch.remainder(t0[:, None, None] + j[None], N)
    old = _gather_rows(buf0, slot).to(xs.dtype)
    return torch.where((j >= 0)[None, :, :, None], inside, old)


def scan_steps(core, xs, state, dones=None, remat: bool = False,
               unroll: int | None = None):
    """The recurrence of a fast core over xs [B, T, obs] -> (beliefs
    [B, T, F_out], final state). dones [B, T] wipe batch b's memory after
    the step where dones[b, t]. remat=True recomputes each step in the
    backward (one checkpoint a step). `unroll` is an XLA scan knob,
    accepted only at its default."""
    if unroll is not None:
        raise NotImplementedError(
            "unroll is an XLA scan compile knob with no eager meaning")
    if not isinstance(remat, bool):
        raise ValueError(f"remat must be True or False for a fast core, "
                         f"not {remat!r}")
    outs = []
    for t in range(xs.shape[1]):
        if remat:
            out, state = checkpoint(core, xs[:, t], state,
                                    use_reentrant=False)
        else:
            out, state = core(xs[:, t], state)
        if dones is not None:
            state = reset_where(state, dones[:, t])
        outs.append(out)
    return torch.stack(outs, dim=1), state


def _conv_plan(gnn, name):
    """(conv_idx, acts, aggrs) of a DenseGraphConv('add' | 'mean') +
    tanh/relu stack, else ValueError."""
    plan = (plan_conv_stack(gnn.layers, allowed_aggrs=("add", "mean"))
            if isinstance(gnn, DenseGNN) else None)
    if plan is None:
        raise ValueError(f"{name} supports DenseGNN stacks of "
                         f"DenseGraphConv('add'|'mean') + tanh/relu")
    return plan


def _insert(buf, x, p):
    """buf [B, N, D] with row p[b] replaced by x[b]."""
    hit = torch.arange(buf.shape[1], device=buf.device)[None, :] \
        == p[:, None]
    return torch.where(hit[..., None], x[:, None, :].to(buf.dtype), buf)


class _FastCore(nn.Module):
    """Shared construction of the fast cores: the GNN plan, the
    preprocessor, the device."""

    def __init__(self, gnn, preprocessor, graph_size, name, device):
        super().__init__()
        self.device = resolve_device(device)
        self._conv_idx, self._acts, self._aggrs = _conv_plan(gnn, name)
        self.gnn = gnn.to(self.device)
        self.preprocessor = (preprocessor.to(self.device)
                             if isinstance(preprocessor, nn.Module)
                             else preprocessor)
        self.graph_size = graph_size

    def _convs(self):
        return [self.gnn.layers[ci] for ci in self._conv_idx]

    def _pre(self, h):
        return h if self.preprocessor is None else self.preprocessor(h)

    def scan(self, xs, state, dones=None, remat: bool = False,
             unroll: int | None = None):
        """See `scan_steps`."""
        return scan_steps(self, xs, state, dones, remat, unroll)


class BandedRingGCM(_FastCore):
    """Temporal-backedge fast path; direction 'forward', 'backward' or
    'both' as TemporalBackedge's."""

    def __init__(self, gnn, preprocessor=None, hops: Sequence[int] = (1,),
                 graph_size: int = 128, direction: str = "forward", *,
                 device=None):
        super().__init__(gnn, preprocessor, graph_size, "BandedRingGCM",
                         device)
        if direction not in ("forward", "backward", "both"):
            raise ValueError(f"unknown direction {direction!r}")
        self.direction = direction
        self.hops = tuple(hops)

    def initial_state(self, B: int, feat: int,
                      dtype=torch.float32) -> BandedState:
        return BandedState(
            nodes=torch.zeros((B, self.graph_size, feat), dtype=dtype,
                              device=self.device),
            t=torch.zeros((B,), dtype=torch.int32, device=self.device))

    def _hop_masks(self, t):
        """[B, N] edge-validity mask per hop (see the module docstring)."""
        N = self.graph_size
        p = torch.remainder(t, N)
        slots = torch.arange(N, dtype=t.dtype, device=t.device)[None, :]
        age = torch.remainder(p[:, None] - slots, N)  # 0 = inserted now
        horizon = torch.clamp(t, max=N - 1)[:, None]
        alive = age <= horizon
        t_insert = t[:, None] - age
        masks = []
        for h in self.hops:
            had_pred = torch.clamp(t_insert, max=N - 1) >= h
            src_alive = age + h <= horizon
            masks.append((alive & had_pred & src_alive).to(torch.float32))
        return masks

    @checked
    def forward(self, x: Float["B F"], state: BandedState):
        """x [B, obs] -> (belief [B, F_out], new state)."""
        nodes, t = state
        N = self.graph_size
        p = torch.remainder(t, N)
        nodes = _insert(nodes, x, p)
        h_feats = self._pre(nodes)
        hop_masks = self._hop_masks(t)
        for conv, act, aggr in zip(self._convs(), self._acts, self._aggrs):
            agg = torch.zeros_like(h_feats)
            deg = torch.zeros(h_feats.shape[:2], dtype=h_feats.dtype,
                              device=h_feats.device)
            for h, m in zip(self.hops, hop_masks):
                m = m.to(h_feats.dtype)
                if self.direction in ("forward", "both"):
                    # in-edge of slot s from slot s - h: sources shift down
                    agg = agg + torch.roll(h_feats, h, dims=1) * m[..., None]
                    deg = deg + m
                if self.direction in ("backward", "both"):
                    # the edge (sink s - h <- source s): sources shift up,
                    # the sink-s mask rolled to position s - h
                    m_b = torch.roll(m, -h, dims=1)
                    agg = agg + torch.roll(h_feats, -h, dims=1) \
                        * m_b[..., None]
                    deg = deg + m_b
            if aggr == "mean":
                agg = agg / torch.clamp(deg, min=1.0)[..., None]
            h_feats = conv_project(conv, agg, h_feats, act)
        b_idx = torch.arange(x.shape[0], device=x.device)
        return h_feats[b_idx, p.long()], BandedState(nodes, t + 1)

    def window_profitable(self, mode: str = "forward") -> bool:
        """The whole-trajectory call's gate: always the window, which beat
        the scan forward and in a training step on the card (chip_smoke.py's
        fast phase, "gates" line; PERF.md §6)."""
        del mode
        return True

    def _stencil_ages(self):
        """need[l]: the node ages whose layer-l features the belief (age 0)
        reads; each conv layer pulls in the sources at age + hop."""
        need = [{0}]
        for _ in self._conv_idx:
            prev = set(need[0])
            for a in need[0]:
                for h in self.hops:
                    prev.add(a + h)
            need.insert(0, prev)
        return [sorted(s) for s in need]

    def window(self, xs, state: BandedState, dones=None):
        """Whole-trajectory forward without the scan, forward direction
        only: the scan's beliefs up to float reassociation and exactly its
        final state. Every step at once as [B, T, F] products over the
        stencil ages. dones [B, T]: the scan's episode resets (masks and
        the final state follow the within-episode step count)."""
        if self.direction != "forward":
            raise ValueError("window() is forward-only")
        nodes0, t0 = state
        T = xs.shape[1]
        N = self.graph_size
        t_eff, r_last = _window_time(t0, T, dones)
        horizon = torch.clamp(t_eff, max=N - 1)

        need = self._stencil_ages()
        raw = _raw_at_ages(need[0], xs, nodes0, t0, N)
        feats = {a: self._pre(raw[:, :, k]) for k, a in enumerate(need[0])}

        def edge_mask(a, h):
            # the edge (sink age a <- source age a + h) at step i:
            # _hop_masks' algebra with t := t_eff
            alive = a <= horizon
            had_pred = torch.clamp(t_eff - a, max=N - 1) >= h
            src_alive = a + h <= horizon
            return (alive & had_pred & src_alive).to(xs.dtype)

        for li, (conv, act) in enumerate(zip(self._convs(), self._acts)):
            new_feats = {}
            for a in need[li + 1]:
                agg = torch.zeros_like(feats[a])
                deg = torch.zeros(agg.shape[:2], dtype=agg.dtype,
                                  device=agg.device)
                for h in self.hops:
                    m = edge_mask(a, h)
                    agg = agg + feats[a + h] * m[..., None]
                    deg = deg + m
                if self._aggrs[li] == "mean":
                    agg = agg / torch.clamp(deg, min=1.0)[..., None]
                new_feats[a] = conv_project(conv, agg, feats[a], act)
            feats = new_feats

        nodes_F, t_F = _ring_final(nodes0, xs, t0, N, r_last)
        return feats[0], BandedState(nodes_F, t_F)


def distance_scores(sel, curr, nodes):
    """The Distance selector's score of curr [B, F] against nodes
    [B, W, F] -> [B, W] (JAX's `dist_fn`): EuclideanEdge's cross-batch
    mean, cosine similarity, the pose slices' distance."""
    if isinstance(sel, EuclideanEdge):
        return euclidean_score(sel.batch_rows(curr), nodes)
    if isinstance(sel, CosineEdge):
        return cosine_score(curr, nodes)
    if isinstance(sel, SpatialEdge):
        return spatial_score(curr, nodes, sel.a_pose_slice,
                             sel.b_pose_slice)
    raise NotImplementedError(
        f"fast cores: unsupported distance {type(sel).__name__}")


def distance_scores_per_step(sel, curr, nodes):
    """JAX's `dist_fn` mapped over time: curr [B, T, F] against nodes
    [B, T, W, F] (each step its own) or [B, W, F] (fixed) -> [B, T, W].
    EuclideanEdge's mean over the batch is taken per step, as the vmap
    takes it, never over B * T."""
    B, T, F = curr.shape
    if isinstance(sel, EuclideanEdge):
        return euclidean_score_per_step(sel.batch_rows(curr), nodes)
    if nodes.dim() == 3:
        nodes = nodes[:, None].expand(B, T, -1, -1)
    W = nodes.shape[2]
    flat = distance_scores(sel, curr.reshape(B * T, F),
                           nodes.reshape(B * T, W, nodes.shape[-1]))
    return flat.reshape(B, T, W)


class BandedScoredGCM(_FastCore):
    """Banded fast path for scored selectors: the adjacency is a band of
    stored values [B, N, w]. Each step scores the new node against the last
    `window` nodes with a Distance selector (EuclideanEdge, CosineEdge or
    SpatialEdge, forward-only, its learned scale `dist_param` included)
    and/or sets 1.0 at the temporal hop offsets. Eviction follows DenseGCM's
    wraparound, as in BandedRingGCM: band values persist per slot, edges
    whose source was evicted are killed at aggregation time by the age mask,
    and a reused sink slot overwrites its row at insert."""

    def __init__(self, gnn, distance=None, preprocessor=None,
                 hops: Sequence[int] = (), window: int | None = None,
                 graph_size: int = 128, *, device=None):
        super().__init__(gnn, preprocessor, graph_size, "BandedScoredGCM",
                         device)
        if distance is not None:
            if getattr(distance, "bidirectional", False):
                raise ValueError("the banded fast path is forward-only")
            w = window if window is not None else distance.window
            if w is None:
                raise ValueError("BandedScoredGCM needs a candidate window "
                                 "(window= here or on the Distance "
                                 "selector)")
            distance = distance.to(self.device)
        else:
            if not hops:
                raise ValueError("need a distance selector and/or temporal "
                                 "hops")
            w = window if window is not None else max(hops)
        if any(h > w for h in hops):
            raise ValueError("hops must fit in the window")
        self.distance = distance
        self.hops = tuple(hops)
        self.window_size = int(w)

    def initial_state(self, B: int, feat: int,
                      dtype=torch.float32) -> BandedScoredState:
        N, dev = self.graph_size, self.device
        return BandedScoredState(
            nodes=torch.zeros((B, N, feat), dtype=dtype, device=dev),
            band=torch.zeros((B, N, self.window_size), dtype=dtype,
                             device=dev),
            t=torch.zeros((B,), dtype=torch.int32, device=dev))

    def _scale(self, v):
        sel = self.distance
        return v / sel.dist_param if sel.learned else v

    def _band_values(self, dists, valid):
        """The band row(s) from scores [..., w] and the offsets' validity:
        1.0 where the score is under the threshold or a hop sits."""
        row = torch.zeros(valid.shape, dtype=torch.float32,
                          device=valid.device)
        if self.distance is not None:
            row = torch.where((dists < self.distance.max_distance) & valid,
                              1.0, row)
        for h in self.hops:
            row[..., h - 1] = torch.where(valid[..., h - 1], 1.0,
                                          row[..., h - 1])
        return row

    def _score_row(self, x, nodes, p, t):
        """Edge values [B, w] of the row inserted at slot p: offset k - 1
        holds the edge (sink p <- source (p - k) mod N)."""
        N, w = self.graph_size, self.window_size
        ks = torch.arange(1, w + 1, dtype=t.dtype, device=t.device)
        # source k exists iff the sink had >= k predecessors at insert
        valid = ks[None, :] <= torch.clamp(t, max=N - 1)[:, None]
        dists = None
        if self.distance is not None:
            src = torch.remainder(p[:, None] - ks[None, :], N)
            wnodes = _gather_rows(nodes, src)  # [B, w, F]
            with torch.no_grad():
                dists = distance_scores(self.distance, self._scale(x),
                                        self._scale(wnodes))
        return self._band_values(dists, valid)

    def _aggregate(self, h, m, src):
        """sum_k m[..., k] * h at the k-th source, and the degree:
        h [B, X, F] gathered at src [X, w] (h's rows) -> [B, X, F]."""
        g = h[:, src.reshape(-1).long()].reshape(
            h.shape[0], *src.shape, h.shape[-1])
        return torch.einsum("bxk,bxkf->bxf", m, g), m.sum(-1)

    @checked
    def forward(self, x: Float["B F"], state: BandedScoredState):
        """x [B, obs] -> (belief [B, F_out], new state)."""
        nodes, band, t = state
        N, w = self.graph_size, self.window_size
        p = torch.remainder(t, N)
        nodes = _insert(nodes, x, p)
        band = _insert(band, self._score_row(x, nodes, p, t), p)
        h_feats = self._pre(nodes)

        # aggregation-time validity per offset k (BandedRingGCM's age
        # algebra; had_pred is in the band row)
        slots = torch.arange(N, dtype=t.dtype, device=t.device)
        ks = torch.arange(1, w + 1, dtype=t.dtype, device=t.device)
        age = torch.remainder(p[:, None] - slots[None, :], N)
        horizon = torch.clamp(t, max=N - 1)[:, None, None]
        live = (age[..., None] <= horizon) \
            & (age[..., None] + ks <= horizon)  # [B, N, w]
        m = band * live.to(band.dtype)
        src = torch.remainder(slots[:, None] - ks[None, :], N)  # [N, w]
        for conv, act, aggr in zip(self._convs(), self._acts, self._aggrs):
            agg, deg = self._aggregate(h_feats, m.to(h_feats.dtype), src)
            if aggr == "mean":
                agg = agg / torch.clamp(deg, min=1.0)[..., None]
            h_feats = conv_project(conv, agg, h_feats, act)
        b_idx = torch.arange(x.shape[0], device=x.device)
        return (h_feats[b_idx, p.long()],
                BandedScoredState(nodes, band, t + 1))

    def window_profitable(self, mode: str = "forward") -> bool:
        """The whole-trajectory call's gate: always the window, which beat
        the scan forward and in a training step on the card (chip_smoke.py's
        fast phase, "gates" line; PERF.md §6)."""
        del mode
        return True

    def _window_rows(self, xs, state, dones, rows):
        """(S [B, T, w], raw [B, T, L*w + 1, F], horizon, r_last): the
        band rows of every in-window sink (the vectorised _score_row: the
        source at offset k is the raw node at age k, valid iff the sink had
        >= k predecessors at insert), or `rows` where given."""
        nodes0, _, t0 = state
        T = xs.shape[1]
        N, w = self.graph_size, self.window_size
        L = len(self._conv_idx)
        t_eff, r_last = _window_time(t0, T, dones)
        horizon = torch.clamp(t_eff, max=N - 1)  # [B, T]
        raw = _raw_at_ages(range(L * w + 1), xs, nodes0, t0, N)
        if rows is not None:
            return rows.to(xs.dtype), raw, horizon, r_last
        ks = torch.arange(1, w + 1, dtype=t0.dtype, device=xs.device)
        valid_k = ks <= horizon[..., None]  # [B, T, w]
        dists = None
        if self.distance is not None:
            with torch.no_grad():
                dists = distance_scores_per_step(
                    self.distance, self._scale(xs),
                    self._scale(raw[:, :, 1:w + 1]))
        return (self._band_values(dists, valid_k).to(xs.dtype), raw,
                horizon, r_last)

    def window(self, xs, state: BandedScoredState, dones=None):
        """Whole-trajectory forward without the scan: the scan's beliefs up
        to float reassociation and exactly its final state. A band row
        depends only on raw observations, so all T rows are scored at once
        (S [B, T, w]); then the stencil recursion runs with S, shifted by
        the sink's age (the stored band before the window), as the
        per-offset edge values. The stencil's ages are 0..L*w, contiguous,
        so each layer is one gather and one einsum over them."""
        return self._window(xs, state, dones, None)

    def _window(self, xs, state: BandedScoredState, dones, rows):
        """`window` with the band rows [B, T, w] given as `rows` where not
        None: a check holds two devices or paths to one edge set where a
        score rounds across the threshold."""
        nodes0, band0, t0 = state
        N, w = self.graph_size, self.window_size
        L = len(self._conv_idx)
        S, raw, horizon, r_last = self._window_rows(xs, state, dones, rows)
        ks = torch.arange(1, w + 1, dtype=t0.dtype, device=xs.device)

        feats = self._pre(raw)  # [B, T, L*w + 1, F]
        for li, (conv, act) in enumerate(zip(self._convs(), self._acts)):
            n_out = (L - 1 - li) * w + 1  # sink ages 0..n_out - 1
            ages = torch.arange(n_out, dtype=t0.dtype, device=xs.device)
            band_a = _raw_at_ages(range(n_out), S, band0, t0, N)
            live = (ages[:, None] <= horizon[..., None, None]) \
                & (ages[:, None] + ks <= horizon[..., None, None])
            m = band_a * live.to(band_a.dtype)  # [B, T, n_out, w]
            src = ages[:, None] + ks[None, :]  # [n_out, w] source ages
            g = feats[:, :, src.reshape(-1).long()].reshape(
                *feats.shape[:2], n_out, w, feats.shape[-1])
            agg = torch.einsum("btak,btakf->btaf", m, g)
            if self._aggrs[li] == "mean":
                agg = agg / torch.clamp(m.sum(-1), min=1.0)[..., None]
            feats = conv_project(conv, agg, feats[:, :, :n_out], act)

        nodes_F, t_F = _ring_final(nodes0, xs, t0, N, r_last)
        band_F, _ = _ring_final(band0, S, t0, N, r_last)
        return feats[:, :, 0], BandedScoredState(nodes_F, band_F, t_F)
