"""The node-sharded SparseGCM (counterpart of
gcm_tpu/parallel/sharded_sparse.py): the whole step (state, selector
grid, compaction, edge append, convolution) split over a mesh axis, one
rank a shard, so the per-rank work and memory are 1/d.

Layout on an axis of d ranks, nb = N / d, epl = max_edges / d; rank s
holds (`ShardedSparseState`):

- nodes [B, nb, F]: rows s * nb .. (s + 1) * nb - 1;
- edges [B, 2, epl], weights [B, epl]: the edges whose SOURCE row it owns,
  in global coordinates (-1 sentinels), so that scoring, weight
  normalisation and the append stay on the rank that scored the pair;
- num_edges [B, 1]: its append cursor; t [B]: replicated;
- span [B]: replicated, the longest window (valid length) of any call
  whose edges the state holds, which bounds their sink - source
  (`_halo`); reset with the rest of a row.

One call, on every rank with the same (replicated) x [B, t, F] and taus:

1. insert the new rows this rank owns;
2. the selector's [B, t, nb] grid over its own source columns:
   TemporalEdge's analytic pairs; the deterministic LearnedEdge's pair MLP
   over its columns, the tempered softmax's max and denominator combined
   over the ranks by one pmax and one psum (the reference's softmax over
   the whole source axis); a SparseEdgeChain sums its members' grids;
3. compaction over the local grid and the append at the local cursor,
   weights 1.0 through grad_preserving_ones;
4. the preprocessor over the local block;
5. each GraphConv('add'): the port's SpMM (the spmm_edge_list kernel on
   the card) over the rank's edges in local coordinates into [B, nb + W,
   F], W the selectors' structural bound on sink - source, and one
   ppermute hands the W-row tail to the right neighbour ("halo"); with no
   bound (an unwindowed learned selector) a full-width [B, N, F] partial
   and a psum ("psum");
6. the beliefs: each rank gathers the new rows it owns and one psum
   assembles them, replicated.

Gradients (parallel/comm.py): the parameters and x enter the shard-local
work through `comm.enter_many` (one all-reduce of their gradients in the
backward), the softmax's denominator is a psum whose backward is a psum,
the halo's backward the reverse ring, and the belief assembly a psum whose
backward is the identity. So every rank ends a backward with the full
gradient of every parameter, and a train step needs no reduction after it
(`sync_grads` is absent).

Two differences from the JAX sharded core, each pinned by a test
(tests/test_torch_port_sharded_sparse.py) and held to the replicated
SparseGCM instead:

- The halo of a windowed learned selector is window + the larger of the
  call's t and the state's span (JAX: the call's t): an edge scored in an
  earlier, longer call reaches back up to window + that call's length,
  and JAX's halo drops it silently when t shrinks. The span lives in the
  state, so a fresh module continuing a carried state (a resumed run, a
  restored server) sizes its halo alike, and a reset row forgets it.
- Edges that miss a rank's epl lanes (or its compaction cap) are counted,
  summed over the ranks, in aux["dropped_edges"] [B], as the replicated
  core's; JAX throws the per-shard overflow away. So are stored edges
  that the halo path would leave out of the aggregation (none while the
  span bounds them: a guard).

Supported, as JAX's: TemporalEdge, LearnedEdge(deterministic=True) and
SparseEdgeChain of those; no aux selectors, positional encoding,
max_hops or dones; GraphConv('add') stacks.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from gcm_tpu_torch.core.graph_state import register_reset
from gcm_tpu_torch.device import resolve_device
from gcm_tpu_torch.edges.sparse_learned import LearnedEdge as \
    SparseLearnedEdge
from gcm_tpu_torch.edges.sparse_spatial import SparseEdgeChain
from gcm_tpu_torch.edges.sparse_temporal import TemporalEdge
from gcm_tpu_torch.nn.sparse_conv import GraphConv, SparseGNN
from gcm_tpu_torch.ops.scatter import (append_edges, edge_mask,
                                       nonzero_padded, rows_set, take_along)
from gcm_tpu_torch.parallel import comm as cc
from gcm_tpu_torch.parallel.edge_partition import _local_spmm
from gcm_tpu_torch.parallel.mesh import axis_group, axis_rank, axis_size
from gcm_tpu_torch.utils.functional import call_with
from gcm_tpu_torch.utils.ste import grad_preserving_ones


class ShardedSparseState(NamedTuple):
    nodes: torch.Tensor      # [B, nb, F]    this rank's node rows
    edges: torch.Tensor      # [B, 2, epl]   source-owned, global, -1 pad
    weights: torch.Tensor    # [B, epl]
    t: torch.Tensor          # [B] int32     replicated
    num_edges: torch.Tensor  # [B, 1] int32  this rank's cursor
    span: torch.Tensor       # [B] int32     replicated: longest window


@register_reset(ShardedSparseState)
def _reset_sharded_sparse(state, mask_for):
    """The replicated SparseGraphState's fills: edge sentinel -1, weight
    1.0, zeroed counters."""
    nodes, edges, weights, t, num_edges, span = state
    return ShardedSparseState(
        nodes=torch.where(mask_for(nodes), 0.0, nodes),
        edges=torch.where(mask_for(edges), -1, edges),
        weights=torch.where(mask_for(weights), 1.0, weights),
        t=torch.where(mask_for(t), 0, t),
        num_edges=torch.where(mask_for(num_edges), 0, num_edges),
        span=torch.where(mask_for(span), 0, span))


def _supported(sel) -> bool:
    if sel is None or isinstance(sel, TemporalEdge):
        return True
    if isinstance(sel, SparseLearnedEdge):
        if not sel.deterministic:
            raise ValueError(
                "sharded learned selector: deterministic only (per-lane "
                "Gumbel noise is not reproducible shard-locally)")
        return True
    if isinstance(sel, SparseEdgeChain):
        return all(_supported(m) for m in sel.selectors)
    return False


class ShardedSparseGCM(nn.Module):
    """See the module docstring. layers: GraphConv('add') layers and
    activations (a SparseGNN's); the parameter tree is SparseGCM's."""

    def __init__(self, layers, mesh, axis: str = "dp", preprocessor=None,
                 edge_selectors=None, graph_size: int = 128,
                 max_edges: int = 512, comm: str = "auto", *, device=None):
        super().__init__()
        for layer in layers:
            if isinstance(layer, nn.Module) and not (
                    isinstance(layer, GraphConv) and layer.aggr == "add"):
                raise ValueError("ShardedSparseGCM supports GraphConv('add') "
                                 "layers")
        if not _supported(edge_selectors):
            raise ValueError(
                "ShardedSparseGCM supports TemporalEdge / deterministic "
                "LearnedEdge / SparseEdgeChain of those, not "
                + type(edge_selectors).__name__)
        self.group = axis_group(mesh, axis)
        self.d, self.rank = axis_size(mesh, axis), axis_rank(mesh, axis)
        if graph_size % self.d or max_edges % self.d:
            raise ValueError(f"graph_size={graph_size} and max_edges="
                             f"{max_edges} must divide over {self.d} ranks")
        if comm not in ("auto", "halo", "psum"):
            raise ValueError(f"unknown comm {comm!r}")
        self.device = resolve_device(device)

        def to_device(m):
            return m.to(self.device) if isinstance(m, nn.Module) else m

        self.gnn = to_device(SparseGNN(layers))
        self.preprocessor = to_device(preprocessor)
        self.edge_selectors = to_device(edge_selectors)
        self.mesh, self.axis, self.comm = mesh, axis, comm
        self.nb = graph_size // self.d
        self.epl = max_edges // self.d
        self.graph_size, self.max_edges = graph_size, max_edges

    def initial_state(self, B: int, feat: int,
                      dtype=torch.float32) -> ShardedSparseState:
        dev = self.device
        return ShardedSparseState(
            nodes=torch.zeros((B, self.nb, feat), dtype=dtype, device=dev),
            edges=torch.full((B, 2, self.epl), -1, dtype=torch.int32,
                             device=dev),
            weights=torch.ones((B, self.epl), dtype=dtype, device=dev),
            t=torch.zeros((B,), dtype=torch.int32, device=dev),
            num_edges=torch.zeros((B, 1), dtype=torch.int32, device=dev),
            span=torch.zeros((B,), dtype=torch.int32, device=dev))

    # -- structural halo bound ------------------------------------------
    def _halo(self, t: int, state: ShardedSparseState | None = None
              ) -> int | None:
        """The most sink - source of any edge after a call of window
        length t on state (a fresh state without one; see the module
        docstring); None when unbounded. A windowed learned selector
        reads the state's span (one device-to-host read)."""

        def t_hist():
            if state is None or state.span.numel() == 0:
                return t
            return max(t, int(state.span.max()))

        def bound(sel):
            if sel is None:
                return 0
            if isinstance(sel, TemporalEdge):
                return max(sel.hops) if sel.hops else 0
            if isinstance(sel, SparseEdgeChain):
                bs = [bound(m) for m in sel.selectors]
                return None if None in bs else max(bs, default=0)
            if sel.window is not None:
                return sel.window + t_hist()
            return None

        return bound(self.edge_selectors)

    def comm_for(self, t: int, state: ShardedSparseState | None = None
                 ) -> tuple[str, int | None]:
        """(the aggregation's collective, the halo) for a window of t on
        state (a fresh state without one)."""
        halo = self._halo(t, state)
        mode = self.comm
        if mode == "auto":
            mode = "halo" if halo is not None and halo <= self.nb else "psum"
        if mode == "halo" and (halo is None or halo > self.nb):
            raise ValueError(
                f"halo={halo} must fit one neighbour block nb={self.nb} "
                "(raise graph_size/d or use comm='psum')")
        return mode, halo

    # -- forward ---------------------------------------------------------
    def forward(self, x, taus, state: ShardedSparseState,
                return_aux: bool = False, dones=None, generator=None,
                noise=None):
        """x [B, t, F] zero-padded window, taus [B] valid lengths, both
        the same on every rank -> (beliefs [B, t, F_out] replicated,
        this rank's new state[, aux]). dones, generator and noise are
        refused: episode-aware replay and stochastic selectors stay on
        the replicated SparseGCM."""
        if dones is not None:
            raise ValueError("the sharded core does not replay episode ends "
                             "(dones); use the replicated SparseGCM")
        if generator is not None or noise is not None:
            raise ValueError("the sharded core runs deterministic "
                             "selectors only; it takes no noise")
        names = [n for n, _ in self.named_parameters()]
        entered = cc.enter_many([p for _, p in self.named_parameters()]
                                  + [x], self.group)
        out = call_with(self, dict(zip(names, entered[:-1])), "_step",
                        entered[-1], taus, state)
        return out if return_aux else out[:2]

    def _grid(self, sel, x_in, nodes_b, rows, T, taus, new_mask, cols, aux,
              prefix=""):
        B, t = rows.shape
        nb = nodes_b.shape[1]
        if isinstance(sel, TemporalEdge):
            g = torch.zeros((B, t, nb), dtype=nodes_b.dtype,
                            device=nodes_b.device)
            for hop in sel.hops:
                src = rows - hop
                ok = new_mask & (src >= 0) & (rows > 0)
                g = torch.maximum(g, ((cols == src[..., None])
                                      & ok[..., None]).to(g.dtype))
            return g
        N = self.graph_size
        cand = new_mask[..., None] & (
            cols < torch.clamp(rows, 0, N)[..., None])
        if sel.window is not None:
            cand = cand & (cols >= torch.clamp(T[:, None, None] - sel.window,
                                               min=0))
        # the sink features are the inputs themselves: a new row holds x,
        # and the sink's row may live on another rank
        logits = sel._score_pairs(x_in.to(nodes_b.dtype), nodes_b)
        tau = sel._temperature(nodes_b.device)
        finfo = torch.finfo(logits.dtype)
        z = torch.where(cand, logits / tau, finfo.min)
        gmax = cc.pmax(torch.amax(z, dim=2), self.group)
        e = torch.where(cand, torch.exp(z - gmax[..., None]), 0.0)
        denom = cc.psum(e.sum(dim=2), self.group, grad="psum")
        soft = e / torch.clamp_min(denom, finfo.tiny)[..., None]
        keep = (soft > 1.0 / (1 + sel.num_edge_samples)) & cand
        counts = cc._all_reduce(torch.stack([keep.sum(), cand.sum()])
                                  .to(torch.float32), self.group)
        n_taus = torch.clamp(taus.sum(), min=1).to(torch.float32)
        aux.update({f"{prefix}edges_per_node": counts[0] / n_taus,
                    f"{prefix}edge_density":
                        counts[0] / torch.clamp(counts[1], min=1.0),
                    f"{prefix}temperature": tau})
        return torch.where(keep, soft, 0.0)

    def _step(self, x_in, taus, state: ShardedSparseState):
        B, t, _ = x_in.shape
        nb, epl, s = self.nb, self.epl, self.rank
        base = s * nb
        mode, halo = self.comm_for(t, state)
        nodes_b, edges_b, w_b, T, ne_b, span = state
        if nodes_b.shape[1] != nb or edges_b.shape[-1] != epl \
                or ne_b.shape != (B, 1):
            raise ValueError("the state is not this rank's 1/d block")
        dev = x_in.device
        ne = ne_b[:, 0]
        aux = {}

        # 1. insert the new rows this rank owns
        i = torch.arange(t, device=dev)[None, :]
        rows = T[:, None] + i                                  # [B, t]
        new_mask = (i < taus[:, None]) & (rows < self.graph_size)
        loc = rows - base
        mine = new_mask & (loc >= 0) & (loc < nb)
        nodes_b = rows_set(nodes_b, torch.clamp(loc, 0, nb - 1), x_in, mine)

        # 2. the selector's grid over this rank's source columns
        sel = self.edge_selectors
        cols = base + torch.arange(nb, device=dev)[None, None, :]
        grid = None
        if isinstance(sel, SparseEdgeChain):
            for k, member in enumerate(sel.selectors):
                g = self._grid(member, x_in, nodes_b, rows, T, taus,
                               new_mask, cols, aux, prefix=f"{k}/")
                grid = g if grid is None else grid + g
        elif sel is not None:
            grid = self._grid(sel, x_in, nodes_b, rows, T, taus, new_mask,
                              cols, aux)

        # 3. local compaction + append at this rank's cursor
        dropped = torch.zeros((B,), dtype=torch.int32, device=dev)
        if grid is not None:
            flat = grid.reshape(B, t * nb)
            k = min(t * nb, epl)
            idx, ok, count = nonzero_padded(flat > 0, k)
            sinks = take_along(rows, torch.clamp(
                torch.div(idx, nb, rounding_mode="floor"), 0, t - 1))
            srcs = base + idx % nb
            vals = take_along(flat, idx)
            vals = torch.where(ok, grad_preserving_ones(
                torch.where(ok, vals, 1.0)), 1.0)
            new_e = torch.stack([torch.where(ok, sinks, -1),
                                 torch.where(ok, srcs, -1)], dim=1)
            before, n_new = ne, torch.clamp(count, max=k)
            edges_b, w_b, ne, _ = append_edges(edges_b, w_b, ne, new_e,
                                               vals, ok)
            dropped = ((count - n_new) + (before + n_new - ne)).to(
                torch.int32)

        # 4. the preprocessor over the local block
        h = nodes_b
        if self.preprocessor is not None:
            h = self.preprocessor(h)

        # 5. the conv stack over this rank's edges
        valid = edge_mask(edges_b)
        src_l = edges_b[:, 1, :] - base
        valid = valid & (src_l >= 0) & (src_l < nb)
        if mode == "halo":
            sink_l = edges_b[:, 0, :] - base
            ok = valid & (sink_l >= 0) & (sink_l < nb + halo)
            dropped = dropped + (valid & ~ok).sum(-1).to(torch.int32)
        aux["dropped_edges"] = cc._all_reduce(dropped, self.group)
        for layer in self.gnn.layers:
            if not isinstance(layer, GraphConv):
                h = layer(h)
                continue
            F = h.shape[-1]
            if mode == "halo":
                acc = _local_spmm(torch.cat([h, h.new_zeros(B, halo, F)], 1),
                                  sink_l, src_l, ok, w_b)
                agg = acc[:, :nb]
                if halo > 0:
                    tail = cc.ppermute(acc[:, nb:], self.group, 1)
                    agg = agg + torch.cat(
                        [tail, h.new_zeros(B, nb - halo, F)], 1)
            else:
                N = self.graph_size
                acc = _local_spmm(torch.cat([h, h.new_zeros(B, N - nb, F)],
                                            1),
                                  edges_b[:, 0, :], src_l, valid, w_b)
                agg = cc.psum(acc, self.group, grad="psum")[:, base:base
                                                              + nb]
            h = layer.lin_rel(agg) + layer.lin_root(h)

        # 6. the beliefs at the new rows, each owned by one rank
        out_loc = torch.where(mine, loc, nb).long()
        padded = torch.cat([h, h.new_zeros(B, 1, h.shape[-1])], dim=1)
        mx = torch.gather(padded, 1, out_loc[..., None].expand(
            -1, -1, h.shape[-1]))
        mx = cc.psum(torch.where(mine[..., None], mx, 0.0), self.group,
                       grad="identity")
        new_state = ShardedSparseState(nodes_b, edges_b, w_b,
                                       (T + taus).to(torch.int32),
                                       ne[:, None],
                                       torch.maximum(span, taus).to(
                                           torch.int32))
        return mx, new_state, aux

    # -- guards ----------------------------------------------------------
    def check_overflow(self, state: ShardedSparseState, taus) -> None:
        """Raise where the reference would: a window that would carry the
        graph past graph_size nodes."""
        if bool((state.t.cpu() + torch.as_tensor(taus).cpu()
                 > self.graph_size).any()):
            raise OverflowError("Overflow")


def shard_sparse_state(state, d: int, r: int,
                       device=None) -> ShardedSparseState:
    """Rank r of d's blocks of a global sharded state (a tuple of arrays
    in ShardedSparseState's field order: nodes [B, N, F], edges [B, 2,
    d * epl], weights [B, d * epl], t [B], num_edges [B, d], span [B]); a
    rank passes its mesh axis' size and its rank on it. JAX's state has
    no span: its t stands in, a bound on every edge's sink - source (the
    halo may then be wider than needed, never too short).
    `merge_sparse_states` and `gather_sparse_state` go back."""
    nodes, edges, weights, t, num_edges = (np.asarray(a) for a in state[:5])
    span = np.asarray(state[5]) if len(state) > 5 else t
    nb, epl = nodes.shape[1] // d, edges.shape[-1] // d

    def on(a, dtype):
        return torch.tensor(np.ascontiguousarray(a), dtype=dtype,
                            device=device)

    return ShardedSparseState(
        nodes=on(nodes[:, r * nb:(r + 1) * nb], torch.float32),
        edges=on(edges[..., r * epl:(r + 1) * epl], torch.int32),
        weights=on(weights[:, r * epl:(r + 1) * epl], torch.float32),
        t=on(t, torch.int32),
        num_edges=on(num_edges[:, r:r + 1], torch.int32),
        span=on(span, torch.int32))


def merge_sparse_states(states) -> ShardedSparseState:
    """The global sharded state (JAX's layout) from every rank's blocks,
    in rank order."""
    return ShardedSparseState(
        nodes=torch.cat([s.nodes for s in states], 1),
        edges=torch.cat([s.edges for s in states], 2),
        weights=torch.cat([s.weights for s in states], 1),
        t=states[0].t.clone(),
        num_edges=torch.cat([s.num_edges for s in states], 1),
        span=states[0].span.clone())


def gather_sparse_state(state: ShardedSparseState, mesh,
                        axis: str = "dp") -> ShardedSparseState:
    """The global sharded state from every rank's blocks, on every rank
    (all-gathers; JAX's layout: edges [B, 2, d * epl] rank-major,
    num_edges [B, d])."""
    g = axis_group(mesh, axis)
    return ShardedSparseState(
        nodes=cc.all_gather_data(state.nodes, g, 1),
        edges=cc.all_gather_data(state.edges, g, 2),
        weights=cc.all_gather_data(state.weights, g, 1),
        t=state.t.clone(),
        num_edges=cc.all_gather_data(state.num_edges, g, 1),
        span=state.span.clone())
