"""SparseGCM, the sparse time-batched memory core (counterpart of
gcm_tpu/models/sparse_gcm.py).

One call takes a zero-padded window x [B, t, F] with per-batch valid
lengths taus [B] and runs it in one pass:

1. insert the taus[b] new nodes at rows T[b]..T[b]+taus[b]-1 (T = state.t);
2. the edge selector's new edges (grid-free `emit_edges` where the
   selector has it and supports it and, under emit="auto", its
   `emit_profitable` gate says so; else its [B, t, N] grid compacted),
   with weights set to 1.0 by `grad_preserving_ones`, appended at each
   batch's cursor;
3. the preprocessor over all N rows, then the positional encoder (under
   `dones`, at within-episode positions);
4. the aux edge selectors on those encoded nodes (grid path; their aux
   keys prefixed "aux/");
5. optionally the `max_hops` reachability mask, and with an integer
   `hop_cap` the gather-compaction of the reachable subgraph
   (hop_cap="auto" keeps the masked path);
6. the GNN over the padded edge list: spmm_edge_list, or spmm_slots with
   aggregation="slots";
7. beliefs gathered at the new rows, zero past taus[b].

Stochastic selectors draw their Gumbel noise from `generator=`, or take it
from `noise=`, a dict {"edge_selectors": ..., "aux_edge_selectors": ...}
of each selector's noise (its logits' shape; a list for a chain). The
state never wraps around: writes past graph_size or max_edges are dropped
and counted (aux["dropped_edges"]); `check_overflow` raises where the
reference would. `forward` and `scan` are differentiable in the parameters
and x (make_sparse_supervised_step trains through `forward`; a learned
selector's edge weights carry the gradient into its scorer); the guards
wait on the host and stay outside the graph.

The JAX package gates two choices on measurements taken on a TPU: the
emit path against the grid path, and hop_cap="auto"'s compaction against
the masked path. Both were measured again on the H100 (chip_smoke.py's
gate phase, PERF.md): the emit gate holds a factor measured there
(edges/sparse_learned.py); compaction was slower than the masked path at
every point, so that gate went and hop_cap="auto" keeps the masked path.
"""

from __future__ import annotations

import torch
from torch import nn

from gcm_tpu_torch.core.graph_state import (SparseGraphState, reset_where,
                                            sparse_initial_state)
from gcm_tpu_torch.device import resolve_device
from gcm_tpu_torch.ops.cuda.spmm_slots import W, bucket_sink_slots, spmm_slots
from gcm_tpu_torch.ops.scatter import (append_edges, nonzero_padded,
                                       rows_set, take_along)
from gcm_tpu_torch.utils.contracts import Bool, Float, Int, checked
from gcm_tpu_torch.utils.ste import grad_preserving_ones
from gcm_tpu_torch.utils.validation import check_sparse_inputs


def _scatter_any(B, N, idx, values, device):
    """[B, N] bool: True at idx[b, k] where values[b, k]. An index outside
    0..N-1 (a sink past graph_size, left by a dropped write) goes to the
    trash column, as JAX drops an out-of-range scatter."""
    idx = idx.long()
    idx = torch.where((idx >= 0) & (idx < N), idx, N)
    out = torch.zeros((B, N + 1), dtype=torch.uint8, device=device)
    out.scatter_reduce_(1, idx, values.to(torch.uint8), "amax",
                        include_self=True)
    return out[:, :N].bool()


class SparseGCM(nn.Module):
    def __init__(self, gnn, preprocessor=None, edge_selectors=None,
                 aux_edge_selectors=None, graph_size: int = 128,
                 max_edges: int = 1024, max_hops: int | None = None,
                 hop_cap: int | str | None = None, positional_encoder=None,
                 validate: bool = False, aggregation: str = "auto",
                 slot_k: int | None = None, emit: str | bool = "auto", *,
                 device=None):
        super().__init__()
        if hop_cap is not None:
            if hop_cap != "auto" and not isinstance(hop_cap, int):
                raise ValueError(f"hop_cap must be an int or 'auto', got "
                                 f"{hop_cap!r}")
            if max_hops is None:
                raise ValueError("hop_cap requires max_hops")
            if aggregation == "slots":
                raise ValueError(
                    "hop_cap compaction composes with the default "
                    "aggregation; slot buckets are sized for the "
                    "uncompacted graph")
        if aggregation not in ("auto", "slots"):
            raise ValueError(f"unknown aggregation {aggregation!r}")
        if aggregation == "slots":
            if slot_k is None:
                raise ValueError("aggregation='slots' needs slot_k")
            if graph_size % W:
                raise ValueError(
                    f"slot aggregation needs graph_size % {W} == 0")
        if emit not in ("auto", True, False):
            raise ValueError(f"emit must be 'auto', True or False: {emit!r}")
        if (emit is True and edge_selectors is not None
                and not (hasattr(edge_selectors, "emit_edges")
                         and getattr(edge_selectors, "supports_emit", True))):
            raise ValueError(
                "emit=True but the edge selector has no grid-free path")
        self.device = resolve_device(device)

        def to_device(m):
            return m.to(self.device) if isinstance(m, nn.Module) else m

        self.gnn = to_device(gnn)
        self.preprocessor = to_device(preprocessor)
        self.edge_selectors = to_device(edge_selectors)
        self.aux_edge_selectors = to_device(aux_edge_selectors)
        self.positional_encoder = to_device(positional_encoder)
        self.graph_size = graph_size
        self.max_edges = max_edges
        self.max_hops = max_hops
        self.hop_cap = hop_cap
        self.validate = validate
        self.aggregation = aggregation
        self.slot_k = slot_k
        self.emit = emit

    def initial_state(self, B: int, feat: int,
                      dtype=torch.float32) -> SparseGraphState:
        """Empty state; `feat` is the observation width."""
        return sparse_initial_state(B, self.graph_size, feat, self.max_edges,
                                    dtype=dtype, device=self.device)

    def _use_emit(self, t: int, N: int) -> bool:
        """The grid-free path wherever the selector has it and supports it,
        unless emit=False; under "auto" also only where the selector's
        `emit_profitable(t, N)` gate, if it has one, says so."""
        sel = self.edge_selectors
        if (self.emit is False or not hasattr(sel, "emit_edges")
                or not getattr(sel, "supports_emit", True)):
            return False
        gate = getattr(sel, "emit_profitable", None)
        return self.emit is True or gate is None or gate(t, N)

    @checked
    def forward(self, x: Float["B t F"], taus: Int["B"],
                state: SparseGraphState, return_aux: bool = False,
                dones: Bool["B t"] | None = None,
                generator: torch.Generator | None = None, noise=None):
        """x [B, t, F] zero-padded window, taus [B] valid lengths; dones
        [B, t] optional episode ends inside the window, after which no edge
        reaches back across the boundary and positions restart. Stochastic
        selectors draw from `generator` or take `noise` (see the module
        docstring). Returns (beliefs [B, t, F_out], new state[, aux])."""
        if self.validate:
            check_sparse_inputs(x, taus, state, self.graph_size,
                                self.max_edges)
        B, t, _ = x.shape
        N = self.graph_size
        nodes, edges, weights, T, num_edges = state
        dev = x.device
        noise = noise or {}
        aux = {}

        i = torch.arange(t, device=dev)[None, :]
        rows = T[:, None] + i                                 # [B, t]
        new_mask = (i < taus[:, None]) & (rows < N)
        nodes = rows_set(nodes, rows, x, new_mask)
        dirty_nodes = nodes

        seg_mask = positions = None
        if dones is not None:
            d = dones.to(torch.int32)
            # segment of each new node: the dones strictly before it; rows
            # already in the graph belong to segment 0
            seg_new = torch.cumsum(d, dim=1, dtype=torch.int32) - d
            rowseg = rows_set(torch.zeros((B, N), dtype=torch.int32,
                                          device=dev), rows, seg_new, new_mask)
            seg_mask = seg_new[:, :, None] == rowseg[:, None, :]  # [B, t, N]
            # within-episode position of each new node: steps since the
            # last start in the window, or T + i in the carried-over episode
            starts = torch.cat([torch.zeros((B, 1), dtype=torch.int32,
                                            device=dev), d[:, :-1]], dim=1)
            last_start = torch.cummax(torch.where(starts > 0, i, -1),
                                      dim=1).values
            pos_new = torch.where(last_start >= 0, i - last_start,
                                  T[:, None] + i).to(torch.int32)
            positions = rows_set(
                torch.arange(N, dtype=torch.int32, device=dev)[None, :]
                .expand(B, N).contiguous(), rows, pos_new, new_mask)
        kw = {} if seg_mask is None else {"seg_mask": seg_mask}

        dropped_total = torch.zeros((B,), dtype=torch.int32, device=dev)
        sel = self.edge_selectors
        if sel is not None:
            sel_kw = dict(kw, generator=generator,
                          noise=noise.get("edge_selectors"))
            if self._use_emit(t, N):
                new_e, vals, valid, sel_aux = sel.emit_edges(
                    dirty_nodes, T, taus, t, **sel_kw)
                aux.update(sel_aux)
                edges, weights, num_edges, dropped = self._append_emitted(
                    edges, weights, num_edges, new_e, vals, valid)
            else:
                grid, sel_aux = sel(dirty_nodes, T, taus, t, **sel_kw)
                aux.update(sel_aux)
                edges, weights, num_edges, dropped = self._append_grid(
                    edges, weights, num_edges, grid, rows)
            dropped_total = dropped_total + dropped

        if self.preprocessor is not None:
            dirty_nodes = self.preprocessor(dirty_nodes)
        if self.positional_encoder is not None:
            pe_kw = {} if positions is None else {"positions": positions}
            dirty_nodes = self.positional_encoder(dirty_nodes, T + taus,
                                                  **pe_kw)
        if self.aux_edge_selectors is not None:
            grid, sel_aux = self.aux_edge_selectors(
                dirty_nodes, T, taus, t, generator=generator,
                noise=noise.get("aux_edge_selectors"), **kw)
            aux.update({f"aux/{k}": v for k, v in sel_aux.items()})
            edges, weights, num_edges, dropped = self._append_grid(
                edges, weights, num_edges, grid, rows)
            dropped_total = dropped_total + dropped

        gnn_edges, gnn_weights, gnn_nodes = edges, weights, dirty_nodes
        out_rows, out_n = rows, N
        if self.max_hops is not None:
            gnn_edges = self._k_hop_edge_mask(edges, new_mask, rows, N)
            # hop_cap="auto" takes the masked path: on the card compaction
            # was slower at every point of chip_smoke.py's gate phase
            cap = None if self.hop_cap == "auto" else self.hop_cap
            if cap is not None:
                (gnn_nodes, gnn_edges, out_rows,
                 aux["hop_overflow"]) = self._compact_reachable(
                    dirty_nodes, gnn_edges, new_mask, rows, t, cap)
                out_n = cap
        if self.aggregation == "slots":
            srcs, ws, counts = bucket_sink_slots(gnn_edges, gnn_weights, N,
                                                 self.slot_k)
            aux["slot_overflow"] = torch.clamp(
                counts - self.slot_k, min=0).sum(dim=(1, 2), dtype=torch.int32)
            node_feats = self.gnn(
                gnn_nodes, gnn_edges, gnn_weights,
                agg_fn=lambda h: spmm_slots(h, srcs, ws, N, self.slot_k))
        else:
            node_feats = self.gnn(gnn_nodes, gnn_edges, gnn_weights)
        aux["dropped_edges"] = dropped_total

        # beliefs at the new rows (compacted ids under hop_cap, -1 where an
        # output node was dropped); padding stays zero
        safe_rows = torch.clamp(out_rows, 0, out_n - 1).long()
        mx = torch.gather(node_feats, 1, safe_rows[..., None].expand(
            -1, -1, node_feats.shape[-1]))
        out_ok = new_mask & (out_rows >= 0)
        mx = torch.where(out_ok[..., None], mx, 0.0)

        new_state = SparseGraphState(nodes, edges, weights,
                                     (T + taus).to(torch.int32), num_edges)
        if return_aux:
            return mx, new_state, aux
        return mx, new_state

    # -- edge appends ------------------------------------------------------
    def _append_grid(self, edges, weights, num_edges, grid, rows):
        """Compact a [B, t, N] weight grid into the padded edge list. Also
        returns the edges lost to the compaction cap or the capacity."""
        B, t, N = grid.shape
        flat = grid.reshape(B, t * N)
        k = min(t * N, self.max_edges)
        idx, valid, count = nonzero_padded(flat > 0, k)
        sinks = take_along(rows, torch.clamp(idx // N, 0, t - 1))
        sj = idx % N
        vals = take_along(flat, idx)
        vals = torch.where(valid, grad_preserving_ones(
            torch.where(valid, vals, 1.0)), 1.0)
        new_e = torch.stack([torch.where(valid, sinks, -1),
                             torch.where(valid, sj, -1)], dim=1)
        before = num_edges
        n_new = torch.clamp(count, max=k)
        edges, weights, num_edges, _ = append_edges(
            edges, weights, num_edges, new_e, vals, valid)
        dropped = (count - n_new) + (before + n_new - num_edges)
        return edges, weights, num_edges, dropped

    def _append_emitted(self, edges, weights, num_edges, new_e, vals, valid):
        """Append directly emitted edges, with the grid path's weights."""
        vals = torch.where(valid, grad_preserving_ones(
            torch.where(valid, vals, 1.0)), 1.0)
        before = num_edges
        n_new = valid.sum(dim=-1, dtype=num_edges.dtype)
        edges, weights, num_edges, _ = append_edges(
            edges, weights, num_edges, new_e, vals, valid)
        return edges, weights, num_edges, before + n_new - num_edges

    # -- k-hop subgraph ------------------------------------------------------
    def _k_hop_edge_mask(self, edges, new_mask, rows, N):
        """Sentinel-mask the edges outside the max_hops-hop subgraph around
        the new nodes: max_hops rounds of sink -> source reachability from
        them, then keep the edges with both ends reachable."""
        B = edges.shape[0]
        valid = (edges[:, 0, :] >= 0) & (edges[:, 1, :] >= 0)
        sink = torch.clamp(edges[:, 0, :].long(), 0, N - 1)
        src = torch.clamp(edges[:, 1, :].long(), 0, N - 1)
        reach = _scatter_any(B, N, torch.clamp(rows, 0, N - 1), new_mask,
                             edges.device)
        for _ in range(self.max_hops):
            at_sink = torch.gather(reach, 1, sink) & valid
            reach = reach | _scatter_any(B, N, src, at_sink, edges.device)
        keep = (valid & torch.gather(reach, 1, sink)
                & torch.gather(reach, 1, src))
        return torch.where(keep[:, None, :], edges, -1)

    def _compact_reachable(self, dirty_nodes, masked_edges, new_mask, rows,
                           t, cap):
        """Gather the k-hop subgraph into [B, cap, F] with renumbered edges.
        A node survives if it is an output node or an end of a kept edge;
        newest first, so on overflow the oldest drop and the outputs stay
        while cap >= t. Returns (nodes [B,cap,F], edges [B,2,E] in
        compacted ids, rows [B,t] compacted output rows (-1 where padded or
        dropped), overflow [B] reachable nodes beyond cap)."""
        if cap < t:
            raise ValueError(f"hop_cap={cap} must cover the window length "
                             f"t={t} so output nodes survive compaction")
        B, N, F = dirty_nodes.shape
        dev = dirty_nodes.device
        sink, src = masked_edges[:, 0, :], masked_edges[:, 1, :]
        valid = (sink >= 0) & (src >= 0)
        used = (_scatter_any(B, N, torch.clamp(rows, 0, N - 1), new_mask, dev)
                | _scatter_any(B, N, torch.where(valid, sink, 0), valid, dev)
                | _scatter_any(B, N, torch.where(valid, src, 0), valid, dev))
        # newest first: nonzero over the index-reversed mask keeps the
        # largest node ids under truncation
        idx_r, ok, count = nonzero_padded(used.flip(-1), cap)
        idx = torch.where(ok, N - 1 - idx_r.long(), N)  # invalid: trash col
        overflow = torch.clamp(count - cap, min=0)
        lane = torch.arange(cap, dtype=torch.int32, device=dev)[None, :] \
            .expand(B, cap)
        inv = torch.full((B, N + 1), -1, dtype=torch.int32, device=dev)
        inv[torch.arange(B, device=dev)[:, None], idx] = \
            torch.where(ok, lane, -1)
        inv = inv[:, :N]
        nodes_sub = torch.gather(dirty_nodes, 1, torch.clamp(idx, 0, N - 1)
                                 [..., None].expand(-1, -1, F))
        nodes_sub = torch.where(ok[..., None], nodes_sub, 0.0)
        sink_sub = take_along(inv, torch.clamp(sink, 0, N - 1))
        src_sub = take_along(inv, torch.clamp(src, 0, N - 1))
        keep = valid & (sink_sub >= 0) & (src_sub >= 0)
        edges_sub = torch.where(keep[:, None, :],
                                torch.stack([sink_sub, src_sub], dim=1), -1)
        rows_sub = take_along(inv, torch.clamp(rows, 0, N - 1))
        rows_sub = torch.where(new_mask, rows_sub, -1)
        return nodes_sub, edges_sub, rows_sub, overflow

    # -- guards ------------------------------------------------------------
    def check_overflow(self, state: SparseGraphState, taus) -> None:
        """Raise where the reference would: a window that would carry the
        graph past graph_size nodes."""
        if bool((state.t.cpu() + torch.as_tensor(taus).cpu()
                 > self.graph_size).any()):
            raise OverflowError("Overflow")

    def check_hop_overflow(self, aux) -> None:
        """Raise when hop_cap compaction dropped reachable nodes
        (aux['hop_overflow'] > 0 from a return_aux=True call)."""
        if "hop_overflow" not in aux:
            return
        dropped = aux["hop_overflow"]
        if bool((dropped > 0).any()):
            raise RuntimeError(
                f"hop_cap dropped {int(dropped.max())} reachable node(s) per "
                "batch (aux['hop_overflow']); the cap is too small for this "
                "state's edge history: raise hop_cap or use the masked "
                "max_hops path (hop_cap=None)")

    def scan(self, xs, state: SparseGraphState, dones=None,
             unroll: int | None = None,
             generator: torch.Generator | None = None, noise=None):
        """Step the core one timestep at a time (t=1 windows) over xs
        [B, T, F] -> (beliefs [B, T, F_out], final state). dones [B, T]:
        the memory of batch b is wiped after the step where dones[b, t].
        Stochastic selectors draw from `generator`, or take noise[t] (a
        `forward` noise dict) at step t. `unroll` is accepted only at its
        default: it is a compile knob of XLA's scan with no eager
        meaning."""
        if unroll is not None:
            raise NotImplementedError(
                "unroll is an XLA scan compile knob with no eager meaning")
        B, T_len, _ = xs.shape
        taus1 = torch.ones((B,), dtype=torch.int32, device=xs.device)
        outs = []
        for t in range(T_len):
            out, state = self(xs[:, t:t + 1], taus1, state,
                              generator=generator,
                              noise=None if noise is None else noise[t])
            if dones is not None:
                state = reset_where(state, dones[:, t])
            outs.append(out[:, 0])
        return torch.stack(outs, dim=1), state
