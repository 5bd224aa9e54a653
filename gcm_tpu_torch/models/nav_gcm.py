"""NavGCM, the navigation memory core (counterpart of
gcm_tpu/models/nav_gcm.py): the state holds raw observations, positions and
rotations, and the edges are rebuilt from geometry on every call (radius or
k nearest over positions) instead of persisted. Causal mode keeps only
sources before the sink, so a whole sequence in one call gives the beliefs
that stepping it gives.

- `NavGCM`: causal, full (non-causal: one graph per step over the prefix,
  the t steps folded into the batch, one kernel call a layer) and pool
  modes, with radius or kNN edges.
- `NavGCMIncremental`: the causal core for collection, computing only the
  tau new rows a call against cached per-layer features (O(tau * V)); its
  outputs equal NavGCM(causal=True)'s.
- `nav_core`: picks between the two by graph size (NAV_INCREMENTAL_MIN_V,
  measured on the card).

GNN protocol: gnn(x, adj_mask, pos, rot, valid, T, taus) -> feats [B, V,
F_out], adj_mask[b, i, j] = message j -> i. `NavDenseGNN` runs its
DenseGraphConv layers one by one on the mask as a dense adjacency, each
'add' layer through `ops/dispatch.py::dense_graph_conv` (the one-layer
kernel on the card, its backward the stack backward's), as JAX calls them
layer by layer; the incremental core's row-restricted products are
einsums, as in JAX.

Distances: both cores compute |a|^2 - 2 a.b + |b|^2 (the JAX package's
expanded form) with each dot product an ordered elementwise sum over the
coordinates, never a matmul, so the same pair of positions gets the same
bits in the full core's [B, V, V] call, the incremental core's [B, tau, V]
call, on the CPU and on the card; a tied or near-tied distance then
selects the same neighbours in both cores.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from gcm_tpu_torch.core.graph_state import register_reset, zero_reset
from gcm_tpu_torch.device import resolve_device
from gcm_tpu_torch.nn.dense_conv import (_CONVS, DenseGraphConv,
                                         conv_project)
from gcm_tpu_torch.nn.nav_conv import NavPoseGNN, NavRelPosConv
from gcm_tpu_torch.ops.scatter import rows_set
from gcm_tpu_torch.utils.contracts import Float, Int, checked


# nav_core's crossover: maps of at least this many vertices take the
# incremental core. Set from chip_smoke.py's nav gate on the card (a tau = 1
# tick of both cores at B = 16, V = 32..1,024; PERF.md), not carried over
# from the JAX package's TPU value: both ticks are host-bound there and the
# incremental one never won clearly, so it is taken where the full core's
# kernels cannot run (above 1,024 vertices).
NAV_INCREMENTAL_MIN_V: int = 1025


class NavState(NamedTuple):
    x: torch.Tensor    # [B, V, F]
    pos: torch.Tensor  # [B, V, P]
    rot: torch.Tensor  # [B, V, R]
    t: torch.Tensor    # [B] int32


@register_reset(NavState)
def _reset_nav(state, mask_for):
    return zero_reset(state, mask_for)


class NavIncState(NamedTuple):
    x: torch.Tensor    # [B, V, F]
    pos: torch.Tensor  # [B, V, P]
    rot: torch.Tensor  # [B, V, R]
    caches: tuple      # per conv after the first: [B, V, F_l] its inputs
    t: torch.Tensor    # [B] int32


@register_reset(NavIncState)
def _reset_nav_inc(state, mask_for):
    def leaf(a):
        m = mask_for(a)
        return a if m is None else torch.where(m, torch.zeros_like(a), a)

    x, pos, rot, caches, t = state
    return NavIncState(leaf(x), leaf(pos), leaf(rot),
                       tuple(leaf(c) for c in caches), leaf(t))


def pair_distance(a, b):
    """|a_i - b_j| for a [..., S, P], b [..., V, P] -> [..., S, V], in the
    expanded form with every dot product summed over P in order by
    elementwise ops (bitwise the same for the same pair in any call and on
    any device)."""
    a2 = a[..., 0] * a[..., 0]
    b2 = b[..., 0] * b[..., 0]
    ab = a[..., :, None, 0] * b[..., None, :, 0]
    for p in range(1, a.shape[-1]):
        a2 = a2 + a[..., p] * a[..., p]
        b2 = b2 + b[..., p] * b[..., p]
        ab = ab + a[..., :, None, p] * b[..., None, :, p]
    sq = a2[..., :, None] - 2.0 * ab + b2[..., None, :]
    return torch.sqrt(torch.clamp_min(sq, 0.0))


def knn_cap(d, mask, k):
    """Keep, per sink row, the candidates of `mask` whose distance is at
    most the k-th smallest candidate distance (ties kept; every candidate
    where there are fewer than k)."""
    if k is None or k >= d.shape[-1]:
        return mask
    big = torch.finfo(d.dtype).max
    dm = torch.where(mask, d, big)
    kth = torch.topk(dm, k, dim=-1, largest=False).values[..., k - 1:k]
    return mask & (dm <= kth)


def _insert(state_x, state_pos, state_rot, T, x, pos, rot, taus, V):
    """Write the window's rows at T[b] + i (i < taus[b], inside V)."""
    t = x.shape[1]
    i = torch.arange(t, device=x.device)[None, :]
    rows = T[:, None].long() + i
    new_mask = (i < taus[:, None]) & (rows < V)
    return (rows, new_mask, rows_set(state_x, rows, x, new_mask),
            rows_set(state_pos, rows, pos, new_mask),
            rows_set(state_rot, rows, rot, new_mask))


class NavDenseGNN(nn.Module):
    """A dense conv stack over cat(x, pos, rot) (use_pose) with the nav
    adjacency mask as the dense adjacency, layer by layer."""

    def __init__(self, layers, use_pose: bool = True):
        super().__init__()
        self.layers = list(layers)
        self.blocks = nn.ModuleList(
            [m for m in self.layers if isinstance(m, nn.Module)])
        self.use_pose = use_pose

    def forward(self, x, adj_mask, pos, rot, valid=None, T=None, taus=None):
        if self.use_pose:
            x = torch.cat([x, pos, rot], dim=-1)
        adj = adj_mask.to(x.dtype)
        for layer in self.layers:
            x = layer(x, adj) if isinstance(layer, _CONVS) else layer(x)
        return x


class NavGCM(nn.Module):
    def __init__(self, gnn, pool: bool = False, max_verts: int = 128,
                 edge_method: str = "radius", k: int | None = 16,
                 r: float = 1.0, causal: bool = True, *, device=None):
        super().__init__()
        if edge_method not in ("knn", "radius"):
            raise ValueError(f"edge_method {edge_method!r}")
        self.device = resolve_device(device)
        self.gnn = gnn
        self.pool = pool
        self.max_verts = max_verts
        self.edge_method = edge_method
        self.k = k
        self.r = r
        self.causal = causal

    def initial_state(self, B: int, feat: int, pos_dim: int = 2,
                      rot_dim: int = 1, dtype=torch.float32) -> NavState:
        V, dev = self.max_verts, self.device
        return NavState(
            x=torch.zeros((B, V, feat), dtype=dtype, device=dev),
            pos=torch.zeros((B, V, pos_dim), dtype=dtype, device=dev),
            rot=torch.zeros((B, V, rot_dim), dtype=dtype, device=dev),
            t=torch.zeros((B,), dtype=torch.int32, device=dev))

    def _edges(self, d, valid):
        """Adjacency mask [..., V, V] (mask[..., i, j] = edge j -> i) from
        the distances d [..., V, V] among the valid [..., V] nodes."""
        pair_ok = valid[..., :, None] & valid[..., None, :]
        if self.causal:  # source strictly before sink (no self loops)
            iu = torch.arange(d.shape[-1], device=d.device)
            pair_ok = pair_ok & (iu[None, :] < iu[:, None])
        mask = (d <= self.r) & pair_ok if self.edge_method == "radius" \
            else pair_ok
        return knn_cap(d, mask, self.k)

    @checked
    def forward(self, x: Float["B t F"], pos: Float["B t P"],
                rot: Float["B t R"], taus: Int["B"], state: NavState):
        """x [B, t, F], pos [B, t, P], rot [B, t, R], taus [B] -> (output
        [B, t, F_out], zero past each taus[b], new state)."""
        B, t, _ = x.shape
        V = self.max_verts
        old_x, old_pos, old_rot, T = state
        rows, new_mask, new_x, new_pos, new_rot = _insert(
            old_x, old_pos, old_rot, T, x, pos, rot, taus, V)
        total = T + taus
        ar = torch.arange(V, device=x.device)
        valid = ar[None, :] < total[:, None]
        d = pair_distance(new_pos, new_pos)
        if self.pool or self.causal:
            feats = self.gnn(new_x, self._edges(d, valid), new_pos, new_rot,
                             valid, T, taus)
            if self.pool:
                denom = torch.clamp_min(valid.sum(-1, keepdim=True), 1)
                pooled = torch.where(valid[..., None], feats, 0.0).sum(1) \
                    / denom
                out = pooled[:, None, :].expand(B, t, pooled.shape[-1])
            else:
                safe = torch.clamp(rows, 0, V - 1)
                out = torch.gather(feats, 1, safe[..., None].expand(
                    B, t, feats.shape[-1]))
        else:
            # full (loop-closure) mode: step s's graph is the prefix
            # 0..T+s with non-causal edges, read at node T+s; the t graphs
            # are folded into the batch, one GNN call for all of them
            last = torch.clamp(rows, 0, V - 1)                  # [B, t]
            pv = (ar[None, None, :] <= last[..., None]) & valid[:, None, :]
            adj = self._edges(d[:, None], pv)                   # [B,t,V,V]

            def fold(a):
                return a[:, None].expand(B, t, *a.shape[1:]).reshape(
                    B * t, *a.shape[1:])

            feats = self.gnn(fold(new_x), adj.reshape(B * t, V, V),
                             fold(new_pos), fold(new_rot),
                             pv.reshape(B * t, V), fold(T), fold(taus))
            feats = feats.reshape(B, t, V, -1)
            out = torch.gather(feats, 2, last[..., None, None].expand(
                B, t, 1, feats.shape[-1]))[:, :, 0]
        out = torch.where(new_mask[..., None], out, 0.0)
        return out, NavState(new_x, new_pos, new_rot, total)


class NavGCMIncremental(nn.Module):
    """The causal NavGCM for collection: computes only the tau NEW rows a
    call. In causal mode an old node's adjacency row never changes (its
    candidate sources are earlier nodes, whose positions are fixed), so
    neither do its features at any layer: the core caches each conv's
    input features for all V slots and, per call, computes geometry and
    convolutions for the new rows alone. Outputs equal
    NavGCM(causal=True)'s. Needs a NavDenseGNN or NavPoseGNN whose
    parameterised layers are DenseGraphConv / NavRelPosConv; no pool mode
    (it never materialises the old nodes' last features)."""

    @staticmethod
    def supports(gnn) -> bool:
        """Can this GNN run on the incremental core? (nav_core's
        dispatch asks this rather than catching a constructor's error.)"""
        if not isinstance(gnn, (NavDenseGNN, NavPoseGNN)):
            return False
        layers = getattr(gnn, "layers", None)
        if not isinstance(layers, (list, tuple)):
            return False
        return all(isinstance(layer, (DenseGraphConv, NavRelPosConv))
                   for layer in layers if isinstance(layer, nn.Module)
                   and any(True for _ in layer.parameters()))

    def __init__(self, gnn, max_verts: int = 128,
                 edge_method: str = "radius", k: int | None = 16,
                 r: float = 1.0, *, device=None):
        super().__init__()
        if edge_method not in ("knn", "radius"):
            raise ValueError(f"edge_method {edge_method!r}")
        if not self.supports(gnn):
            raise TypeError(
                "NavGCMIncremental needs a NavDenseGNN or NavPoseGNN of "
                "DenseGraphConv / NavRelPosConv layers (see "
                "NavGCMIncremental.supports)")
        self.device = resolve_device(device)
        self.gnn = gnn
        self.max_verts = max_verts
        self.edge_method = edge_method
        self.k = k
        self.r = r
        self.causal = True
        self._convs = [m for m in gnn.layers
                       if isinstance(m, (DenseGraphConv, NavRelPosConv))]

    def initial_state(self, B: int, feat: int, pos_dim: int = 2,
                      rot_dim: int = 1, dtype=torch.float32) -> NavIncState:
        V, dev = self.max_verts, self.device
        return NavIncState(
            x=torch.zeros((B, V, feat), dtype=dtype, device=dev),
            pos=torch.zeros((B, V, pos_dim), dtype=dtype, device=dev),
            rot=torch.zeros((B, V, rot_dim), dtype=dtype, device=dev),
            caches=tuple(torch.zeros((B, V, c.in_dim), dtype=dtype,
                                     device=dev) for c in self._convs[1:]),
            t=torch.zeros((B,), dtype=torch.int32, device=dev))

    @staticmethod
    def _conv_rows(conv, adj_rows, x_all, x_rows):
        """DenseGraphConv restricted to the sink rows: adj_rows [B, tau,
        V], x_all [B, V, F] (sources), x_rows [B, tau, F] (root term); the
        value of conv(x_all, adj)[rows]."""
        a = adj_rows.to(x_all.dtype)
        if conv.aggr == "max":
            neg = torch.finfo(x_all.dtype).min
            msgs = torch.where(adj_rows[..., None], x_all[:, None, :, :], neg)
            agg = msgs.amax(dim=2)
            agg = torch.where(agg == neg, 0.0, agg)
        else:
            agg = torch.einsum("btv,bvf->btf", a, x_all)
            if conv.aggr == "mean":
                agg = agg / torch.clamp_min(a.sum(-1, keepdim=True), 1.0)
        return conv_project(conv, agg, x_rows)

    @checked
    def forward(self, x: Float["B t F"], pos: Float["B t P"],
                rot: Float["B t R"], taus: Int["B"], state: NavIncState):
        B, t, _ = x.shape
        V = self.max_verts
        old_x, old_pos, old_rot, caches, T = state
        rows, new_mask, new_x, new_pos, new_rot = _insert(
            old_x, old_pos, old_rot, T, x, pos, rot, taus, V)
        total = T + taus

        # adjacency rows of the new sinks only: [B, tau, V]
        d_rows = pair_distance(pos, new_pos)
        ar = torch.arange(V, device=x.device)[None, None, :]
        pair_ok = (ar < total[:, None, None]) & (ar < rows[:, :, None])
        mask = (d_rows <= self.r) & pair_ok if self.edge_method == "radius" \
            else pair_ok
        adj_rows = knn_cap(d_rows, mask, self.k)

        # conv l > 0 reads the cached inputs of every slot (static in
        # causal mode), refreshed with this call's rows first
        if getattr(self.gnn, "use_pose", False):
            h_rows = torch.cat([x, pos, rot], dim=-1)
            h_all = torch.cat([new_x, new_pos, new_rot], dim=-1)
        else:
            h_rows, h_all = x, new_x
        new_caches = []
        ci = 0
        for layer in self.gnn.layers:
            if isinstance(layer, (DenseGraphConv, NavRelPosConv)):
                if ci > 0:
                    h_all = rows_set(caches[ci - 1], rows, h_rows, new_mask)
                    new_caches.append(h_all)
                if isinstance(layer, DenseGraphConv):
                    h_rows = self._conv_rows(layer, adj_rows, h_all, h_rows)
                else:
                    h_rows = layer.messages(h_all, adj_rows, new_pos, pos,
                                            new_rot, rot) \
                        + layer.lin_root(h_rows)
                ci += 1
            else:
                h_rows = layer(h_rows)
        out = torch.where(new_mask[..., None], h_rows, 0.0)
        return out, NavIncState(new_x, new_pos, new_rot, tuple(new_caches),
                                total)


def nav_core(gnn, max_verts: int = 128, edge_method: str = "radius",
             k: int | None = 16, r: float = 1.0, causal: bool = True,
             pool: bool = False, *, device=None):
    """The incremental core where it is faster and can run (causal, no
    pool, a GNN it can cache, max_verts >= NAV_INCREMENTAL_MIN_V), else
    NavGCM. The two carry different states (NavState, NavIncState): call
    `initial_state` on what this returns."""
    if (causal and not pool and max_verts >= NAV_INCREMENTAL_MIN_V
            and NavGCMIncremental.supports(gnn)):
        return NavGCMIncremental(gnn, max_verts=max_verts,
                                 edge_method=edge_method, k=k, r=r,
                                 device=device)
    return NavGCM(gnn, pool=pool, max_verts=max_verts,
                  edge_method=edge_method, k=k, r=r, causal=causal,
                  device=device)
