"""Edge- and node-partitioned graph aggregation over a mesh axis
(counterpart of gcm_tpu/parallel/edge_partition.py), one rank a shard.

Each function returns f(...) that a rank calls with the blocks JAX's
shard_map in_specs would hand it, and returns the rank's block of the
out_specs:

- `spmm_edge_partitioned`: x [B, N, F] replicated, the rank's block of
  the edge axis; each rank aggregates its edges into a full-width partial
  and one psum adds them. Out: [B, N, F] replicated.
- `spmm_node_partitioned`: x [B, N/d, F] the rank's node block, the
  rank's sink-bucketed edges (`bucket_edges_by_sink`, global indices);
  the source rows are all-gathered. Out: the rank's node block.
- `spmm_bucketed`: node blocks and (source shard, sink shard)-bucketed
  edges (`bucket_edges_cross`): each rank gathers the messages of its
  outgoing edges, one all_to_all routes them (and their sinks) to the
  sink's owner. Out: the rank's node block.
- `spmm_halo`: node blocks and sink-bucketed edges of a banded graph
  (source >= sink's block start - halo): one ppermute brings the left
  neighbour's last `halo` rows. Out: the rank's node block.

Every shard-local sum is the port's SpMM (`ops/dispatch.py::spmm`, the
spmm_edge_list kernel on the card) in local coordinates: sinks outside
the rank's rows are sentinels, which the kernel drops. The gradients
follow `parallel/comm.py`: a replicated input that feeds shard-local work
is entered (its gradient summed over the ranks), a replicated output is a
psum or an all_gather whose backward is the identity or the rank's slice.

`PartitionedSparseGNN` is the model-level entry: a SparseGNN stack of
GraphConv('add') layers whose aggregations run on these collectives, a
drop-in `gnn=` for the replicated SparseGCM, whose parameter tree is
SparseGNN's. Modes as JAX's: "halo", "bucketed", "psum", and "auto"
(halo where `halo` is given; else psum for num_nodes <= 256; else
bucketed). Each rank runs the replicated SparseGCM around it alike.
"""

from __future__ import annotations

import torch
from torch import nn

from gcm_tpu_torch.nn.sparse_conv import GraphConv
from gcm_tpu_torch.ops.dispatch import spmm
from gcm_tpu_torch.ops.scatter import edge_mask, nonzero_padded, take_along
from gcm_tpu_torch.parallel import comm
from gcm_tpu_torch.parallel.mesh import axis_group, axis_rank, axis_size


def _local_spmm(x, sink, src, ok, w):
    """sum over lanes with ok of w * x[src] into row sink: the SpMM kernel
    on x's rows, sentinels where not ok."""
    e = torch.stack([torch.where(ok, sink, -1), torch.where(ok, src, -1)],
                    dim=1).to(torch.int32).contiguous()
    return spmm(x.contiguous(), e,
                torch.where(ok, w, 0.0).to(x.dtype).contiguous())


def _axis(mesh, axis):
    return axis_group(mesh, axis), axis_size(mesh, axis), \
        axis_rank(mesh, axis)


def spmm_edge_partitioned(mesh, axis: str = "dp"):
    group = axis_group(mesh, axis)

    def f(x, edges, weights):
        x = comm.enter(x, group)
        partial = _local_spmm(x, edges[:, 0, :], edges[:, 1, :],
                              edge_mask(edges), weights)
        return comm.psum(partial, group, grad="identity")

    return f


def spmm_node_partitioned(mesh, axis: str = "dp"):
    group, _, r = _axis(mesh, axis)

    def f(x_block, edges, weights):
        nb = x_block.shape[1]
        x_full = comm.all_gather(x_block, group, 1)
        local_sink = edges[:, 0, :] - r * nb
        ok = edge_mask(edges) & (local_sink >= 0) & (local_sink < nb)
        return _local_spmm(x_full, local_sink, edges[:, 1, :], ok,
                           weights)[:, :nb]

    return f


def bucket_edges_cross(edges, weights, n_shards: int, num_nodes: int,
                       k_pair: int):
    """Bucket a padded edge list by (source shard, sink shard) pair, each
    pair a k_pair-lane slice, source-shard-major, so that the rank s's
    block of the edge axis holds its outgoing edges grouped by target.
    Lanes past k_pair in a pair are dropped. Returns (edges [B, 2,
    n_shards^2 * k_pair], weights), sentinel-padded."""
    block = num_nodes // n_shards
    valid = edge_mask(edges)
    sink_dev = torch.clamp(torch.div(edges[:, 0, :], block,
                                      rounding_mode="floor"), 0, n_shards - 1)
    src_dev = torch.clamp(torch.div(edges[:, 1, :], block,
                                    rounding_mode="floor"), 0, n_shards - 1)
    out_e, out_w = [], []
    for s in range(n_shards):
        for t in range(n_shards):
            m = valid & (src_dev == s) & (sink_dev == t)
            idx, ok, _ = nonzero_padded(m, k_pair)
            sink = torch.where(ok, take_along(edges[:, 0, :], idx), -1)
            src = torch.where(ok, take_along(edges[:, 1, :], idx), -1)
            out_e.append(torch.stack([sink, src], dim=1))
            out_w.append(torch.where(ok, take_along(weights, idx), 0.0))
    return (torch.cat(out_e, dim=-1).to(edges.dtype),
            torch.cat(out_w, dim=-1))


def spmm_bucketed(mesh, num_nodes: int, axis: str = "dp"):
    group, d, r = _axis(mesh, axis)
    nb = num_nodes // d

    def f(x_block, edges, w):
        B, _, L = edges.shape
        F = x_block.shape[-1]
        k = L // d
        sink, src = edges[:, 0, :], edges[:, 1, :]
        valid = (sink >= 0) & (src >= 0)
        src_local = torch.clamp(src - r * nb, 0, nb - 1).long()
        msgs = torch.gather(x_block, 1,
                            src_local[..., None].expand(-1, -1, F))
        msgs = torch.where(valid[..., None], msgs * w[..., None], 0.0)
        # route the messages and their sinks to the sinks' owners
        msgs = comm.all_to_all(msgs.reshape(B, d, k, F), group, 1)
        sink = comm.all_to_all_data(sink.reshape(B, d, k), group, 1)
        msgs = msgs.reshape(B, d * k, F)
        sl = sink.reshape(B, d * k) - r * nb
        ok = (sink.reshape(B, d * k) >= 0) & (sl >= 0) & (sl < nb)
        rows = max(d * k, nb)
        if rows > d * k:
            msgs = torch.cat([msgs, msgs.new_zeros(B, rows - d * k, F)], 1)
        lane = torch.arange(d * k, device=msgs.device)[None, :].expand(B, -1)
        return _local_spmm(msgs, sl, lane, ok,
                           torch.ones_like(sl, dtype=msgs.dtype))[:, :nb]

    return f


def spmm_halo(mesh, num_nodes: int, halo: int, axis: str = "dp"):
    group, d, r = _axis(mesh, axis)
    nb = num_nodes // d
    if halo > nb:
        raise ValueError(f"halo={halo} must fit in one neighbour block "
                         f"({nb} rows)")

    def f(x_block, edges, w):
        if halo > 0:
            # rank 0 gets rank d-1's rows (the ring's wrap), which a causal
            # banded graph never reads: no source lies below 0
            halo_rows = comm.ppermute(x_block[:, nb - halo:], group, 1)
            x_ext = torch.cat([halo_rows, x_block], dim=1)
        else:
            x_ext = x_block
        sink, src = edges[:, 0, :], edges[:, 1, :]
        src_l = src - (r * nb - halo)
        sl = sink - r * nb
        ok = (edge_mask(edges) & (src_l >= 0) & (src_l < nb + halo)
              & (sl >= 0) & (sl < nb))
        return _local_spmm(x_ext, sl, src_l, ok, w)[:, :nb]

    return f


def bucket_edges_by_sink(edges, weights, n_shards: int, num_nodes: int,
                         per_shard: int | None = None):
    """Reorder a padded edge list so each lane lands in the block of the
    shard that owns its sink row: width per_shard * n_shards, each block
    that shard's edges in their order, sentinel-padded. per_shard
    defaults to E (lossless); a smaller one drops the overflow."""
    B, _, E = edges.shape
    per = E if per_shard is None else per_shard
    block = num_nodes // n_shards
    valid = edge_mask(edges)
    shard_id = torch.where(
        valid, torch.clamp(torch.div(edges[:, 0, :], block,
                                     rounding_mode="floor"),
                           0, n_shards - 1), n_shards)
    out_e, out_w = [], []
    for s in range(n_shards):
        m = shard_id == s
        order = torch.argsort((~m).to(torch.int8), dim=-1,
                              stable=True)[:, :per]
        ok = torch.gather(m, 1, order)
        sink = torch.where(ok, torch.gather(edges[:, 0, :], 1, order), -1)
        src = torch.where(ok, torch.gather(edges[:, 1, :], 1, order), -1)
        out_e.append(torch.stack([sink, src], dim=1))
        out_w.append(torch.where(ok, torch.gather(weights, 1, order), 0.0))
    return (torch.cat(out_e, dim=-1).to(edges.dtype),
            torch.cat(out_w, dim=-1))


class PartitionedSparseGNN(nn.Module):
    """A SparseGNN stack (GraphConv('add') layers and activations) whose
    aggregations run on the collectives above; see the module docstring.
    Every rank calls it with the same (replicated) x [B, N, F], edges and
    weights and gets the same output; edges are bucketed once a call and
    shared by the layers."""

    def __init__(self, layers, mesh, axis: str = "dp",
                 num_nodes: int | None = None, mode: str = "auto",
                 halo: int | None = None, per_shard: int | None = None,
                 k_pair: int | None = None):
        super().__init__()
        for layer in layers:
            if isinstance(layer, nn.Module) and not (
                    isinstance(layer, GraphConv) and layer.aggr == "add"):
                raise ValueError("PartitionedSparseGNN supports "
                                 "GraphConv('add') layers")
        if mode not in ("auto", "halo", "bucketed", "psum"):
            raise ValueError(f"unknown mode {mode!r}")
        if mode == "auto":
            if halo is not None:
                mode = "halo"
            elif num_nodes is not None and num_nodes > 256:
                mode = "bucketed"
            else:
                mode = "psum"
        self.group, self.d, self.rank = _axis(mesh, axis)
        if mode != "psum":
            if num_nodes is None:
                raise ValueError(f"mode={mode!r} needs num_nodes")
            if num_nodes % self.d:
                raise ValueError(f"num_nodes={num_nodes} must divide over "
                                 f"{self.d} shards")
        if mode == "halo" and halo is None:
            raise ValueError("mode='halo' needs halo (the selector's source "
                             "window: max hop / window + t)")
        if mode == "bucketed" and k_pair is None:
            raise ValueError("mode='bucketed' needs k_pair")
        self.layers = list(layers)
        self.blocks = nn.ModuleList(
            [m for m in self.layers if isinstance(m, nn.Module)])
        self.mesh, self.axis, self.mode = mesh, axis, mode
        self.num_nodes, self.halo = num_nodes, halo
        self.per_shard, self.k_pair = per_shard, k_pair
        if mode == "halo":
            self._spmm = spmm_halo(mesh, num_nodes, halo, axis)
        elif mode == "bucketed":
            self._spmm = spmm_bucketed(mesh, num_nodes, axis)

    def _bucket(self, edges, weights):
        if self.mode == "halo":
            return bucket_edges_by_sink(edges, weights, self.d,
                                        self.num_nodes, self.per_shard)
        if self.mode == "bucketed":
            return bucket_edges_cross(edges, weights, self.d,
                                      self.num_nodes, self.k_pair)
        return edges, weights

    def forward(self, x, edges, weights=None):
        if weights is None:
            weights = edge_mask(edges).to(x.dtype)
        g, d, r = self.group, self.d, self.rank
        edges, weights = self._bucket(edges, comm.enter(weights, g))
        L = edges.shape[-1]
        if L % d:
            raise ValueError(f"{L} edge lanes do not split over {d} shards")
        lanes = slice(r * (L // d), (r + 1) * (L // d))
        e_r, w_r = edges[..., lanes], weights[..., lanes]
        for layer in self.layers:
            if not isinstance(layer, GraphConv):
                x = layer(x)
                continue
            xin = comm.enter(x, g)
            if self.mode == "psum":
                agg = comm.psum(_local_spmm(xin, e_r[:, 0], e_r[:, 1],
                                            edge_mask(e_r), w_r),
                                g, grad="identity")
            else:
                nb = self.num_nodes // d
                out = self._spmm(xin[:, r * nb:(r + 1) * nb], e_r, w_r)
                agg = comm.all_gather(out, g, 1, grad="slice")
            x = layer.lin_rel(agg) + layer.lin_root(x)
        return x
