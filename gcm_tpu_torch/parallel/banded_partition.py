"""Node-sharded scans of the fast cores (counterpart of
gcm_tpu/parallel/banded_partition.py): a graph memory larger than one
card, its slot axis N split over a mesh axis in blocks of nb = N / d, one
rank a block. Plain PyTorch, as the fast cores are.

- `banded_scan_sharded(model, mesh)`: BandedRingGCM (forward hops). Each
  hop's roll becomes one ppermute of the left neighbour's last h rows, so
  a step moves O(B * h * F) a hop a layer, whatever N and d.
- `banded_scored_scan_sharded(model, mesh)`: BandedScoredGCM. One
  ppermute of the left neighbour's last w raw rows scores the new node
  against the previous w slots (which may straddle the block boundary),
  and one of the last w preprocessed rows a layer aggregates the band.
- `clique_scan_sharded(model, mesh)`: CliqueGCM. Every sink's aggregate is
  the same masked sum, so a layer's one collective is a [B, F] psum of the
  blocks' partial sums.

Each returns scan(xs, state) -> (beliefs [B, T, F] replicated, this
rank's state); `shard_banded_state` / `shard_banded_scored_state` cut a
whole state to this rank's block (t replicated). The belief of a step is
the new row's, gathered on the rank that owns it and assembled by one
[B, F] psum a step. The ring's wrap is the ring of ranks: rank 0's left
neighbour is rank d - 1. Parameters and xs enter the shard-local work
through `comm.enter_many`, so a backward through the scan leaves every
rank the full gradients. aggr='add' only, as JAX's.
"""

from __future__ import annotations

import torch

from gcm_tpu_torch.models.banded_gcm import (BandedRingGCM,
                                             BandedScoredGCM,
                                             BandedScoredState, BandedState,
                                             _insert, distance_scores)
from gcm_tpu_torch.models.clique_gcm import CliqueGCM
from gcm_tpu_torch.nn.dense_conv import conv_project
from gcm_tpu_torch.parallel import comm
from gcm_tpu_torch.parallel.mesh import axis_group, axis_rank, axis_size
from gcm_tpu_torch.utils.functional import call_with


def _blocks(model, mesh, axis):
    if any(a != "add" for a in model._aggrs):
        raise ValueError("sharded scans implement aggr='add' only")
    d = axis_size(mesh, axis)
    N = model.graph_size
    if N % d:
        raise ValueError(f"graph_size={N} must divide over {d} shards")
    return axis_group(mesh, axis), N // d, axis_rank(mesh, axis)


def shard_banded_state(state: BandedState, mesh,
                       axis: str = "sp") -> BandedState:
    """This rank's block of a whole BandedState (slot dim split)."""
    d, r = axis_size(mesh, axis), axis_rank(mesh, axis)
    nb = state.nodes.shape[1] // d
    return BandedState(state.nodes[:, r * nb:(r + 1) * nb].contiguous(),
                       state.t.clone())


def shard_banded_scored_state(state: BandedScoredState, mesh,
                              axis: str = "sp") -> BandedScoredState:
    """This rank's block of a whole BandedScoredState (nodes and band)."""
    d, r = axis_size(mesh, axis), axis_rank(mesh, axis)
    nb = state.nodes.shape[1] // d
    sl = slice(r * nb, (r + 1) * nb)
    return BandedScoredState(state.nodes[:, sl].contiguous(),
                             state.band[:, sl].contiguous(), state.t.clone())


def _entered_scan(model, group, body, xs, state):
    """Run body(xs, state) under model's parameters entered (one
    all-reduce of their gradients in the backward)."""
    names = [n for n, _ in model.named_parameters()]
    vals = comm.enter_many([p for _, p in model.named_parameters()] + [xs],
                           group)
    return call_with(model, dict(zip(names, vals[:-1])), body, vals[-1],
                     state)


def _slot_ages(p, t, slots, N):
    age = torch.remainder(p[:, None] - slots[None, :], N)
    return age, torch.clamp(t, max=N - 1)[:, None]


def banded_scan_sharded(model: BandedRingGCM, mesh, axis: str = "sp"):
    if model.direction != "forward":
        raise ValueError("the sharded banded scan is forward-only (a "
                         "backward band needs a right-neighbour halo)")
    group, nb, i = _blocks(model, mesh, axis)
    if max(model.hops) > nb:
        raise ValueError("the halo (max hop) must fit in one block")
    N = model.graph_size

    def body(xs, state):
        nodes_blk, t = state
        B = nodes_blk.shape[0]
        b_idx = torch.arange(B, device=xs.device)
        slots = i * nb + torch.arange(nb, dtype=t.dtype, device=xs.device)
        outs = []
        for step in range(xs.shape[1]):
            p = torch.remainder(t, N)
            local_r = p - i * nb
            in_range = (local_r >= 0) & (local_r < nb)
            nodes_blk = _insert(nodes_blk, xs[:, step], local_r)
            h_feats = model._pre(nodes_blk)
            age, horizon = _slot_ages(p, t, slots, N)
            alive = age <= horizon
            t_insert = t[:, None] - age
            masks = [(alive & (torch.clamp(t_insert, max=N - 1) >= h)
                      & (age + h <= horizon)).to(h_feats.dtype)
                     for h in model.hops]
            for conv, act in zip(model._convs(), model._acts):
                agg = torch.zeros_like(h_feats)
                for h, m in zip(model.hops, masks):
                    # roll(h_feats, h)[s] = h_feats[s - h]: the first h
                    # rows come from the left neighbour's last h
                    halo = comm.ppermute(h_feats[:, nb - h:], group, 1)
                    ext = torch.cat([halo, h_feats], dim=1)
                    agg = agg + ext[:, :nb] * m[..., None]
                h_feats = conv_project(conv, agg, h_feats, act)
            safe = torch.clamp(local_r, 0, nb - 1).long()
            mine = h_feats[b_idx, safe] * in_range[:, None].to(h_feats.dtype)
            outs.append(comm.psum(mine, group, grad="identity"))
            t = t + 1
        return torch.stack(outs, dim=1), BandedState(nodes_blk, t)

    def scan(xs, state: BandedState):
        return _entered_scan(model, group, body, xs, state)

    return scan


def banded_scored_scan_sharded(model: BandedScoredGCM, mesh,
                               axis: str = "sp"):
    if not isinstance(model, BandedScoredGCM):
        raise ValueError("banded_scored_scan_sharded needs BandedScoredGCM")
    group, nb, i = _blocks(model, mesh, axis)
    N, w = model.graph_size, model.window_size
    if w > nb:
        raise ValueError("the window (halo) must fit in one block")

    def body(xs, state):
        nodes_blk, band_blk, t = state
        B = nodes_blk.shape[0]
        dev = xs.device
        b_idx = torch.arange(B, device=dev)
        slots = i * nb + torch.arange(nb, dtype=t.dtype, device=dev)
        ks = torch.arange(1, w + 1, dtype=t.dtype, device=dev)
        outs = []
        for step in range(xs.shape[1]):
            x = xs[:, step]
            p = torch.remainder(t, N)
            local_r = p - i * nb
            in_range = (local_r >= 0) & (local_r < nb)
            nodes_blk = _insert(nodes_blk, x, local_r)
            # score the new row against the previous w slots: ext[m] is
            # the raw node at slot (i * nb + m - w) mod N
            halo_raw = comm.ppermute(nodes_blk[:, nb - w:], group, 1)
            ext_raw = torch.cat([halo_raw, nodes_blk], dim=1)
            src_idx = torch.clamp(w + local_r[:, None] - ks[None, :], 0,
                                  nb + w - 1).long()
            wnodes = torch.gather(ext_raw, 1, src_idx[..., None].expand(
                -1, -1, ext_raw.shape[-1]))
            valid = ks[None, :] <= torch.clamp(t, max=N - 1)[:, None]
            dists = None
            if model.distance is not None:
                with torch.no_grad():
                    dists = distance_scores(model.distance, model._scale(x),
                                            model._scale(wnodes))
            band_blk = _insert(band_blk, model._band_values(dists, valid),
                               local_r)
            h_feats = model._pre(nodes_blk)
            age, horizon = _slot_ages(p, t, slots, N)
            sink_alive = age <= horizon
            for conv, act in zip(model._convs(), model._acts):
                halo_h = comm.ppermute(h_feats[:, nb - w:], group, 1)
                ext_h = torch.cat([halo_h, h_feats], dim=1)
                agg = torch.zeros_like(h_feats)
                for k in range(1, w + 1):
                    m = band_blk[:, :, k - 1] * (
                        sink_alive & (age + k <= horizon)).to(h_feats.dtype)
                    agg = agg + ext_h[:, w - k:w - k + nb] * m[..., None]
                h_feats = conv_project(conv, agg, h_feats, act)
            safe = torch.clamp(local_r, 0, nb - 1).long()
            mine = h_feats[b_idx, safe] * in_range[:, None].to(h_feats.dtype)
            outs.append(comm.psum(mine, group, grad="identity"))
            t = t + 1
        return (torch.stack(outs, dim=1),
                BandedScoredState(nodes_blk, band_blk, t))

    def scan(xs, state: BandedScoredState):
        return _entered_scan(model, group, body, xs, state)

    return scan


def clique_scan_sharded(model: CliqueGCM, mesh, axis: str = "sp"):
    if not isinstance(model, CliqueGCM):
        raise ValueError("clique_scan_sharded needs CliqueGCM")
    group, nb, i = _blocks(model, mesh, axis)
    N = model.graph_size

    def body(xs, state):
        nodes_blk, t = state
        B = nodes_blk.shape[0]
        b_idx = torch.arange(B, device=xs.device)
        slots = i * nb + torch.arange(nb, dtype=t.dtype, device=xs.device)
        outs = []
        for step in range(xs.shape[1]):
            p = torch.remainder(t, N)
            local_r = p - i * nb
            in_range = (local_r >= 0) & (local_r < nb)
            nodes_blk = _insert(nodes_blk, xs[:, step], local_r)
            h = model._pre(nodes_blk)
            age, horizon = _slot_ages(p, t, slots, N)
            alive = (age <= horizon).to(h.dtype)
            for conv, act in zip(model._convs(), model._acts):
                # the partial sums feed each rank's own rows: psum backward
                agg = comm.psum(torch.sum(h * alive[..., None], dim=1),
                                group, grad="psum")
                h = model._apply_layer(conv, act, h @ conv.lin_root.kernel,
                                       (agg @ conv.lin_rel.kernel)[:, None])
            safe = torch.clamp(local_r, 0, nb - 1).long()
            mine = h[b_idx, safe] * in_range[:, None].to(h.dtype)
            outs.append(comm.psum(mine, group, grad="identity"))
            t = t + 1
        return torch.stack(outs, dim=1), BandedState(nodes_blk, t)

    def scan(xs, state: BandedState):
        return _entered_scan(model, group, body, xs, state)

    return scan
