"""The ring core's scan-free trajectory forward (counterpart of
gcm_tpu/models/ring_window.py): `RingDenseGCM.window` for Distance,
LearnedEdge and forward TemporalBackedge rows over an unwindowed candidate
set, where the banded stencil does not apply.

With row-only selectors every memory cell a trajectory touches has a fixed
value and a known lifetime:

- the N initial slots hold nodes0[k] until step kill(k) = (k - t0) mod N
  overwrites them (never, if kill >= T),
- the T inserts hold x_j from step j on (T <= N a chunk, so none is evicted
  again inside the chunk),

so scoring and aggregation run over a fixed extended source space of
M = N + T candidates with per-step validity masks, not over a [B, N, N]
adjacency carried through a scan:

1. the selector rows of every step at once, R [B, T, M];
2. the first layer's features of every entity at every step by the
   kill-cumsum: agg1[i, e] = base[e] - sum_{l <= i} R_all[e, p_l] *
   v_old(p_l) (edges only disappear, by eviction, so time is a prefix sum,
   not a recurrence);
3. the second layer at the output nodes only (the belief is the row just
   inserted).

The beliefs are the scan's up to float-accumulation order; the final
state is exactly the scan's. Supported (`window_supported`): 1- or 2-conv
DenseGraphConv('add' | 'mean') stacks, an EdgeChain of forward unlearned
TemporalBackedge, non-bidirectional unwindowed Distance (learned scale
included) and deterministic LearnedEdge, and a preprocessor. Anything else,
and dones, take the scan. The distances are scored in plain PyTorch
(`distance_scores_per_step`), as the JAX window scores them in `dist_fn`.
Plain PyTorch on either device: the JAX window reaches no TPU kernel.
"""

from __future__ import annotations

import math

import torch

from gcm_tpu_torch.edges.chain import EdgeChain
from gcm_tpu_torch.edges.distance import Distance, EuclideanEdge
from gcm_tpu_torch.edges.learned import LearnedEdge
from gcm_tpu_torch.edges.temporal import TemporalBackedge
from gcm_tpu_torch.models.banded_gcm import (_gather_rows,
                                             distance_scores_per_step)
from gcm_tpu_torch.models.ring_gcm import RingGraphState
from gcm_tpu_torch.nn.dense_conv import conv_project, plan_conv_stack
from gcm_tpu_torch.utils.ste import spardmax, ste

# Chunk sizing: a chunk's [B, c, N + c, F] tensors may take this share of
# the card's memory, counting this many of them live at the peak of a
# forward and of a training step (the kill-cumsum's P and Kcum, agg1, the
# first layer's products and activation; in training autograd keeps agg1,
# the broadcast root input and H1 as well). On the CPU one tensor is capped
# at CPU_CHUNK_BYTES.
CHUNK_MEMORY_SHARE = 0.5
LIVE_TENSORS = {"forward": 6, "train": 12}
CPU_CHUNK_BYTES = 1 << 28


def _selector_ok(sel) -> bool:
    if isinstance(sel, EdgeChain):
        return all(_selector_ok(s) for s in sel.selectors)
    if isinstance(sel, TemporalBackedge):
        return not sel.learned and sel.direction == "forward"
    if isinstance(sel, Distance):
        return not sel.bidirectional and sel.window is None
    if isinstance(sel, LearnedEdge):
        return bool(sel.deterministic)
    return False


def window_supported(model) -> bool:
    """Can ring_window run this model? (a check of its structure)"""
    if (model.aux_edge_selectors is not None or model.pooled
            or model.positional_encoder is not None or model.edge_weights):
        return False
    layers = getattr(model.gnn, "layers", None)
    if layers is None:
        return False
    plan = plan_conv_stack(layers, allowed_aggrs=("add", "mean"))
    if plan is None or len(plan[0]) > 2:
        return False
    return model.edge_selectors is None or _selector_ok(model.edge_selectors)


def _selector_rows(sel, row, xs, cand, valid_ext, p, pastcap, N):
    """Every step's selector row at once, [B, T, M] over the extended
    source space: the rows RingDenseGCM._selector_row_col writes step by
    step (row-only selectors write no column)."""
    T = xs.shape[1]
    M = N + T
    if isinstance(sel, EdgeChain):
        for s in sel.selectors:
            row = _selector_rows(s, row, xs, cand, valid_ext, p, pastcap, N)
        return row
    if isinstance(sel, TemporalBackedge):
        iarr = torch.arange(T, dtype=p.dtype, device=p.device)[None, :]
        m_iota = torch.arange(M, dtype=p.dtype, device=p.device)
        for hop in sel.hops:
            ok = pastcap >= hop
            # the source at age `hop` from step i: insert i - hop inside
            # the window, else the old slot (p_i - hop) mod N
            idx_ext = torch.where(iarr >= hop, N + (iarr - hop),
                                  torch.remainder(p - hop, N))
            hit = (m_iota == idx_ext[..., None]) & ok[..., None]
            row = torch.where(hit, 1.0, row)
        return row
    if isinstance(sel, Distance):
        curr, srcs = xs, cand
        if sel.learned:
            curr, srcs = curr / sel.dist_param, srcs / sel.dist_param
        # the candidates' values never change, only their validity, so each
        # step scores against the same [B, M, F] (EuclideanEdge's batch
        # mean per step, as JAX's vmap over time)
        with torch.no_grad():
            dists = distance_scores_per_step(sel, curr, srcs)
        return torch.where((dists < sel.max_distance) & valid_ext, 1.0, row)
    if isinstance(sel, LearnedEdge):
        B, F = xs.shape[0], xs.shape[-1]
        net_in = torch.cat(
            [xs[:, :, None, :].expand(B, T, M, F),
             cand[:, None].expand(B, T, M, cand.shape[-1])], dim=-1)
        logits = sel.edge_network(net_in)[..., 0]
        edges = spardmax(torch.where(valid_ext, logits, -1e10), axis=-1)
        return torch.where(valid_ext, ste(edges + row), row)
    raise NotImplementedError(
        f"ring window: unsupported selector {type(sel).__name__}")


def _chunk_rows(model, xs, state: RingGraphState, rows=None):
    """(cursor p [B, T], the selector rows [B, T, N + T], or `rows` where
    given, the candidates [B, N + T, F]) of one chunk of T <= N steps, the
    rows in the nodes' dtype (a bfloat16 adjacency holds 0 or 1 exactly,
    and the products run in the nodes' dtype)."""
    nodes0, _, _, t0 = state
    B, T, _ = xs.shape
    N = model.graph_size
    dt, dev = nodes0.dtype, xs.device
    iarr = torch.arange(T, dtype=t0.dtype, device=dev)
    p = torch.remainder(t0[:, None] + iarr[None, :], N)  # [B, T] cursor
    pastcap = torch.clamp(t0[:, None] + iarr[None, :], max=N - 1)
    age_old = torch.remainder(p[..., None] - torch.arange(
        N, dtype=t0.dtype, device=dev), N)  # [B, T, N]
    valid_ext = torch.cat([  # [B, T, N + T]
        (age_old > iarr[None, :, None]) & (age_old <= pastcap[..., None]),
        (iarr[None, :] < iarr[:, None])[None].expand(B, T, T)], dim=2)
    cand = torch.cat([nodes0, xs.to(dt)], dim=1)
    row = torch.zeros((B, T, N + T), dtype=dt, device=dev)
    if rows is not None:
        row = rows.to(dt)
    elif model.edge_selectors is not None:
        row = _selector_rows(model.edge_selectors, row, xs.to(dt), cand,
                             valid_ext, p, pastcap, N)
    return p, row, cand


def _window_rows(model, xs, state: RingGraphState):
    """The selector rows [B, T, N + T] of one chunk (T <= N) over its
    extended source space: N old slots, then the T inserts (what a check
    hands `_window_chunk` as `rows` to hold two devices or paths to one
    edge set)."""
    if xs.shape[1] > model.graph_size:
        raise ValueError(f"one chunk holds at most N = {model.graph_size} "
                         f"steps, not {xs.shape[1]}")
    return _chunk_rows(model, xs, state)[1]


def _window_chunk(model, xs, state: RingGraphState, rows=None):
    """One chunk of T <= N steps -> (beliefs [B, T, F_out], state); `rows`
    [B, T, N + T] replaces the selectors' rows where given."""
    nodes0, adj0, weights, t0 = state
    B, T, _ = xs.shape
    N = model.graph_size
    M = N + T
    conv_idx, acts, aggrs = plan_conv_stack(model.gnn.layers,
                                            allowed_aggrs=("add", "mean"))
    convs = [model.gnn.layers[ci] for ci in conv_idx]
    dt, dev = nodes0.dtype, xs.device
    iarr = torch.arange(T, dtype=t0.dtype, device=dev)
    # the step at which old slot k is overwritten (>= T: it survives)
    kill = torch.remainder(torch.arange(N, dtype=t0.dtype, device=dev)
                           - t0[:, None], N)  # [B, N]
    p, row, cand = _chunk_rows(model, xs, state, rows)
    adj0f = adj0.to(dt)

    dirty = cand if model.preprocessor is None else model.preprocessor(cand)
    if len(convs) == 2:
        # -- layer 1 at every (step, entity): the kill-cumsum -------------
        # rows of all entities: the old slots' rows are adj0 (zero on the
        # new sources: row-only selectors never write to them), the
        # inserts' rows are `row`
        R_all = torch.cat([torch.nn.functional.pad(adj0f, (0, T)), row],
                          dim=1)  # [B, M, M]
        base = torch.bmm(R_all, dirty)  # [B, M, Fh]
        # step l kills old slot p_l: every row loses its entry (e, p_l) with
        # the old value dirty[:, p_l] from step l on (inclusive: the
        # eviction precedes the GNN inside a step)
        G = torch.gather(R_all, 2, p[:, None, :].long().expand(B, M, T))
        v_kill = _gather_rows(dirty[:, :N], p)  # [B, T, Fh]
        Gt = G.transpose(1, 2)[..., None]  # [B, T, M, 1]
        # torch.cumsum is one pass over the tensor: the JAX package's
        # blocked cumsum (RING_WINDOW_CUMSUM_BLOCK) answers XLA's
        # log-doubling lowering and has no use here
        Kcum = torch.cumsum(Gt * v_kill[:, :, None, :], dim=1)
        agg1 = base[:, None] - Kcum  # [B, T, M, Fh]
        h_in = dirty[:, None].expand_as(agg1)
        if aggrs[0] == "mean":
            deg1 = R_all.sum(dim=2)[:, None] - torch.cumsum(Gt[..., 0], 1)
            agg1 = agg1 / torch.clamp(deg1, min=1.0)[..., None]
        H1 = conv_project(convs[0], agg1, h_in, acts[0])
        # -- layer 2 at the output nodes only ------------------------------
        agg2 = torch.einsum("btm,btmf->btf", row, H1)
        if aggrs[1] == "mean":
            agg2 = agg2 / torch.clamp(row.sum(dim=2), min=1.0)[..., None]
        root2 = H1[:, iarr.long(), N + iarr.long()]  # [B, T, F1]
        outs = conv_project(convs[1], agg2, root2, acts[1])
    else:
        agg = torch.bmm(row, dirty)
        if aggrs[0] == "mean":
            agg = agg / torch.clamp(row.sum(dim=2), min=1.0)[..., None]
        outs = conv_project(convs[0], agg, dirty[:, N:], acts[0])

    # -- the final state, exactly the scan's -------------------------------
    killc = torch.clamp(kill, 0, T - 1)
    written = kill < T  # [B, N]
    nodes_F = torch.where(written[..., None],
                          _gather_rows(xs.to(dt), killc), nodes0)
    colmask = (~written).to(dt)  # [B, N]
    # the row written at step l as it survives to the chunk's end: an old
    # source's entry lives iff its column is never overwritten; a new
    # source's (column k holds insert kill(k)) is never evicted in-chunk
    newpart = torch.where(
        written[:, None, :],
        torch.gather(row[:, :, N:], 2,
                     killc[:, None, :].long().expand(B, T, N)), 0.0)
    F_rows = row[:, :, :N] * colmask[:, None, :] + newpart  # [B, T, N]
    written_rows = _gather_rows(F_rows, killc)  # [B, N, N]
    adj_F = torch.where(written[..., None], written_rows,
                        adj0f * colmask[:, None, :])
    return outs, RingGraphState(nodes_F, adj_F.to(adj0.dtype), weights,
                                t0 + T)


def _has(sel, cls) -> bool:
    if isinstance(sel, EdgeChain):
        return any(_has(s, cls) for s in sel.selectors)
    return isinstance(sel, cls)


def max_chunk_len(model, B: int, obs_dim: int, mode: str = "forward",
                  device=None) -> int:
    """The largest chunk length c whose [B, c, N + c, F_wide] tensors, with
    LIVE_TENSORS[mode] of them live, fit in CHUNK_MEMORY_SHARE of the
    card's memory (CPU_CHUNK_BYTES a tensor on the CPU). F_wide is the
    first layer's width, widened to the learned selector's pair input
    (2 * obs) and to EuclideanEdge's [c, B, B, N + c] scores (B). Exactness
    does not depend on c: any c <= N threads the state alike."""
    N = model.graph_size
    plan = plan_conv_stack(model.gnn.layers, allowed_aggrs=("add", "mean"))
    fwide = model.gnn.layers[plan[0][0]].in_dim if plan else obs_dim
    sel = model.edge_selectors
    if sel is not None and _has(sel, LearnedEdge):
        fwide = max(fwide, 2 * obs_dim)
    if sel is not None and _has(sel, EuclideanEdge):
        fwide = max(fwide, B)
    device = torch.device(device if device is not None else model.device)
    if device.type == "cuda":
        total = torch.cuda.get_device_properties(device).total_memory
        tensor_bytes = total * CHUNK_MEMORY_SHARE / LIVE_TENSORS[mode]
    else:
        tensor_bytes = CPU_CHUNK_BYTES
    K = tensor_bytes / (B * fwide * 4)
    c = int((math.sqrt(N * N + 4 * K) - N) / 2)  # c * (N + c) <= K
    if c >= 16:
        c -= c % 8
    return max(1, min(N, c))


def ring_window(model, xs, state: RingGraphState, chunk: int | None = None):
    """The whole-trajectory forward without the scan, in chunks of length
    <= min(N, max_chunk_len): a slot is overwritten at most once a chunk,
    which makes the kill-cumsum exact. The chunk is sized for a training
    step when autograd records (grad mode on and a parameter requires
    grad). chunk= overrides the choice."""
    if not window_supported(model):
        raise ValueError("ring window(): unsupported model structure, use "
                         "scan (see ring_window.window_supported)")
    B, T, F = xs.shape
    N = model.graph_size
    if chunk is None:
        train = torch.is_grad_enabled() and any(
            q.requires_grad for q in model.parameters())
        chunk = max_chunk_len(model, B, F, "train" if train else "forward",
                              device=xs.device)
    chunk = max(1, min(chunk, N))
    outs = []
    for s in range(0, T, chunk):
        o, state = _window_chunk(model, xs[:, s:s + chunk], state)
        outs.append(o)
    return (outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)), state
