"""The README graph memories (proroklab/graph-conv-memory, README.md,
DenseGCM example; src/gcm/ray_sparse_gcm.py) in plain PyTorch, float32.

Each step inserts the observation as the newest node of a graph of at most
`graph_size` nodes, links it to the node `hop` steps back for each hop, runs
a Linear preprocessor over every node and then a stack of graph convolutions
out_i = tanh(W_rel·sum_{j -> i} h_j + b_rel + W_root·h_i); the belief is the
newest node's output.

- Dense: nodes [B,N,obs], adj [B,N,N] (adj[b, sink, source]), num [B]. A
  full graph first drops its oldest node (shifting nodes and adjacency up
  by one) before the insert.
- Sparse: nodes [B,N,obs], an edge list [B,2,E] (sink, source; -1 in free
  lanes) appended at each graph's cursor, weights [B,E] of 1.0, t [B] and
  num_edges [B]; it never wraps, and an edge past E is dropped.

`precision="tf32"` rounds both operands of every product to TF32 (10
mantissa bits, to nearest), and in the backward the incoming gradient too,
and multiplies them in float32: the same reference one precision lower,
which the benchmark's control uses. The caller keeps PyTorch's own TF32
switches off.
"""

from __future__ import annotations

import torch

PRECISIONS = ("fp32", "tf32")


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (its low 13 mantissa bits cleared, to the
    nearest, ties to even)."""
    i = x.contiguous().view(torch.int32).to(torch.int64)
    i = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF & 0xFFFFFFFF
    i = torch.where(i >= 2 ** 31, i - 2 ** 32, i)
    return i.to(torch.int32).view(torch.float32).view(x.shape)


class _Tf32MatMul(torch.autograd.Function):
    """a @ b with both operands rounded to TF32, and in the backward the
    incoming gradient too, each product summed in float32. b is 2-D (a
    projection) or batched like a."""

    @staticmethod
    def forward(ctx, a, b):
        a, b = tf32_round(a), tf32_round(b)
        ctx.save_for_backward(a, b)
        return torch.matmul(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = tf32_round(g)
        ga = torch.matmul(g, b.transpose(-1, -2))
        if b.dim() == 2:
            gb = a.reshape(-1, a.shape[-1]).T @ g.reshape(-1, g.shape[-1])
        else:
            gb = torch.matmul(a.transpose(-1, -2), g)
        return ga, gb


def matmul(a, b, precision="fp32"):
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}")
    return _Tf32MatMul.apply(a, b) if precision == "tf32" else a @ b


def linear(x, w, b, precision="fp32"):
    y = matmul(x, w, precision)
    return y if b is None else y + b


def conv_stack(h, aggregate, weights, layers: int, precision="fp32"):
    """`layers` graph convolutions, each followed by tanh; aggregate(h)
    sums each node's in-neighbours."""
    for layer in range(layers):
        agg = aggregate(h)
        h = torch.tanh(linear(agg, weights[f"conv{layer}.rel.w"],
                              weights[f"conv{layer}.rel.b"], precision)
                       + matmul(h, weights[f"conv{layer}.root.w"], precision))
    return h


# -- dense ------------------------------------------------------------------

def dense_state(B, N, obs, device):
    return (torch.zeros((B, N, obs), device=device),
            torch.zeros((B, N, N), device=device),
            torch.zeros((B,), dtype=torch.long, device=device))


def dense_step(state, x, weights, hops, layers, precision="fp32"):
    """One step of B graphs: x [B, obs] -> (belief [B, F], new state)."""
    nodes, adj, num = state
    B, N, _ = nodes.shape
    rows = torch.arange(B, device=x.device)
    full = (num >= N)[:, None, None]
    nodes = torch.where(full, torch.cat(
        [nodes[:, 1:], torch.zeros_like(nodes[:, :1])], dim=1), nodes)
    shifted = torch.zeros_like(adj)
    shifted[:, :-1, :-1] = adj[:, 1:, 1:]
    adj = torch.where(full, shifted, adj)
    num = num - full[:, 0, 0].long()
    nodes = nodes.clone()
    nodes[rows, num] = x
    adj = adj.clone()
    for hop in hops:
        src = torch.clamp(num - hop, min=0)
        adj[rows, num, src] = torch.where(num >= hop, 1.0,
                                          adj[rows, num, src])
    h = linear(nodes, weights["pre.w"], weights["pre.b"], precision)
    h = conv_stack(h, lambda v: matmul(adj, v, precision), weights, layers,
                   precision)
    return h[rows, num], (nodes, adj, num + 1)


def dense_reset(state, done):
    d = done.to(torch.bool)
    nodes, adj, num = state
    return (torch.where(d[:, None, None], 0.0, nodes),
            torch.where(d[:, None, None], 0.0, adj),
            torch.where(d, 0, num))


def dense_trajectory(xs, weights, graph_size, hops, layers, precision="fp32"):
    """Beliefs [B,T,F] of B fresh graphs stepped over xs [B,T,obs]."""
    B, T, obs = xs.shape
    state = dense_state(B, graph_size, obs, xs.device)
    outs = []
    for t in range(T):
        out, state = dense_step(state, xs[:, t], weights, hops, layers,
                                precision)
        outs.append(out)
    return torch.stack(outs, dim=1)


# -- sparse -----------------------------------------------------------------

def sparse_state(B, N, obs, max_edges, device):
    return (torch.zeros((B, N, obs), device=device),
            torch.full((B, 2, max_edges), -1, dtype=torch.int32,
                       device=device),
            torch.ones((B, max_edges), device=device),
            torch.zeros((B,), dtype=torch.int32, device=device),
            torch.zeros((B,), dtype=torch.int32, device=device))


def edge_aggregate(h, edges, weights):
    """out[b, sink] = sum over valid lanes of w·h[b, source]."""
    B, N, F = h.shape
    sink, src = edges[:, 0].long(), edges[:, 1].long()
    ok = (sink >= 0) & (sink < N) & (src >= 0) & (src < N)
    base = torch.arange(B, device=h.device)[:, None] * N
    flat = h.reshape(B * N, F)
    msgs = flat[(base + torch.where(ok, src, 0)).reshape(-1)]
    msgs = msgs * torch.where(ok, weights, 0.0).reshape(-1, 1)
    out = torch.zeros_like(flat)
    out.index_add_(0, (base + torch.where(ok, sink, 0)).reshape(-1), msgs)
    return out.reshape(B, N, F)


def sparse_tick(state, x, weights, hops, layers, precision="fp32"):
    """One step of B graphs (a window of one): x [B, obs] -> (belief [B,F],
    new state). The new node's edges go in with the largest hop first; past
    graph_size the node is dropped (its belief is zero) and its edges are
    still listed, as the core lists them."""
    nodes, edges, ew, t, num_edges = state
    B, N, _ = nodes.shape
    E = edges.shape[-1]
    rows = torch.arange(B, device=x.device)
    nodes = nodes.clone()
    room = t < N
    slot = torch.clamp(t, max=N - 1).long()
    nodes[rows, slot] = torch.where(room[:, None], x, nodes[rows, slot])
    edges = edges.clone()
    for hop in sorted(hops, reverse=True):
        ok = (t >= hop) & (t > 0) & (num_edges < E)
        lane = torch.clamp(num_edges, max=E - 1).long()
        for k, value in ((0, t), (1, t - hop)):
            edges[rows, k, lane] = torch.where(ok, value.to(torch.int32),
                                               edges[rows, k, lane])
        num_edges = num_edges + ok.to(torch.int32)
    h = linear(nodes, weights["pre.w"], weights["pre.b"], precision)
    h = conv_stack(h, lambda v: edge_aggregate(v, edges, ew), weights,
                   layers, precision)
    out = torch.where(room[:, None], h[rows, slot], 0.0)
    return out, (nodes, edges, ew, t + 1, num_edges)


def sparse_reset(state, done):
    d = done.to(torch.bool)
    nodes, edges, ew, t, num_edges = state
    return (torch.where(d[:, None, None], 0.0, nodes),
            torch.where(d[:, None, None], -1, edges),
            torch.where(d[:, None], 1.0, ew),
            torch.where(d, 0, t), torch.where(d, 0, num_edges))


def sparse_window(xs, taus, weights, graph_size, hops, layers,
                  precision="fp32"):
    """Beliefs [B,T,F] of B fresh graphs given the window xs [B,T,obs] of
    taus[b] valid steps each, in one pass (zero past taus[b])."""
    B, T, obs = xs.shape
    N = graph_size
    dev = xs.device
    steps = torch.arange(T, device=dev)
    valid = steps[None, :] < taus[:, None]
    nodes = torch.zeros((B, N, obs), device=dev)
    keep = min(T, N)
    nodes[:, :keep] = torch.where(valid[:, :keep, None], xs[:, :keep], 0.0)
    sinks, srcs = [], []
    for hop in sorted(hops, reverse=True):
        ok = valid & (steps[None, :] >= hop) & (steps[None, :] < N)
        sinks.append(torch.where(ok, steps[None, :], -1))
        srcs.append(torch.where(ok, steps[None, :] - hop, -1))
    edges = torch.stack([torch.stack(sinks, -1).reshape(B, -1),
                         torch.stack(srcs, -1).reshape(B, -1)], dim=1)
    ew = torch.ones(edges.shape[0], edges.shape[-1], device=dev)
    h = linear(nodes, weights["pre.w"], weights["pre.b"], precision)
    h = conv_stack(h, lambda v: edge_aggregate(v, edges, ew), weights,
                   layers, precision)
    out = torch.zeros((B, T, h.shape[-1]), device=dev)
    out[:, :keep] = torch.where(valid[:, :keep, None], h[:, :keep], 0.0)
    return out
