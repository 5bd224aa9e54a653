"""The reversible backward of the fused ring scan (counterpart of
gcm_tpu/models/ring_reversible.py).

A training scan keeps the [B, N, N] adjacency of every step for its
backward. The fused ring step (RingDenseGCM._call_fused) needs none of
them, because its state update is a pure element replacement:

    nodes' = nodes with row p           <- x
    adj'   = adj   with row p <- row, column p <- col   ((p, p) from row)

Knowing what it evicted, nodes[p] [B, F] and adj[p, :], adj[:, p] [B, N]
each, the pre-step state is the post-step state with those written back,
exactly (no arithmetic; row p wins at (p, p), as in the rewrite). So
`reversible_scan` is a torch.autograd.Function: its forward runs the fused
step T times without a graph and keeps only the evicted rows, and its
backward walks t = T-1 .. 0, restores each pre-step state, re-runs the step
on leaf copies of its inputs under autograd (every selector's own backward,
the dense stack's through `fused_dense_gnn_bwd`) and accumulates the
parameter gradients. The saved state per step is O(B (2N + F)) where the
scan's is O(B N^2).

The parameters enter the Function as explicit inputs, so that it returns
their gradients. Where the forward ran with tensors in place of the
module's own Parameters (a tensor-parallel wrapper's gathered whole
kernels, torch.func.functional_call), the backward replays each step with
those same tensors swapped in (utils/functional.py::call_with), so that
the gradients are theirs and computed with the forward's values.
Stochastic selectors take the port's explicit noise: all
T steps' noise is drawn before the forward (or given by the caller) and
the backward replays noise[t] at step t, the port's form of JAX's bitwise
key replay. The forward is the fused scan's, bitwise; the gradients equal
the scan's up to float reassociation.

Scope (`reversible_refusal`): a RingDenseGCM, no dones (a reset destroys
what the restore needs), no edge weights (their [B, N, N] buffer would need
its own evicted rows). `_Reversible` is shared with the dense core
(models/dense_reversible.py), which supplies its own residuals and restore.
"""

from __future__ import annotations

import torch
from torch import nn

from gcm_tpu_torch.utils.functional import call_with


def reversible_refusal(model, dones=None) -> str | None:
    """Why the ring core's reversible scan cannot run this call, or None."""
    from gcm_tpu_torch.models.ring_gcm import RingDenseGCM

    if not isinstance(model, RingDenseGCM):
        return f"the ring reversible scan takes a RingDenseGCM, not " \
               f"{type(model).__name__}"
    if dones is not None:
        return "remat='reverse' needs dones=None: an episode reset " \
               "destroys the state the reverse pass restores"
    if model.edge_weights:
        return "remat='reverse' needs edge_weights off: the weights buffer " \
               "would need its own evicted rows"
    return None


def reversible_supported(model, dones=None) -> bool:
    """A RingDenseGCM, no dones and no edge_weights."""
    return reversible_refusal(model, dones) is None


class _Reversible(torch.autograd.Function):
    """forward(spec, noises, count0, xs, nodes0, adj0, *params) ->
    (outs [B, T, F'], nodes_T, adj_T). `spec` gives the core's step
    (x, nodes, adj, count, noise) -> (out, nodes', adj', count'), the
    residuals it destroys, residuals(nodes, adj, count) -> tuple, and the
    inverse, restore(nodes', adj', count', residuals) -> (nodes, adj,
    count)."""

    @staticmethod
    def forward(ctx, spec, noises, count0, xs, nodes0, adj0, *params):
        nodes, adj, count = nodes0, adj0, count0
        outs, res = [], []
        for s in range(xs.shape[1]):
            res.append(spec.residuals(nodes, adj, count))
            out, nodes, adj, count = spec.step(xs[:, s], nodes, adj, count,
                                               noises[s])
            outs.append(out)
        res = [torch.stack(r) for r in zip(*res)]
        ctx.spec, ctx.noises, ctx.n_res = spec, noises, len(res)
        ctx.save_for_backward(xs, nodes, adj, count, *res, *params)
        return torch.stack(outs, dim=1), nodes, adj

    @staticmethod
    def backward(ctx, g_outs, g_nodes, g_adj):
        xs, nodes, adj, count, *rest = ctx.saved_tensors
        res, params = rest[:ctx.n_res], rest[ctx.n_res:]
        spec = ctx.spec
        g_params = [torch.zeros_like(p) for p in params]
        g_xs = [None] * xs.shape[1]
        for s in reversed(range(xs.shape[1])):
            nodes, adj, count = spec.restore(nodes, adj, count,
                                             [r[s] for r in res])
            leaves = [t.detach().requires_grad_() for t in
                      (xs[:, s], nodes, adj)]
            with torch.enable_grad():
                if spec.swapped:
                    out, nodes2, adj2, _ = call_with(
                        spec.model, dict(zip(spec.names, params)),
                        spec.step, *leaves, count, ctx.noises[s])
                else:
                    out, nodes2, adj2, _ = spec.step(*leaves, count,
                                                     ctx.noises[s])
                grads = torch.autograd.grad(
                    (out, nodes2, adj2), (*leaves, *params),
                    (g_outs[:, s], g_nodes, g_adj), allow_unused=True)
            gx, g_nodes, g_adj = (torch.zeros_like(t) if g is None else g
                                  for g, t in zip(grads[:3], leaves))
            g_xs[s] = gx
            for acc, g in zip(g_params, grads[3:]):
                if g is not None:
                    acc += g
        return (None, None, None, torch.stack(g_xs, dim=1), g_nodes, g_adj,
                *g_params)


def run_reversible(model, spec, xs, nodes0, adj0, count0, noise, generator):
    """Draw (or take) the T steps' noise, then run `_Reversible` with the
    model's trainable parameters as explicit inputs."""
    B, T = xs.shape[0], xs.shape[1]
    noises = [model.step_noise(B, generator) if noise is None else noise[t]
              for t in range(T)]
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    spec.names = [n for n, _ in named]
    params = [p for _, p in named]
    # a tensor that is not an nn.Parameter stands in for the module's own
    # (functional_call): the replay must swap it back in
    spec.swapped = not all(isinstance(p, nn.Parameter) for p in params)
    return _Reversible.apply(spec, noises, count0, xs, nodes0, adj0, *params)


class _RingSpec:
    """The fused ring step, its evicted rows and their restore."""

    def __init__(self, model):
        self.model = model
        self.N = model.graph_size

    def step(self, x, nodes, adj, t, noise):
        from gcm_tpu_torch.models.ring_gcm import RingGraphState

        none = nodes.new_zeros((0,))
        out, st = self.model._call_fused(
            x, RingGraphState(nodes, adj, none, t), noise)
        return out, st.nodes, st.adj, st.t

    def residuals(self, nodes, adj, t):
        b = torch.arange(nodes.shape[0], device=nodes.device)
        p = torch.remainder(t, self.N).long()
        return nodes[b, p], adj[b, p, :], adj[b, :, p]

    def restore(self, nodes, adj, t, res):
        ev_node, ev_row, ev_col = res
        t = t - 1
        i_eq_p = torch.arange(self.N, device=nodes.device)[None, :] \
            == torch.remainder(t, self.N)[:, None]
        nodes = torch.where(i_eq_p[..., None], ev_node[:, None, :], nodes)
        # the same (p, p) precedence as the forward rewrite: row p wins
        adj = torch.where(i_eq_p[:, :, None], ev_row[:, None, :],
                          torch.where(i_eq_p[:, None, :], ev_col[:, :, None],
                                      adj))
        return nodes, adj, t


def reversible_scan(model, xs, state, noise=None, generator=None):
    """The fused ring scan over xs [B, T, obs] with the reversible
    backward: (outs [B, T, F'], final RingGraphState). Stochastic selectors
    take noise[t] at step t, or noise drawn from `generator` before the
    forward; the backward replays the same noise."""
    from gcm_tpu_torch.models.ring_gcm import RingGraphState

    reason = reversible_refusal(model)
    if reason is not None:
        raise ValueError(reason)
    nodes0, adj0, weights0, t0 = state
    if weights0.numel():
        raise ValueError("remat='reverse' needs an empty weights buffer")
    outs, nodes, adj = run_reversible(model, _RingSpec(model), xs, nodes0,
                                      adj0, t0, noise, generator)
    return outs, RingGraphState(nodes, adj, weights0, t0 + xs.shape[1])
