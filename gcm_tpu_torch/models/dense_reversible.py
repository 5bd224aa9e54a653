"""The reversible backward of the fused dense scan (counterpart of
gcm_tpu/models/dense_reversible.py), the dense-core mirror of
models/ring_reversible.py, which gives the rationale and runs both through
its `_Reversible` Function.

The fused dense step (DenseGCM._call_fused) shifts, then rewrites:

    over   = num_nodes + 1 > N;  num2 = num_nodes - over
    nodes' = (shift-up-if-over nodes) with row num2          <- x
    adj'   = (shift-up-left-if-over adj) with row / col num2  <- selector
             values where written, else the post-shift base

Both phases are inverted from what they destroy:

    rewrite:  row / column num2 of the post-shift base, base_row / base_col
              [B, N] (zero for an over batch, whose num2 = N - 1 lands on
              the shift's zero pad), and node row num2, node_ev [B, F];
    shift:    row 0 / column 0 of the pre-step state, node_row0 [B, F] and
              adj_row0 / adj_col0 [B, N], and the `over` bit; the shifted-
              out tail (index N - 1) was filled with zeros by the forward,
              so padding it back with zeros is lossless.

The saved state per step is O(B (4N + 2F)) where the scan's is O(B N^2).
Scope (`dense_reversible_refusal`): a DenseGCM whose selectors all have a
fused form (dense_fused_supported), no dones, no edge weights.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from gcm_tpu_torch.models.ring_reversible import run_reversible


def dense_reversible_refusal(model, dones=None) -> str | None:
    """Why the dense core's reversible scan cannot run this call, or
    None."""
    from gcm_tpu_torch.models.dense_gcm import DenseGCM, dense_fused_supported

    if not isinstance(model, DenseGCM):
        return f"the dense reversible scan takes a DenseGCM, not " \
               f"{type(model).__name__}"
    if dones is not None:
        return "remat='reverse' needs dones=None: an episode reset " \
               "destroys the state the reverse pass restores"
    if model.edge_weights:
        return "remat='reverse' needs edge_weights off: the weights buffer " \
               "would need its own residuals"
    if not dense_fused_supported(model):
        return "remat='reverse' needs selectors with a fused step " \
               "(dense_fused_supported)"
    return None


def dense_reversible_supported(model, dones=None) -> bool:
    """A DenseGCM with fused-step selectors, no dones and no
    edge_weights."""
    return dense_reversible_refusal(model, dones) is None


class _DenseSpec:
    """The fused dense step, what its shift and rewrite destroy, and their
    inverse (JAX's `residuals` and `run_bwd`)."""

    def __init__(self, model):
        self.model = model
        self.N = model.graph_size

    def step(self, x, nodes, adj, num, noise):
        from gcm_tpu_torch.core.graph_state import DenseGraphState

        none = nodes.new_zeros((0,))
        out, st = self.model._call_fused(
            x, DenseGraphState(nodes, adj, none, num), noise=noise)
        return out, st.nodes, st.adj, st.num_nodes

    def residuals(self, nodes, adj, num):
        b = torch.arange(nodes.shape[0], device=nodes.device)
        over = num + 1 > self.N
        safe = torch.clamp(torch.where(over, num - 1, num), 0,
                           self.N - 1).long()
        ovf = over[:, None]
        # row / column 0 copied: a view would keep the step's whole
        # [B, N, N] adjacency alive until the forward ends
        return (over, nodes[:, 0, :].clone(),
                torch.where(ovf, 0.0, nodes[b, safe, :]),
                adj[:, 0, :].clone(), adj[:, :, 0].clone(),
                torch.where(ovf, 0.0, adj[b, safe, :]),
                torch.where(ovf, 0.0, adj[b, :, safe]))

    def restore(self, nodes, adj, num, res):
        over, node_row0, node_ev, adj_row0, adj_col0, base_row, base_col = res
        iota = torch.arange(self.N, device=nodes.device)
        num2 = num - 1
        num_pre = num2 + over.to(num2.dtype)
        i_eq = iota[None, :] == num2[:, None]
        ovm = over[:, None, None]
        # un-rewrite: row / column num2 back to the post-shift base
        nodes_sh = torch.where(i_eq[..., None], node_ev[:, None, :], nodes)
        adj_sh = torch.where(i_eq[:, :, None], base_row[:, None, :],
                             torch.where(i_eq[:, None, :],
                                         base_col[:, :, None], adj))
        # un-shift (over batches): rows and columns down-right by one, row
        # and column 0 from the saved pre-step contents
        nodes_dn = torch.cat([node_row0[:, None, :], nodes_sh[:, :-1]], dim=1)
        nodes = torch.where(ovm, nodes_dn, nodes_sh)
        adj_dn = F.pad(adj_sh[:, :-1, :-1], (1, 0, 1, 0))
        row0 = iota[None, :, None] == 0
        col0 = iota[None, None, :] == 0
        adj_dn = torch.where(row0, adj_row0[:, None, :], adj_dn)
        adj_dn = torch.where(col0, torch.where(row0, adj_row0[:, 0, None,
                                                              None],
                                               adj_col0[:, :, None]), adj_dn)
        adj = torch.where(ovm, adj_dn, adj_sh)
        return nodes, adj, num_pre


def dense_reversible_scan(model, xs, state, noise=None, generator=None):
    """The fused dense scan over xs [B, T, obs] with the reversible
    backward: (outs [B, T, F'], final DenseGraphState). Noise as
    ring_reversible.reversible_scan's."""
    from gcm_tpu_torch.core.graph_state import DenseGraphState

    reason = dense_reversible_refusal(model)
    if reason is not None:
        raise ValueError(reason)
    nodes0, adj0, weights0, n0 = state
    if weights0.numel():
        raise ValueError("remat='reverse' needs an empty weights buffer")
    outs, nodes, adj = run_reversible(model, _DenseSpec(model), xs, nodes0,
                                      adj0, n0, noise, generator)
    num = torch.clamp(n0 + xs.shape[1], max=model.graph_size)
    return outs, DenseGraphState(nodes, adj, weights0, num)
