"""CliqueGCM, the DenseEdge fast core (counterpart of
gcm_tpu/models/clique_gcm.py).

DenseEdge wires every inserted node both ways to every existing node plus a
self edge, and the wraparound clears the evicted node's row and column, so
the adjacency is always a complete graph with self-loops over the alive
nodes. Every alive sink's GraphConv aggregate is then one masked sum of the
alive nodes:

- a step costs an O(N * F * F') root product and an O(N * F) masked sum,
  against DenseGCM's O(N^2 * F) adj @ x; the state is (nodes, t), a
  `BandedState`, with the banded cores' ring-pointer model (slot t mod N);
- `window()` is a scan-free forward over a whole trajectory: the shared
  aggregate at step i depends only on which writes are alive, so every
  step's slot contents are built at once as [B, T, N, F] gathers.

It gives DenseGCM's beliefs for edge_selectors=DenseEdge() and a
DenseGraphConv('add' | 'mean') + tanh/relu stack, through wraparound and
episode resets. Plain PyTorch on either device: the JAX core reaches no TPU
kernel. The alive sums and `impl="proj"`'s prefix sums add in the
features' dtype, as JAX's do, so the window and the scan, which reduce
batches of other shapes, agree to float32 rounding of the aggregate.
"""

from __future__ import annotations

import torch

from gcm_tpu_torch.models.banded_gcm import (BandedState, _FastCore,
                                             _gather_rows, _insert,
                                             _ring_final, _window_time)


def _alive_sum(h, alive):
    """sum_s alive[b, s] * h[b, s] -> [B, F]."""
    return torch.sum(h * alive[..., None], dim=1)


class CliqueGCM(_FastCore):
    """DenseEdge fast path: the complete graph over the alive nodes is
    implicit."""

    def __init__(self, gnn, preprocessor=None, graph_size: int = 128, *,
                 device=None):
        super().__init__(gnn, preprocessor, graph_size, "CliqueGCM", device)

    def initial_state(self, B: int, feat: int,
                      dtype=torch.float32) -> BandedState:
        return BandedState(
            nodes=torch.zeros((B, self.graph_size, feat), dtype=dtype,
                              device=self.device),
            t=torch.zeros((B,), dtype=torch.int32, device=self.device))

    @staticmethod
    def _apply_layer(conv, act, root_term, rel_term):
        out = root_term + rel_term
        if conv.lin_rel.bias is not None:
            out = out + conv.lin_rel.bias
        if act == "tanh":
            out = torch.tanh(out)
        elif act == "relu":
            out = torch.clamp(out, min=0.0)
        return out

    def forward(self, x, state: BandedState):
        """x [B, obs] -> (belief [B, F_out], new state)."""
        nodes, t = state
        N = self.graph_size
        p = torch.remainder(t, N)
        nodes = _insert(nodes, x, p)
        h = self._pre(nodes)
        slots = torch.arange(N, dtype=t.dtype, device=t.device)[None, :]
        age = torch.remainder(p[:, None] - slots, N)
        horizon = torch.clamp(t, max=N - 1)
        alive = (age <= horizon[:, None]).to(h.dtype)
        # the alive count is every alive sink's in-degree (self-loops
        # included); a mean divides by it
        cnt = (horizon + 1).to(h.dtype)[:, None]
        for conv, act, aggr in zip(self._convs(), self._acts, self._aggrs):
            agg = _alive_sum(h, alive)  # [B, F]
            if aggr == "mean":
                agg = agg / cnt
            root = h @ conv.lin_root.kernel
            rel = (agg @ conv.lin_rel.kernel)[:, None, :]
            h = self._apply_layer(conv, act, root, rel)
        b_idx = torch.arange(x.shape[0], device=x.device)
        return h[b_idx, p.long()], BandedState(nodes, t + 1)

    def window_profitable(self, mode: str = "forward") -> bool:
        """The whole-trajectory call's gate: always the window. On the card
        it beat the scan, forward and in a training step, at every graph
        size measured (chip_smoke.py's fast phase, "gates" line; PERF.md
        §6): the scan is a loop of launches a step."""
        del mode
        return True

    def _prefix_agg(self, feats_seq, feats_old, t0, t_eff, horizon):
        """The layer-0 alive-masked aggregate A0 [B, T, F] from prefix sums,
        no [B, T, N, F] tensor. The alive window nodes at step i are the
        contiguous counter range [i - horizon_i, i], so their sum is a
        cumsum difference; the alive pre-window slots are ages
        1..min(t0, N - 1 - i) (none after a reset), a cumsum over the rows
        sorted by age."""
        T = feats_seq.shape[1]
        N = self.graph_size
        i = torch.arange(T, dtype=t0.dtype, device=t0.device)[None, :]
        C = torch.cumsum(feats_seq, dim=1)  # [B, T, F]
        lo = i - horizon  # [B, T] first alive window index
        gather_lo = _gather_rows(C, torch.clamp(lo - 1, 0, T - 1))
        A_win = C - torch.where((lo >= 1)[..., None], gather_lo, 0.0)
        # the old rows sorted by age: age a lives at slot (t0 - a) mod N
        ages = torch.arange(1, N + 1, dtype=t0.dtype,
                            device=t0.device)[None, :]
        slot_of_age = torch.remainder(t0[:, None] - ages, N)
        D = torch.cumsum(_gather_rows(feats_old, slot_of_age), dim=1)
        no_reset = t_eff == t0[:, None] + i
        m = torch.where(no_reset, torch.clamp(
            torch.minimum(t0[:, None], N - 1 - i), 0, N), 0)
        gather_m = _gather_rows(D, torch.clamp(m - 1, 0, N - 1))
        A_old = torch.where((m >= 1)[..., None], gather_m, 0.0)
        return A_win + A_old

    def _geometry(self, t0, T, dones):
        """(t_eff, r_last, horizon, p, age [B, T, N], in_window, j_idx)."""
        N = self.graph_size
        t_eff, r_last = _window_time(t0, T, dones)
        horizon = torch.clamp(t_eff, max=N - 1)
        p = torch.remainder(t_eff, N)  # [B, T] the insert slot per step
        i_iota = torch.arange(T, dtype=t0.dtype,
                              device=t0.device)[None, :, None]
        slots = torch.arange(N, dtype=t0.dtype,
                             device=t0.device)[None, None, :]
        age = torch.remainder(p[..., None] - slots, N)
        # alive slots were written within the current episode (the counter
        # fills slots in turn from each reset), so the in-window gather is
        # exact wherever `alive` holds; dead slots are masked to 0
        in_window = age <= i_iota
        j_idx = torch.clamp(i_iota - age, 0, T - 1)
        return t_eff, r_last, horizon, p, age, in_window, j_idx

    def _window_proj(self, xs, state: BandedState, dones=None):
        """`window(impl='proj')`: the gather variant's beliefs up to float
        reassociation, with no product over a [B*T, N, F] tensor: the
        first layer's root products per row ([B, T, F] @ W, [B, N, F] @ W)
        gathered, its aggregate from prefix sums (`_prefix_agg`), and the
        last layer on the inserted slots only (the inserted slot holds
        x_i, whose projected root is R_seq[i])."""
        nodes0, t0 = state
        B, T, _ = xs.shape
        N = self.graph_size
        t_eff, r_last, horizon, p, age, in_window, j_idx = self._geometry(
            t0, T, dones)
        feats_seq, feats_old = self._pre(xs), self._pre(nodes0)
        convs = self._convs()
        L = len(convs)
        conv0, act0 = convs[0], self._acts[0]

        cnt = (horizon + 1).to(xs.dtype)[..., None]  # [B, T, 1]
        A0 = self._prefix_agg(feats_seq, feats_old, t0, t_eff, horizon)
        if self._aggrs[0] == "mean":
            A0 = A0 / cnt
        rel0 = A0 @ conv0.lin_rel.kernel
        R_seq = feats_seq @ conv0.lin_root.kernel
        diag0 = self._apply_layer(conv0, act0, R_seq, rel0)
        if L == 1:
            outs = diag0
        else:
            alive = age <= horizon[..., None]
            R_old = feats_old @ conv0.lin_root.kernel
            R_g = torch.where(in_window[..., None], _gather_rows(R_seq, j_idx),
                              R_old[:, None])  # [B, T, N, O]
            feats = self._apply_layer(conv0, act0, R_g, rel0[:, :, None, :])
            feats = feats.reshape(B * T, N, -1)
            aliveF = alive.to(xs.dtype).reshape(B * T, N)
            flat = torch.arange(B * T, device=xs.device)
            p_flat = p.reshape(B * T).long()
            cnt_flat = cnt.reshape(B * T, 1)
            diag_prev = diag0.reshape(B * T, -1)
            for li in range(1, L):
                conv, act = convs[li], self._acts[li]
                agg = _alive_sum(feats, aliveF)
                if self._aggrs[li] == "mean":
                    agg = agg / cnt_flat
                rel = agg @ conv.lin_rel.kernel
                if li == L - 1:
                    root = diag_prev @ conv.lin_root.kernel
                    outs = self._apply_layer(conv, act, root, rel)
                    outs = outs.reshape(B, T, -1)
                else:
                    root = feats @ conv.lin_root.kernel
                    feats = self._apply_layer(conv, act, root,
                                              rel[:, None, :])
                    diag_prev = feats[flat, p_flat]
        nodes_F, t_F = _ring_final(nodes0, xs, t0, N, r_last)
        return outs, BandedState(nodes_F, t_F)

    def window(self, xs, state: BandedState, dones=None,
               impl: str = "gather"):
        """Whole-trajectory forward without the scan: the scan's beliefs up
        to float reassociation and exactly its final state (pure gathers).
        Entry (i, s) of the [B, T, N, F] content tensor is what slot s
        holds at step i (its newest write <= i); the layers are the scan
        step's ops with T folded into the batch ([B*T, N, F] products and
        one masked slot sum a step), the last on the [B*T, F] inserted
        slots only. dones [B, T]: the scan's episode resets. impl:
        'gather' (this) or 'proj' (`_window_proj`)."""
        if impl == "proj":
            return self._window_proj(xs, state, dones=dones)
        if impl != "gather":
            raise ValueError(f"unknown impl {impl!r}")
        nodes0, t0 = state
        B, T, _ = xs.shape
        N = self.graph_size
        _, r_last, horizon, p, age, in_window, j_idx = self._geometry(
            t0, T, dones)
        alive = age <= horizon[..., None]
        feats_seq, feats_old = self._pre(xs), self._pre(nodes0)
        # slot s's content at step i: [B, T, N, F], T folded into the batch
        feats = torch.where(in_window[..., None],
                            _gather_rows(feats_seq, j_idx),
                            feats_old[:, None].to(feats_seq.dtype))
        feats = feats.reshape(B * T, N, feats.shape[-1])
        aliveF = alive.to(xs.dtype).reshape(B * T, N)
        p_flat = p.reshape(B * T).long()
        flat = torch.arange(B * T, device=xs.device)
        cnt_flat = (horizon + 1).to(xs.dtype).reshape(B * T, 1)
        convs = self._convs()
        for li, (conv, act) in enumerate(zip(convs, self._acts)):
            agg = _alive_sum(feats, aliveF)  # [B*T, F]
            if self._aggrs[li] == "mean":
                agg = agg / cnt_flat
            rel = agg @ conv.lin_rel.kernel
            if li == len(convs) - 1:
                root = feats[flat, p_flat] @ conv.lin_root.kernel
                outs = self._apply_layer(conv, act, root, rel)
                outs = outs.reshape(B, T, -1)
            else:
                root = feats @ conv.lin_root.kernel
                feats = self._apply_layer(conv, act, root, rel[:, None, :])
        nodes_F, t_F = _ring_final(nodes0, xs, t0, N, r_last)
        return outs, BandedState(nodes_F, t_F)
