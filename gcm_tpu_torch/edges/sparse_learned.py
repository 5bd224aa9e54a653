"""Learned edge selector, sparse (time-batched) API (counterpart of
gcm_tpu/edges/sparse_learned.py).

An MLP scores every causal (sink >= T, source < sink) pair, optionally
only the sources from T - window on; the logits go through a masked Gumbel
softmax (stochastic) or a masked tempered softmax (deterministic) over the
sources, at a learnable temperature clamped to `temp_bounds`; the entries
above 1 / (1 + num_edge_samples) become edges, so a sink keeps at most
num_edge_samples of them (the slot bound, slot_k = num_edge_samples).

Two paths give the same edges (up to the softmax's reduction order): the
grid path scores all N nodes into a [B, t, N] grid; with a window,
`emit_edges` scores only the band of width window + t behind the new nodes
and emits the kept entries as edges directly, where `emit_profitable`
says the band is narrow enough to pay. Both return the stats aux
(edges_per_node, edge_density, logits_mean, logits_var, temperature).

The stochastic path draws its Gumbel noise from `generator=`, or takes it
as `noise=` (the shape of the logits: [B, t, N] on the grid path,
[B, t, w'] on the emit path), and raises without either.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from gcm_tpu_torch.edges.learned import default_edge_network
from gcm_tpu_torch.nn.module import MLP, Linear
from gcm_tpu_torch.utils.ste import (masked_gumbel_softmax,
                                     masked_tempered_softmax)

# SparseGCM(emit="auto") takes the emit path where N >= EMIT_WINDOW_FACTOR
# * w'. On an H100 (700 W) the emit path's forward window took longer than
# the grid path's at N / w' = 2.7 (N = 128, w' = 48) in both runs of
# chip_smoke.py's gate phase, and tied or won from N / w' = 5.3 on.
EMIT_WINDOW_FACTOR = 3


class LearnedEdge(nn.Module):
    def __init__(self, input_size: int = 0, model: MLP | None = None,
                 num_edge_samples: int = 5, deterministic: bool = False,
                 window: int | None = None, softmax_temp: float = 1.0,
                 learn_softmax_temp: bool = True,
                 temp_bounds: Tuple[float, float] = (0.001, 5.0), *,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        if not (input_size or model):
            raise ValueError("give input_size or model")
        self.deterministic = deterministic
        self.num_edge_samples = num_edge_samples
        self.window = window
        self.softmax_temp = softmax_temp
        self.learn_softmax_temp = learn_softmax_temp
        self.temp_bounds = temp_bounds
        self.edge_network = model if model is not None else \
            default_edge_network(input_size, init="orthogonal",
                                 device=device, generator=generator)
        dev = next(self.edge_network.parameters()).device
        self.tau = (nn.Parameter(torch.tensor([softmax_temp],
                                              dtype=torch.float32,
                                              device=dev))
                    if learn_softmax_temp else None)

    def _score_pairs(self, sink_feats, nodes):
        """Pair logits [B, t, M] of (sink || source) for sink_feats
        [B, t, F] and sources nodes [B, M, F]. When the scorer is an MLP
        whose first layer is Linear(2F, H), that layer factors as
        sink @ W[:F] + source @ W[F:] + b, each product computed once per
        node and broadcast; any other scorer runs on the whole pair grid."""
        B, t, F = sink_feats.shape
        M = nodes.shape[1]
        net = self.edge_network
        first = net.layers[0] if isinstance(net, MLP) and net.layers else None
        if isinstance(first, Linear) and first.in_dim == 2 * F:
            W = first.kernel
            h = (torch.einsum("btf,fh->bth", sink_feats, W[:F])[:, :, None, :]
                 + torch.einsum("bnf,fh->bnh", nodes, W[F:])[:, None, :, :])
            if first.bias is not None:
                h = h + first.bias
            for layer in net.layers[1:]:
                h = layer(h)
            return h[..., 0]
        pair_in = torch.cat([sink_feats[:, :, None, :].expand(B, t, M, F),
                             nodes[:, None, :, :].expand(B, t, M, F)], dim=-1)
        return net(pair_in)[..., 0]

    def _temperature(self, dev):
        if self.learn_softmax_temp:
            return torch.clamp(self.tau[0], *self.temp_bounds)
        return torch.tensor(self.softmax_temp, dtype=torch.float32,
                            device=dev)

    def _soft(self, logits, cand, generator, noise):
        """The per-sink probabilities over the candidate sources."""
        tau = self._temperature(logits.device)
        if self.deterministic:
            soft = masked_tempered_softmax(logits, cand, axis=2, tau=tau)
        else:
            soft = masked_gumbel_softmax(logits, cand, axis=2, tau=tau,
                                         generator=generator, noise=noise)
        return soft, tau

    @staticmethod
    def _stats(keep, cand, logits, taus, tau):
        n_edges = keep.sum()
        n_cand = torch.clamp(cand.sum(), min=1)
        lmean = torch.where(cand, logits, 0.0).sum() / n_cand
        lvar = torch.where(cand, (logits - lmean) ** 2, 0.0).sum() / n_cand
        return {"edges_per_node": n_edges / torch.clamp(taus.sum(), min=1),
                "edge_density": n_edges / n_cand,
                "logits_mean": lmean, "logits_var": lvar, "temperature": tau}

    def forward(self, nodes, T, taus, t: int, seg_mask=None, generator=None,
                noise=None):
        """The grid path: (grid [B, t, N], stats aux)."""
        B, N, F = nodes.shape
        dev = nodes.device
        i = torch.arange(t, device=dev)[None, :]
        sink = T[:, None] + i                                   # [B, t]
        j = torch.arange(N, device=dev)[None, None, :]
        cand = (i < taus[:, None])[..., None] & (
            j < torch.clamp(sink, 0, N)[..., None])
        if self.window is not None:
            cand = cand & (j >= torch.clamp(T[:, None, None] - self.window,
                                            min=0))
        if seg_mask is not None:
            # episode-aware replay: only the sink's own episode competes in
            # the softmax
            cand = cand & seg_mask
        sink_feats = torch.gather(nodes, 1, torch.clamp(sink, 0, N - 1).long()
                                  [..., None].expand(-1, -1, F))
        logits = self._score_pairs(sink_feats, nodes)
        soft, tau = self._soft(logits, cand, generator, noise)
        keep = (soft > 1.0 / (1 + self.num_edge_samples)) & cand
        grid = torch.where(keep, soft, 0.0)
        return grid, self._stats(keep, cand, logits, taus, tau)

    @property
    def supports_emit(self) -> bool:
        """emit_edges needs the window to bound the scored band."""
        return self.window is not None

    def emit_profitable(self, t: int, N: int) -> bool:
        """The dispatch gate of SparseGCM(emit="auto"): the band of
        w' = min(window + t, N) nodes is at most N / EMIT_WINDOW_FACTOR."""
        if self.window is None:
            return False
        return N >= EMIT_WINDOW_FACTOR * min(self.window + t, N)

    def emit_edges(self, nodes, T, taus, t: int, seg_mask=None,
                   generator=None, noise=None):
        """The window-space path: each sink T + i draws its sources from
        [max(T - window, 0), T + i), a band of w' = min(window + t, N)
        nodes gathered into [B, w', F]; the same pair MLP and masked softmax
        over the same candidates, and the kept entries emitted directly.
        Returns (new_edges [B, 2, t * w'], weights, valid, stats aux)."""
        B, N, F = nodes.shape
        dev = nodes.device
        wp = min(self.window + t, N)
        i = torch.arange(t, device=dev)[None, :]
        sink = T[:, None] + i                                   # [B, t]
        lo = torch.clamp(T - self.window, min=0)                # [B]
        src_abs = lo[:, None] + torch.arange(wp, device=dev)[None, :]
        j = src_abs[:, None, :]                                 # [B, 1, w']
        cand = ((i < taus[:, None])[..., None]
                & (j < torch.clamp(sink, 0, N)[..., None]) & (j < N))
        safe = torch.clamp(src_abs, 0, N - 1).long()
        if seg_mask is not None:
            cand = cand & torch.gather(seg_mask, 2,
                                       safe[:, None, :].expand_as(cand))
        win_nodes = torch.gather(nodes, 1, safe[..., None].expand(-1, -1, F))
        sink_feats = torch.gather(nodes, 1, torch.clamp(sink, 0, N - 1).long()
                                  [..., None].expand(-1, -1, F))
        logits = self._score_pairs(sink_feats, win_nodes)       # [B, t, w']
        soft, tau = self._soft(logits, cand, generator, noise)
        keep = (soft > 1.0 / (1 + self.num_edge_samples)) & cand
        ok = keep.reshape(B, -1)
        sinks = sink[:, :, None].expand_as(keep).reshape(B, -1)
        srcs = j.expand_as(keep).reshape(B, -1)
        new_e = torch.stack([torch.where(ok, sinks, -1),
                             torch.where(ok, srcs, -1)], dim=1) \
            .to(torch.int32)
        vals = torch.where(ok, soft.reshape(B, -1), 0.0)
        return new_e, vals, ok, self._stats(keep, cand, logits, taus, tau)
