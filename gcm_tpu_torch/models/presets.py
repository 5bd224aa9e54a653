"""Canonical model configurations (counterpart of
gcm_tpu/models/presets.py).

`readme_dense_gcm` is the flagship README workload: obs -> Linear
preprocessor -> DenseGCM with a 2-layer DenseGraphConv + tanh stack and
TemporalBackedge(hops) on a graph_size-node graph. `readme_sparse_gcm` is
its sparse twin: the same preprocessor and a 2-layer GraphConv + tanh stack
in a SparseGCM with TemporalEdge(hops) and max_edges edge slots. Weights
are drawn from a torch.Generator seeded with `seed`, in the same order for
both, so two calls with the same seed give the same weights on any device,
and the dense and sparse models of one seed share them.
"""

from __future__ import annotations

import torch

from gcm_tpu_torch.device import resolve_device
from gcm_tpu_torch.edges.sparse_temporal import TemporalEdge
from gcm_tpu_torch.edges.temporal import TemporalBackedge
from gcm_tpu_torch.models.dense_gcm import DenseGCM
from gcm_tpu_torch.models.sparse_gcm import SparseGCM
from gcm_tpu_torch.nn.dense_conv import DenseGNN, DenseGraphConv
from gcm_tpu_torch.nn.module import MLP, Linear
from gcm_tpu_torch.nn.sparse_conv import GraphConv, SparseGNN


def readme_dense_gcm(obs_size: int = 8, hidden: int = 32,
                     graph_size: int = 128, hops=(1,), device=None,
                     seed: int = 0) -> DenseGCM:
    device = resolve_device(device)
    g = torch.Generator().manual_seed(seed)
    gnn = DenseGNN([
        DenseGraphConv(hidden, hidden, device=device, generator=g), torch.tanh,
        DenseGraphConv(hidden, hidden, device=device, generator=g), torch.tanh,
    ])
    pre = MLP([Linear(obs_size, hidden, device=device, generator=g)])
    return DenseGCM(gnn, preprocessor=pre, graph_size=graph_size,
                    edge_selectors=TemporalBackedge(list(hops)), device=device)


def readme_sparse_gcm(obs_size: int = 8, hidden: int = 32,
                      graph_size: int = 128, max_edges: int = 512,
                      hops=(1,), device=None, seed: int = 0,
                      **kwargs) -> SparseGCM:
    """kwargs go to SparseGCM (e.g. aggregation="slots", slot_k=1)."""
    device = resolve_device(device)
    g = torch.Generator().manual_seed(seed)
    gnn = SparseGNN([
        GraphConv(hidden, hidden, device=device, generator=g), torch.tanh,
        GraphConv(hidden, hidden, device=device, generator=g), torch.tanh,
    ])
    pre = MLP([Linear(obs_size, hidden, device=device, generator=g)])
    return SparseGCM(gnn, preprocessor=pre, graph_size=graph_size,
                     max_edges=max_edges,
                     edge_selectors=TemporalEdge(list(hops)), device=device,
                     **kwargs)
