"""Carry weights and state between the JAX package and the port.

`load_jax_params(model, params)` takes the JAX package's parameter tree with
numpy (or any array-like) leaves, e.g. for a DenseGCM or a SparseGCM
{"gnn": [...], "preprocessor": [...], "edge_selectors": {}}, and copies it
into the port's modules: layers (DenseGCNConv's `lin` and `bias`
included), edge selectors (a learned distance's `dist_param`, a learned
TemporalBackedge's `window`, a LearnedEdge's `edge_network`, the sparse
LearnedEdge's `edge_network` and `tau`, an EdgeChain's or a
SparseEdgeChain's list), the aux selectors and positional encoders (`pe`,
`reproject`). Both sides store linear kernels [in, out], so
nothing is transposed. DenseGraphConv and GraphConv share one layout, so one
tree loads into the README's dense and sparse models alike.

`named_from_jax(model, tree)` maps any tree of that layout (parameters,
their gradients, Adam's moments) onto the model's parameter names, so that
gradients and updated parameters compare leaf by leaf.

`state_from_numpy` / `sparse_state_from_numpy` and their `*_to_numpy`
inverses carry the recurrent states across.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from gcm_tpu_torch.core.graph_state import DenseGraphState, SparseGraphState
from gcm_tpu_torch.edges.chain import EdgeChain
from gcm_tpu_torch.edges.dense import DenseEdge
from gcm_tpu_torch.edges.distance import Distance
from gcm_tpu_torch.edges.learned import LearnedEdge
from gcm_tpu_torch.edges.sparse_learned import LearnedEdge as \
    SparseLearnedEdge
from gcm_tpu_torch.edges.sparse_spatial import (SparseEdgeChain,
                                                SpatialKNNEdge,
                                                SpatialRadiusEdge)
from gcm_tpu_torch.edges.sparse_temporal import TemporalEdge
from gcm_tpu_torch.edges.temporal import TemporalBackedge
from gcm_tpu_torch.models.dense_gcm import DenseGCM
from gcm_tpu_torch.models.positional import (PositionalEncoding,
                                             RelativePositionalEncoding)
from gcm_tpu_torch.models.sparse_gcm import SparseGCM
from gcm_tpu_torch.nn.dense_conv import (DenseGCNConv, DenseGNN,
                                         DenseGraphConv)
from gcm_tpu_torch.nn.module import MLP, LayerNorm, Linear
from gcm_tpu_torch.nn.sparse_conv import GCNConv, GraphConv, SparseGNN


def _copy(param: torch.Tensor, value) -> None:
    value = torch.tensor(np.asarray(value), dtype=param.dtype)
    if tuple(value.shape) != tuple(param.shape):
        raise ValueError(f"shape {tuple(value.shape)} does not fit parameter "
                         f"of shape {tuple(param.shape)}")
    with torch.no_grad():
        param.copy_(value)


def load_jax_params(module, params) -> None:
    if isinstance(module, Linear):
        _copy(module.kernel, params["kernel"])
        if module.bias is not None:
            _copy(module.bias, params["bias"])
    elif isinstance(module, (DenseGraphConv, GraphConv)):
        load_jax_params(module.lin_rel, params["lin_rel"])
        load_jax_params(module.lin_root, params["lin_root"])
    elif isinstance(module, (GCNConv, DenseGCNConv)):
        load_jax_params(module.lin, params["lin"])
        if module.bias is not None:
            _copy(module.bias, params["bias"])
    elif isinstance(module, (DenseGNN, SparseGNN, MLP)):
        if len(params) != len(module.layers):
            raise ValueError(f"{len(params)} parameter entries for "
                             f"{len(module.layers)} layers")
        for layer, p in zip(module.layers, params):
            if isinstance(layer, torch.nn.Module) and p:
                load_jax_params(layer, p)
    elif isinstance(module, LayerNorm):
        _copy(module.scale, params["scale"])
        _copy(module.bias, params["bias"])
    elif isinstance(module, (DenseGCM, SparseGCM)):
        load_jax_params(module.gnn, params["gnn"])
        for name in ("preprocessor", "edge_selectors", "aux_edge_selectors",
                     "positional_encoder"):
            sub = getattr(module, name, None)
            if sub is not None:
                load_jax_params(sub, params.get(name, {}))
    elif isinstance(module, (EdgeChain, SparseEdgeChain)):
        if len(params) != len(module.selectors):
            raise ValueError(f"{len(params)} parameter entries for "
                             f"{len(module.selectors)} selectors")
        for sel, p in zip(module.selectors, params):
            load_jax_params(sel, p)
    elif isinstance(module, LearnedEdge):
        load_jax_params(module.edge_network, params["edge_network"])
    elif isinstance(module, SparseLearnedEdge):
        load_jax_params(module.edge_network, params["edge_network"])
        if module.tau is not None:
            _copy(module.tau, params["tau"])
    elif isinstance(module, Distance) and module.learned:
        _copy(module.dist_param, params["dist_param"])
    elif isinstance(module, TemporalBackedge) and module.learned:
        _copy(module.window, params["window"])
    elif isinstance(module, (PositionalEncoding, RelativePositionalEncoding)):
        _copy(module.pe, params["pe"])
        if getattr(module, "reproject", None) is not None:
            load_jax_params(module.reproject, params["reproject"])
    elif isinstance(module, (TemporalBackedge, TemporalEdge, DenseEdge,
                             Distance, SpatialRadiusEdge, SpatialKNNEdge)):
        if params:
            raise ValueError(f"{type(module).__name__} has no parameters to "
                             "load")
    else:
        raise TypeError(f"no JAX parameter layout known for "
                        f"{type(module).__name__}")


def named_from_jax(module, tree) -> dict[str, torch.Tensor]:
    """{name: tensor} over module.named_parameters(), each leaf taken from
    `tree`, a JAX tree in the layout `load_jax_params` reads. Raises if a
    parameter has no leaf in the tree."""
    clone = copy.deepcopy(module)
    with torch.no_grad():
        for p in clone.parameters():
            p.fill_(float("nan"))
    load_jax_params(clone, tree)
    out = {name: p.detach() for name, p in clone.named_parameters()}
    missing = [name for name, t in out.items() if bool(t.isnan().any())]
    if missing:
        raise ValueError(f"parameters with no leaf in the tree: {missing}")
    return out


def state_from_numpy(state, device) -> DenseGraphState:
    """A DenseGraphState (or any 4-tuple in its field order) of arrays ->
    the port's DenseGraphState on `device`."""
    nodes, adj, weights, num_nodes = (np.asarray(a) for a in state)
    return DenseGraphState(
        nodes=torch.tensor(nodes, dtype=torch.float32, device=device),
        adj=torch.tensor(adj, dtype=torch.float32, device=device),
        weights=torch.tensor(weights, dtype=torch.float32, device=device),
        num_nodes=torch.tensor(num_nodes, dtype=torch.int32, device=device),
    )


def state_to_numpy(state: DenseGraphState) -> DenseGraphState:
    return DenseGraphState(*(t.detach().cpu().numpy() for t in state))


def sparse_state_from_numpy(state, device) -> SparseGraphState:
    """A SparseGraphState (or any 5-tuple in its field order) of arrays ->
    the port's SparseGraphState on `device`."""
    nodes, edges, weights, t, num_edges = (np.asarray(a) for a in state)
    return SparseGraphState(
        nodes=torch.tensor(nodes, dtype=torch.float32, device=device),
        edges=torch.tensor(edges, dtype=torch.int32, device=device),
        weights=torch.tensor(weights, dtype=torch.float32, device=device),
        t=torch.tensor(t, dtype=torch.int32, device=device),
        num_edges=torch.tensor(num_edges, dtype=torch.int32, device=device),
    )


def sparse_state_to_numpy(state: SparseGraphState) -> SparseGraphState:
    return SparseGraphState(*(t.detach().cpu().numpy() for t in state))
