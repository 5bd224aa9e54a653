"""Carry weights and state between the JAX package and the port.

`load_jax_params(model, params)` takes the JAX package's parameter tree with
numpy (or any array-like) leaves, e.g. for a DenseGCM
{"gnn": [...], "preprocessor": [...], "edge_selectors": {}}, and copies it
into the port's modules. Both sides store linear kernels [in, out], so
nothing is transposed.
"""

from __future__ import annotations

import numpy as np
import torch

from gcm_tpu_torch.core.graph_state import DenseGraphState
from gcm_tpu_torch.edges.temporal import TemporalBackedge
from gcm_tpu_torch.models.dense_gcm import DenseGCM
from gcm_tpu_torch.nn.dense_conv import DenseGNN, DenseGraphConv
from gcm_tpu_torch.nn.module import MLP, Linear


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
    elif isinstance(module, DenseGraphConv):
        load_jax_params(module.lin_rel, params["lin_rel"])
        load_jax_params(module.lin_root, params["lin_root"])
    elif isinstance(module, (DenseGNN, MLP)):
        if len(params) != len(module.layers):
            raise ValueError(f"{len(params)} parameter entries for "
                             f"{len(module.layers)} layers")
        for layer, p in zip(module.layers, params):
            if isinstance(layer, torch.nn.Module) and p:
                load_jax_params(layer, p)
    elif isinstance(module, DenseGCM):
        load_jax_params(module.gnn, params["gnn"])
        if module.preprocessor is not None:
            load_jax_params(module.preprocessor, params["preprocessor"])
        if module.edge_selectors is not None:
            load_jax_params(module.edge_selectors,
                            params.get("edge_selectors", {}))
    elif isinstance(module, TemporalBackedge):
        if params:
            raise ValueError("TemporalBackedge has no parameters to load")
    else:
        raise TypeError(f"no JAX parameter layout known for "
                        f"{type(module).__name__}")


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
