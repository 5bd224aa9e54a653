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

The actor-critic policies' tree is {"core", "logit", "value"}; the nav
policy's core is {"gnn": [...]} (NavDenseGNN's or NavPoseGNN's layers,
{} for an activation), a NavRelPosConv {"msg1", "msg2", "lin_root"}.
`jax_param_tree(model)` is that layout with the port's parameters as its
leaves, the one place that knows it: `named_from_jax(model, tree)` maps
any tree of the layout (parameters, their gradients, Adam's moments) onto
the model's parameter names, so that gradients and updated parameters
compare leaf by leaf, and `jax_paths(model)` names each parameter by its
JAX path.

`state_from_numpy` / `sparse_state_from_numpy` / `ring_state_from_numpy`
/ `banded_state_from_numpy` / `banded_scored_state_from_numpy` /
`nav_state_from_numpy` / `nav_inc_state_from_numpy` and their
`*_to_numpy` inverses carry the recurrent states across. The fast cores'
trees are {"gnn", "preprocessor"} and, for BandedScoredGCM, "distance"
(a learned scale's {"dist_param"}).
"""

from __future__ import annotations

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
from gcm_tpu_torch.models.banded_gcm import (BandedRingGCM,
                                             BandedScoredGCM,
                                             BandedScoredState, BandedState)
from gcm_tpu_torch.models.clique_gcm import CliqueGCM
from gcm_tpu_torch.models.dense_gcm import DenseGCM
from gcm_tpu_torch.models.nav_gcm import (NavDenseGNN, NavGCM,
                                          NavGCMIncremental, NavIncState,
                                          NavState)
from gcm_tpu_torch.models.positional import (PositionalEncoding,
                                             RelativePositionalEncoding)
from gcm_tpu_torch.models.ring_gcm import RingDenseGCM, RingGraphState
from gcm_tpu_torch.models.sparse_gcm import SparseGCM
from gcm_tpu_torch.nn.dense_conv import (DenseGCNConv, DenseGNN,
                                         DenseGraphConv)
from gcm_tpu_torch.nn.module import MLP, LayerNorm, Linear
from gcm_tpu_torch.nn.nav_conv import NavPoseGNN, NavRelPosConv
from gcm_tpu_torch.nn.sparse_conv import GCNConv, GraphConv, SparseGNN
from gcm_tpu_torch.rl.nav import NavActorCritic
from gcm_tpu_torch.rl.wrappers import GCMActorCritic, _FrozenMLP


def _copy(param: torch.Tensor, value) -> None:
    value = torch.tensor(np.asarray(value), dtype=param.dtype)
    if tuple(value.shape) != tuple(param.shape):
        raise ValueError(f"shape {tuple(value.shape)} does not fit parameter "
                         f"of shape {tuple(param.shape)}")
    with torch.no_grad():
        param.copy_(value)


def jax_param_tree(module):
    """The module's parameters in the layout of its JAX parameter tree
    (dicts and lists), the parameters themselves as leaves; a part with no
    parameters is {}. Both sides store linear kernels [in, out], so
    nothing is transposed."""
    if isinstance(module, (GCMActorCritic, NavActorCritic)):
        core = (module.core_train if isinstance(module, NavActorCritic)
                else module.core)
        return {"core": jax_param_tree(core),
                "logit": jax_param_tree(module.logit_branch),
                "value": jax_param_tree(module.value_branch)}
    if isinstance(module, (NavGCM, NavGCMIncremental)):
        return {"gnn": jax_param_tree(module.gnn)}
    if isinstance(module, NavRelPosConv):
        return {n: jax_param_tree(getattr(module, n))
                for n in ("msg1", "msg2", "lin_root")}
    if isinstance(module, _FrozenMLP):
        return jax_param_tree(module.inner)
    if isinstance(module, (Linear, LayerNorm, DenseGCNConv, GCNConv)):
        names = {Linear: ("kernel", "bias"), LayerNorm: ("scale", "bias"),
                 DenseGCNConv: ("lin", "bias"), GCNConv: ("lin", "bias")}
        out = {}
        for n in names[type(module)]:
            sub = getattr(module, n)
            if isinstance(sub, torch.nn.Module):
                out[n] = jax_param_tree(sub)
            elif sub is not None:
                out[n] = sub
        return out
    if isinstance(module, (DenseGraphConv, GraphConv)):
        return {"lin_rel": jax_param_tree(module.lin_rel),
                "lin_root": jax_param_tree(module.lin_root)}
    if isinstance(module, (DenseGNN, SparseGNN, MLP, NavDenseGNN,
                           NavPoseGNN)):
        return [jax_param_tree(m) if isinstance(m, torch.nn.Module) else {}
                for m in module.layers]
    if isinstance(module, (DenseGCM, SparseGCM, RingDenseGCM,
                           BandedRingGCM, BandedScoredGCM, CliqueGCM)):
        out = {"gnn": jax_param_tree(module.gnn)}
        for name in ("preprocessor", "edge_selectors", "aux_edge_selectors",
                     "positional_encoder", "distance"):
            sub = getattr(module, name, None)
            if sub is not None:
                out[name] = jax_param_tree(sub)
        return out
    if isinstance(module, (EdgeChain, SparseEdgeChain)):
        return [jax_param_tree(s) for s in module.selectors]
    if isinstance(module, (LearnedEdge, SparseLearnedEdge)):
        out = {"edge_network": jax_param_tree(module.edge_network)}
        if getattr(module, "tau", None) is not None:
            out["tau"] = module.tau
        return out
    if isinstance(module, Distance) and module.learned:
        return {"dist_param": module.dist_param}
    if isinstance(module, TemporalBackedge) and module.learned:
        return {"window": module.window}
    if isinstance(module, (PositionalEncoding, RelativePositionalEncoding)):
        out = {"pe": module.pe}
        if getattr(module, "reproject", None) is not None:
            out["reproject"] = jax_param_tree(module.reproject)
        return out
    if isinstance(module, (TemporalBackedge, TemporalEdge, DenseEdge,
                           Distance, SpatialRadiusEdge, SpatialKNNEdge)):
        return {}
    raise TypeError(f"no JAX parameter layout known for "
                    f"{type(module).__name__}")


def _has_params(tree) -> bool:
    if isinstance(tree, dict):
        return any(_has_params(v) for v in tree.values())
    if isinstance(tree, list):
        return any(_has_params(v) for v in tree)
    return True


def _leaves(tree, jax_tree=None, path=()):
    """(path, parameter, the JAX tree's leaf at that path or None) for every
    parameter of a `jax_param_tree`, walking `jax_tree` beside it (parts
    without parameters are not looked up); a list of another length than
    the module's raises."""
    if isinstance(tree, (dict, list)):
        if isinstance(tree, list) and jax_tree is not None \
                and len(jax_tree) != len(tree):
            raise ValueError(f"{'/'.join(path)}: {len(jax_tree)} parameter "
                             f"entries for {len(tree)} layers or selectors")
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        for k, sub in items:
            if _has_params(sub):
                yield from _leaves(sub, None if jax_tree is None
                                   else jax_tree[k], path + (str(k),))
    else:
        yield path, tree, jax_tree


def load_jax_params(module, params) -> None:
    """Copy a JAX parameter tree into the module's parameters."""
    for _, param, value in _leaves(jax_param_tree(module), params):
        _copy(param, value)


def jax_paths(module) -> dict[str, str]:
    """{parameter name: its path in the JAX tree}, the path's keys joined
    by "/" as the JAX package's `utils/debug.py::grad_norms` names them
    (e.g. "core/gnn/0/lin_rel/kernel")."""
    names = {id(p): name for name, p in module.named_parameters()}
    return {names[id(p)]: "/".join(path)
            for path, p, _ in _leaves(jax_param_tree(module))}


def named_from_jax(module, tree) -> dict[str, torch.Tensor]:
    """{name: tensor} over module.named_parameters(), each leaf taken from
    `tree`, a JAX tree in the layout `load_jax_params` reads (parameters,
    their gradients, Adam's moments)."""
    names = {id(p): name for name, p in module.named_parameters()}
    out = {}
    for _, param, value in _leaves(jax_param_tree(module), tree):
        t = torch.tensor(np.asarray(value), dtype=param.dtype)
        if tuple(t.shape) != tuple(param.shape):
            raise ValueError(f"shape {tuple(t.shape)} does not fit "
                             f"parameter of shape {tuple(param.shape)}")
        out[names[id(param)]] = t
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


def ring_state_from_numpy(state, device) -> RingGraphState:
    """A RingGraphState (or any 4-tuple in its field order) of arrays ->
    the port's RingGraphState on `device`; the adjacency keeps a bfloat16
    dtype (JAX's adj_dtype), else float32."""
    nodes, adj, weights, t = state
    adj_dtype = (torch.bfloat16 if str(getattr(adj, "dtype", "")) ==
                 "bfloat16" else torch.float32)
    return RingGraphState(
        nodes=torch.tensor(np.asarray(nodes), dtype=torch.float32,
                           device=device),
        adj=torch.tensor(np.asarray(adj, np.float32), dtype=adj_dtype,
                         device=device),
        weights=torch.tensor(np.asarray(weights), dtype=torch.float32,
                             device=device),
        t=torch.tensor(np.asarray(t), dtype=torch.int32, device=device),
    )


def ring_state_to_numpy(state: RingGraphState) -> RingGraphState:
    """The port's RingGraphState as numpy arrays (a bfloat16 adjacency as
    float32, which holds its values exactly)."""
    return RingGraphState(*(t.detach().cpu().float().numpy()
                            if t.dtype == torch.bfloat16
                            else t.detach().cpu().numpy() for t in state))


def banded_state_from_numpy(state, device) -> BandedState:
    """A BandedState (or any (nodes, t) tuple) of arrays -> the port's
    BandedState on `device` (BandedRingGCM's and CliqueGCM's state)."""
    nodes, t = state
    return BandedState(_f32(nodes, device), _i32(t, device))


def banded_state_to_numpy(state: BandedState) -> BandedState:
    return BandedState(*(a.detach().cpu().numpy() for a in state))


def banded_scored_state_from_numpy(state, device) -> BandedScoredState:
    """A BandedScoredState (or any (nodes, band, t) tuple) of arrays -> the
    port's BandedScoredState on `device`."""
    nodes, band, t = state
    return BandedScoredState(_f32(nodes, device), _f32(band, device),
                             _i32(t, device))


def banded_scored_state_to_numpy(state: BandedScoredState):
    return BandedScoredState(*(a.detach().cpu().numpy() for a in state))


def _f32(a, device):
    return torch.tensor(np.asarray(a), dtype=torch.float32, device=device)


def _i32(a, device):
    return torch.tensor(np.asarray(a), dtype=torch.int32, device=device)


def nav_state_from_numpy(state, device) -> NavState:
    """A NavState (or any (x, pos, rot, t) tuple) of arrays -> the port's
    NavState on `device`."""
    x, pos, rot, t = state
    return NavState(_f32(x, device), _f32(pos, device), _f32(rot, device),
                    _i32(t, device))


def nav_state_to_numpy(state: NavState) -> NavState:
    return NavState(*(a.detach().cpu().numpy() for a in state))


def nav_inc_state_from_numpy(state, device) -> NavIncState:
    """A NavIncState (or any (x, pos, rot, caches, t) tuple) of arrays ->
    the port's NavIncState on `device`."""
    x, pos, rot, caches, t = state
    return NavIncState(_f32(x, device), _f32(pos, device), _f32(rot, device),
                       tuple(_f32(c, device) for c in caches),
                       _i32(t, device))


def nav_inc_state_to_numpy(state: NavIncState) -> NavIncState:
    x, pos, rot, caches, t = (a if isinstance(a, tuple)
                              else a.detach().cpu().numpy() for a in state)
    return NavIncState(x, pos, rot,
                       tuple(c.detach().cpu().numpy() for c in caches), t)
