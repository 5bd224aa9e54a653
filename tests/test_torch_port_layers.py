"""The port's layers on their own against the JAX package: DenseGraphConv's
three aggregations with and without bias and mask, DenseGNN with edge
weights, the fused-stack planner, and TemporalBackedge's directions and
hops inside a DenseGCM scan. Same weights (`load_jax_params`), same numpy
inputs; tolerance 1e-5 (float32 on both sides, only summation order
differs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

import gcm_tpu.config as jax_config
from gcm_tpu.edges.temporal import TemporalBackedge as JaxTemporalBackedge
from gcm_tpu.models.dense_gcm import DenseGCM as JaxDenseGCM
from gcm_tpu.nn.dense_conv import DenseGNN as JaxDenseGNN
from gcm_tpu.nn.dense_conv import DenseGraphConv as JaxDenseGraphConv
from gcm_tpu.nn.module import MLP as JaxMLP
from gcm_tpu.nn.module import Linear as JaxLinear
from gcm_tpu_torch import (DenseGCM, DenseGNN, DenseGraphConv, MLP, Linear,
                           TemporalBackedge, load_jax_params, reset_where)
from gcm_tpu_torch.nn.dense_conv import plan_conv_stack

torch.set_num_threads(1)

ATOL = 1e-5
B, N, FIN, FOUT = 2, 16, 8, 6


def graph_inputs(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, N, FIN)).astype(np.float32)
    adj = (rng.random((B, N, N)) < 0.3).astype(np.float32)
    adj[:, 0, :] = 0.0  # a node with no in-edges
    weights = rng.random((B, N, N)).astype(np.float32)
    mask = rng.random((B, N)) < 0.7
    return x, adj, weights, mask


def jax_params(module, seed=0):
    params = module.init(jax.random.PRNGKey(seed))
    return params, jax.tree_util.tree_map(np.asarray, params)


@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("use_bias", [True, False])
@pytest.mark.parametrize("aggr", ["add", "mean", "max"])
def test_dense_graph_conv_matches_jax(aggr, use_bias, with_mask):
    jconv = JaxDenseGraphConv(FIN, FOUT, aggr=aggr, use_bias=use_bias)
    params, np_params = jax_params(jconv)
    conv = DenseGraphConv(FIN, FOUT, aggr=aggr, use_bias=use_bias,
                          device="cpu")
    load_jax_params(conv, np_params)
    x, adj, _, mask = graph_inputs(seed=1)
    mask = mask if with_mask else None
    want = jconv(params, jnp.asarray(x), jnp.asarray(adj),
                 None if mask is None else jnp.asarray(mask))
    with torch.no_grad():
        got = conv(torch.from_numpy(x), torch.from_numpy(adj),
                   None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("fuse", ["auto", ""])
def test_dense_gnn_with_edge_weights_matches_jax(fuse):
    """use_weights multiplies adj by the weights before the stack; a conv
    without bias takes a zero bias in the fused kernel."""
    jgnn = JaxDenseGNN([JaxDenseGraphConv(FIN, FOUT), jax.nn.relu,
                        JaxDenseGraphConv(FOUT, FOUT, use_bias=False)],
                       use_weights=True, fuse=fuse)
    params, np_params = jax_params(jgnn, seed=2)
    gnn = DenseGNN([DenseGraphConv(FIN, FOUT, device="cpu"), torch.relu,
                    DenseGraphConv(FOUT, FOUT, use_bias=False, device="cpu")],
                   use_weights=True, fuse=fuse)
    assert (gnn._fused_plan is not None) == bool(fuse)
    load_jax_params(gnn, np_params)
    x, adj, weights, _ = graph_inputs(seed=3)
    want = jgnn(params, jnp.asarray(x), jnp.asarray(adj),
                jnp.asarray(weights))
    with torch.no_grad():
        got = gnn(torch.from_numpy(x), torch.from_numpy(adj),
                  torch.from_numpy(weights))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("acts,expected", [
    ((torch.tanh, torch.relu), ("tanh", "relu")),
    ((nn.Tanh(), nn.ReLU()), ("tanh", "relu")),
    ((None, torch.tanh), (None, "tanh")),
    ((torch.sigmoid, None), None),   # not an activation the kernel has
])
def test_plan_conv_stack_recognises_activations(acts, expected):
    g = torch.Generator().manual_seed(0)
    layers = []
    for act in acts:
        layers.append(DenseGraphConv(FIN, FIN, device="cpu", generator=g))
        if act is not None:
            layers.append(act)
    plan = plan_conv_stack(layers)
    assert (None if plan is None else plan[1]) == expected
    fused, unfused = DenseGNN(layers), DenseGNN(layers, fuse="")
    x, adj, _, _ = graph_inputs(seed=4)
    with torch.no_grad():
        a = fused(torch.from_numpy(x), torch.from_numpy(adj))
        b = unfused(torch.from_numpy(x), torch.from_numpy(adj))
    torch.testing.assert_close(a, b, atol=ATOL, rtol=0)


def test_plan_conv_stack_keeps_mean_and_max_unfused():
    layers = [DenseGraphConv(FIN, FIN, aggr="mean", device="cpu"), torch.tanh]
    assert plan_conv_stack(layers) is None
    assert plan_conv_stack(layers, allowed_aggrs=("add", "mean"))[2] == (
        "mean",)
    assert DenseGNN(layers)._fused_plan is None


@pytest.mark.parametrize("fused_step", [True, False])
@pytest.mark.parametrize("direction", ["backward", "both"])
def test_temporal_backedge_directions_match_jax(monkeypatch, direction,
                                                fused_step):
    monkeypatch.setattr(jax_config, "DENSE_FUSED_STEP", fused_step)
    obs, hidden, hops, T = 4, 8, (1, 3), 24
    jmodel = JaxDenseGCM(
        JaxDenseGNN([JaxDenseGraphConv(hidden, hidden), jnp.tanh]),
        preprocessor=JaxMLP([JaxLinear(obs, hidden)]),
        edge_selectors=JaxTemporalBackedge(hops, direction=direction),
        graph_size=N)
    params, np_params = jax_params(jmodel, seed=5)
    model = DenseGCM(
        DenseGNN([DenseGraphConv(hidden, hidden, device="cpu"), torch.tanh]),
        preprocessor=MLP([Linear(obs, hidden, device="cpu")]),
        edge_selectors=TemporalBackedge(hops, direction=direction),
        graph_size=N, fused_step=fused_step, device="cpu")
    load_jax_params(model, np_params)
    rng = np.random.default_rng(6)
    xs = rng.standard_normal((B, T, obs)).astype(np.float32)
    dones = rng.random((B, T)) < 0.05
    want, want_state = jmodel.scan(params, xs, jmodel.initial_state(B, obs),
                                   dones=dones)
    with torch.no_grad():
        got, state = model.scan(torch.from_numpy(xs),
                                model.initial_state(B, obs),
                                dones=torch.from_numpy(dones))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    np.testing.assert_array_equal(state.adj.numpy(),
                                  np.asarray(want_state.adj))


def _fused_step_with_other_selector(m):
    model = DenseGCM(m.gnn, preprocessor=m.preprocessor,
                     edge_selectors=lambda nodes, adj, w, n: (adj, w),
                     graph_size=N, device="cpu")
    model(torch.zeros(1, 8), model.initial_state(1, 8))


@pytest.mark.parametrize("make", [
    lambda m: TemporalBackedge(learned=True),
    lambda m: m.scan(torch.zeros(1, 2, 8), m.initial_state(1, 8),
                     remat=True),
    lambda m: m.scan(torch.zeros(1, 2, 8), m.initial_state(1, 8), unroll=4),
    lambda m: DenseGCM(m.gnn, pooled=True, device="cpu"),
    _fused_step_with_other_selector,
], ids=["learned_edges", "remat", "unroll", "pooled", "other_selector"])
def test_unported_options_raise(make):
    from gcm_tpu_torch import readme_dense_gcm

    model = readme_dense_gcm(graph_size=N, device="cpu")
    with pytest.raises(NotImplementedError), torch.no_grad():
        make(model)


def test_reset_where_refuses_unregistered_state():
    from typing import NamedTuple

    class Other(NamedTuple):
        a: torch.Tensor

    with pytest.raises(TypeError, match="no episode reset"):
        reset_where(Other(torch.zeros(2)), torch.tensor([True, False]))
