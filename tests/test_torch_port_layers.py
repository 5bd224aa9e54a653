"""The port's layers on their own against the JAX package: DenseGraphConv's
three aggregations with and without bias and mask, DenseGCNConv (improved,
bias, mask, add_loop) alone and in a DenseGCM scan, conv_project, DenseGNN
with edge weights, the fused-stack planner, and TemporalBackedge's
directions and hops inside a DenseGCM scan. Same weights (`load_jax_params`), same numpy
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
from gcm_tpu.nn.dense_conv import DenseGCNConv as JaxDenseGCNConv
from gcm_tpu.nn.dense_conv import DenseGNN as JaxDenseGNN
from gcm_tpu.nn.dense_conv import DenseGraphConv as JaxDenseGraphConv
from gcm_tpu.nn.dense_conv import conv_project as jax_conv_project
from gcm_tpu.nn.module import MLP as JaxMLP
from gcm_tpu.nn.module import Linear as JaxLinear
from gcm_tpu_torch import (DenseGCM, DenseGCNConv, DenseGNN, DenseGraphConv,
                           MLP, Linear, TemporalBackedge, load_jax_params,
                           reset_where)
from gcm_tpu_torch.nn.dense_conv import conv_project, plan_conv_stack

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def one_step_a_loop_iteration(monkeypatch):
    """JAX's scans unrolled once: unrolling changes how XLA compiles the
    loop (and how long it takes), not what it computes."""
    for knob in ("SCAN_UNROLL", "DENSE_SCAN_UNROLL", "RING_SCAN_UNROLL"):
        monkeypatch.setattr(jax_config, knob, 1)

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


@pytest.mark.parametrize("improved", [False, True])
def test_dense_gcn_conv_matches_jax(improved):
    """DenseGCNConv with and without bias, mask and add_loop, on a 0/1 and
    a weighted adjacency with content on its diagonal (add_loop sets the
    diagonal; a node with no in-edges has its degree clamped to 1)."""
    x, adj, weights, mask = graph_inputs(seed=2)
    adj[:, 3, 3] = 1.0
    for i, (use_bias, with_mask, add_loop, weighted) in enumerate(
            [(b, m, a, w) for b in (True, False) for m in (False, True)
             for a in (True, False) for w in (False, True)]):
        case = (f"bias {use_bias}, mask {with_mask}, add_loop {add_loop}, "
                f"weighted {weighted}")
        jconv = JaxDenseGCNConv(FIN, FOUT, improved=improved,
                                use_bias=use_bias)
        params, np_params = jax_params(jconv, seed=i)
        if use_bias:  # a bias that is not zero
            params["bias"] = params["bias"] + 0.1 * (1 + jnp.arange(FOUT))
            np_params["bias"] = np.asarray(params["bias"])
        conv = DenseGCNConv(FIN, FOUT, improved=improved, use_bias=use_bias,
                            device="cpu")
        load_jax_params(conv, np_params)
        a = adj * weights if weighted else adj
        m = mask if with_mask else None
        want = jconv(params, jnp.asarray(x), jnp.asarray(a),
                     None if m is None else jnp.asarray(m), add_loop=add_loop)
        with torch.no_grad():
            got = conv(torch.from_numpy(x), torch.from_numpy(a),
                       None if m is None else torch.from_numpy(m),
                       add_loop=add_loop)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=0, err_msg=case)


def test_conv_project_matches_jax():
    """lin_rel(agg) + lin_root(h) [+ bias] [+ act] over [..., F] inputs of
    two and three leading dims, each activation, with and without bias."""
    rng = np.random.default_rng(3)
    for use_bias in (True, False):
        jconv = JaxDenseGraphConv(FIN, FOUT, use_bias=use_bias)
        params, np_params = jax_params(jconv, seed=4)
        conv = DenseGraphConv(FIN, FOUT, use_bias=use_bias, device="cpu")
        load_jax_params(conv, np_params)
        for shape in ((B, FIN), (B, N, FIN)):
            agg, h = (rng.standard_normal(shape).astype(np.float32)
                      for _ in range(2))
            for act in (None, "tanh", "relu"):
                want = jax_conv_project(params, jnp.asarray(agg),
                                        jnp.asarray(h), act)
                with torch.no_grad():
                    got = conv_project(conv, torch.from_numpy(agg),
                                       torch.from_numpy(h), act)
                np.testing.assert_allclose(
                    got.numpy(), np.asarray(want), atol=ATOL, rtol=0,
                    err_msg=f"bias {use_bias}, {shape}, {act}")


def test_dense_gcm_with_gcn_conv_matches_jax():
    """A DenseGNN of two DenseGCNConv + tanh runs layer by layer (no fused
    plan), in a DenseGCM scanned past its graph size with dones."""
    hidden, T = 8, 24
    jgnn = JaxDenseGNN([JaxDenseGCNConv(hidden, hidden), jnp.tanh,
                        JaxDenseGCNConv(hidden, hidden, improved=True),
                        jnp.tanh])
    jmodel = JaxDenseGCM(jgnn, preprocessor=JaxMLP([JaxLinear(FIN, hidden)]),
                         edge_selectors=JaxTemporalBackedge([1, 2]),
                         graph_size=N)
    params, np_params = jax_params(jmodel, seed=5)
    gnn = DenseGNN([DenseGCNConv(hidden, hidden, device="cpu"), torch.tanh,
                    DenseGCNConv(hidden, hidden, improved=True,
                                 device="cpu"), torch.tanh])
    assert gnn._fused_plan is None
    model = DenseGCM(gnn, preprocessor=MLP([Linear(FIN, hidden,
                                                   device="cpu")]),
                     edge_selectors=TemporalBackedge([1, 2]), graph_size=N,
                     device="cpu")
    load_jax_params(model, np_params)
    rng = np.random.default_rng(6)
    xs = rng.standard_normal((B, T, FIN)).astype(np.float32)
    dones = rng.random((B, T)) < 0.1
    want, jstate = jmodel.scan(params, xs, jmodel.initial_state(B, FIN),
                               dones=dones)
    with torch.no_grad():
        got, state = model.scan(torch.from_numpy(xs),
                                model.initial_state(B, FIN),
                                dones=torch.from_numpy(dones))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    np.testing.assert_array_equal(state.adj.numpy(), np.asarray(jstate.adj))


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
    """The fused step itself takes only the selectors it has a form for
    (forward() runs other selectors in the unfused step)."""
    model = DenseGCM(m.gnn, preprocessor=m.preprocessor,
                     edge_selectors=lambda nodes, adj, w, n: (adj, w),
                     graph_size=N, device="cpu")
    model._call_fused(torch.zeros(1, 8), model.initial_state(1, 8))


@pytest.mark.parametrize("make", [
    lambda m: m.scan(torch.zeros(1, 2, 8), m.initial_state(1, 8), unroll=4),
    _fused_step_with_other_selector,
], ids=["unroll", "other_selector"])
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
