"""The port's banded and clique fast cores (gcm_tpu_torch/models/banded_gcm.py,
models/clique_gcm.py) against the JAX package's, on the CPU.

The same weights (moved with `load_jax_params`) and the same numpy inputs
go through both. Each core's JAX scan and window run in one jitted call a
configuration, at the JAX tests' sizes: B = 3, N = 8, F = 4, T = 2N + 5
(the ring wraps twice), with and without episode ends.

- BandedRingGCM in all three directions (hops (1, 3) with a preprocessor,
  (1,), (1, 2) with mean aggregation): scan, and for the forward core
  window, against JAX.
- BandedScoredGCM with a windowed EuclideanEdge (B = 3: the window's
  cross-batch mean is taken per step, as JAX's vmap over time takes it),
  CosineEdge, SpatialEdge with a preprocessor, a learned scale, and
  temporal hops chained with a distance: scan and window against JAX, and
  the windowed Euclidean core against the port's DenseGCM with the same
  selector.
- CliqueGCM with one, two and three layers (mean in the last): scan and
  both window impls against JAX, chained windows equal to one scan, and the
  core against the port's DenseGCM with DenseEdge.
- remat=True equal to the plain scan in beliefs and gradients; the refused
  knobs; the state converters.

Tolerances: beliefs within 1e-5 of JAX (ATOL); the final state exactly
JAX's and exactly the port's own scan's (pure gathers in both). Gradients
are held in tests/test_torch_port_ring_window.py (the train steps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gcm_tpu.config as jax_config
from gcm_tpu.edges.distance import CosineEdge as JaxCosineEdge
from gcm_tpu.edges.distance import EuclideanEdge as JaxEuclideanEdge
from gcm_tpu.edges.distance import SpatialEdge as JaxSpatialEdge
from gcm_tpu.models.banded_gcm import BandedRingGCM as JaxBandedRingGCM
from gcm_tpu.models.banded_gcm import BandedScoredGCM as JaxBandedScoredGCM
from gcm_tpu.models.clique_gcm import CliqueGCM as JaxCliqueGCM
from gcm_tpu.nn.dense_conv import DenseGNN as JaxDenseGNN
from gcm_tpu.nn.dense_conv import DenseGraphConv as JaxDenseGraphConv
from gcm_tpu.nn.module import MLP as JaxMLP
from gcm_tpu.nn.module import Linear as JaxLinear
from gcm_tpu_torch import (MLP, BandedRingGCM, BandedScoredGCM, CliqueGCM,
                           CosineEdge, DenseEdge, DenseGCM, DenseGNN,
                           DenseGraphConv, EuclideanEdge, Linear,
                           SpatialEdge,
                           banded_scored_state_from_numpy,
                           banded_scored_state_to_numpy,
                           banded_state_from_numpy, banded_state_to_numpy,
                           load_jax_params)

torch.set_num_threads(1)

ATOL = 1e-5
F, B, N = 4, 3, 8
T = 2 * N + 5


@pytest.fixture(autouse=True)
def one_step_a_loop_iteration(monkeypatch):
    """JAX's scans unrolled once: unrolling changes how XLA compiles the
    loop (and how long it takes), not what it computes."""
    monkeypatch.setattr(jax_config, "SCAN_UNROLL", 1)


def t(a):
    return torch.from_numpy(np.array(a))


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def assert_close(got, want, msg, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=0, err_msg=msg)


def assert_state_equal(got, want, msg):
    for name, a, b in zip(got._fields, got, want):
        np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b),
                                      err_msg=f"{msg}: state.{name}")


def stacks(layers=2, aggr_last="add"):
    """(JAX DenseGNN, port DenseGNN): `layers` DenseGraphConv(F, F) + tanh,
    the last with aggregation `aggr_last`."""
    jl, pl = [], []
    for i in range(layers):
        aggr = aggr_last if i == layers - 1 else "add"
        jl += [JaxDenseGraphConv(F, F, aggr=aggr), jnp.tanh]
        pl += [DenseGraphConv(F, F, aggr=aggr, device="cpu"), torch.tanh]
    return JaxDenseGNN(jl), DenseGNN(pl)


def preprocessors(on):
    if not on:
        return None, None
    return JaxMLP([JaxLinear(F, F)]), MLP([Linear(F, F, device="cpu")])


def inputs(seed, scale=1.0):
    """xs [B, T, F] and dones [B, T]: episodes end at different steps, one
    element runs unbroken."""
    rng = np.random.default_rng(seed)
    xs = (scale * rng.standard_normal((B, T, F))).astype(np.float32)
    dones = np.zeros((B, T), bool)
    dones[0, 5] = dones[0, 14] = True
    dones[1, 11] = True
    return xs, dones


def jax_run(jmodel, params, xs, dones, window_kw=({},)):
    """JAX's scan and window(s) of one configuration, with and without
    dones, in one jitted call: {(kind, with_dones): (outs, state)}."""

    def run(params, xs, dones):
        out = {}
        for d, tag in ((None, False), (dones, True)):
            st = jmodel.initial_state(B, F)
            out[("scan", tag)] = jmodel.scan(params, xs, st, dones=d)
            for i, kw in enumerate(window_kw):
                if kw is not None:
                    out[(f"window{i}", tag)] = jmodel.window(
                        params, xs, st, dones=d, **kw)
        return out

    return jax.jit(run)(params, xs, dones)


def check_core(model, jmodel, params, xs, dones, msg, window_kw=({},)):
    """The port's scan and windows against JAX's, with and without dones;
    each final state exactly JAX's and the port scan's."""
    want = jax_run(jmodel, params, xs, dones, window_kw)
    load_jax_params(model, numpy_tree(params))
    with torch.no_grad():
        for d, tag in ((None, False), (dones, True)):
            dt = None if d is None else t(d)
            st0 = model.initial_state(B, F)
            outs, st = model.scan(t(xs), st0, dones=dt)
            m = f"{msg}, dones={tag}"
            assert_close(outs, want[("scan", tag)][0], f"{m}: scan")
            assert_state_equal(st, want[("scan", tag)][1], f"{m}: scan")
            for i, kw in enumerate(window_kw):
                if kw is None:
                    continue
                w_outs, w_st = model.window(t(xs), st0, dones=dt, **kw)
                assert_close(w_outs, want[(f"window{i}", tag)][0],
                             f"{m}: window {kw}")
                assert_state_equal(w_st, want[(f"window{i}", tag)][1],
                                   f"{m}: window {kw}")
                assert_state_equal(w_st, st, f"{m}: window {kw} vs scan")
                assert_close(w_outs, outs.numpy(), f"{m}: window vs scan")


@pytest.mark.parametrize("direction", ["forward", "backward", "both"])
def test_banded_ring_matches_jax(direction):
    hops, pre, aggr = {"forward": ((1, 3), True, "add"),
                       "backward": ((1,), False, "add"),
                       "both": ((1, 2), False, "mean")}[direction]
    jgnn, gnn = stacks(2, aggr)
    jpre, ppre = preprocessors(pre)
    jmodel = JaxBandedRingGCM(jgnn, preprocessor=jpre, hops=hops,
                              graph_size=N, direction=direction)
    model = BandedRingGCM(gnn, preprocessor=ppre, hops=hops, graph_size=N,
                          direction=direction, device="cpu")
    params = jmodel.init(jax.random.PRNGKey(0))
    xs, dones = inputs(1)
    check_core(model, jmodel, params, xs, dones, f"banded {direction}",
               window_kw=({},) if direction == "forward" else ())
    if direction != "forward":
        with pytest.raises(ValueError, match="forward-only"):
            model.window(t(xs), model.initial_state(B, F))


SCORED = {
    # name: (JAX distance, port distance, hops, window, preprocessor, scale)
    "euclidean": (lambda: JaxEuclideanEdge(1.0, window=3),
                  lambda: EuclideanEdge(1.0, window=3), (), None, False,
                  0.3),
    "cosine": (lambda: JaxCosineEdge(0.5), lambda: CosineEdge(0.5), (), 4,
               False, 1.0),
    "spatial": (lambda: JaxSpatialEdge(0.5, slice(0, 2),
                                       b_pose_slice=slice(2, 4)),
                lambda: SpatialEdge(0.5, slice(0, 2),
                                    b_pose_slice=slice(2, 4)),
                (), 3, True, 0.3),
    "learned_scale": (lambda: JaxEuclideanEdge(1.0, learned=True),
                      lambda: EuclideanEdge(1.0, learned=True, device="cpu"),
                      (), 3, False, 0.3),
    "temporal_chain": (lambda: JaxEuclideanEdge(1.0),
                       lambda: EuclideanEdge(1.0), (1, 2), 3, False, 0.3),
}


@pytest.mark.parametrize("name", list(SCORED))
def test_banded_scored_matches_jax(name):
    jdist, pdist, hops, window, pre, scale = SCORED[name]
    jgnn, gnn = stacks()
    jpre, ppre = preprocessors(pre)
    jmodel = JaxBandedScoredGCM(jgnn, distance=jdist(), preprocessor=jpre,
                                hops=hops, window=window, graph_size=N)
    model = BandedScoredGCM(gnn, distance=pdist(), preprocessor=ppre,
                            hops=hops, window=window, graph_size=N,
                            device="cpu")
    params = jmodel.init(jax.random.PRNGKey(2))
    if "distance" in params and params["distance"]:
        params["distance"] = {"dist_param": jnp.asarray([0.8], jnp.float32)}
    xs, dones = inputs(3, scale)
    check_core(model, jmodel, params, xs, dones, f"scored {name}")
    if name == "euclidean":
        # the port's DenseGCM with the same windowed selector: the same
        # beliefs (the band core's reason to exist)
        dense = DenseGCM(gnn, edge_selectors=EuclideanEdge(1.0, window=3),
                         graph_size=N, device="cpu")
        with torch.no_grad():
            want, _ = dense.scan(t(xs), dense.initial_state(B, F),
                                 dones=t(dones))
            got, _ = model.window(t(xs), model.initial_state(B, F),
                                  dones=t(dones))
        assert_close(got, want.numpy(), "scored window vs DenseGCM")


@pytest.mark.parametrize("layers,aggr_last", [(1, "add"), (2, "add"),
                                              (3, "mean")])
def test_clique_matches_jax(layers, aggr_last):
    jgnn, gnn = stacks(layers, aggr_last)
    jpre, ppre = preprocessors(layers == 2)
    jmodel = JaxCliqueGCM(jgnn, preprocessor=jpre, graph_size=N)
    model = CliqueGCM(gnn, preprocessor=ppre, graph_size=N, device="cpu")
    params = jmodel.init(jax.random.PRNGKey(layers))
    xs, dones = inputs(4 + layers)
    check_core(model, jmodel, params, xs, dones, f"clique L={layers}",
               window_kw=({"impl": "gather"}, {"impl": "proj"}))
    with torch.no_grad():
        # chained windows thread the state as one scan does
        want, want_st = model.scan(t(xs), model.initial_state(B, F))
        st = model.initial_state(B, F)
        outs = []
        for lo, hi, impl in ((0, 5, "gather"), (5, 13, "proj"),
                             (13, T, "gather")):
            o, st = model.window(t(xs[:, lo:hi]), st, impl=impl)
            outs.append(o)
        assert_close(torch.cat(outs, 1), want.numpy(), "chained windows")
        assert_state_equal(st, want_st, "chained windows")
        if layers == 2:
            # the port's DenseGCM with DenseEdge: the same beliefs
            dense = DenseGCM(gnn, preprocessor=ppre,
                             edge_selectors=DenseEdge(), graph_size=N,
                             device="cpu")
            got, _ = dense.scan(t(xs), dense.initial_state(B, F),
                                dones=t(dones))
            want, _ = model.window(t(xs), model.initial_state(B, F),
                                   dones=t(dones))
            assert_close(got, want.numpy(), "clique vs DenseGCM")


def test_fast_core_options():
    """remat=True: the plain scan's beliefs and gradients; refused knobs;
    the state converters round-trip."""
    xs, dones = inputs(9, 0.3)
    cores = {
        "banded": BandedRingGCM(stacks()[1], hops=(1,), graph_size=N,
                                device="cpu"),
        "scored": BandedScoredGCM(stacks()[1], distance=EuclideanEdge(1.0),
                                  hops=(1,), window=3, graph_size=N,
                                  device="cpu"),
        "clique": CliqueGCM(stacks()[1], graph_size=N, device="cpu"),
    }
    for name, model in cores.items():
        runs = []
        for remat in (False, True):
            model.zero_grad(set_to_none=True)
            outs, _ = model.scan(t(xs), model.initial_state(B, F),
                                 dones=t(dones), remat=remat)
            (outs ** 2).mean().backward()
            runs.append((outs.detach(),
                         [p.grad.clone() for p in model.parameters()]))
        torch.testing.assert_close(runs[1][0], runs[0][0], rtol=0, atol=0)
        for a, b in zip(runs[1][1], runs[0][1]):
            torch.testing.assert_close(a, b, rtol=0, atol=ATOL)
        st = model.initial_state(B, F)
        with pytest.raises(ValueError, match="remat"):
            model.scan(t(xs), st, remat="reverse")
        with pytest.raises(NotImplementedError, match="unroll"):
            model.scan(t(xs), st, unroll=2)
        # the card-measured gate: the window at every size, in either mode
        assert model.window_profitable("forward") and \
            model.window_profitable("train")
        with torch.no_grad():
            _, st = model.window(t(xs), st, dones=t(dones))
        conv = (banded_scored_state_from_numpy if name == "scored"
                else banded_state_from_numpy)
        back = (banded_scored_state_to_numpy if name == "scored"
                else banded_state_to_numpy)
        assert_state_equal(conv(back(st), "cpu"), back(st), name)
    with pytest.raises(ValueError, match="impl"):
        cores["clique"].window(t(xs), cores["clique"].initial_state(B, F),
                               impl="dense")
    with pytest.raises(ValueError, match="hops must fit"):
        BandedScoredGCM(stacks()[1], hops=(4,), window=3, device="cpu")
    with pytest.raises(ValueError, match="DenseGraphConv"):
        CliqueGCM(DenseGNN([DenseGraphConv(F, F, aggr="max",
                                           device="cpu")]), device="cpu")
    with pytest.raises(ValueError, match="candidate window"):
        BandedScoredGCM(stacks()[1], distance=EuclideanEdge(1.0),
                        device="cpu")
