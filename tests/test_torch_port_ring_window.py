"""The port's ring window (gcm_tpu_torch/models/ring_window.py,
RingDenseGCM.window) and the window and trajectory train steps
(train/train_step.py) against the JAX package's, on the CPU.

The same weights (moved with `load_jax_params`) and the same numpy inputs
go through both; JAX's side runs jitted, its scans unrolled once.

- The ring window from a warm state (t0 = 3, so the chunks do not start
  at slot 0), B = 3, N = 8, F = 4, T = 2N + 5, for every selector
  `window_supported` takes: forward TemporalBackedge, EuclideanEdge (with
  mean aggregation and a preprocessor), a learned-scale EuclideanEdge,
  CosineEdge (one layer), SpatialEdge, deterministic LearnedEdge, an
  EdgeChain, no selector. A forced chunk of 5 against JAX's, and the
  automatic chunk against the port's own scan. Beliefs within 1e-5, the
  final state (nodes, adjacency, t) exactly JAX's and the scan's.
- The fallback: with dones, or a structure the window refuses (each
  refusal checked against JAX's `window_supported`), `window` is `scan`;
  the gates and `window_applicable`; the CPU chunk cap.
- make_window_supervised_step on each fast core (with episode ends where
  the core's window takes them) and on the ring, and
  make_trajectory_supervised_step taking the window branch and the scan
  branch (remat=True) by the training gate, each against
  jax.value_and_grad and one optax.adam step: loss 1e-5, gradients and
  updated parameters within 1e-4, with the ZERO_GRAD rule (a gradient zero
  up to rounding on one side is such a zero on the other; Adam's update of
  it is the sign of that rounding).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import gcm_tpu.config as jax_config
from gcm_tpu.edges.chain import EdgeChain as JaxEdgeChain
from gcm_tpu.edges.distance import CosineEdge as JaxCosineEdge
from gcm_tpu.edges.distance import EuclideanEdge as JaxEuclideanEdge
from gcm_tpu.edges.distance import SpatialEdge as JaxSpatialEdge
from gcm_tpu.edges.learned import LearnedEdge as JaxLearnedEdge
from gcm_tpu.edges.temporal import TemporalBackedge as JaxTemporalBackedge
from gcm_tpu.models.banded_gcm import BandedRingGCM as JaxBandedRingGCM
from gcm_tpu.models.banded_gcm import BandedScoredGCM as JaxBandedScoredGCM
from gcm_tpu.models.clique_gcm import CliqueGCM as JaxCliqueGCM
from gcm_tpu.models.ring_gcm import RingDenseGCM as JaxRingDenseGCM
from gcm_tpu.models.ring_window import ring_window as jax_ring_window
from gcm_tpu.models.ring_window import \
    window_supported as jax_window_supported
from gcm_tpu.nn.dense_conv import DenseGNN as JaxDenseGNN
from gcm_tpu.nn.dense_conv import DenseGraphConv as JaxDenseGraphConv
from gcm_tpu.nn.module import MLP as JaxMLP
from gcm_tpu.nn.module import Linear as JaxLinear
from gcm_tpu.train.train_step import \
    make_trajectory_supervised_step as jax_trajectory_step
from gcm_tpu_torch import (MLP, BandedRingGCM, BandedScoredGCM, CliqueGCM,
                           CosineEdge, DenseGCM, DenseGNN, DenseGraphConv,
                           EdgeChain, EuclideanEdge, LearnedEdge, Linear,
                           RingDenseGCM, SpatialEdge, TemporalBackedge,
                           load_jax_params, make_trajectory_supervised_step,
                           make_window_supervised_step, named_from_jax,
                           ring_state_from_numpy, ring_state_to_numpy)
from gcm_tpu_torch.models import ring_window

torch.set_num_threads(1)

ATOL, GRAD_ATOL = 1e-5, 1e-4
ZERO_GRAD = 1e-7  # a gradient that is zero up to float32 rounding
LR = 1e-3
F, B, N = 4, 3, 8
T = 2 * N + 5
WARM = 3


@pytest.fixture(autouse=True)
def one_step_a_loop_iteration(monkeypatch):
    """JAX's scans unrolled once: unrolling changes how XLA compiles the
    loop (and how long it takes), not what it computes."""
    for knob in ("SCAN_UNROLL", "DENSE_SCAN_UNROLL", "RING_SCAN_UNROLL"):
        monkeypatch.setattr(jax_config, knob, 1)


def t(a):
    return torch.from_numpy(np.array(a))


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def assert_close(got, want, msg, atol=ATOL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=0,
                               err_msg=msg)


def assert_state_equal(got, want, msg):
    for name, a, b in zip(got._fields, got, want):
        a = a.detach().numpy() if torch.is_tensor(a) else np.asarray(a)
        np.testing.assert_array_equal(a, np.asarray(b),
                                      err_msg=f"{msg}: state.{name}")


def stacks(layers=2, aggr="add"):
    jl, pl = [], []
    for _ in range(layers):
        jl += [JaxDenseGraphConv(F, F, aggr=aggr), jnp.tanh]
        pl += [DenseGraphConv(F, F, aggr=aggr, device="cpu"), torch.tanh]
    return JaxDenseGNN(jl), DenseGNN(pl)


def preprocessors(on):
    if not on:
        return {}, {}
    return ({"preprocessor": JaxMLP([JaxLinear(F, F)])},
            {"preprocessor": MLP([Linear(F, F, device="cpu")])})


SELECTORS = {
    # name: (JAX selector, port selector, input scale, layers, aggr, pre)
    "temporal": (lambda: JaxTemporalBackedge([1, 3]),
                 lambda: TemporalBackedge([1, 3]), 1.0, 2, "add", False),
    "euclidean": (lambda: JaxEuclideanEdge(1.0),
                  lambda: EuclideanEdge(1.0), 0.3, 2, "mean", True),
    "euclidean_learned": (
        lambda: JaxEuclideanEdge(1.0, learned=True),
        lambda: EuclideanEdge(1.0, learned=True, device="cpu"), 0.3, 2,
        "add", False),
    "cosine": (lambda: JaxCosineEdge(0.5), lambda: CosineEdge(0.5), 1.0, 1,
               "add", False),
    "spatial": (lambda: JaxSpatialEdge(0.5, slice(0, 2),
                                       b_pose_slice=slice(2, 4)),
                lambda: SpatialEdge(0.5, slice(0, 2),
                                    b_pose_slice=slice(2, 4)),
                0.3, 2, "add", False),
    "learned": (lambda: JaxLearnedEdge(F, deterministic=True),
                lambda: LearnedEdge(F, deterministic=True, device="cpu"),
                1.0, 2, "add", False),
    "chain": (lambda: JaxEdgeChain([JaxTemporalBackedge([1]),
                                    JaxEuclideanEdge(1.0)]),
              lambda: EdgeChain([TemporalBackedge([1]),
                                 EuclideanEdge(1.0)]), 0.3, 2, "add", False),
    "none": (lambda: None, lambda: None, 1.0, 2, "add", True),
}


def ring_pair(name, seed=0):
    jsel, psel, scale, layers, aggr, pre = SELECTORS[name]
    jgnn, gnn = stacks(layers, aggr)
    jpre, ppre = preprocessors(pre)
    jmodel = JaxRingDenseGCM(jgnn, edge_selectors=jsel(), graph_size=N,
                             **jpre)
    model = RingDenseGCM(gnn, edge_selectors=psel(), graph_size=N,
                         device="cpu", **ppre)
    params = jmodel.init(jax.random.PRNGKey(seed))
    load_jax_params(model, numpy_tree(params))
    return jmodel, params, model, scale


@pytest.mark.parametrize("name", list(SELECTORS))
def test_ring_window_matches_jax(name):
    jmodel, params, model, scale = ring_pair(name)
    rng = np.random.default_rng(len(name))
    warm = (scale * rng.standard_normal((B, WARM, F))).astype(np.float32)
    xs = (scale * rng.standard_normal((B, T, F))).astype(np.float32)
    with torch.no_grad():
        _, st0 = model.scan(t(warm), model.initial_state(B, F))
        np_st0 = ring_state_to_numpy(st0)
        want, want_st = jax.jit(
            lambda p, x, s: jax_ring_window(jmodel, p, x, s, chunk=5))(
                params, xs, type(jmodel.initial_state(1, F))(*np_st0))
        got, got_st = model.window(t(xs), ring_state_from_numpy(np_st0,
                                                                "cpu"),
                                   chunk=5)
        assert_close(got, want, f"{name}: window, chunk 5")
        assert_state_equal(got_st, want_st, f"{name}: window, chunk 5")
        scan, scan_st = model.scan(t(xs), st0)
        auto, auto_st = model.window(t(xs), st0)
        assert_close(auto, scan.numpy(), f"{name}: window vs scan")
        assert_state_equal(auto_st, scan_st, f"{name}: window vs scan")
        assert_state_equal(got_st, scan_st, f"{name}: chunk 5 vs scan")
    assert model.window_applicable() and jax_window_supported(jmodel)


def test_ring_window_fallback_gates_and_chunks():
    """dones and the structures the window refuses take the scan (each
    refusal as JAX's window_supported gives it); the gates answer as their
    constants; the CPU chunk cap."""
    jgnn, gnn = stacks()
    jgnn3, gnn3 = stacks(3)
    cases = {
        "windowed distance": (
            dict(edge_selectors=JaxEuclideanEdge(1.0, window=3)),
            dict(edge_selectors=EuclideanEdge(1.0, window=3))),
        "backward temporal": (
            dict(edge_selectors=JaxTemporalBackedge(
                [1], direction="backward")),
            dict(edge_selectors=TemporalBackedge([1],
                                                 direction="backward"))),
        "learned temporal": (
            dict(edge_selectors=JaxTemporalBackedge(
                learned=True, deterministic=True, learning_window=4)),
            dict(edge_selectors=TemporalBackedge(
                learned=True, deterministic=True, learning_window=4,
                device="cpu"))),
        "stochastic learned": (
            dict(edge_selectors=JaxLearnedEdge(F)),
            dict(edge_selectors=LearnedEdge(F, device="cpu"))),
        "aux selectors": (
            dict(edge_selectors=JaxTemporalBackedge([1]),
                 aux_edge_selectors=JaxCosineEdge(0.5)),
            dict(edge_selectors=TemporalBackedge([1]),
                 aux_edge_selectors=CosineEdge(0.5))),
        "pooled": (dict(pooled=True), dict(pooled=True)),
        "edge weights": (dict(edge_weights=True), dict(edge_weights=True)),
    }
    rng = np.random.default_rng(0)
    xs = t((0.3 * rng.standard_normal((B, 6, F))).astype(np.float32))
    for name, (jkw, pkw) in cases.items():
        jmodel = JaxRingDenseGCM(jgnn, graph_size=N, **jkw)
        model = RingDenseGCM(gnn, graph_size=N, device="cpu", **pkw)
        assert not jax_window_supported(jmodel), name
        assert not ring_window.window_supported(model), name
        assert not model.window_applicable(), name
        gen = torch.Generator().manual_seed(1)
        noise = [model.step_noise(B, gen) for _ in range(6)]
        with torch.no_grad():
            if name == "stochastic learned":
                want = model.scan(xs, model.initial_state(B, F),
                                  noise=noise)
                with pytest.raises(ValueError, match="generator"):
                    model.window(xs, model.initial_state(B, F))
                continue
            want = model.scan(xs, model.initial_state(B, F))
            got = model.window(xs, model.initial_state(B, F))
        assert_state_equal(got[1], want[1], name)
        assert_close(got[0], want[0].numpy(), name, atol=0)
        with pytest.raises(ValueError, match="unsupported"):
            ring_window.ring_window(model, xs, model.initial_state(B, F))
    three = RingDenseGCM(gnn3, edge_selectors=EuclideanEdge(1.0),
                         graph_size=N, device="cpu")
    assert not ring_window.window_supported(three)
    assert not jax_window_supported(JaxRingDenseGCM(
        jgnn3, edge_selectors=JaxEuclideanEdge(1.0), graph_size=N))

    model = RingDenseGCM(gnn, edge_selectors=EuclideanEdge(1.0),
                         graph_size=N, device="cpu")
    dones = t(rng.random((B, 6)) < 0.3)
    with torch.no_grad():
        want = model.scan(xs, model.initial_state(B, F), dones=dones)
        got = model.window(xs, model.initial_state(B, F), dones=dones)
    assert not model.window_applicable(dones=dones)
    assert_state_equal(got[1], want[1], "dones")
    # the card-measured gate: the window at every size, in either mode
    assert model.window_profitable("forward") and model.window_profitable(
        "train")
    # the CPU cap: c * (N + c) * B * F_wide * 4 <= CPU_CHUNK_BYTES, the
    # largest multiple of 8 (EuclideanEdge widens F_wide to B where B > F)
    for Bc, n, fwide in ((8, 1024, 32), (48, 512, 48)):
        big = RingDenseGCM(DenseGNN([DenseGraphConv(32, 32, device="cpu"),
                                     torch.tanh] * 2),
                           edge_selectors=EuclideanEdge(1.0), graph_size=n,
                           device="cpu")
        c = ring_window.max_chunk_len(big, Bc, 8)
        assert 16 <= c < n and c % 8 == 0, c
        per = Bc * fwide * 4
        assert c * (n + c) * per <= ring_window.CPU_CHUNK_BYTES
        assert (c + 8) * (n + c + 8) * per > ring_window.CPU_CHUNK_BYTES
    assert ring_window.max_chunk_len(model, B, F) == N


# -- the train steps ------------------------------------------------------------

def compare_step(model, params, jax_loss, torch_step, batch, msg):
    """The port's step against jax.value_and_grad of the same loss and one
    optax.adam update (see the module docstring)."""

    def jax_step(params, *batch):
        loss, grads = jax.value_and_grad(jax_loss)(params, *batch)
        opt = optax.adam(LR)
        updates, _ = opt.update(grads, opt.init(params), params)
        return loss, grads, optax.apply_updates(params, updates)

    loss, grads, new_params = jax.jit(jax_step)(params, *batch)
    got = torch_step(*(t(a) for a in batch))
    assert_close(got, loss, f"{msg}: loss")
    want_grads = named_from_jax(model, numpy_tree(grads))
    want_params = named_from_jax(model, numpy_tree(new_params))
    named = dict(model.named_parameters())
    assert set(named) == set(want_grads), msg
    for name, p in named.items():
        grad = p.grad if p.grad is not None else torch.zeros_like(p)
        assert_close(grad, want_grads[name], f"{msg}: grad of {name}",
                     atol=GRAD_ATOL)
        if float(want_grads[name].abs().max()) < ZERO_GRAD:
            assert float(grad.abs().max()) < ZERO_GRAD, f"{msg}: {name}"
            continue
        assert_close(p, want_params[name], f"{msg}: {name} after Adam",
                     atol=GRAD_ATOL)


def fast_pair(name):
    """(JAX core, port core, window kwargs, takes dones)."""
    jgnn, gnn = stacks()
    jpre, ppre = preprocessors(True)
    if name == "banded":
        return (JaxBandedRingGCM(jgnn, hops=(1, 2), graph_size=N, **jpre),
                BandedRingGCM(gnn, hops=(1, 2), graph_size=N, device="cpu",
                              **ppre), {}, True)
    if name == "scored":
        return (JaxBandedScoredGCM(jgnn, distance=JaxEuclideanEdge(
                    1.0, learned=True), hops=(1,), window=3, graph_size=N,
                    **jpre),
                BandedScoredGCM(gnn, distance=EuclideanEdge(
                    1.0, learned=True, device="cpu"), hops=(1,), window=3,
                    graph_size=N, device="cpu", **ppre), {}, True)
    if name.startswith("clique"):
        impl = name.split("_")[1]
        return (JaxCliqueGCM(jgnn, graph_size=N, **jpre),
                CliqueGCM(gnn, graph_size=N, device="cpu", **ppre),
                {"impl": impl}, True)
    jmodel, _, model, _ = ring_pair("euclidean")
    return jmodel, model, {}, False


@pytest.mark.parametrize("name", ["banded", "scored", "clique_gather",
                                  "clique_proj", "ring"])
def test_window_step_matches_optax(name):
    jmodel, model, kw, with_dones = fast_pair(name)
    params = jmodel.init(jax.random.PRNGKey(3))
    load_jax_params(model, numpy_tree(params))
    rng = np.random.default_rng(4)
    xs = (0.3 * rng.standard_normal((B, T, F))).astype(np.float32)
    targets = rng.standard_normal((B, T, F)).astype(np.float32)
    dones = np.zeros((B, T), bool)
    if with_dones:
        dones[0, 6] = dones[2, 15] = True

    def jax_loss(params, xs, targets, dones):
        st = jmodel.initial_state(B, F)
        outs, _ = jmodel.window(params, xs, st,
                                dones=dones if with_dones else None, **kw)
        return jnp.mean((outs - targets) ** 2)

    step = make_window_supervised_step(
        model, torch.optim.Adam(model.parameters(), lr=LR), **kw)
    compare_step(model, params, jax_loss,
                 lambda xs, tg, d: step(xs, tg, d if with_dones else None),
                 (xs, targets, dones), f"window step {name}")


@pytest.mark.parametrize("branch", ["window", "scan"])
def test_trajectory_step_matches_optax(monkeypatch, branch):
    """The ring core's trajectory step: the training gate (the port's
    answer and JAX's constant set alike) picks the window, or the scan with
    remat=True; both steps take the same branch."""
    monkeypatch.setattr(RingDenseGCM, "window_profitable",
                        lambda self, mode="forward": branch == "window")
    monkeypatch.setattr(jax_config, "RING_WINDOW_TRAIN_MIN_N",
                        N if branch == "window" else N + 1)
    jmodel, params, model, _ = ring_pair("euclidean", seed=5)
    remat = branch == "scan"
    jstep = jax_trajectory_step(jmodel, optax.adam(LR), remat=remat)
    step = make_trajectory_supervised_step(
        model, torch.optim.Adam(model.parameters(), lr=LR), remat=remat)
    assert step.use_window == (branch == "window")
    rng = np.random.default_rng(6)
    xs = (0.3 * rng.standard_normal((B, T, F))).astype(np.float32)
    targets = rng.standard_normal((B, T, F)).astype(np.float32)

    def jax_loss(params, xs, targets):
        st = jmodel.initial_state(B, F)
        if branch == "window":
            outs, _ = jmodel.window(params, xs, st)
        else:
            outs, _ = jmodel.scan(params, xs, st, remat=True)
        return jnp.mean((outs - targets) ** 2)

    # JAX's own step takes the same branch: its update is the one held
    new_params, _, loss = jax.jit(jstep)(params, optax.adam(LR).init(params),
                                         xs, targets)
    compare_step(model, params, jax_loss, step, (xs, targets),
                 f"trajectory step, {branch}")
    assert_close(t(np.asarray(loss)), loss, "JAX step loss")
    want = named_from_jax(model, numpy_tree(new_params))
    for name, p in model.named_parameters():
        if p.grad is not None and float(p.grad.abs().max()) >= ZERO_GRAD:
            assert_close(p, want[name], f"{branch}: {name} vs JAX's step",
                         atol=GRAD_ATOL)
    if branch == "scan":
        with pytest.raises(NotImplementedError, match="reverse"):
            make_trajectory_supervised_step(model, torch.optim.Adam(
                model.parameters()), remat="reverse")(t(xs), t(targets))
    # a core with no window takes the scan; a banded core its window
    dense = DenseGCM(stacks()[1], graph_size=N, device="cpu")
    assert not make_trajectory_supervised_step(
        dense, torch.optim.Adam(dense.parameters())).use_window
    banded = BandedRingGCM(stacks()[1], graph_size=N, device="cpu")
    assert make_trajectory_supervised_step(
        banded, torch.optim.Adam(banded.parameters())).use_window
