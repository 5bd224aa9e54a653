"""The port's reversible scans (gcm_tpu_torch/models/ring_reversible.py,
dense_reversible.py) against the JAX package's, on the CPU.

The README DenseGCM's weights in both frameworks' ring and dense cores, a
warm, unaligned start (the ring's cursor off slot 0, the dense buffer
about to wrap) and T = 2N + 3 steps: JAX's `reversible_scan` /
`dense_reversible_scan` under jax.value_and_grad against the port's
`scan(remat="reverse")` under autograd, for TemporalBackedge and a chain
of it and a deterministic LearnedEdge (spardmax: 1e-4).
- outputs and the final state within 1e-5 (1e-4 where spardmax decides
  the edges); gradients with respect to the parameters, the inputs and the
  initial state within 1e-4 absolute and 1e-4 relative (JAX's own test
  tolerance, tests/test_ring_reversible.py);
- the port's reversible forward bitwise equal to its own scan, its
  gradients those of remat=False;
- a stochastic selector replayed from the same noise (JAX's Gumbel noise
  for the ring, the port's own for both cores);
- the supported gates against JAX's, and ValueError on dones and edge
  weights;
- make_trajectory_supervised_step(remat="reverse") against JAX's step
  with optax.adam.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import gcm_tpu.config as jax_config
from gcm_tpu.edges.chain import EdgeChain as JaxEdgeChain
from gcm_tpu.edges.learned import LearnedEdge as JaxLearnedEdge
from gcm_tpu.edges.temporal import TemporalBackedge as JaxTemporalBackedge
from gcm_tpu.models.dense_gcm import DenseGCM as JaxDenseGCM
from gcm_tpu.models.dense_reversible import \
    dense_reversible_scan as jax_dense_reversible_scan
from gcm_tpu.models.dense_reversible import \
    dense_reversible_supported as jax_dense_reversible_supported
from gcm_tpu.models.presets import readme_dense_gcm as jax_readme_dense_gcm
from gcm_tpu.models.ring_gcm import RingDenseGCM as JaxRingDenseGCM
from gcm_tpu.models.ring_reversible import \
    reversible_scan as jax_reversible_scan
from gcm_tpu.models.ring_reversible import \
    reversible_supported as jax_reversible_supported
from gcm_tpu.train.train_step import \
    make_trajectory_supervised_step as jax_trajectory_step
from gcm_tpu_torch import (DenseGCM, EdgeChain, LearnedEdge, RingDenseGCM,
                           TemporalBackedge, load_jax_params,
                           make_trajectory_supervised_step, named_from_jax,
                           readme_dense_gcm, ring_state_from_numpy,
                           state_from_numpy)
from gcm_tpu_torch.models.dense_reversible import (_DenseSpec,
                                                   dense_reversible_supported)
from gcm_tpu_torch.models.ring_reversible import (_RingSpec,
                                                  reversible_supported)

torch.set_num_threads(1)

ATOL, ATOL_SPARDMAX = 1e-5, 1e-4
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)  # tests/test_ring_reversible.py's
OBS, HIDDEN, B, G = 4, 8, 3, 8
T = 2 * G + 3
WARM = 5  # the ring's cursor starts at slot 5; the dense buffer fills at 8
LR = 1e-3
ZERO_GRAD = 1e-7  # a gradient that is zero up to float32 rounding


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


SELECTORS = {
    # name: (JAX selector, port selector, belief tolerance)
    "temporal": (lambda: JaxTemporalBackedge([1, 2]),
                 lambda: TemporalBackedge([1, 2]), ATOL),
    "chain": (lambda: JaxEdgeChain([JaxTemporalBackedge([1]),
                                    JaxLearnedEdge(OBS, deterministic=True)]),
              lambda: EdgeChain([TemporalBackedge([1]), LearnedEdge(
                  OBS, deterministic=True, device="cpu")]), ATOL_SPARDMAX),
    "stochastic": (lambda: JaxLearnedEdge(OBS),
                   lambda: LearnedEdge(OBS, device="cpu"), ATOL),
}
CORES = {"ring": (JaxRingDenseGCM, RingDenseGCM, jax_reversible_scan,
                  ring_state_from_numpy),
         "dense": (JaxDenseGCM, DenseGCM, jax_dense_reversible_scan,
                   state_from_numpy)}


@functools.cache
def jax_base():
    jbase = jax_readme_dense_gcm(obs_size=OBS, hidden=HIDDEN, graph_size=G)
    return jbase, jax.jit(jbase.init)(jax.random.PRNGKey(1))


def model_pair(kind, name, **kw):
    """JAX's and the port's core of `kind` with the README weights and the
    named selector."""
    jcls, cls = CORES[kind][:2]
    jbase, base_params = jax_base()
    base = readme_dense_gcm(obs_size=OBS, hidden=HIDDEN, graph_size=G,
                            device="cpu")
    jsel, sel, atol = SELECTORS[name]
    jsel, sel = jsel(), sel()
    jmodel = jcls(jbase.gnn, preprocessor=jbase.preprocessor,
                  edge_selectors=jsel, graph_size=G, **kw)
    model = cls(base.gnn, preprocessor=base.preprocessor,
                edge_selectors=sel, graph_size=G, device="cpu", **kw)
    params = {"gnn": base_params["gnn"],
              "preprocessor": base_params["preprocessor"],
              "edge_selectors": jsel.init(jax.random.PRNGKey(2))}
    load_jax_params(model, numpy_tree(params))
    return jmodel, params, model, atol


@functools.cache
def inputs(seed):
    """(warm-up xs [B, WARM, OBS], xs [B, T, OBS], the loss's projections
    of the outputs, final nodes and final adjacency)."""
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.standard_normal((B, WARM, OBS)).astype(f),
            rng.standard_normal((B, T, OBS)).astype(f),
            rng.standard_normal((B, T, HIDDEN)).astype(f),
            rng.standard_normal((B, G, OBS)).astype(f),
            rng.standard_normal((B, G, G)).astype(f))


def warm_state(jmodel, params, warm, key=None):
    """JAX's state after the warm-up steps (the port starts from it)."""
    st = jmodel.initial_state(B, OBS)
    return jax.jit(lambda p, x, k: jmodel.scan(p, x, st, key=k, unroll=1)[1])(
        params, warm, key)


def jax_run(kind, jmodel, params, xs, st0, proj, key=None):
    """JAX's reversible scan: (outs, final state, loss, grads of (params,
    xs, nodes0, adj0)) of sum(outs * w_o) + sum(nodes_T * w_n) +
    sum(adj_T * w_a)."""
    scan = CORES[kind][2]
    w_o, w_n, w_a = proj

    def loss(p, x, nodes, adj):
        outs, st = scan(jmodel, p, x, st0._replace(nodes=nodes, adj=adj),
                        key=key)
        return (jnp.sum(outs * w_o) + jnp.sum(st.nodes * w_n)
                + jnp.sum(st.adj * w_a)), (outs, st)

    (val, (outs, st)), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2, 3), has_aux=True))(params, xs, st0.nodes,
                                                    st0.adj)
    return outs, st, val, grads


def port_run(model, xs, st0, proj, remat, noise=None):
    """The port's scan under autograd: (outs, final state, loss, {name:
    grad}, grad of xs, grads of nodes0 and adj0)."""
    x = t(xs).requires_grad_()
    nodes = st0.nodes.clone().requires_grad_()
    adj = st0.adj.clone().requires_grad_()
    model.zero_grad(set_to_none=True)
    outs, st = model.scan(x, st0._replace(nodes=nodes, adj=adj), remat=remat,
                          noise=noise)
    w_o, w_n, w_a = (t(p) for p in proj)
    loss = (outs * w_o).sum() + (st.nodes * w_n).sum() + (st.adj * w_a).sum()
    loss.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()
             if p.grad is not None}
    return outs.detach(), st, loss.detach(), grads, x.grad, nodes.grad, \
        adj.grad


def check_against_jax(kind, name, seed, key=None, noise=None):
    jmodel, params, model, atol = model_pair(kind, name)
    warm, xs, *proj = inputs(seed)
    jst0 = warm_state(jmodel, params, warm,
                      None if key is None else jax.random.fold_in(key, 1))
    st0 = CORES[kind][3](numpy_tree(jst0), "cpu")
    jouts, jst, jval, jgrads = jax_run(kind, jmodel, params, xs, jst0, proj,
                                       key)
    outs, st, val, grads, gx, gn, ga = port_run(model, xs, st0, proj,
                                                "reverse", noise)
    label = f"{kind} {name}"
    np.testing.assert_allclose(outs.numpy(), np.asarray(jouts), atol=atol,
                               rtol=0, err_msg=f"{label}: outputs")
    for a, b, field in zip(st, jst, st._fields):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   atol=atol, rtol=0,
                                   err_msg=f"{label}: state.{field}")
    want = named_from_jax(model, numpy_tree(jgrads[0]))
    assert set(grads) <= set(want)
    for n, g in want.items():
        np.testing.assert_allclose(grads.get(n, torch.zeros_like(g)).numpy(),
                                   g.numpy(), **GRAD_TOL,
                                   err_msg=f"{label}: d{n}")
    for got, jg, what in ((gx, jgrads[1], "xs"), (gn, jgrads[2], "nodes0"),
                          (ga, jgrads[3], "adj0")):
        np.testing.assert_allclose(got.numpy(), np.asarray(jg), **GRAD_TOL,
                                   err_msg=f"{label}: d{what}")
    # the port's reversible forward is its scan's, bitwise; the gradients
    # are remat=False's
    plain = port_run(model, xs, st0, proj, False, noise)
    np.testing.assert_array_equal(outs.numpy(), plain[0].numpy())
    for a, b in zip(st, plain[1]):
        np.testing.assert_array_equal(a.detach().numpy(),
                                      b.detach().numpy())
    for n, g in plain[3].items():
        np.testing.assert_allclose(grads[n].numpy(), g.numpy(), atol=1e-6,
                                   rtol=1e-5, err_msg=f"{label}: {n}")
    for a, b in zip((gx, gn, ga), plain[4:]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6,
                                   rtol=1e-5, err_msg=label)


@pytest.mark.parametrize("kind", ["ring", "dense"])
def test_reversible_scan_matches_jax(kind):
    """Both deterministic selectors from a warm, unaligned start: outputs,
    final state and every gradient against JAX's reversible scan, and the
    port's own scan bitwise."""
    for i, name in enumerate(("temporal", "chain")):
        check_against_jax(kind, name, seed=10 * i + len(kind))


def jax_ring_noise(jmodel, key):
    """The Gumbel noise JAX's ring draws at each step from the reversible
    scan's per-step keys (its key splits replayed): a LearnedEdge's [B, G]
    from the step key's edge-selector split."""
    out = []
    for k in jax.random.split(key, T):
        _, sub = jax.random.split(k)
        out.append({"edge_selectors": t(jax.random.gumbel(sub, (B, G),
                                                          jnp.float32)),
                    "aux_edge_selectors": None})
    return out


def test_stochastic_selector_replays_the_noise():
    """A stochastic LearnedEdge: the ring against JAX's reversible scan
    with a key, the port taking JAX's Gumbel noise; both cores' reverse
    scans against their own scans on the same noise from a generator."""
    key = jax.random.PRNGKey(5)
    jmodel, _, _, _ = model_pair("ring", "stochastic")
    check_against_jax("ring", "stochastic", seed=3, key=key,
                      noise=jax_ring_noise(jmodel, key))
    for kind in ("ring", "dense"):
        _, _, model, _ = model_pair(kind, "stochastic")
        _, xs, *proj = inputs(4)
        gen = torch.Generator().manual_seed(9)
        noise = [model.step_noise(B, gen) for _ in range(T)]
        st0 = model.initial_state(B, OBS)
        rev = port_run(model, xs, st0, proj, "reverse", noise)
        plain = port_run(model, xs, st0, proj, False, noise)
        np.testing.assert_array_equal(rev[0].numpy(), plain[0].numpy())
        for n, g in plain[3].items():
            np.testing.assert_allclose(rev[3][n].numpy(), g.numpy(),
                                       atol=1e-6, rtol=1e-5,
                                       err_msg=f"{kind}: {n}")


class _Custom(torch.nn.Module):
    """A selector with no fused form."""


def test_gates_and_refusals():
    """reversible_supported / dense_reversible_supported answer as JAX's
    on each configuration, and scan(remat="reverse") raises ValueError
    naming what fails (dones, edge weights, a selector with no fused
    step) instead of running another scan; each step's residuals are
    rows of their own, no views of the state."""
    cases = []
    for kind in ("ring", "dense"):
        jmodel, _, model, _ = model_pair(kind, "temporal")
        cases.append((jmodel, model, None))
        cases.append((jmodel, model, True))
        jw, _, mw, _ = model_pair(kind, "temporal", edge_weights=True)
        cases.append((jw, mw, None))
    jmodel, _, model, _ = model_pair("dense", "temporal")
    jmodel.edge_selectors, model.edge_selectors = _Custom(), _Custom()
    cases.append((jmodel, model, None))
    for jm, m, dones in cases:
        for port_fn, jax_fn in ((reversible_supported,
                                 jax_reversible_supported),
                                (dense_reversible_supported,
                                 jax_dense_reversible_supported)):
            assert port_fn(m, dones=dones) == jax_fn(jm, dones=dones), (
                type(m).__name__, port_fn.__name__, dones)
    xs = t(inputs(0)[1])
    dones = torch.zeros((B, T), dtype=torch.bool)
    for kind in ("ring", "dense"):
        _, _, model, _ = model_pair(kind, "temporal")
        with pytest.raises(ValueError, match="dones=None"):
            model.scan(xs, model.initial_state(B, OBS), dones=dones,
                       remat="reverse")
        _, _, mw, _ = model_pair(kind, "temporal", edge_weights=True)
        with pytest.raises(ValueError, match="edge_weights"):
            mw.scan(xs, mw.initial_state(B, OBS), remat="reverse")
    model.edge_selectors = _Custom()
    with pytest.raises(ValueError, match="fused step"):
        model.scan(xs, model.initial_state(B, OBS), remat="reverse")
    # the residuals are copies of rows: a view would keep each step's
    # whole [B, N, N] adjacency alive through the forward
    for kind, spec in (("ring", _RingSpec), ("dense", _DenseSpec)):
        _, _, model, _ = model_pair(kind, "temporal")
        st = model.initial_state(B, OBS)
        nodes, adj = torch.rand_like(st.nodes), torch.rand_like(st.adj)
        for r in spec(model).residuals(nodes, adj, st[3] + G):
            assert r.untyped_storage().nbytes() == r.numel() * \
                r.element_size(), (kind, tuple(r.shape))


def test_trajectory_step_reverse_matches_optax(monkeypatch):
    """make_trajectory_supervised_step(remat="reverse") on the scan branch
    (the dense core; the ring with its training gate set to the scan)
    against JAX's step with optax.adam: the loss and the updated
    parameters (those whose gradient is not zero up to rounding, as
    test_torch_port_ring_window.py compares them)."""
    monkeypatch.setattr(RingDenseGCM, "window_profitable",
                        lambda self, mode="forward": False)
    monkeypatch.setattr(jax_config, "RING_WINDOW_TRAIN_MIN_N", G + 1)
    rng = np.random.default_rng(8)
    xs = rng.standard_normal((B, T, OBS)).astype(np.float32)
    targets = rng.standard_normal((B, T, HIDDEN)).astype(np.float32)
    for kind in ("ring", "dense"):
        jmodel, params, model, _ = model_pair(kind, "chain")
        jstep = jax_trajectory_step(jmodel, optax.adam(LR), remat="reverse")
        new_params, _, jloss = jax.jit(jstep)(
            params, optax.adam(LR).init(params), xs, targets)
        step = make_trajectory_supervised_step(
            model, torch.optim.Adam(model.parameters(), lr=LR),
            remat="reverse")
        assert not step.use_window
        loss = step(t(xs), t(targets))
        np.testing.assert_allclose(float(loss), float(jloss), atol=1e-5,
                                   rtol=1e-5, err_msg=kind)
        want = named_from_jax(model, numpy_tree(new_params))
        for n, p in model.named_parameters():
            # Adam's step on a gradient that is zero up to float32 rounding
            # is the sign of that rounding: compared where it is not
            if p.grad is not None and float(p.grad.abs().max()) >= ZERO_GRAD:
                np.testing.assert_allclose(p.detach().numpy(),
                                           want[n].numpy(), **GRAD_TOL,
                                           err_msg=f"{kind}: {n}")
