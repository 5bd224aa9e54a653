"""The port's training against the JAX package's, on the CPU.

The same weights (moved with `load_jax_params`) and the same numpy inputs go
through JAX and the port, where the port's kernels take their plain
versions, forward and backward:

- each of the port's autograd Functions (the fused dense stack, the one
  dense layer, the edge-list SpMM, the slot SpMM) against `jax.vjp` of its
  JAX counterpart, every gradient, adjacency and edge weights included, on
  JAX's XLA path and its Pallas path (interpret mode), with out-of-range
  lanes;
- `make_dense_supervised_step` on the README DenseGCM (ring wraparound,
  with and without dones) and with a LearnedEdge selector, and
  `make_sparse_supervised_step` on the README SparseGCM and on the
  learned sparse core (a deterministic sparse LearnedEdge, its edge
  weights carrying the gradient into the scorer and the temperature),
  default and slots: the loss and every parameter gradient against
  `jax.value_and_grad` of the JAX loss, then the parameters after one
  torch.optim.Adam step against one optax.adam step;
- the port's dense and sparse cores give the same gradients, and
  `DenseGCM.scan(remat=True)` the same loss and gradients, bitwise.

Tolerance, everywhere: 1e-5 absolute plus 1e-4 relative (float32 on both
sides, different summation orders; a gradient of a few units through three
layers already differs by ~2e-5 between the two). Cases of one check loop
inside one item, as in the other port tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import gcm_tpu.config as jax_config
from gcm_tpu.edges.learned import LearnedEdge as JaxLearnedEdge
from gcm_tpu.edges.sparse_learned import LearnedEdge as JaxSparseLearnedEdge
from gcm_tpu.models.dense_gcm import DenseGCM as JaxDenseGCM
from gcm_tpu.models.presets import readme_dense_gcm as jax_readme_dense_gcm
from gcm_tpu.models.presets import readme_sparse_gcm as jax_readme_sparse_gcm
from gcm_tpu.ops import dispatch as jax_dispatch
from gcm_tpu.ops.pallas import fused_gnn as jax_fused_gnn
from gcm_tpu.ops.pallas import spmm_slots as jax_slots
from gcm_tpu_torch import (DenseGCM, LearnedEdge, SparseGCM,
                           SparseLearnedEdge, load_jax_params,
                           make_dense_supervised_step,
                           make_sparse_supervised_step, named_from_jax,
                           readme_dense_gcm, readme_sparse_gcm)
from gcm_tpu_torch.ops import dispatch
from gcm_tpu_torch.ops.cuda.edge_grad import edge_weight_grad_plain
from gcm_tpu_torch.ops.cuda.fused_gnn import fused_dense_gnn
from gcm_tpu_torch.ops.cuda.spmm_slots import bucket_sink_slots, spmm_slots

torch.set_num_threads(1)

ATOL, RTOL = 1e-5, 1e-4
ZERO_GRAD = 1e-7  # a gradient that is zero up to float32 rounding
LR = 1e-3
OBS, HIDDEN = 8, 32


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def assert_close(got, want, atol=ATOL, rtol=RTOL, msg=""):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol,
                               err_msg=msg)


def tracked(*arrays):
    return [torch.tensor(a, requires_grad=True) for a in arrays]


def use_pallas(monkeypatch, on: bool):
    monkeypatch.setattr(jax_config, "USE_PALLAS", on)
    monkeypatch.setattr(jax_config, "PALLAS_DENSE_GCONV", on)
    monkeypatch.setattr(jax_config, "PALLAS_SPMM_MIN_WORK", 0)
    monkeypatch.setattr(jax_config, "SPMM_PRECISION", "highest")


# -- the kernels' autograd Functions -------------------------------------------

def dense_inputs(B, N, widths, seed, weighted=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, N, widths[0])).astype(np.float32)
    adj = (rng.random((B, N, N)) < 0.3).astype(np.float32)
    adj[:, 0, :] = 0.0
    if weighted:
        adj *= rng.random((B, N, N)).astype(np.float32)
    flat = []
    for fi, fo in zip(widths[:-1], widths[1:]):
        flat += [rng.uniform(-0.4, 0.4, (fi, fo)).astype(np.float32),
                 rng.uniform(-0.4, 0.4, (fo,)).astype(np.float32),
                 rng.uniform(-0.4, 0.4, (fi, fo)).astype(np.float32)]
    g = rng.standard_normal((B, N, widths[-1])).astype(np.float32)
    return x, adj, flat, g


def test_dense_functions_match_jax_vjp(monkeypatch):
    """fused_dense_gnn (1-3 layers, each activation) and the one-layer
    dispatch.dense_graph_conv: out, dx, dadj and every parameter's
    gradient against jax.vjp, on JAX's XLA and Pallas paths."""
    cases = {
        "two tanh": ((8, 8, 8), ("tanh", "tanh"), False),
        "relu, none": ((8, 12, 5), ("relu", None), True),
        "three": ((6, 8, 8, 4), (None, "relu", "tanh"), False),
        "one relu": ((8, 8), ("relu",), True),
    }
    for pallas in (False, True):
        use_pallas(monkeypatch, pallas)
        for i, (name, (widths, acts, weighted)) in enumerate(cases.items()):
            x, adj, flat, g = dense_inputs(3, 16, widths, i, weighted)
            want, vjp = jax.vjp(
                lambda a, b, c: jax_fused_gnn.fused_dense_gnn(a, b, c, acts),
                jnp.asarray(x), jnp.asarray(adj),
                tuple(jnp.asarray(p) for p in flat))
            wdx, wdadj, wdflat = vjp(jnp.asarray(g))
            tx, tadj, *tflat = tracked(x, adj, *flat)
            out = fused_dense_gnn(tx, tadj, tflat, acts)
            grads = torch.autograd.grad(out, [tx, tadj, *tflat],
                                        torch.from_numpy(g))
            msg = f"{name}, pallas={pallas}"
            assert_close(out, want, msg=msg)
            for got, w in zip(grads, (wdx, wdadj, *wdflat)):
                assert_close(got, w, msg=msg)

        x, adj, flat, g = dense_inputs(2, 16, (8, 6), 9, weighted=True)
        want, vjp = jax.vjp(jax_dispatch.dense_graph_conv,
                            *(jnp.asarray(a) for a in (x, adj, *flat)))
        tensors = tracked(x, adj, *flat)
        out = dispatch.dense_graph_conv(*tensors)
        grads = torch.autograd.grad(out, tensors, torch.from_numpy(g))
        assert_close(out, want, msg=f"one layer, pallas={pallas}")
        for got, w in zip(grads, vjp(jnp.asarray(g))):
            assert_close(got, w, msg=f"one layer, pallas={pallas}")


def spmm_inputs(B, N, F, E, seed):
    """Random edges with sentinel lanes (sink only, source only, both) and
    lanes whose sink or source is N or more."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, N, F)).astype(np.float32)
    edges = rng.integers(0, N, (B, 2, E)).astype(np.int32)
    edges[:, 0, 1::7] = -1
    edges[:, 1, 2::7] = -1
    edges[:, :, 3::11] = -1
    edges[:, 1, 4::13] = N + 3   # source past the graph
    edges[:, 0, 5::17] = N       # sink past the graph
    w = rng.uniform(0.5, 1.5, (B, E)).astype(np.float32)
    g = rng.standard_normal((B, N, F)).astype(np.float32)
    return x, edges, w, g


def test_spmm_functions_match_jax_vjp(monkeypatch):
    """dispatch.spmm (the edge-list kernel's Function) and spmm_slots: out,
    dx and dw against jax.vjp. The edge list runs on JAX's Pallas path,
    which drops a lane whose sink or source is N or more, as the port's
    kernel does, while dw gathers the clamped rows in both; on JAX's XLA
    path, which clamps such a source in the forward too, only in-range
    lanes are compared. The slot layout holds JAX's `ws != 0` rule: a
    slot of weight 0 gets no gradient."""
    for pallas in (True, False):
        use_pallas(monkeypatch, pallas)
        x, edges, w, g = spmm_inputs(3, 20, 6, 60, seed=int(pallas))
        if not pallas:
            edges = np.where(edges >= 20, -1, edges).astype(np.int32)
        want, vjp = jax.vjp(
            lambda a, b: jax_dispatch.spmm(a, jnp.asarray(edges), b),
            jnp.asarray(x), jnp.asarray(w))
        tx, tw = tracked(x, w)
        out = dispatch.spmm(tx, torch.from_numpy(edges), tw)
        grads = torch.autograd.grad(out, [tx, tw], torch.from_numpy(g))
        msg = f"edge list, pallas={pallas}"
        assert_close(out, want, msg=msg)
        for got, wg in zip(grads, vjp(jnp.asarray(g))):
            assert_close(got, wg, msg=msg)

    for k, seed in ((1, 3), (3, 4)):
        x, edges, w, g = spmm_inputs(2, 256, 5, 300, seed)
        edges = np.where(edges >= 256, -1, edges).astype(np.int32)
        w[:, ::9] = 0.0  # real edges of weight 0
        srcs, ws, _ = jax_slots.bucket_sink_slots(
            jnp.asarray(edges), jnp.asarray(w), 256, k)
        want, vjp = jax.vjp(
            lambda a, b: jax_slots.spmm_slots(a, srcs, b, 256, k),
            jnp.asarray(x), ws)
        t_srcs, t_ws, _ = bucket_sink_slots(torch.from_numpy(edges),
                                            torch.from_numpy(w), 256, k)
        np.testing.assert_array_equal(t_ws.numpy(), np.asarray(ws))
        tx = torch.tensor(x, requires_grad=True)
        t_ws.requires_grad_()
        out = spmm_slots(tx, t_srcs, t_ws, 256, k)
        grads = torch.autograd.grad(out, [tx, t_ws], torch.from_numpy(g))
        assert_close(out, want, msg=f"slots k={k}")
        for got, wg in zip(grads, vjp(jnp.asarray(g))):
            assert_close(got, wg, msg=f"slots k={k}")


def edge_grad_in_order(g, x, edges):
    """dw in the order csrc/edge_grad.cu states, in float32 numpy: column f
    adds into part f % 32 in ascending f (one rounding per product and per
    add), then the 32 parts are added by halves (p + p + 16, then p + 8,
    p + 4, p + 2, p + 1); indices clamped to N - 1, 0 on sentinel lanes."""
    N, F = x.shape[1], x.shape[2]
    b = np.arange(x.shape[0])[:, None]
    gs = g[b, np.clip(edges[:, 0], 0, N - 1)]
    xs = x[b, np.clip(edges[:, 1], 0, N - 1)]
    parts = np.zeros(edges[:, 0].shape + (32,), np.float32)
    for f in range(F):
        parts[..., f % 32] += gs[..., f] * xs[..., f]
    for half in (16, 8, 4, 2, 1):
        parts = parts[..., :half] + parts[..., half:2 * half]
    return np.where((edges[:, 0] >= 0) & (edges[:, 1] >= 0), parts[..., 0],
                    np.float32(0.0))


def test_edge_weight_grad_plain_order():
    """The plain edge weight-gradient is sum_f g[sink] x[src] with indices
    clamped, 0 on sentinel lanes (float64 reference), and bitwise the sum in
    the kernel's stated order, for widths below, at and above the 32 parts
    it sums in, with sentinels and indices of N or more."""
    for F in (1, 5, 13, 32, 45, 96, 128, 260):
        x, edges, _, g = spmm_inputs(2, 12, F, 40, seed=F)
        got = edge_weight_grad_plain(torch.from_numpy(g), torch.from_numpy(x),
                                     torch.from_numpy(edges))
        sink = np.clip(edges[:, 0], 0, 11)
        src = np.clip(edges[:, 1], 0, 11)
        b = np.arange(2)[:, None]
        want = (g[b, sink].astype(np.float64)
                * x[b, src].astype(np.float64)).sum(-1)
        want = np.where((edges[:, 0] >= 0) & (edges[:, 1] >= 0), want, 0.0)
        assert_close(got, want, msg=f"F={F}")
        assert not got[torch.from_numpy((edges[:, 0] < 0)
                                        | (edges[:, 1] < 0))].any()
        ordered = edge_grad_in_order(g, x, edges)
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      ordered.view(np.uint32),
                                      err_msg=f"F={F}: not the stated order")


# -- the train steps against JAX's -------------------------------------------

def compare_step(model, jmodel, params, torch_step, jax_loss, batch, msg):
    """One port step against JAX's value_and_grad and one optax.adam
    update: the loss, every parameter's gradient, every updated parameter
    but those whose gradient is zero up to rounding (LearnedEdge's logit
    shifts: sparsemax does not see a shift of all logits), which must be
    such a zero on both sides."""
    loss, grads = jax.jit(jax.value_and_grad(jax_loss))(params, *batch)
    opt = optax.adam(LR)
    updates, _ = opt.update(grads, opt.init(params), params)
    new_params = optax.apply_updates(params, updates)

    got_loss = torch_step(*(torch.from_numpy(np.asarray(a)) for a in batch))
    assert_close(got_loss, loss, msg=f"{msg}: loss")
    want_grads = named_from_jax(model, numpy_tree(grads))
    want_params = named_from_jax(model, numpy_tree(new_params))
    named = dict(model.named_parameters())
    assert set(named) == set(want_grads)
    for name, p in named.items():
        assert_close(p.grad, want_grads[name], msg=f"{msg}: grad of {name}")
        if float(want_grads[name].abs().max()) < ZERO_GRAD:
            # a zero gradient up to rounding in both frameworks: Adam's
            # update is then the sign of that rounding, in either one
            assert float(p.grad.abs().max()) < ZERO_GRAD, name
            continue
        assert_close(p, want_params[name],
                     msg=f"{msg}: {name} after one Adam step")


def dense_batch(B, T, seed, with_dones):
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((B, T, OBS)).astype(np.float32)
    targets = rng.standard_normal((B, T, HIDDEN)).astype(np.float32)
    if not with_dones:
        return (xs, targets)
    dones = rng.random((B, T)) < 0.08
    return (xs, targets, dones)


def dense_jax_loss(jmodel):
    def loss_fn(params, xs, targets, dones=None):
        state = jmodel.initial_state(xs.shape[0], xs.shape[-1])
        outs, _ = jmodel.scan(params, xs, state, dones=dones)
        return jnp.mean((outs - targets) ** 2)

    return loss_fn


@pytest.mark.parametrize("with_dones", [False, True])
def test_dense_step_matches_jax(with_dones):
    """The README DenseGCM at hidden 32, obs 8, graph 32, B=3, T=40, so
    the ring wraps (and with dones, episodes end mid-trajectory)."""
    G = 32
    jmodel = jax_readme_dense_gcm(obs_size=OBS, hidden=HIDDEN, graph_size=G)
    params = jmodel.init(jax.random.PRNGKey(1))
    model = readme_dense_gcm(obs_size=OBS, hidden=HIDDEN, graph_size=G,
                             device="cpu")
    load_jax_params(model, numpy_tree(params))
    opt = torch.optim.Adam(model.parameters(), lr=LR)
    step = make_dense_supervised_step(model, opt)
    if with_dones:  # the JAX step takes no dones, nor does the port's
        def step(xs, targets, dones):
            opt.zero_grad(set_to_none=True)
            outs, _ = model.scan(xs, model.initial_state(xs.shape[0], OBS),
                                 dones=dones)
            loss = torch.mean((outs - targets) ** 2)
            loss.backward()
            opt.step()
            return loss.detach()
    compare_step(model, jmodel, params, step, dense_jax_loss(jmodel),
                 dense_batch(3, 40, 2 + with_dones, with_dones),
                 f"dense, dones={with_dones}")


def test_learned_edge_step_matches_jax():
    """LearnedEdge (deterministic spardmax) on the dense step: its
    straight-through gradients ride on the adjacency into the edge
    network."""
    G = 16
    jbase = jax_readme_dense_gcm(obs_size=OBS, hidden=HIDDEN, graph_size=G)
    jmodel = JaxDenseGCM(jbase.gnn, preprocessor=jbase.preprocessor,
                         edge_selectors=JaxLearnedEdge(OBS,
                                                       deterministic=True),
                         graph_size=G)
    params = jmodel.init(jax.random.PRNGKey(3))
    base = readme_dense_gcm(obs_size=OBS, hidden=HIDDEN, graph_size=G,
                            device="cpu")
    model = DenseGCM(base.gnn, preprocessor=base.preprocessor,
                     edge_selectors=LearnedEdge(OBS, deterministic=True,
                                                device="cpu"),
                     graph_size=G, device="cpu")
    load_jax_params(model, numpy_tree(params))
    step = make_dense_supervised_step(
        model, torch.optim.Adam(model.parameters(), lr=LR))
    compare_step(model, jmodel, params, step, dense_jax_loss(jmodel),
                 dense_batch(2, 20, 5, False), "learned edges")
    edge_net = [p.grad for n, p in model.named_parameters()
                if n.startswith("edge_selectors")]
    assert edge_net and all(bool(g.abs().sum() > 0) for g in edge_net)


@pytest.mark.parametrize("aggregation", ["auto", "slots"])
def test_sparse_step_matches_jax(aggregation):
    """The README SparseGCM (graph 128, max_edges 512), one window of 40
    with ragged taus: default aggregation and slots (slot_k 1), no wrap."""
    kw = dict(aggregation="slots", slot_k=1) if aggregation == "slots" \
        else {}
    jbase = jax_readme_sparse_gcm(obs_size=OBS, hidden=HIDDEN)
    jmodel = type(jbase)(jbase.gnn, preprocessor=jbase.preprocessor,
                         edge_selectors=jbase.edge_selectors,
                         graph_size=128, max_edges=512, **kw)
    params = jmodel.init(jax.random.PRNGKey(4))
    model = readme_sparse_gcm(obs_size=OBS, hidden=HIDDEN, device="cpu",
                              **kw)
    load_jax_params(model, numpy_tree(params))

    def jax_loss(params, xs, targets, taus):
        state = jmodel.initial_state(xs.shape[0], xs.shape[-1])
        outs, _ = jmodel(params, xs, taus, state)
        return jnp.mean((outs - targets) ** 2)

    rng = np.random.default_rng(6)
    B, T = 3, 40
    taus = np.array([T, 17, 33], np.int32)
    xs = rng.standard_normal((B, T, OBS)).astype(np.float32)
    xs[np.arange(T)[None, :] >= taus[:, None]] = 0.0
    targets = rng.standard_normal((B, T, HIDDEN)).astype(np.float32)
    step = make_sparse_supervised_step(
        model, torch.optim.Adam(model.parameters(), lr=LR))
    compare_step(model, jmodel, params, step, jax_loss, (xs, targets, taus),
                 f"sparse, {aggregation}")


@pytest.mark.parametrize("aggregation", ["auto", "slots"])
def test_learned_sparse_step_matches_jax(aggregation, monkeypatch):
    """The README SparseGCM with a deterministic sparse LearnedEdge
    (num_edge_samples 3, so slot_k 3 bounds a sink's edges), graph 128, one
    window of 12 with ragged taus: the edge weights, 1.0 forward, carry
    d(loss)/d(soft) into the edge network and tau, so the SpMMs' dw runs
    (edge_weight_grad's plain version here; counted below), once per
    layer."""
    from gcm_tpu_torch.ops.cuda import spmm as spmm_mod

    kw = dict(aggregation="slots", slot_k=3) if aggregation == "slots" \
        else {}
    jbase = jax_readme_sparse_gcm(obs_size=OBS, hidden=HIDDEN)
    jmodel = type(jbase)(jbase.gnn, preprocessor=jbase.preprocessor,
                         edge_selectors=JaxSparseLearnedEdge(
                             OBS, deterministic=True, num_edge_samples=3),
                         graph_size=128, max_edges=256, **kw)
    params = jmodel.init(jax.random.PRNGKey(9))
    base = readme_sparse_gcm(obs_size=OBS, hidden=HIDDEN, device="cpu")
    model = SparseGCM(base.gnn, preprocessor=base.preprocessor,
                      edge_selectors=SparseLearnedEdge(
                          OBS, deterministic=True, num_edge_samples=3,
                          device="cpu"),
                      graph_size=128, max_edges=256, device="cpu", **kw)
    load_jax_params(model, numpy_tree(params))

    def jax_loss(params, xs, targets, taus):
        state = jmodel.initial_state(xs.shape[0], xs.shape[-1])
        outs, _ = jmodel(params, xs, taus, state)
        return jnp.mean((outs - targets) ** 2)

    calls = []
    plain = spmm_mod.edge_weight_grad

    def counted(*args):
        calls.append(1)
        return plain(*args)

    monkeypatch.setattr(spmm_mod, "edge_weight_grad", counted)
    if aggregation == "slots":
        from gcm_tpu_torch.ops.cuda import spmm_slots as slots_mod
        monkeypatch.setattr(slots_mod, "edge_weight_grad", counted)
    rng = np.random.default_rng(10)
    B, T = 3, 12
    taus = np.array([T, 7, 10], np.int32)
    xs = 2.0 * rng.standard_normal((B, T, OBS)).astype(np.float32)
    xs[np.arange(T)[None, :] >= taus[:, None]] = 0.0
    targets = rng.standard_normal((B, T, HIDDEN)).astype(np.float32)
    step = make_sparse_supervised_step(
        model, torch.optim.Adam(model.parameters(), lr=LR))
    compare_step(model, jmodel, params, step, jax_loss, (xs, targets, taus),
                 f"learned sparse, {aggregation}")
    assert len(calls) == 2, calls
    learned = {n: p.grad for n, p in model.named_parameters()
               if n.startswith("edge_selectors")}
    assert "edge_selectors.tau" in learned
    assert all(bool(g.abs().sum() > 0) for g in learned.values()), learned


# -- the port against itself ----------------------------------------------------

def grads_of(model, loss):
    params = list(model.parameters())
    return [g.clone() for g in torch.autograd.grad(loss, params)]


def test_dense_and_sparse_gradients_agree():
    """The parity contract, backward: the README dense and sparse cores
    with the same weights, T = graph_size (no wrap), give the same loss
    gradients, slots included."""
    rng = np.random.default_rng(7)
    B, T = 2, 24
    xs = torch.from_numpy(rng.standard_normal((B, T, OBS)).astype(np.float32))
    targets = torch.from_numpy(
        rng.standard_normal((B, T, HIDDEN)).astype(np.float32))
    dense = readme_dense_gcm(obs_size=OBS, graph_size=128, device="cpu",
                             seed=3)
    state = dense.initial_state(B, OBS)
    want = grads_of(dense, torch.mean((dense.scan(xs, state)[0]
                                       - targets) ** 2))
    taus = torch.full((B,), T, dtype=torch.int32)
    for kw in ({}, dict(aggregation="slots", slot_k=1)):
        sparse = readme_sparse_gcm(obs_size=OBS, device="cpu", seed=3, **kw)
        out, _ = sparse(xs, taus, sparse.initial_state(B, OBS))
        got = grads_of(sparse, torch.mean((out - targets) ** 2))
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert_close(a, b.numpy(), msg=f"sparse {kw}")


def test_dense_scan_remat_is_bitwise():
    """remat=True recomputes each step in the backward: the same loss and
    gradients as remat=False, bit for bit, with dones and the ring
    wrapping; unroll still raises, with its reason."""
    rng = np.random.default_rng(8)
    B, T, G = 2, 20, 16
    xs = torch.from_numpy(rng.standard_normal((B, T, OBS)).astype(np.float32))
    dones = torch.from_numpy(rng.random((B, T)) < 0.1)
    model = readme_dense_gcm(obs_size=OBS, graph_size=G, device="cpu")
    results = []
    for remat in (False, True):
        out, _ = model.scan(xs, model.initial_state(B, OBS), dones=dones,
                            remat=remat)
        loss = (out ** 2).mean()
        results.append((loss.detach(), grads_of(model, loss)))
    (l0, g0), (l1, g1) = results
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    with pytest.raises(NotImplementedError, match="no eager meaning"):
        model.scan(xs, model.initial_state(B, OBS), unroll=4)
