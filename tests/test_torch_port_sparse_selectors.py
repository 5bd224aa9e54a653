"""The port's sparse edge selectors and SparseGCM's remaining options against
the JAX package on the CPU, and the distributions of the stochastic
selectors' generator path.

- SpatialRadiusEdge, SpatialKNNEdge (positions on a coarse lattice, so
  that distances tie at the k-th value) and SparseEdgeChain: grids exactly
  equal, with and without seg_mask.
- The sparse LearnedEdge, deterministic and stochastic (JAX's Gumbel noise,
  drawn from the same key, handed to the port as `noise=`), window None
  and set, the grid path and `emit_edges`: keep masks and edges exactly
  equal, soft values and the stats aux within 1e-5.
- SparseGCM over two chained windows, and its scan, with each new
  selector, aux selectors, PositionalEncoding add / cat with and without
  dones, hop_cap="auto" (JAX compacting, the port on the masked path) and
  stochastic selectors: beliefs within 1e-5, edge lists, t and num_edges
  exactly equal.
- The generator path alone: hard-Gumbel pick frequencies within 5 sigma of
  the softmax over 10^4 draws, entropy rising with tau, at most
  num_edge_samples edges kept per sink, the deterministic kept count rising
  as tau drops, and the learned TemporalBackedge's replacement law.

Cases of one check loop inside one item (the failure names the case), as
in the other port tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gcm_tpu.config as jax_config
from gcm_tpu.edges.sparse_learned import LearnedEdge as JaxSparseLearned
from gcm_tpu.edges.sparse_spatial import SparseEdgeChain as JaxSparseChain
from gcm_tpu.edges.sparse_spatial import SpatialKNNEdge as JaxKNN
from gcm_tpu.edges.sparse_spatial import SpatialRadiusEdge as JaxRadius
from gcm_tpu.edges.sparse_temporal import TemporalEdge as JaxTemporalEdge
from gcm_tpu.models.positional import \
    PositionalEncoding as JaxPositionalEncoding
from gcm_tpu.models.sparse_gcm import SparseGCM as JaxSparseGCM
from gcm_tpu.nn import sparse_conv as jax_conv
from gcm_tpu.nn.module import MLP as JaxMLP
from gcm_tpu.nn.module import Linear as JaxLinear
from gcm_tpu.utils.ste import sample_gumbel as jax_sample_gumbel
from gcm_tpu_torch import (MLP, GraphConv, Linear, PositionalEncoding,
                           SparseEdgeChain, SparseGCM, SparseGNN,
                           SparseLearnedEdge, SpatialKNNEdge,
                           SpatialRadiusEdge, TemporalBackedge, TemporalEdge,
                           load_jax_params, sparse_state_to_numpy)
from gcm_tpu_torch.ops.scatter import nonzero_padded
from gcm_tpu_torch.utils import ste as tste

torch.set_num_threads(1)

ATOL = 1e-5
B, N, F, T = 3, 16, 6, 6


def t_(a):
    return torch.from_numpy(np.array(a))


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def assert_close(got, want, msg=""):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=1e-5,
                               err_msg=msg)


def assert_equal(got, want, msg=""):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_array_equal(got, np.asarray(want), err_msg=msg)


def selector_inputs(seed, lattice=False):
    """Nodes (positions on a lattice of 0.25 when `lattice`, so that kNN
    distances tie), the cursor T of three graphs (empty, mid, near full),
    ragged taus and a seg_mask of two episodes inside the window."""
    rng = np.random.default_rng(seed)
    nodes = rng.standard_normal((B, N, F)).astype(np.float32)
    if lattice:
        nodes[..., :2] = np.round(nodes[..., :2] * 2) / 4
    else:
        nodes[..., :2] *= 0.3
    Tc = np.array([0, 5, N - T], np.int32)
    taus = np.array([T, 3, T], np.int32)
    rowseg = np.zeros((B, N), np.int32)
    seg_new = (np.arange(T) >= 2).astype(np.int32)[None, :].repeat(B, 0)
    for b in range(B):
        rowseg[b, Tc[b]:Tc[b] + T] = seg_new[b]
    seg = seg_new[:, :, None] == rowseg[:, None, :]
    return nodes, Tc, taus, seg


def spatial_pairs():
    return {
        "radius": (JaxRadius(slice(0, 2), 0.25), SpatialRadiusEdge(
            slice(0, 2), 0.25)),
        "knn": (JaxKNN(slice(0, 2), k=3), SpatialKNNEdge(slice(0, 2), k=3)),
        "knn_k_past_n": (JaxKNN(slice(1, 4), k=N + 2),
                         SpatialKNNEdge(slice(1, 4), k=N + 2)),
        "chain": (JaxSparseChain([JaxTemporalEdge([1, 2]),
                                  JaxRadius(slice(0, 2), 0.4)]),
                  SparseEdgeChain([TemporalEdge([1, 2]),
                                   SpatialRadiusEdge(slice(0, 2), 0.4)])),
    }


def test_spatial_selectors_match_jax():
    """Radius, kNN (ties at the k-th distance, and k past N) and the chain
    (its grids summed), with and without seg_mask: grids exactly equal."""
    for name, (jsel, sel) in spatial_pairs().items():
        params = jsel.init(jax.random.PRNGKey(0))
        for lattice in (False, True):
            nodes, Tc, taus, seg = selector_inputs(1 + lattice, lattice)
            for use_seg in (False, True):
                kw = {"seg_mask": seg} if use_seg else {}
                want, jaux = jsel(params, jnp.asarray(nodes), jnp.asarray(Tc),
                                  jnp.asarray(taus), T,
                                  **{k: jnp.asarray(v) for k, v in kw.items()})
                got, aux = sel(t_(nodes), t_(Tc), t_(taus), T,
                               **{k: t_(v) for k, v in kw.items()})
                case = f"{name}, lattice {lattice}, seg_mask {use_seg}"
                assert_equal(got, want, case)
                assert set(aux) == set(jaux), case
                assert np.asarray(want).any(), f"{case}: no edge"
                if name == "knn" and lattice:  # ties kept: more than k
                    assert int((got > 0).sum(-1).max()) > 3, case


def learned_pair(seed, **kw):
    jsel = JaxSparseLearned(F, **kw)
    params = jsel.init(jax.random.PRNGKey(seed))
    sel = SparseLearnedEdge(F, device="cpu", **kw)
    load_jax_params(sel, numpy_tree(params))
    return jsel, params, sel


def check_aux(aux, jaux, case):
    assert set(aux) == set(jaux), case
    for k in aux:
        assert_close(aux[k], jaux[k], f"{case}: {k}")


@pytest.mark.parametrize("det", [True, False],
                         ids=["deterministic", "stochastic"])
def test_sparse_learned_edge_matches_jax(det):
    """Deterministic or stochastic, window None and 4, the grid path and
    emit_edges, with and without seg_mask: the keep mask (grid > 0) and the
    emitted edges exactly equal, soft values and stats within 1e-5; and
    emit's edges, compacted, are the grid's."""
    nodes, Tc, taus, seg = selector_inputs(3)
    nodes *= 3.0  # logits spread enough that the cutoff keeps edges
    args = (jnp.asarray(nodes), jnp.asarray(Tc), jnp.asarray(taus), T)
    targs = (t_(nodes), t_(Tc), t_(taus), T)
    for i, (window, use_seg) in enumerate(
            [(w, s) for w in (None, 4) for s in (False, True)], 4 * det):
        case = f"deterministic {det}, window {window}, seg_mask {use_seg}"
        jsel, params, sel = learned_pair(i, deterministic=det, window=window,
                                         num_edge_samples=2)
        assert sel.supports_emit == (window is not None)
        kw = {"seg_mask": seg} if use_seg else {}
        jkw = {k: jnp.asarray(v) for k, v in kw.items()}
        tkw = {k: t_(v) for k, v in kw.items()}
        key = None if det else jax.random.PRNGKey(50 + i)
        noise = None if det else t_(jax_sample_gumbel(key, (B, T, N)))
        want, jaux = jsel(params, *args, key=key, **jkw)
        with torch.no_grad():
            got, aux = sel(*targs, noise=noise, **tkw)
        assert_equal(got > 0, np.asarray(want) > 0, case)
        assert_close(got, want, case)
        check_aux(aux, jaux, case)
        assert np.asarray(want).any(), f"{case}: no edge"
        if window is None:
            continue
        wp = min(window + T, N)
        noise = None if det else t_(jax_sample_gumbel(key, (B, T, wp)))
        jnew, jvals, jok, jaux = jsel.emit_edges(params, *args, key=key,
                                                 **jkw)
        with torch.no_grad():
            new_e, vals, ok, aux = sel.emit_edges(*targs, noise=noise, **tkw)
        assert new_e.dtype == torch.int32
        assert_equal(new_e, jnew, f"{case}, emit")
        assert_equal(ok, jok, f"{case}, emit")
        assert_close(vals, jvals, f"{case}, emit")
        check_aux(aux, jaux, f"{case}, emit")
        if det:  # the same edges as the grid, in the grid's order
            idx, valid, _ = nonzero_padded(got.reshape(B, -1) > 0, T * wp)
            assert_equal(new_e[:, 1][ok], (idx % N)[valid], case)
            assert_equal(new_e[:, 0][ok],
                         (t_(Tc)[:, None] + idx // N)[valid], case)
    if not det:
        with pytest.raises(ValueError, match="generator= or noise="):
            learned_pair(0)[2](*targs)


# -- SparseGCM with the new selectors and options ------------------------------

def gnn_pair(hidden):
    jgnn = jax_conv.SparseGNN([jax_conv.GraphConv(hidden, hidden), jnp.tanh,
                               jax_conv.GraphConv(hidden, hidden), jnp.tanh])
    gnn = SparseGNN([GraphConv(hidden, hidden, device="cpu"), torch.tanh,
                     GraphConv(hidden, hidden, device="cpu"), torch.tanh])
    return jgnn, gnn


def core_pair(sels, aux_sels=None, pe=None, Nn=N, **kw):
    """The JAX SparseGCM and the port's (obs F, hidden 8) with one set of
    weights; sels / aux_sels / pe are (JAX, port) pairs or None."""
    hidden = 8
    jgnn, gnn = gnn_pair(hidden)
    pick = (lambda p, i: None if p is None else p[i])
    jmodel = JaxSparseGCM(jgnn, preprocessor=JaxMLP([JaxLinear(F, hidden)]),
                          edge_selectors=pick(sels, 0),
                          aux_edge_selectors=pick(aux_sels, 0),
                          positional_encoder=pick(pe, 0), graph_size=Nn,
                          max_edges=128, **kw)
    params = jmodel.init(jax.random.PRNGKey(0))
    model = SparseGCM(gnn, preprocessor=MLP([Linear(F, hidden,
                                                    device="cpu")]),
                      edge_selectors=pick(sels, 1),
                      aux_edge_selectors=pick(aux_sels, 1),
                      positional_encoder=pick(pe, 1), graph_size=Nn,
                      max_edges=128, device="cpu", **kw)
    load_jax_params(model, numpy_tree(params))
    return jmodel, params, model


def jax_noise(sel, key, shape):
    """The Gumbel noise a JAX sparse selector draws from `key` for logits
    of `shape`, in the port's layout (a chain's list, split as JAX's)."""
    if isinstance(sel, JaxSparseChain):
        out = []
        for s in sel.selectors:
            key, sub = jax.random.split(key)
            out.append(jax_noise(s, sub, shape))
        return out
    if isinstance(sel, JaxSparseLearned) and not sel.deterministic:
        return t_(jax_sample_gumbel(key, shape))
    return None


def forward_noise(jmodel, key, shapes):
    """The port's noise dict for one JAX forward under `key` (JAX splits
    once for the edge selectors, then once for the aux selectors)."""
    if key is None:
        return None
    out = {}
    for name in ("edge_selectors", "aux_edge_selectors"):
        sel = getattr(jmodel, name)
        if sel is not None:
            key, sub = jax.random.split(key)
            out[name] = jax_noise(sel, sub, shapes[name])
    return out


def assert_state_matches(state, jstate, msg):
    got = sparse_state_to_numpy(state)
    for name in ("edges", "t", "num_edges"):
        assert_equal(getattr(got, name), getattr(jstate, name),
                     f"{msg}: {name}")
    for name in ("nodes", "weights"):
        assert_close(getattr(got, name), getattr(jstate, name),
                     f"{msg}: {name}")


def core_cases():
    return {
        "radius": dict(sels=(JaxRadius(slice(0, 2), 0.6),
                             SpatialRadiusEdge(slice(0, 2), 0.6))),
        "knn": dict(sels=(JaxKNN(slice(0, 2), k=2),
                          SpatialKNNEdge(slice(0, 2), k=2)), dones=True),
        "chain": dict(sels=(
            JaxSparseChain([JaxTemporalEdge([1]), JaxRadius(slice(0, 2),
                                                            0.6)]),
            SparseEdgeChain([TemporalEdge([1]),
                             SpatialRadiusEdge(slice(0, 2), 0.6)]))),
        "learned_grid": dict(sels=(
            JaxSparseLearned(F, deterministic=True, num_edge_samples=2),
            SparseLearnedEdge(F, deterministic=True, num_edge_samples=2,
                              device="cpu")), kw=dict(max_hops=2)),
        "learned_emit": dict(sels=(
            JaxSparseLearned(F, deterministic=True, num_edge_samples=2,
                             window=3),
            SparseLearnedEdge(F, deterministic=True, num_edge_samples=2,
                              window=3, device="cpu")), kw=dict(emit=True),
            dones=True),
        "learned_stochastic_grid": dict(sels=(
            JaxSparseLearned(F, num_edge_samples=3, window=3),
            SparseLearnedEdge(F, num_edge_samples=3, window=3,
                              device="cpu")), kw=dict(emit=False),
            key=True),
        "learned_stochastic_chain_slots": dict(
            sels=(JaxSparseChain([JaxTemporalEdge([1]),
                                  JaxSparseLearned(F, num_edge_samples=2)]),
                  SparseEdgeChain([TemporalEdge([1]),
                                   SparseLearnedEdge(F, num_edge_samples=2,
                                                     device="cpu")])),
            key=True, Nn=128, kw=dict(aggregation="slots", slot_k=3)),
        "aux_learned_pe_add": dict(
            sels=(JaxTemporalEdge([1]), TemporalEdge([1])),
            aux_sels=(JaxSparseLearned(8, num_edge_samples=2),
                      SparseLearnedEdge(8, num_edge_samples=2,
                                        device="cpu")),
            pe=(JaxPositionalEncoding(64, "add", feat_dim=8),
                PositionalEncoding(64, "add", feat_dim=8, device="cpu")),
            key=True, dones=True),
        "aux_radius_pe_cat": dict(
            sels=(JaxTemporalEdge([1]), TemporalEdge([1])),
            aux_sels=(JaxRadius(slice(0, 2), 0.5),
                      SpatialRadiusEdge(slice(0, 2), 0.5)),
            pe=(JaxPositionalEncoding(64, "cat", cat_dim=2, feat_dim=8),
                PositionalEncoding(64, "cat", cat_dim=2, feat_dim=8,
                                   device="cpu"))),
        "pe_add_dones": dict(
            sels=(JaxTemporalEdge([1, 2]), TemporalEdge([1, 2])),
            pe=(JaxPositionalEncoding(64, "add", feat_dim=8),
                PositionalEncoding(64, "add", feat_dim=8, device="cpu")),
            dones=True),
        "hop_cap_auto": dict(
            sels=(JaxTemporalEdge([1, 2]), TemporalEdge([1, 2])),
            kw=dict(max_hops=1, hop_cap="auto"), Nn=32, auto=True),
    }


def window_inputs(Bn, t, seed):
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((2, Bn, t, F)).astype(np.float32)
    xs[..., :2] *= 0.4
    dones = rng.random((2, Bn, t)) < 0.25
    return xs, dones


@pytest.mark.parametrize("name", list(core_cases()))
def test_sparse_gcm_new_options_match_jax(monkeypatch, name):
    """SparseGCM over two chained windows of 6 in each case of core_cases
    (the JAX forward jitted, as a trainer runs it): beliefs within 1e-5, the
    state's edge lists, t and num_edges exactly equal, aux exactly (counts)
    or within 1e-5 (stats). hop_cap="auto": JAX's gates opened, so JAX
    compacts (its cap 8, 6 + 1 * 2, drops nothing) where the port keeps the
    masked path."""
    monkeypatch.setattr(jax_config, "HOP_AUTO_RATIO", 2)
    monkeypatch.setattr(jax_config, "HOP_AUTO_MIN_NF", 0)
    i = list(core_cases()).index(name)
    cfg = core_cases()[name]
    Nn = cfg.get("Nn", N)
    jmodel, params, model = core_pair(
        cfg["sels"], cfg.get("aux_sels"), cfg.get("pe"), Nn=Nn,
        **cfg.get("kw", {}))
    if cfg.get("auto"):
        assert jmodel._resolve_hop_cap(T, Nn, 8) == 8
    jforward = jax.jit(lambda p, x, ta, st, k, d: jmodel(
        p, x, ta, st, key=k, return_aux=True, dones=d))
    xs, dones = window_inputs(B, T, 10 + i)
    taus = np.array([T, 4, T], np.int32)
    jstate, state = jmodel.initial_state(B, F), model.initial_state(B, F)
    key = jax.random.PRNGKey(70 + i) if cfg.get("key") else None
    for w in range(2):
        d = dones[w] if cfg.get("dones") else None
        k = None if key is None else jax.random.fold_in(key, w)
        want, jstate, jaux = jforward(
            params, jnp.asarray(xs[w]), jnp.asarray(taus), jstate, k,
            None if d is None else jnp.asarray(d))
        noise = forward_noise(jmodel, k, {"edge_selectors": (B, T, Nn),
                                          "aux_edge_selectors": (B, T, Nn)})
        with torch.no_grad():
            got, state, aux = model(
                t_(xs[w]), t_(taus), state, return_aux=True, noise=noise,
                dones=None if d is None else t_(d))
        case = f"{name}, window {w}"
        assert_close(got, want, case)
        assert_state_matches(state, jstate, case)
        if cfg.get("auto"):
            assert not np.asarray(jaux.pop("hop_overflow")).any(), case
            assert "hop_overflow" not in aux, case
        check_aux(aux, jaux, case)
    assert int(state.num_edges.min()) > 0, name


def scan_cases():
    pe = (JaxPositionalEncoding(64, "add", feat_dim=8),
          PositionalEncoding(64, "add", feat_dim=8, device="cpu"))
    return {
        "learned_stochastic": dict(sels=(
            JaxSparseLearned(F, num_edge_samples=2, window=4),
            SparseLearnedEdge(F, num_edge_samples=2, window=4,
                              device="cpu")), key=True, kw=dict(emit=True)),
        "knn_pe": dict(sels=(JaxKNN(slice(0, 2), k=2),
                             SpatialKNNEdge(slice(0, 2), k=2)), pe=pe),
    }


@pytest.mark.parametrize("name", list(scan_cases()))
def test_sparse_gcm_scan_with_new_selectors_matches_jax(name):
    """scan with dones: the stochastic learned selector fed JAX's noise
    (one key per step, split as JAX's scan splits it), and the kNN
    selector with a positional encoder."""
    Tn = 10
    i = list(scan_cases()).index(name)
    cfg = scan_cases()[name]
    jmodel, params, model = core_pair(cfg["sels"], pe=cfg.get("pe"),
                                      **cfg.get("kw", {}))
    xs, dones = window_inputs(B, Tn, 30 + i)
    key = jax.random.PRNGKey(90 + i) if cfg.get("key") else None
    want, jstate = jmodel.scan(params, jnp.asarray(xs[0]),
                               jmodel.initial_state(B, F), key=key,
                               dones=jnp.asarray(dones[0]))
    noise = None
    if key is not None:
        wp = min(4 + 1, N)
        noise = [forward_noise(jmodel, k, {"edge_selectors": (B, 1, wp)})
                 for k in jax.random.split(key, Tn)]
    with torch.no_grad():
        got, state = model.scan(t_(xs[0]), model.initial_state(B, F),
                                dones=t_(dones[0]), noise=noise)
    assert_close(got, want, name)
    assert_state_matches(state, jstate, name)


def test_stochastic_core_needs_a_generator_and_repeats_per_seed():
    """Without generator= or noise= the stochastic selector raises; with a
    generator, one seed gives the same beliefs and edges bitwise, and the
    scan draws fresh noise each step."""
    _, _, model = core_pair((
        JaxSparseLearned(F, num_edge_samples=2, window=4),
        SparseLearnedEdge(F, num_edge_samples=2, window=4, device="cpu")))
    xs, _ = window_inputs(B, T, 40)
    taus = torch.full((B,), T, dtype=torch.int32)
    with pytest.raises(ValueError, match="generator= or noise="):
        model(t_(xs[0]), taus, model.initial_state(B, F))
    runs = []
    with torch.no_grad():
        for seed in (5, 5, 6):
            g = torch.Generator().manual_seed(seed)
            out, state = model(t_(xs[0]), taus, model.initial_state(B, F),
                               generator=g)
            out2, state = model.scan(t_(xs[1]), state, generator=g)
            runs.append((out, out2, state.edges))
    assert all(torch.equal(a, b) for a, b in zip(runs[0], runs[1]))
    assert not torch.equal(runs[0][2], runs[2][2])


def test_emit_dispatch_honours_supports_emit(monkeypatch):
    """A LearnedEdge with window=None has emit_edges but cannot emit: "auto"
    keeps it on the grid path, and emit=True is refused; a windowed one
    under emit=True takes the emit path, and under "auto" where its
    emit_profitable gate, if it has one, says so."""
    sel = SparseLearnedEdge(F, deterministic=True, device="cpu")
    _, _, model = core_pair((JaxSparseLearned(F, deterministic=True), sel))

    def refuse(*a, **k):
        raise AssertionError("emit_edges called")

    monkeypatch.setattr(sel, "emit_edges", refuse)
    xs, _ = window_inputs(B, T, 41)
    with torch.no_grad():
        model(t_(xs[0]), torch.full((B,), T, dtype=torch.int32),
              model.initial_state(B, F))
    assert not model._use_emit(T, N)
    gnn = gnn_pair(8)[1]
    with pytest.raises(ValueError, match="grid-free"):
        SparseGCM(gnn, edge_selectors=SparseLearnedEdge(F, device="cpu"),
                  emit=True, device="cpu")
    windowed = SparseGCM(gnn, edge_selectors=SparseLearnedEdge(
        F, window=4, device="cpu"), emit=True, device="cpu")
    assert windowed._use_emit(T, N)
    # under "auto" the selector's gate decides: N >= 3 * min(window + t, N)
    sel = SparseLearnedEdge(F, window=4, device="cpu")
    auto = SparseGCM(gnn, edge_selectors=sel, device="cpu")
    assert not auto._use_emit(6, 29) and auto._use_emit(6, 30)
    gate = SparseLearnedEdge(F, window=16, device="cpu").emit_profitable
    assert [gate(32, n) for n in (128, 144)] == [False, True]
    windowed.edge_selectors = sel
    assert windowed._use_emit(6, 29)


def test_hop_cap_auto_keeps_the_masked_path():
    """hop_cap="auto" runs the masked max_hops path (compaction measured
    slower on the card at every point): the beliefs and aux of hop_cap=None,
    where an integer cap compacts, with the same beliefs."""
    xs, _ = window_inputs(B, T, 42)
    taus = torch.full((B,), T, dtype=torch.int32)
    got = {}
    for cap in ("auto", None, 8):
        _, _, model = core_pair((JaxTemporalEdge([1, 2]), TemporalEdge(
            [1, 2])), Nn=32, max_hops=1, hop_cap=cap)
        with torch.no_grad():
            out, _, aux = model(t_(xs[0]), taus, model.initial_state(B, F),
                                return_aux=True)
        got[cap] = (out, set(aux))
    assert torch.equal(got["auto"][0], got[None][0])
    assert got["auto"][1] == got[None][1] == {"dropped_edges"}
    assert "hop_overflow" in got[8][1]
    torch.testing.assert_close(got[8][0], got[None][0], atol=ATOL, rtol=0)


# -- the generator path's distributions -----------------------------------------

def test_hard_gumbel_frequencies_match_softmax():
    """argmax(logits + Gumbel) ~ Categorical(softmax(logits)): 10^4 draws
    in one call, frequencies within 5 sigma; a masked entry is never
    picked; the hard law is the same at every temperature."""
    n = 10_000
    g = torch.Generator().manual_seed(0)
    logits = torch.tensor([1.0, 0.0, -1.0]).expand(n, 3)
    picks = tste.masked_gumbel_softmax(logits, torch.ones(n, 3, dtype=bool),
                                       hard=True, generator=g)
    want = torch.softmax(logits[0], -1).numpy()
    sigma = np.sqrt(want * (1 - want) / n)
    freq = picks.mean(0).numpy()
    assert (np.abs(freq - want) < 5 * sigma + 1e-3).all(), (freq, want)
    mask = torch.tensor([True, False, True]).expand(n, 3)
    picks = tste.masked_gumbel_softmax(torch.tensor([0.0, 10.0, 0.0])
                                       .expand(n, 3), mask, hard=True,
                                       generator=g)
    freq = picks.mean(0).numpy()
    assert freq[1] == 0.0 and abs(freq[0] - 0.5) < 0.03
    logits = torch.tensor([0.5, -0.5, 0.0, 1.5]).expand(n, 4)
    want = torch.softmax(logits[0], -1).numpy()
    for tau in (0.25, 4.0):
        picks = tste.masked_gumbel_softmax(
            logits, torch.ones(n, 4, dtype=bool), tau=tau, hard=True,
            generator=g)
        assert (np.abs(picks.mean(0).numpy() - want) < 0.03).all(), tau


def entropy(p):
    p = np.asarray(p, np.float64)
    return -(np.where(p > 1e-12, p * np.log(np.maximum(p, 1e-12)), 0.0)
             ).sum(-1)


def test_entropy_rises_with_tau():
    """The tempered softmax's entropy and the Gumbel softmax's mean entropy
    (512 draws) rise strictly with tau."""
    g = torch.Generator().manual_seed(1)
    logits = torch.randn(12, generator=g)
    mask = torch.arange(12) < 9
    hs = [float(entropy(tste.masked_tempered_softmax(logits, mask, tau=t)))
          for t in (0.2, 0.5, 1.0, 2.0, 5.0)]
    assert all(a < b for a, b in zip(hs, hs[1:])), hs
    logits = torch.randn(8, generator=g).expand(512, 8)
    hs = [float(entropy(tste.masked_gumbel_softmax(
        logits, torch.ones(512, 8, dtype=bool), tau=t, generator=g)).mean())
        for t in (0.3, 1.0, 3.0)]
    assert hs[0] < hs[1] < hs[2], hs


def test_learned_cutoff_bounds_and_temperature():
    """The stochastic selector keeps at most num_edge_samples edges a sink
    at any logits (the slot bound); the deterministic one keeps more edges
    at a low temperature than at a high one, where none clear the
    cutoff."""
    S = 3
    g = torch.Generator().manual_seed(2)
    sel = SparseLearnedEdge(4, num_edge_samples=S, device="cpu", generator=g)
    nodes = 3.0 * torch.randn(3, 16, 4, generator=g)
    Tc = torch.tensor([5, 8, 11], dtype=torch.int32)
    taus = torch.full((3,), 4, dtype=torch.int32)
    with torch.no_grad():
        for _ in range(5):
            grid, _ = sel(nodes, Tc, taus, 4, generator=g)
            assert int((grid > 0).sum(2).max()) <= S

    def kept(tau):
        sel = SparseLearnedEdge(4, deterministic=True, num_edge_samples=2,
                                softmax_temp=tau, learn_softmax_temp=False,
                                device="cpu",
                                generator=torch.Generator().manual_seed(0))
        nodes = 2.0 * torch.randn(2, 24, 4,
                                  generator=torch.Generator().manual_seed(1))
        with torch.no_grad():
            grid, _ = sel(nodes, torch.tensor([16, 20], dtype=torch.int32),
                          torch.full((2,), 4, dtype=torch.int32), 4)
        return int((grid > 0).sum())

    assert kept(0.05) > kept(50.0) == 0


def test_learned_temporal_backedge_replacement_law():
    """k hard Gumbel draws over W uniform slots, OR-ed, select
    W (1 - (1 - 1/W)^k) slots in expectation (800 graphs at once)."""
    W, Bn, Nn = 10, 800, 16
    g = torch.Generator().manual_seed(3)
    means = []
    for k in (1, 5):
        sel = TemporalBackedge(learned=True, learning_window=W,
                               num_samples=k, device="cpu")
        num_nodes = torch.full((Bn,), W, dtype=torch.int32)
        noise = tste.noise_for(sel.noise_shape(Bn, Nn), g, "cpu")
        with torch.no_grad():
            adj, _ = sel(None, torch.zeros(Bn, Nn, Nn), torch.zeros(0),
                         num_nodes, noise=noise)
        means.append(float((adj > 0).sum()) / Bn)
    assert abs(means[0] - 1.0) < 0.05, means
    assert abs(means[1] - W * (1 - (1 - 1 / W) ** 5)) < 0.2, means
