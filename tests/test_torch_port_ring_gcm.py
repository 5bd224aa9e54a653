"""The port's RingDenseGCM (gcm_tpu_torch/models/ring_gcm.py) against the
JAX package's, on the CPU.

The same weights (moved with `load_jax_params`) and the same numpy inputs go
through both; the port's kernels take their plain versions. JAX's scan runs
jitted, with `gcm_tpu.config.RING_FUSED_STEP` set through monkeypatch.

- The scan, B = 3, T = 2N + 3 (the ring wraps twice), with episode ends,
  at N = 8 and at N = 5 (off the dense kernels' 16-row grid), for every
  selector the ring runs in slot space (TemporalBackedge forward, backward,
  both, learned and stochastic learned; DenseEdge; CosineEdge,
  SpatialEdge, EuclideanEdge, a learned CosineEdge; LearnedEdge and its
  stochastic form; an EdgeChain), aux selectors behind a PositionalEncoding
  in 'add' and 'cat' modes, pooled and edge_weights: the port's fused and
  unfused steps against JAX's fused step, and the unfused steps of both
  for a subset. The stochastic selectors take the Gumbel noise JAX drew
  (its key splits replayed). Beliefs within 1e-5 (1e-4 where spardmax
  decides the edges), the adjacency and t exactly equal.
- adj_dtype=bfloat16: beliefs bitwise those of float32 storage, and its
  refusal of a learned TemporalBackedge; validate=True; the chunked and
  per-step remat give the forward and the gradients of remat=False.
- The ring against the port's DenseGCM (the same beliefs), and the
  windowed Distance difference the JAX ring has (it applies no window).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gcm_tpu.config as jax_config
from gcm_tpu.edges.chain import EdgeChain as JaxEdgeChain
from gcm_tpu.edges.dense import DenseEdge as JaxDenseEdge
from gcm_tpu.edges.distance import CosineEdge as JaxCosineEdge
from gcm_tpu.edges.distance import EuclideanEdge as JaxEuclideanEdge
from gcm_tpu.edges.distance import SpatialEdge as JaxSpatialEdge
from gcm_tpu.edges.learned import LearnedEdge as JaxLearnedEdge
from gcm_tpu.edges.temporal import TemporalBackedge as JaxTemporalBackedge
from gcm_tpu.models.dense_gcm import DenseGCM as JaxDenseGCM
from gcm_tpu.models.positional import (
    PositionalEncoding as JaxPositionalEncoding)
from gcm_tpu.models.presets import readme_dense_gcm as jax_readme_dense_gcm
from gcm_tpu.models.ring_gcm import RingDenseGCM as JaxRingDenseGCM
from gcm_tpu.nn.dense_conv import DenseGNN as JaxDenseGNN
from gcm_tpu_torch import (CosineEdge, DenseEdge, DenseGCM, DenseGNN,
                           EdgeChain, EuclideanEdge, LearnedEdge,
                           PositionalEncoding, RingDenseGCM, SpatialEdge,
                           TemporalBackedge, load_jax_params,
                           readme_dense_gcm, ring_state_from_numpy,
                           ring_state_to_numpy)
from gcm_tpu_torch.utils.validation import ShapeError

torch.set_num_threads(1)

ATOL = 1e-5
ATOL_SPARDMAX = 1e-4
OBS, HIDDEN, B = 8, 32, 3


def t(a):
    return torch.from_numpy(np.asarray(a))


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def selectors(name):
    """(JAX selector, port selector, input scale, belief tolerance)."""
    return {
        "temporal": (JaxTemporalBackedge([1, 2]), TemporalBackedge([1, 2]),
                     1.0, ATOL),
        "temporal_backward": (
            JaxTemporalBackedge([1, 3], direction="backward"),
            TemporalBackedge([1, 3], direction="backward"), 1.0, ATOL),
        "temporal_both": (JaxTemporalBackedge([2], direction="both"),
                          TemporalBackedge([2], direction="both"), 1.0,
                          ATOL),
        "temporal_learned": (
            JaxTemporalBackedge(learned=True, deterministic=True,
                                learning_window=4),
            TemporalBackedge(learned=True, deterministic=True,
                             learning_window=4, device="cpu"),
            1.0, ATOL_SPARDMAX),
        "temporal_learned_stochastic": (
            JaxTemporalBackedge(learned=True, learning_window=4),
            TemporalBackedge(learned=True, learning_window=4, device="cpu"),
            1.0, ATOL),
        "dense": (JaxDenseEdge(), DenseEdge(), 1.0, ATOL),
        "cosine": (JaxCosineEdge(0.5), CosineEdge(0.5), 1.0, ATOL),
        "spatial": (JaxSpatialEdge(0.5, slice(0, 2),
                                   b_pose_slice=slice(2, 4)),
                    SpatialEdge(0.5, slice(0, 2), b_pose_slice=slice(2, 4)),
                    0.3, ATOL),
        "euclidean": (JaxEuclideanEdge(1.0), EuclideanEdge(1.0), 0.3, ATOL),
        "cosine_learned": (JaxCosineEdge(0.3, learned=True),
                           CosineEdge(0.3, learned=True, device="cpu"), 1.0,
                           ATOL),
        "learned": (JaxLearnedEdge(OBS, deterministic=True),
                    LearnedEdge(OBS, deterministic=True, device="cpu"), 1.0,
                    ATOL_SPARDMAX),
        "learned_stochastic": (JaxLearnedEdge(OBS),
                               LearnedEdge(OBS, device="cpu"), 1.0, ATOL),
        "chain": (JaxEdgeChain([JaxTemporalBackedge([1]),
                                JaxEuclideanEdge(1.0)]),
                  EdgeChain([TemporalBackedge([1]),
                             EuclideanEdge(1.0)]), 0.3, ATOL),
    }[name]


@functools.cache
def jax_base(G):
    """JAX's README DenseGCM on a G-node graph and its parameters."""
    jbase = jax_readme_dense_gcm(obs_size=OBS, hidden=HIDDEN, graph_size=G)
    return jbase, jax.jit(jbase.init)(jax.random.PRNGKey(G))


def model_pair(name, G, jax_kw=None, port_kw=None):
    """The README DenseGCM's weights in JAX's RingDenseGCM and the port's,
    with the named selector configuration on a G-node graph."""
    jbase, base_params = jax_base(G)
    base = readme_dense_gcm(obs_size=OBS, hidden=HIDDEN, graph_size=G,
                            device="cpu")
    jkw, pkw, scale, atol = {}, {}, 1.0, ATOL
    if name.startswith("aux_"):
        mode = name.split("_")[-1]
        jkw["edge_selectors"], pkw["edge_selectors"] = (
            JaxTemporalBackedge([1]), TemporalBackedge([1]))
        if mode == "add":
            jkw["aux_edge_selectors"], pkw["aux_edge_selectors"] = (
                JaxCosineEdge(0.5), CosineEdge(0.5))
        else:
            jkw["aux_edge_selectors"], pkw["aux_edge_selectors"] = (
                JaxLearnedEdge(HIDDEN), LearnedEdge(HIDDEN, device="cpu"))
        jkw["positional_encoder"] = JaxPositionalEncoding(
            64, mode, cat_dim=8, feat_dim=HIDDEN)
        pkw["positional_encoder"] = PositionalEncoding(
            64, mode, cat_dim=8, feat_dim=HIDDEN, device="cpu")
    elif name in ("pooled", "edge_weights"):
        jkw["edge_selectors"], pkw["edge_selectors"] = (
            JaxTemporalBackedge([1]), TemporalBackedge([1]))
        jkw[name] = pkw[name] = True
    else:
        jsel, sel, scale, atol = selectors(name)
        jkw["edge_selectors"], pkw["edge_selectors"] = jsel, sel
    jgnn, gnn = jbase.gnn, base.gnn
    if name == "edge_weights":
        jgnn = JaxDenseGNN(jbase.gnn.layers, use_weights=True)
        gnn = DenseGNN(base.gnn.layers, use_weights=True)
    jmodel = JaxRingDenseGCM(jgnn, preprocessor=jbase.preprocessor,
                             graph_size=G, **jkw, **(jax_kw or {}))
    model = RingDenseGCM(gnn, preprocessor=base.preprocessor, graph_size=G,
                         device="cpu", **pkw, **(port_kw or {}))
    params = {"gnn": base_params["gnn"],
              "preprocessor": base_params["preprocessor"]}
    for i, sub in enumerate(("edge_selectors", "aux_edge_selectors",
                             "positional_encoder")):
        mod = getattr(jmodel, sub)
        if mod is not None:
            params[sub] = mod.init(jax.random.PRNGKey(10 * G + i))
    load_jax_params(model, numpy_tree(params))
    return jmodel, params, model, scale, atol


def jax_noise(sel, key, Bn, Nn):
    """The Gumbel noise the JAX ring's selector draws from `key`, in the
    port's ring layout (the JAX key splits replayed)."""
    if key is None or sel is None:
        return None
    if isinstance(sel, JaxEdgeChain):
        out = []
        for s in sel.selectors:
            key, sub = jax.random.split(key)
            out.append(jax_noise(s, sub, Bn, Nn))
        return out
    if isinstance(sel, JaxLearnedEdge) and not sel.deterministic:
        return t(jax.random.gumbel(key, (Bn, Nn), jnp.float32))
    if (isinstance(sel, JaxTemporalBackedge) and sel.learned
            and not sel.deterministic):
        return t(np.stack([np.asarray(jax.random.gumbel(k, (Bn, Nn)))
                           for k in jax.random.split(key, sel.num_samples)]))
    return None


def step_noise(jmodel, key, Bn, Nn):
    out = {}
    for name in ("edge_selectors", "aux_edge_selectors"):
        sel, sub = getattr(jmodel, name), None
        if sel is not None:
            key, sub = jax.random.split(key)
        out[name] = jax_noise(sel, sub, Bn, Nn)
    return out


def jax_scan(jmodel, params, xs, dones, key):
    """JAX's scan, jitted, one step a loop iteration (unroll only changes
    how XLA compiles the loop, not what it computes)."""
    state = jmodel.initial_state(xs.shape[0], OBS)
    fn = jax.jit(lambda p, x, d, k: jmodel.scan(p, x, state, key=k, dones=d,
                                                unroll=1))
    return fn(params, xs, dones, key)


# (graph size, cases): every configuration at 8, in three items, and a
# subset at 5, off the dense kernels' 16-row grid
CASES = {
    "temporal": (8, ["temporal", "temporal_backward", "temporal_both",
                     "temporal_learned", "temporal_learned_stochastic"]),
    "scored": (8, ["dense", "cosine", "spatial", "euclidean",
                   "cosine_learned"]),
    "learned_aux_options": (8, ["learned", "learned_stochastic", "chain",
                                "aux_pe_add", "aux_pe_cat", "pooled",
                                "edge_weights"]),
    "off_grid": (5, ["temporal", "temporal_learned_stochastic", "cosine",
                     "learned", "chain", "aux_pe_cat"]),
}
# the cases JAX also runs unfused (at graph size 8)
JAX_UNFUSED = ["temporal_learned_stochastic", "learned", "aux_pe_cat"]


@pytest.mark.parametrize("group", list(CASES))
def test_ring_scan_matches_jax(monkeypatch, group):
    """Each configuration of the group at its graph size G, T = 2G + 3 (the
    ring wraps twice), with dones: the port's fused and unfused scans
    against JAX's fused scan, and the unfused scans of both for
    JAX_UNFUSED."""
    G, names = CASES[group]
    T = 2 * G + 3
    for i, name in enumerate(names):
        for jax_fused in (True, False):
            if not jax_fused and (name not in JAX_UNFUSED or G != 8):
                continue
            monkeypatch.setattr(jax_config, "RING_FUSED_STEP", jax_fused)
            jmodel, params, model, scale, atol = model_pair(name, G)
            rng = np.random.default_rng(100 * G + i)
            xs = (scale * rng.standard_normal((B, T, OBS))).astype(np.float32)
            dones = rng.random((B, T)) < 0.06
            key = jax.random.PRNGKey(i)
            want, wstate = jax_scan(jmodel, params, xs, dones, key)
            noise = [step_noise(jmodel, k, B, G)
                     for k in jax.random.split(key, T)]
            for fused in ((True, False) if jax_fused else (False,)):
                model.fused_step = fused
                with torch.no_grad():
                    got, state = model.scan(t(xs), model.initial_state(B, OBS),
                                            dones=t(dones), noise=noise)
                label = f"{name} G={G} fused={fused} jax_fused={jax_fused}"
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           atol=atol, rtol=0, err_msg=label)
                np.testing.assert_array_equal(state.adj.numpy(),
                                              np.asarray(wstate.adj),
                                              err_msg=label)
                np.testing.assert_array_equal(state.t.numpy(),
                                              np.asarray(wstate.t),
                                              err_msg=label)
                assert state.adj.sum() > 0, f"{label}: no edges"


def test_ring_step_from_jax_state():
    """One step from a JAX state carried over with ring_state_from_numpy,
    every slot full (t past N): the same belief and state, and the state
    converts back."""
    G = 8
    jmodel, params, model, _, _ = model_pair("chain", G)
    rng = np.random.default_rng(3)
    xs = (0.3 * rng.standard_normal((B, 12, OBS))).astype(np.float32)
    _, jstate = jax_scan(jmodel, params, xs, np.zeros((B, 12), bool), None)
    x = (0.3 * rng.standard_normal((B, OBS))).astype(np.float32)
    want, wnext = jax.jit(jmodel.__call__)(params, jnp.asarray(x), jstate)
    state = ring_state_from_numpy(numpy_tree(jstate), "cpu")
    with torch.no_grad():
        got, nxt = model(t(x), state)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    for a, b in zip(ring_state_to_numpy(nxt), numpy_tree(wnext)):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=0)


def test_adj_dtype_bf16_is_bitwise_and_refuses_learned_temporal():
    """bfloat16 adjacency storage gives beliefs bitwise equal to float32
    storage for 0/1 selectors (the conv reads it as float32), fused and
    unfused, and matches JAX's bf16 ring; a learned TemporalBackedge is
    refused, as in JAX."""
    G, T = 8, 19
    for name in ("temporal_both", "cosine", "dense", "learned"):
        jmodel, params, model, scale, atol = model_pair(
            name, G, dict(adj_dtype=jnp.bfloat16),
            dict(adj_dtype=torch.bfloat16))
        _, _, model32, _, _ = model_pair(name, G)
        rng = np.random.default_rng(len(name))
        xs = t((scale * rng.standard_normal((B, T, OBS))).astype(np.float32))
        want, _ = jax_scan(jmodel, params, np.asarray(xs),
                           np.zeros((B, T), bool), None)
        with torch.no_grad():
            ref, _ = model32.scan(xs, model32.initial_state(B, OBS))
            for fused in (True, False):
                model.fused_step = fused
                got, state = model.scan(xs, model.initial_state(B, OBS))
                assert state.adj.dtype == torch.bfloat16
                np.testing.assert_array_equal(got.numpy(), ref.numpy(),
                                              err_msg=f"{name} {fused}")
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol,
                                   rtol=0, err_msg=name)
    for sel in (TemporalBackedge(learned=True, device="cpu"),
                EdgeChain([TemporalBackedge([1]),
                           TemporalBackedge(learned=True, device="cpu")])):
        with pytest.raises(ValueError, match="fractional"):
            RingDenseGCM(DenseGNN([]), edge_selectors=sel,
                         adj_dtype=torch.bfloat16, device="cpu")


def test_validate_remat_and_unported_options():
    """validate=True refuses a DenseGraphState and wrong shapes; the chunked
    (K = 4) and per-step remat give remat=False's forward bitwise and its
    gradients; window() gives the scan's beliefs; remat='reverse' gives
    the scan's forward bitwise and its gradients, and refuses dones."""
    G, T = 8, 16
    _, _, model, _, _ = model_pair("learned", G, port_kw=dict(validate=True))
    state = model.initial_state(B, OBS)
    with pytest.raises(ShapeError, match="RingGraphState"):
        model(torch.zeros(B, OBS), readme_dense_gcm(
            obs_size=OBS, graph_size=G, device="cpu").initial_state(B, OBS))
    with pytest.raises(ShapeError, match="nodes"):
        model(torch.zeros(B, OBS + 1), state)
    xs = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (B, T, OBS)).astype(np.float32))
    dones = torch.from_numpy(np.random.default_rng(1).random((B, T)) < 0.1)
    results = {}
    for remat in (False, True, 4):
        model.zero_grad(set_to_none=True)
        out, _ = model.scan(xs, model.initial_state(B, OBS), dones=dones,
                            remat=remat)
        (out ** 2).mean().backward()
        results[remat] = (out.detach(), {n: p.grad.clone() for n, p in
                                         model.named_parameters()
                                         if p.grad is not None})
    out0, grads0 = results[False]
    for remat in (True, 4):
        out, grads = results[remat]
        np.testing.assert_array_equal(out.numpy(), out0.numpy())
        assert set(grads) == set(grads0)
        for n in grads0:
            np.testing.assert_allclose(grads[n].numpy(), grads0[n].numpy(),
                                       atol=1e-6, rtol=1e-5, err_msg=n)
    with pytest.raises(ValueError, match="divisible"):
        model.scan(xs, model.initial_state(B, OBS), remat=5)
    with torch.no_grad():  # the scan-free window: the scan's beliefs
        got, _ = model.window(xs, model.initial_state(B, OBS))
        want, _ = model.scan(xs, model.initial_state(B, OBS))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL_SPARDMAX,
                               rtol=0)
    # the reversible scan (models/ring_reversible.py): the forward bitwise,
    # the gradients the scan's; dones are refused, not run another way
    model.zero_grad(set_to_none=True)
    out, _ = model.scan(xs, model.initial_state(B, OBS), remat="reverse")
    (out ** 2).mean().backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()
             if p.grad is not None}
    model.zero_grad(set_to_none=True)
    want, _ = model.scan(xs, model.initial_state(B, OBS))
    (want ** 2).mean().backward()
    np.testing.assert_array_equal(out.detach().numpy(),
                                  want.detach().numpy())
    for n, p in model.named_parameters():
        if p.grad is not None:
            np.testing.assert_allclose(grads[n].numpy(), p.grad.numpy(),
                                       atol=1e-6, rtol=1e-5, err_msg=n)
    with pytest.raises(ValueError, match="dones=None"):
        model.scan(xs, model.initial_state(B, OBS), dones=dones,
                   remat="reverse")


def test_ring_matches_dense_core_but_not_a_windowed_distance():
    """The ring and the port's DenseGCM give the same beliefs for the same
    weights and selectors; with Distance(window=) they differ, as the JAX
    ring (no window mask) differs from JAX's DenseGCM, and each port core
    holds its JAX twin."""
    G, T = 8, 20
    rng = np.random.default_rng(7)
    xs = (0.3 * rng.standard_normal((B, T, OBS))).astype(np.float32)
    dones = rng.random((B, T)) < 0.05
    for name in ("temporal", "cosine", "learned", "chain", "aux_pe_add"):
        _, _, ring, scale, atol = model_pair(name, G)
        dense = DenseGCM(ring.gnn, preprocessor=ring.preprocessor,
                         edge_selectors=ring.edge_selectors,
                         aux_edge_selectors=ring.aux_edge_selectors,
                         positional_encoder=ring.positional_encoder,
                         graph_size=G, device="cpu")
        with torch.no_grad():
            a, _ = ring.scan(t(xs), ring.initial_state(B, OBS),
                             dones=t(dones))
            b, _ = dense.scan(t(xs), dense.initial_state(B, OBS),
                              dones=t(dones))
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=atol, rtol=0,
                                   err_msg=name)

    jbase = jax_readme_dense_gcm(obs_size=OBS, hidden=HIDDEN, graph_size=G)
    base = readme_dense_gcm(obs_size=OBS, hidden=HIDDEN, graph_size=G,
                            device="cpu")
    jsel, sel = JaxEuclideanEdge(1.0, window=2), EuclideanEdge(1.0, window=2)
    jring = JaxRingDenseGCM(jbase.gnn, preprocessor=jbase.preprocessor,
                            edge_selectors=jsel, graph_size=G)
    jdense = JaxDenseGCM(jbase.gnn, preprocessor=jbase.preprocessor,
                         edge_selectors=jsel, graph_size=G)
    ring = RingDenseGCM(base.gnn, preprocessor=base.preprocessor,
                        edge_selectors=sel, graph_size=G, device="cpu")
    dense = DenseGCM(base.gnn, preprocessor=base.preprocessor,
                     edge_selectors=sel, graph_size=G, device="cpu")
    params = jring.init(jax.random.PRNGKey(0))
    load_jax_params(ring, numpy_tree(params))
    nod = np.zeros((B, T), bool)
    want_ring, _ = jax_scan(jring, params, xs, nod, None)
    want_dense, _ = jax_scan(jdense, params, xs, nod, None)
    with torch.no_grad():
        got_ring, _ = ring.scan(t(xs), ring.initial_state(B, OBS))
        got_dense, _ = dense.scan(t(xs), dense.initial_state(B, OBS))
    np.testing.assert_allclose(got_ring.numpy(), np.asarray(want_ring),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(got_dense.numpy(), np.asarray(want_dense),
                               atol=ATOL, rtol=0)
    gap = np.abs(np.asarray(want_ring) - np.asarray(want_dense)).max()
    assert gap > 1e-3, "the windowed Distance no longer differs in JAX"
    assert np.abs(got_ring.numpy() - got_dense.numpy()).max() > 1e-3
