"""The port's dense edge selectors, their ops and the DenseGCM that runs them,
against the JAX package on the CPU.

- `sddmm_threshold_row_plain` (what the card's kernel computes, bitwise)
  against the Pallas kernel in interpret mode and against the JAX scores.
  The two frameworks round the scores differently, so a lane whose float64
  score lies within 1e-5 of the threshold may flip; such lanes are left out
  and must be under 1% of all lanes.
- `ops/distance.py`, `utils/ste.py` (stochastic functions fed the Gumbel
  noise JAX drew), `LayerNorm` and the positional encoders, at 1e-5 / 1e-6.
- Every selector alone on a hand-built state, and its fused row/column
  form: adjacency exactly equal.
- DenseGCM scan (T > graph_size, so the ring wraps) with each selector,
  fused and unfused, the served tick, and the torch reference
  `bench_reference.RefDenseGCM`: beliefs within 1e-5 (1e-4 where spardmax
  decides the edges, as tests/test_torch_oracle.py allows), adjacency and
  num_nodes exactly equal.

Cases run in loops inside a few test items; each failure names its case.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gcm_tpu.config as jax_config
import gcm_tpu.ops.distance as jdist
import gcm_tpu.utils.ste as jste
from gcm_tpu.edges.chain import EdgeChain as JaxEdgeChain
from gcm_tpu.edges.dense import DenseEdge as JaxDenseEdge
from gcm_tpu.edges.distance import CosineEdge as JaxCosineEdge
from gcm_tpu.edges.distance import EuclideanEdge as JaxEuclideanEdge
from gcm_tpu.edges.distance import SpatialEdge as JaxSpatialEdge
from gcm_tpu.edges.learned import LearnedEdge as JaxLearnedEdge
from gcm_tpu.edges.temporal import TemporalBackedge as JaxTemporalBackedge
from gcm_tpu.models.dense_gcm import DenseGCM as JaxDenseGCM
from gcm_tpu.models.positional import (
    PositionalEncoding as JaxPositionalEncoding,
    RelativePositionalEncoding as JaxRelativePositionalEncoding,
    sincos_table as jax_sincos_table)
from gcm_tpu.models.presets import readme_dense_gcm as jax_readme_dense_gcm
from gcm_tpu.nn.module import LayerNorm as JaxLayerNorm
from gcm_tpu.ops.pallas.sddmm import sddmm_threshold_row as pallas_sddmm
from gcm_tpu.serve.sessions import SessionServer as JaxSessionServer
from gcm_tpu_torch import (CosineEdge, DenseEdge, DenseGCM, EdgeChain,
                           EuclideanEdge, LayerNorm, LearnedEdge,
                           PositionalEncoding, RelativePositionalEncoding,
                           SessionServer, SpatialEdge, TemporalBackedge,
                           load_jax_params, readme_dense_gcm, sincos_table,
                           state_from_numpy)
from gcm_tpu_torch.models.dense_gcm import _dense_selector_row_col, _RowColAcc
from gcm_tpu_torch.ops import distance as tdist
from gcm_tpu_torch.ops.cuda.sddmm import (
    sddmm_threshold_row, sddmm_threshold_row_current,
    sddmm_threshold_row_current_plain, sddmm_threshold_row_plain)
from gcm_tpu_torch.utils import ste as tste

torch.set_num_threads(1)

ATOL = 1e-5
ATOL_SPARDMAX = 1e-4
NEAR = 1e-5        # |float64 score - threshold| below this may flip
NEAR_SHARE = 0.01  # ... and such lanes must be under 1% of all lanes
OBS, HIDDEN, N, B, T = 8, 32, 16, 4, 40


def t(a):
    return torch.from_numpy(np.array(a))


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# -- sddmm_threshold_row ------------------------------------------------------

def score64(curr, nodes, mode):
    """The score in float64, to find the lanes near the threshold."""
    q, n = curr.astype(np.float64)[:, None, :], nodes.astype(np.float64)
    if mode == "euclidean":
        return np.sqrt(((q - n) ** 2).sum(-1))
    nq = np.maximum(np.sqrt((q * q).sum(-1)), 1e-8)
    nn = np.maximum(np.sqrt((n * n).sum(-1)), 1e-8)
    return (q * n).sum(-1) / (nq * nn)


def assert_masks_agree(got, want, curr, nodes, thr, mode, label):
    """Equal masks except on lanes whose float64 score lies within NEAR of
    the threshold; those are under NEAR_SHARE of the lanes."""
    near = np.abs(score64(curr, nodes, mode) - thr) < NEAR
    assert near.mean() < NEAR_SHARE, f"{label}: {near.sum()} lanes near thr"
    np.testing.assert_array_equal(np.where(near, False, got),
                                  np.where(near, False, want), err_msg=label)


def sddmm_cases():
    """(label, curr, nodes, num_nodes, thr, mode): num_nodes 0, mid, N - 1,
    curr the row at num_nodes, as the selectors gather it."""
    rng = np.random.default_rng(0)
    for mode, Bc, Nc, F, thr in (("euclidean", 3, 16, 8, 3.5),
                                 ("euclidean", 3, 13, 2, 1.0),
                                 ("cosine", 3, 16, 8, 0.2),
                                 ("cosine", 3, 13, 5, -0.1)):
        nodes = rng.standard_normal((Bc, Nc, F)).astype(np.float32)
        num_nodes = np.array([0, Nc // 2, Nc - 1], np.int32)
        curr = nodes[np.arange(Bc), num_nodes]
        yield f"{mode} N={Nc} F={F}", curr, nodes, num_nodes, thr, mode


def test_sddmm_plain_matches_pallas_and_jax_scores():
    for label, curr, nodes, num_nodes, thr, mode in sddmm_cases():
        got = sddmm_threshold_row_plain(t(curr), t(nodes), t(num_nodes), thr,
                                        mode).numpy()
        assert got.dtype == np.bool_ and got.any(), label
        want = np.asarray(pallas_sddmm(jnp.asarray(curr), jnp.asarray(nodes),
                                       jnp.asarray(num_nodes), thr,
                                       mode=mode))
        assert_masks_agree(got, want, curr, nodes, thr, mode,
                           f"pallas {label}")
        if mode == "cosine":
            score = jdist.cosine_score(jnp.asarray(curr), jnp.asarray(nodes))
        else:
            score = jdist.spatial_score(jnp.asarray(curr), jnp.asarray(nodes),
                                        slice(0, None))
        past = np.arange(nodes.shape[1])[None, :] < num_nodes[:, None]
        assert_masks_agree(got, (np.asarray(score) < thr) & past, curr, nodes,
                           thr, mode, f"jax score {label}")
        assert not got[0].any(), f"{label}: num_nodes 0 has no edges"
        # the wrapper takes the plain version for CPU tensors, unlaunched
        before = sddmm_threshold_row.launches
        np.testing.assert_array_equal(
            sddmm_threshold_row(t(curr), t(nodes), t(num_nodes), thr,
                                mode).numpy(), got)
        assert sddmm_threshold_row.launches == before
    with pytest.raises(ValueError, match="unknown mode"):
        sddmm_threshold_row(t(curr), t(nodes), t(num_nodes), 0.5, "manhattan")


def test_sddmm_current_entry_matches_explicit_path_and_pallas():
    """The current-node entry's plain version (the function its kernel
    reads in place) equals the explicit path on the gathered node and the
    sliced columns bitwise, and agrees with the Pallas kernel: num_nodes 0,
    mid, N - 1 and past N (clamped); the whole row, a pose slice, different
    slices for the current node and the others at column offsets, F = 5 at
    offset 3, and slices with a step of 2 (which the kernel's wrapper
    copies)."""
    rng = np.random.default_rng(1)
    Bc, Nc = 4, 13
    num_nodes = np.array([0, Nc // 2, Nc - 1, Nc + 7], np.int32)
    for mode, F, cols, curr_cols, thr in (
            ("cosine", 8, None, None, 0.2),
            ("euclidean", 8, slice(0, 2), None, 1.0),
            ("euclidean", 8, slice(4, 6), slice(1, 3), 1.0),
            ("cosine", 11, slice(3, 8), None, -0.1),
            ("euclidean", 11, slice(3, 8), slice(6, 11), 3.0),
            ("euclidean", 9, slice(0, 8, 2), slice(1, 9, 2), 2.5)):
        label = f"{mode} F={F} cols={cols} curr_cols={curr_cols}"
        nodes = rng.standard_normal((Bc, Nc, F)).astype(np.float32)
        scored_cols = cols or slice(None)
        curr = np.ascontiguousarray(nodes[np.arange(Bc), np.clip(
            num_nodes, 0, Nc - 1)][:, curr_cols or scored_cols])
        scored = np.ascontiguousarray(nodes[:, :, scored_cols])
        got = sddmm_threshold_row_current_plain(t(nodes), t(num_nodes), thr,
                                                mode, cols, curr_cols)
        assert got.any() and not got.all(), label
        assert not got[0].any() and got[3].any(), label
        assert torch.equal(got, sddmm_threshold_row_plain(
            t(curr), t(scored), t(num_nodes), thr, mode)), label
        want = np.asarray(pallas_sddmm(jnp.asarray(curr), jnp.asarray(scored),
                                       jnp.asarray(num_nodes), thr,
                                       mode=mode))
        assert_masks_agree(got.numpy(), want, curr, scored, thr, mode,
                           f"pallas {label}")
        # the wrapper takes the plain version for CPU tensors, unlaunched
        before = sddmm_threshold_row.launches
        assert torch.equal(sddmm_threshold_row_current(
            t(nodes), t(num_nodes), thr, mode, cols, curr_cols), got), label
        assert sddmm_threshold_row.launches == before
    with pytest.raises(ValueError, match="unknown mode"):
        sddmm_threshold_row_current(t(nodes), t(num_nodes), 0.5, "manhattan")
    # a tensor that is not on the CPU launches the kernel or raises
    with pytest.raises(ValueError, match="CUDA tensors"):
        sddmm_threshold_row_current(
            torch.empty((Bc, Nc, 8), device="meta"),
            torch.empty(Bc, dtype=torch.int32, device="meta"), 0.5)
    assert sddmm_threshold_row.launches == before


# -- ops/distance.py, utils/ste.py, LayerNorm, positional encoders -------------

def test_distance_ops_match_jax():
    rng = np.random.default_rng(1)
    a = rng.standard_normal((2, 5, 3)).astype(np.float32)
    b = rng.standard_normal((2, 7, 3)).astype(np.float32)
    curr = rng.standard_normal((4, 6)).astype(np.float32)
    nodes = rng.standard_normal((4, 9, 6)).astype(np.float32)
    pos = rng.uniform(0, 2, (2, 12, 2)).astype(np.float32)
    valid = rng.random((2, 12)) < 0.8
    pairs = {
        "cdist": (jdist.cdist(a, b), tdist.cdist(t(a), t(b))),
        "euclidean_score": (jdist.euclidean_score(curr, nodes),
                            tdist.euclidean_score(t(curr), t(nodes))),
        "cosine_score": (jdist.cosine_score(curr, nodes),
                         tdist.cosine_score(t(curr), t(nodes))),
        "spatial_score": (jdist.spatial_score(curr, nodes, slice(0, 2),
                                              slice(3, 5)),
                          tdist.spatial_score(t(curr), t(nodes), slice(0, 2),
                                              slice(3, 5))),
    }
    for name, (want, got) in pairs.items():
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=0, err_msg=name)
    masks = {
        "radius": dict(radius=0.7),
        "radius_no_loop": dict(radius=0.7, loop=False),
        "radius_max_neighbors": dict(radius=1.0, max_neighbors=3),
    }
    for name, kw in masks.items():
        want = jdist.pairwise_radius_mask(pos, valid, **kw)
        got = tdist.pairwise_radius_mask(t(pos), t(valid), **kw)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=name)
    for k, loop in ((3, False), (4, True), (20, False)):
        want = jdist.pairwise_knn_mask(pos, valid, k, loop=loop)
        got = tdist.pairwise_knn_mask(t(pos), t(valid), k, loop=loop)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=f"knn k={k} loop={loop}")


def test_ste_functions_match_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 7)).astype(np.float32)
    mask = rng.random((3, 7)) < 0.6
    mask[2] = False  # a row with no entry
    key = jax.random.PRNGKey(3)
    noise = np.asarray(jax.random.gumbel(key, x.shape, jnp.float32))
    ones = [(rng.random((3, 7)) < 0.5).astype(np.float32) for _ in range(3)]
    cases = {
        "ste": (jste.ste(x), tste.ste(t(x))),
        "straight_through": (jste.straight_through(ones[0], x),
                             tste.straight_through(t(ones[0]), t(x))),
        "sparsemax": (jste.sparsemax(x), tste.sparsemax(t(x))),
        "sparsemax_axis0": (jste.sparsemax(x, axis=0),
                            tste.sparsemax(t(x), axis=0)),
        "spardmax": (jste.spardmax(x), tste.spardmax(t(x))),
        "hardmax": (jste.hardmax(x), tste.hardmax(t(x))),
        "gumbel_softmax": (jste.gumbel_softmax(key, x, tau=0.7),
                           tste.gumbel_softmax(t(x), tau=0.7, noise=t(noise))),
        "gumbel_softmax_hard": (
            jste.gumbel_softmax(key, x, hard=True),
            tste.gumbel_softmax(t(x), hard=True, noise=t(noise))),
        "masked_softmax": (jste.masked_softmax(x, mask, tau=0.5),
                           tste.masked_softmax(t(x), t(mask), tau=0.5)),
        "masked_gumbel_softmax_hard": (
            jste.masked_gumbel_softmax(key, x, mask, hard=True),
            tste.masked_gumbel_softmax(t(x), t(mask), hard=True,
                                       noise=t(noise))),
        "masked_tempered_softmax_hard": (
            jste.masked_tempered_softmax(x, mask, tau=2.0, hard=True),
            tste.masked_tempered_softmax(t(x), t(mask), tau=2.0, hard=True)),
        "diff_or": (jste.diff_or(ones), tste.diff_or([t(o) for o in ones])),
    }
    for name, (want, got) in cases.items():
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                                   rtol=0, err_msg=name)
    # straight-through gradients: identity through ste, soft's through hard
    xt = t(x).requires_grad_()
    tste.ste(xt).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), np.ones_like(x))
    g = torch.Generator().manual_seed(0)
    drawn = tste.gumbel_softmax(t(x), generator=g)
    assert torch.isfinite(drawn).all() and torch.allclose(drawn.sum(-1),
                                                          torch.ones(3))
    with pytest.raises(ValueError, match="generator= or noise="):
        tste.gumbel_softmax(t(x))


def test_layer_norm_and_positional_encoders_match_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 6, 10)).astype(np.float32)
    ln = JaxLayerNorm(10)
    p = {"scale": rng.uniform(0.5, 1.5, 10).astype(np.float32),
         "bias": rng.uniform(-0.5, 0.5, 10).astype(np.float32)}
    tln = LayerNorm(10, device="cpu")
    load_jax_params(tln, p)
    np.testing.assert_allclose(tln(t(x)).detach().numpy(),
                               np.asarray(ln(p, x)), atol=ATOL, rtol=0)
    np.testing.assert_allclose(sincos_table(50, 7).numpy(),
                               np.asarray(jax_sincos_table(50, 7)),
                               atol=1e-6, rtol=0)
    num_nodes = np.array([0, 4], np.int32)
    positions = rng.integers(0, 40, (2, 6)).astype(np.int32)
    encoders = {
        "add": (JaxPositionalEncoding(40, "add", feat_dim=10),
                PositionalEncoding(40, "add", feat_dim=10, device="cpu"), {}),
        "add_positions": (
            JaxPositionalEncoding(40, "add", feat_dim=10),
            PositionalEncoding(40, "add", feat_dim=10, device="cpu"),
            {"positions": positions}),
        "cat": (JaxPositionalEncoding(40, "cat", cat_dim=4, feat_dim=10),
                PositionalEncoding(40, "cat", cat_dim=4, feat_dim=10,
                                   device="cpu"), {}),
        "relative": (JaxRelativePositionalEncoding(40, feat_dim=10),
                     RelativePositionalEncoding(40, feat_dim=10,
                                                device="cpu"), {}),
    }
    for name, (jenc, tenc, kw) in encoders.items():
        params = jenc.init(jax.random.PRNGKey(5))
        load_jax_params(tenc, numpy_tree(params))
        want = jenc(params, x, num_nodes, **kw)
        got = tenc(t(x), t(num_nodes), **{k: t(v) for k, v in kw.items()})
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=ATOL, rtol=0, err_msg=name)


# -- each selector alone --------------------------------------------------------

def selector_pairs(obs=OBS):
    """name -> (JAX selector, port selector), the configurations this slice
    runs and the options around them."""
    return {
        "cosine": (JaxCosineEdge(0.5), CosineEdge(0.5)),
        "spatial": (JaxSpatialEdge(0.25, a_pose_slice=slice(0, 2)),
                    SpatialEdge(0.25, a_pose_slice=slice(0, 2))),
        "spatial_b_slice": (
            JaxSpatialEdge(0.5, slice(0, 2), b_pose_slice=slice(3, 5)),
            SpatialEdge(0.5, slice(0, 2), b_pose_slice=slice(3, 5))),
        "euclidean": (JaxEuclideanEdge(1.0), EuclideanEdge(1.0)),
        "cosine_learned_window": (
            JaxCosineEdge(0.3, learned=True, window=5),
            CosineEdge(0.3, learned=True, window=5, device="cpu")),
        "spatial_learned": (
            JaxSpatialEdge(0.4, slice(1, 3), learned=True),
            SpatialEdge(0.4, slice(1, 3), learned=True, device="cpu")),
        "dense": (JaxDenseEdge(), DenseEdge()),
        "learned": (JaxLearnedEdge(obs, deterministic=True),
                    LearnedEdge(obs, deterministic=True, device="cpu")),
        "learned_stochastic": (JaxLearnedEdge(obs),
                               LearnedEdge(obs, device="cpu")),
        "temporal_learned": (
            JaxTemporalBackedge(learned=True, deterministic=True,
                                learning_window=6),
            TemporalBackedge(learned=True, deterministic=True,
                             learning_window=6, device="cpu")),
        "temporal_learned_stochastic": (
            JaxTemporalBackedge(learned=True, learning_window=6),
            TemporalBackedge(learned=True, learning_window=6, device="cpu")),
        "recall_chain": (
            JaxEdgeChain([JaxTemporalBackedge([1]),
                          JaxEuclideanEdge(1.0, window=4)]),
            EdgeChain([TemporalBackedge([1]), EuclideanEdge(1.0, window=4)])),
    }


def jax_noise(sel, key, Bn, Nn):
    """The Gumbel noise the JAX selector draws from `key`, in the port's
    noise layout (the JAX package's key splits, replayed)."""
    if key is None:
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
        return t(np.stack([
            np.asarray(jax.random.gumbel(k, (Bn, sel.learning_window),
                                         jnp.float32))
            for k in jax.random.split(key, sel.num_samples)]))
    return None


def step_noise(jmodel, key, Bn, Nn):
    """The port's per-step noise dict for the JAX model's step under key."""
    out = {}
    for name in ("edge_selectors", "aux_edge_selectors"):
        sel, sub = getattr(jmodel, name), None
        if sel is not None and key is not None:
            key, sub = jax.random.split(key)
        out[name] = None if sel is None else jax_noise(sel, sub, Bn, Nn)
    return out


def hand_built_state(seed, scale):
    """Random nodes (scaled so that the thresholds cut through the scores),
    a random 0/1/2 adjacency with content at row and column num_nodes, and
    num_nodes 0, mid and N - 1."""
    rng = np.random.default_rng(seed)
    nodes = (scale * rng.standard_normal((3, N, OBS))).astype(np.float32)
    adj = rng.integers(0, 3, (3, N, N)).astype(np.float32)
    num_nodes = np.array([0, N // 2, N - 1], np.int32)
    return nodes, adj, num_nodes


def test_each_selector_alone_matches_jax():
    """Each selector on a hand-built state: the JAX call, the port's call
    and the port's fused row/column form give the same adjacency."""
    for i, (name, (jsel, sel)) in enumerate(selector_pairs().items()):
        params = jsel.init(jax.random.PRNGKey(i))
        load_jax_params(sel, numpy_tree(params))
        scale = 0.3 if name.startswith(("spatial", "euclidean", "recall")) \
            else 1.0
        nodes, adj, num_nodes = hand_built_state(i, scale)
        key = jax.random.PRNGKey(100 + i)
        want, _ = jsel(params, jnp.asarray(nodes), jnp.asarray(adj),
                       jnp.zeros((0,)), jnp.asarray(num_nodes), key=key)
        noise = jax_noise(jsel, key, 3, N)
        with torch.no_grad():
            got, _ = sel(t(nodes), t(adj), torch.zeros(0), t(num_nodes),
                         noise=noise)
            acc = _RowColAcc(3, N, torch.float32, "cpu",
                             lambda: t(adj)[torch.arange(3),
                                            t(num_nodes).long()])
            _dense_selector_row_col(sel, t(nodes), acc, t(num_nodes), noise)
        i_eq = torch.arange(N)[None, :] == t(num_nodes)[:, None]
        fused = torch.where(
            i_eq[:, :, None] & acc.row_m[:, None, :], acc.row[:, None, :],
            torch.where(i_eq[:, None, :] & acc.col_m[:, :, None],
                        acc.col[:, :, None], t(adj)))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=name)
        np.testing.assert_array_equal(fused.numpy(), got.numpy(),
                                      err_msg=f"{name} fused")
        assert not np.array_equal(np.asarray(want), adj), f"{name}: no edge"


# -- DenseGCM with the selectors ------------------------------------------------

def model_pair(name, fused_step=True):
    """The README DenseGCM (graph_size N) with the named selectors, in JAX
    and in the port with the same weights."""
    jmodel = jax_readme_dense_gcm(obs_size=OBS, graph_size=N)
    kw = {}
    if name.startswith("aux_"):
        kind = name[len("aux_"):]
        jmodel.edge_selectors = JaxTemporalBackedge([1])
        jmodel.aux_edge_selectors, kw["aux_edge_selectors"] = {
            "cosine_pe_add": (JaxCosineEdge(0.5), CosineEdge(0.5)),
            "spatial_pe_relative": (
                JaxSpatialEdge(0.5, slice(0, 2), b_pose_slice=slice(2, 4)),
                SpatialEdge(0.5, slice(0, 2), b_pose_slice=slice(2, 4))),
            "learned_pe_cat": (JaxLearnedEdge(HIDDEN),
                               LearnedEdge(HIDDEN, device="cpu")),
        }[kind]
        jmodel.positional_encoder, kw["positional_encoder"] = {
            "cosine_pe_add": (
                JaxPositionalEncoding(64, "add", feat_dim=HIDDEN),
                PositionalEncoding(64, "add", feat_dim=HIDDEN, device="cpu")),
            "spatial_pe_relative": (
                JaxRelativePositionalEncoding(64, feat_dim=HIDDEN),
                RelativePositionalEncoding(64, feat_dim=HIDDEN,
                                           device="cpu")),
            "learned_pe_cat": (
                JaxPositionalEncoding(64, "cat", cat_dim=8, feat_dim=HIDDEN),
                PositionalEncoding(64, "cat", cat_dim=8, feat_dim=HIDDEN,
                                   device="cpu")),
        }[kind]
        kw["edge_selectors"] = TemporalBackedge([1])
    else:
        jmodel.edge_selectors, kw["edge_selectors"] = selector_pairs()[name]
    params = jmodel.init(jax.random.PRNGKey(0))
    base = readme_dense_gcm(obs_size=OBS, graph_size=N, device="cpu")
    model = DenseGCM(base.gnn, preprocessor=base.preprocessor, graph_size=N,
                     fused_step=fused_step, device="cpu", **kw)
    load_jax_params(model, numpy_tree(params))
    return jmodel, params, model


MODEL_CASES = {
    # name: (input scale, belief tolerance)
    "cosine": (1.0, ATOL),
    "spatial": (0.3, ATOL),
    "euclidean": (0.3, ATOL),
    "dense": (1.0, ATOL),
    "learned": (1.0, ATOL_SPARDMAX),
    "temporal_learned": (1.0, ATOL_SPARDMAX),
    "learned_stochastic": (1.0, ATOL),
    "temporal_learned_stochastic": (1.0, ATOL),
    "recall_chain": (0.3, ATOL),
    "aux_cosine_pe_add": (1.0, ATOL),
    "aux_spatial_pe_relative": (1.0, ATOL),
    "aux_learned_pe_cat": (1.0, ATOL),
}


def check_scan(name, fused_step, monkeypatch):
    monkeypatch.setattr(jax_config, "DENSE_FUSED_STEP", fused_step)
    scale, atol = MODEL_CASES[name]
    jmodel, params, model = model_pair(name, fused_step)
    rng = np.random.default_rng(len(name))
    xs = (scale * rng.standard_normal((B, T, OBS))).astype(np.float32)
    dones = rng.random((B, T)) < 0.05
    key = jax.random.PRNGKey(7)
    want, want_state = jmodel.scan(params, xs, jmodel.initial_state(B, OBS),
                                   key=key, dones=dones)
    noise = [step_noise(jmodel, k, B, N) for k in jax.random.split(key, T)]
    with torch.no_grad():
        got, state = model.scan(t(xs), model.initial_state(B, OBS),
                                dones=t(dones), noise=noise)
    label = f"{name} fused_step={fused_step}"
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol,
                               rtol=0, err_msg=label)
    np.testing.assert_array_equal(state.adj.numpy(),
                                  np.asarray(want_state.adj), err_msg=label)
    np.testing.assert_array_equal(state.num_nodes.numpy(),
                                  np.asarray(want_state.num_nodes),
                                  err_msg=label)
    assert state.adj.sum() > 0, f"{label}: no edges"
    return model


@pytest.mark.parametrize("fused_step", [True, False])
def test_dense_gcm_scan_with_selectors_matches_jax(monkeypatch, fused_step):
    """The README DenseGCM's scan with every selector configuration, T >
    graph_size (the ring wraps), episode ends and, for the stochastic
    selectors, the noise JAX drew."""
    for name in MODEL_CASES:
        check_scan(name, fused_step, monkeypatch)


def test_dense_gcm_step_from_hand_built_state_matches_jax(monkeypatch):
    """One step, fused and unfused, from a state with content at row and
    column num_nodes and a full batch element that wraps, for the selectors
    that read the old row and for the kernel's."""
    for name in ("cosine", "spatial", "learned", "temporal_learned",
                 "learned_stochastic", "aux_cosine_pe_add"):
        for fused_step in (True, False):
            monkeypatch.setattr(jax_config, "DENSE_FUSED_STEP", fused_step)
            jmodel, params, model = model_pair(name, fused_step)
            nodes, adj, num_nodes = hand_built_state(len(name), 0.3)
            num_nodes[0] = N  # full: this step wraps
            jstate = (nodes, adj, np.zeros((0,), np.float32), num_nodes)
            x = np.random.default_rng(9).standard_normal(
                (3, OBS)).astype(np.float32)
            key = jax.random.PRNGKey(11)
            want, want_state = jmodel(params, x, type(
                jmodel.initial_state(1, OBS))(*jstate), key=key)
            with torch.no_grad():
                got, state = model(t(x), state_from_numpy(jstate, "cpu"),
                                   noise=step_noise(jmodel, key, 3, N))
            label = f"{name} fused_step={fused_step}"
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=MODEL_CASES[name][1], rtol=0,
                                       err_msg=label)
            np.testing.assert_array_equal(state.adj.numpy(),
                                          np.asarray(want_state.adj),
                                          err_msg=label)


def test_stochastic_selectors_draw_from_generator():
    """With a generator and no noise, the same seed gives the same beliefs;
    with neither, a stochastic selector refuses to run."""
    _, _, model = model_pair("learned_stochastic")
    xs = torch.from_numpy(np.random.default_rng(12).standard_normal(
        (B, 6, OBS)).astype(np.float32))
    with torch.no_grad():
        runs = [model.scan(xs, model.initial_state(B, OBS),
                           generator=torch.Generator().manual_seed(s))[0]
                for s in (1, 1, 2)]
        assert torch.equal(runs[0], runs[1])
        assert not torch.equal(runs[0], runs[2])
        with pytest.raises(ValueError, match="generator= or noise="):
            model(xs[:, 0], model.initial_state(B, OBS))


def test_session_server_with_cosine_edge_matches_jax():
    """A few served ticks with CosineEdge, against the JAX server, and a
    snapshot/restore that continues bitwise."""
    jmodel, params, model = model_pair("cosine")
    jsrv = JaxSessionServer(jmodel, params, capacity=4, obs_dim=OBS)
    srv = SessionServer(model, capacity=4, obs_dim=OBS, device="cpu")
    rng = np.random.default_rng(13)
    restored = None
    for tick in range(24):
        sids = ["a"] + sorted(rng.choice(list("bcdef"), int(rng.integers(
            0, 4)), replace=False))
        obs = {s: rng.standard_normal(OBS).astype(np.float32) for s in sids}
        want, got = jsrv.step(obs), srv.step(obs)
        for s in sids:
            np.testing.assert_allclose(got[s], np.asarray(want[s]), atol=ATOL,
                                       rtol=0, err_msg=f"tick {tick} {s}")
        if restored is not None:
            again = restored.step(obs)
            for s in sids:
                np.testing.assert_array_equal(again[s], got[s])
        if tick == 10:
            _, _, fresh = model_pair("cosine")
            restored = SessionServer(fresh, capacity=4, obs_dim=OBS,
                                     device="cpu")
            restored.restore(srv.snapshot())
    np.testing.assert_array_equal(srv.state.adj.numpy(),
                                  np.asarray(jsrv.state.adj))
    assert srv.stats == jsrv.stats and srv.stats["evictions"] >= 1


def test_selectors_match_torch_reference():
    """The external anchor tests/test_torch_oracle.py holds the JAX model
    to, bench_reference.RefDenseGCM, for the dense, distance and learned
    selectors (graph_size 128, T = 32). Its nn.Linear weights are [out, in]
    and load transposed."""
    from bench_reference import RefDenseGCM

    def linear(m):
        p = {"kernel": m.weight.detach().numpy().T}
        if m.bias is not None:
            p["bias"] = m.bias.detach().numpy()
        return p

    selectors = {
        "dense": (DenseEdge(), ATOL),
        "euclidean": (EuclideanEdge(max_distance=1.0), ATOL),
        "cosine": (CosineEdge(max_distance=0.5), ATOL),
        "spatial": (SpatialEdge(max_distance=0.25, a_pose_slice=slice(0, 2)),
                    ATOL),
        "learned": (LearnedEdge(input_size=OBS, deterministic=True,
                                device="cpu"), ATOL_SPARDMAX),
    }
    for seed, (name, (sel, atol)) in enumerate(selectors.items()):
        torch.manual_seed(seed)
        ref = RefDenseGCM(OBS, HIDDEN, 128, selector=name)
        conv = [{"lin_rel": linear(c.lin_rel), "lin_root": linear(c.lin_root)}
                for c in (ref.conv1, ref.conv2)]
        params = {"preprocessor": [linear(ref.pre)],
                  "gnn": [conv[0], {}, conv[1], {}], "edge_selectors": {}}
        if name == "learned":
            params["edge_selectors"] = {"edge_network": [
                linear(m) if isinstance(m, torch.nn.Linear) else
                {"scale": m.weight.detach().numpy(),
                 "bias": m.bias.detach().numpy()}
                if isinstance(m, torch.nn.LayerNorm) else {}
                for m in ref.edge_mlp.net]}
        base = readme_dense_gcm(obs_size=OBS, device="cpu")
        model = DenseGCM(base.gnn, preprocessor=base.preprocessor,
                         edge_selectors=sel, graph_size=128, device="cpu")
        load_jax_params(model, params)
        xs = np.random.RandomState(seed + 1).randn(B, 32, OBS).astype(
            np.float32)
        hidden = (torch.zeros(B, 128, OBS), torch.zeros(B, 128, 128),
                  torch.zeros(B, dtype=torch.long))
        want = []
        with torch.no_grad():
            for step in range(32):
                mx, hidden = ref(t(xs[:, step]), hidden)
                want.append(mx)
            got, state = model.scan(t(xs), model.initial_state(B, OBS))
        torch.testing.assert_close(got, torch.stack(want, 1), atol=atol,
                                   rtol=0, msg=name)
        # the reference adds its straight-through sum hard + soft - soft,
        # which may miss 1.0 by an ulp
        torch.testing.assert_close(state.adj, hidden[1], rtol=0,
                                   atol=1e-6 if name == "learned" else 0,
                                   msg=name)
        assert state.num_nodes.tolist() == hidden[2].tolist(), name


def test_other_selector_takes_the_unfused_step():
    """A selector without a fused form (any callable of the dense selector
    API) runs in the unfused step, as in the JAX package."""
    base = readme_dense_gcm(obs_size=OBS, graph_size=N, device="cpu")

    def other(nodes, adj, weights, num_nodes, noise=None):
        return DenseEdge()(nodes, adj, weights, num_nodes)

    models = [DenseGCM(base.gnn, preprocessor=base.preprocessor,
                       edge_selectors=sel, graph_size=N, device="cpu")
              for sel in (other, DenseEdge())]
    xs = t(np.random.default_rng(14).standard_normal(
        (B, T, OBS)).astype(np.float32))
    with torch.no_grad():
        (got, got_state), (want, want_state) = (
            m.scan(xs, m.initial_state(B, OBS)) for m in models)
    assert torch.equal(got, want) and torch.equal(got_state.adj,
                                                  want_state.adj)
