"""The port's runtime modules against the JAX package, or its tests'
contracts, on the CPU: train/checkpoint.py, train/resilient.py,
serve/export.py, utils/debug.py, utils/precision.py, utils/roofline.py,
utils/indexing.py, utils/contracts.py and core/graph_state.py::
node_validity_mask.

- checkpoint: a parameter tree with a memory state saved and restored
  (NamedTuples back from the template, bitwise), the latest step,
  max_to_keep, no temporary file left (tests/test_train_utils.py's
  contract);
- resilient: a run of 4 updates, a restart and 2 more bitwise equal to 6
  straight; a fresh start;
- export: the README DenseGCM and its CosineEdge model exported, loaded
  and stepped 3 ticks, bitwise equal to the eager step and within 1e-5 of
  JAX's step with the same weights; a step that reaches another kernel
  refused by name; the ops reached only under export;
- nan_guard, assert_causal_edges against JAX, trace writing its file;
- cast_tree, param_count and summarize's total against JAX's on carried
  weights; every roofline calculator equal to JAX's dict given JAX's TPU
  constants; the indexing helpers and node_validity_mask equal to JAX's;
- the shape contracts of tests/test_validation.py::TestJaxtypingContracts.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcm_tpu.core.graph_state import \
    node_validity_mask as jax_node_validity_mask
from gcm_tpu.edges.distance import CosineEdge as JaxCosineEdge
from gcm_tpu.models.presets import readme_dense_gcm as jax_readme_dense_gcm
from gcm_tpu.utils import indexing as jax_indexing
from gcm_tpu.utils import roofline as jax_roofline
from gcm_tpu.utils.debug import assert_causal_edges as jax_causal
from gcm_tpu.utils.precision import param_count as jax_param_count
from gcm_tpu_torch import (A2C, CosineEdge, GCMActorCritic, RecallEnv,
                           TemporalBackedge, load_jax_params,
                           readme_dense_gcm, readme_sparse_gcm)
from gcm_tpu_torch.core.graph_state import node_validity_mask
from gcm_tpu_torch.serve.export import export_step, load_step
from gcm_tpu_torch.train.checkpoint import make_manager, restore, save
from gcm_tpu_torch.train.resilient import train_resilient
from gcm_tpu_torch.utils import contracts, indexing, roofline
from gcm_tpu_torch.utils.debug import (NAN_MESSAGE, assert_causal_edges,
                                       nan_guard, trace)
from gcm_tpu_torch.utils.precision import cast_tree, param_count, summarize

torch.set_num_threads(1)

OBS, B = 8, 4


def t(a):
    return torch.from_numpy(np.array(a))


def test_checkpoint_save_restore_latest_and_keep(tmp_path):
    """A {params, memory} tree round-trips bitwise, the memory state back
    as its NamedTuple through the template; restore without a step takes
    the latest; max_to_keep drops the oldest; no temporary file stays."""
    model = readme_dense_gcm(obs_size=4, hidden=8, graph_size=8,
                             device="cpu")
    with torch.no_grad():
        _, state = model.scan(torch.randn(2, 3, 4), model.initial_state(2, 4))
    tree = {"params": model.state_dict(), "memory": state, "step": 3}
    mgr = make_manager(str(tmp_path / "ck"), max_to_keep=2)
    save(mgr, 0, tree)
    got = restore(mgr, template=tree)
    assert type(got["memory"]) is type(state) and got["step"] == 3
    for a, b in zip(state, got["memory"]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for k, v in tree["params"].items():
        assert torch.equal(v, got["params"][k])
    plain = restore(mgr, 0)  # no template: the NamedTuple as its dict
    assert set(plain["memory"]) == set(state._fields)
    for step in (5, 7, 9):
        save(mgr, step, {"x": torch.full((3,), float(step))})
    assert mgr.all_steps() == [7, 9] and mgr.latest_step() == 9
    assert torch.equal(restore(mgr, template={"x": torch.zeros(3)})["x"],
                       torch.full((3,), 9.0))
    assert sorted(os.listdir(mgr.directory)) == ["step_7.pt", "step_9.pt"]
    with pytest.raises(FileNotFoundError):
        restore(make_manager(str(tmp_path / "empty")))


def resilient_trainer():
    env = RecallEnv(num_symbols=2, horizon=4, noise_dim=2, device="cpu")
    pol = GCMActorCritic(env.obs_dim, env.num_actions, env.num_actions,
                         graph_size=env.horizon + 1, gnn_input_size=8,
                         gnn_output_size=8,
                         edge_selectors=TemporalBackedge([1]), device="cpu",
                         generator=torch.Generator().manual_seed(0))
    return A2C(env, pol)


def test_resilient_resume_equals_uninterrupted(tmp_path):
    """tests/test_train_utils.py::TestResilientTraining's contract: 4
    updates, a restart asking for 6 (2 run), bitwise the parameters of 6
    straight; a fresh start runs every update."""
    def gen():
        return torch.Generator().manual_seed(7)

    full, _ = train_resilient(resilient_trainer(), str(tmp_path / "full"),
                              updates=6, B=4, generator=gen(),
                              checkpoint_every=2)
    train_resilient(resilient_trainer(), str(tmp_path / "crashed"),
                    updates=4, B=4, generator=gen(), checkpoint_every=2)
    resumed, hist = train_resilient(
        resilient_trainer(), str(tmp_path / "crashed"), updates=6, B=4,
        generator=gen(), checkpoint_every=2)
    assert len(hist) == 2
    for k in full:
        assert torch.equal(full[k], resumed[k]), k
    _, hist = train_resilient(resilient_trainer(), str(tmp_path / "fresh"),
                              updates=3, B=4, generator=gen(),
                              checkpoint_every=10)
    assert len(hist) == 3 and all(np.isfinite(h) for h in hist)


def test_export_round_trip_matches_eager_and_jax():
    """The README DenseGCM and its CosineEdge(0.5) model: the loaded step,
    3 ticks, bitwise the eager step's beliefs and states and within 1e-5
    of JAX's step with the same weights; the exported graph holds the
    served kernels' ops; a sparse step is refused, naming its kernel."""
    jbase = jax_readme_dense_gcm(obs_size=OBS, graph_size=16)
    params = jbase.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    xs = rng.standard_normal((3, B, OBS)).astype(np.float32)
    for cosine in (False, True):
        jmodel = jax_readme_dense_gcm(obs_size=OBS, graph_size=16)
        model = readme_dense_gcm(obs_size=OBS, graph_size=16, device="cpu")
        if cosine:
            jmodel.edge_selectors = JaxCosineEdge(0.5)
            model.edge_selectors = CosineEdge(0.5)
        load_jax_params(model, jax.tree_util.tree_map(np.asarray, params))
        state = model.initial_state(B, OBS)
        blob, exported = export_step(model, t(xs[0]), state)
        ops = {str(n.target) for n in exported.graph.nodes
               if str(n.target).startswith("gcm.")}
        assert "gcm.fused_dense_gnn.default" in ops
        assert ("gcm.sddmm_threshold_row_current.default" in ops) == cosine
        step = load_step(blob)
        jstep = jax.jit(jmodel.__call__)
        st_l = st_e = state
        jst = jmodel.initial_state(B, OBS)
        for x in xs:
            b_l, st_l = step(t(x), st_l)
            with torch.no_grad():
                b_e, st_e = model(t(x), st_e)
            jb, jst = jstep(params, x, jst)
            assert torch.equal(b_l, b_e)
            for a, b in zip(st_l, st_e):
                assert torch.equal(a, b)
            np.testing.assert_allclose(b_l.numpy(), np.asarray(jb),
                                       atol=1e-5, rtol=0)
    sparse = readme_sparse_gcm(graph_size=16, device="cpu")

    class SparseStep(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.core = sparse

        def forward(self, x, state):
            out, state = self.core(x[:, None],
                                   torch.ones(x.shape[0], dtype=torch.int32),
                                   state)
            return out[:, 0], state

    with pytest.raises(NotImplementedError, match="spmm_edge_list"):
        export_step(SparseStep(), t(xs[0]), sparse.initial_state(B, OBS))


def test_ops_only_under_export(monkeypatch):
    """The served kernels' torch.library ops are reached only while
    torch.export traces: with every op made to raise, the eager step of
    the CosineEdge model (rows 1 and 5) and a training call of rows 1 and 2
    run as before, and exporting the step reaches the op."""
    from gcm_tpu_torch.ops.cuda import dense_gconv, fused_gnn, sddmm

    def refuse(*args):
        raise AssertionError("an eager call reached a torch.library op")

    for mod, name in ((fused_gnn, "_op"), (dense_gconv, "_op"),
                      (sddmm, "_row_op"), (sddmm, "_current_op")):
        monkeypatch.setattr(mod, name, refuse)
    model = readme_dense_gcm(obs_size=OBS, graph_size=16, device="cpu")
    model.edge_selectors = CosineEdge(0.5)
    state = model.initial_state(B, OBS)
    x = t(np.random.default_rng(1).standard_normal((B, OBS)).astype(
        np.float32))
    with torch.no_grad():
        model(x, state)
    h = torch.ones((2, 16, 4), requires_grad=True)
    adj = torch.ones((2, 16, 16))
    w = torch.ones((4, 4), requires_grad=True)
    b = torch.zeros(4, requires_grad=True)
    out = fused_gnn.fused_dense_gnn(h, adj, (w, b, w), ("tanh",))
    out = dense_gconv.fused_dense_graph_conv(out, adj, w, b, w, "tanh")
    out.sum().backward()
    assert h.grad is not None and w.grad is not None
    with pytest.raises(AssertionError, match="torch.library op"):
        export_step(model, x, state)


def test_guards_and_trace(tmp_path):
    """nan_guard raises the reference's message on a NaN or infinity in any
    float output and passes a clean one; assert_causal_edges answers as
    JAX's on tests/test_train_utils.py's lists and random ones; trace
    writes its Chrome trace."""
    guarded = nan_guard(lambda x: (x / 0.0, {"ok": torch.ones(2)}))
    with pytest.raises(FloatingPointError, match=NAN_MESSAGE):
        guarded(torch.zeros(3))
    out = nan_guard(torch.tanh)(torch.ones(3))
    assert torch.allclose(out, torch.tanh(torch.ones(3)))
    rng = np.random.default_rng(0)
    lists = [np.array([[[3, 2, -1], [1, 0, -1]]], np.int32),
             np.array([[[1, -1], [2, -1]]], np.int32)]
    for _ in range(6):
        e = rng.integers(-1, 6, (2, 2, 7)).astype(np.int32)
        lists.append(e)
    for e in lists:
        assert bool(assert_causal_edges(t(e))) == bool(jax_causal(e))
    with trace(str(tmp_path / "prof")):
        torch.ones(4).sum()
    assert os.path.getsize(tmp_path / "prof" / "trace.json") > 0


def test_precision_and_roofline_match_jax():
    """cast_tree casts floats only; param_count and summarize's total equal
    JAX's on the README model's carried weights; every roofline calculator
    gives JAX's dict at JAX's TPU constants, and its own peaks are the
    H100's."""
    jbase = jax_readme_dense_gcm(obs_size=OBS, graph_size=16)
    params = jbase.init(jax.random.PRNGKey(0))
    model = readme_dense_gcm(obs_size=OBS, graph_size=16, device="cpu")
    load_jax_params(model, jax.tree_util.tree_map(np.asarray, params))
    assert param_count(model) == jax_param_count(params)
    assert summarize(model).splitlines()[-1].split()[-1] == \
        f"{jax_param_count(params):,}"
    state = model.initial_state(2, OBS)
    cast = cast_tree({"state": state, "w": [torch.ones(2)]})
    assert cast["state"].nodes.dtype == torch.bfloat16
    assert cast["state"].num_nodes.dtype == torch.int32
    assert cast["w"][0].dtype == torch.bfloat16
    assert type(cast["state"]) is type(state)
    chip = dict(hbm_bw=jax_roofline.HBM_BYTES_PER_S,
                flop_rate=jax_roofline.FLOPS_PER_S)
    calls = [("spmm", (64, 512, 8192, 128)), ("dense_scan_step", (32, 128,
                                                                  32)),
             ("banded_scan_step", (32, 128, 32)),
             ("ring_window_train", (32, 1024, 32)),
             ("nav_window", (16, 26, 24, 32)),
             ("nav_incremental_window", (16, 26, 24, 32))]
    for name, args in calls:
        assert getattr(roofline, name)(*args, **chip) == \
            getattr(jax_roofline, name)(*args), name
    assert (roofline.HBM_BYTES_PER_S, roofline.F32_FLOPS_PER_S,
            roofline.TF32_FLOPS_PER_S) == (3.35e12, 67e12, 495e12)


def test_indexing_helpers_match_jax():
    """The eight helpers and node_validity_mask against JAX's on ragged
    batches (zero lengths and a full cap included)."""
    rng = np.random.default_rng(3)
    for _ in range(2):
        Bn = int(rng.integers(2, 5))
        T = rng.integers(0, 6, Bn).astype(np.int32)
        taus = rng.integers(0, 4, Bn).astype(np.int32)
        cap = int((T + taus).sum()) + int(rng.integers(0, 3))
        for name in ("get_nonpadded_idxs", "get_new_node_idxs",
                     "get_valid_node_idxs", "make_flat_new_idx"):
            got = getattr(indexing, name)(t(T), t(taus), cap)
            want = getattr(jax_indexing, name)(jnp.asarray(T),
                                               jnp.asarray(taus), cap)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                              err_msg=name)
        for got, want in (
                (indexing.make_output_idx(t(taus), cap),
                 jax_indexing.make_output_idx(jnp.asarray(taus), cap)),
                (indexing.get_batch_offsets(t(taus)),
                 jax_indexing.get_batch_offsets(jnp.asarray(taus))),
                (indexing.front_back_ptr(t(T), t(taus)),
                 jax_indexing.front_back_ptr(jnp.asarray(T),
                                             jnp.asarray(taus))),
                ((indexing.causal_pair_mask(t(T), t(taus), 3, 8, window=2),
                  indexing.causal_pair_mask(t(T), t(taus), 3, 8)),
                 (jax_indexing.causal_pair_mask(jnp.asarray(T),
                                                jnp.asarray(taus), 3, 8,
                                                window=2),
                  jax_indexing.causal_pair_mask(jnp.asarray(T),
                                                jnp.asarray(taus), 3, 8))),
                ((node_validity_mask(t(T), 6),
                  node_validity_mask(t(T), 6, inclusive=True)),
                 (jax_node_validity_mask(jnp.asarray(T), 6),
                  jax_node_validity_mask(jnp.asarray(T), 6,
                                         inclusive=True)))):
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_shape_contracts(monkeypatch):
    """tests/test_validation.py::TestJaxtypingContracts: with contracts on,
    a [B, t, F] observation into the dense step and a taus batch other than
    x's into the sparse call raise TypeError naming the contract; a scan's
    dones of another batch too; off (the default), calls go through."""
    assert contracts.TYPECHECK is (os.environ.get("GCM_TYPECHECK") == "1")
    monkeypatch.setattr(contracts, "TYPECHECK", False)
    model = readme_dense_gcm(obs_size=4, hidden=8, graph_size=4,
                             device="cpu")
    with torch.no_grad():
        out, _ = model(torch.ones(1, 4), model.initial_state(1, 4))
    assert out.shape == (1, 8)
    monkeypatch.setattr(contracts, "TYPECHECK", True)
    state = model.initial_state(2, 4)
    with pytest.raises(TypeError, match="contract"):
        model(torch.ones(2, 1, 4), state)
    with pytest.raises(TypeError, match="contract"):
        model.scan(torch.ones(2, 3, 4), state,
                   dones=torch.zeros(3, 3, dtype=torch.bool))
    sparse = readme_sparse_gcm(obs_size=4, hidden=8, graph_size=8,
                               max_edges=16, device="cpu")
    with pytest.raises(TypeError, match="contract"):
        sparse(torch.ones(2, 3, 4), torch.ones(3, dtype=torch.int32),
               sparse.initial_state(2, 4))
    with torch.no_grad():
        out, _ = sparse(torch.ones(2, 3, 4), torch.ones(2, dtype=torch.int32),
                        sparse.initial_state(2, 4))
    assert out.shape == (2, 3, 8)
