"""The port's flagship DenseGCM slice against the JAX package.

The same weights (moved with `load_jax_params`) and the same numpy inputs go
through the JAX model and the port's model on the CPU, where the port's
kernels take their plain versions: step by step, `scan` with wraparound
(T > graph_size) and with `dones`, on the JAX default (XLA) path and its
Pallas path (interpret mode), fused and unfused steps, the unfused GNN
(`fuse=""`), `pooled=True` (the README GNN's whole output, and a pooling
GNN), `validate=True` (the same ShapeErrors as JAX), and `SessionServer`
with churn and LRU eviction. Tolerance 1e-5: both sides compute in float32
and differ only in summation order.
"""

import re

import jax
import numpy as np
import pytest
import torch

import gcm_tpu.config as jax_config
from gcm_tpu.core.graph_state import reset_where as jax_reset_where
from gcm_tpu.models.dense_gcm import DenseGCM as JaxDenseGCM
from gcm_tpu.models.presets import readme_dense_gcm as jax_readme_dense_gcm
from gcm_tpu.core.graph_state import \
    sparse_initial_state as jax_sparse_initial_state
from gcm_tpu.nn.dense_conv import DenseGNN as JaxDenseGNN
from gcm_tpu.nn.dense_conv import DenseGraphConv as JaxDenseGraphConv
from gcm_tpu.utils.validation import ShapeError as JaxShapeError
from gcm_tpu.serve.sessions import SessionServer as JaxSessionServer
from gcm_tpu_torch import (DenseGCM, DenseGNN, DenseGraphConv, SessionServer,
                           load_jax_params, readme_dense_gcm, reset_where,
                           sparse_initial_state, state_from_numpy,
                           state_to_numpy)
from gcm_tpu_torch.models.dense_gcm import FAST_CORES
from gcm_tpu_torch.utils.validation import ShapeError

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def one_step_a_loop_iteration(monkeypatch):
    """JAX's scans unrolled once: unrolling changes how XLA compiles the
    loop (and how long it takes), not what it computes."""
    for knob in ("SCAN_UNROLL", "DENSE_SCAN_UNROLL", "RING_SCAN_UNROLL"):
        monkeypatch.setattr(jax_config, knob, 1)

ATOL = 1e-5
OBS, N, B, T = 8, 16, 4, 24


def build_pair(fused_step=True, fuse="auto"):
    jax_model = jax_readme_dense_gcm(obs_size=OBS, graph_size=N)
    params = jax_model.init(jax.random.PRNGKey(0))
    model = readme_dense_gcm(obs_size=OBS, graph_size=N, device="cpu")
    load_jax_params(model, jax.tree_util.tree_map(np.asarray, params))
    model.fused_step = fused_step
    if not fuse:
        jax_model = JaxDenseGCM(
            JaxDenseGNN(jax_model.gnn.layers, fuse=""),
            preprocessor=jax_model.preprocessor,
            edge_selectors=jax_model.edge_selectors, graph_size=N)
        model = DenseGCM(DenseGNN(model.gnn.layers, fuse=""),
                         preprocessor=model.preprocessor,
                         edge_selectors=model.edge_selectors, graph_size=N,
                         fused_step=fused_step, device="cpu")
    return jax_model, params, model


def inputs(seed=0):
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((B, T, OBS)).astype(np.float32)
    dones = rng.random((B, T)) < 0.1
    return xs, dones


def set_jax_path(monkeypatch, path, fused_step):
    monkeypatch.setattr(jax_config, "DENSE_FUSED_STEP", fused_step)
    if path == "pallas":
        monkeypatch.setattr(jax_config, "USE_PALLAS", True)
        monkeypatch.setattr(jax_config, "PALLAS_DENSE_GCONV", True)


def assert_state_close(state, jax_state):
    got = state_to_numpy(state)
    for name in ("nodes", "adj", "num_nodes"):
        np.testing.assert_allclose(getattr(got, name),
                                   np.asarray(getattr(jax_state, name)),
                                   atol=ATOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("path,fused_step,with_dones", [
    ("xla", True, False),
    ("xla", True, True),
    ("xla", False, True),
    ("pallas", True, True),
    ("pallas", False, False),
])
def test_scan_matches_jax(monkeypatch, path, fused_step, with_dones):
    set_jax_path(monkeypatch, path, fused_step)
    jax_model, params, model = build_pair(fused_step)
    xs, dones = inputs()
    dones = dones if with_dones else None
    want, want_state = jax_model.scan(params, xs,
                                      jax_model.initial_state(B, OBS),
                                      dones=dones)
    with torch.no_grad():
        got, state = model.scan(
            torch.from_numpy(xs), model.initial_state(B, OBS),
            dones=None if dones is None else torch.from_numpy(dones))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    assert_state_close(state, want_state)
    assert int(state.num_nodes.max()) <= N


@pytest.mark.parametrize("fused_step", [True, False])
@pytest.mark.parametrize("with_dones", [False, True])
def test_step_by_step_matches_jax(monkeypatch, fused_step, with_dones):
    set_jax_path(monkeypatch, "xla", fused_step)
    jax_model, params, model = build_pair(fused_step)
    xs, dones = inputs(seed=1)
    jax_state = jax_model.initial_state(B, OBS)
    state = model.initial_state(B, OBS)
    with torch.no_grad():
        for t in range(T):
            want, jax_state = jax_model(params, xs[:, t], jax_state)
            got, state = model(torch.from_numpy(xs[:, t]), state)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=ATOL, rtol=0, err_msg=f"t={t}")
            if with_dones:
                jax_state = jax_reset_where(jax_state, dones[:, t])
                state = reset_where(state, torch.from_numpy(dones[:, t]))
    assert_state_close(state, jax_state)


@pytest.mark.parametrize("path", ["xla", "pallas"])
def test_unfused_gnn_matches_jax(monkeypatch, path):
    """DenseGNN(fuse=""): each DenseGraphConv goes through dense_graph_conv
    (the single-layer kernel's plain version here, Pallas on the JAX
    side's Pallas path)."""
    set_jax_path(monkeypatch, path, True)
    jax_model, params, model = build_pair(fuse="")
    xs, dones = inputs(seed=2)
    want, want_state = jax_model.scan(params, xs,
                                      jax_model.initial_state(B, OBS),
                                      dones=dones)
    with torch.no_grad():
        got, state = model.scan(torch.from_numpy(xs),
                                model.initial_state(B, OBS),
                                dones=torch.from_numpy(dones))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    assert_state_close(state, want_state)


class JaxMeanPoolGNN:
    """One tanh DenseGraphConv, then the mean over the nodes: a pooling
    GNN, as tests/test_dense_gcm_options.py builds it."""

    def __init__(self, f):
        self.conv = JaxDenseGraphConv(f, f)

    def init(self, key):
        return {"conv": self.conv.init(key)}

    def __call__(self, params, x, adj, weights=None):
        return jax.numpy.tanh(self.conv(params["conv"], x, adj)).mean(axis=1)


class MeanPoolGNN(torch.nn.Module):
    def __init__(self, f):
        super().__init__()
        self.conv = DenseGraphConv(f, f, device="cpu")

    def forward(self, x, adj, weights=None):
        return torch.tanh(self.conv(x, adj)).mean(dim=1)


@pytest.mark.parametrize("fused_step", [True, False])
def test_pooled_matches_jax(monkeypatch, fused_step):
    """pooled=True: the belief is the GNN's whole output, [B, N, 32] for the
    README stack (step by step and scanned, past graph_size, with dones)
    and [B, OBS] for a pooling GNN."""
    set_jax_path(monkeypatch, "xla", fused_step)
    jbase, params, base = build_pair(fused_step)
    jmodel = JaxDenseGCM(jbase.gnn, preprocessor=jbase.preprocessor,
                         edge_selectors=jbase.edge_selectors, graph_size=N,
                         pooled=True)
    model = DenseGCM(base.gnn, preprocessor=base.preprocessor,
                     edge_selectors=base.edge_selectors, graph_size=N,
                     pooled=True, fused_step=fused_step, device="cpu")
    xs, dones = inputs(seed=5)
    jstate, state = jmodel.initial_state(B, OBS), model.initial_state(B, OBS)
    with torch.no_grad():
        for t in range(3):
            want, jstate = jmodel(params, xs[:, t], jstate)
            got, state = model(torch.from_numpy(xs[:, t]), state)
            assert got.shape == (B, N, 32)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=ATOL, rtol=0, err_msg=f"t={t}")
        want, jstate = jmodel.scan(params, xs, jmodel.initial_state(B, OBS),
                                   dones=dones)
        got, state = model.scan(torch.from_numpy(xs),
                                model.initial_state(B, OBS),
                                dones=torch.from_numpy(dones))
    assert got.shape == (B, T, N, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    assert_state_close(state, jstate)

    jmodel = JaxDenseGCM(JaxMeanPoolGNN(OBS), graph_size=N, pooled=True,
                         edge_selectors=jbase.edge_selectors)
    params = jmodel.init(jax.random.PRNGKey(1))
    model = DenseGCM(MeanPoolGNN(OBS), graph_size=N, pooled=True,
                     edge_selectors=base.edge_selectors,
                     fused_step=fused_step, device="cpu")
    load_jax_params(model.gnn.conv, jax.tree_util.tree_map(
        np.asarray, params["gnn"]["conv"]))
    want, _ = jmodel.scan(params, xs[:, :6], jmodel.initial_state(B, OBS))
    with torch.no_grad():
        got, _ = model.scan(torch.from_numpy(xs[:, :6]),
                            model.initial_state(B, OBS))
    assert got.shape == (B, 6, OBS)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def test_validate_raises_like_jax():
    """validate=True: each input that check_dense_inputs names is refused
    by both with a ShapeError on the same field; a good step passes."""
    jbase, params, base = build_pair()
    jmodel = JaxDenseGCM(jbase.gnn, preprocessor=jbase.preprocessor,
                         edge_selectors=jbase.edge_selectors, graph_size=N,
                         validate=True)
    model = DenseGCM(base.gnn, preprocessor=base.preprocessor,
                     edge_selectors=base.edge_selectors, graph_size=N,
                     validate=True, device="cpu")
    x = np.ones((B, OBS), np.float32)
    good = jmodel.initial_state(B, OBS)
    np_good = state_to_numpy(model.initial_state(B, OBS))
    cases = {
        "sparse state": (x, None, "DenseGraphState"),
        "x rank": (x[None], np_good, "x must be"),
        "x width": (x[:, :5], np_good, "nodes must be"),
        "x batch": (x[:3], np_good, "nodes must be"),
        "adj": (x, np_good._replace(adj=np_good.adj[:, :, :5]),
                "adj must be"),
        "weights": (x, np_good._replace(weights=np.zeros((B, N, 3),
                                                         np.float32)),
                    "weights must be"),
        "num_nodes shape": (x, np_good._replace(
            num_nodes=np.zeros((B, 1), np.int32)), "num_nodes must be"),
        "num_nodes dtype": (x, np_good._replace(
            num_nodes=np.zeros((B,), np.float32)), "num_nodes must be"),
        "x dtype": (x.astype(np.int32), np_good, "x must be floating"),
    }
    for name, (xx, st, match) in cases.items():
        if st is None:
            jst = jax_sparse_initial_state(B, N, OBS, 8)
            tst = sparse_initial_state(B, N, OBS, 8)
        else:
            jst = type(good)(*(jax.numpy.asarray(a) for a in st))
            tst = type(base.initial_state(1, 1))(*(torch.from_numpy(
                np.asarray(a)) for a in st))
        with pytest.raises(JaxShapeError, match=match):
            jmodel(params, jax.numpy.asarray(xx), jst)
        with pytest.raises(ShapeError, match=match), torch.no_grad():
            model(torch.from_numpy(xx), tst)
    with torch.no_grad():
        model(torch.from_numpy(x), model.initial_state(B, OBS))


def test_scan_refuses_reverse_and_unknown_remat():
    """remat="reverse" is the JAX package's reversible scan, not yet in the
    port: it raises, naming the roadmap item, with or without dones, and
    never falls back to per-step checkpointing; any other non-bool remat
    is refused. remat=True gives remat=False's beliefs."""
    _, _, model = build_pair()
    xs, dones = inputs(seed=5)
    xs, dones = torch.from_numpy(xs), torch.from_numpy(dones)
    st = model.initial_state(B, OBS)
    for d in (None, dones):
        with pytest.raises(NotImplementedError, match=re.escape(FAST_CORES)):
            model.scan(xs, st, dones=d, remat="reverse")
    for bad in ("per_step", 4, None):
        with pytest.raises(ValueError, match="remat"):
            model.scan(xs, st, remat=bad)
    with torch.no_grad():
        want, _ = model.scan(xs, st, dones=dones)
        got, _ = model.scan(xs, st, dones=dones, remat=True)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_state_round_trip_from_jax():
    jax_model, params, model = build_pair()
    xs, _ = inputs(seed=3)
    _, jax_state = jax_model.scan(params, xs, jax_model.initial_state(B, OBS))
    state = state_from_numpy(jax_state, "cpu")
    assert state.num_nodes.dtype == torch.int32
    assert_state_close(state, jax_state)
    # continue both from the carried-over state
    want, _ = jax_model(params, xs[:, 0], jax_state)
    with torch.no_grad():
        got, _ = model(torch.from_numpy(xs[:, 0]), state)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("graph_size,steps", [(128, 32), (8, 24)],
                         ids=["readme", "wraparound"])
def test_matches_torch_reference(graph_size, steps):
    """The external anchor tests/test_torch_oracle.py holds the JAX model
    to: bench_reference.RefDenseGCM, the reference's DenseGCM step in plain
    torch. Its nn.Linear weights are [out, in], so they load transposed."""
    from bench_reference import RefDenseGCM

    torch.manual_seed(0)
    ref = RefDenseGCM(OBS, 32, graph_size, selector="temporal")

    def linear(m):
        p = {"kernel": m.weight.detach().numpy().T}
        if m.bias is not None:
            p["bias"] = m.bias.detach().numpy()
        return p

    conv = [{"lin_rel": linear(c.lin_rel), "lin_root": linear(c.lin_root)}
            for c in (ref.conv1, ref.conv2)]
    model = readme_dense_gcm(obs_size=OBS, graph_size=graph_size,
                             device="cpu")
    load_jax_params(model, {"preprocessor": [linear(ref.pre)],
                            "gnn": [conv[0], {}, conv[1], {}],
                            "edge_selectors": {}})
    xs = np.random.default_rng(7).standard_normal(
        (B, steps, OBS)).astype(np.float32)
    hidden = (torch.zeros(B, graph_size, OBS),
              torch.zeros(B, graph_size, graph_size),
              torch.zeros(B, dtype=torch.long))
    want = []
    with torch.no_grad():
        for t in range(steps):
            mx, hidden = ref(torch.from_numpy(xs[:, t]), hidden)
            want.append(mx)
        got, state = model.scan(torch.from_numpy(xs),
                                model.initial_state(B, OBS))
    torch.testing.assert_close(got, torch.stack(want, 1), atol=ATOL, rtol=0)
    torch.testing.assert_close(state.nodes, hidden[0], atol=0, rtol=0)
    torch.testing.assert_close(state.adj, hidden[1], atol=0, rtol=0)
    assert state.num_nodes.tolist() == hidden[2].tolist()


def request_script(ticks=30, seed=4):
    """Per tick: the session ids that send a request, the observations, and
    the ids whose sessions end after the tick. Six ids over a pool of four
    force LRU evictions; s0 requests every tick, so its stream outgrows
    graph_size and wraps around."""
    rng = np.random.default_rng(seed)
    script = []
    for t in range(ticks):
        k = int(rng.integers(1, 4))
        sids = ["s0"] + [f"s{i}" for i in sorted(
            rng.choice(np.arange(1, 6), size=k, replace=False))]
        obs = {sid: rng.standard_normal(OBS).astype(np.float32)
               for sid in sids}
        ends = [f"s{int(rng.integers(1, 6))}"] if t % 7 == 6 else []
        script.append((obs, ends))
    return script


def test_session_server_matches_jax():
    jax_model, params, model = build_pair()
    jax_srv = JaxSessionServer(jax_model, params, capacity=4, obs_dim=OBS)
    srv = SessionServer(model, capacity=4, obs_dim=OBS, device="cpu")
    restored = None
    script = request_script()
    for t, (obs, ends) in enumerate(script):
        want = jax_srv.step(obs)
        got = srv.step(obs)
        assert set(got) == set(want)
        for sid in obs:
            np.testing.assert_allclose(got[sid], np.asarray(want[sid]),
                                       atol=ATOL, rtol=0,
                                       err_msg=f"tick {t} {sid}")
        if restored is not None:
            again = restored.step(obs)
            for sid in obs:
                np.testing.assert_array_equal(again[sid], got[sid])
        for sid in ends:
            for s in (jax_srv, srv, restored):
                if s is not None:
                    s.end_session(sid)
        assert srv.stats == jax_srv.stats
        assert srv.num_active == jax_srv.num_active
        if t == len(script) // 2:
            fresh = readme_dense_gcm(obs_size=OBS, graph_size=N,
                                     device="cpu", seed=1)
            load_jax_params(fresh, jax.tree_util.tree_map(np.asarray, params))
            restored = SessionServer(fresh, capacity=4, obs_dim=OBS,
                                     device="cpu")
            restored.restore(srv.snapshot())
    assert srv.stats["evictions"] >= 1
    assert int(srv.state.num_nodes.max()) == N  # some session wrapped
