"""The port's SparseGCM slice against the JAX package.

The same weights (moved with `load_jax_params`) and the same numpy inputs go
through the JAX functions and the port's on the CPU, where the port's
kernels take their plain versions: the scatter ops, TemporalEdge, the
sparse conv layers, SparseGCM in each configuration the port covers, its
scan, the state codecs, and the torch dense == sparse contract. Float
outputs agree within 1e-5 (float32 on both sides, only summation orders
differ); edge lists, counts and index outputs are exactly equal.

Cases of one check run in a loop inside one test (the failure message names
the case) rather than as separate parametrised items: the suite runs under
pytest-xdist's load scheduling, and every item collected after the heavy
tests/test_sharded_sparse.py cases lengthens the run's tail.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gcm_tpu.config as jax_config
from gcm_tpu.core.graph_state import reset_where as jax_reset_where
from gcm_tpu.core.graph_state import \
    sparse_initial_state as jax_sparse_initial_state
from gcm_tpu.edges.sparse_temporal import TemporalEdge as JaxTemporalEdge
from gcm_tpu.models import converters as jax_converters
from gcm_tpu.models.presets import readme_sparse_gcm as jax_readme_sparse_gcm
from gcm_tpu.models.sparse_gcm import SparseGCM as JaxSparseGCM
from gcm_tpu.nn import sparse_conv as jax_conv
from gcm_tpu.ops import scatter as jax_scatter
from gcm_tpu.ops.coalesce import coalesce_edges as jax_coalesce_edges
from gcm_tpu.utils import packing as jax_packing
from gcm_tpu_torch import (DenseGCM, DenseGNN, DenseGraphConv, GCNConv,
                           GraphConv, SparseGCM, SparseGNN, TemporalBackedge,
                           TemporalEdge, coalesce_edges, dense_to_sparse,
                           load_jax_params, pack_hidden, readme_dense_gcm,
                           readme_sparse_gcm, reset_where,
                           sparse_initial_state, sparse_state_from_numpy,
                           sparse_state_to_numpy, sparse_to_dense,
                           unpack_hidden)
from gcm_tpu_torch.ops import scatter
from gcm_tpu_torch.utils.validation import ShapeError

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def one_step_a_loop_iteration(monkeypatch):
    """JAX's scans unrolled once: unrolling changes how XLA compiles the
    loop (and how long it takes), not what it computes."""
    for knob in ("SCAN_UNROLL", "DENSE_SCAN_UNROLL", "RING_SCAN_UNROLL"):
        monkeypatch.setattr(jax_config, knob, 1)

ATOL = 1e-5
F, N, B, T = 6, 12, 3, 8


def T_(a):
    return torch.from_numpy(np.asarray(a))


def J(a):
    return jnp.asarray(np.asarray(a))


def np_params(params):
    return jax.tree_util.tree_map(np.asarray, params)


def random_padded_edges(Bn, Nn, E, seed, fill=0.5):
    """Random edges in the first `fill` of the lanes, sentinels after them
    and in a few lanes inside (sink only, source only, both)."""
    rng = np.random.default_rng(seed)
    edges = np.full((Bn, 2, E), -1, np.int32)
    n = int(E * fill)
    edges[:, :, :n] = rng.integers(0, Nn, (Bn, 2, n))
    edges[:, 0, 1:n:5] = -1
    edges[:, 1, 2:n:5] = -1
    w = rng.uniform(0.5, 1.5, (Bn, E)).astype(np.float32)
    return edges, w


def assert_close(got, want, **kw):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=0, **kw)


def assert_equal(got, want, **kw):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_array_equal(got, np.asarray(want), **kw)


# -- ops/scatter.py -----------------------------------------------------------

def test_rows_set_and_row_set():
    rng = np.random.default_rng(0)
    target = rng.standard_normal((B, N, F)).astype(np.float32)
    rows = rng.integers(0, N + 3, (B, 4)).astype(np.int32)
    rows[:, 1] = rows[:, 0]  # duplicates are masked off below
    mask = rng.random((B, 4)) < 0.6
    mask[:, 1] = False
    mask &= rows < N
    vals = rng.standard_normal((B, 4, F)).astype(np.float32)
    assert_equal(scatter.rows_set(T_(target), T_(rows), T_(vals), T_(mask)),
                 jax_scatter.rows_set(J(target), J(rows), J(vals), J(mask)))
    one = rows[:, 0]
    m1 = mask[:, 0]
    assert_equal(scatter.row_set(T_(target), T_(one), T_(vals[:, 0]),
                                 T_(m1)),
                 jax_scatter.row_set(J(target), J(one), J(vals[:, 0]),
                                     J(m1)))


def test_edge_scatter_ops():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, N, F)).astype(np.float32)
    edges, w = random_padded_edges(B, N, 20, seed=2)
    for ww in (None, w):
        assert_close(scatter.edge_scatter_add(T_(x), T_(edges),
                                              None if ww is None else T_(ww)),
                     jax_scatter.edge_scatter_add(
                         J(x), J(edges), None if ww is None else J(ww)))
    assert_equal(scatter.edge_mask(T_(edges)), jax_scatter.edge_mask(J(edges)))
    assert_equal(scatter.gather_nodes(T_(x), T_(edges[:, 1])),
                 jax_scatter.gather_nodes(J(x), J(edges[:, 1])))
    assert_equal(scatter.edge_scatter_count(T_(edges), N),
                 jax_scatter.edge_scatter_count(J(edges), N))
    assert_close(scatter.edge_weight_scatter_add(T_(edges), T_(w), N),
                 jax_scatter.edge_weight_scatter_add(J(edges), J(w), N))
    assert_equal(scatter.edge_scatter_max(T_(x), T_(edges), fill=-2.0),
                 jax_scatter.edge_scatter_max(J(x), J(edges), fill=-2.0))


def test_compaction_ops_exact():
    """bucket_rank, nonzero_padded (k below, at and above the count) and
    append_edges (fitting and overflowing) equal JAX's exactly."""
    rng = np.random.default_rng(3)
    keys = rng.integers(0, 7, (B, 40)).astype(np.int32)
    got = scatter.bucket_rank(T_(keys))
    assert got.dtype == torch.int32
    assert_equal(got, jax_scatter.bucket_rank(J(keys)))

    mask = rng.random((B, 16)) < 0.4
    mask[0] = False
    mask[1] = True
    for k in (5, 16, 30):
        got = scatter.nonzero_padded(T_(mask), k)
        want = jax_scatter.nonzero_padded(J(mask), k)
        for g, j in zip(got, want):
            assert_equal(g, j, err_msg=f"nonzero_padded k={k}")

    for E in (24, 9):
        edges, w = random_padded_edges(B, N, E, seed=5, fill=0.25)
        num = (edges[:, 0] >= 0).sum(-1).astype(np.int32)
        new_e = rng.integers(0, N, (B, 2, 7)).astype(np.int32)
        new_w = rng.uniform(0.5, 1.5, (B, 7)).astype(np.float32)
        new_valid = rng.random((B, 7)) < 0.7
        got = scatter.append_edges(T_(edges), T_(w), T_(num), T_(new_e),
                                   T_(new_w), T_(new_valid))
        want = jax_scatter.append_edges(J(edges), J(w), J(num), J(new_e),
                                        J(new_w), J(new_valid))
        for g, j in zip(got, want):
            assert_equal(g, j, err_msg=f"append_edges E={E}")
        assert got[0].dtype == torch.int32 and got[2].dtype == torch.int32


# -- edges/sparse_temporal.py ------------------------------------------------

def test_temporal_edge_grid_and_emit_exact():
    hops, t = (1, 3), 5
    rng = np.random.default_rng(7)
    nodes = np.zeros((B, N, 2), np.float32)
    Tn = np.array([0, 2, 6], np.int32)
    taus = np.array([5, 3, 0], np.int32)
    sel, jsel = TemporalEdge(hops), JaxTemporalEdge(hops)
    for seg in (None, rng.random((B, t, N)) < 0.7):
        kw_t = {} if seg is None else {"seg_mask": T_(seg)}
        kw_j = {} if seg is None else {"seg_mask": J(seg)}
        grid, _ = sel(T_(nodes), T_(Tn), T_(taus), t, **kw_t)
        jgrid, _ = jsel({}, J(nodes), J(Tn), J(taus), t, **kw_j)
        assert_equal(grid, jgrid, err_msg=f"grid, seg_mask {seg is not None}")
        got = sel.emit_edges(T_(nodes), T_(Tn), T_(taus), t, **kw_t)
        want = jsel.emit_edges({}, J(nodes), J(Tn), J(taus), t, **kw_j)
        for g, j in zip(got[:3], want[:3]):
            assert_equal(g, j, err_msg=f"emit, seg_mask {seg is not None}")
    assert sel.reach_bound_per_hop() == jsel.reach_bound_per_hop() == 3


# -- nn/sparse_conv.py --------------------------------------------------------

def conv_inputs(seed=8):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, N, F)).astype(np.float32)
    edges, w = random_padded_edges(B, N, 30, seed=seed + 1)
    return x, edges, w


def test_graph_conv_matches_jax():
    x, edges, w = conv_inputs()
    for aggr in ("add", "mean", "max"):
        jconv = jax_conv.GraphConv(F, 5, aggr=aggr)
        params = jconv.init(jax.random.PRNGKey(0))
        conv = GraphConv(F, 5, aggr=aggr, device="cpu")
        load_jax_params(conv, np_params(params))
        for ww in (None, w):
            want = jconv(params, J(x), J(edges),
                         None if ww is None else J(ww))
            with torch.no_grad():
                got = conv(T_(x), T_(edges), None if ww is None else T_(ww))
            assert_close(got, want,
                         err_msg=f"{aggr}, weights {ww is not None}")


def test_gcn_conv_matches_jax():
    x, edges, w = conv_inputs(seed=9)
    mask = np.arange(N)[None, :] < np.array([[4], [12], [9]])
    for improved, self_loops, with_mask in [
            (False, True, False), (True, True, True), (False, False, False)]:
        jconv = jax_conv.GCNConv(F, 5, improved=improved,
                                 add_self_loops=self_loops)
        params = jconv.init(jax.random.PRNGKey(1))
        params["bias"] = jnp.linspace(-0.5, 0.5, 5)  # a bias that is not 0
        conv = GCNConv(F, 5, improved=improved, add_self_loops=self_loops,
                       device="cpu")
        load_jax_params(conv, np_params(params))
        want = jconv(params, J(x), J(edges), J(w),
                     node_mask=J(mask) if with_mask else None)
        with torch.no_grad():
            got = conv(T_(x), T_(edges), T_(w),
                       node_mask=T_(mask) if with_mask else None)
        assert_close(got, want, err_msg=f"improved {improved}, self loops "
                     f"{self_loops}, node_mask {with_mask}")


def test_sparse_gnn_matches_jax():
    jgnn = jax_conv.SparseGNN([jax_conv.GraphConv(F, 8), jnp.tanh,
                               jax_conv.GCNConv(8, 8), jax.nn.relu,
                               jax_conv.GraphConv(8, 4, aggr="mean")])
    params = jgnn.init(jax.random.PRNGKey(2))
    gnn = SparseGNN([GraphConv(F, 8, device="cpu"), torch.tanh,
                     GCNConv(8, 8, device="cpu"), torch.relu,
                     GraphConv(8, 4, aggr="mean", device="cpu")])
    load_jax_params(gnn, np_params(params))
    x, edges, w = conv_inputs(seed=10)
    with torch.no_grad():
        got = gnn(T_(x), T_(edges), T_(w))
    assert_close(got, jgnn(params, J(x), J(edges), J(w)))


# -- models/sparse_gcm.py -----------------------------------------------------

def build_pair(hops=(1,), Nn=N, max_edges=64, obs=F, hidden=F, **kw):
    """The JAX SparseGCM and the port's, with one set of weights."""

    def jgnn():
        return jax_conv.SparseGNN([jax_conv.GraphConv(hidden, hidden),
                                   jnp.tanh,
                                   jax_conv.GraphConv(hidden, hidden),
                                   jnp.tanh])
    from gcm_tpu.nn.module import MLP as JaxMLP
    from gcm_tpu.nn.module import Linear as JaxLinear
    from gcm_tpu_torch import MLP, Linear

    jmodel = JaxSparseGCM(jgnn(), preprocessor=JaxMLP([JaxLinear(obs,
                                                                 hidden)]),
                          graph_size=Nn, max_edges=max_edges,
                          edge_selectors=JaxTemporalEdge(list(hops)), **kw)
    params = jmodel.init(jax.random.PRNGKey(0))
    gnn = SparseGNN([GraphConv(hidden, hidden, device="cpu"), torch.tanh,
                     GraphConv(hidden, hidden, device="cpu"), torch.tanh])
    model = SparseGCM(gnn, preprocessor=MLP([Linear(obs, hidden,
                                                    device="cpu")]),
                      graph_size=Nn, max_edges=max_edges,
                      edge_selectors=TemporalEdge(list(hops)), device="cpu",
                      **kw)
    load_jax_params(model, np_params(params))
    return jmodel, params, model


def window(Bn=B, t=T, obs=F, seed=11):
    return np.random.default_rng(seed).standard_normal(
        (Bn, t, obs)).astype(np.float32)


def assert_state_matches(state, jstate):
    got = sparse_state_to_numpy(state)
    for name in ("edges", "t", "num_edges"):
        assert_equal(getattr(got, name), getattr(jstate, name), err_msg=name)
    for name in ("nodes", "weights"):
        assert_close(getattr(got, name), getattr(jstate, name), err_msg=name)


CONFIGS = {
    "emit": dict(kw=dict(emit=True)),
    "grid": dict(kw=dict(emit=False)),
    "two_hops": dict(hops=(1, 3), kw=dict()),
    "ragged": dict(ragged=True, kw=dict()),
    "dones": dict(dones=True, kw=dict()),
    "dones_grid": dict(dones=True, hops=(1, 2), kw=dict(emit=False)),
    "max_hops": dict(kw=dict(max_hops=1)),
    "hop_cap": dict(hops=(1, 2), kw=dict(max_hops=1, hop_cap=10)),
    "slots": dict(hops=(1, 2), Nn=128, kw=dict(aggregation="slots",
                                               slot_k=2)),
    "capacity_drop": dict(max_edges=5, kw=dict()),
}


def check_config(name):
    """SparseGCM in configuration `name` against the JAX one over two
    chained windows (the second starts from a non-empty graph and, at
    N=12, carries t past graph_size, where both drop the writes)."""
    cfg = CONFIGS[name]
    Nn = cfg.get("Nn", N)
    jmodel, params, model = build_pair(
        hops=cfg.get("hops", (1,)), Nn=Nn,
        max_edges=cfg.get("max_edges", 64), **cfg["kw"])
    xs = window()
    taus = np.full((B,), T, np.int32)
    if cfg.get("ragged"):
        taus = np.array([2, 5, 8], np.int32)
        xs = np.where(np.arange(T)[None, :, None] < taus[:, None, None],
                      xs, 0.0).astype(np.float32)
    dones = None
    if cfg.get("dones"):
        dones = np.zeros((B, T), bool)
        dones[0, 2] = dones[1, 5] = dones[2, 0] = dones[2, 3] = True
    jstate = jmodel.initial_state(B, F)
    state = model.initial_state(B, F)
    for w in range(2):
        want, jstate, jaux = jmodel(params, J(xs), J(taus), jstate,
                                    return_aux=True,
                                    dones=None if dones is None else J(dones))
        with torch.no_grad():
            got, state, aux = model(T_(xs), T_(taus), state,
                                    return_aux=True,
                                    dones=None if dones is None
                                    else T_(dones))
        assert_close(got, want, err_msg=f"{name}, window {w}")
        assert_state_matches(state, jstate)
        assert set(aux) == set(jaux)
        for key in aux:
            assert_equal(aux[key], jaux[key], err_msg=f"{name}: {key}")
    if name == "capacity_drop":
        assert int(aux["dropped_edges"].min()) > 0
    if name == "ragged":
        assert not got[0, 2:].any() and not got[1, 5:].any()


def test_sparse_gcm_paths_match_jax():
    """emit True and False, two hops, ragged taus, dones."""
    for name in ("emit", "grid", "two_hops", "ragged", "dones"):
        check_config(name)


def test_sparse_gcm_options_match_jax():
    """dones on the grid path, max_hops, integer hop_cap, slots, and a
    capacity that drops edges."""
    for name in ("dones_grid", "max_hops", "hop_cap", "slots",
                 "capacity_drop"):
        check_config(name)


def test_kernels_get_contiguous_inputs(monkeypatch):
    """On the card the kernel wrappers refuse a non-contiguous tensor, so
    every tensor the model hands them must be contiguous; checked here, on
    the CPU, at the plain versions the wrappers take."""
    from gcm_tpu_torch.ops.cuda import spmm as spmm_mod
    from gcm_tpu_torch.ops.cuda import spmm_slots as slots_mod

    seen = []

    def contiguous_only(plain):
        def call(*args):
            assert all(a.is_contiguous() for a in args
                       if torch.is_tensor(a)), [a.stride() for a in args
                                                if torch.is_tensor(a)]
            seen.append(plain.__name__)
            return plain(*args)
        return call

    monkeypatch.setattr(spmm_mod, "spmm_edge_list_plain",
                        contiguous_only(spmm_mod.spmm_edge_list_plain))
    monkeypatch.setattr(slots_mod, "spmm_slots_plain",
                        contiguous_only(slots_mod.spmm_slots_plain))
    xs = T_(window())[:, ::2]  # a strided window
    taus = torch.full((B,), xs.shape[1], dtype=torch.int32)
    for name in ("emit", "grid", "dones", "hop_cap", "slots"):
        cfg = CONFIGS[name]
        _, _, model = build_pair(hops=cfg.get("hops", (1,)),
                                 Nn=cfg.get("Nn", N), **cfg["kw"])
        dones = torch.zeros((B, xs.shape[1]), dtype=torch.bool)
        dones[:, 1] = cfg.get("dones", False)
        state = model.initial_state(B, F)
        seen.clear()
        with torch.no_grad():
            for _ in range(2):
                _, state = model(xs, taus, state, dones=dones)
            model.scan(xs, state)
        assert len(seen) == 2 * (2 + xs.shape[1]), name


def test_scan_matches_jax():
    jmodel, params, model = build_pair(hops=(1, 2))
    xs = window(t=10, seed=12)
    for dones in (None, np.random.default_rng(13).random((B, 10)) < 0.2):
        want, jstate = jmodel.scan(params, J(xs), jmodel.initial_state(B, F),
                                   dones=None if dones is None else J(dones))
        with torch.no_grad():
            got, state = model.scan(T_(xs), model.initial_state(B, F),
                                    dones=None if dones is None
                                    else T_(dones))
        assert_close(got, want, err_msg=f"dones {dones is not None}")
        assert_state_matches(state, jstate)


def test_sparse_reset_restores_fills():
    jstate = jax_sparse_initial_state(B, N, F, 16)
    rng = np.random.default_rng(14)
    filled = [rng.standard_normal((B, N, F)).astype(np.float32),
              rng.integers(0, N, (B, 2, 16)).astype(np.int32),
              rng.random((B, 16)).astype(np.float32),
              np.array([3, 4, 5], np.int32), np.array([6, 7, 8], np.int32)]
    jstate = type(jstate)(*(J(a) for a in filled))
    done = np.array([True, False, True])
    want = jax_reset_where(jstate, J(done))
    got = reset_where(sparse_state_from_numpy(filled, "cpu"), T_(done))
    for g, j in zip(got, want):
        assert_equal(g, j)
    empty = sparse_initial_state(B, N, F, 16)
    for g, j in zip(empty, jax_sparse_initial_state(B, N, F, 16)):
        assert_equal(g, j)


# -- codecs -------------------------------------------------------------------

def test_pack_unpack_match_jax():
    edges, w = random_padded_edges(B, N, 12, seed=15, fill=0.8)
    num = (scatter.edge_mask(T_(edges))).sum(-1).numpy().astype(np.int32)
    nodes = window(t=N, seed=16)
    Tn = np.array([3, 7, 12], np.int32)
    state = [nodes, edges, w, Tn, num]
    for max_edges in (8, 20):  # a cut and a wider packing
        jpacked = jax_packing.pack_hidden(type(jax_sparse_initial_state(
            1, 1, 1, 1))(*(J(a) for a in state)), max_edges)
        packed = pack_hidden(sparse_state_from_numpy(state, "cpu"),
                             max_edges)
        for g, j in zip(packed, jpacked):
            assert_equal(g, j, err_msg=f"pack {max_edges}")
        for cap in (None, 12):
            got = unpack_hidden(packed, max_edges=cap)
            want = jax_packing.unpack_hidden(jpacked, max_edges=cap)
            for g, j in zip(got, want):
                assert_equal(g, j, err_msg=f"unpack {max_edges} {cap}")


def test_converters_match_jax():
    rng = np.random.default_rng(17)
    adj = (rng.random((B, N, N)) < 0.2) * rng.uniform(0.5, 2.0, (B, N, N))
    adj = adj.astype(np.float32)
    for cap in (None, 20):
        got = dense_to_sparse(T_(adj), max_edges=cap)
        want = jax_converters.dense_to_sparse(J(adj), max_edges=cap)
        for g, j in zip(got, want):
            assert_equal(g, j)
    edges, w = random_padded_edges(B, N, 30, seed=18)
    edges[:, :, 5] = edges[:, :, 4]  # a duplicate edge adds up
    assert_close(sparse_to_dense(T_(edges), T_(w), N),
                 jax_converters.sparse_to_dense(J(edges), J(w), N))
    assert_equal(sparse_to_dense(T_(edges), None, N),
                 jax_converters.sparse_to_dense(J(edges), None, N))
    back = sparse_to_dense(*dense_to_sparse(T_(adj)), N)
    assert_equal(back, adj)


def test_coalesce_edges_matches_jax():
    rng = np.random.default_rng(19)
    edges = rng.integers(0, 4, (B, 2, 24)).astype(np.int32)  # many dups
    edges[:, :, ::6] = -1
    w = rng.uniform(0.5, 1.5, (B, 24)).astype(np.float32)
    for reduce in ("sum", "mean", "min", "max"):
        got = coalesce_edges(T_(edges), T_(w), 4, reduce=reduce)
        want = jax_coalesce_edges(J(edges), J(w), 4, reduce=reduce)
        assert_equal(got[0], want[0], err_msg=reduce)
        assert_close(got[1], want[1], err_msg=reduce)
        assert_equal(got[2], want[2], err_msg=reduce)


# -- the torch dense == sparse contract ---------------------------------------

def torch_pair(Nn=N, max_edges=64, hops=(1,)):
    """A torch DenseGCM and SparseGCM over one set of weights, as
    tests/test_sparse_gcm.py::make_models builds the JAX pair."""
    g = torch.Generator().manual_seed(0)
    dconvs = [DenseGraphConv(F, F, device="cpu", generator=g)
              for _ in range(2)]
    sconvs = [GraphConv(F, F, device="cpu") for _ in range(2)]
    for d, s in zip(dconvs, sconvs):
        s.load_state_dict(d.state_dict())
    dense = DenseGCM(DenseGNN([dconvs[0], torch.tanh, dconvs[1],
                               torch.tanh]), graph_size=Nn,
                     edge_selectors=TemporalBackedge(list(hops)),
                     device="cpu")
    sparse = SparseGCM(SparseGNN([sconvs[0], torch.tanh, sconvs[1],
                                  torch.tanh]), graph_size=Nn,
                       max_edges=max_edges,
                       edge_selectors=TemporalEdge(list(hops)), device="cpu")
    return dense, sparse


@torch.no_grad()
def test_dense_equals_sparse_in_torch():
    dense, sparse = torch_pair()
    xs = T_(window())
    outs_d, final_d = dense.scan(xs, dense.initial_state(B, F))
    # sparse step by step
    outs_s, final_s = sparse.scan(xs, sparse.initial_state(B, F))
    torch.testing.assert_close(outs_s, outs_d, atol=ATOL, rtol=0)
    torch.testing.assert_close(final_s.nodes, final_d.nodes, atol=0, rtol=0)
    # sparse whole sequence, and the same data in two chained windows
    taus = torch.full((B,), T, dtype=torch.int32)
    outs_w, final_w = sparse(xs, taus, sparse.initial_state(B, F))
    torch.testing.assert_close(outs_w, outs_d, atol=ATOL, rtol=0)
    assert final_w.t.tolist() == [T] * B
    for b in range(B):
        e = final_w.edges[b]
        assert {(int(s), int(t)) for s, t in zip(e[0], e[1]) if s >= 0} \
            == {(i, i - 1) for i in range(1, T)}
    h = torch.full((B,), T // 2, dtype=torch.int32)
    oa, st = sparse(xs[:, :T // 2], h, sparse.initial_state(B, F))
    ob, _ = sparse(xs[:, T // 2:], h, st)
    torch.testing.assert_close(torch.cat([oa, ob], 1), outs_w, atol=ATOL,
                               rtol=0)
    # max_hops >= depth leaves the new nodes' outputs as they are
    sparse.max_hops = 2
    outs_h, _ = sparse(xs, taus, sparse.initial_state(B, F))
    torch.testing.assert_close(outs_h, outs_w, atol=1e-6, rtol=0)


@torch.no_grad()
def test_dense_equals_sparse_ragged_in_torch():
    dense, sparse = torch_pair()
    xs = window()
    taus = np.array([2, 5, 8], np.int32)
    padded = np.where(np.arange(T)[None, :, None] < taus[:, None, None], xs,
                      0.0).astype(np.float32)
    outs, final = sparse(T_(padded), T_(taus), sparse.initial_state(B, F))
    assert final.t.tolist() == [2, 5, 8]
    for b in range(B):
        tb = int(taus[b])
        outs_d, _ = dense.scan(T_(xs[b:b + 1, :tb]), dense.initial_state(1, F))
        torch.testing.assert_close(outs[b, :tb], outs_d[0], atol=ATOL, rtol=0)
        assert not outs[b, tb:].any()


@torch.no_grad()
def test_readme_sparse_gcm_matches_jax_and_dense():
    """The README's sparse workload at full width (obs 8, hidden 32, graph
    128, 512 edge slots) over a short window, against JAX; and the port's
    README dense model with the same weights, as the parity contract."""
    jmodel = jax_readme_sparse_gcm()
    params = jmodel.init(jax.random.PRNGKey(0))
    model = readme_sparse_gcm(device="cpu")
    load_jax_params(model, np_params(params))
    dense = readme_dense_gcm(device="cpu")
    load_jax_params(dense, np_params(params))
    xs = window(Bn=2, t=12, obs=8, seed=20)
    taus = np.full((2,), 12, np.int32)
    want, jstate = jmodel(params, J(xs), J(taus), jmodel.initial_state(2, 8))
    got, state = model(T_(xs), T_(taus), model.initial_state(2, 8))
    assert got.shape == (2, 12, 32)
    assert_close(got, want)
    assert_state_matches(state, jstate)
    outs_d, _ = dense.scan(T_(xs), dense.initial_state(2, 8))
    torch.testing.assert_close(got, outs_d, atol=ATOL, rtol=0)


def test_readme_models_of_one_seed_share_weights():
    sparse = readme_sparse_gcm(device="cpu", seed=3)
    dense = readme_dense_gcm(device="cpu", seed=3)
    s = dict(sparse.named_parameters())
    for name, p in dense.named_parameters():
        torch.testing.assert_close(s[name], p, atol=0, rtol=0)


# -- guards --------------------------------------------------------------------

def test_guards():
    """validate=True raises on bad shapes; check_overflow raises where the
    reference would; check_hop_overflow raises when hop_cap dropped
    reachable nodes."""
    model = readme_sparse_gcm(graph_size=16, max_edges=8, device="cpu",
                              validate=True)
    state = model.initial_state(2, 8)
    with pytest.raises(ShapeError, match="taus"):
        model(torch.zeros(2, 3, 8), torch.ones(3, dtype=torch.int32), state)
    with pytest.raises(ShapeError, match="nodes"):
        model(torch.zeros(2, 3, 5), torch.ones(2, dtype=torch.int32), state)
    model.check_overflow(state._replace(t=torch.tensor([10, 12],
                                                       dtype=torch.int32)),
                         torch.tensor([6, 4]))
    with pytest.raises(OverflowError):
        model.check_overflow(state._replace(t=torch.tensor(
            [10, 13], dtype=torch.int32)), torch.tensor([6, 4]))

    _, _, model = build_pair(hops=(1, 2), max_edges=64, max_hops=2,
                                  hop_cap=4)
    xs = window(t=4, seed=21)
    taus = torch.full((B,), 4, dtype=torch.int32)
    with torch.no_grad():
        _, state = model(T_(xs), taus, model.initial_state(B, F))
        _, _, aux = model(T_(xs), taus, state, return_aux=True)
    assert int(aux["hop_overflow"].max()) > 0
    with pytest.raises(RuntimeError, match="hop_cap"):
        model.check_hop_overflow(aux)


def test_unported_and_invalid_options_raise():
    """Invalid options raise ValueError; scan(unroll=) raises with its
    reason (every other option of the JAX SparseGCM is ported)."""
    for kw in [dict(aggregation="slots"),
               dict(aggregation="slots", slot_k=1, graph_size=64),
               dict(hop_cap=8), dict(hop_cap="some", max_hops=1),
               dict(hop_cap="auto", max_hops=1, aggregation="slots",
                    slot_k=1),
               dict(aggregation="sum"), dict(emit="yes")]:
        with pytest.raises(ValueError):
            readme_sparse_gcm(device="cpu", **kw)
    model = readme_sparse_gcm(graph_size=16, device="cpu")
    with pytest.raises(NotImplementedError, match="no eager meaning"):
        model.scan(torch.zeros(1, 2, 8), model.initial_state(1, 8), unroll=2)
