"""The port's node-sharded SparseGCM (gcm_tpu_torch/parallel/
sharded_sparse.py) and partitioned aggregation (parallel/
edge_partition.py) against the JAX package's, on the CPU.

One spawned world of 4 gloo ranks computes every case
(`parallel/cases.py::run_cases`; d = 4 on make_mesh(4, 1), d = 2 on the
dp axis of make_mesh(2, 2)); the JAX references, JAX's sharded modules on
conftest's virtual CPU devices and the replicated SparseGCM, run here from
the same numpy weights and inputs. Mirrors tests/test_sharded_sparse.py,
tests/test_edge_partition.py and tests/test_multihost.py:

- multi-window beliefs against both JAX cores (1e-5); node buffers and
  edge SETS exact; the per-rank cursors summing to the replicated count;
- the windowed learned selector on the halo path, the unwindowed one on
  the psum path, their stats aux, the chain, and the gradients of every
  parameter against jax.grad of the replicated core (1e-4);
- where the port differs from JAX's sharded core and follows the
  replicated SparseGCM instead (ROADMAP Queue 3): windows whose t shrinks
  under a windowed learned selector, and the per-rank append overflow in
  aux["dropped_edges"];
- refusals (stochastic selector, unsupported chain member, dones, a halo
  too wide) and SparseGCMActorCritic(mesh=) against JAX's adapter;
- each partitioned SpMM and its gradient against edge_scatter_add and
  jax.grad; bucketing preserving edges; PartitionedSparseGNN's halo,
  bucketed and psum modes inside SparseGCM (beliefs, gradients), its auto
  dispatch and the halo model's Adam step against optax;
- tests/test_multihost.py's update on 2 ranks against one process (rtol
  1e-6) and its sharded SparseGCM checksum.
"""

from concurrent.futures import Future, ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gcm_tpu.edges.sparse_learned import LearnedEdge as JaxSparseLearned
from gcm_tpu.edges.sparse_spatial import SparseEdgeChain as JaxChain
from gcm_tpu.edges.sparse_temporal import TemporalEdge as JaxTemporalEdge
from gcm_tpu.models.sparse_gcm import SparseGCM as JaxSparseGCM
from gcm_tpu.nn.module import MLP as JaxMLP
from gcm_tpu.nn.module import Linear as JaxLinear
from gcm_tpu.nn.sparse_conv import GraphConv as JaxGraphConv
from gcm_tpu.nn.sparse_conv import SparseGNN as JaxSparseGNN
from gcm_tpu.ops.scatter import edge_scatter_add as jax_scatter_add
from gcm_tpu.parallel import edge_partition as jep
from gcm_tpu.parallel.mesh import make_mesh as jax_mesh
from gcm_tpu.parallel.sharded_sparse import \
    ShardedSparseGCM as JaxShardedSparseGCM
from gcm_tpu.rl.wrappers import SparseGCMActorCritic as JaxAdapter
from gcm_tpu_torch import (GraphConv, SparseGCM, SparseGNN, TemporalEdge,
                           jax_paths)
from gcm_tpu_torch.parallel.cases import build_sparse_pair, run_cases
from gcm_tpu_torch.parallel.distributed import spawn_world
from gcm_tpu_torch.parallel.mesh import make_mesh
from gcm_tpu_torch.parallel.sharded_sparse import (merge_sparse_states,
                                                   shard_sparse_state)
from tests import multihost_common as mh

B, OBS, HID = 3, 6, 8
OUT_TOL, GRAD_TOL = 1e-5, 1e-4
JAX_THREADS = 4


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_selector(kind):
    if kind[0] == "temporal":
        return JaxTemporalEdge(list(kind[1]))
    if kind[0] == "learned":
        return JaxSparseLearned(input_size=OBS, deterministic=True,
                                num_edge_samples=3, window=kind[1])
    return JaxChain([jax_selector(k) for k in kind[1]])


def jax_pair(spec):
    """tests/test_sharded_sparse.py's build_pair on d virtual devices."""
    stack = []
    for _ in range(2):
        stack += [JaxGraphConv(HID, HID), jnp.tanh]
    pre = JaxMLP([JaxLinear(OBS, HID)])
    single = JaxSparseGCM(JaxSparseGNN(stack), preprocessor=pre,
                          edge_selectors=jax_selector(spec["sel"]),
                          graph_size=spec["N"], max_edges=spec["E"])
    sharded = JaxShardedSparseGCM(
        stack, jax_mesh(dp=spec["d"], tp=1), axis="dp", preprocessor=pre,
        edge_selectors=jax_selector(spec["sel"]), graph_size=spec["N"],
        max_edges=spec["E"])
    return single, sharded, single.init(jax.random.PRNGKey(spec["seed"]))


def windows(seed, shapes):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((B, t, OBS)).astype(np.float32),
             np.asarray(taus, np.int32)) for t, taus in shapes]


def sparse_case(d, sel, shapes, seed, N=64, E=256, grad=True,
                jax_sharded=True):
    spec = {"d": d, "sel": sel, "N": N, "E": E, "obs": OBS, "hid": HID,
            "B": B, "seed": seed, "windows": windows(seed, shapes)}
    single, sharded, params = jax_pair(spec)
    spec["params"] = np_tree(params)
    if grad:
        spec["grad_window"] = windows(seed + 100, [(4, [4] * B)])[0]
    return spec, lambda: sparse_refs(spec, single, sharded, params,
                                     jax_sharded)


def sparse_refs(spec, single, sharded, params, jax_sharded):
    ref = {"single": [], "sharded": []}
    ss, sh = single.initial_state(B, OBS), sharded.initial_state(B, OBS)
    f_single = jax.jit(lambda p, x, t, st: single(p, x, t, st,
                                                  return_aux=True))
    f_sharded = jax.jit(lambda p, x, t, st: sharded(p, x, t, st))
    for xs, taus in spec["windows"]:
        out, ss, aux = f_single(params, jnp.asarray(xs), jnp.asarray(taus),
                                ss)
        ref["single"].append(np.asarray(out))
        ref.setdefault("single_aux", aux)
        if jax_sharded:
            out, sh = f_sharded(params, jnp.asarray(xs), jnp.asarray(taus),
                                sh)
            ref["sharded"].append(np.asarray(out))
    ref["state"] = np_tree(ss)
    if jax_sharded:
        ref["sharded_state"] = np_tree(sh)
    ref["spec"] = {k: spec[k] for k in ("sel", "N", "E", "obs", "hid")}
    if "grad_window" in spec:
        xs, taus = spec["grad_window"]

        def loss(p):
            out, _ = single(p, jnp.asarray(xs), jnp.asarray(taus),
                            single.initial_state(B, OBS))
            return jnp.sum(out ** 2)

        ref["grads"] = np_tree(jax.jit(jax.grad(loss))(params))
    return ref


def edge_set(edges, weights, b):
    e, w = np.asarray(edges[b]), np.asarray(weights[b])
    ok = (e[0] >= 0) & (e[1] >= 0)
    return {(int(s), int(r), round(float(x), 5))
            for s, r, x in zip(e[0][ok], e[1][ok], w[ok])}


def spmm_case(seed, d, N=32, E=64, F=16, window=3):
    k_pair = 64 // d  # room for every (source, sink) shard pair's edges
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((4, N, F)).astype(np.float32)
    edges = rng.integers(0, N, (4, 2, E)).astype(np.int32)
    edges[:, :, -8:] = -1
    w = rng.random((4, E)).astype(np.float32)
    sinks, srcs = zip(*[(i, i - h) for i in range(N)
                        for h in range(1, window + 1) if i - h >= 0])
    band = np.broadcast_to(np.array([sinks, srcs], np.int32)[None],
                           (4, 2, len(sinks))).copy()
    band_w = rng.random((4, len(sinks))).astype(np.float32)
    spec = {"d": d, "x": x, "edges": edges, "w": w, "k_pair": k_pair,
            "halo": window, "band_edges": band, "band_w": band_w}
    return spec, lambda: spmm_refs(spec, jnp.asarray(x), jnp.asarray(edges),
                                   jnp.asarray(w), jnp.asarray(band),
                                   jnp.asarray(band_w), d, N, k_pair)


def spmm_refs(spec, x, edges, w, band, band_w, d, N, k_pair):
    @jax.jit
    def fwd_grad(e, ww):
        y = jax_scatter_add(x, e, ww)
        g = jax.grad(lambda x_: jnp.sum(jax_scatter_add(x_, e, ww) ** 2))(x)
        return y, g

    ref = {"plain": np_tree(fwd_grad(edges, w)),
           "band": np_tree(fwd_grad(band, band_w))}
    if d == 4:  # JAX's partitioned SpMM itself, on d virtual devices
        mesh = jax_mesh(dp=d, tp=1)
        be, bw = jep.bucket_edges_cross(edges, w, d, N, k_pair=k_pair)
        ref["jax_bucketed"] = np.asarray(jax.jit(jep.spmm_bucketed(
            mesh, num_nodes=N))(x, be, bw))
    return ref


def partitioned_case(mode, d, seed=0, train=False, **gnn_kw):
    F, N, T, Bp = 6, 16, 8, 4
    layers = [JaxGraphConv(F, F), jnp.tanh, JaxGraphConv(F, F), jnp.tanh]
    plain = JaxSparseGCM(JaxSparseGNN(layers), graph_size=N,
                         max_edges=8 * N, edge_selectors=JaxTemporalEdge(
                             [1, 2]))
    params = plain.init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 1)
    xs = jnp.asarray(rng.standard_normal((Bp, T, F)).astype(np.float32))
    taus = jnp.full((Bp,), T, jnp.int32)
    spec = {"d": d, "F": F, "N": N, "E": 8 * N, "hops": (1, 2),
            "mode": mode, "num_nodes": N, "gnn_kw": gnn_kw,
            "params": np_tree(params), "xs": np.asarray(xs),
            "taus": np.asarray(taus)}
    if train:
        spec["targets"] = rng.standard_normal((Bp, T, F)).astype(np.float32)
    return spec, lambda: partitioned_refs(spec, plain, params, xs, taus)


def partitioned_refs(spec, plain, params, xs, taus):
    Bp, F = xs.shape[0], xs.shape[-1]

    def loss(p):
        o, _ = plain(p, xs, taus, plain.initial_state(Bp, F))
        return jnp.sum(o ** 2)

    out, _ = jax.jit(lambda p: plain(p, xs, taus,
                                     plain.initial_state(Bp, F)))(params)
    ref = {"beliefs": np.asarray(out),
           "grads": np_tree(jax.jit(jax.grad(loss))(params))}
    if "targets" in spec:
        tgt = jnp.asarray(spec["targets"])

        def sup(p):
            o, _ = plain(p, xs, taus, plain.initial_state(Bp, F))
            return jnp.mean((o - tgt) ** 2)

        lval, g = jax.jit(jax.value_and_grad(sup))(params)
        opt = optax.adam(1e-3)
        upd, _ = opt.update(g, opt.init(params), params)
        ref["loss"] = float(lval)
        ref["params"] = np_tree(optax.apply_updates(params, upd))
    return ref


def multihost_case():
    model, params, xs, ys = mh.build_model_and_data()
    stack = [JaxGraphConv(mh.HID, mh.HID), jnp.tanh,
             JaxGraphConv(mh.HID, mh.HID), jnp.tanh]
    ref_core = JaxSparseGCM(
        JaxSparseGNN(stack), preprocessor=JaxMLP([JaxLinear(mh.OBS,
                                                            mh.HID)]),
        edge_selectors=JaxSparseLearned(input_size=mh.OBS,
                                        deterministic=True,
                                        num_edge_samples=3, window=6),
        graph_size=32, max_edges=128)
    sp_params = ref_core.init(jax.random.PRNGKey(3))
    sp_xs = np.random.default_rng(4).standard_normal(
        (mh.B_GLOBAL, 5, mh.OBS)).astype(np.float32)
    spec = {"hid": mh.HID, "obs": mh.OBS, "N": mh.N, "lr": mh.LR,
            "params": np_tree(params), "xs": np.asarray(xs),
            "ys": np.asarray(ys),
            "sparse": {"N": 32, "E": 128, "params": np_tree(sp_params),
                       "xs": sp_xs,
                       "taus": np.full((mh.B_GLOBAL,), 5, np.int32)}}

    def refs():
        want_sum, want_norm = mh.updated_param_checksum(model, params, xs,
                                                        ys)
        # mh.sharded_sparse_checksum()'s replicated reference, jitted
        taus = jnp.full((mh.B_GLOBAL,), 5, jnp.int32)
        mx, st = jax.jit(lambda p, x: ref_core(
            p, x, taus, ref_core.initial_state(mh.B_GLOBAL, mh.OBS)))(
            sp_params, jnp.asarray(sp_xs))
        return {"checksum": want_sum, "grad_norm": want_norm,
                "sharded_sparse_sum": float(jnp.sum(jnp.abs(mx))),
                "sharded_sparse_edges": int(jnp.sum(st.num_edges))}

    return spec, refs


def adapter_case(d):
    mesh = jax_mesh(dp=d, tp=1)
    common = dict(graph_size=64, max_edges=256, gnn_input_size=HID,
                  gnn_output_size=HID, edge_selectors=JaxTemporalEdge([1, 2]))
    pol_r = JaxAdapter(OBS, 3, 3, **common)
    pol_s = JaxAdapter(OBS, 3, 3, mesh=mesh, **common)
    params = pol_r.init(jax.random.PRNGKey(0))
    obs = np.random.default_rng(1).standard_normal((B, 5, OBS)).astype(
        np.float32)
    spec = {"d": d, "obs": OBS, "hid": HID, "params": np_tree(params),
            "xs": obs}

    def refs():
        lr, vr, _ = jax.jit(lambda p, o: pol_r(p, o, pol_r.initial_state(
            B)))(params, obs)
        ls, vs, _ = jax.jit(lambda p, o: pol_s(p, o, pol_s.initial_state(
            B)))(params, obs)
        np.testing.assert_allclose(np.asarray(lr), np.asarray(ls),
                                   atol=1e-5)
        return {"logits": np.asarray(lr), "values": np.asarray(vr)}

    return spec, refs


TEMPORAL = ("temporal", (1, 2))
LEARNED_W = ("learned", 6)
LEARNED = ("learned", None)
CHAIN = ("chain", (TEMPORAL, LEARNED_W))


@pytest.fixture(scope="module")
def world():
    """Every case's spec, then the world of 4 ranks in a thread while the
    JAX references compile and run here, in threads (XLA compiles without
    the GIL); (refs, [rank results])."""
    torch.set_num_threads(1)
    with ThreadPoolExecutor(JAX_THREADS) as pool, \
            ThreadPoolExecutor(1) as spawner:
        return build_world(pool, spawner)


def build_world(pool, spawner):
    cases = {}

    def add(name, runner, pair):
        """pair: (spec, refs thunk or None), a future of one, or a
        callable that makes one once the futures are done."""
        cases[name] = (runner, pair)

    # JAX's sharded core where it is the same program as ours (d = 4, the
    # halo path); the replicated core everywhere
    two_windows = [(5, [5, 3, 4]), (5, [2, 5, 4])]
    temporal = pool.submit(sparse_case, 4, TEMPORAL, two_windows, seed=4)
    add("temporal4", "sharded_sparse", temporal)
    add("temporal2", "sharded_sparse",  # the same inputs and references
        lambda: (dict(temporal.result()[0], d=2), None))
    add("learned_halo", "sharded_sparse", pool.submit(
        sparse_case, 4, LEARNED_W, [(4, [4] * B), (4, [4] * B)], seed=5))
    add("learned_psum", "sharded_sparse", pool.submit(
        sparse_case, 2, LEARNED, [(4, [4, 3, 4])], seed=6,
        jax_sharded=False))
    add("chain", "sharded_sparse", pool.submit(
        sparse_case, 4, CHAIN, [(4, [4] * B), (4, [4] * B)], seed=7,
        jax_sharded=False))
    # t shrinking under a windowed learned selector (where JAX's halo
    # drops edges: ROADMAP Queue 3), the second window on a new module
    # that continues the carried state: the replicated core is the
    # reference
    shrink = pool.submit(sparse_case, 2, LEARNED_W,
                         [(6, [6] * B), (2, [2] * B), (1, [1] * B)], seed=8,
                         N=32, E=128, grad=False, jax_sharded=False)
    add("shrinking", "sharded_sparse", lambda: (
        dict(shrink.result()[0], fresh_from=1), shrink.result()[1]))
    # a rank's lanes fill: edges counted in aux["dropped_edges"]
    # (against the port's replicated core, itself held to JAX above)
    overflow = pool.submit(sparse_case, 4, TEMPORAL,
                           [(5, [5] * B), (5, [5] * B)], seed=9, N=32, E=8,
                           grad=False, jax_sharded=False)
    add("overflow", "sharded_sparse", lambda: (overflow.result()[0], None))
    add("adapter", "adapter", pool.submit(adapter_case, 4))
    add("refusals", "refusals", ({}, dict))
    # d = 2 and the bucketed and psum modes share their inputs and JAX
    # references with the d = 4 / halo cases
    spmm4 = pool.submit(spmm_case, 14, 4)
    add("spmm4", "spmm_partitioned", spmm4)
    add("spmm2", "spmm_partitioned",
        lambda: (dict(spmm4.result()[0], d=2, k_pair=32), None))
    halo = pool.submit(partitioned_case, "halo", 4, train=True, halo=2)
    add("halo_gcm", "partitioned_gcm", halo)

    def plain(**kw):
        spec = {k: v for k, v in halo.result()[0].items() if k != "targets"}
        return dict(spec, **kw), None

    add("bucketed_gcm", "partitioned_gcm",
        lambda: plain(mode="bucketed", d=2, gnn_kw={"k_pair": 32}))
    add("psum_gcm", "partitioned_gcm", lambda: plain(mode="psum",
                                                     gnn_kw={}))
    add("auto", "auto_modes", ({"kws": [
        dict(num_nodes=16, halo=2), dict(num_nodes=128),
        dict(num_nodes=512, k_pair=16)]},
        lambda: ["halo", "psum", "bucketed"]))
    add("multihost", "multihost", pool.submit(multihost_case))
    pairs = {}
    for name, (_, p) in cases.items():
        if isinstance(p, Future):
            p = p.result()
        elif callable(p):
            p = p()
        pairs[name] = p
    ranks = spawner.submit(spawn_world, run_cases, 4, "cpu", args=(
        "cpu", {name: (runner, pairs[name][0])
                for name, (runner, _) in cases.items()}), timeout_s=300)
    futs = {name: pool.submit(pair[1]) for name, pair in pairs.items()
            if pair[1] is not None}
    refs = {name: f.result() for name, f in futs.items()}
    for name, same in (("temporal2", "temporal4"), ("spmm2", "spmm4"),
                       ("bucketed_gcm", "halo_gcm"),
                       ("psum_gcm", "halo_gcm")):
        refs[name] = refs[same]
    return refs, ranks.result()


def same_on_ranks(ranks, name, key):
    """A replicated result: every rank returned the same."""
    first = ranks[0][name][key]
    for r in ranks[1:]:
        for a, b in zip(jax.tree_util.tree_leaves(first),
                        jax.tree_util.tree_leaves(r[name][key])):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    return first


def check_core(refs, ranks, name, jax_sharded=True, edges_exact=True):
    ref, got = refs[name], ranks[0][name]
    outs = same_on_ranks(ranks, name, "sharded")
    for i, o in enumerate(outs):
        np.testing.assert_allclose(o, ref["single"][i], atol=OUT_TOL,
                                   rtol=0, err_msg=f"{name} window {i}")
        np.testing.assert_allclose(o, got["single"][i], atol=OUT_TOL,
                                   rtol=0)
        if jax_sharded:
            np.testing.assert_allclose(o, ref["sharded"][i], atol=OUT_TOL,
                                       rtol=0)
    nodes, edges, weights, t, num_edges, _ = got["state"]
    want = ref["state"]
    np.testing.assert_array_equal(nodes, want.nodes)
    np.testing.assert_array_equal(t, want.t)
    if edges_exact:
        for b in range(B):
            assert edge_set(edges, weights, b) == edge_set(
                want.edges, want.weights, b), f"{name} batch {b}"
        np.testing.assert_array_equal(num_edges.sum(1), want.num_edges)
    return got


def named_close(got, twin, jax_tree, atol, rtol, msg):
    """got {port parameter name: array} against the JAX tree, leaf by
    leaf through the twin module's JAX paths (weights.jax_paths)."""
    paths = jax_paths(twin)
    assert set(got) == set(paths), (sorted(got), sorted(paths))
    for name, path in paths.items():
        want = jax_tree
        for k in path.split("/"):
            want = want[int(k)] if isinstance(want, (list, tuple)) else \
                want[k]
        np.testing.assert_allclose(got[name], np.asarray(want), atol=atol,
                                   rtol=rtol, err_msg=f"{msg}: {name}")


def check_grads(refs, ranks, name, spec):
    """Every rank holds the full gradient, within 1e-4 of jax.grad."""
    twin = build_sparse_pair(dict(spec, d=4), None)[0]
    for r in ranks:
        named_close(r[name]["grads"], twin, refs[name]["grads"], GRAD_TOL,
                    GRAD_TOL, name)


def check_sharded_core(refs, ranks):
    """Temporal (d = 2, 4), windowed learned on the halo path, unwindowed
    on the psum path, the chain: beliefs, nodes, edge sets, cursors, the
    structural halo, stats aux and every gradient."""
    for name in ("temporal2", "temporal4", "learned_halo", "learned_psum",
                 "chain"):
        check_core(refs, ranks, name,
                   jax_sharded=bool(refs[name]["sharded"]))
        if "grads" in refs[name]:
            check_grads(refs, ranks, name, refs[name]["spec"])
    assert ranks[0]["temporal4"]["nb"] == 64 // 4
    assert ranks[0]["temporal4"]["epl"] == 256 // 4
    assert ranks[0]["learned_halo"]["halo4"] == 10  # window + t
    assert ranks[0]["chain"]["halo4"] == 10  # max(hops, window + t)
    assert ranks[0]["learned_psum"]["halo4"] is None
    assert ranks[0]["learned_halo"]["modes"] == [("halo", 10)] * 2
    assert [m[0] for m in ranks[0]["learned_psum"]["modes"]] == ["psum"]
    assert ranks[0]["temporal2"]["modes"][0] == ("halo", 2)
    aux, want = ranks[0]["learned_halo"]["aux"][0], \
        refs["learned_halo"]["single_aux"]
    for k in ("edges_per_node", "edge_density", "temperature"):
        np.testing.assert_allclose(aux[k], np.asarray(want[k]), atol=1e-5)
    # edges are owned by the rank that holds their source
    _, edges, _, _, _, _ = ranks[0]["temporal4"]["state"]
    epl, nb = 64, 16
    for s in range(4):
        sl = edges[:, :, s * epl:(s + 1) * epl]
        ok = (sl[:, 0] >= 0) & (sl[:, 1] >= 0)
        src = sl[:, 1][ok]
        assert src.size == 0 or ((src >= s * nb).all()
                                 and (src < (s + 1) * nb).all())


def check_state_conversion(refs, ranks):
    """JAX's sharded state cut into rank blocks and merged back exactly;
    the port's final state, gathered on the ranks, is JAX's sharded
    state: nodes and per-rank cursors equal, each rank's edge set."""
    for name in ("temporal4", "learned_halo"):
        jst = refs[name]["sharded_state"]
        merged = merge_sparse_states([shard_sparse_state(jst, 4, r)
                                      for r in range(4)])
        for a, b in zip(merged, jst):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        nodes, edges, weights, t, num_edges, _ = ranks[0][name]["state"]
        np.testing.assert_array_equal(nodes, jst.nodes)
        np.testing.assert_array_equal(num_edges, jst.num_edges)
        epl = edges.shape[-1] // 4
        for r in range(4):
            lanes = slice(r * epl, (r + 1) * epl)
            for b in range(B):
                assert edge_set(edges[:, :, lanes], weights[:, lanes], b) \
                    == edge_set(jst.edges[:, :, lanes],
                                jst.weights[:, lanes], b), (name, r, b)


def check_differences_from_jax(refs, ranks):
    """Windows whose t shrinks (6, 2, 1) under a windowed
    learned selector, the later two on a new module that continues the
    state, keep every edge of the replicated core (the halo from the
    state's span, the longest window it holds edges of, so the halo path
    holds) and drop none; a reset state forgets the span. A rank whose
    lanes fill reports its lost edges in aux["dropped_edges"]: stored +
    dropped = what the replicated core stores with room for all."""
    got = check_core(refs, ranks, "shrinking", jax_sharded=False)
    assert [m for m in got["modes"]] == [("halo", 12)] * 3
    assert all((a["dropped_edges"] == 0).all() for a in got["aux"])
    np.testing.assert_array_equal(got["state"][5], [6] * B)
    assert got["reset_mode"] == ("halo", 7)  # window + the call's t
    got = ranks[0]["overflow"]
    for o in got["sharded"]:
        assert np.isfinite(o).all()
    stored = got["state"][4].sum(1)
    dropped = sum(a["dropped_edges"] for a in got["aux"])
    assert (dropped > 0).all()
    # the replicated core with E = 8 also drops; with room for all it
    # stores what the sharded core stored plus what it dropped
    want_all = got["single_state"][4] + sum(
        np.asarray(a["dropped_edges"]) for a in got["single_aux"])
    np.testing.assert_array_equal(stored + dropped, want_all)


def check_refusals_and_adapter(refs, ranks):
    msgs = ranks[0]["refusals"]
    assert "deterministic only" in msgs["stochastic"]
    assert "TemporalEdge" in msgs["chain_member"]
    assert "plain selector configuration" in msgs["adapter_max_hops"]
    assert "dones" in msgs["dones"]
    assert "halo=" in msgs["halo_too_wide"]
    with pytest.raises(RuntimeError, match="initialised process group"):
        make_mesh(device_type="cpu")  # no world in this process
    got = same_on_ranks(ranks, "adapter", "logits")
    assert ranks[0]["adapter"]["core"] == "ShardedSparseGCM"
    np.testing.assert_allclose(got, refs["adapter"]["logits"], atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(ranks[0]["adapter"]["values"],
                               refs["adapter"]["values"], atol=1e-5, rtol=0)


def check_partitioned_aggregation(refs, ranks):
    """Each partitioned SpMM and its x-gradient against edge_scatter_add
    and jax.grad (d = 2, 4), bucketing preserving edges, the three
    PartitionedSparseGNN modes in SparseGCM (beliefs, gradients), auto
    dispatch and the halo model's Adam step against optax."""
    for d in (2, 4):
        got, ref = ranks[0][f"spmm{d}"], refs[f"spmm{d}"]
        y, g = ref["plain"]
        for key in ("edge", "node", "bucketed"):
            np.testing.assert_allclose(got[key][0], y, atol=1e-5, rtol=0,
                                       err_msg=f"{key} d={d}")
            np.testing.assert_allclose(got[key][1], g, atol=1e-4, rtol=0,
                                       err_msg=f"{key} grad d={d}")
        if "jax_bucketed" in ref:
            np.testing.assert_allclose(got["bucketed"][0],
                                       ref["jax_bucketed"], atol=1e-5,
                                       rtol=0)
        for key in ("sink_bucketed", "cross_bucketed"):
            np.testing.assert_allclose(got[key], y, atol=1e-5, rtol=0)
        yb, gb = ref["band"]
        np.testing.assert_allclose(got["halo"][0], yb, atol=1e-5, rtol=0)
        np.testing.assert_allclose(got["halo"][1], gb, atol=1e-4, rtol=0)
    for name in ("halo_gcm", "bucketed_gcm", "psum_gcm"):
        got, ref = ranks[0][name], refs[name]
        assert got["mode"] == name.split("_")[0]
        np.testing.assert_allclose(got["beliefs"], ref["beliefs"],
                                   atol=1e-5, rtol=0, err_msg=name)
        named_close(got["grads"], partitioned_twin(), ref["grads"],
                    GRAD_TOL, GRAD_TOL, name)
    got, ref = ranks[0]["halo_gcm"], refs["halo_gcm"]
    np.testing.assert_allclose(float(got["loss"]), ref["loss"], atol=1e-5)
    named_close(got["params"], partitioned_twin(), ref["params"], 1e-4, 0,
                "halo Adam step")
    assert ranks[0]["auto"] == refs["auto"]


def partitioned_twin():
    F = 6
    return SparseGCM(SparseGNN([GraphConv(F, F, device="cpu"), torch.tanh,
                                GraphConv(F, F, device="cpu"), torch.tanh]),
                     graph_size=16, max_edges=128, device="cpu",
                     edge_selectors=TemporalEdge([1, 2]))


def check_two_process_dp_update(refs, ranks):
    """tests/test_multihost.py on 2 ranks of the world: the dp update's
    checksum and gradient norm within rtol 1e-6 of one process; the
    sharded SparseGCM's output sum (1e-5) and edge count equal."""
    want = refs["multihost"]
    for r in ranks:
        got = r["multihost"]
        np.testing.assert_allclose(got["checksum"], want["checksum"],
                                   rtol=1e-6)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                                   rtol=1e-6)
        np.testing.assert_allclose(got["sharded_sparse_sum"],
                                   want["sharded_sparse_sum"], rtol=1e-5)
        assert got["sharded_sparse_edges"] == want["sharded_sparse_edges"]


def test_sharded_sparse_and_partitioned_match_jax(world):
    """One item, so that one worker spawns the file's world: every check
    above in turn."""
    refs, ranks = world
    check_sharded_core(refs, ranks)
    check_state_conversion(refs, ranks)
    check_differences_from_jax(refs, ranks)
    check_refusals_and_adapter(refs, ranks)
    check_partitioned_aggregation(refs, ranks)
    check_two_process_dp_update(refs, ranks)
