"""The port's parallelism (gcm_tpu_torch/parallel/: mesh, sharding rules,
TensorParallel dp x tp train steps, the node-sharded fast-core scans, dp
A2C / PPO and the multichip dry run) against the JAX package's, on the
CPU.

One spawned world of 4 gloo ranks computes every case
(`parallel/cases.py::run_cases`; d = 4 on make_mesh(4, 1), d = 2 and
dp 2 x tp 2 on make_mesh(2, 2)); the JAX references run here from the
same numpy weights and inputs, JAX's scans unrolled once. Mirrors
tests/test_parallel.py:

- mesh shapes; param_specs against JAX's rule leaf by leaf (the port
  stores kernels [in, out] as JAX does: column-parallel splits dim 1),
  each rank's shard and its Adam moments 1/tp of the kernel;
- dp parity of the README DenseGCM's scan and SparseGCM's window against
  JAX (1e-5); dp x tp dense and window train steps and the dp sparse
  step against jax.value_and_grad + optax.adam (loss 1e-5, parameters
  1e-4); two dp x tp Adam steps whose backwards recompute (the dense
  trajectory step and the ring core with EuclideanEdge, its batch-wide
  mean over dp, each with remat=True and remat="reverse")
  against two optax steps (loss 1e-5, parameters 1e-4);
- the node-sharded banded (hop at the halo boundary included), scored
  and clique scans against JAX's sharded scans and the unsharded ones
  (beliefs 1e-5, final states exact up to 1e-6);
- dp A2C, PPO and the clique-window A2C on JAX's trajectories (and PPO's
  permutations) against JAX's updates (1e-4), and a dp update against the
  single-process port update from one seed (1e-5);
- the dry run (parallel/dryrun.py) whole on dp 2 x tp 2, every section
  within its tolerance against the unsharded port.
"""

from concurrent.futures import Future, ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import gcm_tpu.config as jax_config
from gcm_tpu.edges.dense import DenseEdge as JaxDenseEdge
from gcm_tpu.edges.distance import EuclideanEdge as JaxEuclideanEdge
from gcm_tpu.edges.temporal import TemporalBackedge as JaxTemporalBackedge
from gcm_tpu.models.banded_gcm import BandedRingGCM as JaxBanded
from gcm_tpu.models.banded_gcm import BandedScoredGCM as JaxScored
from gcm_tpu.models.clique_gcm import CliqueGCM as JaxClique
from gcm_tpu.models.presets import readme_dense_gcm, readme_sparse_gcm
from gcm_tpu.models.ring_gcm import RingDenseGCM as JaxRing
from gcm_tpu.nn.dense_conv import DenseGNN as JaxDenseGNN
from gcm_tpu.nn.dense_conv import DenseGraphConv as JaxDenseGraphConv
from gcm_tpu.nn.module import MLP as JaxMLP
from gcm_tpu.nn.module import Linear as JaxLinear
from gcm_tpu.parallel import banded_partition as jbp
from gcm_tpu.parallel.mesh import make_mesh as jax_mesh
from gcm_tpu.parallel.sharding import param_specs as jax_param_specs
from gcm_tpu.rl import env as jenv
from gcm_tpu.rl.a2c import A2C as JaxA2C
from gcm_tpu.rl.ppo import PPO as JaxPPO
from gcm_tpu.rl.wrappers import GCMActorCritic as JaxGCMActorCritic
from gcm_tpu.train.train_step import (make_dense_supervised_step,
                                      make_sparse_supervised_step,
                                      make_trajectory_supervised_step,
                                      make_window_supervised_step)
from gcm_tpu_torch import (MLP, BandedRingGCM, DenseGNN, DenseGraphConv,
                           EuclideanEdge, GCMActorCritic, Linear, RecallEnv,
                           RingDenseGCM, TemporalBackedge, jax_paths)
from gcm_tpu_torch import readme_dense_gcm as port_readme_dense
from gcm_tpu_torch import readme_sparse_gcm as port_readme_sparse
from gcm_tpu_torch.parallel.cases import run_cases
from gcm_tpu_torch.parallel.distributed import spawn_world
from gcm_tpu_torch.parallel.dryrun import SECTIONS

OUT_TOL, PARAM_TOL = 1e-5, 1e-4
LR = 3e-3
JAX_THREADS = 4


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def at_path(tree, path):
    for k in path.split("/"):
        tree = tree[int(k)] if isinstance(tree, (list, tuple)) else tree[k]
    return tree


def named_close(got, twin, jax_tree, atol, rtol, msg):
    """got {port parameter name: array} against the JAX tree, leaf by leaf
    through the twin module's JAX paths."""
    paths = jax_paths(twin)
    assert set(got) == set(paths), (sorted(got), sorted(paths))
    for name, path in paths.items():
        np.testing.assert_allclose(got[name],
                                   np.asarray(at_path(jax_tree, path)),
                                   atol=atol, rtol=rtol,
                                   err_msg=f"{msg}: {name}")


def adam_step(loss_fn, params, *args):
    lval, g = jax.jit(jax.value_and_grad(loss_fn))(params, *args)
    opt = optax.adam(1e-3)
    upd, _ = opt.update(g, opt.init(params), params)
    return float(lval), np_tree(optax.apply_updates(params, upd))


def step_case(kind, seed):
    B, T, obs, hidden, graph = 8, 4, 8, 16, 12
    rng = np.random.default_rng(seed)
    if kind == "window":
        model = JaxBanded(JaxDenseGNN([JaxDenseGraphConv(hidden, hidden),
                                       jnp.tanh]), hops=(1,),
                          graph_size=graph)
        obs = hidden
        step = make_window_supervised_step(model, optax.adam(1e-3))
    elif kind == "sparse":
        model = readme_sparse_gcm(obs_size=obs, hidden=hidden,
                                  graph_size=graph, max_edges=64)
        step = make_sparse_supervised_step(model, optax.adam(1e-3))
    else:
        model = readme_dense_gcm(obs_size=obs, hidden=hidden,
                                 graph_size=graph)
        step = make_dense_supervised_step(model, optax.adam(1e-3))
    params = model.init(jax.random.PRNGKey(seed))
    xs = rng.standard_normal((B, T, obs)).astype(np.float32)
    tg = rng.standard_normal((B, T, hidden)).astype(np.float32)
    taus = np.full((B,), T, np.int32)
    spec = {"kind": kind, "dp": 2, "tp": 2 if kind != "sparse" else 1,
            "obs": obs, "hidden": hidden, "graph": graph, "max_edges": 64,
            "params": np_tree(params), "xs": xs, "targets": tg,
            "taus": taus}
    if kind == "sparse":
        spec["dp"] = 4

    def refs():
        args = (jnp.asarray(xs), jnp.asarray(tg)) + (
            (jnp.asarray(taus),) if kind == "sparse" else ())
        p_ref, _, loss = jax.jit(step)(params,
                                       optax.adam(1e-3).init(params), *args)
        return {"loss": float(loss), "params": np_tree(p_ref),
                "specs": jax_param_specs(params)}

    return spec, refs


def remat_case(kind, seed, max_distance=1.0):
    """Two Adam steps of the dense trajectory step (remat=True) or of the
    ring core with EuclideanEdge (no remat: the same function) on the
    global batch; the port runs them under dp 2 x tp 2 with remat."""
    B, T, obs, hidden, graph = 8, 4, 8, 16, 12
    rng = np.random.default_rng(seed)
    xs = (0.3 * rng.standard_normal((B, T, obs))).astype(np.float32)
    tg = rng.standard_normal((B, T, hidden)).astype(np.float32)
    opt = optax.adam(1e-3)
    if kind == "dense":
        model = readme_dense_gcm(obs_size=obs, hidden=hidden,
                                 graph_size=graph)
        step = make_trajectory_supervised_step(model, opt, remat=True)
    else:
        model = JaxRing(JaxDenseGNN([JaxDenseGraphConv(hidden, hidden),
                                     jnp.tanh,
                                     JaxDenseGraphConv(hidden, hidden),
                                     jnp.tanh]),
                        preprocessor=JaxMLP([JaxLinear(obs, hidden)]),
                        edge_selectors=JaxEuclideanEdge(
                            max_distance=max_distance),
                        graph_size=graph)

        def loss_fn(p, x, y):
            outs, _ = model.scan(p, x, model.initial_state(B, obs))
            return jnp.mean((outs - y) ** 2)

        def step(p, st, x, y):
            loss, g = jax.value_and_grad(loss_fn)(p, x, y)
            upd, st = opt.update(g, st, p)
            return optax.apply_updates(p, upd), st, loss

    params = model.init(jax.random.PRNGKey(seed))
    spec = {"kind": kind, "obs": obs, "hidden": hidden, "graph": graph,
            "max_distance": max_distance, "params": np_tree(params),
            "xs": xs, "targets": tg}

    def refs():
        p, st, losses = params, opt.init(params), []
        f = jax.jit(step)
        for _ in range(2):
            p, st, loss = f(p, st, jnp.asarray(xs), jnp.asarray(tg))
            losses.append(float(loss))
        return {"losses": losses, "params": np_tree(p)}

    return spec, refs


def fast_case(core, d, N, hops=(), window=None, learned=False, T=None,
              seed=0, F=4, B=2):
    T = T or 2 * N + 3  # wraps past capacity
    gnn = JaxDenseGNN([JaxDenseGraphConv(F, F), jnp.tanh,
                       JaxDenseGraphConv(F, F), jnp.tanh])
    pre = JaxMLP([JaxLinear(F, F)])
    mesh = jax_mesh(dp=d, tp=1, devices=jax.devices()[:d])
    if core == "banded":
        model = JaxBanded(gnn, preprocessor=pre, hops=hops, graph_size=N)
        scan = jbp.banded_scan_sharded(model, mesh, axis="dp")
        st = jbp.shard_banded_state(model.initial_state(B, F), mesh, "dp")
    elif core == "clique":
        model = JaxClique(gnn, preprocessor=pre, graph_size=N)
        scan = jbp.clique_scan_sharded(model, mesh, axis="dp")
        st = jbp.shard_banded_state(model.initial_state(B, F), mesh, "dp")
    else:
        model = JaxScored(gnn, distance=JaxEuclideanEdge(
            max_distance=1.1, learned=learned, window=window), hops=hops,
            preprocessor=pre, graph_size=N)
        scan = jbp.banded_scored_scan_sharded(model, mesh, axis="dp")
        st = jbp.shard_banded_scored_state(model.initial_state(B, F), mesh,
                                           "dp")
    params = model.init(jax.random.PRNGKey(seed))
    xs = jax.random.normal(jax.random.PRNGKey(seed + 1), (B, T, F))
    spec = {"core": core, "d": d, "F": F, "N": N, "hops": hops,
            "window": window, "learned": learned, "params": np_tree(params),
            "xs": np.asarray(xs)}

    def refs():
        want, ws = jax.jit(lambda p, x: model.scan(
            p, x, model.initial_state(B, F)))(params, xs)
        got, _ = jax.jit(scan)(params, xs, st)
        return {"want": np.asarray(want), "jax_sharded": np.asarray(got),
                "state": np_tree(ws)}

    return spec, refs


def recall_policy(core):
    env = jenv.RecallEnv(num_symbols=2, horizon=4, noise_dim=2)
    return env, JaxGCMActorCritic(
        env.obs_dim, env.num_actions, env.num_actions, core=core,
        graph_size=env.horizon + 1, gnn_input_size=8, gnn_output_size=8,
        edge_selectors=(JaxDenseEdge() if core == "clique"
                        else JaxTemporalBackedge([1])))


def recall_params(core, seed):
    return np_tree(recall_policy(core)[1].init(jax.random.PRNGKey(seed)))


def rl_case(algo, core, d, seed):
    env, jpol = recall_policy(core)
    params = jpol.init(jax.random.PRNGKey(seed))
    B = 8
    key = jax.random.PRNGKey(seed + 1)
    spec = {"algo": algo, "core": core, "d": d, "lr": LR,
            "params": np_tree(params)}
    if algo == "ppo":
        jtr = JaxPPO(env, jpol, lr=LR, epochs=2, num_minibatches=2)
        k_collect, k_perm = jax.random.split(key)
        traj = jax.jit(jtr.collect, static_argnums=2)(params, k_collect, B)
        spec["perms"] = [np.asarray(jax.random.permutation(k, B))
                         for k in jax.random.split(k_perm, jtr.epochs)]
    else:
        jtr = JaxA2C(env, jpol, lr=LR)
        traj = jax.jit(jtr.collect, static_argnums=2)(params, key, B)
    spec["traj"] = np_tree(traj)

    def refs():
        if algo == "ppo":
            new_params, _, metrics = jax.jit(jtr.update, static_argnums=3)(
                params, jtr.opt.init(params), key, B)
            loss = metrics["loss"]
        else:
            (loss, _), grads = jax.jit(jax.value_and_grad(
                jtr.loss, has_aux=True))(params, traj)
            opt = optax.adam(LR)
            upd, _ = opt.update(grads, opt.init(params), params)
            new_params = optax.apply_updates(params, upd)
        return {"loss": float(loss), "params": np_tree(new_params)}

    return spec, refs


def recall_twin(core):
    env = RecallEnv(2, 4, 2, device="cpu")
    return GCMActorCritic(env.obs_dim, env.num_actions, env.num_actions,
                          graph_size=5, gnn_input_size=8, gnn_output_size=8,
                          device="cpu", core=core,
                          edge_selectors=(None if core == "clique" else
                                          TemporalBackedge([1])))


@pytest.fixture(scope="module")
def world():
    """Every case's spec, then the world of 4 ranks in a thread while the
    JAX references compile and run here, in threads (XLA compiles without
    the GIL); (refs, [rank results])."""
    torch.set_num_threads(1)
    saved = {k: getattr(jax_config, k) for k in (
        "SCAN_UNROLL", "DENSE_SCAN_UNROLL", "RING_SCAN_UNROLL")}
    for k in saved:  # JAX's scans unrolled once: compile time only
        setattr(jax_config, k, 1)
    try:
        with ThreadPoolExecutor(JAX_THREADS) as pool, \
                ThreadPoolExecutor(1) as spawner:
            return build_world(pool, spawner)
    finally:
        for k, v in saved.items():
            setattr(jax_config, k, v)


def readme_cases():
    """The README DenseGCM's scan and SparseGCM's window under dp, d = 2
    and 4 (d = 4 shares d = 2's references): {name: (spec, refs)}."""
    B, T, obs = 8, 6, 8
    rng = np.random.default_rng(0)
    xs = rng.standard_normal((B, T, obs)).astype(np.float32)
    dense = readme_dense_gcm(obs_size=obs, hidden=16, graph_size=16)
    dparams = dense.init(jax.random.PRNGKey(0))
    sparse = readme_sparse_gcm(obs_size=obs, hidden=16, graph_size=16,
                               max_edges=64)
    sparams = sparse.init(jax.random.PRNGKey(0))
    taus = np.asarray([5, 2, 4, 5, 0, 5, 3, 5], np.int32)

    def dense_want():
        return np.asarray(jax.jit(lambda p, x: dense.scan(
            p, x, dense.initial_state(B, obs)))(dparams,
                                                 jnp.asarray(xs))[0])

    def sparse_want():
        return np.asarray(jax.jit(lambda p, x, t: sparse(
            p, x, t, sparse.initial_state(B, obs)))(
            sparams, jnp.asarray(xs[:, :5]), jnp.asarray(taus))[0])

    out = {}
    for i, d in enumerate((2, 4)):
        out[f"dense_scan{d}"] = (
            {"d": d, "obs": obs, "hidden": 16, "graph": 16,
             "params": np_tree(dparams), "xs": xs},
            dense_want if i == 0 else None)
        out[f"sparse{d}"] = (
            {"d": d, "obs": obs, "hidden": 16, "graph": 16,
             "max_edges": 64, "params": np_tree(sparams),
             "xs": xs[:, :5], "taus": taus},
            sparse_want if i == 0 else None)
    return out


def build_world(pool, spawner):
    cases = {}

    def add(name, runner, pair):
        """pair: (spec, refs thunk or None), a future of one, or a
        callable that makes one once the futures are done."""
        cases[name] = (runner, pair)

    add("mesh", "mesh_shapes", ({}, lambda: None))
    readme = pool.submit(readme_cases)
    for name, runner in (("dense_scan2", "dense_scan_dp"),
                         ("sparse2", "sparse_dp"),
                         ("dense_scan4", "dense_scan_dp"),
                         ("sparse4", "sparse_dp")):
        add(name, runner, lambda name=name: readme.result()[name])
    for kind in ("dense", "window", "sparse"):
        add(f"step_{kind}", "train_step_dp_tp",
            pool.submit(step_case, kind, 1))
    for kind in ("dense", "ring"):
        rc = pool.submit(remat_case, kind, 6)
        for i, remat in enumerate((True, "reverse")):
            add(f"remat_{kind}_{remat}", "remat_steps",
                lambda rc=rc, i=i, remat=remat: (
                    dict(rc.result()[0], remat=remat),
                    rc.result()[1] if i == 0 else None))
    for name, args, kw in (
            ("banded_1_d4", ("banded", 4, 16), {"hops": (1,)}),
            ("banded_12_d2", ("banded", 2, 16), {"hops": (1, 2)}),
            # max hop == block
            ("banded_boundary", ("banded", 4, 8), {"hops": (2,)}),
            ("scored_w2", ("scored", 4, 16), {"window": 2}),
            # window == block
            ("scored_boundary", ("scored", 4, 8), {"window": 2}),
            ("scored_learned", ("scored", 4, 16),
             {"window": 3, "hops": (1,), "learned": True}),
            ("clique_d4", ("clique", 4, 16), {}),
            ("clique_uneven", ("clique", 2, 16), {"T": 21})):
        add(name, "fast_scan_sharded", pool.submit(fast_case, *args, **kw))
    add("a2c", "rl_dp", pool.submit(rl_case, "a2c", "ring", 4, 1))
    add("ppo", "rl_dp", pool.submit(rl_case, "ppo", "ring", 2, 2))
    add("a2c_clique", "rl_dp", pool.submit(rl_case, "a2c", "clique", 4, 3))
    for name, algo, core, d, seed in (("a2c_update", "a2c", "ring", 4, 4),
                                      ("ppo_update", "ppo", "banded", 2, 5)):
        rp = pool.submit(recall_params, core, seed)
        add(name, "rl_dp_update", lambda rp=rp, algo=algo, core=core, d=d,
            seed=seed: ({"algo": algo, "core": core, "d": d, "lr": LR,
                         "seed": seed, "B": 8, "params": rp.result()},
                        lambda: None))
    add("dryrun", "dryrun", ({}, lambda: None))
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
    for kind in ("dense", "ring"):
        refs[f"remat_{kind}_reverse"] = refs[f"remat_{kind}_True"]
    refs["dense_scan4"], refs["sparse4"] = refs["dense_scan2"], \
        refs["sparse2"]
    return refs, ranks.result()


def check_mesh_and_sharding_rules(refs, ranks):
    """make_mesh's shapes; param_specs against JAX's rule, each rank's
    shard and its Adam moments 1/tp."""
    m = ranks[0]["mesh"]
    assert m["a"] == (("dp", "tp"), (4, 1)) and m["b_dp"] == 4
    assert m["c"] == (2, 2)
    assert sorted(r["mesh"]["c_coords"] for r in ranks) == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    from jax.sharding import PartitionSpec as P

    dims = {P(None, "tp"): 1, P("tp", None): 0, P("tp"): 0, P(): None}
    for kind, twin in (("dense", port_readme_dense(8, 16, 12,
                                                   device="cpu")),
                       ("window", BandedRingGCM(
                           DenseGNN([DenseGraphConv(16, 16, device="cpu"),
                                     torch.tanh]), hops=(1,), graph_size=12,
                           device="cpu"))):
        got = ranks[0][f"step_{kind}"]
        want = {n: dims[at_path(refs[f"step_{kind}"]["specs"], p)]
                for n, p in jax_paths(twin).items()}
        assert got["specs"] == want
        assert any(v is not None for v in want.values())
        for n, dim in want.items():
            full = tuple(dict(twin.named_parameters())[n].shape)
            shard = got["shards"][n.replace(".", "/")]
            assert got["moments"][n.replace(".", "/")] == shard
            if dim is None:
                assert shard == full
            else:
                assert shard[dim] * 2 == full[dim]


def check_dp_and_tp_steps(refs, ranks):
    """dp scans and windows (1e-5), dp x tp dense and window steps and the
    dp sparse step (loss 1e-5, parameters after Adam 1e-4)."""
    for r in ranks:
        for d in (2, 4):
            np.testing.assert_allclose(r[f"dense_scan{d}"],
                                       refs[f"dense_scan{d}"], atol=OUT_TOL,
                                       rtol=0)
            np.testing.assert_allclose(r[f"sparse{d}"], refs[f"sparse{d}"],
                                       atol=OUT_TOL, rtol=0)
    twins = {"dense": port_readme_dense(8, 16, 12, device="cpu"),
             "sparse": port_readme_sparse(8, 16, 12, 64, device="cpu"),
             "window": BandedRingGCM(
                 DenseGNN([DenseGraphConv(16, 16, device="cpu"),
                           torch.tanh]), hops=(1,), graph_size=12,
                 device="cpu")}
    for kind, twin in twins.items():
        for r in ranks:
            got, want = r[f"step_{kind}"], refs[f"step_{kind}"]
            np.testing.assert_allclose(float(got["loss"]), want["loss"],
                                       atol=OUT_TOL, err_msg=kind)
            named_close(got["params"], twin, want["params"], PARAM_TOL, 0,
                        f"{kind} step")


def check_remat_steps(refs, ranks):
    """Two dp x tp Adam steps whose backwards recompute after the forward
    (a checkpoint's recompute, the reversible replay): the dense
    trajectory step and the ring core with EuclideanEdge
    (remat True and "reverse") against two optax steps of the global batch:
    losses 1e-5, parameters 1e-4."""
    obs, hidden, graph = 8, 16, 12
    twins = {"dense": port_readme_dense(obs, hidden, graph, device="cpu"),
             "ring": RingDenseGCM(
                 DenseGNN([DenseGraphConv(hidden, hidden, device="cpu"),
                           torch.tanh,
                           DenseGraphConv(hidden, hidden, device="cpu"),
                           torch.tanh]),
                 preprocessor=MLP([Linear(obs, hidden, device="cpu")]),
                 edge_selectors=EuclideanEdge(1.0, device="cpu"),
                 graph_size=graph, device="cpu")}
    for name in ("remat_dense_True", "remat_dense_reverse",
                 "remat_ring_True", "remat_ring_reverse"):
        want = refs[name]
        for r in ranks:
            got = r[name]
            np.testing.assert_allclose([float(x) for x in got["losses"]],
                                       want["losses"], atol=OUT_TOL,
                                       rtol=0, err_msg=name)
            named_close(got["params"], twins[name.split("_")[1]],
                        want["params"], PARAM_TOL, 0, name)


def check_sharded_fast_scans(refs, ranks):
    """Banded (a hop as wide as the block), scored (a window as wide as
    the block, hops and a learned scale) and clique (d = 2, 4; an uneven
    trajectory): beliefs against JAX's sharded and unsharded scans
    (1e-5), the final nodes, band and t."""
    for name in ("banded_1_d4", "banded_12_d2", "banded_boundary",
                 "scored_w2", "scored_boundary", "scored_learned",
                 "clique_d4", "clique_uneven"):
        ref = refs[name]
        for r in ranks:
            got = r[name]
            np.testing.assert_allclose(got["outs"], ref["want"],
                                       atol=OUT_TOL, rtol=0, err_msg=name)
            np.testing.assert_allclose(got["outs"], ref["jax_sharded"],
                                       atol=OUT_TOL, rtol=0, err_msg=name)
            np.testing.assert_allclose(got["nodes"], ref["state"].nodes,
                                       atol=1e-6, rtol=0, err_msg=name)
            np.testing.assert_array_equal(got["t"], ref["state"].t)
            if "band" in got:
                np.testing.assert_allclose(got["band"], ref["state"].band,
                                           atol=1e-6, rtol=0)


def check_dp_rl(refs, ranks):
    """dp A2C (ring, d = 4), PPO (d = 2) and the clique-window A2C on JAX's
    trajectories against JAX's updates; dp updates (A2C ring d = 4, PPO
    banded d = 2) against the single-process port update from one seed."""
    for name, core in (("a2c", "ring"), ("ppo", "ring"),
                       ("a2c_clique", "clique")):
        for r in ranks:
            got, want = r[name], refs[name]
            np.testing.assert_allclose(float(got["loss"]), want["loss"],
                                       atol=1e-5, rtol=1e-4, err_msg=name)
            named_close(got["params"], recall_twin(core), want["params"],
                        PARAM_TOL, 0, name)
    for name in ("a2c_update", "ppo_update"):
        for r in ranks:
            got = r[name]
            np.testing.assert_allclose(float(got["loss"]),
                                       float(got["want_loss"]), atol=1e-5)
            for n, v in got["want"].items():
                np.testing.assert_allclose(got["params"][n], v, atol=1e-5,
                                           rtol=0, err_msg=f"{name} {n}")


def check_dryrun_multichip(refs, ranks):
    """parallel/dryrun.py whole on dp 2 x tp 2 (edge and node shards over
    4): every section ran within its tolerance on every rank."""
    for r in ranks:
        assert tuple(r["dryrun"]) == SECTIONS
        assert r["dryrun"]["mesh_server"]["ranks"] == 4
        assert np.isfinite(r["dryrun"]["dense_dp_tp"]["loss"])


def test_parallel_matches_jax(world):
    """One item, so that one worker spawns the file's world: every check
    above in turn."""
    refs, ranks = world
    check_mesh_and_sharding_rules(refs, ranks)
    check_dp_and_tp_steps(refs, ranks)
    check_remat_steps(refs, ranks)
    check_sharded_fast_scans(refs, ranks)
    check_dp_rl(refs, ranks)
    check_dryrun_multichip(refs, ranks)
