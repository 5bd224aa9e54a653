"""Per-rank case runners: what one rank of a spawned world runs for the
parallel parity tests (tests/test_torch_port_parallel.py,
tests/test_torch_port_sharded_sparse.py). Each runner builds the port's
modules from a spec and the parameter tree it is handed (numpy, in the
JAX package's layout), runs the sharded path on this rank and returns
numpy for the caller to hold against the JAX package and the unsharded
port. `run_cases(device_type, cases)` runs {name: (runner, spec)} in
order, every rank the same list (the collectives pair up in that order).

Meshes: a world of 4 ranks holds both shard counts the tests use, d = 4
on make_mesh(4, 1)'s dp axis and d = 2 on make_mesh(2, 2)'s dp axis (the
two tp ranks of a dp group run the same d = 2 computation).
"""

from __future__ import annotations

import copy
import time

import numpy as np
import torch
import torch.distributed as dist

from gcm_tpu_torch.core.graph_state import reset_where
from gcm_tpu_torch.edges.dense import DenseEdge
from gcm_tpu_torch.edges.distance import EuclideanEdge
from gcm_tpu_torch.edges.sparse_learned import LearnedEdge as \
    SparseLearnedEdge
from gcm_tpu_torch.edges.sparse_spatial import (SparseEdgeChain,
                                                SpatialRadiusEdge)
from gcm_tpu_torch.edges.sparse_temporal import TemporalEdge
from gcm_tpu_torch.edges.temporal import TemporalBackedge
from gcm_tpu_torch.models.banded_gcm import BandedRingGCM, BandedScoredGCM
from gcm_tpu_torch.models.clique_gcm import CliqueGCM
from gcm_tpu_torch.models.ring_gcm import RingDenseGCM
from gcm_tpu_torch.models.presets import readme_dense_gcm, readme_sparse_gcm
from gcm_tpu_torch.models.sparse_gcm import SparseGCM
from gcm_tpu_torch.nn.dense_conv import DenseGNN, DenseGraphConv
from gcm_tpu_torch.nn.module import MLP, Linear
from gcm_tpu_torch.nn.sparse_conv import GraphConv, SparseGNN
from gcm_tpu_torch.ops.scatter import edge_scatter_add
from gcm_tpu_torch.parallel import comm
from gcm_tpu_torch.parallel.banded_partition import (
    banded_scan_sharded, banded_scored_scan_sharded, clique_scan_sharded,
    shard_banded_scored_state, shard_banded_state)
from gcm_tpu_torch.parallel.edge_partition import (
    PartitionedSparseGNN, bucket_edges_by_sink, bucket_edges_cross,
    spmm_bucketed, spmm_edge_partitioned, spmm_halo, spmm_node_partitioned)
from gcm_tpu_torch.parallel.mesh import (Spec, axis_group, axis_rank,
                                         axis_size, batch_sharding, block,
                                         gather_tensor, make_mesh,
                                         shard_tensor)
from gcm_tpu_torch.parallel.sharded_sparse import (ShardedSparseGCM,
                                                   gather_sparse_state)
from gcm_tpu_torch.parallel.sharding import (TensorParallel, param_specs,
                                             shard_pytree, state_specs)
from gcm_tpu_torch.rl.a2c import A2C
from gcm_tpu_torch.rl.env import RecallEnv
from gcm_tpu_torch.rl.ppo import PPO
from gcm_tpu_torch.rl.wrappers import GCMActorCritic, SparseGCMActorCritic
from gcm_tpu_torch.train.train_step import (
    make_dense_supervised_step, make_sparse_supervised_step,
    make_trajectory_supervised_step, make_window_supervised_step)
from gcm_tpu_torch.weights import load_jax_params

CPU = torch.device("cpu")


def _t(a, dtype=None):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _mesh(d: int):
    """The mesh whose dp axis has d ranks (module docstring)."""
    n = dist.get_world_size()
    return make_mesh(dp=d, tp=n // d, device_type="cpu")


def _named(module) -> dict:
    return {n: p.detach() for n, p in module.named_parameters()}


def _grads(module) -> dict:
    return {n: (p.grad if p.grad is not None else torch.zeros_like(p))
            for n, p in module.named_parameters()}


# -- builders: the port's twin of each JAX test module ------------------
def _dense_gnn(F, layers=2):
    stack = []
    for _ in range(layers):
        stack += [DenseGraphConv(F, F, device=CPU), torch.tanh]
    return DenseGNN(stack)


def build_fast(spec):
    """spec: {"core": "banded" | "scored" | "clique", "F", "N", "hops",
    "window", "learned"}; the JAX tests' two-layer stack with a Linear
    preprocessor."""
    F, N = spec["F"], spec["N"]
    gnn, pre = _dense_gnn(F), MLP([Linear(F, F, device=CPU)])
    if spec["core"] == "banded":
        return BandedRingGCM(gnn, preprocessor=pre, hops=spec["hops"],
                             graph_size=N, device=CPU)
    if spec["core"] == "clique":
        return CliqueGCM(gnn, preprocessor=pre, graph_size=N, device=CPU)
    dist_ = EuclideanEdge(1.1, learned=spec["learned"],
                          window=spec["window"], device=CPU)
    return BandedScoredGCM(gnn, distance=dist_, hops=spec["hops"],
                           preprocessor=pre, graph_size=N, device=CPU)


def _selector(kind, obs):
    if kind[0] == "temporal":
        return TemporalEdge(list(kind[1]))
    if kind[0] == "learned":
        return SparseLearnedEdge(obs, deterministic=True, num_edge_samples=3,
                                 window=kind[1], device=CPU)
    if kind[0] == "chain":
        return SparseEdgeChain([_selector(k, obs) for k in kind[1]])
    if kind[0] == "stochastic":
        return SparseLearnedEdge(obs, deterministic=False, device=CPU)
    if kind[0] == "spatial":
        return SpatialRadiusEdge(slice(0, 2), radius=1.0)
    raise ValueError(kind)


def build_sparse_pair(spec, mesh):
    """tests/test_sharded_sparse.py's build_pair: (replicated SparseGCM,
    ShardedSparseGCM) over the same layer and preprocessor modules; with
    mesh None the replicated one alone, (SparseGCM, None)."""
    obs, hid = spec["obs"], spec["hid"]
    stack = []
    for _ in range(spec.get("layers", 2)):
        stack += [GraphConv(hid, hid, device=CPU), torch.tanh]
    pre = MLP([Linear(obs, hid, device=CPU)]) if spec.get("pre", True) \
        else None
    kw = dict(graph_size=spec["N"], max_edges=spec["E"], device=CPU)
    single = SparseGCM(SparseGNN(stack), preprocessor=pre,
                       edge_selectors=_selector(spec["sel"], obs), **kw)
    if mesh is None:
        return single, None
    sharded = ShardedSparseGCM(stack, mesh, preprocessor=pre,
                               edge_selectors=_selector(spec["sel"], obs),
                               comm=spec.get("comm", "auto"), **kw)
    return single, sharded


# -- runners ----------------------------------------------------------------
def mesh_shapes(spec):
    """make_mesh's shapes: (4, 1) named, the default dp, (2, 2)."""
    a = make_mesh(dp=4, tp=1, device_type="cpu")
    b = make_mesh(tp=1, device_type="cpu")
    c = make_mesh(dp=2, tp=2, device_type="cpu")
    return {"a": (a.mesh_dim_names, tuple(a.shape)),
            "b_dp": axis_size(b, "dp"), "c": tuple(c.shape),
            "c_coords": (axis_rank(c, "dp"), axis_rank(c, "tp"))}


def dense_scan_dp(spec):
    """The README DenseGCM's scan with the batch split over dp."""
    mesh = _mesh(spec["d"])
    model = readme_dense_gcm(spec["obs"], spec["hidden"], spec["graph"],
                             device=CPU)
    load_jax_params(model, spec["params"])
    xs = _t(spec["xs"])
    st = model.initial_state(xs.shape[0], xs.shape[-1])
    st = shard_pytree(mesh, st, state_specs(st))
    with torch.no_grad():
        outs, _ = model.scan(shard_tensor(xs, batch_sharding(mesh, 3)), st)
    return gather_tensor(outs, batch_sharding(mesh, 3))


def sparse_dp(spec):
    """The README SparseGCM's window with the batch split over dp."""
    mesh = _mesh(spec["d"])
    model = readme_sparse_gcm(spec["obs"], spec["hidden"], spec["graph"],
                              spec["max_edges"], device=CPU)
    load_jax_params(model, spec["params"])
    xs, taus = _t(spec["xs"]), _t(spec["taus"], torch.int32)
    st = model.initial_state(xs.shape[0], xs.shape[-1])
    st = shard_pytree(mesh, st, state_specs(st))
    b = batch_sharding(mesh, 3)
    with torch.no_grad():
        outs, _ = model(shard_tensor(xs, b), shard_tensor(
            taus, Spec(mesh, ("dp",))), st)
    return gather_tensor(outs, b)


def train_step_dp_tp(spec):
    """One Adam step of make_{dense,window,sparse}_supervised_step under
    TensorParallel on make_mesh(dp, tp); returns the loss, the whole
    parameters and this rank's shard shapes."""
    mesh = make_mesh(dp=spec["dp"], tp=spec["tp"], device_type="cpu")
    kind = spec["kind"]
    if kind == "dense":
        model = readme_dense_gcm(spec["obs"], spec["hidden"], spec["graph"],
                                 device=CPU)
    elif kind == "sparse":
        model = readme_sparse_gcm(spec["obs"], spec["hidden"], spec["graph"],
                                  spec["max_edges"], device=CPU)
    else:
        model = BandedRingGCM(_dense_gnn(spec["hidden"], layers=1),
                              hops=(1,), graph_size=spec["graph"], device=CPU)
    load_jax_params(model, spec["params"])
    tpm = TensorParallel(model, mesh)
    opt = torch.optim.Adam(tpm.parameters(), lr=1e-3)
    rows = block(spec["xs"].shape[0], spec["dp"], axis_rank(mesh, "dp"))
    xs, tg = _t(spec["xs"])[rows], _t(spec["targets"])[rows]
    if kind == "dense":
        loss = make_dense_supervised_step(tpm, opt)(xs, tg)
    elif kind == "sparse":
        loss = make_sparse_supervised_step(tpm, opt)(
            xs, tg, _t(spec["taus"], torch.int32)[rows])
    else:
        loss = make_window_supervised_step(tpm, opt)(xs, tg)
    return {"loss": loss, "params": tpm.gathered_state_dict(),
            "specs": param_specs(model),
            "shards": {n: tuple(p.shape) for n, p in tpm.shards.items()},
            "moments": {n: tuple(opt.state[p]["exp_avg"].shape)
                        for n, p in tpm.shards.items()}}


def remat_steps(spec):
    """Two Adam steps under TensorParallel on make_mesh(2, 2) whose
    backwards recompute: the README DenseGCM through
    make_trajectory_supervised_step(remat=spec["remat"]) (a checkpoint a
    step or chunk), or the ring core with EuclideanEdge through its scan
    (remat True or "reverse": the batch-wide mean recomputed or replayed
    in the backward). The losses and the whole parameters after."""
    mesh = make_mesh(dp=2, tp=2, device_type="cpu")
    obs, hidden, graph = spec["obs"], spec["hidden"], spec["graph"]
    if spec["kind"] == "dense":
        model = readme_dense_gcm(obs, hidden, graph, device=CPU)
    else:
        model = RingDenseGCM(
            _dense_gnn(hidden), preprocessor=MLP([Linear(obs, hidden,
                                                         device=CPU)]),
            edge_selectors=EuclideanEdge(spec["max_distance"], device=CPU),
            graph_size=graph, device=CPU)
    load_jax_params(model, spec["params"])
    tpm = TensorParallel(model, mesh)
    opt = torch.optim.Adam(tpm.parameters(), lr=1e-3)
    rows = block(spec["xs"].shape[0], 2, axis_rank(mesh, "dp"))
    xs, tg = _t(spec["xs"])[rows], _t(spec["targets"])[rows]
    if spec["kind"] == "dense":
        step = make_trajectory_supervised_step(tpm, opt,
                                               remat=spec["remat"])
        assert not step.use_window
    else:
        def step(xs, tg):
            opt.zero_grad(set_to_none=True)
            outs, _ = tpm.scan(xs, tpm.initial_state(xs.shape[0], obs),
                               remat=spec["remat"])
            loss = torch.mean((outs - tg) ** 2)
            loss.backward()
            tpm.sync_grads()
            opt.step()
            return tpm.reduce_loss(loss.detach())
    losses = [step(xs, tg) for _ in range(2)]
    return {"losses": losses, "params": tpm.gathered_state_dict()}


def fast_scan_sharded(spec):
    """A node-sharded fast-core scan on d ranks: beliefs and the whole
    final state."""
    mesh = _mesh(spec["d"])
    model = build_fast(spec)
    load_jax_params(model, spec["params"])
    xs = _t(spec["xs"])
    B = xs.shape[0]
    if spec["core"] == "scored":
        scan = banded_scored_scan_sharded(model, mesh, axis="dp")
        st = shard_banded_scored_state(model.initial_state(B, spec["F"]),
                                       mesh, "dp")
    else:
        fn = banded_scan_sharded if spec["core"] == "banded" else \
            clique_scan_sharded
        scan = fn(model, mesh, axis="dp")
        st = shard_banded_state(model.initial_state(B, spec["F"]), mesh,
                                "dp")
    with torch.no_grad():
        outs, fin = scan(xs, st)
    g = axis_group(mesh, "dp")
    out = {"outs": outs, "nodes": comm.all_gather_data(fin.nodes, g, 1),
           "t": fin.t}
    if spec["core"] == "scored":
        out["band"] = comm.all_gather_data(fin.band, g, 1)
    return out


def _recall_trainer(spec, mesh):
    env = RecallEnv(2, 4, 2, device=CPU)
    pol = GCMActorCritic(env.obs_dim, env.num_actions, env.num_actions,
                         graph_size=env.horizon + 1, gnn_input_size=8,
                         gnn_output_size=8, device=CPU, core=spec["core"],
                         edge_selectors=(DenseEdge() if spec["core"] ==
                                         "clique" else TemporalBackedge([1])))
    load_jax_params(pol, spec["params"])
    if spec["algo"] == "ppo":
        return PPO(env, pol, lr=spec["lr"], epochs=2, num_minibatches=2,
                   dp_mesh=mesh), pol
    return A2C(env, pol, lr=spec["lr"], dp_mesh=mesh), pol


def rl_dp(spec):
    """dp A2C / PPO on JAX's trajectory (and PPO's permutations): the
    parameters after the update and its loss."""
    mesh = _mesh(spec["d"])
    tr, pol = _recall_trainer(spec, mesh)
    traj = {k: _t(v) for k, v in spec["traj"].items()}
    if spec["algo"] == "ppo":
        m = tr.learn(traj, [_t(p) for p in spec["perms"]])
        loss = m["loss"]
    else:
        total, _ = tr.loss(tr._own(traj))
        tr.apply(total)
        loss = total.detach().clone()
        tr._dp_mean([loss])
    return {"loss": loss, "params": _named(pol)}


def rl_dp_update(spec):
    """A dp update against the single-process one from one seed: both
    collect from the same generator; every rank's parameters after."""
    mesh = _mesh(spec["d"])
    tr, pol = _recall_trainer(spec, mesh)
    ref = copy.deepcopy(pol)
    m = tr.update(torch.Generator().manual_seed(spec["seed"]), spec["B"])
    rtr = (PPO(tr.env, ref, lr=spec["lr"], epochs=2, num_minibatches=2)
           if spec["algo"] == "ppo" else A2C(tr.env, ref, lr=spec["lr"]))
    w = rtr.update(torch.Generator().manual_seed(spec["seed"]), spec["B"])
    return {"loss": m["loss"], "want_loss": w["loss"],
            "params": _named(pol), "want": _named(ref)}


def sharded_sparse(spec):
    """The sharded core against the replicated port over windows: beliefs
    of both, the whole final states, the first window's aux, and the
    gradients of sum(beliefs^2) of `grad_window` from a fresh state."""
    mesh = _mesh(spec["d"])
    single, sharded = build_sparse_pair(spec, mesh)
    load_jax_params(single, spec["params"])
    load_jax_params(sharded, spec["params"])
    B, obs = spec["B"], spec["obs"]
    halo4 = sharded._halo(4)
    ss, sh = single.initial_state(B, obs), sharded.initial_state(B, obs)
    outs_s, outs_h, aux_h, aux_s, modes = [], [], [], [], []
    with torch.no_grad():
        for i, (xs, taus) in enumerate(spec["windows"]):
            if i == spec.get("fresh_from"):  # a new module goes on
                sharded = build_sparse_pair(spec, mesh)[1]
                load_jax_params(sharded, spec["params"])
            xs, taus = _t(xs), _t(taus, torch.int32)
            modes.append(sharded.comm_for(xs.shape[1], sh))
            a, ss, ax_s = single(xs, taus, ss, return_aux=True)
            b, sh, ax_h = sharded(xs, taus, sh, return_aux=True)
            outs_s.append(a)
            outs_h.append(b)
            aux_s.append(ax_s)
            aux_h.append(ax_h)
    out = {"single": outs_s, "sharded": outs_h, "modes": modes,
           "state": tuple(gather_sparse_state(sh, mesh)),
           "single_state": tuple(ss), "aux": aux_h, "single_aux": aux_s,
           "nb": sharded.nb, "epl": sharded.epl,
           "halo4": halo4,
           "reset_mode": sharded.comm_for(1, reset_where(
               sh, torch.ones(B, dtype=torch.bool)))}
    if "grad_window" in spec:
        xs, taus = (_t(spec["grad_window"][0]),
                    _t(spec["grad_window"][1], torch.int32))
        _, fresh = build_sparse_pair(spec, mesh)
        load_jax_params(fresh, spec["params"])
        b, _ = fresh(xs, taus, fresh.initial_state(B, obs))
        (b ** 2).sum().backward()
        out["grads"] = _grads(fresh)
        out["grad_beliefs"] = b.detach()
    return out


def refusals(spec):
    """The configurations the sharded core and the adapter refuse, each
    with its ValueError's message."""
    mesh = _mesh(4)
    core = build_sparse_pair({"obs": 6, "hid": 8, "N": 64, "E": 256,
                              "sel": ("temporal", (1,))}, mesh)[1]
    out = {}
    tries = {
        "stochastic": lambda: ShardedSparseGCM(
            [GraphConv(8, 8, device=CPU)], mesh,
            edge_selectors=_selector(("stochastic",), 6), graph_size=64,
            max_edges=256, device=CPU),
        "chain_member": lambda: ShardedSparseGCM(
            [GraphConv(8, 8, device=CPU)], mesh,
            edge_selectors=SparseEdgeChain([TemporalEdge([1]),
                                            _selector(("spatial",), 6)]),
            graph_size=64, max_edges=256, device=CPU),
        "adapter_max_hops": lambda: SparseGCMActorCritic(
            6, 3, 3, mesh=mesh, graph_size=64, gnn_input_size=8,
            gnn_output_size=8, edge_selectors=TemporalEdge([1]), max_hops=2,
            device=CPU),
        "dones": lambda: core(torch.zeros(2, 1, 6),
                              torch.ones(2, dtype=torch.int32),
                              core.initial_state(2, 6),
                              dones=torch.zeros(2, 1, dtype=torch.bool)),
        "halo_too_wide": lambda: build_sparse_pair(
            {"obs": 6, "hid": 8, "N": 16, "E": 64, "comm": "halo",
             "sel": ("learned", 6)}, mesh)[1].comm_for(4),
    }
    for name, fn in tries.items():
        try:
            fn()
            out[name] = ""
        except ValueError as e:
            out[name] = str(e)
    return out


def adapter(spec):
    """SparseGCMActorCritic(mesh=) against the replicated adapter."""
    mesh = _mesh(spec["d"])
    common = dict(graph_size=64, max_edges=256, gnn_input_size=spec["hid"],
                  gnn_output_size=spec["hid"], device=CPU)
    pol_s = SparseGCMActorCritic(spec["obs"], 3, 3, mesh=mesh,
                                 edge_selectors=TemporalEdge([1, 2]),
                                 **common)
    load_jax_params(pol_s, spec["params"])
    obs = _t(spec["xs"])
    with torch.no_grad():
        logits, values, _ = pol_s(obs, pol_s.initial_state(obs.shape[0]))
    return {"core": type(pol_s.core).__name__, "logits": logits,
            "values": values}


def spmm_partitioned(spec):
    """Each partitioned SpMM and the gradient of sum(out^2) in x, on d
    ranks; outputs and gradients whole."""
    mesh = _mesh(spec["d"])
    d, r = axis_size(mesh, "dp"), axis_rank(mesh, "dp")
    x, edges, w = (_t(spec["x"]), _t(spec["edges"], torch.int32),
                   _t(spec["w"]))
    B, N, F = x.shape
    rows = block(N, d, r)
    g = axis_group(mesh, "dp")
    out = {}
    x_rep = x.clone().requires_grad_(True)
    lanes = block(edges.shape[-1], d, r)
    y = spmm_edge_partitioned(mesh)(x_rep, edges[..., lanes].contiguous(),
                                    w[:, lanes].contiguous())
    (y ** 2).sum().backward()
    out["edge"] = (y.detach(), x_rep.grad)

    def node_sharded(f, be, bw):
        xb = x[:, rows].clone().requires_grad_(True)
        lanes = block(be.shape[-1], d, r)
        yb = f(xb, be[..., lanes].contiguous(), bw[:, lanes].contiguous())
        (yb ** 2).sum().backward()
        return (comm.all_gather_data(yb.detach(), g, 1),
                comm.all_gather_data(xb.grad, g, 1))

    be, bw = bucket_edges_by_sink(edges, w, d, N)
    out["sink_bucketed"] = edge_scatter_add(x, be, bw)
    out["node"] = node_sharded(spmm_node_partitioned(mesh), be, bw)
    ce, cw = bucket_edges_cross(edges, w, d, N, k_pair=spec["k_pair"])
    out["cross_bucketed"] = edge_scatter_add(x, ce, cw)
    out["bucketed"] = node_sharded(spmm_bucketed(mesh, N), ce, cw)
    if "band_edges" in spec:
        he, hw = _t(spec["band_edges"], torch.int32), _t(spec["band_w"])
        hbe, hbw = bucket_edges_by_sink(he, hw, d, N)
        out["halo"] = node_sharded(spmm_halo(mesh, N, spec["halo"]), hbe,
                                   hbw)
    return out


def partitioned_gcm(spec):
    """SparseGCM over PartitionedSparseGNN in a mode against JAX's plain
    SparseGCM: beliefs and the gradients of sum(beliefs^2); with
    "targets", one supervised Adam step's loss and parameters."""
    mesh = _mesh(spec["d"])
    F, N = spec["F"], spec["N"]
    layers = [GraphConv(F, F, device=CPU), torch.tanh,
              GraphConv(F, F, device=CPU), torch.tanh]
    gnn = PartitionedSparseGNN(layers, mesh, num_nodes=spec.get("num_nodes"),
                               mode=spec["mode"], **spec.get("gnn_kw", {}))
    model = SparseGCM(gnn, graph_size=N, max_edges=spec["E"],
                      edge_selectors=TemporalEdge(list(spec["hops"])),
                      device=CPU)
    load_jax_params(model, spec["params"])
    xs, taus = _t(spec["xs"]), _t(spec["taus"], torch.int32)
    B = xs.shape[0]
    y, _ = model(xs, taus, model.initial_state(B, F))
    (y ** 2).sum().backward()
    out = {"mode": gnn.mode, "beliefs": y.detach(), "grads": _grads(model)}
    if "targets" in spec:
        model.zero_grad()
        opt = torch.optim.Adam(model.parameters(), lr=1e-3)
        out["loss"] = make_sparse_supervised_step(model, opt)(
            xs, _t(spec["targets"]), taus)
        out["params"] = _named(model)
    return out


def auto_modes(spec):
    mesh = _mesh(4)
    layers = [GraphConv(4, 4, device=CPU)]
    return [PartitionedSparseGNN(layers, mesh, **kw).mode
            for kw in spec["kws"]]


def multihost(spec):
    """tests/multihost_common.py's update on the dp axis of 2 ranks: one
    SGD step of BandedRingGCM.window with each rank's half of the batch,
    the gradients averaged over dp; (sum of |updated params|, grad norm).
    And the sharded SparseGCM's checksum with its node axis over the
    same ranks."""
    mesh = _mesh(2)
    g = axis_group(mesh, "dp")
    hid, obs, N = spec["hid"], spec["obs"], spec["N"]
    stack = [DenseGraphConv(hid, hid, device=CPU), torch.tanh,
             DenseGraphConv(hid, hid, device=CPU), torch.tanh]
    model = BandedRingGCM(DenseGNN(stack),
                          preprocessor=MLP([Linear(obs, hid, device=CPU)]),
                          hops=(1,), graph_size=N, device=CPU)
    load_jax_params(model, spec["params"])
    xs, ys = _t(spec["xs"]), _t(spec["ys"])
    rows = block(xs.shape[0], 2, axis_rank(mesh, "dp"))
    outs, _ = model.window(xs[rows], model.initial_state(
        rows.stop - rows.start, obs))
    # the mean over the global batch: each rank's half-batch mean / 2
    (torch.mean((outs - ys[rows]) ** 2) / 2).backward()
    grads = [p.grad for p in model.parameters()]
    flat = comm.psum(torch.cat([q.reshape(-1) for q in grads]), g)
    gnorm = float(torch.sqrt(torch.sum(flat ** 2)))
    at, checksum = 0, 0.0
    with torch.no_grad():
        for p in model.parameters():
            p -= spec["lr"] * flat[at:at + p.numel()].view_as(p)
            at += p.numel()
            checksum += float(p.abs().sum())
    sp = spec["sparse"]
    single, sharded = build_sparse_pair(
        {"obs": obs, "hid": hid, "N": sp["N"], "E": sp["E"],
         "sel": ("learned", 6)}, mesh)
    load_jax_params(sharded, sp["params"])
    with torch.no_grad():
        mx, st = sharded(_t(sp["xs"]), _t(sp["taus"], torch.int32),
                         sharded.initial_state(sp["xs"].shape[0], obs))
    n_edges = comm.all_gather_data(st.num_edges, g, 1).sum()
    return {"checksum": checksum, "grad_norm": gnorm,
            "sharded_sparse_sum": float(mx.abs().sum()),
            "sharded_sparse_edges": int(n_edges)}


def dryrun(spec):
    """The whole dry run (parallel/dryrun.py) on this world."""
    from gcm_tpu_torch.parallel.dryrun import dryrun_rank

    return dryrun_rank("cpu")


RUNNERS = {f.__name__: f for f in (
    dryrun,
    mesh_shapes, dense_scan_dp, sparse_dp, train_step_dp_tp, remat_steps,
    fast_scan_sharded, rl_dp, rl_dp_update, sharded_sparse, refusals,
    adapter, spmm_partitioned, partitioned_gcm, auto_modes, multihost)}


def run_cases(device_type: str, cases: dict) -> dict:
    """{name: RUNNERS[runner](spec)} for cases {name: (runner, spec)}, on
    the CPU (the parity tests' device)."""
    if device_type != "cpu":
        raise ValueError("the parity cases run on the CPU")
    torch.manual_seed(0)
    out, seconds = {}, {}
    for name, (runner, spec) in cases.items():
        t0 = time.perf_counter()
        out[name] = RUNNERS[runner](spec)
        seconds[name] = time.perf_counter() - t0
    out["seconds"] = seconds
    return out
