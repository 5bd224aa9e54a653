"""The multichip dry run of the port (counterpart of
__graft_entry__.py::dryrun_multichip), section for section in JAX's order,
each checked against its unsharded counterpart on the same rank:

 1. dp x tp README DenseGCM train step (TensorParallel);
 2. edge-partitioned SparseGCM (PartitionedSparseGNN, psum);
 3. bucketed all_to_all SpMM;
 4. halo SparseGCM + its supervised train step;
 5. halo SpMM on a banded graph;
 6. node-sharded banded, clique and scored-band scans;
 7. dp A2C and PPO updates;
 8. dp A2C on the banded and clique windows;
 9. dp x tp train step through BandedRingGCM.window;
10. mesh SessionServer (a BandedRingGCM pool), with a snapshot restored
    into an unsharded server;
11. dp ring window (EuclideanEdge) forward and backward;
12. end-to-end ShardedSparseGCM with a deterministic windowed learned
    selector, forward and gradient, against the replicated SparseGCM.

`dryrun_rank(device_type)` is one rank's body inside an initialised world
of n ranks (tp = 2 where n is even, dp = n / tp; the edge and node shards
over all n); it returns {section: its numbers} and raises where a section
misses its tolerance (beliefs and outputs 1e-5, gradients, losses and
one optimizer step 1e-4). `dryrun_multichip(n)` runs it in this process's
world of n ranks, or spawns one.

`sharded_cases_rank` is the body of chip_smoke.py's world of two ranks on
one card: the README-width sharded sparse core (halo and psum, each
ending in an Adam step, with the share of its wall time in collectives
from `timed_collectives`), the halo PartitionedSparseGNN train step and
the dp A2C update, returned for the parent to hold against the unsharded
port (`sharded_core`, `partitioned_core`, `sparse_windows_and_step` build
and run both sides).
"""

from __future__ import annotations

import contextlib
import copy
import time

import numpy as np
import torch
import torch.distributed as dist

from gcm_tpu_torch.device import resolve_device
from gcm_tpu_torch.edges.dense import DenseEdge
from gcm_tpu_torch.edges.distance import EuclideanEdge
from gcm_tpu_torch.edges.sparse_learned import LearnedEdge as \
    SparseLearnedEdge
from gcm_tpu_torch.edges.sparse_temporal import TemporalEdge
from gcm_tpu_torch.edges.temporal import TemporalBackedge
from gcm_tpu_torch.models.banded_gcm import BandedRingGCM, BandedScoredGCM
from gcm_tpu_torch.models.clique_gcm import CliqueGCM
from gcm_tpu_torch.models.presets import readme_dense_gcm
from gcm_tpu_torch.models.ring_gcm import RingDenseGCM
from gcm_tpu_torch.models.sparse_gcm import SparseGCM
from gcm_tpu_torch.nn.dense_conv import DenseGNN, DenseGraphConv
from gcm_tpu_torch.nn.module import MLP, Linear
from gcm_tpu_torch.nn.sparse_conv import GraphConv, SparseGNN
from gcm_tpu_torch.ops.dispatch import spmm
from gcm_tpu_torch.parallel import comm
from gcm_tpu_torch.parallel.banded_partition import (
    banded_scan_sharded, banded_scored_scan_sharded, clique_scan_sharded,
    shard_banded_scored_state, shard_banded_state)
from gcm_tpu_torch.parallel.distributed import spawn_world
from gcm_tpu_torch.parallel.edge_partition import (PartitionedSparseGNN,
                                                   bucket_edges_by_sink,
                                                   bucket_edges_cross,
                                                   spmm_bucketed, spmm_halo)
from gcm_tpu_torch.parallel.mesh import (axis_group, axis_rank, axis_size,
                                         bind_batch, block, make_mesh)
from gcm_tpu_torch.parallel.sharded_sparse import ShardedSparseGCM
from gcm_tpu_torch.parallel.sharding import TensorParallel
from gcm_tpu_torch.rl.a2c import A2C
from gcm_tpu_torch.rl.env import RecallEnv
from gcm_tpu_torch.rl.ppo import PPO
from gcm_tpu_torch.rl.wrappers import GCMActorCritic
from gcm_tpu_torch.serve.sessions import SessionServer
from gcm_tpu_torch.train.train_step import (make_dense_supervised_step,
                                            make_sparse_supervised_step,
                                            make_window_supervised_step)

TOL_OUT = 1e-5   # beliefs and outputs
TOL_GRAD = 1e-4  # gradients, losses, parameters after an optimizer step


def close(label, got, want, tol) -> float:
    """max |got - want|; raises past tol."""
    err = float((torch.as_tensor(got).detach().cpu().double()
                 - torch.as_tensor(want).detach().cpu().double())
                .abs().max()) if torch.as_tensor(want).numel() else 0.0
    if not err <= tol:
        raise AssertionError(f"{label}: max |error| {err:.3g} > {tol:g}")
    return err


def params_close(label, got: dict, ref_module, tol=TOL_GRAD) -> float:
    """The largest error of got {name: tensor} against ref_module's."""
    return max(close(f"{label} {n}", got[n], p, tol)
               for n, p in ref_module.named_parameters())


def grads_close(label, module, ref_module, tol=TOL_GRAD) -> float:
    ref = dict(ref_module.named_parameters())
    err = 0.0
    for n, p in module.named_parameters():
        a = p.grad if p.grad is not None else torch.zeros_like(p)
        b = ref[n].grad if ref[n].grad is not None else torch.zeros_like(p)
        err = max(err, close(f"{label} grad {n}", a, b, tol))
    return err


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _randn(seed, *shape, device):
    return torch.randn(*shape, generator=_gen(seed)).to(device)


def _conv_stack(cls, widths, device, seed, layers=1):
    g = _gen(seed)
    out = []
    for _ in range(layers):
        out += [cls(widths, widths, device=device, generator=g), torch.tanh]
    return out


def _device(device_type):
    if device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def dense_dp_tp(mesh, dev, obs=8, hidden=32, graph=16, T=4, B=None,
                seed=0) -> dict:
    """Section 1: the README DenseGCM's train step under dp x tp against
    the unsharded step (loss 1e-5, every parameter after Adam 1e-4)."""
    dp = axis_size(mesh, "dp")
    B = B or 2 * dp
    model = readme_dense_gcm(obs, hidden, graph, device=dev, seed=seed)
    ref = copy.deepcopy(model)
    xs = _randn(seed + 1, B, T, obs, device=dev)
    tg = _randn(seed + 2, B, T, hidden, device=dev)
    rows = block(B, dp, axis_rank(mesh, "dp"))
    tpm = TensorParallel(model, mesh)
    loss = make_dense_supervised_step(
        tpm, torch.optim.Adam(tpm.parameters(), lr=1e-3))(xs[rows], tg[rows])
    want = make_dense_supervised_step(
        ref, torch.optim.Adam(ref.parameters(), lr=1e-3))(xs, tg)
    return {"loss": float(loss), "loss_err": close("dense dp x tp loss", loss,
                                                   want, TOL_OUT),
            "param_err": params_close("dense dp x tp",
                                      tpm.gathered_state_dict(), ref)}


def window_dp_tp(mesh, dev, hidden=32, graph=16, T=4, B=None, seed=18):
    """Section 9: BandedRingGCM's window train step under dp x tp."""
    dp = axis_size(mesh, "dp")
    B = B or 2 * dp
    model = BandedRingGCM(DenseGNN(_conv_stack(DenseGraphConv, hidden, dev,
                                               seed)),
                          hops=(1,), graph_size=graph, device=dev)
    ref = copy.deepcopy(model)
    xs = _randn(seed + 1, B, T, hidden, device=dev)
    tg = _randn(seed + 2, B, T, hidden, device=dev)
    rows = block(B, dp, axis_rank(mesh, "dp"))
    tpm = TensorParallel(model, mesh)
    loss = make_window_supervised_step(
        tpm, torch.optim.Adam(tpm.parameters(), lr=1e-3))(xs[rows], tg[rows])
    want = make_window_supervised_step(
        ref, torch.optim.Adam(ref.parameters(), lr=1e-3))(xs, tg)
    return {"loss": float(loss),
            "loss_err": close("window dp x tp loss", loss, want, TOL_OUT),
            "param_err": params_close("window dp x tp",
                                      tpm.gathered_state_dict(), ref)}


def edge_partitioned_sparse(ep, dev, hidden=32, graph=16, T=4, seed=1):
    """Section 2: SparseGCM over PartitionedSparseGNN (psum mode)."""
    n = axis_size(ep, "dp")
    B = 2 * n
    layers = _conv_stack(GraphConv, hidden, dev, seed)
    kw = dict(graph_size=graph, max_edges=4 * graph,
              edge_selectors=TemporalEdge([1]), device=dev)
    part = SparseGCM(PartitionedSparseGNN(layers, ep), **kw)
    plain = SparseGCM(SparseGNN(layers), **kw)
    x = _randn(seed + 1, B, T, hidden, device=dev)
    taus = torch.full((B,), T, dtype=torch.int32, device=dev)
    got, _ = part(x, taus, part.initial_state(B, hidden))
    want, _ = plain(x, taus, plain.initial_state(B, hidden))
    return {"out_err": close("edge-partitioned SparseGCM", got, want,
                             TOL_OUT)}


def _random_graph(seed, B, N, E, F, dev, banded=False):
    g = _gen(seed)
    sink = torch.randint(0, N, (B, E), generator=g)
    src = torch.randint(0, N, (B, E), generator=g)
    if banded:  # a window-4 causal band
        src = torch.clamp(sink - 1 - src % 4, min=0)
    edges = torch.stack([sink, src], 1).to(torch.int32).to(dev)
    w = torch.rand((B, E), generator=g).to(dev)
    return _randn(seed + 1, B, N, F, device=dev), edges, w


def bucketed_spmm(ep, dev, F=32, E=64, seed=2):
    """Section 3: the all_to_all SpMM on a random graph."""
    n, r = axis_size(ep, "dp"), axis_rank(ep, "dp")
    N, B = 8 * n, 2 * n
    x, edges, w = _random_graph(seed, B, N, E, F, dev)
    want = spmm(x, edges, w)
    be, bw = bucket_edges_cross(edges, w, n, N, k_pair=E)
    lanes = block(be.shape[-1], n, r)
    rows = block(N, n, r)
    got = spmm_bucketed(ep, N)(x[:, rows], be[..., lanes].contiguous(),
                               bw[:, lanes].contiguous())
    return {"out_err": close("bucketed a2a SpMM", got, want[:, rows],
                             TOL_OUT)}


def halo_sparse_train(ep, dev, F=32, T=4, seed=11):
    """Section 4: SparseGCM on the halo collective and its train step."""
    n = axis_size(ep, "dp")
    N, B = 2 * n, 2 * n
    layers = _conv_stack(GraphConv, F, dev, seed)
    kw = dict(graph_size=N, max_edges=4 * N,
              edge_selectors=TemporalEdge([1, 2]), device=dev)
    part = SparseGCM(PartitionedSparseGNN(layers, ep, num_nodes=N,
                                          mode="halo", halo=2), **kw)
    plain = copy.deepcopy(SparseGCM(SparseGNN(layers), **kw))
    xs = _randn(seed + 1, B, T, F, device=dev)
    tg = _randn(seed + 2, B, T, F, device=dev)
    taus = torch.full((B,), T, dtype=torch.int32, device=dev)
    loss = make_sparse_supervised_step(
        part, torch.optim.Adam(part.parameters(), lr=1e-3))(xs, tg, taus)
    want = make_sparse_supervised_step(
        plain, torch.optim.Adam(plain.parameters(), lr=1e-3))(xs, tg, taus)
    return {"loss": float(loss),
            "loss_err": close("halo SparseGCM loss", loss, want, TOL_OUT),
            "param_err": params_close("halo SparseGCM", dict(
                part.named_parameters()), plain)}


def halo_spmm(ep, dev, F=32, E=64, seed=4):
    """Section 5: the ppermute halo SpMM on a banded graph."""
    n, r = axis_size(ep, "dp"), axis_rank(ep, "dp")
    N, B = 8 * n, 2 * n
    x, edges, w = _random_graph(seed, B, N, E, F, dev, banded=True)
    want = spmm(x, edges, w)
    be, bw = bucket_edges_by_sink(edges, w, n, N)
    lanes, rows = block(be.shape[-1], n, r), block(N, n, r)
    got = spmm_halo(ep, N, halo=5)(x[:, rows], be[..., lanes].contiguous(),
                                   bw[:, lanes].contiguous())
    return {"out_err": close("halo SpMM", got, want[:, rows], TOL_OUT)}


def sharded_scans(ep, dev, hidden=32, seed=5):
    """Section 6: node-sharded banded, clique and scored-band scans."""
    n = axis_size(ep, "dp")
    N, B = 2 * n, 2 * n
    xs = _randn(seed + 1, B, N + 3, hidden, device=dev)
    out = {}
    for kind in ("banded", "clique", "scored"):
        gnn = DenseGNN(_conv_stack(DenseGraphConv, hidden, dev, seed))
        if kind == "banded":
            model = BandedRingGCM(gnn, hops=(1,), graph_size=N, device=dev)
            scan = banded_scan_sharded(model, ep, axis="dp")
            st = shard_banded_state(model.initial_state(B, hidden), ep, "dp")
        elif kind == "clique":
            model = CliqueGCM(gnn, graph_size=N, device=dev)
            scan = clique_scan_sharded(model, ep, axis="dp")
            st = shard_banded_state(model.initial_state(B, hidden), ep, "dp")
        else:
            model = BandedScoredGCM(
                gnn, distance=EuclideanEdge(1.1, window=2, device=dev),
                graph_size=N, device=dev)
            scan = banded_scored_scan_sharded(model, ep, axis="dp")
            st = shard_banded_scored_state(model.initial_state(B, hidden),
                                           ep, "dp")
        with torch.no_grad():
            want, _ = model.scan(xs, model.initial_state(B, hidden))
            got, _ = scan(xs, st)
        out[f"{kind}_err"] = close(f"sharded {kind} scan", got, want,
                                   TOL_OUT)
    return out


def recall_policy(env, dev, seed, **kw):
    return GCMActorCritic(env.obs_dim, env.num_actions, env.num_actions,
                          graph_size=env.horizon + 1, gnn_input_size=8,
                          gnn_output_size=8, device=dev,
                          generator=_gen(seed), **kw)


def dp_rl(ep, dev, seed=7, B=None) -> dict:
    """Sections 7 and 8: dp A2C and PPO updates on the recall task (ring
    core), and dp A2C on the banded and clique windows, each against the
    single-process update from the same generator seed."""
    n = axis_size(ep, "dp")
    B = B or 2 * n
    env = RecallEnv(num_symbols=2, horizon=4, noise_dim=2, device=dev)
    out = {}
    cases = [("a2c", A2C, {"edge_selectors": TemporalBackedge([1])}, {}),
             ("ppo", PPO, {"edge_selectors": TemporalBackedge([1])},
              {"epochs": 2, "num_minibatches": 2}),
             ("a2c_banded", A2C, {"core": "banded",
                                  "edge_selectors": TemporalBackedge([1])},
              {}),
             ("a2c_clique", A2C, {"core": "clique",
                                  "edge_selectors": DenseEdge()}, {})]
    for label, cls, pol_kw, tr_kw in cases:
        pol = recall_policy(env, dev, seed, **pol_kw)
        ref = copy.deepcopy(pol)
        m = cls(env, pol, dp_mesh=ep, **tr_kw).update(
            torch.Generator(device=dev).manual_seed(seed + 1), B)
        w = cls(env, ref, **tr_kw).update(
            torch.Generator(device=dev).manual_seed(seed + 1), B)
        out[label] = {"loss": float(m["loss"]),
                      "loss_err": close(f"dp {label} loss", m["loss"],
                                        w["loss"], TOL_GRAD),
                      "param_err": params_close(
                          f"dp {label}", dict(pol.named_parameters()), ref)}
    return out


def mesh_server(ep, dev, obs=8, hidden=32, graph=16, ticks=3, seed=3):
    """Section 10: a BandedRingGCM session pool split over the mesh against
    the unsharded server, then its snapshot restored into an unsharded
    server, which must continue alike."""
    n = axis_size(ep, "dp")
    g = _gen(seed)
    model = BandedRingGCM(
        DenseGNN([DenseGraphConv(hidden, hidden, device=dev, generator=g),
                  torch.tanh]),
        preprocessor=MLP([Linear(obs, hidden, device=dev, generator=g)]),
        hops=(1,), graph_size=graph, device=dev)
    srv = SessionServer(model, 2 * n, obs, mesh=ep, device=dev)
    ref = SessionServer(model, 2 * n, obs, device=dev)
    rng = np.random.default_rng(seed)
    err = 0.0
    for tick in range(ticks):
        reqs = {f"s{(i + tick) % (2 * n)}": rng.standard_normal(obs)
                for i in range(n + 1 if 2 * n > n + 1 else n)}
        a, b = srv.step(reqs), ref.step(reqs)
        err = max(err, max(close("mesh server", a[k], b[k], TOL_OUT)
                           for k in reqs))
    restored = SessionServer(model, 2 * n, obs, device=dev)
    restored.restore(srv.snapshot())
    reqs = {f"s{i}": rng.standard_normal(obs) for i in range(n)}
    a, b = restored.step(reqs), ref.step(reqs)
    err = max(err, max(close("mesh snapshot restored unsharded", a[k], b[k],
                             TOL_OUT) for k in reqs))
    return {"out_err": err, "sessions": 2 * n, "ranks": n}


def dp_ring_window(ep, dev, obs=8, hidden=32, graph=16, T=4, seed=21):
    """Section 11: RingDenseGCM(EuclideanEdge).window forward and backward
    with the batch split over dp (its batch-wide mean over every rank's
    rows: the selector bound to the dp group), against the whole batch in
    one process; then the scan with remat=True and remat="reverse", whose
    backwards recompute the steps (and the mean) after the forward."""
    n, r = axis_size(ep, "dp"), axis_rank(ep, "dp")
    B = 2 * n
    g = _gen(seed)
    model = RingDenseGCM(
        DenseGNN(_conv_stack(DenseGraphConv, hidden, dev, seed, layers=2)),
        preprocessor=MLP([Linear(obs, hidden, device=dev, generator=g)]),
        edge_selectors=EuclideanEdge(1.0, device=dev), graph_size=graph,
        device=dev)
    ref = copy.deepcopy(model)
    bind_batch(model, axis_group(ep, "dp"))
    xs = 0.3 * _randn(seed + 1, B, T, obs, device=dev)
    rows = block(B, n, r)
    want, _ = ref.window(xs, ref.initial_state(B, obs))
    (want ** 2).sum().backward()
    out_err = grad_err = 0.0
    for remat in (None, True, "reverse"):
        label = f"dp ring {'window' if remat is None else 'scan'} " \
                f"remat={remat}"
        model.zero_grad(set_to_none=True)
        st = model.initial_state(B // n, obs)
        outs, _ = (model.window(xs[rows], st) if remat is None
                   else model.scan(xs[rows], st, remat=remat))
        (outs ** 2).sum().backward()
        comm.all_reduce_many([p.grad for p in model.parameters()],
                             axis_group(ep, "dp"))
        out_err = max(out_err, close(label, outs, want[rows], TOL_OUT))
        grad_err = max(grad_err, grads_close(label, model, ref))
    return {"out_err": out_err, "grad_err": grad_err}


def e2e_sharded_sparse(ep, dev, obs=8, hidden=32, T=4, seed=22):
    """Section 12: ShardedSparseGCM (windowed deterministic learned
    selector) forward and gradient against the replicated SparseGCM."""
    n = axis_size(ep, "dp")
    N, B = 8 * n, 2 * n
    stack = _conv_stack(GraphConv, hidden, dev, seed, layers=2)
    pre = MLP([Linear(obs, hidden, device=dev, generator=_gen(seed))])

    def sel():
        return SparseLearnedEdge(obs, deterministic=True, num_edge_samples=3,
                                 window=6, device=dev,
                                 generator=_gen(seed + 5))

    sharded = ShardedSparseGCM(stack, ep, preprocessor=pre,
                               edge_selectors=sel(), graph_size=N,
                               max_edges=8 * N, device=dev)
    ref = copy.deepcopy(SparseGCM(SparseGNN(stack), preprocessor=pre,
                                  edge_selectors=sel(), graph_size=N,
                                  max_edges=8 * N, device=dev))
    xs = _randn(seed + 1, B, T, obs, device=dev)
    taus = torch.full((B,), T, dtype=torch.int32, device=dev)
    got, _ = sharded(xs, taus, sharded.initial_state(B, obs))
    want, _ = ref(xs, taus, ref.initial_state(B, obs))
    (got ** 2).sum().backward()
    (want ** 2).sum().backward()
    return {"out_err": close("e2e sharded SparseGCM", got, want, TOL_OUT),
            "loss": float((got ** 2).sum().detach()),
            "grad_err": grads_close("e2e sharded SparseGCM", sharded, ref)}


SECTIONS = ("dense_dp_tp", "edge_partitioned_sparse", "bucketed_spmm",
            "halo_sparse_train", "halo_spmm", "sharded_scans", "dp_rl",
            "window_dp_tp", "mesh_server", "dp_ring_window",
            "e2e_sharded_sparse")


def dryrun_rank(device_type: str = "cuda", verbose: bool = False) -> dict:
    """One rank's dry run inside an initialised world (module
    docstring)."""
    n = dist.get_world_size()
    dev = _device(device_type)
    tp = 2 if n % 2 == 0 else 1
    mesh = make_mesh(dp=n // tp, tp=tp, device_type=device_type)
    ep = make_mesh(dp=n, tp=1, device_type=device_type)
    out = {}
    for name in SECTIONS:
        fn = globals()[name]
        out[name] = fn(mesh if name in ("dense_dp_tp", "window_dp_tp")
                       else ep, dev)
        if verbose and dist.get_rank() == 0:
            print(f"dryrun_multichip({n}): {name} "
                  f"(dp{n // tp} x tp{tp}) OK {out[name]}", flush=True)
    return out


def dryrun_multichip(n: int, device_type: str = "cuda",
                     backend: str | None = None,
                     verbose: bool = True) -> dict:
    """Run every section on n ranks: in this process's world when it has
    n ranks, else in a spawned one. device_type "cuda" (the default)
    raises without a card; NCCL takes a card a rank (backend="gloo" puts
    several ranks on one card). Returns rank 0's {section: numbers};
    every rank checks its own."""
    if device_type == "cuda":
        resolve_device(None)
    if dist.is_initialized():
        if dist.get_world_size() != n:
            raise ValueError(f"this world has {dist.get_world_size()} "
                             f"ranks, not {n}")
        return dryrun_rank(device_type, verbose)
    return spawn_world(dryrun_rank, n, device_type,
                       args=(device_type, verbose), backend=backend)[0]


@contextlib.contextmanager
def timed_collectives(sync=lambda: None):
    """Within the block, the wall seconds spent in parallel/comm.py's
    collectives (its four entry points), each bracketed by sync()
    (torch.cuda.synchronize on the card, so work queued before a
    collective is not charged to it): yields {"seconds", "calls"}."""
    rec = {"seconds": 0.0, "calls": 0}
    names = ("all_reduce_", "all_gather_data", "_ppermute", "_all_to_all")
    saved = {n: getattr(comm, n) for n in names}

    def timed(fn):
        def run(*args, **kw):
            sync()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            sync()
            rec["seconds"] += time.perf_counter() - t0
            rec["calls"] += 1
            return out
        return run

    for n in names:
        setattr(comm, n, timed(saved[n]))
    try:
        yield rec
    finally:
        for n in names:
            setattr(comm, n, saved[n])


def sparse_windows_and_step(model, data, dev, sync=lambda: None):
    """chip_smoke.py's sharded-core run, the same on a sharded core (each
    rank) and on its replicated twin: the windows of data["xs"] [W, B, T,
    obs] forward, the state carried (beliefs of each), then one Adam step
    on the last window from the carried state; returns the beliefs, the
    loss, the gradients, the parameters after the step and the edge
    count."""
    xs = torch.as_tensor(data["xs"], device=dev)
    tg = torch.as_tensor(data["targets"], device=dev)
    taus = torch.full((xs.shape[1],), xs.shape[2], dtype=torch.int32,
                      device=dev)
    state = model.initial_state(xs.shape[1], xs.shape[-1])
    beliefs = []
    with torch.no_grad():
        for w in range(xs.shape[0] - 1):
            out, state = model(xs[w], taus, state)
            beliefs.append(out)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    opt.zero_grad(set_to_none=True)
    out, state = model(xs[-1], taus, state)
    loss = torch.mean((out - tg) ** 2)
    loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()
             if p.grad is not None}
    opt.step()
    sync()
    edges = state.num_edges
    if isinstance(model, ShardedSparseGCM):
        edges = comm.all_gather_data(edges, model.group, 1)
    return {"beliefs": torch.stack(beliefs + [out.detach()]),
            "loss": loss.detach(), "grads": grads,
            "params": {n: p.detach() for n, p in model.named_parameters()},
            "num_edges": edges.sum(-1) if edges.dim() == 2 else edges}


def sharded_cases_rank(device_type: str, data: dict) -> dict:
    """The body of chip_smoke.py's two-rank world on one card (gloo): the
    sharded core on the halo and psum paths (`sparse_windows_and_step`,
    the share of its wall time in collectives), the halo
    PartitionedSparseGNN's train step, the dp A2C update, which
    collectives gloo runs on CUDA tensors, and this rank's kernel
    launches. data: {"xs", "targets", "N", "E", "obs", "hidden",
    "part_xs", "part_targets", "a2c_B"}."""
    from gcm_tpu_torch.ops.cuda.edge_grad import edge_weight_grad
    from gcm_tpu_torch.ops.cuda.fused_gnn import (fused_dense_gnn,
                                                  fused_dense_gnn_bwd)
    from gcm_tpu_torch.ops.cuda.spmm import spmm_edge_list

    dev = _device(device_type)
    sync = torch.cuda.synchronize if device_type == "cuda" else \
        (lambda: None)
    mesh = make_mesh(dp=dist.get_world_size(), tp=1, device_type=device_type)
    counted = (fused_dense_gnn, fused_dense_gnn_bwd, spmm_edge_list,
               edge_weight_grad)
    for fn in counted:
        fn.launches = 0
    out = {"gloo_cuda": _gloo_cuda_collectives(dev)}
    for case in ("halo", "psum"):
        # a first run warms the path up; the second, on a fresh core of
        # the same weights, is timed and returned
        sparse_windows_and_step(sharded_core(case, mesh, data, dev), data,
                                dev, sync)
        model = sharded_core(case, mesh, data, dev)
        sync()
        t0 = time.perf_counter()
        with timed_collectives(sync) as rec:
            res = sparse_windows_and_step(model, data, dev, sync)
        wall = time.perf_counter() - t0
        res.update(comm=model.comm_for(data["xs"].shape[2]), wall_s=wall,
                   collective_s=rec["seconds"], collectives=rec["calls"])
        out[case] = res
    part = partitioned_core(mesh, data, dev)
    xs, tg = (torch.as_tensor(data["part_xs"], device=dev),
              torch.as_tensor(data["part_targets"], device=dev))
    taus = torch.full((xs.shape[0],), xs.shape[1], dtype=torch.int32,
                      device=dev)
    loss = make_sparse_supervised_step(
        part, torch.optim.Adam(part.parameters(), lr=1e-3))(xs, tg, taus)
    out["partitioned"] = {"loss": loss, "params": {
        n: p.detach() for n, p in part.named_parameters()}}
    env = RecallEnv(num_symbols=2, horizon=4, noise_dim=2, device=dev)
    pol = recall_policy(env, dev, seed=7,
                         edge_selectors=TemporalBackedge([1]))
    m = A2C(env, pol, dp_mesh=mesh).update(
        torch.Generator(device=dev).manual_seed(8), data["a2c_B"])
    out["a2c"] = {"loss": m["loss"], "params": {
        n: p.detach() for n, p in pol.named_parameters()}}
    sync()
    out["launches"] = {fn.__name__: fn.launches for fn in counted}
    return out


def _gloo_cuda_collectives(dev) -> dict:
    """Which collectives this world's backend runs on a tensor of dev:
    "ok" or the error's first line (PyTorch documents gloo's CUDA support
    as broadcast and all_reduce only)."""
    t = torch.ones(4, device=dev)
    tries = {
        "all_reduce": lambda: dist.all_reduce(t.clone()),
        "broadcast": lambda: dist.broadcast(t.clone(), src=0),
        "all_gather": lambda: dist.all_gather(
            [torch.empty_like(t) for _ in range(dist.get_world_size())], t),
    }
    out = {}
    for name, fn in tries.items():
        try:
            fn()
            out[name] = "ok"
        except RuntimeError as e:
            out[name] = str(e).splitlines()[0][:120]
    return out


def sharded_core(case, mesh, data, dev):
    """chip_smoke.py's sharded sparse core (examples/train_sharded.py's:
    two GraphConv + tanh, a Linear preprocessor) at the README sparse
    core's graph: case "halo" with TemporalEdge([1, 2]), "psum" with an
    unwindowed deterministic LearnedEdge; with mesh None the replicated
    SparseGCM of the same weights."""
    obs, hidden = data["obs"], data["hidden"]
    g = _gen(0)
    stack = [GraphConv(hidden, hidden, device=dev, generator=g), torch.tanh,
             GraphConv(hidden, hidden, device=dev, generator=g), torch.tanh]
    pre = MLP([Linear(obs, hidden, device=dev, generator=g)])
    sel = (TemporalEdge([1, 2]) if case == "halo" else
           SparseLearnedEdge(obs, deterministic=True, num_edge_samples=3,
                             device=dev, generator=g))
    kw = dict(preprocessor=pre, edge_selectors=sel, graph_size=data["N"],
              max_edges=data["E"], device=dev)
    if mesh is None:
        return SparseGCM(SparseGNN(stack), **kw)
    return ShardedSparseGCM(stack, mesh, comm=case, **kw)


def partitioned_core(mesh, data, dev):
    """The halo PartitionedSparseGNN's SparseGCM at chip_smoke.py's widths
    (TemporalEdge([1, 2]), halo 2); with mesh None its SparseGNN twin."""
    hidden = data["hidden"]
    g = _gen(1)
    stack = [GraphConv(hidden, hidden, device=dev, generator=g), torch.tanh,
             GraphConv(hidden, hidden, device=dev, generator=g), torch.tanh]
    pre = MLP([Linear(data["obs"], hidden, device=dev, generator=g)])
    gnn = (SparseGNN(stack) if mesh is None else
           PartitionedSparseGNN(stack, mesh, num_nodes=data["N"],
                                mode="halo", halo=2))
    return SparseGCM(gnn, preprocessor=pre, graph_size=data["N"],
                     max_edges=data["E"],
                     edge_selectors=TemporalEdge([1, 2]), device=dev)
