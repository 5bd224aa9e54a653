"""The port stands alone: gcm_tpu_torch and chip_smoke.py import neither JAX
nor the JAX package, and the port's entry points run on the CUDA card by
default, raising instead of falling back to the CPU when there is none."""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import gcm_tpu_torch as g
from gcm_tpu_torch.benchmarks.spmm_variants import (probe_dynamic_gather,
                                                    run_sweep)
from gcm_tpu_torch.parallel import distributed as pdist
from gcm_tpu_torch.parallel.dryrun import dryrun_multichip
from gcm_tpu_torch.parallel.mesh import make_mesh
from gcm_tpu_torch.train.resilient import train_resilient

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


def test_import_leaves_jax_out():
    code = ("import sys, gcm_tpu_torch, gcm_tpu_torch.ops._build, "
            "gcm_tpu_torch.weights, gcm_tpu_torch.benchmarks.spmm_variants, "
            "gcm_tpu_torch.edges.sparse_learned, "
            "gcm_tpu_torch.edges.sparse_spatial, "
            "gcm_tpu_torch.data.host_buffer, gcm_tpu_torch.data.prefetch, "
            "gcm_tpu_torch.rl.external, gcm_tpu_torch.rl.native_env, "
            "gcm_tpu_torch.rl.nav, gcm_tpu_torch.models.nav_gcm, "
            "gcm_tpu_torch.nn.nav_conv, gcm_tpu_torch.models.banded_gcm, "
            "gcm_tpu_torch.models.clique_gcm, "
            "gcm_tpu_torch.models.ring_window, "
            "gcm_tpu_torch.train.train_step, "
            "gcm_tpu_torch.models.ring_reversible, "
            "gcm_tpu_torch.models.dense_reversible, "
            "gcm_tpu_torch.train.checkpoint, gcm_tpu_torch.train.resilient, "
            "gcm_tpu_torch.serve.export, gcm_tpu_torch.utils.debug, "
            "gcm_tpu_torch.utils.precision, gcm_tpu_torch.utils.roofline, "
            "gcm_tpu_torch.utils.indexing, gcm_tpu_torch.utils.contracts, "
            "gcm_tpu_torch.parallel.mesh, gcm_tpu_torch.parallel.comm, "
            "gcm_tpu_torch.parallel.distributed, "
            "gcm_tpu_torch.parallel.sharding, "
            "gcm_tpu_torch.parallel.edge_partition, "
            "gcm_tpu_torch.parallel.sharded_sparse, "
            "gcm_tpu_torch.parallel.banded_partition, "
            "gcm_tpu_torch.parallel.dryrun, gcm_tpu_torch.parallel.cases; "
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'jaxlib')) or m == 'gcm_tpu' "
            "or m.startswith('gcm_tpu.')); print(bad)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True,
                         timeout=120)
    assert out.stdout.strip() == "[]"


def test_sources_reference_no_jax():
    files = sorted((ROOT / "gcm_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]
    assert len(files) > 10
    hits = []
    for path in files:
        for line in path.read_text().splitlines():
            if re.search(r"^\s*(import jax|from jax)", line) or re.search(
                    r"\bgcm_tpu\.", line):
                hits.append(f"{path.relative_to(ROOT)}: {line.strip()}")
    # mentions of the JAX package's files in docstrings and comments name
    # them by path (gcm_tpu/...), never as a module (gcm_tpu.x)
    assert not hits, hits


def _cpu_model():
    return g.readme_dense_gcm(graph_size=16, device="cpu")


def _cpu_gnn():
    return g.DenseGNN([g.DenseGraphConv(4, 4, device="cpu"), torch.tanh])


def _cpu_nav_gnn():
    return g.NavDenseGNN([g.DenseGraphConv(4, 4, device="cpu")])


@pytest.mark.parametrize("entry", [
    lambda: g.readme_dense_gcm(),
    lambda: g.Linear(4, 4),
    lambda: g.DenseGraphConv(4, 4),
    lambda: g.DenseGCM(g.DenseGNN([g.DenseGraphConv(4, 4, device="cpu")])),
    lambda: g.SessionServer(_cpu_model(), capacity=2, obs_dim=8),
    lambda: g.resolve_device(None),
    lambda: g.readme_sparse_gcm(),
    lambda: g.GraphConv(4, 4),
    lambda: g.GCNConv(4, 4),
    lambda: g.SparseGCM(g.SparseGNN([g.GraphConv(4, 4, device="cpu")]),
                        edge_selectors=g.TemporalEdge([1])),
    lambda: g.LayerNorm(4),
    lambda: g.LearnedEdge(4),
    lambda: g.SparseLearnedEdge(4),
    lambda: g.DenseGCNConv(4, 4),
    lambda: g.SparseGCM(g.SparseGNN([g.GraphConv(4, 4, device="cpu")]),
                        edge_selectors=g.SparseEdgeChain(
                            [g.TemporalEdge([1]),
                             g.SpatialKNNEdge(slice(0, 2), 2)])),
    lambda: g.CosineEdge(0.5, learned=True),
    lambda: g.SpatialEdge(0.5, slice(0, 2), learned=True),
    lambda: g.TemporalBackedge(learned=True),
    lambda: g.PositionalEncoding(feat_dim=4),
    lambda: g.RelativePositionalEncoding(feat_dim=4),
    lambda: g.DenseGCM(g.DenseGNN([g.DenseGraphConv(4, 4, device="cpu")]),
                       edge_selectors=g.CosineEdge(0.5)),
    lambda: run_sweep(),
    lambda: probe_dynamic_gather(),
    lambda: g.RingDenseGCM(g.DenseGNN([g.DenseGraphConv(4, 4,
                                                        device="cpu")]),
                           edge_selectors=g.TemporalBackedge([1])),
    lambda: g.GCMActorCritic(4, 2, 2, edge_selectors=g.TemporalBackedge([1])),
    lambda: g.SparseGCMActorCritic(4, 2, 2,
                                   edge_selectors=g.TemporalEdge([1])),
    lambda: g.A2C(g.RecallEnv(), g.GCMActorCritic(9, 4, 4)),
    lambda: g.PPO(g.RecallEnv(), g.GCMActorCritic(9, 4, 4)),
    lambda: g.TMazeEnv(),
    lambda: g.CartPoleEnv(masked_velocity=True),
    lambda: g.RecallEnv(),
    lambda: g.ContinuousRecallEnv(),
    lambda: g.NavGCM(_cpu_nav_gnn()),
    lambda: g.NavGCMIncremental(_cpu_nav_gnn()),
    lambda: g.nav_core(_cpu_nav_gnn()),
    lambda: g.NavRelPosConv(4, 4),
    lambda: g.NavActorCritic(5, 3),
    lambda: g.prefetch_to_device(iter([])),
    lambda: g.episode_batch_to_device(*(np.zeros((1, 2)),) * 3,
                                      np.ones(1), 0.9),
    lambda: g.BandedRingGCM(_cpu_gnn()),
    lambda: g.BandedScoredGCM(_cpu_gnn(), hops=(1,)),
    lambda: g.CliqueGCM(_cpu_gnn()),
    lambda: g.GCMActorCritic(4, 2, 2, core="banded",
                             edge_selectors=g.TemporalBackedge([1])),
    lambda: g.GCMActorCritic(4, 2, 2, core="clique",
                             edge_selectors=g.DenseEdge()),
    lambda: g.GCMActorCritic(4, 2, 2, core="banded_scored",
                             edge_selectors=g.EuclideanEdge(1.0, window=4)),
    lambda: train_resilient(None, "unused", updates=1),
], ids=["readme_dense_gcm", "Linear", "DenseGraphConv", "DenseGCM",
        "SessionServer", "resolve_device", "readme_sparse_gcm", "GraphConv",
        "GCNConv", "SparseGCM", "LayerNorm", "LearnedEdge",
        "SparseLearnedEdge", "DenseGCNConv", "SparseGCM_spatial_chain",
        "CosineEdge_learned", "SpatialEdge_learned",
        "TemporalBackedge_learned", "PositionalEncoding",
        "RelativePositionalEncoding", "DenseGCM_cosine", "run_sweep",
        "probe_dynamic_gather", "RingDenseGCM", "GCMActorCritic",
        "SparseGCMActorCritic", "A2C", "PPO", "TMazeEnv", "CartPoleEnv",
        "RecallEnv", "ContinuousRecallEnv", "NavGCM", "NavGCMIncremental",
        "nav_core", "NavRelPosConv", "NavActorCritic", "prefetch_to_device",
        "episode_batch_to_device", "BandedRingGCM", "BandedScoredGCM",
        "CliqueGCM", "GCMActorCritic_banded", "GCMActorCritic_clique",
        "GCMActorCritic_banded_scored", "train_resilient"])
def test_entry_points_default_to_cuda(entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None resolves to it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry()


def test_cpu_server_runs_when_asked():
    srv = g.SessionServer(_cpu_model(), capacity=2, obs_dim=8, device="cpu")
    out = srv.step({"a": np.ones(8, np.float32)})
    assert out["a"].shape == (32,) and np.isfinite(out["a"]).all()


@pytest.mark.parametrize("entry", [
    lambda: make_mesh(),
    lambda: pdist.global_mesh(),
    lambda: pdist.initialize_multihost("localhost:1", 1, 0),
    lambda: pdist.spawn_world(print, 1),
    lambda: pdist.world_of_one().__enter__(),
    lambda: dryrun_multichip(1),
    lambda: g.SessionServer(_cpu_model(), capacity=2, obs_dim=8,
                            mesh=object()),
], ids=["make_mesh", "global_mesh", "initialize_multihost", "spawn_world",
        "world_of_one", "dryrun_multichip", "SessionServer_mesh"])
def test_parallel_entry_points_default_to_cuda(entry):
    """The parallel entry points take the card by default and raise
    without one, before any process group or process exists."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default resolves to it")
    with pytest.raises(RuntimeError, match="='cpu'"):
        entry()
    assert not torch.distributed.is_initialized()


def test_parallel_runs_on_the_cpu_when_asked():
    """A CPU world of one: the mesh, a mesh SessionServer and the whole
    dry run."""
    with pdist.world_of_one("cpu"):
        mesh = make_mesh(device_type="cpu")
        assert tuple(mesh.shape) == (1, 1)
        srv = g.SessionServer(_cpu_model(), capacity=2, obs_dim=8,
                              mesh=mesh, device="cpu")
        out = srv.step({"a": np.ones(8, np.float32)})
        assert out["a"].shape == (32,) and np.isfinite(out["a"]).all()
        res = dryrun_multichip(1, device_type="cpu", verbose=False)
        assert res["e2e_sharded_sparse"]["grad_err"] <= 1e-4
    assert not torch.distributed.is_initialized()
