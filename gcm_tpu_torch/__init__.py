"""gcm_tpu_torch: the PyTorch / CUDA port of gcm_tpu for one NVIDIA H100.

Plain tensor code is PyTorch; the graph-conv, SpMM and score-row kernels,
and the backwards of the graph-conv stack and of the SpMM edge weights, are
hand-written CUDA for sm_90a (csrc/), built with nvcc into `_build/` at
first use. The train steps (train/) train both cores through them, and the
RL stack (rl/: environments, actor-critic policies over the ring, dense and
sparse cores, A2C and PPO) trains policies on the card; its host-stepped
path (rl/external.py, the native replay buffer and CartPole pool of
data/host_buffer.py and rl/native_env.py, data/prefetch.py) drives host
environments, and rl/nav.py trains a navigation policy over the NavGCM
cores (models/nav_gcm.py, nn/nav_conv.py). The fast cores
(models/banded_gcm.py, models/clique_gcm.py, models/ring_window.py)
compute whole trajectories without a scan, and make_window_supervised_step
/ make_trajectory_supervised_step train through them. parallel/ runs
the port on torch.distributed, one process a shard: dp x tp train steps,
the partitioned and node-sharded sparse cores, the node-sharded fast-core
scans, SessionServer(mesh=), A2C / PPO(dp_mesh=). Entry
points run on the CUDA card unless given device="cpu", where every kernel
takes its plain PyTorch version. This package imports neither JAX nor
the gcm_tpu package.
"""

from gcm_tpu_torch.core.graph_state import (DenseGraphState,
                                            SparseGraphState,
                                            dense_initial_state, reset_where,
                                            sparse_initial_state)
from gcm_tpu_torch.data.host_buffer import HostReplayBuffer, pack_edges_host
from gcm_tpu_torch.data.prefetch import prefetch_to_device
from gcm_tpu_torch.device import resolve_device
from gcm_tpu_torch.edges.chain import EdgeChain
from gcm_tpu_torch.edges.dense import DenseEdge
from gcm_tpu_torch.edges.distance import (CosineEdge, Distance, EuclideanEdge,
                                          SpatialEdge)
from gcm_tpu_torch.edges.learned import LearnedEdge, default_edge_network
from gcm_tpu_torch.edges.sparse_learned import LearnedEdge as \
    SparseLearnedEdge
from gcm_tpu_torch.edges.sparse_spatial import (SparseEdgeChain,
                                                SpatialKNNEdge,
                                                SpatialRadiusEdge)
from gcm_tpu_torch.edges.sparse_temporal import TemporalEdge
from gcm_tpu_torch.edges.temporal import TemporalBackedge
from gcm_tpu_torch.models.banded_gcm import (BandedRingGCM,
                                             BandedScoredGCM,
                                             BandedScoredState, BandedState)
from gcm_tpu_torch.models.clique_gcm import CliqueGCM
from gcm_tpu_torch.models.converters import dense_to_sparse, sparse_to_dense
from gcm_tpu_torch.models.dense_gcm import DenseGCM, dense_fused_supported
from gcm_tpu_torch.models.nav_gcm import (NavDenseGNN, NavGCM,
                                          NavGCMIncremental, NavIncState,
                                          NavState, nav_core)
from gcm_tpu_torch.models.positional import (PositionalEncoding,
                                             RelativePositionalEncoding,
                                             sincos_table)
from gcm_tpu_torch.models.presets import readme_dense_gcm, readme_sparse_gcm
from gcm_tpu_torch.models.ring_gcm import RingDenseGCM, RingGraphState
from gcm_tpu_torch.models.sparse_gcm import SparseGCM
from gcm_tpu_torch.nn.dense_conv import (DenseGCNConv, DenseGNN,
                                         DenseGraphConv)
from gcm_tpu_torch.nn.module import MLP, LayerNorm, Linear
from gcm_tpu_torch.nn.nav_conv import NavPoseGNN, NavRelPosConv
from gcm_tpu_torch.nn.sparse_conv import GCNConv, GraphConv, SparseGNN
from gcm_tpu_torch.ops.coalesce import coalesce_edges
from gcm_tpu_torch.ops.cuda.dense_gconv import fused_dense_graph_conv
from gcm_tpu_torch.ops.cuda.fused_gnn import fused_dense_gnn
from gcm_tpu_torch.ops.cuda.sddmm import (sddmm_threshold_row,
                                          sddmm_threshold_row_current)
from gcm_tpu_torch.ops.cuda.spmm import spmm_edge_list
from gcm_tpu_torch.ops.cuda.spmm_slots import (bucket_sink_slots,
                                               check_slot_overflow, spmm_slots)
from gcm_tpu_torch.parallel.edge_partition import PartitionedSparseGNN
from gcm_tpu_torch.parallel.sharded_sparse import (ShardedSparseGCM,
                                                   ShardedSparseState)
from gcm_tpu_torch.rl.a2c import A2C, discounted_returns
from gcm_tpu_torch.rl.distributions import Categorical, DiagGaussian
from gcm_tpu_torch.rl.env import (CartPoleEnv, ContinuousRecallEnv,
                                  RecallEnv, TMazeEnv)
from gcm_tpu_torch.rl.external import (HostEnvPool, PythonEnv,
                                       collect_host_episodes,
                                       episode_batch_to_device,
                                       make_offline_a2c_update)
from gcm_tpu_torch.rl.native_env import NativeCartPolePool
from gcm_tpu_torch.rl.nav import (NavActorCritic, PointGoalNav,
                                  make_nav_a2c_update)
from gcm_tpu_torch.rl.ppo import PPO, gae
from gcm_tpu_torch.rl.wrappers import GCMActorCritic, SparseGCMActorCritic
from gcm_tpu_torch.serve.sessions import SessionServer
from gcm_tpu_torch.train import (make_dense_supervised_step,
                                 make_sparse_supervised_step,
                                 make_trajectory_supervised_step,
                                 make_window_supervised_step)
from gcm_tpu_torch.utils.debug import grad_norms
from gcm_tpu_torch.utils.packing import pack_hidden, unpack_hidden
from gcm_tpu_torch.weights import (banded_scored_state_from_numpy,
                                   banded_scored_state_to_numpy,
                                   banded_state_from_numpy,
                                   banded_state_to_numpy, jax_param_tree,
                                   jax_paths,
                                   load_jax_params, named_from_jax,
                                   nav_inc_state_from_numpy,
                                   nav_inc_state_to_numpy,
                                   nav_state_from_numpy, nav_state_to_numpy,
                                   ring_state_from_numpy, ring_state_to_numpy,
                                   sparse_state_from_numpy,
                                   sparse_state_to_numpy, state_from_numpy,
                                   state_to_numpy)

__all__ = [
    "A2C", "BandedRingGCM", "BandedScoredGCM", "BandedScoredState",
    "BandedState", "CartPoleEnv", "CliqueGCM", "Categorical", "ContinuousRecallEnv", "CosineEdge",
    "DenseEdge", "DenseGCM", "DenseGCNConv", "DenseGNN", "DenseGraphConv",
    "DenseGraphState", "DiagGaussian", "Distance", "EdgeChain",
    "EuclideanEdge", "GCMActorCritic", "GCNConv", "GraphConv", "HostEnvPool",
    "HostReplayBuffer", "LayerNorm", "LearnedEdge", "Linear", "MLP",
    "NativeCartPolePool", "NavActorCritic", "NavDenseGNN", "NavGCM",
    "NavGCMIncremental", "NavIncState", "NavPoseGNN", "NavRelPosConv",
    "NavState", "PPO", "PartitionedSparseGNN", "PointGoalNav", "PositionalEncoding", "PythonEnv",
    "RecallEnv", "RelativePositionalEncoding", "RingDenseGCM",
    "RingGraphState", "SessionServer", "ShardedSparseGCM",
    "ShardedSparseState", "SparseEdgeChain", "SparseGCM",
    "SparseGCMActorCritic", "SparseGNN", "SparseGraphState",
    "SparseLearnedEdge", "SpatialEdge", "SpatialKNNEdge", "SpatialRadiusEdge",
    "TMazeEnv", "TemporalBackedge", "TemporalEdge", "bucket_sink_slots",
    "banded_scored_state_from_numpy", "banded_scored_state_to_numpy",
    "banded_state_from_numpy", "banded_state_to_numpy",
    "check_slot_overflow", "coalesce_edges", "collect_host_episodes",
    "default_edge_network", "dense_fused_supported", "dense_initial_state",
    "dense_to_sparse", "discounted_returns", "episode_batch_to_device",
    "fused_dense_gnn", "fused_dense_graph_conv", "gae", "grad_norms",
    "jax_param_tree", "jax_paths", "load_jax_params",
    "make_dense_supervised_step", "make_nav_a2c_update",
    "make_offline_a2c_update", "make_sparse_supervised_step",
    "make_trajectory_supervised_step", "make_window_supervised_step", "named_from_jax",
    "nav_core", "nav_inc_state_from_numpy", "nav_inc_state_to_numpy",
    "nav_state_from_numpy", "nav_state_to_numpy", "pack_edges_host",
    "pack_hidden", "prefetch_to_device", "readme_dense_gcm",
    "readme_sparse_gcm", "reset_where", "resolve_device",
    "ring_state_from_numpy", "ring_state_to_numpy", "sddmm_threshold_row",
    "sddmm_threshold_row_current", "sincos_table", "sparse_initial_state",
    "sparse_state_from_numpy", "sparse_state_to_numpy", "sparse_to_dense",
    "spmm_edge_list", "spmm_slots", "state_from_numpy", "state_to_numpy",
    "unpack_hidden",
]
