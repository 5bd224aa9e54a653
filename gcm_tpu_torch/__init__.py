"""gcm_tpu_torch: the PyTorch / CUDA port of gcm_tpu for one NVIDIA H100.

Plain tensor code is PyTorch; the graph-conv, SpMM and score-row kernels,
and the backwards of the graph-conv stack and of the SpMM edge weights, are
hand-written CUDA for sm_90a (csrc/), built with nvcc into `_build/` at
first use. The train steps (train/) train both cores through them. Entry
points run on the CUDA card unless given device="cpu", where every kernel
takes its plain PyTorch version. This package imports neither JAX nor
the gcm_tpu package.
"""

from gcm_tpu_torch.core.graph_state import (DenseGraphState,
                                            SparseGraphState,
                                            dense_initial_state, reset_where,
                                            sparse_initial_state)
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
from gcm_tpu_torch.models.converters import dense_to_sparse, sparse_to_dense
from gcm_tpu_torch.models.dense_gcm import DenseGCM, dense_fused_supported
from gcm_tpu_torch.models.positional import (PositionalEncoding,
                                             RelativePositionalEncoding,
                                             sincos_table)
from gcm_tpu_torch.models.presets import readme_dense_gcm, readme_sparse_gcm
from gcm_tpu_torch.models.sparse_gcm import SparseGCM
from gcm_tpu_torch.nn.dense_conv import (DenseGCNConv, DenseGNN,
                                         DenseGraphConv)
from gcm_tpu_torch.nn.module import MLP, LayerNorm, Linear
from gcm_tpu_torch.nn.sparse_conv import GCNConv, GraphConv, SparseGNN
from gcm_tpu_torch.ops.coalesce import coalesce_edges
from gcm_tpu_torch.ops.cuda.dense_gconv import fused_dense_graph_conv
from gcm_tpu_torch.ops.cuda.fused_gnn import fused_dense_gnn
from gcm_tpu_torch.ops.cuda.sddmm import (sddmm_threshold_row,
                                          sddmm_threshold_row_current)
from gcm_tpu_torch.ops.cuda.spmm import spmm_edge_list
from gcm_tpu_torch.ops.cuda.spmm_slots import (bucket_sink_slots,
                                               check_slot_overflow, spmm_slots)
from gcm_tpu_torch.serve.sessions import SessionServer
from gcm_tpu_torch.train import (make_dense_supervised_step,
                                 make_sparse_supervised_step)
from gcm_tpu_torch.utils.packing import pack_hidden, unpack_hidden
from gcm_tpu_torch.weights import (load_jax_params, named_from_jax,
                                   sparse_state_from_numpy,
                                   sparse_state_to_numpy, state_from_numpy,
                                   state_to_numpy)

__all__ = [
    "CosineEdge", "DenseEdge", "DenseGCM", "DenseGCNConv", "DenseGNN",
    "DenseGraphConv", "DenseGraphState", "Distance", "EdgeChain",
    "EuclideanEdge", "GCNConv", "GraphConv", "LayerNorm", "LearnedEdge",
    "Linear", "MLP", "PositionalEncoding", "RelativePositionalEncoding",
    "SessionServer", "SparseEdgeChain", "SparseGCM", "SparseGNN",
    "SparseGraphState", "SparseLearnedEdge", "SpatialEdge",
    "SpatialKNNEdge", "SpatialRadiusEdge", "TemporalBackedge",
    "TemporalEdge", "bucket_sink_slots", "check_slot_overflow",
    "coalesce_edges", "default_edge_network", "dense_fused_supported",
    "dense_initial_state", "dense_to_sparse", "fused_dense_gnn",
    "fused_dense_graph_conv", "load_jax_params",
    "make_dense_supervised_step", "make_sparse_supervised_step",
    "named_from_jax", "pack_hidden", "readme_dense_gcm",
    "readme_sparse_gcm", "reset_where", "resolve_device",
    "sddmm_threshold_row", "sddmm_threshold_row_current", "sincos_table",
    "sparse_initial_state", "sparse_state_from_numpy",
    "sparse_state_to_numpy", "sparse_to_dense", "spmm_edge_list",
    "spmm_slots", "state_from_numpy", "state_to_numpy", "unpack_hidden",
]
