"""gcm_tpu_torch: the PyTorch / CUDA port of gcm_tpu for one NVIDIA H100.

Plain tensor code is PyTorch; the graph-conv kernels are hand-written CUDA
for sm_90a (csrc/), built with nvcc into `_build/` at first use. Entry
points run on the CUDA card unless given device="cpu", where every kernel
takes its plain PyTorch version. This package imports neither JAX nor
the gcm_tpu package.
"""

from gcm_tpu_torch.core.graph_state import (DenseGraphState,
                                            dense_initial_state, reset_where)
from gcm_tpu_torch.device import resolve_device
from gcm_tpu_torch.edges.temporal import TemporalBackedge
from gcm_tpu_torch.models.dense_gcm import DenseGCM
from gcm_tpu_torch.models.presets import readme_dense_gcm
from gcm_tpu_torch.nn.dense_conv import DenseGNN, DenseGraphConv
from gcm_tpu_torch.nn.module import MLP, Linear
from gcm_tpu_torch.ops.cuda.dense_gconv import fused_dense_graph_conv
from gcm_tpu_torch.ops.cuda.fused_gnn import fused_dense_gnn
from gcm_tpu_torch.serve.sessions import SessionServer
from gcm_tpu_torch.weights import (load_jax_params, state_from_numpy,
                                   state_to_numpy)

__all__ = [
    "DenseGCM", "DenseGNN", "DenseGraphConv", "DenseGraphState", "Linear",
    "MLP", "SessionServer", "TemporalBackedge", "dense_initial_state",
    "fused_dense_gnn", "fused_dense_graph_conv", "load_jax_params",
    "readme_dense_gcm", "reset_where", "resolve_device", "state_from_numpy",
    "state_to_numpy",
]
