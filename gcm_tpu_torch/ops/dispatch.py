"""Compute ops the conv layers call (counterpart of gcm_tpu/ops/dispatch.py),
differentiable as JAX's custom VJPs are: dense_graph_conv in every argument,
adj included (learned edges); spmm in x and the edge weights. Their
backwards launch CUDA kernels on the card (ops/cuda/fused_gnn.py::
fused_dense_gnn_bwd; spmm_edge_list on the flipped edges and
ops/cuda/edge_grad.py).

The choice between kernel and plain version follows the tensors' device and
nothing else: CUDA tensors launch the hand-written kernel, CPU tensors take
its plain PyTorch version. There is no size gate.
"""

from __future__ import annotations

from gcm_tpu_torch.ops.cuda.dense_gconv import fused_dense_graph_conv
from gcm_tpu_torch.ops.cuda.spmm import spmm_edge_list


def dense_graph_conv(x, adj, w_rel, b_rel, w_root):
    """out = (adj @ x) @ w_rel + b_rel + x @ w_root (DenseGraphConv 'add').
    Differentiable in every argument."""
    return fused_dense_graph_conv(x, adj, w_rel, b_rel, w_root)


def spmm(x, edges, weights):
    """out[b, i] = sum over e with sink_e = i of w_e * x[b, src_e]
    (the sparse GraphConv / GCNConv aggregation). Differentiable in x and
    weights; edges are index data."""
    return spmm_edge_list(x, edges, weights)
