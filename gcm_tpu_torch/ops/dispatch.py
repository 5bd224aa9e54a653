"""Compute ops the conv layers call (counterpart of gcm_tpu/ops/dispatch.py),
forward only.

The choice between kernel and plain version follows the tensors' device and
nothing else: CUDA tensors launch the hand-written kernel, CPU tensors take
its plain PyTorch version. There is no size gate.
"""

from __future__ import annotations

from gcm_tpu_torch.ops.cuda.dense_gconv import fused_dense_graph_conv
from gcm_tpu_torch.ops.cuda.spmm import spmm_edge_list


def dense_graph_conv(x, adj, w_rel, b_rel, w_root):
    """out = (adj @ x) @ w_rel + b_rel + x @ w_root (DenseGraphConv 'add')."""
    return fused_dense_graph_conv(x, adj, w_rel, b_rel, w_root)


def spmm(x, edges, weights):
    """out[b, i] = sum over e with sink_e = i of w_e * x[b, src_e]
    (the sparse GraphConv / GCNConv aggregation)."""
    return spmm_edge_list(x, edges, weights)
