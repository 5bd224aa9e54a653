"""Compute ops the conv layers call (counterpart of gcm_tpu/ops/dispatch.py),
forward only.

The choice between kernel and plain version follows the tensors' device and
nothing else: CUDA tensors launch the hand-written kernel, CPU tensors take
its plain PyTorch version. There is no size gate.
"""

from __future__ import annotations

from gcm_tpu_torch.ops.cuda.dense_gconv import fused_dense_graph_conv


def dense_graph_conv(x, adj, w_rel, b_rel, w_root):
    """out = (adj @ x) @ w_rel + b_rel + x @ w_root (DenseGraphConv 'add')."""
    return fused_dense_graph_conv(x, adj, w_rel, b_rel, w_root)
