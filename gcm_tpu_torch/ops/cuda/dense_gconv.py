"""Fused single dense graph-conv layer (counterpart of
gcm_tpu/ops/pallas/dense_gconv.py):

    out = (adj @ x) @ W_rel + b_rel + x @ W_root  [+ activation]

It shares its device code with the fused stack (csrc/dense_gnn.cu, the
one-layer case, where each block takes one tile of rows) but has its own C
entry point and its own launch count.
"""

from __future__ import annotations

import torch

from gcm_tpu_torch.ops.cuda._launch import (
    ACT_CODES, check_aligned16, check_cuda, check_forward_only, check_rc,
    check_sizes, ptr, stream_of)
from gcm_tpu_torch.ops.cuda.fused_gnn import _lib, fused_dense_gnn_plain


def fused_dense_graph_conv_plain(x, adj, w_rel, b_rel, w_root,
                                 activation=None):
    return fused_dense_gnn_plain(x, adj, (w_rel, b_rel, w_root), (activation,))


def _launch(x, adj, w_rel, b_rel, w_root, activation):
    if x.dim() != 3:
        raise ValueError(f"x must be [B, N, F], got {tuple(x.shape)}")
    B, N, F = x.shape
    Fo = w_rel.shape[-1]
    check_sizes(B, N, (F, Fo))
    dev = x.device
    check_cuda("x", x, (B, N, F), dev)
    check_cuda("adj", adj, (B, N, N), dev)
    check_aligned16("adj", adj)
    check_cuda("w_rel", w_rel, (F, Fo), dev)
    check_cuda("b_rel", b_rel, (Fo,), dev)
    check_cuda("w_root", w_root, (F, Fo), dev)
    if activation not in ACT_CODES:
        raise ValueError(f"unsupported activation {activation}")
    out = torch.empty((B, N, Fo), device=dev, dtype=torch.float32)
    rc = _lib().gcm_fused_dense_graph_conv_f32(
        ptr(x), ptr(adj), ptr(w_rel), ptr(b_rel), ptr(w_root), ptr(out),
        B, N, F, Fo, ACT_CODES[activation], dev.index, stream_of(dev))
    check_rc("fused_dense_graph_conv", rc)
    fused_dense_graph_conv.launches += 1
    return out


def fused_dense_graph_conv(x, adj, w_rel, b_rel, w_root, activation=None):
    """x [B,N,F], adj [B,N,N], w_rel/w_root [F,Fo], b_rel [Fo] -> [B,N,Fo].
    CUDA tensors launch the kernel (or raise); CPU tensors take the plain
    version."""
    check_forward_only(x, adj, w_rel, b_rel, w_root)
    if x.device.type == "cpu":
        return fused_dense_graph_conv_plain(x, adj, w_rel, b_rel, w_root,
                                            activation)
    return _launch(x, adj, w_rel, b_rel, w_root, activation)


fused_dense_graph_conv.launches = 0  # kernel launches, for callers to read
