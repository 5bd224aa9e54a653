"""Fused single dense graph-conv layer (counterpart of
gcm_tpu/ops/pallas/dense_gconv.py):

    out = (adj @ x) @ W_rel + b_rel + x @ W_root  [+ activation]

It shares its device code with the fused stack (csrc/dense_gnn.cu: 3xTF32
products on the tensor cores; the one-layer case, where the rows are split
over blocks of 32..128) but has its own C entry point and its own launch
count. A graph size off the 16-row grid is padded, as the stack's.

Differentiable in x, adj and the three parameters (JAX's
`ops/dispatch.py::dense_graph_conv`): a tracked call goes through
`_FusedDenseGraphConv`, whose backward is the stack's,
`fused_dense_gnn_bwd`, at one layer (csrc/dense_gnn_bwd.cu on the card).
"""

from __future__ import annotations

import torch

from gcm_tpu_torch.ops.cuda._launch import (
    ACT_CODES, GRID, check_aligned16, check_cuda, check_rc, check_sizes,
    needs_grad, pad_graph, ptr, stream_of, unpad_rows)
from gcm_tpu_torch.ops.cuda.fused_gnn import (NEED_ADJ, NEED_PARAMS, NEED_X,
                                              _lib, fused_dense_gnn_bwd,
                                              fused_dense_gnn_plain)


def fused_dense_graph_conv_plain(x, adj, w_rel, b_rel, w_root,
                                 activation=None):
    return fused_dense_gnn_plain(x, adj, (w_rel, b_rel, w_root), (activation,))


def _launch(x, adj, w_rel, b_rel, w_root, activation):
    if x.dim() != 3:
        raise ValueError(f"x must be [B, N, F], got {tuple(x.shape)}")
    if x.shape[1] % GRID:  # off the kernel's row grid: padded exactly
        N = x.shape[1]
        return unpad_rows(_launch(*pad_graph(x, adj), w_rel, b_rel, w_root,
                                  activation), N)
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


def _forward(x, adj, w_rel, b_rel, w_root, activation):
    if x.device.type == "cpu":
        return fused_dense_graph_conv_plain(x, adj, w_rel, b_rel, w_root,
                                            activation)
    return _launch(x, adj, w_rel, b_rel, w_root, activation)


class _FusedDenseGraphConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, adj, w_rel, b_rel, w_root, activation):
        ctx.activation = activation
        ctx.save_for_backward(x, adj, w_rel, b_rel, w_root)
        return _forward(x, adj, w_rel, b_rel, w_root, activation)

    @staticmethod
    def backward(ctx, g):
        x, adj, *params = ctx.saved_tensors
        need_in = ctx.needs_input_grad
        need = ((NEED_X if need_in[0] else 0)
                | (NEED_ADJ if need_in[1] else 0)
                | (NEED_PARAMS if any(need_in[2:5]) else 0))
        dx, dadj, dparams = fused_dense_gnn_bwd(
            x, adj, params, (ctx.activation,), g, need)
        return (dx, dadj, *(dparams or [None] * 3), None)


def fused_dense_graph_conv(x, adj, w_rel, b_rel, w_root, activation=None):
    """x [B,N,F], adj [B,N,N], w_rel/w_root [F,Fo], b_rel [Fo] -> [B,N,Fo].
    Differentiable in all five. CUDA tensors launch the kernel (or raise);
    CPU tensors take the plain version."""
    if needs_grad(x, adj, w_rel, b_rel, w_root):
        return _FusedDenseGraphConv.apply(x, adj, w_rel, b_rel, w_root,
                                          activation)
    return _forward(x, adj, w_rel, b_rel, w_root, activation)


fused_dense_graph_conv.launches = 0  # kernel launches, for callers to read
