"""Whole-GNN fused kernel: a stack of DenseGraphConv('add') layers with
their activations in one launch (counterpart of
gcm_tpu/ops/pallas/fused_gnn.py).

`fused_dense_gnn` launches the hand-written CUDA kernel
(csrc/dense_gnn.cu: 3xTF32 products on the tensor cores, within 1e-5 of
the float32 plain version) for CUDA tensors and takes the plain PyTorch
version, `fused_dense_gnn_plain`, only for CPU tensors. Forward only.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from gcm_tpu_torch.ops import _build
from gcm_tpu_torch.ops.cuda._launch import (
    ACT_CODES, apply_act, check_aligned16, check_cuda, check_forward_only,
    check_rc, check_sizes, ptr, stream_of)


def fused_dense_gnn_plain(x, adj, flat_params, acts):
    """L layers of h <- act((adj @ h) @ W_rel + b_rel + h @ W_root)."""
    h = x
    for layer, act in enumerate(acts):
        wr, br, wo = flat_params[3 * layer: 3 * layer + 3]
        agg = torch.bmm(adj, h)
        h = apply_act(agg @ wr + br + h @ wo, act)
    return h


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("dense_gnn")
    vp, ip = ctypes.c_void_p, ctypes.c_int
    lib.gcm_dense_gnn_scratch_floats.argtypes = [
        ctypes.POINTER(ip), ip, ip, ip]
    lib.gcm_dense_gnn_scratch_floats.restype = ctypes.c_longlong
    lib.gcm_fused_dense_gnn_f32.argtypes = [
        vp, vp, vp, vp, ctypes.POINTER(vp), ctypes.POINTER(vp),
        ctypes.POINTER(vp), ctypes.POINTER(ip), ctypes.POINTER(ip), ip, ip, ip,
        ip, vp]
    lib.gcm_fused_dense_gnn_f32.restype = ip
    lib.gcm_fused_dense_graph_conv_f32.argtypes = [
        vp, vp, vp, vp, vp, vp, ip, ip, ip, ip, ip, ip, vp]
    lib.gcm_fused_dense_graph_conv_f32.restype = ip
    return lib


def _launch(x, adj, flat_params, acts):
    n_layers = len(acts)
    if len(flat_params) != 3 * n_layers:
        raise ValueError(f"{len(flat_params)} params for {n_layers} layers; "
                         "expected (w_rel, b_rel, w_root) per layer")
    if x.dim() != 3:
        raise ValueError(f"x must be [B, N, F], got {tuple(x.shape)}")
    B, N, _ = x.shape
    widths = [x.shape[2]] + [flat_params[3 * i].shape[-1]
                             for i in range(n_layers)]
    check_sizes(B, N, widths)
    dev = x.device
    check_cuda("x", x, (B, N, widths[0]), dev)
    check_cuda("adj", adj, (B, N, N), dev)
    check_aligned16("adj", adj)
    for i in range(n_layers):
        wr, br, wo = flat_params[3 * i: 3 * i + 3]
        check_cuda(f"w_rel[{i}]", wr, (widths[i], widths[i + 1]), dev)
        check_cuda(f"b_rel[{i}]", br, (widths[i + 1],), dev)
        check_cuda(f"w_root[{i}]", wo, (widths[i], widths[i + 1]), dev)
    if any(a not in ACT_CODES for a in acts):
        raise ValueError(f"unsupported activations {acts}")

    lib = _lib()
    c_widths = (ctypes.c_int * (n_layers + 1))(*widths)
    n_scratch = lib.gcm_dense_gnn_scratch_floats(c_widths, n_layers, B, N)
    scratch = (torch.empty(n_scratch, device=dev, dtype=torch.float32)
               if n_scratch > 0 else None)
    out = torch.empty((B, N, widths[-1]), device=dev, dtype=torch.float32)

    def ptrs(k):
        return (ctypes.c_void_p * n_layers)(
            *[flat_params[3 * i + k].data_ptr() for i in range(n_layers)])

    rc = lib.gcm_fused_dense_gnn_f32(
        ptr(x), ptr(adj), ptr(out), ptr(scratch), ptrs(0), ptrs(1), ptrs(2),
        c_widths, (ctypes.c_int * n_layers)(*[ACT_CODES[a] for a in acts]),
        n_layers, B, N, dev.index, stream_of(dev))
    check_rc("fused_dense_gnn", rc)
    fused_dense_gnn.launches += 1
    return out


def fused_dense_gnn(x, adj, flat_params, acts):
    """x [B,N,F], adj [B,N,N], flat_params = (wr0, br0, wo0, wr1, ...) with
    W [F_in, F_out] and b [F_out], acts = tuple of None|'tanh'|'relu' per
    layer -> [B,N,F_out]. CUDA tensors launch the kernel (or raise); CPU
    tensors take the plain version."""
    flat_params = tuple(flat_params)
    acts = tuple(acts)
    check_forward_only(x, adj, *flat_params)
    if x.device.type == "cpu":
        return fused_dense_gnn_plain(x, adj, flat_params, acts)
    return _launch(x, adj, flat_params, acts)


fused_dense_gnn.launches = 0  # kernel launches, for callers to read and reset
