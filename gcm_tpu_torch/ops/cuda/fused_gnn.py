"""Whole-GNN fused kernel: a stack of DenseGraphConv('add') layers with
their activations in one launch (counterpart of
gcm_tpu/ops/pallas/fused_gnn.py).

`fused_dense_gnn` launches the hand-written CUDA kernel
(csrc/dense_gnn.cu: 3xTF32 products on the tensor cores, within 1e-5 of
the float32 plain version) for CUDA tensors and takes the plain PyTorch
version, `fused_dense_gnn_plain`, only for CPU tensors. Any graph size in
1..1,024 launches: one off the kernel's 16-row grid is padded with zero
rows and columns and the real rows sliced back out, exactly
(`_launch.py::pad_graph`), forward and backward.

Gradients flow to x, adj and every parameter. Where autograd tracks one of
them, the call goes through `_FusedDenseGnn`, whose backward is
`fused_dense_gnn_bwd`: the kernel of csrc/dense_gnn_bwd.cu for CUDA tensors
(it recomputes the layers' inputs, as the JAX package's backward replays
its forward under jax.vjp) and `fused_dense_gnn_bwd_plain`, JAX's formulas
written out, for CPU tensors. Untracked calls launch the forward directly.

The forward is also the torch.library op `gcm::fused_dense_gnn` (with a
fake for shapes), which a step exported by serve/export.py calls: the op
wraps the same launcher, with the plain version for CPU tensors by the same
device rule. Eager calls and the autograd Function reach the op only while
torch.export traces them (`_launch.py::exporting`), and otherwise call the
launcher directly, without the op's dispatch.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from gcm_tpu_torch.ops import _build
from gcm_tpu_torch.ops.cuda._launch import (
    ACT_CODES, ACT_NAMES, GRID, apply_act, check_aligned16, check_cuda,
    check_op_device, check_rc, check_sizes, exporting, grid_rows, needs_grad,
    pad_graph, ptr, refuse_export, stream_of, unpad_adj, unpad_rows)

NEED_X, NEED_ADJ, NEED_PARAMS = 1, 2, 4  # the backward's flags


def fused_dense_gnn_plain(x, adj, flat_params, acts):
    """L layers of h <- act((adj @ h) @ W_rel + b_rel + h @ W_root)."""
    h = x
    for layer, act in enumerate(acts):
        wr, br, wo = flat_params[3 * layer: 3 * layer + 3]
        agg = torch.bmm(adj, h)
        h = apply_act(agg @ wr + br + h @ wo, act)
    return h


def act_grad(out, act):
    """act'(z) from the activation's output: tanh 1 - out^2, relu out > 0
    (relu(z) > 0 exactly where z > 0), identity 1."""
    if act == "tanh":
        return 1.0 - out * out
    if act == "relu":
        return (out > 0).to(out.dtype)
    return torch.ones_like(out)


def fused_dense_gnn_bwd_plain(x, adj, flat_params, acts, g, need):
    """The stack's backward, JAX's formulas written out: the layers' inputs
    h and aggregates agg = adj h recomputed, then per layer in reverse
    gz = g * act'(z), dagg = gz W_rel^T, dh = adj^T dagg + gz W_root^T,
    dadj += dagg h^T, dW_rel = sum over b of agg^T gz, db_rel = sum gz,
    dW_root = sum over b of h^T gz. Returns (dx, dadj, dparams), each None
    unless its flag is in `need` (dparams in flat_params' order)."""
    hs, aggs = [x], []
    for layer, act in enumerate(acts):
        wr, br, wo = flat_params[3 * layer: 3 * layer + 3]
        aggs.append(torch.bmm(adj, hs[-1]))
        hs.append(apply_act(aggs[-1] @ wr + br + hs[-1] @ wo, act))
    dadj, dparams = None, [None] * len(flat_params)
    for layer in reversed(range(len(acts))):
        wr, _, wo = flat_params[3 * layer: 3 * layer + 3]
        h = hs[layer]
        gz = g * act_grad(hs[layer + 1], acts[layer])
        dagg = gz @ wr.T
        if need & NEED_PARAMS:
            gz2 = gz.reshape(-1, gz.shape[-1])
            dparams[3 * layer] = aggs[layer].reshape(-1, h.shape[-1]).T @ gz2
            dparams[3 * layer + 1] = gz2.sum(0)
            dparams[3 * layer + 2] = h.reshape(-1, h.shape[-1]).T @ gz2
        if need & NEED_ADJ:
            d = torch.bmm(dagg, h.transpose(1, 2))
            dadj = d if dadj is None else dadj + d
        if layer or need & NEED_X:
            g = torch.bmm(adj.transpose(1, 2), dagg) + gz @ wo.T
    return (g if need & NEED_X else None), dadj, (
        dparams if need & NEED_PARAMS else None)


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


def check_stack(x, adj, flat_params, acts) -> list[int]:
    """The checks of both stack kernels (forward and backward); returns the
    feature widths, input first."""
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
    return widths


def _launch(x, adj, flat_params, acts):
    """Any N in 1..1024: an N off the kernel's 16-row grid is padded with
    zero rows (and adjacency columns) and the real rows sliced back out,
    exactly (`pad_graph`)."""
    if x.dim() == 3 and x.shape[1] % GRID:
        N = x.shape[1]
        return unpad_rows(_launch(*pad_graph(x, adj), flat_params, acts), N)
    n_layers = len(acts)
    B, N, _ = x.shape
    widths = check_stack(x, adj, flat_params, acts)
    dev = x.device
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


def _run(x, adj, flat_params, acts):
    if x.device.type == "cpu":
        return fused_dense_gnn_plain(x, adj, flat_params, acts)
    return _launch(x, adj, flat_params, acts)


@torch.library.custom_op("gcm::fused_dense_gnn", mutates_args=())
def _op(x: torch.Tensor, adj: torch.Tensor, flat_params: list[torch.Tensor],
        act_codes: list[int]) -> torch.Tensor:
    out = _run(x, adj, flat_params, tuple(ACT_NAMES[c] for c in act_codes))
    return out.clone() if out is x else out  # an op's output is new


@_op.register_fake
def _op_fake(x, adj, flat_params, act_codes):
    width = flat_params[-1].shape[-1] if flat_params else x.shape[-1]
    return x.new_empty((x.shape[0], x.shape[1], width))


def _forward(x, adj, flat_params, acts):
    if any(a not in ACT_CODES for a in acts):
        raise ValueError(f"unsupported activations {acts}")
    check_op_device("fused_dense_gnn", x, adj, *flat_params)
    if exporting():
        return _op(x, adj, list(flat_params), [ACT_CODES[a] for a in acts])
    return _run(x, adj, flat_params, acts)


class _FusedDenseGnn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, adj, acts, *flat_params):
        ctx.acts = acts
        ctx.save_for_backward(x, adj, *flat_params)
        return _forward(x, adj, flat_params, acts)

    @staticmethod
    def backward(ctx, g):
        x, adj, *flat = ctx.saved_tensors
        need_in = ctx.needs_input_grad
        need = ((NEED_X if need_in[0] else 0)
                | (NEED_ADJ if need_in[1] else 0)
                | (NEED_PARAMS if any(need_in[3:]) else 0))
        dx, dadj, dparams = fused_dense_gnn_bwd(x, adj, flat, ctx.acts, g,
                                                need)
        return (dx, dadj, None, *(dparams or [None] * len(flat)))


def fused_dense_gnn(x, adj, flat_params, acts):
    """x [B,N,F], adj [B,N,N], flat_params = (wr0, br0, wo0, wr1, ...) with
    W [F_in, F_out] and b [F_out], acts = tuple of None|'tanh'|'relu' per
    layer -> [B,N,F_out]. Differentiable in x, adj and every parameter.
    CUDA tensors launch the kernel (or raise); CPU tensors take the plain
    version."""
    flat_params = tuple(flat_params)
    acts = tuple(acts)
    if needs_grad(x, adj, *flat_params):
        return _FusedDenseGnn.apply(x, adj, acts, *flat_params)
    return _forward(x, adj, flat_params, acts)


fused_dense_gnn.launches = 0  # kernel launches, for callers to read and reset


@functools.cache
def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("dense_gnn_bwd")
    vp, ip = ctypes.c_void_p, ctypes.c_int
    lib.gcm_dense_gnn_bwd_scratch_floats.argtypes = [
        ctypes.POINTER(ip), ip, ip, ip, ip, ip]
    lib.gcm_dense_gnn_bwd_scratch_floats.restype = ctypes.c_longlong
    lib.gcm_fused_dense_gnn_bwd_f32.argtypes = [
        vp, vp, vp, ctypes.POINTER(vp), ctypes.POINTER(vp),
        ctypes.POINTER(vp), ctypes.POINTER(ip), ctypes.POINTER(ip), ip, ip,
        ip, ip, vp, vp, vp, vp, ip, ip, vp]
    lib.gcm_fused_dense_gnn_bwd_f32.restype = ip
    lib.gcm_dense_gnn_bwd_plan.argtypes = [
        ctypes.POINTER(ip), ip, ip, ip, ip, ip, ctypes.POINTER(ip)]
    lib.gcm_dense_gnn_bwd_plan.restype = ip
    return lib


BWD_PLAN_KEYS = ("C", "R", "wn", "nt", "onchip", "adj_resident",
                 "w_resident", "gk", "smem", "resident_blocks")


_NO_PLAN = 9  # cudaErrorInvalidConfiguration


def fused_dense_gnn_bwd_plan(widths, B, N, device, cluster=0):
    """How the backward kernel splits a [B, N] batch of this stack on the
    CUDA `device`: the cluster size C (blocks a batch element), rows a
    block R, warps across a row tile's n-tiles wn and n-tiles a warp nt,
    whether the blocks' rows stay in shared memory (onchip, else a global
    scratch), whether the adjacency and the weights stay resident, the
    chunk rows gk, shared-memory bytes a block, and how many blocks the
    card holds at once in clusters of C (an N off the 16-row grid at its
    padded size, as the wrapper launches it). `cluster` (1, 2, 4, 8 or 16) asks
    for that C in place of the planner's choice (0); None where the shape
    has no plan at that C."""
    widths = [int(w) for w in widths]
    out = (ctypes.c_int * len(BWD_PLAN_KEYS))()
    rc = _bwd_lib().gcm_dense_gnn_bwd_plan(
        (ctypes.c_int * len(widths))(*widths), len(widths) - 1, B,
        grid_rows(N),
        cluster, torch.device(device).index or 0, out)
    if rc == _NO_PLAN and cluster:
        return None
    check_rc("fused_dense_gnn_bwd_plan", rc)
    return dict(zip(BWD_PLAN_KEYS, out))


def _launch_bwd(x, adj, flat_params, acts, g, need, cluster):
    if x.dim() == 3 and x.shape[1] % GRID:  # off the grid: padded, as forward
        N = x.shape[1]
        xp, adjp, gp = pad_graph(x, adj, g)
        dx, dadj, dparams = _launch_bwd(xp, adjp, flat_params, acts, gp,
                                        need, cluster)
        return unpad_rows(dx, N), unpad_adj(dadj, N), dparams
    n_layers = len(acts)
    B, N, _ = x.shape
    widths = check_stack(x, adj, flat_params, acts)
    dev = x.device
    check_cuda("g", g, (B, N, widths[-1]), dev)
    lib = _bwd_lib()
    c_widths = (ctypes.c_int * (n_layers + 1))(*widths)
    n_scratch = lib.gcm_dense_gnn_bwd_scratch_floats(c_widths, n_layers, B, N,
                                                     cluster, dev.index)
    scratch = torch.empty(n_scratch, device=dev, dtype=torch.float32)
    dx = (torch.empty_like(x) if need & NEED_X else None)
    dadj = (torch.empty_like(adj) if need & NEED_ADJ else None)
    dflat = (torch.empty(sum(p.numel() for p in flat_params), device=dev,
                         dtype=torch.float32)
             if need & NEED_PARAMS else None)

    def ptrs(k):
        return (ctypes.c_void_p * n_layers)(
            *[flat_params[3 * i + k].data_ptr() for i in range(n_layers)])

    rc = lib.gcm_fused_dense_gnn_bwd_f32(
        ptr(x), ptr(adj), ptr(g), ptrs(0), ptrs(1), ptrs(2), c_widths,
        (ctypes.c_int * n_layers)(*[ACT_CODES[a] for a in acts]), n_layers,
        B, N, need, ptr(dx), ptr(dadj), ptr(dflat), ptr(scratch), cluster,
        dev.index, stream_of(dev))
    check_rc("fused_dense_gnn_bwd", rc)
    fused_dense_gnn_bwd.launches += 1
    dparams = None
    if dflat is not None:
        dparams = [d.view(p.shape) for d, p in zip(
            dflat.split([p.numel() for p in flat_params]), flat_params)]
    return dx, dadj, dparams


def fused_dense_gnn_bwd(x, adj, flat_params, acts, g, need, cluster=0):
    """The stack's backward for the cotangent g [B,N,F_out]: (dx, dadj,
    dparams) as `fused_dense_gnn_bwd_plain` gives them, each only where its
    flag is in `need` (NEED_X, NEED_ADJ, NEED_PARAMS). CUDA tensors launch
    the kernel of csrc/dense_gnn_bwd.cu (or raise), in clusters of
    `cluster` blocks a batch element where it is not 0 (the planner's
    choice), as `fused_dense_gnn_bwd_plan` says; CPU tensors take the plain
    version."""
    refuse_export("fused_dense_gnn_bwd")
    flat_params, acts = tuple(flat_params), tuple(acts)
    g = g.contiguous()
    if x.device.type == "cpu":
        return fused_dense_gnn_bwd_plain(x, adj, flat_params, acts, g, need)
    return _launch_bwd(x, adj, flat_params, acts, g, need, cluster)


# calls of the C entry, for callers to read: each call launches the
# backward kernel and, where parameter gradients are asked for, the
# kernel that sums their partials, two kernels a call on a training step
fused_dense_gnn_bwd.launches = 0
