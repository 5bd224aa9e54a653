"""Dense (adjacency-matrix) graph convolutions (counterpart of
gcm_tpu/nn/dense_conv.py): DenseGraphConv and the DenseGNN stack.

`adj[b, i, j] != 0` means the message flows j -> i (sink-row convention).
A stack of DenseGraphConv('add') layers, each optionally followed by one
tanh or relu, runs as one fused kernel launch (ops/cuda/fused_gnn.py).
"""

from __future__ import annotations

import torch
from torch import nn

from gcm_tpu_torch.nn.module import Linear
from gcm_tpu_torch.ops.cuda.fused_gnn import fused_dense_gnn
from gcm_tpu_torch.ops.dispatch import dense_graph_conv

# activations the fused-stack planner recognises, by callable or module type
_ACT_FNS = {torch.tanh: "tanh", torch.relu: "relu"}
_ACT_MODULES = {nn.Tanh: "tanh", nn.ReLU: "relu"}


def _act_name(layer):
    """'tanh'/'relu' for a recognised activation, else None."""
    name = _ACT_MODULES.get(type(layer))
    if name is None and not isinstance(layer, nn.Module):
        name = _ACT_FNS.get(layer)
    return name


class DenseGraphConv(nn.Module):
    """out = lin_rel(aggr(adj, x)) + lin_root(x).

    aggr='add'  : adj @ x (the fused kernel on CUDA tensors)
    aggr='mean' : adj @ x / max(deg, 1)
    aggr='max'  : elementwise max over in-neighbours (0 where there are none)
    """

    def __init__(self, in_dim: int, out_dim: int, aggr: str = "add",
                 use_bias: bool = True, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        if aggr not in ("add", "mean", "max"):
            raise ValueError(f"unknown aggregation {aggr!r}")
        self.in_dim = in_dim
        self.out_dim = out_dim
        self.aggr = aggr
        self.lin_rel = Linear(in_dim, out_dim, use_bias=use_bias,
                              device=device, generator=generator)
        self.lin_root = Linear(in_dim, out_dim, use_bias=False,
                               device=device, generator=generator)

    def rel_bias(self) -> torch.Tensor:
        """lin_rel's bias, or zeros when it has none (what the kernels take)."""
        if self.lin_rel.bias is not None:
            return self.lin_rel.bias
        return torch.zeros(self.out_dim, dtype=self.lin_rel.kernel.dtype,
                           device=self.lin_rel.kernel.device)

    def forward(self, x, adj, mask=None):
        if self.aggr == "add":
            out = dense_graph_conv(x, adj.to(x.dtype), self.lin_rel.kernel,
                                   self.rel_bias(), self.lin_root.kernel)
        else:
            if self.aggr == "mean":
                agg = torch.bmm(adj, x)
                agg = agg / torch.clamp(adj.sum(-1, keepdim=True), min=1.0)
            else:
                neg = torch.finfo(x.dtype).min
                msgs = torch.where((adj != 0)[..., None], x[:, None, :, :],
                                   neg)
                agg = msgs.amax(dim=2)
                agg = torch.where(agg == neg, 0.0, agg)
            out = self.lin_rel(agg) + self.lin_root(x)
        if mask is not None:
            out = out * mask[..., None].to(out.dtype)
        return out


def plan_conv_stack(layers, allowed_aggrs=("add",)):
    """Detect a DenseGraphConv (+ optional tanh/relu) stack. Returns
    (conv_idx, acts, aggrs), one entry per conv, or None if any layer falls
    outside the pattern or uses an aggregation not allowed."""
    acts, conv_idx, aggrs = [], [], []
    i = 0
    while i < len(layers):
        layer = layers[i]
        if not (isinstance(layer, DenseGraphConv)
                and layer.aggr in allowed_aggrs):
            return None
        conv_idx.append(i)
        aggrs.append(layer.aggr)
        act = None
        if i + 1 < len(layers) and not isinstance(layers[i + 1],
                                                  DenseGraphConv):
            act = _act_name(layers[i + 1])
            if act is None:
                return None
            i += 1
        acts.append(act)
        i += 1
    if not conv_idx:
        return None
    return tuple(conv_idx), tuple(acts), tuple(aggrs)


class DenseGNN(nn.Module):
    """A stack of dense conv layers and activations with the DenseGCM
    signature gnn(x, adj, weights) -> x. DenseGraphConv layers receive
    (x, adj), every other layer (activations) receives x. With
    `use_weights`, adj is multiplied elementwise by the weight matrix
    first. `fuse` (any true value) runs a
    recognised DenseGraphConv('add') stack as one fused kernel; fuse=""
    runs the layers one by one."""

    def __init__(self, layers, use_weights: bool = False, fuse: str = "auto"):
        super().__init__()
        self.layers = list(layers)
        self.blocks = nn.ModuleList(
            [m for m in self.layers if isinstance(m, nn.Module)])
        self.use_weights = use_weights
        self.fuse = fuse
        plan = plan_conv_stack(self.layers) if fuse else None
        self._fused_plan = plan[:2] if plan is not None else None

    def forward(self, x, adj, weights=None):
        if self.use_weights and weights is not None and weights.numel() > 0:
            adj = adj * weights
        if self._fused_plan is not None:
            conv_idx, acts = self._fused_plan
            flat = []
            for ci in conv_idx:
                conv = self.layers[ci]
                flat += [conv.lin_rel.kernel, conv.rel_bias(),
                         conv.lin_root.kernel]
            return fused_dense_gnn(x, adj.to(x.dtype), flat, acts)
        for layer in self.layers:
            x = layer(x, adj) if isinstance(layer, DenseGraphConv) else layer(x)
        return x
