"""Sparse (padded-edge-list) graph convolutions (counterpart of
gcm_tpu/nn/sparse_conv.py): GraphConv, GCNConv and the SparseGNN stack.

Edge list convention: edges[b] = [[sink...], [source...]] with -1 in unused
lanes; a message flows source -> sink. The 'add' aggregations go through
`ops/dispatch.py::spmm`, which launches the spmm_edge_list kernel on CUDA
tensors, forward and backward.
"""

from __future__ import annotations

import torch
from torch import nn

from gcm_tpu_torch.device import resolve_device
from gcm_tpu_torch.nn.module import Linear
from gcm_tpu_torch.ops.dispatch import spmm
from gcm_tpu_torch.ops.scatter import (edge_mask, edge_scatter_count,
                                       edge_scatter_max,
                                       edge_weight_scatter_add)


class GraphConv(nn.Module):
    """out_i = lin_root(x_i) + lin_rel(aggr over j of w_ij x_j), as
    torch_geometric's GraphConv: edge weights scale the messages.

    aggr='add' : the weighted sum (spmm)
    aggr='mean': the weighted sum over the in-degree (at least 1)
    aggr='max' : elementwise max over in-neighbours (0 where there are none)
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

    def forward(self, x, edges, weights=None, agg_fn=None):
        """agg_fn: a precomputed aggregation x -> [B, N, F] (the slot
        layout's spmm_slots), shared by every layer; 'add' only."""
        N = x.shape[1]
        if agg_fn is not None:
            if self.aggr != "add":
                raise ValueError("agg_fn supports aggr='add' only")
            agg = agg_fn(x)
        elif self.aggr == "max":
            agg = edge_scatter_max(x, edges, num_nodes=N)
        else:
            if weights is None:
                weights = edge_mask(edges).to(x.dtype)
            agg = spmm(x, edges, weights)
            if self.aggr == "mean":
                deg = edge_scatter_count(edges, N)
                agg = agg / torch.clamp(deg, min=1.0)[..., None]
        return self.lin_rel(agg) + self.lin_root(x)


class GCNConv(nn.Module):
    """GCN layer over a padded edge list, as torch_geometric's GCNConv.

    With add_self_loops, every valid node (node_mask [B, N]) gets a self
    loop of weight 1 (2 when improved); norm = d_i^-1/2 w_ij d_j^-1/2 with
    degrees summed from the edge weights, self loops included. The degree
    sum uses scatter_add_, which on a CUDA tensor adds in no
    fixed order: there the result may differ in the last bit between runs.
    """

    def __init__(self, in_dim: int, out_dim: int, improved: bool = False,
                 add_self_loops: bool = True, use_bias: bool = True, *,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        self.in_dim = in_dim
        self.out_dim = out_dim
        self.improved = improved
        self.add_self_loops = add_self_loops
        self.lin = Linear(in_dim, out_dim, use_bias=False, init="glorot",
                          device=device, generator=generator)
        self.bias = (nn.Parameter(torch.zeros(out_dim,
                                              device=resolve_device(device)))
                     if use_bias else None)

    def forward(self, x, edges, weights=None, node_mask=None):
        B, N, _ = x.shape
        if weights is None:
            weights = edge_mask(edges).to(x.dtype)
        fill = 2.0 if self.improved else 1.0
        deg = edge_weight_scatter_add(edges, weights, N)
        if self.add_self_loops:
            loops = (torch.ones((B, N), dtype=deg.dtype, device=deg.device)
                     if node_mask is None else node_mask.to(deg.dtype))
            deg = deg + fill * loops
        dis = torch.where(deg > 0, torch.rsqrt(torch.clamp(deg, min=1e-12)),
                          0.0)
        sink = torch.clamp(edges[:, 0, :].long(), 0, N - 1)
        src = torch.clamp(edges[:, 1, :].long(), 0, N - 1)
        norm_w = (torch.gather(dis, 1, sink) * weights
                  * torch.gather(dis, 1, src))
        xw = self.lin(x)
        out = spmm(xw, edges, norm_w)
        if self.add_self_loops:
            self_norm = dis * fill * dis
            if node_mask is not None:
                self_norm = self_norm * node_mask.to(xw.dtype)
            out = out + xw * self_norm[..., None]
        if self.bias is not None:
            out = out + self.bias
        return out


_CONVS = (GraphConv, GCNConv)


class SparseGNN(nn.Module):
    """A stack of sparse conv layers and activations with the SparseGCM
    signature gnn(x [B,N,F], edges [B,2,E], weights [B,E]) -> x. Conv
    layers receive (x, edges, weights), every other layer receives x."""

    def __init__(self, layers):
        super().__init__()
        self.layers = list(layers)
        self.blocks = nn.ModuleList(
            [m for m in self.layers if isinstance(m, nn.Module)])

    def forward(self, x, edges, weights=None, agg_fn=None):
        for layer in self.layers:
            if isinstance(layer, _CONVS):
                if agg_fn is not None:
                    if not isinstance(layer, GraphConv):
                        raise ValueError(
                            "slot aggregation supports GraphConv stacks")
                    x = layer(x, edges, weights, agg_fn=agg_fn)
                else:
                    x = layer(x, edges, weights)
            else:
                x = layer(x)
        return x
