"""Pairwise-distance scoring ops (counterpart of gcm_tpu/ops/distance.py):
the scores of the distance edge selectors and the radius / kNN masks of
spatial graphs, in plain PyTorch. The thresholded row that CosineEdge and
SpatialEdge write is the hand-written kernel of ops/cuda/sddmm.py; these are
the scores themselves, as the JAX package computes them.
"""

from __future__ import annotations

import torch


def cdist(a: torch.Tensor, b: torch.Tensor, eps: float = 0.0):
    """Euclidean distance matrix |a_i - b_j|, a [..., P, F], b [..., R, F]
    -> [..., P, R], in the expanded quadratic form |a|^2 - 2 a.b + |b|^2
    (batch dims broadcast)."""
    a2 = torch.sum(a * a, dim=-1, keepdim=True)
    b2 = torch.sum(b * b, dim=-1, keepdim=True)
    ab = torch.matmul(a, b.transpose(-1, -2))
    sq = a2 - 2.0 * ab + b2.transpose(-1, -2)
    return torch.sqrt(torch.clamp_min(sq, eps))


def euclidean_score(curr: torch.Tensor, nodes: torch.Tensor):
    """EuclideanEdge's score, curr [B, F], nodes [B, N, F] -> [B, N], with
    the reference's broadcast: dist[b, n] = mean_j |curr[j] - nodes[b, n]|,
    the mean over every batch element's current node (the plain distance
    for B == 1)."""
    return cdist(curr[None, :, :], nodes).mean(dim=1)


def euclidean_score_per_step(curr: torch.Tensor, nodes: torch.Tensor):
    """`euclidean_score` at every step of a trajectory: curr [B, T, F]
    against nodes [B, T, N, F] (each step its own) or [B, N, F] (the same
    at every step) -> [B, T, N]. The mean runs over the batch's current
    nodes of the same step, as the JAX package's vmap over time takes it."""
    c = curr.transpose(0, 1)[:, None]  # [T, 1, B, F]
    n = nodes.transpose(0, 1) if nodes.dim() == 4 else nodes[None]
    return cdist(c, n).mean(dim=2).transpose(0, 1)


def cosine_score(curr: torch.Tensor, nodes: torch.Tensor, eps: float = 1e-8):
    """Cosine similarity with torch.nn.CosineSimilarity's eps clamp on the
    norms, curr [B, F], nodes [B, N, F] -> [B, N]."""
    na = torch.clamp_min(torch.linalg.vector_norm(curr, dim=-1, keepdim=True),
                         eps)
    nb = torch.clamp_min(torch.linalg.vector_norm(nodes, dim=-1), eps)
    dots = torch.einsum("bf,bnf->bn", curr, nodes)
    return dots / (na * nb)


def spatial_score(curr, nodes, a_slice: slice, b_slice: slice | None = None):
    """Euclidean distance between the pose slices curr[:, a_slice] and
    nodes[:, :, b_slice], -> [B, N]."""
    if b_slice is None:
        b_slice = a_slice
    return torch.linalg.vector_norm(
        curr[:, a_slice][:, None, :] - nodes[:, :, b_slice], dim=-1)


def pairwise_radius_mask(pos, valid, radius: float,
                         max_neighbors: int | None = None, loop: bool = True):
    """Radius-graph mask, pos [B, T, D], valid [B, T] -> [B, T, T]:
    mask[b, i, j] means node j lies within `radius` of node i (an edge
    j -> i). With max_neighbors, only the max_neighbors nearest per centre
    i are kept."""
    T = pos.shape[1]
    d = cdist(pos, pos)
    mask = (d <= radius) & valid[:, :, None] & valid[:, None, :]
    if not loop:
        mask = mask & ~torch.eye(T, dtype=torch.bool, device=pos.device)
    if max_neighbors is not None and max_neighbors < T:
        dm = torch.where(mask, d, torch.finfo(d.dtype).max)
        kth = torch.sort(dm, dim=-1).values[..., max_neighbors - 1:
                                            max_neighbors]
        mask = mask & (dm <= kth)
    return mask


def pairwise_knn_mask(pos, valid, k: int, loop: bool = False):
    """k-nearest-neighbour mask: mask[b, i, j] means j is one of i's k
    nearest valid nodes."""
    T = pos.shape[1]
    d = cdist(pos, pos)
    big = torch.finfo(d.dtype).max
    dm = torch.where(valid[:, :, None] & valid[:, None, :], d, big)
    if not loop:
        dm = torch.where(torch.eye(T, dtype=torch.bool, device=pos.device),
                         big, dm)
    kk = min(k, T)
    kth = torch.sort(dm, dim=-1).values[..., kk - 1:kk]
    return (dm <= kth) & (dm < big)
