"""Distance-threshold edge selectors, dense API (counterpart of
gcm_tpu/edges/distance.py): score the current node num_nodes[b] against
every memory node, threshold, and wire an edge from each past node whose
score is below the threshold.

CosineEdge and SpatialEdge take their thresholded row from the
hand-written kernel's current-node entry `sddmm_threshold_row_current`
(ops/cuda/sddmm.py), which computes exactly their score and reads the
current node and the pose columns where they lie in `nodes`: on CUDA
tensors it launches, on CPU tensors its plain version runs, and both give
bitwise-equal rows. EuclideanEdge
stays in plain PyTorch: its score is the reference's batch-mean broadcast
(ops/distance.py::euclidean_score), not the per-batch distance the kernel
computes.

Dense selector API: selector(nodes, adj, weights, num_nodes, noise=None)
-> (adj, weights); these selectors draw no noise.
"""

from __future__ import annotations

import torch
from torch import nn

from gcm_tpu_torch.device import resolve_device
from gcm_tpu_torch.ops.cuda.sddmm import (current_node,
                                          sddmm_threshold_row_current)
from gcm_tpu_torch.ops.distance import euclidean_score
from gcm_tpu_torch.parallel import comm


class Distance(nn.Module):
    """Base: an edge where score(curr, node) < max_distance, from past
    nodes only (no self edge), optionally also the reverse edge
    (bidirectional). learned=True divides the node features by a learnable
    scale `dist_param` (initialised to max_distance) and fixes the
    threshold at 1.0. window restricts the sources to the last `window`
    nodes."""

    def __init__(self, max_distance: float, bidirectional: bool = False,
                 learned: bool = False, window: int | None = None, *,
                 device=None):
        super().__init__()
        self.max_distance = 1.0 if learned else max_distance
        self.init_distance = max_distance
        self.bidirectional = bidirectional
        self.learned = learned
        self.window = window
        self.dist_param = (nn.Parameter(torch.tensor(
            [float(max_distance)], device=resolve_device(device)))
            if learned else None)

    def edge_mask(self, nodes, num_nodes):  # pragma: no cover - abstract
        """[B, N] bool: score(curr, node_j) < max_distance and
        j < num_nodes[b], on the (scaled) nodes."""
        raise NotImplementedError

    def row_mask(self, nodes, num_nodes):
        """The sources of the edges into num_nodes[b], [B, N] bool."""
        if self.learned:
            nodes = nodes / self.dist_param
        mask = self.edge_mask(nodes, num_nodes)
        if self.window is not None:
            iota = torch.arange(nodes.shape[1], device=nodes.device)
            mask = mask & (iota[None, :] >= num_nodes[:, None] - self.window)
        return mask

    def forward(self, nodes, adj, weights, num_nodes, noise=None):
        del noise
        N = adj.shape[1]
        mask = self.row_mask(nodes, num_nodes)
        iota = torch.arange(N, device=adj.device)
        i = num_nodes[:, None, None]
        adj = torch.where((iota[None, :, None] == i) & mask[:, None, :], 1.0,
                          adj)
        if self.bidirectional:
            adj = torch.where((iota[None, None, :] == i) & mask[:, :, None],
                              1.0, adj)
        return adj, weights


class EuclideanEdge(Distance):
    """Euclidean distance with the reference's batch-mean broadcast
    (ops/distance.py::euclidean_score), in plain PyTorch: the kernel's
    per-batch distance is another function whenever B > 1.

    The mean runs over the whole batch. Under data parallelism a rank
    holds only its rows, and `batch_group` (a comm.GroupRef, bound by
    parallel/mesh.py::bind_batch; None in one process) names the ranks
    whose rows make up the batch: `batch_rows` all-gathers the current
    nodes over them. The cores that score with this selector (the dense,
    ring and banded cores) call it too."""

    def __init__(self, max_distance: float, learned: bool = False,
                 window: int | None = None, *, device=None):
        super().__init__(max_distance, learned=learned, window=window,
                         device=device)
        self.batch_group = None

    def batch_rows(self, curr):
        """curr [B, ...] with every rank's rows of the batch [d * B, ...]
        in rank order (curr itself in one process)."""
        if self.batch_group is None:
            return curr
        return comm.all_gather(curr, self.batch_group.group, 0)

    def edge_mask(self, nodes, num_nodes):
        past = torch.arange(nodes.shape[1], device=nodes.device)[None, :] \
            < num_nodes[:, None]
        curr = self.batch_rows(current_node(nodes, num_nodes))
        return (euclidean_score(curr, nodes) < self.max_distance) & past


class CosineEdge(Distance):
    """Cosine similarity (ops/distance.py::cosine_score) compared against
    the threshold; the row comes from the sddmm_threshold_row kernel in
    cosine mode, which reads the current node in place."""

    def __init__(self, max_distance: float, learned: bool = False,
                 window: int | None = None, *, device=None):
        super().__init__(max_distance, learned=learned, window=window,
                         device=device)

    def edge_mask(self, nodes, num_nodes):
        return sddmm_threshold_row_current(nodes, num_nodes,
                                           self.max_distance, "cosine")


class SpatialEdge(Distance):
    """Euclidean distance between the pose slices curr[a_pose_slice] and
    node[b_pose_slice] (ops/distance.py::spatial_score); the row comes from
    the sddmm_threshold_row kernel in euclidean mode, which reads both
    slices where they lie in the nodes."""

    def __init__(self, max_distance: float, a_pose_slice: slice,
                 b_pose_slice: slice | None = None, learned: bool = False,
                 window: int | None = None, *, device=None):
        super().__init__(max_distance, learned=learned, window=window,
                         device=device)
        self.a_pose_slice = a_pose_slice
        self.b_pose_slice = b_pose_slice or a_pose_slice

    def edge_mask(self, nodes, num_nodes):
        return sddmm_threshold_row_current(
            nodes, num_nodes, self.max_distance, "euclidean",
            cols=self.b_pose_slice, curr_cols=self.a_pose_slice)
