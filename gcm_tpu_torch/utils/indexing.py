"""Ragged-batch index helpers, fixed-shape and padded (counterpart of
gcm_tpu/utils/indexing.py).

The reference builds ragged index tensors with Python loops (its
util.py index generators and NavGCM's compute_idx family); these return
padded index tensors and a validity mask instead, in the same
batch-major, time-ascending order. The cores use broadcast masks
directly: the helpers are for users and for parity tests.
"""

from __future__ import annotations

import torch


def _segment_fill(lengths: torch.Tensor, cap: int):
    """(b_idx, k_idx, mask), each [cap]: the pairs (b, 0..lengths[b] - 1)
    batch-major, padded with zeros (mask False) to `cap` entries."""
    B = lengths.shape[0]
    lengths = lengths.to(torch.int64)
    total = lengths.sum()
    starts = torch.cumsum(lengths, 0) - lengths
    pos = torch.arange(cap, device=lengths.device)
    b_idx = torch.clamp((pos[:, None] >= starts[None, :]).sum(-1) - 1,
                        0, B - 1)
    k_idx = pos - starts[b_idx]
    mask = pos < total
    zero = torch.zeros_like(pos)
    return (torch.where(mask, b_idx, zero).to(torch.int32),
            torch.where(mask, k_idx, zero).to(torch.int32), mask)


def get_nonpadded_idxs(T, taus, cap: int):
    """(b, 0..taus[b]) pairs: the valid positions of a zero-padded input
    window."""
    del T
    return _segment_fill(taus, cap)


def get_new_node_idxs(T, taus, cap: int):
    """(b, T[b]..T[b] + taus[b]) pairs: the rows just inserted."""
    b, k, m = _segment_fill(taus, cap)
    return b, torch.where(m, T[b.long()] + k, 0).to(torch.int32), m


def get_valid_node_idxs(T, taus, cap: int):
    """(b, 0..T[b] + taus[b]) pairs: every valid row."""
    return _segment_fill(T + taus, cap)


def get_batch_offsets(lengths):
    """(starts, ends) of each batch element's segment in the flattened
    node order."""
    ends = torch.cumsum(lengths, 0)
    return ends - lengths, ends


def make_flat_new_idx(T, taus, cap: int):
    """The new nodes' indices in the flattened valid-node order: for each
    b, [cum(T + taus)[b] - taus[b], cum(T + taus)[b])."""
    b, k, m = _segment_fill(taus, cap)
    bl = b.long()
    cs = torch.cumsum(T + taus, 0)
    return torch.where(m, cs[bl] - taus[bl] + k, 0).to(torch.int32), m


def make_output_idx(taus, cap: int):
    """(b, 0..taus[b]) positions in the padded output."""
    return _segment_fill(taus, cap)


def front_back_ptr(T, taus):
    """Each graph's first and last node in the flattened order."""
    back = torch.cumsum(T + taus, 0) - 1
    front = torch.cat([torch.zeros((1,), dtype=back.dtype,
                                   device=back.device), back[:-1] + 1])
    return front, back


def causal_pair_mask(T, taus, t: int, N: int, window: int | None = None):
    """cand [B, t, N]: sink T[b] + i (i < taus[b]) receives from source
    j < sink, optionally windowed to j >= T[b] - window."""
    i = torch.arange(t, device=T.device)[None, :]
    j = torch.arange(N, device=T.device)[None, None, :]
    sink = T[:, None] + i
    cand = (i < taus[:, None])[..., None] \
        & (j < torch.clamp(sink, 0, N)[..., None])
    if window is not None:
        cand = cand & (j >= torch.clamp(T[:, None, None] - window, min=0))
    return cand
