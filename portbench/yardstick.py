"""The benchmark's own counts of operations and bytes, and the card's peaks.

Every count is written from the shapes and the inputs, never from how a
kernel lays out or rounds its work: each useful product is counted once,
each input the work needs is read once and each output written once. A
backward is counted as twice its forward. Float32 throughout.
"""

from __future__ import annotations

import numpy as np

# NVIDIA H100 SXM data sheet, dense rates, at the card's full 700 W. TF32 is
# the highest rate at which any product of a float32 configuration can run,
# so no correct implementation reads above 100% of it.
PEAK_FLOPS = 495e12
PEAK_BYTES_PER_S = 3.35e12
F32 = 4
I32 = 4


def bound_s(ops: float, nbytes: float) -> tuple[float, str]:
    """The least time the card could take for the work, and which bound
    binds: 'ops' or 'bytes'."""
    t_ops, t_bytes = ops / PEAK_FLOPS, nbytes / PEAK_BYTES_PER_S
    return (t_ops, "ops") if t_ops >= t_bytes else (t_bytes, "bytes")


def conv_params(widths) -> int:
    """Parameters of a graph-conv stack: per layer W_rel, b_rel, W_root."""
    return sum(2 * fi * fo + fo for fi, fo in zip(widths[:-1], widths[1:]))


def linear_ops(rows: int, f_in: int, f_out: int) -> int:
    """x [rows, f_in] @ W [f_in, f_out]."""
    return 2 * rows * f_in * f_out


def dense_gnn_ops(B: int, N: int, widths) -> int:
    """The dense stack's forward over all N nodes of B graphs: per layer the
    aggregation adj @ h and the two projections, 2·B·(N²·f_in +
    2·N·f_in·f_out)."""
    return sum(2 * B * (N * N * fi + 2 * N * fi * fo)
               for fi, fo in zip(widths[:-1], widths[1:]))


def dense_gnn_bytes(B: int, N: int, widths) -> int:
    """The stack's forward: x [B,N,f0], adj [B,N,N] and the parameters
    read once, the output [B,N,f_last] written once."""
    return F32 * (B * N * widths[0] + B * N * N + conv_params(widths)
                  + B * N * widths[-1])


def dense_gnn_bwd_bytes(B: int, N: int, widths) -> int:
    """The stack's backward (no adjacency gradient): x, adj, the output's
    gradient and the parameters read once; dx and the parameter gradients
    written once."""
    p = conv_params(widths)
    return F32 * (B * N * widths[0] + B * N * N + B * N * widths[-1] + p
                  + B * N * widths[0] + p)


def temporal_edges(n: int, hops) -> int:
    """Edges that TemporalEdge / TemporalBackedge(hops) hold in a graph of
    the n newest nodes of one episode: node i links to i - h for h <= i."""
    return sum(max(n - h, 0) for h in hops)


def temporal_sources(n: int, hops) -> int:
    """Distinct source (and, by symmetry, sink) rows of those edges."""
    return max(n - min(hops), 0) if hops and n else 0


def temporal_totals(n, hops) -> tuple[int, int]:
    """(sum of temporal_edges, sum of temporal_sources) over graphs of n [B]
    nodes (a numpy array), in a few passes: the sum of max(n - h, 0) is
    sum(n) - B·h plus, for each k in 1..h, the graphs of fewer than k
    nodes."""
    total, B = int(n.sum()), n.size

    def past(h):
        return total - B * h + sum(int(np.count_nonzero(n < k))
                                   for k in range(1, h + 1))

    if not hops:
        return 0, 0
    return sum(past(h) for h in hops), past(min(hops))


def sparse_gnn_ops(B: int, N: int, edges: int, widths) -> int:
    """The sparse stack's forward over all N nodes of B graphs holding
    `edges` valid edges in all: per layer the aggregation (one multiply-add
    a feature an edge) and the two projections."""
    return sum(2 * edges * fi + 2 * B * 2 * N * fi * fo
               for fi, fo in zip(widths[:-1], widths[1:]))


def spmm_bytes(B: int, N: int, F: int, edges: int, rows_read: int) -> int:
    """One aggregation out[b, sink] += w·x[b, src] over `edges` valid edges:
    the `rows_read` source rows of x, each edge's sink, source and weight
    read once; the whole output [B,N,F] written once."""
    return F32 * rows_read * F + (2 * I32 + F32) * edges + F32 * B * N * F
