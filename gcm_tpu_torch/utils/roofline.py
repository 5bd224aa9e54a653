"""Analytic speed-of-light calculators for the standard GCM workloads
(counterpart of gcm_tpu/utils/roofline.py): the least time a call could
take at a shape, from the bytes it must move and the operations it must
do, the denominator of every "x of its bound" in PERF.md.

The chip constants default to the published figures of one NVIDIA H100
SXM (dense rates, no sparsity, at its 700 W limit): 3.35 TB/s of HBM3,
67 TFLOP/s float32 outside the tensor cores and 495 TFLOP/s TF32 on them.
chip_smoke.py's bounds read them here; every calculator takes `hbm_bw=`
and `flop_rate=` for another card (e.g. TF32_FLOPS_PER_S for the dense
kernels' 3xTF32 products, counted as three products).

Every function returns a dict with:
  hbm_bytes    - bytes moved per unit of work (the workload's natural unit)
  flops        - useful operations per unit
  hbm_floor_s  - time floor from bandwidth alone
  flop_floor_s - time floor from compute alone
  floor_s      - max of the two (the roofline)
  bound        - "hbm" | "flops"
plus workload-specific throughput fields. The byte and operation counts
are the JAX package's, so the dicts equal its dicts given its constants.
"""

from __future__ import annotations

# NVIDIA H100 SXM, published peaks
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
TF32_FLOPS_PER_S = 495e12


def _pack(hbm_bytes, flops, hbm_bw=HBM_BYTES_PER_S,
          flop_rate=F32_FLOPS_PER_S):
    hbm_floor = hbm_bytes / hbm_bw
    flop_floor = flops / flop_rate
    return {
        "hbm_bytes": hbm_bytes,
        "flops": flops,
        "hbm_floor_s": hbm_floor,
        "flop_floor_s": flop_floor,
        "floor_s": max(hbm_floor, flop_floor),
        "bound": "hbm" if hbm_floor >= flop_floor else "flops",
    }


def spmm(B, N, E, F, dtype_bytes=4, **chip):
    """Padded-edge-list SpMM per call: x + out node
    tensors + edges/weights; useful FLOPs 2·E·F per batch element."""
    hbm = (2 * B * N * F + 3 * B * E) * dtype_bytes  # x, out, (sink,src,w)
    flops = 2.0 * B * E * F
    out = _pack(hbm, flops, **chip)
    out["edges_per_s"] = B * E / out["floor_s"]
    return out


def dense_scan_step(B, N, F, dtype_bytes=4, **chip):
    """One DenseGCM scan step: the [B,N,N] adjacency
    + [B,N,F] nodes read through HBM each step (per-step writes touch one
    row/one adjacency row — negligible, the JAX package's convention);
    conv flops 2·B·N²·F."""
    hbm = (B * N * N + B * N * F) * dtype_bytes
    flops = 2.0 * B * N * N * F
    out = _pack(hbm, flops, **chip)
    out["timesteps_per_s"] = B / out["floor_s"]
    return out


def banded_scan_step(B, N, F, hops=1, dtype_bytes=4, **chip):
    """One BandedRingGCM step: adjacency implicit —
    only the [B,N,F] node read remains (the write is one row/step)."""
    hbm = B * N * F * dtype_bytes
    flops = 2.0 * B * N * F * (hops + 1)
    out = _pack(hbm, flops, **chip)
    out["timesteps_per_s"] = B / out["floor_s"]
    return out


def ring_window_train(B, N, F, chunk=None, n_bufs=6, dtype_bytes=4, **chip):
    """Ring-core scan-free window() TRAINING (models/ring_window.py): the
    kill-cumsum materializes ~4 [B, c, N+c, F] tensors per chunk in the
    forward and the backward re-reads/re-writes ~2 more (cumsum transpose +
    cotangents) — per-timestep HBM ≈ n_bufs · B·(N+c)·F bytes. A rough
    model (n_bufs is an estimate, not a count), but unlike borrowing the
    SCAN's [B,N,N] floor it has the right N-scaling: the window's whole
    point is that no [B,N,N] adjacency exists on this path."""
    c = min(N, chunk) if chunk else N
    M = N + c
    hbm = n_bufs * B * M * F * dtype_bytes
    flops = 2.0 * n_bufs * B * M * F  # elementwise-dominated
    out = _pack(hbm, flops, **chip)
    out["timesteps_per_s"] = B / out["floor_s"]
    return out


def nav_window(B, V, tau, F, pose_dim=3, layers=(19, 16), dtype_bytes=4,
               **chip):
    """One NavGCM causal window of B·tau timesteps: cdist write + per-layer [B,V,V] adjacency reads + node
    tensors; GNN flops 2·B·V²·F_in per layer."""
    adj = B * V * V * dtype_bytes
    nodes = 2 * B * V * (F + pose_dim) * dtype_bytes * len(layers)
    hbm = adj * (1 + len(layers)) + nodes
    flops = sum(2.0 * B * V * V * fin for fin in layers)
    out = _pack(hbm, flops, **chip)
    out["timesteps_per_s"] = B * tau / out["floor_s"]
    return out


def nav_incremental_window(B, V, tau, F, pose_dim=3, layers=(19, 16),
                           dtype_bytes=4, **chip):
    """NavGCMIncremental: only the tau new rows' geometry + conv rows are
    computed per window — the V/tau overhead factor removed."""
    adj_rows = B * tau * V * dtype_bytes
    nodes = (B * V * F + 2 * B * tau * F) * dtype_bytes * len(layers)
    hbm = adj_rows * (1 + len(layers)) + nodes
    flops = sum(2.0 * B * tau * V * fin for fin in layers)
    out = _pack(hbm, flops, **chip)
    out["timesteps_per_s"] = B * tau / out["floor_s"]
    return out
