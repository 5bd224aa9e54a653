"""Drive the PyTorch port (gcm_tpu_torch) on one CUDA card and check it.

    python3 chip_smoke.py

Phases, one JSON line each:
1. device: requires CUDA; prints the card's name and power limit;
2. build: builds every kernel from gcm_tpu_torch/csrc with nvcc (sm_90a);
3. kernels: each kernel against its plain PyTorch version on the card
   (max abs error, tolerance 1e-5: the summation order differs, and the
   dense kernels' products are 3xTF32 on the tensor cores), with
   the device time per call and the time per call with the host's launch
   gaps (both from CUDA events) of the kernel, the plain version and a
   torch bmm/addmm chain of the same function (TF32 off), the dense
   kernels at cases that reach every instantiation of csrc/dense_gnn.cu,
   and an empty kernel by the same harness (the floor under small calls);
   then inputs the kernels do not take (misaligned, a graph size above
   1,024, float64) must raise, unlaunched;
4. serve: the flagship DenseGCM in a SessionServer(capacity=256) for 200
   ticks with session churn and LRU evictions, against a CPU copy with the
   same weights (atol 1e-4), with a snapshot/restore at tick 100 that must
   continue bitwise, and one fused_dense_gnn launch per tick;
5. scan: DenseGCM.scan over [32, 256, 8] against the CPU copy (atol 1e-4),
   and the same model with DenseGNN(fuse="") through
   fused_dense_graph_conv;
6. sparse: the README's SparseGCM (readme_sparse_gcm) over [32, 128, 8] in
   four chained windows of 32, a window with ragged taus, the same weights
   in the dense README model (the dense == sparse contract), the same model
   with aggregation="slots", and SparseGCM.scan over [32, 64, 8] with dones,
   each against a CPU copy loaded from the same numpy weights (atol 1e-4;
   edge lists, t and num_edges exactly equal), with exact launch counts of
   spmm_edge_list and spmm_slots;
7. selectors: the README DenseGCM with CosineEdge(0.5) and SpatialEdge(0.25)
   (scored by sddmm_threshold_row) served 100 ticks at capacity 256 and
   scanned over [32, 256, 8], against a CPU copy (adjacency exactly equal,
   beliefs within 1e-4, one sddmm launch per step), with a bitwise
   snapshot/restore; DenseEdge and LearnedEdge(deterministic) scanned over
   [32, 64, 8] the same way; EuclideanEdge(1.0) and the recall chain
   teacher-forced for 64 steps
   (their cdist rounds differently on the two devices: an edge may differ
   only where the float64 score lies within 1e-5 of the threshold); then,
   timed alone and in turns with the README's temporal selector, 100
   served ticks with a profiled window each (kernels and device µs per
   tick of the three) and two rounds of scans.
8. sweep: the SpMM variant sweep (gcm_tpu_torch/benchmarks/spmm_variants.py)
   as its script runs it: the gather probe through take_rows, take_lanes
   and take_rows_loop (each "ok"), then its 15 rows at full width, B=64,
   N=512, E=8192, F=128, every row checked against the plain scatter (1e-3;
   0.5 for bf16) and timed in edges/s, through spmm_edge_list,
   spmm_onehot_dtype, spmm_win, spmm_pairs, spmm_seg and spmm_prefetch,
   with no row of the JAX script left out;
9. gradients: spmm_pairs and spmm_seg forward and backward at the sweep's
   point against autograd through their plain versions (dx and dw within
   1e-4), their dw through edge_weight_grad, exact launch counts;
10. train: both README cores trained through make_dense_supervised_step
   (B=32, T=160 on a 128-node graph, so the ring wraps: fused_dense_gnn
   forward and fused_dense_gnn_bwd backward each step) and
   make_sparse_supervised_step (one window of [32, 128, 8], default and
   aggregation="slots": spmm_edge_list or spmm_slots forward,
   spmm_edge_list for dx backward), three Adam steps each against a CPU
   copy (loss and every gradient within 1e-4), exact launches per forward
   + backward, a finite loss that falls, µs per step and a profiled step;
   and the learned sparse core (the README sparse core with a
   deterministic sparse LearnedEdge, 3 edge samples), default and slots
   (slot_k 3), whose edge weights carry the gradient: each layer's backward
   also launches edge_weight_grad;
11. options: the cores' remaining options against CPU copies (beliefs
   within 1e-4; edge lists, t and num_edges exactly equal):
   benchmarks/profile_sparse.py's learned core (B=8, F=32, graph 256,
   2,048 edge slots, max_hops 2, LearnedEdge(window=32, 3 samples)) over
   T=256 in windows of 32 on the emit path, the grid path (the same edges)
   and slots (spmm_slots), with the smallest |soft - 1/(1+S)| seen; the
   README sparse core over [32, 128, 8] with SpatialRadiusEdge(0:2, 0.25),
   SpatialKNNEdge(0:2, k=4), a SparseEdgeChain, a PositionalEncoding under
   dones, an aux selector, hop_cap="auto" (the masked path) and the
   stochastic learned selector (noise handed to both copies; a CUDA
   Generator bitwise repeatable per seed); a pooled README DenseGCM
   (validate=True) scanned over [32, 256, 8]; a DenseGCNConv stack at
   README widths scanned over [32, 64, 8];
12. gates: the two dispatch choices the JAX package gates on TPU
   measurements, timed on the card (time_ms: call and device ms, median of
   5 rounds): the learned selector's emit path against its grid path at
   benchmarks/gate_hygiene.py's point for N = 128..1,024, and hop_cap
   compaction against the masked path at benchmarks/hop_compact.py's
   workload for N = 256..4,096 at F = 128 and 32, each pair with the same
   beliefs;
13. ring: the ring core (RingDenseGCM) at the README widths over
   [32, 256, 8] with TemporalBackedge([1]), CosineEdge(0.5) and a
   deterministic LearnedEdge, against the port's DenseGCM with the same
   modules (1e-5; 1e-4 for the cosine graph's ~85 in-edges a row) and a
   CPU copy (1e-4), then the ring and dense cores served at capacity 256
   in turns (µs, kernels and device µs a tick);
14. rl: A2C and PPO on the card (gcm_tpu_torch/rl): CartPole with masked
   velocities (horizon 64, reward scale 0.05, B=64) under the ring
   GCMActorCritic (graph 16, hops [1, 2], widths 64): one update's loss
   and gradients against a CPU copy (1e-4), 5 A2C and 2 PPO updates timed
   and profiled, the replay's remat timed in turns; the recall task at
   graph size 5 (off the 16-row grid), which must learn as the JAX
   package's test demands; one sparse-policy update against a CPU copy;
   the trained policy served by SessionServer.from_policy against a CPU
   copy (1e-4);
15. host: the host-stepped path (rl/external.py) at the JAX package's
   examples/train_external_env.py sizes, SparseGCMActorCritic (gnn 32,
   TemporalEdge([1]), graph T_max + 1, previous actions) on the native
   CartPole pool (16 envs, horizon 24) and a host T-maze pool (16 envs):
   greedy collection equal to a CPU copy's (buffer samples bitwise), one
   update's loss and gradients against the CPU copy (1e-5), launches a
   tick and an update, collect ticks/s, env steps/s and update ms over a
   few updates, and the update loop fed inline and through
   prefetch_to_device (data/prefetch.py), ms per update each way;
16. nav: NavActorCritic at examples/train_nav.py's sizes (16
   PointGoalNav envs, horizon 24, max_verts 26, hidden 32, k 8, r 2.5):
   collect through NavGCMIncremental == replay through NavGCM (1e-5), the
   replay's loss and gradients against a CPU copy (1e-4; the adjacency
   equal but for entries within 1e-5 of their cut, then teacher-forced),
   fused_dense_graph_conv 2 a replay forward and none a collect tick,
   fused_dense_gnn_bwd 2 calls an update, the nav gate (both cores' tau = 1
   tick and whole window at B = 16, V = 32..1,024: the rule for
   models/nav_gcm.py::NAV_INCREMENTAL_MIN_V) and 30 updates of training
   with their early and late collect returns;
17. fast: the scan-free fast cores at the JAX package's benchmark widths
   (obs 8, a Linear(8, 32) preprocessor, 2 x DenseGraphConv(32, 32) +
   tanh): BandedRingGCM (hops (1,), N = 128) scanned over [32, 256, 8]
   against chained windows of 128; BandedScoredGCM with EuclideanEdge(1.0,
   window=32) the same; CliqueGCM (N = 512) over [32, 128, 8] against
   chained windows of 64 in both impls; RingDenseGCM(EuclideanEdge(1.0))
   at N = 1,024 over [32, 320, 8], window against scan. Each window within
   1e-5 of its scan (the banded and clique final states exact), each core
   within 1e-5 of the port's DenseGCM / RingDenseGCM with the equivalent
   selector, and within 1e-4 of a CPU copy. The clique and the ring sum
   hundreds of terms to ~50 in their first layer, so they are held instead
   to FAST_SUM_TOL, each float32 path also against a float64 witness, with
   TF32 products as the control the limit must catch. A Euclidean edge may
   differ between two sides only within 1e-5 of its threshold (float64),
   and the beliefs are then held teacher-forced on one side's edge rows. Three
   Adam steps through make_window_supervised_step (CliqueGCM with
   impl="proj") and, for the ring, make_trajectory_supervised_step (the
   branch its training gate picks), against a CPU copy (1e-4); one
   profiled window and training step a core; each gate's window against
   scan in turns (timesteps/s); the launches of rows 1, 5 and A of each
   part.
Phase 3 also holds spmm_edge_list and spmm_slots (bitwise: kernel and
plain version add in the same order; slots also with sources outside their
windows) against their plain versions beside one torch.sparse.mm call on a
block-diagonal COO matrix of the same edges, sddmm_threshold_row bitwise
against its plain version beside a gather + bmm + norms + compare chain,
through both entries (curr given, and the current node and pose columns
read in place from the nodes, as the selectors call it: the served cosine
and spatial rows, different slices for the two, F = 5 at an unaligned
offset and F = 128), and the variant kernels spmm_pairs (f32x2, bf16),
spmm_seg, spmm_prefetch, spmm_onehot_dtype and spmm_win (f32, bf16)
bitwise against theirs (which add in the kernels' order) at the sweep's
point, at odd shapes with sentinels and out-of-range indices (spmm_win on
raw lanes whose sinks leave their windows), a segment spanning two chunks,
benchmarks/drive_r5c.py's shape and empty edge lists, and, for the
sink-sorted kernels (csrc/sink_sort.cuh: spmm_edge_list, spmm_onehot_dtype,
spmm_win, spmm_prefetch), a hot row over two sort passes, sinks descending
in lane order, eight passes, 4,100 rows in row tiles, a plan of exactly
48 KB of dynamic shared memory and one sink block of 905 or 4,100 rows,
beside the same
torch.sparse.mm; the gathers take_rows, take_lanes and take_rows_loop bit
for bit against theirs (NaN where NaN) at the probe's shapes, at the
sweep's message gather ([32768, 128] by 524,288 indices; lanes [32768,
512] by [32768, 128]), with indices past either end and, for
take_rows_loop, at 65,536 rows, beside index_select / torch.gather; it
checks every kernel's refusals. It holds the stack backward
fused_dense_gnn_bwd (csrc/dense_gnn_bwd.cu; no register spills in its
build log) against its plain version, JAX's formulas (dx, dadj where asked
for, every parameter's gradient, each within 1e-5 of its largest
magnitude, at least 1), at the dense scan's training shape, the served
batch, a learned adjacency, each activation, one layer, the adjacency
streamed in chunks (N = 512, 1,024), one element in a cluster of 16, a
single 16-row tile, four layers (widths 128, 8, 1, 24, 128), B = 300 and
rows that fit in shared memory at no cluster size (global scratch), each
with the kernel's plan (blocks an element, rows a block, what stays in
shared memory; every route the planner takes runs in some case), and at
every other cluster size the shape allows, checked and timed beside the
plan's, beside autograd's backward through the bmm + addmm chain; and edge_weight_grad (csrc/edge_grad.cu;
no register spills in its build) bitwise against its plain version at the
sweep's point (the raw list, its pair and segment buckets as the gradient
phase hands them, every lane into one sink), two sink tiles an element,
the sparse path's window, indices of N or more (F = 13 and 45), F = 260,
no valid lane and rows of 16,387 floats, on the planner's plan and on
other plans forced through its tile_bytes and splits (each a different
plan: the other route on either side of its warp-a-lane threshold, other
tiles and splits at the sweep's point), beside one
torch.sparse.sampled_addmm. The dense kernels and the stack backward also
run at graph sizes off their 16-row grid (N = 5, 65, 100), which the
wrappers pad and slice, each against its plain version at the unpadded N.
Phases 4-17 each run with every launch count set to 0 just before and
read just after; each must launch the kernels of its path.
Then the kernels line and, last, {"ok": true, "device": {...}}. Any failed
check raises, so the script exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import functools
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

TOL_KERNEL = 1e-5
TOL_MODEL = 1e-4
PEAK_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
PEAK_F32_FLOP_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
PEAK_TF32_FLOP_PER_S = 495e12  # H100 SXM dense TF32 on the tensor cores


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def device_events(prof):
    """(name, self device µs, count) of the device-side events of a profile:
    an aten op's own entry would repeat the time of the kernels it
    launched."""
    from torch.autograd import DeviceType

    return [(e.key[:80], e.self_device_time_total, e.count)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]


def time_ms(fn, reps: int = 20, rounds: int = 5,
            warmup: int = 5) -> tuple[float, float]:
    """(device_ms, call_ms) of one call of fn: the median over rounds of
    CUDA events around reps back-to-back calls, over reps. device_ms: a spin
    kernel first holds the stream until the host has enqueued every call
    behind it, so the events bracket the calls' kernels with no idle gaps
    between them. A function of hundreds of launches fills the launch queue
    before the spin ends; then fewer calls are queued per round (halved, down
    to one). call_ms: the same without the spin; where the host enqueues
    slower than the device runs, it holds the device's idle gaps too."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def run(spin_cycles: int, n: int) -> tuple[float, bool]:
        if spin_cycles:
            torch.cuda._sleep(spin_cycles)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        ahead = not start.query()  # all enqueued before the first call ran
        torch.cuda.synchronize()
        return start.elapsed_time(end) / n, ahead

    calls = [run(0, reps)[0] for _ in range(rounds)]
    spin, n = 4_000_000, reps  # ~2 ms at the H100's clock
    devices = []
    while len(devices) < rounds:
        device, ahead = run(spin, n)
        if ahead:
            devices.append(device)
        elif n > 1:
            n = max(1, n // 2)
        elif spin < 4_000_000 * 4 ** 5:
            spin *= 4
        else:
            raise RuntimeError("the host never got ahead of the device: no "
                               "device time measured")
    return statistics.median(devices), statistics.median(calls)


# -- phase 3: kernels against their plain versions ---------------------------

def make_case(B, N, widths, seed, inputs="0/1"):
    """x, adj and flat params on the card. adj is random 0/1 with eight
    in-edges per row on average and every eighth row empty; with inputs
    "weighted" that mask times uniform (0, 1) edge weights, as DenseGNN
    builds it with edge weights (the TF32 split of a 0/1 adj has no low
    half); with "x*8" x is scaled by 8, so that the split of h carries
    larger magnitudes."""
    g = torch.Generator().manual_seed(seed)
    x = torch.rand((B, N, widths[0]), generator=g) * 2 - 1
    adj = (torch.rand((B, N, N), generator=g) < 8 / N).float()
    adj[:, ::8, :] = 0.0
    if inputs == "weighted":
        adj *= torch.rand((B, N, N), generator=g)
    elif inputs == "x*8":
        x *= 8
    flat = []
    for fin, fout in zip(widths[:-1], widths[1:]):
        bound = fin ** -0.5
        for shape in ((fin, fout), (fout,), (fin, fout)):
            flat.append((torch.rand(shape, generator=g) * 2 - 1) * bound)
    return [t.cuda() for t in (x, adj, *flat)]


def library_gnn(x, adj, wcats, biases, acts):
    """The same function as torch library calls: per layer one bmm and one
    addmm over [adj@h, h] @ [W_rel; W_root]."""
    from gcm_tpu_torch.ops.cuda._launch import apply_act

    h = x
    B, N, _ = x.shape
    for wcat, b, act in zip(wcats, biases, acts):
        cat = torch.cat([torch.bmm(adj, h), h], dim=-1).reshape(B * N, -1)
        h = apply_act(torch.addmm(b, cat, wcat).reshape(B, N, -1), act)
    return h


def bound_ms(nbytes, flops, peak=PEAK_F32_FLOP_PER_S):
    """Least time on an H100 SXM for a function that must move nbytes (each
    input read once, each output written once) and do flops operations at
    the rate peak (f32 outside the tensor cores by default): (ms, what
    bounds it)."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def lane_bytes(sinks):
    """The bytes of an edge layout's int32 sink, int32 source and f32
    weight lanes that a function must read: every lane's sink, and the
    source and weight of each lane that is not padding (sink >= 0)."""
    return 4 * sinks.numel() + 8 * int((sinks >= 0).sum())


def dense_bound_ms(B, N, widths):
    """The dense stack's products on the tensor cores, three TF32 products
    for each f32-accurate one (3xTF32, which holds TOL_KERNEL), or its
    bytes."""
    flops = sum(2 * B * (N * N * fi + 2 * N * fi * fo)
                for fi, fo in zip(widths[:-1], widths[1:]))
    params = sum(2 * fi * fo + fo for fi, fo in zip(widths[:-1], widths[1:]))
    nbytes = 4 * (B * N * widths[0] + B * N * N + params + B * N * widths[-1])
    return bound_ms(nbytes, 3 * flops, PEAK_TF32_FLOP_PER_S)


def max_abs_err(got, want, nan_fills=False) -> float:
    """Max abs difference. With nan_fills, a NaN of both at one place counts
    as 0 (NaN against a number stays NaN, which no tolerance admits)."""
    diff = (got.float() - want.float()).abs()
    if nan_fills:
        diff = torch.where(got.isnan() & want.isnan(), 0.0, diff)
    return float(diff.max())


def bitwise_equal(a, b) -> bool:
    """Equal bit for bit (a NaN equal to the same NaN)."""
    if a.is_floating_point() and a.dtype == b.dtype:
        a, b = a.view(torch.uint8), b.view(torch.uint8)
    return torch.equal(a, b)


def flat(out):
    """A function's output as one tensor: a tuple of tensors (a backward's
    gradients) flattened and joined in order."""
    if isinstance(out, (tuple, list)):
        return torch.cat([t.float().reshape(-1) for t in out])
    return out


def kernel_row(name, shape, main_path, kernel, plain, library, bound,
               tol=TOL_KERNEL, nan_fills=False, err_scale=None, library_as=None):
    """Checks a kernel against its plain version (within tol, two launches
    bitwise equal) and times the kernel, the plain version and the library
    call; emits and returns the row. Boolean outputs compare as 0/1; a
    tuple of outputs (gradients) compares as one flattened tensor. The
    kernel's output must be finite, unless nan_fills (the gathers' fills
    past the end): then it must be NaN exactly where the plain version's
    is. A "hot row" case's plain version is checked but not timed (its one
    row makes it thousands of launches a call; plain_ms is None). With
    err_scale (a tensor of want's flattened shape), the check holds
    |got - want| / err_scale within tol. library_as maps the library call's
    output onto the kernel's, for its error (outside its timing)."""
    got = flat(kernel())
    torch.cuda.synchronize()
    want = flat(plain())
    err = max_abs_err(got, want, nan_fills)
    scaled = (err if err_scale is None
              else float(((got - want).abs() / err_scale).max()))
    again = flat(kernel())
    torch.cuda.synchronize()
    lib_out = flat(library())
    if library_as is not None:
        lib_out = library_as(lib_out)
    lib_err = max_abs_err(lib_out, want, nan_fills)
    ms, call_ms = time_ms(kernel)
    plain_ms, plain_call_ms = (time_ms(plain) if shape.get("case") != "hot row"
                               else (None, None))
    library_ms, library_call_ms = time_ms(library)
    row = dict(kernel=name, **shape, main_path=main_path, max_abs_err=err,
               **({} if err_scale is None else {"max_scaled_err": scaled}),
               bitwise_repeatable=bitwise_equal(got, again),
               ms=ms, plain_ms=plain_ms, library_ms=library_ms,
               x_bound=ms / bound[0],
               call_ms=call_ms, plain_call_ms=plain_call_ms,
               library_call_ms=library_call_ms,
               library_max_abs_err=lib_err, bound_ms=bound[0],
               bound_by=bound[1])
    emit("kernel", **row)
    if nan_fills:
        check(torch.equal(got.isnan(), want.isnan()),
              f"{name} {shape}: NaN off the plain version's places")
    else:
        check(bool(torch.isfinite(got).all()), f"{name} {shape}: non-finite")
    kind = "abs" if err_scale is None else "scaled"
    check(scaled <= tol, f"{name} {shape}: max {kind} err {scaled} > {tol}")
    check(row["bitwise_repeatable"], f"{name} {shape}: two launches differ")
    return row


def kernel_case(name, B, N, widths, acts, inputs, seed, main_path):
    from gcm_tpu_torch.ops.cuda.dense_gconv import (
        fused_dense_graph_conv, fused_dense_graph_conv_plain)
    from gcm_tpu_torch.ops.cuda.fused_gnn import (fused_dense_gnn,
                                                  fused_dense_gnn_plain)

    x, adj, *flat = make_case(B, N, widths, seed, inputs)
    if name == "fused_dense_gnn":
        def kernel():
            return fused_dense_gnn(x, adj, flat, acts)

        def plain():
            return fused_dense_gnn_plain(x, adj, flat, acts)
    else:
        def kernel():
            return fused_dense_graph_conv(x, adj, *flat, activation=acts[0])

        def plain():
            return fused_dense_graph_conv_plain(x, adj, *flat,
                                                activation=acts[0])
    wcats = [torch.cat([flat[3 * i], flat[3 * i + 2]], 0)
             for i in range(len(acts))]
    biases = [flat[3 * i + 1] for i in range(len(acts))]
    return kernel_row(
        name, dict(B=B, N=N, widths=list(widths), acts=list(acts),
                   inputs=inputs),
        main_path, kernel, plain,
        library=lambda: library_gnn(x, adj, wcats, biases, acts),
        bound=dense_bound_ms(B, N, widths))


KERNEL_CASES = [
    # (name, B, N, widths, acts, inputs (make_case), main_path)
    ("fused_dense_gnn", 256, 128, (32, 32, 32), ("tanh", "tanh"), "0/1",
     True),
    ("fused_dense_gnn", 32, 512, (32, 32, 32), ("tanh", "tanh"), "0/1",
     False),
    ("fused_dense_gnn", 8, 512, (128, 128, 128), ("relu", "tanh"), "0/1",
     False),
    ("fused_dense_gnn", 16, 128, (8, 32, 64, 16), (None, "relu", "tanh"),
     "0/1", False),
    ("fused_dense_graph_conv", 32, 128, (32, 32), (None,), "0/1", True),
    ("fused_dense_graph_conv", 256, 128, (32, 32), (None,), "0/1", False),
    ("fused_dense_graph_conv", 256, 128, (32, 32), ("tanh",), "0/1", False),
    ("fused_dense_graph_conv", 256, 128, (32, 32), ("relu",), "0/1", False),
    # widths that are not multiples of 8 (the MMA tiles' padding)
    ("fused_dense_gnn", 16, 128, (8, 30, 17), ("tanh", None), "0/1", False),
    ("fused_dense_graph_conv", 16, 128, (13, 30), ("relu",), "0/1", False),
    # the low half of the TF32 split: a weighted adjacency, a larger x (its
    # outputs through tanh: unbounded outputs of ~40 differ by more than
    # 1e-5 from f32 rounding alone)
    ("fused_dense_gnn", 256, 128, (32, 32, 32), ("tanh", "tanh"), "weighted",
     False),
    ("fused_dense_graph_conv", 32, 128, (32, 32), (None,), "weighted", False),
    ("fused_dense_gnn", 256, 128, (32, 32, 32), ("tanh", "tanh"), "x*8",
     False),
    # the plans and instantiations of csrc/dense_gnn.cu the cases above
    # leave out: h as quads over two passes, the adjacency streamed through
    # two chunk buffers; split single-layer blocks at 2 and 4 n-tiles a
    # warp, the latter also streamed with x read from device memory; quads
    # at 16 n-tiles with x loaded a float at a time; h in global memory at
    # 8 n-tiles
    ("fused_dense_gnn", 32, 256, (32, 32, 32), ("tanh", "tanh"), "weighted",
     False),
    ("fused_dense_graph_conv", 32, 128, (64, 64), ("tanh",), "0/1", False),
    ("fused_dense_graph_conv", 32, 128, (128, 128), ("relu",), "0/1", False),
    ("fused_dense_graph_conv", 4, 1024, (128, 128), ("tanh",), "weighted",
     False),
    ("fused_dense_gnn", 16, 64, (7, 96, 9), ("tanh", None), "0/1", False),
    ("fused_dense_gnn", 8, 512, (64, 64, 64), ("relu", "tanh"), "0/1",
     False),
    # graph sizes off the kernels' 16-row grid, which the wrappers pad
    # (the RL configurations' horizon + 1: 5 for the recall task, 65 for
    # CartPole at horizon 64; and 100)
    ("fused_dense_gnn", 32, 5, (16, 16, 16), ("tanh", "tanh"), "0/1", False),
    ("fused_dense_gnn", 64, 65, (64, 64, 64), ("tanh", "tanh"), "weighted",
     False),
    ("fused_dense_gnn", 16, 100, (32, 32, 32), ("relu", "tanh"), "0/1",
     False),
    ("fused_dense_graph_conv", 32, 5, (16, 16), ("tanh",), "0/1", False),
    ("fused_dense_graph_conv", 64, 65, (64, 64), (None,), "weighted", False),
    ("fused_dense_graph_conv", 16, 100, (32, 32), ("relu",), "0/1", False),
    # the nav replay's two convs (rl/nav.py at examples/train_nav.py's
    # sizes: B_train 32, max_verts 26, features 5 + pose 3 -> 32 -> 32)
    ("fused_dense_graph_conv", 32, 26, (8, 32), (None,), "0/1", False),
    ("fused_dense_graph_conv", 32, 26, (32, 32), (None,), "0/1", False),
]


def dense_bwd_bound_ms(B, N, widths, need_adj):
    """The stack backward's least time: the forward replay's and the
    backward's products on the tensor cores, three TF32 products for each
    f32-accurate one as `dense_bound_ms` counts the forward's (whatever
    route the kernel takes), or its bytes (x, adj, the parameters and g
    read once; dx, dadj if asked for and the parameters' gradients written
    once)."""
    flops = 0
    for fi, fo in zip(widths[:-1], widths[1:]):
        flops += 2 * B * (N * N * fi + 2 * N * fi * fo)   # replay
        flops += 2 * B * N * fi * fo * 3                  # dagg, dW_rel, dW_root
        flops += 2 * B * (N * N * fi + N * fo * fi)       # dh
        if need_adj:
            flops += 2 * B * N * N * fi                   # dadj
    params = sum(2 * fi * fo + fo for fi, fo in zip(widths[:-1], widths[1:]))
    nbytes = 4 * (2 * B * N * widths[0] + B * N * N * (1 + need_adj)
                  + 2 * params + B * N * widths[-1])
    return bound_ms(nbytes, 3 * flops, PEAK_TF32_FLOP_PER_S)


def dense_bwd_case(case, B, N, widths, acts, need_adj, inputs, seed,
                   main_path):
    """The stack backward (csrc/dense_gnn_bwd.cu) against its plain
    version, JAX's formulas, for a cotangent g uniform in (-1, 1): dx, dadj
    where asked for, and every parameter's gradient, each within TOL_KERNEL
    of its largest magnitude (at least 1): a parameter's gradient sums
    B x N products, up to a few hundred at these shapes, where float32
    rounding in another order alone differs by more than 1e-5 (autograd
    through cuBLAS differs from the plain version as much). Library:
    autograd's backward through the bmm + addmm forward (its graph built
    once)."""
    from gcm_tpu_torch.ops.cuda.fused_gnn import (
        NEED_ADJ, NEED_PARAMS, NEED_X, fused_dense_gnn_bwd,
        fused_dense_gnn_bwd_plain, fused_dense_gnn_bwd_plan)

    x, adj, *params = make_case(B, N, widths, seed, inputs)
    g = (torch.rand((B, N, widths[-1]), generator=torch.Generator()
                    .manual_seed(seed + 1000)) * 2 - 1).cuda()
    need = NEED_X | NEED_PARAMS | (NEED_ADJ if need_adj else 0)

    def grads(fn):
        dx, dadj, dparams = fn(x, adj, params, acts, g, need)
        return (dx,) + ((dadj,) if need_adj else ()) + tuple(dparams)

    L = len(acts)
    xl = x.clone().requires_grad_()
    adjl = adj.clone().requires_grad_(need_adj)
    wcats = [torch.cat([params[3 * i], params[3 * i + 2]], 0)
             .requires_grad_() for i in range(L)]
    biases = [params[3 * i + 1].clone().requires_grad_() for i in range(L)]
    out = library_gnn(xl, adjl, wcats, biases, acts)
    leaves = [xl] + ([adjl] if need_adj else []) + wcats + biases

    def library():
        d = torch.autograd.grad(out, leaves, g, retain_graph=True)
        dw, db = d[-2 * L:-L], d[-L:]
        per_layer = [(dw[i][:widths[i]], db[i], dw[i][widths[i]:])
                     for i in range(L)]
        return d[:len(leaves) - 2 * L] + tuple(t for p in per_layer
                                               for t in p)

    want = grads(fused_dense_gnn_bwd_plain)
    err_scale = torch.cat([
        torch.full((t.numel(),), max(1.0, float(t.abs().max())),
                   device=t.device) for t in want])
    # every cluster size the shape has a plan at, each checked as the
    # choice is and timed beside it, for the planner's choice to be judged
    by_c = {}
    for C in (1, 2, 4, 8, 16):
        plan = fused_dense_gnn_bwd_plan(widths, B, N, x.device, cluster=C)
        if plan is None:
            continue

        def run(C=C):
            return grads(functools.partial(fused_dense_gnn_bwd, cluster=C))

        err = float(((flat(run()) - flat(want)).abs() / err_scale).max())
        check(err <= TOL_KERNEL, f"fused_dense_gnn_bwd {case} in clusters of "
              f"{C}: max scaled err {err} > {TOL_KERNEL}")
        by_c[C] = dict(ms=time_ms(run)[0], max_scaled_err=err,
                       route=[plan[k] for k in BWD_ROUTE_KEYS])
    return kernel_row(
        "fused_dense_gnn_bwd",
        dict(case=case, B=B, N=N, widths=list(widths), acts=list(acts),
             dadj=need_adj, inputs=inputs,
             plan=fused_dense_gnn_bwd_plan(widths, B, N, x.device),
             by_C=by_c),
        main_path, kernel=lambda: grads(fused_dense_gnn_bwd),
        plain=lambda: grads(fused_dense_gnn_bwd_plain), library=library,
        bound=dense_bwd_bound_ms(B, N, widths, need_adj),
        err_scale=err_scale)


DENSE_BWD_CASES = [
    # (case, B, N, widths, acts, dadj, inputs (make_case), main_path): the
    # dense scan's training step (its adjacency carries no gradient), the
    # served batch, a learned adjacency (dadj), the other activations and
    # one layer (the one-layer conv's backward), a weighted adjacency, and
    # the adjacency streamed in chunks (N = 512 and 1,024), with odd
    # widths; then one element in the largest cluster, a single 16-row tile,
    # four layers with the widest width, a width of 1 and widths off the
    # 8-column MMA grid, a grid of no whole number of waves, and rows that
    # fit in shared memory at no cluster size (the global scratch)
    ("scan", 32, 128, (32, 32, 32), ("tanh", "tanh"), False, "0/1", True),
    ("served batch", 256, 128, (32, 32, 32), ("tanh", "tanh"), False, "0/1",
     False),
    ("learned adjacency", 32, 128, (32, 32, 32), ("tanh", "tanh"), True,
     "weighted", False),
    ("relu, none", 16, 64, (8, 32, 16), ("relu", None), True, "0/1", False),
    ("one layer", 32, 128, (32, 32), (None,), True, "0/1", False),
    ("streamed", 8, 512, (64, 64, 64), ("relu", "tanh"), True, "weighted",
     False),
    ("streamed, odd widths", 2, 1024, (13, 30, 17, 7),
     ("tanh", "relu", None), False, "x*8", False),
    ("one element", 1, 1024, (32, 32, 32), ("tanh", "tanh"), False, "0/1",
     False),
    ("one tile", 8, 16, (32, 32, 32), ("tanh", "tanh"), True, "weighted",
     False),
    ("four layers", 16, 128, (128, 8, 1, 24, 128),
     ("relu", "tanh", None, "tanh"), True, "0/1", False),
    ("B=300", 300, 128, (32, 32, 32), ("tanh", "tanh"), False, "0/1", False),
    ("scratch", 2, 1024, (128, 128, 128), ("tanh", "tanh"), True,
     "weighted", False),
    # graph sizes off the 16-row grid, padded by the wrapper
    ("N=5", 32, 5, (16, 16, 16), ("tanh", "tanh"), True, "0/1", False),
    ("N=65", 64, 65, (64, 64, 64), ("tanh", "tanh"), False, "weighted",
     False),
    ("N=100", 16, 100, (32, 32, 32), ("relu", "tanh"), True, "0/1", False),
    # the nav replay's convs' backward (V = 26; the mask takes no gradient)
    ("nav V=26", 32, 26, (32, 32), (None,), False, "0/1", False),
]
# what a block of the backward keeps in shared memory, as its plan says:
# its rows (else they are in global scratch), the adjacency, the weights;
# every route the planner takes (kRoutes in csrc/dense_gnn_bwd.cu) runs in
# some case of DENSE_BWD_CASES
BWD_ROUTE_KEYS = ("onchip", "adj_resident", "w_resident")
BWD_ROUTES = {(1, 1, 1), (1, 0, 1), (1, 0, 0), (0, 0, 0)}


def edge_grad_case(case, B, N, F, E, plans, seed, main_path):
    """The edge weight-gradient (csrc/edge_grad.cu) bitwise against its
    plain version, which adds in the kernel's order, on the planner's plan
    and on each (tile_bytes, splits) of plans (each checked bitwise and
    timed as by_plan, for the planner's choice to be judged; each must be
    a plan other than the planner's and the others'; no plan changes the
    order). "pairs layout" and "segment layout" hand it the
    bucket_edges_pairs and bucket_edges_segments lanes of the case's random
    edges, as gradient_phase's pair and segment backwards do. Library: the
    same function as one torch.sparse.sampled_addmm (g x^T sampled at the
    block-diagonal CSR of the in-range lanes; autograd's backward through
    torch.sparse.mm to its values waits for the host, so the harness sees
    no device time of it), its values mapped back onto the lanes for the
    error only."""
    from gcm_tpu_torch.benchmarks.spmm_variants import (block_diagonal_coo,
                                                        pair_cap)
    from gcm_tpu_torch.ops.cuda import spmm2, spmm_seg
    from gcm_tpu_torch.ops.cuda.edge_grad import (_launch, edge_weight_grad,
                                                  edge_weight_grad_plain,
                                                  edge_weight_grad_plan)

    x, edges, w = (torch.from_numpy(a).cuda() for a in spmm_inputs(
        "odd" if case.startswith("odd") else case, B, N, F, E, seed))
    if case in ("pairs layout", "segment layout"):
        cap = pair_cap(N, E)
        if case == "pairs layout":
            edges, w, counts = spmm2.bucket_edges_pairs(edges, w, N, cap)
        else:
            edges, w, _, _, counts = spmm_seg.bucket_edges_segments(
                edges, w, N, cap)
        spmm2.check_bucket_overflow(counts, cap)
        E = edges.shape[2]
    g = torch.from_numpy(np.random.default_rng(seed + 1000).standard_normal(
        (B, N, F)).astype(np.float32)).cuda()
    coo = block_diagonal_coo(edges, w, N)
    csr = coo.to_sparse_csr()
    g2, x2t = g.reshape(B * N, F), x.reshape(B * N, F).T.contiguous()
    valid = (edges[:, 0] >= 0) & (edges[:, 1] >= 0)
    off = (torch.arange(B, device=edges.device) * N)[:, None]
    # each in-range lane's place among the COO's sorted (row, column) keys
    inside = valid & (edges[:, 0] < N) & (edges[:, 1] < N)
    key = ((edges[:, 0].long() + off) * (B * N) + edges[:, 1].long() + off)
    keys = coo.indices()[0] * (B * N) + coo.indices()[1]
    pos = torch.searchsorted(keys, key.clamp(min=0)).clamp(
        max=max(keys.numel() - 1, 0))

    def library_as(vals):
        if not vals.numel():
            return torch.zeros_like(key, dtype=torch.float32)
        return torch.where(inside, vals[pos], 0.0)

    def rows(i):  # the distinct rows of g or x the valid lanes read
        r = torch.clamp(edges[:, i].long(), max=N - 1) + off
        return int(torch.unique(r[valid]).numel())

    plan = edge_weight_grad_plan(B, N, F, E, x.device)
    want = edge_weight_grad_plain(g, x, edges)
    seen, by_plan = [plan], {}
    for tile_bytes, splits in plans:
        forced = edge_weight_grad_plan(B, N, F, E, x.device, tile_bytes,
                                       splits)
        check(forced not in seen, f"edge_weight_grad {case}: the forced "
              f"plan {tile_bytes}/{splits} is {forced}, a plan already run")
        seen.append(forced)

        def run(tile_bytes=tile_bytes, splits=splits):
            return _launch(g, x, edges, tile_bytes, splits)

        check(bitwise_equal(run(), want), f"edge_weight_grad {case} on plan "
              f"{forced}: not bitwise equal to its plain version")
        by_plan[f"{tile_bytes}/{splits}"] = dict(
            ms=time_ms(run)[0], tiles=forced["tiles"],
            splits=forced["splits"])
    n_valid = int(valid.sum())
    return kernel_row(
        "edge_weight_grad",
        dict(case=case, B=B, N=N, F=F, E=E, plan=plan, by_plan=by_plan),
        main_path,
        kernel=lambda: edge_weight_grad(g, x, edges),
        plain=lambda: edge_weight_grad_plain(g, x, edges),
        library=lambda: torch.sparse.sampled_addmm(csr, g2, x2t, beta=0.0)
        .values(), library_as=library_as,
        bound=bound_ms(4 * F * (rows(0) + rows(1)) + 8 * B * E + 4 * B * E,
                       2 * n_valid * F),
        tol=0.0)  # bitwise: both add in the same order


# forced (tile_bytes, splits) plans: a warp a lane; the tiled kernel with
# csrc/edge_grad.cu's own tile (kTileBytes) on a call the planner gives a
# warp a lane; and for the sweep's layouts 64 and 128 KB tiles of g (4 and
# 2 tiles an element), one and eight splits a tile
LANE, TILED = (-1, 0), (262144, 0)
SWEEP_PLANS = ((65536, 0), (131072, 0), (0, 1), (0, 8), LANE)
EDGE_GRAD_CASES = [
    # (case, B, N, F, E, plans, main_path): the SpMM sweep's point, raw and
    # as the pair and segment buckets gradient_phase's backwards hand it
    # (E = 8192 raw lanes, 16 buckets of pair_cap 1,024 lanes, about half
    # of them empty); every lane into sink 7; two tiles of sink rows an
    # element (against one); the sparse path's window; sentinels and
    # indices of N or more (clamped rows: every "odd" case), F = 13 on
    # either side of the warp-a-lane threshold (16,384 lanes) and F = 45;
    # many columns; no valid lane; rows of 16,387 floats. Each call near
    # the threshold also runs on the other route. Together they take every
    # route of csrc/edge_grad.cu (EDGE_GRAD_ROUTES).
    ("wide", 64, 512, 128, 8192, SWEEP_PLANS, True),
    ("main path", 32, 128, 32, 512, ((0, 1), LANE), False),
    ("odd", 2, 300, 13, 777, (TILED,), False),
    ("many columns", 4, 256, 260, 2048, (TILED,), False),
    ("empty", 2, 128, 32, 64, (TILED,), False),
    ("pairs layout", 64, 512, 128, 8192, SWEEP_PLANS, True),
    ("hot row", 64, 512, 128, 8192, ((0, 1), LANE), False),
    ("segment layout", 64, 512, 128, 8192, SWEEP_PLANS, True),
    ("two tiles", 16, 1024, 128, 8192, ((524288, 0),), False),
    ("odd, tiled", 16, 300, 13, 1024, (LANE,), False),
    ("odd, F = 45", 16, 256, 45, 2048, (LANE,), False),
    ("wide rows", 2, 16, 16387, 40, (TILED,), False),
]
# the kernel's routes (tiled; tiled with F <= 32; tiled with float4 rows),
# each taken by some case of EDGE_GRAD_CASES on its own plan
EDGE_GRAD_ROUTES = {(1, True, True), (1, True, False), (1, False, True),
                    (1, False, False), (0, False, False)}


def edge_grad_route(row):
    tiled = row["plan"]["tiled"]
    return (tiled, bool(tiled) and row["F"] <= 32,
            bool(tiled) and row["F"] % 4 == 0)


def launch_floor() -> dict:
    """The device time of one launch of an empty kernel (PyTorch's spin
    kernel, 0 cycles) by the same harness: the floor under the smallest
    kernel calls."""
    ms, call_ms = time_ms(lambda: torch.cuda._sleep(0))
    row = dict(kernel="empty", ms=ms, call_ms=call_ms)
    emit("launch_floor", **row)
    return row


def refuse_all(cases, wrappers, errors=(ValueError,)) -> dict:
    """Calls each of cases, every one of which must raise one of errors
    before any of wrappers launches; emits and returns the messages."""
    launches = [f.launches for f in wrappers]
    refused = {}
    for case, call in cases.items():
        try:
            call()
        except errors as e:
            refused[case] = str(e)
    check(sorted(refused) == sorted(cases),
          f"inputs not refused: {sorted(set(cases) - set(refused))}")
    check([f.launches for f in wrappers] == launches,
          "a refused input was launched")
    emit("refuse", **refused)
    return refused


def refusal_phase() -> None:
    """Inputs the kernels do not take raise on the card before any launch."""
    from gcm_tpu_torch.ops.cuda.dense_gconv import fused_dense_graph_conv
    from gcm_tpu_torch.ops.cuda.fused_gnn import fused_dense_gnn

    x, adj, *flat = make_case(2, 128, (32, 32), seed=99)
    misaligned = torch.empty(adj.numel() + 1, device=adj.device)[1:] \
        .view(adj.shape).copy_(adj)
    # a graph size off the 16-row grid is padded and launched; one above
    # the kernels' 1,024 rows is not
    x2k, adj2k, *flat2k = make_case(1, 2048, (32, 32), seed=99)
    cases = {
        "misaligned_adj": lambda: fused_dense_gnn(x, misaligned, flat,
                                                  ("tanh",)),
        "graph_size_2048": lambda: fused_dense_graph_conv(x2k, adj2k,
                                                          *flat2k),
        "float64": lambda: fused_dense_graph_conv(x.double(), adj.double(),
                                                  *(p.double() for p in flat)),
    }
    refuse_all(cases, (fused_dense_gnn, fused_dense_graph_conv))


# -- phase 3, continued: the SpMM kernels -------------------------------------

def temporal_edges(B, N, E, hops, steps):
    """The [B, 2, E] int32 edge list TemporalEdge(hops) leaves after `steps`
    steps (per new node, hops descending), -1 in the lanes after it."""
    sinks, srcs = [], []
    for i in range(1, steps):
        for h in sorted(hops, reverse=True):
            if i - h >= 0:
                sinks.append(i)
                srcs.append(i - h)
    check(len(sinks) <= E, "temporal edges overflow the edge list")
    edges = np.full((B, 2, E), -1, np.int32)
    edges[:, 0, :len(sinks)] = sinks
    edges[:, 1, :len(srcs)] = srcs
    return edges


def spmm_inputs(case, B, N, F, E, seed):
    """x, edges, weights (numpy) for a kernel case."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, N, F)).astype(np.float32)
    if case == "main path":  # what a 128-step whole window leaves
        edges = temporal_edges(B, N, E, (1,), N)
        w = np.ones((B, E), np.float32)
    elif case == "empty":
        edges = np.full((B, 2, E), -1, np.int32)
        w = np.ones((B, E), np.float32)
    else:
        edges = rng.integers(0, N, (B, 2, E)).astype(np.int32)
        if case == "odd":  # -1 in sink-only, source-only and both lanes,
            edges[:, 0, 1::6] = -1  # and indices of N or more
            edges[:, 1, 2::6] = -1
            edges[:, :, 3::6] = -1
            edges[:, 0, 4::12] = N
            edges[:, 1, 5::12] = N + 3
        elif case == "hot row":  # every lane into one sink
            edges[:, 0] = 7
        elif case == "descending":  # sinks fall with the lane index
            edges[:, 0] = N - 1 - np.arange(E) * N // E
        w = rng.uniform(0.5, 1.5, (B, E)).astype(np.float32)
    return x, edges, w


def lanes_per_sink(edges, N):
    """The most lanes of a [B,2,E] edge list that share a sink in 0..N-1:
    no spmm variant adds more lanes into one row, so its plain version,
    given this depth, sums in lane order without the host wait of finding
    its own (ops/scatter.py::in_order_slots) and is timed on the device."""
    B = edges.shape[0]
    sink = edges[:, 0].long()
    ok = (sink >= 0) & (sink < N)
    key = torch.where(ok, sink + N * torch.arange(B, device=sink.device)[
        :, None], B * N)
    return int(torch.bincount(key.flatten(), minlength=B * N + 1)[:-1].max())


def spmm_case(case, B, N, F, E, seed, main_path):
    from gcm_tpu_torch.benchmarks.spmm_variants import block_diagonal_coo
    from gcm_tpu_torch.ops.cuda.spmm import (spmm_edge_list,
                                             spmm_edge_list_plain)

    x, edges, w = (torch.from_numpy(a).cuda()
                   for a in spmm_inputs(case, B, N, F, E, seed))
    coo = block_diagonal_coo(edges, w, N)
    x2 = x.reshape(B * N, F)
    # the operations this run's data needs: its valid lanes
    n_valid = int(coo.values().numel())
    depth = lanes_per_sink(edges, N)
    row = kernel_row(
        "spmm_edge_list", dict(case=case, B=B, N=N, F=F, E=E), main_path,
        kernel=lambda: spmm_edge_list(x, edges, w),
        plain=lambda: spmm_edge_list_plain(x, edges, w, depth),
        library=lambda: torch.sparse.mm(coo, x2).reshape(B, N, F),
        bound=bound_ms(4 * B * 2 * N * F + lane_bytes(edges[:, 0]),
                       2 * n_valid * F),
        tol=0.0)  # bitwise: both add in lane order
    if case == "empty":
        check(not bool(row["max_abs_err"]), "empty edge list: not zero")
    return row


def slots_coo(srcs, ws, N):
    """The edges of a slot layout (a source inside its window, a weight
    other than 0) as one block-diagonal COO matrix [B*N, B*N]."""
    from gcm_tpu_torch.ops.cuda.spmm_slots import W

    B, nw, k = srcs.shape[0], N // W, srcs.shape[2]
    s5 = srcs.reshape(B, nw, nw, k, W).long()
    w5 = ws.reshape(B, nw, nw, k, W)
    keep = (s5 >= 0) & (s5 < W) & (w5 != 0)
    b, sw, kc, _, lane = keep.nonzero(as_tuple=True)
    idx = torch.stack([b * N + sw * W + lane, b * N + kc * W + s5[keep]])
    with torch.sparse.check_sparse_tensor_invariants():
        return torch.sparse_coo_tensor(idx, w5[keep],
                                       (B * N, B * N)).coalesce()


def slots_case(case, B, N, F, k, hops, seed, main_path):
    from gcm_tpu_torch.ops.cuda.spmm_slots import (
        W, bucket_sink_slots, check_slot_overflow, spmm_slots,
        spmm_slots_plain)

    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((B, N, F))
                         .astype(np.float32)).cuda()
    edges = torch.from_numpy(temporal_edges(B, N, len(hops) * N, hops,
                                            N)).cuda()
    w = torch.from_numpy(rng.uniform(0.5, 1.5, edges.shape[::2])
                         .astype(np.float32)).cuda()
    srcs, ws, counts = bucket_sink_slots(edges, w, N, k)
    check_slot_overflow(counts, k)
    if case.startswith("out-of-range"):  # weighted slots that add nothing
        srcs.view(-1)[::7] = -1
        srcs.view(-1)[3::11] = W + 5
    coo = slots_coo(srcs, ws, N)
    x2 = x.reshape(B * N, F)
    P = (N // W) ** 2
    return kernel_row(
        "spmm_slots", dict(case=case, B=B, N=N, F=F, k=k), main_path,
        kernel=lambda: spmm_slots(x, srcs, ws, N, k),
        plain=lambda: spmm_slots_plain(x, srcs, ws, k),
        library=lambda: torch.sparse.mm(coo, x2).reshape(B, N, F),
        bound=bound_ms(4 * B * (2 * F * N + 2 * P * k * W),
                       2 * int(coo.values().numel()) * F),
        tol=0.0)  # bitwise equal: the plain version adds in the kernel's order


SPMM_CASES = [
    # (case, B, N, F, E, main_path); then the branches of the sink-sorted
    # kernel (csrc/sink_sort.cuh): a hot row over two passes of 8,192 lanes
    # (F = 130: float2 columns, a 2-column tile), sinks descending in lane
    # order (F = 260: five feature tiles), eight passes, N = 4,100 in tiles
    # of 1,024 rows (the largest shared-memory plan), and a plan of exactly
    # 48 KB of dynamic shared memory (256 rows, 4,096 lanes: the gate
    # phase's N = 1,024 window), which with the kernel's static s_part needs
    # the opt-in above 48 KB
    ("main path", 32, 128, 32, 512, True),
    ("wide", 64, 512, 128, 8192, False),
    ("odd", 3, 12, 13, 37, False),
    ("empty", 4, 128, 32, 64, False),
    ("hot row", 2, 256, 130, 9000, False),
    ("descending", 4, 512, 260, 4096, False),
    ("many lanes", 2, 512, 128, 65536, False),
    ("large N", 64, 4100, 13, 16384, False),
    ("48 KB plan", 32, 1024, 32, 4096, False),
]
SLOTS_CASES = [
    # (case, B, N, F, k, hops, main_path). The direct kernel (csrc/
    # spmm_slots.cu::spmm_slots_kernel): float4 columns, 8 threads a sink
    # row; single columns at F = 13; 65 float4 columns over 32 threads; k =
    # 3 at the last k before the staged kernel; 36 slots a row over five
    # rounds of 8 gathers, some sources outside their window. The staged
    # kernel (k >= 4, float4 columns, at least one block an SM): k = 4 and
    # k = 12, and k = 9 with sources outside their window
    ("main path", 32, 128, 32, 1, (1,), True),
    ("odd", 2, 256, 13, 2, (1, 2), False),
    ("many columns", 2, 256, 260, 3, (1, 2, 3), False),
    ("k boundary, direct", 64, 512, 128, 3, (1, 2, 3), False),
    ("out-of-range sources", 4, 256, 32, 9, tuple(range(1, 10)), False),
    ("k boundary, staged", 64, 512, 128, 4, (1, 2, 3, 4), False),
    ("many hops", 64, 512, 128, 12, tuple(range(1, 13)), False),
    ("out-of-range sources, staged", 64, 256, 128, 9, tuple(range(1, 10)),
     False),
]


def sddmm_inputs(B, N, F, seed):
    """nodes [B,N,F] standard normal, num_nodes with 0 and N - 1 among
    them, and curr = nodes[b, num_nodes[b]] (as the selectors gather it), on
    the card."""
    g = torch.Generator().manual_seed(seed)
    nodes = torch.randn((B, N, F), generator=g)
    num_nodes = torch.randint(0, N, (B,), generator=g, dtype=torch.int32)
    num_nodes[0], num_nodes[-1] = 0, N - 1
    curr = nodes[torch.arange(B), num_nodes.long()]
    return curr.cuda(), nodes.cuda(), num_nodes.cuda()


def library_sddmm(curr, nodes, num_nodes, thr, mode):
    """The same row from torch library calls: one bmm for the dot products,
    norms, and the compare (the euclidean distance in its expanded form)."""
    dots = torch.bmm(nodes, curr[:, :, None])[..., 0]
    if mode == "cosine":
        score = dots / (torch.linalg.vector_norm(curr, dim=-1, keepdim=True)
                        .clamp_min(1e-8)
                        * torch.linalg.vector_norm(nodes, dim=-1)
                        .clamp_min(1e-8))
    else:
        sq = (curr * curr).sum(-1, keepdim=True) - 2 * dots \
            + (nodes * nodes).sum(-1)
        score = sq.clamp_min(0).sqrt()
    iota = torch.arange(nodes.shape[1], device=nodes.device)
    return (score < thr) & (iota[None, :] < num_nodes[:, None])


def sddmm_bound_ms(B, N, F, mode, curr_apart=True):
    """Inputs read once, the bool row written once; the operations the
    score needs (euclidean: sub, mul, add per feature and a sqrt per node;
    cosine: the dot and the node's norm per feature, curr's norm once per
    batch element, a sqrt, a product and a division per node). Without
    curr_apart, curr is one of the scored rows, read with them."""
    nbytes = 4 * (B * F * curr_apart + B * N * F + B) + B * N
    flops = (3 * B * N * F + B * N if mode == "euclidean"
             else 4 * B * N * F + 2 * B * F + 3 * B * N)
    return bound_ms(nbytes, flops)


def sddmm_case(case, B, N, F, mode, thr, seed, main_path):
    from gcm_tpu_torch.ops.cuda.sddmm import (sddmm_threshold_row,
                                              sddmm_threshold_row_plain)

    curr, nodes, num_nodes = sddmm_inputs(B, N, F, seed)
    row = kernel_row(
        "sddmm_threshold_row", dict(case=case, B=B, N=N, F=F, mode=mode,
                                    threshold=thr), main_path,
        kernel=lambda: sddmm_threshold_row(curr, nodes, num_nodes, thr, mode),
        plain=lambda: sddmm_threshold_row_plain(curr, nodes, num_nodes, thr,
                                                mode),
        library=lambda: library_sddmm(curr, nodes, num_nodes, thr, mode),
        bound=sddmm_bound_ms(B, N, F, mode), tol=0.0)  # bitwise equal
    check_mask(sddmm_threshold_row(curr, nodes, num_nodes, thr, mode), case,
               mode)
    return row


def check_mask(got, case, mode) -> None:
    """A score row that tests something: neither all nor no edges, and
    none from batch element 0, whose num_nodes is 0."""
    check(bool(got.any()) and not bool(got.all()),
          f"sddmm {case} {mode}: a constant mask tests nothing")
    check(not bool(got[0].any()), f"sddmm {case} {mode}: num_nodes 0 has "
          "edges")


SDDMM_CASES = [
    # (case, B, N, F, mode, threshold, main_path): the explicit entry at the
    # served shape with CosineEdge(0.5) on the raw obs and SpatialEdge(0.25)
    # on a 2-wide pose slice, a wide and an odd shape
    ("served cosine", 256, 128, 8, "cosine", 0.5, False),
    ("served spatial", 256, 128, 2, "euclidean", 0.25, False),
    ("wide", 64, 512, 128, "cosine", 0.0, False),
    ("wide", 64, 512, 128, "euclidean", 16.0, False),
    ("odd", 3, 13, 5, "cosine", 0.2, False),
    ("odd", 3, 13, 5, "euclidean", 3.0, False),
]


def sddmm_current_case(case, B, N, F, cols, curr_cols, mode, thr, seed,
                       main_path):
    """The current-node entry as the selectors call it: the current node
    and both column ranges read from nodes [B,N,F] in place."""
    from gcm_tpu_torch.ops.cuda.sddmm import (
        current_node, sddmm_threshold_row_current,
        sddmm_threshold_row_current_plain)

    _, nodes, num_nodes = sddmm_inputs(B, N, F, seed)
    num_nodes[1] = N + 3  # clamped to N - 1
    cols, curr_cols = slice(*cols), slice(*curr_cols or cols)
    width = cols.stop - cols.start
    row = kernel_row(
        "sddmm_threshold_row", dict(case=case, B=B, N=N, F=F, mode=mode,
                                    threshold=thr, cols=str(cols),
                                    curr_cols=str(curr_cols)), main_path,
        kernel=lambda: sddmm_threshold_row_current(nodes, num_nodes, thr,
                                                   mode, cols, curr_cols),
        plain=lambda: sddmm_threshold_row_current_plain(
            nodes, num_nodes, thr, mode, cols, curr_cols),
        library=lambda: library_sddmm(
            current_node(nodes, num_nodes)[:, curr_cols], nodes[:, :, cols],
            num_nodes, thr, mode),
        bound=sddmm_bound_ms(B, N, width, mode,
                             curr_apart=curr_cols != cols),
        tol=0.0)  # bitwise equal
    check_mask(sddmm_threshold_row_current(nodes, num_nodes, thr, mode, cols,
                                           curr_cols), case, mode)
    return row


SDDMM_CURRENT_CASES = [
    # (case, B, N, F, cols, curr_cols (None: cols), mode, threshold,
    # main_path): the served CosineEdge(0.5) and SpatialEdge(0.25, pose
    # 0:2) rows as the selectors ask for them, different pose slices at
    # column offsets, F = 5 at the unaligned offset 3 (scalar loads), and
    # F = 128 (float4 loads)
    ("served cosine current", 256, 128, 8, (0, 8), None, "cosine", 0.5,
     True),
    ("served spatial current", 256, 128, 8, (0, 2), None, "euclidean", 0.25,
     False),
    ("a != b slices", 256, 128, 8, (4, 6), (1, 3), "euclidean", 0.5, False),
    ("odd at offset 3", 3, 13, 11, (3, 8), None, "cosine", 0.2, False),
    ("wide current", 64, 512, 128, (0, 128), None, "cosine", 0.0, False),
]


def sddmm_refusal_phase() -> None:
    """Inputs the score-row kernel does not take raise on the card before
    any launch."""
    from gcm_tpu_torch.ops.cuda.sddmm import (sddmm_threshold_row,
                                              sddmm_threshold_row_current)

    curr, nodes, num_nodes = sddmm_inputs(4, 16, 8, seed=97)
    current = sddmm_threshold_row_current
    nodes_t = nodes.transpose(1, 2).contiguous().transpose(1, 2)
    one = torch.zeros((1, 1), device="cuda")
    cases = {
        "float64": lambda: sddmm_threshold_row(
            curr.double(), nodes.double(), num_nodes, 0.5),
        "int64_num_nodes": lambda: sddmm_threshold_row(
            curr, nodes, num_nodes.long(), 0.5),
        "non_contiguous": lambda: sddmm_threshold_row(curr, nodes_t,
                                                      num_nodes, 0.5),
        "wrong_shape": lambda: sddmm_threshold_row(curr[:, :-1], nodes,
                                                   num_nodes, 0.5),
        "cpu_num_nodes": lambda: sddmm_threshold_row(curr, nodes,
                                                     num_nodes.cpu(), 0.5),
        "batch_65536": lambda: sddmm_threshold_row(
            torch.zeros((65536, 1), device="cuda"),
            torch.zeros((65536, 1, 1), device="cuda"),
            torch.zeros(65536, dtype=torch.int32, device="cuda"), 0.5),
        "features_65537": lambda: sddmm_threshold_row(
            torch.zeros((1, 65537), device="cuda"),
            torch.zeros((1, 1, 65537), device="cuda"),
            torch.zeros(1, dtype=torch.int32, device="cuda"), 0.5),
        "empty_graph": lambda: sddmm_threshold_row(
            one, one[:, :0, None].expand(1, 0, 1).contiguous(),
            torch.zeros(1, dtype=torch.int32, device="cuda"), 0.5),
        "current_float64": lambda: current(nodes.double(), num_nodes, 0.5),
        "current_int64_num_nodes": lambda: current(nodes, num_nodes.long(),
                                                   0.5),
        "current_cpu_num_nodes": lambda: current(nodes, num_nodes.cpu(), 0.5),
        "current_cpu_nodes": lambda: current(nodes.cpu(), num_nodes, 0.5),
        "current_widths_differ": lambda: current(
            nodes, num_nodes, 0.5, cols=slice(0, 2), curr_cols=slice(0, 3)),
        "current_no_columns": lambda: current(nodes, num_nodes, 0.5,
                                              cols=slice(2, 2)),
        "current_not_3d": lambda: current(nodes[0], num_nodes, 0.5),
    }
    refuse_all(cases, (sddmm_threshold_row,))


def sparse_refusal_phase() -> None:
    """Inputs the SpMM kernels do not take raise on the card before any
    launch: float64, int64 indices, wrong shapes, non-contiguous tensors."""
    from gcm_tpu_torch.ops.cuda.spmm import spmm_edge_list
    from gcm_tpu_torch.ops.cuda.spmm_slots import bucket_sink_slots, spmm_slots

    x, edges, w = (torch.from_numpy(a).cuda()
                   for a in spmm_inputs("wide", 2, 128, 8, 16, seed=98))
    srcs, ws, _ = bucket_sink_slots(edges, w, 128, 4)
    xt = x.transpose(1, 2).contiguous().transpose(1, 2)  # same shape, strided
    cases = {
        "spmm_float64": lambda: spmm_edge_list(x.double(), edges, w.double()),
        "spmm_int64_edges": lambda: spmm_edge_list(x, edges.long(), w),
        "spmm_wrong_shape": lambda: spmm_edge_list(x, edges, w[:, :-1]),
        "spmm_non_contiguous": lambda: spmm_edge_list(xt, edges, w),
        "slots_float64": lambda: spmm_slots(x.double(), srcs, ws.double(),
                                            128, 4),
        "slots_int64_srcs": lambda: spmm_slots(x, srcs.long(), ws, 128, 4),
        "slots_wrong_shape": lambda: spmm_slots(x, srcs, ws, 128, 3),
        "slots_non_contiguous": lambda: spmm_slots(xt, srcs, ws, 128, 4),
    }
    refuse_all(cases, (spmm_edge_list, spmm_slots))


# -- phase 4: the served flagship --------------------------------------------

def serve_phase(card: str, seed: int = 0, ticks: int = 200,
                capacity: int = 256, snap_at: int = 100):
    from gcm_tpu_torch import SessionServer, readme_dense_gcm
    from gcm_tpu_torch.ops.cuda.fused_gnn import fused_dense_gnn

    obs_dim = 8
    model = readme_dense_gcm(obs_size=obs_dim, device="cuda", seed=seed)
    cpu_model = readme_dense_gcm(obs_size=obs_dim, device="cpu", seed=seed)
    srv = SessionServer(model, capacity=capacity, obs_dim=obs_dim)
    ref = SessionServer(cpu_model, capacity=capacity, obs_dim=obs_dim,
                        device="cpu")
    restored = None
    rng = np.random.default_rng(seed)
    live = [f"s{i}" for i in range(capacity - 16)]
    next_id = len(live)
    step_s, worst = [], 0.0
    for tick in range(ticks):
        arrivals = []
        if tick and tick % 10 == 0:
            # churn: 8 sessions end, 24 new ids arrive; the live set
            # outgrows the pool, so later arrivals evict idle sessions
            for sid in live[:8]:
                for s in (srv, ref, restored):
                    if s is not None:
                        s.end_session(sid)
            arrivals = [f"s{next_id + i}" for i in range(24)]
            next_id += 24
            live = live[8:] + arrivals
        others = [s for s in live if s not in arrivals and rng.random() < 0.6]
        sids = arrivals + others[:capacity // 2]
        reqs = {sid: rng.standard_normal(obs_dim).astype(np.float32)
                for sid in sids}
        before = fused_dense_gnn.launches
        t0 = time.perf_counter()
        out = srv.step(reqs)
        step_s.append(time.perf_counter() - t0)
        check(fused_dense_gnn.launches == before + 1,
              f"tick {tick}: {fused_dense_gnn.launches - before} "
              "fused_dense_gnn launches, expected 1")
        want = ref.step(reqs)
        for sid in sids:
            check(bool(np.isfinite(out[sid]).all()), f"{sid}: non-finite")
            worst = max(worst, float(np.abs(out[sid] - want[sid]).max()))
        if restored is not None:
            again = restored.step(reqs)
            for sid in sids:
                check(np.array_equal(out[sid], again[sid]),
                      f"tick {tick}: restored server differs for {sid}")
        if tick + 1 == snap_at:
            restored = SessionServer(
                readme_dense_gcm(obs_size=obs_dim, device="cuda", seed=seed),
                capacity=capacity, obs_dim=obs_dim)
            restored.restore(srv.snapshot())
    stats = srv.stats
    check(worst <= TOL_MODEL, f"served beliefs differ from the CPU copy by "
          f"{worst} > {TOL_MODEL}")
    check(stats == ref.stats, f"stats differ: {stats} vs {ref.stats}")
    check(stats["evictions"] >= 1, "no LRU eviction happened")
    med = statistics.median(step_s)
    emit("serve", card=card, capacity=capacity, graph_size=128,
         ticks=ticks, max_abs_err_vs_cpu=worst, restored_bitwise=True,
         snapshot_tick=snap_at, stats=stats,
         ticks_per_s=ticks / sum(step_s), us_per_tick_median=1e6 * med,
         profile=dict(requests_per_tick=len(reqs),
                      **profile_calls(lambda: restored.step(reqs))))


def profile_calls(run, n: int = 20) -> dict:
    """Where a call's time goes: torch.profiler over n calls of run(), after
    one call outside it. The wall time includes the profiler's own overhead.
    Where the profiler sees no device activity (its tracing is not always
    available), the device fields are None: not measured."""
    from torch.profiler import ProfilerActivity, profile

    run()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            run()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    device = device_events(prof)
    device_us = sum(us for _, us, _ in device)
    top = sorted(device, key=lambda e: -e[1])[:8]
    host = sorted(((e.key[:60], e.self_cpu_time_total)
                   for e in prof.key_averages()
                   if e.self_cpu_time_total > 0), key=lambda e: -e[1])[:8]
    seen = device_us > 0
    return dict(calls=n, wall_us_per_call=wall_us / n,
                top_host_self_us_per_call={k: us / n for k, us in host},
                device_us_per_call=device_us / n if seen else None,
                device_busy_share=device_us / wall_us if seen else None,
                device_kernels_per_call=sum(c for _, _, c in device) / n
                if seen else None,
                top_device_us_per_call={k: us / n for k, us, _ in top}
                if seen else None)


# -- phase 5: scan forward ----------------------------------------------------

def scan_phase(card: str, seed: int = 0, B: int = 32, T: int = 256):
    from gcm_tpu_torch import DenseGCM, DenseGNN, readme_dense_gcm
    from gcm_tpu_torch.ops.cuda.dense_gconv import fused_dense_graph_conv

    obs_dim = 8
    model = readme_dense_gcm(obs_size=obs_dim, device="cuda", seed=seed)
    cpu_model = readme_dense_gcm(obs_size=obs_dim, device="cpu", seed=seed)
    xs = torch.from_numpy(np.random.default_rng(seed + 1)
                          .standard_normal((B, T, obs_dim)).astype(np.float32))
    with torch.no_grad():
        want, want_state = cpu_model.scan(xs, cpu_model.initial_state(B,
                                                                      obs_dim))
        xs_c = xs.cuda()
        got, state = model.scan(xs_c, model.initial_state(B, obs_dim))
        err = float((got.cpu() - want).abs().max())
        err_adj = float((state.adj.cpu() - want_state.adj).abs().max())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.scan(xs_c, model.initial_state(B, obs_dim))
        torch.cuda.synchronize()
        fused_s = time.perf_counter() - t0

        unfused = DenseGCM(DenseGNN(model.gnn.layers, fuse=""),
                           preprocessor=model.preprocessor,
                           edge_selectors=model.edge_selectors,
                           graph_size=model.graph_size, device="cuda")
        before = fused_dense_graph_conv.launches
        t0 = time.perf_counter()
        got_u, _ = unfused.scan(xs_c, unfused.initial_state(B, obs_dim))
        torch.cuda.synchronize()
        unfused_s = time.perf_counter() - t0
        launched = fused_dense_graph_conv.launches - before
        err_u = float((got_u.cpu() - want).abs().max())
    check(bool(torch.isfinite(got).all()), "scan: non-finite beliefs")
    check(max(err, err_adj, err_u) <= TOL_MODEL,
          f"scan differs from the CPU copy: {err}, adj {err_adj}, "
          f"unfused {err_u}")
    check(launched == 2 * T, f"fuse='': {launched} fused_dense_graph_conv "
          f"launches, expected {2 * T}")
    emit("scan", card=card, B=B, T=T, graph_size=128, max_abs_err_vs_cpu=err,
         adj_max_abs_err=err_adj, timesteps_per_s=B * T / fused_s,
         unfused_max_abs_err=err_u, unfused_timesteps_per_s=B * T / unfused_s,
         fused_dense_graph_conv_launches=launched)


# -- phase 6: the sparse core -------------------------------------------------

def numpy_params(seed: int, obs: int = 8, hidden: int = 32) -> dict:
    """One parameter tree, in the JAX package's layout, for the README's
    dense and sparse models alike (they share it)."""
    rng = np.random.default_rng(seed)

    def linear(fin, fout, bias=True):
        bound = fin ** -0.5
        p = {"kernel": rng.uniform(-bound, bound, (fin, fout))
             .astype(np.float32)}
        if bias:
            p["bias"] = rng.uniform(-bound, bound, fout).astype(np.float32)
        return p

    def conv():
        return {"lin_rel": linear(hidden, hidden),
                "lin_root": linear(hidden, hidden, bias=False)}

    return {"gnn": [conv(), {}, conv(), {}],
            "preprocessor": [linear(obs, hidden)], "edge_selectors": {}}


def run_windows(model, xs, taus, state, window, dones=None,
                generator=None):
    """The whole-window forward over xs [B, T, F] in chained windows (dones
    [B, T] cut the same way; a stochastic selector draws from
    `generator`)."""
    outs = []
    for w0 in range(0, xs.shape[1], window):
        d = None if dones is None else dones[:, w0:w0 + window]
        out, state, aux = model(xs[:, w0:w0 + window], taus, state,
                                return_aux=True, dones=d,
                                generator=generator)
        check(not bool(aux["dropped_edges"].any()), "edges were dropped")
        check(not bool(aux.get("slot_overflow", torch.zeros(1)).any()),
              "slot overflow")
        outs.append(out)
    return torch.cat(outs, dim=1), state


def sparse_close(label, got, want, state=None, want_state=None) -> float:
    """Beliefs within TOL_MODEL of the CPU copy's; nodes, edges, t and
    num_edges exactly equal."""
    check(bool(torch.isfinite(got).all()), f"{label}: non-finite beliefs")
    err = float((got.cpu() - want).abs().max())
    check(err <= TOL_MODEL, f"{label}: beliefs differ from the CPU copy by "
          f"{err} > {TOL_MODEL}")
    if state is not None:
        for name in ("nodes", "edges", "t", "num_edges"):
            check(torch.equal(getattr(state, name).cpu(),
                              getattr(want_state, name)),
                  f"{label}: state.{name} differs from the CPU copy")
    return err


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def sparse_phase(card: str, seed: int = 0, B: int = 32, T: int = 128,
                 window: int = 32, scan_T: int = 64):
    from gcm_tpu_torch import (load_jax_params, readme_dense_gcm,
                               readme_sparse_gcm)
    from gcm_tpu_torch.ops.cuda.spmm import spmm_edge_list
    from gcm_tpu_torch.ops.cuda.spmm_slots import spmm_slots

    obs_dim = 8
    params = numpy_params(seed, obs_dim)

    def model(device, **kw):
        m = readme_sparse_gcm(obs_size=obs_dim, device=device, **kw)
        load_jax_params(m, params)
        return m

    gpu, cpu = model("cuda"), model("cpu")
    rng = np.random.default_rng(seed + 2)
    xs = torch.from_numpy(rng.standard_normal((B, T, obs_dim))
                          .astype(np.float32))
    xs_c = xs.cuda()
    full = torch.full((B,), window, dtype=torch.int32)
    full_c = full.cuda()
    row = dict(card=card, B=B, T=T, window=window, graph_size=128,
               max_edges=512)
    with torch.no_grad():
        # 1. the whole-window forward, four chained windows
        want, want_state = run_windows(cpu, xs, full, cpu.initial_state(
            B, obs_dim), window)
        before = spmm_edge_list.launches
        got, state = run_windows(gpu, xs_c, full_c,
                                 gpu.initial_state(B, obs_dim), window)
        launched = spmm_edge_list.launches - before
        row["max_abs_err_vs_cpu"] = sparse_close("whole window", got, want,
                                                 state, want_state)
        check(launched == 2 * T // window, f"{launched} spmm_edge_list "
              f"launches, expected {2 * T // window}")
        row["spmm_edge_list_launches"] = launched
        _, secs = timed(lambda: run_windows(
            gpu, xs_c, full_c, gpu.initial_state(B, obs_dim), window))
        row["timesteps_per_s"] = B * T / secs
        state_w = gpu.initial_state(B, obs_dim)
        row["profile_one_window"] = profile_calls(
            lambda: gpu(xs_c[:, :window], full_c, state_w))

        # 2. one window with ragged taus, zero past them
        taus = torch.from_numpy(rng.integers(1, window + 1, B)
                                .astype(np.int32))
        pad = torch.arange(window)[None, :, None] < taus[:, None, None]
        xr = torch.where(pad, xs[:, :window], 0.0)
        want_r, want_rs = cpu(xr, taus, cpu.initial_state(B, obs_dim))
        got_r, state_r = gpu(xr.cuda(), taus.cuda(),
                             gpu.initial_state(B, obs_dim))
        row["ragged_max_abs_err_vs_cpu"] = sparse_close(
            "ragged taus", got_r, want_r, state_r, want_rs)
        check(not bool(torch.where(pad.cuda(), 0.0, got_r).any()),
              "ragged taus: beliefs past taus are not zero")

        # 3. the dense == sparse contract: the dense README model with the
        # same weights, scanned step by step (T = graph_size: no wrap)
        dense = readme_dense_gcm(obs_size=obs_dim, device="cuda")
        load_jax_params(dense, params)
        got_d, _ = dense.scan(xs_c, dense.initial_state(B, obs_dim))
        err_d = float((got_d - got).abs().max())
        check(err_d <= TOL_MODEL, f"dense and sparse differ by {err_d} > "
              f"{TOL_MODEL}")
        row["dense_vs_sparse_max_abs_err"] = err_d

        # 4. aggregation="slots", k = len(hops) = 1
        slots = model("cuda", aggregation="slots", slot_k=1)
        before = spmm_slots.launches
        got_s, state_s = run_windows(slots, xs_c, full_c,
                                     slots.initial_state(B, obs_dim), window)
        launched = spmm_slots.launches - before
        err_s = float((got_s - got).abs().max())
        check(err_s <= TOL_MODEL, f"slots and default aggregation differ "
              f"by {err_s} > {TOL_MODEL}")
        check(torch.equal(state_s.edges, state.edges), "slots: edges differ")
        check(launched == 2 * T // window, f"{launched} spmm_slots launches, "
              f"expected {2 * T // window}")
        row.update(slots_vs_default_max_abs_err=err_s,
                   spmm_slots_launches=launched)
        _, secs = timed(lambda: run_windows(
            slots, xs_c, full_c, slots.initial_state(B, obs_dim),
            window))
        row["slots_timesteps_per_s"] = B * T / secs

        # 5. step by step with episode ends
        dones = torch.zeros((B, scan_T), dtype=torch.bool)
        dones[::3, 10] = dones[1::4, 25] = dones[:, 50] = True
        want_sc, want_scs = cpu.scan(xs[:, :scan_T], cpu.initial_state(
            B, obs_dim), dones=dones)
        (got_sc, state_sc), secs = timed(lambda: gpu.scan(
            xs_c[:, :scan_T], gpu.initial_state(B, obs_dim),
            dones=dones.cuda()))
        row["scan_max_abs_err_vs_cpu"] = sparse_close(
            "scan with dones", got_sc, want_sc, state_sc, want_scs)
        row.update(scan_T=scan_T, scan_timesteps_per_s=B * scan_T / secs)
    emit("sparse", **row)


# -- phase 7: the README DenseGCM with the other dense selectors --------------

SELECTOR_THRESHOLDS = {"cosine": 0.5, "spatial": 0.25, "euclidean": 1.0,
                       "recall_chain": 1.0}


def selector_model(kind: str, device: str, seed: int = 0):
    """The README DenseGCM (readme_dense_gcm's weights) with the selector of
    the repo's benchmark configurations: CosineEdge(0.5), SpatialEdge(0.25)
    on the pose slice 0:2 and EuclideanEdge(1.0) (bench.py's config 3),
    LearnedEdge(8, deterministic) (config 5a), DenseEdge, the recall
    example's EdgeChain([TemporalBackedge([1]), EuclideanEdge(1.0,
    window=4)]), or the README's TemporalBackedge([1]) for comparison. The
    same seed gives the same weights on any device."""
    from gcm_tpu_torch import (CosineEdge, DenseEdge, DenseGCM, EdgeChain,
                               EuclideanEdge, LearnedEdge, SpatialEdge,
                               TemporalBackedge, readme_dense_gcm)

    sel = {
        "cosine": lambda: CosineEdge(max_distance=0.5),
        "spatial": lambda: SpatialEdge(max_distance=0.25,
                                       a_pose_slice=slice(0, 2)),
        "euclidean": lambda: EuclideanEdge(max_distance=1.0),
        "dense": DenseEdge,
        "learned": lambda: LearnedEdge(
            input_size=8, deterministic=True, device=device,
            generator=torch.Generator().manual_seed(seed + 1)),
        "recall_chain": lambda: EdgeChain([
            TemporalBackedge([1]), EuclideanEdge(1.0, window=4)]),
        "temporal": lambda: TemporalBackedge([1]),
    }[kind]()
    base = readme_dense_gcm(obs_size=8, device=device, seed=seed)
    return DenseGCM(base.gnn, preprocessor=base.preprocessor,
                    edge_selectors=sel, graph_size=base.graph_size,
                    device=device)


def tick_requests(rng, capacity: int) -> dict:
    """One tick's requests: each of `capacity` sessions with probability
    1/2, an observation of 8 standard normal features."""
    return {f"s{i}": rng.standard_normal(8).astype(np.float32)
            for i in range(capacity) if rng.random() < 0.5}


def serve_selector(kind: str, ticks: int, capacity: int = 256,
                   seed: int = 0) -> dict:
    """The served tick with a kernel-scored selector, against a CPU copy:
    beliefs within TOL_MODEL, the adjacency exactly equal after every tick,
    one sddmm launch per tick; then a bitwise snapshot/restore."""
    from gcm_tpu_torch import SessionServer
    from gcm_tpu_torch.ops.cuda.sddmm import sddmm_threshold_row

    srv = SessionServer(selector_model(kind, "cuda", seed), capacity, 8)
    ref = SessionServer(selector_model(kind, "cpu", seed), capacity, 8,
                        device="cpu")
    rng = np.random.default_rng(seed + 10)
    worst, reqs = 0.0, {}
    for tick in range(ticks):
        reqs = tick_requests(rng, capacity)
        sids = list(reqs)
        if tick % 20 == 19:  # sessions end and come back with fresh memory
            for sid in sids[:16]:
                srv.end_session(sid)
                ref.end_session(sid)
        before = sddmm_threshold_row.launches
        out = srv.step(reqs)
        check(sddmm_threshold_row.launches == before + 1,
              f"{kind} tick {tick}: {sddmm_threshold_row.launches - before} "
              "sddmm launches, expected 1")
        want = ref.step(reqs)
        for sid in sids:
            check(bool(np.isfinite(out[sid]).all()), f"{sid}: non-finite")
            worst = max(worst, float(np.abs(out[sid] - want[sid]).max()))
        check(torch.equal(srv.state.adj.cpu(), ref.state.adj),
              f"{kind} tick {tick}: adjacency differs from the CPU copy")
    check(worst <= TOL_MODEL, f"{kind} served beliefs differ from the CPU "
          f"copy by {worst} > {TOL_MODEL}")
    restored = SessionServer(selector_model(kind, "cuda", seed), capacity, 8)
    restored.restore(srv.snapshot())
    a, b = srv.step(reqs), restored.step(reqs)
    check(all(np.array_equal(a[k], b[k]) for k in a),
          f"{kind}: the restored server differs")
    return dict(ticks=ticks, capacity=capacity, max_abs_err_vs_cpu=worst,
                edges_per_row=float(srv.state.adj.sum() / capacity / 128),
                restored_bitwise=True)


def serve_timing(kinds, ticks: int = 100, capacity: int = 256,
                 seed: int = 0) -> dict:
    """The served tick of each selector's README DenseGCM alone on the card
    (no CPU copy between ticks), the servers ticking in turns on the same
    requests; then a profiled window of each."""
    from gcm_tpu_torch import SessionServer

    servers = {k: SessionServer(selector_model(k, "cuda", seed), capacity, 8)
               for k in kinds}
    rng = np.random.default_rng(seed + 40)
    step_s = {k: [] for k in kinds}
    reqs = {}
    for tick in range(ticks + 10):  # the first 10 ticks warm up
        reqs = tick_requests(rng, capacity)
        for k, srv in servers.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            srv.step(reqs)
            if tick >= 10:
                step_s[k].append(time.perf_counter() - t0)
    return {k: dict(ticks=ticks, capacity=capacity,
                    us_per_tick_median=1e6 * statistics.median(step_s[k]),
                    ticks_per_s=ticks / sum(step_s[k]),
                    profile=dict(requests_per_tick=len(reqs), **profile_calls(
                        lambda srv=srv: srv.step(reqs))))
            for k, srv in servers.items()}


def scan_timing(kinds, B: int, T: int, rounds: int = 2, seed: int = 0):
    """Timesteps/s of each selector's DenseGCM.scan over [B, T, 8], the
    kinds in turns, forwards then backwards, `rounds` times."""
    models = {k: selector_model(k, "cuda", seed) for k in kinds}
    xs = torch.from_numpy(np.random.default_rng(seed + 50).standard_normal(
        (B, T, 8)).astype(np.float32)).cuda()
    order = (list(kinds) + list(kinds)[::-1]) * rounds
    rates = {k: [] for k in kinds}
    for k in order:
        m = models[k]
        _, secs = timed(lambda: m.scan(xs, m.initial_state(B, 8)))
        rates[k].append(B * T / secs)
    return rates


def scan_selector(kind: str, B: int, T: int, seed: int = 0) -> dict:
    """DenseGCM.scan with the selector against the CPU copy: beliefs within
    TOL_MODEL and the adjacency exactly equal."""
    from gcm_tpu_torch.ops.cuda.sddmm import sddmm_threshold_row

    gpu, cpu = selector_model(kind, "cuda", seed), selector_model(kind, "cpu",
                                                                  seed)
    xs = torch.from_numpy(np.random.default_rng(seed + 20).standard_normal(
        (B, T, 8)).astype(np.float32))
    want, want_state = cpu.scan(xs, cpu.initial_state(B, 8))
    xs_c = xs.cuda()
    before = sddmm_threshold_row.launches
    (got, state), secs = timed(lambda: gpu.scan(xs_c,
                                                gpu.initial_state(B, 8)))
    launched = sddmm_threshold_row.launches - before
    err = float((got.cpu() - want).abs().max())
    check(bool(torch.isfinite(got).all()), f"{kind} scan: non-finite")
    check(err <= TOL_MODEL, f"{kind} scan differs from the CPU copy by {err}")
    check(torch.equal(state.adj.cpu(), want_state.adj)
          and torch.equal(state.num_nodes.cpu(), want_state.num_nodes),
          f"{kind} scan: adjacency differs from the CPU copy")
    return dict(B=B, T=T, max_abs_err_vs_cpu=err, timesteps_per_s=B * T / secs,
                sddmm_launches=launched,
                edges_per_row=float(state.adj.sum() / B / 128))


def euclidean_score64(nodes, num_nodes):
    """EuclideanEdge's score (the batch-mean broadcast) in float64 and in
    the difference form: [B, N]."""
    x = nodes.double()
    curr = x[torch.arange(x.shape[0]), num_nodes.long()]
    d = ((curr[None, :, None, :] - x[:, None, :, :]) ** 2).sum(-1).sqrt()
    return d.mean(dim=1)


def teacher_forced_selector(kind: str, B: int, T: int, obs_scale: float,
                            seed: int = 0) -> dict:
    """EuclideanEdge and the recall chain score with the expanded quadratic
    form of cdist, whose rounding differs between the card and the CPU, so
    one edge may flip where the score lies within rounding of the
    threshold and change every later belief. Each step therefore starts on
    the card from the CPU copy's state: the new adjacency row may differ
    only on lanes whose float64 score lies within 1e-5 of the threshold
    (counted), and beliefs of the rows that agree lie within TOL_MODEL."""
    gpu, cpu = selector_model(kind, "cuda", seed), selector_model(kind, "cpu",
                                                                  seed)
    thr = SELECTOR_THRESHOLDS[kind]
    xs = torch.from_numpy((obs_scale * np.random.default_rng(seed + 30)
                           .standard_normal((B, T, 8))).astype(np.float32))
    state = cpu.initial_state(B, 8)
    worst, near_lanes, flipped, edges = 0.0, 0, 0, 0
    for step in range(T):
        want, nxt = cpu(xs[:, step], state)
        got, got_state = gpu(xs[:, step].cuda(),
                             type(state)(*(t.cuda() for t in state)))
        row = nxt.num_nodes.long() - 1
        b_idx = torch.arange(B)
        near = (euclidean_score64(nxt.nodes, row) - thr).abs() < 1e-5
        diff = got_state.adj.cpu() != nxt.adj
        off_row = diff.clone()
        off_row[b_idx, row] = False
        check(not bool(off_row.any()), f"{kind} step {step}: adjacency "
              "differs off the new row")
        flips = diff[b_idx, row]
        check(not bool((flips & ~near).any()), f"{kind} step {step}: an "
              "edge differs from the CPU copy away from the threshold")
        same = ~flips.any(dim=1)
        if bool(same.any()):
            worst = max(worst, float((got.cpu() - want)[same].abs().max()))
        near_lanes += int(near.sum())
        flipped += int(flips.sum())
        edges += int(nxt.adj[b_idx, row].sum())
        state = nxt
    check(worst <= TOL_MODEL, f"{kind} teacher-forced beliefs differ by "
          f"{worst} > {TOL_MODEL}")
    check(edges > 0, f"{kind}: no edges were made")
    return dict(B=B, T=T, obs_scale=obs_scale, teacher_forced=True,
                max_abs_err_vs_cpu=worst, lanes_near_threshold=near_lanes,
                lanes_flipped=flipped, edges_made=edges)


def selector_phase(card: str, serve_ticks: int = 100, B: int = 32,
                   T: int = 256, T_small: int = 64):
    """The README DenseGCM with the dense selectors this slice ports: the
    kernel-scored CosineEdge and SpatialEdge served and scanned at full
    depth, the others scanned at a smaller depth."""
    row = dict(card=card, graph_size=128)
    with torch.no_grad():
        for kind in ("cosine", "spatial"):
            row[f"serve_{kind}"] = serve_selector(kind, serve_ticks)
            row[f"scan_{kind}"] = scan_selector(kind, B, T)
            check(row[f"scan_{kind}"]["sddmm_launches"] == T,
                  f"{kind} scan: {row[f'scan_{kind}']['sddmm_launches']} "
                  f"sddmm launches, expected {T}")
        for kind in ("dense", "learned"):
            row[f"scan_{kind}"] = scan_selector(kind, B, T_small)
            check(row[f"scan_{kind}"]["sddmm_launches"] == 0,
                  f"{kind}: the sddmm kernel was launched")
        # obs scaled so that distances straddle the threshold of 1.0
        for kind in ("euclidean", "recall_chain"):
            row[f"teacher_forced_{kind}"] = teacher_forced_selector(
                kind, B, T_small, obs_scale=0.25)
        kinds = ("temporal", "cosine", "spatial")
        row["served_tick_in_turns"] = serve_timing(kinds, serve_ticks)
        row["served_kernels_per_tick"] = {
            k: row["served_tick_in_turns"][k]["profile"][
                "device_kernels_per_call"] for k in kinds}
        row["served_device_us_per_tick"] = {
            k: row["served_tick_in_turns"][k]["profile"][
                "device_us_per_call"] for k in kinds}
        row["scan_timesteps_per_s_in_turns"] = scan_timing(kinds, B, T)
    emit("selectors", **row)


# -- phase 8: the SpMM variants and their sweep -------------------------------

def variant_inputs(case, B, N, F, E, seed):
    """x, edges, weights on the card for a variant case: spmm_inputs', and
    for "chunk spanning" 200 edges into sink 7 (two 128-lane chunks of its
    bucket) before the random ones."""
    x, edges, w = spmm_inputs(
        case if case in ("odd", "empty", "hot row", "descending") else "wide",
        B, N, F, E, seed)
    if case == "chunk spanning":
        edges[:, 0, :200] = 7
        edges[:, 1, :200] = np.arange(200) % N
    return (torch.from_numpy(a).cuda() for a in (x, edges, w))


def variant_case(kernel, case, B, N, F, E, mode, seed, main_path):
    """One kernel row of the SpMM variants: the kernel against its plain
    version, beside torch.sparse.mm on the block-diagonal COO of the same
    edges. mode: the pair kernel's precision, the one-hot kernel's dtype
    ("f32" or "bf16") or the per-edge kernel's n_blocks."""
    from gcm_tpu_torch.benchmarks.spmm_variants import (block_diagonal_coo,
                                                        pair_cap)
    from gcm_tpu_torch.ops.cuda import spmm as spmm_mod
    from gcm_tpu_torch.ops.cuda import spmm2, spmm_prefetch, spmm_seg

    x, edges, w = variant_inputs(case, B, N, F, E, seed)
    coo = block_diagonal_coo(edges, w, N)
    n_valid = int(coo.values().numel())
    depth = lanes_per_sink(edges, N)
    shape = dict(case=case, B=B, N=N, F=F, E=E, mode=mode)
    xy = 2 * B * N * F  # x read once, out written once; and the lanes
    if kernel in ("spmm_pairs", "spmm_seg"):
        # pair_cap, raised to the multiple of 128 that holds the fullest
        # bucket (a hot row's): no edge is dropped
        cap = pair_cap(N, E)
        fullest = int(spmm2.bucket_edges_pairs(edges, w, N, cap)[2].max())
        cap = max(cap, -(-fullest // 128) * 128)
    if kernel == "spmm_pairs":
        be, bw, counts = spmm2.bucket_edges_pairs(edges, w, N, cap)
        spmm2.check_bucket_overflow(counts, cap)
        shape["cap"] = cap
        run = (lambda: spmm2.spmm_pairs(x, be, bw, N, cap, mode),
               lambda: spmm2.spmm_pairs_plain(x, be, bw, cap, mode, depth))
        nbytes = 4 * xy + lane_bytes(be[:, 0])
    elif kernel == "spmm_seg":
        be, bw, begin, end, tot = spmm_seg.bucket_edges_segments(edges, w, N,
                                                                 cap)
        spmm2.check_bucket_overflow(tot, cap)
        shape["cap"] = cap
        if case == "clamped tables":  # begin < 0 and end > 128 here and there
            begin.view(-1)[::5] -= 7
            end.view(-1)[3::7] += 40
        # the kernel walks each sink's table segments, which a sink of N or
        # more spills into the next lanes' (as in JAX): the longest walk
        lens = (end.clamp(max=128) - begin.clamp(min=0)).clamp(min=0)
        depth = int(lens.reshape(B, N // 128, -1, 128).sum(2).max())
        run = (lambda: spmm_seg.spmm_seg(x, be, bw, begin, end, N, cap),
               lambda: spmm_seg.spmm_seg_plain(x, be, bw, begin, end, cap,
                                               depth))
        nbytes = 4 * (xy + 2 * begin.numel()) + lane_bytes(be[:, 0])
    elif kernel == "spmm_prefetch":
        # 2E/nblk slots a block, as the sweep; elsewhere lossless (K = E)
        cap = 2 * E // mode if case == "sweep" else None
        sl, src, pw, dropped = spmm_prefetch.bucket_edges_sink_blocks(
            edges, w, N, mode, cap)
        check(not int(dropped.max()), f"prefetch {case}: edges dropped")
        shape["K"] = sl.shape[2]
        run = (lambda: spmm_prefetch.spmm_prefetch_bucketed(x, sl, src, pw,
                                                            N),
               lambda: spmm_prefetch.spmm_prefetch_plain(x, sl, src, pw, N,
                                                         depth))
        nbytes = 4 * xy + lane_bytes(sl)
    else:
        dtype = torch.bfloat16 if mode == "bf16" else torch.float32
        run = (lambda: spmm_mod.spmm_onehot_dtype(x, edges, w, dtype),
               lambda: spmm_mod.spmm_onehot_dtype_plain(x, edges, w, dtype,
                                                        depth))
        nbytes = 4 * xy + lane_bytes(edges[:, 0])
    x2 = x.reshape(B * N, F)
    with torch.no_grad():
        row = kernel_row(
            kernel, shape, main_path, *run,
            library=lambda: torch.sparse.mm(coo, x2).reshape(B, N, F),
            bound=bound_ms(nbytes, 2 * n_valid * F),
            tol=0.0)  # bitwise: both add in the same order
    if case == "empty":
        check(not bool(run[0]().any()), f"{kernel} empty edge list: not zero")
    return row


VARIANT_CASES = [
    # (kernel, case, B, N, F, E, mode, main_path): the sweep's point, odd
    # shapes with sentinels and indices of N or more (defined for all four:
    # dropped or clamped, see each module), and empty edge lists
    ("spmm_pairs", "sweep", 64, 512, 128, 8192, "f32x2", True),
    ("spmm_pairs", "sweep", 64, 512, 128, 8192, "bf16", True),
    ("spmm_pairs", "odd", 3, 256, 13, 600, "f32x2", False),
    ("spmm_pairs", "odd", 3, 256, 13, 600, "bf16", False),
    ("spmm_pairs", "empty", 4, 128, 32, 64, "f32x2", False),
    ("spmm_seg", "sweep", 64, 512, 128, 8192, None, True),
    ("spmm_seg", "odd", 3, 256, 13, 600, None, False),
    ("spmm_seg", "chunk spanning", 2, 128, 32, 300, None, False),
    ("spmm_seg", "empty", 4, 128, 32, 64, None, False),
    ("spmm_prefetch", "sweep", 64, 512, 128, 8192, 4, True),
    ("spmm_prefetch", "sweep", 64, 512, 128, 8192, 8, True),
    ("spmm_prefetch", "drive_r5c", 4, 32, 128, 64, 4, False),
    ("spmm_prefetch", "one block", 2, 512, 64, 2048, 1, False),
    ("spmm_prefetch", "odd", 3, 96, 13, 37, 3, False),
    ("spmm_prefetch", "empty", 4, 128, 32, 64, 4, False),
    ("spmm_onehot_dtype", "sweep", 64, 512, 128, 8192, "f32", True),
    ("spmm_onehot_dtype", "sweep", 64, 512, 128, 8192, "bf16", True),
    ("spmm_onehot_dtype", "odd", 3, 12, 13, 37, "f32", False),
    ("spmm_onehot_dtype", "odd", 3, 12, 13, 37, "bf16", False),
    ("spmm_onehot_dtype", "empty", 4, 128, 32, 64, "bf16", False),
    # the sink-sorted kernels' branches (see SPMM_CASES): a hot row over two
    # passes (the prefetch's second sink block empty), descending sinks at
    # F = 260, eight passes; prefetch at one sink block of 905 rows (the
    # earlier kernel's limit, one tile) and of 4,100 (five tiles, two passes)
    ("spmm_onehot_dtype", "hot row", 2, 256, 130, 9000, "bf16", False),
    ("spmm_onehot_dtype", "descending", 4, 512, 260, 4096, "bf16", False),
    ("spmm_onehot_dtype", "many lanes", 2, 512, 128, 65536, "bf16", False),
    ("spmm_prefetch", "hot row", 2, 256, 130, 9000, 2, False),
    ("spmm_prefetch", "descending", 4, 512, 260, 4096, 4, False),
    ("spmm_prefetch", "one block", 64, 905, 64, 4096, 1, False),
    ("spmm_prefetch", "one block", 64, 4100, 13, 16384, 1, False),
    # the sink-sorted pair kernel's branches, both modes: a hot row over two
    # passes (cap 2,432), descending sinks at F = 260, windows of
    # 10,240 lanes (cap 2,560: two passes), one batch element whose windows
    # plan() splits into four row tiles of 32 rows (F = 64: one column a
    # lane); "odd" above has sources outside their buckets' windows
    ("spmm_pairs", "hot row", 2, 512, 130, 9000, "f32x2", False),
    ("spmm_pairs", "hot row", 2, 512, 130, 9000, "bf16", False),
    ("spmm_pairs", "descending", 4, 512, 260, 4096, "f32x2", False),
    ("spmm_pairs", "descending", 4, 512, 260, 4096, "bf16", False),
    ("spmm_pairs", "two passes", 2, 512, 128, 20480, "f32x2", False),
    ("spmm_pairs", "two passes", 2, 512, 128, 20480, "bf16", False),
    ("spmm_pairs", "row tiles", 1, 256, 64, 2048, "f32x2", False),
    ("spmm_pairs", "row tiles", 1, 256, 64, 2048, "bf16", False),
    # the batched walk's branches: 40 table entries a row (N = 1,024, cap
    # 640: two rounds of 32), a hot row of 2,000 lanes over eight or more
    # chunks, tables with begin < 0 and end > 128 at F = 64, descending
    # sinks at F = 260 (float4 columns; "odd" above takes F = 13, scalar)
    ("spmm_seg", "many entries", 4, 1024, 128, 20480, None, False),
    ("spmm_seg", "hot row", 2, 256, 128, 2000, None, False),
    ("spmm_seg", "clamped tables", 3, 512, 64, 4096, None, False),
    ("spmm_seg", "descending", 4, 512, 260, 4096, None, False),
]


def variant_refusal_phase() -> None:
    """Inputs the variant kernels do not take raise on the card before any
    launch: float64, int64 indices, wrong shapes, non-contiguous or CPU
    tensors, a graph or cap off the 128 grid, an unknown dtype, and a
    tracked input into the forward-only kernel."""
    from gcm_tpu_torch.ops.cuda import spmm as spmm_mod
    from gcm_tpu_torch.ops.cuda import spmm2, spmm_prefetch, spmm_seg

    x, edges, w = variant_inputs("wide", 2, 256, 8, 64, seed=96)
    be, bw, _ = spmm2.bucket_edges_pairs(edges, w, 256, 128)
    se = spmm_seg.bucket_edges_segments(edges, w, 256, 128)[:4]
    sl, src, pw, _ = spmm_prefetch.bucket_edges_sink_blocks(edges, w, 256, 4)
    xt = x.transpose(1, 2).contiguous().transpose(1, 2)  # same shape, strided
    x100 = x[:, :100].contiguous()
    pairs, seg = spmm2.spmm_pairs, spmm_seg.spmm_seg
    bucketed = spmm_prefetch.spmm_prefetch_bucketed
    onehot = spmm_mod.spmm_onehot_dtype
    cases = {
        "pairs_float64": lambda: pairs(x.double(), be, bw.double(), 256, 128),
        "pairs_int64_edges": lambda: pairs(x, be.long(), bw, 256, 128),
        "pairs_wrong_shape": lambda: pairs(x, be, bw[:, :-1], 256, 128),
        "pairs_non_contiguous": lambda: pairs(xt, be, bw, 256, 128),
        "pairs_cpu_weights": lambda: pairs(x, be, bw.cpu(), 256, 128),
        "pairs_nodes_100": lambda: pairs(x100, be, bw, 100, 128),
        "pairs_cap_192": lambda: pairs(x, be[..., :768], bw[..., :768], 256,
                                       192),
        "pairs_precision": lambda: pairs(x, be, bw, 256, 128, "highest"),
        "seg_float64": lambda: seg(x.double(), se[0], se[1].double(),
                                   *se[2:], 256, 128),
        "seg_int64_tables": lambda: seg(x, *se[:2], se[2].long(), se[3], 256,
                                        128),
        "seg_wrong_shape": lambda: seg(x, *se[:3], se[3][:, :, :, :64], 256,
                                       128),
        "seg_non_contiguous": lambda: seg(xt, *se, 256, 128),
        "seg_cap_192": lambda: seg(x, *se, 256, 192),
        "prefetch_float64": lambda: bucketed(x.double(), sl, src,
                                             pw.double(), 256),
        "prefetch_int64_src": lambda: bucketed(x, sl, src.long(), pw, 256),
        "prefetch_wrong_shape": lambda: bucketed(x, sl, src, pw[..., :-1],
                                                 256),
        "prefetch_non_contiguous": lambda: bucketed(xt, sl, src, pw, 256),
        "prefetch_requires_grad": lambda: spmm_prefetch.spmm_prefetch(
            x.clone().requires_grad_(), edges, w),
        "onehot_float64": lambda: onehot(x.double(), edges, w.double(),
                                         torch.bfloat16),
        "onehot_int64_edges": lambda: onehot(x, edges.long(), w,
                                             torch.bfloat16),
        "onehot_non_contiguous": lambda: onehot(xt, edges, w, torch.bfloat16),
        "onehot_float16": lambda: onehot(x, edges, w, torch.float16),
    }
    wrappers = (pairs, seg, spmm_prefetch.spmm_prefetch, onehot,
                spmm_mod.spmm_edge_list)
    refused = refuse_all(cases, wrappers, (ValueError, NotImplementedError))
    check("no_grad" in refused["prefetch_requires_grad"],
          "a tracked input into spmm_prefetch was not refused as such")


def win_case(case, B, N, F, cap, mode, seed, main_path):
    """spmm_win against its plain version beside torch.sparse.mm on the
    block-diagonal COO of the lanes that stay in their windows. "sweep":
    the sweep's uniform edges bucketed at cap; "descending": n_win * cap
    edges with sinks falling with the lane index, bucketed (each segment
    full, its sinks descending); "odd" and "hot row": raw lanes (sinks
    outside their segment's window, sentinels, indices of N or more; every
    sink 7, so segment 0 holds one hot row) as the layout; "empty": all
    lanes -1."""
    from gcm_tpu_torch.benchmarks.spmm_variants import block_diagonal_coo
    from gcm_tpu_torch.ops.cuda import spmm_win as win_mod

    n_win = N // 128
    if case in ("sweep", "descending"):
        x, edges, w = variant_inputs(
            "wide" if case == "sweep" else case, B, N, F,
            8192 if case == "sweep" else n_win * cap, seed)
        be, bw, counts = win_mod.bucket_by_sink_window(edges, w, N, cap=cap)
        overflow = win_mod.window_overflow(counts, cap)
        check(overflow is None, f"spmm_win {case}: {overflow}")
    else:
        x, be, bw = variant_inputs(case, B, N, F, n_win * cap, seed)
    kept = win_mod.in_window(be, N, cap)
    coo = block_diagonal_coo(kept, bw, N)
    depth = lanes_per_sink(kept, N)
    dtype = torch.bfloat16 if mode == "bf16" else torch.float32
    x2 = x.reshape(B * N, F)
    with torch.no_grad():
        row = kernel_row(
            "spmm_win", dict(case=case, B=B, N=N, F=F, cap=cap, mode=mode),
            main_path,
            kernel=lambda: win_mod.spmm_win(x, be, bw, N, cap, dtype),
            plain=lambda: win_mod.spmm_win_plain(x, be, bw, N, cap, dtype,
                                                 depth),
            library=lambda: torch.sparse.mm(coo, x2).reshape(B, N, F),
            bound=bound_ms(4 * 2 * B * N * F + lane_bytes(be[:, 0]),
                           2 * int(coo.values().numel()) * F),
            tol=0.0)  # bitwise: both add in lane order
    if case == "empty":
        check(not bool(row["max_abs_err"]) and not bool(
            win_mod.spmm_win(x, be, bw, N, cap, dtype).any()),
              "spmm_win empty lanes: not zero")
    return row


WIN_CASES = [
    # (case, B, N, F, cap, mode, main_path): the sweep's point at the JAX
    # sweep's cap E/2, an odd shape (cap 500: one lane block, not a multiple
    # of 128), an empty list
    ("sweep", 64, 512, 128, 4096, "f32", True),
    ("sweep", 64, 512, 128, 4096, "bf16", True),
    ("odd", 3, 256, 13, 500, "f32", False),
    ("odd", 3, 256, 13, 500, "bf16", False),
    ("empty", 4, 128, 32, 64, "f32", False),
    # the sink-sorted kernel's branches in window mode: a hot row over two
    # passes (cap 8,704), full segments of descending sinks at F = 260 in
    # both modes
    ("hot row", 2, 256, 130, 8704, "f32", False),
    ("descending", 4, 512, 260, 1024, "f32", False),
    ("descending", 4, 512, 260, 1024, "bf16", False),
]


def gather_inputs(kernel, case, seed):
    """(x, idx) on the card. "probe": the JAX probe's own inputs; "wide":
    rows gather the sweep's messages (x the sweep's [B*N, F] = [32768, 128]
    node rows, idx b*N + src of its B*E = 524,288 edges), lanes gather
    [32768, 128] of [32768, 512]; "out of range": indices past either end
    (-D-36, -D, -1, D+6 among them, D the gathered dimension); "middle":
    rows gather 65,536 random rows of [32768, 128], where take_rows_loop's
    runs are neither 1 row nor 32."""
    rng = np.random.default_rng(seed)
    lanes = kernel == "take_lanes"
    if case == "probe":
        if lanes:
            x = np.arange(8 * 512, dtype=np.float32).reshape(8, 512)
            idx = np.tile(np.array([[5, 3, 500, 0, 1, 2, 33, 7] * 16],
                                   np.int32), (8, 1))
        else:
            x = np.arange(64 * 128, dtype=np.float32).reshape(64, 128)
            idx = np.array([5, 3, 60, 0, 1, 2, 33, 7] * 16, np.int32)
    elif case == "middle":
        x = rng.standard_normal((32768, 128)).astype(np.float32)
        idx = rng.integers(0, 32768, 65536).astype(np.int32)
    elif case == "wide":
        if lanes:
            x = rng.standard_normal((32768, 512)).astype(np.float32)
            idx = rng.integers(0, 512, (32768, 128)).astype(np.int32)
        else:
            B, N, F, E = 64, 512, 128, 8192
            x = rng.standard_normal((B * N, F)).astype(np.float32)
            src = rng.integers(0, N, (B, E))
            idx = (src + N * np.arange(B)[:, None]).astype(np.int32).ravel()
    else:
        R, C = (8, 512) if lanes else (64, 128)
        x = rng.standard_normal((R, C)).astype(np.float32)
        D = C if lanes else R
        idx = rng.integers(-D - 40, D + 40, (R, 128) if lanes else 128)
        idx.flat[:4] = [-D - 36, -D, -1, D + 6]
        idx = idx.astype(np.int32)
    return torch.from_numpy(x).cuda(), torch.from_numpy(idx).cuda()


def gather_case(kernel, case, seed, main_path):
    """A gather against its plain version, bitwise (NaN where NaN), beside
    index_select (rows) or torch.gather (lanes) on the index wrapped and
    clamped into range (a library gather asserts on the card past the
    end)."""
    from gcm_tpu_torch.ops.cuda import gather as gather_mod

    x, idx = gather_inputs(kernel, case, seed)
    R, C = x.shape
    fn = getattr(gather_mod, kernel)
    plain = getattr(gather_mod, f"{kernel}_plain")
    lanes = kernel == "take_lanes"
    D = C if lanes else R
    i = idx.long()
    wrapped = torch.where(i < 0, i + D, i)
    safe = wrapped.clamp(0, D - 1)
    # the bytes of x the indices touch (an index past either end of
    # take_rows / take_lanes reads nothing): whole rows, or the distinct
    # 32-byte sectors of the lanes gathered
    touched = safe if kernel == "take_rows_loop" else wrapped
    ok = (touched >= 0) & (touched < D)
    if lanes:
        library = lambda: torch.gather(x, 1, safe)  # noqa: E731
        rows = torch.arange(R, device=x.device)[:, None]
        sectors = ((rows * C + touched) // 8)[ok]
        x_bytes = 32 * int(torch.unique(sectors).numel())
    else:
        safe = safe.int()
        library = lambda: x.index_select(0, safe)  # noqa: E731
        x_bytes = 4 * C * int(torch.unique(touched[ok]).numel())
    nbytes = x_bytes + 4 * idx.numel() * (2 if lanes else 1 + C)
    row = kernel_row(
        kernel, dict(case=case, x=[R, C], idx=list(idx.shape)), main_path,
        kernel=lambda: fn(x, idx), plain=lambda: plain(x, idx),
        library=library, bound=bound_ms(nbytes, 0), tol=0.0, nan_fills=True)
    got, want = fn(x, idx), plain(x, idx)
    check(bitwise_equal(got, want),
          f"{kernel} {case}: not bit for bit the plain version's")
    fills = int(want.isnan().sum())
    check((fills > 0) == (case == "out of range"
                          and kernel != "take_rows_loop"),
          f"{kernel} {case}: {fills} NaN fills")
    return row


GATHER_CASES = [
    # (kernel, case, main_path): the probe's own inputs (what the sweep's
    # probe runs), the sweep's message gather, indices past either end
    (kernel, case, case == "probe")
    for kernel in ("take_rows", "take_lanes", "take_rows_loop")
    for case in ("probe", "wide", "out of range")
] + [("take_rows_loop", "middle", False)]


def win_gather_refusal_phase() -> None:
    """Inputs spmm_win and the gathers do not take raise on the card before
    any launch: float64, int64 indices, wrong shapes, non-contiguous or CPU
    tensors, a graph off the 128 grid, a cap above 512 off the 512 grid,
    an unknown dtype and a tracked input."""
    from gcm_tpu_torch.ops.cuda import gather as gather_mod
    from gcm_tpu_torch.ops.cuda import spmm_win as win_mod

    x, edges, w = variant_inputs("wide", 2, 256, 8, 64, seed=94)
    be, bw, _ = win_mod.bucket_by_sink_window(edges, w, 256, cap=64)
    be6, bw6, _ = win_mod.bucket_by_sink_window(edges, w, 256, cap=600)
    xt = x.transpose(1, 2).contiguous().transpose(1, 2)
    win = win_mod.spmm_win
    rows, lanes = gather_mod.take_rows, gather_mod.take_lanes
    loop = gather_mod.take_rows_loop
    g = x[0]
    gi = torch.zeros(16, dtype=torch.int32, device="cuda")
    gl = torch.zeros((256, 4), dtype=torch.int32, device="cuda")
    cases = {
        "win_float64": lambda: win(x.double(), be, bw.double(), 256, 64),
        "win_int64_edges": lambda: win(x, be.long(), bw, 256, 64),
        "win_wrong_shape": lambda: win(x, be, bw[:, :-1], 256, 64),
        "win_non_contiguous": lambda: win(xt, be, bw, 256, 64),
        "win_cpu_weights": lambda: win(x, be, bw.cpu(), 256, 64),
        "win_nodes_200": lambda: win(x[:, :200].contiguous(), be, bw, 200,
                                     64),
        "win_cap_600": lambda: win(x, be6, bw6, 256, 600),
        "win_float16": lambda: win(x, be, bw, 256, 64, torch.float16),
        "win_requires_grad": lambda: win(x.clone().requires_grad_(), be, bw,
                                         256, 64),
        "rows_float64": lambda: rows(g.double(), gi),
        "rows_int64_idx": lambda: rows(g, gi.long()),
        "rows_non_contiguous": lambda: rows(g.t(), gi),
        "rows_cpu_idx": lambda: rows(g, gi.cpu()),
        "rows_3d_x": lambda: rows(x, gi),
        "lanes_float64": lambda: lanes(g.double(), gl),
        "lanes_int64_idx": lambda: lanes(g, gl.long()),
        "lanes_rows_differ": lambda: lanes(g, gl[:7]),
        "lanes_non_contiguous_idx": lambda: lanes(
            g, gl.t().contiguous().t()),
        "loop_float64": lambda: loop(g.double(), gi),
        "loop_int64_idx": lambda: loop(g, gi.long()),
        "loop_non_contiguous": lambda: loop(g.t(), gi),
        "loop_requires_grad": lambda: loop(g.clone().requires_grad_(), gi),
    }
    refused = refuse_all(cases, (win, rows, lanes, loop),
                         (ValueError, NotImplementedError))
    for case in ("win_requires_grad", "loop_requires_grad"):
        check("no_grad" in refused[case], f"{case}: not refused as tracked")


def gradient_phase(card: str, B=64, N=512, F=128, E=8192, seed=95) -> None:
    """spmm_pairs and spmm_seg forward and backward on the card against
    autograd through their plain versions on the card: out within
    TOL_KERNEL, dx and dw within TOL_MODEL; one forward and backward
    launches exactly two spmm_pairs and one edge_weight_grad, or one
    spmm_seg, one spmm_edge_list and one edge_weight_grad."""
    from gcm_tpu_torch.benchmarks.spmm_variants import pair_cap
    from gcm_tpu_torch.ops.cuda import spmm as spmm_mod
    from gcm_tpu_torch.ops.cuda import spmm2, spmm_seg
    from gcm_tpu_torch.ops.cuda.edge_grad import edge_weight_grad

    x, edges, w = variant_inputs("wide", B, N, F, E, seed)
    cot = torch.randn((B, N, F), generator=torch.Generator().manual_seed(
        seed)).cuda()
    cap = pair_cap(N, E)
    be, bw, counts = spmm2.bucket_edges_pairs(edges, w, N, cap)
    se = spmm_seg.bucket_edges_segments(edges, w, N, cap)
    spmm2.check_bucket_overflow(counts, cap)
    cases = {
        "spmm_pairs": (bw, lambda a, b: spmm2.spmm_pairs(a, be, b, N, cap),
                       lambda a, b: spmm2.spmm_pairs_plain(a, be, b, cap),
                       {spmm2.spmm_pairs: 2, edge_weight_grad: 1}),
        "spmm_seg": (se[1],
                     lambda a, b: spmm_seg.spmm_seg(a, se[0], b, *se[2:4], N,
                                                    cap),
                     lambda a, b: spmm_seg.spmm_seg_plain(a, se[0], b,
                                                          *se[2:4], cap),
                     {spmm_seg.spmm_seg: 1, spmm_mod.spmm_edge_list: 1,
                      edge_weight_grad: 1}),
    }
    row = dict(card=card, B=B, N=N, F=F, E=E, cap=cap)
    every = (spmm2.spmm_pairs, spmm_seg.spmm_seg, spmm_mod.spmm_edge_list,
             edge_weight_grad)
    for name, (weights, fn, plain, want_launches) in cases.items():
        grads = []
        for f in (fn, plain):
            a = x.clone().requires_grad_()
            b = weights.clone().requires_grad_()
            before = [g.launches for g in every]
            out = f(a, b)
            (out * cot).sum().backward()
            torch.cuda.synchronize()
            launched = {g: g.launches - n for g, n in zip(every, before)}
            grads.append((out.detach(), a.grad, b.grad, launched))
        (out, dx, dw, launched), (p_out, p_dx, p_dw, p_launched) = grads
        counts = {g.__name__: n for g, n in launched.items()}
        check(launched == {g: want_launches.get(g, 0) for g in every},
              f"{name}: launches per forward and backward {counts}")
        check(not any(p_launched.values()), f"{name}: the plain version "
              "launched a kernel")
        errs = {k: float((u - v).abs().max()) for k, u, v in (
            ("out", out, p_out), ("dx", dx, p_dx), ("dw", dw, p_dw))}
        check(errs["out"] <= TOL_KERNEL and errs["dx"] <= TOL_MODEL
              and errs["dw"] <= TOL_MODEL, f"{name} gradients: {errs}")
        check(float(dw.abs().sum()) > 0, f"{name}: dw is zero")
        row[name] = dict(max_abs_err=errs, launches=counts)
    emit("gradients", **row)


# -- phase 9: training both cores ---------------------------------------------

def train_run(label, make_model, make_step, batch, want_launches, steps, lr):
    """`steps` Adam steps of a model on the card and of its CPU copy (the
    same numpy weights) on one batch: the loss and every parameter's
    gradient within TOL_MODEL of the copy's at each step, the kernels
    launched per forward + backward exactly `want_launches`, a finite loss
    that falls; wall µs per step (synchronised) and, over one more step,
    where its time goes."""
    from gcm_tpu_torch.ops.cuda.dense_gconv import fused_dense_graph_conv
    from gcm_tpu_torch.ops.cuda.edge_grad import edge_weight_grad
    from gcm_tpu_torch.ops.cuda.fused_gnn import (fused_dense_gnn,
                                                  fused_dense_gnn_bwd)
    from gcm_tpu_torch.ops.cuda.spmm import spmm_edge_list
    from gcm_tpu_torch.ops.cuda.spmm_slots import spmm_slots

    counted = (fused_dense_gnn, fused_dense_gnn_bwd, fused_dense_graph_conv,
               spmm_edge_list, spmm_slots, edge_weight_grad)
    gpu, cpu = make_model("cuda"), make_model("cpu")
    gpu_step = make_step(gpu, torch.optim.Adam(gpu.parameters(), lr=lr))
    cpu_step = make_step(cpu, torch.optim.Adam(cpu.parameters(), lr=lr))
    batch_c = [t.cuda() for t in batch]
    losses, step_us, worst = [], [], 0.0
    for i in range(steps):
        before = [f.launches for f in counted]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = gpu_step(*batch_c)
        torch.cuda.synchronize()
        step_us.append(1e6 * (time.perf_counter() - t0))
        launched = {f.__name__: f.launches - n
                    for f, n in zip(counted, before) if f.launches - n}
        check(launched == want_launches, f"{label} step {i}: launches "
              f"{launched}, expected {want_launches}")
        want = cpu_step(*batch)
        check(bool(torch.isfinite(loss)), f"{label} step {i}: loss {loss}")
        errs = [abs(float(loss) - float(want))]
        for (name, p), (_, q) in zip(gpu.named_parameters(),
                                     cpu.named_parameters()):
            check(bool(torch.isfinite(p.grad).all()),
                  f"{label} step {i}: non-finite grad of {name}")
            errs.append(float((p.grad.cpu() - q.grad).abs().max()))
        worst = max(worst, *errs)
        losses.append(float(loss))
    check(worst <= TOL_MODEL, f"{label}: loss or grads differ from the CPU "
          f"copy by {worst} > {TOL_MODEL}")
    check(losses[-1] < losses[0], f"{label}: the loss did not fall: "
          f"{losses}")
    return dict(losses=losses, max_abs_err_vs_cpu=worst,
                launches_per_step=launched, us_per_step=step_us,
                us_per_step_median=statistics.median(step_us),
                profile_one_step=profile_calls(lambda: gpu_step(*batch_c),
                                               n=1))


def train_phase(card: str, seed: int = 0, B: int = 32, dense_T: int = 160,
                sparse_T: int = 128, steps: int = 3, lr: float = 1e-3):
    """Training both README cores at full width through
    make_dense_supervised_step / make_sparse_supervised_step: the dense
    core at B=32 over T=160 on a 128-node graph (the ring wraps), one
    fused_dense_gnn launch and one fused_dense_gnn_bwd call a timestep (the
    count is of calls: each launches two kernels, the backward and the sum
    of its parameter partials); the sparse core
    over one window of [32, 128, 8], default (two spmm_edge_list launches
    forward, two for dx backward; its edge weights carry no gradient) and
    aggregation="slots" (two spmm_slots forward, two spmm_edge_list
    backward); and the learned sparse core (the same with a deterministic
    sparse LearnedEdge, 3 edge samples), whose edge weights carry the
    gradient into the selector, so each layer's backward also launches
    edge_weight_grad: default and slots with slot_k=3."""
    from gcm_tpu_torch import (SparseLearnedEdge, load_jax_params,
                               make_dense_supervised_step,
                               make_sparse_supervised_step, readme_dense_gcm,
                               readme_sparse_gcm)

    obs_dim, hidden = 8, 32
    params = numpy_params(seed, obs_dim, hidden)
    rng = np.random.default_rng(seed + 3)

    def batch(T):
        return [torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)) for shape in ((B, T, obs_dim), (B, T, hidden))]

    def loaded(build, **kw):
        def make(device):
            m = build(obs_size=obs_dim, hidden=hidden, device=device, **kw)
            load_jax_params(m, params)
            return m
        return make

    row = dict(card=card, B=B, lr=lr, steps=steps)
    row["dense"] = dict(T=dense_T, graph_size=128, **train_run(
        "dense", loaded(readme_dense_gcm), make_dense_supervised_step,
        batch(dense_T), {"fused_dense_gnn": dense_T,
                         "fused_dense_gnn_bwd": dense_T}, steps, lr))
    taus = torch.full((B,), sparse_T, dtype=torch.int32)
    for agg, kw, want in (
            ("default", {}, {"spmm_edge_list": 4}),
            ("slots", dict(aggregation="slots", slot_k=1),
             {"spmm_slots": 2, "spmm_edge_list": 2})):
        row[f"sparse_{agg}"] = dict(T=sparse_T, graph_size=128, **train_run(
            f"sparse {agg}", loaded(readme_sparse_gcm, **kw),
            make_sparse_supervised_step, batch(sparse_T) + [taus], want,
            steps, lr))

    def learned(**kw):
        """The README sparse core with a deterministic sparse LearnedEdge
        (3 edge samples): its edge weights carry the gradient."""
        def make(device):
            m = loaded(readme_sparse_gcm, **kw)(device)
            m.edge_selectors = SparseLearnedEdge(
                obs_dim, deterministic=True, num_edge_samples=3,
                device=device, generator=torch.Generator().manual_seed(
                    seed + 5))
            return m
        return make

    for agg, kw, want in (
            ("default", {}, {"spmm_edge_list": 4, "edge_weight_grad": 2}),
            ("slots", dict(aggregation="slots", slot_k=3),
             {"spmm_slots": 2, "spmm_edge_list": 2, "edge_weight_grad": 2})):
        row[f"learned_{agg}"] = dict(T=sparse_T, graph_size=128, **train_run(
            f"learned {agg}", learned(**kw), make_sparse_supervised_step,
            batch(sparse_T) + [taus], want, steps, lr))
    emit("train", **row)


def sweep_phase(card: str) -> None:
    """The SpMM variant sweep as its script runs it: the gather probe, every
    gather "ok", then every row at its full width (B=64, N=512, E=8192,
    F=128), every kernel row within its check, and no JAX row left out."""
    from gcm_tpu_torch.benchmarks.spmm_variants import (probe_dynamic_gather,
                                                        run_sweep)

    probe = probe_dynamic_gather()
    check(set(probe.values()) == {"ok"}, f"gather probe: {probe}")
    out = run_sweep()
    errors = {k: r["error"] for k, r in out["results"].items()
              if "error" in r and r["kernel"]}
    check(not errors, f"sweep rows failed: {errors}")
    check(len(out["results"]) == 15, "the sweep ran "
          f"{len(out['results'])} rows, expected 15")
    check(out["not_ported"] == [], f"not ported: {out['not_ported']}")
    emit("sweep", card=card, probe=probe, **out)


# -- phase 11: the cores' remaining options -------------------------------

def learned_core(device: str, seed: int, **kw):
    """benchmarks/profile_sparse.py's learned core: SparseGCM over 32-wide
    observations (no preprocessor), two GraphConv(32, 32) + tanh, graph 256,
    2,048 edge slots, max_hops 2, a deterministic sparse LearnedEdge with 3
    edge samples and a window of 32. The weights come from a torch
    Generator seeded with `seed`, the same on every device."""
    from gcm_tpu_torch import (GraphConv, SparseGCM, SparseGNN,
                               SparseLearnedEdge)

    g = torch.Generator().manual_seed(seed)
    gnn = SparseGNN([GraphConv(32, 32, device=device, generator=g),
                     torch.tanh,
                     GraphConv(32, 32, device=device, generator=g),
                     torch.tanh])
    sel = SparseLearnedEdge(32, deterministic=True, num_edge_samples=3,
                            window=32, device=device, generator=g)
    return SparseGCM(gnn, graph_size=256, max_edges=2048, max_hops=2,
                     edge_selectors=sel, device=device, **kw)


def cutoff_margins(sel):
    """Wraps sel._soft to record the smallest |soft - 1/(1+S)| over the
    candidates of each call (a near tie at the cutoff could keep an edge on
    one device and drop it on another). Returns the list it appends to."""
    seen, soft_fn = [], sel._soft
    cutoff = 1.0 / (1 + sel.num_edge_samples)

    def recording(logits, cand, generator, noise):
        soft, tau = soft_fn(logits, cand, generator, noise)
        seen.append(float((soft - cutoff).abs()[cand].min()))
        return soft, tau

    sel._soft = recording
    return seen


def options_learned(row, seed, B=8, T=256, window=32):
    from gcm_tpu_torch.ops.cuda.spmm_slots import spmm_slots

    xs = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (B, T, 32)).astype(np.float32))
    xs_c = xs.cuda()
    full = torch.full((B,), window, dtype=torch.int32)
    out = {}
    for label, kw in (("emit", dict(emit=True)), ("grid", dict(emit=False)),
                      ("slots", dict(emit=True, aggregation="slots",
                                     slot_k=3))):
        gpu, cpu = learned_core("cuda", seed, **kw), learned_core("cpu",
                                                                  seed, **kw)
        margins = cutoff_margins(gpu.edge_selectors)
        want, want_state = run_windows(cpu, xs, full,
                                       cpu.initial_state(B, 32), window)
        before = spmm_slots.launches
        got, state = run_windows(gpu, xs_c, full.cuda(),
                                 gpu.initial_state(B, 32), window)
        launched = spmm_slots.launches - before
        err = sparse_close(f"learned core, {label}", got, want, state,
                           want_state)
        del gpu.edge_selectors._soft  # the class's method again
        _, secs = timed(lambda: run_windows(gpu, xs_c, full.cuda(),
                                            gpu.initial_state(B, 32), window))
        out[label] = (got, state)
        row[f"learned_{label}"] = dict(
            max_abs_err_vs_cpu=err, min_cutoff_margin=min(margins),
            edges=int(state.num_edges.sum()),
            timesteps_per_s=B * T / secs, spmm_slots_launches=launched)
    check(torch.equal(out["emit"][1].edges, out["grid"][1].edges),
          "learned core: emit and grid paths give different edges")
    check(torch.equal(out["slots"][1].edges, out["emit"][1].edges),
          "learned core: slots and default give different edges")
    err = float((out["slots"][0] - out["emit"][0]).abs().max())
    check(err <= TOL_MODEL, f"learned core: slots and default differ by "
          f"{err} > {TOL_MODEL}")
    row["learned_core"] = dict(
        B=B, T=T, F=32, graph_size=256, max_edges=2048, max_hops=2,
        window=window, num_edge_samples=3, emit_vs_grid_edges_equal=True,
        slots_vs_default_max_abs_err=err)
    gpu = learned_core("cuda", seed, emit=True)
    state = run_windows(gpu, xs_c[:, :T // 2], full.cuda(),
                        gpu.initial_state(B, 32), window)[1]
    row["learned_core"]["profile_one_window"] = profile_calls(
        lambda: gpu(xs_c[:, T // 2:T // 2 + window], full.cuda(), state))


def readme_with(device, seed, params, **kw):
    """The README sparse core (readme_sparse_gcm's shapes, `params`'
    weights) with the selectors and options of kw."""
    from gcm_tpu_torch import SparseGCM, load_jax_params, readme_sparse_gcm

    base = readme_sparse_gcm(obs_size=8, device=device, seed=seed)
    load_jax_params(base, params)
    return SparseGCM(base.gnn, preprocessor=base.preprocessor,
                     graph_size=128, max_edges=kw.pop("max_edges", 2048),
                     device=device, **kw)


def options_selectors(row, seed, B=32, T=128, window=32):
    from gcm_tpu_torch import (PositionalEncoding, SparseEdgeChain,
                               SparseLearnedEdge, SpatialKNNEdge,
                               SpatialRadiusEdge, TemporalEdge)

    params = numpy_params(seed, 8)
    rng = np.random.default_rng(seed + 1)
    xs = torch.from_numpy(rng.standard_normal((B, T, 8)).astype(np.float32))
    xs[..., :2] *= 0.3  # positions where the radius cuts
    dones = torch.from_numpy(rng.random((B, T)) < 0.03)
    full = torch.full((B,), window, dtype=torch.int32)

    def pe(device):
        return PositionalEncoding(256, "add", feat_dim=32, device=device)

    cases = {
        "radius": lambda d: dict(edge_selectors=SpatialRadiusEdge(
            slice(0, 2), 0.25)),
        "knn": lambda d: dict(edge_selectors=SpatialKNNEdge(slice(0, 2),
                                                            k=4)),
        "chain": lambda d: dict(edge_selectors=SparseEdgeChain([
            TemporalEdge([1]), SpatialRadiusEdge(slice(0, 2), 0.25)])),
        "pe_dones": lambda d: dict(edge_selectors=TemporalEdge([1]),
                                   positional_encoder=pe(d)),
        "aux": lambda d: dict(edge_selectors=TemporalEdge([1]),
                              aux_edge_selectors=TemporalEdge([2, 3]),
                              positional_encoder=pe(d)),
        "hop_cap_auto": lambda d: dict(edge_selectors=TemporalEdge([1]),
                                       max_hops=2, hop_cap="auto"),
    }
    for name, make in cases.items():
        gpu = readme_with("cuda", seed, params, **make("cuda"))
        cpu = readme_with("cpu", seed, params, **make("cpu"))
        d = dones if name == "pe_dones" else None
        want, want_state = run_windows(cpu, xs, full,
                                       cpu.initial_state(B, 8), window, d)
        got, state = run_windows(gpu, xs.cuda(), full.cuda(),
                                 gpu.initial_state(B, 8), window,
                                 None if d is None else d.cuda())
        err = sparse_close(name, got, want, state, want_state)
        row[name] = dict(max_abs_err_vs_cpu=err,
                         edges=int(state.num_edges.sum()))
        check(int(state.num_edges.min()) > 0, f"{name}: no edges")
    # hop_cap="auto" keeps the masked path on the card (no compaction, so
    # no hop_overflow count), as the gate phase's times say it should
    auto = readme_with("cuda", seed, params, edge_selectors=TemporalEdge([1]),
                       max_hops=2, hop_cap="auto")
    aux = auto(xs[:, :window].cuda(), full.cuda(), auto.initial_state(B, 8),
               return_aux=True)[2]
    check("hop_overflow" not in aux, "hop_cap='auto' compacted")
    row["hop_cap_auto"]["path"] = "masked"

    # the stochastic learned selector: noise from a CPU generator handed to
    # both copies (grid path: logits [B, t, 128]); on the card, a Generator
    # gives the same beliefs and edges bitwise for one seed
    def stochastic(device):
        return readme_with(device, seed, params, edge_selectors=(
            SparseLearnedEdge(8, num_edge_samples=3, device=device,
                              generator=torch.Generator().manual_seed(seed))))

    gpu, cpu = stochastic("cuda"), stochastic("cpu")
    from gcm_tpu_torch.utils.ste import sample_gumbel

    noise = sample_gumbel((B, window, 128), torch.Generator().manual_seed(7))
    with torch.no_grad():
        want, want_state = cpu(xs[:, :window], full, cpu.initial_state(B, 8),
                               noise={"edge_selectors": noise})
        got, state = gpu(xs[:, :window].cuda(), full.cuda(),
                         gpu.initial_state(B, 8),
                         noise={"edge_selectors": noise.cuda()})
        err = sparse_close("stochastic learned", got, want, state,
                           want_state)
        runs = []
        for s in (11, 11, 12):
            g = torch.Generator(device="cuda").manual_seed(s)
            out, state = run_windows(gpu, xs.cuda(), full.cuda(),
                                     gpu.initial_state(B, 8), window,
                                     generator=g)
            runs.append((out, state.edges))
    check(all(torch.equal(a, b) for a, b in zip(runs[0], runs[1])),
          "stochastic learned: one seed is not bitwise repeatable")
    check(not torch.equal(runs[0][1], runs[2][1]),
          "stochastic learned: two seeds give the same edges")
    row["stochastic_learned"] = dict(max_abs_err_vs_cpu=err,
                                     repeatable_per_seed=True)


def options_dense(row, seed, B=32, T=256, gcn_T=64):
    from gcm_tpu_torch import (MLP, DenseGCM, DenseGCNConv, DenseGNN, Linear,
                               TemporalBackedge, readme_dense_gcm)

    xs = torch.from_numpy(np.random.default_rng(seed + 2).standard_normal(
        (B, T, 8)).astype(np.float32))

    def pooled(device):
        base = readme_dense_gcm(obs_size=8, device=device, seed=seed)
        return DenseGCM(base.gnn, preprocessor=base.preprocessor,
                        edge_selectors=base.edge_selectors, graph_size=128,
                        pooled=True, validate=True, device=device)

    def gcn(device):
        g = torch.Generator().manual_seed(seed)
        gnn = DenseGNN([DenseGCNConv(32, 32, device=device, generator=g),
                        torch.tanh,
                        DenseGCNConv(32, 32, device=device, generator=g),
                        torch.tanh])
        return DenseGCM(gnn, preprocessor=MLP([Linear(8, 32, device=device,
                                                      generator=g)]),
                        edge_selectors=TemporalBackedge([1]), graph_size=128,
                        device=device)

    for name, make, steps in (("pooled", pooled, T), ("gcn_conv", gcn,
                                                      gcn_T)):
        gpu, cpu = make("cuda"), make("cpu")
        with torch.no_grad():
            want, want_state = cpu.scan(xs[:, :steps], cpu.initial_state(B, 8))
            got, state = gpu.scan(xs[:, :steps].cuda(),
                                  gpu.initial_state(B, 8))
        check(bool(torch.isfinite(got).all()), f"{name}: non-finite")
        err = float((got.cpu() - want).abs().max())
        check(err <= TOL_MODEL, f"{name}: differs from the CPU copy by {err}")
        check(torch.equal(state.adj.cpu(), want_state.adj),
              f"{name}: adjacency differs from the CPU copy")
        row[name] = dict(T=steps, shape=list(got.shape),
                         max_abs_err_vs_cpu=err)
    check(row["pooled"]["shape"] == [B, T, 128, 32], "pooled: shape")


def options_phase(card: str, seed: int = 0):
    """The options of both cores the earlier phases do not drive, each
    against a CPU copy with the same weights (beliefs within 1e-4; edge
    lists, t and num_edges exactly equal): profile_sparse's learned core in
    windows of 32 (emit, grid, slots); the README sparse core with the
    spatial selectors, a chain, a positional encoder under dones, an aux
    selector, hop_cap="auto" and the stochastic learned selector (noise
    handed to both; a Generator bitwise repeatable per seed on the card);
    a pooled README DenseGCM (validate=True) scanned over [32, 256, 8]; a
    DenseGCNConv stack at README widths."""
    row = dict(card=card)
    with torch.no_grad():
        options_learned(row, seed)
        options_selectors(row, seed)
        options_dense(row, seed)
    emit("options", **row)


# -- phase 12: the dispatch gates ---------------------------------------------

def filled_state(model, B, F, T0, hops, seed):
    """A state whose first T0 rows hold random nodes joined by the temporal
    edges of `hops`, as a run of that selector would leave them."""
    from gcm_tpu_torch import sparse_state_from_numpy

    N, E = model.graph_size, model.max_edges
    rng = np.random.default_rng(seed)
    nodes = np.zeros((B, N, F), np.float32)
    nodes[:, :T0] = rng.standard_normal((B, T0, F))
    pairs = [(i, i - h) for i in range(T0) for h in sorted(hops,
                                                           reverse=True)
             if i - h >= 0]
    edges = np.full((B, 2, E), -1, np.int32)
    edges[:, :, :len(pairs)] = np.array(pairs, np.int32).T[None]
    weights = np.zeros((B, E), np.float32)
    weights[:, :len(pairs)] = 1.0
    return sparse_state_from_numpy(
        (nodes, edges, weights, np.full(B, T0, np.int32),
         np.full(B, len(pairs), np.int32)), model.device)


def gate_phase(card: str, seed: int = 0):
    """The two dispatch gates on the card, each path's forward window timed
    by time_ms (CUDA events, median of 5 rounds of 10 calls: call_ms what
    a caller waits, device_ms the device's work): the learned selector's
    emit path against its grid path at benchmarks/gate_hygiene.py's point
    (B=32, obs 8, hidden 32, windows of 32, window 16) for N in 128..1024;
    hop_cap compaction (cap 32) against the masked max_hops path at
    benchmarks/hop_compact.py's workload (B=16, tau 8, two GraphConv(F, F)
    + tanh, max_hops 2, TemporalEdge([1, 2])) for N in 256..4096 at F = 128
    and 32. Each pair also gives the same beliefs (1e-4)."""
    from gcm_tpu_torch import (MLP, GraphConv, Linear, SparseGCM, SparseGNN,
                               SparseLearnedEdge, TemporalEdge)

    row = dict(card=card, emit=[], hop_cap=[])
    rng = np.random.default_rng(seed)

    def gnn(F, g):
        return SparseGNN([GraphConv(F, F, device="cuda", generator=g),
                          torch.tanh,
                          GraphConv(F, F, device="cuda", generator=g),
                          torch.tanh])

    B, Tw = 32, 32
    x = torch.from_numpy(rng.standard_normal((B, Tw, 8)).astype(np.float32)
                         ).cuda()
    taus = torch.full((B,), Tw, dtype=torch.int32).cuda()
    for N in (128, 256, 512, 1024):
        times, outs = {}, {}
        for emit_on in (True, False):
            g = torch.Generator().manual_seed(seed)
            model = SparseGCM(
                gnn(32, g), preprocessor=MLP([Linear(8, 32, device="cuda",
                                                     generator=g)]),
                edge_selectors=SparseLearnedEdge(
                    8, deterministic=True, window=16, device="cuda",
                    generator=g),
                graph_size=N, max_edges=4 * N, emit=emit_on, device="cuda")
            state = filled_state(model, B, 8, N - 2 * Tw, (1,), seed)
            with torch.no_grad():
                outs[emit_on] = model(x, taus, state)[0]
                times[emit_on] = time_ms(lambda: model(x, taus, state),
                                         reps=10)
        err = float((outs[True] - outs[False]).abs().max())
        check(err <= TOL_MODEL, f"emit gate N={N}: paths differ by {err}")
        row["emit"].append(dict(
            N=N, window_band=min(16 + Tw, N), emit_call_ms=times[True][1],
            grid_call_ms=times[False][1], emit_device_ms=times[True][0],
            grid_device_ms=times[False][0], max_abs_err=err))

    B, tau, cap = 16, 8, 32
    taus = torch.full((B,), tau, dtype=torch.int32).cuda()
    for F in (128, 32):
        x = torch.from_numpy(rng.standard_normal((B, tau, F)).astype(
            np.float32)).cuda()
        for N in (256, 1024, 4096):
            times, outs = {}, {}
            for hop_cap in (cap, None):
                g = torch.Generator().manual_seed(seed)
                model = SparseGCM(gnn(F, g), edge_selectors=TemporalEdge(
                    [1, 2]), graph_size=N, max_edges=4 * N, max_hops=2,
                    hop_cap=hop_cap, device="cuda")
                state = filled_state(model, B, F, N // 2, (1, 2), seed)
                with torch.no_grad():
                    outs[hop_cap] = model(x, taus, state)[0]
                    times[hop_cap] = time_ms(lambda: model(x, taus, state),
                                             reps=10)
            err = float((outs[cap] - outs[None]).abs().max())
            check(err <= TOL_MODEL, f"hop gate N={N} F={F}: paths differ "
                  f"by {err}")
            row["hop_cap"].append(dict(
                N=N, F=F, cap=cap, NF=N * F, compact_call_ms=times[cap][1],
                masked_call_ms=times[None][1],
                compact_device_ms=times[cap][0],
                masked_device_ms=times[None][0], max_abs_err=err))
    emit("gates", **row)


# -- main ---------------------------------------------------------------------

# -- phase 13: the ring core --------------------------------------------------

# selector -> how close the ring's beliefs must come to the dense core's on
# the card: the two sum each row's in-edges in another order (slot against
# logical order), which at CosineEdge(0.5)'s ~85 in-edges a row reaches
# 3.7e-5 between the plain versions on the CPU already
RING_SELECTORS = {"temporal": TOL_KERNEL, "cosine": TOL_MODEL,
                  "learned": TOL_KERNEL}


def ring_pair(kind: str, device: str, seed: int = 0):
    """The README DenseGCM (readme_dense_gcm's weights, obs 8, hidden 32,
    graph 128) with TemporalBackedge([1]), CosineEdge(0.5) or a
    deterministic LearnedEdge(8), and a RingDenseGCM of the same modules."""
    from gcm_tpu_torch import (CosineEdge, DenseGCM, LearnedEdge,
                               RingDenseGCM, TemporalBackedge,
                               readme_dense_gcm)

    sel = {"temporal": lambda: TemporalBackedge([1]),
           "cosine": lambda: CosineEdge(max_distance=0.5),
           "learned": lambda: LearnedEdge(
               input_size=8, deterministic=True, device=device,
               generator=torch.Generator().manual_seed(seed + 1))}[kind]()
    base = readme_dense_gcm(obs_size=8, device=device, seed=seed)
    kw = dict(preprocessor=base.preprocessor, edge_selectors=sel,
              graph_size=base.graph_size, device=device)
    return RingDenseGCM(base.gnn, **kw), DenseGCM(base.gnn, **kw)


NEAR_TIE = 1e-5  # |z - tau| of spardmax below this may flip between devices


def ring_learned_teacher_forced(ring, ring_cpu, xs) -> dict:
    """The ring with a deterministic LearnedEdge against its CPU copy step
    by step, each CPU step from the card's state: an edge of row p may
    differ only where the CPU's spardmax margin |z - tau| (z the shaped
    logits, tau the sparsemax threshold) is under NEAR_TIE; beliefs within
    TOL_MODEL wherever row p agrees."""
    from gcm_tpu_torch.utils.ste import sparsemax

    B, T = xs.shape[0], xs.shape[1]
    N = ring.graph_size
    state = ring.initial_state(B, 8)
    flips, worst_margin, worst = 0, 0.0, 0.0
    for t in range(T):
        cpu_state = type(state)(*(a.cpu() for a in state))
        out, nxt = ring(xs[:, t].cuda(), state)
        want, want_next = ring_cpu(xs[:, t], cpu_state)
        p, _, _, valid = ring_cpu._geometry(cpu_state.t)
        b = torch.arange(B)
        i_eq = torch.arange(N)[None, :] == p[:, None]
        nodes = torch.where(i_eq[..., None], xs[:, t][:, None, :],
                            cpu_state.nodes)
        curr = nodes[b, p.long()]
        sel = ring_cpu.edge_selectors
        logits = sel.edge_network(torch.cat(
            [curr[:, None, :].expand_as(nodes), nodes], dim=-1))[..., 0]
        z = torch.where(valid, logits, -1e10)
        soft = sparsemax(z)
        tau = torch.where(soft > 0, z - soft, -float("inf")).amax(
            -1, keepdim=True)
        differ = nxt.adj.cpu() != want_next.adj
        check(not bool((differ & ~i_eq[:, :, None]).any()),
              f"ring learned step {t}: an edge off row p differs")
        row_differs = differ[b, p.long()]
        if bool(row_differs.any()):
            margin = float((z - tau).abs()[row_differs].max())
            check(margin < NEAR_TIE, f"ring learned step {t}: an edge differs "
                  f"from the CPU copy at margin {margin} >= {NEAR_TIE}")
            flips += int(row_differs.sum())
            worst_margin = max(worst_margin, margin)
        agree = ~row_differs.any(-1)
        if bool(agree.any()):
            worst = max(worst, float((out.cpu()[agree] - want[agree])
                                     .abs().max()))
        state = nxt
    check(worst <= TOL_MODEL, f"ring learned, teacher-forced: beliefs "
          f"differ from the CPU copy by {worst} > {TOL_MODEL}")
    return dict(steps=T, edges_flipped=flips, largest_flip_margin=worst_margin,
                max_abs_err_where_rows_agree=worst)


def ring_phase(card: str, seed: int = 0, B: int = 32, T: int = 256,
               ticks: int = 100, capacity: int = 256):
    """The ring core (RingDenseGCM) at the README widths over [32, 256, 8],
    which wraps its 128 slots twice, with TemporalBackedge([1]),
    CosineEdge(0.5) (scored by sddmm_threshold_row's explicit entry in slot
    space) and a deterministic LearnedEdge: beliefs within TOL_KERNEL of
    the port's DenseGCM with the same modules on the card, and within
    TOL_MODEL of a CPU copy of the ring; one fused_dense_gnn launch a step,
    one sddmm launch a cosine step. Then the temporal ring and dense cores
    served at capacity 256 in turns on the same requests: median µs a tick
    and, from a profiled window, kernels and device µs a tick."""
    from gcm_tpu_torch import SessionServer
    from gcm_tpu_torch.ops.cuda.fused_gnn import fused_dense_gnn
    from gcm_tpu_torch.ops.cuda.sddmm import sddmm_threshold_row

    t_phase = time.perf_counter()
    xs = torch.from_numpy(np.random.default_rng(seed + 60).standard_normal(
        (B, T, 8)).astype(np.float32))
    xs_c = xs.cuda()
    row = dict(card=card, B=B, T=T, graph_size=128)
    with torch.no_grad():
        for kind, tol in RING_SELECTORS.items():
            ring, dense = ring_pair(kind, "cuda", seed)
            ring_cpu, _ = ring_pair(kind, "cpu", seed)
            before = (fused_dense_gnn.launches, sddmm_threshold_row.launches)
            (got, state), secs = timed(
                lambda: ring.scan(xs_c, ring.initial_state(B, 8)))
            launched = (fused_dense_gnn.launches - before[0],
                        sddmm_threshold_row.launches - before[1])
            (want_dense, _), dense_secs = timed(
                lambda: dense.scan(xs_c, dense.initial_state(B, 8)))
            want_cpu, cpu_state = ring_cpu.scan(xs,
                                                ring_cpu.initial_state(B, 8))
            check(bool(torch.isfinite(got).all()), f"ring {kind}: non-finite")
            err_dense = float((got - want_dense).abs().max())
            err_cpu = float((got.cpu() - want_cpu).abs().max())
            adj_equal = torch.equal(state.adj.cpu(), cpu_state.adj)
            check(err_dense <= tol, f"ring {kind}: beliefs differ "
                  f"from the dense core's by {err_dense} > {tol}")
            if kind == "learned":
                # spardmax's hard support flips where a logit sits within
                # rounding of the threshold, and a flip then changes every
                # later step: held teacher-forced, step by step
                row_teacher = ring_learned_teacher_forced(ring, ring_cpu, xs)
            else:
                check(err_cpu <= TOL_MODEL, f"ring {kind}: beliefs differ "
                      f"from the CPU copy by {err_cpu} > {TOL_MODEL}")
            want = (T, T if kind == "cosine" else 0)
            check(launched == want, f"ring {kind}: launches (fused_dense_gnn, "
                  f"sddmm) {launched}, expected {want}")
            row[f"scan_{kind}"] = dict(
                max_abs_err_vs_dense=err_dense, max_abs_err_vs_cpu=err_cpu,
                adj_equal_to_cpu=adj_equal,
                **({"teacher_forced": row_teacher} if kind == "learned"
                   else {}),
                timesteps_per_s=B * T / secs,
                dense_timesteps_per_s=B * T / dense_secs,
                launches=dict(fused_dense_gnn=launched[0],
                              sddmm_threshold_row=launched[1]))
        servers = {}
        for name, model in zip(("ring", "dense"),
                               ring_pair("temporal", "cuda", seed)):
            servers[name] = SessionServer(model, capacity, 8)
        rng = np.random.default_rng(seed + 61)
        step_s = {k: [] for k in servers}
        outs, reqs = {}, {}
        for tick in range(ticks + 10):  # the first 10 ticks warm up
            reqs = tick_requests(rng, capacity)
            for k, srv in servers.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                outs[k] = srv.step(reqs)
                if tick >= 10:
                    step_s[k].append(time.perf_counter() - t0)
            err = max(float(np.abs(outs["ring"][s] - outs["dense"][s]).max())
                      for s in reqs)
            check(err <= TOL_KERNEL, f"served ring tick {tick} differs from "
                  f"the dense core's by {err}")
        row["served_in_turns"] = {
            k: dict(capacity=capacity, ticks=ticks,
                    us_per_tick_median=1e6 * statistics.median(step_s[k]),
                    profile=dict(requests_per_tick=len(reqs),
                                 **profile_calls(
                                     lambda srv=srv: srv.step(reqs))))
            for k, srv in servers.items()}
    emit("ring", seconds=time.perf_counter() - t_phase, **row)


# -- phase 14: RL on the card -------------------------------------------------

def cpu_copy(policy, build):
    """build("cpu") with the card policy's weights."""
    cpu = build("cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in policy.state_dict().items()})
    return cpu


def grads_vs_cpu(label, trainer, cpu_trainer, traj):
    """One update's loss and every gradient of the card trainer's policy
    against the CPU copy's on the same trajectory (TOL_MODEL); the card's
    replay runs the kernels' Functions, forward and backward."""
    traj_cpu = {k: v.cpu() for k, v in traj.items()}
    out = {}
    for tr, tj in ((trainer, traj), (cpu_trainer, traj_cpu)):
        tr.opt.zero_grad(set_to_none=True)
        loss, _ = tr.loss(tj)
        loss.backward()
        out[tr] = (float(loss.detach()), {n: p.grad for n, p in
                                 tr.policy.named_parameters()})
    (loss, grads), (want_loss, want_grads) = out[trainer], out[cpu_trainer]
    errs = [abs(loss - want_loss)]
    for n, g in grads.items():
        check(g is not None and bool(torch.isfinite(g).all()),
              f"{label}: gradient of {n} missing or non-finite")
        errs.append(float((g.cpu() - want_grads[n]).abs().max()))
    worst = max(errs)
    check(worst <= TOL_MODEL, f"{label}: loss or gradients differ from the "
          f"CPU copy by {worst} > {TOL_MODEL}")
    return dict(loss=loss, max_abs_err_vs_cpu=worst, params=len(grads))


def timed_updates(trainer, generator, B, n):
    """n updates, each synchronised: (wall ms of each, the last metrics)."""
    ms, metrics = [], None
    for _ in range(n):
        (metrics), secs = timed(lambda: trainer.update(generator, B))
        ms.append(1e3 * secs)
    return ms, metrics


def rl_phase(card: str, seed: int = 0):
    """RL trained on the card (gcm_tpu_torch/rl):
    (a) CartPoleEnv(horizon=64, masked_velocity=True, reward_scale=0.05)
    at B=64 under GCMActorCritic's ring core (graph_size 16,
    TemporalBackedge([1, 2]), widths 64 -> 64), the configuration the JAX
    package's CartPoleEnv documents: one A2C update's loss and every
    gradient against a CPU copy on the same collected trajectory (1e-4); 5
    A2C updates and 2 PPO updates (4 epochs x 2 minibatches), wall ms per
    update and env steps/s, and where one profiled update's time goes; the
    replay + backward with remat=False and with chunks of 16 and 8 steps,
    timed in turns on one trajectory (the choice train_remat_for holds);
    (b) tests/test_rl.py's learning check: RecallEnv(2 symbols, horizon 4,
    noise 2) at graph_size 5 (off the 16-row grid), gnn 16/16, previous
    actions, A2C(lr=8e-3, entropy_coef=0.003), 150 updates at B=32, which
    must reach late > max(0.62, early + 0.05);
    (c) one A2C update of a SparseGCMActorCritic (TemporalEdge([1]),
    max_edges 64, graph 8) on that RecallEnv against a CPU copy (1e-4);
    (d) the trained (b) policy (its weights, no previous actions) served by
    SessionServer.from_policy at capacity 256 against a CPU copy: logits
    and values within 1e-4."""
    from gcm_tpu_torch import (A2C, PPO, CartPoleEnv, GCMActorCritic,
                               RecallEnv, SessionServer,
                               SparseGCMActorCritic, TemporalBackedge,
                               TemporalEdge)
    from gcm_tpu_torch.rl import wrappers

    t_phase = time.perf_counter()
    row = dict(card=card)
    g = torch.Generator(device="cuda").manual_seed(seed)

    # (a) CartPole, the documented configuration
    B, T = 64, 64

    def cartpole(device):
        return GCMActorCritic(
            2, 2, 2, graph_size=16, edge_selectors=TemporalBackedge([1, 2]),
            device=device, generator=torch.Generator().manual_seed(seed))

    env = CartPoleEnv(horizon=T, masked_velocity=True, reward_scale=0.05)
    env_cpu = CartPoleEnv(horizon=T, masked_velocity=True, reward_scale=0.05,
                          device="cpu")
    pol = cartpole("cuda")
    a2c = A2C(env, pol, rollout_len=T)
    traj = a2c.collect(g, B)
    a = dict(B=B, T=T, graph_size=16, core="ring")
    a["grads"] = grads_vs_cpu("cartpole a2c", a2c,
                              A2C(env_cpu, cpu_copy(pol, cartpole),
                                  rollout_len=T), traj)
    a["episode_ends_in_rollout"] = int(traj["dones"].sum())
    ms, m = timed_updates(a2c, g, B, 5)
    a["a2c"] = dict(ms_per_update=ms, ms_median=statistics.median(ms),
                    env_steps_per_s=B * T / (statistics.median(ms) / 1e3),
                    loss=float(m["loss"]), ret=float(m["return"]),
                    profile_one_update=profile_calls(
                        lambda: a2c.update(g, B), n=1))
    ppo = PPO(env, cartpole("cuda"), rollout_len=T, epochs=4,
              num_minibatches=2)
    ms, m = timed_updates(ppo, g, B, 2)
    a["ppo"] = dict(epochs=4, num_minibatches=2, ms_per_update=ms,
                    env_steps_per_s=B * T / (statistics.median(ms) / 1e3),
                    loss=float(m["loss"]),
                    profile_one_update=profile_calls(
                        lambda: ppo.update(g, B), n=1))
    # the replay's remat, timed in turns on one trajectory
    remat_ms = {}
    chosen = wrappers.TRAIN_REMAT_CHUNK
    try:
        for _ in range(3):
            for K in (None, 16, 8, None):
                wrappers.TRAIN_REMAT_CHUNK = K
                _, secs = timed(lambda: a2c.apply(a2c.loss(traj)[0]))
                remat_ms.setdefault(str(K), []).append(1e3 * secs)
    finally:
        wrappers.TRAIN_REMAT_CHUNK = chosen
    a["replay_backward_ms_by_remat_chunk"] = {
        k: dict(ms=v, median=statistics.median(v)) for k, v in
        remat_ms.items()}
    a["train_remat_chunk_in_use"] = chosen
    row["cartpole"] = a

    # (b) the recall task learns at graph size 5
    renv = RecallEnv(num_symbols=2, horizon=4, noise_dim=2)
    obs = renv.obs_dim

    def recall(device, **kw):
        cfg = dict(graph_size=5, gnn_input_size=16, gnn_output_size=16,
                   edge_selectors=TemporalBackedge([1]))
        cfg.update(kw)
        return GCMActorCritic(obs, 2, 2, device=device,
                              generator=torch.Generator().manual_seed(seed),
                              **cfg)

    pol_b = recall("cuda", use_prev_action=True)
    trainer = A2C(renv, pol_b, lr=8e-3, entropy_coef=0.003)
    history, secs = timed(lambda: trainer.train(g, updates=150, B=32))
    early, late = float(np.mean(history[:10])), float(np.mean(history[-10:]))
    check(late > max(0.62, early + 0.05),
          f"recall did not learn: early={early:.3f} late={late:.3f}")
    row["recall_learns"] = dict(updates=150, B=32, graph_size=5,
                                early=early, late=late,
                                ms_per_update=1e3 * secs / 150)

    # (c) the sparse policy: one update against a CPU copy
    def sparse(device):
        return SparseGCMActorCritic(
            obs, 2, 2, graph_size=8, max_edges=64, gnn_input_size=16,
            gnn_output_size=16, edge_selectors=TemporalEdge([1]),
            device=device, generator=torch.Generator().manual_seed(seed))

    renv_cpu = RecallEnv(num_symbols=2, horizon=4, noise_dim=2, device="cpu")
    pol_c = sparse("cuda")
    sa2c = A2C(renv, pol_c)
    row["sparse_a2c"] = grads_vs_cpu(
        "sparse a2c", sa2c, A2C(renv_cpu, cpu_copy(pol_c, sparse)),
        sa2c.collect(g, 32))

    # (d) the trained recall policy served. A request carries no previous
    # action, so it is served with the neutral action 0 folded into the
    # preprocessor: x @ W = obs @ W[:obs] + one_hot(0) @ W[obs:] = obs @
    # W[:obs] + W[obs], into the bias; the same function of the
    # observations as the trained policy fed action 0
    served = recall("cuda")
    weights = dict(pol_b.state_dict())
    kernel = weights.pop("core.preprocessor.blocks.0.kernel")
    weights["core.preprocessor.blocks.0.kernel"] = kernel[:obs]
    weights["core.preprocessor.blocks.0.bias"] = (
        weights["core.preprocessor.blocks.0.bias"] + kernel[obs])
    served.load_state_dict(weights)
    srv = SessionServer.from_policy(served, capacity=256)
    ref = SessionServer.from_policy(cpu_copy(served, recall), capacity=256)
    rng = np.random.default_rng(seed + 70)
    worst, step_s = 0.0, []
    for tick in range(60):
        reqs = {f"s{i}": rng.standard_normal(obs).astype(np.float32)
                for i in range(256) if rng.random() < 0.5}
        out, secs = timed(lambda: srv.step(reqs))
        step_s.append(secs)
        want = ref.step(reqs)
        for sid in reqs:
            for k in ("logits", "value"):
                check(bool(np.isfinite(out[sid][k]).all()),
                      f"served {sid} {k}: non-finite")
                worst = max(worst, float(np.abs(out[sid][k]
                                                - want[sid][k]).max()))
    check(worst <= TOL_MODEL, f"served policy differs from the CPU copy by "
          f"{worst} > {TOL_MODEL}")
    row["served_policy"] = dict(capacity=256, ticks=60,
                                max_abs_err_vs_cpu=worst,
                                us_per_tick_median=1e6 * statistics.median(
                                    step_s))
    emit("rl", seconds=time.perf_counter() - t_phase, **row)


# -- phase 15: the host-stepped path ------------------------------------------

class HostTMaze:
    """A host T-maze in numpy (the JAX package's examples/
    train_external_env.py::PyTMaze, which that script trains): the goal
    side shows only at the corridor's start; at the junction the agent must
    turn the remembered way. Actions 0 forward, 1 left, 2 right."""

    obs_dim = 4
    num_actions = 3

    def __init__(self, corridor_length=4, rng=None):
        self.L = corridor_length
        self.rng = rng or np.random.default_rng(0)

    def _obs(self):
        at_start, at_junction = self.pos == 0, self.pos >= self.L
        return np.array([at_start and self.goal == 0,
                         at_start and self.goal == 1,
                         not at_junction, at_junction], np.float32)

    def reset(self):
        self.goal = int(self.rng.integers(0, 2))
        self.pos = 0
        self.t = 0
        return self._obs()

    def step(self, action):
        at_junction = self.pos >= self.L
        self.t += 1
        if at_junction and action in (1, 2):
            return self._obs(), (4.0 if action - 1 == self.goal else -0.1), \
                True
        if action == 0 and not at_junction:
            self.pos += 1
            return self._obs(), 0.0, self.t > self.L + 2
        return self._obs(), -0.1, self.t > self.L + 2


def host_pool(kind: str, seed: int):
    """(pool, T_max) of examples/train_external_env.py: 16 envs of the
    native CartPole (horizon 24, reward 0.1) or of the host T-maze
    (corridor 4)."""
    from gcm_tpu_torch import HostEnvPool, NativeCartPolePool

    if kind == "native_cartpole":
        return NativeCartPolePool(16, horizon=24, reward_scale=0.1,
                                  seed=100 + seed), 24
    return HostEnvPool([HostTMaze(4, np.random.default_rng(100 + seed + i))
                        for i in range(16)]), 8


def same_buffers(label, a, b, B, T_max):
    check((a.num_episodes, a.total_steps) == (b.num_episodes, b.total_steps),
          f"{label}: {a.num_episodes} episodes / {a.total_steps} steps, CPU "
          f"copy {b.num_episodes} / {b.total_steps}")
    for seed in range(3):
        for x, y in zip(a.sample(B, T_max, seed), b.sample(B, T_max, seed)):
            check(np.array_equal(x, y), f"{label}: buffer samples differ "
                  "from the CPU copy's")


def a2c_grads(policy, batch, value_coef, entropy_coef, state):
    """The masked A2C loss of one batch through `policy` from `state` and
    every parameter's gradient (no step)."""
    from gcm_tpu_torch.rl.external import masked_a2c_loss

    policy.zero_grad(set_to_none=True)
    logits, values, _ = policy(batch["obs"], state,
                               prev_actions=batch["prev_actions"],
                               taus=batch["taus"])
    loss, _ = masked_a2c_loss(logits, values, batch, value_coef,
                              entropy_coef)
    loss.backward()
    return float(loss.detach()), {n: p.grad for n, p in
                                  policy.named_parameters()}


def grads_close(label, got, want, tol):
    (loss, grads), (want_loss, want_grads) = got, want
    errs = [abs(loss - want_loss)]
    for n, g in grads.items():
        check(g is not None and bool(torch.isfinite(g).all()),
              f"{label}: gradient of {n} missing or non-finite")
        errs.append(float((g.cpu() - want_grads[n]).abs().max()))
    worst = max(errs)
    check(worst <= tol, f"{label}: loss or gradients differ from the CPU "
          f"copy by {worst} > {tol}")
    return dict(loss=loss, max_abs_err_vs_cpu=worst, params=len(grads))


def counted(fn, *wrappers):
    """fn()'s result and the launches of each wrapper during it."""
    before = [w.launches for w in wrappers]
    out = fn()
    torch.cuda.synchronize()
    return out, [w.launches - b for w, b in zip(wrappers, before)]


def spread(ms):
    return dict(ms=ms, median=statistics.median(ms), min=min(ms),
                max=max(ms))


def host_phase(card: str, seed: int = 0, B_train: int = 32,
               updates: int = 5, fed: int = 20):
    """The host-stepped path (rl/external.py) at examples/
    train_external_env.py's sizes: SparseGCMActorCritic (gnn 32 -> 32,
    TemporalEdge([1]), graph T_max + 1, 4 T_max edge slots, previous
    actions), Adam(3e-3), the native replay buffer, on the native CartPole
    pool and on a host T-maze pool, 16 envs each. For each pool: greedy
    collection against a CPU copy (the same actions: the same episodes in
    the buffer, samples bitwise); one update's loss and gradients against
    the CPU copy on the same batch (1e-5); launches of spmm_edge_list and
    edge_weight_grad a collect tick and an update; `updates` updates of
    collect(2 T_max) -> sample(B_train) -> episode_batch_to_device ->
    make_offline_a2c_update, timed (collect ticks/s, env steps/s, update
    ms) with one profiled update (kernels, busy share); then `fed` updates
    fed inline and through prefetch_to_device, in turns, ms per update
    each way."""
    from gcm_tpu_torch import (HostReplayBuffer, SparseGCMActorCritic,
                               TemporalEdge, collect_host_episodes,
                               episode_batch_to_device,
                               make_offline_a2c_update, prefetch_to_device)
    from gcm_tpu_torch.ops.cuda.edge_grad import edge_weight_grad
    from gcm_tpu_torch.ops.cuda.spmm import spmm_edge_list

    t_phase = time.perf_counter()
    row = dict(card=card)
    for kind in ("native_cartpole", "tmaze"):
        pool, T_max = host_pool(kind, seed)
        cpu_pool, _ = host_pool(kind, seed)

        def build(device):
            return SparseGCMActorCritic(
                pool.obs_dim, pool.num_actions, pool.num_actions,
                graph_size=T_max + 1, gnn_input_size=32, gnn_output_size=32,
                edge_selectors=TemporalEdge([1]), max_edges=4 * T_max,
                use_prev_action=True, device=device,
                generator=torch.Generator().manual_seed(seed))

        pol = build("cuda")
        pol_cpu = cpu_copy(pol, build)
        r = dict(envs=len(pool), T_max=T_max, B_train=B_train)

        # greedy collection: the same actions as the CPU copy
        buf = HostReplayBuffer(200_000, pool.obs_dim)
        buf_cpu = HostReplayBuffer(200_000, pool.obs_dim)
        (n_eps, ret), (tick_spmm, tick_dw) = counted(
            lambda: collect_host_episodes(pool, pol, buf, 2 * T_max,
                                          greedy=True),
            spmm_edge_list, edge_weight_grad)
        want = collect_host_episodes(cpu_pool, pol_cpu, buf_cpu, 2 * T_max,
                                     greedy=True)
        check((n_eps, ret) == want, f"{kind}: greedy collection gave "
              f"{(n_eps, ret)}, the CPU copy {want}")
        check(n_eps > 0, f"{kind}: no episode ended")
        same_buffers(kind, buf, buf_cpu, B_train, T_max)
        r["greedy"] = dict(episodes=n_eps, mean_return=ret,
                           same_actions_as_cpu=True)
        r["launches_per_collect_tick"] = dict(
            spmm_edge_list=tick_spmm / (2 * T_max),
            edge_weight_grad=tick_dw / (2 * T_max))

        # one update's loss and gradients against the CPU copy
        sample = buf.sample(B_train, T_max, seed=seed)
        batch = episode_batch_to_device(*sample, gamma=0.99)
        batch_cpu = episode_batch_to_device(*sample, gamma=0.99,
                                            device="cpu")
        (got, (upd_spmm, upd_dw)) = counted(
            lambda: a2c_grads(pol, batch, 0.5, 0.01,
                              pol.initial_state(B_train)),
            spmm_edge_list, edge_weight_grad)
        r["grads"] = grads_close(
            f"{kind} update", got,
            a2c_grads(pol_cpu, batch_cpu, 0.5, 0.01,
                      pol_cpu.initial_state(B_train)), TOL_KERNEL)
        r["launches_per_update"] = dict(spmm_edge_list=upd_spmm,
                                        edge_weight_grad=upd_dw)
        check(upd_spmm > 0 and tick_spmm > 0,
              f"{kind}: spmm_edge_list not launched on the host path")

        # the training loop
        opt = torch.optim.Adam(pol.parameters(), lr=3e-3)
        update = make_offline_a2c_update(pol, opt)
        g = torch.Generator(device="cuda").manual_seed(seed)
        collect_s, update_ms, eps = [], [], 0
        for u in range(updates):
            (n, _), secs = timed(lambda: collect_host_episodes(
                pool, pol, buf, 2 * T_max, g))
            collect_s.append(secs)
            eps += n
            metrics, secs = timed(lambda: update(episode_batch_to_device(
                *buf.sample(B_train, T_max, seed=u), gamma=0.99)))
            update_ms.append(1e3 * secs)
            check(bool(torch.isfinite(metrics["loss"])),
                  f"{kind}: non-finite loss")
        ticks = updates * 2 * T_max
        r["train"] = dict(
            updates=updates, episodes=eps,
            collect_ticks_per_s=ticks / sum(collect_s),
            env_steps_per_s=ticks * len(pool) / sum(collect_s),
            update_ms=spread(update_ms),
            profile_one_update=profile_calls(lambda: update(
                episode_batch_to_device(*buf.sample(B_train, T_max, seed=0),
                                        gamma=0.99)), n=1))

        # the update loop fed inline and through the prefetch, in turns
        def samples():
            for u in range(fed):
                obs, acts, rews, taus = buf.sample(B_train, T_max, seed=u)
                yield {"obs": obs, "acts": acts, "rews": rews, "taus": taus}

        def inline():
            for s in samples():
                update(episode_batch_to_device(
                    s["obs"], s["acts"], s["rews"], s["taus"], gamma=0.99))

        def prefetched():
            for s in prefetch_to_device(samples(), size=2):
                update(episode_batch_to_device(
                    s["obs"], s["acts"], s["rews"], s["taus"], gamma=0.99))

        fed_ms = {"inline": [], "prefetch": []}
        for name in ("inline", "prefetch", "prefetch", "inline"):
            _, secs = timed(inline if name == "inline" else prefetched)
            fed_ms[name].append(1e3 * secs / fed)
        r["fed_ms_per_update"] = {k: dict(ms=v, mean=statistics.mean(v))
                                  for k, v in fed_ms.items()}
        row[kind] = r
    emit("host", seconds=time.perf_counter() - t_phase, **row)


# -- phase 16: the navigation memory ------------------------------------------

# the JAX package's examples' V = 26 pads to 32; 1,024 is the largest graph
# the dense kernels take (above it only the incremental core runs)
NAV_GATE_V = (32, 64, 128, 256, 512, 1024)
NAV_GATE_MARGIN = 0.9  # the incremental tick must take under 90% of the full


def nav_walk(rng, B, V):
    """Poses of B PointGoalNav-like walks of V steps on the 45-degree
    lattice (turning in place repeats a pose), as [B, V, 2] positions and
    [B, V, 1] headings."""
    theta = np.zeros(B)
    pos = np.zeros((B, 2))
    out_p, out_r = np.zeros((B, V, 2)), np.zeros((B, V, 1))
    for s in range(V):
        out_p[:, s], out_r[:, s, 0] = pos, theta
        a = rng.choice(3, size=B, p=[0.25, 0.15, 0.6])
        theta = theta + np.where(a == 0, np.pi / 4,
                                 np.where(a == 1, -np.pi / 4, 0.0))
        step = np.stack([np.cos(theta), np.sin(theta)], -1)
        pos = pos + np.where(a[:, None] == 2, step, 0.0)
    return out_p.astype(np.float32), out_r.astype(np.float32)


def nav_gate(seed: int, B: int = 16):
    """Both nav cores timed at B = 16 (the examples' 16 envs) and V in
    NAV_GATE_V, NavActorCritic's widths (features 5 + pose 3 -> 32 -> 32,
    k 8, r 2.5): a tau = 1 tick into a state holding V - 1 nodes and a whole
    window (tau = V) from empty, call and device ms (time_ms), in turns
    (full, incremental, incremental, full; the median of the two). Both
    ticks are host-bound and their call times move by tens of percent
    between readings, so the rule asks for a clear win: the smallest V
    from which the incremental tick's call ms is below NAV_GATE_MARGIN of
    the full core's at that V and every larger one; where there is none,
    1,025, the first V the full core's kernels cannot take."""
    from gcm_tpu_torch import NavGCM, NavGCMIncremental
    from gcm_tpu_torch.models import nav_gcm
    from gcm_tpu_torch.rl.nav import NavActorCritic

    rng = np.random.default_rng(seed)
    rows = []
    for V in NAV_GATE_V:
        pol = NavActorCritic(5, 3, max_verts=V, hidden=32, k=8, r=2.5,
                             device="cuda",
                             generator=torch.Generator().manual_seed(seed))
        gnn = pol.core_train.gnn
        full = NavGCM(gnn, max_verts=V, k=8, r=2.5, device="cuda")
        inc = NavGCMIncremental(gnn, max_verts=V, k=8, r=2.5, device="cuda")
        pos, rot = (torch.from_numpy(a).cuda() for a in nav_walk(rng, B, V))
        x = torch.from_numpy(rng.standard_normal((B, V, 5)).astype(
            np.float32)).cuda()
        ones = torch.ones(B, dtype=torch.int32, device="cuda")
        with torch.no_grad():
            states = {}
            for name, core in (("full", full), ("incremental", inc)):
                fill = torch.full((B,), V - 1, dtype=torch.int32,
                                  device="cuda")
                _, st = core(x[:, :-1], pos[:, :-1], rot[:, :-1], fill,
                             core.initial_state(B, 5))
                states[name] = st
            fns = {}
            for name, core in (("full", full), ("incremental", inc)):
                fns[name] = {
                    "tick": functools.partial(core, x[:, -1:], pos[:, -1:],
                                              rot[:, -1:], ones,
                                              states[name]),
                    "window": functools.partial(
                        core, x, pos, rot, torch.full_like(ones, V),
                        core.initial_state(B, 5))}
            runs = {(n, k): [] for n in fns for k in ("tick", "window")}
            for name in ("full", "incremental", "incremental", "full"):
                for kind, fn in fns[name].items():
                    runs[name, kind].append(time_ms(fn, reps=10, rounds=3))
            r = dict(V=V, B=B)
            for (name, kind), got in runs.items():
                r.setdefault(name, {})[kind] = dict(
                    device_ms=statistics.median(d for d, _ in got),
                    call_ms=statistics.median(c for _, c in got),
                    call_ms_runs=[c for _, c in got])
            got, _ = inc(x[:, -1:], pos[:, -1:], rot[:, -1:], ones,
                         states["incremental"])
            want, _ = full(x[:, -1:], pos[:, -1:], rot[:, -1:], ones,
                           states["full"])
            r["tick_max_abs_diff"] = float((got - want).abs().max())
            check(r["tick_max_abs_diff"] <= TOL_KERNEL,
                  f"nav gate V={V}: the cores' ticks differ by "
                  f"{r['tick_max_abs_diff']}")
        rows.append(r)
    wins = [r["incremental"]["tick"]["call_ms"]
            < NAV_GATE_MARGIN * r["full"]["tick"]["call_ms"] for r in rows]
    rule = NAV_GATE_V[-1] + 1
    for i in range(len(rows)):
        if all(wins[i:]):
            rule = NAV_GATE_V[i]
            break
    return dict(points=rows, margin=NAV_GATE_MARGIN, rule_min_v=rule,
                constant_in_use=nav_gcm.NAV_INCREMENTAL_MIN_V)


def nav_margins(pos, valid, k, r):
    """float64 margins of every candidate pair of the causal radius graph:
    |d - r| and |d - the k-th candidate distance| (the cuts that can flip
    between devices), the smaller of the two."""
    p = pos.double()
    d = torch.cdist(p, p)
    V = pos.shape[1]
    iu = torch.arange(V, device=pos.device)
    cand = valid[:, :, None] & valid[:, None, :] & (iu[None, :] < iu[:, None])
    within = cand & (d <= r)
    kth = torch.sort(torch.where(within, d, torch.inf), -1).values[
        ..., k - 1:k]
    return torch.minimum((d - r).abs(), (d - kth).abs())


def nav_phase(card: str, seed: int = 0, updates: int = 30,
              B_train: int = 32):
    """NavActorCritic at examples/train_nav.py's sizes: 16 PointGoalNav
    envs (horizon 24) in a HostEnvPool, max_verts 26, hidden 32, k 8, r
    2.5, Adam(5e-4) behind clip_by_global_norm(0.5), entropy 0.03, the
    native buffer (4 * 16 * 24 steps), B_train 32:
    (a) collect (the incremental core, tick by tick) == replay (NavGCM, one
    call) on the card within 1e-5 on a collected batch of episodes;
    (b) the replay, the loss and every gradient against a CPU copy within
    1e-4: the adjacency of both copies equal, except at entries whose
    float64 distance lies within 1e-5 of its cut (then the CPU copy is held
    teacher-forced on the card's adjacency);
    (c) launches: fused_dense_graph_conv 2 a replay forward and none on an
    incremental tick, fused_dense_gnn_bwd a update;
    (d) the nav gate (nav_gate);
    (e) `updates` updates of collect(horizon + 2) -> sample -> update,
    the early and late collect returns (finite; learning is reported, not
    asserted), update and collect times."""
    from gcm_tpu_torch import (HostEnvPool, HostReplayBuffer,
                               NavActorCritic, PointGoalNav,
                               collect_host_episodes,
                               episode_batch_to_device, make_nav_a2c_update)
    from gcm_tpu_torch.models.nav_gcm import pair_distance
    from gcm_tpu_torch.ops.cuda.dense_gconv import fused_dense_graph_conv
    from gcm_tpu_torch.ops.cuda.fused_gnn import fused_dense_gnn_bwd
    from gcm_tpu_torch.rl.distributions import Categorical

    t_phase = time.perf_counter()
    horizon, envs, V = 24, 16, 26
    row = dict(card=card, envs=envs, horizon=horizon, max_verts=V,
               B_train=B_train)

    def make_pool(offset=0):
        return HostEnvPool([PointGoalNav(
            horizon=horizon, rng=np.random.default_rng(100 + offset + i))
            for i in range(envs)])

    def build(device):
        return NavActorCritic(5, 3, max_verts=V, hidden=32, k=8, r=2.5,
                              device=device,
                              generator=torch.Generator().manual_seed(seed))

    pol = build("cuda")
    pol_cpu = cpu_copy(pol, build)
    pool = make_pool()

    # (a) collect == replay: tick by tick through the incremental core
    # (actions drawn from the logits), recording the logits, then the
    # episodes replayed in one call from their first steps
    g = torch.Generator(device="cuda").manual_seed(seed)
    dist = Categorical()
    with torch.no_grad():
        obs = pool.reset()
        state = pol.initial_state(envs)
        prev = torch.zeros(envs, dtype=torch.int64, device="cuda")
        seq_o, seq_p, seq_l = [], [], []
        ended = np.zeros(envs, bool)
        taus = np.full(envs, horizon, np.int32)
        before = fused_dense_graph_conv.launches
        for s in range(horizon):
            o = torch.as_tensor(obs, device="cuda")
            logits, _, state = pol.step(o, state, prev_action=prev)
            act = dist.sample(g, logits)
            seq_o.append(o)
            seq_p.append(prev)
            seq_l.append(logits)
            obs, _, done = pool.step(act.cpu().numpy())
            taus = np.where(done & ~ended, s + 1, taus)
            ended |= done
            prev = act
        torch.cuda.synchronize()
        tick_graph_conv = fused_dense_graph_conv.launches - before
        obs_seq, prev_seq = torch.stack(seq_o, 1), torch.stack(seq_p, 1)
        collected = torch.stack(seq_l, 1)
        t_taus = torch.as_tensor(taus, device="cuda")
        (replay, replay_launches) = counted(
            lambda: pol(obs_seq, None, prev_actions=prev_seq, taus=t_taus),
            fused_dense_graph_conv)
    valid = torch.arange(horizon, device="cuda")[None] < t_taus[:, None]
    diff = float((replay[0] - collected).abs()[valid].max())
    check(diff <= TOL_KERNEL, f"nav collect != replay by {diff}")
    check(tick_graph_conv == 0, f"{tick_graph_conv} fused_dense_graph_conv "
          "launches on incremental ticks, expected 0")
    check(replay_launches[0] == 2, f"{replay_launches[0]} "
          "fused_dense_graph_conv launches a replay forward, expected 2")
    row["collect_equals_replay"] = dict(max_abs_diff=diff, episodes=envs,
                                        taus=taus.tolist())
    row["launches"] = dict(graph_conv_per_tick=tick_graph_conv / horizon,
                           graph_conv_per_replay=replay_launches[0])

    # (b) replay, loss and gradients against the CPU copy; an adjacency
    # entry may differ only at a float64 margin under 1e-5, and then the
    # CPU copy replays on the card's adjacency (teacher-forced)
    buf = HostReplayBuffer(4 * envs * horizon, 5)
    collect_host_episodes(pool, pol, buf, 3 * (horizon + 2), g)
    sample = buf.sample(B_train, horizon, seed=seed)
    batch = episode_batch_to_device(*sample, gamma=0.99)
    batch_cpu = episode_batch_to_device(*sample, gamma=0.99, device="cpu")
    core, core_cpu = pol.core_train, pol_cpu.core_train
    with torch.no_grad():
        feat, pos, rot = pol._split(batch["obs"], batch["prev_actions"])
        _, filled = core(feat, pos, rot, batch["taus"],
                         core.initial_state(B_train, pol.feat_dim))
    node_valid = torch.arange(V, device="cuda")[None] \
        < batch["taus"][:, None]
    adj = core._edges(pair_distance(filled.pos, filled.pos), node_valid)
    adj_cpu = core_cpu._edges(pair_distance(filled.pos.cpu(),
                                            filled.pos.cpu()),
                              node_valid.cpu())
    flips = adj.cpu() != adj_cpu
    margins = nav_margins(filled.pos, node_valid, 8, 2.5).cpu()
    check(bool((margins[flips] < 1e-5).all()), "nav adjacency differs from "
          "the CPU copy's away from a tie")
    row["adjacency_vs_cpu"] = dict(flips=int(flips.sum()),
                                   edges=int(adj.sum()),
                                   teacher_forced=bool(flips.any()))
    (got, bwd) = counted(lambda: a2c_grads(pol, batch, 0.5, 0.03, None),
                         fused_dense_graph_conv, fused_dense_gnn_bwd)
    if flips.any():
        forced = adj.cpu()
        core_cpu._edges = lambda d, valid: forced
    want = a2c_grads(pol_cpu, batch_cpu, 0.5, 0.03, None)
    core_cpu.__dict__.pop("_edges", None)
    row["grads"] = grads_close("nav update", got, want, TOL_MODEL)
    row["launches"].update(graph_conv_per_update=bwd[0],
                           gnn_bwd_calls_per_update=bwd[1])
    check(bwd[1] == 2, f"{bwd[1]} fused_dense_gnn_bwd calls a nav update, "
          "expected 2 (one a conv)")

    # (d) the gate
    row["gate"] = nav_gate(seed)

    # (e) a short training run
    opt = torch.optim.Adam(pol.parameters(), lr=5e-4)
    update = make_nav_a2c_update(pol, opt, entropy_coef=0.03,
                                 max_grad_norm=0.5)
    returns, collect_ms, update_ms = [], [], []
    for u in range(updates):
        (_, ret), secs = timed(lambda: collect_host_episodes(
            pool, pol, buf, horizon + 2, g))
        returns.append(ret)
        collect_ms.append(1e3 * secs)
        metrics, secs = timed(lambda: update(episode_batch_to_device(
            *buf.sample(B_train, horizon, seed=u), gamma=0.99)))
        update_ms.append(1e3 * secs)
        check(bool(torch.isfinite(metrics["loss"])), "nav: non-finite loss")
    check(all(np.isfinite(returns)), "nav: non-finite collect return")
    row["train"] = dict(
        updates=updates, early_return=float(np.mean(returns[:5])),
        late_return=float(np.mean(returns[-5:])),
        collect_ms=spread(collect_ms), update_ms=spread(update_ms),
        collect_ticks_per_s=updates * (horizon + 2) / (sum(collect_ms) / 1e3),
        profile_one_update=profile_calls(lambda: update(
            episode_batch_to_device(*buf.sample(B_train, horizon, seed=0),
                                    gamma=0.99)), n=1))
    emit("nav", seconds=time.perf_counter() - t_phase, **row)


# -- phase 17: the fast cores ---------------------------------------------------

FAST_SCALE = 0.3  # input scale: EuclideanEdge(1.0) then takes part of the
#                   candidates (the JAX benchmarks' N(0, 1) inputs leave
#                   almost none under the threshold)
RING_GATE_N = (32, 128, 256, 512, 1024)
CLIQUE_GATE_N = (128, 512, 1024)


def fast_core(kind: str, device: str, seed: int = 0, N: int = 128):
    """A fast core at the JAX package's benchmark widths (bench.py:262-330,
    :384-410, :543-580; benchmarks/state_churn.py:178-200): obs 8, a
    Linear(8, 32) preprocessor, 2 x DenseGraphConv(32, 32) + tanh, weights
    from readme_dense_gcm's seed; and the port's scan core with the
    equivalent selector and the same modules."""
    from gcm_tpu_torch import (BandedRingGCM, BandedScoredGCM, CliqueGCM,
                               DenseEdge, DenseGCM, EuclideanEdge,
                               RingDenseGCM, TemporalBackedge,
                               readme_dense_gcm)

    base = readme_dense_gcm(obs_size=8, device=device, seed=seed)
    kw = dict(preprocessor=base.preprocessor, graph_size=N, device=device)
    if kind == "banded":
        return (BandedRingGCM(base.gnn, hops=(1,), **kw),
                DenseGCM(base.gnn, edge_selectors=TemporalBackedge([1]),
                         **kw))
    if kind == "scored":
        return (BandedScoredGCM(base.gnn, distance=EuclideanEdge(
                    1.0, window=32), **kw),
                DenseGCM(base.gnn, edge_selectors=EuclideanEdge(
                    1.0, window=32), **kw))
    if kind == "clique":
        return (CliqueGCM(base.gnn, **kw),
                DenseGCM(base.gnn, edge_selectors=DenseEdge(), **kw))
    ring = RingDenseGCM(base.gnn, edge_selectors=EuclideanEdge(1.0), **kw)
    return ring, ring


# The clique's and the ring window's float32 beliefs against each other
# and against a float64 witness of the same core. Their first aggregate is
# a sum of hundreds of terms reaching ~50 (float32 rounds it at ~4e-6, and
# lin_rel carries that into the beliefs), so 1e-5 absolute is out of
# reach. Each limit lies above the sound float32 paths' readings and below
# the TF32 control's (PERF.md §6, the fast cores).
FAST_SUM_TOL = {"clique": 2e-4, "ring": 5e-5}


@contextlib.contextmanager
def tf32_matmuls():
    """Products in TF32 (a 10-bit mantissa) inside: the lower-precision
    control of the fast cores' limits."""
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def float64_copy(model):
    """The model's weights in float64 (the fast cores are plain PyTorch)."""
    import copy

    return copy.deepcopy(model).double()


def witness_check(label, ref, paths, control, tol):
    """Each float32 path ({name: beliefs}) within tol of the float64
    witness ref, and the TF32 control above tol: a limit the control
    passed could not tell a lower-precision path from a sound one."""
    errs = {k: float((v.double() - ref).abs().max())
            for k, v in paths.items()}
    ctl = float((control.double() - ref).abs().max())
    check(max(errs.values()) <= tol, f"{label}: float32 vs the float64 "
          f"witness {errs} above {tol}")
    check(ctl > tol, f"{label}: the TF32 control reads {ctl}, within {tol}")
    return dict(vs_float64=errs, tf32_control_vs_float64=ctl, tol=tol)


def fast_inputs(seed, B, T, obs=8):
    rng = np.random.default_rng(seed)
    xs = (FAST_SCALE * rng.standard_normal((B, T, obs))).astype(np.float32)
    targets = rng.standard_normal((B, T, 32)).astype(np.float32)
    return torch.from_numpy(xs), torch.from_numpy(targets)


def euclid64_margins(xs, entries):
    """|d - 1.0| in float64 of EuclideanEdge's score (the mean over the
    batch's current nodes at step i) for each (b, i, s) of `entries`, s the
    source's step; xs [B, T, F] from an empty state."""
    if not len(entries):
        return []
    x = xs.double().cpu()
    b, i, s = (torch.as_tensor(c) for c in zip(*entries))
    d = (x[:, i].transpose(0, 1) - x[b, s][:, None]).norm(dim=-1).mean(-1)
    return (d - 1.0).abs().tolist()


def smallest_margin(xs, w=None):
    """The smallest |d - 1.0| in float64 over every candidate EuclideanEdge
    scores from an empty state: step i against the inputs of steps
    i - w .. i - 1 (all earlier steps where w is None), d the mean over the
    batch's current nodes at step i."""
    from gcm_tpu_torch.ops.distance import euclidean_score_per_step

    x = xs.double()
    T = x.shape[1]
    d = euclidean_score_per_step(x, x)  # [B, T, T]: step i, source j
    i = torch.arange(T, device=x.device)
    valid = i[None, :] < i[:, None]
    if w is not None:
        valid &= i[None, :] >= i[:, None] - w
    return float((d - 1.0).abs()[:, valid].min())


def row_flips(label, got, want, xs, to_entry):
    """The entries where two devices' (or two paths') edge rows differ:
    each must lie within NEAR_TIE of the threshold in float64. Returns the
    count and the largest margin."""
    diff = (got.cpu() != want.cpu()).nonzero().tolist()
    margins = euclid64_margins(xs, [to_entry(*e) for e in diff])
    worst = max(margins, default=0.0)
    check(worst < NEAR_TIE, f"{label}: an edge differs at margin {worst} "
          f">= {NEAR_TIE}")
    return dict(flips=len(diff), largest_flip_margin=worst)


def rates(secs, steps):
    """Timesteps/s of each reading: the median, min and max."""
    r = [steps / s for s in secs]
    return dict(median=statistics.median(r), min=min(r), max=max(r))


def gate_reading(scan_fn, window_fn, steps, label):
    """Window against scan in turns (scan, window, window, scan, after one
    warm call each): timesteps/s of both and whether the window won."""
    fns = {"scan": scan_fn, "window": window_fn}
    scan_fn(), window_fn()
    secs = {k: [] for k in fns}
    for name in ("scan", "window", "window", "scan"):
        secs[name].append(timed(fns[name])[1])
    row = {k: rates(v, steps) for k, v in secs.items()}
    row["window_wins"] = row["window"]["median"] > row["scan"]["median"]
    row["label"] = label
    return row


def train_fns(model, xs, targets, lr=1e-3, **window_kw):
    """(scan step, window step) of the model: one Adam step through its
    scan (make_dense_supervised_step) and through its window
    (make_window_supervised_step), each on its own copy of the weights."""
    import copy

    from gcm_tpu_torch import (make_dense_supervised_step,
                               make_window_supervised_step)

    a, b = copy.deepcopy(model), copy.deepcopy(model)
    s = make_dense_supervised_step(a, torch.optim.Adam(a.parameters(), lr))
    w = make_window_supervised_step(b, torch.optim.Adam(b.parameters(), lr),
                                    **window_kw)
    return (lambda: s(xs, targets)), (lambda: w(xs, targets))


def copy_to_cpu(model, cpu_model):
    cpu_model.load_state_dict({k: v.cpu() for k, v in
                               model.state_dict().items()})
    return cpu_model


def grads_match(label, model, cpu_model, tol=TOL_MODEL):
    """Every parameter's gradient on the card within tol of the CPU
    copy's (ZERO_GRAD: None on one side is zero)."""
    worst = 0.0
    for (name, p), q in zip(model.named_parameters(),
                            cpu_model.parameters()):
        g = p.grad.cpu() if p.grad is not None else torch.zeros_like(q)
        h = q.grad if q.grad is not None else torch.zeros_like(q)
        worst = max(worst, float((g - h).abs().max()))
    check(worst <= tol, f"{label}: gradients differ from the CPU copy by "
          f"{worst} > {tol}")
    return worst


def steps_vs_cpu(label, model, cpu_model, xs, targets, steps=3, lr=1e-3,
                 cpu_rows=None, **window_kw):
    """`steps` Adam steps through make_window_supervised_step on the card
    and on a CPU copy: losses and gradients within TOL_MODEL. cpu_rows: the
    card's edge rows, which the CPU copy's window takes where an edge
    flipped between the two (see `forced`)."""
    from gcm_tpu_torch import make_window_supervised_step

    copy_to_cpu(model, cpu_model)
    if cpu_rows is not None:
        def window(xs, st, dones=None):
            return on_rows(cpu_model, xs, st, cpu_rows)

        cpu_model.window = window
    step = make_window_supervised_step(
        model, torch.optim.Adam(model.parameters(), lr), **window_kw)
    cpu_step = make_window_supervised_step(
        cpu_model, torch.optim.Adam(cpu_model.parameters(), lr),
        **window_kw)
    losses, worst_loss, worst_grad = [], 0.0, 0.0
    for _ in range(steps):
        loss = float(step(xs.cuda(), targets.cuda()))
        want = float(cpu_step(xs, targets))
        worst_loss = max(worst_loss, abs(loss - want))
        worst_grad = max(worst_grad, grads_match(label, model, cpu_model))
        losses.append(loss)
    check(worst_loss <= TOL_MODEL and all(np.isfinite(losses)),
          f"{label}: losses {losses} differ from the CPU copy's by "
          f"{worst_loss}")
    return dict(steps=steps, losses=losses, loss_max_abs_err=worst_loss,
                grad_max_abs_err=worst_grad)


def on_rows(model, xs, st0, rows):
    """A fast core's one-chunk window from st0 teacher-forced on `rows`
    (the scored core's band rows [B, T, w], the ring's selector rows
    [B, T, N + T]): (beliefs, state)."""
    from gcm_tpu_torch.models import ring_window

    if hasattr(model, "_window"):
        return model._window(xs, st0, None, rows)
    return ring_window._window_chunk(model, xs, st0, rows=rows)


def launches_of(fn, wrappers):
    """fn's result and the launches of each named wrapper during it."""
    before = {k: w.launches for k, w in wrappers.items()}
    out = fn()
    return out, {k: w.launches - before[k] for k, w in wrappers.items()}


def fast_banded(row, wrappers, seed, B=32, T=256, Tw=128):
    """BandedRingGCM (hops (1,)): the scan over [32, 256, 8] against
    chained windows of 128 (beliefs 1e-5, the final state exact), against
    DenseGCM with TemporalBackedge([1]) (1e-5) and a CPU copy's window
    (1e-4); three Adam steps through make_window_supervised_step against a
    CPU copy; the gate."""
    model, dense = fast_core("banded", "cuda", seed)
    cpu_model, _ = fast_core("banded", "cpu", seed)
    xs, targets = fast_inputs(seed + 70, B, T)
    xs_c = xs.cuda()
    with torch.no_grad():
        (scan, scan_st), l_scan = launches_of(
            lambda: model.scan(xs_c, model.initial_state(B, 8)), wrappers)

        def chained():
            st, outs = model.initial_state(B, 8), []
            for lo in range(0, T, Tw):
                o, st = model.window(xs_c[:, lo:lo + Tw], st)
                outs.append(o)
            return torch.cat(outs, 1), st

        (win, win_st), l_win = launches_of(chained, wrappers)
        (want, _), l_dense = launches_of(
            lambda: dense.scan(xs_c, dense.initial_state(B, 8)), wrappers)
        cpu, _ = cpu_model.window(xs[:, :Tw], cpu_model.initial_state(B, 8))
    err_ws = float((win - scan).abs().max())
    exact = all(torch.equal(a, b) for a, b in zip(win_st, scan_st))
    err_dense = float((scan - want).abs().max())
    err_cpu = float((win[:, :Tw].cpu() - cpu).abs().max())
    check(bool(torch.isfinite(win).all()), "banded: non-finite beliefs")
    check(err_ws <= TOL_KERNEL and exact, f"banded: window vs scan {err_ws}, "
          f"final state equal {exact}")
    check(err_dense <= TOL_KERNEL, f"banded vs DenseGCM: {err_dense}")
    check(err_cpu <= TOL_MODEL, f"banded vs the CPU copy: {err_cpu}")
    check(l_scan["fused_dense_gnn"] == 0 and l_win["fused_dense_gnn"] == 0
          and l_dense["fused_dense_gnn"] == T,
          f"banded launches: scan {l_scan}, window {l_win}, dense {l_dense}")
    row["banded"] = dict(
        B=B, T=T, Tw=Tw, window_vs_scan_max_abs_err=err_ws,
        final_state_exact=exact, vs_dense_max_abs_err=err_dense,
        vs_cpu_max_abs_err=err_cpu,
        launches=dict(scan=l_scan, window=l_win, dense_scan=l_dense),
        train=steps_vs_cpu("banded train", model, cpu_model, xs[:, :Tw],
                           targets[:, :Tw]))
    return model, xs, targets


def scored_rows_of_scan(model, xs):
    """The scored core's scan step by step from an empty state, and the
    band row each step writes: (beliefs, rows [B, T, w])."""
    B, T = xs.shape[0], xs.shape[1]
    st, outs, rows = model.initial_state(B, 8), [], []
    b = torch.arange(B, device=xs.device)
    for t in range(T):
        out, st = model(xs[:, t], st)
        outs.append(out)
        rows.append(st.band[b, (st.t - 1).remainder(model.graph_size).long()])
    return torch.stack(outs, 1), torch.stack(rows, 1)


def dense_rows_of_scan(dense, xs, w):
    """DenseGCM's scan step by step from an empty state, and each step's
    inserted row as band offsets 1..w: (beliefs, rows [B, T, w])."""
    B, T = xs.shape[0], xs.shape[1]
    N = dense.graph_size
    st, outs, rows = dense.initial_state(B, 8), [], []
    b = torch.arange(B, device=xs.device)
    k = torch.arange(1, w + 1, device=xs.device)
    for t in range(T):
        out, st = dense(xs[:, t], st)
        r = (st.num_nodes - 1).long()  # the inserted row
        outs.append(out)
        adj_row = st.adj[b, r]  # [B, N]
        src = r[:, None] - k[None, :]
        rows.append(torch.where(src >= 0, torch.gather(
            adj_row, 1, src.clamp(0, N - 1)), 0.0))
    return torch.stack(outs, 1), torch.stack(rows, 1)


def fast_scored(row, wrappers, seed, B=32, T=256, Tw=128):
    """BandedScoredGCM with EuclideanEdge(1.0, window=32): the window
    against its scan (step by step, each step's band row recorded) and
    against DenseGCM with the same windowed selector, and a CPU copy's
    window, each teacher-forced onto the other side's rows where a score
    rounds across the threshold; three Adam steps against the CPU copy."""
    model, dense = fast_core("scored", "cuda", seed)
    cpu_model, _ = fast_core("scored", "cpu", seed)
    xs, targets = fast_inputs(seed + 71, B, T)
    xs_c = xs.cuda()
    w = model.window_size
    to_entry = (lambda b, i, k: (b, i, i - k - 1))
    with torch.no_grad():
        st0 = model.initial_state(B, 8)
        (win, win_st), l_win = launches_of(lambda: model.window(xs_c, st0),
                                           wrappers)
        rows = model._window_rows(xs_c, st0, None, None)[0]
        (scan, scan_rows), l_scan = launches_of(
            lambda: scored_rows_of_scan(model, xs_c), wrappers)
        (want, dense_rows), l_dense = launches_of(
            lambda: dense_rows_of_scan(dense, xs_c, w), wrappers)
        f_scan = row_flips("scored window vs scan", rows, scan_rows, xs,
                           to_entry)
        f_dense = row_flips("scored vs DenseGCM", scan_rows, dense_rows, xs,
                            to_entry)
        tf_scan = (on_rows(model, xs_c, st0, scan_rows)[0]
                   if f_scan["flips"] else win)
        tf_dense = (on_rows(model, xs_c, st0, dense_rows)[0]
                    if f_dense["flips"] else win)
        cpu_st0 = cpu_model.initial_state(B, 8)
        cpu_rows = cpu_model._window_rows(xs[:, :Tw], cpu_st0, None,
                                          None)[0]
        f_cpu = row_flips("scored vs the CPU copy", rows[:, :Tw], cpu_rows,
                          xs, to_entry)
        margin = smallest_margin(xs_c, w)
        train_rows = rows[:, :Tw].cpu() if f_cpu["flips"] else None
        cpu, _ = (on_rows(cpu_model, xs[:, :Tw], cpu_st0, train_rows)
                  if f_cpu["flips"] else
                  cpu_model.window(xs[:, :Tw], cpu_st0))
    err_ws = float((tf_scan - scan).abs().max())
    err_dense = float((tf_dense - want).abs().max())
    err_cpu = float((win[:, :Tw].cpu() - cpu).abs().max())
    check(bool(torch.isfinite(win).all()), "scored: non-finite beliefs")
    check(err_ws <= TOL_KERNEL, f"scored: window vs scan {err_ws}")
    check(err_dense <= TOL_KERNEL, f"scored vs DenseGCM: {err_dense}")
    check(err_cpu <= TOL_MODEL, f"scored vs the CPU copy: {err_cpu}")
    check(l_scan["fused_dense_gnn"] == 0 and l_win["fused_dense_gnn"] == 0
          and l_dense["fused_dense_gnn"] == T,
          f"scored launches: scan {l_scan}, window {l_win}, "
          f"dense {l_dense}")
    row["scored"] = dict(
        B=B, T=T, window=w, edges_per_row=float(rows.sum(-1).mean()),
        smallest_score_margin=margin,
        window_vs_scan_max_abs_err=err_ws, window_vs_scan=f_scan,
        vs_dense_max_abs_err=err_dense, vs_dense=f_dense,
        vs_cpu_max_abs_err=err_cpu, vs_cpu=f_cpu,
        launches=dict(scan=l_scan, window=l_win, dense_scan=l_dense),
        train=steps_vs_cpu("scored train", model, cpu_model, xs[:, :Tw],
                           targets[:, :Tw], cpu_rows=train_rows))
    return model, xs, targets


def fast_clique(row, wrappers, seed, B=32, T=128, Tw=64, N=512):
    """CliqueGCM at N = 512: the scan over [32, 128, 8] against chained
    windows of 64 in both impls (the final state exact) and against DenseGCM
    with DenseEdge, and each of them against a float64 witness (the gather
    window in float64), all within FAST_SUM_TOL["clique"], with the gather
    window in TF32 as the control; a CPU copy's window (1e-4); three Adam
    steps through make_window_supervised_step(impl="proj") against a CPU
    copy."""
    model, dense = fast_core("clique", "cuda", seed, N=N)
    cpu_model, _ = fast_core("clique", "cpu", seed, N=N)
    xs, targets = fast_inputs(seed + 72, B, T)
    xs_c = xs.cuda()
    tol = FAST_SUM_TOL["clique"]
    out = dict(B=B, T=T, Tw=Tw, graph_size=N)
    paths = {}
    with torch.no_grad():
        (scan, scan_st), l_scan = launches_of(
            lambda: model.scan(xs_c, model.initial_state(B, 8)), wrappers)
        paths["scan"] = scan
        for impl in ("gather", "proj"):
            def chained(impl=impl):
                st, outs = model.initial_state(B, 8), []
                for lo in range(0, T, Tw):
                    o, st = model.window(xs_c[:, lo:lo + Tw], st, impl=impl)
                    outs.append(o)
                return torch.cat(outs, 1), st

            (win, win_st), l_win = launches_of(chained, wrappers)
            paths[f"window_{impl}"] = win
            err = float((win - scan).abs().max())
            exact = all(torch.equal(a, b) for a, b in zip(win_st, scan_st))
            check(bool(torch.isfinite(win).all()) and err <= tol
                  and exact, f"clique {impl}: window vs scan {err} > {tol} "
                  f"or final state unequal ({exact})")
            check(l_win["fused_dense_gnn"] == 0, f"clique {impl}: {l_win}")
            out[f"window_{impl}"] = dict(vs_scan_max_abs_err=err,
                                         final_state_exact=exact,
                                         launches=l_win)
        (want, _), l_dense = launches_of(
            lambda: dense.scan(xs_c, dense.initial_state(B, 8)), wrappers)
        paths["dense_scan"] = want
        ref = float64_copy(model)
        ref_out, _ = ref.window(xs_c.double(), ref.initial_state(
            B, 8, dtype=torch.float64))
        with tf32_matmuls():
            ctl, _ = model.window(xs_c, model.initial_state(B, 8))
        cpu, _ = cpu_model.window(xs[:, :Tw], cpu_model.initial_state(B, 8),
                                  impl="proj")
    err_dense = float((scan - want).abs().max())
    err_cpu = float((scan[:, :Tw].cpu() - cpu).abs().max())
    check(err_dense <= tol, f"clique vs DenseGCM: {err_dense} > {tol}")
    check(err_cpu <= TOL_MODEL, f"clique vs the CPU copy: {err_cpu}")
    check(l_scan["fused_dense_gnn"] == 0
          and l_dense["fused_dense_gnn"] == T,
          f"clique launches: scan {l_scan}, dense {l_dense}")
    out.update(vs_dense_max_abs_err=err_dense, vs_cpu_max_abs_err=err_cpu,
               witness=witness_check("clique", ref_out, paths, ctl, tol),
               launches=dict(scan=l_scan, dense_scan=l_dense),
               train=steps_vs_cpu("clique train", model, cpu_model,
                                  xs[:, :Tw], targets[:, :Tw], impl="proj"))
    row["clique"] = out
    return model, xs, targets


def ring_scan_rows(adj_F, T, N):
    """The scan's selector rows over the window's extended source space,
    from its final adjacency: from an empty state with T <= N, row p_i =
    slot i holds step i's row and source slot s < i is insert s."""
    B = adj_F.shape[0]
    rows = torch.zeros((B, T, N + T), dtype=torch.float32,
                       device=adj_F.device)
    rows[:, :, N:] = torch.tril(adj_F[:, :T, :T].float(), diagonal=-1)
    return rows


def fast_ring(row, wrappers, seed, B=32, T=320, N=1024, T_cpu=64):
    """RingDenseGCM(EuclideanEdge(1.0)) at N = 1,024: the window over
    [32, 320, 8] against the ring scan, teacher-forced onto the scan's rows
    where an edge flipped (only within 1e-5 of the threshold): the final
    state exact; window and scan each against a float64 witness (the
    window in float64 on the scan's rows), all within FAST_SUM_TOL["ring"],
    with the window in TF32 as the control; a CPU copy's window at T = 64
    (1e-4), on the card's rows where an edge flipped; three Adam steps
    through make_trajectory_supervised_step (the branch its gate picks)
    and, at T = 64, three make_window_supervised_step steps against the
    CPU copy."""
    from gcm_tpu_torch import make_trajectory_supervised_step
    from gcm_tpu_torch.models import ring_window

    model, _ = fast_core("ring", "cuda", seed, N=N)
    cpu_model, _ = fast_core("ring", "cpu", seed, N=N)
    xs, targets = fast_inputs(seed + 73, B, T)
    xs_c = xs.cuda()
    tol = FAST_SUM_TOL["ring"]
    to_entry = (lambda b, i, e: (b, i, e - N))
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        st0 = model.initial_state(B, 8)
        (win, win_st), l_win = launches_of(lambda: model.window(xs_c, st0),
                                           wrappers)
        fwd_peak = torch.cuda.max_memory_allocated()
        rows = ring_window._window_rows(model, xs_c, st0)
        (scan, scan_st), l_scan = launches_of(
            lambda: model.scan(xs_c, st0), wrappers)
        scan_rows = ring_scan_rows(scan_st.adj, T, N)
        f_scan = row_flips("ring window vs scan", rows, scan_rows, xs,
                           to_entry)
        tf, tf_st = (on_rows(model, xs_c, st0, scan_rows)
                     if f_scan["flips"] else (win, win_st))
        ref = float64_copy(model)
        ref_out, _ = on_rows(ref, xs_c.double(), ref.initial_state(
            B, 8, dtype=torch.float64), scan_rows)
        with tf32_matmuls():
            ctl, _ = on_rows(model, xs_c, st0, scan_rows)
        del ref
        margin = smallest_margin(xs_c)
        cpu_st0 = cpu_model.initial_state(B, 8)
        card_rows = rows[:, :T_cpu, :N + T_cpu].cpu()
        f_cpu = row_flips("ring window vs the CPU copy", card_rows,
                          ring_window._window_rows(cpu_model, xs[:, :T_cpu],
                                                   cpu_st0), xs, to_entry)
        cpu_rows = card_rows if f_cpu["flips"] else None
        cpu, _ = (on_rows(cpu_model, xs[:, :T_cpu], cpu_st0, cpu_rows)
                  if f_cpu["flips"] else
                  cpu_model.window(xs[:, :T_cpu], cpu_st0))
    err_ws = float((tf - scan).abs().max())
    exact = all(torch.equal(a, b) for a, b in zip(tf_st, scan_st))
    win_cpu, _ = model.window(xs_c[:, :T_cpu], st0)
    err_cpu = float((win_cpu.detach().cpu() - cpu).abs().max())
    check(bool(torch.isfinite(win).all()), "ring window: non-finite")
    check(err_ws <= tol and exact, f"ring window vs scan {err_ws} > {tol} "
          f"or final state unequal ({exact})")
    check(err_cpu <= TOL_MODEL, f"ring window vs the CPU copy: {err_cpu}")
    check(l_win["fused_dense_gnn"] == 0 and l_scan["fused_dense_gnn"] == T,
          f"ring launches: window {l_win}, scan {l_scan}")
    witness = witness_check("ring", ref_out, {"window": tf, "scan": scan},
                            ctl, tol)
    torch.cuda.reset_peak_memory_stats()
    step = make_trajectory_supervised_step(
        model, torch.optim.Adam(model.parameters(), 1e-3))
    (losses, l_step) = launches_of(
        lambda: [float(step(xs_c, targets.cuda())) for _ in range(3)],
        wrappers)
    train_peak = torch.cuda.max_memory_allocated()
    check(all(np.isfinite(losses)), f"ring trajectory step: {losses}")
    want_step = ({"fused_dense_gnn": 0, "fused_dense_gnn_bwd": 0}
                 if step.use_window else
                 {"fused_dense_gnn": 3 * T, "fused_dense_gnn_bwd": 3 * T})
    check(all(l_step[k] == v for k, v in want_step.items()),
          f"ring trajectory step launches {l_step}, expected {want_step}")
    total = torch.cuda.get_device_properties(0).total_memory
    row["ring_window"] = dict(
        B=B, T=T, graph_size=N, edges_per_row=float(rows.sum(-1).mean()),
        smallest_score_margin=margin,
        chunk=dict(forward=ring_window.max_chunk_len(model, B, 8),
                   train=ring_window.max_chunk_len(model, B, 8, "train")),
        peak_gib=dict(forward=fwd_peak / 2 ** 30, train=train_peak / 2 ** 30,
                      card=total / 2 ** 30),
        window_vs_scan_max_abs_err=err_ws, final_state_exact=exact,
        window_vs_scan=f_scan, witness=witness,
        vs_cpu_max_abs_err=err_cpu, vs_cpu=f_cpu,
        launches=dict(window=l_win, scan=l_scan, trajectory_steps=l_step),
        trajectory_step=dict(branch="window" if step.use_window else "scan",
                             losses=losses),
        train_vs_cpu=steps_vs_cpu(
            "ring train", model, cpu_model, xs[:, :T_cpu],
            targets[:, :T_cpu], cpu_rows=cpu_rows))
    return model, xs, targets


def fast_gates(seed, B=32):
    """Each fast core's window against its scan, forward and train (one
    Adam step), timesteps/s in turns: the banded cores at N = 128 (T = 256
    forward in chained windows of 128, T = 128 train), the clique core at
    N = 128, 512 and 1,024 (T = 128, windows of 64), the ring core at
    N = 32, 128, 256, 512 and 1,024 (T = 128). Returns the readings,
    whether the window won at every point of a core and mode (the rule its
    gate follows) and the gate's answer at each point."""
    out, answers = {}, {}
    for kind in ("banded", "scored"):
        model, _ = fast_core(kind, "cuda", seed)
        xs, targets = fast_inputs(seed + 80, B, 256)
        xs_c = xs.cuda()

        def fwd_scan(model=model, xs_c=xs_c):
            with torch.no_grad():
                return model.scan(xs_c, model.initial_state(B, 8))

        def fwd_win(model=model, xs_c=xs_c):
            with torch.no_grad():
                st = model.initial_state(B, 8)
                for lo in range(0, 256, 128):
                    _, st = model.window(xs_c[:, lo:lo + 128], st)

        s, w = train_fns(model, xs_c[:, :128], targets[:, :128].cuda())
        out[kind] = [dict(graph_size=128, forward=gate_reading(
            fwd_scan, fwd_win, B * 256, "T 256"), train=gate_reading(
            s, w, B * 128, "T 128"))]
        answers[kind] = [gate_answers(model)]
    clique = []
    for N in CLIQUE_GATE_N:
        model, _ = fast_core("clique", "cuda", seed, N=N)
        xs, targets = fast_inputs(seed + 81, B, 128)
        xs_c = xs.cuda()

        def fwd_scan(model=model, xs_c=xs_c):
            with torch.no_grad():
                return model.scan(xs_c, model.initial_state(B, 8))

        def fwd_win(model=model, xs_c=xs_c):
            with torch.no_grad():
                st = model.initial_state(B, 8)
                for lo in range(0, 128, 64):
                    _, st = model.window(xs_c[:, lo:lo + 64], st,
                                         impl="proj")

        s, w = train_fns(model, xs_c, targets.cuda(), impl="proj")
        clique.append(dict(graph_size=N, forward=gate_reading(
            fwd_scan, fwd_win, B * 128, f"N {N}"), train=gate_reading(
            s, w, B * 128, f"N {N}")))
        answers.setdefault("clique", []).append(gate_answers(model))
    out["clique"] = clique
    ring = []
    for N in RING_GATE_N:
        model, _ = fast_core("ring", "cuda", seed, N=N)
        xs, targets = fast_inputs(seed + 82, B, 128)
        xs_c = xs.cuda()

        def fwd_scan(model=model, xs_c=xs_c):
            with torch.no_grad():
                return model.scan(xs_c, model.initial_state(B, 8))

        def fwd_win(model=model, xs_c=xs_c):
            with torch.no_grad():
                return model.window(xs_c, model.initial_state(B, 8))

        s, w = train_fns(model, xs_c, targets.cuda())
        ring.append(dict(graph_size=N, forward=gate_reading(
            fwd_scan, fwd_win, B * 128, f"N {N}"), train=gate_reading(
            s, w, B * 128, f"N {N}")))
        answers.setdefault("ring", []).append(gate_answers(model))
    out["ring"] = ring
    out["window_won_everywhere"] = {
        k: {m: all(r[m]["window_wins"] for r in out[k])
            for m in ("forward", "train")} for k in answers}
    out["gate_answers"] = answers
    return out


def gate_answers(model):
    """The core's window_profitable answer by mode."""
    return {m: model.window_profitable(m) for m in ("forward", "train")}


def fast_phase(card: str, seed: int = 0):
    """The scan-free fast cores (models/banded_gcm.py, clique_gcm.py,
    ring_window.py) and the window and trajectory train steps at the JAX
    package's benchmark widths: each window against its own scan, against
    the port's DenseGCM / RingDenseGCM scan with the equivalent selector
    and against a CPU copy; timesteps/s of scan and window in turns; one
    profiled window and training step a core; the gates' readings; the
    launches of fused_dense_gnn (row 1), sddmm_threshold_row (row 5) and
    fused_dense_gnn_bwd (row A) of each part (the fast cores launch none:
    the dense and ring scans theirs)."""
    from gcm_tpu_torch import make_window_supervised_step
    from gcm_tpu_torch.ops.cuda.fused_gnn import (fused_dense_gnn,
                                                  fused_dense_gnn_bwd)
    from gcm_tpu_torch.ops.cuda.sddmm import sddmm_threshold_row

    t_phase = time.perf_counter()
    wrappers = {"fused_dense_gnn": fused_dense_gnn,
                "sddmm_threshold_row": sddmm_threshold_row,
                "fused_dense_gnn_bwd": fused_dense_gnn_bwd}
    row = dict(card=card, input_scale=FAST_SCALE)
    profiled = {}
    for kind, run in (("banded", fast_banded), ("scored", fast_scored),
                      ("clique", fast_clique), ("ring_window", fast_ring)):
        model, xs, targets = run(row, wrappers, seed)
        T = {"banded": 128, "scored": 128, "clique": 64,
             "ring_window": xs.shape[1]}[kind]
        xs_c, tg_c = xs[:, :T].cuda(), targets[:, :T].cuda()
        kw = {"impl": "proj"} if kind == "clique" else {}
        step = make_window_supervised_step(
            model, torch.optim.Adam(model.parameters(), 1e-3), **kw)

        def window(model=model, xs_c=xs_c, kw=kw):
            with torch.no_grad():
                model.window(xs_c, model.initial_state(xs_c.shape[0], 8),
                             **kw)

        profiled[kind] = dict(
            T=T, window=profile_calls(window, n=3),
            train_step=profile_calls(lambda: step(xs_c, tg_c), n=3))
    row["profiled"] = profiled
    (gates, l_gates) = launches_of(lambda: fast_gates(seed), wrappers)
    row["gates"] = gates
    row["launches_gates"] = l_gates
    emit("fast", seconds=time.perf_counter() - t_phase, **row)


KERNEL_META = {
    "fused_dense_gnn": dict(
        source="gcm_tpu_torch/csrc/dense_gnn.cu",
        replaces="gcm_tpu/ops/pallas/fused_gnn.py:83"),
    "fused_dense_graph_conv": dict(
        source="gcm_tpu_torch/csrc/dense_gnn.cu",
        replaces="gcm_tpu/ops/pallas/dense_gconv.py:51"),
    "spmm_edge_list": dict(
        source="gcm_tpu_torch/csrc/spmm.cu",
        replaces="gcm_tpu/ops/pallas/spmm.py:104"),
    "spmm_slots": dict(
        source="gcm_tpu_torch/csrc/spmm_slots.cu",
        replaces="gcm_tpu/ops/pallas/spmm_slots.py:66"),
    "sddmm_threshold_row": dict(
        source="gcm_tpu_torch/csrc/sddmm.cu",
        replaces="gcm_tpu/ops/pallas/sddmm.py:63"),
    "spmm_pairs": dict(
        source="gcm_tpu_torch/csrc/spmm_pairs.cu",
        replaces="gcm_tpu/ops/pallas/spmm2.py:118"),
    "spmm_seg": dict(
        source="gcm_tpu_torch/csrc/spmm_seg.cu",
        replaces="gcm_tpu/ops/pallas/spmm_seg.py:97"),
    "spmm_prefetch": dict(
        source="gcm_tpu_torch/csrc/spmm_prefetch.cu",
        replaces="gcm_tpu/ops/pallas/spmm_prefetch.py:95"),
    "spmm_onehot_dtype": dict(
        source="gcm_tpu_torch/csrc/spmm.cu",
        replaces="benchmarks/spmm_variants.py:177"),
    "spmm_win": dict(
        source="gcm_tpu_torch/csrc/spmm_win.cu",
        replaces="benchmarks/spmm_variants.py:260"),
    "take_rows": dict(
        source="gcm_tpu_torch/csrc/gather.cu",
        replaces="benchmarks/spmm_variants.py:287"),
    "take_lanes": dict(
        source="gcm_tpu_torch/csrc/gather.cu",
        replaces="benchmarks/spmm_variants.py:287"),
    "take_rows_loop": dict(
        source="gcm_tpu_torch/csrc/gather.cu",
        replaces="benchmarks/spmm_variants.py:287"),
    "fused_dense_gnn_bwd": dict(
        source="gcm_tpu_torch/csrc/dense_gnn_bwd.cu",
        replaces="gcm_tpu/ops/pallas/fused_gnn.py:139"),
    "edge_weight_grad": dict(
        source="gcm_tpu_torch/csrc/edge_grad.cu",
        replaces="gcm_tpu/ops/dispatch.py:40"),
}


def ptxas_lines(src: str) -> list[str]:
    """The lines of a source's build log (-Xptxas -v) that give each
    kernel's registers and spills, each led by its source and kernel."""
    from gcm_tpu_torch.ops import _build

    lines, kernel = [], "?"
    for ln in _build.build_log(src).splitlines():
        if "Compiling entry function" in ln:
            kernel = ln.split("'")[1]
        elif "registers" in ln or "spill" in ln:
            lines.append(f"{src} {kernel}: "
                         + ln.replace("ptxas info    :", "").strip())
    return lines


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    name = torch.cuda.get_device_name(0)
    emit("device", name=name, count=torch.cuda.device_count(),
         nvidia_smi=card, torch=torch.__version__, cuda=torch.version.cuda)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from gcm_tpu_torch.ops import _build
    from gcm_tpu_torch.ops.cuda.dense_gconv import fused_dense_graph_conv
    from gcm_tpu_torch.ops.cuda.edge_grad import edge_weight_grad
    from gcm_tpu_torch.ops.cuda.fused_gnn import (fused_dense_gnn,
                                                  fused_dense_gnn_bwd)
    from gcm_tpu_torch.ops.cuda.gather import (take_lanes, take_rows,
                                               take_rows_loop)
    from gcm_tpu_torch.ops.cuda.sddmm import sddmm_threshold_row
    from gcm_tpu_torch.ops.cuda.spmm import spmm_edge_list, spmm_onehot_dtype
    from gcm_tpu_torch.ops.cuda.spmm2 import spmm_pairs
    from gcm_tpu_torch.ops.cuda.spmm_prefetch import spmm_prefetch
    from gcm_tpu_torch.ops.cuda.spmm_seg import spmm_seg
    from gcm_tpu_torch.ops.cuda.spmm_slots import spmm_slots
    from gcm_tpu_torch.ops.cuda.spmm_win import spmm_win

    t0 = time.perf_counter()
    waited = _build.build_all()
    ptxas = [ln for src in waited for ln in ptxas_lines(src)]
    emit("build", seconds=time.perf_counter() - t0, sources=waited,
         ptxas=ptxas)
    spills = [ln for ln in ptxas
              if ln.startswith(("dense_gnn_bwd ", "edge_grad "))
              and "spill" in ln and "0 bytes spill stores, 0 bytes spill "
              "loads" not in ln]
    check(not spills, f"the stack backward or the edge weight-gradient "
          f"spills: {spills}")

    rows = [kernel_case(*case[:6], seed=i, main_path=case[6])
            for i, case in enumerate(KERNEL_CASES)]
    rows += [spmm_case(*case[:5], seed=i, main_path=case[5])
             for i, case in enumerate(SPMM_CASES)]
    rows += [slots_case(*case[:6], seed=i, main_path=case[6])
             for i, case in enumerate(SLOTS_CASES)]
    rows += [sddmm_current_case(*case[:8], seed=i, main_path=case[8])
             for i, case in enumerate(SDDMM_CURRENT_CASES)]
    rows += [sddmm_case(*case[:6], seed=i, main_path=case[6])
             for i, case in enumerate(SDDMM_CASES)]
    rows += [variant_case(*case[:7], seed=i, main_path=case[7])
             for i, case in enumerate(VARIANT_CASES)]
    rows += [win_case(*case[:6], seed=i, main_path=case[6])
             for i, case in enumerate(WIN_CASES)]
    rows += [gather_case(*case[:2], seed=i, main_path=case[2])
             for i, case in enumerate(GATHER_CASES)]
    rows += [dense_bwd_case(*case[:7], seed=i, main_path=case[7])
             for i, case in enumerate(DENSE_BWD_CASES)]
    routes = {r["case"]: tuple(r["plan"][k] for k in BWD_ROUTE_KEYS)
              for r in rows if r["kernel"] == "fused_dense_gnn_bwd"}
    check(set(routes.values()) == BWD_ROUTES,
          f"the stack backward's cases take routes {routes}, not each of "
          f"{sorted(BWD_ROUTES)}")
    rows += [edge_grad_case(*case[:6], seed=i, main_path=case[6])
             for i, case in enumerate(EDGE_GRAD_CASES)]
    grad_rows = [r for r in rows if r["kernel"] == "edge_weight_grad"]
    routes = {r["case"]: edge_grad_route(r) for r in grad_rows}
    check(set(routes.values()) == EDGE_GRAD_ROUTES,
          f"the edge weight-gradient's cases take routes {routes}, not each "
          f"of {sorted(EDGE_GRAD_ROUTES)}")
    check(any(r["plan"]["tiles"] > 1 for r in grad_rows),
          "no edge weight-gradient case's own plan takes two tiles or more")
    launch_floor()
    refusal_phase()
    sparse_refusal_phase()
    sddmm_refusal_phase()
    variant_refusal_phase()
    win_gather_refusal_phase()

    wrappers = {"fused_dense_gnn": fused_dense_gnn,
                "fused_dense_graph_conv": fused_dense_graph_conv,
                "spmm_edge_list": spmm_edge_list, "spmm_slots": spmm_slots,
                "sddmm_threshold_row": sddmm_threshold_row,
                "spmm_pairs": spmm_pairs, "spmm_seg": spmm_seg,
                "spmm_prefetch": spmm_prefetch,
                "spmm_onehot_dtype": spmm_onehot_dtype,
                "spmm_win": spmm_win,
                "take_rows": take_rows, "take_lanes": take_lanes,
                "take_rows_loop": take_rows_loop,
                "fused_dense_gnn_bwd": fused_dense_gnn_bwd,
                "edge_weight_grad": edge_weight_grad}
    paths = [  # (phase, the kernels its path launches)
        (serve_phase, ("fused_dense_gnn",)),
        (scan_phase, ("fused_dense_gnn", "fused_dense_graph_conv")),
        (sparse_phase, ("spmm_edge_list", "spmm_slots")),
        (selector_phase, ("fused_dense_gnn", "sddmm_threshold_row")),
        (sweep_phase, ("spmm_edge_list", "spmm_onehot_dtype", "spmm_pairs",
                       "spmm_seg", "spmm_prefetch", "spmm_win", "take_rows",
                       "take_lanes", "take_rows_loop")),
        (gradient_phase, ("spmm_pairs", "spmm_seg", "spmm_edge_list",
                          "edge_weight_grad")),
        (train_phase, ("fused_dense_gnn", "fused_dense_gnn_bwd",
                       "spmm_edge_list", "spmm_slots", "edge_weight_grad")),
        (options_phase, ("fused_dense_gnn", "spmm_edge_list", "spmm_slots")),
        (gate_phase, ("spmm_edge_list",)),
        (ring_phase, ("fused_dense_gnn", "sddmm_threshold_row")),
        (rl_phase, ("fused_dense_gnn", "fused_dense_gnn_bwd",
                    "spmm_edge_list")),
        (host_phase, ("spmm_edge_list",)),
        (nav_phase, ("fused_dense_graph_conv", "fused_dense_gnn_bwd")),
        (fast_phase, ("fused_dense_gnn", "fused_dense_gnn_bwd")),
    ]
    launches = dict.fromkeys(wrappers, 0)
    for phase, kernels in paths:
        for fn in wrappers.values():
            fn.launches = 0
        phase(card)
        for k, fn in wrappers.items():
            launches[k] += fn.launches
        for k in kernels:
            check(wrappers[k].launches > 0,
                  f"{k} was not launched on the {phase.__name__} path")

    kernels = []
    for k, meta in KERNEL_META.items():
        main_row = next(r for r in rows if r["kernel"] == k and r["main_path"])
        kernels.append(dict(
            name=k, route="cuda", **meta, launches=launches[k],
            max_abs_err=max(r["max_abs_err"] for r in rows
                            if r["kernel"] == k),
            ms=main_row["ms"], plain_ms=main_row["plain_ms"],
            bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"],
            library_ms=main_row["library_ms"]))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
