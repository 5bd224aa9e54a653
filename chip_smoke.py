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
   kernels at cases that reach every instantiation of csrc/dense_gnn.cu;
   then inputs the kernels do not take (misaligned, wrong graph size,
   float64) must raise, unlaunched;
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
   served ticks with a profiled window each and two rounds of scans.
8. sweep: the SpMM variant sweep (gcm_tpu_torch/benchmarks/spmm_variants.py)
   as its script runs it: the gather probe through take_rows, take_lanes
   and take_rows_loop (each "ok"), then its 15 rows at full width, B=64,
   N=512, E=8192, F=128, every row checked against the plain scatter (1e-3;
   0.5 for bf16) and timed in edges/s, through spmm_edge_list,
   spmm_onehot_dtype, spmm_win, spmm_pairs, spmm_seg and spmm_prefetch,
   with no row of the JAX script left out.
Phase 3 also holds spmm_edge_list (bitwise: kernel and plain version add
in lane order) and spmm_slots (1e-5) against their plain versions beside
one torch.sparse.mm call on a block-diagonal COO matrix of the same edges,
sddmm_threshold_row bitwise against its plain version beside a bmm + norms
+ compare chain, and the variant kernels spmm_pairs (f32x2, bf16),
spmm_seg, spmm_prefetch, spmm_onehot_dtype and spmm_win (f32, bf16)
bitwise against theirs (which add in the kernels' order) at the sweep's
point, at odd shapes with sentinels and out-of-range indices (spmm_win on
raw lanes whose sinks leave their windows), a segment spanning two chunks,
benchmarks/drive_r5c.py's shape and empty edge lists, beside the same
torch.sparse.mm; the gathers take_rows, take_lanes and take_rows_loop bit
for bit against theirs (NaN where NaN) at the probe's shapes, at the
sweep's message gather ([32768, 128] by 524,288 indices; lanes [32768,
512] by [32768, 128]), with indices past either end and, for
take_rows_loop, at 65,536 rows, beside index_select / torch.gather; it checks every kernel's refusals, and runs
spmm_pairs and spmm_seg forward and backward against autograd through
their plain versions (dx and dw within 1e-4, exact launch counts).
Phases 4-8 each run with every launch count set to 0 just before and
read just after; each must launch the kernels of its path.
Then the kernels line and, last, {"ok": true, "device": {...}}. Any failed
check raises, so the script exits non-zero and prints no result.
"""

from __future__ import annotations

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


def kernel_row(name, shape, main_path, kernel, plain, library, bound,
               tol=TOL_KERNEL, nan_fills=False):
    """Checks a kernel against its plain version (within tol, two launches
    bitwise equal) and times the kernel, the plain version and the library
    call; emits and returns the row. Boolean outputs compare as 0/1. The
    kernel's output must be finite, unless nan_fills (the gathers' fills
    past the end): then it must be NaN exactly where the plain version's
    is."""
    got = kernel()
    torch.cuda.synchronize()
    want = plain()
    err = max_abs_err(got, want, nan_fills)
    again = kernel()
    torch.cuda.synchronize()
    lib_err = max_abs_err(library(), want, nan_fills)
    ms, call_ms = time_ms(kernel)
    plain_ms, plain_call_ms = time_ms(plain)
    library_ms, library_call_ms = time_ms(library)
    row = dict(kernel=name, **shape, main_path=main_path, max_abs_err=err,
               bitwise_repeatable=bitwise_equal(got, again),
               ms=ms, plain_ms=plain_ms, library_ms=library_ms,
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
    check(err <= tol, f"{name} {shape}: max abs err {err} > {tol}")
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
]


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
    x100, adj100, *flat100 = make_case(2, 112, (32, 32), seed=99)
    adj100 = adj100[:, :100, :100].contiguous()
    x100 = x100[:, :100].contiguous()
    cases = {
        "misaligned_adj": lambda: fused_dense_gnn(x, misaligned, flat,
                                                  ("tanh",)),
        "graph_size_100": lambda: fused_dense_graph_conv(x100, adj100,
                                                         *flat100),
        "float64": lambda: fused_dense_graph_conv(x.double(), adj.double(),
                                                  *(p.double() for p in flat)),
    }
    refuse_all(cases, (fused_dense_gnn, fused_dense_graph_conv))


# -- phase 3, continued: the SpMM kernels ---------------------------------------

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


def slots_case(case, B, N, F, k, hops, seed, main_path):
    from gcm_tpu_torch.benchmarks.spmm_variants import block_diagonal_coo
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
    coo = block_diagonal_coo(edges, w, N)
    x2 = x.reshape(B * N, F)
    P = (N // W) ** 2
    return kernel_row(
        "spmm_slots", dict(case=case, B=B, N=N, F=F, k=k), main_path,
        kernel=lambda: spmm_slots(x, srcs, ws, N, k),
        plain=lambda: spmm_slots_plain(x, srcs, ws, k),
        library=lambda: torch.sparse.mm(coo, x2).reshape(B, N, F),
        bound=bound_ms(4 * B * (2 * F * N + 2 * P * k * W),
                       2 * int(coo.values().numel()) * F))


SPMM_CASES = [
    # (case, B, N, F, E, main_path)
    ("main path", 32, 128, 32, 512, True),
    ("wide", 64, 512, 128, 8192, False),
    ("odd", 3, 12, 13, 37, False),
    ("empty", 4, 128, 32, 64, False),
]
SLOTS_CASES = [
    # (case, B, N, F, k, hops, main_path)
    ("main path", 32, 128, 32, 1, (1,), True),
    ("many hops", 64, 512, 128, 12, tuple(range(1, 13)), False),
    ("odd", 2, 256, 13, 2, (1, 2), False),
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


def sddmm_bound_ms(B, N, F, mode):
    """Inputs read once, the bool row written once; the operations the
    score needs (euclidean: sub, mul, add per feature and a sqrt per node;
    cosine: the dot and the node's norm per feature, curr's norm once per
    batch element, a sqrt, a product and a division per node)."""
    nbytes = 4 * (B * F + B * N * F + B) + B * N
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
    got = sddmm_threshold_row(curr, nodes, num_nodes, thr, mode)
    check(bool(got.any()) and not bool(got.all()),
          f"sddmm {case} {mode}: a constant mask tests nothing")
    check(not bool(got[0].any()), f"sddmm {case} {mode}: num_nodes 0 has "
          "edges")
    return row


SDDMM_CASES = [
    # (case, B, N, F, mode, threshold, main_path): the served shape with
    # CosineEdge(0.5) on the raw obs and SpatialEdge(0.25) on a 2-wide pose
    # slice, a wide and an odd shape
    ("served cosine", 256, 128, 8, "cosine", 0.5, True),
    ("served spatial", 256, 128, 2, "euclidean", 0.25, True),
    ("wide", 64, 512, 128, "cosine", 0.0, False),
    ("wide", 64, 512, 128, "euclidean", 16.0, False),
    ("odd", 3, 13, 5, "cosine", 0.2, False),
    ("odd", 3, 13, 5, "euclidean", 3.0, False),
]


def sddmm_refusal_phase() -> None:
    """Inputs the score-row kernel does not take raise on the card before
    any launch."""
    from gcm_tpu_torch.ops.cuda.sddmm import sddmm_threshold_row

    curr, nodes, num_nodes = sddmm_inputs(4, 16, 8, seed=97)
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


# -- phase 6: the sparse core ---------------------------------------------------

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


def run_windows(model, xs, taus, state, window):
    """The whole-window forward over xs [B, T, F] in chained windows."""
    outs = []
    for w0 in range(0, xs.shape[1], window):
        out, state, aux = model(xs[:, w0:w0 + window], taus, state,
                                return_aux=True)
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


# -- phase 7: the README DenseGCM with the other dense selectors ---------------

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
        row["scan_timesteps_per_s_in_turns"] = scan_timing(kinds, B, T)
    emit("selectors", **row)


# -- phase 8: the SpMM variants and their sweep --------------------------------

def variant_inputs(case, B, N, F, E, seed):
    """x, edges, weights on the card for a variant case: spmm_inputs', and
    for "chunk spanning" 200 edges into sink 7 (two 128-lane chunks of its
    bucket) before the random ones."""
    x, edges, w = spmm_inputs("odd" if case == "odd" else
                              "empty" if case == "empty" else "wide",
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
    if kernel == "spmm_pairs":
        cap = pair_cap(N, E)
        be, bw, counts = spmm2.bucket_edges_pairs(edges, w, N, cap)
        spmm2.check_bucket_overflow(counts, cap)
        shape["cap"] = cap
        run = (lambda: spmm2.spmm_pairs(x, be, bw, N, cap, mode),
               lambda: spmm2.spmm_pairs_plain(x, be, bw, cap, mode, depth))
        nbytes = 4 * xy + lane_bytes(be[:, 0])
    elif kernel == "spmm_seg":
        cap = pair_cap(N, E)
        be, bw, begin, end, tot = spmm_seg.bucket_edges_segments(edges, w, N,
                                                                 cap)
        spmm2.check_bucket_overflow(tot, cap)
        shape["cap"] = cap
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
]


def variant_refusal_phase() -> None:
    """Inputs the variant kernels do not take raise on the card before any
    launch: float64, int64 indices, wrong shapes, non-contiguous or CPU
    tensors, a graph or cap off the 128 grid, too many rows per sink block,
    an unknown dtype, and a tracked input into the forward-only kernel."""
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
        "prefetch_rows_per_block": lambda: bucketed(
            torch.zeros((1, 1024, 8), device="cuda"),
            torch.zeros((1, 1, 4), dtype=torch.int32, device="cuda"),
            torch.zeros((1, 1, 4), dtype=torch.int32, device="cuda"),
            torch.zeros((1, 1, 4), device="cuda"), 1024),
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
    the sweep's uniform edges bucketed at cap; "odd": raw lanes (sinks
    outside their segment's window, sentinels, indices of N or more) as the
    layout; "empty": all lanes -1."""
    from gcm_tpu_torch.benchmarks.spmm_variants import block_diagonal_coo
    from gcm_tpu_torch.ops.cuda import spmm_win as win_mod

    n_win = N // 128
    if case == "sweep":
        x, edges, w = variant_inputs("wide", B, N, F, 8192, seed)
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


def gradient_phase(B=64, N=512, F=128, E=8192, seed=95) -> None:
    """spmm_pairs and spmm_seg forward and backward on the card against
    autograd through their plain versions on the card: out within
    TOL_KERNEL, dx and dw within TOL_MODEL; one forward and backward
    launches exactly two spmm_pairs, or one spmm_seg and one
    spmm_edge_list."""
    from gcm_tpu_torch.benchmarks.spmm_variants import pair_cap
    from gcm_tpu_torch.ops.cuda import spmm as spmm_mod
    from gcm_tpu_torch.ops.cuda import spmm2, spmm_seg

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
                       {spmm2.spmm_pairs: 2}),
        "spmm_seg": (se[1],
                     lambda a, b: spmm_seg.spmm_seg(a, se[0], b, *se[2:4], N,
                                                    cap),
                     lambda a, b: spmm_seg.spmm_seg_plain(a, se[0], b,
                                                          *se[2:4], cap),
                     {spmm_seg.spmm_seg: 1, spmm_mod.spmm_edge_list: 1}),
    }
    row = dict(B=B, N=N, F=F, E=E, cap=cap)
    every = (spmm2.spmm_pairs, spmm_seg.spmm_seg, spmm_mod.spmm_edge_list)
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


# -- main ---------------------------------------------------------------------

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
}


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
    from gcm_tpu_torch.ops.cuda.fused_gnn import fused_dense_gnn
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
    ptxas = [ln.strip() for src in waited for ln in
             _build.build_log(src).splitlines()
             if "registers" in ln or "spill" in ln]
    emit("build", seconds=time.perf_counter() - t0, sources=waited,
         ptxas=ptxas)

    rows = [kernel_case(*case[:6], seed=i, main_path=case[6])
            for i, case in enumerate(KERNEL_CASES)]
    rows += [spmm_case(*case[:5], seed=i, main_path=case[5])
             for i, case in enumerate(SPMM_CASES)]
    rows += [slots_case(*case[:6], seed=i, main_path=case[6])
             for i, case in enumerate(SLOTS_CASES)]
    rows += [sddmm_case(*case[:6], seed=i, main_path=case[6])
             for i, case in enumerate(SDDMM_CASES)]
    rows += [variant_case(*case[:7], seed=i, main_path=case[7])
             for i, case in enumerate(VARIANT_CASES)]
    rows += [win_case(*case[:6], seed=i, main_path=case[6])
             for i, case in enumerate(WIN_CASES)]
    rows += [gather_case(*case[:2], seed=i, main_path=case[2])
             for i, case in enumerate(GATHER_CASES)]
    refusal_phase()
    sparse_refusal_phase()
    sddmm_refusal_phase()
    variant_refusal_phase()
    win_gather_refusal_phase()
    gradient_phase()

    wrappers = {"fused_dense_gnn": fused_dense_gnn,
                "fused_dense_graph_conv": fused_dense_graph_conv,
                "spmm_edge_list": spmm_edge_list, "spmm_slots": spmm_slots,
                "sddmm_threshold_row": sddmm_threshold_row,
                "spmm_pairs": spmm_pairs, "spmm_seg": spmm_seg,
                "spmm_prefetch": spmm_prefetch,
                "spmm_onehot_dtype": spmm_onehot_dtype,
                "spmm_win": spmm_win,
                "take_rows": take_rows, "take_lanes": take_lanes,
                "take_rows_loop": take_rows_loop}
    paths = [  # (phase, the kernels its path launches)
        (serve_phase, ("fused_dense_gnn",)),
        (scan_phase, ("fused_dense_gnn", "fused_dense_graph_conv")),
        (sparse_phase, ("spmm_edge_list", "spmm_slots")),
        (selector_phase, ("fused_dense_gnn", "sddmm_threshold_row")),
        (sweep_phase, ("spmm_edge_list", "spmm_onehot_dtype", "spmm_pairs",
                       "spmm_seg", "spmm_prefetch", "spmm_win", "take_rows",
                       "take_lanes", "take_rows_loop")),
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
