"""The SpMM variant sweep (counterpart of benchmarks/spmm_variants.py).

Times implementations of the padded-edge-list SpMM

    out[b, i] = sum over e with sink_e = i of w_e * x[b, src_e]

at the sweep's point (B=64, N=512, E=8192, F=128; sinks and sources
uniform in 0..N-1, weights uniform in [0.5, 1.5), no sentinels). Every row
is first checked against ops/scatter.py::edge_scatter_add on the same
inputs (atol 1e-3; 0.5 for the bf16 rows) and then timed: CUDA events
around ITERS chained calls x <- f(x) * 0.1 (the scale included), the
median of ROUNDS. Each row prints edges/s = B*E / time per call, the
check's max abs error and the launches of its kernel.

Rows (the JAX script's name in brackets):
  scatter          gather + scatter_add_ in plain torch     [xla_scatter]
  sorted           the same on edges sorted by sink         [xla_sorted]
  sorted_hint      torch.segment_reduce of the sink-sorted messages, the
                   library call that takes sortedness as given
                                                            [xla_sorted_hint]
  cumsum           prefix sums of sink-sorted messages      [xla_cumsum]
  sparse_mm        torch.sparse.mm on the block-diagonal COO, the library
                   yardstick (no JAX row)
  edge_list_f32x2  ops/cuda/spmm.py::spmm_edge_list         [pallas_f32x2]
  onehot_f32/bf16  ops/cuda/spmm.py::spmm_onehot_dtype      [pallas_onehot,
                                                             pallas_bf16]
  win_f32/bf16     ops/cuda/spmm_win.py, cap E/2 lanes per 128-sink window
                                                            [pallas_win,
                                                             pallas_win_bf16]
  seg              ops/cuda/spmm_seg.py, cap 2x the mean bucket load
                   rounded up to 128                        [pallas_seg]
  prefetch_nblk4/8 ops/cuda/spmm_prefetch.py, cap 2E/nblk   [pallas_prefetch_*]
  pairs_f32x2/bf16 ops/cuda/spmm2.py at the seg row's cap (not in the JAX
                   script; BASELINE.md records it at this point)
Before the rows, `main` prints {"probe": ...}: `probe_dynamic_gather` runs
the three gathers of ops/cuda/gather.py on the JAX probe's own inputs.
So this sweep is the JAX script's default run row for row, probe first,
plus sparse_mm and the pairs rows; the last line's `not_ported` is empty.

    python -m gcm_tpu_torch.benchmarks.spmm_variants [--skip a,b]
                                                     [--probe-only]

runs on the CUDA card; `run_sweep(device="cpu")` runs the plain versions.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np
import torch

from gcm_tpu_torch.device import resolve_device
from gcm_tpu_torch.ops.cuda.gather import (take_lanes, take_rows,
                                           take_rows_loop)
from gcm_tpu_torch.ops.cuda.spmm import spmm_edge_list, spmm_onehot_dtype
from gcm_tpu_torch.ops.cuda.spmm2 import (W, bucket_edges_pairs,
                                          check_bucket_overflow, spmm_pairs)
from gcm_tpu_torch.ops.cuda.spmm_prefetch import (bucket_edges_sink_blocks,
                                                  spmm_prefetch,
                                                  spmm_prefetch_bucketed)
from gcm_tpu_torch.ops.cuda.spmm_seg import bucket_edges_segments, spmm_seg
from gcm_tpu_torch.ops.cuda.spmm_win import (bucket_by_sink_window, spmm_win,
                                             window_overflow)
from gcm_tpu_torch.ops.scatter import (edge_mask, edge_scatter_add,
                                       gather_nodes)

ITERS = 20  # chained calls per timed round
ROUNDS = 5  # timed rounds; the median is kept


def make_edges(B, N, E, seed=1):
    """edges [B,2,E] int32 (sinks, sources uniform in 0..N-1) and weights
    [B,E] float32 uniform in [0.5, 1.5), from numpy's default_rng(seed)."""
    rng = np.random.default_rng(seed)
    edges = rng.integers(0, N, (B, 2, E)).astype(np.int32)
    w = rng.uniform(0.5, 1.5, (B, E)).astype(np.float32)
    return edges, w


def block_diagonal_coo(edges, w, N):
    """The valid lanes of a [B,2,E] edge list as one coalesced sparse COO
    matrix [B*N, B*N] (sink row, source column), for torch.sparse.mm."""
    B = edges.shape[0]
    sink, src = edges[:, 0].long(), edges[:, 1].long()
    ok = (sink >= 0) & (sink < N) & (src >= 0) & (src < N)
    off = (torch.arange(B, device=edges.device) * N)[:, None]
    idx = torch.stack([(sink + off)[ok], (src + off)[ok]])
    with torch.sparse.check_sparse_tensor_invariants():
        return torch.sparse_coo_tensor(idx, w[ok], (B * N, B * N)).coalesce()


def sort_by_sink(edges, w, N):
    """Stable sort of the padded edge list by sink (invalid lanes, -1, go
    last)."""
    valid = edge_mask(edges)
    order = torch.argsort(torch.where(valid, edges[:, 0], N), dim=-1,
                          stable=True)
    e = torch.where(valid[:, None], edges, -1)
    return (torch.gather(e, 2, order[:, None].expand(-1, 2, -1)),
            torch.gather(w, 1, order))


def sorted_messages(x, edges, w):
    """The weighted messages of a sink-sorted edge list [B,E,F], 0 on its
    invalid lanes, and each sink's lane count [B,N+1] (the invalid lanes,
    sorted last, counted in the last)."""
    N = x.shape[1]
    valid = edge_mask(edges)
    sink = torch.where(valid, edges[:, 0].long(), N)
    msgs = gather_nodes(x, edges[:, 1]) * w[..., None]
    deg = torch.zeros((x.shape[0], N + 1), dtype=torch.long, device=x.device)
    deg.scatter_add_(1, sink, torch.ones_like(sink))
    return torch.where(valid[..., None], msgs, 0.0), deg


def cumsum_sorted(x, edges, w):
    """Sink-sorted edges: each sink's sum is the difference of the prefix
    sums of the messages at its segment's two ends."""
    B, N, F = x.shape
    msgs, deg = sorted_messages(x, edges, w)
    csum = torch.cat([torch.zeros((B, 1, F), dtype=x.dtype, device=x.device),
                      torch.cumsum(msgs, 1)], 1)
    hi = torch.cumsum(deg[:, :N], -1)
    lo = hi - deg[:, :N]
    return (torch.gather(csum, 1, hi[..., None].expand(-1, -1, F))
            - torch.gather(csum, 1, lo[..., None].expand(-1, -1, F)))


def segment_sum_sorted(x, edges, w):
    """Sink-sorted edges: one torch.segment_reduce over each batch
    element's messages in segments of the sinks' lane counts (the invalid
    lanes' segment cut off)."""
    msgs, deg = sorted_messages(x, edges, w)
    return torch.segment_reduce(msgs, "sum", lengths=deg, axis=1)[:, :-1]


def probe_dynamic_gather(device=None):
    """The JAX script's capability probe on its own inputs: take_rows,
    take_lanes and take_rows_loop against x[idx] and take_along_dim ->
    {"take_rows", "take_lanes", "dynslice_loop"}: "ok", "WRONG" or
    "fail: <error>", as the JAX probe reports."""
    dev = resolve_device(device)
    x = torch.arange(64 * 128, dtype=torch.float32, device=dev).reshape(64,
                                                                        128)
    idx = torch.tensor([5, 3, 60, 0, 1, 2, 33, 7] * 16, dtype=torch.int32,
                       device=dev)
    xT = torch.arange(8 * 512, dtype=torch.float32, device=dev).reshape(8, 512)
    idxl = torch.tensor([[5, 3, 500, 0, 1, 2, 33, 7] * 16], dtype=torch.int32,
                        device=dev).repeat(8, 1)
    cases = {
        "take_rows": (lambda: take_rows(x, idx), lambda: x[idx.long()]),
        "take_lanes": (lambda: take_lanes(xT, idxl),
                       lambda: torch.take_along_dim(xT, idxl.long(), 1)),
        "dynslice_loop": (lambda: take_rows_loop(x, idx),
                          lambda: x[idx.long()]),
    }
    results = {}
    for name, (got, want) in cases.items():
        try:
            results[name] = "ok" if torch.equal(got(), want()) else "WRONG"
        except Exception as ex:  # noqa: BLE001 - reported, as in JAX
            results[name] = f"fail: {type(ex).__name__}: {str(ex)[:160]}"
    return results


def pair_cap(N, E):
    """Twice the mean pair-bucket load, rounded up to 128 (1024 at the
    sweep's point), as the JAX sweep sizes its seg row."""
    P = (N // W) ** 2
    return max(W, -(-2 * (E // P) // W) * W)


def _bucket_overflow(counts, cap):
    """check_bucket_overflow's message, or None."""
    try:
        check_bucket_overflow(counts, cap)
    except ValueError as e:
        return str(e)
    return None


def _seconds_per_call(fn, x0, device):
    def chain():
        x = x0
        for _ in range(ITERS):
            x = fn(x) * 0.1
        return x

    chain()  # warm-up
    times = []
    for _ in range(ROUNDS):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize(device)
            start.record()
            chain()
            end.record()
            torch.cuda.synchronize(device)
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            chain()
            times.append(time.perf_counter() - t0)
    return statistics.median(times) / ITERS


def run_sweep(B=64, N=512, E=8192, F=128, device=None, skip=(), seed=1):
    """Checks and times every row (printing one JSON line each) and returns
    {"device", "workload", "results", "not_ported"}; a row that fails its
    check, or whose buckets overflow, holds "error" instead of a rate."""
    dev = resolve_device(device)
    edges_np, w_np = make_edges(B, N, E, seed)
    edges = torch.from_numpy(edges_np).to(dev)
    w = torch.from_numpy(w_np).to(dev)
    x0 = torch.from_numpy(np.random.default_rng(seed + 100).standard_normal(
        (B, N, F)).astype(np.float32)).to(dev)
    want = edge_scatter_add(x0, edges, w)
    results = {}

    def run(name, fn, atol=1e-3, kernel=None, overflow=None):
        if name in skip:
            return
        before = kernel.launches if kernel else 0
        got = fn(x0)
        err = float((got - want).abs().max())
        if overflow:
            row = {"error": overflow}
        elif not err <= atol:
            row = {"error": f"max abs err {err:.3e} > {atol}"}
        else:
            sec = _seconds_per_call(fn, x0, dev)
            row = {"edges_per_s": B * E / sec, "ms": 1e3 * sec}
        row.update(max_abs_err=err, kernel=kernel.__name__ if kernel else None,
                   launches=kernel.launches - before if kernel else None)
        results[name] = row
        print(json.dumps({name: row}), flush=True)

    with torch.no_grad():
        sedges, sw = sort_by_sink(edges, w, N)
        run("scatter", lambda x: edge_scatter_add(x, edges, w))
        run("sorted", lambda x: edge_scatter_add(x, sedges, sw))
        run("sorted_hint", lambda x: segment_sum_sorted(x, sedges, sw))
        run("cumsum", lambda x: cumsum_sorted(x, sedges, sw))
        coo = block_diagonal_coo(edges, w, N)
        run("sparse_mm", lambda x: torch.sparse.mm(
            coo, x.reshape(B * N, F)).reshape(B, N, F))
        run("edge_list_f32x2", lambda x: spmm_edge_list(x, edges, w, "f32x2"),
            kernel=spmm_edge_list)
        for name, dtype, atol in (("onehot_f32", torch.float32, 1e-3),
                                  ("onehot_bf16", torch.bfloat16, 0.5)):
            run(name, lambda x, d=dtype: spmm_onehot_dtype(x, edges, w, d),
                atol=atol, kernel=spmm_onehot_dtype)
        win_cap = E // 2  # as the JAX script buckets its pallas_win rows
        we, ww, counts = bucket_by_sink_window(edges, w, N, cap=win_cap)
        for name, dtype, atol in (("win_f32", torch.float32, 1e-3),
                                  ("win_bf16", torch.bfloat16, 0.5)):
            run(name, lambda x, d=dtype: spmm_win(x, we, ww, N, win_cap, d),
                atol=atol, kernel=spmm_win,
                overflow=window_overflow(counts, win_cap))

        cap = pair_cap(N, E)
        be, bw, begin, end, tot = bucket_edges_segments(edges, w, N, cap)
        run("seg", lambda x: spmm_seg(x, be, bw, begin, end, N, cap),
            kernel=spmm_seg, overflow=_bucket_overflow(tot, cap))
        for nblk in (4, 8):
            sl, src, pw, dropped = bucket_edges_sink_blocks(
                edges, w, N, nblk, cap=2 * E // nblk)
            lost = int(dropped.max())
            run(f"prefetch_nblk{nblk}",
                lambda x, a=(sl, src, pw): spmm_prefetch_bucketed(x, *a, N),
                kernel=spmm_prefetch,
                overflow=f"{lost} edges dropped past the cap" if lost
                else None)
        pe, pw, counts = bucket_edges_pairs(edges, w, N, cap)
        for precision, atol in (("f32x2", 1e-3), ("bf16", 0.5)):
            run(f"pairs_{precision}",
                lambda x, p=precision: spmm_pairs(x, pe, pw, N, cap, p),
                atol=atol, kernel=spmm_pairs,
                overflow=_bucket_overflow(counts, cap))

    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    return {"device": name, "workload": f"B={B} N={N} E={E} F={F}",
            "cap": cap, "results": results, "not_ported": []}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--skip", default="", help="comma-separated rows")
    ap.add_argument("--probe-only", action="store_true",
                    help="run the gather probe alone")
    args = ap.parse_args(argv)
    print(json.dumps({"probe": probe_dynamic_gather()}), flush=True)
    if args.probe_only:
        return
    out = run_sweep(skip=tuple(filter(None, args.skip.split(","))))
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
