"""Drive the PyTorch port (gcm_tpu_torch) on one CUDA card and check it.

    python3 chip_smoke.py

Phases, one JSON line each:
1. device: requires CUDA; prints the card's name and power limit;
2. build: builds every kernel from gcm_tpu_torch/csrc with nvcc (sm_90a);
3. kernels: each kernel against its plain PyTorch version on the card
   (max abs error, tolerance 1e-5: only the summation order differs), with
   the device time per call and the time per call with the host's launch
   gaps (both from CUDA events) of the kernel, the plain version and a
   torch bmm/addmm chain of the same function (TF32 off); then inputs the
   kernels do not
   take (misaligned, wrong graph size, float64) must raise, unlaunched;
4. serve: the flagship DenseGCM in a SessionServer(capacity=256) for 200
   ticks with session churn and LRU evictions, against a CPU copy with the
   same weights (atol 1e-4), with a snapshot/restore at tick 100 that must
   continue bitwise, and one fused_dense_gnn launch per tick;
5. scan: DenseGCM.scan over [32, 256, 8] against the CPU copy (atol 1e-4),
   and the same model with DenseGNN(fuse="") through
   fused_dense_graph_conv.
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


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def device_events(prof):
    """(name, self device µs) of the device-side events of a profile: an
    aten op's own entry would repeat the time of the kernels it launched."""
    from torch.autograd import DeviceType

    return [(e.key[:80], e.self_device_time_total)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]


def time_ms(fn, reps: int = 20, rounds: int = 5,
            warmup: int = 5) -> tuple[float, float]:
    """(device_ms, call_ms) of one call of fn: the median over rounds of
    CUDA events around reps back-to-back calls, over reps. device_ms: a spin
    kernel first holds the stream until the host has enqueued every call
    behind it, so the events bracket the calls' kernels with no idle gaps
    between them. call_ms: the same without the spin; where the host
    enqueues slower than the device runs, it holds the device's idle gaps
    too."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def run(spin_cycles: int) -> tuple[float, bool]:
        if spin_cycles:
            torch.cuda._sleep(spin_cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        ahead = not start.query()  # all enqueued before the first call ran
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps, ahead

    calls = [run(0)[0] for _ in range(rounds)]
    spin = 4_000_000  # ~2 ms at the H100's clock
    devices = []
    while len(devices) < rounds:
        device, ahead = run(spin)
        if ahead:
            devices.append(device)
        elif spin < 4_000_000 * 4 ** 5:
            spin *= 4
        else:
            raise RuntimeError("the host never got ahead of the device: no "
                               "device time measured")
    return statistics.median(devices), statistics.median(calls)


# -- phase 3: kernels against their plain versions ---------------------------

def make_case(B, N, widths, seed):
    """x, adj and flat params on the card. adj is random 0/1 with eight
    in-edges per row on average and every eighth row empty."""
    g = torch.Generator().manual_seed(seed)
    x = torch.rand((B, N, widths[0]), generator=g) * 2 - 1
    adj = (torch.rand((B, N, N), generator=g) < 8 / N).float()
    adj[:, ::8, :] = 0.0
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


def bound_ms(B, N, widths):
    """Least time on an H100 SXM: dense products at the f32 rate, or each
    input read once and the output written once, whichever is longer."""
    flops = sum(2 * B * (N * N * fi + 2 * N * fi * fo)
                for fi, fo in zip(widths[:-1], widths[1:]))
    params = sum(2 * fi * fo + fo for fi, fo in zip(widths[:-1], widths[1:]))
    nbytes = 4 * (B * N * widths[0] + B * N * N + params + B * N * widths[-1])
    t_ops, t_bytes = flops / PEAK_F32_FLOP_PER_S, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def kernel_case(name, B, N, widths, acts, seed, main_path):
    from gcm_tpu_torch.ops.cuda.dense_gconv import (
        fused_dense_graph_conv, fused_dense_graph_conv_plain)
    from gcm_tpu_torch.ops.cuda.fused_gnn import (fused_dense_gnn,
                                                  fused_dense_gnn_plain)

    x, adj, *flat = make_case(B, N, widths, seed)
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
    got = kernel()
    torch.cuda.synchronize()
    want = plain()
    err = float((got - want).abs().max())
    again = kernel()
    torch.cuda.synchronize()
    wcats = [torch.cat([flat[3 * i], flat[3 * i + 2]], 0)
             for i in range(len(acts))]
    biases = [flat[3 * i + 1] for i in range(len(acts))]
    lib_err = float((library_gnn(x, adj, wcats, biases, acts) - want)
                    .abs().max())
    b_ms, b_by = bound_ms(B, N, widths)
    ms, call_ms = time_ms(kernel)
    plain_ms, plain_call_ms = time_ms(plain)
    library_ms, library_call_ms = time_ms(
        lambda: library_gnn(x, adj, wcats, biases, acts))
    row = dict(kernel=name, B=B, N=N, widths=list(widths), acts=list(acts),
               main_path=main_path, max_abs_err=err,
               bitwise_repeatable=bool(torch.equal(got, again)),
               ms=ms, plain_ms=plain_ms, library_ms=library_ms,
               call_ms=call_ms, plain_call_ms=plain_call_ms,
               library_call_ms=library_call_ms,
               library_max_abs_err=lib_err, bound_ms=b_ms, bound_by=b_by)
    emit("kernel", **row)
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
    check(err <= TOL_KERNEL, f"{name} {B}x{N} {widths} {acts}: max abs err "
          f"{err} > {TOL_KERNEL}")
    check(row["bitwise_repeatable"], f"{name}: two launches differ")
    return row


KERNEL_CASES = [
    # (name, B, N, widths, acts, main_path)
    ("fused_dense_gnn", 256, 128, (32, 32, 32), ("tanh", "tanh"), True),
    ("fused_dense_gnn", 32, 512, (32, 32, 32), ("tanh", "tanh"), False),
    ("fused_dense_gnn", 8, 512, (128, 128, 128), ("relu", "tanh"), False),
    ("fused_dense_gnn", 16, 128, (8, 32, 64, 16), (None, "relu", "tanh"),
     False),
    ("fused_dense_graph_conv", 32, 128, (32, 32), (None,), True),
    ("fused_dense_graph_conv", 256, 128, (32, 32), (None,), False),
    ("fused_dense_graph_conv", 256, 128, (32, 32), ("tanh",), False),
    ("fused_dense_graph_conv", 256, 128, (32, 32), ("relu",), False),
    # widths that are not multiples of 4 (shared-memory alignment)
    ("fused_dense_gnn", 16, 128, (8, 30, 17), ("tanh", None), False),
    ("fused_dense_graph_conv", 16, 128, (13, 30), ("relu",), False),
]


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
    launches = (fused_dense_gnn.launches, fused_dense_graph_conv.launches)
    refused = {}
    for case, call in cases.items():
        try:
            call()
        except ValueError as e:
            refused[case] = str(e)
    check(sorted(refused) == sorted(cases),
          f"inputs not refused: {sorted(set(cases) - set(refused))}")
    check((fused_dense_gnn.launches, fused_dense_graph_conv.launches)
          == launches, "a refused input was launched")
    emit("refuse", **refused)


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
         profile=profile_ticks(restored, reqs))


def profile_ticks(srv, reqs, n: int = 20) -> dict:
    """Where a served tick's time goes: torch.profiler over n ticks of the
    same requests (every session already holds a row). The wall time
    includes the profiler's own overhead. Where the profiler sees no device
    activity (its tracing is not always available), the device fields are
    None: not measured."""
    from torch.profiler import ProfilerActivity, profile

    srv.step(reqs)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            srv.step(reqs)
        wall_us = 1e6 * (time.perf_counter() - t0)
    device = device_events(prof)
    device_us = sum(us for _, us in device)
    top = sorted(device, key=lambda kv: -kv[1])[:8]
    seen = device_us > 0
    return dict(ticks=n, requests_per_tick=len(reqs),
                wall_us_per_tick=wall_us / n,
                device_us_per_tick=device_us / n if seen else None,
                device_busy_share=device_us / wall_us if seen else None,
                top_device_us_per_tick={k: us / n for k, us in top}
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


# -- main ---------------------------------------------------------------------

KERNEL_META = {
    "fused_dense_gnn": dict(
        source="gcm_tpu_torch/csrc/dense_gnn.cu",
        replaces="gcm_tpu/ops/pallas/fused_gnn.py:83"),
    "fused_dense_graph_conv": dict(
        source="gcm_tpu_torch/csrc/dense_gnn.cu",
        replaces="gcm_tpu/ops/pallas/dense_gconv.py:51"),
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

    t0 = time.perf_counter()
    waited = _build.build_all()
    ptxas = [ln.strip() for src in waited for ln in
             _build.build_log(src).splitlines()
             if "registers" in ln or "spill" in ln]
    emit("build", seconds=time.perf_counter() - t0, sources=waited,
         ptxas=ptxas)

    rows = [kernel_case(*case[:5], seed=i, main_path=case[5])
            for i, case in enumerate(KERNEL_CASES)]
    refusal_phase()

    wrappers = {"fused_dense_gnn": fused_dense_gnn,
                "fused_dense_graph_conv": fused_dense_graph_conv}
    for fn in wrappers.values():
        fn.launches = 0
    serve_phase(card)
    scan_phase(card)
    launches = {k: fn.launches for k, fn in wrappers.items()}
    for k, n in launches.items():
        check(n > 0, f"{k} was not launched on the main path")

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
