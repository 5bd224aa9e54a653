"""One run of one cell: set-up, the measured window (traced in part with
--trace 1), the metrics BENCHMARK.json lists for the cell, the check
against the reference, and the result line.

The cell's files are found by name: BENCHMARK.json's workload entry, then
workloads/<cell>.json (the driver, the traffic's parameters, the check's
limits), configs/<config>.json and drivers/<driver>.py; each metric is read
by metrics/<metric>.py. Nothing else needs an edit when a cell, a
configuration or a metric is added.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import torch

from portbench import compare, trace, traffic

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "gcm_tpu")


class NoCard(RuntimeError):
    pass


class ForbiddenImport(RuntimeError):
    pass


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(HERE.parent / "BENCHMARK.json")


def cell_files(bench: dict, name: str) -> tuple[dict, dict, dict]:
    """(BENCHMARK.json's entry, workload file, configuration file)."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    wl = load_json(HERE / "workloads" / f"{name}.json")
    cfg = load_json(HERE / "configs" / f"{cell['config']}.json")
    if (wl["config"], wl["traffic_mix"]) != (cell["config"], cell["traffic"]):
        raise ValueError(f"{name}: workload file and BENCHMARK.json disagree")
    return cell, wl, cfg


def metric_reader(name: str):
    """metrics/<name>.py, loaded by its path (names hold dots)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench.metrics." + name.replace(".", "__"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell_metrics(bench: dict, name: str, traced: bool) -> list[dict]:
    entries = bench["per_layer"] if traced else bench["end_to_end"]
    return [m for m in entries if name in m.get("workloads", [name])]


def forbidden_modules() -> list[str]:
    """Top-level names in sys.modules of JAX or its package, compared
    whole (gcm_tpu_torch is not gcm_tpu)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _diff(a: dict, b: dict) -> dict:
    out = {k: b[k] - a[k] for k in ("units", "timesteps", "env_steps",
                                     "model_ops")}
    out["work"] = {}
    for kernel, w in b["work"].items():
        w0 = a["work"].get(kernel, {"ops": 0, "bytes": 0, "bound_s": 0,
                                    "bound_by": {"ops": 0, "bytes": 0}})
        out["work"][kernel] = {
            k: w[k] - w0[k] for k in ("ops", "bytes", "bound_s")}
        out["work"][kernel]["bound_by"] = {
            k: w["bound_by"][k] - w0["bound_by"][k] for k in w["bound_by"]}
    return out


def measure(driver, seconds: float, trace_seconds: float | None):
    """The window: driver.unit() until `seconds` have passed, the first
    `trace_seconds` of it under the profiler. Returns (whole, host,
    traced, trace): the whole window's and its untraced part's seconds and
    counters (with the tick latencies), the traced part's, and the trace's
    reduction."""
    driver.sync()
    prof = span = None
    if trace_seconds is not None:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU]
        if driver.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.start()
        span = record_function(trace.WINDOW_SPAN)
        span.__enter__()
        driver.tracing = True
    c0 = driver.counters()
    lat0 = len(getattr(driver, "latency", []))
    t0 = time.perf_counter()
    host0, c_host0, lat_host0 = t0, c0, lat0
    traced = None
    while True:
        driver.unit()
        now = time.perf_counter()
        if prof is not None and (now - t0 >= trace_seconds
                                 or now - t0 >= seconds):
            driver.sync()
            t_mid = time.perf_counter()
            c_mid = driver.counters()
            span.__exit__(None, None, None)
            driver.tracing = False
            prof.stop()
            traced = {"seconds": t_mid - t0, "count": _diff(c0, c_mid)}
            host0 = time.perf_counter()
            c_host0 = driver.counters()
            lat_host0 = len(getattr(driver, "latency", []))
            prof_done, prof = prof, None
        if now - t0 >= seconds:
            break
    driver.sync()
    t1 = time.perf_counter()
    c1 = driver.counters()
    latency = getattr(driver, "latency", [])
    whole = {"seconds": t1 - t0, "count": _diff(c0, c1),
             "latency": latency[lat0:]}
    host = {"seconds": t1 - host0, "count": _diff(c_host0, c1),
            "latency": latency[lat_host0:]}
    reduced = trace.summarize(prof_done) if traced is not None else None
    return whole, host, traced, reduced


def run(name: str, seed: int, seconds: float, traced: bool, t_start: float,
        device: str = "cuda") -> dict:
    bench = benchmark()
    cell, wl, cfg = cell_files(bench, name)
    if device == "cuda":
        if not torch.cuda.is_available():
            raise NoCard("torch.cuda.is_available() is false")
        if torch.cuda.device_count() < cell["chips"]:
            raise NoCard(f"{name} needs {cell['chips']} cards, "
                         f"{torch.cuda.device_count()} visible")
        torch.cuda.reset_peak_memory_stats()
    torch.backends.cuda.matmul.allow_tf32 = False  # the configs are float32
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(1)
    ctx = SimpleNamespace(name=name, workload=wl, config=cfg, seed=seed,
                          seeds=traffic.sub_seeds(seed),
                          device="cuda:0" if device == "cuda" else device)
    driver = importlib.import_module(f"portbench.drivers.{wl['driver']}") \
        .Driver(ctx)
    driver.mark("imports and the device")
    driver.setup()
    driver.sync()
    gc.collect()  # set-up's objects out of the collector's way in the window
    gc.freeze()
    setup_s = time.perf_counter() - t_start
    last = t_start
    for what, t in driver.phases:  # set-up's breakdown, on standard error
        print(f"setup {what}: {t - last:.3f} s", file=sys.stderr)
        last = t
    trace_s = min(wl["trace_seconds"], seconds) if traced else None
    whole, host, traced_part, reduced = measure(driver, seconds, trace_s)
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    failed = driver.failed()

    view = SimpleNamespace(name=name, cell=cell, workload=wl, config=cfg,
                           setup_s=setup_s, window=whole, host=host,
                           traced=traced_part, trace=reduced)
    metrics = {}
    for m in cell_metrics(bench, name, traced):
        value = metric_reader(m["name"]).read(view)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    numbers = driver.check()["program"]
    correct, rows = compare.judge(numbers, wl["limits"])
    found = forbidden_modules()
    if found:
        raise ForbiddenImport(f"modules loaded: {', '.join(found)}")

    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                    else device),
           "count": cell["chips"], "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct and failed == 0),
              "attempted": whole["count"]["units"], "failed": failed,
              "metrics": metrics, "device": dev}
    if traced and device == "cuda" and reduced is None:
        raise RuntimeError("the profiler saw no device activity")
    if reduced is not None:
        dev["busy_s"] = reduced.busy_s
        dev["window_s"] = reduced.window_s
        result["breakdown"] = {"device_ops": reduced.device_ops,
                               "idle_gaps": reduced.idle_gaps}
    result["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    return result
