"""The traced window, reduced: torch.profiler (CUPTI) over part of the
window, and from its events the device's busy time (the union of the
kernel, copy and set intervals inside the window, not the sum of their
times), kernel counts and times by symbol, the device operations that took
most time, and the longest idle gaps with what the host was doing in each.
"""

from __future__ import annotations

import re
from collections import defaultdict

import numpy as np

WINDOW_SPAN = "portbench.window"
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


class Trace:
    def __init__(self, window_s, busy_s, kernels, by_name, device_ops,
                 idle_gaps):
        self.window_s = window_s
        self.busy_s = busy_s
        self.kernels = kernels        # kernel launches inside the window
        self.by_name = by_name        # {kernel name: (seconds, count)}
        self.device_ops = device_ops  # [[name, seconds]], most time first
        self.idle_gaps = idle_gaps    # [[what the host did, seconds]]

    def kernel_s(self, pattern: str) -> tuple[float, int]:
        """Seconds and launches of the kernels whose symbol matches."""
        rx = re.compile(pattern)
        hits = [v for k, v in self.by_name.items() if rx.search(k)]
        return sum(s for s, _ in hits), sum(c for _, c in hits)

    def idle_pct(self) -> float:
        return 100.0 * (1.0 - self.busy_s / self.window_s)


def _kind(e) -> str:
    """The event's kind: kineto's activity type where this PyTorch has it;
    else a span's shadow on the device is an annotation, and a device event
    is a copy or a set by its name, or a kernel."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    if hasattr(e, "is_user_annotation") and e.is_user_annotation():
        return "gpu_user_annotation"
    name = e.name()
    if name.startswith(("Memcpy", "memcpy")):
        return "gpu_memcpy"
    if name.startswith(("Memset", "memset")):
        return "gpu_memset"
    return "kernel"


def _union(intervals: np.ndarray) -> np.ndarray:
    """Merged [start, end] rows of intervals sorted by start."""
    merged = []
    for s, e in intervals:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return np.array(merged, dtype=np.int64).reshape(-1, 2)


def _short(name: str, width: int = 96) -> str:
    return name if len(name) <= width else name[:width - 3] + "..."


def summarize(prof) -> Trace | None:
    """The window's reduction, or None where the profiler saw no device
    activity in it."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    window = None
    host, device = [], []
    for e in events:
        kind, name = _kind(e), e.name()
        span = (e.start_ns(), e.start_ns() + e.duration_ns())
        if e.device_type() == DeviceType.CUDA:
            if kind in DEVICE_KINDS:
                device.append((name, kind) + span)
        elif name == WINDOW_SPAN:
            window = span
        else:
            host.append((name,) + span)
    if window is None:
        raise RuntimeError("the trace holds no window span")
    w0, w1 = window
    spans = {n for n, _, _ in host}  # a device event named as a host call
    device = [d for d in device if d[0] not in spans]  # is a span's shadow
    device = [(n, k, max(s, w0), min(e, w1)) for n, k, s, e in device
              if e > w0 and s < w1]
    if not device:
        return None
    iv = np.array(sorted((s, e) for _, _, s, e in device), dtype=np.int64)
    busy = _union(iv)
    busy_ns = int((busy[:, 1] - busy[:, 0]).sum())
    by_name = defaultdict(lambda: [0.0, 0])
    for n, _, s, e in device:
        by_name[n][0] += (e - s) / 1e9
        by_name[n][1] += 1
    kernels = sum(k == "kernel" for _, k, _, _ in device)
    device_ops = [[_short(n), v[0]] for n, v in
                  sorted(by_name.items(), key=lambda kv: -kv[1][0])[:TOP]]
    edges = np.concatenate([[w0], busy.reshape(-1), [w1]]).reshape(-1, 2)
    gaps = [(int(s), int(e)) for s, e in edges if e > s]
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
    names = [n for n, _, _ in host]
    starts = np.array([s for _, s, _ in host], dtype=np.int64)
    ends = np.array([e for _, _, e in host], dtype=np.int64)
    return Trace((w1 - w0) / 1e9, busy_ns / 1e9, kernels,
                 {n: tuple(v) for n, v in by_name.items()}, device_ops,
                 [[_host_label(names, starts, ends, (s + e) // 2),
                   (e - s) / 1e9] for s, e in gaps])


def _host_label(names, starts, ends, mid) -> str:
    """What the host ran at `mid`: the benchmark's span around it and the
    innermost recorded call."""
    inside = np.nonzero((starts <= mid) & (ends >= mid))[0]
    if not len(inside):
        return "host: nothing recorded"
    inside = inside[np.argsort(starts[inside], kind="stable")]
    spans = [names[i] for i in inside if names[i].startswith("portbench.")]
    outer = spans[0] if spans else "outside the benchmark's spans"
    return _short(f"{outer} > {names[inside[-1]]}")
