"""Shared arithmetic of the metric readers. A reader's `read(view)` returns
the metric's value, or None where its run has nothing to read: the
harness then leaves the metric out of the line."""

from __future__ import annotations

import numpy as np

from portbench import yardstick


def rate(part: dict, counter: str) -> float | None:
    """A counter over the seconds of a part of the window."""
    if not part["count"]["units"] or part["seconds"] <= 0:
        return None
    return part["count"][counter] / part["seconds"]


def per_unit_kernels(view) -> float | None:
    """Kernel launches in the trace over the units it holds."""
    if view.trace is None or not view.traced["count"]["units"]:
        return None
    return view.trace.kernels / view.traced["count"]["units"]


def idle_pct(view) -> float | None:
    return None if view.trace is None else view.trace.idle_pct()


def mfu_pct(view) -> float | None:
    """The model's operations (yardstick.py) over the untraced part of the
    window, against the card's TF32 peak."""
    ops = rate(view.host, "model_ops")
    return None if ops is None else 100.0 * ops / yardstick.PEAK_FLOPS


def roofline_pct(view, work: str, symbols: str) -> float | None:
    """The least time the traced calls of a kernel row could take (the
    larger of operations over the peak and bytes over the bandwidth, call
    by call) over the time the trace gives the kernels whose symbols match."""
    if view.trace is None:
        return None
    bound = view.traced["count"]["work"].get(work, {}).get("bound_s", 0.0)
    seconds, launches = view.trace.kernel_s(symbols)
    if not launches or not bound:
        return None
    return 100.0 * bound / seconds


def tick_p95_ms(view) -> float | None:
    """The 95th percentile of the ticks' latencies in the untraced part of
    the window (the profiler slows the host)."""
    lat = view.host.get("latency") or []
    if len(lat) < 20:
        return None
    return 1e3 * float(np.percentile(lat, 95))
