"""The numbers that decide `correct`, each against the limit its workload
file gives (set from the program's readings over a dozen seeds and the
control's, PERF.md).

Training (readings: each checked step's loss, each leaf's norm of the first
gradient, each leaf's norm of the parameters' change over the checked
steps):
- loss_gap: the largest |loss - reference| / |reference| over the steps;
- grad_gap / change_gap: the worst leaf's gap between the two norms,
  |norm - reference norm| / max(reference norm of the leaf, median leaf's
  reference norm). Leaves whose reference gradient is under a thousandth
  of the median leaf's move under Adam by round-off alone and are left out
  of change_gap.

Rollout (readings: the beliefs of the sampled environments at every tick,
and their memory's state after the last):
- belief_gap: the largest |belief - reference|;
- state_mismatch: entries of the final state that differ (exact: 0).
"""

from __future__ import annotations

import statistics

import numpy as np

ROUND_OFF_SHARE = 1e-3


def _worst_leaf(got: dict, want: dict, leaves) -> float:
    med = statistics.median(want[k] for k in want)
    return max(abs(got[k] - want[k]) / max(want[k], med, 1e-30)
               for k in leaves)


def train_numbers(got: dict, want: dict) -> dict:
    loss = max(abs(g - w) / abs(w) for g, w in zip(got["loss"], want["loss"]))
    grad = _worst_leaf(got["grad"], want["grad"], want["grad"])
    med = statistics.median(want["grad"].values())
    moved = [k for k, v in want["grad"].items() if v >= ROUND_OFF_SHARE * med]
    change = _worst_leaf(got["change"], want["change"], moved)
    return {"loss_gap": loss, "grad_gap": grad, "change_gap": change}


def rollout_numbers(got: dict, want: dict) -> dict:
    gap = float(np.max(np.abs(got["beliefs"] - want["beliefs"]),
                       initial=0.0))
    if not np.isfinite(got["beliefs"]).all():
        gap = float("inf")
    mismatch = sum(int(np.count_nonzero(g != w)) if g.shape == w.shape
                   else max(g.size, w.size)
                   for g, w in zip(got["state"], want["state"]))
    mismatch += abs(len(got["state"]) - len(want["state"]))
    return {"belief_gap": gap, "state_mismatch": float(mismatch)}


def judge(numbers: dict, limits: dict) -> tuple[bool, list]:
    """(correct, [(name, value, limit)]): correct where every number is
    finite and within its limit."""
    rows = [(k, float(v), float(limits[k])) for k, v in numbers.items()]
    ok = all(np.isfinite(v) and v <= lim for _, v, lim in rows)
    return ok, rows
