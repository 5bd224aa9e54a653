"""Runs one cell several times, one process a run, as the checks do, and
summarises the spread of each metric:

    python3 portbench/series.py --workload <cell> --seeds 11,12,13 \
        --seconds 20 --trace 0 --out chiprun_out/<file>.jsonl

Each run's result line (or its failure, with the end of its standard
error) is appended to --out. The summary gives each metric's median and
its spread, the distance between the first and third quartile
(statistics.quantiles(values, n=4)) as a share of the median.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def spread(values) -> float | None:
    if len(values) < 2:
        return None
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2 if q2 else None


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    print(f"card: {card()}", flush=True)
    values = {}
    with open(out, "a") as f:
        for seed in (int(s) for s in args.seeds.split(",")):
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "portbench/run.py", "--workload",
                 args.workload, "--seed", str(seed), "--seconds",
                 str(args.seconds), "--trace", str(args.trace)],
                cwd=ROOT, capture_output=True, text=True)
            wall = time.perf_counter() - t0
            lines = proc.stdout.strip().splitlines()
            row = {"workload": args.workload, "seed": seed,
                   "trace": args.trace, "rc": proc.returncode, "wall_s": wall,
                   "setup": [ln for ln in proc.stderr.splitlines()
                             if ln.startswith("setup ")]}
            try:
                row["result"] = json.loads(lines[-1])
            except (IndexError, json.JSONDecodeError):
                row["stderr"] = proc.stderr[-6000:]
            f.write(json.dumps(row) + "\n")
            f.flush()
            res = row.get("result", {})
            for k, v in res.get("metrics", {}).items():
                values.setdefault(k, []).append(v["value"])
            print(json.dumps({"seed": seed, "rc": proc.returncode,
                              "wall_s": round(wall, 1),
                              "correct": res.get("correct"),
                              "metrics": {k: v["value"] for k, v in
                                          res.get("metrics", {}).items()},
                              "checks": res.get("checks"),
                              "peak": res.get("device", {}).get(
                                  "memory_peak_bytes"),
                              "busy_s": res.get("device", {}).get("busy_s"),
                              "window_s": res.get("device", {}).get(
                                  "window_s")}), flush=True)
            if "stderr" in row:
                print(row["stderr"][-3000:], flush=True)
    for k, v in values.items():
        print(json.dumps({"metric": k, "n": len(v),
                          "median": statistics.median(v),
                          "spread": spread(v), "values": v}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
