"""The readings that a cell's limits are set from (PERF.md), in one
process: for each seed the program's numbers against the reference and,
for the first --extra seeds, the control's (the reference in TF32 in the
program's place) and, for training, a planted fault's (the reference with
half of the batch left out, the mean over the rest):

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        --extra 3 --seconds 20

A rollout runs a window of --seconds at the cell's own load first; a
training cell's readings need none. The benchmark's runs never run this.
One JSON line a seed.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from portbench import harness, traffic  # noqa: E402


def readings(name: str, seed: int, extra: tuple, seconds: float,
             device: str = "cuda:0") -> dict:
    cell, wl, cfg = harness.cell_files(harness.benchmark(), name)
    ctx = SimpleNamespace(name=name, workload=wl, config=cfg, seed=seed,
                          seeds=traffic.sub_seeds(seed), device=device)
    driver = importlib.import_module(
        f"portbench.drivers.{wl['driver']}").Driver(ctx)
    t0 = time.perf_counter()
    driver.setup()
    driver.sync()
    row = {"workload": name, "seed": seed,
           "setup_s": time.perf_counter() - t0}
    if wl["driver"] == "rollout":
        whole, _, _, _ = harness.measure(driver, seconds, None)
        row["units"] = whole["count"]["units"]
    t0 = time.perf_counter()
    row.update(driver.check(extra))
    row["check_s"] = time.perf_counter() - t0
    del driver
    gc.collect()
    if device.startswith("cuda"):
        torch.cuda.empty_cache()
    return row


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--extra", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=20.0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("calibrate: no card", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        extra = ("control", "half_batch") if i < args.extra else ()
        print(json.dumps(readings(args.workload, seed, extra, args.seconds)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
