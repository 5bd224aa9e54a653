"""spmm_slots's direct kernel against its staged kernel, across the slots a
window (k), on one CUDA card.

    python -m gcm_tpu_torch.benchmarks.slots_staging_ab [--rounds 2]

Copies the package and chip_smoke.py twice under _checkout/slots_staging_ab/
(git ignores _checkout/): "direct" with csrc/spmm_slots.cu's choice of the
staged kernel turned off, "staged" with it always on (float4 columns; single
float columns take the direct kernel in both). Then, `rounds` times, runs
each copy in a process of its own, one after the other, and times in each
spmm_slots on TemporalEdge(1..k)'s slot layout (chip_smoke.slots_case's
inputs, each call checked bit for bit against the plain version) at
B=64, N=512, F=128 for k = 1, 2, 3, 4, 6, 8, 12 and at the sparse path's
B=32, N=128, F=32 for k = 1, 4, 8. Prints one JSON line per timing (build,
case, ms) and last a summary: each case's least ms of each build.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
OUT = ROOT / "_checkout" / "slots_staging_ab"
CHOICE = "if (k >= kStagedMinK && blocks >= sm_count(device))"
CASES = ([(64, 512, 128, k) for k in (1, 2, 3, 4, 6, 8, 12)]
         + [(32, 128, 32, k) for k in (1, 4, 8)])

RUN = """
import json, sys
sys.path.insert(0, ".")
import numpy as np
import torch
import chip_smoke
from gcm_tpu_torch.ops.cuda.spmm_slots import (bucket_sink_slots, spmm_slots,
                                               spmm_slots_plain)
for B, N, F, k in {cases}:
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((B, N, F)).astype(np.float32)).cuda()
    edges = torch.from_numpy(chip_smoke.temporal_edges(
        B, N, k * N, tuple(range(1, k + 1)), N)).cuda()
    w = torch.from_numpy(rng.uniform(0.5, 1.5, edges.shape[::2])
                         .astype(np.float32)).cuda()
    srcs, ws, _ = bucket_sink_slots(edges, w, N, k)
    chip_smoke.check(chip_smoke.bitwise_equal(spmm_slots(x, srcs, ws, N, k),
                                              spmm_slots_plain(x, srcs, ws, k)),
                     f"B={{B}} N={{N}} F={{F}} k={{k}}: differs from the plain version")
    ms = chip_smoke.time_ms(lambda: spmm_slots(x, srcs, ws, N, k))[0]
    print("AB " + json.dumps(dict(case=f"B={{B}} N={{N}} F={{F}} k={{k}}", ms=ms)))
"""


def make_copy(name: str) -> Path:
    """The package and chip_smoke.py under OUT/name, with no built kernels
    and the staged kernel's choice fixed off ("direct") or on ("staged")."""
    dst = OUT / name
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(ROOT / "gcm_tpu_torch", dst / "gcm_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    shutil.copy(ROOT / "chip_smoke.py", dst)
    src = dst / "gcm_tpu_torch" / "csrc" / "spmm_slots.cu"
    text = src.read_text()
    if text.count(CHOICE) != 1:
        raise RuntimeError(f"spmm_slots.cu: no single '{CHOICE}'")
    src.write_text(text.replace(
        CHOICE, "if (false)" if name == "direct" else "if (true)"))
    return dst


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    builds = {name: make_copy(name) for name in ("direct", "staged")}
    least: dict[str, dict[str, float]] = {}
    for _ in range(args.rounds):
        for name, path in builds.items():
            out = subprocess.run(
                [sys.executable, "-c", RUN.format(cases=CASES)], cwd=path,
                capture_output=True, text=True, timeout=600)
            if out.returncode:
                raise RuntimeError(f"{name}: exit {out.returncode}\n"
                                   f"{out.stderr[-4000:]}")
            for line in out.stdout.splitlines():
                if line.startswith("AB "):
                    t = json.loads(line[3:])
                    row = least.setdefault(t["case"], {})
                    row[name] = min(row.get(name, t["ms"]), t["ms"])
                    print(json.dumps(dict(build=name, **t)), flush=True)
    print(json.dumps(least))


if __name__ == "__main__":
    main()
