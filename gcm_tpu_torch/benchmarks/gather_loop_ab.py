"""take_rows_loop at the gather probe's shape (x [64, 128], 128 rows), with
and without the kernel's instantiation for runs of one row, beside
index_select, on one CUDA card.

    python -m gcm_tpu_torch.benchmarks.gather_loop_ab [--rounds 2] [--reps 4]

Copies the package and chip_smoke.py twice under _checkout/gather_loop_ab/
(git ignores _checkout/): "one" as it is, "general" with csrc/gather.cu's
dispatch to the run-of-one instantiation turned off, so that the general
loop takes the probe's runs of one row. Then, `rounds` times, runs each copy
in a process of its own, one after the other, and in each times
chip_smoke.py's probe case of take_rows_loop `reps` times (each checked bit
for bit against its plain version). Prints one JSON line per timing (build,
ms, library_ms: index_select's) and last a summary: each build's least and
most ms and library_ms.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
OUT = ROOT / "_checkout" / "gather_loop_ab"
DISPATCH = ("if (run_len == 1 && vec)", "else if (run_len == 1)")

RUN = """
import json, sys
sys.path.insert(0, ".")
import chip_smoke
for _ in range({reps}):
    row = chip_smoke.gather_case("take_rows_loop", "probe", 7, True)
    print("AB " + json.dumps(dict(ms=row["ms"], library_ms=row["library_ms"])))
"""


def make_copy(name: str) -> Path:
    """The package and chip_smoke.py under OUT/name, with no built kernels;
    "general" with the run-of-one dispatch turned off."""
    dst = OUT / name
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(ROOT / "gcm_tpu_torch", dst / "gcm_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    shutil.copy(ROOT / "chip_smoke.py", dst)
    if name == "general":
        src = dst / "gcm_tpu_torch" / "csrc" / "gather.cu"
        text = src.read_text()
        for cond in DISPATCH:
            if text.count(cond) != 1:
                raise RuntimeError(f"gather.cu: no single '{cond}'")
            text = text.replace(cond, cond.replace("run_len == 1", "false"))
        src.write_text(text)
    return dst


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=4)
    args = ap.parse_args(argv)
    builds = {name: make_copy(name) for name in ("one", "general")}
    times: dict[str, list[dict]] = {name: [] for name in builds}
    for _ in range(args.rounds):
        for name, path in builds.items():
            out = subprocess.run(
                [sys.executable, "-c", RUN.format(reps=args.reps)], cwd=path,
                capture_output=True, text=True, timeout=600)
            if out.returncode:
                raise RuntimeError(f"{name}: exit {out.returncode}\n"
                                   f"{out.stderr[-4000:]}")
            for line in out.stdout.splitlines():
                if line.startswith("AB "):
                    t = json.loads(line[3:])
                    times[name].append(t)
                    print(json.dumps(dict(build=name, **t)), flush=True)
    print(json.dumps({name: {key: [min(t[key] for t in ts),
                                   max(t[key] for t in ts)]
                             for key in ("ms", "library_ms")}
                      for name, ts in times.items()}))


if __name__ == "__main__":
    main()
