"""The dense scan's throughput in two trees of the repository, in turns, in
one process on one CUDA card: chip_smoke.py's scan phase of each tree.

    python -m gcm_tpu_torch.benchmarks.scan_ab TREE_A TREE_B [--rounds 4]

Each tree is a directory that holds chip_smoke.py and gcm_tpu_torch/ (for
example a `git archive` of a commit unpacked under _checkout/, which git
ignores). Both trees' modules live in one process: before each call the
tree's own `chip_smoke` and `gcm_tpu_torch.*` modules are put in
`sys.modules` (imported from the tree on its first call), so each call
runs that tree's code, and the host's noise (a one-card machine shares its
CPU cores) falls on both alike. Each round runs A, B, B, A; each call is
that tree's `chip_smoke.scan_phase` (README DenseGCM, [32, 256, 8], fused
and fuse="", each scan checked against a CPU copy). Prints one JSON line
per reading (tree, round, timesteps_per_s, unfused_timesteps_per_s) and
last a summary: each tree's least, median and most of both.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import io
import json
import os
import statistics
import subprocess
import sys

KEYS = ("timesteps_per_s", "unfused_timesteps_per_s")


def _own(name: str) -> bool:
    return name == "chip_smoke" or name.split(".")[0] == "gcm_tpu_torch"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs=2)
    ap.add_argument("--rounds", type=int, default=4)
    args = ap.parse_args(argv)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    a, b = trees = [os.path.abspath(t) for t in args.trees]
    modules: dict[str, dict] = {tree: {} for tree in trees}
    readings: dict[str, list[dict]] = {tree: [] for tree in trees}
    sys.path.insert(0, "")
    for rnd in range(args.rounds):
        for tree in (a, b, b, a):
            for name in [n for n in sys.modules if _own(n)]:
                del sys.modules[name]
            sys.modules.update(modules[tree])
            sys.path[0] = tree
            importlib.invalidate_caches()
            chip_smoke = importlib.import_module("chip_smoke")
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                chip_smoke.scan_phase(card)
            modules[tree] = {n: m for n, m in sys.modules.items() if _own(n)}
            stray = [n for n, m in modules[tree].items()
                     if not getattr(m, "__file__", tree).startswith(tree)]
            if stray:
                raise RuntimeError(f"{tree}: modules of the other tree "
                                   f"{stray}")
            row = json.loads(out.getvalue().splitlines()[-1])
            r = {k: row[k] for k in KEYS}
            readings[tree].append(r)
            print(json.dumps(dict(tree=tree, round=rnd, card=card, **r)),
                  flush=True)
    print(json.dumps({tree: {k: [min(r[k] for r in rs),
                                 statistics.median(r[k] for r in rs),
                                 max(r[k] for r in rs)] for k in KEYS}
                      for tree, rs in readings.items()}))


if __name__ == "__main__":
    main()
