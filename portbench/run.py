"""Runs one cell of the benchmark on the card this process starts on:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

and prints, as the last line of standard output, one JSON object: correct,
attempted, failed, metrics, device (and breakdown with --trace 1), then the
numbers compared with their limits under "checks"; those numbers also end
standard error. Without a card (or with fewer than the cell needs), or if
JAX or the JAX package got loaded, it prints no result and exits non-zero.
"""

import time

T_START = time.perf_counter()  # set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        from portbench import harness

        result = harness.run(args.workload, args.seed, args.seconds,
                             bool(args.trace), T_START)
    except Exception as e:  # the run's boundary: report, print no result
        traceback.print_exc()
        print(f"portbench: {type(e).__name__}: {e}", file=sys.stderr)
        return {"NoCard": 3, "ForbiddenImport": 4}.get(type(e).__name__, 1)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
