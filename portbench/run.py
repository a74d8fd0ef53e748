"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload resnet50.phub_k2_f32 --seed 7 \\
        --seconds 40 --trace 0

From the root of a checkout, on a machine with the CUDA card the cell
asks for.  The last line of standard output is the result (one JSON
object); the last lines of standard error are the numbers the check
compared, each beside its limit.  Without a card, or with fewer cards
than the cell asks for, the run exits with code 2 and prints no result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # the program is the checkout's src/repro_torch; its kernels build into
    # the checkout's build/ (kernels/_build.py)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    os.environ.setdefault("USE_FLAX", "0")
    import torch

    from portbench import harness

    cell = next((w for w in harness.manifest()["workloads"]
                 if w["name"] == args.workload), None)
    if cell is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} cards, this machine has "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result, checks = harness.run_cell(
        args.workload, args.seed, args.seconds, bool(args.trace),
        device="cuda:0", t_start=T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"the run loaded {', '.join(found)}: the benchmark measures "
              "repro_torch alone", file=sys.stderr)
        return 3
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
