"""The readings the check's limits are set from, on the card at a cell's
own size, all in one process (no measured window: training's readings
need none).

    python3 portbench/calibrate.py --workload resnet50.phub_k2_f32 \\
        --seeds 1 2 3 4 5 6 7 8 9 10 11 12 --control-seeds 21 22 23 \\
        --out calib_resnet50.phub_k2_f32.jsonl

For each of ``--seeds``: the program's first steps against the
reference's (sound runs: the lower readings).  For each of
``--control-seeds``: the control, the reference computed in TF32 put in
the program's place, against the reference in f32; and each fault of
``faults.FAULTS_OF`` planted in the program (the upper readings).  Every
reading is one line of ``--out`` and of standard output.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--faults", nargs="*", default=None)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import importlib

    import torch

    from portbench import faults, harness
    from portbench.yardstick import compare

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda:0")
    files = harness.cell_files(args.workload)
    cfg, traffic = files["config"], files["traffic"]
    family = importlib.import_module(f"portbench.families.{cfg['family']}")
    driver = importlib.import_module(f"portbench.drivers.{traffic['driver']}")
    wanted = (faults.FAULTS_OF[traffic["driver"]] if args.faults is None
              else args.faults)
    out = open(args.out, "w")

    def program(seed):
        system = driver.System(family, cfg, traffic, seed, device)
        rec = harness.program_record(system, family, cfg, traffic, seed,
                                     device)
        system.close()
        del system
        gc.collect()
        torch.cuda.empty_cache()
        return rec

    def emit(kind, seed, prog):
        ref = harness.reference_record(family, cfg, traffic, seed, device)
        line = {"workload": args.workload, "kind": kind, "seed": seed,
                **compare.numbers(prog, ref), **compare.detail(prog, ref)}
        print(json.dumps(line), flush=True)
        out.write(json.dumps(line) + "\n")
        out.flush()

    for seed in args.seeds:
        emit("program", seed, program(seed))
    for seed in args.control_seeds:
        emit("control_tf32", seed, harness.reference_record(
            family, cfg, traffic, seed, device, prec="tf32"))
        for name in wanted:
            if name == "unchanged_state":
                continue  # reads 1 by construction (compare's module doc)
            with faults.FAULTS[name]():
                prog = program(seed)
            emit(name, seed, prog)
    out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
