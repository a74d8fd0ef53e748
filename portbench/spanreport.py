"""The program's spans in one cell: where a round's device time and the
device's idle time go, layer by layer, and what tracing costs.

    python3 portbench/spanreport.py --workload equiformer-v2.spmd_molecule \\
        --seed 7 --rounds 5 --out spans.json

From the root of a checkout, on the card (``--device cpu --small`` runs
the cell's small version on the CPU).  It builds the cell's program as
``harness.run_cell`` does, runs the set-up's three rounds, then three
stretches of ``--rounds`` rounds each:

- untraced (``--untraced-rounds`` rounds, ``--rounds`` by default): the
  median round (CUDA events at the round boundaries) and the program's
  counters over it;
- device activity alone (the traced run's first stretch): the median
  round, the idle share, and whether the stretch holds any ``ps.*`` span;
- the host's ops with the benchmark's ``pb.*`` ranges and the program's
  ``ps.*`` spans (the traced run's second stretch): the median round, the
  median device ms a round of each range and span, the median idle ms a
  round under each span (``yardstick/spans.py``), each span's host self
  ms a round, and the program's counters over the stretch.

The last line of standard output is the report (one JSON object), also
written to ``--out``.  A program without spans or counters reports them
empty.
"""
from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import os
import statistics
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _counters(system) -> dict:
    """The driver's counters, the program's tracing counters and the SPMD
    exchange's collective counts, where the program has them."""
    out = dict(system.counters())
    try:
        from repro_torch import tracing
    except ImportError:
        tracing = None
    if tracing is not None:
        out.update(tracing.counters())
    stats = getattr(getattr(system, "ex", None), "stats", None)
    if stats is not None:
        out["exchange_rounds"] = stats.rounds
        for kind, n in stats.collective_bytes.items():
            out[f"collective_bytes.{kind}"] = n
        out["collective_bytes"] = sum(stats.collective_bytes.values())
    return out


def _stretch(harness, system, clock, rounds: int, acts, ranges: bool):
    """``rounds`` rounds under a profile of ``acts`` (with the benchmark's
    ranges where ``ranges``): the trace's events, the round times and the
    counters' change over the rounds (read before the trace's export, whose
    objects the collector then sweeps)."""
    from torch.profiler import profile, record_function

    from portbench.yardstick import trace

    before = _counters(system)
    with (system.instrumented() if ranges else contextlib.nullcontext()), \
            profile(activities=acts) as prof:
        with record_function("pb.window"):
            stamps, _ = harness._loop(system, clock, float("inf"), rounds,
                                      ranges)
        counted = _change(before, _counters(system))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        events = trace.load(path)
    return events, clock.ms(stamps), counted


def _change(before: dict, after: dict) -> dict:
    return {k: after[k] - before.get(k, 0) for k in after}


def _per_round(rows: list) -> dict:
    """Median ms a round of every key of ``rows`` (µs dicts, one a round)."""
    names = {k for r in rows for k in r}
    return {k: statistics.median(r.get(k, 0.0) for r in rows) / 1e3
            for k in sorted(names)}


def report(workload: str, seed: int, rounds: int, device: str,
           small: bool = False, untraced_rounds: int | None = None) -> dict:
    import torch
    from torch.profiler import ProfilerActivity

    from portbench import harness
    from portbench.yardstick import spans, trace

    if small:
        from portbench.tests.small import files as small_files
        files = small_files(workload)
    else:
        files = harness.cell_files(workload)
    cfg, traffic = files["config"], files["traffic"]
    family = importlib.import_module(f"portbench.families.{cfg['family']}")
    driver = importlib.import_module(
        f"portbench.drivers.{traffic['driver']}")
    clock = harness._Clock(device)
    system = driver.System(family, cfg, traffic, seed, torch.device(device))
    for _ in range(harness.FIRST_STEPS):
        system.round()
    clock.sync()

    out = {"workload": workload, "seed": seed, "rounds": rounds,
           "device": (torch.cuda.get_device_name(0) if clock.cuda
                      else "cpu"),
           "power_limit": harness._power_limit() if clock.cuda else None,
           "torch": torch.__version__}
    before = _counters(system)
    stamps, _ = harness._loop(system, clock, float("inf"),
                              untraced_rounds or rounds)
    out["untraced"] = {"round_ms": statistics.median(clock.ms(stamps)),
                       "rounds": untraced_rounds or rounds,
                       "counters": _change(before, _counters(system))}

    acts = [ProfilerActivity.CUDA] if clock.cuda else [ProfilerActivity.CPU]
    events, round_ms, _ = _stretch(harness, system, clock, rounds, acts,
                                   False)
    busy = trace.summarize(events)
    window = busy["window_us"] or sum(round_ms) * 1e3
    out["device_only"] = {
        "round_ms": statistics.median(round_ms),
        "idle_share": (100.0 * (1.0 - busy["busy_us"] / window)
                       if busy["busy_us"] else None),
        "ps_spans": sum(1 for e in events
                        if str(e.get("name", "")).startswith(spans.PREFIX))}
    del events

    acts = ([ProfilerActivity.CUDA] if clock.cuda else []) + [
        ProfilerActivity.CPU]
    events, round_ms, counted = _stretch(harness, system, clock, rounds,
                                         acts, True)
    layers = trace.summarize(events)
    prog = spans.summarize(events)
    del events
    n = max(1, len(prog["rounds_us"]))
    out["ranged"] = {
        "round_ms": statistics.median(round_ms),
        "range_ms": _per_round(layers["rounds_us"]),
        "span_ms": _per_round(prog["rounds_us"]),
        "idle_ms": _per_round(prog["idle_rounds_us"]),
        "idle_ms_total": (statistics.median(
            sum(r.values()) for r in prog["idle_rounds_us"]) / 1e3
            if prog["idle_rounds_us"] else None),
        "idle_total_s": prog["idle_total_us"] / 1e6,
        "idle_gaps": layers["idle_gaps"],
        "idle_gaps_by_span": spans.idle_gaps_by_span(prog),
        "host_self_ms": {k: v / 1e3 / n
                         for k, v in sorted(prog["host_self_us"].items())},
        "counters": counted,
        "samples": rounds * system.samples_per_round}
    system.close()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--untraced-rounds", type=int)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    os.environ.setdefault("USE_FLAX", "0")
    import torch

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    out = report(args.workload, args.seed, args.rounds, args.device,
                 args.small, args.untraced_rounds)
    line = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
