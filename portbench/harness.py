"""One run of one cell: set-up, the measured window, the check.

The cell (``BENCHMARK.json``'s ``workloads`` entry) names a configuration
(``configs/<file>``: the model's sizes and its ``family``) and a traffic
mix (``traffic/<traffic>.json``: the ``driver`` and its parameters).  The
harness builds the program through ``drivers/<driver>.py`` and
``families/<family>.py``, runs the first steps (the set-up's warm-up, and
what the check compares), measures for ``seconds`` seconds, then frees
the program and runs the reference (``reference/``) over the same first
steps.  The limits of the check are ``limits/<workload>.json``.

With ``trace`` the window is a traced one of at most ``trace_rounds``
rounds, and the metrics are the per-layer ones, each read by
``metrics/<name>.py`` (``read(ctx)``: a number, or None where there is
nothing to read, and the metric is then left out).
"""
from __future__ import annotations

import gc
import importlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

from portbench.reference.precision import precision
from portbench.reference.train import first_steps
from portbench.yardstick import compare, trace
from portbench.yardstick.costs import step_flops
from portbench.yardstick.inputs import build_tree, leaves, make_params

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
FIRST_STEPS = 3
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell_files(name: str, bench: dict | None = None) -> dict:
    """The cell's entry, configuration, traffic mix and limits, by name."""
    bench = bench or manifest()
    cell = next(w for w in bench["workloads"] if w["name"] == name)
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    return {
        "cell": cell,
        "config": json.loads((ROOT / conf["file"]).read_text()),
        "traffic": json.loads(
            (HERE / "traffic" / f"{cell['traffic']}.json").read_text()),
        "limits": json.loads(
            (HERE / "limits" / f"{name}.json").read_text())["limits"],
        "bench": bench,
    }


def _reported(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


class _Clock:
    """Round boundaries: CUDA events on the card's stream (read after the
    window, so the loop never waits for them), the host clock on the CPU."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"

    def stamp(self):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def ms(self, stamps: list) -> list:
        if not self.cuda:
            return [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
        return [a.elapsed_time(b) for a, b in zip(stamps, stamps[1:])]


def _loop(system, clock, seconds: float, max_rounds: int | None,
          mark: bool = False):
    """Rounds until ``seconds`` have passed (or ``max_rounds`` are done),
    then a wait for the device; each round in a ``pb.round`` range where
    ``mark``.  Returns the round boundaries' stamps and the seconds."""
    from portbench.drivers.common import ranged

    stamps = [clock.stamp()]
    t0 = time.perf_counter()
    while True:
        with ranged("pb.round", mark):
            system.round()
        stamps.append(clock.stamp())
        if time.perf_counter() - t0 >= seconds:
            break
        if max_rounds is not None and len(stamps) > max_rounds:
            break
    clock.sync()
    return stamps, time.perf_counter() - t0


def _profiled(system, clock, seconds: float, rounds: int, ranges: bool):
    """A profiled stretch of at most ``rounds`` rounds: device activity
    alone (``ranges`` False: little overhead, so the busy share and the
    round times stand for an untraced run), or with the host's ops and
    the benchmark's ranges (``ranges`` True: device time by layer)."""
    import contextlib

    from torch.profiler import ProfilerActivity, profile, record_function

    acts = ([ProfilerActivity.CUDA] if clock.cuda else [])
    if ranges or not clock.cuda:
        acts.append(ProfilerActivity.CPU)
    first = system.rounds
    with (system.instrumented() if ranges else contextlib.nullcontext()), \
            profile(activities=acts) as prof:
        with record_function("pb.window"):
            stamps, window_s = _loop(system, clock, seconds, rounds, ranges)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        summary = trace.summarize(trace.load(path))
    if summary["window_us"] is None:
        summary["window_us"] = window_s * 1e6
    summary.update(rounds=system.rounds - first, round_ms=clock.ms(stamps))
    return summary


def _reader(name: str):
    """The reader of a per-layer metric: ``metrics/<name>.py``, by the
    part of the name before its first dot (``fwd_bwd_ms.graphs`` is
    ``fwd_bwd_ms`` in cells that report ``graphs_per_s``)."""
    base = name.split(".")[0]
    return importlib.import_module(f"portbench.metrics.{base}").read


def _power_limit() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def _program_change(prog: dict, params0: dict) -> dict:
    """The program's parameters after the first steps less the inputs'."""
    start = dict(leaves(params0))
    return build_tree((path, t - start[path].cpu())
                      for path, t in leaves(prog["params"]))


def reference_record(family, cfg, traffic, seed, device,
                     prec: str = "f32") -> dict:
    """The reference's first steps from the seed's inputs."""
    params0 = make_params(family.param_spec(cfg, traffic), seed, device)
    batches = family.batches(cfg, traffic, seed, device)
    with precision(prec, device):
        return first_steps(family.ref_loss(cfg, traffic), params0, batches,
                           traffic["optimizer"], steps=FIRST_STEPS,
                           codec=traffic.get("codec", "none"),
                           chunk_elems=traffic["chunk_elems"])


def program_record(system, family, cfg, traffic, seed, device) -> dict:
    """The program's first steps, in the reference's terms (the change of
    the parameters against the seed's inputs)."""
    prog = system.first_steps(FIRST_STEPS)
    params0 = make_params(family.param_spec(cfg, traffic), seed, device)
    prog["change"] = _program_change(prog, params0)
    del params0, prog["params"]
    return prog


def run_cell(workload: str, seed: int, seconds: float, trace_on: bool, *,
             device=None, t_start: float | None = None,
             files: dict | None = None) -> tuple[dict, dict]:
    """One run; returns (result line, checks).  ``files`` replaces what
    ``cell_files`` reads (the tests' small configurations)."""
    t_start = time.perf_counter() if t_start is None else t_start
    files = files or cell_files(workload)
    cfg, traffic, limits = files["config"], files["traffic"], files["limits"]
    bench = files["bench"]
    device = torch.device(device or "cuda")
    clock = _Clock(device)
    family = importlib.import_module(f"portbench.families.{cfg['family']}")
    driver = importlib.import_module(f"portbench.drivers.{traffic['driver']}")

    # -- set-up: build, the first steps, the cost of a round ---------------
    phases = {"start": time.perf_counter() - t_start}
    system = driver.System(family, cfg, traffic, seed, device)
    clock.sync()
    phases["build"] = time.perf_counter() - t_start
    meta = make_params(family.param_spec(cfg, traffic), 0, "meta")
    flops = system.workers * step_flops(family.meta_loss(cfg, traffic), meta,
                                        family.meta_batch(cfg, traffic))
    del meta
    phases["flops"] = time.perf_counter() - t_start
    prog = program_record(system, family, cfg, traffic, seed, device)
    clock.sync()
    phases["first_steps"] = time.perf_counter() - t_start
    setup_peak = (torch.cuda.max_memory_allocated(device) if clock.cuda
                  else 0)
    if clock.cuda:
        torch.cuda.reset_peak_memory_stats(device)
    before = system.counters()
    rounds0 = system.rounds
    setup_s = time.perf_counter() - t_start

    # -- the window --------------------------------------------------------
    busy = layers = None
    if trace_on:
        t0 = time.perf_counter()
        n = traffic["trace_rounds"]
        busy = _profiled(system, clock, seconds / 2, n, ranges=False)
        layers = _profiled(system, clock, seconds / 2, n, ranges=True)
        round_ms = busy["round_ms"] + layers["round_ms"]
        window_s = time.perf_counter() - t0
    else:
        stamps, window_s = _loop(system, clock, seconds, None)
        round_ms = clock.ms(stamps)
    peak = torch.cuda.max_memory_allocated(device) if clock.cuda else 0
    rounds = system.rounds - rounds0
    after = system.counters()
    losses_done = system.rounds * system.workers
    failed = int(system.bad)
    ctx = {"rounds": rounds, "samples": rounds * system.samples_per_round,
           "round_ms": round_ms, "window_s": window_s,
           "busy": busy, "layers": layers,
           "flops_per_round": flops, "update_bytes": system.update_bytes,
           "counters": {k: after[k] - before[k] for k in after}}
    metrics = {}
    if trace_on:
        for m in bench["per_layer"]:
            if _reported(m, workload):
                value = _reader(m["name"])(ctx)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = {
            "samples_per_s": ctx["samples"] / window_s,
            "graphs_per_s": ctx["samples"] / window_s,
            "step_ms_p95": (statistics.quantiles(
                round_ms, n=100, method="inclusive")[94]
                if len(round_ms) >= 2 else None),
            "peak_gib": peak / 2**30,
            "setup_s": setup_s,
        }
        for m in bench["end_to_end"]:
            if _reported(m, workload) and e2e.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": m["unit"]}

    # -- the check, after the program is freed -------------------------------
    system.close()
    del system
    gc.collect()
    if clock.cuda:
        torch.cuda.empty_cache()
    ref = reference_record(family, cfg, traffic, seed, device)
    correct, checks = compare.judge(compare.numbers(prog, ref), limits)

    device_info = {
        "platform": "gpu" if clock.cuda else "cpu",
        "kind": (torch.cuda.get_device_name(device) if clock.cuda else "cpu"),
        "count": 1, "memory_peak_bytes": max(setup_peak, peak)}
    result = {"correct": correct, "attempted": losses_done, "failed": failed,
              "metrics": metrics, "device": device_info}
    if trace_on:
        device_info["busy_s"] = busy["busy_us"] / 1e6
        device_info["window_s"] = busy["window_us"] / 1e6
        result["breakdown"] = {"device_ops": busy["device_ops"],
                               "idle_gaps": layers["idle_gaps"]}
    if clock.cuda:
        result["card"] = {
            "power_limit": _power_limit(), "peak_f32_tflops": 67,
            "rounds": rounds, "window_s": window_s,
            "round_ms": [min(round_ms), statistics.median(round_ms),
                         max(round_ms)] if round_ms else None,
            "range_ms": ({k: v / 1e3 for k, v in layers["range_us"].items()}
                         if layers else None),
            "setup": phases}
    result["checks"] = checks
    return result, checks


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
