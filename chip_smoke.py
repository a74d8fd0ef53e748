"""Drive the PyTorch port on one CUDA card and check it end to end.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA Hopper card
and the CUDA toolkit.  It imports nothing of JAX.  Phases, each of which
raises on failure (the script then exits non-zero and prints no result):

1. the card: its name and power limit (``nvidia-smi``);
2. build: every kernel under ``src/repro_torch/csrc`` with ``nvcc`` (one
   process per source, all at once) into ``build/torch_kernels``;
3. kernels against their plain PyTorch versions on the card, bitwise:
   ``fused_agg_opt`` over five optimizers x K in {1, 2, 3, 8} x four
   (grad, param) dtype pairs x N in {8192, 3*8192+77}, step 5, lr_scale
   0.7;
4. the main path at full width: gemma3-1b (26 layers, d=1152, vocab
   262144, bf16) trained for 3 rounds by 2 workers through a 4-shard
   PBoxFabric with AdamW.  Every kernel launch count is set to 0 just
   before and read just after; shard 0's first update is captured and
   replayed through the plain version, bitwise;
5. the kernel and its plain version timed at the main path's shape
   (AdamW, K=2, N=325,451,776 f32) with CUDA events, beside the byte bound.

The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# Published device-memory rates (NVIDIA data sheets), keyed by a part of
# torch.cuda.get_device_name(); the H100 SXM's 3.35 TB/s is the default.
MEM_BYTES_PER_S = (("H100 PCIe", 2.0e12), ("H100 NVL", 3.9e12),
                   ("H200", 4.8e12), ("H100", 3.35e12))
F32_FLOPS_PER_S = 67e12  # H100 SXM, f32 outside the tensor cores


def adamw_ops(k: int) -> int:
    """f32 operations per element of one AdamW update from K gradients:
    K-1 adds and the 1/K scale, then m (3), v (4), the bias corrections
    (2), sqrt, +eps, the divide, weight decay (2) and the lr step (2)."""
    return (k - 1) + 1 + 3 + 4 + 2 + 1 + 1 + 1 + 2 + 2


def log(*a) -> None:
    print(*a, flush=True)


def card_rate(name: str) -> float:
    for key, rate in MEM_BYTES_PER_S:
        if key in name:
            return rate
    return MEM_BYTES_PER_S[-1][1]


def cuda_ms(fn, reps: int) -> float:
    """Median ms of ``fn()`` over ``reps`` runs, each between CUDA events."""
    import torch

    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_abs_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item() if a.numel() else 0.0


# -- phase 3 ---------------------------------------------------------------
def kernel_sweep(dev) -> float:
    import numpy as np
    import torch

    from repro_torch.kernels.fused_agg_opt import kernel as K
    from repro_torch.kernels.fused_agg_opt.ops import scalar_packet
    from repro_torch.optim import optimizers as O

    specs = [O.sgd(1e-2, weight_decay=0.01), O.momentum(1e-2, 0.9),
             O.momentum(1e-2, 0.9, nesterov=True), O.adam(1e-3),
             O.adamw(1e-3, weight_decay=0.1)]
    dtypes = [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
              (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)]
    worst, cases = 0.0, 0
    for spec in specs:
        for k in (1, 2, 3, 8):
            for gdt, pdt in dtypes:
                for n in (8192, 3 * 8192 + 77):
                    rng = np.random.default_rng(cases)
                    g = torch.from_numpy(rng.standard_normal((k, n), np.float32))
                    p = torch.from_numpy(rng.standard_normal(n, np.float32))
                    st = [torch.from_numpy(rng.standard_normal(n, np.float32) * 0.1)
                          for _ in range(spec.num_state_slots)]
                    if len(st) == 2:
                        st[1] = st[1].abs()
                    g, p = g.to(dev, gdt), p.to(dev, pdt)
                    st = tuple(s.to(dev) for s in st)
                    packet = scalar_packet(spec, 5, 0.7, device=dev)
                    want_p, want_s = K.fused_agg_opt_torch(g, p, st, packet, spec)
                    got_p, got_s = K.fused_agg_opt_cuda(
                        g, p.clone(), tuple(s.clone() for s in st), packet, spec)
                    torch.cuda.synchronize()
                    pairs = [(got_p, want_p), *zip(got_s, want_s)]
                    worst = max([worst] + [max_abs_err(a, b) for a, b in pairs])
                    if not all(torch.equal(a, b) for a, b in pairs):
                        raise AssertionError(
                            f"fused_agg_opt differs from its plain version: "
                            f"{spec.name} nesterov={spec.nesterov} k={k} n={n} "
                            f"{gdt}/{pdt}, max |err| {worst}")
                    cases += 1
    log(f"kernel sweep: fused_agg_opt == fused_agg_opt_torch bitwise in "
        f"{cases} cases")
    return worst


# -- phase 4 ---------------------------------------------------------------
def main_path(dev) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.configs.registry import get_arch
    from repro_torch.core.chunking import ParamSpace
    from repro_torch.core.config import FabricConfig
    from repro_torch.core.fabric import PBoxFabric, WorkerHarness
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.kernels.fused_agg_opt import kernel as K
    from repro_torch.kernels.fused_agg_opt.ops import scalar_packet
    from repro_torch.models.transformer import init_params, lm_loss_and_grad
    from repro_torch.optim.optimizers import adamw

    rounds, workers, shards, seq = 3, 2, 4, 1024
    cfg = get_arch("gemma3-1b").config
    torch.cuda.reset_peak_memory_stats(dev)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    space = ParamSpace.build(params)
    log(space.describe())
    spec = adamw(3e-3)
    init = space.flatten(params)
    del params
    fab = PBoxFabric(space, spec, init,
                     config=FabricConfig(num_shards=shards, num_workers=workers),
                     device=dev)
    del init
    streams = [lm_batches(cfg.vocab, 1, seq, seed=w) for w in range(workers)]
    losses: list = []
    mem: list = [("fabric built", torch.cuda.memory_allocated(dev),
                  torch.cuda.max_memory_allocated(dev))]

    def grad_fn(p, wstep):
        b = next(streams[wstep[0]])
        with record_function("worker.fwd_bwd"):
            loss, g = lm_loss_and_grad(
                p, torch.from_numpy(b["tokens"]).to(dev),
                torch.from_numpy(b["labels"]).to(dev), cfg)
        losses.append(loss)
        mem.append((f"w{wstep[0]} step {wstep[1]} grads",
                    torch.cuda.memory_allocated(dev),
                    torch.cuda.max_memory_allocated(dev)))
        return g

    # Instrumentation: CUDA events around every kernel launch, and shard
    # 0's first update captured to host memory (inputs before, outputs
    # after) for a replay through the plain version.
    launch_ms: list = []
    launch = K.fused_agg_opt_cuda

    def timed_launch(*args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = launch(*args, **kwargs)
        end.record()
        launch_ms.append((start, end))
        return out

    captured: dict = {}
    shard0 = fab.shards[0]
    apply0 = shard0.apply

    def host_copy(x):
        return x.to("cpu", copy=True)

    def capturing_apply(grads, step, *, average):
        if step == 1:
            captured["in"] = (host_copy(grads), host_copy(shard0.params),
                              tuple(map(host_copy, shard0.state)), step)
        apply0(grads, step, average=average)
        if step == 1:
            captured["out"] = (host_copy(shard0.params),
                               tuple(map(host_copy, shard0.state)))

    pull0, push0 = fab.pull, fab.push

    def labelled(name, fn):
        def call(*args, **kwargs):
            with record_function(name):
                return fn(*args, **kwargs)
        return call

    fab.pull = labelled("fabric.pull", pull0)
    fab.push = labelled("fabric.push+aggregate", push0)
    shard0.apply = capturing_apply
    K.fused_agg_opt_cuda = timed_launch
    h = WorkerHarness(fab, grad_fn, lambda w, s: (w, s))
    round_ms = []
    # the last round runs under torch.profiler: device time by kernel and
    # host time by phase (the profiler slows the host, so the unprofiled
    # round before it is the steady wall time)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    try:
        K.launches = 0
        for r in range(1, rounds + 1):
            if r == rounds:
                prof.start()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            h.run(r)
            torch.cuda.synchronize()
            round_ms.append((time.perf_counter() - t0) * 1e3)
            mem.append((f"round {r} done", torch.cuda.memory_allocated(dev),
                        torch.cuda.max_memory_allocated(dev)))
        prof.stop()
        launches = K.launches
    finally:
        K.fused_agg_opt_cuda = launch
        del shard0.apply, fab.pull, fab.push
    peak = torch.cuda.max_memory_allocated(dev)
    loss_vals = [x.item() for x in losses]
    kernel_ms = [s.elapsed_time(e) for s, e in launch_ms]
    log(fab.describe())
    log(f"main path: gemma3-1b full width, {rounds} rounds x {workers} "
        f"workers, batch 1 x {seq} tokens, {shards} shards, AdamW")
    log(f"  losses {loss_vals}")
    log(f"  round wall ms {[round(x, 1) for x in round_ms]} (round 1 "
        f"includes cuBLAS warm-up and the shard-0 capture to host memory)")
    log(f"  fused_agg_opt launches {launches}; ms per launch (CUDA events, "
        f"median of {len(kernel_ms)}) {statistics.median(kernel_ms):.4f}; "
        f"all {[round(x, 4) for x in kernel_ms]}")
    log(f"  peak device memory {peak} bytes ({peak / 2**30:.2f} GiB)")
    log("  device memory GiB (allocated, peak so far): " + "; ".join(
        f"{name} {a / 2**30:.2f}/{m / 2**30:.2f}" for name, a, m in mem))
    breakdown = profile_summary(prof, round_ms[-2], launch_ms[-shards:])
    if not all(math.isfinite(x) for x in loss_vals):
        raise AssertionError(f"non-finite loss: {loss_vals}")
    if fab.stats.steps != rounds:
        raise AssertionError(f"fabric ran {fab.stats.steps} rounds, not {rounds}")
    if launches != shards * rounds:
        raise AssertionError(
            f"fused_agg_opt launched {launches} times, not {shards * rounds}")
    flat = fab.params
    if tuple(flat.shape) != (space.flat_elems,) or not torch.isfinite(flat).all():
        raise AssertionError("fabric params are not finite or misshapen")
    n0 = shard0.num_elems
    del fab, h, flat, shard0, losses
    torch.cuda.empty_cache()

    # replay shard 0's first update through the plain version, in slices
    # (the update is elementwise, so a slice's plain result is the same
    # bits as the whole's)
    grads, p, st, step = captured["in"]
    got_p, got_s = captured["out"]
    k = grads.shape[0]
    grads = grads.reshape(k, n0)
    p, st = p.reshape(n0), tuple(s.reshape(n0) for s in st)
    got_p, got_s = got_p.reshape(n0), tuple(s.reshape(n0) for s in got_s)
    packet = scalar_packet(spec, step, device=dev)
    worst, piece = 0.0, 1 << 25
    for a in range(0, n0, piece):
        sl = slice(a, min(a + piece, n0))
        want_p, want_s = K.fused_agg_opt_torch(
            grads[:, sl].to(dev), p[sl].to(dev),
            tuple(s[sl].to(dev) for s in st), packet, spec)
        pairs = [(got_p[sl], want_p.cpu()),
                 *[(g[sl], w.cpu()) for g, w in zip(got_s, want_s)]]
        worst = max([worst] + [max_abs_err(x, y) for x, y in pairs])
        if not all(torch.equal(x, y) for x, y in pairs):
            raise AssertionError(
                f"main-path launch differs from the plain version, max |err| {worst}")
    log(f"  shard 0 round 1 (K={k}, N={n0}): kernel == plain version bitwise")
    return {"launches": launches, "main_path_ms": statistics.median(kernel_ms),
            "max_abs_err": worst, "n": n0, "k": k, "peak_bytes": peak,
            "round_ms": round_ms, "losses": loss_vals, **breakdown}


def profile_summary(prof, steady_round_ms: float, last_launches) -> dict:
    """Print where the profiled round's time went: host time per labelled
    phase, device busy time (the union of kernel, copy and fill intervals)
    against the unprofiled round's wall time, and the top kernels."""
    from torch.autograd import DeviceType

    def on_device(e):
        return e.device_type == DeviceType.CUDA and not e.is_user_annotation

    for e in prof.key_averages():
        if e.is_user_annotation and e.device_type == DeviceType.CPU:
            log(f"    host   {e.cpu_time_total / 1e3:9.2f} ms  x{e.count:<5d} "
                f"{e.key} (wall time inside the range, profiler on)")
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if on_device(e))
    busy_us, reach = 0.0, float("-inf")
    for start, end in spans:
        busy_us += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    if busy_us <= 0:
        log("  profiler: no device time recorded (not measured)")
        return {"device_busy_ms": None}
    kernel_us = sum(s.elapsed_time(e) for s, e in last_launches) * 1e3
    log(f"  profiled round: device busy {busy_us / 1e3:.1f} ms = "
        f"{busy_us / 1e3 / steady_round_ms:.1%} of the unprofiled round "
        f"({steady_round_ms:.1f} ms), idle "
        f"{1 - busy_us / 1e3 / steady_round_ms:.1%}; fused_agg_opt "
        f"{kernel_us / 1e3:.1f} ms = {kernel_us / busy_us:.1%} of device time")
    kernels = [e for e in prof.key_averages() if on_device(e)]
    for e in sorted(kernels, key=lambda e: e.self_device_time_total,
                    reverse=True)[:12]:
        log(f"    device {e.self_device_time_total / 1e3:9.2f} ms  "
            f"x{e.count:<5d} {e.key[:100]}")
    return {"device_busy_ms": busy_us / 1e3}


# -- phase 5 ---------------------------------------------------------------
def time_at_main_shape(dev, n: int, k: int) -> dict:
    import torch

    from repro_torch.kernels.fused_agg_opt import kernel as K
    from repro_torch.kernels.fused_agg_opt.ops import scalar_packet
    from repro_torch.optim.optimizers import adamw

    spec = adamw(3e-3)
    gen = torch.Generator(device=dev).manual_seed(1)
    grads = torch.randn((k, n), generator=gen, device=dev)
    p = torch.randn(n, generator=gen, device=dev)
    m = torch.randn(n, generator=gen, device=dev) * 0.1
    v = (torch.randn(n, generator=gen, device=dev) * 0.1).abs()
    packet = scalar_packet(spec, 1, device=dev)
    want_p, want_s = K.fused_agg_opt_torch(grads, p, (m, v), packet, spec)
    K.fused_agg_opt_cuda(grads, p, (m, v), packet, spec)  # in place
    torch.cuda.synchronize()
    err = max(max_abs_err(p, want_p), *[max_abs_err(a, b) for a, b in
                                        zip((m, v), want_s)])
    if not (torch.equal(p, want_p) and torch.equal(m, want_s[0])
            and torch.equal(v, want_s[1])):
        raise AssertionError(f"kernel differs at the main shape, max |err| {err}")
    del want_p, want_s
    kernel_ms = cuda_ms(lambda: K.fused_agg_opt_cuda(grads, p, (m, v), packet,
                                                     spec), reps=20)
    plain_ms = cuda_ms(lambda: K.fused_agg_opt_torch(grads, p, (m, v), packet,
                                                     spec), reps=5)
    name = torch.cuda.get_device_name(dev)
    nbytes = (k * 4 + 2 * 4 + 2 * 2 * 4) * n  # grads in; param, m, v in+out
    ops = adamw_ops(k) * n
    byte_ms = nbytes / card_rate(name) * 1e3
    op_ms = ops / F32_FLOPS_PER_S * 1e3
    bound_ms = max(byte_ms, op_ms)
    log(f"timing at the main shape (AdamW, K={k}, N={n}, f32): kernel "
        f"{kernel_ms:.4f} ms (median of 20), plain version {plain_ms:.4f} ms "
        f"(median of 5); bound {bound_ms:.4f} ms = {nbytes} bytes at "
        f"{card_rate(name) / 1e12:g} TB/s (operations: {op_ms:.4f} ms); "
        f"kernel reaches {bound_ms / kernel_ms:.1%} of the bound")
    return {"ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if byte_ms >= op_ms else "operations",
            "max_abs_err": err, "bytes": nbytes}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    name = torch.cuda.get_device_name(dev)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    log(f"device: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(smi.stdout.strip().splitlines()[0])

    secs = _build.build_all()
    log(f"build: {_build.sources()} in {secs:.1f} s")
    for src in _build.sources():
        for line in _build.build_log(src).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {src}: {line.strip()}")

    sweep_err = kernel_sweep(dev)
    run = main_path(dev)
    timing = time_at_main_shape(dev, run["n"], run["k"])
    kernels = [{
        "name": "fused_agg_opt",
        "route": "cuda",
        "source": "src/repro_torch/csrc/fused_agg_opt.cu",
        "replaces": "src/repro/kernels/fused_agg_opt/kernel.py:162",
        "held_against": "fused_agg_opt_torch",
        "match": "bitwise",
        "launches": run["launches"],
        "max_abs_err": max(sweep_err, run["max_abs_err"], timing["max_abs_err"]),
        "ms": timing["ms"],
        "main_path_ms": run["main_path_ms"],
        "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"],
        "library_ms": None,
        "shape": {"k": run["k"], "n": run["n"], "optimizer": "adamw",
                  "dtype": "f32"},
    }]
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
