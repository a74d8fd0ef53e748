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
   0.7; ``quantize_chunks``/``dequantize_chunks`` over N in {8192,
   37*8192} x chunk in {128, 8192}, and N = 5*65536 at chunk 65536, with
   zero, NaN and inf chunks, each slab also one element off alignment;
   ``wire_fused`` over none/bf16/int8 x five optimizers x K in {1, 2, 3,
   8}, against its plain version and against the unfused kernel pipeline
   (dequantize, then ``fused_agg_opt``);
4. the f32 main path at full width: gemma3-1b (26 layers, d=1152, vocab
   262144, bf16) trained for 3 rounds by 2 workers through a 4-shard
   PBoxFabric with AdamW over the raw f32 wire.  Every kernel launch count
   is set to 0 just before and read just after; shard 0's first update is
   captured and replayed through the plain version, bitwise;
5. the int8 main path: the same loop with the int8 wire codec (error
   feedback on, fused wire path on).  The counts are set to 0 just before
   and read just after: 6 quantize, 6 dequantize, 12 wire_fused and no
   fused_agg_opt launches, 3 fused wire rounds.  Shard 0's first
   ``apply_wire`` is replayed through ``wire_fused_torch`` and through the
   unfused kernel pipeline, and worker 0's round-2 quantize (of its
   error-corrected gradients) and dequantize through their plain versions,
   all bitwise;
6. every kernel and its plain version timed at its main path's shape with
   CUDA events, beside its byte bound and, where one PyTorch call computes
   the same function, that call's time.

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
ROUNDS, WORKERS, SHARDS, SEQ = 3, 2, 4, 1024


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


def bound(name: str, nbytes: int, ops: int) -> dict:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the f32 operations over the f32 peak."""
    byte_ms = nbytes / card_rate(name) * 1e3
    op_ms = ops / F32_FLOPS_PER_S * 1e3
    return {"bound_ms": max(byte_ms, op_ms), "byte_ms": byte_ms,
            "op_ms": op_ms, "bytes": nbytes,
            "bound_by": "bytes" if byte_ms >= op_ms else "operations"}


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
    if not a.numel():
        return 0.0
    d = (a.float() - b.float()).abs()
    # NaN/inf in the same places on both sides agree; elsewhere they count
    same = (a.float() == b.float()) | (a.float().isnan() & b.float().isnan())
    return d.masked_fill(same, 0.0).max().item()


def same_bits(a, b) -> bool:
    """Bitwise equality, NaN payloads included."""
    import torch

    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype.is_floating_point:
        view = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
        return torch.equal(a.view(view[a.dtype]), b.view(view[b.dtype]))
    return torch.equal(a, b)


# -- phase 3 ---------------------------------------------------------------
def _specs():
    from repro_torch.optim import optimizers as O

    return [O.sgd(1e-2, weight_decay=0.01), O.momentum(1e-2, 0.9),
            O.momentum(1e-2, 0.9, nesterov=True), O.adam(1e-3),
            O.adamw(1e-3, weight_decay=0.1)]


def _state(rng, spec, n, dev):
    import numpy as np
    import torch

    st = [torch.from_numpy(rng.standard_normal(n, np.float32) * 0.1)
          for _ in range(spec.num_state_slots)]
    if len(st) == 2:
        st[1] = st[1].abs()
    return tuple(s.to(dev) for s in st)


def kernel_sweep(dev) -> float:
    import numpy as np
    import torch

    from repro_torch.kernels.fused_agg_opt import kernel as K
    from repro_torch.kernels.fused_agg_opt.ops import scalar_packet

    dtypes = [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
              (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)]
    worst, cases = 0.0, 0
    for spec in _specs():
        for k in (1, 2, 3, 8):
            for gdt, pdt in dtypes:
                for n in (8192, 3 * 8192 + 77):
                    rng = np.random.default_rng(cases)
                    g = torch.from_numpy(rng.standard_normal((k, n), np.float32))
                    p = torch.from_numpy(rng.standard_normal(n, np.float32))
                    st = _state(rng, spec, n, dev)
                    g, p = g.to(dev, gdt), p.to(dev, pdt)
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


def _shifted(t, offset: int):
    """A copy of flat ``t`` that starts ``offset`` elements into a fresh
    buffer (offset 1 is off every vector alignment)."""
    import torch

    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    view = buf[offset:]
    view.copy_(t)
    return view


def _special_slab(rng, n: int, chunk: int):
    """A seeded normal slab whose first chunks are all zero, hold a NaN,
    hold +inf and -inf, and hold NaN beside inf."""
    import numpy as np

    x = (rng.standard_normal(n) * rng.uniform(0.01, 100)).astype(np.float32)
    c = n // chunk
    if c >= 4:
        x[:chunk] = 0.0
        x[chunk + 3] = np.nan
        x[2 * chunk + 5], x[2 * chunk + 9] = np.inf, -np.inf
        x[3 * chunk + 1], x[3 * chunk + 2] = np.nan, np.inf
    return x


def quant_sweep(dev) -> dict:
    """Both quant kernels against their plain versions, bitwise."""
    import numpy as np
    import torch

    from repro_torch.kernels.quant import kernel as Q

    worst = {"quantize_chunks": 0.0, "dequantize_chunks": 0.0}
    cases = 0
    # chunk 65536 is too large for a block's registers and takes the
    # kernel's two-pass route; offset 1 takes the one-element loads
    shapes = [(n, chunk) for n in (8192, 37 * 8192) for chunk in (128, 8192)]
    for n, chunk in shapes + [(5 * 65536, 65536)]:
        for offset in (0, 1):
            rng = np.random.default_rng(1000 + cases)
            x = torch.from_numpy(_special_slab(rng, n, chunk)).to(dev)
            want_q, want_s = Q.quantize_chunks_torch(x, chunk)
            got_q, got_s = Q.quantize_chunks_cuda(_shifted(x, offset), chunk)
            want_d = Q.dequantize_chunks_torch(want_q, want_s, chunk)
            got_d = Q.dequantize_chunks_cuda(_shifted(want_q, offset), want_s,
                                             chunk)
            torch.cuda.synchronize()
            worst["quantize_chunks"] = max(
                worst["quantize_chunks"], max_abs_err(got_q, want_q),
                max_abs_err(got_s, want_s))
            worst["dequantize_chunks"] = max(
                worst["dequantize_chunks"], max_abs_err(got_d, want_d))
            if not (same_bits(got_q, want_q) and same_bits(got_s, want_s)):
                raise AssertionError(
                    f"quantize_chunks differs from its plain version: n={n} "
                    f"chunk={chunk} offset={offset}, max |err| "
                    f"{worst['quantize_chunks']}")
            if not same_bits(got_d, want_d):
                raise AssertionError(
                    f"dequantize_chunks differs from its plain version: n={n} "
                    f"chunk={chunk} offset={offset}, max |err| "
                    f"{worst['dequantize_chunks']}")
            cases += 1
    log(f"kernel sweep: quantize_chunks and dequantize_chunks == their plain "
        f"versions bitwise in {cases} cases (zero, NaN and inf chunks "
        f"included)")
    return worst


def _wire_streams(rng, codec: str, k: int, n: int, chunk: int, dev):
    """K encoded streams as the fabric makes them: the plain quantize of
    seeded normal slabs (int8), their bf16 rounding, or the raw f32."""
    import numpy as np
    import torch

    from repro_torch.kernels.quant import kernel as Q

    g = torch.from_numpy(rng.standard_normal((k, n), np.float32)).to(dev)
    if codec == "none":
        return g, None
    if codec == "bf16":
        return g.to(torch.bfloat16), None
    pairs = [Q.quantize_chunks_torch(g[i], chunk) for i in range(k)]
    return (torch.stack([q for q, _ in pairs]),
            torch.stack([s for _, s in pairs]))


def wire_sweep(dev) -> float:
    """wire_fused against its plain version and against the unfused kernel
    pipeline (dequantize kernel per stream, then fused_agg_opt), bitwise.
    The K=2 cases also run with the param and state slabs one element off
    16-byte alignment, which takes the kernel's one-element path."""
    import numpy as np
    import torch

    from repro_torch.kernels.fused_agg_opt.ops import scalar_packet
    from repro_torch.kernels.wire_path import kernel as W
    from repro_torch.kernels.wire_path.ops import unfused_wire_update

    chunk, n = 4096, 3 * 4096
    worst, cases = 0.0, 0
    for codec in ("none", "bf16", "int8"):
        for spec in _specs():
            for k in (1, 2, 3, 8):
                for offset in ((0, 1) if k == 2 else (0,)):
                    rng = np.random.default_rng(2000 + cases)
                    pay, sc = _wire_streams(rng, codec, k, n, chunk, dev)
                    p = torch.from_numpy(rng.standard_normal(n, np.float32)).to(dev)
                    st = _state(rng, spec, n, dev)
                    packet = scalar_packet(spec, 4, 0.7, device=dev)
                    want_p, want_s = W.wire_fused_torch(
                        pay, sc, p, st, packet, spec, codec=codec,
                        chunk_elems=chunk)
                    got_p, got_s = W.wire_fused_cuda(
                        pay, sc, _shifted(p, offset),
                        tuple(_shifted(x, offset) for x in st), packet,
                        spec, codec=codec, chunk_elems=chunk)
                    un_p, un_s = unfused_wire_update(
                        pay, sc, p.clone(), tuple(s.clone() for s in st), spec,
                        4, 0.7, codec=codec, chunk_elems=chunk)
                    torch.cuda.synchronize()
                    pairs = [(got_p, want_p), *zip(got_s, want_s),
                             (got_p, un_p), *zip(got_s, un_s)]
                    worst = max([worst] + [max_abs_err(a, b) for a, b in pairs])
                    if not all(torch.equal(a, b) for a, b in pairs):
                        raise AssertionError(
                            f"wire_fused differs from its plain version or the "
                            f"unfused kernel pipeline: {codec} {spec.name} "
                            f"nesterov={spec.nesterov} k={k} offset={offset}, "
                            f"max |err| {worst}")
                    cases += 1
    log(f"kernel sweep: wire_fused == wire_fused_torch == dequantize + "
        f"fused_agg_opt kernels bitwise in {cases} cases")
    return worst


# -- phases 4 and 5 ----------------------------------------------------------
class LaunchTimer:
    """CUDA events around every call of a kernel wrapper on the main path
    (a module attribute, swapped in and restored)."""

    def __init__(self, module, attr: str):
        self.module, self.attr = module, attr
        self.launch = getattr(module, attr)
        self.events: list = []

    def __enter__(self):
        import torch

        def timed(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = self.launch(*args, **kwargs)
            end.record()
            self.events.append((start, end))
            return out

        setattr(self.module, self.attr, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.attr, self.launch)

    def ms(self) -> list:
        return [s.elapsed_time(e) for s, e in self.events]


class CaptureCall:
    """Device copies of the tensor arguments and outputs of call number
    ``index`` (from 0) of a kernel wrapper on the main path (a module
    attribute, swapped in and restored).  The copies queue on the stream
    without a host wait, so a timed round is not held up; ``memory`` is
    told their bytes before they are made."""

    def __init__(self, module, attr: str, index: int, memory):
        self.module, self.attr, self.index = module, attr, index
        self.memory = memory
        self.launch = getattr(module, attr)
        self.calls = 0
        self.args = self.out = None

    def __enter__(self):
        import torch

        def capture(*args, **kwargs):
            out = self.launch(*args, **kwargs)
            if self.calls == self.index:
                outs = out if isinstance(out, tuple) else (out,)
                self.memory.hold(sum(
                    t.numel() * t.element_size()
                    for t in (*args, *outs) if torch.is_tensor(t)))
                self.args = tuple(a.clone() if torch.is_tensor(a) else a
                                  for a in args)
                self.out = tuple(t.clone() for t in outs)
            self.calls += 1
            return out

        setattr(self.module, self.attr, capture)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.attr, self.launch)


class PathMemory:
    """The main path's device memory, allocated and peak, without the
    bytes its captures hold (kept apart with a peak reset at each one)."""

    def __init__(self, dev):
        import torch

        self.dev, self.held, self.peak = dev, 0, 0
        torch.cuda.reset_peak_memory_stats(dev)

    def hold(self, nbytes: int) -> None:
        import torch

        self.peak = self.now()[1]
        self.held += nbytes
        torch.cuda.reset_peak_memory_stats(self.dev)

    def now(self) -> tuple:
        """(allocated, peak so far) in bytes."""
        import torch

        return (torch.cuda.memory_allocated(self.dev) - self.held,
                max(self.peak,
                    torch.cuda.max_memory_allocated(self.dev) - self.held))


def _host(x):
    return x.to("cpu", copy=True)


def main_path(dev, codec: str) -> dict:
    """Train gemma3-1b at full width for ROUNDS rounds through the fabric
    with ``codec`` on the wire.  Returns the path's launch counts, timings
    and shard 0's captured first update."""
    import contextlib

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.configs.registry import get_arch
    from repro_torch.core.chunking import ParamSpace
    from repro_torch.core.compression import CompressionConfig
    from repro_torch.core.config import FabricConfig, WireConfig
    from repro_torch.core.fabric import PBoxFabric, WorkerHarness
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.kernels.fused_agg_opt import kernel as K
    from repro_torch.kernels.quant import kernel as Q
    from repro_torch.kernels.wire_path import kernel as W
    from repro_torch.models.transformer import init_params, lm_loss_and_grad
    from repro_torch.optim.optimizers import adamw

    cfg = get_arch("gemma3-1b").config
    memory = PathMemory(dev)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    space = ParamSpace.build(params)
    log(space.describe())
    spec = adamw(3e-3)
    init = space.flatten(params)
    del params
    fab = PBoxFabric(
        space, spec, init, device=dev,
        config=FabricConfig(num_shards=SHARDS, num_workers=WORKERS,
                            wire=WireConfig(compression=CompressionConfig(
                                codec=codec))))
    del init
    streams = [lm_batches(cfg.vocab, 1, SEQ, seed=w) for w in range(WORKERS)]
    losses: list = []
    mem: list = [("fabric built", *memory.now())]

    def grad_fn(p, wstep):
        b = next(streams[wstep[0]])
        with record_function("worker.fwd_bwd"):
            loss, g = lm_loss_and_grad(
                p, torch.from_numpy(b["tokens"]).to(dev),
                torch.from_numpy(b["labels"]).to(dev), cfg)
        losses.append(loss)
        mem.append((f"w{wstep[0]} step {wstep[1]} grads", *memory.now()))
        return g

    # shard 0's first update captured to host memory (inputs before,
    # outputs after) for a replay through the plain version
    captured: dict = {}
    shard0 = fab.shards[0]
    fused = fab._fused_wire
    apply_name = "apply_wire" if fused else "apply"
    apply0 = getattr(shard0, apply_name)

    def capturing_apply(*args, **kwargs):
        step = args[-1]
        if step == 1:
            captured["in"] = (tuple(_host(a) if torch.is_tensor(a) else a
                                    for a in args),
                              _host(shard0.params),
                              tuple(map(_host, shard0.state)))
        apply0(*args, **kwargs)
        if step == 1:
            captured["out"] = (_host(shard0.params),
                               tuple(map(_host, shard0.state)))

    def labelled(name, fn):
        def call(*args, **kwargs):
            with record_function(name):
                return fn(*args, **kwargs)
        return call

    fab.pull = labelled("fabric.pull", fab.pull)
    fab.push = labelled("fabric.push+aggregate", fab.push)
    setattr(shard0, apply_name, capturing_apply)
    kernel_name = "wire_fused" if fused else "fused_agg_opt"
    timer = LaunchTimer(W, "wire_fused_cuda") if fused else LaunchTimer(
        K, "fused_agg_opt_cuda")
    h = WorkerHarness(fab, grad_fn, lambda w, s: (w, s))
    round_ms = []
    # the last round runs under torch.profiler: device time by kernel and
    # host time by phase (the profiler slows the host, so the unprofiled
    # round before it is the steady wall time)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    # worker 0's round-2 encode (the quantize of its gradients plus the
    # round-1 residual, then the dequantize for the new residual), captured
    # for a replay: each worker encodes once a round
    codec_calls = ([CaptureCall(Q, "quantize_chunks_cuda", WORKERS, memory),
                    CaptureCall(Q, "dequantize_chunks_cuda", WORKERS, memory)]
                   if codec == "int8" else [])
    try:
        with timer, contextlib.ExitStack() as stack:
            for call in codec_calls:
                stack.enter_context(call)
            # every count of the port's kernels to 0 just before the path
            K.launches = Q.quantize_launches = Q.dequantize_launches = 0
            W.launches = 0
            for r in range(1, ROUNDS + 1):
                if r == ROUNDS:
                    prof.start()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                h.run(r)
                torch.cuda.synchronize()
                round_ms.append((time.perf_counter() - t0) * 1e3)
                mem.append((f"round {r} done", *memory.now()))
            prof.stop()
            # ...and read just after
            launches = {"fused_agg_opt": K.launches,
                        "quantize_chunks": Q.quantize_launches,
                        "dequantize_chunks": Q.dequantize_launches,
                        "wire_fused": W.launches}
    finally:
        del fab.pull, fab.push
        delattr(shard0, apply_name)
    peak = memory.now()[1]
    loss_vals = [x.item() for x in losses]
    kernel_ms = timer.ms()
    log(fab.describe())
    log(f"main path ({codec} wire): {cfg.name}, {ROUNDS} rounds x {WORKERS} "
        f"workers, batch 1 x {SEQ} tokens, {SHARDS} shards, AdamW")
    log(f"  losses {loss_vals}")
    log(f"  round wall ms {[round(x, 1) for x in round_ms]} (round 1 "
        f"includes cuBLAS warm-up and the shard-0 capture to host memory)")
    log(f"  launches {launches}; fused wire rounds {fab.stats.fused_wire_rounds}")
    log(f"  {kernel_name} ms per launch (CUDA events, median of "
        f"{len(kernel_ms)}) {statistics.median(kernel_ms):.4f}; all "
        f"{[round(x, 4) for x in kernel_ms]}")
    log(f"  bytes pushed {fab.stats.bytes_pushed}, pulled "
        f"{fab.stats.bytes_pulled}")
    log(f"  peak device memory {peak} bytes ({peak / 2**30:.2f} GiB)"
        + (f", not counting the {memory.held} bytes of device copies the "
           f"replay check holds" if memory.held else ""))
    log("  device memory GiB (allocated, peak so far): " + "; ".join(
        f"{name} {a / 2**30:.2f}/{m / 2**30:.2f}" for name, a, m in mem))
    breakdown = profile_summary(prof, round_ms[-2], timer.events[-SHARDS:],
                                kernel_name)
    if not all(math.isfinite(x) for x in loss_vals):
        raise AssertionError(f"non-finite loss: {loss_vals}")
    if fab.stats.steps != ROUNDS:
        raise AssertionError(f"fabric ran {fab.stats.steps} rounds, not {ROUNDS}")
    want = ({"fused_agg_opt": 0, "quantize_chunks": WORKERS * ROUNDS,
             "dequantize_chunks": WORKERS * ROUNDS,
             "wire_fused": SHARDS * ROUNDS} if codec == "int8" else
            {"fused_agg_opt": SHARDS * ROUNDS, "quantize_chunks": 0,
             "dequantize_chunks": 0, "wire_fused": 0})
    if launches != want:
        raise AssertionError(f"launch counts {launches}, expected {want}")
    if fab.stats.fused_wire_rounds != (ROUNDS if codec != "none" else 0):
        raise AssertionError(
            f"fused_wire_rounds {fab.stats.fused_wire_rounds} after {ROUNDS} "
            f"rounds of the {codec} wire")
    flat = fab.params
    if tuple(flat.shape) != (space.flat_elems,) or not torch.isfinite(flat).all():
        raise AssertionError("fabric params are not finite or misshapen")
    for call in codec_calls:
        captured[call.attr.removesuffix("_cuda")] = (call.args, call.out)
    n0 = shard0.num_elems
    del fab, h, flat, shard0, losses
    torch.cuda.empty_cache()
    return {"launches": launches, "kernel": kernel_name,
            "main_path_ms": statistics.median(kernel_ms), "n": n0,
            "flat": space.flat_elems, "chunk": space.chunk_elems,
            "peak_bytes": peak, "round_ms": round_ms, "losses": loss_vals,
            "captured": captured, "spec": spec, **breakdown}


def replay_f32(dev, run: dict) -> float:
    """Shard 0's first f32 update through fused_agg_opt's plain version, in
    slices (the update is elementwise, so a slice's plain result is the
    same bits as the whole's)."""
    from repro_torch.kernels.fused_agg_opt import kernel as K
    from repro_torch.kernels.fused_agg_opt.ops import scalar_packet

    (grads, step), p, st = run["captured"]["in"]
    got_p, got_s = run["captured"]["out"]
    n0 = run["n"]
    k = grads.shape[0]
    grads = grads.reshape(k, n0)
    p, st = p.reshape(n0), tuple(s.reshape(n0) for s in st)
    got_p, got_s = got_p.reshape(n0), tuple(s.reshape(n0) for s in got_s)
    packet = scalar_packet(run["spec"], step, device=dev)
    worst, piece = 0.0, 1 << 25
    for a in range(0, n0, piece):
        sl = slice(a, min(a + piece, n0))
        want_p, want_s = K.fused_agg_opt_torch(
            grads[:, sl].to(dev), p[sl].to(dev),
            tuple(s[sl].to(dev) for s in st), packet, run["spec"])
        pairs = [(got_p[sl], want_p.cpu()),
                 *[(g[sl], w.cpu()) for g, w in zip(got_s, want_s)]]
        worst = max([worst] + [max_abs_err(x, y) for x, y in pairs])
        if not all(same_bits(x, y) for x, y in pairs):
            raise AssertionError(
                f"main-path launch differs from the plain version, max |err| {worst}")
    log(f"  shard 0 round 1 (K={k}, N={n0}): fused_agg_opt == plain version "
        f"bitwise")
    return worst


def replay_wire(dev, run: dict) -> float:
    """Shard 0's first apply_wire through wire_fused_torch (in slices of
    whole chunks) and through the unfused kernel pipeline (the dequantize
    kernel per stream, then fused_agg_opt), both bitwise."""
    import torch

    from repro_torch.kernels.fused_agg_opt.ops import scalar_packet
    from repro_torch.kernels.wire_path import kernel as W
    from repro_torch.kernels.wire_path.ops import unfused_wire_update

    (pay, scales, codec, step), p, st = run["captured"]["in"]
    got_p, got_s = run["captured"]["out"]
    n0, chunk, spec = run["n"], run["chunk"], run["spec"]
    k = pay.shape[0]
    pay, scales = pay.reshape(k, n0), scales.reshape(k, n0 // chunk)
    p, st = p.reshape(n0), tuple(s.reshape(n0) for s in st)
    got_p, got_s = got_p.reshape(n0), tuple(s.reshape(n0) for s in got_s)
    packet = scalar_packet(spec, step, device=dev)
    worst, piece = 0.0, (1 << 25) // chunk * chunk
    for a in range(0, n0, piece):
        sl = slice(a, min(a + piece, n0))
        csl = slice(sl.start // chunk, sl.stop // chunk)
        want_p, want_s = W.wire_fused_torch(
            pay[:, sl].to(dev), scales[:, csl].to(dev), p[sl].to(dev),
            tuple(s[sl].to(dev) for s in st), packet, spec, codec=codec,
            chunk_elems=chunk)
        pairs = [(got_p[sl], want_p.cpu()),
                 *[(g[sl], w.cpu()) for g, w in zip(got_s, want_s)]]
        worst = max([worst] + [max_abs_err(x, y) for x, y in pairs])
        if not all(same_bits(x, y) for x, y in pairs):
            raise AssertionError(
                f"main-path wire_fused differs from wire_fused_torch, max "
                f"|err| {worst}")
    un_p, un_s = unfused_wire_update(
        pay.to(dev), scales.to(dev), p.to(dev), tuple(s.to(dev) for s in st),
        spec, step, codec=codec, chunk_elems=chunk)
    torch.cuda.synchronize()
    pairs = [(got_p, un_p.cpu()), *zip(got_s, (s.cpu() for s in un_s))]
    worst = max([worst] + [max_abs_err(x, y) for x, y in pairs])
    if not all(same_bits(x, y) for x, y in pairs):
        raise AssertionError(
            f"main-path wire_fused differs from the unfused kernel pipeline, "
            f"max |err| {worst}")
    del un_p, un_s
    torch.cuda.empty_cache()
    log(f"  shard 0 round 1 (K={k}, N={n0}, {codec}): wire_fused == "
        f"wire_fused_torch == dequantize + fused_agg_opt kernels bitwise")
    return worst


def replay_codec(run: dict) -> dict:
    """Worker 0's round-2 quantize and dequantize on the int8 main path
    (the error-feedback-corrected gradients and their residual) through
    their plain versions, in slices of whole chunks (each chunk is
    coded on its own, so a slice's plain result is the same bits as the
    whole's), bitwise.  The captures are device copies."""
    from repro_torch.kernels.quant import kernel as Q

    (x, chunk), (got_q, got_s) = run["captured"]["quantize_chunks"]
    (dq, ds, dchunk), (got_d,) = run["captured"]["dequantize_chunks"]
    if not (dchunk == chunk and same_bits(dq, got_q) and same_bits(ds, got_s)):
        raise AssertionError("the captured dequantize did not decode the "
                             "captured quantize's payload (encode_wire's "
                             "residual)")
    n = x.shape[0]
    worst = {"quantize_chunks": 0.0, "dequantize_chunks": 0.0}
    piece = (1 << 25) // chunk * chunk
    for a in range(0, n, piece):
        sl = slice(a, min(a + piece, n))
        csl = slice(sl.start // chunk, sl.stop // chunk)
        want_q, want_s = Q.quantize_chunks_torch(x[sl], chunk)
        want_d = Q.dequantize_chunks_torch(dq[sl], ds[csl], chunk)
        worst["quantize_chunks"] = max(worst["quantize_chunks"],
                                       max_abs_err(got_q[sl], want_q),
                                       max_abs_err(got_s[csl], want_s))
        worst["dequantize_chunks"] = max(worst["dequantize_chunks"],
                                         max_abs_err(got_d[sl], want_d))
        if not (same_bits(got_q[sl], want_q) and same_bits(got_s[csl], want_s)):
            raise AssertionError(
                f"main-path quantize differs from its plain version, max "
                f"|err| {worst['quantize_chunks']}")
        if not same_bits(got_d[sl], want_d):
            raise AssertionError(
                f"main-path dequantize differs from its plain version, max "
                f"|err| {worst['dequantize_chunks']}")
    log(f"  worker 0 round 2 encode (N={n}, chunk {chunk}): quantize and "
        f"dequantize == their plain versions bitwise")
    return worst


def profile_summary(prof, steady_round_ms: float, last_launches,
                    kernel_name: str) -> dict:
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
        f"{1 - busy_us / 1e3 / steady_round_ms:.1%}; {kernel_name} "
        f"{kernel_us / 1e3:.1f} ms = {kernel_us / busy_us:.1%} of device time")
    kernels = [e for e in prof.key_averages() if on_device(e)]
    for e in sorted(kernels, key=lambda e: e.self_device_time_total,
                    reverse=True)[:20]:
        log(f"    device {e.self_device_time_total / 1e3:9.2f} ms  "
            f"x{e.count:<5d} {e.key[:100]}")
    return {"device_busy_ms": busy_us / 1e3}


# -- phase 6 -----------------------------------------------------------------
def time_fused_agg_opt(dev, n: int, k: int) -> dict:
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
    b = bound(torch.cuda.get_device_name(dev),
              (k * 4 + 2 * 4 + 2 * 2 * 4) * n,  # grads in; param, m, v in+out
              adamw_ops(k) * n)
    log(f"timing fused_agg_opt (AdamW, K={k}, N={n}, f32): kernel "
        f"{kernel_ms:.4f} ms (median of 20), plain version {plain_ms:.4f} ms "
        f"(median of 5); bound {b['bound_ms']:.4f} ms = {b['bytes']} bytes "
        f"(operations: {b['op_ms']:.4f} ms); kernel reaches "
        f"{b['bound_ms'] / kernel_ms:.1%} of the bound; library: none")
    return {"ms": kernel_ms, "plain_ms": plain_ms, "max_abs_err": err,
            "library_ms": None, **b}


def time_quant(dev, flat: int, chunk: int) -> dict:
    """Both quant kernels at the main path's shape (the whole flat space,
    one worker's push), beside their plain versions and, for dequantize,
    torch's per-channel quantized dequantize()."""
    import torch

    from repro_torch.kernels.quant import kernel as Q

    name = torch.cuda.get_device_name(dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn(flat, generator=gen, device=dev) * 1e-3
    c = flat // chunk
    q, s = Q.quantize_chunks_cuda(x, chunk)
    want_q, want_s = Q.quantize_chunks_torch(x, chunk)
    torch.cuda.synchronize()
    q_err = max(max_abs_err(q, want_q), max_abs_err(s, want_s))
    if not (same_bits(q, want_q) and same_bits(s, want_s)):
        raise AssertionError(f"quantize differs at the main shape, max |err| {q_err}")
    del want_q, want_s
    quant_ms = cuda_ms(lambda: Q.quantize_chunks_cuda(x, chunk), reps=20)
    quant_plain = cuda_ms(lambda: Q.quantize_chunks_torch(x, chunk), reps=3)
    del x
    d = Q.dequantize_chunks_cuda(q, s, chunk)
    want_d = Q.dequantize_chunks_torch(q, s, chunk)
    torch.cuda.synchronize()
    d_err = max_abs_err(d, want_d)
    if not same_bits(d, want_d):
        raise AssertionError(f"dequantize differs at the main shape, max |err| {d_err}")
    del d
    deq_ms = cuda_ms(lambda: Q.dequantize_chunks_cuda(q, s, chunk), reps=20)
    deq_plain = cuda_ms(lambda: Q.dequantize_chunks_torch(q, s, chunk), reps=3)
    # torch's own per-channel dequantize of the same bits (channel = chunk),
    # the yardstick only: the port never calls it
    try:
        qt = torch._make_per_channel_quantized_tensor(
            q.view(c, chunk), s.double(),
            torch.zeros(c, dtype=torch.long, device=dev), 0)
        lib = qt.dequantize().reshape(flat)
        torch.cuda.synchronize()
        lib_same = same_bits(lib, want_d)
        lib_err = max_abs_err(lib, want_d)
        del lib
        lib_ms = cuda_ms(lambda: qt.dequantize(), reps=20)
        del qt
    except (RuntimeError, NotImplementedError) as exc:
        log(f"  torch per-channel dequantize() not timed: {exc}"[:300])
        lib_ms, lib_same, lib_err = None, None, None
    del want_d
    nbytes = 5 * flat + 4 * c
    bq = bound(name, nbytes, 5 * flat)  # |x|, max, divide, round, clamp
    bd = bound(name, nbytes, flat)  # one multiply
    log(f"timing quantize_chunks (N={flat}, chunk {chunk}): kernel "
        f"{quant_ms:.4f} ms (median of 20), plain version {quant_plain:.4f} "
        f"ms (median of 3); bound {bq['bound_ms']:.4f} ms = {nbytes} bytes; "
        f"kernel reaches {bq['bound_ms'] / quant_ms:.1%} of the bound; "
        f"library: none (no one call finds the chunk scales and encodes)")
    log(f"timing dequantize_chunks (N={flat}, chunk {chunk}): kernel "
        f"{deq_ms:.4f} ms (median of 20), plain version {deq_plain:.4f} ms "
        f"(median of 3); bound {bd['bound_ms']:.4f} ms; kernel reaches "
        f"{bd['bound_ms'] / deq_ms:.1%} of the bound; torch per-channel "
        f"dequantize() {lib_ms} ms (median of 20), same bits: {lib_same}"
        f" (max |err| {lib_err})")
    return {
        "quantize_chunks": {"ms": quant_ms, "plain_ms": quant_plain,
                            "max_abs_err": q_err, "library_ms": None, **bq},
        "dequantize_chunks": {"ms": deq_ms, "plain_ms": deq_plain,
                              "max_abs_err": d_err, "library_ms": lib_ms,
                              "library_same_bits": lib_same, **bd},
    }


def time_wire(dev, n: int, k: int, chunk: int) -> dict:
    """wire_fused at the main path's shard shape (AdamW, K int8 streams),
    beside its plain version and the unfused kernel pipeline it replaces."""
    import torch

    from repro_torch.kernels.fused_agg_opt.ops import scalar_packet
    from repro_torch.kernels.quant import kernel as Q
    from repro_torch.kernels.wire_path import kernel as W
    from repro_torch.kernels.wire_path.ops import unfused_wire_update
    from repro_torch.optim.optimizers import adamw

    spec = adamw(3e-3)
    c = n // chunk
    gen = torch.Generator(device=dev).manual_seed(3)
    pairs = [Q.quantize_chunks_cuda(
        torch.randn(n, generator=gen, device=dev) * 1e-3, chunk)
        for _ in range(k)]
    pay = torch.stack([q for q, _ in pairs])
    sc = torch.stack([s for _, s in pairs])
    del pairs
    p = torch.randn(n, generator=gen, device=dev)
    m = torch.randn(n, generator=gen, device=dev) * 1e-3
    v = (torch.randn(n, generator=gen, device=dev) * 1e-3).abs()
    packet = scalar_packet(spec, 1, device=dev)
    want_p, want_s = W.wire_fused_torch(pay, sc, p, (m, v), packet, spec,
                                        codec="int8", chunk_elems=chunk)
    W.wire_fused_cuda(pay, sc, p, (m, v), packet, spec, codec="int8",
                      chunk_elems=chunk)  # in place
    torch.cuda.synchronize()
    err = max(max_abs_err(p, want_p), *[max_abs_err(a, b) for a, b in
                                        zip((m, v), want_s)])
    if not (same_bits(p, want_p) and same_bits(m, want_s[0])
            and same_bits(v, want_s[1])):
        raise AssertionError(f"wire_fused differs at the main shape, max |err| {err}")
    del want_p, want_s
    kernel_ms = cuda_ms(lambda: W.wire_fused_cuda(
        pay, sc, p, (m, v), packet, spec, codec="int8", chunk_elems=chunk),
        reps=20)
    plain_ms = cuda_ms(lambda: W.wire_fused_torch(
        pay, sc, p, (m, v), packet, spec, codec="int8", chunk_elems=chunk),
        reps=3)
    unfused_ms = cuda_ms(lambda: unfused_wire_update(
        pay, sc, p, (m, v), spec, 1, codec="int8", chunk_elems=chunk), reps=10)
    b = bound(torch.cuda.get_device_name(dev),
              (k * 1 + 2 * 4 + 2 * 2 * 4) * n + 4 * k * c,
              (k + adamw_ops(k)) * n)
    log(f"timing wire_fused (AdamW, K={k} int8 streams, N={n}, chunk "
        f"{chunk}): kernel {kernel_ms:.4f} ms (median of 20), plain version "
        f"{plain_ms:.4f} ms (median of 3), unfused kernel pipeline "
        f"(dequantize x{k} + fused_agg_opt) {unfused_ms:.4f} ms (median of "
        f"10); bound {b['bound_ms']:.4f} ms = {b['bytes']} bytes (operations: "
        f"{b['op_ms']:.4f} ms); kernel reaches "
        f"{b['bound_ms'] / kernel_ms:.1%} of the bound; library: none")
    return {"ms": kernel_ms, "plain_ms": plain_ms, "unfused_ms": unfused_ms,
            "max_abs_err": err, "library_ms": None, **b}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build

    t_start = time.perf_counter()
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

    sweep = {"fused_agg_opt": kernel_sweep(dev), **quant_sweep(dev),
             "wire_fused": wire_sweep(dev)}
    f32 = main_path(dev, "none")
    f32_err = replay_f32(dev, f32)
    f32.pop("captured")
    int8 = main_path(dev, "int8")
    int8_err = replay_wire(dev, int8)
    codec_err = replay_codec(int8)
    int8.pop("captured")
    timing = {"fused_agg_opt": time_fused_agg_opt(dev, f32["n"], WORKERS),
              **time_quant(dev, int8["flat"], int8["chunk"]),
              "wire_fused": time_wire(dev, int8["n"], WORKERS, int8["chunk"])}
    replayed = {"fused_agg_opt": f32_err, "wire_fused": int8_err, **codec_err}
    rows = [
        ("fused_agg_opt", "fused_agg_opt.cu", "fused_agg_opt/kernel.py:162",
         f32, {"k": WORKERS, "n": f32["n"], "optimizer": "adamw",
               "dtype": "f32"}),
        ("quantize_chunks", "quant.cu", "quant/kernel.py:31", int8,
         {"n": int8["flat"], "chunk": int8["chunk"], "dtype": "f32->int8"}),
        ("dequantize_chunks", "quant.cu", "quant/kernel.py:62", int8,
         {"n": int8["flat"], "chunk": int8["chunk"], "dtype": "int8->f32"}),
        ("wire_fused", "wire_path.cu", "wire_path/kernel.py:149", int8,
         {"k": WORKERS, "n": int8["n"], "chunk": int8["chunk"],
          "optimizer": "adamw", "dtype": "int8"}),
    ]
    kernels = []
    for kname, src, tpu, run, shape in rows:
        t = timing[kname]
        kernels.append({
            "name": kname,
            "route": "cuda",
            "source": f"src/repro_torch/csrc/{src}",
            "replaces": f"src/repro/kernels/{tpu}",
            "held_against": f"{kname}_torch" if kname != "wire_fused"
                            else "wire_fused_torch and dequantize+fused_agg_opt",
            "match": "bitwise",
            "launches": run["launches"][kname],
            "max_abs_err": max(sweep[kname], replayed.get(kname, 0.0),
                               t["max_abs_err"]),
            "ms": t["ms"],
            "main_path_ms": run["main_path_ms"] if run["kernel"] == kname
                            else None,
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "shape": shape,
        })
    log(f"main path peaks: f32 {f32['peak_bytes'] / 2**30:.2f} GiB, int8 "
        f"{int8['peak_bytes'] / 2**30:.2f} GiB; whole run "
        f"{time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
