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
   (grad, param) dtype pairs x N in {8192, 3*8192+77} x average on and off
   (off: the async path), step 5, lr_scale 0.7;
   ``quantize_chunks``/``dequantize_chunks`` over N in {8192,
   37*8192} x chunk in {128, 8192}, and N = 5*65536 at chunk 65536, with
   zero, NaN and inf chunks, each slab also one element off alignment;
   ``wire_fused`` over none/bf16/int8 x five optimizers x K in {1, 2, 3,
   8} x average on and off, against its plain version and against the
   unfused kernel pipeline (dequantize, then ``fused_agg_opt``);
   ``embedding_bag`` over B in {1,
   7, 4096} x L in {1, 3, 33} x D in {16, 128, 130} x {sum, mean} with
   zero-weight padding, all-padding bags, NaN and inf rows, int32 and int64
   indices, and ``segment_sum`` with duplicate-heavy, strided and special
   rows;
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
6. the DLRM sparse main path at full width: dlrm-mlperf (26 Criteo tables
   capped at 10M rows a table, 52,487,036 rows x 128 f32, each padded to a
   multiple of 4 rows; the published MLPs) trained for 3 rounds by 2 workers x 32,768 samples, the dense MLPs
   through a 4-shard PBoxFabric and the tables through a fabric-attached
   SparseTier (hash placement, codec none, SGD 0.1 on both).  The counts
   are set to 0 just before and read just after: 156 embedding_bag, 156
   segment_sum, 12 fused_agg_opt and no codec launches.  Worker 0's
   round-2 lookup of t0 and its coalescing of t0 and t5 (3 rows) are
   replayed through the plain versions, bitwise;
7. sharding independence on the card: the DLRM SMOKE loop at batch 4,096
   with heavily repeated ids, codecs none and int8 (error feedback on), 1
   shard against 4: tables, row versions and dense params bitwise equal;
8. the backup quorum at full width (gemma3-1b, AdamW, 4 shards; phases
   8-10 run with torch's deterministic algorithms, since they compare
   recomputed gradients): 3 workers, ``min_push_fraction`` 0.5, 3 rounds
   in which all pull, workers 0 and 1 push (K = 2) and worker 2's
   superseded push is dropped.  Counts set to 0 just before and read just
   after: 12 fused_agg_opt launches, 3 steps, 3 partial aggregations, 3
   late pushes dropped; the params bitwise equal to a 2-worker sync
   fabric fed workers 0 and 1's batches;
9. async at full width on the int8 wire (error feedback, fused wire
   path): 2 workers at speeds [1, 2], 9 pushes, each applied at once.
   Counts: 9 quantize, 9 dequantize, 36 wire_fused (K = 1, no averaging),
   no fused_agg_opt; shard 0's first apply_wire replayed through
   ``wire_fused_torch`` and the unfused kernel pipeline, bitwise;
10. snapshot, rebalance and restore at full width (f32 wire, 2 workers):
   run A takes a mid-round snapshot in round 3 (15.6 GB to host), drains
   shard 3 through a ShardRebalancer and trains to round 5; run B restores
   the snapshot onto a fresh 2-shard fabric and replays rounds 3-5.  A
   and B end bitwise equal, the snapshot is unchanged by A (SHA-1), and a
   second restore gives its bits back;
11. every mode (quorum, SSP with staleness 1, async) x codec (none, int8)
   at the SMOKE config, the fabric on the card against the fabric on the
   CPU, bitwise, each with a mid-round ``Checkpointer.save_fabric`` /
   ``restore_fabric`` round trip;
12. the f32 rack chain at full width (gemma3-1b, AdamW, 4 shards; phases
   12 and 13 under deterministic algorithms too): 4 workers over a
   ``NetworkTopology`` of 2 racks with a 1:4 core, codec none, 3 rounds.
   Counts: 12 fused_agg_opt, no codec launches; 6 rack streams; the core
   link carries 2 f32 streams a round.  The params bitwise equal to a
   4-worker flat fabric fed the same batches, whose core carries 4;
13. the switch pools at full width on the int8 wire (error feedback, fused
   wire path): 2 workers, one a rack, with ToR and core pools of one slot
   per chunk (158,912): every round offloaded to both pools; counts 12
   wire_fused, no quantize / dequantize.  Then pools one slot short
   (starved, never engaged): counts 12 quantize, 12 dequantize, 12
   wire_fused, and params bitwise equal to the same topology fabric with
   no switch tier;
14. every codec (none, bf16, int8) x mode (sync, quorum, SSP, async) x
   switch (off, on, starved, a ToR pool or the core pool failed at round
   2 and restored at round 3 by a ``FaultPlan``) at the SMOKE config over
   2 racks, the fabric on the card against the fabric on the CPU, bitwise
   in params, state, residuals, every stats field and ``fault_trace``;
15. failover and reshard at full width (gemma3-1b, AdamW, 4 shards, under
   deterministic algorithms): 2 workers, one in each of 2 racks (1:4
   core), codec none, 4 rounds.  Run A, replication 1, fault-free: 16
   fused_agg_opt launches and no chain.  Run B, replication 2 (the chain
   a device copy of p, m and v, 15,621,685,248 bytes, every hop across
   the core): rack 1's link degraded 3x after round 1, shard 1 crashed
   after round 2 (promote, re-silver), the link restored after round 3,
   then ``reshard(2)``; 12 + 2 fused_agg_opt launches.  B's params and
   both AdamW slots equal A's bitwise, its losses A's, its exported fault
   trace the CPU rehearsal's (the same schedule at the SMOKE config), and
   its replication, re-silver and core-link bytes the arithmetic; each
   chain pass, the failover and the reshard are timed with the peaks;
16. the fault tier at the SMOKE config, card == CPU bitwise (params,
   state, residuals, every stats field, the fault traces): codec (none,
   bf16, int8) x replication (1, raising ShardLost; 2; 3, the same shard
   crashing twice in consecutive rounds) x racks (1, 2) x a crash after
   round 1 or 2; a worker crash and re-entry through
   ``elastic.worker_reentry``; a SparseTier on a replicated fabric with a
   shard crash, its lookups included.  Each failover also equals the
   card's fault-free run;
17. the tenancy tier at full width (under deterministic algorithms): two
   gemma3-1b tenants on one ``MultiJobFabric`` (4 shards, 2 racks, 1:4
   core), each 2 workers (one a rack), AdamW, codec none, R = 1: ``a``
   (init seed 0, priority 2) and ``b`` (init seed 1, priority 1, its own
   batch seeds), their workers interleaved tick by tick.  Rounds 1-2 with
   both attached, ``detach("b")`` (a 15.6 GB host snapshot), ``a``'s round
   3 alone, ``b`` re-attached from its snapshot (namespace [2c, 3c), c =
   158,912 chunks) for its round 3.  Counts: 24 box fused_agg_opt, no codec
   launch.  Each tenant's params, m and v equal its ``dedicated_fabric``
   twin's (12 launches, the same batches) bitwise, compared on the card
   while only that tenant's final slabs are kept; losses and pushed /
   pulled bytes equal; a round adds 1.5x ``a``'s dedicated
   ``sim_wire_us`` and 3.0x ``b``'s, 1.0x for ``a`` alone (to 1e-12
   relative), and ``a``'s simulated step time stays under ``b``'s;
   ``utilization()`` holds both tenants on every link with contention > 1,
   ``shard_occupancy()`` both on every shard (39,728 chunks each), and
   ``route()`` sends global ids of each namespace to the owning shard.
   Each round (shared and dedicated), the detach and the re-attach are
   timed, with the peaks;
18. the tenancy tier at the SMOKE config, card == CPU bitwise in every
   tenant's params, state and residuals, every stats field, the fault
   traces and the box's utilization, shard occupancy, routes and
   describe: 1, 2 and 3 tenants x shards (1, 4) x racks (1, 2) x codec
   (none, bf16, int8); a sync / quorum / SSP mix; switch-slot grants (one
   granted, one refused, the grant returned at detach and handed on); a
   box-wide ``crash_shard`` (R = 1 raising ``ShardLost`` after the R = 2
   tenant's failover); an elastic re-attach onto 3 shards; tenant shares
   in mid-run.  Each tenant also equals its dedicated twin on the card,
   and each case's launches equal the CPU run's plain-version calls;
19. every kernel and its plain version timed at its main path's shape with
   CUDA events, beside its byte bound and, where one PyTorch call computes
   the same function, that call's time (embedding_bag also at one
   multi-hot shape, B = 32,768 x L = 20; fused_agg_opt and wire_fused also
   at K = 1 without averaging, as the async path runs them); and the
   switch pool's plain-torch integer math (shared scale, int8 encode,
   residual, int32 slot sum, dequantize) at full width;
20. the serving path at full width (run after phase 18): gemma3-1b served
   through ``launch/serve.py``'s body, ``serve(arch.config, args)``, with
   the CLI's arguments (``--source fabric --train-rounds 1``, 4 shards, 2
   racks at 1:4, R = 2, 2 workers, batch 4, a 1024-token prompt, 32
   tokens, ``--max-staleness 1``).  Counts set to 0 just before the call
   and read just after: 4 fused_agg_opt, no codec launch.  The read (from
   the chain tails) equals ``fabric.params`` bitwise at version 1; after a
   round of card-drawn gradients the cached read still holds version 1's
   bits (SHA-1 and a kept copy) and a ``max_staleness=0`` read version
   2's.  The scan decode's logits against a forward of the 1,055-token
   sequence and the unrolled decode's (rolling 512-slot caches) against
   the scan decode's, within 5 % of the largest logit; ``assemble``, a
   miss, a hit, the prefill and a decode step timed, with the peak.  Then
   ``--source checkpoint`` (saved at round 0, restored, served back
   bitwise);
21. sparse serving at full width: dlrm-mlperf (as phase 6) under a 2-rack
   ``NetworkTopology``, R = 1: one training round (52 embedding_bag, 52
   segment_sum, 4 fused_agg_opt), then a ``SparseReadPlane`` of 2
   frontends serving a Zipf(1.05) trace of 12 x 4,096 rows over the two
   largest tables, a second round between reads; every served row equals
   ``tier.table(name)[ids]`` bitwise; hit rate, rack and core bytes and
   ms per ``read_rows`` batch reported;
22. the serving path at the SMOKE config, card == CPU bitwise in every
   read, stats field, clock float, served request and ``describe``:
   ReadPlane and HierarchicalReadPlane over 1 and 2 racks x R = 1, 2, 3
   with a shard crash between reads; a FrontDoor over ``generate_trace``
   traces (open, closed loop, diurnal, flash crowd, a mixed trace through
   a hierarchical plane); serve tenants on a MultiJobFabric over codecs
   none, bf16, int8; a SparseReadPlane at R = 2 over 2 racks with a shard
   failover and a fabric ``restore`` between reads; each case's launches
   equal to the CPU run's plain-version calls.  Then prefill and the scan
   and unrolled decodes in f32, card against CPU: ids equal, logits
   within 1e-4 of the largest.

23. the closed loop at full width (under deterministic algorithms, after
   phase 15): gemma3-1b, 2 workers (one a rack, 1:4 core), AdamW, codec
   none, R = 2, a ReadPlane of 2 frontends, an Autoscaler (``min_shards``
   4, ``max_shards`` 8, ``scale_up_busy_us`` 0.0, cooldown 10 rounds,
   ``solve_placement``).  Round 1; ``auto.step()`` doubles the shards to 8
   through ``reshard`` and ``resolve_placement`` applies the solver's
   deltas; rounds 2-3; ``auto.apply_plan`` of a 4-shard plan from
   ``PlacementProblem.standard(...).solve(seed=0)`` (one ``shard_count``
   delta: ``reshard(4, plan=...)``); round 4.  Counts set to 0 just before
   and read just after: 24 fused_agg_opt, no codec launch;
   ``rescales == 2``; the live plan equals the host re-solve after
   ``step()`` (chain and frontend racks) and the applied plan's chain
   racks after ``apply_plan``, the events equal ``diff_plans``; params
   and both AdamW slots hash (SHA-1) to phase 15's fixed-layout R = 1 run
   A and the losses equal its; a read after round 4 equals
   ``fab.params``, a read taken before the second reshard keeps its bits.
   Rounds, ``step`` / ``apply_plan`` with the solve split out, reshards,
   allocator retries and the peak are reported;
24. the closed loop at the SMOKE config, card == CPU bitwise in params,
   slots, residuals, every stats field, fault traces, ``auto.events``,
   ``describe()``, ``telemetry()``, reads and sparse tables: codec none /
   int8 x racks 1 / 2 / 4 x shards 1 -> 2, 2 -> 8, 8 -> 2; scale-up and
   scale-down from busy telemetry; straggler proposals on the delta path;
   ``resolve_placement``; two sparse autoscaled runs whose 8-shard plan
   carries a solved row map from a Zipf row load; a sparse reshard and
   failover; ``tenant_shares`` through ``shared=`` on a MultiJobFabric;
   each autoscaled run equal to its fixed-layout twin on the card, each
   case's launches equal to the CPU run's plain-version calls.

The line before the last is the kernel table as JSON (each row with its
launches on every path); the last line is ``{"ok": true, "device":
{...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import itertools
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
# the DLRM sparse path: the MLPerf global batch split over the workers, and
# the Criteo tables capped at 10M rows so tables and dense view fit the card
DLRM_BATCH, DLRM_ROW_CAP, DLRM_LR = 32768, 10_000_000, 0.1


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


def _on_device(e) -> bool:
    from torch.autograd import DeviceType

    return e.device_type == DeviceType.CUDA and not e.is_user_annotation


def graph_ms(calls: list, replays: int = 5) -> float:
    """Device ms of one call: ``calls`` captured back to back in one CUDA
    graph, the graph replayed ``replays`` times between CUDA events, the
    median replay divided by the number of calls.  Around a launch of tens
    of microseconds, events around each call mostly measure the host's
    launch overhead (the card idles while Python prepares it); a replay
    launches the same kernels with none."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capture, as torch asks
        for fn in calls:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in calls:
            fn()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / len(calls))
    del graph
    return statistics.median(times)


def kernel_device_ms(prof, key: str) -> tuple:
    """(total device ms, launches) of the kernels whose name holds ``key``
    in a profiled window."""
    hits = [e for e in prof.key_averages() if _on_device(e) and key in e.key]
    return (sum(e.self_device_time_total for e in hits) / 1e3,
            sum(e.count for e in hits))


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
    # average off: the async path's K = 1 pushes
    for average, spec, k, (gdt, pdt), n in itertools.product(
            (True, False), _specs(), (1, 2, 3, 8), dtypes,
            (8192, 3 * 8192 + 77)):
        rng = np.random.default_rng(cases)
        g = torch.from_numpy(rng.standard_normal((k, n), np.float32))
        p = torch.from_numpy(rng.standard_normal(n, np.float32))
        st = _state(rng, spec, n, dev)
        g, p = g.to(dev, gdt), p.to(dev, pdt)
        packet = scalar_packet(spec, 5, 0.7, device=dev)
        want_p, want_s = K.fused_agg_opt_torch(g, p, st, packet, spec,
                                               average=average)
        got_p, got_s = K.fused_agg_opt_cuda(
            g, p.clone(), tuple(s.clone() for s in st), packet, spec,
            average=average)
        torch.cuda.synchronize()
        pairs = [(got_p, want_p), *zip(got_s, want_s)]
        worst = max([worst] + [max_abs_err(a, b) for a, b in pairs])
        if not all(torch.equal(a, b) for a, b in pairs):
            raise AssertionError(
                f"fused_agg_opt differs from its plain version: {spec.name} "
                f"nesterov={spec.nesterov} k={k} n={n} {gdt}/{pdt} "
                f"average={average}, max |err| {worst}")
        cases += 1
    log(f"kernel sweep: fused_agg_opt == fused_agg_opt_torch bitwise in "
        f"{cases} cases (average on and off)")
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
    # average off: the async path's K = 1 pushes
    for average, codec, spec, k in itertools.product(
            (True, False), ("none", "bf16", "int8"), _specs(), (1, 2, 3, 8)):
        for offset in ((0, 1) if k == 2 else (0,)):
            rng = np.random.default_rng(2000 + cases)
            pay, sc = _wire_streams(rng, codec, k, n, chunk, dev)
            p = torch.from_numpy(rng.standard_normal(n, np.float32)).to(dev)
            st = _state(rng, spec, n, dev)
            packet = scalar_packet(spec, 4, 0.7, device=dev)
            want_p, want_s = W.wire_fused_torch(
                pay, sc, p, st, packet, spec, codec=codec, chunk_elems=chunk,
                average=average)
            got_p, got_s = W.wire_fused_cuda(
                pay, sc, _shifted(p, offset),
                tuple(_shifted(x, offset) for x in st), packet, spec,
                codec=codec, chunk_elems=chunk, average=average)
            un_p, un_s = unfused_wire_update(
                pay, sc, p.clone(), tuple(s.clone() for s in st), spec, 4, 0.7,
                codec=codec, chunk_elems=chunk, average=average)
            torch.cuda.synchronize()
            pairs = [(got_p, want_p), *zip(got_s, want_s),
                     (got_p, un_p), *zip(got_s, un_s)]
            worst = max([worst] + [max_abs_err(a, b) for a, b in pairs])
            if not all(torch.equal(a, b) for a, b in pairs):
                raise AssertionError(
                    f"wire_fused differs from its plain version or the "
                    f"unfused kernel pipeline: {codec} {spec.name} "
                    f"nesterov={spec.nesterov} k={k} offset={offset} "
                    f"average={average}, max |err| {worst}")
            cases += 1
    log(f"kernel sweep: wire_fused == wire_fused_torch == dequantize + "
        f"fused_agg_opt kernels bitwise in {cases} cases (average on and off)")
    return worst


def _bag_case(rng, b: int, length: int, d: int, dev, idx_dtype):
    """A (1000, d) table with NaN and +-inf rows, and (b, length) bags
    whose upper slots are zero-weight padding (index 0) and whose bag 0 is
    all padding."""
    import numpy as np
    import torch

    v = 1000
    table = (rng.standard_normal((v, d)) * rng.uniform(0.01, 100)).astype(np.float32)
    table[7, 0], table[11, d - 1], table[13, d // 2] = np.nan, np.inf, -np.inf
    idx = rng.integers(0, v, (b, length))
    w = rng.standard_normal((b, length)).astype(np.float32)
    if length > 1:
        w[:, length // 2 + 1:], idx[:, length // 2 + 1:] = 0.0, 0
    if b > 1:
        w[0], idx[0] = 0.0, 0
    idx[:, 0] = np.where(np.arange(b) % 5 == 1, 7 + 2 * (np.arange(b) % 3),
                         idx[:, 0])  # some live slots read the special rows
    return (torch.from_numpy(table).to(dev),
            torch.from_numpy(idx).to(dev, idx_dtype),
            torch.from_numpy(w).to(dev))


def bag_sweep(dev) -> dict:
    """embedding_bag and segment_sum against their plain versions on the
    card, bitwise.  Odd cases read the table one element off 16-byte
    alignment, which takes the kernel's one-float path."""
    import numpy as np
    import torch

    from repro_torch.kernels.embedding_bag import kernel as E

    worst = {"embedding_bag": 0.0, "segment_sum": 0.0}
    cases = 0
    for b in (1, 7, 4096):
        for length in (1, 3, 33):
            for d in (16, 128, 130):
                for mode in ("sum", "mean"):
                    rng = np.random.default_rng(3000 + cases)
                    idx_dtype = (torch.int32, torch.int64)[cases % 2]
                    table, idx, w = _bag_case(rng, b, length, d, dev, idx_dtype)
                    want = E.embedding_bag_torch(table, idx, w, mode)
                    src = _shifted(table.reshape(-1), cases % 2).view(table.shape)
                    got = E.embedding_bag_cuda(src, idx, w, mode)
                    torch.cuda.synchronize()
                    worst["embedding_bag"] = max(worst["embedding_bag"],
                                                 max_abs_err(got, want))
                    if not same_bits(got, want):
                        raise AssertionError(
                            f"embedding_bag differs from its plain version: "
                            f"B={b} L={length} D={d} {mode} {idx_dtype}, max "
                            f"|err| {worst['embedding_bag']}")
                    cases += 1
    seg_cases = 0
    for n in (1, 37, 4096):
        for pattern in ("unique", "three", "zipf"):
            for d in (16, 128, 130):
                rng = np.random.default_rng(4000 + seg_cases)
                ids = {"unique": rng.permutation(n), "three": rng.integers(0, 3, n),
                       "zipf": rng.zipf(1.2, n) % 97}[pattern]
                uniq, inv = np.unique(ids, return_inverse=True)
                block = (rng.standard_normal((n, 3, d)) * 10).astype(np.float32)
                block[0, 1, :2] = -0.0
                if n > 5:
                    block[3, 1, 1], block[5, 1, 0] = np.nan, np.inf
                rows = torch.from_numpy(block).to(dev)[:, 1]  # strided rows
                order = torch.from_numpy(np.argsort(inv, kind="stable")).to(dev)
                seg = torch.from_numpy(np.concatenate(
                    [[0], np.cumsum(np.bincount(inv))]).astype(np.int64)).to(dev)
                want = E.segment_sum_torch(rows, order, seg)
                got = E.segment_sum_cuda(rows, order, seg)
                torch.cuda.synchronize()
                worst["segment_sum"] = max(worst["segment_sum"],
                                           max_abs_err(got, want))
                if not same_bits(got, want) or got.shape[0] != uniq.size:
                    raise AssertionError(
                        f"segment_sum differs from its plain version: n={n} "
                        f"{pattern} D={d}, max |err| {worst['segment_sum']}")
                seg_cases += 1
    log(f"kernel sweep: embedding_bag == embedding_bag_torch bitwise in "
        f"{cases} cases (padding, all-padding bags, NaN and inf rows, int32 "
        f"and int64 indices); segment_sum == segment_sum_torch bitwise in "
        f"{seg_cases} cases (duplicates, strided, -0, NaN and inf rows)")
    return worst


# -- phases 4 and 5 ----------------------------------------------------------
class LaunchTimer:
    """CUDA events around every call of a kernel wrapper on the main path
    (a module attribute, swapped in and restored)."""

    def __init__(self, module, attr: str):
        self.module, self.attr = module, attr
        self.events: list = []

    def __enter__(self):
        import torch

        # wrap what is there now, so wrappers of one attribute nest
        self.launch = getattr(self.module, self.attr)

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
        self.calls = 0
        self.args = self.out = None

    def __enter__(self):
        import torch

        self.launch = getattr(self.module, self.attr)

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
    bytes its captures hold (kept apart with a peak reset at each one)
    and without ``held`` bytes that an earlier run left allocated for a
    comparison."""

    def __init__(self, dev, held: int = 0):
        import torch

        self.dev, self.held, self.peak = dev, held, 0
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


def capture_first_apply(shard, name: str, captured: dict) -> None:
    """Wrap ``shard.<name>`` (``apply`` or ``apply_wire``) so that its
    step-1 call's tensor arguments, ``average`` and the shard's params and
    state before it (``captured["in"]``) and after it
    (``captured["out"]``) land in host memory, for a replay through the
    plain version.  ``delattr(shard, name)`` unwraps it."""
    import torch

    launch = getattr(shard, name)

    def capture(*args, **kwargs):
        first = args[-1] == 1  # the step
        if first:
            captured["in"] = (tuple(_host(a) if torch.is_tensor(a) else a
                                    for a in args),
                              _host(shard.params),
                              tuple(map(_host, shard.state)))
            captured["average"] = kwargs.get("average", True)
        launch(*args, **kwargs)
        if first:
            captured["out"] = (_host(shard.params),
                               tuple(map(_host, shard.state)))

    setattr(shard, name, capture)


def main_path(dev, codec: str) -> dict:
    """Train gemma3-1b at full width for ROUNDS rounds through the fabric
    with ``codec`` on the wire.  Returns the path's launch counts, timings
    and shard 0's captured first update."""
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

    def labelled(name, fn):
        def call(*args, **kwargs):
            with record_function(name):
                return fn(*args, **kwargs)
        return call

    fab.pull = labelled("fabric.pull", fab.pull)
    fab.push = labelled("fabric.push+aggregate", fab.push)
    capture_first_apply(shard0, apply_name, captured)
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
            _zero_counts()  # every count of the port's kernels to 0 just before
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
            launches = _counts()  # ...and read just after
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
    want |= {"embedding_bag": 0, "segment_sum": 0}
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
    average = run["captured"]["average"]
    worst, piece = 0.0, 1 << 25
    for a in range(0, n0, piece):
        sl = slice(a, min(a + piece, n0))
        want_p, want_s = K.fused_agg_opt_torch(
            grads[:, sl].to(dev), p[sl].to(dev),
            tuple(s[sl].to(dev) for s in st), packet, run["spec"],
            average=average)
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
    average = run["captured"]["average"]
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
            chunk_elems=chunk, average=average)
        pairs = [(got_p[sl], want_p.cpu()),
                 *[(g[sl], w.cpu()) for g, w in zip(got_s, want_s)]]
        worst = max([worst] + [max_abs_err(x, y) for x, y in pairs])
        if not all(same_bits(x, y) for x, y in pairs):
            raise AssertionError(
                f"main-path wire_fused differs from wire_fused_torch, max "
                f"|err| {worst}")
    un_p, un_s = unfused_wire_update(
        pay.to(dev), scales.to(dev), p.to(dev), tuple(s.to(dev) for s in st),
        spec, step, codec=codec, chunk_elems=chunk, average=average)
    torch.cuda.synchronize()
    pairs = [(got_p, un_p.cpu()), *zip(got_s, (s.cpu() for s in un_s))]
    worst = max([worst] + [max_abs_err(x, y) for x, y in pairs])
    if not all(same_bits(x, y) for x, y in pairs):
        raise AssertionError(
            f"main-path wire_fused differs from the unfused kernel pipeline, "
            f"max |err| {worst}")
    del un_p, un_s
    torch.cuda.empty_cache()
    log(f"  shard 0 step 1 (K={k}, N={n0}, {codec}, average={average}): "
        f"wire_fused == wire_fused_torch == dequantize + fused_agg_opt "
        f"kernels bitwise")
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


# -- phases 6 and 7: the DLRM sparse path ------------------------------------
def dlrm_capped_config():
    """dlrm-mlperf at its published widths with every table capped at
    DLRM_ROW_CAP rows (the only cut: 163,079,093 rows at the 40M cap need
    77.8 GiB in f32, twice that with the tier's dense view)."""
    from repro_torch.configs.registry import get_arch

    cfg = get_arch("dlrm-mlperf").config
    return dataclasses.replace(cfg, vocabs=tuple(
        min(v, DLRM_ROW_CAP) for v in cfg.vocabs))


def dlrm_setup(cfg, dev, num_shards: int, codec: str = "none",
               topology=None):
    """The dense MLPs in a ``num_shards`` fabric and the tables in a
    fabric-attached SparseTier, built one table at a time from seeded
    generators (tables, bottom MLP, top MLP: seeds 0, 1, 2, in
    ``dlrm_init``'s order); each initial table is dropped once the tier
    holds its slabs.  Each table is padded to a multiple of the shard
    count (``padded_vocab``, the JAX package's ``init_tables(tp)``
    convention): a row placement needs a row for every shard, and
    Criteo's 3-row table has fewer than 4.  Ids never reach the pad rows.
    A ``topology`` goes to the fabric, and the tier inherits it."""
    import torch

    from repro_torch.core.chunking import ParamSpace
    from repro_torch.core.config import FabricConfig, WireConfig
    from repro_torch.core.fabric import PBoxFabric
    from repro_torch.core.sparse import SparseTier
    from repro_torch.models.common import embed_init
    from repro_torch.models.recsys.embedding import init_mlp, padded_vocab
    from repro_torch.optim.optimizers import sgd

    g_tables, g_bot, g_top = (torch.Generator(device=dev).manual_seed(s)
                              for s in range(3))
    dense = {"bot": init_mlp(g_bot, (cfg.n_dense,) + cfg.bot_mlp, cfg.dtype),
             "top": init_mlp(g_top, (cfg.top_in,) + cfg.top_mlp, cfg.dtype)}
    space = ParamSpace.build(dense)
    fab = PBoxFabric(space, sgd(DLRM_LR), space.flatten(dense), device=dev,
                     config=FabricConfig(num_shards=num_shards,
                                         num_workers=WORKERS,
                                         wire=WireConfig(topology=topology)))
    tier = SparseTier(fabric=fab, lr=DLRM_LR, codec=codec, placement="hash")
    for i, v in enumerate(cfg.vocabs):
        init = embed_init(g_tables, (padded_vocab(v, num_shards), cfg.embed_dim),
                          cfg.dtype, std=0.01)
        tier.add_table(f"t{i}", init)
        del init
    return space, fab, tier


def dlrm_round(space, fab, tier, cfg, streams, dev, losses: list) -> None:
    """One synchronous round, every worker in turn: pull the dense params,
    one SparseTier.lookup per table (one-hot bags), autograd of
    dlrm_loss_from_emb with respect to the dense params and a leaf ``e``,
    the dense gradient pushed into the fabric and (ids, cot_e) into the
    tier.  Each phase is a profiler range."""
    import numpy as np
    import torch
    from torch.profiler import record_function

    from repro_torch.models.recsys.models import dlrm_loss_from_emb

    for w in range(WORKERS):
        b = next(streams[w])
        bags = np.arange(b["sparse"].shape[0] + 1)
        with record_function("fabric.pull"):
            p = space.unflatten(fab.pull(w))
        p = {g: {k: v.detach().requires_grad_() for k, v in p[g].items()}
             for g in p}
        with record_function("lookup"):
            e = torch.stack([tier.lookup(w, f"t{i}", b["sparse"][:, i], bags)
                             for i in range(cfg.n_sparse)], dim=1)
        e.requires_grad_()
        with record_function("fwd_bwd"):
            batch = {"dense": torch.from_numpy(b["dense"]).to(dev),
                     "labels": torch.from_numpy(b["labels"]).to(dev)}
            loss, _ = dlrm_loss_from_emb(p, e, batch, cfg)
            leaves = [p[g][k] for g in sorted(p) for k in sorted(p[g])]
            *g_dense, cot_e = torch.autograd.grad(loss, leaves + [e])
        it = iter(g_dense)
        grads = {g: {k: next(it) for k in sorted(p[g])} for g in sorted(p)}
        with record_function("fabric.push"):
            fab.push(w, space.flatten(grads))
        with record_function("sparse.push"):
            tier.push(w, {f"t{i}": (b["sparse"][:, i], cot_e[:, i])
                          for i in range(cfg.n_sparse)})
        losses.append(loss.detach())


def _counts() -> dict:
    from repro_torch.kernels.embedding_bag import kernel as E
    from repro_torch.kernels.fused_agg_opt import kernel as K
    from repro_torch.kernels.quant import kernel as Q
    from repro_torch.kernels.wire_path import kernel as W

    return {"embedding_bag": E.launches, "segment_sum": E.segment_launches,
            "fused_agg_opt": K.launches, "quantize_chunks": Q.quantize_launches,
            "dequantize_chunks": Q.dequantize_launches, "wire_fused": W.launches}


def _zero_counts() -> None:
    from repro_torch.kernels.embedding_bag import kernel as E
    from repro_torch.kernels.fused_agg_opt import kernel as K
    from repro_torch.kernels.quant import kernel as Q
    from repro_torch.kernels.wire_path import kernel as W

    E.launches = E.segment_launches = K.launches = 0
    Q.quantize_launches = Q.dequantize_launches = W.launches = 0


def dlrm_path(dev) -> dict:
    """Train dlrm-mlperf (tables capped at DLRM_ROW_CAP rows) at full width
    for ROUNDS rounds: 2 workers x DLRM_BATCH samples, 4 shards.  Returns
    the launch counts, timings, stats and the captured kernel calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data.synthetic import recsys_batches
    from repro_torch.kernels.embedding_bag import kernel as E

    cfg = dlrm_capped_config()
    memory = PathMemory(dev)
    t0 = time.perf_counter()
    space, fab, tier = dlrm_setup(cfg, dev, SHARDS)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    mem = [("tier built", *memory.now())]
    rows = sum(t.num_rows for t in tier.tables.values())
    log(f"dlrm path: {cfg.name}, {cfg.n_sparse} tables capped at "
        f"{DLRM_ROW_CAP} rows ({sum(cfg.vocabs)} rows; {rows} padded to a "
        f"multiple of {SHARDS}) x {cfg.embed_dim} f32 "
        f"({rows * cfg.embed_dim * 4 / 2**30:.2f} GiB), bot {cfg.bot_mlp}, "
        f"top {cfg.top_mlp}; dense params {space.payload_elems}; built in "
        f"{setup_s:.1f} s")
    streams = [recsys_batches("dlrm-mlperf", cfg, DLRM_BATCH, seed=w)
               for w in range(WORKERS)]
    losses: list = []
    round_ms = []
    n = cfg.n_sparse
    # worker 0's round-2 lookup of t0 and its round-2 coalescing of t0 and
    # t5 (3 rows: every id a duplicate), replayed through the plain versions
    captures = [CaptureCall(E, "embedding_bag_cuda", WORKERS * n, memory),
                CaptureCall(E, "segment_sum_cuda", WORKERS * n, memory),
                CaptureCall(E, "segment_sum_cuda", WORKERS * n + 5, memory)]
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    with contextlib.ExitStack() as stack:
        for call in captures:
            stack.enter_context(call)
        _zero_counts()  # every count to 0 just before the path...
        for r in range(1, ROUNDS + 1):
            if r == ROUNDS:
                prof.start()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dlrm_round(space, fab, tier, cfg, streams, dev, losses)
            torch.cuda.synchronize()
            round_ms.append((time.perf_counter() - t0) * 1e3)
            mem.append((f"round {r} done", *memory.now()))
        prof.stop()
        launches = _counts()  # ...and read just after
    peak = memory.now()[1]
    loss_vals = [x.item() for x in losses]
    st = tier.stats
    log(tier.describe())
    log(f"  losses {loss_vals}")
    log(f"  round wall ms {[round(x, 1) for x in round_ms]} (round 1 "
        f"includes cuBLAS warm-up)")
    log(f"  launches {launches}")
    log(f"  SparseStats: rows pushed {st.rows_pushed}, coalesced "
        f"{st.rows_coalesced}, pulled {st.rows_pulled}; bytes pushed "
        f"{st.bytes_pushed}, pulled {st.bytes_pulled}; rounds {st.rounds}, "
        f"lookups {st.lookups}, pushes {st.pushes}")
    log(f"  fabric: bytes pushed {fab.stats.bytes_pushed}, pulled "
        f"{fab.stats.bytes_pulled}, steps {fab.stats.steps}")
    log(f"  peak device memory {peak} bytes ({peak / 2**30:.2f} GiB)"
        + (f", not counting the {memory.held} bytes of device copies the "
           f"replay check holds" if memory.held else ""))
    log("  device memory GiB (allocated, peak so far): " + "; ".join(
        f"{name} {a / 2**30:.2f}/{m / 2**30:.2f}" for name, a, m in mem))
    breakdown = profile_summary(prof, round_ms[-2], None, "embedding_bag",
                                "bag_kernel")
    in_path = {}
    for name, key in (("embedding_bag", "bag_kernel"),
                      ("segment_sum", "segment_kernel"),
                      ("fused_agg_opt", "fused_agg_opt_kernel"),
                      ("dense view rebuild (index_copy_)", "index_copy_kernel")):
        total, count = kernel_device_ms(prof, key)
        in_path[name] = total / count if count else None
        log(f"  profiled round, device: {name} {total:.4f} ms in {count} "
            f"launches" + (f" ({total / count:.4f} ms each)" if count else ""))
    want = {"embedding_bag": n * WORKERS * ROUNDS,
            "segment_sum": n * WORKERS * ROUNDS,
            "fused_agg_opt": SHARDS * ROUNDS, "quantize_chunks": 0,
            "dequantize_chunks": 0, "wire_fused": 0}
    if launches != want:
        raise AssertionError(f"launch counts {launches}, expected {want}")
    if not all(math.isfinite(x) for x in loss_vals):
        raise AssertionError(f"non-finite loss: {loss_vals}")
    if (fab.stats.steps, tier.round) != (ROUNDS, ROUNDS):
        raise AssertionError(f"fabric ran {fab.stats.steps} rounds and the "
                             f"tier {tier.round}, not {ROUNDS}")
    pushed = WORKERS * ROUNDS * n * DLRM_BATCH
    if (st.rows_pushed + st.rows_coalesced != pushed
            or st.lookups != WORKERS * ROUNDS * n
            or st.bytes_pushed != st.rows_pushed * (4 * cfg.embed_dim + 4)):
        raise AssertionError(f"SparseStats do not add up: {st}")
    for name, table in tier.tables.items():
        if not all(torch.isfinite(slab).all() for slab in table.slabs):
            raise AssertionError(f"table {name} holds non-finite values")
    if not torch.isfinite(fab.params).all():
        raise AssertionError("dense params are not finite")
    largest = max(range(n), key=lambda i: cfg.vocabs[i])
    u_largest = int(torch.unique(torch.from_numpy(
        next(recsys_batches("dlrm-mlperf", cfg, DLRM_BATCH, seed=0))["sparse"][:, largest])).numel())
    captured = {"lookup": (captures[0].args, captures[0].out),
                "coalesce_t0": (captures[1].args, captures[1].out),
                "coalesce_t5": (captures[2].args, captures[2].out)}
    del fab, tier, space, losses
    torch.cuda.empty_cache()
    return {"launches": launches, "kernel": "embedding_bag",
            "main_path_ms": in_path["embedding_bag"],
            "segment_main_path_ms": in_path["segment_sum"], "peak_bytes": peak,
            "round_ms": round_ms, "losses": loss_vals, "setup_s": setup_s,
            "stats": dataclasses.asdict(st), "captured": captured,
            "u_largest": u_largest, "rows": rows, **breakdown}


def replay_dlrm(run: dict) -> dict:
    """The captured lookup and coalescing calls through the plain versions
    on the card, bitwise."""
    from repro_torch.kernels.embedding_bag import kernel as E

    (table, idx, w, mode), (got,) = run["captured"]["lookup"]
    want = E.embedding_bag_torch(table, idx, w, mode)
    worst = {"embedding_bag": max_abs_err(got, want), "segment_sum": 0.0}
    if not same_bits(got, want):
        raise AssertionError(f"main-path embedding_bag differs from its plain "
                             f"version, max |err| {worst['embedding_bag']}")
    log(f"  worker 0 round 2 lookup of t0 (U={table.shape[0]}, B={idx.shape[0]}, "
        f"L={idx.shape[1]}): embedding_bag == plain version bitwise")
    for key in ("coalesce_t0", "coalesce_t5"):
        (rows, order, seg), (got,) = run["captured"][key]
        want = E.segment_sum_torch(rows, order, seg)
        worst["segment_sum"] = max(worst["segment_sum"], max_abs_err(got, want))
        if not same_bits(got, want):
            raise AssertionError(f"main-path segment_sum ({key}) differs from "
                                 f"its plain version, max |err| "
                                 f"{worst['segment_sum']}")
        log(f"  worker 0 round 2 {key.replace('_', ' of ')} (n={rows.shape[0]}, "
            f"U={seg.numel() - 1}): segment_sum == plain version bitwise")
    return worst


def dlrm_sharding_check(dev) -> None:
    """The DLRM SMOKE loop on the card with heavily repeated ids (every id
    taken modulo 17), 1 shard against 4, codecs none and int8 with error
    feedback: tables, row versions and dense params bitwise equal.  An
    atomic in the coalescing or the round's fold would break it."""
    import numpy as np
    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.data.synthetic import recsys_batches

    cfg = get_arch("dlrm-mlperf").smoke_config

    def repeated(seed):
        for b in recsys_batches("dlrm-mlperf", cfg, 4096, seed=seed):
            b["sparse"] = (b["sparse"] % 17).astype(np.int32)
            yield b

    for codec in ("none", "int8"):
        runs = []
        for shards in (1, 4):
            space, fab, tier = dlrm_setup(cfg, dev, shards, codec)
            streams = [repeated(w) for w in range(WORKERS)]
            losses: list = []
            for _ in range(ROUNDS):
                dlrm_round(space, fab, tier, cfg, streams, dev, losses)
            runs.append((fab, tier, [x.item() for x in losses]))
        (fa, ta, la), (fb, tb, lb) = runs
        same = la == lb and same_bits(fa.params, fb.params) and all(
            same_bits(ta.table(k), tb.table(k))
            and np.array_equal(ta.row_versions(k), tb.row_versions(k))
            for k in ta.tables)
        if not same:
            raise AssertionError(f"DLRM SMOKE on the card: 1 and 4 shards "
                                 f"differ with codec {codec}")
        log(f"dlrm sharding check ({codec}, batch 4096, ids mod 17, "
            f"coalesced {ta.stats.rows_coalesced} of "
            f"{ta.stats.rows_coalesced + ta.stats.rows_pushed} rows): 1 shard "
            f"== 4 shards bitwise (tables, versions, dense params)")
        del runs, fa, fb, ta, tb
    torch.cuda.empty_cache()


# -- phases 8 to 11: straggler modes, snapshots and rebalancing ---------------
@contextlib.contextmanager
def deterministic():
    """torch's deterministic algorithms while the block runs.  The runs
    these phases compare recompute the same gradients, and the model's
    backward accumulates with atomics (``index_add_`` under the GQA head
    gather, ``index_put_`` under the embedding gather) unless torch takes
    its deterministic paths.  An op without one only warns; the bitwise
    comparisons would then fail."""
    import torch

    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])


def timed(fn) -> float:
    """Host ms of ``fn()``, the work it queues on the card included."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def _check_counts(label: str, got: dict, want: dict) -> None:
    want = {k: 0 for k in got} | want
    if got != want:
        raise AssertionError(f"{label}: launch counts {got}, expected {want}")


def finite_losses(losses: list) -> list:
    """The losses recorded since the last call, as floats (emptying the
    list); raises on a non-finite one.  Read once a phase: ``item()``
    waits for the card."""
    vals = [x.item() for x in losses]
    losses.clear()
    if not all(math.isfinite(x) for x in vals):
        raise AssertionError(f"non-finite loss: {vals}")
    return vals


class GemmaWorkers:
    """gemma3-1b at full width for phases 8-13: seeded weights (seed 0),
    the flat space, fabrics built from them, and a worker gradient that is
    a function of the pulled params and (worker, step) alone, so a
    replayed step sees the same tokens."""

    def __init__(self, dev):
        import torch

        from repro_torch.configs.registry import get_arch
        from repro_torch.core.chunking import ParamSpace
        from repro_torch.models.transformer import init_params

        self.dev = dev
        self.cfg = get_arch("gemma3-1b").config
        params = init_params(self.cfg,
                             torch.Generator(device=dev).manual_seed(0))
        self.space = ParamSpace.build(params)
        self.init = self.space.flatten(params)
        del params
        torch.cuda.empty_cache()
        self.losses: list = []

    def finite_losses(self) -> list:
        return finite_losses(self.losses)

    def grad_tree(self, params: dict, w: int, s: int) -> dict:
        """Worker ``w``'s gradient tree at its step ``s``."""
        import torch

        from repro_torch.data.synthetic import lm_batches
        from repro_torch.models.transformer import lm_loss_and_grad

        b = next(lm_batches(self.cfg.vocab, 1, SEQ, seed=1000 * (w + 1) + s))
        loss, g = lm_loss_and_grad(
            params, torch.from_numpy(b["tokens"]).to(self.dev),
            torch.from_numpy(b["labels"]).to(self.dev), self.cfg)
        self.losses.append(loss)
        return g

    def grad(self, flat, w: int, s: int):
        """The flat gradient against the pulled flat params."""
        return self.space.flatten(
            self.grad_tree(self.space.unflatten(flat), w, s))

    def fabric(self, num_workers: int, num_shards: int = SHARDS,
               codec: str = "none", topology=None, switch=None, **fields):
        from repro_torch.core.compression import CompressionConfig
        from repro_torch.core.config import (
            FabricConfig,
            SwitchConfig,
            WireConfig,
        )
        from repro_torch.core.fabric import PBoxFabric
        from repro_torch.optim.optimizers import adamw

        return PBoxFabric(
            self.space, adamw(3e-3), self.init, device=self.dev,
            config=FabricConfig(num_shards=num_shards,
                                num_workers=num_workers,
                                wire=WireConfig(
                                    topology=topology,
                                    compression=CompressionConfig(
                                        codec=codec),
                                    switch=switch or SwitchConfig()),
                                **fields))

    def round(self, fab, s: int, workers=(0, 1)) -> None:
        """Each worker in turn pulls, computes its step-``s`` gradient and
        pushes."""
        for w in workers:
            fab.push(w, self.grad(fab.pull(w), w, s))


def quorum_path(dev, gw: GemmaWorkers) -> dict:
    """Backup quorum at full width: 3 workers, ``min_push_fraction`` 0.5,
    so the quorum is ceil(1.5) = 2.  Each round all three pull, workers 0
    and 1 push (the round fires with K = 2), and worker 2 pushes the
    gradient it computed against the superseded params, which the fabric
    drops.  The params must equal a 2-worker sync fabric fed workers 0 and
    1's batches, bitwise."""
    import torch

    memory = PathMemory(dev)
    fab = gw.fabric(3, min_push_fraction=0.5)
    if fab.min_pushes != 2:
        raise AssertionError(f"min_pushes {fab.min_pushes}, not 2")

    def one_round(s):
        flats = [fab.pull(w) for w in range(3)]
        for w in (0, 1):
            fab.push(w, gw.grad(flats[w], w, s))
        late = gw.grad(flats[2], 2, s)  # against the superseded params
        del flats
        fab.push(2, late)

    _zero_counts()  # the counts to 0 just before the path...
    round_ms = [timed(lambda s=s: one_round(s)) for s in range(ROUNDS)]
    launches = _counts()  # ...and read just after
    peak = memory.now()[1]
    st = fab.stats
    log(f"quorum path: {gw.cfg.name}, 3 workers, min_push_fraction 0.5 "
        f"(min_pushes {fab.min_pushes}), {SHARDS} shards, AdamW, {ROUNDS} "
        f"rounds")
    log(f"  losses {gw.finite_losses()}")
    log(f"  launches {launches}; steps {st.steps}, partial aggregations "
        f"{st.partial_aggregations}, late pushes dropped "
        f"{st.late_pushes_dropped}")
    log(f"  round wall ms {[round(x, 1) for x in round_ms]} (3 gradients a "
        f"round, the third dropped); peak device memory {peak} bytes "
        f"({peak / 2**30:.2f} GiB)")
    _check_counts("quorum path", launches, {"fused_agg_opt": SHARDS * ROUNDS})
    if (st.steps, st.partial_aggregations, st.late_pushes_dropped) != (
            ROUNDS, ROUNDS, ROUNDS):
        raise AssertionError(f"quorum stats {st}")
    final = fab.params
    del fab
    ref = gw.fabric(2)
    for s in range(ROUNDS):
        gw.round(ref, s)
    gw.finite_losses()
    if not same_bits(final, ref.params):
        raise AssertionError(
            f"quorum fabric differs from the 2-worker sync fabric, max |err| "
            f"{max_abs_err(final, ref.params)}")
    log(f"  quorum (K = 2 of 3, the late push dropped) == 2-worker sync "
        f"fabric, bitwise after {ROUNDS} rounds")
    del ref, final
    torch.cuda.empty_cache()
    return {"launches": launches, "round_ms": round_ms, "peak_bytes": peak}


def async_path(dev, gw: GemmaWorkers) -> dict:
    """Async (Hogwild-PS) at full width on the int8 wire, error feedback
    and the fused wire path on: ``WorkerHarness(speed=[1, 2]).run(3)``
    makes 9 pushes, each applied at once with K = 1 and no averaging.
    Shard 0's first apply_wire is captured for a replay."""
    import torch

    from repro_torch.core.fabric import WorkerHarness
    from repro_torch.kernels.wire_path import kernel as W

    memory = PathMemory(dev)
    fab = gw.fabric(2, codec="int8", mode="async")
    captured: dict = {}
    shard0 = fab.shards[0]
    capture_first_apply(shard0, "apply_wire", captured)
    timer = LaunchTimer(W, "wire_fused_cuda")
    h = WorkerHarness(fab, lambda p, ws: gw.grad_tree(p, *ws),
                      lambda w, s: (w, s), speed=[1, 2])
    marks = []  # the host clock as each push has been applied
    push = fab.push

    def marked_push(w, g):
        push(w, g)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    fab.push = marked_push
    try:
        with timer:
            _zero_counts()  # the counts to 0 just before the path...
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            h.run(ROUNDS)
            launches = _counts()  # ...and read just after
    finally:
        delattr(shard0, "apply_wire")
        del fab.push
    push_ms = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
    ms = sum(push_ms)
    peak = memory.now()[1]
    st = fab.stats
    pushes = 3 * ROUNDS
    kernel_ms = timer.ms()
    log(f"async path: {gw.cfg.name}, 2 workers at speeds [1, 2], int8 wire "
        f"(error feedback, fused wire path), {SHARDS} shards, AdamW")
    log(f"  losses {gw.finite_losses()}")
    log(f"  launches {launches}; steps {st.steps}, fused wire rounds "
        f"{st.fused_wire_rounds}, pushes {st.pushes}; wall ms {ms:.1f} for "
        f"{pushes} pushes, each (pull, gradient, encode, 4 updates) "
        f"{[round(x, 1) for x in push_ms]} (the first includes the shard-0 "
        f"capture to host memory)")
    log(f"  wire_fused (K=1, average=False) ms per launch (CUDA events, "
        f"median of {len(kernel_ms)}) {statistics.median(kernel_ms):.4f}; "
        f"peak device memory {peak} bytes ({peak / 2**30:.2f} GiB)")
    _check_counts("async path", launches, {
        "quantize_chunks": pushes, "dequantize_chunks": pushes,
        "wire_fused": SHARDS * pushes})
    if (st.steps, st.fused_wire_rounds, st.pushes) != (pushes,) * 3:
        raise AssertionError(f"async stats {st}")
    if captured["average"] or captured["in"][0][0].shape[0] != 1:
        raise AssertionError("the async apply_wire was not K = 1 without "
                             "averaging")
    if not torch.isfinite(fab.params).all():
        raise AssertionError("async params are not finite")
    n0, spec = shard0.num_elems, fab.spec
    del fab, h, shard0
    torch.cuda.empty_cache()
    return {"launches": launches, "push_ms": push_ms, "peak_bytes": peak,
            "main_path_ms": statistics.median(kernel_ms), "n": n0,
            "chunk": gw.space.chunk_elems, "spec": spec, "captured": captured}


def host_available_bytes() -> int:
    """MemAvailable of /proc/meminfo, in bytes."""
    for line in Path("/proc/meminfo").read_text().splitlines():
        if line.startswith("MemAvailable:"):
            return int(line.split()[1]) * 1024
    raise RuntimeError("no MemAvailable in /proc/meminfo")


def snapshot_digest(snap: dict) -> str:
    """SHA-1 of a snapshot's arrays (pieces hashed on 8 threads; hashlib
    releases the GIL), clocks and step."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    piece = 1 << 28
    views = []
    for a in (snap["params"], *snap["state"]):
        b = np.ascontiguousarray(a).reshape(-1).view(np.uint8)
        views += [b[i:i + piece] for i in range(0, b.size, piece)]
    with ThreadPoolExecutor(8) as pool:
        parts = list(pool.map(lambda v: hashlib.sha1(v).digest(), views))
    h = hashlib.sha1(b"".join(parts))
    h.update(np.asarray(snap["worker_clock"], np.int64).tobytes())
    h.update(str(int(snap["step"])).encode())
    return h.hexdigest()


def snapshot_path(dev, gw: GemmaWorkers) -> dict:
    """Snapshot, rebalance and restore at full width (f32 wire, 2 workers).

    Run A: rounds 1-2; in round 3 worker 0 pushes, the snapshot is taken
    (worker 0's clock rolls back in it), worker 1 pushes; a
    ShardRebalancer fed latencies that flag shard 3 drains it; rounds 4-5.
    Run B: a fresh 2-shard fabric restores the snapshot and replays round
    3, then rounds 4-5.  A's and B's final params must be bitwise equal
    (only A's are kept while B runs), the snapshot must be unchanged by
    A's later rounds, and restoring it a second time must give its bits
    back."""
    import torch

    from repro_torch.runtime.straggler import ShardRebalancer

    free = host_available_bytes()
    log(f"snapshot path: {gw.cfg.name}, 2 workers, f32 wire, AdamW; host "
        f"memory available before it {free} bytes ({free / 2**30:.1f} GiB)")
    memory = PathMemory(dev)
    fab = gw.fabric(2)
    _zero_counts()  # run A's counts to 0 just before it...
    round_ms = [timed(lambda s=s: gw.round(fab, s)) for s in (0, 1)]
    gw.round(fab, 2, workers=(0,))
    snap: dict = {}
    d2h_ms = timed(lambda: snap.update(fab.snapshot()))
    nbytes = sum(a.nbytes for a in (snap["params"], *snap["state"]))
    if list(snap["worker_clock"]) != [2, 2] or list(fab.worker_clock) != [3, 2]:
        raise AssertionError(
            f"mid-round snapshot clocks {snap['worker_clock']} (fabric "
            f"{fab.worker_clock}), expected [2, 2] ([3, 2])")
    t0 = time.perf_counter()
    digest = snapshot_digest(snap)
    hash_s = time.perf_counter() - t0
    gw.round(fab, 2, workers=(1,))
    reb = ShardRebalancer(fab, cooldown=0)
    for _ in range(10):
        for shard, lat_ms in enumerate((1.0, 1.0, 1.0, 5.0)):
            reb.record(shard, lat_ms)
    drained: list = []
    rebalance_ms = timed(lambda: drained.extend(reb.maybe_rebalance()))
    if drained != [3] or fab.shards[3].num_chunks != 0:
        raise AssertionError(f"the rebalancer drained {drained}; shard 3 "
                             f"holds {fab.shards[3].num_chunks} chunks")
    moved = fab.stats.chunks_moved
    round_ms += [timed(lambda s=s: gw.round(fab, s)) for s in (3, 4)]
    launches_a = _counts()  # ...read just after
    peak_a = memory.now()[1]
    losses_a = gw.finite_losses()
    final_a = fab.params
    sim = (fab.stats.sim_pipelined_us, fab.stats.sim_serialized_us)
    del fab, reb
    torch.cuda.empty_cache()
    if snapshot_digest(snap) != digest:
        raise AssertionError("run A's later rounds changed the snapshot")
    log(f"  run A (4 shards): launches {launches_a}; round wall ms "
        f"{[round(x, 1) for x in round_ms]} (rounds 1, 2, 4, 5); mid-round 3 "
        f"snapshot of {nbytes} bytes to host in {d2h_ms:.1f} ms "
        f"({nbytes / d2h_ms / 1e6:.2f} GB/s), SHA-1 in {hash_s:.1f} s; the "
        f"rebalancer drained shard {drained} ({moved} chunks moved) in "
        f"{rebalance_ms:.1f} ms; event clock pipelined/serialized "
        f"{sim[0]:.0f}/{sim[1]:.0f} us; peak device memory {peak_a} bytes "
        f"({peak_a / 2**30:.2f} GiB)")
    _check_counts("snapshot run A", launches_a,
                  {"fused_agg_opt": 3 * SHARDS + 2 * (SHARDS - 1)})
    memory = PathMemory(dev)
    fab = gw.fabric(2, num_shards=2)
    _zero_counts()  # run B's counts to 0 just before it...
    h2d_ms = timed(lambda: fab.restore(snap))
    if fab.step != 2 or list(fab.worker_clock) != [2, 2]:
        raise AssertionError(f"restored step {fab.step}, clocks "
                             f"{fab.worker_clock}")
    round_b = [timed(lambda s=s: gw.round(fab, s)) for s in (2, 3, 4)]
    launches_b = _counts()  # ...read just after
    peak_b = memory.now()[1]
    losses_b = gw.finite_losses()
    if not same_bits(final_a, fab.params):
        raise AssertionError(
            f"run B (restored onto 2 shards) differs from run A, max |err| "
            f"{max_abs_err(final_a, fab.params)}")
    log(f"  run B (2 shards): restore of {nbytes} bytes in {h2d_ms:.1f} ms "
        f"({nbytes / h2d_ms / 1e6:.2f} GB/s); launches {launches_b}; round "
        f"wall ms {[round(x, 1) for x in round_b]} (rounds 3-5); peak device "
        f"memory {peak_b} bytes ({peak_b / 2**30:.2f} GiB)")
    if losses_b != losses_a[-len(losses_b):]:
        raise AssertionError(f"run B's losses {losses_b} are not run A's "
                             f"last {losses_a[-len(losses_b):]}")
    log(f"  run A (mid-round snapshot, rebalance) == run B (restored onto 2 "
        f"shards), bitwise; losses A {losses_a}, B {losses_b}")
    _check_counts("snapshot run B", launches_b, {"fused_agg_opt": 3 * 2})
    del final_a
    fab.restore(snap)
    again: dict = {}
    again_ms = timed(lambda: again.update(fab.snapshot()))
    if snapshot_digest(again) != digest:
        raise AssertionError("restoring the snapshot a second time gave "
                             "other bits")
    log(f"  restored a second time: the snapshot's bits (re-snapshot in "
        f"{again_ms:.1f} ms); the snapshot unchanged by run A's later rounds")
    del fab, snap, again
    torch.cuda.empty_cache()
    return {"launches_a": launches_a, "launches_b": launches_b,
            "round_ms": round_ms + round_b, "d2h_ms": d2h_ms,
            "h2d_ms": h2d_ms, "snapshot_bytes": nbytes,
            "rebalance_ms": rebalance_ms, "chunks_moved": moved,
            "peak_bytes": max(peak_a, peak_b), "host_available": free}


# mode -> (workers, FabricConfig fields, harness speeds; None: by hand)
SMOKE_MODES = {
    "quorum": (3, dict(min_push_fraction=0.5), None),
    "ssp": (2, dict(mode="stale", staleness=1), [1, 2]),
    "async": (2, dict(mode="async"), [1, 2]),
}


def smoke_modes_check(dev) -> dict:
    """Every mode x codec (none, int8) at gemma3-1b's SMOKE config: the
    fabric on ``dev`` against the fabric on the CPU, bitwise in params,
    state, error-feedback residuals and every ServerStats field.  The
    workers' gradients come from the CPU model for both fabrics (the
    card's matmuls sum in another order), so two fabrics that agree pull
    the same params and get the same gradients.  Each run then takes a
    mid-round ``Checkpointer.save_fabric`` into a temporary directory,
    restores it into a fresh fabric with ``restore_fabric`` and trains 2
    more rounds.  Returns each case's kernel launches on ``dev``."""
    import tempfile

    import torch

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.chunking import ParamSpace
    from repro_torch.core.compression import CompressionConfig
    from repro_torch.core.config import FabricConfig, WireConfig
    from repro_torch.core.fabric import PBoxFabric, WorkerHarness
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.models.transformer import init_params, lm_loss_and_grad
    from repro_torch.optim.optimizers import adamw

    cfg = get_arch("gemma3-1b").smoke_config
    params = init_params(cfg, torch.Generator().manual_seed(0))
    space = ParamSpace.build(params, chunk_elems=4096)
    init = space.flatten(params)
    cpu = torch.device("cpu")

    def grad(flat, w, s):
        b = next(lm_batches(cfg.vocab, 4, 32, seed=1000 * (w + 1) + s))
        _, g = lm_loss_and_grad(space.unflatten(flat.cpu()),
                                torch.from_numpy(b["tokens"]),
                                torch.from_numpy(b["labels"]), cfg)
        return space.flatten(g).to(flat.device)

    def drive(fab, speeds, rounds):
        if speeds is not None:
            WorkerHarness(fab, lambda p, ws: space.unflatten(
                grad(space.flatten(p), *ws)), lambda w, s: (w, s),
                speed=speeds).run(rounds)
            return
        for s in range(rounds):  # all pull, then all push: the last drops
            flats = [fab.pull(w) for w in range(fab.num_workers)]
            for w in range(fab.num_workers):
                fab.push(w, grad(flats[w], w, s))

    def state_of(fab):
        return ([fab.params.cpu()]
                + [fab._assemble_rows(lambda sh, k=k: sh.state[k]).cpu()
                   for k in range(fab.spec.num_state_slots)]
                + [fab._worker_ef[w].cpu() for w in sorted(fab._worker_ef)])

    def run(d, config, speeds, mode, tmp):
        fab = PBoxFabric(space, adamw(3e-3), init.to(d), config=config,
                         device=d)
        drive(fab, speeds, ROUNDS)
        first = (state_of(fab), dataclasses.asdict(fab.stats))
        fab.push(0, grad(fab.pull(0), 0, 9))  # mid-round
        ck = Checkpointer(Path(tmp) / d.type)
        ck.save_fabric(fab.step, fab, meta={"mode": mode})
        fab2 = PBoxFabric(space, adamw(3e-3), torch.zeros_like(init, device=d),
                          config=config, device=d)
        meta = ck.restore_fabric(fab2)
        if meta["mode"] != mode or fab2.step != fab.step:
            raise AssertionError(f"checkpoint meta {meta}, step {fab2.step}")
        drive(fab2, speeds, 2)
        return first, state_of(fab2), dataclasses.asdict(fab2.stats)

    launches = {}
    for mode, (workers, fields, speeds) in SMOKE_MODES.items():
        for codec in ("none", "int8"):
            config = FabricConfig(
                num_shards=SHARDS, num_workers=workers, **fields,
                wire=WireConfig(compression=CompressionConfig(codec=codec)))
            with tempfile.TemporaryDirectory() as tmp:
                ref = run(cpu, config, speeds, mode, tmp)
                _zero_counts()
                got = run(dev, config, speeds, mode, tmp)
                launches[f"{mode}/{codec}"] = _counts()
            same = (all(same_bits(a, b) for a, b in zip(ref[0][0], got[0][0]))
                    and ref[0][1] == got[0][1] and ref[2] == got[2]
                    and all(same_bits(a, b) for a, b in zip(ref[1], got[1])))
            if not same:
                raise AssertionError(f"SMOKE {mode}/{codec}: the fabric on "
                                     f"{dev} differs from the CPU's")
            st = ref[0][1]
            log(f"smoke modes: {mode}/{codec} ({workers} workers, "
                + (f"speeds {speeds}" if speeds else "all pull, then all push")
                + f"): steps {st['steps']}, partial "
                f"{st['partial_aggregations']}, dropped "
                f"{st['late_pushes_dropped']}, fused wire rounds "
                f"{st['fused_wire_rounds']}; then a mid-round save_fabric / "
                f"restore_fabric and 2 more rounds; {dev} == cpu bitwise; "
                f"launches on {dev.type} {launches[f'{mode}/{codec}']}")
    return launches


# -- phases 12 to 14: the rack topology tier ---------------------------------
RACKS, OVERSUB = 2, 4.0  # NetworkTopology(workers, 2 racks, 1:4 core)


def topology(workers: int):
    from repro_torch.core.topology import NetworkTopology

    return NetworkTopology(workers, RACKS, oversubscription=OVERSUB)


def rack_chain_path(dev, gw: GemmaWorkers) -> dict:
    """Phase 12: the f32 rack chain at full width.  4 workers over 2 racks
    (1:4 core), codec none, 3 rounds: each ToR folds its members onto the
    prefix from the rack before and relays it, so the shards see one
    stream and three zero rows a round.  The params must equal a 4-worker
    flat fabric fed the same batches, bitwise; the core link carries 2
    streams a round where the flat fabric's carries 4."""
    import torch

    from repro_torch.core.compression import CompressionConfig, wire_bytes

    workers = range(4)
    n = gw.space.flat_elems
    memory = PathMemory(dev)
    fab = gw.fabric(4, topology=topology(4))
    _zero_counts()  # the counts to 0 just before the path...
    round_ms = [timed(lambda s=s: gw.round(fab, s, workers))
                for s in range(ROUNDS)]
    launches = _counts()  # ...and read just after
    peak = memory.now()[1]
    st = fab.stats
    stream = wire_bytes(CompressionConfig(), n)
    log(f"rack chain path: {gw.cfg.name}, 4 workers over {RACKS} racks "
        f"(core 1:{OVERSUB:g}), codec none, {SHARDS} shards, AdamW, {ROUNDS} "
        f"rounds")
    log(f"  losses {gw.finite_losses()}")
    log(f"  launches {launches}; rack streams {st.rack_streams}, bytes core "
        f"link {st.bytes_core_link}, rack links {st.bytes_rack_link}; event "
        f"clock core {st.sim_core_wire_us:.0f} us, pipelined "
        f"{st.sim_pipelined_us:.0f} us")
    log(f"  round wall ms {[round(x, 1) for x in round_ms]} (4 gradients a "
        f"round); peak device memory {peak} bytes ({peak / 2**30:.2f} GiB)")
    _check_counts("rack chain path", launches,
                  {"fused_agg_opt": SHARDS * ROUNDS})
    want = (ROUNDS * RACKS, ROUNDS * RACKS * stream, ROUNDS * 4 * stream)
    if (st.rack_streams, st.bytes_core_link, st.bytes_rack_link) != want:
        raise AssertionError(f"rack chain stats {st}, expected (rack "
                             f"streams, core, rack bytes) {want}")
    final = fab.params
    del fab
    torch.cuda.empty_cache()
    # the rack chain's params, kept for the comparison, are not the flat
    # run's memory
    flat_memory = PathMemory(dev, held=final.numel() * final.element_size())
    ref = gw.fabric(4)
    _zero_counts()
    flat_ms = [timed(lambda s=s: gw.round(ref, s, workers))
               for s in range(ROUNDS)]
    flat_launches = _counts()
    flat_peak = flat_memory.now()[1]
    gw.finite_losses()
    _check_counts("flat 4-worker fabric", flat_launches,
                  {"fused_agg_opt": SHARDS * ROUNDS})
    if ref.stats.bytes_core_link != ROUNDS * 4 * stream:
        raise AssertionError(f"flat core bytes {ref.stats.bytes_core_link}")
    if not same_bits(final, ref.params):
        raise AssertionError(
            f"rack chain differs from the flat fabric, max |err| "
            f"{max_abs_err(final, ref.params)}")
    log(f"  rack chain == 4-worker flat fabric, bitwise after {ROUNDS} rounds; "
        f"core link {st.bytes_core_link} bytes against the flat fabric's "
        f"{ref.stats.bytes_core_link} ({st.bytes_core_link / ref.stats.bytes_core_link:.2f}x); "
        f"flat round wall ms {[round(x, 1) for x in flat_ms]}, peak "
        f"{flat_peak} bytes ({flat_peak / 2**30:.2f} GiB)")
    out = {"launches": launches, "flat_launches": flat_launches,
           "round_ms": round_ms, "flat_round_ms": flat_ms,
           "peak_bytes": peak, "flat_peak_bytes": flat_peak,
           "bytes_core_link": st.bytes_core_link,
           "flat_bytes_core_link": ref.stats.bytes_core_link}
    del ref, final
    torch.cuda.empty_cache()
    return out


def switch_path(dev, gw: GemmaWorkers) -> dict:
    """Phase 13: the switch pools at full width on the int8 wire (error
    feedback, fused wire path).  2 workers, one in each of 2 racks, AdamW,
    3 rounds, three runs:
      offloaded  ToR and core pools of one slot per chunk: every round
                 the ToR pools sum their rack's int8 payload under a shared
                 scale and the core pool sums the two rack streams, one
                 re-encoded stream reaching the shards;
      starved    pools one slot short: no push is ever parked, so the run
                 is the software path;
      no switch  the same topology fabric without the tier; the starved
                 run must equal it, bitwise."""
    import torch

    from repro_torch.core.compression import CompressionConfig, wire_bytes
    from repro_torch.core.config import SwitchConfig

    c = gw.space.num_chunks
    runs: dict = {}
    finals: dict = {}
    for label, slots in (("offloaded", c), ("starved", c - 1),
                         ("no switch", None)):
        switch = (SwitchConfig() if slots is None else
                  SwitchConfig(enabled=True, tor_slots=slots,
                               core_slots=slots))
        # the starved run's params, kept for the comparison, are not this
        # run's memory
        memory = PathMemory(dev, held=sum(t.numel() * t.element_size()
                                          for t in finals.values()))
        fab = gw.fabric(WORKERS, codec="int8", topology=topology(WORKERS),
                        switch=switch)
        _zero_counts()  # the counts to 0 just before the run...
        round_ms = [timed(lambda s=s: gw.round(fab, s))
                    for s in range(ROUNDS)]
        launches = _counts()  # ...and read just after
        peak = memory.now()[1]
        st = fab.stats
        runs[label] = {"launches": launches, "round_ms": round_ms,
                       "peak_bytes": peak,
                       "stats": dataclasses.asdict(st),
                       "switches": [dataclasses.asdict(r.switch.stats)
                                    for r in fab.rack_aggs if r.switch]
                       + ([dataclasses.asdict(fab.core_switch.stats)]
                          if fab.core_switch else [])}
        log(f"switch path ({label}): {gw.cfg.name}, 2 workers over {RACKS} "
            f"racks, int8 wire, "
            + (f"tor_slots = core_slots = {slots} ({c} chunks)" if slots
               else "no switch tier") + f", AdamW, {ROUNDS} rounds")
        log(f"  losses {gw.finite_losses()}")
        log(f"  launches {launches}; switch rounds {st.switch_rounds}, core "
            f"switch rounds {st.core_switch_rounds}, fallback rounds "
            f"{st.switch_fallback_rounds}, bytes absorbed "
            f"{st.bytes_switch_agg}, PS ingress saved {st.bytes_switch_saved}; "
            f"bytes core link {st.bytes_core_link}")
        log(f"  round wall ms {[round(x, 1) for x in round_ms]}; peak device "
            f"memory {peak} bytes ({peak / 2**30:.2f} GiB)")
        if not torch.isfinite(fab.params).all():
            raise AssertionError(f"switch path ({label}): params not finite")
        if label == "offloaded":
            _check_counts("offloaded switch run", launches,
                          {"wire_fused": SHARDS * ROUNDS})
            if (st.switch_rounds, st.core_switch_rounds,
                    st.switch_fallback_rounds) != (ROUNDS, ROUNDS, 0):
                raise AssertionError(f"offloaded switch stats {st}")
        else:
            _check_counts(f"{label} run", launches, {
                "quantize_chunks": 2 * WORKERS * ROUNDS,
                "dequantize_chunks": 2 * WORKERS * ROUNDS,
                "wire_fused": SHARDS * ROUNDS})
            if st.switch_rounds or st.core_switch_rounds:
                raise AssertionError(f"{label} run offloaded: {st}")
            finals[label] = fab.params
        del fab
        torch.cuda.empty_cache()
    if not same_bits(finals["starved"], finals["no switch"]):
        raise AssertionError(
            f"starved pools differ from no switch tier, max |err| "
            f"{max_abs_err(finals['starved'], finals['no switch'])}")
    del finals
    torch.cuda.empty_cache()
    flat = ROUNDS * WORKERS * wire_bytes(CompressionConfig(codec="int8"),
                                         gw.space.flat_elems)
    log(f"  starved pools == no switch tier, bitwise after {ROUNDS} rounds; "
        f"core link {runs['offloaded']['stats']['bytes_core_link']} bytes, "
        f"a flat int8 fabric's {flat} (2 pushes a round); the core pool "
        f"saved {runs['offloaded']['stats']['bytes_switch_saved']} bytes of "
        f"PS ingress")
    return runs


def switch_math_ms(dev, n: int, chunk: int) -> dict:
    """Device time (CUDA events, median of 5) of the switch pool's plain
    torch integer math at full width, on two seeded f32 slabs of ``n``
    elements (2 racks): the shared scale, one sender's int8 encode and its
    residual, the int32 slot sum of two payloads and its dequantize.  Each
    beside its byte bound (inputs read once, outputs written once)."""
    import torch

    from repro_torch.core.topology import (
        SwitchCompute,
        group_scale,
        integer_quantize,
        quant_residual,
        scale_chunks,
    )

    name = torch.cuda.get_device_name(dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    a = torch.randn(n, generator=gen, device=dev) * 1e-3
    b = torch.randn(n, generator=gen, device=dev) * 1e-3
    c = n // chunk
    sw = SwitchCompute("t", c)
    s = group_scale([a, b], chunk)
    qa = integer_quantize(a, s, chunk)
    qb = integer_quantize(b, s, chunk)
    acc = sw.accumulate([qa, qb], chunk)
    # (label, call, bytes read and written once)
    ops = {
        "group_scale (2 slabs)": (lambda: group_scale([a, b], chunk),
                                  8 * n + 4 * c),
        "integer_quantize": (lambda: integer_quantize(a, s, chunk),
                             4 * n + 4 * c + n),
        "residual": (lambda: quant_residual(a, qa, s),
                     4 * n + n + 4 * c + 4 * n),
        "accumulate (2 payloads)": (lambda: sw.accumulate([qa, qb], chunk),
                                    2 * n + 4 * n),
        "dequantize the sum": (lambda: scale_chunks(acc, s),
                               4 * n + 4 * c + 4 * n),
    }
    out = {}
    for label, (fn, nbytes) in ops.items():
        ms = cuda_ms(fn, reps=5)
        out[label] = {"ms": ms, **bound(name, nbytes, 0)}
    del a, b, qa, qb, acc, s
    torch.cuda.empty_cache()
    total = sum(v["ms"] for v in out.values())
    log(f"switch integer math (plain torch ops, n = {n}, chunk {chunk}; CUDA "
        f"events, median of 5): " + "; ".join(
            f"{k} {v['ms']:.3f} ms (bound {v['bound_ms']:.3f})"
            for k, v in out.items()) + f"; sum {total:.3f} ms")
    return out


# the SMOKE topology sweep: mode -> (FabricConfig fields, harness speeds;
# None: every worker pulls, then every worker pushes)
TOPO_MODES = {
    "sync": (dict(), [1, 1, 1, 1]),
    "quorum": (dict(min_push_fraction=0.75), None),
    "ssp": (dict(mode="stale", staleness=1), [1, 1, 1, 2]),
    "async": (dict(mode="async"), [1, 1, 1, 2]),
}
SWITCH_VARIANTS = ("off", "on", "starved", "tor_fail", "core_fail")


def smoke_topology_check(dev) -> dict:
    """Phase 14: the topology tier at gemma3-1b's SMOKE config, every codec
    (none, bf16, int8 with error feedback) x mode (sync, a 3-of-4 quorum,
    SSP, async) x switch (off; pools of one slot per chunk; starved one
    slot short; a ToR pool, or the core pool, failed at round 2 by a
    FaultPlan and restored at round 3): 4 workers over 2 racks, 4 shards,
    3 rounds.  The fabric on ``dev`` against the fabric on the CPU,
    bitwise in params, state, every ServerStats / ShardStats / RackStats /
    SwitchStats field, the ToRs' and core pool's residuals and
    fault_trace.  The card run goes first and computes each gradient on
    the card, keyed by (worker, step, digest of the pulled params); the
    CPU run then takes the gradient of the same key, so both fabrics get
    the same bits, and a CPU pull the card never made fails the case.
    Returns each case's kernel launches on ``dev``."""
    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.core.chunking import ParamSpace
    from repro_torch.core.compression import CompressionConfig
    from repro_torch.core.config import (
        FabricConfig,
        FaultConfig,
        SwitchConfig,
        WireConfig,
    )
    from repro_torch.core.fabric import PBoxFabric, WorkerHarness
    from repro_torch.core.replication import FaultEvent, FaultPlan
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.models.transformer import init_params, lm_loss_and_grad
    from repro_torch.optim.optimizers import adamw

    cfg = get_arch("gemma3-1b").smoke_config
    params = init_params(cfg, torch.Generator().manual_seed(0))
    space = ParamSpace.build(params, chunk_elems=4096)
    init = space.flatten(params)
    cpu = torch.device("cpu")
    book: dict = {}
    filling = [True]  # the card run fills the book, the CPU run reads it

    def grad(flat, w, s):
        key = (w, s, hashlib.sha1(flat.cpu().numpy().tobytes()).hexdigest())
        if key not in book:
            if not filling[0]:
                raise AssertionError(
                    f"the CPU fabric pulled params for worker {w} step {s} "
                    "that the card fabric never pulled")
            b = next(lm_batches(cfg.vocab, 4, 32, seed=1000 * (w + 1) + s))
            _, g = lm_loss_and_grad(
                space.unflatten(flat), torch.from_numpy(b["tokens"]).to(dev),
                torch.from_numpy(b["labels"]).to(dev), cfg)
            book[key] = space.flatten(g).cpu()
        return book[key].to(flat.device)

    def run(d, config, speeds):
        fab = PBoxFabric(space, adamw(3e-3), init.to(d), config=config,
                         device=d)
        if speeds is not None:
            WorkerHarness(fab, lambda p, ws: space.unflatten(
                grad(space.flatten(p), *ws)), lambda w, s: (w, s),
                speed=speeds).run(ROUNDS)
        else:
            for s in range(ROUNDS):
                flats = [fab.pull(w) for w in range(4)]
                for w in range(4):
                    fab.push(w, grad(flats[w], w, s))
        return fab

    def bits_of(fab):
        efs = [r._uplink_ef for r in fab.rack_aggs] + [fab._core_ef] + [
            r._worker_ef[w] for r in fab.rack_aggs for w in r.members]
        return ([fab.params.cpu()]
                + [fab._assemble_rows(lambda sh, k=k: sh.state[k]).cpu()
                   for k in range(fab.spec.num_state_slots)]
                + [None if e is None else e.cpu() for e in efs])

    def stats_of(fab):
        return (dataclasses.asdict(fab.stats),
                [dataclasses.asdict(sh.stats) for sh in fab.shards],
                [dataclasses.asdict(r.stats) for r in fab.rack_aggs],
                [dataclasses.asdict(r.switch.stats) if r.switch else None
                 for r in fab.rack_aggs],
                dataclasses.asdict(fab.core_switch.stats)
                if fab.core_switch else None,
                fab.fault_trace)

    launches = {}
    offloads = {}
    c = space.num_chunks
    for codec in ("none", "bf16", "int8"):
        for mode, (fields, speeds) in TOPO_MODES.items():
            for variant in SWITCH_VARIANTS:
                slots = c - (variant == "starved")
                switch = (SwitchConfig() if variant == "off" else
                          SwitchConfig(enabled=True, tor_slots=slots,
                                       core_slots=slots))
                target = {"tor_fail": 0, "core_fail": RACKS}.get(variant)
                plan = (None if target is None else FaultPlan([
                    FaultEvent(2, "switch_fail", target),
                    FaultEvent(3, "switch_restore", target)]))
                config = FabricConfig(
                    num_shards=SHARDS, num_workers=4, **fields,
                    wire=WireConfig(topology=topology(4), switch=switch,
                                    compression=CompressionConfig(
                                        codec=codec)),
                    faults=FaultConfig(fault_plan=plan))
                book.clear()
                case = f"{codec}/{mode}/{variant}"
                filling[0] = True
                _zero_counts()
                got = run(dev, config, speeds)
                launches[case] = _counts()
                filling[0] = False
                ref = run(cpu, config, speeds)
                same = (stats_of(ref) == stats_of(got) and all(
                    (a is None and b is None) or same_bits(a, b)
                    for a, b in zip(bits_of(ref), bits_of(got))))
                if not same:
                    raise AssertionError(f"SMOKE topology {case}: the fabric "
                                         f"on {dev} differs from the CPU's")
                st = ref.stats
                offloads[case] = (st.switch_rounds, st.core_switch_rounds,
                                  st.switch_fallback_rounds)
                del got, ref
    book.clear()
    engaged = {k: v for k, v in offloads.items() if any(v)}
    if not engaged or not all(k.startswith("int8/") for k in engaged):
        raise AssertionError(f"switch offloads by case {offloads}")
    total = {k: sum(c[k] for c in launches.values())
             for k in next(iter(launches.values()))}
    log(f"smoke topology: {len(launches)} cases (codec x mode x switch, 4 "
        f"workers over {RACKS} racks, {SHARDS} shards, {ROUNDS} rounds), "
        f"{dev} == cpu bitwise in params, state, residuals, every stats "
        f"field and fault_trace; launches on {dev.type} {total}; (ToR, core, "
        f"fallback) switch rounds where a pool engaged {engaged}")
    return launches


# -- phases 15 and 16: the fault tier ----------------------------------------
FAULT_ROUNDS = 4
# the full-width run B's plan, (round, kind, target, factor): rack 1's link
# slows 3x after round 1, shard 1 crashes after round 2, the link is
# restored after round 3; the fabric reshards 4 -> 2 after round 3
FAULT_EVENTS = ((1, "link_degrade", 1, 3.0), (2, "shard_crash", 1, 1.0),
                (3, "link_restore", 1, 1.0))
RESHARD_AFTER, RESHARD_TO = 3, 2


def fault_plan(events):
    from repro_torch.core.replication import FaultEvent, FaultPlan

    return FaultPlan(FaultEvent(*e) for e in events)


def host_state(fab) -> list:
    """``fab``'s params and optimizer slots, assembled one at a time on its
    device, as host numpy copies."""
    out = [fab.params.to("cpu", copy=True).numpy()]
    fab._flat_cache = None
    for k in range(fab.spec.num_state_slots):
        out.append(fab._assemble_rows(lambda sh, k=k: sh.state[k]).to(
            "cpu", copy=True).numpy())
    return out


def state_digest(arrays: list) -> str:
    """SHA-1 over host arrays' bytes, in order (no copy)."""
    h = hashlib.sha1()
    for x in arrays:
        h.update(memoryview(x).cast("B"))
    return h.hexdigest()


def same_host_bits(a: list, b: list) -> bool:
    import numpy as np

    return len(a) == len(b) and all(
        x.shape == y.shape and np.array_equal(x.view(np.uint32),
                                              y.view(np.uint32))
        for x, y in zip(a, b))


def fault_rehearsal() -> dict:
    """Phase 15's schedule on the CPU at gemma3-1b's SMOKE config (the
    same workers, racks, shards, replication, plan and reshard): the fault
    trace the full-width run on the card must export."""
    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.core.chunking import ParamSpace
    from repro_torch.core.config import FabricConfig, FaultConfig, WireConfig
    from repro_torch.core.fabric import PBoxFabric
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.models.transformer import init_params, lm_loss_and_grad
    from repro_torch.optim.optimizers import adamw

    cfg = get_arch("gemma3-1b").smoke_config
    params = init_params(cfg, torch.Generator().manual_seed(0))
    space = ParamSpace.build(params, chunk_elems=4096)
    fab = PBoxFabric(space, adamw(3e-3), space.flatten(params), device="cpu",
                     config=FabricConfig(
                         num_shards=SHARDS, num_workers=2,
                         wire=WireConfig(topology=topology(2)),
                         faults=FaultConfig(replication=2, fault_plan=fault_plan(
                             FAULT_EVENTS))))

    for s in range(FAULT_ROUNDS):
        for w in range(2):
            b = next(lm_batches(cfg.vocab, 4, 32, seed=1000 * (w + 1) + s))
            _, g = lm_loss_and_grad(
                space.unflatten(fab.pull(w)), torch.from_numpy(b["tokens"]),
                torch.from_numpy(b["labels"]), cfg)
            fab.push(w, space.flatten(g))
        if s + 1 == RESHARD_AFTER:
            fab.reshard(RESHARD_TO)
    return fab.export_fault_trace()


def failover_path(dev, gw: GemmaWorkers, rehearsal: dict) -> dict:
    """Phase 15: failover and reshard at full width.  2 workers, one in
    each of 2 racks (1:4 core), codec none, AdamW, 4 shards, 4 rounds.

    Run A: replication 1, fault-free; it must build no chain.  Run B:
    replication 2 (every chain hop crosses the core) under FAULT_EVENTS,
    and ``reshard(2)`` at the edge after round 3.  After round 4 B's
    params and both AdamW slots must equal A's bitwise (both kept on the
    host), B's losses A's, and B's exported fault trace the CPU
    rehearsal's.  The byte counters must equal the arithmetic: one chain
    hop of the whole state (params + 2 slots, raw f32) a round, one
    re-silver of shard 1's slab, and both on the core link on top of A's
    training streams.  Times each round, each chain pass (CUDA events
    around ``_replicate_round``), the failover (host clock and events
    around ``crash_shard``) and the reshard (host clock), and the peaks."""
    import time as _time

    import numpy as np
    import torch

    from repro_torch.core.config import FaultConfig

    space = gw.space
    state_bytes = 4 * space.flat_elems * 3  # params + AdamW's 2 slots
    shard1 = len(np.array_split(np.arange(space.num_chunks), SHARDS)[1])
    resilver_bytes = 4 * 3 * shard1 * space.chunk_elems
    name = torch.cuda.get_device_name(dev)
    topo = topology(2)

    def retries():
        """The caching allocator's retries so far (each frees its cached
        blocks and waits for the card)."""
        return torch.cuda.memory_stats(dev).get("num_alloc_retries", 0)

    memory = PathMemory(dev)
    fab = gw.fabric(2, topology=topo)
    retries_a = retries()
    _zero_counts()  # run A's counts to 0 just before it...
    round_a = [timed(lambda s=s: gw.round(fab, s))
               for s in range(FAULT_ROUNDS)]
    launches_a = _counts()  # ...and read just after
    peak_a = memory.now()[1]
    retries_a = retries() - retries_a
    losses_a = gw.finite_losses()
    if fab.replicas or fab.stats.bytes_replication:
        raise AssertionError("a replication-1 fabric built a chain")
    core_a = fab.stats.bytes_core_link
    want = host_state(fab)
    digest_a = state_digest(want)  # phase 23's fixed-layout reference
    del fab
    torch.cuda.empty_cache()
    _check_counts("failover run A", launches_a,
                  {"fused_agg_opt": SHARDS * FAULT_ROUNDS})

    memory = PathMemory(dev)
    fab = gw.fabric(2, topology=topo, faults=FaultConfig(
        replication=2, fault_plan=fault_plan(FAULT_EVENTS)))
    provisioned = memory.now()[0]
    chain_events: list = []
    replicate = fab._replicate_round

    def timed_replicate():
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        replicate()
        end.record()
        chain_events.append((start, end))

    failover: dict = {}
    crash = fab.crash_shard

    def timed_crash(shard_id):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        before = torch.cuda.memory_allocated(dev)
        torch.cuda.synchronize()
        t0 = _time.perf_counter()
        start.record()
        action = crash(shard_id)
        end.record()
        torch.cuda.synchronize()
        failover.update(host_ms=(_time.perf_counter() - t0) * 1e3,
                        device_ms=start.elapsed_time(end),
                        allocated=torch.cuda.memory_allocated(dev) - before)
        return action

    fab._replicate_round = timed_replicate
    fab.crash_shard = timed_crash
    retries_b = [retries()]
    _zero_counts()  # run B's counts to 0 just before it...
    round_b = []
    for s in range(FAULT_ROUNDS):
        round_b.append(timed(lambda s=s: gw.round(fab, s)))
        retries_b.append(retries())
        if s + 1 == RESHARD_AFTER:
            launches_edge = _counts()
            memory.hold(0)  # the reshard's own peak from here
            reshard_ms = timed(lambda: fab.reshard(RESHARD_TO))
            reshard_peak = torch.cuda.max_memory_allocated(dev)
    launches_b = _counts()  # ...and read just after
    peak_b = memory.now()[1]
    losses_b = gw.finite_losses()
    chain_ms = [a.elapsed_time(b) for a, b in chain_events]
    st = fab.stats
    trace = fab.export_fault_trace()
    got = host_state(fab)
    # the timing wrappers close over fab's bound methods: a reference
    # cycle that would keep run B's state and chain on the card
    del fab._replicate_round, fab.crash_shard, fab
    torch.cuda.empty_cache()
    if not same_host_bits(want, got):
        raise AssertionError(
            "failover run B differs from the fault-free run A, max |err| "
            + str([float(np.max(np.abs(a - b))) for a, b in zip(want, got)]))
    del want, got
    if losses_b != losses_a:
        raise AssertionError(f"run B's losses {losses_b}, run A's {losses_a}")
    if trace != rehearsal:
        raise AssertionError(f"run B's fault trace {trace}, the CPU "
                             f"rehearsal's {rehearsal}")
    want_stats = dict(failovers=1, resilvers=1, rescales=1,
                      shards_crashed=1, link_degrades=1,
                      replication_rounds=FAULT_ROUNDS,
                      bytes_replication=FAULT_ROUNDS * state_bytes,
                      bytes_resilver=resilver_bytes,
                      bytes_core_link=core_a + FAULT_ROUNDS * state_bytes
                      + resilver_bytes)
    got_stats = {k: getattr(st, k) for k in want_stats}
    if got_stats != want_stats:
        raise AssertionError(f"failover run B stats {got_stats}, expected "
                             f"{want_stats}")
    _check_counts("failover run B to the reshard", launches_edge,
                  {"fused_agg_opt": SHARDS * RESHARD_AFTER})
    _check_counts("failover run B", launches_b, {
        "fused_agg_opt": SHARDS * RESHARD_AFTER
        + RESHARD_TO * (FAULT_ROUNDS - RESHARD_AFTER)})
    chain_bound = bound(name, 2 * state_bytes, 0)["bound_ms"]
    resilver_bound = bound(name, 2 * resilver_bytes, 0)["bound_ms"]
    log(f"failover path: {gw.cfg.name}, 2 workers over {RACKS} racks (core "
        f"1:{OVERSUB:g}), codec none, AdamW, {SHARDS} shards, "
        f"{FAULT_ROUNDS} rounds; run B replication 2 under "
        f"{list(FAULT_EVENTS)}, reshard {SHARDS} -> {RESHARD_TO} after round "
        f"{RESHARD_AFTER}")
    log(f"  run A (R = 1): round wall ms {[round(x, 1) for x in round_a]}; "
        f"launches {launches_a}; no chain; peak device memory {peak_a} "
        f"bytes ({peak_a / 2**30:.2f} GiB); allocator retries {retries_a}")
    log(f"  run B (R = 2): round wall ms {[round(x, 1) for x in round_b]}; "
        f"launches {launches_b}; chain provisioned at construction, "
        f"{provisioned} bytes allocated ({provisioned / 2**30:.2f} GiB); "
        f"peak device memory {peak_b} bytes ({peak_b / 2**30:.2f} GiB); "
        f"allocator retries by round "
        f"{[b - a for a, b in zip(retries_b, retries_b[1:])]}")
    log(f"  chain pass (_replicate_round, CUDA events) ms "
        f"{[round(x, 3) for x in chain_ms]} for {state_bytes} bytes a round "
        f"(bound {chain_bound:.3f} ms, {name})")
    log(f"  failover of shard 1 (promote, re-silver {resilver_bytes} bytes): "
        f"host {failover['host_ms']:.3f} ms, device {failover['device_ms']:.3f}"
        f" ms (re-silver bound {resilver_bound:.3f} ms), {failover['allocated']}"
        f" bytes allocated")
    log(f"  reshard {SHARDS} -> {RESHARD_TO}: {reshard_ms:.1f} ms host, peak "
        f"device memory during it {reshard_peak} bytes "
        f"({reshard_peak / 2**30:.2f} GiB)")
    log(f"  run B == run A bitwise (params, both AdamW slots); losses "
        f"{losses_b}; fault trace == the CPU rehearsal's "
        f"{[t['action'] for t in trace['trace']]}; bytes replication "
        f"{st.bytes_replication}, resilver {st.bytes_resilver}, core link "
        f"{st.bytes_core_link} (run A {core_a})")
    if failover["allocated"] > 0:
        raise AssertionError(f"the failover allocated {failover['allocated']} "
                             "bytes")
    return {"launches_a": launches_a, "launches_b": launches_b,
            "round_ms_a": round_a, "round_ms_b": round_b,
            "chain_ms": chain_ms, "chain_bound_ms": chain_bound,
            "failover": failover, "resilver_bound_ms": resilver_bound,
            "reshard_ms": reshard_ms, "reshard_peak_bytes": reshard_peak,
            "peak_a": peak_a, "peak_b": peak_b, "digest_a": digest_a,
            "losses_a": losses_a}


def smoke_fault_check(dev) -> dict:
    """Phase 16: the fault tier at gemma3-1b's SMOKE config, 4 workers, 4
    shards, 3 rounds, the fabric on ``dev`` against the fabric on the CPU,
    bitwise in params, state, residuals, every stats field, ``fault_trace``
    and ``export_fault_trace()``: codec (none, bf16, int8) x replication
    (1: ``ShardLost`` on both; 2; 3, with the same shard crashing again the
    next round) x racks (1; 2 with a 1:4 core) x a shard crash after round
    1 or round 2; a worker crash after round 1 with its re-entry through
    ``runtime/elastic.worker_reentry`` before round 3 (2 racks, R = 2);
    and a SparseTier attached to an R = 2 fabric without topology (int8
    rows, a table of 4096 x 32), shard 1 crashing after round 2, its
    lookups through ``embedding_bag`` compared too.  Each shard-crash case
    on the card also equals the card's fault-free run.  Gradients are
    booked on the card by (worker, step, digest of the pulled params) and
    replayed on the CPU, as in phase 14.  Returns each case's launches on
    ``dev``."""
    import numpy as np
    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.core.chunking import ParamSpace
    from repro_torch.core.compression import CompressionConfig
    from repro_torch.core.config import FabricConfig, FaultConfig, WireConfig
    from repro_torch.core.fabric import PBoxFabric
    from repro_torch.core.replication import ShardLost
    from repro_torch.core.sparse import SparseTier
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.models.transformer import init_params, lm_loss_and_grad
    from repro_torch.optim.optimizers import adamw
    from repro_torch.runtime.elastic import worker_reentry

    cfg = get_arch("gemma3-1b").smoke_config
    params = init_params(cfg, torch.Generator().manual_seed(0))
    space = ParamSpace.build(params, chunk_elems=4096)
    init = space.flatten(params)
    cpu = torch.device("cpu")
    book: dict = {}
    filling = [True]  # the card runs fill the book, the CPU runs read it

    def grad(flat, w, s):
        key = (w, s, hashlib.sha1(flat.cpu().numpy().tobytes()).hexdigest())
        if key not in book:
            if not filling[0]:
                raise AssertionError(
                    f"the CPU fabric pulled params for worker {w} step {s} "
                    "that the card fabric never pulled")
            b = next(lm_batches(cfg.vocab, 4, 32, seed=1000 * (w + 1) + s))
            _, g = lm_loss_and_grad(
                space.unflatten(flat), torch.from_numpy(b["tokens"]).to(dev),
                torch.from_numpy(b["labels"]).to(dev), cfg)
            book[key] = space.flatten(g).cpu()
        return book[key].to(flat.device)

    def build(d, codec, racks, replication=1, events=()):
        return PBoxFabric(space, adamw(3e-3), init.to(d), device=d,
                          config=FabricConfig(
                              num_shards=SHARDS, num_workers=4,
                              wire=WireConfig(
                                  topology=topology(4) if racks > 1 else None,
                                  compression=CompressionConfig(codec=codec)),
                              faults=FaultConfig(
                                  replication=replication,
                                  fault_plan=fault_plan(events)
                                  if events else None)))

    def drive(fab, reentry=None, tier=None, lookups=None):
        """ROUNDS rounds: the alive workers pull, then push; ``reentry``
        (round, worker) re-admits a crashed worker at that round's start;
        with a ``tier`` each worker first pushes sparse rows and looks a
        jagged batch up.  Returns the ShardLost a crash raised, as text."""
        try:
            for s in range(ROUNDS):
                if reentry is not None and s == reentry[0]:
                    worker_reentry(fab, reentry[1])
                alive = [w for w in range(4) if fab.alive(w)]
                if tier is not None:
                    for w in alive:
                        rng = np.random.default_rng((s, w))
                        ids = rng.integers(0, 4096, size=64)
                        rows = rng.standard_normal((64, 32)).astype(
                            np.float32)
                        tier.push(w, {"t0": (ids, torch.from_numpy(rows).to(
                            fab.device))})
                        offsets = np.arange(0, 65, 4)
                        lookups.append(tier.lookup(w, "t0", ids, offsets).cpu())
                flats = {w: fab.pull(w) for w in alive}
                for w in alive:
                    fab.push(w, grad(flats[w], w, s))
        except ShardLost as e:
            return f"{type(e).__name__}: {e}"
        return None

    def bits_of(fab):
        efs = ([r._uplink_ef for r in fab.rack_aggs]
               + [r._worker_ef[w] for r in fab.rack_aggs for w in r.members]
               + [fab._worker_ef[w] for w in sorted(fab._worker_ef)])
        return ([fab.params.cpu()]
                + [fab._assemble_rows(lambda sh, k=k: sh.state[k]).cpu()
                   for k in range(fab.spec.num_state_slots)]
                + [None if e is None else e.cpu() for e in efs])

    def stats_of(fab):
        return (dataclasses.asdict(fab.stats),
                [dataclasses.asdict(sh.stats) for sh in fab.shards],
                [dataclasses.asdict(r.stats) for r in fab.rack_aggs],
                fab.fault_trace, fab.export_fault_trace(),
                sorted(fab.dead_workers), fab.worker_clock.tolist())

    def same(a, b):
        return all((x is None and y is None) or same_bits(x, y)
                   for x, y in zip(a, b))

    cases = []
    for codec in ("none", "bf16", "int8"):
        for racks in (1, 2):
            for r in (1, 2, 3):
                for at in (1, 2):
                    events = [(at, "shard_crash", at)]
                    if r == 3:  # the same shard again, the next round
                        events.append((at + 1, "shard_crash", at))
                    cases.append((f"{codec}/racks{racks}/R{r}/crash{at}",
                                  codec, racks, r, events, None))
        cases.append((f"{codec}/racks2/R2/worker_reentry", codec, 2, 2,
                      [(1, "worker_crash", 3)], (2, 3)))
    launches: dict = {}
    bases: dict = {}
    lost = 0
    for case, codec, racks, r, events, reentry in cases:
        if (codec, racks) not in bases:
            filling[0] = True
            base = build(dev, codec, racks)
            drive(base)
            bases[(codec, racks)] = bits_of(base)[:3]
            del base
        filling[0] = True
        _zero_counts()
        got = build(dev, codec, racks, r, events)
        err = drive(got, reentry)
        launches[case] = _counts()
        filling[0] = False
        ref = build(cpu, codec, racks, r, events)
        ref_err = drive(ref, reentry)
        if (err, stats_of(got)) != (ref_err, stats_of(ref)) or not same(
                bits_of(ref), bits_of(got)):
            raise AssertionError(f"SMOKE fault {case}: the fabric on {dev} "
                                 f"differs from the CPU's ({err} / {ref_err})")
        if (r == 1) != (err is not None):
            raise AssertionError(f"SMOKE fault {case}: raised {err}")
        lost += err is not None
        if reentry is None and err is None:
            if not same(bases[(codec, racks)], bits_of(got)[:3]):
                raise AssertionError(f"SMOKE fault {case}: the failover "
                                     "differs from the fault-free run")
            if got.stats.failovers != len(events):
                raise AssertionError(f"SMOKE fault {case}: "
                                     f"{got.stats.failovers} failovers")
        del got, ref
    # the sparse tier attached to a replicated fabric, fault-free and not
    table = np.random.default_rng(7).standard_normal((4096, 32)).astype(
        np.float32)
    runs = {}
    for label, d, events in (("base", dev, ()),
                             ("card", dev, [(2, "shard_crash", 1)]),
                             ("cpu", cpu, [(2, "shard_crash", 1)])):
        filling[0] = d != cpu
        _zero_counts()
        fab = build(d, "none", 1, 2, events)
        tier = SparseTier(fabric=fab, codec="int8", lr=0.05)
        tier.add_table("t0", table)
        outs: list = []
        if drive(fab, tier=tier, lookups=outs) is not None:
            raise AssertionError("SMOKE sparse failover raised")
        if label == "card":
            launches["none/racks1/R2/sparse_tier"] = _counts()
        runs[label] = (bits_of(fab)[:3], tier.table("t0").cpu(),
                       tier.row_versions("t0"),
                       dataclasses.asdict(tier.stats), outs,
                       tier.replication, stats_of(fab))
        del fab, tier
    (bb, bt, bv, _, bo, _, _), card, ref = (runs["base"], runs["card"],
                                            runs["cpu"])
    if not (same(card[0], ref[0]) and same_bits(card[1], ref[1])
            and np.array_equal(card[2], ref[2]) and card[3] == ref[3]
            and same(card[4], ref[4]) and card[6] == ref[6]):
        raise AssertionError(f"SMOKE sparse failover: {dev} differs from "
                             "the CPU")
    if not (same(card[0], bb) and same_bits(card[1], bt)
            and np.array_equal(card[2], bv) and same(card[4], bo)):
        raise AssertionError("SMOKE sparse failover differs from its "
                             "fault-free run")
    if card[5] != 2 or card[3]["failovers"] != 1:
        raise AssertionError(f"SMOKE sparse tier stats {card[3]}")
    book.clear()
    total = {k: sum(c[k] for c in launches.values())
             for k in next(iter(launches.values()))}
    log(f"smoke faults: {len(launches)} cases (codec x R x racks x crash "
        f"round, worker re-entry, a SparseTier failover; 4 workers, "
        f"{SHARDS} shards, {ROUNDS} rounds), {dev} == cpu bitwise in params, "
        f"state, residuals, every stats field and the fault traces; each "
        f"failover == its fault-free run; {lost} ShardLost at R = 1 on both; "
        f"launches on {dev.type} {total}")
    return launches


# -- phases 17 and 18: the tenancy tier ---------------------------------------
TENANT_ROUNDS = 3
# the full-width tenants: name -> (init seed, fair-share priority, the base
# of its batch seeds)
FULL_TENANTS = {"a": (0, 2.0, 0), "b": (1, 1.0, 500_000)}


class Tenant:
    """One gemma3-1b tenant of phase 17: its JobSpec (seeded weights on the
    card, AdamW 3e-3, 2 workers, codec none, R = 1) and a worker gradient
    that is a function of the pulled params and (worker, step) alone, with
    the tenant's own batch seeds."""

    def __init__(self, dev, cfg, name: str):
        import torch

        from repro_torch.core.tenancy import JobSpec
        from repro_torch.models.transformer import init_params
        from repro_torch.optim.optimizers import adamw

        seed, priority, self.batch_base = FULL_TENANTS[name]
        self.dev, self.cfg = dev, cfg
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed))
        self.spec = JobSpec(name=name, params=params, optimizer=adamw(3e-3),
                            num_workers=WORKERS, priority=priority)
        self.losses: list = []

    def grad(self, params: dict, ws: tuple) -> dict:
        import torch

        from repro_torch.data.synthetic import lm_batches
        from repro_torch.models.transformer import lm_loss_and_grad

        w, s = ws
        b = next(lm_batches(self.cfg.vocab, 1, SEQ,
                            seed=self.batch_base + 1000 * (w + 1) + s))
        loss, g = lm_loss_and_grad(
            params, torch.from_numpy(b["tokens"]).to(self.dev),
            torch.from_numpy(b["labels"]).to(self.dev), self.cfg)
        self.losses.append(loss)
        return g

    def harness(self, server, steps_done: int = 0):
        """A WorkerHarness over ``server`` whose workers have done
        ``steps_done`` steps (a re-attached job resumes its batches)."""
        from repro_torch.core.fabric import WorkerHarness

        h = WorkerHarness(server, self.grad, lambda w, s: (w, s))
        h.steps_done = [steps_done] * WORKERS
        return h

    def finite_losses(self) -> list:
        return finite_losses(self.losses)


def tick(harness) -> tuple:
    """One tenant round (each worker pulls, computes and pushes; the last
    push fires the round): (host ms, the round's ``sim_wire_us``)."""
    st = harness.server.stats
    before = st.sim_wire_us
    ms = timed(harness.tick)
    return ms, st.sim_wire_us - before


def slabs(fab) -> list:
    """Each shard's (chunk ids, params, optimizer slots): references to the
    tensors the kernels write, for a comparison on the card."""
    return [(sh.chunk_ids, sh.params, *sh.state) for sh in fab.shards]


def same_slabs(a: list, b: list) -> bool:
    import numpy as np

    return len(a) == len(b) and all(
        np.array_equal(x[0], y[0]) and len(x) == len(y)
        and all(same_bits(p, q) for p, q in zip(x[1:], y[1:]))
        for x, y in zip(a, b))


def tenancy_path(dev) -> dict:
    """Phase 17: two gemma3-1b tenants at full width on one shared box
    (``MultiJobFabric``: 4 shards, 2 racks, 1:4 core), each 2 workers (one
    a rack), AdamW, codec none, R = 1: ``a`` (init seed 0, priority 2) and
    ``b`` (init seed 1, priority 1, its own batch seeds).  Their workers
    interleave tick by tick.  Rounds 1-2 with both attached; ``detach("b")``
    (a host snapshot); ``a``'s round 3 alone; ``a``'s dedicated twin
    (``dedicated_fabric``, 3 rounds, the same batches) is compared with
    ``a``'s slabs on the card; ``b`` re-attaches from its snapshot (its
    namespace [2c, 3c)) and runs its round 3; then the box is released and
    ``b``'s twin compared with ``b``'s slabs.  Checks: 24 box
    ``fused_agg_opt`` launches and no codec launch, 12 each twin; params,
    m, v, losses and pushed / pulled bytes of each tenant equal its twin's;
    a round adds 1.5x ``a``'s dedicated ``sim_wire_us`` and 3.0x ``b``'s
    while both are attached, 1.0x for ``a`` alone (to 1e-12 relative);
    ``a``'s simulated step time under ``b``'s; both tenants on every link
    and every shard; ``route`` of global ids in each namespace.  Times each
    round (host clock around synchronized work), the detach and the
    re-attach, with the peaks."""
    import gc

    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.core import fabric as fabric_mod
    from repro_torch.core.tenancy import MultiJobFabric, dedicated_fabric

    cfg = get_arch("gemma3-1b").config
    name = torch.cuda.get_device_name(dev)
    gc.collect()
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated(dev)  # what earlier phases left
    ta, tb = Tenant(dev, cfg, "a"), Tenant(dev, cfg, "b")
    torch.cuda.empty_cache()
    layout = dict(num_shards=SHARDS, num_racks=RACKS,
                  oversubscription=OVERSUB, device=dev)
    box = MultiJobFabric(**layout)
    memory = PathMemory(dev)
    ha, hb = box.attach(ta.spec), box.attach(tb.spec)
    c = ha.space.num_chunks
    harnesses = {"a": ta.harness(ha), "b": tb.harness(hb)}
    shared_ms = {"a": [], "b": []}
    wire = {"a": [], "b": []}
    _zero_counts()  # the box's counts to 0 just before its rounds...
    for _ in range(2):
        for label in ("a", "b"):
            ms, us = tick(harnesses[label])
            shared_ms[label].append(ms)
            wire[label].append(us)
    space_b, steps_b = hb.space, harnesses["b"].steps_done[0]
    stats_b = dataclasses.replace(hb.stats)
    snap_b: dict = {}
    detach_ms = timed(lambda: snap_b.update(box.detach("b")))
    snap_bytes = snap_b["params"].nbytes + sum(s.nbytes
                                               for s in snap_b["state"])
    # nothing may keep b's detached fabric: its slabs leave the card here
    del hb, harnesses["b"]
    gc.collect()
    torch.cuda.empty_cache()
    wa = harnesses.pop("a")
    ms, us = tick(wa)
    shared_ms["a"].append(ms)
    wire["a"].append(us)
    launches = _counts()  # ...read before a's twin...
    peak_shared = memory.now()[1]
    scales_alone = box.wire_scales(ha.fabric)

    def twin(t, steps):
        """``t``'s dedicated fabric (the box's layout, no co-tenant), run
        ``steps`` rounds: the fabric, its launches, round times, wire
        increments and peak."""
        mem = PathMemory(dev)
        ded = dedicated_fabric(t.spec, MultiJobFabric(**layout))
        h = t.harness(ded)
        _zero_counts()
        rounds = [tick(h) for _ in range(steps)]
        return (ded, _counts(), [r[0] for r in rounds],
                [r[1] for r in rounds], mem.now()[1])

    ded_a, twin_a_launches, ded_ms_a, ded_wire_a, peak_twin_a = twin(
        ta, TENANT_ROUNDS)
    losses_a = ta.finite_losses()
    same_a = same_slabs(slabs(ha.fabric), slabs(ded_a))
    bytes_a = [(f.stats.bytes_pushed, f.stats.bytes_pulled)
               for f in (ha.fabric, ded_a)]
    del ded_a
    torch.cuda.empty_cache()

    restore_ms: list = []
    restore = fabric_mod.PBoxFabric.restore

    def timed_restore(fab, snap):
        restore_ms.append(timed(lambda: restore(fab, snap)))

    memory = PathMemory(dev)
    fabric_mod.PBoxFabric.restore = timed_restore
    try:
        attach_ms = timed(lambda: box.attach(tb.spec, snapshot=snap_b,
                                             snapshot_space=space_b))
    finally:
        fabric_mod.PBoxFabric.restore = restore
    hb = box.jobs["b"]
    wb = tb.harness(hb, steps_b)
    _zero_counts()  # ...and to 0 again for b's round 3, read just after
    ms, us = tick(wb)
    launches = {k: v + _counts()[k] for k, v in launches.items()}
    shared_ms["b"].append(ms)
    wire["b"].append(us)
    peak_shared = max(peak_shared, memory.now()[1])
    util, occupancy = box.utilization(), box.shard_occupancy()
    per_shard = c // SHARDS
    routes = {g: box.route(g) for g in (0, c // 2, c - 1, 2 * c,
                                        2 * c + c // 2 + 1, 3 * c - 1)}
    want_routes = {g: (("a" if g < c else "b"),
                       (g - (0 if g < c else 2 * c)) // per_shard)
                   for g in routes}
    stale_route = None
    try:
        box.route(c)  # b's first range: never reused, now unrouted
    except KeyError as e:
        stale_route = str(e)
    step_us = (ha.sim_step_time_us(), hb.sim_step_time_us())
    chunk_base_b = hb.chunk_base
    describe = box.describe()
    final_b = slabs(hb.fabric)
    bytes_b = (stats_b.bytes_pushed + hb.stats.bytes_pushed,
               stats_b.bytes_pulled + hb.stats.bytes_pulled)
    # release the box (and a's slabs and weights with it): only b's final
    # slabs stay
    del ha, hb, wa, wb, box, ta
    gc.collect()
    torch.cuda.empty_cache()
    ded_b, twin_b_launches, ded_ms_b, ded_wire_b, peak_twin_b = twin(
        tb, TENANT_ROUNDS)
    losses_b = tb.finite_losses()
    same_b = same_slabs(final_b, slabs(ded_b))
    bytes_b = [bytes_b, (ded_b.stats.bytes_pushed, ded_b.stats.bytes_pulled)]
    del ded_b, final_b, tb, snap_b
    gc.collect()
    torch.cuda.empty_cache()

    log(f"tenancy path: {cfg.name} x 2 tenants on one MultiJobFabric "
        f"({SHARDS} shards, {RACKS} racks, core 1:{OVERSUB:g}), each "
        f"{WORKERS} workers (one a rack), AdamW, codec none, R = 1; a "
        f"(seed 0, priority 2), b (seed 1, priority 1); c = {c} chunks a "
        f"tenant; {resident} bytes allocated before the phase")
    log(f"  round wall ms, shared box: a {[round(x, 1) for x in shared_ms['a']]}"
        f" (round 3 alone), b {[round(x, 1) for x in shared_ms['b']]} (round "
        f"3 re-attached); dedicated: a {[round(x, 1) for x in ded_ms_a]}, b "
        f"{[round(x, 1) for x in ded_ms_b]} ({name})")
    log(f"  detach b (D2H snapshot of {snap_bytes} bytes) {detach_ms:.1f} ms;"
        f" re-attach b {attach_ms:.1f} ms, of which the restore (H2D) "
        f"{restore_ms[0]:.1f} ms; b's namespace [{chunk_base_b}, "
        f"{chunk_base_b + c})")
    log(f"  peak device memory: shared run {peak_shared} bytes "
        f"({peak_shared / 2**30:.2f} GiB), a's twin {peak_twin_a} "
        f"({peak_twin_a / 2**30:.2f} GiB, a's shared slabs resident), b's "
        f"twin {peak_twin_b} ({peak_twin_b / 2**30:.2f} GiB, b's final slabs "
        f"resident)")
    log(f"  launches: box {launches}, twins {twin_a_launches} / "
        f"{twin_b_launches}; losses a {losses_a[-WORKERS:]}, b "
        f"{losses_b[-WORKERS:]} (last round)")
    log(f"  sim_wire_us a round, shared / dedicated: a "
        f"{[x / y for x, y in zip(wire['a'], ded_wire_a)]}, b "
        f"{[x / y for x, y in zip(wire['b'], ded_wire_b)]}; sim step us a "
        f"{step_us[0]:.1f} < b {step_us[1]:.1f}; contention "
        + ", ".join(f"{k} x{v['contention_factor']:.3f}"
                    for k, v in util.items()))

    _check_counts("tenancy box", launches,
                  {"fused_agg_opt": 2 * SHARDS * TENANT_ROUNDS})
    _check_counts("tenancy twin a", twin_a_launches,
                  {"fused_agg_opt": SHARDS * TENANT_ROUNDS})
    _check_counts("tenancy twin b", twin_b_launches,
                  {"fused_agg_opt": SHARDS * TENANT_ROUNDS})
    if not (same_a and same_b):
        raise AssertionError(f"tenancy: a shared tenant differs from its "
                             f"dedicated twin (a {same_a}, b {same_b})")
    for label, losses in (("a", losses_a), ("b", losses_b)):
        half = WORKERS * TENANT_ROUNDS
        if len(losses) != 2 * half or losses[:half] != losses[half:]:
            raise AssertionError(f"tenant {label}: shared losses "
                                 f"{losses[:half]}, twin's {losses[half:]}")
    if bytes_a[0] != bytes_a[1] or bytes_b[0] != bytes_b[1]:
        raise AssertionError(f"tenancy bytes (pushed, pulled) a {bytes_a}, "
                             f"b {bytes_b}")
    want = {"a": [1.5, 1.5, 1.0], "b": [3.0, 3.0, 3.0]}
    for label, ded in (("a", ded_wire_a), ("b", ded_wire_b)):
        for got, base, k in zip(wire[label], ded, want[label]):
            if abs(got - k * base) > 1e-12 * k * base:
                raise AssertionError(
                    f"tenant {label}: sim_wire_us {wire[label]} against the "
                    f"twin's {ded}, expected x{want[label]}")
    if scales_alone != (1.0, 1.0) or not step_us[0] < step_us[1]:
        raise AssertionError(f"fair share: a alone {scales_alone}, sim step "
                             f"us {step_us}")
    for link in [f"rack{r}" for r in range(RACKS)] + ["core"]:
        u = util[link]
        if set(u["by_job"]) != {"a", "b"} or not u["contention_factor"] > 1:
            raise AssertionError(f"tenancy link {link}: {u}")
    if occupancy != [{"a": per_shard, "b": per_shard}] * SHARDS:
        raise AssertionError(f"tenancy shard occupancy {occupancy}")
    if routes != want_routes or stale_route is None or chunk_base_b != 2 * c:
        raise AssertionError(f"tenancy routes {routes} (want {want_routes}), "
                             f"stale {stale_route}, b at {chunk_base_b}")
    log(f"  a == its dedicated twin and b == its twin bitwise (params, m, v)"
        f" across b's detach and re-attach; losses and bytes equal; "
        f"fair-share x1.5 / x3.0 / x1.0 exact; both tenants on "
        f"{sorted(util)} and on every shard ({per_shard} chunks each); "
        f"routes {routes}")
    log("  " + describe.replace("\n", "\n  "))
    return {"launches": launches, "shared_ms": shared_ms, "dedicated_ms": {"a": ded_ms_a,
                                                     "b": ded_ms_b},
            "detach_ms": detach_ms, "attach_ms": attach_ms,
            "snapshot_bytes": snap_bytes,
            "restore_ms": restore_ms[0], "peak_shared": peak_shared,
            "peak_twin_a": peak_twin_a, "peak_twin_b": peak_twin_b,
            "twin_launches": {k: twin_a_launches[k] + twin_b_launches[k]
                              for k in twin_a_launches}}


def _residuals(fab) -> list:
    """Every codec error-feedback residual of ``fab`` (None where a stage
    keeps none), in a fixed order: rack uplinks, the core, the rack-side
    worker NICs, the fabric's worker NICs."""
    return ([r._uplink_ef for r in fab.rack_aggs] + [fab._core_ef]
            + [r._worker_ef[w] for r in fab.rack_aggs for w in r.members]
            + [fab._worker_ef[w] for w in sorted(fab._worker_ef)])


class PlainCalls:
    """Counts the calls of each kernel's plain version while the block
    runs (module attributes, swapped in and restored): what a CPU run
    does in place of the card's launches."""

    NAMES = {"fused_agg_opt": ("fused_agg_opt", "fused_agg_opt_torch"),
             "quantize_chunks": ("quant", "quantize_chunks_torch"),
             "dequantize_chunks": ("quant", "dequantize_chunks_torch"),
             "wire_fused": ("wire_path", "wire_fused_torch"),
             "embedding_bag": ("embedding_bag", "embedding_bag_torch"),
             "segment_sum": ("embedding_bag", "segment_sum_torch")}

    def __enter__(self):
        import importlib

        self.counts = {k: 0 for k in _counts()}
        self.saved = []
        for key, (pkg, attr) in self.NAMES.items():
            mod = importlib.import_module(f"repro_torch.kernels.{pkg}.kernel")
            fn = getattr(mod, attr)

            def counted(*a, fn=fn, key=key, **kw):
                self.counts[key] += 1
                return fn(*a, **kw)

            self.saved.append((mod, attr, fn))
            setattr(mod, attr, counted)
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in self.saved:
            setattr(mod, attr, fn)


def smoke_tenancy_check(dev) -> dict:
    """Phase 18: the tenancy tier at gemma3-1b's SMOKE config, each box on
    ``dev`` against the same box on the CPU, bitwise in every tenant's
    params, state and residuals, every ServerStats / ShardStats /
    RackStats / SwitchStats field, the fault traces, and the box's
    ``utilization()``, ``shard_occupancy()``, routes, telemetry and
    ``describe()``.  Cases: 1, 2 and 3 tenants (2 workers each; seeds,
    optimizers and priorities differ) x shards (1, 4) x racks (1, 2) x
    codec (none, bf16, int8); a sync, a 3-of-4 quorum and an SSP tenant
    (4 workers each, 4 shards, 2 racks); int8 tenants under switch pools
    of one tenant's chunk count (the first granted, the second refused,
    the grant returned at detach and handed to the next attach); a
    box-wide ``crash_shard`` with an R = 1 tenant attached before an R = 2
    one (``ShardLost`` raised after the R = 2 tenant's failover); a detach
    from a 4-shard box re-attached onto a 3-shard one through
    ``elastic_restore``; ``apply_tenant_shares`` and a ``tenant_shares``
    plan delta in mid-run.  Each tenant also equals its
    ``dedicated_fabric`` twin on the card.  Gradients are booked on the
    card by (tenant, worker, step, digest of the pulled params) and
    replayed on the CPU, as in phases 14 and 16; the card's launches of
    each case must equal the CPU run's calls of the plain versions.
    Returns each case's launches on ``dev``."""
    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.core.chunking import ParamSpace
    from repro_torch.core.fabric import WorkerHarness
    from repro_torch.core.placement import PlanDelta
    from repro_torch.core.replication import ShardLost
    from repro_torch.core.tenancy import (
        JobSpec,
        MultiJobFabric,
        dedicated_fabric,
    )
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.models.transformer import init_params, lm_loss_and_grad
    from repro_torch.optim.optimizers import adamw, momentum, sgd

    cfg = get_arch("gemma3-1b").smoke_config
    trees = [init_params(cfg, torch.Generator().manual_seed(seed))
             for seed in range(3)]
    flat_space = ParamSpace.build(trees[0], chunk_elems=4096)
    optimizers = (adamw(3e-3), momentum(0.05, 0.9), sgd(0.01))
    cpu = torch.device("cpu")
    book: dict = {}
    filling = [True]  # the card runs fill the book, the CPU runs read it

    def grad(tenant, seed, params, ws):
        w, s = ws
        flat = flat_space.flatten(params)
        key = (tenant, w, s,
               hashlib.sha1(flat.cpu().numpy().tobytes()).hexdigest())
        if key not in book:
            if not filling[0]:
                raise AssertionError(
                    f"the CPU box pulled params for tenant {tenant} worker "
                    f"{w} step {s} that the card box never pulled")
            b = next(lm_batches(cfg.vocab, 4, 32,
                                seed=100_000 * seed + 1000 * (w + 1) + s))
            _, g = lm_loss_and_grad(
                params, torch.from_numpy(b["tokens"]).to(flat.device),
                torch.from_numpy(b["labels"]).to(flat.device), cfg)
            book[key] = flat_space.flatten(g).cpu()
        return flat_space.unflatten(book[key].to(flat.device))

    def spec(name, seed, *, workers=2, opt=0, **kw):
        return JobSpec(name=name, params=trees[seed],
                       optimizer=optimizers[opt], num_workers=workers,
                       chunk_elems=4096, **kw)

    def harness(h, seed, steps_done=0, name=None):
        """A harness over tenant handle ``h`` (or a twin fabric of tenant
        ``name``) whose workers have done ``steps_done`` steps."""
        name = name or h.namespace
        wh = WorkerHarness(h, lambda p, ws: grad(name, seed, p, ws),
                           lambda w, s: (w, s))
        wh.steps_done = [steps_done] * h.num_workers
        return wh

    def drive(pairs, steps):
        """Interleave the tenants' harnesses tick by tick (as
        tests/test_tenancy.py's ``drive``); returns the harnesses."""
        hs = [harness(h, seed) for h, seed in pairs]
        for _ in range(steps * 100):
            if all(min(w.steps_done) >= steps for w in hs):
                return hs
            for w in hs:
                if min(w.steps_done) < steps:
                    w.tick()
        raise AssertionError("tenant scheduler livelock")

    def fab_bits(fab):
        efs = _residuals(fab)
        return ([fab.params.cpu()]
                + [fab._assemble_rows(lambda sh, k=k: sh.state[k]).reshape(
                    -1).cpu() for k in range(fab.spec.num_state_slots)]
                + [None if e is None else e.cpu() for e in efs])

    def fab_stats(fab):
        return (dataclasses.asdict(fab.stats),
                [dataclasses.asdict(sh.stats) for sh in fab.shards],
                [dataclasses.asdict(r.stats) for r in fab.rack_aggs],
                [dataclasses.asdict(r.switch.stats) if r.switch else None
                 for r in fab.rack_aggs],
                dataclasses.asdict(fab.core_switch.stats)
                if fab.core_switch else None,
                fab.fault_trace, fab.export_fault_trace(),
                sorted(fab.dead_workers), fab.worker_clock.tolist(),
                fab.chunk_owner.tolist(), fab.step)

    def twin_same(fab, ded):
        """A tenant against its twin: every bit, or, across an elastic
        re-target (the flat spaces pad differently), params and state over
        the payload."""
        a, b = fab_bits(fab), fab_bits(ded)
        if fab.space.flat_elems != ded.space.flat_elems:
            n, k = fab.space.payload_elems, 1 + fab.spec.num_state_slots
            a, b = [x[:n] for x in a[:k]], [y[:n] for y in b[:k]]
        return len(a) == len(b) and all(
            (x is None and y is None) or (
                x is not None and y is not None and same_bits(x, y))
            for x, y in zip(a, b))

    def box_state(b):
        """(every comparable view and counter, every tenant's bits)."""
        views, bits = [], []
        for h in b.jobs.values():
            g = h.global_chunks()
            views.append((h.name, h.chunk_base, h.telemetry(),
                          fab_stats(h.fabric),
                          [b.route(int(x)) for x in g[::7]]))
            bits += fab_bits(h.fabric)
        views.append((b.utilization(), b.shard_occupancy(), b.describe(),
                      dataclasses.asdict(b.aggregate_stats()),
                      {n: dataclasses.astuple(s)
                       for n, s in b.switch_grants.items()},
                      b._tor_slots_left, b._core_slots_left, b.rounds,
                      b._next_chunk_base))
        return views, bits

    def sweep_case(n, shards, racks, codec):
        def run(d):
            box = MultiJobFabric(num_shards=shards, num_racks=racks,
                                 device=d)
            handles = [box.attach(spec(f"t{i}", i, opt=i, codec=codec,
                                       priority=float(i + 1)))
                       for i in range(n)]
            twins = [(h, dedicated_fabric(h.spec, box), i, ROUNDS)
                     for i, h in enumerate(handles)]
            drive([(h, i) for i, h in enumerate(handles)], ROUNDS)
            return [box], twins, []
        return run

    def mix_case(d):
        box = MultiJobFabric(num_shards=SHARDS, num_racks=RACKS, device=d)
        specs = [spec("sync", 0, workers=4),
                 spec("quorum", 1, workers=4, opt=2, min_push_fraction=0.75),
                 spec("ssp", 2, workers=4, opt=1, mode="stale",
                      staleness=2)]
        handles = [box.attach(s) for s in specs]
        twins = [(h, dedicated_fabric(h.spec, box), i, ROUNDS + 1)
                 for i, h in enumerate(handles)]
        drive([(h, i) for i, h in enumerate(handles)], ROUNDS + 1)
        return [box], twins, []

    def grant_case(d):
        chunks = ParamSpace.build(trees[0], chunk_elems=4096,
                                  num_owners=SHARDS).num_chunks
        from repro_torch.core.config import SwitchConfig

        box = MultiJobFabric(num_shards=SHARDS, num_racks=RACKS, device=d,
                             switch=SwitchConfig(enabled=True,
                                                 tor_slots=chunks,
                                                 core_slots=chunks))
        h1 = box.attach(spec("g1", 0, codec="int8"))
        h2 = box.attach(spec("g2", 1, codec="int8", opt=1))
        events = [sorted(box.switch_grants)]
        twins = [(h1, dedicated_fabric(h1.spec, box), 0, ROUNDS),
                 (h2, dedicated_fabric(h2.spec, box), 1, ROUNDS)]
        drive([(h1, 0), (h2, 1)], ROUNDS)
        box.detach("g1")
        events.append((box._tor_slots_left, box._core_slots_left))
        h3 = box.attach(spec("g3", 2, codec="int8", opt=2))
        events.append(sorted(box.switch_grants))
        twins.append((h3, dedicated_fabric(h3.spec, box), 2, ROUNDS))
        drive([(h3, 2)], ROUNDS)
        events.append([h.stats.switch_rounds for h in (h1, h2, h3)])
        return [box], twins, events

    def crash_case(d):
        box = MultiJobFabric(num_shards=SHARDS, num_racks=RACKS, device=d)
        h1 = box.attach(spec("r1", 0, codec="int8"))
        h2 = box.attach(spec("r2", 1, replication=2, opt=1))
        twins = [(h, dedicated_fabric(h.spec, box), i, ROUNDS)
                 for i, h in enumerate((h1, h2))]
        hs = drive([(h1, 0), (h2, 1)], ROUNDS - 1)
        err = None
        try:
            box.crash_shard(1)
        except ShardLost as e:
            err = f"{type(e).__name__}: {e}"
        events = [err, h1.stats.shards_crashed, h2.stats.failovers]
        for w in hs:  # every tenant trains on after the crash
            w.run(ROUNDS)
        return [box], twins, events

    def elastic_case(d):
        box4 = MultiJobFabric(num_shards=SHARDS, num_racks=RACKS, device=d)
        # codec none: a snapshot carries no error-feedback residual, so
        # only the raw wire resumes exactly as the uninterrupted twin
        h4 = box4.attach(spec("mig", 0))
        ded = dedicated_fabric(h4.spec, box4)
        drive([(h4, 0)], ROUNDS - 1)
        space4 = h4.space
        snap = box4.detach("mig")
        box3 = MultiJobFabric(num_shards=3, num_racks=RACKS, device=d)
        h3 = box3.attach(h4.spec, snapshot=snap, snapshot_space=space4)
        events = [space4.flat_elems, h3.space.flat_elems, h3.step]
        harness(h3, 0, ROUNDS - 1).run(ROUNDS)
        return [box4, box3], [(h3, ded, 0, ROUNDS)], events

    def shares_case(d):
        box = MultiJobFabric(num_shards=SHARDS, num_racks=RACKS, device=d)
        handles = [box.attach(spec("s0", 0, priority=2.0)),
                   box.attach(spec("s1", 1, opt=1, bandwidth_cap=0.5))]
        twins = [(h, dedicated_fabric(h.spec, box), i, ROUNDS + 1)
                 for i, h in enumerate(handles)]
        hs = drive([(h, i) for i, h in enumerate(handles)], 1)
        events = [box.apply_tenant_shares({"s0": 1.0, "s1": 4.0, "gone": 2})]
        for w in hs:
            w.run(2)
        events.append(box.apply_plan_delta(
            PlanDelta(kind="tenant_shares", shares=(("s0", 8.0),))))
        for w in hs:
            w.run(ROUNDS + 1)
        events.append([box.wire_scales(h.fabric) for h in handles])
        return [box], twins, events

    cases = [(f"{n}t/shards{s}/racks{r}/{codec}", sweep_case(n, s, r, codec))
             for n in (1, 2, 3) for s in (1, SHARDS) for r in (1, RACKS)
             for codec in ("none", "bf16", "int8")]
    cases += [("mix/sync+quorum+ssp", mix_case),
              ("switch/grant+refuse+return", grant_case),
              ("box_crash/R1+R2", crash_case),
              ("elastic/4->3_shards", elastic_case),
              ("tenant_shares/mid_run", shares_case)]
    launches: dict = {}
    special: dict = {}
    for case, run in cases:
        book.clear()
        filling[0] = True
        _zero_counts()
        boxes, twins, events = run(dev)
        launches[case] = _counts()
        got = [box_state(b) for b in boxes]
        for h, ded, seed, steps in twins:
            harness(ded, seed, name=h.name).run(steps)
            if not twin_same(h.fabric, ded):
                raise AssertionError(f"SMOKE tenancy {case}: tenant "
                                     f"{h.name} differs from its dedicated "
                                     "twin on the card")
        del boxes, twins
        filling[0] = False
        with PlainCalls() as plain:
            ref_boxes, _, ref_events = run(cpu)
        ref = [box_state(b) for b in ref_boxes]
        del ref_boxes
        if plain.counts != launches[case]:
            raise AssertionError(f"SMOKE tenancy {case}: launches "
                                 f"{launches[case]}, the CPU run's plain "
                                 f"calls {plain.counts}")
        if events != ref_events or [v for v, _ in got] != [v for v, _ in ref]:
            raise AssertionError(f"SMOKE tenancy {case}: the box on {dev} "
                                 f"differs from the CPU's ({events} / "
                                 f"{ref_events})")
        for (_, a), (_, b) in zip(got, ref):
            if len(a) != len(b) or not all(
                    (x is None and y is None) or (
                        x is not None and y is not None and same_bits(x, y))
                    for x, y in zip(a, b)):
                raise AssertionError(f"SMOKE tenancy {case}: tenant bits on "
                                     f"{dev} differ from the CPU's")
        if events:
            special[case] = events
    book.clear()
    grants, crash, elastic, shares = (special[k] for k in (
        "switch/grant+refuse+return", "box_crash/R1+R2",
        "elastic/4->3_shards", "tenant_shares/mid_run"))
    chunks = ParamSpace.build(trees[0], chunk_elems=4096,
                              num_owners=SHARDS).num_chunks
    if grants != [["g1"], (chunks, chunks), ["g3"], [ROUNDS, 0, ROUNDS]]:
        raise AssertionError(f"SMOKE tenancy switch grants {grants}")
    if not (crash[0] and crash[0].startswith("ShardLost")
            and crash[1:] == [1, 1]):
        raise AssertionError(f"SMOKE tenancy box crash {crash}")
    if elastic[0] == elastic[1] or elastic[2] != ROUNDS - 1:
        raise AssertionError(f"SMOKE tenancy elastic re-target {elastic}")
    if shares != [2, 1, [(1.5, 1.5), (3.0, 3.0)]]:
        raise AssertionError(f"SMOKE tenancy shares {shares}")
    total = {k: sum(c[k] for c in launches.values())
             for k in next(iter(launches.values()))}
    log(f"smoke tenancy: {len(launches)} cases (1-3 tenants x shards x "
        f"racks x codec; sync + quorum + SSP; switch grants; a box-wide "
        f"crash; an elastic re-attach; tenant shares), {dev} == cpu bitwise "
        f"in every tenant's bits, every stats field, the fault traces and "
        f"the box's views; each tenant == its dedicated twin on {dev.type}; "
        f"launches == the CPU run's plain calls, on {dev.type} {total}; "
        f"grants {grants}; crash {crash}; elastic {elastic}; shares {shares}")
    return launches


def profile_summary(prof, steady_round_ms: float, last_launches,
                    kernel_name: str, kernel_key: str = "") -> dict:
    """Print where the profiled round's time went: host time per labelled
    phase, device busy time (the union of kernel, copy and fill intervals)
    against the unprofiled round's wall time, and the top kernels.  The
    named kernel's time is its CUDA events (``last_launches``), or, with
    ``last_launches`` None, the profiler's records of kernels whose name
    holds ``kernel_key``."""
    from torch.autograd import DeviceType

    for e in prof.key_averages():
        if e.is_user_annotation and e.device_type == DeviceType.CPU:
            log(f"    host   {e.cpu_time_total / 1e3:9.2f} ms  x{e.count:<5d} "
                f"{e.key} (wall time inside the range, profiler on)")
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if _on_device(e))
    busy_us, reach = 0.0, float("-inf")
    for start, end in spans:
        busy_us += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    if busy_us <= 0:
        log("  profiler: no device time recorded (not measured)")
        return {"device_busy_ms": None}
    kernel_us = (kernel_device_ms(prof, kernel_key)[0] * 1e3
                 if last_launches is None else
                 sum(s.elapsed_time(e) for s, e in last_launches) * 1e3)
    log(f"  profiled round: device busy {busy_us / 1e3:.1f} ms = "
        f"{busy_us / 1e3 / steady_round_ms:.1%} of the unprofiled round "
        f"({steady_round_ms:.1f} ms), idle "
        f"{1 - busy_us / 1e3 / steady_round_ms:.1%}; {kernel_name} "
        f"{kernel_us / 1e3:.1f} ms = {kernel_us / busy_us:.1%} of device time")
    kernels = [e for e in prof.key_averages() if _on_device(e)]
    for e in sorted(kernels, key=lambda e: e.self_device_time_total,
                    reverse=True)[:20]:
        log(f"    device {e.self_device_time_total / 1e3:9.2f} ms  "
            f"x{e.count:<5d} {e.key[:100]}")
    return {"device_busy_ms": busy_us / 1e3}


# -- phases 20 to 22: the serving path -----------------------------------------
# the full-width serve run: the CLI's arguments (launch/serve.py), gemma3-1b
# at its published config through a 4-shard, 2-rack (1:4 core), R = 2 fabric
SERVE_ARGV = ["--arch", "gemma3-1b", "--source", "fabric", "--train-rounds",
              "1", "--serve-shards", str(SHARDS), "--serve-racks", "2",
              "--serve-replication", "2", "--serve-workers", str(WORKERS),
              "--batch", "4", "--prompt-len", str(SEQ), "--tokens", "32",
              "--max-staleness", "1", "--seed", "0"]
# decode against a forward of the longer sequence, and the unrolled
# (rolling window) decode against the scan decode, in bf16: the largest
# logit difference over the largest |logit|.  At the SMOKE config in bf16
# (4 layers, d=64, window 8, prompts of 24 tokens, 8 steps, 3 seeds) both
# differences stay within 1.64 % of the largest logit (0.0088-0.0107 of
# 0.64-0.66: 2-3 bf16 ulps), from bf16 rounding in matmuls of other shapes;
# full width stacks 6.5x the layers, so the bound is 3x that, 5 %.
SERVE_LOGIT_TOL = 0.05
# the same checks card against CPU at the SMOKE config in f32: cuBLAS and
# the CPU BLAS sum in other orders (f32 logits of order 1)
SMOKE_LOGIT_TOL = 1e-4


def rel_logit_err(a, b) -> float:
    """Largest |a - b| over the largest |b| (f32 logits, any shape)."""
    return ((a.float() - b.float()).abs().max()
            / b.float().abs().max()).item()


def _digest(t) -> str:
    return hashlib.sha1(t.cpu().numpy().tobytes()).hexdigest()


def serve_path(dev) -> dict:
    """Phase 20: gemma3-1b served at full width through ``launch/serve.py``'s
    body (``serve(arch.config, args)``): one round of the CLI's synthetic
    training (the float64 numpy draws, rounded to f32), a ``max_staleness=1``
    read from the R = 2 chain tails, a prefill of 4 x 1024 tokens and 31
    greedy decode steps (32 tokens).  Counts set to 0 just before the call
    and read just after: 4 fused_agg_opt, no codec launch.  Then a round of
    gradients drawn on the card, the cached read served again (still version
    1's bits) and a ``max_staleness=0`` read (version 2's).  The scan decode
    is held against a forward of the 1,055-token sequence and the unrolled
    decode (rolling 512-slot caches seeded from the prefill's) against the
    scan decode, at SERVE_LOGIT_TOL; ``assemble``, a miss, a hit, the prefill and a decode
    step are timed.  Then ``--source checkpoint`` (no training round:
    saved at round 0 and served back through a SnapshotSource)."""
    import shutil

    import numpy as np
    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.core.config import ServeConfig
    from repro_torch.core.serving import FabricSource, ReadPlane
    from repro_torch.launch import serve as S
    from repro_torch.models import transformer as T

    cfg = get_arch("gemma3-1b").config
    args = S.build_argparser().parse_args(SERVE_ARGV)
    memory = PathMemory(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _zero_counts()  # every count to 0 just before the path...
    out = S.serve(cfg, args, device=dev)
    torch.cuda.synchronize()
    launches = _counts()  # ...and read just after
    cli_s = time.perf_counter() - t0
    _check_counts("serve path", launches, {"fused_agg_opt": SHARDS})
    fabric, plane, params = out["fabric"], out["plane"], out["params"]
    info = out["read"]
    if (info["version"], info["staleness"], info["replication"],
            info["shards"]) != (1, 0, 2, SHARDS):
        raise AssertionError(f"serve read provenance {info}")
    v1 = plane.frontends[0].flat
    if not same_bits(v1, fabric.params):
        raise AssertionError("the served read is not fabric.params' bits")
    v1_copy = v1.clone()
    v1_sha = _digest(v1)
    gen = out["generated"]
    if gen.shape != (args.batch, args.tokens) or not ((gen >= 0) & (gen < cfg.vocab)).all():
        raise AssertionError(f"generated ids {gen.shape} out of range")
    n = fabric.space.flat_elems
    log(f"serve path: {cfg.name} full width, flat {n} (N params "
        f"{cfg.param_count()}), {SHARDS} shards over 2 racks (1:4 core), "
        f"R = 2, 1 CLI round in {cli_s:.1f} s (the numpy draws of "
        f"{WORKERS} x {n} float64 normals included); launches {launches}; "
        f"CLI prefill {out['prefill_ms']:.1f} ms, decode "
        f"{out['decode_ms']:.1f} ms for {args.tokens - 1} steps (host "
        "clock)")
    log("  " + plane.describe())

    # round 2 with card-drawn gradients; the cached read must not move
    g = torch.Generator(device=dev).manual_seed(7)
    _zero_counts()
    for w in range(WORKERS):
        fabric.pull(w)
    for w in range(WORKERS):
        fabric.push(w, 1e-3 * torch.randn(n, generator=g, device=dev))
    torch.cuda.synchronize()
    _check_counts("serve round 2", _counts(), {"fused_agg_opt": SHARDS})
    hit = plane.read(0)
    if not (hit.cache_hit and hit.version == 1 and hit.staleness == 1):
        raise AssertionError(f"max_staleness=1 read after round 2: {hit}")
    if not same_bits(hit.flat, v1_copy) or _digest(hit.flat) != v1_sha:
        raise AssertionError("the cached read lost version 1's bits")
    if same_bits(hit.flat, fabric.params):
        raise AssertionError("round 2 did not change the params")
    fresh_plane = ReadPlane(fabric, config=ServeConfig(max_staleness=0))
    fresh = fresh_plane.read(0)
    if fresh.cache_hit or fresh.version != 2 or not same_bits(
            fresh.flat, fabric.params):
        raise AssertionError(f"max_staleness=0 read: {fresh}")
    del v1_copy, hit, fresh, fresh_plane
    # read-side times: the tails assembled (CUDA events), a miss and a
    # batch of 4 hits (host clock around synchronized work)
    source = FabricSource(fabric)
    assemble_ms = [cuda_ms(source.assemble, 1) for _ in range(3)]

    def miss():
        ReadPlane(fabric, config=ServeConfig(max_staleness=1)).read_batch(
            0, 4)

    miss_ms = [timed(miss) for _ in range(3)]
    hit_ms = [timed(lambda: plane.read_batch(0, 4)) for _ in range(5)]
    sim_us = plane.stats.sim_serve_us
    # decode checks and times on the served params
    rng = np.random.default_rng(args.seed)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab, (args.batch, args.prompt_len)).astype(np.int32)).to(dev)
    ids = torch.from_numpy(gen.astype(np.int32)).to(dev)
    max_seq = args.prompt_len + args.tokens
    with torch.no_grad():
        nxt, cache = T.prefill(params, prompts, cfg, max_seq)
        if not torch.equal(nxt, ids[:, 0]):
            raise AssertionError("prefill disagrees with the CLI's prefill")
        scan = []
        for i in range(args.tokens - 1):
            x = T.decode_hidden(params, ids[:, i], cache, SEQ + i, cfg)
            scan.append(T.head_logits(params, x, cfg))
            if not torch.equal(scan[-1].argmax(-1).int(), ids[:, i + 1]):
                raise AssertionError(f"decode step {i} disagrees with the "
                                     "CLI's")
        seq = torch.cat([prompts, ids[:, :-1]], dim=1)  # 1,055 tokens
        hidden, _ = T.forward(params, seq, cfg)
        fwd = [T.head_logits(params, hidden[:, SEQ + i], cfg)
               for i in range(args.tokens - 1)]
        del hidden
        decode_err = max(rel_logit_err(a, b) for a, b in zip(scan, fwd))
        decode_ids = sum(int(torch.equal(a.argmax(-1), b.argmax(-1)))
                         for a, b in zip(scan, fwd))
        # the unrolled decode over the same history: its caches seeded from
        # the prefill's (global layers: positions 0..1023; local layers:
        # the last 512, position p in slot p % 512), then the 31 generated
        # tokens decoded through it (a replay of all 1,055 steps through
        # the eager unrolled path takes ~40 s; phase 22 and the CPU tests
        # replay from position 0)
        caches = T.init_cache_unrolled(cfg, args.batch, max_seq, device=dev)
        for li, layer in enumerate(caches):
            w = layer["k"].shape[1]
            pos = torch.arange(max(0, SEQ - w), SEQ, device=dev)
            slots = pos if cfg.is_global_layer(li) else pos % w
            for key in ("k", "v"):
                layer[key][:, slots] = cache[key][li][:, pos]
        t0 = time.perf_counter()
        unrolled = []
        for i in range(args.tokens - 1):
            x = T.decode_hidden_unrolled(params, ids[:, i], caches, SEQ + i,
                                         cfg)
            unrolled.append(T.head_logits(params, x, cfg))
        torch.cuda.synchronize()
        unrolled_s = time.perf_counter() - t0
        unrolled_err = max(rel_logit_err(a, b)
                           for a, b in zip(unrolled, scan))
        for name, err in (("decode vs forward", decode_err),
                          ("unrolled vs scan decode", unrolled_err)):
            if not err <= SERVE_LOGIT_TOL:
                raise AssertionError(f"{name}: logits differ by {err:.4f} of"
                                     f" the largest, over {SERVE_LOGIT_TOL}")
        prefill_ms = [cuda_ms(lambda: T.prefill(params, prompts, cfg,
                                                max_seq), 1)
                      for _ in range(3)]
        step_ms = [cuda_ms(lambda: T.decode_step(params, ids[:, 5], cache,
                                                 SEQ + 5, cfg), 1)
                   for _ in range(10)]
        del cache, caches, scan, fwd, unrolled
    peak = memory.now()[1]
    log(f"  round-2 checks: cached read (staleness 1) == version 1 (SHA-1 "
        f"{v1_sha[:12]}), fresh read == version 2; assemble "
        f"{[round(x, 3) for x in assemble_ms]} ms (CUDA events), miss "
        f"{[round(x, 2) for x in miss_ms]} ms, hit (batch of 4) "
        f"{[round(x, 3) for x in hit_ms]} ms (host clock), sim_serve_us "
        f"{sim_us}")
    steps = args.tokens - 1
    log(f"  decode: {args.batch} x {SEQ} prompt, {steps} steps; vs a forward"
        f" of {seq.shape[1]} tokens {decode_err:.5f} of the largest logit "
        f"({decode_ids}/{steps} steps with every greedy id equal), unrolled "
        f"vs scan {unrolled_err:.5f} (tolerance {SERVE_LOGIT_TOL}); "
        f"{steps} unrolled steps "
        f"{unrolled_s:.1f} s; prefill {[round(x, 2) for x in prefill_ms]} ms,"
        f" decode step {statistics.median(step_ms):.3f} ms (median of 10; "
        f"CUDA events); peak {peak / 2**30:.2f} GiB")
    stats = dataclasses.asdict(plane.stats)
    stats.pop("latency")
    del out, fabric, plane, params, source, prompts, ids, seq, v1
    torch.cuda.empty_cache()

    # --source checkpoint: saved at round 0, restored, served back
    ckpt_dir = ROOT / "build" / "serve_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    cargs = S.build_argparser().parse_args(
        SERVE_ARGV[:SERVE_ARGV.index("--train-rounds")]
        + ["--source", "checkpoint", "--train-rounds", "0", "--checkpoint",
           str(ckpt_dir), "--serve-shards", str(SHARDS), "--serve-racks", "2",
           "--serve-replication", "2", "--batch", "1", "--prompt-len", "16",
           "--tokens", "2"])
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cout = S.serve(cfg, cargs, device=dev)
        torch.cuda.synchronize()
        ckpt_s = time.perf_counter() - t0
        cread = cout["plane"].frontends[0].flat
        if (cout["read"]["version"] != 0
                or not same_bits(cread, cout["fabric"].params)):
            raise AssertionError("the checkpoint-served read is not the "
                                 "fabric's bits")
        del cout, cread
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    log(f"  checkpoint source: saved at round 0 ({n * 4} B of params), "
        f"restored and served back bitwise in {ckpt_s:.1f} s (fabric build, "
        f"save, restore, a 1 x 16 prefill and one decode step)")
    return {"launches": launches, "peak_bytes": peak, "cli_s": cli_s,
            "assemble_ms": assemble_ms, "miss_ms": miss_ms, "hit_ms": hit_ms,
            "prefill_ms": prefill_ms, "decode_step_ms": step_ms,
            "decode_err": decode_err, "unrolled_err": unrolled_err,
            "sim_serve_us": sim_us, "stats": stats, "ckpt_s": ckpt_s,
            "flat_elems": n}


def sparse_serve_path(dev) -> dict:
    """Phase 21: dlrm-mlperf (tables capped at DLRM_ROW_CAP rows, as phase
    6) under a 2-rack NetworkTopology (1:4 core), R = 1: one training round
    of 2 workers (counts set to 0 just before and read just after: 52
    embedding_bag, 52 segment_sum, 4 fused_agg_opt), then a SparseReadPlane
    of 2 frontends (one a rack, 65,536 hot rows each) serving a Zipfian
    trace (skew 1.05) of 4,096-row batches over the two largest tables,
    interleaved with a second round.  Every served row equals a direct
    ``tier.table(name)[ids]`` bitwise; the hit rate, the rack and core
    bytes and the ms per ``read_rows`` batch are reported."""
    import numpy as np
    import torch

    from repro_torch.core.config import ServeConfig
    from repro_torch.core.serving import SparseReadPlane, zipfian_trace
    from repro_torch.core.topology import NetworkTopology
    from repro_torch.data.synthetic import recsys_batches

    cfg = dlrm_capped_config()
    memory = PathMemory(dev)
    topo = NetworkTopology(num_workers=WORKERS, num_racks=2)
    space, fab, tier = dlrm_setup(cfg, dev, SHARDS, topology=topo)
    if tier.topology is not topo or tier.replication != 1:
        raise AssertionError("the tier did not inherit the topology")
    streams = [recsys_batches("dlrm-mlperf", cfg, DLRM_BATCH, seed=w)
               for w in range(WORKERS)]
    losses: list = []
    n = cfg.n_sparse
    torch.cuda.synchronize()
    _zero_counts()  # every count to 0 just before the round...
    t0 = time.perf_counter()
    dlrm_round(space, fab, tier, cfg, streams, dev, losses)
    torch.cuda.synchronize()
    round_ms = [(time.perf_counter() - t0) * 1e3]
    launches = _counts()  # ...and read just after
    _check_counts("sparse serve round 1", launches,
                  {"embedding_bag": n * WORKERS, "segment_sum": n * WORKERS,
                   "fused_agg_opt": sum(1 for s in fab.shards
                                        if s.num_chunks)})
    order = sorted(range(n), key=lambda i: -cfg.vocabs[i])[:2]
    names = [f"t{i}" for i in order]
    plane = SparseReadPlane(tier, config=ServeConfig(
        num_frontends=2, cache_rows=65536, name="rows",
        serve_us_per_read=0.01))
    batch, batches = 4096, 12
    traces = {name: zipfian_trace(tier.tables[name].num_rows,
                                  batch * batches, 1.05, seed=i)
              for i, name in enumerate(names)}
    read_ms, served = [], 0
    for b in range(batches):
        if b == batches // 2:  # the second round lands between reads
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dlrm_round(space, fab, tier, cfg, streams, dev, losses)
            torch.cuda.synchronize()
            round_ms.append((time.perf_counter() - t0) * 1e3)
        name = names[b % 2]
        ids = traces[name][b * batch:(b + 1) * batch]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = plane.read_rows(b % 2, name, ids)
        torch.cuda.synchronize()
        read_ms.append((time.perf_counter() - t0) * 1e3)
        direct = tier.table(name)[torch.from_numpy(ids).to(dev)]
        if not same_bits(res.rows, direct):
            raise AssertionError(f"batch {b}: served rows of {name} differ "
                                 "from the direct table read")
        if not np.array_equal(res.versions, tier.row_versions(name)[ids]):
            raise AssertionError(f"batch {b}: stamped versions differ")
        served += len(ids)
        del direct, res
    finite_losses(losses)
    st, ts = plane.stats, tier.stats
    if st.row_reads != served or st.row_hits + st.row_misses != served:
        raise AssertionError(f"SparseServeStats do not add up: {st}")
    if not (st.bytes_rack_link > 0 and st.bytes_core_link > 0
            and st.bytes_refreshed == st.bytes_rack_link
            + st.bytes_core_link):
        raise AssertionError(f"serve bytes not split by rack: {st}")
    peak = memory.now()[1]
    log(f"sparse serve path: {cfg.name} (tables capped at {DLRM_ROW_CAP} "
        f"rows) over 2 racks (1:4 core), R = 1; round 1 launches {launches};"
        f" rounds {[round(x, 1) for x in round_ms]} ms; tier rack / core "
        f"bytes {ts.bytes_rack_link} / {ts.bytes_core_link}, sim push / "
        f"lookup us {ts.sim_push_us:.1f} / {ts.sim_lookup_us:.1f}")
    log(f"  {plane.describe()}; served {served} rows of {names} in "
        f"{batches} batches of {batch}, every row == the direct table read; "
        f"hit rate {st.hit_rate:.4f} ({st.stale_rows} version-stale, "
        f"{st.evictions} evictions); serve rack / core bytes "
        f"{st.bytes_rack_link} / {st.bytes_core_link}; read_rows ms "
        f"{[round(x, 1) for x in read_ms]} (host clock); sim_serve_us "
        f"{st.sim_serve_us:.1f}; peak {peak / 2**30:.2f} GiB")
    stats = dataclasses.asdict(st)
    del space, fab, tier, plane, streams
    torch.cuda.empty_cache()
    return {"launches": launches, "peak_bytes": peak, "round_ms": round_ms,
            "read_ms": read_ms, "stats": stats, "served": served,
            "tables": names}


def _record(x):
    """A comparable record of a serving result: tensors to the host,
    dataclasses and trackers to plain fields (floats kept exact)."""
    import torch

    from repro_torch.core.serving import LatencyTracker

    if torch.is_tensor(x):
        return x.detach().cpu()
    if isinstance(x, LatencyTracker):
        return ("tracker", x.counts.tolist(), x.count, x.total_us, x.min_us,
                x.max_us, [x.quantile(q) for q in (0.5, 0.99, 0.999)])
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,
                {f.name: _record(getattr(x, f.name))
                 for f in dataclasses.fields(x)})
    if isinstance(x, dict):
        return {k: _record(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_record(v) for v in x]
    if hasattr(x, "dtype") and hasattr(x, "tolist"):  # numpy
        return ("array", str(x.dtype), x.tolist())
    return x


def _same_record(a, b, where: str) -> None:
    import torch

    if torch.is_tensor(a) or torch.is_tensor(b):
        if not (torch.is_tensor(a) and torch.is_tensor(b)
                and same_bits(a, b)):
            raise AssertionError(f"{where}: tensors differ")
    elif isinstance(a, dict) and isinstance(b, dict):
        if a.keys() != b.keys():
            raise AssertionError(f"{where}: keys {a.keys()} != {b.keys()}")
        for k in a:
            _same_record(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        if len(a) != len(b):
            raise AssertionError(f"{where}: {len(a)} != {len(b)} items")
        for i, (x, y) in enumerate(zip(a, b)):
            _same_record(x, y, f"{where}[{i}]")
    elif a != b and not (isinstance(a, float) and math.isnan(a)
                         and isinstance(b, float) and math.isnan(b)):
        raise AssertionError(f"{where}: {a!r} != {b!r}")


def smoke_serve_check(dev) -> dict:
    """Phase 22: the serving path at gemma3-1b's SMOKE config (its flat
    space, 4 shards, chunks of 4096), every case on ``dev`` against the
    same case on the CPU: every ReadResult (bits, version, staleness, hit,
    frontend, ``sim_us``), every ServeStats / SparseServeStats field (the
    latency bins and ``sim_serve_us`` included), every ServedRequest,
    ``describe()``, and the fabric's params bitwise.  Cases: ReadPlane and
    HierarchicalReadPlane over 1 and 2 racks x R = 1, 2, 3 with a shard
    crash between reads (failed over at R >= 2, twice at R = 3; ShardLost
    at R = 1); a FrontDoor running ``generate_trace`` traces (open, closed
    loop, diurnal, flash crowd; and a mixed trace through a hierarchical
    plane); serve tenants (a flat and a hierarchical plane) beside a
    training job on a 2-rack MultiJobFabric over codecs none, bf16, int8;
    a SparseReadPlane at R = 2 over 2 racks with a shard failover and a
    fabric ``restore`` between reads.  Gradients are numpy draws, the same
    bits on both devices.  Each case's launches on the card equal the CPU
    run's calls of the plain versions.  Then prefill, the scan decode and
    the unrolled decode in f32, card against CPU: greedy ids equal, logits
    within SMOKE_LOGIT_TOL.  Returns each case's launches on ``dev``."""
    import numpy as np
    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.core import config as C
    from repro_torch.core import serving as S
    from repro_torch.core import workload as WL
    from repro_torch.core.chunking import ParamSpace
    from repro_torch.core.compression import CompressionConfig
    from repro_torch.core.fabric import PBoxFabric
    from repro_torch.core.replication import ShardLost
    from repro_torch.core.sparse import SparseTier
    from repro_torch.core.tenancy import JobSpec, MultiJobFabric
    from repro_torch.core.topology import NetworkTopology
    from repro_torch.models import transformer as T
    from repro_torch.optim.optimizers import adamw, momentum, sgd

    mcfg = get_arch("gemma3-1b").smoke_config
    tree = T.init_params(mcfg, torch.Generator().manual_seed(0),
                         device="cpu")
    space = ParamSpace.build(tree, chunk_elems=4096)
    init = space.flatten(tree)
    grads: dict = {}  # (flat length, seed) -> a numpy-drawn gradient
    cpu = torch.device("cpu")

    def fabric(device, racks, R, codec="none", opt=None):
        topo = (NetworkTopology(num_workers=WORKERS, num_racks=racks)
                if racks > 1 else None)
        return PBoxFabric(space, opt or momentum(0.05, 0.9), init,
                          device=device, config=C.FabricConfig(
                              num_shards=SHARDS, num_workers=WORKERS,
                              wire=C.WireConfig(
                                  topology=topo,
                                  compression=CompressionConfig(codec=codec)),
                              faults=C.FaultConfig(replication=R)))

    def train(fab, r):
        n = fab.space.flat_elems
        for w in range(fab.num_workers):
            fab.pull(w)
        for w in range(fab.num_workers):
            key = (n, (w + r) % 4)
            if key not in grads:
                grads[key] = torch.from_numpy((1e-2 * np.random.default_rng(
                    key[1]).standard_normal(n)).astype(np.float32))
            fab.push(w, grads[key].to(fab.device))

    def crash(fab, shard):
        try:
            return fab.crash_shard(shard)
        except ShardLost as e:
            return f"ShardLost: {e}"

    def hier_config(**kw):
        return C.ServeConfig(
            slos=(("rt", C.SLOConfig(latency_budget_us=400.0, priority=2.0)),
                  ("bulk", C.SLOConfig(latency_budget_us=400.0,
                                       staleness_bound=3))),
            hierarchy=C.HierarchyConfig(enabled=True,
                                        staleness_ladder=(0, 1, 3),
                                        frontends_per_tier=(1, 1, 2)), **kw)

    def planes_case(racks, R):
        def run(device):
            fab = fabric(device, racks, R)
            flat = S.ReadPlane(fab, config=C.ServeConfig(
                num_frontends=2, max_staleness=1, serve_us_per_read=0.3))
            hier = S.HierarchicalReadPlane(fab, config=hier_config())
            reads, fates = [], []
            for r in range(4):
                train(fab, r)
                if r == 1 or (r == 2 and R == 3):
                    fates.append(crash(fab, 1))
                reads += [flat.read(0), *flat.read_batch(1, 3)]
                reads += [hier.read(f) for f in range(len(hier.frontends))]
            return {"reads": reads, "fates": fates, "flat": flat.stats,
                    "hier": hier.stats, "describe": [flat.describe(),
                                                     hier.describe()],
                    "params": fab.params}
        return run

    def traces():
        c = C
        open_t = c.TenantLoadConfig(name="o", n_requests=30, batch_max=2,
                                    arrival=c.ArrivalConfig(
                                        interarrival_us=7.0))
        return {
            "open": (open_t, c.TenantLoadConfig(
                name="p", n_requests=20, arrival=c.ArrivalConfig(
                    process="poisson", interarrival_us=9.0))),
            "closed": (c.TenantLoadConfig(name="c", clients=3, think_us=12.0,
                                          requests_per_client=5,
                                          staleness_req=1),),
            "diurnal": (dataclasses.replace(open_t, diurnal=c.DiurnalConfig(
                enabled=True, amplitude=0.6, period_us=300.0, phase=0.1)),),
            "flash": (dataclasses.replace(open_t, flash=c.FlashCrowdConfig(
                enabled=True, at_us=50.0, duration_us=80.0, magnitude=6.0)),),
            "mixed": (c.TenantLoadConfig(
                name="rt", n_requests=15, arrival=c.ArrivalConfig(
                    process="poisson", interarrival_us=20.0)),
                      c.TenantLoadConfig(
                name="bulk", n_requests=25, staleness_req=3,
                arrival=c.ArrivalConfig(process="mmpp", interarrival_us=10.0,
                                        burst_factor=5.0,
                                        burst_dwell_us=60.0)),
                      c.TenantLoadConfig(name="cl", clients=2, think_us=15.0,
                                         requests_per_client=6,
                                         staleness_req=3)),
        }

    def door_case(shape):
        trace = WL.generate_trace(C.WorkloadConfig(tenants=traces()[shape]),
                                  3)

        def run(device):
            fab = fabric(device, 2, 2)
            admission = C.AdmissionConfig(enabled=True, rate_per_us=0.2,
                                          burst=3, shed_slack=0.7)
            if shape == "mixed":
                plane = S.HierarchicalReadPlane(fab, config=hier_config(
                    admission=admission))
            else:
                plane = S.ReadPlane(fab, config=C.ServeConfig(
                    num_frontends=2, max_staleness=1, serve_us_per_read=2.0,
                    slos=(("o", C.SLOConfig(latency_budget_us=40.0,
                                            priority=2.0)),
                          ("c", C.SLOConfig(latency_budget_us=60.0,
                                            staleness_bound=1))),
                    admission=admission))
            fired = [0]

            def on_time(now):
                while fired[0] < 4 and now >= (fired[0] + 1) * 50.0:
                    train(fab, fired[0])
                    fired[0] += 1

            door = S.FrontDoor(plane)
            outs = door.run(trace, on_time=on_time)
            if not any(o.admitted for o in outs):
                raise AssertionError(f"door/{shape}: nothing admitted")
            return {"outs": outs, "stats": plane.stats,
                    "door": door.describe(), "plane": plane.describe(),
                    "params": fab.params}
        return run

    def tenants_case(codec):
        def run(device):
            box = MultiJobFabric(num_shards=SHARDS, num_racks=2,
                                 device=device)
            h = box.attach(JobSpec(name="train", params=tree,
                                   optimizer=adamw(3e-3),
                                   num_workers=WORKERS, codec=codec,
                                   chunk_elems=4096, replication=2))
            flat = box.attach_serving(
                JobSpec(name="serve", params=None, optimizer=None,
                        num_workers=2, priority=1.0, bandwidth_cap=0.5),
                "train", max_staleness=1)
            hier = box.attach_serving(
                JobSpec(name="geo", params=None, optimizer=None,
                        num_workers=1, priority=2.0), "train",
                config=hier_config())
            reads = []
            for r in range(3):
                train(h, r)
                if r == 1:
                    box.apply_tenant_shares({"serve": 3.0})
                reads += [flat.read(r % 2), *flat.read_batch(1, 2)]
                reads += [hier.read(f) for f in range(len(hier.frontends))]
            util, desc = box.utilization(), box.describe()
            box.detach_serving("geo")
            return {"reads": reads, "flat": flat.stats, "hier": hier.stats,
                    "util": util, "describe": desc,
                    "links": {k: dict(q.stats.by_job)
                              for k, q in box.links.items()},
                    "params": h.fabric.params,
                    "stats": h.fabric.stats}
        return run

    def sparse_case(device):
        topo = NetworkTopology(num_workers=WORKERS, num_racks=2)
        dense = {"w": torch.zeros(2 * 4096)}
        dspace = ParamSpace.build(dense, chunk_elems=4096)
        fab = PBoxFabric(dspace, sgd(0.1), dspace.flatten(dense),
                         device=device, config=C.FabricConfig(
                             num_shards=SHARDS, num_workers=WORKERS,
                             wire=C.WireConfig(topology=topo),
                             faults=C.FaultConfig(replication=2)))
        tier = SparseTier(fabric=fab, codec="int8", lr=0.05)
        v, d = 4096, 32
        tier.add_table("t0", np.random.default_rng(5).standard_normal(
            (v, d)).astype(np.float32))
        plane = S.SparseReadPlane(tier, config=C.ServeConfig(
            num_frontends=2, cache_rows=256, name="rows"))
        trace = S.zipfian_trace(v, 1200, 1.1, seed=2)
        rng = np.random.default_rng(9)

        out, snap = [], None

        def sparse_round():
            for w in range(WORKERS):
                ids = rng.integers(0, v, size=200)
                out.append(tier.lookup(w, "t0", ids[:50],
                                       np.arange(0, 51, 5)))
                rows = rng.standard_normal((200, d)).astype(np.float32)
                tier.push(w, {"t0": (ids, torch.from_numpy(rows).to(
                    device))})

        for step in range(8):
            if step in (1, 2, 5):
                sparse_round()
            if step == 2:
                snap = fab.snapshot()
            if step == 3:
                out.append(fab.crash_shard(1))
            if step == 6:
                fab.restore(snap)
            ids = trace[step * 150:(step + 1) * 150]
            res = plane.read_rows(step % 2, "t0", ids)
            if not same_bits(res.rows, tier.table("t0")[
                    torch.from_numpy(ids).to(device)]):
                raise AssertionError(f"sparse step {step}: served rows "
                                     "differ from the direct table read")
            out.append(res)
        return {"reads": out, "stats": plane.stats, "tier": tier.stats,
                "table": tier.table("t0"), "versions": tier.row_versions(
                    "t0"), "describe": [plane.describe(), tier.describe()]}

    cases = {f"plane/racks{racks}/R{R}": planes_case(racks, R)
             for racks in (1, 2) for R in (1, 2, 3)}
    cases |= {f"door/{shape}": door_case(shape)
              for shape in ("open", "closed", "diurnal", "flash", "mixed")}
    cases |= {f"tenants/{codec}": tenants_case(codec)
              for codec in ("none", "bf16", "int8")}
    cases["sparse/R2/racks2"] = sparse_case
    launches = {}
    for label, run in cases.items():
        _zero_counts()
        card = _record(run(dev))
        torch.cuda.synchronize()
        launches[label] = _counts()
        with PlainCalls() as plain:
            host = _record(run(cpu))
        _same_record(card, host, label)
        if launches[label] != plain.counts:
            raise AssertionError(f"{label}: card launches {launches[label]},"
                                 f" CPU plain-version calls {plain.counts}")
        if not any(launches[label].values()):
            raise AssertionError(f"{label}: no kernel launched")

    # prefill, the scan decode and the unrolled decode, card against CPU
    def decode(device):
        params = _tree_to(tree, device)
        toks = torch.from_numpy(np.random.default_rng(4).integers(
            0, mcfg.vocab, (3, 20)).astype(np.int32)).to(device)
        nxt, cache = T.prefill(params, toks, mcfg, 28)
        caches = T.init_cache_unrolled(mcfg, 3, 28, device=device)
        for pos in range(20):
            T.decode_hidden_unrolled(params, toks[:, pos], caches, pos, mcfg)
        ids, scan, unrolled = [nxt], [], []
        for i in range(7):
            x = T.decode_hidden(params, ids[-1], cache, 20 + i, mcfg)
            u = T.decode_hidden_unrolled(params, ids[-1], caches, 20 + i,
                                         mcfg)
            scan.append(T.head_logits(params, x, mcfg))
            unrolled.append(T.head_logits(params, u, mcfg))
            ids.append(T._greedy_logits(params, x, mcfg))
        return (torch.stack(ids).cpu(), torch.stack(scan).cpu(),
                torch.stack(unrolled).cpu())

    with torch.no_grad():
        card_ids, card_scan, card_unrolled = decode(dev)
        cpu_ids, cpu_scan, cpu_unrolled = decode(cpu)
    errs = (rel_logit_err(card_scan, cpu_scan),
            rel_logit_err(card_unrolled, cpu_unrolled),
            rel_logit_err(card_unrolled, card_scan))
    if not torch.equal(card_ids, cpu_ids) or max(errs) > SMOKE_LOGIT_TOL:
        raise AssertionError(f"SMOKE decode card vs CPU: ids equal "
                             f"{torch.equal(card_ids, cpu_ids)}, logit "
                             f"errors {errs} (tolerance {SMOKE_LOGIT_TOL})")
    total = {k: sum(c[k] for c in launches.values()) for k in _counts()}
    log(f"SMOKE serve sweep: {len(cases)} cases card == CPU bitwise (reads, "
        f"every stats field and clock float, served requests, describe, "
        f"params); launches {total}, each case's equal to the CPU run's "
        f"plain-version calls; decode card vs CPU: ids equal, logits "
        f"{errs[0]:.2e} (scan) / {errs[1]:.2e} (unrolled) of the largest, "
        f"unrolled vs scan on the card {errs[2]:.2e}")
    return launches


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


# -- phases 23 and 24: the placement solver and the closed-loop autoscaler ----
AUTO_ROUNDS = FAULT_ROUNDS  # phase 15's run A is the fixed-layout twin
AUTO_POLICY = dict(min_shards=SHARDS, max_shards=2 * SHARDS,
                   scale_up_busy_us=0.0, cooldown_rounds=10,
                   solve_placement=True)


def contiguous_owner(num_chunks: int, num_shards: int):
    """The contiguous policy's chunk -> shard map (``_partition``)."""
    import numpy as np

    sizes = [len(a) for a in np.array_split(np.arange(num_chunks),
                                            num_shards)]
    return np.repeat(np.arange(num_shards, dtype=np.int64), sizes)


def autoscale_path(dev, gw: GemmaWorkers, ref: dict) -> dict:
    """Phase 23: the closed loop at full width.  gemma3-1b, 2 workers (one
    in each of 2 racks, 1:4 core), AdamW, codec none, R = 2, 4 shards, a
    ReadPlane of 2 frontends, and an Autoscaler under AUTO_POLICY.  Round
    1; ``auto.step()`` (any busy time is above the 0.0 threshold: the
    shard count doubles to 8 through ``reshard``, then
    ``resolve_placement`` applies the solver's deltas); rounds 2 and 3; a
    read; ``auto.apply_plan`` of the 4-shard plan that
    ``PlacementProblem.standard(...).solve(seed=0)`` builds from the live
    shapes (one ``shard_count`` delta: ``reshard(4, plan=plan)``); round
    4; a read.

    Checks: the counts set to 0 just before the sequence and read just
    after give 4 + 8 + 8 + 4 fused_agg_opt launches and no codec launch;
    ``rescales == 2``; after ``step()`` the live plan equals the solved
    plan (the same problem solved again on the host) in chain and frontend
    racks, and the events equal ``diff_plans(base, solved)`` after the
    reshard; after ``apply_plan`` the live chain racks equal the applied
    plan's and the frontends stay; params and both AdamW slots hash to
    phase 15's fixed-layout R = 1 run (SHA-1 of the host state) and the
    losses equal its; the read after round 4 equals ``fab.params``, and
    the read taken before the second reshard keeps its bits (SHA-1 and a
    host copy).  Times each round, each ``step`` / ``apply_plan`` with
    the solve split out, each reshard, and the allocator retries and the
    peak."""
    import numpy as np
    import torch

    from repro_torch.core.config import FaultConfig, ServeConfig
    from repro_torch.core.placement import (
        PlacementPlan,
        PlacementProblem,
        current_plan,
        diff_plans,
    )
    from repro_torch.core.serving import ReadPlane
    from repro_torch.runtime.autoscaler import Autoscaler, AutoscalerPolicy

    t_phase = time.perf_counter()
    space = gw.space
    n_hi = AUTO_POLICY["max_shards"]
    owner = {n: contiguous_owner(space.num_chunks, n) for n in (SHARDS, n_hi)}

    def problem(n):
        # what Autoscaler._problem reads off the fabric, rebuilt on the host
        return PlacementProblem.standard(
            num_shards=n, num_racks=RACKS, replication=2, num_frontends=2,
            oversubscription=OVERSUB, codec="none",
            chunk_elems=space.chunk_elems,
            chunks_per_shard=np.bincount(owner[n], minlength=n))

    def retries():
        return torch.cuda.memory_stats(dev).get("num_alloc_retries", 0)

    memory = PathMemory(dev)
    fab = gw.fabric(2, topology=topology(2),
                    faults=FaultConfig(replication=2))
    plane = ReadPlane(fab, config=ServeConfig(num_frontends=2))
    auto = Autoscaler(fab, policy=AutoscalerPolicy(**AUTO_POLICY),
                      planes=[plane])
    reshard_ms: list = []
    solve_ms: list = []
    reshard = fab.reshard
    solve = PlacementProblem.solve

    def timed_reshard(n, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = reshard(n, **kw)
        torch.cuda.synchronize()
        reshard_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    def timed_solve(self, **kw):
        t0 = time.perf_counter()
        out = solve(self, **kw)
        solve_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    def host_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    fab.reshard = timed_reshard
    PlacementProblem.solve = timed_solve
    try:
        retries_by = [retries()]
        round_ms = []

        def train(s):
            round_ms.append(timed(lambda: gw.round(fab, s)))
            retries_by.append(retries())

        _zero_counts()  # every count to 0 just before the sequence...
        train(0)
        step_events, step_ms = host_ms(auto.step)
        step_solve = list(solve_ms)
        live_step = current_plan(fab, planes=[plane])
        train(1)
        train(2)
        r3 = plane.read(0)
        if r3.version != 3 or not same_bits(r3.flat, fab.params):
            raise AssertionError(f"autoscale read after round 3: version "
                                 f"{r3.version}, not fab.params' bits")
        r3_host = r3.flat.to("cpu", copy=True)
        r3_sha = _digest(r3_host)
        fab._flat_cache = None
        solve_ms.clear()
        plan4 = problem(SHARDS).solve(seed=0)
        plan_solve = list(solve_ms)
        apply_events, apply_ms = host_ms(lambda: auto.apply_plan(plan4))
        live_apply = current_plan(fab, planes=[plane])
        train(3)
        launches = _counts()  # ...and read just after
    finally:
        PlacementProblem.solve = solve
        del fab.reshard
    peak = memory.now()[1]
    losses = gw.finite_losses()
    _check_counts("autoscale path", launches, {
        "fused_agg_opt": SHARDS + n_hi + n_hi + SHARDS})

    # the solver again on the host, from the shapes after the reshard
    base = PlacementPlan.default(
        n_hi, num_racks=RACKS, replication=2, num_frontends=2).replace(
        chunk_owner=owner[n_hi], origin="live")
    solved = problem(n_hi).solve(start=base, sweeps=auto.policy.solver_sweeps,
                                 local_moves=auto.policy.solver_moves,
                                 seed=auto.seed)
    deltas = diff_plans(base, solved)
    moved = int(np.sum(owner[n_hi] != owner[SHARDS]))
    kinds = [e.kind for e in step_events]
    if (kinds != ["reshard"] + [d.kind for d in deltas]
            or not step_events[0].detail.startswith(
                f"-> {n_hi} shards ({moved} chunks moved, ")
            or any(not e.detail.startswith(d.describe())
                   for e, d in zip(step_events[1:], deltas))):
        raise AssertionError(f"autoscale step events {step_events}, expected "
                             f"a reshard to {n_hi} then {deltas}")
    # auto.events as the JAX loop keeps it: resolve_placement's apply_plan
    # records the re-placement deltas, and step() records them again after
    # its reshard
    again = [d.kind for d in deltas]
    if [e.kind for e in auto.events] != again + kinds + ["reshard"]:
        raise AssertionError(f"auto.events {auto.events}")
    if (not np.array_equal(live_step.replica_racks, solved.replica_racks)
            or live_step.frontend_racks != solved.frontend_racks):
        raise AssertionError(f"after step() the live plan "
                             f"{live_step.describe()} is not the solved "
                             f"{solved.describe()}")
    if [(e.kind, e.detail) for e in apply_events] != [
            ("reshard", f"-> {SHARDS} shards ({moved} chunks moved)")]:
        raise AssertionError(f"autoscale apply_plan events {apply_events}")
    if (not np.array_equal(live_apply.replica_racks, plan4.replica_racks)
            or live_apply.frontend_racks != live_step.frontend_racks):
        raise AssertionError(f"after apply_plan the live plan "
                             f"{live_apply.describe()}, applied "
                             f"{plan4.describe()}")
    if fab.stats.rescales != 2 or fab.num_shards != SHARDS:
        raise AssertionError(f"rescales {fab.stats.rescales}, shards "
                             f"{fab.num_shards}")
    r4 = plane.read(0)
    if r4.version != AUTO_ROUNDS or not same_bits(r4.flat, fab.params):
        raise AssertionError(f"autoscale read after round 4: version "
                             f"{r4.version}, not fab.params' bits")
    fab._flat_cache = None
    del r4
    kept = r3.flat.to("cpu", copy=True)
    if not same_bits(kept, r3_host) or _digest(kept) != r3_sha:
        raise AssertionError("the read taken before the second reshard "
                             "lost its bits")
    del kept, r3_host, r3
    digest = state_digest(host_state(fab))
    if digest != ref["digest_a"]:
        raise AssertionError("the autoscaled run's params and AdamW slots "
                             "differ from phase 15's fixed-layout run")
    if losses != ref["losses_a"]:
        raise AssertionError(f"autoscaled losses {losses}, the fixed-layout "
                             f"run's {ref['losses_a']}")
    describe = auto.describe()
    events = [(e.round, e.kind, e.detail) for e in auto.events]
    stats = {k: getattr(fab.stats, k) for k in (
        "rescales", "chunks_moved", "replica_moves", "bytes_replication",
        "bytes_core_link")}
    retries_by = [b - a for a, b in zip(retries_by, retries_by[1:])]
    del plane, auto, fab
    torch.cuda.empty_cache()
    log(f"autoscale path: {gw.cfg.name} full width, 2 workers over {RACKS} "
        f"racks (core 1:{OVERSUB:g}), AdamW, codec none, R = 2, "
        f"{SHARDS} -> {n_hi} -> {SHARDS} shards over {AUTO_ROUNDS} rounds, a "
        f"ReadPlane of 2 frontends; launches {launches}")
    log(f"  events {events}; {describe}; stats {stats}")
    log(f"  the re-solve at {n_hi} shards gave {len(deltas)} deltas "
        f"({solved.describe()}); the {SHARDS}-shard plan "
        f"{plan4.describe()}")
    log(f"  round wall ms {[round(x, 1) for x in round_ms]} (rounds 2 and "
        f"4 first after a reshard); step() {step_ms:.1f} ms host (solve "
        f"{[round(x, 2) for x in step_solve]} ms), apply_plan "
        f"{apply_ms:.1f} ms host (its plan's solve "
        f"{[round(x, 2) for x in plan_solve]} ms); reshards "
        f"{[round(x, 1) for x in reshard_ms]} ms host; allocator retries by "
        f"round {retries_by}; peak device memory {peak} bytes "
        f"({peak / 2**30:.2f} GiB)")
    log(f"  params and both AdamW slots == phase 15's fixed-layout R = 1 run "
        f"(SHA-1 {digest}); losses {losses}; the read before the second "
        f"reshard kept its bits; the read after round {AUTO_ROUNDS} == "
        f"fab.params; phase {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "round_ms": round_ms, "step_ms": step_ms,
            "apply_ms": apply_ms, "solve_ms": step_solve + plan_solve,
            "reshard_ms": reshard_ms, "retries": retries_by,
            "peak_bytes": peak, "events": events}


def _fabric_record(fab) -> dict:
    """A comparable record of a fabric: params, optimizer slots and codec
    residuals (host copies), every stats field, the fault traces, chunk
    ownership and chain racks."""
    fab._flat_cache = None
    return _record({
        "params": fab.params,
        "state": [fab._assemble_rows(lambda sh, k=k: sh.state[k]).reshape(-1)
                  for k in range(fab.spec.num_state_slots)],
        "ef": _residuals(fab), "stats": fab.stats,
        "shards": [sh.stats for sh in fab.shards],
        "racks": [r.stats for r in fab.rack_aggs],
        "trace": fab.fault_trace, "export": fab.export_fault_trace(),
        "owner": fab.chunk_owner, "plan": fab.plan.replica_racks,
        "chains": [g.racks for g in fab.replicas], "step": fab.step})


def _telemetry(auto):
    """``telemetry()``, or the error it raises (a SparseReadPlane's stats
    carry no SLO fields, in either package)."""
    try:
        return auto.telemetry()
    except AttributeError as e:
        return f"AttributeError: {e}"


def smoke_autoscale_check(dev, only=None) -> dict:
    """Phase 24: the closed loop at gemma3-1b's SMOKE config (its flat
    space, chunks of 4096, 4 workers, momentum), every case on ``dev``
    against the same case on the CPU, bitwise in params, optimizer slots,
    residuals, every stats field, the fault traces, ``auto.events``,
    ``describe()``, the ``telemetry()`` dict (key for key, float for
    float), the read planes' stats and reads, and the sparse tiers'
    tables, versions and stats.  Cases (tests/test_autoscaler.py's, on
    R = 2 fabrics under a ``NetworkTopology``): codec none / int8 x racks
    1 / 2 / 4 x shards 1 -> 2, 2 -> 8, 8 -> 2 (a chain re-home and a
    frontend move, then a ``shard_count`` delta; each run equals its
    fixed-layout twin on the card); scale-up and scale-down from busy
    telemetry; straggler proposals through ``ShardRebalancer``;
    ``resolve_placement`` (twice the same events); two sparse autoscaled
    runs (codec none / int8) whose 8-shard plan carries a solved row map
    from a Zipf row load (lookups, pushes and reads between the levers);
    a sparse reshard refused mid-round, then done and failed over; a
    ``tenant_shares`` plan through ``shared=`` on a MultiJobFabric.
    Gradients are numpy draws, the same bits on both devices.  Each case's
    launches on the card equal the CPU run's calls of the plain versions.
    ``only`` names a subset of the cases.  Returns each case's launches on
    ``dev``."""
    import numpy as np
    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.core import config as C
    from repro_torch.core import serving as S
    from repro_torch.core.chunking import ParamSpace
    from repro_torch.core.compression import CompressionConfig
    from repro_torch.core.fabric import PBoxFabric
    from repro_torch.core.placement import (
        PlacementProblem,
        PlanDelta,
        current_plan,
        diff_plans,
    )
    from repro_torch.core.sparse import SparseTier
    from repro_torch.core.tenancy import JobSpec, MultiJobFabric
    from repro_torch.core.topology import NetworkTopology
    from repro_torch.models import transformer as T
    from repro_torch.optim.optimizers import adamw, momentum
    from repro_torch.runtime.autoscaler import Autoscaler, AutoscalerPolicy
    from repro_torch.runtime.straggler import ShardRebalancer

    t_phase = time.perf_counter()
    k = 4  # workers, as tests/test_autoscaler.py's K
    v, d = 256, 16  # sparse table rows and width
    mcfg = get_arch("gemma3-1b").smoke_config
    tree = T.init_params(mcfg, torch.Generator().manual_seed(0),
                         device="cpu")
    space = ParamSpace.build(tree, chunk_elems=4096)
    init = space.flatten(tree)
    table = np.random.default_rng(7).standard_normal((v, d)).astype(
        np.float32)
    zipf = 1.0 / (np.arange(v) + 1.0) ** 1.05
    grads: dict = {}
    cpu = torch.device("cpu")

    def fabric(device, shards, racks, codec="none", R=2):
        return PBoxFabric(space, momentum(0.05, 0.9), init, device=device,
                          config=C.FabricConfig(
                              num_shards=shards, num_workers=k,
                              wire=C.WireConfig(
                                  topology=NetworkTopology(num_workers=k,
                                                           num_racks=racks),
                                  compression=CompressionConfig(codec=codec)),
                              faults=C.FaultConfig(replication=R)))

    def train(fab, r):
        n = fab.space.flat_elems
        for w in range(fab.num_workers):
            fab.pull(w)
        for w in range(fab.num_workers):
            key = (n, (w + r) % 4)
            if key not in grads:
                grads[key] = torch.from_numpy((1e-2 * np.random.default_rng(
                    key[1]).standard_normal(n)).astype(np.float32))
            fab.push(w, grads[key].to(fab.device))

    def perturb(base, racks):
        rr = np.asarray(base.replica_racks).copy()
        rr[0] = (rr[0] + 1) % racks
        fe = list(base.frontend_racks)
        if fe:
            fe[0] = (fe[0] + 1) % racks
        return base.replace(replica_racks=rr, frontend_racks=tuple(fe),
                            origin="solved")

    def outcome(auto, **extra):
        return {"events": auto.events, "describe": auto.describe(),
                "telemetry": _telemetry(auto),
                "fab": _fabric_record(auto.fabric),
                "planes": [p.stats for p in auto.planes],
                "frontends": [[fe.rack for fe in p.frontends]
                              for p in auto.planes], **extra}

    def dense_case(codec, racks, shards, target):
        def run(device):
            fa = fabric(device, shards, racks, codec)
            fb = fabric(device, shards, racks, codec)
            plane = S.ReadPlane(fb, config=C.ServeConfig(num_frontends=2))
            auto = Autoscaler(fb, planes=[plane], policy=AutoscalerPolicy(
                min_shards=1, max_shards=8, cooldown_rounds=0,
                solve_placement=False))
            for r in range(2):
                train(fa, r)
                train(fb, r)
            moved = auto.apply_plan(perturb(current_plan(fb, planes=[plane]),
                                            racks))
            for r in range(2, 4):
                train(fa, r)
                train(fb, r)
            auto.apply_delta(PlanDelta(kind="shard_count",
                                       new_shards=target))
            for r in range(4, 6):
                train(fa, r)
                train(fb, r)
            read = plane.read(0)
            checks = [same_bits(fa.params, fb.params),
                      same_bits(read.flat, fb.params),
                      fb.num_shards == target, fb.stats.rescales == 1,
                      racks == 1 or {"replica_racks", "frontend_move"}
                      <= {e.kind for e in moved}]
            return outcome(auto, read=read, checks=checks)
        return run

    def scale_up(device):
        fa, fb = fabric(device, 1, 2), fabric(device, 1, 2)
        auto = Autoscaler(fb, policy=AutoscalerPolicy(
            min_shards=1, max_shards=4, scale_up_busy_us=0.0,
            scale_down_busy_us=0.0, cooldown_rounds=1,
            solve_placement=False))
        ticks = []
        for r in range(4):
            train(fa, r)
            train(fb, r)
            ticks.append(_telemetry(auto))
            auto.step()
        checks = [fb.num_shards == 4, fb.stats.rescales == 2,
                  same_bits(fa.params, fb.params)]
        return outcome(auto, ticks=ticks, checks=checks)

    def scale_down(device):
        fab = fabric(device, 8, 2)
        auto = Autoscaler(fab, policy=AutoscalerPolicy(
            min_shards=2, max_shards=8, scale_up_busy_us=1e12,
            scale_down_busy_us=1e12, cooldown_rounds=0,
            solve_placement=False))
        train(fab, 0)
        shards = []
        for _ in range(3):
            auto.step()
            shards.append(fab.num_shards)
        train(fab, 1)
        return outcome(auto, checks=[shards == [4, 2, 2]])

    def straggler(device):
        fa, fb = fabric(device, 4, 2), fabric(device, 4, 2)
        reb_a = ShardRebalancer(fa, cooldown=0)
        reb_b = ShardRebalancer(fb, cooldown=0)
        auto = Autoscaler(fb, rebalancer=reb_b,
                          policy=AutoscalerPolicy(solve_placement=False))
        for r in range(2):
            train(fa, r)
            train(fb, r)
        for _ in range(25):
            for reb in (reb_a, reb_b):
                reb.record(0, 10.0)
                for sh in range(1, 4):
                    reb.record(sh, 0.1)
        legacy = reb_a.maybe_rebalance()
        events = auto.step()
        for r in range(2, 4):
            train(fa, r)
            train(fb, r)
        checks = [legacy == [0], [e.kind for e in events] == ["chunk_moves"],
                  fb.shards[0].num_chunks == 0,
                  np.array_equal(fa.chunk_owner, fb.chunk_owner),
                  same_bits(fa.params, fb.params)]
        return outcome(auto, checks=checks)

    def resolve(device):
        runs = []
        for _ in range(2):
            fab = fabric(device, 4, 2)
            plane = S.ReadPlane(fab, config=C.ServeConfig(num_frontends=2))
            auto = Autoscaler(fab, planes=[plane], seed=3)
            for r in range(2):
                train(fab, r)
            events = auto.resolve_placement()
            for r in range(2, 4):
                train(fab, r)
            runs.append((auto, [(e.kind, e.detail) for e in events]))
        plain = fabric(device, 4, 2)
        for r in range(4):
            train(plain, r)
        (auto, ev_a), (twin, ev_b) = runs
        checks = [ev_a == ev_b,
                  same_bits(auto.fabric.params, twin.fabric.params),
                  same_bits(plain.params, auto.fabric.params)]
        return outcome(auto, checks=checks)

    def sparse_stack(device, codec):
        fab = fabric(device, 2, 2)
        plane = S.ReadPlane(fab, config=C.ServeConfig(num_frontends=2))
        tier = SparseTier(fabric=fab, codec=codec, lr=0.1)
        tier.add_table("t0", table)
        splane = S.SparseReadPlane(tier, config=C.ServeConfig(
            num_frontends=2, cache_rows=64))
        return fab, plane, tier, splane

    def sparse_round(tier, rng, out):
        for w in range(tier.num_workers):
            ids = rng.integers(0, v, size=24)
            out.append(tier.lookup(w, "t0", ids[:12], np.arange(0, 13, 3)))
            rows = rng.standard_normal((24, d)).astype(np.float32)
            tier.push(w, {"t0": (ids, torch.from_numpy(rows).to(
                tier.device))})

    def sparse_case(codec):
        def run(device):
            fa, _, ta, _ = sparse_stack(device, codec)
            fb, plane, tb, splane = sparse_stack(device, codec)
            auto = Autoscaler(fb, planes=[plane, splane],
                              policy=AutoscalerPolicy(cooldown_rounds=0))
            looked: list = []
            for run_id, (fab, tier) in enumerate(((fa, ta), (fb, tb))):
                rng = np.random.default_rng(11)
                for r in range(2):
                    train(fab, r)
                    sparse_round(tier, rng, looked if run_id else [])
            moved = auto.apply_plan(perturb(
                current_plan(fb, planes=[plane, splane]), 2))
            plan = PlacementProblem.standard(
                num_shards=8, num_racks=2, replication=2, num_frontends=4,
                chunk_elems=space.chunk_elems,
                row_load={"t0": zipf}).solve(seed=0)
            rescale = auto.apply_plan(plan)
            for run_id, (fab, tier) in enumerate(((fa, ta), (fb, tb))):
                rng = np.random.default_rng(13)
                for r in range(2, 4):
                    train(fab, r)
                    sparse_round(tier, rng, looked if run_id else [])
            res = splane.read_rows(1, "t0", np.arange(v))
            checks = [any(e.kind == "frontend_move" for e in moved),
                      [e.kind for e in rescale] == ["reshard"],
                      tb.num_shards == 8 and tb.stats.rescales == 1,
                      tb.tables["t0"].placement.policy == "plan",
                      np.array_equal(tb.tables["t0"].placement.owner,
                                     plan.row_owner["t0"]),
                      same_bits(fa.params, fb.params),
                      same_bits(ta.table("t0"), tb.table("t0")),
                      np.array_equal(ta.row_versions("t0"),
                                     tb.row_versions("t0")),
                      same_bits(res.rows, tb.table("t0"))]
            return outcome(auto, checks=checks, looked=looked, rows=res,
                           table=tb.table("t0"),
                           versions=tb.row_versions("t0"),
                           tier=tb.stats, owner=plan.row_owner["t0"],
                           describe_tier=tb.describe())
        return run

    def sparse_failover(device):
        fab = fabric(device, 2, 2)
        tier = SparseTier(fabric=fab, replication=2)
        tier.add_table("t0", table)
        out: list = []
        sparse_round(tier, np.random.default_rng(5), out)
        ones = torch.ones((4, d), device=tier.device)
        tier.push(0, {"t0": (np.arange(4), ones)})
        try:
            tier.reshard(4)
            refused = None
        except RuntimeError as e:
            refused = str(e)
        for w in range(1, tier.num_workers):
            tier.push(w, {"t0": (np.arange(4), ones)})
        before = tier.table("t0").clone()
        tier.reshard(4)
        kept = same_bits(tier.table("t0"), before)
        action = tier.failover(1)
        checks = [refused is not None, kept, len(tier._chains) == 4,
                  same_bits(tier.table("t0"), before)]
        return {"refused": refused, "action": action, "checks": checks,
                "looked": out, "table": tier.table("t0"),
                "versions": tier.row_versions("t0"), "tier": tier.stats,
                "describe": tier.describe()}

    def shares(device):
        def attach_two(box):
            return [box.attach(JobSpec(name=name, params=tree,
                                       optimizer=adamw(3e-3), num_workers=2,
                                       chunk_elems=4096, priority=pri))
                    for name, pri in (("a", 2.0), ("b", 1.0))]

        box = MultiJobFabric(num_shards=2, num_racks=2, device=device)
        handles = attach_two(box)
        for h in handles:
            train(h, 0)
        auto = Autoscaler(handles[0].fabric, shared=box)
        base = current_plan(handles[0].fabric)
        first = auto.apply_plan(base.replace(
            tenant_shares={"a": 1.0, "b": 3.0}))
        again = auto.apply_plan(base.replace(
            tenant_shares={"a": 1.0, "b": 3.0}))
        solved = PlacementProblem.standard(
            num_shards=2, num_racks=2,
            tenant_demand={"a": 2.0, "b": 5.0}).solve(seed=0)
        auto.apply_delta(diff_plans(base, solved)[-1])
        for h in handles:
            train(h, 1)
        plain = MultiJobFabric(num_shards=2, num_racks=2, device=device)
        for h in attach_two(plain):
            train(h, 0)
            train(h, 1)
        checks = [[e.kind for e in first] == ["tenant_shares"], again == [],
                  box._share_override == {"a": 1.0, "b": 2.5},
                  all(same_bits(h.fabric.params, p.fabric.params)
                      for h, p in zip(handles, plain.jobs.values()))]
        return outcome(auto, checks=checks,
                       tenants=[_fabric_record(h.fabric) for h in handles],
                       util=box.utilization(), box=box.describe(),
                       links={n: dict(q.stats.by_job)
                              for n, q in box.links.items()})

    cases = {f"dense/{codec}/racks{racks}/{s}->{t}": dense_case(
        codec, racks, s, t) for codec in ("none", "int8")
        for racks in (1, 2, 4) for s, t in ((1, 2), (2, 8), (8, 2))}
    cases |= {"scale_up/busy": scale_up, "scale_down/idle": scale_down,
              "straggler/delta_path": straggler, "resolve/seed3": resolve}
    cases |= {f"sparse/{codec}/solved_rows": sparse_case(codec)
              for codec in ("none", "int8")}
    cases |= {"sparse/reshard+failover": sparse_failover,
              "tenant_shares/shared": shares}
    if only is not None:
        cases = {label: cases[label] for label in only}
    launches = {}
    for label, run in cases.items():
        _zero_counts()
        card = _record(run(dev))
        torch.cuda.synchronize()
        launches[label] = _counts()
        with PlainCalls() as plain:
            host = _record(run(cpu))
        if not all(card["checks"]):
            raise AssertionError(f"{label}: checks on {dev} {card['checks']}")
        _same_record(card, host, label)
        if launches[label] != plain.counts:
            raise AssertionError(f"{label}: card launches {launches[label]},"
                                 f" CPU plain-version calls {plain.counts}")
        if not any(launches[label].values()):
            raise AssertionError(f"{label}: no kernel launched")
    grads.clear()
    total = {key: sum(c[key] for c in launches.values()) for key in _counts()}
    log(f"SMOKE autoscale sweep: {len(cases)} cases card == CPU bitwise "
        f"(params, slots, residuals, every stats field, fault traces, "
        f"events, describe, telemetry, reads, sparse tables); each "
        f"autoscaled run == its fixed-layout twin on {dev.type}; launches "
        f"{total}, each case's equal to the CPU run's plain-version calls; "
        f"{time.perf_counter() - t_phase:.1f} s")
    return launches


# -- phase 19: kernel timings ------------------------------------------------
def time_fused_agg_opt(dev, n: int, k: int, average: bool = True) -> dict:
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
    want_p, want_s = K.fused_agg_opt_torch(grads, p, (m, v), packet, spec,
                                           average=average)
    K.fused_agg_opt_cuda(grads, p, (m, v), packet, spec,
                         average=average)  # in place
    torch.cuda.synchronize()
    err = max(max_abs_err(p, want_p), *[max_abs_err(a, b) for a, b in
                                        zip((m, v), want_s)])
    if not (torch.equal(p, want_p) and torch.equal(m, want_s[0])
            and torch.equal(v, want_s[1])):
        raise AssertionError(f"kernel differs at the main shape, max |err| {err}")
    del want_p, want_s
    kernel_ms = cuda_ms(lambda: K.fused_agg_opt_cuda(
        grads, p, (m, v), packet, spec, average=average), reps=20)
    plain_ms = cuda_ms(lambda: K.fused_agg_opt_torch(
        grads, p, (m, v), packet, spec, average=average), reps=5)
    b = bound(torch.cuda.get_device_name(dev),
              (k * 4 + 2 * 4 + 2 * 2 * 4) * n,  # grads in; param, m, v in+out
              adamw_ops(k) * n)
    log(f"timing fused_agg_opt (AdamW, K={k}, average={average}, N={n}, "
        f"f32): kernel "
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


def time_wire(dev, n: int, k: int, chunk: int, average: bool = True) -> dict:
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
                                        codec="int8", chunk_elems=chunk,
                                        average=average)
    W.wire_fused_cuda(pay, sc, p, (m, v), packet, spec, codec="int8",
                      chunk_elems=chunk, average=average)  # in place
    torch.cuda.synchronize()
    err = max(max_abs_err(p, want_p), *[max_abs_err(a, b) for a, b in
                                        zip((m, v), want_s)])
    if not (same_bits(p, want_p) and same_bits(m, want_s[0])
            and same_bits(v, want_s[1])):
        raise AssertionError(f"wire_fused differs at the main shape, max |err| {err}")
    del want_p, want_s
    kernel_ms = cuda_ms(lambda: W.wire_fused_cuda(
        pay, sc, p, (m, v), packet, spec, codec="int8", chunk_elems=chunk,
        average=average), reps=20)
    plain_ms = cuda_ms(lambda: W.wire_fused_torch(
        pay, sc, p, (m, v), packet, spec, codec="int8", chunk_elems=chunk,
        average=average), reps=3)
    unfused_ms = cuda_ms(lambda: unfused_wire_update(
        pay, sc, p, (m, v), spec, 1, codec="int8", chunk_elems=chunk,
        average=average), reps=10)
    b = bound(torch.cuda.get_device_name(dev),
              (k * 1 + 2 * 4 + 2 * 2 * 4) * n + 4 * k * c,
              (k + adamw_ops(k)) * n)
    log(f"timing wire_fused (AdamW, K={k} int8 streams, average={average}, "
        f"N={n}, chunk "
        f"{chunk}): kernel {kernel_ms:.4f} ms (median of 20), plain version "
        f"{plain_ms:.4f} ms (median of 3), unfused kernel pipeline "
        f"(dequantize x{k} + fused_agg_opt) {unfused_ms:.4f} ms (median of "
        f"10); bound {b['bound_ms']:.4f} ms = {b['bytes']} bytes (operations: "
        f"{b['op_ms']:.4f} ms); kernel reaches "
        f"{b['bound_ms'] / kernel_ms:.1%} of the bound; library: none")
    return {"ms": kernel_ms, "plain_ms": plain_ms, "unfused_ms": unfused_ms,
            "max_abs_err": err, "library_ms": None, **b}


def _graph_or_events(calls: list, label: str) -> tuple:
    """(ms, how): ``graph_ms`` of the calls, or, where a call cannot be
    captured in a CUDA graph, the median of CUDA events around each."""
    import torch

    try:
        return graph_ms(calls), "graph"
    except RuntimeError as exc:
        torch.cuda.synchronize()
        log(f"  {label}: not capturable in a CUDA graph ({str(exc)[:120]}); "
            f"timed with CUDA events around each call")
        return cuda_ms(calls[0], reps=20), "events"


def time_embedding_bag(dev, b: int, length: int, d: int, vocab: int,
                       label: str, sets: int) -> dict:
    """embedding_bag as the sparse tier calls it: ``b`` bags of ``length``
    ids drawn from ``vocab`` rows, the (U, d) block of unique rows and the
    block-local indices.  ``sets`` such inputs are cycled through, so the
    calls' working set exceeds the 50 MB L2 as a cold lookup's would.
    Beside its plain version and ``torch.nn.functional.embedding_bag`` with
    per-sample weights (sum), which the port never calls."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.embedding_bag import kernel as E

    inputs = []
    for i in range(sets):
        rng = np.random.default_rng(50 + i)
        uniq, inv = np.unique(rng.integers(0, vocab, b * length),
                              return_inverse=True)
        gen = torch.Generator(device=dev).manual_seed(50 + i)
        block = torch.randn((uniq.size, d), generator=gen, device=dev) * 0.01
        idx = torch.from_numpy(inv.reshape(b, length).astype(np.int32)).to(dev)
        w = (torch.ones((b, length), device=dev) if length == 1 else
             torch.rand((b, length), generator=gen, device=dev))
        inputs.append((block, idx, w, idx.long()))
    block, idx, w, idx64 = inputs[0]
    u = block.shape[0]
    got = E.embedding_bag_cuda(block, idx, w)
    want = E.embedding_bag_torch(block, idx, w)
    lib = F.embedding_bag(idx64, block, per_sample_weights=w, mode="sum")
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    if not same_bits(got, want):
        raise AssertionError(f"embedding_bag differs at the {label} shape, "
                             f"max |err| {err}")
    lib_same, lib_err = same_bits(lib, want), max_abs_err(lib, want)
    del got, want, lib
    reps = max(1, 20 // sets)
    kernel_ms, _ = _graph_or_events(
        [lambda x=x: E.embedding_bag_cuda(x[0], x[1], x[2])
         for x in inputs] * reps, "embedding_bag")
    lib_ms, lib_how = _graph_or_events(
        [lambda x=x: F.embedding_bag(x[3], x[0], per_sample_weights=x[2],
                                     mode="sum") for x in inputs] * reps,
        "F.embedding_bag")
    events_ms = cuda_ms(lambda: E.embedding_bag_cuda(block, idx, w), reps=20)
    plain_ms = cuda_ms(lambda: E.embedding_bag_torch(block, idx, w), reps=5)
    # each touched row read once, the (B, L) int32 ids and f32 weights, the
    # (B, D) output written once; an FMA (2 ops) an element a slot
    bnd = bound(torch.cuda.get_device_name(dev), u * d * 4 + b * length * 8
                + b * d * 4, 2 * b * length * d)
    log(f"timing embedding_bag ({label}: B={b}, L={length}, D={d}, U={u} "
        f"unique rows of {vocab}; {sets} input sets cycled): kernel "
        f"{kernel_ms:.4f} ms a call (CUDA graph of {sets * reps} calls, "
        f"median of 5 replays; CUDA events around one call, host launch "
        f"included: {events_ms:.4f}), plain version {plain_ms:.4f} ms "
        f"(events, median of 5); bound {bnd['bound_ms']:.4f} ms = "
        f"{bnd['bytes']} bytes; kernel reaches "
        f"{bnd['bound_ms'] / kernel_ms:.1%} of the bound; "
        f"F.embedding_bag(per_sample_weights, sum) {lib_ms:.4f} ms "
        f"({lib_how}), same bits: {lib_same} (max |err| {lib_err})")
    return {"ms": kernel_ms, "plain_ms": plain_ms, "max_abs_err": err,
            "library_ms": lib_ms, "library_same_bits": lib_same, "u": u,
            "ms_events": events_ms,
            "shape": {"b": b, "l": length, "d": d, "u": u, "vocab": vocab},
            **bnd}


def time_segment_sum(dev, n: int, d: int, vocab: int) -> dict:
    """segment_sum as a push coalesces the largest table: ``n`` ids drawn
    from ``vocab`` rows, the (n, d) rows a strided column of the (n, 26, d)
    cotangent; four columns are cycled through (past the 50 MB L2).
    Beside its plain version and ``index_add_`` into zeros, which the port
    never calls (its atomics fold duplicates in no fixed order)."""
    import numpy as np
    import torch

    from repro_torch.kernels.embedding_bag import kernel as E

    rng = np.random.default_rng(6)
    uniq, inv = np.unique(rng.integers(0, vocab, n), return_inverse=True)
    u = uniq.size
    gen = torch.Generator(device=dev).manual_seed(6)
    cot = torch.randn((n, 26, d), generator=gen, device=dev)
    cols = [cot[:, i] for i in range(4)]
    order = torch.from_numpy(np.argsort(inv, kind="stable")).to(dev)
    seg = torch.from_numpy(np.concatenate(
        [[0], np.cumsum(np.bincount(inv))]).astype(np.int64)).to(dev)
    inv_t = torch.from_numpy(inv.astype(np.int64)).to(dev)
    rows = cols[0]
    got = E.segment_sum_cuda(rows, order, seg)
    want = E.segment_sum_torch(rows, order, seg)
    lib = torch.zeros((u, d), device=dev).index_add_(0, inv_t, rows)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    if not same_bits(got, want):
        raise AssertionError(f"segment_sum differs at the main shape, max |err| {err}")
    lib_same = same_bits(lib, want)
    del got, want, lib
    kernel_ms, _ = _graph_or_events(
        [lambda r=r: E.segment_sum_cuda(r, order, seg) for r in cols] * 5,
        "segment_sum")
    lib_ms, lib_how = _graph_or_events(
        [lambda r=r: torch.zeros((u, d), device=dev).index_add_(0, inv_t, r)
         for r in cols] * 5, "index_add_")
    events_ms = cuda_ms(lambda: E.segment_sum_cuda(rows, order, seg), reps=20)
    plain_ms = cuda_ms(lambda: E.segment_sum_torch(rows, order, seg), reps=5)
    # rows read once, order and offsets, the (U, D) sums written once
    bnd = bound(torch.cuda.get_device_name(dev),
                n * d * 4 + n * 8 + (u + 1) * 8 + u * d * 4, n * d)
    log(f"timing segment_sum (n={n}, D={d}, U={u} of {vocab}, strided rows, "
        f"4 columns cycled): kernel {kernel_ms:.4f} ms a call (CUDA graph of "
        f"20 calls, median of 5 replays; CUDA events around one call: "
        f"{events_ms:.4f}), plain version {plain_ms:.4f} ms (events, median "
        f"of 5); bound {bnd['bound_ms']:.4f} ms = {bnd['bytes']} bytes; "
        f"kernel reaches {bnd['bound_ms'] / kernel_ms:.1%} of the bound; "
        f"zeros + index_add_ {lib_ms:.4f} ms ({lib_how}), same bits: "
        f"{lib_same}")
    del cot, cols
    return {"ms": kernel_ms, "plain_ms": plain_ms, "max_abs_err": err,
            "library_ms": lib_ms, "library_same_bits": lib_same,
            "ms_events": events_ms,
            "shape": {"n": n, "d": d, "u": u, "vocab": vocab}, **bnd}


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
             "wire_fused": wire_sweep(dev), **bag_sweep(dev)}
    f32 = main_path(dev, "none")
    f32_err = replay_f32(dev, f32)
    f32.pop("captured")
    int8 = main_path(dev, "int8")
    int8_err = replay_wire(dev, int8)
    codec_err = replay_codec(int8)
    int8.pop("captured")
    dlrm = dlrm_path(dev)
    dlrm_err = replay_dlrm(dlrm)
    dlrm.pop("captured")
    dlrm_sharding_check(dev)
    rehearsal = fault_rehearsal()
    with deterministic():
        gw = GemmaWorkers(dev)
        quorum = quorum_path(dev, gw)
        asyn = async_path(dev, gw)
        snap = snapshot_path(dev, gw)
        rack = rack_chain_path(dev, gw)
        switch = switch_path(dev, gw)
        fault = failover_path(dev, gw, rehearsal)
        auto = autoscale_path(dev, gw, fault)
        del gw
        torch.cuda.empty_cache()
        tenancy = tenancy_path(dev)
    async_err = replay_wire(dev, asyn)
    asyn.pop("captured")
    smoke = smoke_modes_check(dev)
    smoke_topo = smoke_topology_check(dev)
    smoke_fault = smoke_fault_check(dev)
    smoke_tenancy = smoke_tenancy_check(dev)
    torch.cuda.empty_cache()
    serve = serve_path(dev)
    sparse_serve = sparse_serve_path(dev)
    smoke_serve = smoke_serve_check(dev)
    smoke_auto = smoke_autoscale_check(dev)
    switch_math = switch_math_ms(dev, int8["flat"], int8["chunk"])
    d = dlrm_capped_config().embed_dim
    timing = {"fused_agg_opt": time_fused_agg_opt(dev, f32["n"], WORKERS),
              **time_quant(dev, int8["flat"], int8["chunk"]),
              "wire_fused": time_wire(dev, int8["n"], WORKERS, int8["chunk"]),
              # the async path's K = 1 pushes, without averaging
              "fused_agg_opt_k1": time_fused_agg_opt(dev, f32["n"], 1,
                                                     average=False),
              "wire_fused_k1": time_wire(dev, asyn["n"], 1, asyn["chunk"],
                                         average=False),
              "embedding_bag": time_embedding_bag(
                  dev, DLRM_BATCH, 1, d, DLRM_ROW_CAP, "one-hot main path", 4),
              "segment_sum": time_segment_sum(dev, DLRM_BATCH, d, DLRM_ROW_CAP)}
    multi_hot = time_embedding_bag(dev, DLRM_BATCH, 20, d, DLRM_ROW_CAP,
                                   "multi-hot", 2)
    replayed = {"fused_agg_opt": f32_err,
                "wire_fused": max(int8_err, async_err), **codec_err,
                **dlrm_err}
    # every path's launches, by kernel; the SMOKE cases summed
    paths = {"f32": f32["launches"], "int8": int8["launches"],
             "dlrm": dlrm["launches"], "quorum": quorum["launches"],
             "async_int8": asyn["launches"],
             "snapshot_run_a": snap["launches_a"],
             "snapshot_run_b": snap["launches_b"],
             "smoke_modes": {k: sum(c[k] for c in smoke.values())
                             for k in f32["launches"]},
             "rack_chain": rack["launches"],
             "rack_flat_reference": rack["flat_launches"],
             **{f"switch_{label.replace(' ', '_')}": run["launches"]
                for label, run in switch.items()},
             "smoke_topology": {k: sum(c[k] for c in smoke_topo.values())
                                for k in f32["launches"]},
             "failover_run_a": fault["launches_a"],
             "failover_run_b": fault["launches_b"],
             "smoke_faults": {k: sum(c[k] for c in smoke_fault.values())
                              for k in f32["launches"]},
             "tenancy_box": tenancy["launches"],
             "tenancy_twins": tenancy["twin_launches"],
             "smoke_tenancy": {k: sum(c[k] for c in smoke_tenancy.values())
                               for k in f32["launches"]},
             "serve_gemma": serve["launches"],
             "serve_sparse": sparse_serve["launches"],
             "smoke_serve": {k: sum(c[k] for c in smoke_serve.values())
                             for k in f32["launches"]},
             "autoscale_gemma": auto["launches"],
             "smoke_autoscale": {k: sum(c[k] for c in smoke_auto.values())
                                 for k in f32["launches"]}}
    # K = 1 without averaging: the async pushes (f32 ones only at SMOKE)
    k1_launches = {"fused_agg_opt": smoke["async/none"]["fused_agg_opt"],
                   "wire_fused": asyn["launches"]["wire_fused"]
                   + smoke["async/int8"]["wire_fused"]}
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
        ("embedding_bag", "embedding_bag.cu", "embedding_bag/kernel.py:32",
         dlrm, {**timing["embedding_bag"]["shape"], "dtype": "f32",
                "multi_hot_l20": {k: multi_hot[k] for k in (
                    "ms", "plain_ms", "bound_ms", "library_ms", "u")}}),
        ("segment_sum", "embedding_bag.cu",
         "src/repro/runtime/sparse_push.py:59", dlrm, {**timing["segment_sum"]["shape"],
                              "dtype": "f32"}),
    ]
    kernels = []
    for kname, src, tpu, run, shape in rows:
        t = timing[kname]
        kernels.append({
            "name": kname,
            "route": "cuda",
            "source": f"src/repro_torch/csrc/{src}",
            # segment_sum replaces jax.ops.segment_sum, an XLA op (no TPU
            # kernel): the sparse push's in-order duplicate fold
            "replaces": tpu if tpu.startswith("src/")
                        else f"src/repro/kernels/{tpu}",
            "held_against": f"{kname}_torch" if kname != "wire_fused"
                            else "wire_fused_torch and dequantize+fused_agg_opt",
            **({"library_same_bits": t["library_same_bits"]}
               if "library_same_bits" in t else {}),
            "match": "bitwise",
            "launches": run["launches"][kname],
            "max_abs_err": max(sweep[kname], replayed.get(kname, 0.0),
                               t["max_abs_err"]),
            "ms": t["ms"],
            "main_path_ms": run["main_path_ms"] if run["kernel"] == kname
                            else run.get("segment_main_path_ms")
                            if kname == "segment_sum" else None,
            **({"ms_events": t["ms_events"]} if "ms_events" in t else {}),
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "shape": shape,
            "launches_by_path": {p: c[kname] for p, c in paths.items()},
            **({"k1_no_average": {
                "launches": k1_launches[kname],
                **{key: timing[f"{kname}_k1"][key] for key in (
                    "ms", "plain_ms", "bound_ms", "bound_by",
                    "max_abs_err")}}} if kname in k1_launches else {}),
        })
    log(f"main path peaks: f32 {f32['peak_bytes'] / 2**30:.2f} GiB, int8 "
        f"{int8['peak_bytes'] / 2**30:.2f} GiB, dlrm "
        f"{dlrm['peak_bytes'] / 2**30:.2f} GiB, quorum "
        f"{quorum['peak_bytes'] / 2**30:.2f} GiB, async int8 "
        f"{asyn['peak_bytes'] / 2**30:.2f} GiB, snapshot "
        f"{snap['peak_bytes'] / 2**30:.2f} GiB, rack chain "
        f"{rack['peak_bytes'] / 2**30:.2f} GiB (its flat reference "
        f"{rack['flat_peak_bytes'] / 2**30:.2f}), switch "
        + ", ".join(f"{label} {run['peak_bytes'] / 2**30:.2f} GiB"
                    for label, run in switch.items())
        + "; steady rounds (round 2): rack chain "
        f"{rack['round_ms'][1]:.1f} ms (flat {rack['flat_round_ms'][1]:.1f}), "
        + ", ".join(f"switch {label} {run['round_ms'][1]:.1f} ms"
                    for label, run in switch.items())
        + f"; failover run A {fault['peak_a'] / 2**30:.2f} GiB, run B "
        f"{fault['peak_b'] / 2**30:.2f} GiB (its reshard "
        f"{fault['reshard_peak_bytes'] / 2**30:.2f}), steady rounds (round "
        f"2) A {fault['round_ms_a'][1]:.1f} ms, B {fault['round_ms_b'][1]:.1f}"
        f" ms, chain pass {statistics.median(fault['chain_ms']):.3f} ms"
        f"; tenancy shared run {tenancy['peak_shared'] / 2**30:.2f} GiB, "
        f"twins {tenancy['peak_twin_a'] / 2**30:.2f} / "
        f"{tenancy['peak_twin_b'] / 2**30:.2f} GiB, steady rounds (round 2)"
        f" shared a {tenancy['shared_ms']['a'][1]:.1f} / b "
        f"{tenancy['shared_ms']['b'][1]:.1f} ms, dedicated a "
        f"{tenancy['dedicated_ms']['a'][1]:.1f} / b "
        f"{tenancy['dedicated_ms']['b'][1]:.1f} ms, detach "
        f"{tenancy['detach_ms']:.1f} ms, re-attach {tenancy['attach_ms']:.1f}"
        f" ms; serve gemma {serve['peak_bytes'] / 2**30:.2f} GiB (assemble "
        f"{statistics.median(serve['assemble_ms']):.3f} ms, miss "
        f"{statistics.median(serve['miss_ms']):.2f} ms, hit "
        f"{statistics.median(serve['hit_ms']):.3f} ms, prefill 4 x {SEQ} "
        f"{statistics.median(serve['prefill_ms']):.2f} ms, decode step "
        f"{statistics.median(serve['decode_step_ms']):.3f} ms), sparse serve "
        f"{sparse_serve['peak_bytes'] / 2**30:.2f} GiB (read_rows "
        f"{statistics.median(sparse_serve['read_ms']):.1f} ms a batch, hit "
        f"rate {sparse_serve['stats']['row_hits'] / sparse_serve['served']:.4f})"
        + f"; autoscale {auto['peak_bytes'] / 2**30:.2f} GiB (rounds "
        f"{[round(x, 1) for x in auto['round_ms']]} ms, reshards "
        f"{[round(x, 1) for x in auto['reshard_ms']]} ms, solves "
        f"{[round(x, 2) for x in auto['solve_ms']]} ms, retries "
        f"{auto['retries']})"
        + f"; switch integer math "
        f"{sum(v['ms'] for v in switch_math.values()):.3f} ms; whole run "
        f"{time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
