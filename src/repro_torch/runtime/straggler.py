"""Straggler mitigation policies for PS training (torch counterpart of
``repro/runtime/straggler.py``).

The mitigation levers are the PS-level ones the paper's design enables,
implemented by the port's fabric (``core/fabric.py``):

  * backup-worker quorum: the fabric applies the update once
    ``min_push_fraction`` of workers have pushed; a push computed against
    params a quorum round superseded is refused at admission
    (``ServerStats.late_pushes_dropped``), so stale gradients neither join
    a later round's quorum nor bias its average.
  * bounded staleness (SSP): workers may run ahead up to ``staleness`` steps
    -- hides transient slowness without losing gradients.
  * chunk rebalancing: if a PS *shard* is persistently slow, its chunks are
    re-assigned to healthy shards; parameters and optimizer state migrate
    with their chunks (``PBoxFabric.rebalance``), so the move is
    numerics-neutral.

``StragglerMonitor`` detects persistent stragglers from per-step latencies
(median-based, robust to noise); ``ShardRebalancer`` closes the loop from
shard latency measurements to fabric chunk re-assignment.  The chunk
re-assignment policy (``rebalance_chunks``) lives in ``core/placement.py``
and is re-exported here.  This module is numpy only.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.placement import PlanDelta as PlanDelta
from repro_torch.core.placement import chunk_rebalance_delta as chunk_rebalance_delta
from repro_torch.core.placement import rebalance_chunks as rebalance_chunks


@dataclasses.dataclass
class StragglerPolicy:
    mode: str = "sync"  # "sync" | "backup" | "stale"
    min_push_fraction: float = 1.0  # backup mode: quorum fraction
    staleness: int = 0  # SSP bound

    def server_kwargs(self) -> dict:
        if self.mode == "backup":
            return {"mode": "sync", "min_push_fraction": self.min_push_fraction}
        if self.mode == "stale":
            return {"mode": "stale", "staleness": self.staleness}
        return {"mode": "sync"}


class StragglerMonitor:
    """Flags workers whose push latency is persistently above
    ``threshold`` x the fleet median."""

    def __init__(self, n_workers: int, threshold: float = 2.0, window: int = 20):
        self.lat = [[] for _ in range(n_workers)]
        self.threshold = threshold
        self.window = window

    def record(self, worker: int, seconds: float) -> None:
        w = self.lat[worker]
        w.append(seconds)
        if len(w) > self.window:
            w.pop(0)

    def stragglers(self) -> list[int]:
        meds = [np.median(w) if w else 0.0 for w in self.lat]
        fleet = np.median([m for m in meds if m > 0] or [0.0])
        if fleet <= 0:
            return []
        return [i for i, m in enumerate(meds) if m > self.threshold * fleet]


class ShardRebalancer:
    """The fabric-side straggler loop: record per-shard aggregation
    latencies, and when a shard is persistently slow, move its chunks to
    healthy shards via ``PBoxFabric.rebalance``.

    ``cooldown`` fabric steps must elapse between rebalances so a single
    latency spike can't thrash chunk ownership."""

    def __init__(self, fabric, *, threshold: float = 2.0, window: int = 20,
                 cooldown: int = 10):
        self.fabric = fabric
        self.monitor = StragglerMonitor(fabric.num_shards, threshold, window)
        self.cooldown = cooldown
        self._last_rebalance_step = -cooldown

    def record(self, shard: int, seconds: float) -> None:
        self.monitor.record(shard, seconds)

    def speeds(self) -> np.ndarray:
        """Per-shard median aggregation latency (seconds; 0.0 with no
        samples) — the autoscaler's shard-speed telemetry feed."""
        return np.array([np.median(w) if w else 0.0
                         for w in self.monitor.lat], dtype=np.float64)

    def _slow_movable(self) -> tuple[list[int], list[int]]:
        slow = self.monitor.stragglers()
        movable = [s for s in slow
                   if self.fabric.shards[s].num_chunks > 0]
        return slow, movable

    def propose(self) -> PlanDelta | None:
        """The rebalancer as a plan-delta producer: the chunk moves it
        *would* apply right now, as a ``chunk_moves`` delta — or None
        when on cooldown, nothing is slow, or no healthy target exists.
        The caller (the autoscaler) applies the delta through
        ``PBoxFabric.apply_plan_delta`` and reports back with
        ``mark_applied()`` so the cooldown clock advances exactly as in
        the self-applying loop."""
        if self.fabric.step - self._last_rebalance_step < self.cooldown:
            return None
        slow, movable = self._slow_movable()
        if not movable:
            return None
        return chunk_rebalance_delta(self.fabric.chunk_owner, slow,
                                     self.fabric.num_shards)

    def mark_applied(self) -> None:
        """Start the cooldown window: a proposed delta was applied."""
        self._last_rebalance_step = self.fabric.step

    def maybe_rebalance(self) -> list[int]:
        """Returns the shards drained this call ([] if none).

        The whole slow set — including shards already drained to zero
        chunks — is passed to ``rebalance`` so a still-slow empty shard is
        never the minimum-count *target* for another straggler's chunks.
        (A shard that genuinely recovers stops being flagged and rejoins
        the healthy pool.)"""
        if self.fabric.step - self._last_rebalance_step < self.cooldown:
            return []
        slow, movable = self._slow_movable()
        if not movable:
            return []
        self.fabric.rebalance(slow)
        self._last_rebalance_step = self.fabric.step
        return movable
