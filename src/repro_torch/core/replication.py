"""Chain replication and deterministic faults for the PS tiers (torch
counterpart of ``repro/core/replication.py``).

Ported so far:

  ``ShardLost``     the sparse tier raises it when a shard fails with no
                    surviving replica.
  ``FaultPlan``     a deterministic, seedable schedule of ``FaultEvent``s
                    keyed on the fabric's aggregation round, drawn once at
                    build time (``generate``) and replayable from its JSON
                    (``to_json``/``from_json``).  The fabric fires the
                    switch kinds (``switch_fail``/``switch_restore``);
                    ``FabricConfig.validate`` refuses a plan holding any
                    other kind until the fault tier is ported.

``ReplicaGroup`` waits for the port's fault tier.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Iterable

import numpy as np

FAULT_KINDS = (
    "shard_crash",  # target: shard id — primary engine dies at a round edge
    "worker_crash",  # target: worker id — its in-flight stream dies with it
    "worker_recover",  # target: worker id — re-entry via snapshot/restore
    "link_degrade",  # target: rack id — rack link slows by ``factor``
    "link_restore",  # target: rack id — degradation lifted
    # switch tier (core/topology.SwitchCompute): target rack id fails that
    # ToR's aggregation pool; target == num_racks fails the core pool.
    # Consumed mid-round, before the target round's rack aggregation, so a
    # failed pool never aggregates its own round
    # (PBoxFabric._consume_switch_faults).
    "switch_fail",
    "switch_restore",
)


class ShardLost(RuntimeError):
    """A shard crashed with no surviving replica: its slab of the flat
    parameter space is unrecoverable.  Raised instead of silently serving
    a corrupt (zero-filled or stale) flat space."""

    def __init__(self, shard_id: int, num_chunks: int, round_: int,
                 replication: int):
        self.shard_id = shard_id
        self.num_chunks = num_chunks
        self.round = round_
        self.replication = replication
        super().__init__(
            f"shard {shard_id} crashed at round {round_} holding "
            f"{num_chunks} chunks with replication={replication}: no "
            "surviving replica to fail over to. Training state is lost — "
            "restore from the last checkpoint, or run the fabric with "
            "replication>=2 so a chain backup can be promoted in place."
        )


# ---------------------------------------------------------------------------
# fault plan
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault, keyed on the fabric's aggregation-round clock:
    it fires when the fabric completes round ``round`` (the switch kinds
    fire before that round's rack aggregation)."""

    round: int
    kind: str
    target: int
    factor: float = 1.0  # link_degrade only: rack-link slowdown (>= 1)

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; one of {FAULT_KINDS}")
        if self.round < 1:
            raise ValueError("fault rounds start at 1 (after the first "
                             "aggregation round completes)")
        if self.target < 0:
            raise ValueError("fault target must be >= 0")
        if self.factor < 1.0:
            raise ValueError("link_degrade factor must be >= 1")

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


class FaultPlan:
    """A deterministic fault schedule.

    Build one from events, or draw one with ``generate(seed=)``: the
    randomness happens once, at build time, with a seeded generator; at
    run time ``between`` is a lookup on the fabric's round counter."""

    def __init__(self, events: Iterable[FaultEvent] = ()):
        evs = list(events)
        for ev in evs:
            if not isinstance(ev, FaultEvent):
                raise TypeError(f"not a FaultEvent: {ev!r}")
        # stable order: by round, then schedule order (ties fire in the
        # order the plan lists them)
        self.events: tuple[FaultEvent, ...] = tuple(
            sorted(evs, key=lambda e: e.round))

    def __len__(self) -> int:
        return len(self.events)

    @property
    def max_round(self) -> int:
        return max((e.round for e in self.events), default=0)

    def between(self, after: int, upto: int) -> tuple[FaultEvent, ...]:
        """Events with ``after < round <= upto`` in firing order."""
        return tuple(e for e in self.events if after < e.round <= upto)

    # -- seeded generation ----------------------------------------------
    @staticmethod
    def generate(
        seed: int,
        *,
        rounds: int,
        num_shards: int,
        num_workers: int,
        num_racks: int = 1,
        shard_crash_rate: float = 0.0,
        worker_crash_rate: float = 0.0,
        link_degrade_rate: float = 0.0,
        switch_fail_rate: float = 0.0,
        recover_after: int = 2,
        max_dead_workers: int = 1,
    ) -> "FaultPlan":
        """Draw a schedule once with ``np.random.default_rng(seed)``: per
        round each fault class fires independently with its rate, in the
        JAX package's draw order, so the same (seed, shape) gives the same
        plan in both packages.  Crashed workers get a ``worker_recover``
        ``recover_after`` rounds later (at most ``max_dead_workers`` down
        at once); link degradations and switch failures (uniform over the
        ``num_racks`` ToR pools and the core pool at ``num_racks``) get a
        restore the following round.  Rate-zero classes draw nothing."""
        rng = np.random.default_rng(seed)
        events: list[FaultEvent] = []
        down_until: dict[int, int] = {}  # worker -> recovery round
        for r in range(1, rounds + 1):
            down_until = {w: u for w, u in down_until.items() if u > r}
            if shard_crash_rate and rng.random() < shard_crash_rate:
                events.append(FaultEvent(
                    r, "shard_crash", int(rng.integers(num_shards))))
            if (worker_crash_rate and len(down_until) < max_dead_workers
                    and rng.random() < worker_crash_rate):
                alive = [w for w in range(num_workers) if w not in down_until]
                if len(alive) > 1:
                    w = int(alive[rng.integers(len(alive))])
                    events.append(FaultEvent(r, "worker_crash", w))
                    back = r + recover_after
                    if back <= rounds:
                        events.append(FaultEvent(back, "worker_recover", w))
                        down_until[w] = back
                    else:
                        down_until[w] = rounds + 1
            if link_degrade_rate and rng.random() < link_degrade_rate:
                rack = int(rng.integers(num_racks))
                factor = float(2.0 + 2.0 * rng.random())  # 2x-4x slowdown
                events.append(FaultEvent(r, "link_degrade", rack, factor))
                if r + 1 <= rounds:
                    events.append(FaultEvent(r + 1, "link_restore", rack))
            if switch_fail_rate and rng.random() < switch_fail_rate:
                # target num_racks is the core pool (see FAULT_KINDS)
                sw = int(rng.integers(num_racks + 1))
                events.append(FaultEvent(r, "switch_fail", sw))
                if r + 1 <= rounds:
                    events.append(FaultEvent(r + 1, "switch_restore", sw))
        return FaultPlan(events)

    # -- replayable serialization ---------------------------------------
    def to_json(self) -> dict:
        return {"schema": 1, "events": [e.to_json() for e in self.events]}

    @classmethod
    def from_json(cls, doc: dict | str) -> "FaultPlan":
        if isinstance(doc, str):
            doc = json.loads(doc)
        if doc.get("schema") != 1:
            raise ValueError("not a FaultPlan JSON document")
        return cls(FaultEvent(**e) for e in doc["events"])

    def describe(self) -> str:
        kinds: dict[str, int] = {}
        for e in self.events:
            kinds[e.kind] = kinds.get(e.kind, 0) + 1
        parts = ", ".join(f"{k}={v}" for k, v in sorted(kinds.items()))
        return (f"FaultPlan: {len(self.events)} events over rounds "
                f"1..{self.max_round} ({parts or 'empty'})")
