"""Chain replication and deterministic faults for the PS tiers (torch
counterpart of ``repro/core/replication.py``).

  ``ReplicaGroup``  chain (primary-backup) replication of one shard's chunk
                    state at factor R.  After every aggregation round the
                    primary's slab (params and optimizer state, raw f32)
                    goes down the chain; a crash at a round edge promotes
                    the chain head, which holds the primary's exact
                    post-round bits.
  ``FaultPlan``     a deterministic, seedable schedule of ``FaultEvent``s
                    (shard crash, worker crash and recovery, link degrade
                    and restore, switch fail and restore) keyed on the
                    fabric's aggregation round, drawn once at build time
                    (``generate``) and replayable from its JSON
                    (``to_json``/``from_json``).
  ``ShardLost``     raised when a shard crashes with no surviving replica
                    (R = 1): its slab is gone, and the fabric says so
                    instead of serving a corrupt flat space.

In the JAX package a backup is a reference to an immutable array.  Here the
kernels update a shard's slab in place on the card, so a reference would be
overwritten by the next round: a ``ReplicaGroup`` keeps one device copy of
the slab and ``copy_``s the primary into it each round.  All ``factor - 1``
backups share that copy, as the JAX backups share one reference, so device
memory holds one state set whatever R is, while the byte accounting still
books ``factor - 1`` hops.  With R >= 2 a sync run that crashes and fails
over at any round is bit-identical to the failure-free run (the JAX
package's headline invariant); wiring lives in ``core/fabric.py``.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Iterable, Sequence

import numpy as np
import torch

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
    it fires when the fabric completes round ``round``, after the round's
    update and chain replication (the switch kinds fire before that
    round's rack aggregation)."""

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


# ---------------------------------------------------------------------------
# replica chain
# ---------------------------------------------------------------------------
def _fits(buf: tuple, shard: Any) -> bool:
    """Whether the (params, state) buffers ``buf`` can take ``shard``'s
    slab: the same shapes, dtypes and devices, slot for slot."""
    p, st = buf
    if len(st) != len(shard.state):
        return False
    return all(
        a.shape == b.shape and a.dtype == b.dtype and a.device == b.device
        for a, b in zip((p, *st), (shard.params, *shard.state)))


class ReplicaGroup:
    """Chain replication state for one shard: ``factor - 1`` backups, each
    holding a byte-exact copy of the primary's (chunk ids, params,
    optimizer state) as of the last ``sync``.

    ``racks[0]`` is the primary's rack, ``racks[1:]`` the backups'; the
    group records them so the byte accounting knows which hops cross the
    core.  The backups share one set of buffers, which the group keeps
    between rounds and ``sync`` overwrites with ``copy_``: no round
    allocates, and no backup aliases the slab the kernels write."""

    def __init__(self, shard_id: int, factor: int, racks: Sequence[int]):
        if factor < 2:
            raise ValueError("a ReplicaGroup needs factor >= 2")
        if len(racks) != factor:
            raise ValueError("racks must place every replica (primary first)")
        self.shard_id = shard_id
        self.factor = factor
        self.racks = tuple(int(r) for r in racks)
        self.synced_round = -1
        # chain order: copies[0] is the chain head (first to be promoted)
        self.copies: list[tuple[np.ndarray, torch.Tensor, tuple]] = []
        self._buf: tuple[torch.Tensor, tuple] | None = None

    @property
    def num_backups(self) -> int:
        return len(self.copies)

    def state_bytes(self, num_state_slots: int, num_elems: int) -> int:
        """Raw f32 bytes one chain hop ships: the slab's params plus every
        optimizer-state slot.  Never codec-compressed: a lossy replica
        could not be promoted bit-exactly."""
        return 4 * num_elems * (1 + num_state_slots)

    def hop_racks(self) -> tuple[tuple[int, int], ...]:
        """(src, dst) rack per chain hop: primary -> backup 1 -> ... ."""
        return tuple(
            (self.racks[i], self.racks[i + 1])
            for i in range(self.factor - 1)
        )

    def sync(self, shard: Any, round_: int, *,
             spare: tuple[torch.Tensor, tuple] | None = None) -> None:
        """One chain pass: every backup now holds the primary's exact
        post-round state (the fabric accounts bytes and time per hop).

        The slab is copied into the group's buffers.  When the group holds
        none of the slab's shape (the first sync, a failover, a chunk
        move), it takes ``spare`` if that fits (a failover passes the
        crashed primary's buffers), else allocates."""
        if self._buf is not None and not _fits(self._buf, shard):
            self._buf = None  # a chunk move changed the slab: release first
            self.copies = []
        if self._buf is None:
            if spare is not None and _fits(spare, shard):
                self._buf = spare
            else:
                self._buf = (torch.empty_like(shard.params),
                             tuple(torch.empty_like(s) for s in shard.state))
        p, st = self._buf
        p.copy_(shard.params)
        for dst, src in zip(st, shard.state):
            dst.copy_(src)
        copy = (shard.chunk_ids.copy(), p, st)
        self.copies = [copy] * (self.factor - 1)
        self.synced_round = round_

    def tail(self) -> tuple[np.ndarray, torch.Tensor, tuple]:
        """The chain tail's copy (chunk ids, params, optimizer state): the
        replica furthest from the primary.  Byte-exact for the last
        ``sync``ed round; the next ``sync`` overwrites it in place."""
        if not self.copies:
            raise ShardLost(self.shard_id, 0, self.synced_round, self.factor)
        return self.copies[-1]

    def promote(self) -> tuple[np.ndarray, torch.Tensor, tuple]:
        """Fail over: pop the chain head's copy (the new primary's state).
        Its buffers now belong to the new primary, so the group holds none
        until the caller ``sync``s to re-silver the chain; until then any
        remaining backup shares the promoted buffers."""
        if not self.copies:
            raise ShardLost(self.shard_id, 0, -1, self.factor)
        self._buf = None
        return self.copies.pop(0)

    def describe(self) -> str:
        return (f"ReplicaGroup(shard {self.shard_id}): factor {self.factor}, "
                f"{self.num_backups} backups on racks {self.racks[1:]}, "
                f"synced at round {self.synced_round}")
