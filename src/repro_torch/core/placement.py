"""Placement plans, plan deltas and the straggler chunk moves (torch
counterpart of part of ``repro/core/placement.py``).

The port so far carries what the fabric needs:

  ``PlacementPlan``          the immutable decision set: each shard's
                             replication chain racks, frontend racks and
                             optional explicit chunk and row ownership.
                             ``PlacementPlan.default`` is the anti-affine
                             ``(s + r) % racks`` heuristic every fabric
                             runs under unless it is given a plan.
  ``PlanDelta``              one applicable change to a placement; the
                             fabric applies ``chunk_moves``,
                             ``replica_racks`` and ``shard_count``
                             (``PBoxFabric.apply_plan_delta``).
  ``rebalance_chunks``       the straggler heuristic: a slow shard's chunks
                             go round-robin to the least loaded healthy
                             shards.
  ``chunk_rebalance_delta``  the same moves as a ``chunk_moves`` delta.

The plan solver (``PlacementProblem``, its objectives and constraints),
``current_plan`` and ``diff_plans`` are not ported yet.  Placement moves
byte and time accounting only, never bits: chunks move with their
parameters and optimizer state.  This module is numpy only.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np

_DELTA_KINDS = ("chunk_moves", "replica_racks", "frontend_move",
                "shard_count", "tenant_shares")


@dataclasses.dataclass(frozen=True, eq=False)
class PlacementPlan:
    """One complete placement decision set (immutable; its arrays are
    frozen read-only on construction).

    ``replica_racks`` is (num_shards, >= replication): column 0 is each
    shard's primary home rack, columns 1+ its chain backups.
    ``frontend_racks`` places serving frontends (empty without a read
    plane).  ``chunk_owner`` / ``row_owner`` are optional explicit
    ownership maps; absent means the consumer's own policy (contiguous or
    round-robin chunks, hash or range rows).  ``tenant_shares`` overrides
    fair-share weights per job name."""

    num_shards: int
    num_racks: int = 1
    replication: int = 1
    replica_racks: np.ndarray | None = None
    frontend_racks: tuple[int, ...] = ()
    chunk_owner: np.ndarray | None = None
    row_owner: Mapping[str, np.ndarray] = dataclasses.field(
        default_factory=dict)
    tenant_shares: Mapping[str, float] = dataclasses.field(
        default_factory=dict)
    origin: str = "default"

    def __post_init__(self):
        if self.num_shards < 1:
            raise ValueError("num_shards must be >= 1")
        if self.num_racks < 1:
            raise ValueError("num_racks must be >= 1")
        if self.replication < 1:
            raise ValueError("replication must be >= 1")
        rr = self.replica_racks
        if rr is None:
            # the heuristic: replica r of shard s in (s + r) % racks
            # (NetworkTopology.replica_racks)
            home = np.arange(self.num_shards, dtype=np.int64) % self.num_racks
            rr = (home[:, None] + np.arange(self.replication,
                                            dtype=np.int64)[None, :]) \
                % self.num_racks
        rr = np.asarray(rr, dtype=np.int64)
        if rr.shape[0] != self.num_shards or rr.ndim != 2:
            raise ValueError(
                f"replica_racks must be (num_shards, >=1); got {rr.shape}")
        if rr.shape[1] < self.replication:
            raise ValueError(
                f"replica_racks places {rr.shape[1]} copies, plan declares "
                f"replication {self.replication}")
        if rr.size and (rr.min() < 0 or rr.max() >= self.num_racks):
            raise ValueError("replica_racks entries out of rack range")
        rr = rr.copy()
        rr.setflags(write=False)
        object.__setattr__(self, "replica_racks", rr)
        fr = tuple(int(r) for r in self.frontend_racks)
        if any(not 0 <= r < self.num_racks for r in fr):
            raise ValueError("frontend_racks entries out of rack range")
        object.__setattr__(self, "frontend_racks", fr)
        if self.chunk_owner is not None:
            co = np.asarray(self.chunk_owner, dtype=np.int64).copy()
            if co.ndim != 1:
                raise ValueError("chunk_owner must be 1-D")
            if co.size and (co.min() < 0 or co.max() >= self.num_shards):
                raise ValueError("chunk_owner entries out of shard range")
            co.setflags(write=False)
            object.__setattr__(self, "chunk_owner", co)
        ro = {}
        for name, owner in dict(self.row_owner).items():
            owner = np.asarray(owner, dtype=np.int64).copy()
            if owner.size and (owner.min() < 0
                               or owner.max() >= self.num_shards):
                raise ValueError(
                    f"row_owner[{name!r}] entries out of shard range")
            owner.setflags(write=False)
            ro[str(name)] = owner
        object.__setattr__(self, "row_owner", ro)
        shares = {str(k): float(v)
                  for k, v in dict(self.tenant_shares).items()}
        if any(v <= 0.0 for v in shares.values()):
            raise ValueError("tenant_shares weights must be > 0")
        object.__setattr__(self, "tenant_shares", shares)

    @classmethod
    def default(cls, num_shards: int, *, num_racks: int = 1,
                replication: int = 1,
                num_frontends: int = 0) -> "PlacementPlan":
        """The heuristics as a plan: anti-affine ``(s + r) % racks``
        chains, ``f % racks`` frontends, policy-default chunk and row
        ownership, no tenant shares."""
        return cls(
            num_shards=num_shards,
            num_racks=num_racks,
            replication=replication,
            frontend_racks=tuple(f % num_racks for f in range(num_frontends)),
        )

    @property
    def home_racks(self) -> np.ndarray:
        """Primary home rack per shard (``replica_racks``' first column)."""
        return self.replica_racks[:, 0]

    def replace(self, **kw) -> "PlacementPlan":
        """A modified copy (re-validated; the original stays frozen)."""
        return dataclasses.replace(self, **kw)

    def describe(self) -> str:
        homes = ",".join(str(int(r)) for r in self.home_racks)
        return (
            f"PlacementPlan[{self.origin}]: {self.num_shards} shards x "
            f"R{self.replication} over {self.num_racks} racks "
            f"(homes {homes}), {len(self.frontend_racks)} frontends, "
            f"chunks {'explicit' if self.chunk_owner is not None else 'policy'}, "
            f"{len(self.row_owner)} row maps, "
            f"{len(self.tenant_shares)} tenant shares"
        )


@dataclasses.dataclass(frozen=True)
class PlanDelta:
    """One applicable difference between two plans.

    Kinds and their consumers:
      ``chunk_moves``    ((chunk, new_owner), ...)  -> PBoxFabric.apply_plan_delta
      ``replica_racks``  shard + full new chain     -> PBoxFabric.apply_plan_delta
      ``shard_count``    new_shards                 -> PBoxFabric.apply_plan_delta
      ``frontend_move``  frontend + rack            -> the read plane
      ``tenant_shares``  ((name, weight), ...)      -> the tenancy box
    """

    kind: str
    moves: tuple[tuple[int, int], ...] = ()
    shard: int = -1
    racks: tuple[int, ...] = ()
    frontend: int = -1
    rack: int = -1
    new_shards: int = 0
    shares: tuple[tuple[str, float], ...] = ()

    def __post_init__(self):
        if self.kind not in _DELTA_KINDS:
            raise ValueError(
                f"unknown delta kind {self.kind!r} (want one of "
                f"{_DELTA_KINDS})")
        object.__setattr__(
            self, "moves",
            tuple((int(c), int(o)) for c, o in self.moves))
        object.__setattr__(self, "racks",
                           tuple(int(r) for r in self.racks))
        object.__setattr__(
            self, "shares",
            tuple((str(n), float(w)) for n, w in self.shares))

    def describe(self) -> str:
        if self.kind == "chunk_moves":
            return f"chunk_moves: {len(self.moves)} chunks"
        if self.kind == "replica_racks":
            return f"replica_racks: shard {self.shard} -> {self.racks}"
        if self.kind == "frontend_move":
            return f"frontend_move: frontend {self.frontend} -> rack {self.rack}"
        if self.kind == "shard_count":
            return f"shard_count: -> {self.new_shards}"
        return f"tenant_shares: {dict(self.shares)}"


def rebalance_chunks(chunk_owner: np.ndarray, slow_shards: Sequence[int],
                     n_shards: int) -> np.ndarray:
    """Re-assign chunks owned by slow shards round-robin to healthy shards.
    chunk_owner: (num_chunks,) int array.  Returns new assignment with the
    balance invariant |count_i - count_j| <= 1 preserved among healthy
    shards.  With no healthy shard left the assignment is returned
    unchanged (there is nowhere to move to)."""
    healthy = [s for s in range(n_shards) if s not in slow_shards]
    if not healthy:
        return chunk_owner
    out = chunk_owner.copy()
    moved = np.where(np.isin(chunk_owner, slow_shards))[0]
    counts = {h: int(np.sum(out == h)) for h in healthy}
    for c in moved:
        tgt = min(counts, key=counts.get)
        out[c] = tgt
        counts[tgt] += 1
    return out


def chunk_rebalance_delta(chunk_owner: np.ndarray,
                          slow_shards: Sequence[int],
                          n_shards: int) -> PlanDelta | None:
    """The straggler heuristic as a plan delta: the chunk moves
    ``rebalance_chunks`` would make, or None when nothing moves."""
    new_owner = rebalance_chunks(np.asarray(chunk_owner), list(slow_shards),
                                 n_shards)
    moved = np.flatnonzero(new_owner != np.asarray(chunk_owner))
    if len(moved) == 0:
        return None
    return PlanDelta(kind="chunk_moves",
                     moves=tuple((int(c), int(new_owner[c])) for c in moved))
