"""Placement plan deltas and the straggler chunk moves (torch counterpart
of part of ``repro/core/placement.py``).

The port so far carries only what the fabric's rebalancing needs:

  ``PlanDelta``              one applicable change to a placement; the
                             fabric applies ``chunk_moves``
                             (``PBoxFabric.apply_plan_delta``).
  ``rebalance_chunks``       the straggler heuristic: a slow shard's chunks
                             go round-robin to the least loaded healthy
                             shards.
  ``chunk_rebalance_delta``  the same moves as a ``chunk_moves`` delta.

``PlacementPlan``, ``diff_plans`` and the plan solver are not ported yet.
Placement moves byte and time accounting only, never bits: chunks move
with their parameters and optimizer state.  This module is numpy only.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

_DELTA_KINDS = ("chunk_moves", "replica_racks", "frontend_move",
                "shard_count", "tenant_shares")


@dataclasses.dataclass(frozen=True)
class PlanDelta:
    """One applicable difference between two plans.

    Kinds and their consumers (the JAX package's; the port's fabric
    applies ``chunk_moves`` and refuses the others it would own):
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
