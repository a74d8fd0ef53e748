"""The placement layer: plans, plan deltas, the plan solver and the
straggler chunk moves (torch counterpart of ``repro/core/placement.py``).

  ``PlacementPlan``          the immutable decision set: each shard's
                             replication chain racks, frontend racks,
                             optional explicit chunk and row ownership and
                             per-tenant fair-share weights.
                             ``PlacementPlan.default`` is the anti-affine
                             ``(s + r) % racks`` heuristic every fabric
                             runs under unless it is given a plan.
  ``PlanDelta``              one applicable change to a placement; the
                             fabric applies ``chunk_moves``,
                             ``replica_racks`` and ``shard_count``
                             (``PBoxFabric.apply_plan_delta``), the read
                             plane ``frontend_move``, the tenancy box
                             ``tenant_shares``.
  ``diff_plans``             the ordered deltas turning one plan into
                             another.
  ``Objective``              scoring terms priced with the fabric's own
  ``Constraint``             ``wire_bytes`` and hop-cost models (core-link
                             bytes, rack load balance, hot-row skew) and
                             feasibility predicates (rack capacity,
                             replica anti-affinity, chunk balance).
  ``PlacementProblem``       the solver: greedy coordinate descent plus a
                             seeded local search, longest-processing-time
                             row maps and demand-proportional tenant
                             shares.  Same inputs + same seed => the same
                             plan as the JAX package's, field for field.
  ``current_plan``           the placement a live fabric runs, read from
                             host state only.
  ``rebalance_chunks``       the straggler heuristic: a slow shard's chunks
                             go round-robin to the least loaded healthy
                             shards; ``chunk_rebalance_delta`` gives the
                             same moves as a delta.

Placement moves byte and time accounting only, never bits: chunks move
with their parameters and optimizer state.  This module is numpy only;
the scores keep the JAX package's float types and summation order (Python
floats in ``CoreByteCost``, numpy float64 in ``LoadBalance``, the
objectives summed in insertion order), since the solver picks a plan by
strict ``<`` comparisons of those totals.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Sequence

import numpy as np

from repro_torch.core.compression import CompressionConfig, wire_bytes

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


def diff_plans(old: PlacementPlan,
               new: PlacementPlan) -> tuple[PlanDelta, ...]:
    """The ordered delta sequence turning ``old`` into ``new``.

    A shard-count change subsumes everything else: the new plan rides
    along with the reshard (``PBoxFabric.reshard(n, plan=new)``), so a
    single ``shard_count`` delta is emitted.  Otherwise: per-shard chain
    re-placements, chunk moves (when both plans pin ownership), frontend
    moves over the common frontend range, and one tenant-share delta when
    the weights differ."""
    if old.num_racks != new.num_racks:
        raise ValueError("plans describe different rack counts")
    if old.num_shards != new.num_shards:
        return (PlanDelta(kind="shard_count", new_shards=new.num_shards),)
    deltas: list[PlanDelta] = []
    cols = min(old.replica_racks.shape[1], new.replica_racks.shape[1])
    for s in range(old.num_shards):
        o, n = old.replica_racks[s, :cols], new.replica_racks[s, :cols]
        if not np.array_equal(o, n):
            deltas.append(PlanDelta(kind="replica_racks", shard=s,
                                    racks=tuple(int(r) for r in n)))
    if old.chunk_owner is not None and new.chunk_owner is not None \
            and len(old.chunk_owner) == len(new.chunk_owner):
        moved = np.flatnonzero(old.chunk_owner != new.chunk_owner)
        if len(moved):
            deltas.append(PlanDelta(
                kind="chunk_moves",
                moves=tuple((int(c), int(new.chunk_owner[c]))
                            for c in moved)))
    for f in range(min(len(old.frontend_racks), len(new.frontend_racks))):
        if old.frontend_racks[f] != new.frontend_racks[f]:
            deltas.append(PlanDelta(kind="frontend_move", frontend=f,
                                    rack=new.frontend_racks[f]))
    if dict(old.tenant_shares) != dict(new.tenant_shares) \
            and new.tenant_shares:
        deltas.append(PlanDelta(
            kind="tenant_shares",
            shares=tuple(sorted(new.tenant_shares.items()))))
    return tuple(deltas)


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


# ---------------------------------------------------------------------------
# objectives and constraints
# ---------------------------------------------------------------------------
class Objective:
    """One scoring term: lower is better.  Scores are priced against the
    problem's wire model (``wire_bytes`` + hop cost), so the solver
    optimizes the same quantities the fabric's event clock accounts."""

    name = "objective"

    def score(self, plan: PlacementPlan,
              problem: "PlacementProblem") -> float:
        raise NotImplementedError


class Constraint:
    """One feasibility predicate: ``violations`` returns human-readable
    reasons (empty = satisfied).  An infeasible plan scores +inf."""

    name = "constraint"

    def violations(self, plan: PlacementPlan,
                   problem: "PlacementProblem") -> list[str]:
        raise NotImplementedError


class CoreByteCost(Objective):
    """Cross-rack byte cost per round: replication chain hops plus serving
    refresh streams, each priced ``bytes * hop_cost`` as the fabric's
    chain streams and the read plane's refreshes book them (rack-local
    1.0, cross-rack the oversubscription factor).  Python floats, shard by
    shard and then frontend by frontend."""

    name = "core_bytes"

    def __init__(self, serve_weight: float = 1.0):
        self.serve_weight = float(serve_weight)

    def score(self, plan, problem):
        cost = 0.0
        rr = plan.replica_racks
        for s in range(plan.num_shards):
            nbytes = problem.shard_bytes(s, plan)
            for r in range(plan.replication - 1):
                cost += nbytes * problem.hop_cost(int(rr[s, r]),
                                                  int(rr[s, r + 1]))
        for fe_rack in plan.frontend_racks:
            for s in range(plan.num_shards):
                src = problem.serve_rack(plan, s, fe_rack)
                cost += (self.serve_weight * problem.shard_bytes(s, plan)
                         * problem.hop_cost(src, fe_rack))
        return cost


class LoadBalance(Objective):
    """Spread of per-rack hosted primary bytes (population variance,
    normalized by the mean so the term is scale-free; numpy float64)."""

    name = "load_balance"

    def score(self, plan, problem):
        load = np.zeros(plan.num_racks, dtype=np.float64)
        for s in range(plan.num_shards):
            load[int(plan.replica_racks[s, 0])] += problem.shard_bytes(s, plan)
        mean = load.mean()
        if mean <= 0.0:
            return 0.0
        return float(((load - mean) ** 2).mean()) / (mean * mean)


class HotRowSkew(Objective):
    """max/mean per-shard hot-row load under the plan's row map, minus 1
    (0.0 is perfect; only scored for tables the problem has a load
    histogram for).  Without an explicit ``row_owner`` the default hash
    policy is assumed."""

    name = "hot_row_skew"

    def score(self, plan, problem):
        if not problem.row_load:
            return 0.0
        worst = 0.0
        for name, load in problem.row_load.items():
            owner = plan.row_owner.get(name)
            if owner is None:
                owner = problem.default_row_owner(name)
            per_shard = np.bincount(owner, weights=load,
                                    minlength=plan.num_shards)
            mean = per_shard.mean()
            if mean > 0.0:
                worst = max(worst, float(per_shard.max() / mean) - 1.0)
        return worst


class RackCapacity(Constraint):
    """No rack hosts more shard primaries than its capacity (default:
    the even split, ceil(shards / racks))."""

    name = "rack_capacity"

    def __init__(self, max_primaries: int | None = None):
        self.max_primaries = max_primaries

    def violations(self, plan, problem):
        cap = self.max_primaries
        if cap is None:
            cap = -(-plan.num_shards // plan.num_racks)
        counts = np.bincount(plan.home_racks, minlength=plan.num_racks)
        return [
            f"rack {r} hosts {int(c)} primaries (cap {cap})"
            for r, c in enumerate(counts) if c > cap
        ]


class ReplicaAntiAffinity(Constraint):
    """Consecutive chain hops land in distinct racks while the factor
    fits the rack count: a rack loss can never take a shard and its
    next-hop backup at once."""

    name = "replica_anti_affinity"

    def violations(self, plan, problem):
        if plan.replication > plan.num_racks:
            return []  # full anti-affinity is impossible; chains may wrap
        out = []
        rr = plan.replica_racks
        for s in range(plan.num_shards):
            for r in range(plan.replication - 1):
                if int(rr[s, r]) == int(rr[s, r + 1]):
                    out.append(
                        f"shard {s}: chain hops {r}->{r + 1} share rack "
                        f"{int(rr[s, r])}")
        return out


class ChunkBalance(Constraint):
    """Explicit chunk ownership stays balanced: |count_i - count_j| <= 1
    (vacuous when the plan leaves chunks to the consumer's policy)."""

    name = "chunk_balance"

    def violations(self, plan, problem):
        if plan.chunk_owner is None:
            return []
        counts = np.bincount(plan.chunk_owner, minlength=plan.num_shards)
        if counts.max() - counts.min() > 1:
            return [
                f"chunk counts span {int(counts.min())}..{int(counts.max())}"
            ]
        return []


# ---------------------------------------------------------------------------
# the problem + solver
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class PlanScore:
    """One evaluation: weighted total (lower is better; +inf when any
    constraint is violated), per-objective terms, and the violations."""

    total: float
    terms: Mapping[str, float]
    violations: tuple[str, ...]

    @property
    def feasible(self) -> bool:
        return not self.violations


class PlacementProblem:
    """The declarative placement problem: shapes + a wire model +
    composable objectives/constraints + a deterministic solver.

    ``chunks_per_shard`` is the load model (defaults to one chunk per
    shard); bytes are priced through the same ``wire_bytes`` codec model
    the fabric accounts with, and cross-rack hops pay ``oversubscription``
    like ``NetworkTopology.hop_cost``.  ``row_load`` (table name -> per-row
    access weights) enables the hot-row skew objective and the row-map
    decision variable; ``tenant_demand`` (job name -> relative demand)
    enables the tenant-share variable.

    ``solve`` is a pure function of (problem inputs, start plan, seed);
    ties break to the lowest rack id (the ``NetworkTopology.nearest_rack``
    rule)."""

    def __init__(
        self,
        *,
        num_shards: int,
        num_racks: int = 1,
        replication: int = 1,
        num_frontends: int = 0,
        oversubscription: float = 4.0,
        codec: str = "none",
        chunk_elems: int = 8192,
        chunks_per_shard: Sequence[int] | None = None,
        row_load: Mapping[str, Any] | None = None,
        tenant_demand: Mapping[str, float] | None = None,
    ):
        if num_shards < 1 or num_racks < 1 or replication < 1:
            raise ValueError("num_shards/num_racks/replication must be >= 1")
        if oversubscription < 1.0:
            raise ValueError("oversubscription must be >= 1")
        self.num_shards = int(num_shards)
        self.num_racks = int(num_racks)
        self.replication = int(replication)
        self.num_frontends = int(num_frontends)
        self.oversubscription = float(oversubscription)
        self.compression = CompressionConfig(codec=codec,
                                             chunk_elems=chunk_elems)
        self.chunk_elems = int(chunk_elems)
        if chunks_per_shard is None:
            chunks_per_shard = [1] * self.num_shards
        cps = np.asarray(chunks_per_shard, dtype=np.int64)
        if cps.shape != (self.num_shards,):
            raise ValueError("chunks_per_shard must list every shard")
        self.chunks_per_shard = cps
        self.row_load = {
            str(k): np.asarray(v, dtype=np.float64)
            for k, v in dict(row_load or {}).items()
        }
        self.tenant_demand = {
            str(k): float(v) for k, v in dict(tenant_demand or {}).items()
        }
        self.objectives: list[tuple[Objective, float]] = []
        self.constraints: list[Constraint] = []

    # -- composition ---------------------------------------------------
    def add_objective(self, obj: Objective,
                      weight: float = 1.0) -> "PlacementProblem":
        if weight <= 0.0:
            raise ValueError("objective weight must be > 0")
        self.objectives.append((obj, float(weight)))
        return self

    def add_constraint(self, con: Constraint) -> "PlacementProblem":
        self.constraints.append(con)
        return self

    @classmethod
    def standard(cls, **kw) -> "PlacementProblem":
        """The canonical composition: core-byte cost + load balance (+
        hot-row skew when a row load model is given), under rack capacity,
        anti-affinity, and chunk balance."""
        prob = cls(**kw)
        prob.add_objective(CoreByteCost())
        prob.add_objective(LoadBalance(),
                           weight=float(prob.shard_bytes_total()))
        if prob.row_load:
            prob.add_objective(HotRowSkew(),
                               weight=float(prob.shard_bytes_total()))
        prob.add_constraint(RackCapacity())
        prob.add_constraint(ReplicaAntiAffinity())
        prob.add_constraint(ChunkBalance())
        return prob

    # -- the wire model ------------------------------------------------
    def shard_bytes(self, shard: int, plan: PlacementPlan) -> float:
        """One shard's per-round stream in codec wire bytes (the plan's
        explicit chunk ownership overrides the load model when present)."""
        if plan.chunk_owner is not None:
            chunks = int(np.sum(plan.chunk_owner == shard))
        else:
            chunks = int(self.chunks_per_shard[shard])
        return float(wire_bytes(self.compression, chunks * self.chunk_elems))

    def shard_bytes_total(self) -> float:
        return float(wire_bytes(
            self.compression,
            int(self.chunks_per_shard.sum()) * self.chunk_elems))

    def hop_cost(self, src_rack: int, dst_rack: int) -> float:
        """``NetworkTopology.hop_cost``'s pricing, reproduced so plans can
        be scored without a live topology object."""
        return 1.0 if src_rack == dst_rack else self.oversubscription

    def serve_rack(self, plan: PlacementPlan, shard: int,
                   frontend_rack: int) -> int:
        """The rack that would serve ``frontend_rack``'s refreshes of
        ``shard`` under ``plan`` (``FabricSource.serve_rack``): the
        cheapest backup rack at R >= 2 (ties to the lowest rack id), the
        primary's home otherwise."""
        rr = plan.replica_racks
        if plan.replication < 2:
            return int(rr[shard, 0])
        cands = [int(r) for r in rr[shard, 1:plan.replication]]
        return min(cands, key=lambda r: (self.hop_cost(r, frontend_rack), r))

    def default_row_owner(self, name: str) -> np.ndarray:
        """The hash policy's row map for a table in the load model (what
        ``HotRowSkew`` scores when the plan has no explicit map), from
        core/sparse.py's splitmix64."""
        from repro_torch.core.sparse import RowPlacement
        num_rows = len(self.row_load[name])
        return RowPlacement(num_rows, self.num_shards, "hash").owner

    # -- evaluation ----------------------------------------------------
    def default_plan(self) -> PlacementPlan:
        return PlacementPlan.default(
            self.num_shards, num_racks=self.num_racks,
            replication=self.replication, num_frontends=self.num_frontends)

    def evaluate(self, plan: PlacementPlan) -> PlanScore:
        violations: list[str] = []
        for con in self.constraints:
            violations.extend(con.violations(plan, self))
        terms = {obj.name: w * obj.score(plan, self)
                 for obj, w in self.objectives}
        total = float("inf") if violations else float(sum(terms.values()))
        return PlanScore(total=total, terms=terms,
                         violations=tuple(violations))

    # -- the solver ----------------------------------------------------
    def _chain_for_home(self, home: int) -> list[int]:
        return [(home + r) % self.num_racks for r in range(self.replication)]

    def solve(self, *, start: PlacementPlan | None = None, sweeps: int = 2,
              local_moves: int = 32, seed: int = 0) -> PlacementPlan:
        """Deterministic greedy coordinate descent + seeded local search.

        Greedy phase, per sweep: each shard's home rack (its chain
        following the anti-affine rotation), then each backup hop
        individually, then each frontend, always scanning racks in
        ascending id so ties resolve to the lowest rack.  Local-search
        phase: ``local_moves`` seeded single-rack perturbations (shard,
        hop, rack drawn in that order), accepted only on strict
        improvement.  Row maps and tenant shares are solved directly
        (greedy longest-processing-time rows; demand-proportional
        shares)."""
        plan = start if start is not None else self.default_plan()
        if plan.num_shards != self.num_shards \
                or plan.num_racks != self.num_racks \
                or plan.replication != self.replication:
            raise ValueError("start plan does not match the problem's shapes")
        rr = [list(int(r) for r in row[:self.replication])
              for row in plan.replica_racks]
        fr = list(plan.frontend_racks[:self.num_frontends])
        fr += [f % self.num_racks for f in range(len(fr), self.num_frontends)]

        def assemble() -> PlacementPlan:
            return plan.replace(
                replica_racks=np.asarray(
                    rr, dtype=np.int64).reshape(self.num_shards,
                                                self.replication),
                frontend_racks=tuple(fr), origin="solved")

        best = self.evaluate(assemble()).total
        for _ in range(max(1, sweeps)):
            for s in range(self.num_shards):
                keep = list(rr[s])
                for home in range(self.num_racks):
                    rr[s] = self._chain_for_home(home)
                    cost = self.evaluate(assemble()).total
                    if cost < best:
                        best, keep = cost, list(rr[s])
                rr[s] = keep
                for hop in range(1, self.replication):
                    kept = rr[s][hop]
                    for cand in range(self.num_racks):
                        rr[s][hop] = cand
                        cost = self.evaluate(assemble()).total
                        if cost < best:
                            best, kept = cost, cand
                    rr[s][hop] = kept
            for f in range(len(fr)):
                kept = fr[f]
                for cand in range(self.num_racks):
                    fr[f] = cand
                    cost = self.evaluate(assemble()).total
                    if cost < best:
                        best, kept = cost, cand
                fr[f] = kept
        rng = np.random.default_rng(seed)
        for _ in range(max(0, local_moves)):
            s = int(rng.integers(self.num_shards))
            hop = int(rng.integers(self.replication))
            cand = int(rng.integers(self.num_racks))
            kept = rr[s][hop]
            rr[s][hop] = cand
            cost = self.evaluate(assemble()).total
            if cost < best:
                best = cost
            else:
                rr[s][hop] = kept
        solved = assemble()
        # direct decision variables: hot rows and tenant shares have
        # closed-form greedy optima, no search needed
        row_owner = dict(solved.row_owner)
        for name, load in self.row_load.items():
            row_owner[name] = self._solve_rows(load)
        shares = dict(solved.tenant_shares)
        if self.tenant_demand:
            lo = min(self.tenant_demand.values())
            shares = {n: d / lo for n, d in sorted(self.tenant_demand.items())}
        return solved.replace(row_owner=row_owner, tenant_shares=shares)

    def _solve_rows(self, load: np.ndarray) -> np.ndarray:
        """Greedy longest-processing-time row assignment: rows in
        descending load (ties to the lower row id) onto the least-loaded
        shard (ties to the lower shard id); within 4/3 of the optimal
        makespan.  A Python loop over rows: fine at test sizes, minutes at
        a 10M-row table."""
        order = np.lexsort((np.arange(len(load)), -load))
        owner = np.zeros(len(load), dtype=np.int64)
        shard_load = np.zeros(self.num_shards, dtype=np.float64)
        for row in order:
            tgt = int(np.argmin(shard_load))  # argmin ties -> lowest id
            owner[row] = tgt
            shard_load[tgt] += load[row]
        return owner


# ---------------------------------------------------------------------------
# live-fabric snapshot
# ---------------------------------------------------------------------------
def current_plan(fabric: Any, *, planes: Sequence[Any] = ()) -> PlacementPlan:
    """The placement a live fabric is actually running: its plan's chain
    racks refreshed from the replica groups, explicit chunk ownership, and
    the given read planes' current frontend racks.  Host state only (the
    plan, ``ReplicaGroup.racks``, ``chunk_owner``, the frontends' racks):
    no device buffer is read.  The autoscaler diffs solver output against
    this."""
    plan = fabric.plan
    rr = np.asarray(plan.replica_racks).copy()
    for group in fabric.replicas:
        rr[group.shard_id, :len(group.racks)] = group.racks
    frontends: list[int] = []
    for plane in planes:
        frontends.extend(int(fe.rack) for fe in plane.frontends)
    return plan.replace(replica_racks=rr,
                        chunk_owner=fabric.chunk_owner.copy(),
                        frontend_racks=tuple(frontends), origin="live")
