"""Closed-loop autoscaler: live telemetry -> re-solve -> plan deltas (torch
counterpart of ``repro/runtime/autoscaler.py``).

The loop the placement layer (core/placement.py) exists to close:

    telemetry -----> decide -----> apply
    shard speeds     shard count   PBoxFabric.reshard (in place)
    link occupancy   chunk moves   PBoxFabric.apply_plan_delta
    serve times      chain homes   PBoxFabric.apply_plan_delta
    round busy-us    frontends     ReadPlane.move_frontend
                     shares        MultiJobFabric.apply_tenant_shares

Every lever is timing-only under the fabric's sharding-independence
invariant (sharding, racks, placement and shares move byte and time
accounting, never bits), so a run with the autoscaler ends bit-identical
to the same run without it, dense and sparse, across shard counts, rack
counts and codecs (tests/test_torch_autoscaler.py).

Decisions are deterministic: thresholds compare event-clock microseconds
(``ServerStats.sim_pipelined_us``, a pure function of the run, never the
wall clock), the solver is seeded and ties break to the lowest rack id,
and cooldowns count fabric rounds.  So the card and the CPU make the same
decisions on the same run.  Everything here reads host state only.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np

from repro_torch.core.placement import (
    PlacementPlan,
    PlacementProblem,
    PlanDelta,
    current_plan,
    diff_plans,
)


@dataclasses.dataclass(frozen=True)
class AutoscalerPolicy:
    """Thresholds and levers for one control loop.

    ``scale_up_busy_us`` / ``scale_down_busy_us`` compare the fabric's
    pipelined event-clock time per round, averaged over the window since
    the last decision: above the up-threshold the engine count doubles
    (capped at ``max_shards``), below the down-threshold it halves
    (floored at ``min_shards``).  The defaults never trigger: an
    autoscaler with a default policy acts only through straggler
    proposals and explicit ``apply_plan`` calls."""

    min_shards: int = 1
    max_shards: int = 8
    scale_up_busy_us: float = float("inf")
    scale_down_busy_us: float = 0.0
    cooldown_rounds: int = 10
    solve_placement: bool = True
    solve_every: int = 0  # also re-solve every N rounds (0: only on rescale)
    solver_sweeps: int = 1
    solver_moves: int = 8

    def __post_init__(self):
        if not 1 <= self.min_shards <= self.max_shards:
            raise ValueError("need 1 <= min_shards <= max_shards")
        if self.scale_down_busy_us > self.scale_up_busy_us:
            raise ValueError("scale_down threshold exceeds scale_up")
        if self.cooldown_rounds < 0 or self.solve_every < 0:
            raise ValueError("cooldown_rounds/solve_every must be >= 0")


@dataclasses.dataclass(frozen=True)
class ScaleEvent:
    """One applied decision, for the run's audit trail."""

    round: int
    kind: str  # "reshard" | "chunk_moves" | "replica_racks" |
    #            "frontend_move" | "tenant_shares"
    detail: str


class Autoscaler:
    """Drives one fabric (plus its serving planes and, optionally, its
    tenancy box) from live telemetry.  Call :meth:`step` at round edges,
    between a completed aggregation round and the next pushes: the only
    point where the elastic levers are legal.

    ``planes`` lists the read planes whose frontends the plan places, in
    plan order: global frontend ``f`` of ``PlacementPlan.frontend_racks``
    indexes the planes' frontends concatenated (the order
    ``current_plan`` reads them in).  ``shared`` is the
    ``MultiJobFabric`` that takes ``tenant_shares`` deltas."""

    def __init__(
        self,
        fabric: Any,
        *,
        policy: AutoscalerPolicy | None = None,
        rebalancer: Any = None,
        planes: Sequence[Any] = (),
        shared: Any = None,
        seed: int = 0,
    ):
        self.fabric = fabric
        self.policy = policy or AutoscalerPolicy()
        self.rebalancer = rebalancer
        self.planes = list(planes)
        self.shared = shared
        self.seed = int(seed)
        self.events: list[ScaleEvent] = []
        self._last_scale_round = fabric.step - self.policy.cooldown_rounds
        self._last_solve_round = fabric.step
        self._mark_round = fabric.step
        self._mark_us = float(fabric.stats.sim_pipelined_us)

    # -- telemetry -------------------------------------------------------
    def telemetry(self) -> dict:
        """One flat snapshot of every signal the loop decides on."""
        fab = self.fabric
        rounds = max(1, fab.step - self._mark_round)
        tele: dict[str, Any] = {
            "round": int(fab.step),
            "num_shards": int(fab.num_shards),
            "busy_us_per_round": (float(fab.stats.sim_pipelined_us)
                                  - self._mark_us) / rounds,
        }
        if self.rebalancer is not None:
            tele["shard_speeds"] = self.rebalancer.speeds()
        if self.planes:
            tele["serve_us"] = [float(p.stats.sim_serve_us)
                                for p in self.planes]
            # SLO health per plane: goodput under the SLO and shed counts
            # (zero for a plane no FrontDoor writes into)
            tele["serve_goodput"] = [float(p.stats.goodput)
                                     for p in self.planes]
            tele["serve_shed"] = [int(p.stats.shed) for p in self.planes]
            tele["serve_p99_us"] = [float(p.stats.latency.p99)
                                    for p in self.planes]
        if self.shared is not None:
            tele["link_busy_us"] = {
                name: float(q.stats.busy_us)
                for name, q in sorted(self.shared.links.items())
            }
        return tele

    # -- the control loop ------------------------------------------------
    def step(self) -> list[ScaleEvent]:
        """One control tick: straggler proposals first (cheap and local),
        then the shard-count decision, then, after a rescale or on the
        ``solve_every`` cadence, a placement re-solve applied as plan
        deltas.  Returns the events applied this tick."""
        events: list[ScaleEvent] = []
        fab = self.fabric
        pol = self.policy
        if self.rebalancer is not None:
            delta = self.rebalancer.propose()
            if delta is not None:
                moved = fab.apply_plan_delta(delta)
                self.rebalancer.mark_applied()
                events.append(ScaleEvent(fab.step, "chunk_moves",
                                         f"{moved} chunks re-homed"))
        busy = self.telemetry()["busy_us_per_round"]
        target = fab.num_shards
        if busy > pol.scale_up_busy_us:
            target = min(pol.max_shards, max(pol.min_shards,
                                             fab.num_shards * 2))
        elif busy < pol.scale_down_busy_us:
            target = max(pol.min_shards, min(pol.max_shards,
                                             (fab.num_shards + 1) // 2))
        rescaled = False
        if (target != fab.num_shards
                and fab.step - self._last_scale_round >= pol.cooldown_rounds
                and not fab._inbox and not fab._staged):
            moved = fab.reshard(target)
            rescaled = True
            self._last_scale_round = fab.step
            events.append(ScaleEvent(
                fab.step, "reshard",
                f"-> {target} shards ({moved} chunks moved, "
                f"{busy:.1f}us/round)"))
        self._mark_round = fab.step
        self._mark_us = float(fab.stats.sim_pipelined_us)
        due = (pol.solve_every > 0
               and fab.step - self._last_solve_round >= pol.solve_every)
        if pol.solve_placement and (rescaled or due):
            events.extend(self.resolve_placement())
            self._last_solve_round = fab.step
        self.events.extend(events)
        return events

    # -- placement re-solve ----------------------------------------------
    def _problem(self) -> PlacementProblem:
        # static knobs from the fabric's FabricConfig, the one record of
        # how it was built; the live layout (chunk ownership, attached
        # planes) from the fabric itself
        fab = self.fabric
        cfg = fab.config
        topo = cfg.wire.topology
        return PlacementProblem.standard(
            num_shards=fab.num_shards,
            num_racks=topo.num_racks if topo is not None else 1,
            replication=cfg.faults.replication,
            num_frontends=sum(len(p.frontends) for p in self.planes),
            oversubscription=(topo.oversubscription if topo is not None
                              else 4.0),
            codec=fab.compression.codec,
            chunk_elems=fab.space.chunk_elems,
            chunks_per_shard=np.bincount(fab.chunk_owner,
                                         minlength=fab.num_shards),
        )

    def resolve_placement(self) -> list[ScaleEvent]:
        """Re-solve the placement problem against the live layout and
        apply the difference as plan deltas.  Deterministic: the problem
        is built from the fabric's own shapes, the solver is seeded."""
        base = current_plan(self.fabric, planes=self.planes)
        solved = self._problem().solve(
            start=base, sweeps=self.policy.solver_sweeps,
            local_moves=self.policy.solver_moves, seed=self.seed)
        return self.apply_plan(solved, base=base)

    def apply_plan(self, plan: PlacementPlan, *,
                   base: PlacementPlan | None = None) -> list[ScaleEvent]:
        """Apply ``plan`` to the running stack as deltas against the live
        layout (or ``base``).  Every delta kind routes to its owner; each
        application is timing-only."""
        fab = self.fabric
        if base is None:
            base = current_plan(fab, planes=self.planes)
        events: list[ScaleEvent] = []
        for delta in diff_plans(base, plan):
            events.extend(self.apply_delta(delta, plan=plan))
        self.events.extend(events)
        return events

    def apply_delta(self, delta: PlanDelta,
                    *, plan: PlacementPlan | None = None) -> list[ScaleEvent]:
        """Route one delta to its consumer (fabric, plane, or tenancy
        box).  ``plan`` rides along with ``shard_count`` deltas so the
        reshard lands the full target layout in one step."""
        fab = self.fabric
        events: list[ScaleEvent] = []
        if delta.kind in ("chunk_moves", "replica_racks"):
            n = fab.apply_plan_delta(delta)
            events.append(ScaleEvent(fab.step, delta.kind,
                                     f"{delta.describe()} ({n} applied)"))
        elif delta.kind == "shard_count":
            moved = fab.reshard(delta.new_shards, plan=plan)
            self._last_scale_round = fab.step
            events.append(ScaleEvent(
                fab.step, "reshard",
                f"-> {delta.new_shards} shards ({moved} chunks moved)"))
        elif delta.kind == "frontend_move":
            plane, local = self._plane_of(delta.frontend)
            plane.move_frontend(local, delta.rack)
            events.append(ScaleEvent(fab.step, "frontend_move",
                                     delta.describe()))
        elif delta.kind == "tenant_shares":
            if self.shared is not None:
                changed = self.shared.apply_tenant_shares(dict(delta.shares))
                if changed:
                    events.append(ScaleEvent(fab.step, "tenant_shares",
                                             delta.describe()))
        else:  # pragma: no cover - PlanDelta validates kinds
            raise ValueError(f"unknown delta kind {delta.kind!r}")
        return events

    def _plane_of(self, frontend: int) -> tuple[Any, int]:
        """Global plan frontend index -> (plane, plane-local index)."""
        offset = 0
        for plane in self.planes:
            n = len(plane.frontends)
            if frontend < offset + n:
                return plane, frontend - offset
            offset += n
        raise ValueError(f"no frontend {frontend} across "
                         f"{len(self.planes)} planes")

    def describe(self) -> str:
        kinds: dict[str, int] = {}
        for e in self.events:
            kinds[e.kind] = kinds.get(e.kind, 0) + 1
        summary = ", ".join(f"{k}={v}" for k, v in sorted(kinds.items())) \
            or "no events"
        return (f"Autoscaler: {len(self.events)} events ({summary}), "
                f"{self.fabric.num_shards} shards at round "
                f"{self.fabric.step}")
