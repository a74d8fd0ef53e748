"""Declarative construction surfaces: FabricConfig, ServeConfig,
WorkloadConfig (torch counterpart of ``repro/core/config.py``).

The fabric's knobs fold into one frozen, validated config tree:

  ``FabricConfig``     scalar fabric knobs (shards, mode, workers, the
                       tenancy namespace, ...)
  ``WireConfig``         the wire tier: topology, codec, link model and
                         the switch tier
  ``SwitchConfig``         in-network aggregation slot pools
  ``FaultConfig``        replication factor, fault schedule, anti-affinity
  ``PlacementConfig``    chunk placement policy and an explicit plan

The serving tier rides the same pattern:

  ``ServeConfig``      the whole read-plane surface (frontends, the
                       staleness bound, fair-share knobs) plus
    ``SLOConfig``        one tenant class's latency budget, staleness
                         bound and shed priority
    ``AdmissionConfig``  token-bucket admission and overload shedding
    ``HierarchyConfig``  the geo read-plane ladder (core/hierarchy.py)
  ``WorkloadConfig``   trace-driven load (core/workload.py):
    ``ArrivalConfig``    open, Poisson or MMPP arrivals
    ``DiurnalConfig``    sinusoidal rate modulation
    ``FlashCrowdConfig`` a rate spike window
    ``TenantLoadConfig`` one tenant's mix, open- or closed-loop

``PBoxFabric(space, spec, init_flat, config=...)`` is the primary fabric
constructor; the legacy keyword spread is accepted through one adapter
(``FabricConfig.from_legacy_kwargs``) that emits a ``DeprecationWarning``
once per call site (``warn_legacy_call``), as in the JAX package.  The JAX
fields ``use_pallas`` and ``fused_wire_path`` have no field here: the
update runs the CUDA kernel on CUDA tensors and its plain version on CPU
tensors, and a codec'd push takes the fused wire kernel wherever
``wire_path_supported`` allows it, which gives the same bits as the
unfused route it would switch to.  The adapter accepts both keywords at
their JAX default (``True``) and refuses any other value.
``ReadPlane`` / ``SparseReadPlane`` take ``config=`` or their legacy
keyword spreads (``ServeConfig.from_legacy_kwargs`` /
``from_sparse_legacy_kwargs``) in the same way.

All cross-field validation lives in ``validate()``: one named
``FabricConfigError`` per rule, the same rules, names and order as the JAX
package.  ``namespace`` / ``chunk_base`` place a tenant's chunk space on a
shared box (``core/tenancy.py``).

Sub-configs hold live objects (topology, codec, fault plan, plan, link
model) by reference and are validated duck-typed, so this module imports
nothing else of the port.
"""
from __future__ import annotations

import dataclasses
import sys
import warnings
from typing import Any

_MODES = ("sync", "async", "stale")
_PLACEMENTS = ("contiguous", "round_robin")


class FabricConfigError(ValueError):
    """An invalid FabricConfig field combination, named per rule."""

    def __init__(self, rule: str, detail: str):
        self.rule = rule
        super().__init__(f"[{rule}] {detail}")


@dataclasses.dataclass(frozen=True)
class SwitchConfig:
    """In-network aggregation pools (SwitchML-style bounded switch memory):
    ``tor_slots`` per ToR, ``core_slots`` at the core switch."""

    enabled: bool = False
    tor_slots: int = 0
    core_slots: int = 0


@dataclasses.dataclass(frozen=True)
class WireConfig:
    """Everything about how gradient bits cross the network: ``topology``
    (the rack tier), ``compression`` (the wire codec), ``link`` (the
    event-clock costs, a ``core.fabric.LinkModel``) and the ``switch``
    pools."""

    topology: Any | None = None
    compression: Any | None = None
    link: Any | None = None
    switch: SwitchConfig = SwitchConfig()


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Fault-tolerance tier: chain replication + deterministic faults."""

    replication: int = 1
    fault_plan: Any | None = None
    anti_affine: bool = False


@dataclasses.dataclass(frozen=True)
class PlacementConfig:
    """Chunk-placement policy ("contiguous" | "round_robin") and an
    optional explicit placement plan."""

    policy: str = "contiguous"
    plan: Any | None = None


# legacy keyword name -> where it landed in the config tree, the JAX
# package's table.  ``None``: the JAX field has no counterpart in the port
# (the device picks the kernel route), so the adapter accepts only the JAX
# default for it
LEGACY_KWARGS = {
    "num_shards": "num_shards",
    "mode": "mode",
    "staleness": "staleness",
    "num_workers": "num_workers",
    "min_push_fraction": "min_push_fraction",
    "use_pallas": None,
    "namespace": "namespace",
    "chunk_base": "chunk_base",
    "topology": "wire.topology",
    "compression": "wire.compression",
    "link": "wire.link",
    "fused_wire_path": None,
    "replication": "faults.replication",
    "fault_plan": "faults.fault_plan",
    "placement": "placement.policy",
    "plan": "placement.plan",
}

# serving legacy keyword name -> ServeConfig field: the ReadPlane adapter
# reads it, as the JAX package's does
SERVE_LEGACY_KWARGS = {
    "max_staleness": "max_staleness",
    "num_frontends": "num_frontends",
    "name": "name",
    "priority": "priority",
    "bandwidth_cap": "bandwidth_cap",
    "serve_us_per_read": "serve_us_per_read",
}

# and the SparseReadPlane spread (cache_rows is sparse-only)
SPARSE_SERVE_LEGACY_KWARGS = {
    "num_frontends": "num_frontends",
    "cache_rows": "cache_rows",
    "name": "name",
    "serve_us_per_read": "serve_us_per_read",
}

# call sites (file, lineno) already warned this process: the adapter warns
# exactly once per site regardless of the warning filters
_WARNED_SITES: set[tuple[str, int]] = set()


def warn_legacy_call(depth: int = 2, *, constructor: str = "PBoxFabric",
                     config: str = "FabricConfig") -> bool:
    """Emit the deprecation warning for the caller ``depth`` frames up,
    once per (file, line) call site.  Returns True if a warning was
    emitted (False on a repeat visit from the same site)."""
    try:
        frame = sys._getframe(depth)
        site = (frame.f_code.co_filename, frame.f_lineno)
    except ValueError:  # shallow stack (embedded interpreters)
        site = ("<unknown>", 0)
    if site in _WARNED_SITES:
        return False
    _WARNED_SITES.add(site)
    warnings.warn(
        f"constructing {constructor} from loose keyword arguments is "
        f"deprecated; build a core.config.{config} and pass "
        "config=... (see docs/api.md for the field-by-field migration "
        "table)",
        DeprecationWarning,
        stacklevel=depth + 1,
    )
    return True


@dataclasses.dataclass(frozen=True)
class FabricConfig:
    """The whole construction surface of a PBoxFabric, as one value."""

    num_shards: int = 1
    mode: str = "sync"  # "sync" | "async" | "stale"
    staleness: int = 0
    num_workers: int = 1
    min_push_fraction: float = 1.0
    namespace: str | None = None
    chunk_base: int = 0
    wire: WireConfig = WireConfig()
    faults: FaultConfig = FaultConfig()
    placement: PlacementConfig = PlacementConfig()

    # -- legacy adapter --------------------------------------------------
    @classmethod
    def from_legacy_kwargs(cls, **kw: Any) -> "FabricConfig":
        """Build a config from the pre-consolidation keyword surface.

        Accepts exactly the JAX package's legacy keywords (see
        ``LEGACY_KWARGS``); anything else is a TypeError, as is a value
        other than ``True`` for ``use_pallas`` / ``fused_wire_path``."""
        unknown = set(kw) - set(LEGACY_KWARGS)
        if unknown:
            raise TypeError(
                f"unknown PBoxFabric argument(s): {sorted(unknown)}; "
                f"legacy keywords are {sorted(LEGACY_KWARGS)}")
        for name, path in LEGACY_KWARGS.items():
            if path is None and name in kw and kw[name] is not True:
                raise TypeError(
                    f"{name}={kw[name]!r} has no counterpart in the PyTorch "
                    "fabric: the device picks the kernel route (the CUDA "
                    "kernel on the card, its plain version on the CPU), and "
                    "the fused and unfused wire routes give the same bits; "
                    "only the JAX default True is accepted")
        wire = WireConfig(
            topology=kw.get("topology"),
            compression=kw.get("compression"),
            link=kw.get("link"),
        )
        faults = FaultConfig(
            replication=kw.get("replication", 1),
            fault_plan=kw.get("fault_plan"),
        )
        placement = PlacementConfig(
            policy=kw.get("placement", "contiguous"),
            plan=kw.get("plan"),
        )
        return cls(
            num_shards=kw.get("num_shards", 1),
            mode=kw.get("mode", "sync"),
            staleness=kw.get("staleness", 0),
            num_workers=kw.get("num_workers", 1),
            min_push_fraction=kw.get("min_push_fraction", 1.0),
            namespace=kw.get("namespace"),
            chunk_base=kw.get("chunk_base", 0),
            wire=wire,
            faults=faults,
            placement=placement,
        )

    # -- validation ------------------------------------------------------
    def validate(self) -> "FabricConfig":
        """Check every cross-field rule before any fabric state exists.

        One named ``FabricConfigError`` per rule; returns self so
        constructors can chain ``config.validate()``."""
        if self.mode not in _MODES:
            raise FabricConfigError(
                "mode", f"unknown mode {self.mode!r}; one of {_MODES}")
        if self.num_shards < 1:
            raise FabricConfigError(
                "num_shards", "num_shards must be >= 1")
        if self.num_workers < 1:
            raise FabricConfigError(
                "num_workers", "num_workers must be >= 1")
        if self.staleness < 0:
            raise FabricConfigError(
                "staleness", "staleness must be >= 0")
        if not 0.0 < self.min_push_fraction <= 1.0:
            raise FabricConfigError(
                "min_push_fraction", "min_push_fraction must be in (0, 1]")
        if self.chunk_base < 0:
            raise FabricConfigError(
                "chunk_base", "chunk_base must be >= 0")
        if self.placement.policy not in _PLACEMENTS:
            raise FabricConfigError(
                "placement_policy",
                f"unknown placement {self.placement.policy!r}; "
                f"one of {_PLACEMENTS}")
        topo = self.wire.topology
        if topo is not None and topo.num_workers != self.num_workers:
            raise FabricConfigError(
                "topology_workers",
                f"topology is for {topo.num_workers} workers, fabric has "
                f"{self.num_workers}")
        repl = self.faults.replication
        if repl < 1:
            raise FabricConfigError(
                "replication", "replication factor must be >= 1")
        n_racks = topo.num_racks if topo is not None else 1
        if self.faults.anti_affine and repl > n_racks:
            raise FabricConfigError(
                "anti_affine",
                f"anti-affine chains need replication <= num_racks; got "
                f"R={repl} over {n_racks} rack(s) — the chain would have "
                "to wrap racks")
        sw = self.wire.switch
        if sw.enabled and sw.tor_slots < 1:
            raise FabricConfigError(
                "switch_slots",
                "an enabled switch tier needs tor_slots >= 1 (a switch "
                "with no aggregation slots can never aggregate)")
        if sw.tor_slots < 0 or sw.core_slots < 0:
            raise FabricConfigError(
                "switch_slots", "switch slot counts must be >= 0")
        plan = self.placement.plan
        if plan is not None:
            if plan.num_shards != self.num_shards:
                raise FabricConfigError(
                    "plan_shards",
                    f"plan places {plan.num_shards} shards, fabric has "
                    f"{self.num_shards}")
            if plan.num_racks != n_racks:
                raise FabricConfigError(
                    "plan_racks",
                    f"plan places {plan.num_racks} racks, topology has "
                    f"{n_racks}")
            if plan.replica_racks.shape[1] < repl:
                raise FabricConfigError(
                    "plan_replication",
                    f"plan places {plan.replica_racks.shape[1]} chain "
                    f"copies, fabric replicates at {repl}")
        return self

    # -- introspection ---------------------------------------------------
    def describe(self) -> str:
        """Every knob, round-tripped — ``PBoxFabric.describe()`` embeds
        this so a fabric's printout names its full construction surface."""
        codec = (self.wire.compression.codec
                 if self.wire.compression is not None else "none")
        topo = self.wire.topology
        sw = self.wire.switch
        lines = [
            f"FabricConfig: shards={self.num_shards} mode={self.mode}"
            + (f"(s={self.staleness})" if self.mode == "stale" else "")
            + f" workers={self.num_workers}"
            + f" min_push={self.min_push_fraction:g}",
            f"  wire: codec={codec}"
            + (f" racks={topo.num_racks}"
               f" oversub=1:{topo.oversubscription:g}" if topo else
               " (no topology)")
            + (" link=custom" if self.wire.link is not None else ""),
            f"  switch: {'on' if sw.enabled else 'off'}"
            + (f" tor_slots={sw.tor_slots} core_slots={sw.core_slots}"
               if sw.enabled else ""),
            f"  faults: replication={self.faults.replication}"
            + (" anti_affine" if self.faults.anti_affine else "")
            + (f" plan={len(self.faults.fault_plan)} events"
               if self.faults.fault_plan is not None else ""),
            f"  placement: policy={self.placement.policy}"
            + (" plan=explicit" if self.placement.plan is not None
               else " plan=default"),
        ]
        if self.namespace is not None:
            lines[0] += f" ns={self.namespace}@{self.chunk_base}"
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# the serving surface (core/serving.py)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class SLOConfig:
    """One tenant class's service-level objective.

    ``latency_budget_us`` is the event-clock deadline a request must
    complete within to count toward goodput; ``staleness_bound`` the
    freshness requirement its reads carry (rounds behind the newest
    servable version — also the hierarchy tier selector's routing key);
    ``priority`` orders tenants under overload shedding (lower sheds
    first — strictly, not proportionally: an overloaded plane protects
    its highest-priority admitted tenants outright)."""

    latency_budget_us: float = float("inf")
    staleness_bound: int = 0
    priority: float = 1.0


@dataclasses.dataclass(frozen=True)
class AdmissionConfig:
    """Token-bucket admission control + overload shedding.

    Each tenant's bucket refills at ``rate_per_us`` request-tokens per
    event-clock microsecond up to ``burst``; an arrival with no token is
    shed at the door (``shed_rate_limit``).  Admitted requests can still
    be shed under overload: when a frontend's queued backlog would push a
    request past ``shed_slack`` times its tenant's latency budget, the
    plane sheds it rather than serve it late (``shed_overload``) — lower
    priority tenants shed first."""

    enabled: bool = False
    rate_per_us: float = 1.0
    burst: int = 8
    shed_slack: float = 1.0


@dataclasses.dataclass(frozen=True)
class HierarchyConfig:
    """The geo read-plane ladder (core/hierarchy.py).

    Three frontend tiers at increasing distance from the fabric — rack
    (co-racked with the serving replicas), cluster (same cluster, across
    the oversubscribed core), cross-cluster (the client's own region,
    across the WAN).  ``staleness_ladder`` is each tier's cache bound,
    strictly increasing from 0 (the rack tier serves read-your-round);
    ``frontends_per_tier`` sizes each tier; ``geo_oversubscription`` is
    the WAN hop's cost factor relative to a rack-local hop (the core hop
    uses the topology's own oversubscription via ``hop_cost``)."""

    enabled: bool = False
    staleness_ladder: tuple[int, ...] = (0, 4, 16)
    frontends_per_tier: tuple[int, ...] = (1, 1, 1)
    geo_oversubscription: float = 8.0


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """The whole construction surface of a read plane, as one value.

    Mirrors ``FabricConfig``: frozen plain data, every cross-field rule
    in ``validate()`` (named ``FabricConfigError`` subrules), a legacy
    keyword adapter warning once per call site, and a ``describe()``
    round-trip.  ``cache_rows`` only applies to ``SparseReadPlane``;
    ``slos`` maps tenant-class names to their objectives (the admission
    controller and the SLO bench key requests by these names)."""

    num_frontends: int = 1
    max_staleness: int = 0
    name: str = "serve"
    priority: float = 1.0
    bandwidth_cap: float | None = None
    serve_us_per_read: float = 0.05
    cache_rows: int = 256
    slos: tuple[tuple[str, SLOConfig], ...] = ()
    admission: AdmissionConfig = AdmissionConfig()
    hierarchy: HierarchyConfig = HierarchyConfig()

    # -- legacy adapters -------------------------------------------------
    @classmethod
    def from_legacy_kwargs(cls, **kw: Any) -> "ServeConfig":
        """Build a config from the pre-consolidation ``ReadPlane``
        keyword spread (see ``SERVE_LEGACY_KWARGS``)."""
        unknown = set(kw) - set(SERVE_LEGACY_KWARGS)
        if unknown:
            raise TypeError(
                f"unknown ReadPlane argument(s): {sorted(unknown)}; "
                f"legacy keywords are {sorted(SERVE_LEGACY_KWARGS)}")
        return cls(
            num_frontends=kw.get("num_frontends", 1),
            max_staleness=kw.get("max_staleness", 0),
            name=kw.get("name", "serve"),
            priority=kw.get("priority", 1.0),
            bandwidth_cap=kw.get("bandwidth_cap"),
            serve_us_per_read=kw.get("serve_us_per_read", 0.05),
        )

    @classmethod
    def from_sparse_legacy_kwargs(cls, **kw: Any) -> "ServeConfig":
        """Build a config from the pre-consolidation ``SparseReadPlane``
        keyword spread (see ``SPARSE_SERVE_LEGACY_KWARGS``)."""
        unknown = set(kw) - set(SPARSE_SERVE_LEGACY_KWARGS)
        if unknown:
            raise TypeError(
                f"unknown SparseReadPlane argument(s): {sorted(unknown)}; "
                f"legacy keywords are {sorted(SPARSE_SERVE_LEGACY_KWARGS)}")
        return cls(
            num_frontends=kw.get("num_frontends", 1),
            cache_rows=kw.get("cache_rows", 256),
            name=kw.get("name", "sparse-serve"),
            serve_us_per_read=kw.get("serve_us_per_read", 0.01),
        )

    # -- validation ------------------------------------------------------
    def validate(self) -> "ServeConfig":
        """Check every cross-field rule before any plane state exists."""
        if self.num_frontends < 1:
            raise FabricConfigError(
                "serve_frontends", "num_frontends must be >= 1")
        if self.max_staleness < 0:
            raise FabricConfigError(
                "serve_staleness", "max_staleness must be >= 0")
        if self.priority <= 0.0:
            raise FabricConfigError(
                "serve_priority", "priority must be > 0")
        if (self.bandwidth_cap is not None
                and not 0.0 < self.bandwidth_cap <= 1.0):
            raise FabricConfigError(
                "serve_bandwidth_cap", "bandwidth_cap must be in (0, 1]")
        if self.serve_us_per_read < 0.0:
            raise FabricConfigError(
                "serve_cost", "serve_us_per_read must be >= 0")
        if self.cache_rows < 1:
            raise FabricConfigError(
                "serve_cache_rows", "cache_rows must be >= 1")
        seen: set[str] = set()
        for tenant, slo in self.slos:
            if not tenant or tenant in seen:
                raise FabricConfigError(
                    "slo_tenant",
                    f"SLO tenant names must be unique and non-empty; "
                    f"got {tenant!r}")
            seen.add(tenant)
            if slo.latency_budget_us <= 0.0:
                raise FabricConfigError(
                    "slo_budget",
                    f"tenant {tenant!r}: latency_budget_us must be > 0")
            if slo.staleness_bound < 0:
                raise FabricConfigError(
                    "slo_staleness",
                    f"tenant {tenant!r}: staleness_bound must be >= 0")
            if slo.priority <= 0.0:
                raise FabricConfigError(
                    "slo_priority",
                    f"tenant {tenant!r}: priority must be > 0")
        adm = self.admission
        if adm.enabled:
            if adm.rate_per_us <= 0.0:
                raise FabricConfigError(
                    "admission_rate",
                    "an enabled admission controller needs rate_per_us > 0")
            if adm.burst < 1:
                raise FabricConfigError(
                    "admission_burst", "burst must be >= 1")
            if adm.shed_slack <= 0.0:
                raise FabricConfigError(
                    "admission_slack", "shed_slack must be > 0")
        hier = self.hierarchy
        if hier.enabled:
            ladder = hier.staleness_ladder
            if len(ladder) < 2:
                raise FabricConfigError(
                    "hierarchy_ladder",
                    "a hierarchy needs at least two tiers in its "
                    "staleness ladder")
            if ladder[0] != 0:
                raise FabricConfigError(
                    "hierarchy_ladder",
                    "the innermost (rack) tier must bound staleness at 0 "
                    "so every freshness requirement stays routable")
            if any(b >= a for b, a in zip(ladder, ladder[1:])):
                raise FabricConfigError(
                    "hierarchy_ladder",
                    f"staleness ladder must be strictly increasing; got "
                    f"{ladder}")
            if len(hier.frontends_per_tier) != len(ladder):
                raise FabricConfigError(
                    "hierarchy_frontends",
                    f"frontends_per_tier has {len(hier.frontends_per_tier)}"
                    f" entries for {len(ladder)} tiers")
            if any(f < 1 for f in hier.frontends_per_tier):
                raise FabricConfigError(
                    "hierarchy_frontends",
                    "every tier needs at least one frontend")
            if hier.geo_oversubscription < 1.0:
                raise FabricConfigError(
                    "hierarchy_geo",
                    "geo_oversubscription must be >= 1 (1 = the WAN is as "
                    "cheap as a rack hop)")
        return self

    # -- introspection ---------------------------------------------------
    def describe(self) -> str:
        """Every knob, round-tripped — ``ReadPlane.describe()`` names its
        construction surface with this."""
        lines = [
            f"ServeConfig[{self.name}]: frontends={self.num_frontends} "
            f"stale<={self.max_staleness} priority={self.priority:g}"
            + (f" cap={self.bandwidth_cap:g}"
               if self.bandwidth_cap is not None else "")
            + f" us/read={self.serve_us_per_read:g}",
        ]
        if self.slos:
            parts = ", ".join(
                f"{t}(<{s.latency_budget_us:g}us, stale<={s.staleness_bound}"
                f", prio {s.priority:g})" for t, s in self.slos)
            lines.append(f"  slos: {parts}")
        if self.admission.enabled:
            a = self.admission
            lines.append(f"  admission: {a.rate_per_us:g}/us burst={a.burst}"
                         f" shed_slack={a.shed_slack:g}")
        if self.hierarchy.enabled:
            h = self.hierarchy
            lines.append(
                "  hierarchy: ladder="
                + "/".join(str(s) for s in h.staleness_ladder)
                + " frontends="
                + "/".join(str(f) for f in h.frontends_per_tier)
                + f" geo=1:{h.geo_oversubscription:g}")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# the workload surface (core/workload.py)
# ---------------------------------------------------------------------------
_ARRIVALS = ("open", "poisson", "mmpp")


@dataclasses.dataclass(frozen=True)
class ArrivalConfig:
    """One tenant's arrival process.

    ``"open"`` is the exact fixed-spacing open-loop generator (request i
    arrives at ``i * interarrival_us`` — the legacy serve_load shape);
    ``"poisson"`` draws exponential interarrivals with the same mean;
    ``"mmpp"`` is a two-state Markov-modulated Poisson process — the
    bursty shape — whose hi state multiplies the rate by
    ``burst_factor`` and whose state dwell times are exponential with
    mean ``burst_dwell_us``."""

    process: str = "open"
    interarrival_us: float = 10.0
    burst_factor: float = 8.0
    burst_dwell_us: float = 200.0


@dataclasses.dataclass(frozen=True)
class DiurnalConfig:
    """Sinusoidal rate modulation: rate(t) = base * (1 + amplitude *
    sin(2π (t/period + phase))) — the daily cycle, compressed onto the
    event clock."""

    enabled: bool = False
    amplitude: float = 0.5
    period_us: float = 1000.0
    phase: float = 0.0


@dataclasses.dataclass(frozen=True)
class FlashCrowdConfig:
    """A flash crowd: the arrival rate multiplies by ``magnitude`` inside
    ``[at_us, at_us + duration_us)`` — the overload window the admission
    controller exists for."""

    enabled: bool = False
    at_us: float = 0.0
    duration_us: float = 100.0
    magnitude: float = 10.0


@dataclasses.dataclass(frozen=True)
class TenantLoadConfig:
    """One tenant's load mix.

    Open-loop (``clients == 0``): ``n_requests`` arrivals drawn from
    ``arrival`` (modulated by ``diurnal``/``flash``), batched up to
    ``batch_max`` per frontend visit.  Closed-loop (``clients >= 1``):
    each client issues ``requests_per_client`` requests, waiting for the
    previous completion plus an exponential think time of mean
    ``think_us`` before the next — arrivals depend on service times, so
    the trace pre-draws the think times and the driver replays them.
    ``staleness_req`` rides on every request (the hierarchy tier
    selector's routing key and the SLO staleness check)."""

    name: str = "load"
    arrival: ArrivalConfig = ArrivalConfig()
    diurnal: DiurnalConfig = DiurnalConfig()
    flash: FlashCrowdConfig = FlashCrowdConfig()
    n_requests: int = 0
    batch_max: int = 1
    staleness_req: int = 0
    clients: int = 0
    think_us: float = 0.0
    requests_per_client: int = 0


@dataclasses.dataclass(frozen=True)
class WorkloadConfig:
    """A whole serving workload: per-tenant mixes sharing one read plane.

    Declarative and frozen like ``FabricConfig``; randomness happens
    exactly once, in ``core/workload.generate_trace(config, seed)`` —
    the trace is replayable (``to_json``/``from_json``) the same way a
    ``FaultPlan`` is."""

    tenants: tuple[TenantLoadConfig, ...] = ()

    def validate(self) -> "WorkloadConfig":
        """Check every cross-field rule before any trace is drawn."""
        if not self.tenants:
            raise FabricConfigError(
                "workload_tenants", "a workload needs at least one tenant")
        seen: set[str] = set()
        for t in self.tenants:
            if not t.name or t.name in seen:
                raise FabricConfigError(
                    "tenant_name",
                    f"tenant names must be unique and non-empty; got "
                    f"{t.name!r}")
            seen.add(t.name)
            if t.arrival.process not in _ARRIVALS:
                raise FabricConfigError(
                    "arrival_process",
                    f"tenant {t.name!r}: unknown arrival process "
                    f"{t.arrival.process!r}; one of {_ARRIVALS}")
            if t.arrival.interarrival_us <= 0.0:
                raise FabricConfigError(
                    "arrival_rate",
                    f"tenant {t.name!r}: interarrival_us must be > 0")
            if t.arrival.process == "mmpp" and (
                    t.arrival.burst_factor < 1.0
                    or t.arrival.burst_dwell_us <= 0.0):
                raise FabricConfigError(
                    "mmpp_shape",
                    f"tenant {t.name!r}: MMPP needs burst_factor >= 1 and "
                    "burst_dwell_us > 0")
            if t.diurnal.enabled and not 0.0 <= t.diurnal.amplitude < 1.0:
                raise FabricConfigError(
                    "diurnal_amplitude",
                    f"tenant {t.name!r}: diurnal amplitude must be in "
                    "[0, 1) (an amplitude of 1 would zero the rate)")
            if t.diurnal.enabled and t.diurnal.period_us <= 0.0:
                raise FabricConfigError(
                    "diurnal_period",
                    f"tenant {t.name!r}: diurnal period_us must be > 0")
            if t.flash.enabled and (t.flash.magnitude < 1.0
                                    or t.flash.duration_us <= 0.0
                                    or t.flash.at_us < 0.0):
                raise FabricConfigError(
                    "flash_shape",
                    f"tenant {t.name!r}: a flash crowd needs magnitude >= "
                    "1, duration_us > 0 and at_us >= 0")
            if t.batch_max < 1:
                raise FabricConfigError(
                    "batch_max",
                    f"tenant {t.name!r}: batch_max must be >= 1")
            if t.staleness_req < 0:
                raise FabricConfigError(
                    "staleness_req",
                    f"tenant {t.name!r}: staleness_req must be >= 0")
            if t.clients < 0:
                raise FabricConfigError(
                    "closed_loop",
                    f"tenant {t.name!r}: clients must be >= 0")
            if t.clients > 0:
                if t.requests_per_client < 1:
                    raise FabricConfigError(
                        "closed_loop",
                        f"tenant {t.name!r}: closed-loop clients need "
                        "requests_per_client >= 1")
                if t.think_us < 0.0:
                    raise FabricConfigError(
                        "closed_loop",
                        f"tenant {t.name!r}: think_us must be >= 0")
                if t.arrival.process != "open":
                    raise FabricConfigError(
                        "closed_loop",
                        f"tenant {t.name!r}: closed-loop tenants pace "
                        "themselves by think time; arrival process must "
                        "stay 'open'")
            elif t.n_requests < 1:
                raise FabricConfigError(
                    "open_loop",
                    f"tenant {t.name!r}: an open-loop tenant needs "
                    "n_requests >= 1")
        return self

    def describe(self) -> str:
        """One line per tenant: its process, rate and loop shape."""
        lines = ["WorkloadConfig:"]
        for t in self.tenants:
            shape = (f"closed({t.clients}x{t.requests_per_client}, "
                     f"think {t.think_us:g}us)" if t.clients
                     else f"open({t.n_requests})")
            mods = []
            if t.diurnal.enabled:
                mods.append(f"diurnal(a={t.diurnal.amplitude:g})")
            if t.flash.enabled:
                mods.append(f"flash(x{t.flash.magnitude:g}@"
                            f"{t.flash.at_us:g}us)")
            lines.append(
                f"  {t.name}: {t.arrival.process} "
                f"1/{t.arrival.interarrival_us:g}us {shape}"
                + (" " + "+".join(mods) if mods else "")
                + f" batch<={t.batch_max} stale<={t.staleness_req}")
        return "\n".join(lines)
