"""Multi-tenant PBox: concurrent training jobs on one shared fabric (torch
counterpart of ``repro/core/tenancy.py``).

PBox is shared central PS hardware: a balanced rack-scale box that many
tenants' jobs drive at once.  This module adds that layer on top of the
chunk-sharded fabric:

  ``JobSpec``        one tenant's job: model, optimizer, worker set,
                     priority weight, wire codec, admission mode.
  ``JobHandle``      the tenant's view of the shared fabric: it exposes the
                     ``PBoxFabric`` worker API (pull/push/push_chunks), so a
                     ``WorkerHarness`` drives it unchanged, plus job-level
                     telemetry (per-job ``ServerStats``, simulated step
                     time).
  ``MultiJobFabric`` the shared box: one shard set, one physical wire.
                     Each attached job's chunk space is mapped into a
                     per-job *namespace* on the shared shards (global chunk
                     id = the job's ``chunk_base`` + local id; shard s holds
                     every job's shard-s slab), and all jobs' rack-link and
                     core-link transfers run on one shared event clock with
                     weighted fair sharing.

Fair sharing: while ``J`` jobs are attached, job ``j``'s wire stages are
inflated by ``scale_j = sum_i(priority_i) / priority_j`` (the fluid-flow
limit of weighted fair queueing), floored at ``1 / bandwidth_cap_j`` when
the job is capped.  Every transfer is also booked on the per-link
``LinkQueue``s (one per physical rack edge link and one core uplink,
``core/topology.py``), so co-tenants inflate each other's
``sim_core_wire_us`` and the queues expose the box's utilization.

Isolation: contention is timing only.  A job's sync training on the shared
box is bit-identical to the same job alone on a dedicated fabric at any
co-tenant count, shard count and rack layout: each job's pushes are
aggregated by its own admission state over its own namespace, and each
job's slabs are tensors of its own, which the kernels write in place.
Each job's slab is chain-replicated at the job's own ``replication`` and
fails over independently: a co-tenant's crash, failover and re-silvering
are timing events on the shared wire, never numeric ones.

Attach and detach at runtime reuse the snapshot/restore machinery
(``runtime/elastic.py``): ``detach`` returns a host snapshot under the JAX
package's keys, and ``attach(snapshot=)`` restores it, re-targeting the
flat state through ``elastic_restore`` when the new shard count re-pads
the chunk space.  A snapshot of either package re-attaches on the other.

The JAX constructor arguments ``use_pallas`` / ``fused_wire_path`` become
``device``: the kernels run on the card, their plain versions on the CPU,
and the fused wire route is taken wherever the kernel supports it.

Serve tenants (``attach_serving``): a read plane (``core/serving.py``)
attached as a co-tenant of a training job joins the fair-share priority
totals and books its refresh streams on the box's link queues, but owns no
chunk space; detaching the source job detaches its serve tenants with it.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core.chunking import DEFAULT_CHUNK_ELEMS, ParamSpace
from repro_torch.core.compression import CompressionConfig
from repro_torch.core.config import (
    FabricConfig,
    FaultConfig,
    PlacementConfig,
    ServeConfig,
    SwitchConfig,
    WireConfig,
)
from repro_torch.core.fabric import LinkModel, PBoxFabric, ServerStats
from repro_torch.core.topology import LinkQueue, NetworkTopology
from repro_torch.device import resolve_device
from repro_torch.optim.optimizers import OptimizerSpec
# the module, not its function: runtime/elastic imports core.chunking,
# whose package imports this module, so the name resolves at call time
from repro_torch.runtime import elastic


@dataclasses.dataclass(frozen=True)
class JobSpec:
    """One tenant job's static description.

    ``priority`` is the weighted-fair-share weight (2.0 gets twice the wire
    of 1.0 under contention); ``bandwidth_cap`` optionally caps the job at
    that fraction of each shared link even when the box is otherwise idle.
    ``params`` is the job's initial parameter tree; the fabrics built from
    it copy it and never write it."""

    name: str
    params: Any  # the model's parameter tree (the job's initial state)
    optimizer: OptimizerSpec
    num_workers: int
    priority: float = 1.0
    bandwidth_cap: float | None = None  # fraction of each link in (0, 1]
    codec: str = "none"  # "none" | "bf16" | "int8"
    mode: str = "sync"  # "sync" | "async" | "stale"
    staleness: int = 0
    min_push_fraction: float = 1.0
    chunk_elems: int = DEFAULT_CHUNK_ELEMS
    # fault tier: chain-replicate this job's slabs at factor R and drive
    # its own fault schedule; one tenant's crashes never touch another's
    # bits
    replication: int = 1
    fault_plan: Any | None = None  # replication.FaultPlan

    def __post_init__(self):
        if not self.name:
            raise ValueError("job needs a non-empty name")
        if self.num_workers < 1:
            raise ValueError("num_workers must be >= 1")
        if self.priority <= 0.0:
            raise ValueError("priority must be > 0")
        if self.bandwidth_cap is not None and not 0.0 < self.bandwidth_cap <= 1.0:
            raise ValueError("bandwidth_cap must be in (0, 1]")
        if self.replication < 1:
            raise ValueError("replication factor must be >= 1")


class JobHandle:
    """One tenant's live view of the shared fabric.

    Quacks like the job's dedicated ``PBoxFabric`` (attribute access
    delegates), so ``WorkerHarness(handle, ...)`` works unchanged; adds the
    job-level telemetry the tenancy layer owns."""

    def __init__(self, spec: JobSpec, fabric: PBoxFabric, chunk_base: int):
        self.spec = spec
        self.fabric = fabric
        self.chunk_base = chunk_base
        self.detached = False

    # -- delegation: the PBoxFabric worker API ---------------------------
    def __getattr__(self, item):
        return getattr(self.fabric, item)

    @property
    def name(self) -> str:
        return self.spec.name

    @property
    def stats(self) -> ServerStats:
        """This job's own ServerStats (never mixed with co-tenants')."""
        return self.fabric.stats

    # -- namespace -------------------------------------------------------
    def global_chunks(self) -> np.ndarray:
        """This job's chunk ids in the box-wide namespace."""
        return self.fabric.global_chunk_ids()

    # -- telemetry -------------------------------------------------------
    def sim_step_time_us(self) -> float:
        """Simulated pipelined time per aggregation round: the number
        co-tenancy inflates."""
        s = self.fabric.stats
        return s.sim_pipelined_us / max(1, s.steps)

    def telemetry(self) -> dict:
        s = self.fabric.stats
        return {
            "job": self.spec.name,
            "priority": self.spec.priority,
            "steps": s.steps,
            "sim_step_us": self.sim_step_time_us(),
            "sim_core_wire_us": s.sim_core_wire_us,
            "bytes_pushed": s.bytes_pushed,
            "bytes_pulled": s.bytes_pulled,
            "late_pushes_dropped": s.late_pushes_dropped,
            "detached": self.detached,
        }


def _job_config(
    spec: JobSpec,
    *,
    num_shards: int,
    num_racks: int,
    oversubscription: float,
    link: LinkModel,
    switch: SwitchConfig | None = None,
    namespace: str | None = None,
    chunk_base: int = 0,
) -> FabricConfig:
    """One job's full fabric configuration: the single source both the
    shared box and its dedicated counterfactual build from, so the
    bit-identity comparison never drifts onto differently configured
    twins."""
    topology = None
    if num_racks > 1 and spec.num_workers > 1:
        topology = NetworkTopology(
            num_workers=spec.num_workers,
            num_racks=min(num_racks, spec.num_workers),
            oversubscription=oversubscription,
        )
    return FabricConfig(
        num_shards=num_shards,
        mode=spec.mode,
        staleness=spec.staleness,
        num_workers=spec.num_workers,
        min_push_fraction=spec.min_push_fraction,
        namespace=namespace,
        chunk_base=chunk_base,
        wire=WireConfig(
            topology=topology,
            compression=CompressionConfig(codec=spec.codec),
            link=link,
            switch=switch or SwitchConfig(),
        ),
        faults=FaultConfig(replication=spec.replication,
                           fault_plan=spec.fault_plan),
        placement=PlacementConfig(),
    )


def _build_fabric(
    spec: JobSpec,
    *,
    num_shards: int,
    device: torch.device,
    shared_clock: Any | None = None,
    **cfg_kw: Any,
) -> PBoxFabric:
    """Construct one job's fabric from its ``_job_config``.  The flat
    initial state is a fresh copy of ``spec.params`` (``flatten`` packs
    into a new buffer), so the kernels never write the spec's tree."""
    space = ParamSpace.build(
        spec.params, chunk_elems=spec.chunk_elems, num_owners=num_shards)
    cfg = _job_config(spec, num_shards=num_shards, **cfg_kw)
    return PBoxFabric(
        space,
        spec.optimizer,
        space.flatten(spec.params),
        config=cfg,
        device=device,
        shared_clock=shared_clock,
    )


class MultiJobFabric:
    """The shared PBox: one balanced shard set, one physical wire, many
    tenant jobs.

    Each job gets its own ``PBoxFabric`` control plane (admission state,
    per-job ``ServerStats``) whose chunk space is namespaced onto the
    *shared* shard set: shard ``s`` of the box holds every job's shard-s
    slab, and global chunk ids are disjoint across jobs.  All jobs share
    the event clock: wire stages are inflated by weighted fair sharing
    (see the module docstring) and booked on per-link ``LinkQueue``s.

    The jobs' state lives on ``device``: the CUDA card unless the caller
    passes another (the tests pass ``"cpu"``)."""

    def __init__(
        self,
        *,
        num_shards: int = 1,
        num_racks: int = 1,
        oversubscription: float = 4.0,
        link: LinkModel | None = None,
        switch: SwitchConfig | None = None,
        device: torch.device | str | None = None,
    ):
        if num_shards < 1:
            raise ValueError("num_shards must be >= 1")
        if num_racks < 1:
            raise ValueError("num_racks must be >= 1")
        self.num_shards = num_shards
        self.num_racks = num_racks
        self.oversubscription = oversubscription
        self.link = link or LinkModel()
        self.device = resolve_device(device)
        # the box's ToR and core switch register pools are shared like the
        # links.  Grants are static at attach and full-slab-or-nothing: a
        # job gets its whole chunk count from the per-ToR budget (and the
        # core budget when it has room) or no switch tier at all, so a
        # granted job's offload matches a dedicated fabric with the same
        # grant bit for bit
        self.switch = switch or SwitchConfig()
        self._tor_slots_left = self.switch.tor_slots
        self._core_slots_left = self.switch.core_slots
        self.switch_grants: dict[str, SwitchConfig] = {}
        self.jobs: dict[str, JobHandle] = {}
        # serve tenants (core/serving.py): read planes attached as
        # co-tenants join the fair-share priority totals and book refresh
        # streams on the shared links, but own no chunk space
        self.serving: dict[str, Any] = {}
        self._serve_source: dict[str, str] = {}  # serve name -> job name
        self._next_chunk_base = 0
        # plan-driven fair-share weight overrides (tenant name -> weight):
        # they shadow the attach-time JobSpec priorities; timing only
        self._share_override: dict[str, float] = {}
        self.links: dict[str, LinkQueue] = {
            **{f"rack{r}": LinkQueue(f"rack{r}") for r in range(num_racks)},
            "core": LinkQueue("core"),
        }
        if self.switch.enabled:
            # pool registers contend like a link: per-round occupancy is
            # booked through the record_switch hook
            self.links["switch"] = LinkQueue("switch")
        self.rounds = 0  # aggregation rounds across all tenants

    # -- tenancy lifecycle ----------------------------------------------
    def attach(
        self,
        spec: JobSpec,
        *,
        snapshot: dict | None = None,
        snapshot_space: ParamSpace | None = None,
    ) -> JobHandle:
        """Admit a job onto the shared box.

        ``snapshot`` / ``snapshot_space`` resume a detached job: the flat
        state is re-targeted through ``runtime/elastic`` when this box's
        shard count re-pads the chunk space differently from the box the
        snapshot was taken on."""
        if spec.name in self.jobs or spec.name in self.serving:
            # tenant names are one namespace: the per-link by_job
            # accounting and the priority totals key on them
            raise ValueError(f"tenant {spec.name!r} is already attached")
        grant = self._grant_switch(spec)
        fabric = _build_fabric(
            spec,
            num_shards=self.num_shards,
            device=self.device,
            num_racks=self.num_racks,
            oversubscription=self.oversubscription,
            link=self.link,
            switch=grant,
            namespace=spec.name,
            chunk_base=self._next_chunk_base,
            shared_clock=self,
        )
        space = fabric.space
        handle = JobHandle(spec, fabric, self._next_chunk_base)
        # the namespace only grows: a detached job's range is never reused
        self._next_chunk_base += space.num_chunks
        if snapshot is not None:
            if (snapshot_space is not None
                    and snapshot_space.flat_elems != space.flat_elems):
                snapshot, _ = elastic.elastic_restore(
                    dict(snapshot), snapshot_space, self.num_shards)
            fabric.restore(snapshot)
        self.jobs[spec.name] = handle
        return handle

    def _grant_switch(self, spec: JobSpec) -> SwitchConfig | None:
        """Attach-time switch-slot grant, full-slab-or-nothing.

        A training job on the int8 wire under a rack topology gets its
        whole chunk count from the per-ToR register budget (and from the
        core budget when that pool has room) or nothing: a partial grant
        could never engage (``SwitchCompute.can_offload`` is
        all-or-nothing).  The grant is recorded in ``switch_grants`` so
        ``dedicated_fabric`` builds the identically granted twin, and
        returned on detach.  The chunk count comes from the tree's shapes
        alone (``ParamSpace.build`` reads no values)."""
        if (not self.switch.enabled or spec.codec != "int8"
                or spec.mode == "async"
                or not (self.num_racks > 1 and spec.num_workers > 1)):
            return None
        chunks = ParamSpace.build(
            spec.params, chunk_elems=spec.chunk_elems,
            num_owners=self.num_shards).num_chunks
        if self._tor_slots_left < chunks:
            return None
        self._tor_slots_left -= chunks
        core = 0
        if self._core_slots_left >= chunks:
            self._core_slots_left -= chunks
            core = chunks
        grant = SwitchConfig(enabled=True, tor_slots=chunks, core_slots=core)
        self.switch_grants[spec.name] = grant
        return grant

    def detach(self, name: str) -> dict:
        """Evict a job; returns its snapshot (params, optimizer state, step,
        worker clocks, as host copies) so ``attach(snapshot=...)`` resumes
        it, on this box or another one (elastic re-target included).  Serve
        tenants reading the job detach with it (their planes keep working
        against the now-dedicated fabric, uncontended).  Any switch-slot
        grant returns to the box's register budget."""
        if name not in self.jobs:
            raise KeyError(f"job {name!r} is not attached")
        handle = self.jobs.pop(name)
        handle.detached = True
        self._share_override.pop(name, None)
        grant = self.switch_grants.pop(name, None)
        if grant is not None:
            self._tor_slots_left += grant.tor_slots
            self._core_slots_left += grant.core_slots
        # a detached job no longer contends: its handle, if still driven,
        # behaves like a dedicated fabric
        handle.fabric.shared_clock = None
        for sname, src in list(self._serve_source.items()):
            if src == name:
                self.detach_serving(sname)
        return handle.fabric.snapshot()

    # -- serve tenants (core/serving.py) ---------------------------------
    def attach_serving(
        self,
        spec: JobSpec,
        source: str,
        *,
        config=None,
        max_staleness: int = 0,
        serve_us_per_read: float = 0.05,
    ):
        """Attach a read plane as a co-tenant serving ``source``'s params.

        The serve job rides the same ``JobSpec`` surface as a training
        tenant: ``priority`` joins the weighted-fair-share totals (so serve
        traffic inflates co-tenants' wire stages and vice versa),
        ``bandwidth_cap`` floors its own share, and ``num_workers`` is the
        frontend count.  ``params``/``optimizer`` are ignored (a serve
        tenant owns no chunk space: it reads the source job's replica
        tails).  Contention is timing-only: attaching a serve tenant leaves
        every training tenant bit-identical.

        ``config`` (a ``core.config.ServeConfig``) carries the serving
        knobs beyond the JobSpec (staleness bound, SLOs, admission,
        hierarchy); the spec's name/priority/cap/frontend count override
        the config's.  With ``config.hierarchy.enabled`` the attached plane
        is a ``HierarchicalReadPlane`` sized by its ``frontends_per_tier``.
        """
        from repro_torch.core.serving import HierarchicalReadPlane, ReadPlane

        if spec.name in self.jobs or spec.name in self.serving:
            raise ValueError(f"tenant {spec.name!r} is already attached")
        if source not in self.jobs:
            raise KeyError(f"serve source job {source!r} is not attached")
        if config is None:
            config = ServeConfig(max_staleness=max_staleness,
                                 serve_us_per_read=serve_us_per_read)
        config = dataclasses.replace(
            config,
            name=spec.name,
            priority=spec.priority,
            bandwidth_cap=spec.bandwidth_cap,
            num_frontends=spec.num_workers,
        )
        cls = (HierarchicalReadPlane if config.hierarchy.enabled
               else ReadPlane)
        plane = cls(self.jobs[source], config=config, shared=self)
        self.serving[spec.name] = plane
        self._serve_source[spec.name] = source
        return plane

    def detach_serving(self, name: str):
        """Detach a serve tenant: its plane keeps serving (standalone,
        uncontended) but stops contending on the shared wire."""
        if name not in self.serving:
            raise KeyError(f"serve tenant {name!r} is not attached")
        plane = self.serving.pop(name)
        self._serve_source.pop(name, None)
        self._share_override.pop(name, None)
        plane.shared = None
        return plane

    def serve_scale(self, plane) -> float:
        """Fair-share inflation for one serve tenant's refresh streams:
        total active priority weight (training + serve tenants) over the
        plane's own, the rule ``wire_scales`` applies to training
        transfers.  The plane applies its own bandwidth-cap floor on top.
        A hierarchical plane's tier planes share their parent's attachment
        (one serve tenant, one priority weight)."""
        attached = self.serving.get(plane.name)
        if attached is None or (attached is not plane
                                and attached is not getattr(
                                    plane, "parent", None)):
            raise KeyError(
                f"serve tenant {plane.name!r} is not attached to this box")
        return (self._total_priority()
                / self._priority_of(plane.name, plane.priority))

    def _total_priority(self) -> float:
        return (sum(self._priority_of(h.name, h.spec.priority)
                    for h in self.jobs.values())
                + sum(self._priority_of(p.name, p.priority)
                      for p in self.serving.values()))

    def _priority_of(self, name: str, default: float) -> float:
        """One tenant's live fair-share weight: the plan override when set,
        the attach-time spec priority otherwise."""
        return self._share_override.get(name, default)

    def apply_tenant_shares(self, shares: dict[str, float]) -> int:
        """Apply a placement plan's per-tenant bandwidth shares (the
        ``tenant_shares`` plan delta).  Weights shadow the attach-time
        ``JobSpec.priority`` values in every fair-share computation; names
        not attached are ignored (the plan may be older than a detach).
        Timing only.  Returns the number of tenants whose weight
        changed."""
        changed = 0
        for name, weight in (shares or {}).items():
            if name not in self.jobs and name not in self.serving:
                continue
            weight = float(weight)
            if weight <= 0.0:
                raise ValueError(
                    f"tenant share for {name!r} must be > 0, got {weight}")
            if self._share_override.get(name) != weight:
                changed += 1
            self._share_override[name] = weight
        return changed

    def apply_plan_delta(self, delta) -> int:
        """Apply the tenancy-owned plan delta kind (``tenant_shares``).
        Fabric-owned kinds must go to the per-job fabrics."""
        if delta.kind != "tenant_shares":
            raise ValueError(
                f"MultiJobFabric applies 'tenant_shares' deltas, got "
                f"{delta.kind!r}")
        return self.apply_tenant_shares(dict(delta.shares))

    # -- fault tier ------------------------------------------------------
    def crash_shard(self, shard_id: int) -> dict[str, str]:
        """The physical engine ``shard_id`` dies for *every* tenant: each
        attached job holds a slab on it, so each job's fabric fails over its
        own slab (promoting its own chain replica).

        Returns job -> action.  Tenants are processed in attach order; an
        under-replicated tenant (replication == 1) raises ``ShardLost``
        *after* every replicated tenant has failed over, so one tenant's
        missing backups never block the others' recovery."""
        if not 0 <= shard_id < self.num_shards:
            raise ValueError(f"no shard {shard_id}")
        actions: dict[str, str] = {}
        lost = None
        for h in list(self.jobs.values()):
            try:
                actions[h.name] = h.fabric.crash_shard(shard_id)
            except Exception as e:  # ShardLost: record, keep failing over
                actions[h.name] = f"lost: {e}"
                if lost is None:
                    lost = e
        if lost is not None:
            raise lost
        return actions

    # -- shared event clock (PBoxFabric.shared_clock protocol) -----------
    def wire_scales(self, fabric: PBoxFabric) -> tuple[float, float]:
        """Fair-share inflation for one job's wire stages: total active
        priority weight over the job's own, floored by its bandwidth cap.
        Applied to both tiers: co-tenants contend for the rack edge links
        and the core uplink alike."""
        handle = self.jobs.get(fabric.namespace)
        if handle is None:
            raise KeyError(
                f"fabric namespace {fabric.namespace!r} is not attached")
        total = self._total_priority()
        scale = total / self._priority_of(handle.name, handle.spec.priority)
        if handle.spec.bandwidth_cap is not None:
            scale = max(scale, 1.0 / handle.spec.bandwidth_cap)
        return scale, scale

    def record_round(
        self,
        fabric: PBoxFabric,
        *,
        rack_us: float,
        core_us: float,
        rack_demand_us: float,
        core_demand_us: float,
        makespan_us: float,
    ) -> None:
        """Book one job round's link occupancy on the shared queues.

        A job's racks run in parallel, so each physical rack link the job
        occupies is busy for the whole (inflated) rack stage; the single
        core uplink carries the core stage.  ``*_demand_us`` is what the
        transfer would have taken alone: the queues' contention factor is
        busy over demand."""
        handle = self.jobs.get(fabric.namespace)
        if handle is None:  # detached mid-flight: nothing to book
            return
        scale = rack_us / rack_demand_us if rack_demand_us > 0 else 1.0
        racks = (fabric.topology.num_racks if fabric.topology is not None
                 else 1)
        for r in range(min(racks, self.num_racks)):
            self.links[f"rack{r}"].reserve(
                handle.name, rack_demand_us, scale)
        if core_us > 0.0:
            self.links["core"].reserve(
                handle.name, core_demand_us,
                core_us / core_demand_us if core_demand_us > 0 else 1.0)
        self.rounds += 1

    def record_switch(self, fabric: PBoxFabric, *, pool_us: float) -> None:
        """Book one round's switch-pool occupancy on the shared ``switch``
        queue under the job's name.  Slot capacity was reserved at attach
        (``_grant_switch``), so no contention inflation applies."""
        handle = self.jobs.get(fabric.namespace)
        q = self.links.get("switch")
        if handle is None or q is None or pool_us <= 0.0:
            return
        q.reserve(handle.name, pool_us, 1.0)

    # -- box-wide views ---------------------------------------------------
    def aggregate_stats(self) -> ServerStats:
        """Sum of every attached job's ServerStats (the box's load)."""
        out = ServerStats()
        for h in self.jobs.values():
            for f in dataclasses.fields(ServerStats):
                setattr(out, f.name,
                        getattr(out, f.name) + getattr(h.stats, f.name))
        return out

    def utilization(self) -> dict:
        """Per-link occupancy: demand vs busy µs, contention factor, and
        per-job shares."""
        return {
            name: {
                "demand_us": q.stats.demand_us,
                "busy_us": q.stats.busy_us,
                "queued_us": q.stats.queued_us,
                "contention_factor": q.stats.contention_factor,
                "by_job": dict(q.stats.by_job),
            }
            for name, q in self.links.items()
        }

    def shard_occupancy(self) -> list[dict[str, int]]:
        """Per shared shard: chunks held per job (every shard serves every
        tenant)."""
        out: list[dict[str, int]] = [{} for _ in range(self.num_shards)]
        for h in self.jobs.values():
            for sid in range(self.num_shards):
                n = int(np.sum(h.fabric.chunk_owner == sid))
                if n:
                    out[sid][h.name] = n
        return out

    def route(self, global_chunk: int) -> tuple[str, int]:
        """Namespace routing: (job name, owning shard) of a box-wide chunk
        id."""
        for h in self.jobs.values():
            local = global_chunk - h.chunk_base
            if 0 <= local < h.fabric.space.num_chunks:
                return h.name, int(h.fabric.chunk_owner[local])
        raise KeyError(f"global chunk {global_chunk} is in no attached "
                       "job's namespace")

    def describe(self) -> str:
        lines = [
            f"MultiJobFabric: {self.num_shards} shards, {self.num_racks} "
            f"racks (1:{self.oversubscription:g} core), "
            f"{len(self.jobs)} jobs, {self.rounds} rounds"
        ]
        for h in self.jobs.values():
            t = h.telemetry()
            lines.append(
                f"  job {h.name}: prio={h.spec.priority:g}, "
                f"chunks [{h.chunk_base}, "
                f"{h.chunk_base + h.fabric.space.num_chunks}), "
                f"steps={t['steps']}, sim_step={t['sim_step_us']:.1f}us"
            )
        for name, plane in self.serving.items():
            lines.append(
                f"  serve {name} (reads {self._serve_source.get(name)}): "
                + plane.describe()
            )
        for q in self.links.values():
            lines.append("  " + q.describe())
        return "\n".join(lines)


def dedicated_fabric(spec: JobSpec, box: MultiJobFabric) -> PBoxFabric:
    """The job's counterfactual: the same job alone on a dedicated fabric
    with the box's shard count, rack layout, link, codec, device and the
    same switch-slot grant the box handed the attached job.  Built by the
    construction path ``attach`` uses, minus the tenancy hooks."""
    return _build_fabric(
        spec,
        num_shards=box.num_shards,
        device=box.device,
        num_racks=box.num_racks,
        oversubscription=box.oversubscription,
        link=box.link,
        switch=box.switch_grants.get(spec.name),
    )
