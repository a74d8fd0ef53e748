"""Read plane: replica-backed parameter serving under live training (torch
counterpart of ``repro/core/serving.py``).

The paper evaluates PBox on its write path (push -> aggregate -> optimize),
but a central parameter store's other half is reads at scale: a live model
store serving version-stamped parameters to inference frontends while
training keeps mutating them.  PHub (arXiv:1805.07891) frames the PS as
rack-scale *service* hardware and GaDei (arXiv:1611.06213) runs training
and serving against one store; this module adds that read plane on top of
the fabric without touching its training hot path:

  ``ReadPlane``      the serving tier: N frontends, each with a pull cache
                     invalidated by round version, serving staleness-bounded
                     batched reads.  Cache misses refresh from *chain
                     replica tails* (core/replication.py) routed to the
                     rack-local replica (``NetworkTopology.hop_cost``), so
                     serve traffic never queues behind — or ahead of — the
                     primary aggregation engines.
  ``FabricSource``   adapter over a live ``PBoxFabric`` (or a tenancy
                     ``JobHandle``): version = the fabric's round counter,
                     bits = the replica tails' post-round slabs (the
                     primary slabs when replication is 1).
  ``SnapshotSource`` adapter over a frozen flat space (a checkpoint, or a
                     host-side copy of SPMD train state): a single
                     published version, optionally re-published/advanced
                     by the training loop (runtime/trainer.attach_telemetry
                     advances it per step).
  ``ServeStats``     read-plane accounting: hits/misses, replica vs primary
                     refreshes, rack/core serve bytes, staleness ceiling.

Serving semantics (load-bearing, tests/test_serving.py):

  * **Version stamping** — every read returns ``ReadResult.version``, the
    fabric round its bits belong to, and the bits are *bit-identical* to
    ``fabric.params`` as of that round (replica tails hold byte-exact
    post-round copies; with R = 1 the read comes from the primary slab).
  * **Staleness bound** — a read's ``staleness`` (rounds between the
    stamped version and the store's current version at serve time) never
    exceeds ``max_staleness``: the frontend cache serves hits only inside
    the bound and refreshes otherwise.  ``max_staleness=0`` is
    read-your-round consistency; larger bounds trade freshness for cache
    hit rate (SSP for the read side).
  * **Cache invalidation rule** — a frontend's cache is keyed by the round
    version it pulled; it is invalidated exactly when
    ``current_version - cached_version > max_staleness`` (and wholesale by
    ``invalidate()``, which the fabric calls on ``restore`` — a rewound
    round counter must not leave forward-dated cache entries behind).
  * **Training isolation** — the read plane never writes fabric state:
    attaching it and serving any number of reads leaves training
    bit-identical to an unserved run.  Contention is timing-only, via the
    tenancy tier: a serve job attached through
    ``MultiJobFabric.attach_serving`` carries a ``JobSpec`` priority /
    bandwidth cap, joins the weighted-fair-share totals, and books its
    refresh streams on the shared per-link ``LinkQueue``s.

The event-clock model prices a cache miss as one raw-f32 stream per shard
from its serving replica's rack into the frontend's rack (rack-local hops
ride the full-bisection tier, cross-rack hops pay the oversubscribed core
— same ``hop_cost`` the replication chains use), inflated by the serve
job's fair share; ``benchmarks/serve_load.py`` drives an open-loop load
generator against this clock and reports p50/p99 read latency.

The SLO tier (docs/architecture.md §13) stacks three more pieces on top,
all timing-and-bookkeeping only (bits never change):

  ``HierarchicalReadPlane``  the geo ladder from ``core/hierarchy.py``
                     as a read plane: rack / cluster / cross-cluster
                     frontend tiers with distinct client latency floors
                     priced off ``NetworkTopology.hop_cost``; reads
                     route to the nearest tier satisfying their
                     staleness requirement.
  ``FrontDoor``      per-tenant token-bucket admission, priority-aware
                     overload shedding (shed rather than serve late),
                     streaming p50/p99/p99.9 (``LatencyTracker``) and
                     goodput-under-SLO in ``ServeStats``; drives
                     ``core/workload.py`` traces (open- and closed-loop)
                     deterministically.

Construction is declarative: ``core.config.ServeConfig`` (SLOs,
admission, hierarchy) is the primary surface for both planes; the
pre-redesign keyword spreads warn once per call site through the same
legacy adapter cadence as ``PBoxFabric`` (docs/api.md).

Every counter, byte total and event-clock float is Python arithmetic in the
JAX package's order, so the two packages' stats agree bit for bit.  The
bits differ from the JAX package in one way that matters: JAX arrays are
immutable, while the port's kernels update shard slabs, and
``ReplicaGroup.sync`` overwrites the chain's kept buffers, in place.  So
nothing a plane caches may alias them: ``FabricSource.assemble`` copies
the tails into a fresh tensor (at R = 1 ``fabric.params`` already is one:
the fabric assembles it anew each round and never writes it),
``SnapshotSource`` owns a copy of what it is given, and the rows a
``SparseReadPlane`` caches come out of a gather into a fresh tensor.  A
read cached at version v therefore keeps v's bits after any number of
later rounds.  Tensors live on the source's device: the fabric's or tier's,
or the card for a ``SnapshotSource`` unless it is given ``device=``.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import weakref
from typing import Any

import numpy as np
import torch

from repro_torch.core.config import (AdmissionConfig, SLOConfig, ServeConfig,
                                     warn_legacy_call)
from repro_torch.core.hierarchy import select_tier, tier_ladder
from repro_torch.device import resolve_device


# ---------------------------------------------------------------------------
# stats
# ---------------------------------------------------------------------------
class LatencyTracker:
    """Streaming latency quantiles over a log-binned histogram.

    O(1) memory and O(1) per record, and — unlike t-digest-style sketches
    — fully deterministic: the same latency sequence yields the same bins
    and the same quantiles on every host, so p50/p99/p99.9 can sit in the
    bench baseline under a tight gate.  Bin edges are geometric
    (``bins_per_decade`` per decade, default 64 ≈ 3.7 % resolution);
    ``quantile`` returns the upper edge of the bin holding the q-th
    sample, clamped to the exact observed min/max."""

    def __init__(self, lo_us: float = 1e-3, hi_us: float = 1e7,
                 bins_per_decade: int = 64):
        if not 0.0 < lo_us < hi_us:
            raise ValueError("need 0 < lo_us < hi_us")
        if bins_per_decade < 1:
            raise ValueError("bins_per_decade must be >= 1")
        self.lo_us = float(lo_us)
        self.bins_per_decade = int(bins_per_decade)
        decades = math.log10(hi_us / lo_us)
        nbins = int(math.ceil(decades * bins_per_decade))
        # [0] = under lo, [1..nbins] = the geometric bins, [-1] = over hi
        self.counts = np.zeros(nbins + 2, dtype=np.int64)
        self.count = 0
        self.total_us = 0.0
        self.min_us = math.inf
        self.max_us = 0.0

    def record(self, us: float) -> None:
        if us < 0.0:
            raise ValueError("latency must be >= 0")
        us = float(us)
        if us <= self.lo_us:
            idx = 0
        else:
            idx = 1 + int(math.log10(us / self.lo_us) * self.bins_per_decade)
            idx = min(idx, len(self.counts) - 1)
        self.counts[idx] += 1
        self.count += 1
        self.total_us += us
        self.min_us = min(self.min_us, us)
        self.max_us = max(self.max_us, us)

    def quantile(self, q: float) -> float:
        """The upper bin edge covering the ``q``-quantile sample (0.0
        when nothing was recorded)."""
        if not 0.0 <= q <= 1.0:
            raise ValueError("q must be in [0, 1]")
        if self.count == 0:
            return 0.0
        target = max(1, int(math.ceil(q * self.count)))
        cum = 0
        for idx, c in enumerate(self.counts):
            cum += int(c)
            if cum >= target:
                if idx == 0:
                    edge = self.lo_us
                else:
                    edge = self.lo_us * 10.0 ** (idx / self.bins_per_decade)
                return min(max(edge, self.min_us), self.max_us)
        return self.max_us  # unreachable: cum == count covers q == 1

    @property
    def p50(self) -> float:
        return self.quantile(0.50)

    @property
    def p99(self) -> float:
        return self.quantile(0.99)

    @property
    def p999(self) -> float:
        return self.quantile(0.999)

    @property
    def mean_us(self) -> float:
        return self.total_us / self.count if self.count else 0.0

    def merge(self, other: "LatencyTracker") -> None:
        """Fold ``other``'s samples in (same binning required)."""
        if (other.lo_us != self.lo_us
                or other.bins_per_decade != self.bins_per_decade
                or len(other.counts) != len(self.counts)):
            raise ValueError("cannot merge trackers with different binning")
        self.counts += other.counts
        self.count += other.count
        self.total_us += other.total_us
        self.min_us = min(self.min_us, other.min_us)
        self.max_us = max(self.max_us, other.max_us)

    def __eq__(self, other: Any) -> bool:
        if not isinstance(other, LatencyTracker):
            return NotImplemented
        return (self.count == other.count
                and self.lo_us == other.lo_us
                and self.bins_per_decade == other.bins_per_decade
                and np.array_equal(self.counts, other.counts))

    def __repr__(self) -> str:
        if self.count == 0:
            return "LatencyTracker(empty)"
        return (f"LatencyTracker(n={self.count}, p50={self.p50:.3g}us, "
                f"p99={self.p99:.3g}us, p99.9={self.p999:.3g}us)")


@dataclasses.dataclass
class ServeStats:
    """Read-plane accounting (the serve-side twin of fabric ServerStats)."""

    reads: int = 0  # requests served (batch members count individually)
    batches: int = 0  # read_batch calls
    cache_hits: int = 0  # requests served from a frontend's pull cache
    cache_misses: int = 0  # requests that forced a refresh
    refreshes: int = 0  # replica pulls (one per miss batch)
    replica_streams: int = 0  # refresh streams served by chain backups
    primary_streams: int = 0  # refresh streams served by primary slabs (R=1)
    snapshot_streams: int = 0  # refresh streams served by a SnapshotSource
    bytes_refreshed: int = 0  # replica/primary -> frontend (raw f32)
    bytes_rack_link: int = 0  # refresh bytes on rack-local links
    bytes_core_link: int = 0  # refresh bytes crossing the core
    bytes_served: int = 0  # frontend -> client
    max_staleness_served: int = 0  # staleness ceiling actually observed
    frontend_moves: int = 0  # plan-driven frontend re-placements
    sim_serve_us: float = 0.0  # cumulative event-clock service time
    # SLO front-door accounting (FrontDoor fills these; a bare plane with
    # no front door leaves them zero)
    admitted: int = 0  # requests past the token bucket + overload check
    shed_rate_limit: int = 0  # shed at the door: no bucket token
    shed_overload: int = 0  # shed under backlog: would blow the budget
    slo_met: int = 0  # admitted, served within budget + staleness bound
    slo_violations: int = 0  # admitted but served late (or too stale)
    latency: LatencyTracker = dataclasses.field(
        default_factory=LatencyTracker)  # client-observed request latency

    @property
    def hit_rate(self) -> float:
        if self.reads == 0:
            return 0.0
        return self.cache_hits / self.reads

    @property
    def offered(self) -> int:
        """Requests that reached the front door at all."""
        return self.admitted + self.shed_rate_limit + self.shed_overload

    @property
    def shed(self) -> int:
        return self.shed_rate_limit + self.shed_overload

    @property
    def goodput(self) -> float:
        """Goodput under SLO: the fraction of *offered* requests that
        completed within their tenant's latency budget and staleness
        bound.  Shed requests count against goodput (they were offered
        and not served) — but they never count as SLO violations: the
        whole point of shedding is keeping admitted tenants inside
        budget."""
        if self.offered == 0:
            return 0.0
        return self.slo_met / self.offered


@dataclasses.dataclass(frozen=True)
class ReadResult:
    """One served read: the full flat parameter space plus its provenance.

    ``version`` is the fabric round the bits belong to; ``staleness`` is
    how many rounds behind the *upstream* round counter this read was at
    serve time.  The enforced ``max_staleness`` bound is measured against
    the newest **servable** version — identical for a fabric source, but
    a snapshot-backed store may itself lag upstream training
    (``SnapshotSource.advance``), and that lag is reported here on top of
    the bounded part."""

    version: int
    flat: torch.Tensor
    staleness: int
    cache_hit: bool
    frontend: int
    sim_us: float


@dataclasses.dataclass(frozen=True)
class _Stream:
    """One refresh stream: ``num_chunks`` chunks out of ``src_rack``."""

    num_chunks: int
    src_rack: int
    kind: str  # "replica" | "primary" | "snapshot"


# ---------------------------------------------------------------------------
# parameter sources
# ---------------------------------------------------------------------------
class FabricSource:
    """Read-side adapter over a live ``PBoxFabric`` (or a tenancy
    ``JobHandle``, which delegates the same surface).

    With replication >= 2 the bits come from each shard's *chain tail*
    (``ReplicaGroup.tail``) — byte-exact post-round copies, synced at every
    round edge, so serving never reads the primary engines the training
    hot path is writing.  With replication 1 there is no chain and reads
    fall back to the primary slabs (still bit-exact: the fabric only
    mutates them at round edges).  Refresh streams are routed from the
    replica rack nearest the reading frontend (anti-affine placement means
    most racks have a local replica of most shards)."""

    def __init__(self, fabric: Any):
        if not hasattr(fabric, "shards") or not hasattr(fabric, "space"):
            raise TypeError(
                "FabricSource wraps a PBoxFabric (or a JobHandle delegating "
                f"one); got {type(fabric).__name__}"
            )
        self.fabric = fabric

    @property
    def version(self) -> int:
        return int(self.fabric.step)

    @property
    def space(self):
        return self.fabric.space

    @property
    def num_racks(self) -> int:
        topo = self.fabric.topology
        return topo.num_racks if topo is not None else 1

    @property
    def wire_us_per_chunk(self) -> float:
        return self.fabric.link.wire_us_per_chunk

    def _replicated(self) -> bool:
        return bool(self.fabric.replication > 1 and self.fabric.replicas)

    def _primary_racks(self) -> np.ndarray:
        """Home rack per shard (the only serving option at R = 1)."""
        topo = self.fabric.topology
        if topo is None:
            return np.zeros(self.fabric.num_shards, dtype=np.int64)
        return topo.replica_racks(self.fabric.num_shards, 1)[:, 0]

    def hop_cost(self, src_rack: int, dst_rack: int) -> float:
        topo = self.fabric.topology
        if topo is None:
            return 1.0
        return topo.hop_cost(src_rack, dst_rack)

    def serve_rack(self, shard_id: int, frontend_rack: int) -> int:
        """The rack whose replica serves ``frontend_rack``'s refreshes of
        shard ``shard_id``: the cheapest hop among the chain's *backup*
        racks (every backup holds the same bits, so routing is free to be
        locality-greedy); the primary's home rack when R = 1."""
        if not self._replicated():
            return int(self._primary_racks()[shard_id])
        racks = self.fabric.replicas[shard_id].racks[1:]
        topo = self.fabric.topology
        if topo is None:
            return int(racks[0])
        return topo.nearest_rack(racks, frontend_rack)

    def streams(self, frontend_rack: int) -> list[_Stream]:
        kind = "replica" if self._replicated() else "primary"
        return [
            _Stream(shard.num_chunks, self.serve_rack(shard.shard_id,
                                                      frontend_rack), kind)
            for shard in self.fabric.shards
            if shard.num_chunks
        ]

    def assemble(self) -> torch.Tensor:
        """The full flat space at the current version, assembled from the
        serving replicas (bit-identical to ``fabric.params``: the tails are
        byte-exact copies of the post-round slabs).  Always a tensor that
        nothing else writes: the tails are copied out of the chain's kept
        buffers, which the next ``sync`` overwrites in place, and at R = 1
        ``fabric.params`` is assembled anew each round."""
        fabric = self.fabric
        if not self._replicated():
            return fabric.params
        space = fabric.space
        rows = torch.zeros((space.num_chunks, space.chunk_elems),
                           dtype=torch.float32, device=fabric.device)
        for group, shard in zip(fabric.replicas, fabric.shards):
            if group.synced_round != fabric.step:
                raise RuntimeError(
                    f"shard {shard.shard_id}'s chain is synced at round "
                    f"{group.synced_round}, fabric is at {fabric.step}: "
                    "replica tails cannot serve an unsynced round"
                )
            ids, params, _state = group.tail()
            if len(ids):
                rows[torch.from_numpy(np.asarray(ids, np.int64)).to(
                    fabric.device)] = params
        return rows.reshape(-1)


class SnapshotSource:
    """A frozen flat parameter space as a read-plane source.

    Built from a checkpointed fabric snapshot (``from_snapshot``) or any
    host/device flat array — the live-training story's other half: a
    serving tier warmed from the last checkpoint, later re-published in
    place (``publish``) or version-advanced per SPMD train step
    (``advance``, driven by ``runtime/trainer.attach_telemetry``).

    The source owns a copy of every flat it is given, on ``device`` (the
    card unless the caller passes another): the caller may reuse or
    overwrite its array."""

    def __init__(self, flat: Any, *, version: int = 0,
                 wire_us_per_chunk: float = 1.0, chunk_elems: int = 8192,
                 device: torch.device | str | None = None):
        self.device = resolve_device(device)
        self._flat = _owned_flat(flat, self.device)
        self._version = int(version)
        self._upstream = int(version)
        self.wire_us_per_chunk = float(wire_us_per_chunk)
        self.chunk_elems = int(chunk_elems)
        self.num_racks = 1

    @classmethod
    def from_snapshot(cls, snap: dict, **kw) -> "SnapshotSource":
        """Wrap a ``PBoxFabric.snapshot()`` (or ``Checkpointer``-restored)
        dict: the stamped version is the snapshot's round counter."""
        return cls(snap["params"], version=int(snap["step"]), **kw)

    @property
    def version(self) -> int:
        return self._version

    def publish(self, flat: Any, version: int) -> None:
        """Replace the served bits (a newer checkpoint landed).  Versions
        are strictly monotone: re-publishing an already-served version
        with different bits would break version-stamped bit-identity."""
        if version <= self._version:
            raise ValueError(
                f"cannot publish version {version} over {self._version}: "
                "the read plane's versions only move forward"
            )
        self._flat = _owned_flat(flat, self.device)
        self._version = int(version)
        self._upstream = max(self._upstream, self._version)

    def advance(self, rounds: int = 1) -> None:
        """The upstream trainer completed ``rounds`` more rounds without
        re-publishing bits here: reported read staleness grows (the store
        itself lags — exactly what a checkpoint-warmed serving tier does
        between checkpoint publishes)."""
        if rounds < 0:
            raise ValueError("rounds must be >= 0")
        self._upstream += rounds

    @property
    def upstream_version(self) -> int:
        """The newest version known to exist upstream (== the published
        version until ``advance`` says training moved past it)."""
        return self._upstream

    def hop_cost(self, src_rack: int, dst_rack: int) -> float:
        return 1.0

    def streams(self, frontend_rack: int) -> list[_Stream]:
        n = max(1, -(-self._flat.numel() // self.chunk_elems))
        return [_Stream(n, 0, "snapshot")]

    def assemble(self) -> torch.Tensor:
        return self._flat


def _owned_flat(flat: Any, device: torch.device) -> torch.Tensor:
    """``flat`` as an f32 vector on ``device`` that shares no storage with
    the caller's array or tensor."""
    if isinstance(flat, torch.Tensor):
        out = flat.detach().to(device, torch.float32).reshape(-1)
        if out.data_ptr() == flat.data_ptr():
            out = out.clone()
        return out
    host = np.array(flat, dtype=np.float32, copy=True).reshape(-1)
    return torch.from_numpy(host).to(device)


# ---------------------------------------------------------------------------
# the read plane
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class _Frontend:
    """One serving frontend: its rack and its version-keyed pull cache."""

    fid: int
    rack: int
    version: int | None = None
    flat: torch.Tensor | None = None


class ReadPlane:
    """Staleness-bounded, version-stamped parameter serving over a live
    fabric (or a checkpointed snapshot) — see the module docstring for the
    serving semantics.

    ``source`` may be a ``PBoxFabric``, a tenancy ``JobHandle`` (both are
    wrapped in a ``FabricSource``), or any source object (``FabricSource``
    / ``SnapshotSource``).  ``num_frontends`` serving frontends are placed
    round-robin over the topology's racks; each keeps one cached flat
    space keyed by the round version it pulled.

    Construction: the primary surface is ``config=`` — a validated
    ``core.config.ServeConfig`` carrying every knob.  The pre-redesign
    keyword spread (``max_staleness=``, ``num_frontends=``, ...) still
    works through ``ServeConfig.from_legacy_kwargs`` with a
    once-per-call-site ``DeprecationWarning`` (the same adapter cadence
    as ``PBoxFabric``); ``shared``/``plan`` are live wiring, not config,
    and stay real keywords on both paths.

    Tenancy: ``MultiJobFabric.attach_serving`` sets ``shared`` so refresh
    streams are inflated by the serve job's weighted fair share and booked
    on the shared per-link queues; standalone planes serve uncontended
    (``bandwidth_cap`` still applies)."""

    def __init__(
        self,
        source: Any,
        *,
        config: ServeConfig | None = None,
        shared: Any | None = None,
        plan: Any = None,
        **legacy: Any,
    ):
        if config is not None and legacy:
            raise TypeError(
                f"pass either config= or the legacy keyword spread, not "
                f"both (got config and {sorted(legacy)})")
        if config is None:
            if legacy:
                warn_legacy_call(constructor="ReadPlane",
                                 config="ServeConfig")
            config = ServeConfig.from_legacy_kwargs(**legacy)
        config.validate()
        if not hasattr(source, "assemble"):
            source = FabricSource(source)
        self.config = config
        self.source = source
        self.max_staleness = config.max_staleness
        self.name = config.name
        self.priority = config.priority
        self.bandwidth_cap = config.bandwidth_cap
        self.serve_us_per_read = config.serve_us_per_read
        self.shared = shared
        num_frontends = config.num_frontends
        racks = max(1, source.num_racks)
        # frontend -> rack comes from the placement plan when one is
        # attached (kwarg, else the backing fabric's); the default plan's
        # assignment is f % racks, so the default path is byte-identical
        # to the old hard-coded round-robin
        if plan is None:
            plan = getattr(getattr(source, "fabric", None), "plan", None)
        fe_racks = getattr(plan, "frontend_racks", ()) or ()
        self.frontends = [
            _Frontend(f, (int(fe_racks[f]) % racks if f < len(fe_racks)
                          else f % racks))
            for f in range(num_frontends)
        ]
        self.stats = ServeStats()
        # assembled-flat memo: assembling the full space from replica
        # tails is O(space); every frontend missing on the same round
        # reuses one assembly
        self._assembled: tuple[int, torch.Tensor] | None = None
        # let the fabric invalidate caches on restore (a rewound round
        # counter must not leave forward-dated cache entries behind).
        # Registered as a weakref: a dropped plane must not be pinned —
        # its frontend caches hold full O(model) flat arrays — and the
        # fabric prunes dead entries as it notifies.
        fabric = getattr(source, "fabric", None)
        if fabric is not None and hasattr(fabric, "read_planes"):
            fabric.read_planes.append(weakref.ref(self))

    # -- refresh plumbing ------------------------------------------------
    @property
    def current_version(self) -> int:
        """The newest round known to exist upstream.  For a fabric source
        this is also the newest *servable* round; a snapshot source may
        lag behind it (``SnapshotSource.advance``), in which case reported
        staleness includes the store's own lag while the enforced bound is
        measured against what the store can actually serve."""
        return getattr(self.source, "upstream_version", self.source.version)

    def _scale(self) -> float:
        """Fair-share inflation of this plane's refresh streams: the
        tenancy clock's serve share when attached to a shared box, the
        bandwidth-cap floor always."""
        scale = 1.0
        if self.shared is not None:
            scale = self.shared.serve_scale(self)
        if self.bandwidth_cap is not None:
            scale = max(scale, 1.0 / self.bandwidth_cap)
        return scale

    def _flat_now(self) -> torch.Tensor:
        version = self.source.version
        if self._assembled is None or self._assembled[0] != version:
            self._assembled = (version, self.source.assemble())
        return self._assembled[1]

    def _refresh(self, fe: _Frontend) -> float:
        """Pull the current version into ``fe``'s cache; returns the
        event-clock cost (fair-share inflated) and books every stream on
        the shared per-link queues."""
        streams = self.source.streams(fe.rack)
        chunk_elems = getattr(self.source, "space", None)
        elems = (chunk_elems.chunk_elems if chunk_elems is not None
                 else getattr(self.source, "chunk_elems", 8192))
        wire = getattr(self.source, "wire_us_per_chunk", 1.0)
        scale = self._scale()
        total_us = 0.0
        for st in streams:
            nbytes = 4 * st.num_chunks * elems
            demand = st.num_chunks * wire * self.source.hop_cost(
                st.src_rack, fe.rack)
            total_us += demand * scale
            self.stats.bytes_refreshed += nbytes
            if st.src_rack == fe.rack:
                self.stats.bytes_rack_link += nbytes
            else:
                self.stats.bytes_core_link += nbytes
            key = f"{st.kind}_streams"
            setattr(self.stats, key, getattr(self.stats, key) + 1)
            if self.shared is not None:
                link = (f"rack{st.src_rack}" if st.src_rack == fe.rack
                        else "core")
                queue = self.shared.links.get(link)
                if queue is not None:
                    queue.reserve(self.name, demand, scale)
        fe.version = self.source.version
        fe.flat = self._flat_now()
        self.stats.refreshes += 1
        return total_us

    # -- serving API -----------------------------------------------------
    def read(self, frontend: int = 0) -> ReadResult:
        """Serve one read from ``frontend``'s cache (refreshing it first
        when the cached version breaks the staleness bound)."""
        return self.read_batch(frontend, 1)[0]

    def read_batch(self, frontend: int, n: int) -> list[ReadResult]:
        """Serve ``n`` requests in one batch: at most one replica refresh,
        amortized over the batch; every member is stamped with the same
        version (a batch is one consistent snapshot)."""
        if not 0 <= frontend < len(self.frontends):
            raise ValueError(f"no frontend {frontend}")
        if n < 1:
            raise ValueError("batch size must be >= 1")
        fe = self.frontends[frontend]
        servable = self.source.version
        # invalidation rule: the cache serves iff its round version is
        # within the staleness bound of the newest servable round (a
        # forward-dated entry — impossible outside a restore that forgot
        # invalidate() — also refreshes)
        hit = (fe.version is not None
               and 0 <= servable - fe.version <= self.max_staleness)
        sim_us = 0.0 if hit else self._refresh(fe)
        sim_us += n * self.serve_us_per_read
        bound_staleness = servable - int(fe.version)
        staleness = self.current_version - int(fe.version)
        flat = fe.flat
        self.stats.batches += 1
        self.stats.reads += n
        self.stats.cache_hits += n if hit else 0
        self.stats.cache_misses += 0 if hit else n
        self.stats.bytes_served += n * flat.numel() * 4
        self.stats.max_staleness_served = max(
            self.stats.max_staleness_served, bound_staleness)
        self.stats.sim_serve_us += sim_us
        if not 0 <= bound_staleness <= self.max_staleness:
            raise RuntimeError(
                f"read served {bound_staleness} rounds stale with "
                f"max_staleness={self.max_staleness} — refresh logic broke "
                "its own bound"
            )
        return [
            ReadResult(int(fe.version), flat, staleness, hit, frontend,
                       sim_us if i == 0 else 0.0)
            for i in range(n)
        ]

    def move_frontend(self, frontend: int, rack: int) -> None:
        """Re-home one frontend onto ``rack`` — the plan delta's serving
        lever.  Timing-only by construction: the cache and its version
        stamp stay (the bits are rack-independent); only future refresh
        streams are priced from the new rack."""
        if not 0 <= frontend < len(self.frontends):
            raise ValueError(f"no frontend {frontend}")
        racks = max(1, self.source.num_racks)
        if not 0 <= rack < racks:
            raise ValueError(f"no rack {rack} (topology has {racks})")
        fe = self.frontends[frontend]
        if fe.rack == rack:
            return
        fe.rack = rack
        self.stats.frontend_moves += 1

    def invalidate(self) -> None:
        """Drop every frontend cache and the assembly memo.  The fabric
        calls this from ``restore`` (the round counter may rewind, and a
        cache stamped with a round from the abandoned timeline must never
        serve again)."""
        for fe in self.frontends:
            fe.version = None
            fe.flat = None
        self._assembled = None

    def notify_round(self, rounds: int = 1) -> None:
        """Upstream training advanced without new bits landing here — only
        meaningful for snapshot-backed planes (``SnapshotSource.advance``);
        fabric-backed planes read the live round counter directly."""
        adv = getattr(self.source, "advance", None)
        if adv is not None:
            adv(rounds)

    def describe(self) -> str:
        s = self.stats
        racks = ",".join(str(fe.rack) for fe in self.frontends)
        return (
            f"ReadPlane[{self.name}]: {len(self.frontends)} frontends "
            f"(racks {racks}), bound {self.max_staleness} rounds, "
            f"{s.reads} reads ({s.hit_rate:.0%} cache hit, "
            f"{s.refreshes} refreshes, max staleness "
            f"{s.max_staleness_served}), {s.bytes_refreshed >> 10} KiB "
            f"refreshed ({s.bytes_rack_link >> 10} rack / "
            f"{s.bytes_core_link >> 10} core KiB)"
        )


# ---------------------------------------------------------------------------
# the hierarchical (geo) read plane
# ---------------------------------------------------------------------------
class HierarchicalReadPlane:
    """Rack / cluster / cross-cluster serving over one source — the geo
    ladder from ``core/hierarchy.py`` activated as a read plane.

    One inner ``ReadPlane`` per ``ReadTier``, all backed by the same
    source (and the same assembled-flat memo discipline), each serving
    under its tier's staleness bound with its tier's refresh bandwidth
    cap.  The client sits *outside* the datacenter: the cross-cluster
    tier is client-local (latency floor 0) but caches the stalest bits,
    the rack tier is co-racked with the serving replicas (bound 0) but a
    WAN + core transit away.  ``route`` picks the nearest tier whose
    bound satisfies a request's staleness requirement, so staleness
    tolerance buys latency — and every tier's reads stay bit-identical
    to ``fabric.params`` at their stamped version (each tier is a plain
    ``ReadPlane``; the ladder never touches bits).

    The aggregate surface (``frontends``, ``move_frontend``, ``stats``,
    ``invalidate``) matches ``ReadPlane`` so the autoscaler and
    placement deltas drive it unchanged; frontends are indexed globally
    in tier order (rack tier first)."""

    def __init__(
        self,
        source: Any,
        *,
        config: ServeConfig,
        shared: Any | None = None,
        plan: Any = None,
    ):
        config.validate()
        if not config.hierarchy.enabled:
            raise ValueError(
                "HierarchicalReadPlane needs config.hierarchy.enabled; "
                "use ReadPlane for a flat plane")
        if not hasattr(source, "assemble"):
            source = FabricSource(source)
        self.config = config
        self.source = source
        self.name = config.name
        self.priority = config.priority
        self.bandwidth_cap = config.bandwidth_cap
        self.serve_us_per_read = config.serve_us_per_read
        # the loosest bound any tier serves under (the plane-level
        # ceiling, for describe/telemetry symmetry with ReadPlane)
        self.max_staleness = config.hierarchy.staleness_ladder[-1]
        topo = getattr(getattr(source, "fabric", None), "topology", None)
        wire = getattr(source, "wire_us_per_chunk", 1.0)
        self.tiers = tier_ladder(config.hierarchy, topology=topo,
                                 wire_us_per_chunk=wire)
        # door-level SLO accounting (admission/shed/goodput/latency):
        # a FrontDoor over this plane writes here, and the ``stats``
        # merge folds it in so telemetry sees one surface
        self.slo_stats = ServeStats()
        self.planes: list[ReadPlane] = []
        self._offsets: list[int] = []
        off = 0
        for tier in self.tiers:
            sub = dataclasses.replace(
                config,
                num_frontends=tier.num_frontends,
                max_staleness=tier.max_staleness,
                bandwidth_cap=tier.refresh_cap,
                slos=(),
                admission=dataclasses.replace(config.admission,
                                              enabled=False),
                hierarchy=dataclasses.replace(config.hierarchy,
                                              enabled=False),
            )
            p = ReadPlane(source, config=sub, shared=shared, plan=plan)
            p.parent = self  # tenancy serve_scale accepts tier planes
            self.planes.append(p)
            self._offsets.append(off)
            off += tier.num_frontends

    # -- shared-box wiring (tenancy attach/detach set this) --------------
    @property
    def shared(self) -> Any | None:
        return self.planes[0].shared

    @shared.setter
    def shared(self, box: Any | None) -> None:
        for p in self.planes:
            p.shared = box

    # -- routing ---------------------------------------------------------
    @property
    def current_version(self) -> int:
        return self.planes[0].current_version

    def route(self, staleness_req: int) -> int:
        """The tier index serving a read with this staleness requirement:
        nearest (lowest client latency floor) among the tiers whose bound
        satisfies it."""
        return select_tier(self.tiers, staleness_req)

    def frontend_range(self, tier: int) -> tuple[int, int]:
        """Global frontend index range ``[lo, hi)`` of one tier."""
        lo = self._offsets[tier]
        return lo, lo + self.tiers[tier].num_frontends

    def _locate(self, frontend: int) -> tuple[ReadPlane, int]:
        if not 0 <= frontend < sum(t.num_frontends for t in self.tiers):
            raise ValueError(f"no frontend {frontend}")
        for tier in reversed(range(len(self.tiers))):
            if frontend >= self._offsets[tier]:
                return self.planes[tier], frontend - self._offsets[tier]
        raise AssertionError("unreachable")

    # -- serving API (ReadPlane-shaped) ----------------------------------
    def read(self, frontend: int = 0) -> ReadResult:
        return self.read_batch(frontend, 1)[0]

    def read_batch(self, frontend: int, n: int) -> list[ReadResult]:
        """Serve a batch from one (globally indexed) frontend under its
        own tier's staleness bound.  ``sim_us`` is frontend service time
        only; the client additionally pays the tier's latency floor in
        transit (``tiers[i].latency_floor_us``) — the ``FrontDoor`` adds
        it to the client-observed latency without serializing it into
        frontend occupancy."""
        plane, local = self._locate(frontend)
        return plane.read_batch(local, n)

    @property
    def frontends(self) -> list[_Frontend]:
        """Every tier's frontends, concatenated in tier order (the
        placement/autoscaler surface)."""
        return [fe for p in self.planes for fe in p.frontends]

    def move_frontend(self, frontend: int, rack: int) -> None:
        plane, local = self._locate(frontend)
        plane.move_frontend(local, rack)

    def invalidate(self) -> None:
        for p in self.planes:
            p.invalidate()

    def notify_round(self, rounds: int = 1) -> None:
        self.planes[0].notify_round(rounds)

    @property
    def stats(self) -> ServeStats:
        """A merged snapshot: every tier plane's wire accounting plus the
        door-level SLO counters (``slo_stats``) — the telemetry surface."""
        out = ServeStats()
        for s in [p.stats for p in self.planes] + [self.slo_stats]:
            for f in dataclasses.fields(ServeStats):
                if f.name == "latency":
                    out.latency.merge(s.latency)
                elif f.name == "max_staleness_served":
                    out.max_staleness_served = max(
                        out.max_staleness_served, s.max_staleness_served)
                else:
                    setattr(out, f.name,
                            getattr(out, f.name) + getattr(s, f.name))
        return out

    def tier_stats(self, tier: int) -> ServeStats:
        return self.planes[tier].stats

    def describe(self) -> str:
        lines = [f"HierarchicalReadPlane[{self.name}]: "
                 f"{len(self.tiers)} tiers"]
        for t, p in zip(self.tiers, self.planes):
            lines.append(
                f"  {t.name}: floor {t.latency_floor_us:g}us, bound "
                f"{t.max_staleness} rounds"
                + (f", refresh cap {t.refresh_cap:g}"
                   if t.refresh_cap is not None else "")
                + f" — {p.describe()}")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# SLO front door: admission control + shedding + goodput accounting
# ---------------------------------------------------------------------------
class TokenBucket:
    """Deterministic token-bucket rate limiter on the event clock.

    Refills continuously at ``rate_per_us`` up to ``burst``; ``admit``
    spends one token (when available) at the given event-clock time.
    Time only moves forward — out-of-order probes see the bucket as of
    the latest time observed."""

    def __init__(self, rate_per_us: float, burst: float):
        if rate_per_us <= 0.0:
            raise ValueError("rate_per_us must be > 0")
        if burst < 1:
            raise ValueError("burst must be >= 1")
        self.rate_per_us = float(rate_per_us)
        self.capacity = float(burst)
        self.tokens = float(burst)
        self._t = 0.0

    def admit(self, now_us: float, cost: float = 1.0) -> bool:
        if now_us > self._t:
            self.tokens = min(self.capacity,
                              self.tokens + (now_us - self._t)
                              * self.rate_per_us)
            self._t = now_us
        if self.tokens >= cost:
            self.tokens -= cost
            return True
        return False


@dataclasses.dataclass(frozen=True)
class ServedRequest:
    """One front-door outcome: the request's fate, timing and (when
    served) the read it got.  ``finish_us`` for a shed request is its
    arrival time — the client learns immediately and can think/retry."""

    tenant: str
    arrival_us: float
    admitted: bool
    shed: str | None  # None | "rate_limit" | "overload"
    tier: int  # 0 for a flat plane
    frontend: int
    finish_us: float
    latency_us: float  # queue wait + service + tier latency floor
    slo_met: bool
    result: ReadResult | None


class FrontDoor:
    """The SLO front door over a read plane (flat or hierarchical).

    Sits where production requests arrive and makes the three decisions
    the plane itself never does:

      1. **Admission** — each tenant class has a token bucket
         (``AdmissionConfig.rate_per_us`` / ``burst``); an arrival with
         no token is shed at the door (``shed_rate_limit``).
      2. **Overload shedding, priority-aware** — an admitted arrival
         still sheds when its frontend's queued backlog would hold it
         past ``shed_slack x latency_budget x (priority / max
         priority)``: at equal budgets a lower-priority tenant hits its
         threshold strictly earlier, so overload sheds the low-priority
         classes first and the plane *sheds rather than serves late* —
         admitted work stays inside budget.
      3. **Routing** — a hierarchical plane's requests go to the nearest
         tier satisfying their staleness requirement, then to the
         least-loaded frontend of that tier (ties to the lowest index —
         deterministic).

    Accounting lands in ``self.stats`` (a ``ServeStats``): streaming
    p50/p99/p99.9 client latency, admitted/shed counters, and
    goodput-under-SLO.  Client latency = queue wait + frontend service +
    the tier's latency floor; the floor is transit, so it never
    serializes into frontend occupancy.  Everything here is timing and
    bookkeeping only — the bits a request gets remain whatever the plane
    serves, bit-identical to the fabric at the stamped version."""

    def __init__(self, plane: Any, *,
                 slos: Any = None, admission: AdmissionConfig | None = None):
        cfg = getattr(plane, "config", None)
        if slos is None:
            slos = cfg.slos if cfg is not None else ()
        if admission is None:
            admission = (cfg.admission if cfg is not None
                         else AdmissionConfig())
        self.plane = plane
        self.slos: dict[str, SLOConfig] = dict(slos)
        self.admission = admission
        self._default_slo = SLOConfig()
        self._max_priority = max(
            (s.priority for s in self.slos.values()), default=1.0)
        self.buckets: dict[str, TokenBucket] = {}
        self.free_at = [0.0] * len(plane.frontends)
        # SLO counters land where telemetry reads them: the hierarchical
        # plane's persistent ``slo_stats``, a flat plane's own stats
        sink = getattr(plane, "slo_stats", None)
        if sink is None:
            sink = getattr(plane, "stats", None)
        self.stats = sink if isinstance(sink, ServeStats) else ServeStats()

    def slo_of(self, tenant: str) -> SLOConfig:
        return self.slos.get(tenant, self._default_slo)

    def _bucket(self, tenant: str) -> TokenBucket:
        b = self.buckets.get(tenant)
        if b is None:
            b = self.buckets[tenant] = TokenBucket(
                self.admission.rate_per_us, self.admission.burst)
        return b

    def _shed_threshold_us(self, slo: SLOConfig) -> float:
        """The queue wait beyond which this tenant sheds instead of
        serving late.  Scaled by priority relative to the box's highest:
        under one shared backlog the low-priority classes cross their
        thresholds first."""
        if math.isinf(slo.latency_budget_us):
            return math.inf
        return (self.admission.shed_slack * slo.latency_budget_us
                * (slo.priority / self._max_priority))

    def submit(self, request: Any) -> ServedRequest:
        """Admit/shed/serve one workload ``Request`` (anything with
        ``arrival_us``/``tenant``/``n``/``staleness_req``).  Arrivals
        must be submitted in event-clock order — the driver (``run``)
        guarantees it."""
        now = float(request.arrival_us)
        tenant = request.tenant
        slo = self.slo_of(tenant)
        if self.admission.enabled and not self._bucket(tenant).admit(now):
            self.stats.shed_rate_limit += 1
            return ServedRequest(tenant, now, False, "rate_limit", 0, -1,
                                 now, 0.0, False, None)
        if hasattr(self.plane, "route"):
            tier = self.plane.route(request.staleness_req)
            lo, hi = self.plane.frontend_range(tier)
            floor = self.plane.tiers[tier].latency_floor_us
        else:
            tier, (lo, hi), floor = 0, (0, len(self.plane.frontends)), 0.0
        f = min(range(lo, hi), key=lambda i: (self.free_at[i], i))
        wait = max(0.0, self.free_at[f] - now)
        if (self.admission.enabled
                and wait + floor > self._shed_threshold_us(slo)):
            self.stats.shed_overload += 1
            return ServedRequest(tenant, now, False, "overload", tier, f,
                                 now, 0.0, False, None)
        self.stats.admitted += 1
        results = self.plane.read_batch(f, request.n)
        service = results[0].sim_us  # the batch's cost rides its head
        start = max(now, self.free_at[f])
        finish = start + service
        self.free_at[f] = finish
        latency = (finish - now) + floor
        self.stats.latency.record(latency)
        met = latency <= slo.latency_budget_us
        if tenant in self.slos:
            met = met and results[0].staleness <= slo.staleness_bound
        if met:
            self.stats.slo_met += 1
        else:
            self.stats.slo_violations += 1
        return ServedRequest(tenant, now, True, None, tier, f, finish,
                             latency, met, results[0])

    def run(self, trace: Any, on_time: Any = None) -> list[ServedRequest]:
        """Drive a ``WorkloadTrace`` to completion: open-loop arrivals
        fire at their recorded times, closed-loop clients issue, wait for
        completion (or shed), think, and issue again.  ``on_time(t)``,
        when given, is called with each arrival's event-clock time before
        it is submitted — the hook the benches use to fire training
        rounds on the same clock.  Fully deterministic — same trace, same
        plane, same outcomes, so a replayed trace yields bit-identical
        stats."""
        outcomes: list[ServedRequest] = []
        clients = [c for tenant in sorted(trace.think)
                   for c in trace.clients(tenant)]
        reqs = trace.requests
        i = 0
        while True:
            t_open = reqs[i].arrival_us if i < len(reqs) else math.inf
            t_closed, j = min(
                ((c.next_at, k) for k, c in enumerate(clients)
                 if not c.done),
                default=(math.inf, -1))
            if math.isinf(t_open) and math.isinf(t_closed):
                return outcomes
            if on_time is not None:
                on_time(min(t_open, t_closed))
            if t_open <= t_closed:  # ties: open-loop arrivals first
                outcomes.append(self.submit(reqs[i]))
                i += 1
            else:
                c = clients[j]
                out = self.submit(c.issue())
                c.completed(out.finish_us)
                outcomes.append(out)

    def describe(self) -> str:
        s = self.stats
        lat = s.latency
        return (
            f"FrontDoor[{self.plane.name}]: {s.offered} offered, "
            f"{s.admitted} admitted, {s.shed_rate_limit}+{s.shed_overload} "
            f"shed (rate/overload), goodput {s.goodput:.1%}, "
            f"p50/p99/p99.9 {lat.p50:.2f}/{lat.p99:.2f}/{lat.p999:.2f}us"
        )


# ---------------------------------------------------------------------------
# sparse row serving (hot-row caches over core/sparse.SparseTier)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class SparseServeStats:
    """Hot-row cache accounting: the row-granular twin of ServeStats."""

    row_reads: int = 0  # rows served (batch members individually)
    batches: int = 0  # read_rows calls
    row_hits: int = 0  # rows served from a frontend's hot cache
    row_misses: int = 0  # rows that forced a replica fetch
    stale_rows: int = 0  # misses caused by a version bump (vs. cold/evicted)
    evictions: int = 0  # LRU capacity evictions
    bytes_refreshed: int = 0  # replica -> frontend (raw f32 rows + ids)
    bytes_rack_link: int = 0
    bytes_core_link: int = 0
    bytes_served: int = 0  # frontend -> client
    frontend_moves: int = 0  # plan-driven frontend re-placements
    sim_serve_us: float = 0.0  # cumulative event-clock service time

    @property
    def hit_rate(self) -> float:
        if self.row_reads == 0:
            return 0.0
        return self.row_hits / self.row_reads


@dataclasses.dataclass(frozen=True)
class SparseReadResult:
    """One served row batch: rows stacked in request order, each stamped
    with the version (tier round) its bits belong to."""

    rows: torch.Tensor  # (n, D) f32
    versions: np.ndarray  # (n,) int64 — per-row stamped version
    hits: np.ndarray  # (n,) bool — served from the hot cache
    frontend: int
    sim_us: float


def zipfian_trace(num_rows: int, n: int, skew: float, seed: int = 0,
                  ) -> np.ndarray:
    """A power-law row-access trace: ``n`` draws over ``[0, num_rows)``
    with P(rank r) ∝ 1/r^skew (``skew=0`` is uniform) — the canonical
    recsys hot-key distribution the hot-row caches exist for.  Bounded
    and seeded (unlike ``numpy``'s unbounded ``zipf`` sampler), so traces
    are deterministic across runs and platforms."""
    if num_rows < 1 or n < 0:
        raise ValueError("num_rows must be >= 1 and n >= 0")
    if skew < 0:
        raise ValueError("skew must be >= 0")
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, num_rows + 1, dtype=np.float64) ** skew
    p /= p.sum()
    return rng.choice(num_rows, size=n, p=p).astype(np.int64)


class _RowFrontend:
    """One sparse frontend: its rack and an LRU hot-row cache keyed
    ``(table, row id) -> (stamped version, row bits)``."""

    def __init__(self, fid: int, rack: int, capacity: int):
        self.fid = fid
        self.rack = rack
        self.capacity = capacity
        self.cache: collections.OrderedDict = collections.OrderedDict()


class SparseReadPlane:
    """Per-frontend hot-row caches over a ``core/sparse.SparseTier``.

    Serving semantics (the sparse twin of ReadPlane's, but *exact* rather
    than staleness-bounded — tests/test_sparse_tier.py):

      * **Exact version-keyed invalidation** — a cached row serves iff its
        stamped version equals the tier's live ``row_versions`` entry.
        A ``push`` round that updates row ``i`` bumps ``versions[i]``, so
        the next read of ``i`` misses and refetches; rows the round did
        not touch keep serving from cache.  Served bits are therefore
        *always* bit-identical to a direct ``tier.table(name)[i]`` read —
        the headline invariant.
      * **Replica routing** — misses refresh from the chain's cheapest
        backup rack (``SparseTier.serve_rack``), the home rack at R = 1;
        reads happen between rounds, when chain tails are byte-exact
        copies of the primaries, so routing never changes bits.
      * **LRU hot set** — each frontend caches at most ``cache_rows``
        rows; Zipfian traces (``zipfian_trace``) keep the hot head
        resident while the cold tail churns.
      * **Training isolation** — reads never write tier state; serving
        any trace leaves training bit-identical.

    Registered on the tier's ``read_planes`` (weakref) so a fabric
    ``restore`` — which may rewind the round counter — can drop caches
    stamped on the abandoned timeline (``SparseTier.on_restore``)."""

    def __init__(
        self,
        tier: Any,
        *,
        config: ServeConfig | None = None,
        plan: Any = None,
        **legacy: Any,
    ):
        if config is not None and legacy:
            raise TypeError(
                f"pass either config= or the legacy keyword spread, not "
                f"both (got config and {sorted(legacy)})")
        if config is None:
            if legacy:
                warn_legacy_call(constructor="SparseReadPlane",
                                 config="ServeConfig")
            config = ServeConfig.from_sparse_legacy_kwargs(**legacy)
        config.validate()
        self.config = config
        num_frontends = config.num_frontends
        cache_rows = config.cache_rows
        self.tier = tier
        self.name = config.name
        self.serve_us_per_read = float(config.serve_us_per_read)
        racks = max(1, tier.topology.num_racks if tier.topology is not None
                    else 1)
        # frontend placement mirrors ReadPlane: plan-backed when a plan is
        # attached (kwarg, else the tier's), f % racks otherwise/by default
        if plan is None:
            plan = getattr(tier, "plan", None)
        fe_racks = getattr(plan, "frontend_racks", ()) or ()
        self.frontends = [
            _RowFrontend(f, (int(fe_racks[f]) % racks if f < len(fe_racks)
                             else f % racks), cache_rows)
            for f in range(num_frontends)
        ]
        self.stats = SparseServeStats()
        tier.read_planes.append(weakref.ref(self))

    def move_frontend(self, frontend: int, rack: int) -> None:
        """Re-home one sparse frontend onto ``rack``.  Timing-only: the
        hot-row cache is exact-version keyed, so its entries stay valid;
        only future refetch streams are priced from the new rack."""
        if not 0 <= frontend < len(self.frontends):
            raise ValueError(f"no frontend {frontend}")
        racks = max(1, self.tier.topology.num_racks
                    if self.tier.topology is not None else 1)
        if not 0 <= rack < racks:
            raise ValueError(f"no rack {rack} (topology has {racks})")
        fe = self.frontends[frontend]
        if fe.rack == rack:
            return
        fe.rack = rack
        self.stats.frontend_moves += 1

    def read_rows(self, frontend: int, name: str, ids: Any,
                  ) -> SparseReadResult:
        """Serve a batch of row reads from ``frontend``'s hot cache,
        refetching rows whose cached version is stale (or missing) from
        the serving replica."""
        if not 0 <= frontend < len(self.frontends):
            raise ValueError(f"no frontend {frontend}")
        fe = self.frontends[frontend]
        tier = self.tier
        table = tier._table(name)
        ids_np = np.asarray(ids, dtype=np.int64).reshape(-1)
        if ids_np.size and (ids_np.min() < 0
                            or ids_np.max() >= table.num_rows):
            raise ValueError(
                f"row ids out of range for table {name!r} "
                f"({table.num_rows} rows)")
        live = table.versions
        out_rows = [None] * ids_np.size
        versions = np.empty(ids_np.size, dtype=np.int64)
        hits = np.zeros(ids_np.size, dtype=bool)
        miss_pos: list[int] = []
        for i, rid in enumerate(ids_np):
            key = (name, int(rid))
            entry = fe.cache.get(key)
            if entry is not None and entry[0] == live[rid]:
                fe.cache.move_to_end(key)
                out_rows[i] = entry[1]
                versions[i] = entry[0]
                hits[i] = True
            else:
                if entry is not None:
                    self.stats.stale_rows += 1
                miss_pos.append(i)
        sim_us = 0.0
        if miss_pos:
            miss_ids = ids_np[miss_pos]
            uniq = np.unique(miss_ids)
            fetched = table.rows(uniq)  # replica bits == primary bits
            per_row = 4 * table.dim + 4  # raw f32 row + int32 id
            owners = table.placement.owner[uniq]
            for s in np.unique(owners):
                nbytes = int(per_row * (owners == s).sum())
                src = tier.serve_rack(int(s), fe.rack)
                self.stats.bytes_refreshed += nbytes
                if src == fe.rack:
                    self.stats.bytes_rack_link += nbytes
                else:
                    self.stats.bytes_core_link += nbytes
                sim_us += tier._us(nbytes, src, fe.rack)
            lut = {int(r): j for j, r in enumerate(uniq)}
            for i in miss_pos:
                rid = int(ids_np[i])
                row = fetched[lut[rid]]
                ver = int(live[rid])
                out_rows[i] = row
                versions[i] = ver
                fe.cache[(name, rid)] = (ver, row)
                fe.cache.move_to_end((name, rid))
            while len(fe.cache) > fe.capacity:
                fe.cache.popitem(last=False)
                self.stats.evictions += 1
        sim_us += ids_np.size * self.serve_us_per_read
        self.stats.batches += 1
        self.stats.row_reads += ids_np.size
        self.stats.row_hits += int(hits.sum())
        self.stats.row_misses += len(miss_pos)
        self.stats.bytes_served += ids_np.size * 4 * table.dim
        self.stats.sim_serve_us += sim_us
        rows = (torch.stack(out_rows) if out_rows
                else torch.zeros((0, table.dim), dtype=torch.float32,
                                 device=tier.device))
        return SparseReadResult(rows, versions, hits, frontend, sim_us)

    def invalidate(self) -> None:
        """Drop every frontend's hot cache (fabric restore: the tier's
        round counter may rewind, and the same version number will hold
        different bits on the new timeline)."""
        for fe in self.frontends:
            fe.cache.clear()

    def describe(self) -> str:
        s = self.stats
        racks = ",".join(str(fe.rack) for fe in self.frontends)
        return (
            f"SparseReadPlane[{self.name}]: {len(self.frontends)} "
            f"frontends (racks {racks}), {s.row_reads} row reads "
            f"({s.hit_rate:.0%} hit, {s.stale_rows} version-stale, "
            f"{s.evictions} evictions), {s.bytes_refreshed >> 10} KiB "
            f"refreshed ({s.bytes_rack_link >> 10} rack / "
            f"{s.bytes_core_link >> 10} core KiB)"
        )
