"""Chunk-sharded PBox fabric: the paper's balanced multi-engine PS (torch
counterpart of ``repro/core/fabric.py``).

  ``PBoxShard``    one aggregation engine.  Owns a set of 32 KB key chunks
                   (a contiguous slab or a round-robin stripe), holds their
                   parameters and optimizer state on the fabric's device,
                   and runs the fused K-way aggregate+optimize kernel on
                   only its chunks.  Chunks move between shards with their
                   state (``release`` / ``adopt``).
  ``PBoxFabric``   routes per-chunk pushes and pulls to the owning shards
                   and admits pushes by mode: a barrier every step (sync),
                   a backup quorum that drops late gradients
                   (``min_push_fraction`` < 1), bounded staleness (SSP) or
                   every push applied at once (async).  It moves chunks off
                   slow shards (``rebalance``) and takes and restores
                   crash-consistent snapshots.
  ``WorkerHarness`` drives K logical workers against a fabric.

Numerics are identical to a single-engine server by construction: the
fused update is elementwise over the flat space and sums workers in a fixed
(ascending) order, so applying it shard by shard is bit-equal to applying
it once over the whole space.  The JAX package pads each shard's slab to
the TPU kernel's register block; the CUDA kernel masks its own tail, and
zero rows are a fixed point of every optimizer, so the port does not pad
and the numbers do not change.

The event clock (``_simulate_round``) is the JAX package's, line for line:
chunk ``c`` arrives at ``(c+1) * wire_us`` (scaled by the codec's bytes per
element), each shard aggregates its chunks in arrival order, and
``ServerStats`` records the pipelined makespan beside the
store-and-forward baseline.

The wire codec (``core/compression.py``: none, bf16 or int8 with error
feedback) runs on each worker's push to the PS.  Where
``wire_path_supported`` allows the codec x optimizer x chunk geometry (the
fused wire path) a push stays encoded up to the shards, and each shard
decodes, aggregates and applies it in one kernel (``kernels/wire_path``);
otherwise the push is decoded at the hop (``roundtrip``) and the shards
run ``fused_agg_opt`` on f32 rows.  Both routes give the same bits; the
JAX package's ``fused_wire_path`` switch between them has no counterpart.

The kernels update a shard's parameters and state in place on the card,
so nothing the fabric hands out may alias them: ``snapshot`` copies to
host memory before it returns, ``restore`` copies into fresh tensors, and
``release`` returns copies.

Attach a ``NetworkTopology`` (``core/topology.py``) and each rack's
pushes cross the codec'd rack link to their ToR, are combined there, and
one stream per rack crosses the oversubscribed core link.  With codec
"none" the ToRs chain the running f32 prefix through the racks in
ascending worker order, and the shards fold it with zero rows standing in
for the absorbed streams, so rack-aggregated training is bit-identical to
the flat fabric.  Integer codecs combine per rack and re-encode at the
ToR.  With the switch tier (``SwitchConfig``) and the int8 codec, a ToR
pool may sum the rack's int8 payloads under one shared scale, and a core
pool the racks' streams; a pool that is failed (a ``FaultPlan``'s
``switch_fail``) or too small takes the software path, bit-identical to a
fabric with no switch.  The event clock adds the core link as a second
pipeline stage.

Every fabric runs under a ``PlacementPlan`` (``core/placement.py``): the
default plan unless the config names one.  It places each shard's
replication chain on racks and may pin chunk ownership.

Fault tolerance (``core/replication.py``): ``replication=R`` chain-
replicates every shard's slab (params and optimizer state, raw f32) to
R - 1 backups after each round, anti-affine to racks, and a ``FaultPlan``
injects shard, worker, link and switch faults at round edges.  A shard
crash with R >= 2 promotes the chain head bit-exactly and re-silvers the
chain; with R = 1 it raises ``ShardLost``.  Worker crashes shrink the
admission barrier to the survivors, who re-enter through
``runtime/elastic.worker_reentry``; a degraded rack link slows the event
clock.  The chain is a real device copy (the kernels write the primary in
place), ``copy_``d into buffers each group keeps between rounds, and
replication and recovery bytes land on the same rack and core accounting
as training traffic.  ``reshard`` changes the shard count in place at a
round edge, one state slot at a time; ``replace_chain_racks`` re-homes a
chain.

Tenancy (``core/tenancy.py``): a ``MultiJobFabric`` builds one fabric per
tenant job over its shared shard set.  ``namespace`` / ``chunk_base`` place
the job's chunks in the box-wide namespace (``global_chunk_ids``), and a
``shared_clock`` inflates the job's wire stages by the box's fair share
and books each round on the box's link queues.  Both touch only routing
metadata and the event clock: the bits are those of a dedicated fabric.

A sparse tier (``core/sparse.SparseTier(fabric=...)``) attaches to a
fabric: it inherits the shard and worker counts, topology, replication,
plan, link model, chunk size and device, registers in ``sparse_tiers``,
and fails over and reshards with the fabric's engines.  Read planes
(``core/serving.py``) register in ``read_planes``; ``restore`` invalidates
their caches and the sparse tiers' serving caches.

The round's layers are ``repro_torch.tracing`` spans: ``ps.pull``,
``ps.push`` (and its ``ps.encode``), ``ps.aggregate``, each shard's
``ps.shard_apply`` and ``WorkerHarness``'s ``ps.worker_grad``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import numpy as np
import torch

from repro_torch.core.chunking import ParamSpace
from repro_torch.core.compression import (
    CompressionConfig,
    WirePayload,
    encode_wire,
    init_ef_state,
    roundtrip,
    wire_bytes,
)
from repro_torch.core.config import FabricConfig, warn_legacy_call
from repro_torch.core.placement import (
    PlacementPlan,
    PlanDelta,
    chunk_rebalance_delta,
)
from repro_torch.core.replication import FaultPlan, ReplicaGroup, ShardLost
from repro_torch.core.topology import (
    NetworkTopology,
    RackAggregator,
    SwitchCompute,
    group_scale,
    integer_quantize,
    quant_residual,
    scale_chunks,
)
from repro_torch.device import resolve_device
from repro_torch.kernels.fused_agg_opt.ops import fused_aggregate_update
from repro_torch.kernels.wire_path.ops import (
    fused_wire_update,
    wire_path_supported,
)
from repro_torch.optim.optimizers import OptimizerSpec, init_opt_state
from repro_torch.tracing import span

_PULL_BYTES = 4  # pulls cross as raw f32 whatever the push codec


# ---------------------------------------------------------------------------
# stats
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class ServerStats:
    """Fabric-wide accounting: the JAX package's fields, all of them, so the
    two fabrics' stats compare field by field.  Counters of tiers the port
    does not run yet stay 0."""

    steps: int = 0
    pushes: int = 0
    pulls: int = 0
    bytes_pushed: int = 0
    bytes_pulled: int = 0
    partial_aggregations: int = 0
    late_pushes_dropped: int = 0
    # chunk-granular accounting
    chunk_pushes: int = 0
    chunk_pulls: int = 0
    rebalances: int = 0
    chunks_moved: int = 0
    # placement / autoscaling tier
    rescales: int = 0
    replica_moves: int = 0
    # topology-tier wire accounting
    bytes_rack_link: int = 0
    bytes_core_link: int = 0
    rack_streams: int = 0
    # fused wire path
    fused_wire_rounds: int = 0
    # in-network switch tier
    switch_rounds: int = 0
    switch_fallback_rounds: int = 0
    core_switch_rounds: int = 0
    bytes_switch_agg: int = 0
    bytes_switch_saved: int = 0
    switch_failures: int = 0
    switch_restores: int = 0
    # event-ordered simulator clock (µs of simulated time, cumulative)
    sim_wire_us: float = 0.0
    sim_core_wire_us: float = 0.0
    sim_agg_us: float = 0.0
    sim_pipelined_us: float = 0.0  # chunk-pipelined, sharded makespan
    sim_serialized_us: float = 0.0  # monolithic store-and-forward baseline
    # fault-tolerance tier
    shards_crashed: int = 0
    failovers: int = 0
    resilvers: int = 0
    workers_crashed: int = 0
    workers_recovered: int = 0
    link_degrades: int = 0
    replication_rounds: int = 0
    bytes_replication: int = 0
    bytes_resilver: int = 0
    sim_replication_us: float = 0.0
    sim_recovery_us: float = 0.0

    @property
    def pipeline_speedup(self) -> float:
        """Simulated speedup of chunk-pipelined sharded aggregation over the
        monolithic push-everything-then-aggregate baseline."""
        if self.sim_pipelined_us <= 0.0:
            return 1.0
        return self.sim_serialized_us / self.sim_pipelined_us


@dataclasses.dataclass
class ShardStats:
    chunk_pushes: int = 0
    chunk_pulls: int = 0
    bytes_pushed: int = 0
    bytes_pulled: int = 0
    agg_events: int = 0
    sim_busy_us: float = 0.0


@dataclasses.dataclass(frozen=True)
class LinkModel:
    """Event-clock costs for the pipelined push/aggregate/pull simulation:
    chunk ``c`` (all workers' copies) lands at ``(c+1) *
    wire_us_per_chunk``; a shard spends ``agg_us_per_chunk`` of engine time
    per chunk."""

    wire_us_per_chunk: float = 1.0
    agg_us_per_chunk: float = 0.5


# ---------------------------------------------------------------------------
# shard
# ---------------------------------------------------------------------------
def _row_index(ids: np.ndarray, device: torch.device) -> slice | torch.Tensor:
    """Index of a shard's rows in the (num_chunks, chunk_elems) space: a
    slice (a view, no copy) for a contiguous run of chunks, else an index
    tensor on ``device``."""
    if len(ids) and np.array_equal(ids, np.arange(ids[0], ids[0] + len(ids))):
        return slice(int(ids[0]), int(ids[0]) + len(ids))
    return torch.as_tensor(ids, dtype=torch.long, device=device)


class PBoxShard:
    """One aggregation engine: owns chunks, runs the fused kernel on them."""

    def __init__(
        self,
        shard_id: int,
        space: ParamSpace,
        spec: OptimizerSpec,
        chunk_ids: np.ndarray,
        chunk_params: torch.Tensor,  # (n_owned, chunk_elems)
    ):
        self.shard_id = shard_id
        self.space = space
        self.spec = spec
        self.chunk_ids = np.asarray(chunk_ids, dtype=np.int64)
        self.rows = _row_index(self.chunk_ids, chunk_params.device)
        # a private f32 copy: the kernel updates it in place
        self.params = chunk_params.to(torch.float32, copy=True)
        self.state = init_opt_state(spec, self.params)
        self.stats = ShardStats()

    @classmethod
    def from_state(cls, shard_id: int, space: ParamSpace,
                   spec: OptimizerSpec, chunk_ids: np.ndarray,
                   params: torch.Tensor, state: tuple) -> "PBoxShard":
        """A shard over rows it already owns: ``params`` and ``state`` are
        taken as they are, not copied (a failover's promoted chain copy, a
        reshard's regathered rows).  At full width a copy would cost a
        second slab set at the moment of the swap."""
        shard = cls.__new__(cls)
        shard.shard_id = shard_id
        shard.space = space
        shard.spec = spec
        shard.chunk_ids = np.asarray(chunk_ids, dtype=np.int64)
        shard.rows = _row_index(shard.chunk_ids, params.device)
        shard.params = params
        shard.state = tuple(state)
        shard.stats = ShardStats()
        return shard

    @property
    def num_chunks(self) -> int:
        return len(self.chunk_ids)

    @property
    def num_elems(self) -> int:
        return self.num_chunks * self.space.chunk_elems

    @span("ps.shard_apply")
    def apply(self, pushes: list, step: int, *, average: bool) -> None:
        """pushes: the K workers' whole (num_chunks, chunk_elems) gradient
        slabs in ascending worker order, ``None`` for a zero row.  The
        kernel reads this shard's chunks of each where they lie: a view of
        the rows for a contiguous run of chunks, else through the chunk-id
        table; nothing is stacked."""
        if self.num_chunks == 0:
            return
        n = self.num_elems
        table = isinstance(self.rows, torch.Tensor)
        new_p, new_s = fused_aggregate_update(
            [None if g is None else g.contiguous() if table
             else g.contiguous()[self.rows] for g in pushes],
            self.params.reshape(n),
            tuple(s.reshape(n) for s in self.state),
            self.spec,
            step,
            average=average,
            chunk_ids=self.rows if table else None,
        )
        shape = (self.num_chunks, self.space.chunk_elems)
        self.params = new_p.reshape(shape)
        self.state = tuple(s.reshape(shape) for s in new_s)
        self.stats.agg_events += 1

    @span("ps.shard_apply")
    def apply_wire(
        self,
        payload: torch.Tensor,  # (K, n_owned, chunk_elems) wire dtype
        scales: torch.Tensor | None,  # (K, n_owned) f32 (int8), else None
        codec: str,
        step: int,
        *,
        average: bool,
    ) -> None:
        """``apply``, wire-form: the K streams arrive still encoded and the
        single-pass kernel (``kernels/wire_path``) decodes, folds and
        applies the optimizer without materializing decoded f32 gradients;
        bit-identical to decode-then-``apply``."""
        if self.num_chunks == 0:
            return
        k = payload.shape[0]
        n = self.num_elems
        new_p, new_s = fused_wire_update(
            payload.reshape(k, n),
            None if scales is None else scales.reshape(k, self.num_chunks),
            self.params.reshape(n),
            tuple(s.reshape(n) for s in self.state),
            self.spec,
            step,
            codec=codec,
            chunk_elems=self.space.chunk_elems,
            average=average,
        )
        shape = (self.num_chunks, self.space.chunk_elems)
        self.params = new_p.reshape(shape)
        self.state = tuple(s.reshape(shape) for s in new_s)
        self.stats.agg_events += 1

    # -- chunk migration (rebalancing) ---------------------------------
    def release(self, chunk_ids: np.ndarray) -> tuple[torch.Tensor, tuple]:
        """Give up ownership of ``chunk_ids``; returns copies of their
        (params, state) rows in the order of ``chunk_ids``."""
        pos = np.searchsorted(self.chunk_ids, chunk_ids)
        if np.any(pos >= len(self.chunk_ids)) or not np.array_equal(
                self.chunk_ids[pos], chunk_ids):
            raise ValueError("releasing chunks this shard does not own")
        dev = self.params.device
        # indexing with a tensor copies: the rows handed out never alias
        # the slab the kernel writes in place
        pos_t = torch.as_tensor(pos, dtype=torch.long, device=dev)
        p_rows = self.params[pos_t]
        s_rows = tuple(s[pos_t] for s in self.state)
        keep = np.ones(self.num_chunks, dtype=bool)
        keep[pos] = False
        self.chunk_ids = self.chunk_ids[keep]
        keep_t = torch.as_tensor(np.flatnonzero(keep), dtype=torch.long,
                                 device=dev)
        self.params = self.params[keep_t]
        self.state = tuple(s[keep_t] for s in self.state)
        self.rows = _row_index(self.chunk_ids, dev)
        return p_rows, s_rows

    def adopt(self, chunk_ids: np.ndarray, p_rows: torch.Tensor,
              s_rows: tuple) -> None:
        """Take ownership of ``chunk_ids`` with their (params, state) rows;
        the merged ids stay sorted, as the event clock reads them."""
        dev = self.params.device
        merged = np.concatenate([self.chunk_ids,
                                 np.asarray(chunk_ids, np.int64)])
        order = np.argsort(merged, kind="stable")
        order_t = torch.as_tensor(order, dtype=torch.long, device=dev)
        self.chunk_ids = merged[order]
        self.params = torch.cat([self.params, p_rows])[order_t]
        self.state = tuple(torch.cat([s, r])[order_t]
                           for s, r in zip(self.state, s_rows))
        # a shard's chunks need not be one contiguous run after a move
        self.rows = _row_index(self.chunk_ids, dev)


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` as numpy: never a view of device or CPU state
    the kernels later write."""
    return t.detach().to("cpu", copy=True).numpy()


def _fresh_rows(host: np.ndarray, shard: PBoxShard,
                device: torch.device) -> torch.Tensor:
    """Shard ``shard``'s rows of the (num_chunks, chunk_elems) host array,
    as a fresh tensor on ``device`` (``torch.tensor`` always copies)."""
    rows = shard.rows
    part = host[rows] if isinstance(rows, slice) else host[shard.chunk_ids]
    return torch.tensor(part, dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# fabric
# ---------------------------------------------------------------------------
class PBoxFabric:
    """Chunk-sharded PS fabric over N aggregation engines.

    Synchronization modes (the JAX fabric's admission semantics):

      sync      barrier every step (BSP; the paper's setting)
      async     each completed push is applied at once, chunk-routed to
                the owning shards (Hogwild-PS): K = 1, no averaging
      stale(s)  bounded staleness: a worker may run at most ``s`` steps
                ahead of the slowest worker (SSP); s=0 == sync

    Workers push the whole flat gradient at once (``push``) or chunk group
    by chunk group (``push_chunks``); a push completes once every chunk of
    the flat space is staged.  When a round's pushes are in, each shard
    runs the fused aggregate+optimize kernel on them (ascending worker
    order), which reads the shard's chunks of each push where they lie.

    Every push carries the params version (fabric step) the worker last
    pulled.  In sync mode with a backup quorum (``min_pushes`` below the
    alive workers) the round fires once the quorum has pushed, and a push
    computed against a version that round superseded is dropped before
    the codec sees it (``ServerStats.late_pushes_dropped``).  SSP admits
    late pushes; a worker that pushes twice before the barrier replaces
    its own earlier push, as in the JAX package.

    With a ``NetworkTopology`` the pushes cross the rack tier (see the
    module docstring).  ToR combining exists only where rounds exist: in
    async mode every push crosses both tiers on its own (``rack_streams``
    stays 0).

    State lives on ``device``: the CUDA card unless the caller passes
    another (the tests pass ``"cpu"``); with no card and no device given,
    construction raises.

    ``config`` is the construction surface; the JAX package's legacy
    keywords are accepted instead of it (never beside it) through
    ``FabricConfig.from_legacy_kwargs``, with a ``DeprecationWarning`` once
    per call site.  ``shared_clock`` is the owning ``MultiJobFabric``, a
    runtime link rather than a config value.
    """

    def __init__(
        self,
        space: ParamSpace,
        spec: OptimizerSpec,
        init_flat: torch.Tensor,
        *,
        config: FabricConfig | None = None,
        device: torch.device | str | None = None,
        shared_clock: Any | None = None,
        **legacy: Any,
    ):
        if config is not None and legacy:
            raise TypeError(
                "pass config=FabricConfig(...) or legacy keywords, not "
                f"both (got legacy {sorted(legacy)})")
        if config is None:
            if legacy:
                warn_legacy_call()
            config = FabricConfig.from_legacy_kwargs(**legacy)
        # every cross-field rule fails HERE, before any state is built
        config.validate()
        self.config = config
        self.device = resolve_device(device)
        self.space = space
        self.spec = spec
        self.mode = config.mode
        self.staleness = (
            config.staleness if config.mode == "stale"
            else (0 if config.mode == "sync" else 1 << 30)
        )
        self.num_workers = config.num_workers
        self.num_shards = config.num_shards
        self.min_push_fraction = config.min_push_fraction
        self.link = config.wire.link or LinkModel()
        # tenancy hooks: the job's place in the box-wide chunk namespace
        # (global id = chunk_base + local id) and the box's shared event
        # clock; routing metadata and timing only, never bits
        self.namespace = config.namespace
        self.chunk_base = config.chunk_base
        self.shared_clock = shared_clock
        # codec chunks align with PS chunks so per-chunk scales ride the
        # same wire framing
        self.compression = dataclasses.replace(
            config.wire.compression or CompressionConfig(codec="none"),
            chunk_elems=space.chunk_elems,
        )
        # fused wire path: pushes stay encoded up to the shards where the
        # kernel supports the codec x optimizer x chunk geometry; otherwise
        # a codec'd push is decoded at the hop (codec "none" has nothing
        # to decode) and the shards apply f32 rows
        self._fused_wire = wire_path_supported(
            self.compression.codec, spec, space.chunk_elems)
        topology: NetworkTopology | None = config.wire.topology
        self.topology = topology
        # in-network switch tier: each ToR may own a bounded pool of
        # aggregation slots, and a core pool may combine the rack uplinks.
        # A pool takes a round iff it is alive and holds every chunk, so a
        # refusal is the bit-exact software combine; codec "none" and bf16
        # never engage (integer slot arithmetic over the int8 wire only)
        sw = config.wire.switch
        self.switch_cfg = sw
        self.rack_aggs: list[RackAggregator] = []
        if topology is not None:
            self.rack_aggs = [
                RackAggregator(
                    r, topology.members(r), self.compression,
                    space.flat_elems,
                    switch=(SwitchCompute(f"tor{r}", sw.tor_slots)
                            if sw.enabled else None),
                    device=self.device,
                )
                for r in range(topology.num_racks)
            ]
        self.core_switch = (
            SwitchCompute("core", sw.core_slots)
            if sw.enabled and sw.core_slots > 0 and topology is not None
            else None
        )
        self._core_ef = (init_ef_state(self.compression, space.flat_elems,
                                       device=self.device)
                         if self.core_switch is not None else None)
        self._switch_cursor = 0  # fault-plan rounds consumed mid-round
        self._deferred: set[int] = set()  # raw pushes parked for a pool
        self._round_switch_chunks = 0  # pool occupancy of the last round
        self.fault_plan: FaultPlan | None = config.faults.fault_plan
        # without a topology the codec runs on the worker -> PS wire, and
        # each worker's NIC keeps its error-feedback residual (with one,
        # the ToRs keep them)
        self._worker_ef: dict[int, torch.Tensor | None] = {
            w: init_ef_state(self.compression, space.flat_elems,
                             device=self.device)
            for w in range(self.num_workers)
        } if self.compression.codec != "none" and topology is None else {}
        # placement layer: every fabric runs under a plan; None means the
        # default plan (the anti-affine chain formula, chunk ownership by
        # ``placement_policy``), which keeps the caller's topology object
        # as it is.  An explicit plan is attached to the topology so its
        # placement queries read the plan.
        self.placement_policy = config.placement.policy
        replication = config.faults.replication
        plan = config.placement.plan
        explicit_plan = plan is not None
        n_racks = topology.num_racks if topology is not None else 1
        if plan is None:
            plan = PlacementPlan.default(self.num_shards, num_racks=n_racks,
                                         replication=replication)
        self._check_plan(plan, self.num_shards, n_racks, replication)
        self.plan = plan
        if topology is not None and explicit_plan:
            self.topology = topology.with_plan(plan)
        # fault tier: chain replication at factor R, the fault schedule
        # fired at round edges, and the crash bookkeeping routing reads
        self.replication = replication
        self.fault_trace: list[dict] = []
        self.dead_workers: set[int] = set()
        self._link_degrade: dict[int, float] = {}  # rack -> slowdown >= 1
        self._fault_cursor = 0  # last round whose faults already fired
        # read planes (core/serving.py) register here as weakrefs, so a
        # dropped plane's O(model) caches stay collectable, and restore()
        # invalidates the live ones.  Serving never writes fabric state.
        self.read_planes: list = []  # weakrefs to attached ReadPlanes
        self.sparse_tiers: list = []  # weakrefs to attached SparseTiers
        self.step = 0
        self.worker_clock = np.zeros(self.num_workers, dtype=np.int64)
        # params version (fabric step) each worker last pulled: what
        # sync-mode admission judges a push's freshness by
        self._pull_step = np.zeros(self.num_workers, dtype=np.int64)
        self._drops_since_step = 0  # guards against a silent all-stale halt
        self.stats = ServerStats()

        c = space.num_chunks
        rows = init_flat.to(self.device, torch.float32).reshape(
            c, space.chunk_elems)
        self.chunk_owner = np.empty(c, dtype=np.int64)
        self.shards: list[PBoxShard] = []
        for sid, ids in enumerate(self._partition(plan, self.num_shards)):
            self.chunk_owner[ids] = sid
            shard_rows = _row_index(ids, self.device)
            self.shards.append(
                PBoxShard(sid, space, spec, ids, rows[shard_rows])
            )
        # sync/stale inbox: worker -> (num_chunks, chunk_elems) f32
        # gradient rows, or the push still encoded on the fused wire path
        self._inbox: dict[int, torch.Tensor | WirePayload] = {}
        # chunk-by-chunk staging: worker -> (rows buffer, staged mask)
        self._staged: dict[int, tuple[torch.Tensor, np.ndarray]] = {}
        self._flat_cache: torch.Tensor | None = None
        # a device copy of init_flat, where one was made, is freed before
        # the chains allocate
        del rows
        # the chains: the initial provisioning copies ship with the model
        # broadcast, not on the training wire.  R = 1 builds none.
        self.replicas: list[ReplicaGroup] = self._build_chains(plan)

    @staticmethod
    def _check_plan(plan: PlacementPlan, num_shards: int, num_racks: int,
                    replication: int) -> None:
        if plan.num_shards != num_shards:
            raise ValueError(
                f"plan places {plan.num_shards} shards, fabric has "
                f"{num_shards}")
        if plan.num_racks != num_racks:
            raise ValueError(
                f"plan places {plan.num_racks} racks, topology has "
                f"{num_racks}")
        if plan.replica_racks.shape[1] < replication:
            raise ValueError(
                f"plan places {plan.replica_racks.shape[1]} chain copies, "
                f"fabric replicates at {replication}")

    def _partition(self, plan: PlacementPlan,
                   num_shards: int) -> list[np.ndarray]:
        """Each shard's chunk ids: the plan's explicit ``chunk_owner`` when
        it has one (the policy is then ignored), else round-robin (chunk c
        -> engine c % N, the paper's assignment: a streamed push feeds
        every engine) or contiguous slabs."""
        c = self.space.num_chunks
        if plan.chunk_owner is not None:
            if len(plan.chunk_owner) != c:
                raise ValueError(
                    f"plan places {len(plan.chunk_owner)} chunks, the "
                    f"space has {c}")
            return [np.flatnonzero(plan.chunk_owner == s)
                    for s in range(num_shards)]
        if self.placement_policy == "round_robin":
            return [np.arange(c)[np.arange(c) % num_shards == s]
                    for s in range(num_shards)]
        return np.array_split(np.arange(c), num_shards)

    def _build_chains(self, plan: PlacementPlan) -> list[ReplicaGroup]:
        """One chain per shard at the plan's racks, provisioned by a sync
        (no bytes booked); none at R = 1."""
        if self.replication < 2:
            return []
        racks = plan.replica_racks[:, :self.replication]
        chains = [ReplicaGroup(s.shard_id, self.replication,
                               racks[s.shard_id]) for s in self.shards]
        for group, shard in zip(chains, self.shards):
            group.sync(shard, round_=self.step)
        return chains

    # -- assembled views -----------------------------------------------
    def _assemble_rows(self, per_shard: Callable[[PBoxShard], Any]) -> torch.Tensor:
        rows = torch.zeros((self.space.num_chunks, self.space.chunk_elems),
                           dtype=torch.float32, device=self.device)
        for shard in self.shards:
            if shard.num_chunks:
                rows[shard.rows] = per_shard(shard)
        return rows

    @property
    def params(self) -> torch.Tensor:
        """The full flat parameter space, assembled from the shards (a
        fresh tensor per round; callers must not write to it)."""
        if self._flat_cache is None:
            self._flat_cache = self._assemble_rows(
                lambda s: s.params).reshape(-1)
        return self._flat_cache

    # -- liveness / quorum ---------------------------------------------
    @property
    def num_alive_workers(self) -> int:
        return self.num_workers - len(self.dead_workers)

    @property
    def min_pushes(self) -> int:
        """Quorum size over the alive workers: ``ceil`` of the float
        product, as the JAX package computes it."""
        return max(1, int(np.ceil(self.min_push_fraction
                                  * self.num_alive_workers)))

    def alive(self, worker: int) -> bool:
        return worker not in self.dead_workers

    # -- worker API ----------------------------------------------------
    @span("ps.pull")
    def pull(self, worker: int) -> torch.Tensor:
        flat = self.params
        self._pull_step[worker] = self.step
        self.stats.pulls += 1
        self.stats.bytes_pulled += flat.numel() * _PULL_BYTES
        self.stats.chunk_pulls += self.space.num_chunks
        for shard in self.shards:
            shard.stats.chunk_pulls += shard.num_chunks
            shard.stats.bytes_pulled += shard.num_elems * _PULL_BYTES
        return flat

    def can_proceed(self, worker: int) -> bool:
        """SSP admission: a worker may start its next step iff it is within
        ``staleness`` steps of the slowest alive worker (0 in sync mode,
        unbounded in async).  A dead worker neither proceeds nor holds the
        window."""
        if worker in self.dead_workers:
            return False
        clocks = self.worker_clock
        if self.dead_workers:
            alive = [c for w, c in enumerate(clocks)
                     if w not in self.dead_workers]
            return clocks[worker] - min(alive) <= self.staleness
        return clocks[worker] - clocks.min() <= self.staleness

    @span("ps.push")
    def push(self, worker: int, gflat: torch.Tensor) -> None:
        """Push the whole flat gradient in one call."""
        if tuple(gflat.shape) != (self.space.flat_elems,):
            raise ValueError("bad gradient shape")
        self._complete_push(
            worker, gflat.reshape(self.space.num_chunks, self.space.chunk_elems)
        )

    @span("ps.push")
    def push_chunks(
        self, worker: int, chunk_ids: Sequence[int] | np.ndarray,
        gchunks: torch.Tensor,
    ) -> None:
        """Stage a worker's gradient for a subset of chunks.

        ``gchunks``: (len(chunk_ids), chunk_elems).  The push completes (and
        enters the barrier) once all chunks are staged."""
        ids = np.asarray(chunk_ids, dtype=np.int64)
        if tuple(gchunks.shape) != (len(ids), self.space.chunk_elems):
            raise ValueError("bad chunk gradient shape")
        if worker not in self._staged:
            # one staging buffer on the fabric's device, written in place
            self._staged[worker] = (
                torch.zeros((self.space.num_chunks, self.space.chunk_elems),
                            dtype=torch.float32, device=self.device),
                np.zeros(self.space.num_chunks, dtype=bool),
            )
        buf, mask = self._staged[worker]
        buf[torch.as_tensor(ids, device=self.device)] = gchunks.to(
            self.device, torch.float32)
        mask[ids] = True
        if mask.all():
            self._staged.pop(worker)
            self._complete_push(worker, buf)

    # -- push completion / admission ------------------------------------
    def _rack_agg_on(self) -> bool:
        # async has no rounds, so the ToR has nothing to batch: rack
        # aggregation is a sync/SSP round concept
        return (self.topology is not None and self.topology.rack_aggregation
                and self.mode != "async")

    def _switch_on(self) -> bool:
        # the switch tier rides the rack tier and speaks only the int8 wire
        # format (integer slot arithmetic)
        return (self._rack_agg_on() and self.switch_cfg.enabled
                and self.compression.codec == "int8")

    def _complete_push(self, worker: int, gchunks: torch.Tensor) -> None:
        if worker in self.dead_workers:
            raise RuntimeError(
                f"worker {worker} crashed at round {self.step} and has not "
                "re-entered; revive it (runtime/elastic.worker_reentry) "
                "before pushing")
        self.worker_clock[worker] += 1
        nbytes = wire_bytes(self.compression, gchunks.numel())
        self.stats.pushes += 1
        self.stats.bytes_pushed += nbytes
        self.stats.chunk_pushes += self.space.num_chunks
        if self.topology is not None:
            self.stats.bytes_rack_link += nbytes
        # Backup quorum: a gradient computed against params a quorum round
        # has superseded is dropped here, before the codec encodes it (its
        # error feedback stays untouched).  Only a strict-subset quorum
        # can supersede a push; SSP admits late pushes, async has no
        # rounds.
        if (self.mode == "sync" and self.min_pushes < self.num_alive_workers
                and int(self._pull_step[worker]) < self.step):
            self.stats.late_pushes_dropped += 1
            self._drops_since_step += 1
            if self.topology is not None:
                # the stale stream spent the rack link either way
                self.rack_aggs[self.topology.rack_of[worker]].drop_stale()
            if not self._rack_agg_on():
                # no aggregating ToR to refuse it early: the stream crossed
                # the core before the PS could drop it
                self.stats.bytes_core_link += nbytes
            if (self._drops_since_step >= self.num_workers
                    and bool((self._pull_step < self.step).all())):
                # every worker pushes superseded gradients and nobody has
                # re-pulled: no round could ever fire again
                raise RuntimeError(
                    "all workers' pushes were computed against params "
                    f"superseded by round {self.step}; pull between rounds "
                    "so gradients are fresh (see PBoxFabric docstring)")
            return
        if not self._rack_agg_on():
            # no ToR combining: the worker's stream crosses the core itself
            # and reaches the shards directly (with ToR aggregation both
            # are charged per combined stream in _rack_aggregate)
            self.stats.bytes_core_link += nbytes
            for shard in self.shards:
                shard.stats.chunk_pushes += shard.num_chunks
                shard.stats.bytes_pushed += wire_bytes(self.compression,
                                                       shard.num_elems)
        wire: WirePayload | None = None
        if self.topology is not None or self.compression.codec != "none":
            with span("ps.encode"):
                gchunks, wire = self._encode(worker, gchunks)
        if self.mode == "async":
            self._apply_async(gchunks, wire)
            return
        self._inbox[worker] = gchunks if wire is None else wire
        if len(self._inbox) >= self.min_pushes and self._barrier_met():
            self._aggregate()

    def _encode(self, worker: int, gchunks: torch.Tensor
                ) -> tuple[torch.Tensor, WirePayload | None]:
        """The wire crossing to the PS: with the fused wire path and no
        aggregating ToR the stream stays encoded up to the shards (the
        payload returned), else it is decoded at the hop (a ToR decodes to
        combine, so there the encoded hop moves to the rack uplink)."""
        wire: WirePayload | None = None
        flat = gchunks.reshape(-1)
        if self.topology is not None:
            rack = self.rack_aggs[self.topology.rack_of[worker]]
            if (self._switch_on() and rack.switch is not None
                    and rack.switch.alive
                    and rack.switch.slots >= self.space.num_chunks):
                # a switch-pool candidate: park the slab raw (the pool's
                # shared scale needs every member's magnitude) and book the
                # rack link now; the offload decision waits for the round
                # edge, where a pool failed meanwhile falls back
                rack.ingest_deferred(worker)
                self._deferred.add(worker)
            elif self._fused_wire and not self._rack_agg_on():
                wire = rack.ingest_wire(worker, flat)
            else:
                gchunks = rack.ingest(worker, flat).reshape(gchunks.shape)
        elif self._fused_wire:
            wire, self._worker_ef[worker] = encode_wire(
                self.compression, flat, self._worker_ef[worker])
        else:
            dec, self._worker_ef[worker] = roundtrip(
                self.compression, flat, self._worker_ef[worker])
            gchunks = dec.reshape(gchunks.shape)
        return gchunks, wire

    @span("ps.aggregate")
    def _apply_async(self, gchunks: torch.Tensor,
                     wire: WirePayload | None) -> None:
        """Hogwild-PS: one push is one step, applied at once on every
        shard with K = 1 and no averaging, at the new step's scalars."""
        self.step += 1
        if wire is not None:
            pay = wire.payload.reshape(self.space.num_chunks,
                                       self.space.chunk_elems)
            for shard in self.shards:
                if shard.num_chunks:
                    shard.apply_wire(
                        pay[shard.rows][None],
                        None if wire.scale is None
                        else wire.scale[shard.rows][None],
                        wire.codec, self.step, average=False)
            self.stats.fused_wire_rounds += 1
        else:
            for shard in self.shards:
                if shard.num_chunks:
                    shard.apply([gchunks], self.step, average=False)
        self.stats.steps += 1
        self._simulate_round(streams=1 if self.topology else None)
        self._flat_cache = None
        self._replicate_round()
        self._fire_faults()

    def _barrier_met(self) -> bool:
        # a quorum exists only as a strict subset of the alive workers;
        # ceil(fraction * alive) == alive is a full barrier
        if self.min_pushes < self.num_alive_workers:
            return True  # the inbox holds only current-round pushes
        return len(self._inbox) == self.num_alive_workers

    @span("ps.aggregate")
    def _aggregate(self) -> None:
        workers = sorted(self._inbox)
        if len(workers) < self.num_workers:
            self.stats.partial_aggregations += 1
        self.step += 1
        # the pulled flat view is stale from here on: free it before the
        # round's temporaries
        self._flat_cache = None
        streams = None
        if self._rack_agg_on():
            streams = self._rack_aggregate(workers)
        else:
            if self.topology is not None:
                streams = len(workers)  # every worker stream crosses the core
            if self._fused_wire:
                # the inbox holds WirePayloads: stack the encoded streams
                # per shard and let the single-pass kernel decode them
                codec = self.compression.codec
                shape = (self.space.num_chunks, self.space.chunk_elems)
                pays = [self._inbox[w] for w in workers]
                for shard in self.shards:
                    if not shard.num_chunks:
                        continue
                    pay = torch.stack(
                        [wp.payload.reshape(shape)[shard.rows]
                         for wp in pays])
                    sc = (torch.stack([wp.scale[shard.rows] for wp in pays])
                          if codec == "int8" else None)
                    shard.apply_wire(pay, sc, codec, self.step, average=True)
                self.stats.fused_wire_rounds += 1
            else:
                pushes = [self._inbox[w] for w in workers]
                for shard in self.shards:
                    shard.apply(pushes, self.step, average=True)
        self._inbox.clear()
        self._deferred.clear()
        self.stats.steps += 1
        self._drops_since_step = 0
        self._simulate_round(streams=streams)
        self._flat_cache = None
        # chain replication completes before the round edge: a crash
        # scheduled at this round promotes the post-round bits
        self._replicate_round()
        self._fire_faults()

    def _rack_aggregate(self, workers: list[int]) -> int:
        """Combine this round's pushes rack by rack, then apply the
        upstream stream(s) to every shard.  Returns the number of streams
        that crossed the core link.

        f32 (codec "none") chains the running partial through the racks in
        ascending worker order: the add sequence of the fused kernel's
        left fold, so bit-identical to the flat fabric for any contiguous
        layout and any quorum subset.  Integer codecs combine each rack
        independently, re-encode at the ToR, and the shards fold the rack
        streams in rack order.  The streams are applied through the same
        (K, n) kernel call the flat fabric makes, with zero rows for the
        per-worker streams the ToRs absorbed (x + 0 is exact), so the
        averaging divisor stays the worker count.  Each push leaves the
        inbox once its rack has combined it."""
        # switch faults land mid-round: a pool scheduled to fail at this
        # round refuses this round's offload
        self._consume_switch_faults()
        self._round_switch_chunks = 0
        e = self.space.chunk_elems
        c = self.space.num_chunks
        shape = (c, e)
        codec = self.compression.codec
        streams: list[torch.Tensor] = []
        wire_streams: list[WirePayload] = []
        shipped = 0
        present = set(workers)
        active = [(rack, [w for w in rack.members if w in present])
                  for rack in self.rack_aggs]
        active = [(rack, members) for rack, members in active if members]
        # the core pool engages only when >= 2 rack streams would cross the
        # core and the fused wire path can carry its re-encoded egress
        use_core = (
            self._switch_on() and self.core_switch is not None
            and self._fused_wire and len(active) >= 2
            and self.core_switch.can_offload(c)
        )
        core_racks: list[RackAggregator] = []
        core_slabs: list[torch.Tensor] = []
        offloaded = fallback = False
        carry = None  # codec "none": the running prefix chained through racks
        for rack, members in active:
            if codec == "none":
                for w in members:
                    g = self._inbox.pop(w)
                    carry = g if carry is None else carry + g
                relay = rack.uplink(carry.reshape(-1)).reshape(shape)
                streams = [relay]  # the chain's latest prefix supersedes
            else:
                if any(w in self._deferred for w in members):
                    # the rack's pushes were parked raw for the pool; the
                    # round-edge decision: a pool failed since push time
                    # takes the whole rack to the bit-exact software combine
                    pushes = [(w, self._inbox.pop(w).reshape(-1))
                              for w in members]
                    if rack.switch.can_offload(c):
                        local = rack.switch_combine(pushes)
                        self._round_switch_chunks += c
                        self.stats.bytes_switch_agg += (
                            (self.space.flat_elems + 4 * c) * len(pushes))
                        offloaded = True
                    else:
                        local = rack.software_combine(pushes)
                        fallback = True
                    del pushes
                else:
                    local = None
                    for w in members:
                        g = self._inbox.pop(w).reshape(-1)
                        local = g if local is None else local + g
                if use_core:
                    # staged for the core pool: quantization is coordinated
                    # across racks below (one shared scale)
                    core_racks.append(rack)
                    core_slabs.append(rack.uplink_pool(local))
                elif self._fused_wire:
                    # the re-encoded rack stream crosses the core still
                    # encoded; the shards' kernel decodes it
                    wire_streams.append(rack.uplink_wire(local))
                else:
                    streams.append(rack.uplink(local).reshape(shape))
                del local
            shipped += 1
            self.stats.bytes_core_link += wire_bytes(self.compression,
                                                     self.space.flat_elems)
            self.stats.rack_streams += 1
            if use_core:
                continue  # one PS-ingress stream, charged at pool egress
            # shard ingress: one combined stream per rack reaches the PS
            for shard in self.shards:
                shard.stats.chunk_pushes += shard.num_chunks
                shard.stats.bytes_pushed += wire_bytes(self.compression,
                                                       shard.num_elems)
        if offloaded:
            self.stats.switch_rounds += 1
        if fallback:
            self.stats.switch_fallback_rounds += 1
        if use_core:
            wire_streams.append(self._core_combine(core_racks, core_slabs))
            n_racks = len(core_racks)
            self._round_switch_chunks += c
            self.stats.core_switch_rounds += 1
            self.stats.bytes_switch_agg += (
                (self.space.flat_elems + 4 * c) * n_racks)
            self.stats.bytes_switch_saved += (
                (n_racks - 1)
                * wire_bytes(self.compression, self.space.flat_elems))
            for shard in self.shards:
                shard.stats.chunk_pushes += shard.num_chunks
                shard.stats.bytes_pushed += wire_bytes(self.compression,
                                                       shard.num_elems)
        k = len(workers)
        if wire_streams:
            # zero rows stand in for the streams the ToRs absorbed: a zero
            # payload decodes to exact 0.0 (int8: q = 0 under scale 1.0;
            # bf16: zero bits widen to +0.0f)
            for shard in self.shards:
                if not shard.num_chunks:
                    continue
                rows = shard.rows
                pay = torch.zeros((k, shard.num_chunks, e),
                                  dtype=wire_streams[0].payload.dtype,
                                  device=self.device)
                sc = (torch.ones((k, shard.num_chunks), dtype=torch.float32,
                                 device=self.device)
                      if codec == "int8" else None)
                for i, wp in enumerate(wire_streams):
                    pay[i] = wp.payload.reshape(shape)[rows]
                    if sc is not None:
                        sc[i] = wp.scale[rows]
                shard.apply_wire(pay, sc, codec, self.step, average=True)
                del pay, sc
            self.stats.fused_wire_rounds += 1
            return shipped
        # null rows stand in for the absorbed streams: the kernel folds each
        # as + 0.0f, the zero row's exact add
        pushes = streams + [None] * (k - len(streams))
        for shard in self.shards:
            shard.apply(pushes, self.step, average=True)
        return shipped

    def _core_combine(self, racks: list[RackAggregator],
                      slabs: list[torch.Tensor]) -> WirePayload:
        """The core pool's crossing: the racks share one per-chunk scale
        (``group_scale`` over their slabs), each ships int8 under it and
        keeps its switch-side residual against it, and the slot registers
        sum with exact int32 adds.  The pool's egress re-encodes the sum
        once with the core switch's own error feedback, so one stream lands
        at the PS however many racks fed the pool."""
        e = self.space.chunk_elems
        s_sh = group_scale(slabs, e)
        qs = []
        for i, rack in enumerate(racks):
            q = integer_quantize(slabs[i], s_sh, e)
            rack.commit_uplink(slabs[i], q, s_sh)
            slabs[i] = None  # each staged slab is spent once committed
            qs.append(q)
        acc = self.core_switch.accumulate(qs, e)
        del qs
        dec = scale_chunks(acc, s_sh)
        del acc
        slab_c = dec + self._core_ef if self._core_ef is not None else dec
        del dec
        s_c = group_scale([slab_c], e)
        q_c = integer_quantize(slab_c, s_c, e)
        if self._core_ef is not None:
            self._core_ef = quant_residual(slab_c, q_c, s_c)
        return WirePayload("int8", q_c, s_c)

    # -- event-ordered pipeline clock ------------------------------------
    def _simulate_round(self, streams: int | None = None) -> None:
        """Replay one aggregation round on the event clock: chunk c arrives
        at (c+1)*wire_us; each shard aggregates its chunks in arrival order,
        overlapping wire and engine time (chunk i aggregates while chunk i+1
        is in flight).  The wire time scales with the codec's bytes per
        element.

        With a topology the wire is a two-stage pipeline: the rack link
        feeds the ToR, then the oversubscribed core link relays each chunk
        onward (``streams`` streams share the racks' uplinks: one a rack
        with ToR aggregation, every worker's without).  The worst active
        link degradation slows the rack stage: the clock is
        round-granular, and the slowest rack is a sync round's barrier.

        With a ``shared_clock`` (a tenant of a ``MultiJobFabric``) both wire
        stages are inflated by the clock's fair-share scales, and the
        round's link occupancy is booked back on the box's queues.  The
        JAX package's arithmetic, product for product."""
        rack_scale = core_scale = 1.0
        if self.shared_clock is not None:
            rack_scale, core_scale = self.shared_clock.wire_scales(self)
            if rack_scale < 1.0 or core_scale < 1.0:
                raise ValueError(
                    "shared-clock scales cannot beat a dedicated link")
        bpe_scale = wire_bytes(self.compression, self.space.chunk_elems) / (
            4.0 * self.space.chunk_elems)
        degrade = max(self._link_degrade.values(), default=1.0)
        wire = self.link.wire_us_per_chunk * bpe_scale * rack_scale * degrade
        agg = self.link.agg_us_per_chunk
        c = self.space.num_chunks
        idx = np.arange(c, dtype=np.float64)
        core = 0.0
        if self.topology is not None:
            share = (1.0 if streams is None
                     else max(1.0, streams / self.topology.num_racks))
            # rack_scale rode in on ``wire``: only the core tier's extra
            # contention is applied on top
            core = (wire * self.topology.oversubscription * share
                    * (core_scale / rack_scale))
            edge_done = (idx + 1.0) * wire
            # the core relays chunk i while chunk i+1 crosses the rack link
            arrival = (np.maximum.accumulate(edge_done - idx * core)
                       + (idx + 1.0) * core)
            self.stats.sim_core_wire_us += c * core
        else:
            arrival = (idx + 1.0) * wire
        makespan = 0.0
        for shard in self.shards:
            if not shard.num_chunks:
                continue
            arr = arrival[shard.chunk_ids]
            n = len(arr)
            # completion_i = max_{j<=i}(arrival_j - j*agg) + (i+1)*agg
            shifted = arr - np.arange(n) * agg
            done = np.maximum.accumulate(shifted) + (np.arange(n) + 1) * agg
            makespan = max(makespan, float(done[-1]))
            shard.stats.sim_busy_us += n * agg
        self.stats.sim_wire_us += c * wire
        self.stats.sim_agg_us += c * agg
        self.stats.sim_pipelined_us += makespan
        self.stats.sim_serialized_us += c * wire + c * core + c * agg
        if self.shared_clock is not None:
            self.shared_clock.record_round(
                self,
                rack_us=c * wire,
                core_us=c * core,
                rack_demand_us=c * wire / rack_scale,
                core_demand_us=c * core / core_scale,
                makespan_us=makespan,
            )
            # switch-pool occupancy: an optional protocol method, so a
            # clock without it keeps working
            if (self._round_switch_chunks
                    and hasattr(self.shared_clock, "record_switch")):
                self.shared_clock.record_switch(
                    self, pool_us=self._round_switch_chunks * agg)

    # -- fault tier: chain replication, failover, injection ----------------
    def _hop_cost(self, src_rack: int, dst_rack: int) -> float:
        """Event-clock cost multiplier of one replication hop: rack-local
        hops ride the full-bisection tier, cross-rack hops pay the
        oversubscribed core."""
        if self.topology is None:
            return 1.0
        return self.topology.hop_cost(src_rack, dst_rack)

    def _account_state_stream(self, group: ReplicaGroup, shard: PBoxShard,
                              *, resilver: bool) -> None:
        """Book one chain pass (or one re-silver stream) for ``shard``:
        raw-f32 state bytes land on the rack/core link accounting training
        traffic uses, and the event clock records the pass in
        ``sim_replication_us`` (chain replication overlaps the next round)
        or ``sim_recovery_us`` (re-silvering is the failover's cost)."""
        nbytes = group.state_bytes(self.spec.num_state_slots,
                                   shard.num_elems)
        hops = group.hop_racks()
        if resilver:
            # one stream from the surviving chain onto the replacement
            hops = hops[:1]
        us_per_chunk = self.link.wire_us_per_chunk * (
            1 + self.spec.num_state_slots)
        for src, dst in hops:
            if resilver:
                self.stats.bytes_resilver += nbytes
            else:
                self.stats.bytes_replication += nbytes
            if self.topology is not None:
                if src == dst:
                    self.stats.bytes_rack_link += nbytes
                else:
                    self.stats.bytes_core_link += nbytes
            us = shard.num_chunks * us_per_chunk * self._hop_cost(src, dst)
            if resilver:
                self.stats.sim_recovery_us += us
            else:
                self.stats.sim_replication_us += us

    def _replicate_round(self) -> None:
        """One chain pass after a completed round: every backup now holds
        the primary's exact post-round slab (raw f32), so a crash at this
        round edge fails over bit-exactly.  One ``copy_`` of each shard's
        state a round; nothing at R = 1."""
        if not self.replicas:
            return
        for group, shard in zip(self.replicas, self.shards):
            if shard.num_chunks:
                self._account_state_stream(group, shard, resilver=False)
            group.sync(shard, round_=self.step)
        self.stats.replication_rounds += 1

    def _fire_faults(self) -> None:
        """Inject every scheduled fault whose round the event clock just
        passed: round edges are the only crash points, always after the
        round's chain replication.  Switch faults are consumed mid-round
        (``_consume_switch_faults``, own cursor); here they only catch up
        on rounds that never reached a rack aggregation."""
        if self.fault_plan is None:
            return
        self._consume_switch_faults()
        due = self.fault_plan.between(self._fault_cursor, self.step)
        self._fault_cursor = self.step
        for ev in due:
            self._apply_fault(ev)

    def _apply_fault(self, ev) -> None:
        if ev.kind in ("switch_fail", "switch_restore"):
            return  # consumed mid-round by _consume_switch_faults
        rec: dict[str, Any] = {"round": int(self.step), "event": ev.to_json()}
        if ev.kind == "shard_crash":
            self.fault_trace.append(rec)  # recorded before a possible raise
            rec["action"] = self.crash_shard(ev.target)
        elif ev.kind == "worker_crash":
            self.crash_worker(ev.target)
            rec["action"] = "worker_crashed"
            self.fault_trace.append(rec)
        elif ev.kind == "worker_recover":
            # in-process recovery: the fabric's state is current, so revive
            # directly (elastic.worker_reentry's clock alignment, without
            # materializing a snapshot to discard it)
            self.revive_worker(ev.target)
            rec["action"] = "worker_reentered"
            self.fault_trace.append(rec)
        elif ev.kind == "link_degrade":
            if self.topology is not None and not (
                    0 <= ev.target < self.topology.num_racks):
                raise ValueError(f"link_degrade targets rack {ev.target}, "
                                 "not in the topology")
            self._link_degrade[ev.target] = ev.factor
            self.stats.link_degrades += 1
            rec["action"] = f"link_degraded_x{ev.factor:g}"
            self.fault_trace.append(rec)
        elif ev.kind == "link_restore":
            self._link_degrade.pop(ev.target, None)
            rec["action"] = "link_restored"
            self.fault_trace.append(rec)

    def crash_shard(self, shard_id: int) -> str:
        """One aggregation engine dies at a round edge.

        With a surviving chain (replication >= 2) the chain head's copy of
        the post-round slab becomes the replacement engine's slab as it is
        (no copy), routing re-targets the replacement (``chunk_owner`` is
        unchanged; the shard slot is), and the crashed engine's buffers
        take the re-silvered copy, so the chain is back at full strength
        without allocating.  Attached sparse tiers fail their co-resident
        row slices over too.  With replication == 1 the slab is gone:
        raises ``ShardLost``."""
        if not 0 <= shard_id < self.num_shards:
            raise ValueError(f"no shard {shard_id}")
        dead = self.shards[shard_id]
        self.stats.shards_crashed += 1
        if self.replication < 2 or not self.replicas:
            raise ShardLost(shard_id, dead.num_chunks, self.step,
                            self.replication)
        group = self.replicas[shard_id]
        chunk_ids, params, state = group.promote()
        replacement = PBoxShard.from_state(shard_id, self.space, self.spec,
                                           chunk_ids, params, state)
        self.shards[shard_id] = replacement
        self.stats.failovers += 1
        # recovery: one state stream re-silvers the chain's empty slot
        if replacement.num_chunks:
            self._account_state_stream(group, replacement, resilver=True)
        group.sync(replacement, round_=self.step,
                   spare=(dead.params, dead.state))
        del dead
        self.stats.resilvers += 1
        self.sparse_tiers = [r for r in self.sparse_tiers
                             if r() is not None]
        for ref in self.sparse_tiers:
            tier = ref()
            if tier is not None:
                tier.failover(shard_id)
        self._flat_cache = None
        return "failed_over"

    def crash_worker(self, worker: int) -> None:
        """A worker process dies: its in-flight stream (staged chunks, an
        unaggregated inbox entry) dies with it, and the admission barrier
        shrinks to the survivors.  If its missing push was all the round's
        barrier waited on, the round fires now."""
        if not 0 <= worker < self.num_workers:
            raise ValueError(f"no worker {worker}")
        if worker in self.dead_workers:
            return
        self.dead_workers.add(worker)
        self.stats.workers_crashed += 1
        self._staged.pop(worker, None)
        self._deferred.discard(worker)  # a parked raw push dies in flight
        dropped = self._inbox.pop(worker, None)
        if dropped is not None:
            self.worker_clock[worker] -= 1  # that push never happened
        if (self.mode != "async" and self._inbox
                and len(self._inbox) >= self.min_pushes
                and self._barrier_met()):
            self._aggregate()

    def revive_worker(self, worker: int, *, clock: int | None = None) -> None:
        """Re-admit a crashed worker (``runtime/elastic.worker_reentry``):
        it resumes on the current params version, its clock at the
        current step, so its first push is fresh."""
        if worker not in self.dead_workers:
            return
        self.dead_workers.discard(worker)
        self.stats.workers_recovered += 1
        self.worker_clock[worker] = self.step if clock is None else clock
        self._pull_step[worker] = self.step

    def export_fault_trace(self) -> dict:
        """The replayable failure record: the deterministic plan plus every
        injected event and the action taken.  Counts come from the trace,
        not ``ServerStats``: stats are cumulative across a restore and a
        replay, while the trace (truncated on restore) is the current
        timeline."""
        kinds: dict[str, int] = {}
        actions: dict[str, int] = {}
        for rec in self.fault_trace:
            k = rec["event"]["kind"]
            kinds[k] = kinds.get(k, 0) + 1
            a = rec.get("action")
            if a is not None:
                actions[a] = actions.get(a, 0) + 1
        return {
            "schema": 1,
            "replication": self.replication,
            "plan": self.fault_plan.to_json() if self.fault_plan else None,
            "trace": list(self.fault_trace),
            "round": int(self.step),
            "stats": {
                "shards_crashed": kinds.get("shard_crash", 0),
                "failovers": actions.get("failed_over", 0),
                "resilvers": actions.get("failed_over", 0),
                "workers_crashed": kinds.get("worker_crash", 0),
                "workers_recovered": kinds.get("worker_recover", 0),
                "link_degrades": kinds.get("link_degrade", 0),
            },
        }

    # -- switch faults ------------------------------------------------------
    def _consume_switch_faults(self) -> None:
        """Fire the fault plan's due ``switch_fail`` / ``switch_restore``
        events.  Runs at the top of ``_rack_aggregate``, before the round's
        offload decision, and after every round (catching up on rounds
        that never reached a rack aggregation).  Target rack id flips that
        ToR's pool; target == num_racks flips the core pool.  Without a
        switch tier an event is recorded as ignored, so a plan replays on
        any fabric."""
        if self.fault_plan is None:
            return
        due = self.fault_plan.between(self._switch_cursor, self.step)
        self._switch_cursor = self.step
        n_racks = len(self.rack_aggs)
        for ev in due:
            if ev.kind not in ("switch_fail", "switch_restore"):
                continue
            rec: dict[str, Any] = {"round": int(self.step),
                                   "event": ev.to_json()}
            if not 0 <= ev.target <= n_racks:
                raise ValueError(
                    f"{ev.kind} targets switch {ev.target}; the fabric has "
                    f"{n_racks} ToR pools + 1 core pool")
            sw = (self.core_switch if ev.target == n_racks
                  else self.rack_aggs[ev.target].switch
                  if self.rack_aggs else None)
            if sw is None:
                rec["action"] = "ignored_no_switch_tier"
            elif ev.kind == "switch_fail":
                sw.fail()
                self.stats.switch_failures += 1
                rec["action"] = f"switch_failed:{sw.name}"
            else:
                sw.restore()
                self.stats.switch_restores += 1
                rec["action"] = f"switch_restored:{sw.name}"
            self.fault_trace.append(rec)

    # -- placement-plan hooks ---------------------------------------------
    def rebalance(self, slow_shards: Sequence[int]) -> int:
        """Move all chunks owned by ``slow_shards`` to healthy shards
        (balance-preserving), as a ``chunk_moves`` plan delta applied
        through ``apply_plan_delta``.  Parameters and optimizer state move
        with their chunks, so training numerics are unchanged.  Returns
        the number of chunks moved."""
        delta = chunk_rebalance_delta(self.chunk_owner, list(slow_shards),
                                      self.num_shards)
        if delta is None:
            return 0
        return self.apply_plan_delta(delta)

    def apply_plan_delta(self, delta: PlanDelta) -> int:
        """Apply one placement-plan delta; returns a progress count (chunks
        moved, chain copies re-homed, or chunks re-assigned by a reshard).
        Every kind moves ownership and byte/time accounting, never
        parameter or optimizer bits."""
        if delta.kind == "chunk_moves":
            return self._apply_chunk_moves(delta.moves)
        if delta.kind == "replica_racks":
            return self.replace_chain_racks(delta.shard, delta.racks)
        if delta.kind == "shard_count":
            return self.reshard(delta.new_shards)
        raise ValueError(
            f"delta kind {delta.kind!r} is not fabric-applied (frontend "
            "moves belong to the read plane, tenant shares to the "
            "MultiJobFabric)")

    def _apply_chunk_moves(self, moves: Sequence[tuple[int, int]]) -> int:
        new_owner = self.chunk_owner.copy()
        for chunk, owner in moves:
            if not 0 <= chunk < self.space.num_chunks:
                raise ValueError(f"no chunk {chunk}")
            if not 0 <= owner < self.num_shards:
                raise ValueError(f"no shard {owner}")
            new_owner[chunk] = owner
        moved = np.where(new_owner != self.chunk_owner)[0]
        if len(moved) == 0:
            return 0
        # every source shard releases its moved chunks (copies, in id
        # order); each destination then gathers its rows in one index
        released: list[tuple[np.ndarray, torch.Tensor, tuple]] = []
        for shard in self.shards:
            ids = moved[self.chunk_owner[moved] == shard.shard_id]
            if len(ids):
                released.append((ids, *shard.release(ids)))
        at = np.empty(self.space.num_chunks, dtype=np.int64)
        at[np.concatenate([ids for ids, _, _ in released])] = np.arange(
            len(moved))
        p_all = torch.cat([p for _, p, _ in released])
        s_all = tuple(torch.cat([s[k] for _, _, s in released])
                      for k in range(self.spec.num_state_slots))
        del released
        for shard in self.shards:
            ids = moved[new_owner[moved] == shard.shard_id]
            if len(ids) == 0:
                continue
            sel = torch.as_tensor(at[ids], dtype=torch.long,
                                  device=self.device)
            shard.adopt(ids, p_all[sel], tuple(s[sel] for s in s_all))
        self.chunk_owner = new_owner
        self.stats.rebalances += 1
        self.stats.chunks_moved += len(moved)
        # the chains follow their shard's new chunk set (the move rides the
        # rebalance transfer, not the replication wire)
        for group, shard in zip(self.replicas, self.shards):
            group.sync(shard, round_=self.step)
        self._flat_cache = None
        return len(moved)

    def replace_chain_racks(self, shard_id: int,
                            new_racks: Sequence[int]) -> int:
        """Re-home one shard's replication chain onto ``new_racks``
        (primary's home first, then the backups).  Returns the number of
        copies that moved.  Numerics-neutral: a move is metadata plus one
        state stream on the wire for each copy that changes rack, booked
        as recovery traffic (``bytes_resilver``, ``sim_recovery_us``).  The
        plan and the plan-backed topology are refreshed."""
        if not self.replicas:
            raise ValueError(
                "no replication chains to re-home (replication < 2)")
        if not 0 <= shard_id < self.num_shards:
            raise ValueError(f"no shard {shard_id}")
        group = self.replicas[shard_id]
        new = tuple(int(r) for r in new_racks)
        if len(new) != group.factor:
            raise ValueError(
                f"chain has {group.factor} copies, got {len(new)} racks")
        n_racks = self.topology.num_racks if self.topology is not None else 1
        for r in new:
            if not 0 <= r < n_racks:
                raise ValueError(f"rack {r} not in the topology")
        old = group.racks
        if new == old:
            return 0
        shard = self.shards[shard_id]
        group.racks = new
        rr = np.asarray(self.plan.replica_racks).copy()
        rr[shard_id, :len(new)] = new
        self.plan = self.plan.replace(replica_racks=rr)
        if self.topology is not None:
            self.topology = self.topology.with_plan(self.plan)
        moved = 0
        if shard.num_chunks:
            nbytes = group.state_bytes(self.spec.num_state_slots,
                                       shard.num_elems)
            us_per_chunk = self.link.wire_us_per_chunk * (
                1 + self.spec.num_state_slots)
            for src, dst in zip(old, new):
                if src == dst:
                    continue
                moved += 1
                self.stats.bytes_resilver += nbytes
                if self.topology is not None:
                    self.stats.bytes_core_link += nbytes
                self.stats.sim_recovery_us += (
                    shard.num_chunks * us_per_chunk
                    * self._hop_cost(src, dst))
        else:
            moved = sum(1 for a, b in zip(old, new) if a != b)
        self.stats.replica_moves += moved
        return moved

    def reshard(self, new_num_shards: int, *,
                plan: PlacementPlan | None = None) -> int:
        """Change the live fabric's shard count in place: the autoscaler's
        grow/shrink lever.  Returns the number of chunks whose owner
        changed.

        A round-edge operation: in-flight pushes must have drained.  The
        same chunk space is re-partitioned over another number of engines,
        so push/pull shapes, residuals, clocks and pull versions stay as
        they were, and every shard applies the same per-chunk kernel
        program: bit-identical across the change.  The order keeps the
        card's memory at the state plus one slot: the chains are dropped
        first, the slots (params, then each optimizer slot) are regathered
        one at a time with each old slab released once gathered
        (``_regather``), then the chains are provisioned again from
        ``plan`` (default: the anti-affine default plan).  Attached sparse
        tiers re-shard with the dense engines."""
        if new_num_shards < 1:
            raise ValueError("num_shards must be >= 1")
        if self._inbox or self._staged:
            raise RuntimeError(
                "reshard is a round-edge operation: in-flight pushes must "
                "drain (or be dropped) before the engine set changes")
        if new_num_shards == self.num_shards and plan is None:
            return 0
        n_racks = self.topology.num_racks if self.topology is not None else 1
        if plan is None:
            plan = PlacementPlan.default(new_num_shards, num_racks=n_racks,
                                         replication=self.replication)
        self._check_plan(plan, new_num_shards, n_racks, self.replication)
        assignment = self._partition(plan, new_num_shards)
        owner = np.empty(self.space.num_chunks, dtype=np.int64)
        for sid, ids in enumerate(assignment):
            owner[ids] = sid
        moved = int(np.sum(owner != self.chunk_owner))
        self.replicas = []
        self._flat_cache = None
        slots = self._regather(assignment)
        self.shards = [
            PBoxShard.from_state(sid, self.space, self.spec, ids,
                                 slots[sid][0], tuple(slots[sid][1:]))
            for sid, ids in enumerate(assignment)
        ]
        del slots
        self.chunk_owner = owner
        self.num_shards = new_num_shards
        self.plan = plan
        if self.topology is not None:
            self.topology = self.topology.with_plan(plan)
        self.replicas = self._build_chains(plan)
        self.stats.rescales += 1
        self.stats.chunks_moved += moved
        self.sparse_tiers = [r for r in self.sparse_tiers
                             if r() is not None]
        for ref in self.sparse_tiers:
            tier = ref()
            if tier is not None:
                tier.reshard(new_num_shards)
        return moved

    def _regather(self, assignment: list[np.ndarray]) -> list[list]:
        """The rows of every state slot (params first) for the new
        partition ``assignment``, as ``[shard][slot]`` tensors.  One slot
        at a time: each new slab is filled from the old shards' slabs
        (slices where both sides are contiguous runs), then that slot of
        every old shard is released."""
        e = self.space.chunk_elems
        dev = self.device
        pos = np.empty(self.space.num_chunks, dtype=np.int64)
        for sh in self.shards:
            pos[sh.chunk_ids] = np.arange(sh.num_chunks)
        # (old shard, new shard) -> (rows in the new slab, rows in the old)
        routes = []
        for new_sid, ids in enumerate(assignment):
            for sh in self.shards:
                mine = np.flatnonzero(self.chunk_owner[ids] == sh.shard_id)
                if len(mine):
                    routes.append((sh, new_sid, _row_index(mine, dev),
                                   _row_index(pos[ids[mine]], dev)))
        out: list[list] = [[] for _ in assignment]
        for k in range(1 + self.spec.num_state_slots):
            dst = [torch.empty((len(ids), e), dtype=torch.float32,
                               device=dev) for ids in assignment]
            for sh, new_sid, to, frm in routes:
                src = sh.params if k == 0 else sh.state[k - 1]
                dst[new_sid][to] = src[frm]
            for sh in self.shards:
                if k == 0:
                    sh.params = None
                else:
                    sh.state = sh.state[:k - 1] + (None,) + sh.state[k:]
            for slabs, d in zip(out, dst):
                slabs.append(d)
            del dst
        return out

    # -- snapshot / restore ----------------------------------------------
    def snapshot(self) -> dict:
        """Crash-consistent snapshot of the committed training state, as
        host (numpy) copies under the JAX package's keys, so a snapshot of
        either package restores into the other.

        Taken mid-round (inbox non-empty) it still restores to a state from
        which training re-converges bit-identically: params and optimizer
        state are pre-round (the inbox has not been applied), and the
        clocks are rolled back for every in-flight push, which the
        restored run replays.  Chunk-staged pushes never advanced a
        clock."""
        wc = self.worker_clock.copy()
        for w in self._inbox:
            wc[w] -= 1
        return {
            "params": _to_host(self.params),
            # one slot assembled on the device at a time
            "state": tuple(_to_host(self._assemble_rows(
                lambda s, k=k: s.state[k]).reshape(-1))
                for k in range(self.spec.num_state_slots)),
            "step": self.step,
            "worker_clock": wc,
            "dead_workers": np.asarray(sorted(self.dead_workers),
                                       dtype=np.int64),
            "replication": self.replication,
        }

    def restore(self, snap: dict) -> None:
        """Restore a snapshot: parameters, optimizer state, the round
        counter and the per-worker clocks, into fresh tensors (the
        snapshot's arrays are never aliased).  Snapshots without
        ``worker_clock``, and restores onto another worker count, reset
        every clock to the restored step.  Staged pushes, the inbox and
        the error-feedback residuals (the ToRs' and the core pool's
        included) are discarded: they belong to in-flight streams that did
        not survive.  Failed switch pools come back alive."""
        shape = (self.space.num_chunks, self.space.chunk_elems)
        params = np.asarray(snap["params"], dtype=np.float32).reshape(shape)
        states = [np.asarray(s, dtype=np.float32).reshape(shape)
                  for s in snap["state"]]
        for shard in self.shards:
            shard.params = _fresh_rows(params, shard, self.device)
            shard.state = tuple(_fresh_rows(s, shard, self.device)
                                for s in states)
        self.step = int(snap["step"])
        wc = snap.get("worker_clock")
        if wc is not None and len(np.atleast_1d(wc)) == self.num_workers:
            self.worker_clock = np.asarray(wc, dtype=np.int64).copy()
        else:
            self.worker_clock = np.full(self.num_workers, self.step,
                                        dtype=np.int64)
        # every worker resumes against the restored params version
        self._pull_step = np.full(self.num_workers, self.step,
                                  dtype=np.int64)
        self._drops_since_step = 0
        self._inbox.clear()
        self._staged.clear()
        self._deferred.clear()
        for rack in self.rack_aggs:
            rack.reset()  # also revives an attached ToR switch pool
        if self.core_switch is not None:
            self.core_switch.reset()
            self._core_ef = init_ef_state(self.compression,
                                          self.space.flat_elems,
                                          device=self.device)
        self._worker_ef = {
            w: init_ef_state(self.compression, self.space.flat_elems,
                             device=self.device)
            for w in self._worker_ef
        }
        # a replayed fault plan re-fires from the restored round, and the
        # trace drops the rolled-back tail so replayed events appear once
        self.fault_trace = [r for r in self.fault_trace
                            if r["round"] <= self.step]
        dead = snap.get("dead_workers")
        self.dead_workers = (
            {int(w) for w in np.atleast_1d(dead) if 0 <= w < self.num_workers}
            if dead is not None else set()
        )
        self._link_degrade.clear()
        self._fault_cursor = self.step
        self._switch_cursor = self.step
        for group, shard in zip(self.replicas, self.shards):
            group.sync(shard, round_=self.step)  # provisioning, not wire
        # serving caches stamped with rounds from the abandoned timeline
        # must never serve again (the restored counter may rewind past
        # them, and the same round number will hold different bits); dead
        # planes are pruned as a side effect
        self.read_planes = [r for r in self.read_planes if r() is not None]
        for ref in self.read_planes:
            plane = ref()
            if plane is not None:
                plane.invalidate()
        # attached sparse tiers drop caches stamped on the abandoned
        # timeline the same way
        self.sparse_tiers = [r for r in self.sparse_tiers
                             if r() is not None]
        for ref in self.sparse_tiers:
            tier = ref()
            if tier is not None:
                tier.on_restore()
        self._flat_cache = None

    # -- introspection -----------------------------------------------------
    def rack_of(self, worker: int) -> int:
        """Rack hosting ``worker`` (0 when no topology is attached)."""
        return self.topology.rack_of[worker] if self.topology else 0

    def global_chunk_ids(self, local_ids: np.ndarray | None = None) -> np.ndarray:
        """Map local chunk ids into the box-wide namespace (``chunk_base``
        offset; identity on a dedicated fabric)."""
        if local_ids is None:
            local_ids = np.arange(self.space.num_chunks)
        ids = np.asarray(local_ids, dtype=np.int64)
        if ids.size and (ids.min() < 0 or ids.max() >= self.space.num_chunks):
            raise ValueError("local chunk id out of range")
        return ids + self.chunk_base

    def describe(self) -> str:
        lines = [
            (f"[{self.namespace}] " if self.namespace else "")
            + f"PBoxFabric: {self.num_shards} shards x "
            f"{self.space.num_chunks} chunks ({self.space.chunk_elems} elems), "
            f"mode={self.mode}, workers={self.num_workers}, "
            f"codec={self.compression.codec}, "
            f"fused_wire={'on' if self._fused_wire else 'off'}, "
            f"device={self.device}"
        ]
        lines += ["  " + ln for ln in self.config.describe().splitlines()]
        if self.switch_cfg.enabled:
            s = self.stats
            lines.append(
                f"  switch tier: {s.switch_rounds} rounds offloaded "
                f"({s.switch_fallback_rounds} fell back, "
                f"{s.core_switch_rounds} core-pooled), "
                f"{s.bytes_switch_agg >> 10} KiB absorbed in-pool, "
                f"{s.bytes_switch_saved >> 10} KiB ingress saved"
            )
            for rack in self.rack_aggs:
                if rack.switch is not None:
                    lines.append("    " + rack.switch.describe())
            if self.core_switch is not None:
                lines.append("    " + self.core_switch.describe())
        if self.topology is not None:
            lines.append("  " + self.topology.describe())
            lines.append(
                f"  core link: {self.stats.bytes_core_link >> 10} KiB in "
                f"{self.stats.rack_streams} aggregated streams, rack links "
                f"{self.stats.bytes_rack_link >> 10} KiB, late pushes "
                f"dropped {self.stats.late_pushes_dropped}"
            )
        if self.replication > 1:
            s = self.stats
            lines.append(
                f"  replication: R={self.replication}, "
                f"{s.bytes_replication >> 10} KiB chained, "
                f"{s.failovers} failovers ({s.resilvers} re-silvered), "
                f"{len(self.dead_workers)} workers down"
            )
        for ref in self.read_planes:
            plane = ref()
            if plane is not None:
                lines.append("  " + plane.describe())
        for shard in self.shards:
            lines.append(
                f"  shard {shard.shard_id}: {shard.num_chunks} chunks, "
                f"pushed={shard.stats.bytes_pushed >> 10} KiB, "
                f"pulled={shard.stats.bytes_pulled >> 10} KiB"
            )
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# worker harness
# ---------------------------------------------------------------------------
class WorkerHarness:
    """Drives K logical workers against a PBoxFabric.

    ``grad_fn(params_tree, batch) -> grad_tree`` is the worker compute;
    ``speed[w]`` scales how many scheduler ticks worker w needs per step
    (straggler modelling); ``chunk_groups > 1`` streams each push in that
    many chunk groups through the fabric's staging path (chunk-by-chunk
    push, as on a real NIC).

    Workers carry the fabric's rack assignment: ``rack_of(w)`` exposes it,
    ``steps_done_by_rack()`` sums progress per rack, and
    ``speed_by_rack`` slows a whole rack.
    """

    def __init__(
        self,
        server: PBoxFabric,
        grad_fn: Callable,
        batches_fn: Callable[[int, int], Any],  # (worker, step) -> batch
        speed: list[int] | None = None,
        chunk_groups: int = 1,
        speed_by_rack: dict[int, int] | None = None,
    ):
        self.server = server
        self.grad_fn = grad_fn
        self.batches_fn = batches_fn
        k = server.num_workers
        self.topology = server.topology
        self.speed = list(speed) if speed else [1] * k
        if speed_by_rack:
            if self.topology is None:
                raise ValueError("speed_by_rack needs a fabric topology")
            bad = [r for r in speed_by_rack if not
                   0 <= r < self.topology.num_racks]
            if bad:
                raise ValueError(
                    f"speed_by_rack names racks {bad} but the topology has "
                    f"racks 0..{self.topology.num_racks - 1}"
                )
            for w in range(k):
                r = self.topology.rack_of[w]
                if r in speed_by_rack:
                    self.speed[w] = speed_by_rack[r]
        self.chunk_groups = chunk_groups
        self._phase = [0] * k
        self.steps_done = [0] * k

    def rack_of(self, worker: int) -> int:
        return self.server.rack_of(worker)

    @property
    def job(self) -> str | None:
        """Tenant namespace this harness drives (None on a dedicated
        fabric)."""
        return getattr(self.server, "namespace", None)

    def telemetry(self) -> dict:
        """Job-level progress snapshot: worker steps, simulated per-round
        time and wire totals."""
        s = self.server.stats
        return {
            "job": self.job,
            "worker_steps": list(self.steps_done),
            "server_steps": s.steps,
            "sim_step_us": s.sim_pipelined_us / max(1, s.steps),
            "sim_core_wire_us": s.sim_core_wire_us,
            "bytes_pushed": s.bytes_pushed,
            "bytes_pulled": s.bytes_pulled,
            "steps_done_by_rack": self.steps_done_by_rack(),
        }

    def steps_done_by_rack(self) -> dict[int, int]:
        """Total completed worker-steps per rack (rack 0 holds everyone
        when the fabric has no topology)."""
        out: dict[int, int] = {}
        for w, n in enumerate(self.steps_done):
            out[self.rack_of(w)] = out.get(self.rack_of(w), 0) + n
        return out

    def _push(self, w: int, gflat: torch.Tensor) -> None:
        srv = self.server
        if self.chunk_groups <= 1:
            srv.push(w, gflat)
            return
        rows = gflat.reshape(srv.space.num_chunks, srv.space.chunk_elems)
        for ids in np.array_split(np.arange(srv.space.num_chunks),
                                  self.chunk_groups):
            if len(ids):
                srv.push_chunks(w, ids, rows[int(ids[0]):int(ids[-1]) + 1])

    def tick(self) -> None:
        """One scheduler tick: every non-blocked worker advances."""
        srv = self.server
        for w in range(srv.num_workers):
            if not srv.can_proceed(w):
                continue
            self._phase[w] += 1
            if self._phase[w] < self.speed[w]:
                continue
            self._phase[w] = 0
            flat = srv.pull(w)
            params = srv.space.unflatten(flat)
            batch = self.batches_fn(w, self.steps_done[w])
            with span("ps.worker_grad"):
                grads = self.grad_fn(params, batch)
            self._push(w, srv.space.flatten(grads))
            self.steps_done[w] += 1

    def _alive_progress(self) -> list[int]:
        """Completed steps of the workers still alive: a dead worker's
        stalled count must not hold ``run`` hostage."""
        is_alive = getattr(self.server, "alive", None)
        if is_alive is None:
            return list(self.steps_done)
        alive = [d for w, d in enumerate(self.steps_done) if is_alive(w)]
        if not alive:
            raise RuntimeError("every worker has crashed; nothing can run")
        return alive

    def run(self, worker_steps: int) -> None:
        guard = 0
        while min(self._alive_progress()) < worker_steps:
            self.tick()
            guard += 1
            if guard > worker_steps * max(self.speed) * 10 + 100:
                raise RuntimeError("scheduler livelock — staleness deadlock?")
