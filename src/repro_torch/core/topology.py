"""Datacenter topology tier: racks, ToR in-network aggregation, core uplinks
(torch counterpart of ``repro/core/topology.py``).

Inside a rack, workers see full bisection bandwidth to their top-of-rack
(ToR) switch; the ToR's uplink into the datacenter core is oversubscribed
(commonly 1:4).  In-network aggregation combines the rack's gradient
streams at the ToR, so one stream per rack crosses the scarce core link.

Four pieces, as in the JAX package:

  ``NetworkTopology``   the static layout: workers grouped into contiguous
                        racks, each with an oversubscribed core uplink.
  ``RackAggregator``    one ToR's aggregation state: per-worker NIC
                        error feedback for the edge-link codec, switch-side
                        error feedback for the re-encoded upstream stream,
                        and per-rack wire accounting.
  ``SwitchCompute``     one programmable switch's bounded aggregation pool
                        (SwitchML-style): integer slot registers that sum
                        int8 gradient segments.  A slab that does not fit
                        the pool, or arrives while the switch is failed,
                        takes the ToR's software path, bit-identically to a
                        fabric with no switch tier.
  ``LinkQueue``         one shared physical link's weighted-fair queue,
                        pure Python (the tenancy tier's ``MultiJobFabric``
                        shares it between jobs).

The switch's integer math (``group_scale``, ``integer_quantize`` and the
int32 slot sum) is plain torch ops, as it is plain ``jnp`` outside any
Pallas kernel in the JAX package.  Two details keep it bitwise equal to the
JAX package on either device: the scale divides ``amax`` by a tensor (torch
on the card turns division by a Python scalar into a product with its f32
reciprocal, where the JAX package divides eagerly), and a per-chunk scale
multiplies a (C, E) view by ``scale[:, None]`` instead of materialising the
repeated (N,) vector (the same products, one slab less memory).

Determinism: f32 addition is not associative, so with ``codec="none"`` the
fabric chains the partial sum through the racks in ascending worker order,
which reproduces the fused kernel's left fold bit for bit for any
contiguous rack layout and any quorum subset.  Integer codecs are
associative on the wire, so each rack combines independently and
re-encodes.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.compression import (
    CompressionConfig,
    WirePayload,
    encode_wire,
    init_ef_state,
    roundtrip,
    wire_bytes,
)
from repro_torch.device import resolve_device


# ---------------------------------------------------------------------------
# switch-pool integer arithmetic
# ---------------------------------------------------------------------------
def group_scale(slabs: list[torch.Tensor], chunk_elems: int) -> torch.Tensor:
    """Shared per-chunk quantization scale across ``slabs``: every sender
    quantizes chunk ``c`` against the group's largest magnitude, so the
    switch sums the int8 payloads with integer adds and one dequantize
    recovers the group sum.  ``amax / 127`` (a true division, as the JAX
    package computes it eagerly), 1.0 on an all-zero chunk; a NaN chunk
    propagates through the max and gets scale 1.0."""
    amax = None
    for slab in slabs:
        a = torch.amax(torch.abs(slab.reshape(-1, chunk_elems).float()),
                       dim=1)
        amax = a if amax is None else torch.maximum(amax, a)
    return torch.where(amax > 0, amax / torch.full_like(amax, 127.0),
                       torch.ones_like(amax))


def integer_quantize(slab: torch.Tensor, scale: torch.Tensor,
                     chunk_elems: int) -> torch.Tensor:
    """(N,) f32 -> (N,) int8 under a given per-chunk ``scale`` (C,): the
    sender's half of the switch pool's integer path.  Round half to even,
    clip to [-127, 127], then the int8 cast; a NaN quotient encodes as 0,
    as XLA's conversion gives (torch's NaN-to-int8 cast is not defined).
    One f32 temporary, rounded and clipped in place."""
    c = slab.shape[0] // chunk_elems
    t = slab.reshape(c, chunk_elems).float() / scale[:, None]
    t.round_().clamp_(-127, 127).nan_to_num_(nan=0.0)
    return t.to(torch.int8).reshape(-1)


def scale_chunks(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``f32(x) * scale[chunk]`` for an integer (N,) ``x`` and a per-chunk
    (C,) ``scale``: one product per element, the JAX package's
    ``x.astype(f32) * jnp.repeat(scale, e)``."""
    out = x.float()
    return out.view(scale.shape[0], -1).mul_(scale[:, None]).view(-1)


def quant_residual(slab2: torch.Tensor, q: torch.Tensor,
              scale: torch.Tensor) -> torch.Tensor:
    """Error-feedback residual ``slab2 - f32(q) * scale``: two roundings,
    the product's and the difference's, as in the JAX package."""
    d = scale_chunks(q, scale)
    return torch.sub(slab2, d, out=d)


@dataclasses.dataclass
class SwitchStats:
    """One switch pool's accounting."""

    rounds_offloaded: int = 0  # rounds the pool aggregated a whole slab
    rounds_declined: int = 0  # engaged rounds refused (failed / exhausted)
    chunks_aggregated: int = 0  # chunk segments accumulated in registers
    int_adds: int = 0  # integer additions the pool performed
    bytes_agg: int = 0  # wire bytes absorbed into slot registers
    pool_high_water: int = 0  # most slots ever live in one round
    failures: int = 0
    restores: int = 0


class SwitchCompute:
    """Bounded aggregation pool of one programmable switch.

    One slot accumulates one chunk's integer partial sum.  The pool takes a
    round only when the whole slab fits (``slots >= num_chunks``) and the
    switch is alive; otherwise the round takes the ToR's software path.
    The decision is made before any quantization, so the fallback is
    bit-identical to a fabric with no switch tier.  Accumulation is int32:
    with ``K`` senders a register holds at most ``127 * K``, so the sum is
    exact."""

    def __init__(self, name: str, slots: int):
        if slots < 0:
            raise ValueError("switch slots must be >= 0")
        self.name = name
        self.slots = int(slots)
        self.alive = True
        self.stats = SwitchStats()

    def can_offload(self, num_chunks: int) -> bool:
        """One round's admission decision (call once per round): alive and
        the whole slab fits.  A refusal is recorded (``rounds_declined``)."""
        if not self.alive or num_chunks > self.slots:
            self.stats.rounds_declined += 1
            return False
        self.stats.pool_high_water = max(self.stats.pool_high_water,
                                         num_chunks)
        return True

    def accumulate(self, qs: list[torch.Tensor],
                   chunk_elems: int) -> torch.Tensor:
        """Integer-sum the senders' int8 payloads in the slot registers:
        (N,) int32, exact.  Books the pool's work accounting."""
        acc = None
        for q in qs:
            acc = (q.to(torch.int32, copy=True) if acc is None
                   else acc.add_(q))
        n = qs[0].shape[0]
        c = n // chunk_elems
        st = self.stats
        st.rounds_offloaded += 1
        st.chunks_aggregated += c * len(qs)
        st.int_adds += (len(qs) - 1) * n
        st.bytes_agg += (n + 4 * c) * len(qs)  # int8 payload + scale words
        return acc

    def fail(self) -> None:
        self.alive = False
        self.stats.failures += 1

    def restore(self) -> None:
        self.alive = True
        self.stats.restores += 1

    def reset(self) -> None:
        """Elastic restore: the pool comes back alive and empty (its
        registers are drained every round, so only liveness resets)."""
        self.alive = True

    def describe(self) -> str:
        s = self.stats
        return (f"switch {self.name}: {self.slots} slots "
                f"{'up' if self.alive else 'DOWN'}, "
                f"{s.rounds_offloaded} rounds offloaded "
                f"({s.rounds_declined} declined), "
                f"{s.bytes_agg >> 10} KiB absorbed, "
                f"{s.int_adds} int adds")


@dataclasses.dataclass(frozen=True)
class NetworkTopology:
    """Workers grouped into contiguous racks with oversubscribed uplinks.

    ``rack_of`` maps worker -> rack and must be non-decreasing: the chained
    f32 aggregation relies on rack order matching ascending worker order.
    ``oversubscription`` is the core-uplink bandwidth divisor;
    ``rack_aggregation`` toggles ToR combining (off, every worker stream
    crosses the core itself).  ``plan`` is a placement plan, duck-typed
    (``num_racks``, ``num_shards``, ``replica_racks``) as in
    ``core/config.py``; it is left out of equality and hashing."""

    num_workers: int
    num_racks: int = 1
    oversubscription: float = 4.0
    rack_aggregation: bool = True
    rack_of: tuple[int, ...] = ()
    plan: object = dataclasses.field(default=None, compare=False, repr=False)

    def __post_init__(self):
        if self.num_workers < 1:
            raise ValueError("num_workers must be >= 1")
        if not 1 <= self.num_racks <= self.num_workers:
            raise ValueError("num_racks must be in [1, num_workers]")
        if self.oversubscription < 1.0:
            raise ValueError("oversubscription must be >= 1 (1 = full bisection)")
        if not self.rack_of:
            assign = np.repeat(
                np.arange(self.num_racks),
                [len(a) for a in np.array_split(np.arange(self.num_workers),
                                                self.num_racks)],
            )
            object.__setattr__(self, "rack_of", tuple(int(r) for r in assign))
        if len(self.rack_of) != self.num_workers:
            raise ValueError("rack_of must assign every worker")
        ranks = np.asarray(self.rack_of)
        if ranks.min() < 0 or ranks.max() >= self.num_racks:
            raise ValueError("rack_of entries out of range")
        if len(np.unique(ranks)) != self.num_racks:
            raise ValueError("every rack must contain at least one worker")
        if np.any(np.diff(ranks) < 0):
            raise ValueError(
                "racks must be contiguous worker ranges (rack_of "
                "non-decreasing): the deterministic chained aggregation "
                "order requires it"
            )
        if self.plan is not None and self.plan.num_racks != self.num_racks:
            raise ValueError(
                f"plan places {self.plan.num_racks} racks, topology has "
                f"{self.num_racks}"
            )

    def with_plan(self, plan) -> "NetworkTopology":
        """A copy of this topology with a placement plan attached: the
        placement queries read the plan; the physical layout is kept."""
        return dataclasses.replace(self, plan=plan)

    # -- queries -------------------------------------------------------
    def members(self, rack: int) -> tuple[int, ...]:
        return tuple(w for w, r in enumerate(self.rack_of) if r == rack)

    def replica_racks(self, num_shards: int, factor: int) -> np.ndarray:
        """Anti-affine replica placement: ``(num_shards, factor)`` rack ids
        where replica ``r`` of shard ``s`` lives in rack ``(s + r) %
        num_racks``.  With a plan attached whose shapes match, the plan's
        chain racks instead; a query for another shard count or a deeper
        factor falls back to the formula."""
        if num_shards < 1:
            raise ValueError("num_shards must be >= 1")
        if factor < 1:
            raise ValueError("replication factor must be >= 1")
        plan = self.plan
        if (plan is not None and plan.num_shards == num_shards
                and plan.replica_racks.shape[1] >= factor):
            return plan.replica_racks[:, :factor].copy()
        home = np.arange(num_shards, dtype=np.int64) % self.num_racks
        return (home[:, None]
                + np.arange(factor, dtype=np.int64)[None, :]) % self.num_racks

    def home_racks(self, num_shards: int) -> np.ndarray:
        """Primary home rack per shard: ``replica_racks``' first column."""
        return self.replica_racks(num_shards, 1)[:, 0]

    def hop_cost(self, src_rack: int, dst_rack: int) -> float:
        """Relative wire cost of one chunk between two racks' domains: 1.0
        rack-local, the oversubscription factor across the core."""
        for rack in (src_rack, dst_rack):
            if not 0 <= rack < self.num_racks:
                raise ValueError(f"rack {rack} not in the topology")
        return 1.0 if src_rack == dst_rack else self.oversubscription

    def nearest_rack(self, candidates, to_rack: int) -> int:
        """The candidate rack cheapest to reach from ``to_rack`` by
        ``hop_cost``.  Tie-breaking rule (pinned, as in the JAX package):
        among equally cheap candidates the lowest rack id wins; the read
        plane, the placement solver and the autoscaler all assume it."""
        cands = tuple(int(c) for c in candidates)
        if not cands:
            raise ValueError("nearest_rack needs at least one candidate")
        for c in cands:
            if not 0 <= c < self.num_racks:
                raise ValueError(f"rack {c} not in the topology")
        return min(cands, key=lambda r: (self.hop_cost(r, to_rack), r))

    @property
    def workers_per_rack(self) -> int:
        """Largest rack population (uniform layouts: the rack size)."""
        return int(np.bincount(np.asarray(self.rack_of)).max())

    def describe(self) -> str:
        sizes = np.bincount(np.asarray(self.rack_of), minlength=self.num_racks)
        return (
            f"NetworkTopology: {self.num_workers} workers / {self.num_racks} "
            f"racks {list(map(int, sizes))}, core 1:{self.oversubscription:g} "
            f"oversubscribed, ToR aggregation "
            f"{'on' if self.rack_aggregation else 'off'}"
        )


@dataclasses.dataclass
class LinkStats:
    """Occupancy accounting for one shared physical link."""

    reservations: int = 0
    demand_us: float = 0.0  # single-tenant time the transfers would take
    busy_us: float = 0.0  # actual (fair-share inflated) occupancy
    by_job: dict = dataclasses.field(default_factory=dict)  # job -> busy µs

    @property
    def queued_us(self) -> float:
        """Contention-added time on this link."""
        return self.busy_us - self.demand_us

    @property
    def contention_factor(self) -> float:
        """busy/demand: 1.0 on an uncontended link, >1 under co-tenancy."""
        if self.demand_us <= 0.0:
            return 1.0
        return self.busy_us / self.demand_us


class LinkQueue:
    """Weighted-fair queue on one shared physical link (a rack's edge link
    or the core uplink), fluid-flow style: a transfer that would take
    ``demand_us`` alone occupies the link for ``demand_us * scale``, where
    ``scale`` is the reserving job's fair-share inflation."""

    def __init__(self, name: str):
        self.name = name
        self.stats = LinkStats()

    def reserve(self, job: str, demand_us: float, scale: float) -> float:
        """Occupy the link for one job's transfer; returns the actual
        (inflated) occupancy in µs."""
        if demand_us < 0.0:
            raise ValueError("demand_us must be >= 0")
        if scale < 1.0:
            raise ValueError("fair-share scale cannot beat a dedicated link")
        actual = demand_us * scale
        s = self.stats
        s.reservations += 1
        s.demand_us += demand_us
        s.busy_us += actual
        s.by_job[job] = s.by_job.get(job, 0.0) + actual
        return actual

    def describe(self) -> str:
        s = self.stats
        shares = ", ".join(
            f"{j}={v:.0f}us" for j, v in sorted(s.by_job.items()))
        return (
            f"link {self.name}: busy {s.busy_us:.0f}us "
            f"(demand {s.demand_us:.0f}us, x{s.contention_factor:.2f} "
            f"contention) [{shares}]"
        )


@dataclasses.dataclass
class RackStats:
    ingests: int = 0  # worker streams accepted at the ToR
    uplinks: int = 0  # streams shipped up the core link
    stale_drops: int = 0  # stale quorum-round streams refused at the ToR
    bytes_in: int = 0  # worker -> ToR (rack-local, full bisection)
    bytes_up: int = 0  # ToR -> core (oversubscribed)


class RackAggregator:
    """One ToR switch: accepts its rack's worker pushes over the codec'd
    edge link and ships one (re-encoded) stream up the core link.

    Each worker's NIC keeps its own error-feedback residual (``ingest``),
    the switch keeps one for the re-quantized upstream sum (``uplink``).
    With a ``SwitchCompute`` pool attached, int8 pushes may be parked raw
    at the ToR (``ingest_deferred``) and summed by the pool at round time
    (``switch_combine``); when the pool refuses the round,
    ``software_combine`` runs the exact per-worker codec round trip that
    ``ingest`` would have run.  Residuals live on ``device`` (the card
    unless the caller passes another)."""

    def __init__(
        self,
        rack_id: int,
        members: tuple[int, ...],
        cfg: CompressionConfig,
        n_elems: int,
        switch: SwitchCompute | None = None,
        *,
        device: torch.device | str | None = None,
    ):
        self.rack_id = rack_id
        self.members = tuple(members)
        self.cfg = cfg
        self.n_elems = n_elems
        self.switch = switch
        self.device = resolve_device(device)
        self.stats = RackStats()
        self._worker_ef = {w: self._fresh_ef() for w in members}
        self._uplink_ef = self._fresh_ef()

    def _fresh_ef(self) -> torch.Tensor | None:
        return init_ef_state(self.cfg, self.n_elems, device=self.device)

    def _check_member(self, worker: int) -> None:
        if worker not in self._worker_ef:
            raise ValueError(f"worker {worker} is not in rack {self.rack_id}")

    def _book_ingest(self, worker: int) -> None:
        self._check_member(worker)
        self.stats.ingests += 1
        self.stats.bytes_in += wire_bytes(self.cfg, self.n_elems)

    def ingest(self, worker: int, slab: torch.Tensor) -> torch.Tensor:
        """One worker push crossing the rack-local link: the slab as the
        ToR sees it (codec round trip, worker-NIC error feedback)."""
        self._book_ingest(worker)
        dec, self._worker_ef[worker] = roundtrip(
            self.cfg, slab, self._worker_ef[worker])
        return dec

    def ingest_wire(self, worker: int, slab: torch.Tensor) -> WirePayload:
        """``ingest``, wire-form: the push stays encoded through the ToR
        for the shards' fused kernel.  Same error feedback and bytes."""
        self._book_ingest(worker)
        wp, self._worker_ef[worker] = encode_wire(
            self.cfg, slab, self._worker_ef[worker])
        return wp

    def ingest_deferred(self, worker: int) -> None:
        """Book one push parked raw at the ToR for the switch pool: the
        stream spent the rack link now; quantization waits for
        ``switch_combine`` (the shared scale needs every member)."""
        self._book_ingest(worker)

    def switch_combine(
            self, pushes: list[tuple[int, torch.Tensor]]) -> torch.Tensor:
        """Aggregate one round's parked pushes in the switch pool: each
        sender adds its NIC residual, the group shares one per-chunk scale
        (``group_scale``), each sender ships int8 under it and keeps its
        residual against that scale, and the slot registers sum with exact
        int32 adds.  Returns the dequantized (N,) f32 group sum.
        ``pushes`` are in ascending worker order; bytes were booked at
        ``ingest_deferred``."""
        sw = self.switch
        if sw is None:
            raise RuntimeError(f"rack {self.rack_id} has no switch pool")
        e = self.cfg.chunk_elems
        use_ef = self.cfg.error_feedback
        slabs2 = []
        for w, slab in pushes:
            self._check_member(w)
            ef = self._worker_ef[w]
            slabs2.append((w, slab + ef if (use_ef and ef is not None)
                           else slab))
        scale = group_scale([s for _, s in slabs2], e)
        qs = []
        for w, slab2 in slabs2:
            q = integer_quantize(slab2, scale, e)
            qs.append(q)
            if use_ef and self._worker_ef[w] is not None:
                self._worker_ef[w] = quant_residual(slab2, q, scale)
        del slabs2
        acc = sw.accumulate(qs, e)
        del qs
        return scale_chunks(acc, scale)

    def software_combine(
            self, pushes: list[tuple[int, torch.Tensor]]) -> torch.Tensor:
        """Fallback for parked pushes whose round the pool refused:
        per-worker codec round trip with NIC error feedback, summed in
        ascending worker order, which is the exact math of ``ingest`` at
        push time plus the fabric's fold."""
        total = None
        for w, slab in pushes:
            self._check_member(w)
            dec, self._worker_ef[w] = roundtrip(
                self.cfg, slab, self._worker_ef[w])
            total = dec if total is None else total + dec
        return total

    def drop_stale(self) -> None:
        """A stale quorum-round stream was refused: it spent the rack link
        but is never decoded and touches no error feedback."""
        self.stats.stale_drops += 1
        self.stats.bytes_in += wire_bytes(self.cfg, self.n_elems)

    def _book_uplink(self) -> None:
        self.stats.uplinks += 1
        self.stats.bytes_up += wire_bytes(self.cfg, self.n_elems)

    def uplink(self, slab: torch.Tensor) -> torch.Tensor:
        """The rack's combined stream crossing the core link: identity for
        f32 (the chain relays its prefix), else a codec round trip with the
        switch-side error feedback."""
        self._book_uplink()
        dec, self._uplink_ef = roundtrip(self.cfg, slab, self._uplink_ef)
        return dec

    def uplink_wire(self, slab: torch.Tensor) -> WirePayload:
        """``uplink``, wire-form: re-encoded at the ToR and shipped still
        encoded for the shards' fused kernel."""
        self._book_uplink()
        wp, self._uplink_ef = encode_wire(self.cfg, slab, self._uplink_ef)
        return wp

    def uplink_pool(self, slab: torch.Tensor) -> torch.Tensor:
        """Stage the rack's stream for a core-pool crossing: books the
        uplink and returns the slab with the switch-side residual added;
        ``commit_uplink`` lands the new residual once the core's shared
        scale is known."""
        self._book_uplink()
        ef = self._uplink_ef
        return slab + ef if (self.cfg.error_feedback and ef is not None) \
            else slab

    def commit_uplink(self, slab2: torch.Tensor, q: torch.Tensor,
                      scale: torch.Tensor) -> None:
        """Land the switch-side residual of a core-pool crossing: the rack
        shipped ``q`` under the group's shared per-chunk ``scale`` (C,).
        The JAX package passes the scale repeated per element; the
        residual's bits are the same."""
        if self.cfg.error_feedback and self._uplink_ef is not None:
            self._uplink_ef = quant_residual(slab2, q, scale)

    def reset(self) -> None:
        """Clear codec residuals (streams restart fresh); an attached switch
        pool comes back alive."""
        self._worker_ef = {w: self._fresh_ef() for w in self.members}
        self._uplink_ef = self._fresh_ef()
        if self.switch is not None:
            self.switch.reset()
