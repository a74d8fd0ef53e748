"""Declarative construction surface of the fabric: FabricConfig.

Counterpart of ``repro/core/config.py`` (its ``FabricConfig`` half).  The
fabric's knobs fold into one frozen, validated config tree:

  ``FabricConfig``     scalar fabric knobs (shards, mode, workers, the
                       tenancy namespace, ...)
  ``WireConfig``         the wire tier: topology, codec, link model and
                         the switch tier
  ``SwitchConfig``         in-network aggregation slot pools
  ``FaultConfig``        replication factor, fault schedule, anti-affinity
  ``PlacementConfig``    chunk placement policy and an explicit plan

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
