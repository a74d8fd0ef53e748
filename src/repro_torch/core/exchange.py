"""PS parameter exchange: push -> aggregate -> optimize -> pull, per rank
(torch counterpart of ``repro/core/exchange.py``).

These functions are *per-rank code* over a ``launch.mesh.Mesh`` whose axes
carry the workers: the JAX package runs them inside a manual
``shard_map``, the port in every process of a ``torch.distributed`` group.
Three strategies, matching the paper's comparison set:

  allreduce   The sharded-baseline data flow: gradients are all-reduced so
              every worker holds the aggregate, and every worker redundantly
              runs the optimizer on the full (local) parameter space.

  pbox        The PBox/PHub design: the flat chunk space is owned in equal
              slabs by every worker.  Push = one reduce-scatter (the sum
              arrives at the chunk owner); optimize = the fused
              ``fused_agg_opt`` kernel on the owned slab only; pull = one
              all-gather.  One round of communication, minimum total bytes,
              balanced by construction.

  pbox_hier   The paper's Fig. 5 hierarchical scheme: reduce-scatter within
              a pod first, then exchange only the already-scattered slab
              across pods, optionally bf16 / int8 encoded (the ``quant``
              kernels).  Owners are the pod-local data axes; optimizer state
              is replicated across pods, and the pull never crosses pods.

Owner ``i`` of a slab is the rank whose row-major index over the owner axes
is ``i``, as JAX's tiled ``psum_scatter`` assigns it, so each rank's slots
sit at the same offsets of the global layout in both packages (the
checkpoint's).  A division by the worker count is a product with its f32
reciprocal, which is what XLA compiles the JAX ``slab / nw`` to; under
``allreduce`` and ``pbox`` the kernel takes it as its ``grad_scale`` and
multiplies in its own pass, rounding to the slab's dtype as the eager
product does.

``PSExchange.stats`` (an ``ExchangeStats``, the port's addition) counts
the rounds and, by collective, the calls and the bytes of the tensors
handed to them, from shapes on the host.  ``device_update`` is a
``ps.exchange`` span, each collective a ``ps.<collective>`` span, the
owned slab's update ``ps.shard_apply`` and ``pbox_hier``'s codec
``ps.encode`` (``repro_torch.tracing``).

``fused_aggregate_update`` on a CUDA tensor launches the kernel, which
updates the owned slab of ``pflat`` and the slots IN PLACE (the JAX
functions return new arrays, and the JAX trainer donates its inputs):
``device_update`` consumes ``pflat`` and ``state``; callers use what it
returns.  CPU tensors take the kernel's plain version, bit-equal to it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import torch

from repro_torch.core import compression as comp
from repro_torch.core.chunking import ParamSpace
from repro_torch.core.compression import CompressionConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.fused_agg_opt.ops import fused_aggregate_update
from repro_torch.optim.optimizers import OptimizerSpec
from repro_torch.tracing import span


@dataclasses.dataclass(frozen=True)
class ExchangeConfig:
    """What the exchange moves and how.

    ``strategy`` picks the data flow ("allreduce" | "pbox" | "pbox_hier"),
    ``chunk_elems`` the flat space's chunk size, ``compression`` the codec
    of ``pbox_hier``'s cross-pod stage, ``pull_dtype`` the dtype the pull
    ships (e.g. ``torch.bfloat16`` to halve pull bytes).  ``use_pallas``
    and ``interpret`` are the JAX route knobs, accepted so JAX call sites
    work unchanged and read nowhere: the tensors' device picks the route
    (the CUDA kernel on the card, its plain version on the CPU), whatever
    their values."""

    strategy: str = "pbox"  # "allreduce" | "pbox" | "pbox_hier"
    chunk_elems: int = 8192
    compression: CompressionConfig = CompressionConfig()
    pull_dtype: Any = None
    use_pallas: bool = False
    interpret: bool = True


@dataclasses.dataclass
class ExchangeStats:
    """What ``device_update`` handed to the collectives: ``rounds``, and
    by collective (``reduce_scatter``, ``all_gather``, ``all_reduce``) the
    calls and the bytes of the tensors (the inputs of a reduce-scatter and
    an all-reduce, the output of an all-gather), counted from shapes on the
    host."""

    rounds: int = 0
    collective_calls: dict = dataclasses.field(default_factory=dict)
    collective_bytes: dict = dataclasses.field(default_factory=dict)

    def book(self, kind: str, t: torch.Tensor) -> None:
        self.collective_calls[kind] = self.collective_calls.get(kind, 0) + 1
        self.collective_bytes[kind] = (self.collective_bytes.get(kind, 0)
                                       + t.numel() * t.element_size())



class PSExchange:
    """Binds (optimizer, exchange config, mesh axis roles).

    ``worker_axes``: mesh axes over which gradients differ (batch sharding).
    ``pod_axis``: the outermost worker axis treated as the "rack" boundary
    for the hierarchical strategy (must be first in worker_axes)."""

    def __init__(
        self,
        spec: OptimizerSpec,
        cfg: ExchangeConfig,
        worker_axes: Sequence[str],
        pod_axis: str | None = None,
    ):
        self.spec = spec
        self.cfg = cfg
        self.worker_axes = tuple(worker_axes)
        self.pod_axis = pod_axis
        self.stats = ExchangeStats()
        if cfg.strategy == "pbox_hier":
            if pod_axis is None or pod_axis != self.worker_axes[0]:
                raise ValueError(
                    "pbox_hier requires pod_axis == worker_axes[0], got "
                    f"{pod_axis} vs {self.worker_axes}"
                )
            self.owner_axes = self.worker_axes[1:]
        elif cfg.strategy == "pbox":
            self.owner_axes = self.worker_axes
        elif cfg.strategy == "allreduce":
            self.owner_axes = ()
        else:
            raise ValueError(f"unknown strategy {cfg.strategy}")

    # ------------------------------------------------------------------
    # layout helpers (host side)
    # ------------------------------------------------------------------
    def build_space(self, local_params: Any, mesh_axis_sizes: dict) -> ParamSpace:
        """ParamSpace over the *local* tensor shapes."""
        n_owners = 1
        for a in self.owner_axes:
            n_owners *= mesh_axis_sizes[a]
        return ParamSpace.build(
            local_params, chunk_elems=self.cfg.chunk_elems,
            num_owners=max(n_owners, 1)
        )

    def slab_elems(self, space: ParamSpace) -> int:
        if self.cfg.strategy == "allreduce":
            return space.flat_elems
        return space.flat_elems // space.num_owners

    def init_slab_state(self, space: ParamSpace, *,
                        device: torch.device | str | None = None) -> dict:
        """Per-rank optimizer + error-feedback state (slab sized), on
        ``device`` (the card unless the caller passes another)."""
        dev = resolve_device(device)
        n = self.slab_elems(space)
        slots = tuple(
            torch.zeros((n,), dtype=torch.float32, device=dev)
            for _ in range(self.spec.num_state_slots)
        )
        ef = comp.init_ef_state(self.cfg.compression, n, device=dev)
        return {"slots": slots, "ef": ef,
                "step": torch.zeros((), dtype=torch.int32, device=dev)}

    # ------------------------------------------------------------------
    # per-rank exchange
    # ------------------------------------------------------------------
    def _collective(self, kind: str, fn, x: torch.Tensor, axes, **kwargs):
        """``fn(x, axes)``, a mesh collective, in its span and booked (no
        axes: the mesh hands ``x`` back and nothing is booked)."""
        with span("ps." + kind):
            out = fn(x, axes, **kwargs)
        if axes:
            self.stats.book(kind, out if kind == "all_gather" else x)
        return out

    def _update_slab(self, slab, pflat, mesh, owner_axes, state, step,
                     lr_scale, grad_scale=None):
        """The owned slab's fused update (``slab * grad_scale`` folded into
        the kernel's pass when given), then the pull over ``owner_axes``."""
        widx = mesh.axis_index(owner_axes)
        n = slab.shape[0]
        pslab = pflat[widx * n:(widx + 1) * n]
        with span("ps.shard_apply"):
            new_slab, new_slots = fused_aggregate_update(
                [slab], pslab, state["slots"], self.spec, step, lr_scale,
                average=False, grad_scale=grad_scale)
        pulled = new_slab
        if self.cfg.pull_dtype is not None:
            pulled = pulled.to(self.cfg.pull_dtype)
        new_p = self._collective("all_gather", mesh.all_gather, pulled,
                                 owner_axes).to(pflat.dtype)
        return new_p, new_slots

    @span("ps.exchange")
    def device_update(
        self,
        gflat: torch.Tensor,  # (flat,) this rank's gradient, PS dtype
        pflat: torch.Tensor,  # (flat,) params (PS dtype), replicated
        state: dict,  # from init_slab_state
        lr_scale: torch.Tensor | float = 1.0,
        *,
        mesh,
    ) -> tuple[torch.Tensor, dict]:
        """One PS round over ``mesh`` (a ``launch.mesh.Mesh``, the port's
        addition: JAX's ``shard_map`` supplies the axes).  Returns (new
        pflat, new state); consumes ``pflat`` and ``state`` (see the module
        docstring), never ``gflat``."""
        cfg, spec = self.cfg, self.spec
        self.stats.rounds += 1
        step = state["step"] + 1
        inv_nw = 1.0 / mesh.axis_size(self.worker_axes)

        if cfg.strategy == "allreduce":
            # the kernel multiplies the sum by inv_nw in its own pass,
            # rounded to the gradient's dtype as the eager product is
            g = self._collective("all_reduce", mesh.psum, gflat,
                                 self.worker_axes)
            with span("ps.shard_apply"):
                new_p, new_slots = fused_aggregate_update(
                    [g], pflat, state["slots"], spec, step, lr_scale,
                    average=False, grad_scale=inv_nw)
            return new_p, {"slots": new_slots, "ef": state["ef"], "step": step}

        if cfg.strategy == "pbox":
            # push: one reduce-scatter over all worker axes, arriving
            # already summed at the chunk owner; x inv_nw inside the kernel
            slab = self._collective("reduce_scatter", mesh.psum_scatter,
                                    gflat, self.worker_axes)
            new_p, new_slots = self._update_slab(
                slab, pflat, mesh, self.worker_axes, state, step, lr_scale,
                grad_scale=inv_nw)
            return new_p, {"slots": new_slots, "ef": state["ef"], "step": step}

        if cfg.strategy == "pbox_hier":
            pod, data_axes = self.pod_axis, self.owner_axes
            # stage 1: rack-local aggregation (reduce-scatter within pod);
            # the slab is summed or encoded again before the update, so the
            # scale is its own pass here
            slab = self._collective("reduce_scatter", mesh.psum_scatter,
                                    gflat, data_axes) * inv_nw
            # stage 2: one aggregated stream across pods, optionally coded
            ef = state["ef"]
            if cfg.compression.codec == "none":
                slab = self._collective("all_reduce", mesh.psum, slab, pod)
            else:
                with span("ps.encode"):
                    payload, ef = comp.encode(cfg.compression, slab, ef)
                # gather the pods' payloads, decode each and sum locally
                # (switch-side integer adds with per-chunk rescale)
                gathered = tuple(
                    self._collective("all_gather", mesh.all_gather, p, pod,
                                     tiled=False)
                    for p in payload)
                slab = None
                for i in range(mesh.axis_size(pod)):
                    with span("ps.encode"):
                        part = comp.decode(cfg.compression,
                                           tuple(g[i] for g in gathered))
                    slab = part if slab is None else slab + part
            new_p, new_slots = self._update_slab(
                slab, pflat, mesh, data_axes, state, step, lr_scale)
            return new_p, {"slots": new_slots, "ef": ef, "step": step}

        raise ValueError(cfg.strategy)

    # ------------------------------------------------------------------
    # analytical wire-byte model (used by benchmarks + roofline narrative)
    # ------------------------------------------------------------------
    def modeled_bytes(self, flat_elems: int, n_pod: int, n_data: int) -> dict:
        """Per-device bytes moved per step, by stage (f32 grads).

        "allreduce" here models the paper's *colocated sharded PS* baseline
        (Fig. 3's normalization): every worker ships the full gradient to
        the PS shards and pulls full parameters back, while its own NIC
        simultaneously serves its PS shard's aggregate traffic.  PBox moves
        the collective-theoretic minimum (one RS + one AG) on balanced
        links."""
        G = flat_elems * 4
        nw = n_pod * n_data
        c = self.cfg.compression.wire_bytes_per_elem / 4.0
        pull = self.cfg.pull_dtype is not None and 0.5 or 1.0
        if self.cfg.strategy == "allreduce":
            return {"push": 2 * G + 2 * G * (nw - 1) / nw, "pull": 0.0,
                    "xpod": None}
        if self.cfg.strategy == "pbox":
            s = G * (nw - 1) / nw
            return {"push": s, "pull": s * pull, "xpod": None}
        if self.cfg.strategy == "pbox_hier":
            s = G * (n_data - 1) / n_data  # intra-pod RS + AG
            x = (G / n_data) * 2 * (n_pod - 1) / n_pod * c  # cross-pod AR
            return {"push": s, "pull": s * pull, "xpod": x}
        raise ValueError(self.cfg.strategy)
