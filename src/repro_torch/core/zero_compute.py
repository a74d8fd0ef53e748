"""ZeroComputeEngine: the paper's Fig. 4 limit study (torch counterpart of
``repro/core/zero_compute.py``).

Simulates infinitely fast computation by running *only* the parameter
exchange: a step takes synthetic per-worker gradients and performs
push -> aggregate+optimize -> pull over the mesh's process groups.  Used to
find the exchange-only throughput ceiling and to time the collectives.

The JAX step is a jitted ``shard_map`` over global arrays; here each rank
calls the step on its own pieces, so ``init_zero_compute_state`` returns
this rank's state (its owned slab of the slots and residual), not JAX's
global view.  The step consumes ``pflat`` and ``state``, as the JAX one
donates them.
"""
from __future__ import annotations

import torch

from repro_torch.core.exchange import PSExchange
from repro_torch.device import resolve_device


def make_zero_compute_step(mesh, exchange: PSExchange, flat_elems: int):
    """Returns step(pflat, gflat, state) -> (pflat, state), per rank.

    pflat/gflat are (flat_elems,) on every rank (each worker has its own
    gradient values in practice; equal ones are only a stand-in: the
    collective pattern and byte counts are identical)."""

    def step(pflat, gflat, state):
        if pflat.shape != (flat_elems,) or gflat.shape != (flat_elems,):
            raise ValueError(
                f"pflat and gflat must be ({flat_elems},), got "
                f"{tuple(pflat.shape)} and {tuple(gflat.shape)}")
        return exchange.device_update(gflat, pflat, state, mesh=mesh)

    return step


def init_zero_compute_state(mesh, exchange: PSExchange, flat_elems: int, *,
                            device: torch.device | str | None = None) -> dict:
    """This rank's initial state for ``make_zero_compute_step``: zero slots
    (and residual, when the codec keeps one) over its owned slab, on
    ``device`` (the card unless the caller passes another)."""
    n_owner = 1
    for a in exchange.owner_axes:
        n_owner *= mesh.shape[a]
    slab = (flat_elems if exchange.cfg.strategy == "allreduce"
            else flat_elems // n_owner)
    dev = resolve_device(device)
    slots = tuple(
        torch.zeros((slab,), dtype=torch.float32, device=dev)
        for _ in range(exchange.spec.num_state_slots)
    )
    ef = None
    c = exchange.cfg.compression
    if c.codec != "none" and c.error_feedback:
        ef = torch.zeros((slab,), dtype=torch.float32, device=dev)
    return {"slots": slots, "ef": ef,
            "step": torch.zeros((), dtype=torch.int32, device=dev)}
