"""Trace-driven serving workloads: diurnal, bursty, per-tenant, replayable
(the port's copy of ``repro/core/workload.py``: numpy only, so the same
config and seed give the JAX package's trace exactly).

The read plane's original load generator (benchmarks/serve_load.py) was a
flat open loop — one tenant, fixed interarrival, no SLOs.  Production
parameter-serving traffic looks nothing like that: GaDei's
training-as-a-service deployment (arXiv:1611.06213) runs many tenants'
diurnal and bursty mixes against one store, and closed-loop clients (each
user waits for a response, thinks, then asks again) behave qualitatively
differently from open-loop floods under overload.  This module is the
declarative workload tier that feeds the SLO serving machinery
(core/serving.py):

  ``Request``        one arrival: event-clock time, tenant class, batch
                     hint, staleness requirement.
  ``WorkloadTrace``  a fully materialized, seeded draw of a
                     ``WorkloadConfig`` (core/config.py): open-loop
                     arrivals as a sorted request list, closed-loop
                     tenants as pre-drawn think-time tables.  Replayable
                     like a ``FaultPlan``: randomness happens exactly
                     once, in ``generate_trace(config, seed)``; replaying
                     a trace — or its ``to_json``/``from_json``
                     round-trip — against the same plane yields
                     bit-identical serving stats.
  ``ClosedLoopClient``  one closed-loop client's pacing state: request
                     k+1 arrives at completion(k) + think[k].  Think
                     times are drawn at generate time, so the loop is a
                     pure function of the service times it observes.

Arrival shapes (all per tenant, composable):

  * ``open``     exact fixed spacing — request i at ``i * interarrival``
                 (the legacy serve_load generator, byte-for-byte).
  * ``poisson``  exponential interarrivals with the same mean.
  * ``mmpp``     two-state Markov-modulated Poisson — the bursty shape:
                 a hi state multiplies the rate by ``burst_factor``,
                 state dwells are exponential with mean
                 ``burst_dwell_us``.
  * diurnal modulation — rate(t) scaled by a sinusoid (the daily cycle
    compressed onto the event clock); deterministic closed form.
  * flash crowds — the rate multiplies by ``magnitude`` inside a window;
    the overload the admission controller (core/serving.py) sheds.
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Iterable

import numpy as np

from repro_torch.core.config import TenantLoadConfig, WorkloadConfig


@dataclasses.dataclass(frozen=True)
class Request:
    """One workload arrival.

    ``n`` is the batch-size hint (requests the client bundles into one
    plane visit); ``staleness_req`` the freshness bound the read must
    satisfy — the hierarchy tier selector's routing key and the SLO
    staleness check both read it."""

    arrival_us: float
    tenant: str
    n: int = 1
    staleness_req: int = 0

    def __post_init__(self):
        if self.arrival_us < 0.0:
            raise ValueError("arrival_us must be >= 0")
        if self.n < 1:
            raise ValueError("request batch hint must be >= 1")
        if self.staleness_req < 0:
            raise ValueError("staleness_req must be >= 0")

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def rate_factor(tenant: TenantLoadConfig, t: float) -> float:
    """The deterministic rate modulation at event-clock time ``t``:
    diurnal sinusoid times flash-crowd window, both closed form — the
    same factor for the same (config, t) on every host."""
    factor = 1.0
    d = tenant.diurnal
    if d.enabled:
        factor *= 1.0 + d.amplitude * math.sin(
            2.0 * math.pi * (t / d.period_us + d.phase))
    f = tenant.flash
    if f.enabled and f.at_us <= t < f.at_us + f.duration_us:
        factor *= f.magnitude
    return factor


def _open_arrivals(tenant: TenantLoadConfig) -> list[float]:
    """Fixed-spacing arrivals.  Unmodulated, this is exactly
    ``i * interarrival_us`` — the legacy serve_load generator; with
    diurnal/flash modulation the spacing compresses by the closed-form
    rate factor (still zero randomness)."""
    base = tenant.arrival.interarrival_us
    modulated = tenant.diurnal.enabled or tenant.flash.enabled
    out: list[float] = []
    t = 0.0
    for i in range(tenant.n_requests):
        if not modulated:
            t = i * base  # byte-for-byte the legacy schedule
        out.append(t)
        if modulated:
            t += base / rate_factor(tenant, t)
    return out


def _poisson_arrivals(tenant: TenantLoadConfig,
                      rng: np.random.Generator) -> list[float]:
    """Exponential interarrivals, rate modulated by the closed form."""
    base = tenant.arrival.interarrival_us
    out: list[float] = []
    t = 0.0
    for _ in range(tenant.n_requests):
        t += float(rng.exponential(base / rate_factor(tenant, t)))
        out.append(t)
    return out


def _mmpp_arrivals(tenant: TenantLoadConfig,
                   rng: np.random.Generator) -> list[float]:
    """Two-state MMPP: lo state at the base rate, hi state at
    ``burst_factor`` times it; exponential state dwells of mean
    ``burst_dwell_us``.  State switches are walked arrival-by-arrival so
    an arrival drawn past a switch is re-drawn from the new state's rate
    at the switch point (the standard thinning-free construction)."""
    arr = tenant.arrival
    base = arr.interarrival_us
    out: list[float] = []
    t = 0.0
    hi = False
    next_switch = t + float(rng.exponential(arr.burst_dwell_us))
    while len(out) < tenant.n_requests:
        mult = arr.burst_factor if hi else 1.0
        gap = float(rng.exponential(base / (mult * rate_factor(tenant, t))))
        if t + gap >= next_switch:
            # the state flipped before this arrival landed: advance to
            # the switch and redraw under the new state's rate
            t = next_switch
            hi = not hi
            next_switch = t + float(rng.exponential(arr.burst_dwell_us))
            continue
        t += gap
        out.append(t)
    return out


class WorkloadTrace:
    """One seeded draw of a ``WorkloadConfig``.

    ``requests`` holds every open-loop arrival, globally sorted by
    arrival time (ties keep tenant declaration order — part of the
    deterministic contract); ``think`` maps each closed-loop tenant to
    its ``(clients, requests_per_client)`` think-time table.  Runtime
    replay is pure lookup — the trace carries every random draw."""

    def __init__(self, requests: Iterable[Request] = (),
                 think: dict[str, np.ndarray] | None = None,
                 staleness_req: dict[str, int] | None = None):
        reqs = list(requests)
        for r in reqs:
            if not isinstance(r, Request):
                raise TypeError(f"not a Request: {r!r}")
        # stable sort: ties fire in list order (tenant declaration order)
        self.requests: tuple[Request, ...] = tuple(
            sorted(reqs, key=lambda r: r.arrival_us))
        self.think: dict[str, np.ndarray] = {
            name: np.asarray(arr, dtype=np.float64)
            for name, arr in (think or {}).items()
        }
        self.staleness_req: dict[str, int] = dict(staleness_req or {})

    def __len__(self) -> int:
        return len(self.requests)

    @property
    def duration_us(self) -> float:
        """The last open-loop arrival (0.0 for pure closed-loop traces)."""
        return self.requests[-1].arrival_us if self.requests else 0.0

    def clients(self, tenant: str) -> list["ClosedLoopClient"]:
        """Fresh closed-loop clients for ``tenant``, one per think-table
        row — each replay starts from the same pre-drawn think times."""
        if tenant not in self.think:
            raise KeyError(f"tenant {tenant!r} has no closed-loop clients")
        req = self.staleness_req.get(tenant, 0)
        return [
            ClosedLoopClient(tenant=tenant, client=c,
                             think_us=self.think[tenant][c],
                             staleness_req=req)
            for c in range(self.think[tenant].shape[0])
        ]

    def to_json(self) -> dict:
        return {
            "schema": 1,
            "requests": [r.to_json() for r in self.requests],
            "think": {k: v.tolist() for k, v in self.think.items()},
            "staleness_req": dict(self.staleness_req),
        }

    @classmethod
    def from_json(cls, doc: dict | str) -> "WorkloadTrace":
        if isinstance(doc, str):
            doc = json.loads(doc)
        if doc.get("schema") != 1:
            raise ValueError("not a WorkloadTrace JSON document")
        return cls(
            (Request(**r) for r in doc["requests"]),
            {k: np.asarray(v) for k, v in doc.get("think", {}).items()},
            {k: int(v) for k, v in doc.get("staleness_req", {}).items()},
        )

    def describe(self) -> str:
        per_tenant: dict[str, int] = {}
        for r in self.requests:
            per_tenant[r.tenant] = per_tenant.get(r.tenant, 0) + 1
        parts = [f"{k}={v}" for k, v in sorted(per_tenant.items())]
        parts += [f"{k}=closed({v.shape[0]}x{v.shape[1]})"
                  for k, v in sorted(self.think.items())]
        return (f"WorkloadTrace: {len(self.requests)} open-loop arrivals "
                f"over {self.duration_us:.1f}us ({', '.join(parts)})")


@dataclasses.dataclass
class ClosedLoopClient:
    """One closed-loop client's pacing state.

    The client has exactly ``len(think_us)`` requests; request 0 arrives
    after the initial think (``think_us[0]`` from t=0), and request k+1
    arrives at ``completion(k) + think_us[k+1]``.  All think times were
    drawn at trace-generation time, so two replays observing the same
    completions produce bit-identical arrivals."""

    tenant: str
    client: int
    think_us: np.ndarray
    staleness_req: int = 0
    issued: int = 0
    next_at: float = dataclasses.field(init=False)

    def __post_init__(self):
        self.think_us = np.asarray(self.think_us, dtype=np.float64)
        self.next_at = float(self.think_us[0]) if len(self.think_us) else 0.0

    @property
    def done(self) -> bool:
        return self.issued >= len(self.think_us)

    def issue(self) -> Request:
        """The request this client is about to send (at ``next_at``)."""
        if self.done:
            raise RuntimeError(
                f"client {self.tenant}/{self.client} has no requests left")
        return Request(self.next_at, self.tenant, 1, self.staleness_req)

    def completed(self, finish_us: float) -> None:
        """Record the in-flight request's completion (or shed) time and
        schedule the next arrival after the pre-drawn think time."""
        if self.done:
            raise RuntimeError(
                f"client {self.tenant}/{self.client} completed with no "
                "request in flight")
        self.issued += 1
        if not self.done:
            self.next_at = float(finish_us) + float(self.think_us[self.issued])


def generate_trace(config: WorkloadConfig, seed: int) -> WorkloadTrace:
    """Draw a workload trace once, with all randomness keyed on
    ``(seed, tenant index)`` — adding a tenant to the config never
    perturbs another tenant's arrivals, and the same (config, seed)
    always yields the same trace on every host."""
    config.validate()
    requests: list[Request] = []
    think: dict[str, np.ndarray] = {}
    staleness: dict[str, int] = {}
    for idx, tenant in enumerate(config.tenants):
        rng = np.random.default_rng((seed, idx))
        if tenant.clients > 0:
            if tenant.think_us > 0.0:
                tbl = rng.exponential(
                    tenant.think_us,
                    size=(tenant.clients, tenant.requests_per_client))
            else:
                tbl = np.zeros(
                    (tenant.clients, tenant.requests_per_client))
            think[tenant.name] = tbl
            staleness[tenant.name] = tenant.staleness_req
            continue
        proc = tenant.arrival.process
        if proc == "open":
            arrivals = _open_arrivals(tenant)
        elif proc == "poisson":
            arrivals = _poisson_arrivals(tenant, rng)
        else:  # "mmpp" (validate() pinned the set)
            arrivals = _mmpp_arrivals(tenant, rng)
        requests.extend(
            Request(t, tenant.name, 1, tenant.staleness_req)
            for t in arrivals)
    return WorkloadTrace(requests, think, staleness)
