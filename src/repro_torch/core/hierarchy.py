"""The geo read-plane tier ladder (torch counterpart of the serving half of
``repro/core/hierarchy.py``).

The paper's §3 insight (aggregate inside the rack at full bisection
bandwidth, forward one stream upward) read in the serving direction gives
the hierarchical read plane (``core/serving.py::HierarchicalReadPlane``):
production traffic arrives from *outside* the datacenter, so the tier
closest to the client (cross-cluster / edge) is the cheapest to reach but
caches the stalest bits, while the rack tier, co-racked with the serving
replicas, is freshest but a WAN + core transit away.  ``ReadTier`` prices
each tier's client latency floor off ``NetworkTopology.hop_cost`` (the core
hop) plus a WAN factor, and ``select_tier`` routes a read to the **nearest
tier that satisfies its staleness bound**.

Plain Python: the same floats as the JAX package's, operation for
operation.  The JAX module's SPMD collectives (``hierarchical_psum``,
``hierarchical_pmean``, ``two_level_all_gather``) belong to the SPMD path,
which is not ported yet.
"""
from __future__ import annotations

import dataclasses


# ---------------------------------------------------------------------------
# the geo read-plane ladder (consumed by core/serving.HierarchicalReadPlane)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ReadTier:
    """One serving tier of the geo ladder.

    ``latency_floor_us`` is the event-clock transit a client pays to
    reach this tier's frontends (0 for the client-local cross-cluster
    tier, WAN + core for the rack tier); ``max_staleness`` the cache
    bound its frontends serve under; ``refresh_cap`` the bandwidth-cap
    floor its refresh streams pay back toward the fabric (``None`` =
    rack-local, uncapped)."""

    name: str
    latency_floor_us: float
    max_staleness: int
    num_frontends: int
    refresh_cap: float | None = None


def tier_ladder(config, *, topology=None, wire_us_per_chunk: float = 1.0,
                ) -> tuple[ReadTier, ...]:
    """Materialize a ``HierarchyConfig`` into priced ``ReadTier``s.

    Tier 0 is the rack tier (freshest: bound 0, co-racked with the
    serving replicas), the last tier is cross-cluster (stalest bound,
    client-local).  Client latency floors are priced off the topology's
    own ``hop_cost`` for the core hop and ``geo_oversubscription`` for
    the WAN hop, both in units of ``wire_us_per_chunk``:

      floor(last)    = 0                      (the client's own region)
      floor(middle)  = wire * geo             (one WAN hop inward)
      floor(0)       = wire * (geo + core)    (WAN, then the core)

    Refresh streams pay the same distances in the other direction: the
    rack tier refreshes rack-locally (no cap), middle tiers across the
    core (cap 1/core), the outermost across core + WAN (cap
    1/(core*geo))."""
    ladder = tuple(config.staleness_ladder)
    fronts = tuple(config.frontends_per_tier)
    geo = float(config.geo_oversubscription)
    wire = float(wire_us_per_chunk)
    if topology is not None and topology.num_racks > 1:
        core = float(topology.hop_cost(0, 1))  # the oversubscribed core
    else:
        core = 1.0
    n = len(ladder)
    tiers = []
    for i, (bound, nf) in enumerate(zip(ladder, fronts)):
        if i == 0:
            name = "rack"
        elif i == n - 1:
            name = "xcluster"
        else:
            name = "cluster" if n == 3 else f"cluster{i}"
        if i == n - 1:
            floor = 0.0
        else:
            floor = wire * (geo + core * (n - 2 - i))
        if i == 0:
            dist = 1.0  # refreshes ride the rack-local full-bisection tier
        elif i == n - 1:
            dist = core * geo  # core, then the WAN
        else:
            dist = core
        cap = None if dist <= 1.0 else 1.0 / dist
        tiers.append(ReadTier(name=name, latency_floor_us=floor,
                              max_staleness=int(bound), num_frontends=int(nf),
                              refresh_cap=cap))
    return tuple(tiers)


def select_tier(tiers, staleness_req: int) -> int:
    """The nearest tier satisfying ``staleness_req``: among tiers whose
    cache bound is within the request's staleness requirement, the one
    with the lowest client latency floor (ties break toward the looser
    bound, then the lower index — all deterministic).  Tier 0 bounds
    staleness at 0, so every requirement is routable."""
    if staleness_req < 0:
        raise ValueError("staleness_req must be >= 0")
    eligible = [(t.latency_floor_us, -t.max_staleness, i)
                for i, t in enumerate(tiers)
                if t.max_staleness <= staleness_req]
    if not eligible:
        raise ValueError(
            f"no tier satisfies staleness_req={staleness_req} "
            f"(bounds: {[t.max_staleness for t in tiers]})")
    return min(eligible)[2]
