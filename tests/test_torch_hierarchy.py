"""The port's read-plane tier ladder (``repro_torch.core.hierarchy``)
against the JAX one.

Mirrors the three ladder tests of tests/test_hierarchy.py (:136-192): each
builds the same ``HierarchyConfig`` in either package and holds every
``ReadTier`` (name, latency floor, staleness bound, frontend count,
refresh cap) and every ``select_tier`` answer equal, then runs the JAX
test's own assertions on the port's ladder.  The collectives of that file
(``hierarchical_psum`` and its kin) wait for the SPMD path (ROADMAP queue
1, item 6).
"""
import dataclasses

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core import config as jconfig  # noqa: E402
from repro.core import hierarchy as jhier  # noqa: E402
from repro.core.topology import NetworkTopology as JaxTopology  # noqa: E402
from repro_torch.core import config as tconfig  # noqa: E402
from repro_torch.core.hierarchy import select_tier, tier_ladder  # noqa: E402
from repro_torch.core.topology import NetworkTopology  # noqa: E402


def ladder_cfg(c=tconfig, **kw):
    base = dict(enabled=True, staleness_ladder=(0, 4, 16),
                frontends_per_tier=(1, 2, 3), geo_oversubscription=8.0)
    base.update(kw)
    return c.HierarchyConfig(**base)


def ladders(topo=None, **kw):
    """The port's ladder, held equal to JAX's tier by tier."""
    ttopo = jtopo = None
    if topo is not None:
        ttopo, jtopo = NetworkTopology(**topo), JaxTopology(**topo)
    wire = kw.pop("wire_us_per_chunk", 1.0)
    tiers = tier_ladder(ladder_cfg(**kw), topology=ttopo,
                        wire_us_per_chunk=wire)
    jtiers = jhier.tier_ladder(ladder_cfg(jconfig, **kw), topology=jtopo,
                               wire_us_per_chunk=wire)
    assert [dataclasses.astuple(t) for t in tiers] == \
        [dataclasses.astuple(t) for t in jtiers]
    return tiers, jtiers


def test_tier_ladder_prices_floors_off_hop_cost():
    topo = dict(num_workers=4, num_racks=2, oversubscription=4.0)
    tiers, _ = ladders(topo, wire_us_per_chunk=1.5)
    assert [t.name for t in tiers] == ["rack", "cluster", "xcluster"]
    core = NetworkTopology(**topo).hop_cost(0, 1)
    assert core == 4.0
    assert tiers[2].latency_floor_us == 0.0
    assert tiers[1].latency_floor_us == pytest.approx(1.5 * 8.0)
    assert tiers[0].latency_floor_us == pytest.approx(1.5 * (8.0 + core))
    floors = [t.latency_floor_us for t in tiers]
    assert floors[0] > floors[1] > floors[2]
    assert [t.max_staleness for t in tiers] == [0, 4, 16]
    assert [t.num_frontends for t in tiers] == [1, 2, 3]
    assert tiers[0].refresh_cap is None
    assert tiers[1].refresh_cap == pytest.approx(1.0 / core)
    assert tiers[2].refresh_cap == pytest.approx(1.0 / (core * 8.0))
    # an uneven core and wire: the floats are still JAX's, bit for bit
    ladders(dict(num_workers=6, num_racks=3, oversubscription=2.7),
            wire_us_per_chunk=0.7, geo_oversubscription=3.3)


def test_tier_ladder_without_topology_uses_unit_core():
    tiers, _ = ladders(geo_oversubscription=2.0)
    assert tiers[0].latency_floor_us == pytest.approx(2.0 + 1.0)
    assert tiers[1].latency_floor_us == pytest.approx(2.0)
    assert tiers[2].latency_floor_us == 0.0
    two, _ = ladders(staleness_ladder=(0, 8), frontends_per_tier=(1, 1))
    assert [t.name for t in two] == ["rack", "xcluster"]
    assert two[0].latency_floor_us == pytest.approx(8.0)
    four, _ = ladders(staleness_ladder=(0, 2, 4, 8),
                      frontends_per_tier=(1, 1, 1, 1))
    assert [t.name for t in four] == ["rack", "cluster1", "cluster2",
                                      "xcluster"]


def test_select_tier_routes_to_nearest_satisfying_bound():
    tiers, jtiers = ladders()
    for req in (0, 3, 4, 15, 16, 10 ** 6):
        assert select_tier(tiers, req) == jhier.select_tier(jtiers, req)
    assert select_tier(tiers, 0) == 0
    assert select_tier(tiers, 3) == 0
    assert select_tier(tiers, 4) == 1
    assert select_tier(tiers, 15) == 1
    assert select_tier(tiers, 16) == 2
    assert select_tier(tiers, 10 ** 6) == 2
    for bad in ((tiers, -1), (tiers[1:], 0)):
        with pytest.raises(ValueError) as e:
            select_tier(*bad)
        with pytest.raises(ValueError) as je:
            jhier.select_tier(jtiers if bad[0] is tiers else jtiers[1:],
                              bad[1])
        assert str(e.value) == str(je.value)
