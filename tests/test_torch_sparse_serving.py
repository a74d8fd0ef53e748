"""The port's sparse tier under a topology and its hot-row serving
(``SparseReadPlane``) against the JAX tier.

Mirrors the topology and serving cases of tests/test_sparse_tier.py: each
runs on the JAX ``SparseTier`` / ``SparseReadPlane`` and on the port's (on
the CPU) with the same numpy inputs, and holds the tables, the row
versions, every ``SparseStats`` field (rack and core bytes, the ``sim_*``
event-clock floats), every ``SparseReadResult`` (rows bit for bit,
versions, hits, frontend, ``sim_us``) and every ``SparseServeStats`` field
equal; then the JAX test's own assertions run on the port.  The
hypothesis cases are parametrized over fixed seeds.

Beyond the mirror: serving at R = 1, 2 and 3 over 2 racks with a shard
failover and a fabric ``restore`` between reads (the chip's SMOKE sweep
runs the R = 2 case card against CPU), ``zipfian_trace`` equal to JAX's,
an uneven link and core (0.7 µs a chunk, 1:2.5) for the hop-cost product,
and rows served at R = 1 that keep their bits after a round updates the
slabs in place.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from test_torch_serving import assert_stats_same  # noqa: E402

from repro.core import serving as jserving  # noqa: E402
from repro.core import sparse as jsparse  # noqa: E402
from repro.core.chunking import TILE_ELEMS as JAX_TILE  # noqa: E402
from repro.core.chunking import ParamSpace as JaxSpace  # noqa: E402
from repro.core.fabric import LinkModel as JaxLink  # noqa: E402
from repro.core.fabric import PBoxFabric as JaxFabric  # noqa: E402
from repro.core.replication import ShardLost as JaxShardLost  # noqa: E402
from repro.core.topology import NetworkTopology as JaxTopology  # noqa: E402
from repro.optim.optimizers import sgd as jsgd  # noqa: E402
from repro_torch.core import serving as tserving  # noqa: E402
from repro_torch.core import sparse as tsparse  # noqa: E402
from repro_torch.core.chunking import TILE_ELEMS, ParamSpace  # noqa: E402
from repro_torch.core.fabric import LinkModel, PBoxFabric  # noqa: E402
from repro_torch.core.replication import ShardLost  # noqa: E402
from repro_torch.core.topology import NetworkTopology  # noqa: E402
from repro_torch.optim.optimizers import sgd  # noqa: E402

V, D, K = 64, 16, 2
INIT = np.random.default_rng(1805).standard_normal((V, D)).astype(np.float32)
PKGS = (jsparse, tsparse)


def _bits(a):
    if isinstance(a, torch.Tensor):
        a = a.numpy()
    return np.asarray(a, np.float32).view(np.uint32)


def _topo(pkg, **kw):
    return (JaxTopology if pkg is jsparse else NetworkTopology)(**kw)


def _plane_cls(pkg):
    return (jserving if pkg is jsparse else tserving).SparseReadPlane


def make_tier(pkg, num_shards=2, *, racks=0, codec="none", replication=1,
              placement="hash", workers=K, lr=0.1, topo_kw=None, **kw):
    topo = (_topo(pkg, num_workers=max(workers, racks), num_racks=racks,
                  **(topo_kw or {})) if racks else None)
    if pkg is tsparse:
        kw["device"] = "cpu"
    tier = pkg.SparseTier(num_shards=num_shards, num_workers=workers,
                          topology=topo, codec=codec,
                          replication=replication, placement=placement,
                          lr=lr, **kw)
    tier.add_table("t0", INIT)
    return tier


def drive(tier, rounds=3, seed=5, batch=12, workers=K, vocab=V):
    rng = np.random.default_rng(seed)
    to = (torch.from_numpy if isinstance(tier, tsparse.SparseTier)
          else jnp.asarray)
    for _ in range(rounds):
        for w in range(workers):
            ids = rng.integers(0, vocab, size=batch)
            g = rng.standard_normal((batch, D)).astype(np.float32)
            tier.push(w, {"t0": (ids, to(g))})
    return tier


def assert_tier_same(jt, tt):
    assert tt.round == jt.round
    for name in jt.tables:
        np.testing.assert_array_equal(_bits(tt.table(name)),
                                      _bits(jt.table(name)))
        np.testing.assert_array_equal(tt.row_versions(name),
                                      jt.row_versions(name))
    assert dataclasses.asdict(tt.stats) == dataclasses.asdict(jt.stats)
    np.testing.assert_array_equal(tt.chain_racks, jt.chain_racks)
    np.testing.assert_array_equal(tt.home_racks, jt.home_racks)
    assert tt.describe() == jt.describe()


def assert_rows_same(jr, tr):
    np.testing.assert_array_equal(_bits(tr.rows), _bits(jr.rows))
    np.testing.assert_array_equal(tr.versions, jr.versions)
    np.testing.assert_array_equal(tr.hits, jr.hits)
    assert (tr.frontend, tr.sim_us) == (jr.frontend, jr.sim_us)


def assert_plane_same(jp, tp):
    assert_stats_same(jp.stats, tp.stats)
    assert jp.describe() == tp.describe()
    assert [(f.fid, f.rack, f.capacity, list(f.cache)) for f in
            jp.frontends] == [(f.fid, f.rack, f.capacity, list(f.cache))
                              for f in tp.frontends]


def both(scenario):
    return scenario(jsparse), scenario(tsparse)


# ---------------------------------------------------------------------------
# the tier under a topology
# ---------------------------------------------------------------------------
def test_placement_replica_racks_anti_affine():
    def run(pkg):
        topo = _topo(pkg, num_workers=8, num_racks=4)
        kw = {"device": "cpu"} if pkg is tsparse else {}
        tier = pkg.SparseTier(num_shards=4, num_workers=2, topology=topo,
                              replication=3, **kw)
        return tier, topo

    (jt, _), (tier, topo) = both(run)
    np.testing.assert_array_equal(tier.chain_racks, jt.chain_racks)
    for s in range(4):
        assert len(set(int(r) for r in tier.chain_racks[s])) == 3
    np.testing.assert_array_equal(tier.home_racks, topo.home_racks(4))
    assert tier.topology is topo
    with pytest.raises(ValueError, match="topology places 2 workers"):
        tsparse.SparseTier(num_shards=2, num_workers=3, device="cpu",
                           topology=NetworkTopology(num_workers=2,
                                                    num_racks=2))


@pytest.mark.parametrize("codec", ["none", "bf16", "int8"])
@pytest.mark.parametrize("racks", [1, 2, 4])
@pytest.mark.parametrize("shards", [2, 8])
def test_sharded_training_bit_identical_to_single_table(shards, racks,
                                                        codec):
    """The headline invariant under a topology: the port's sharded,
    rack-aware tier == its single-table tier, bitwise, and == the JAX tier
    in every table bit and stats field."""
    jt, tt = (drive(make_tier(pkg, shards, racks=racks, codec=codec))
              for pkg in PKGS)
    assert_tier_same(jt, tt)
    single = drive(make_tier(tsparse, 1, codec=codec))
    np.testing.assert_array_equal(_bits(single.table("t0")),
                                  _bits(tt.table("t0")))
    np.testing.assert_array_equal(single.row_versions("t0"),
                                  tt.row_versions("t0"))
    if racks > 1:
        assert tt.stats.bytes_core_link > 0


@pytest.mark.parametrize("codec,per_row", [
    ("none", 4 * D + 4), ("bf16", 2 * D + 4), ("int8", D + 4 + 4)])
def test_push_wire_bytes_exact(codec, per_row):
    def run(pkg):
        topo = _topo(pkg, num_workers=2, num_racks=2)
        kw = {"device": "cpu"} if pkg is tsparse else {}
        tier = pkg.SparseTier(num_shards=2, num_workers=1, topology=topo,
                              codec=codec, placement="range", **kw)
        tier.add_table("t0", INIT)
        ids = np.array([1, 2, 40, 41, 42])
        rows = np.ones((5, D), np.float32)
        tier.push(0, {"t0": (ids, rows if pkg is jsparse
                             else torch.from_numpy(rows))})
        return tier

    jt, tier = both(run)
    assert_tier_same(jt, tier)
    assert tier.stats.bytes_pushed == 5 * per_row
    assert tier.stats.bytes_rack_link == 2 * per_row
    assert tier.stats.bytes_core_link == 3 * per_row
    assert tier.stats.sim_push_us > 0


def test_lookup_wire_bytes_exact_per_unique_row():
    def run(pkg):
        topo = _topo(pkg, num_workers=2, num_racks=2)
        kw = {"device": "cpu"} if pkg is tsparse else {}
        tier = pkg.SparseTier(num_shards=2, num_workers=2, topology=topo,
                              placement="range", **kw)
        tier.add_table("t0", INIT)
        out = tier.lookup(1, "t0", np.array([1, 1, 1, 40]), np.array([0, 4]))
        return tier, out

    (jt, jout), (tier, out) = both(run)
    assert_tier_same(jt, tier)
    np.testing.assert_array_equal(_bits(out), _bits(jout))
    per_row = 4 * D + 4
    assert tier.stats.rows_pulled == 2
    assert tier.stats.bytes_pulled == 2 * per_row
    assert tier.stats.bytes_rack_link == per_row  # worker 1 sits in rack 1
    assert tier.stats.bytes_core_link == per_row
    assert tier.stats.sim_lookup_us > 0


def test_replication_ships_only_delta_rows():
    def run(pkg):
        topo = _topo(pkg, num_workers=2, num_racks=2)
        kw = {"device": "cpu"} if pkg is tsparse else {}
        tier = pkg.SparseTier(num_shards=2, num_workers=1, topology=topo,
                              replication=2, placement="range", **kw)
        tier.add_table("t0", INIT)
        rows = np.ones((2, D), np.float32)
        tier.push(0, {"t0": (np.array([1, 40]), rows if pkg is jsparse
                             else torch.from_numpy(rows))})
        return tier

    jt, tier = both(run)
    assert_tier_same(jt, tier)
    assert tier.stats.rows_replicated == 2
    assert tier.stats.bytes_replicated == 2 * (4 * D + 4)


def test_uneven_link_and_core_floats_match_jax():
    """wire 0.7 µs a chunk and a 1:2.5 core: every ``_us`` product (bytes
    pro-rated, then scaled by the hop cost) is JAX's, bit for bit."""
    def run(pkg):
        link = (JaxLink if pkg is jsparse else LinkModel)(
            wire_us_per_chunk=0.7)
        tier = make_tier(pkg, 4, racks=2, codec="int8", replication=3,
                         topo_kw={"oversubscription": 2.5},
                         wire_us_per_chunk=link.wire_us_per_chunk,
                         chunk_elems=1000)
        drive(tier, rounds=3)
        tier.lookup(1, "t0", np.arange(0, V, 3), np.array([0, 5, 22]))
        tier.failover(2)
        drive(tier, rounds=1, seed=9)
        plane = _plane_cls(pkg)(tier, num_frontends=2, cache_rows=16)
        res = [plane.read_rows(f, "t0", np.arange(f, V, 2)) for f in (0, 1)]
        return tier, plane, res

    (jt, jp, jres), (tier, plane, res) = both(run)
    assert_tier_same(jt, tier)
    assert_plane_same(jp, plane)
    for a, b in zip(jres, res):
        assert_rows_same(a, b)
    s = tier.stats
    assert s.sim_push_us != round(s.sim_push_us)


def test_failover_every_shard_bit_exact():
    base = drive(make_tier(tsparse, 4, racks=2, replication=2), rounds=4)
    for crash in range(4):
        tiers = []
        for pkg in PKGS:
            tier = make_tier(pkg, 4, racks=2, replication=2)
            drive(tier, rounds=2)
            tier.failover(crash)
            drive(tier, rounds=2, seed=50)
            tiers.append(tier)
        assert_tier_same(*tiers)
        ref = drive(make_tier(tsparse, 4, racks=2, replication=2), rounds=2)
        drive(ref, rounds=2, seed=50)
        np.testing.assert_array_equal(_bits(tiers[1].table("t0")),
                                      _bits(ref.table("t0")))
        assert tiers[1].stats.failovers == 1 == tiers[1].stats.resilvers
    assert base.round == 4


def test_failover_without_replica_raises_shard_lost():
    with pytest.raises(JaxShardLost) as je:
        drive(make_tier(jsparse, 2, racks=2), rounds=1).failover(0)
    with pytest.raises(ShardLost) as e:
        drive(make_tier(tsparse, 2, racks=2), rounds=1).failover(0)
    assert str(e.value) == str(je.value)


# ---------------------------------------------------------------------------
# hot-row serving
# ---------------------------------------------------------------------------
def test_zipfian_trace_matches_jax():
    for args in ((V, 120, 0.0, 0), (V, 200, 1.2, 7), (1000, 500, 0.8, 3)):
        np.testing.assert_array_equal(tserving.zipfian_trace(*args),
                                      jserving.zipfian_trace(*args))
    for bad in ((0, 5, 1.0), (V, -1, 1.0), (V, 5, -1.0)):
        with pytest.raises(ValueError) as e:
            tserving.zipfian_trace(*bad)
        with pytest.raises(ValueError) as je:
            jserving.zipfian_trace(*bad)
        assert str(e.value) == str(je.value)


@pytest.mark.parametrize("seed", [0, 17, 433])
@pytest.mark.parametrize("skew", [0.0, 0.8, 1.2])
def test_cached_reads_bit_identical_to_direct(skew, seed):
    def run(pkg):
        tier = make_tier(pkg, 4, racks=2, replication=2)
        plane = _plane_cls(pkg)(tier, num_frontends=2, cache_rows=24)
        trace = jserving.zipfian_trace(V, 120, skew, seed=seed)
        rng = np.random.default_rng(seed)
        results, direct = [], []
        for step in range(6):
            ids = trace[step * 20:(step + 1) * 20]
            results.append(plane.read_rows(step % 2, "t0", ids))
            direct.append((_bits(tier.table("t0"))[ids].copy(),
                           tier.row_versions("t0")[ids].copy()))
            drive(tier, rounds=1, seed=int(rng.integers(1 << 30)), batch=6)
        return tier, plane, results, direct

    (jt, jp, jres, _), (tier, plane, res, direct) = both(run)
    assert_tier_same(jt, tier)
    assert_plane_same(jp, plane)
    for a, b, (rows, versions) in zip(jres, res, direct):
        assert_rows_same(a, b)
        np.testing.assert_array_equal(_bits(b.rows), rows)
        np.testing.assert_array_equal(b.versions, versions)


def test_row_update_invalidates_exactly_the_updated_rows():
    def run(pkg):
        tier = make_tier(pkg, 2, workers=K)
        plane = _plane_cls(pkg)(tier, cache_rows=V)
        res = [plane.read_rows(0, "t0", np.arange(V)),
               plane.read_rows(0, "t0", np.arange(V))]
        ones = np.ones((2, D), np.float32)
        for w in range(K):
            tier.push(w, {"t0": (np.array([5, 9]), ones if pkg is jsparse
                                 else torch.from_numpy(ones))})
        res.append(plane.read_rows(0, "t0", np.arange(V)))
        return tier, plane, res

    (jt, jp, jres), (tier, plane, res) = both(run)
    assert_tier_same(jt, tier)
    assert_plane_same(jp, plane)
    for a, b in zip(jres, res):
        assert_rows_same(a, b)
    assert res[1].hits.all()
    assert not res[2].hits[5] and not res[2].hits[9]
    assert res[2].hits.sum() == V - 2
    assert plane.stats.stale_rows == 2


def test_hot_cache_lru_eviction_keeps_hot_head():
    def run(pkg):
        tier = make_tier(pkg, 2)
        plane = _plane_cls(pkg)(tier, cache_rows=4)
        res = [plane.read_rows(0, "t0", np.array(ids)) for ids in
               ([0, 1, 2, 3], [0, 1], [50, 51], [0, 1, 2])]
        return plane, res

    (jp, jres), (plane, res) = both(run)
    assert_plane_same(jp, plane)
    for a, b in zip(jres, res):
        assert_rows_same(a, b)
    assert plane.stats.evictions == 3
    assert res[3].hits[0] and res[3].hits[1] and not res[3].hits[2]


def test_serving_reads_never_perturb_training():
    def run(pkg):
        served = make_tier(pkg, 2, racks=2, replication=2)
        plane = _plane_cls(pkg)(served, num_frontends=2, cache_rows=16)
        bare = make_tier(pkg, 2, racks=2, replication=2)
        rng = np.random.default_rng(11)
        res = []
        for r in range(3):
            res.append(plane.read_rows(
                r % 2, "t0", jserving.zipfian_trace(V, 30, 1.0, seed=r)))
            seed = int(rng.integers(1 << 30))
            drive(served, rounds=1, seed=seed)
            drive(bare, rounds=1, seed=seed)
        return served, bare, plane, res

    (js, _, jp, jres), (served, bare, plane, res) = both(run)
    assert_tier_same(js, served)
    assert_plane_same(jp, plane)
    for a, b in zip(jres, res):
        assert_rows_same(a, b)
    np.testing.assert_array_equal(_bits(served.table("t0")),
                                  _bits(bare.table("t0")))
    assert dataclasses.asdict(served.stats) == dataclasses.asdict(bare.stats)


def test_serving_routes_rack_local_replicas():
    def run(pkg, replication, frontends):
        topo = _topo(pkg, num_workers=2, num_racks=2)
        kw = {"device": "cpu"} if pkg is tsparse else {}
        tier = pkg.SparseTier(num_shards=2, num_workers=1, topology=topo,
                              replication=replication, **kw)
        tier.add_table("t0", INIT)
        plane = _plane_cls(pkg)(tier, num_frontends=frontends, cache_rows=V)
        res = [plane.read_rows(f, "t0", np.arange(V))
               for f in range(frontends)]
        routes = [tier.serve_rack(s, r) for s in range(2) for r in range(2)]
        return plane, res, routes

    for replication, frontends in ((3, 2), (2, 1)):
        (jp, jres, jroutes), (plane, res, routes) = (
            run(pkg, replication, frontends) for pkg in PKGS)
        assert_plane_same(jp, plane)
        for a, b in zip(jres, res):
            assert_rows_same(a, b)
        assert routes == jroutes
        if replication == 3:
            assert plane.stats.bytes_refreshed > 0
            assert plane.stats.bytes_core_link == 0
            assert plane.stats.row_misses == 2 * V
        else:
            assert plane.stats.bytes_core_link > 0


def test_serving_invalidate_and_oob():
    def run(pkg):
        tier = make_tier(pkg, 2)
        plane = _plane_cls(pkg)(tier, cache_rows=8)
        plane.read_rows(0, "t0", np.array([1, 2]))
        plane.invalidate()
        res = plane.read_rows(0, "t0", np.array([1, 2]))
        errors = []
        for call in (lambda: plane.read_rows(0, "t0", np.array([V])),
                     lambda: plane.read_rows(5, "t0", np.array([1])),
                     lambda: plane.move_frontend(0, 3)):
            with pytest.raises(ValueError) as e:
                call()
            errors.append(str(e.value))
        return plane, res, errors

    (jp, jres, jerr), (plane, res, err) = both(run)
    assert_plane_same(jp, plane)
    assert_rows_same(jres, res)
    assert err == jerr
    assert not res.hits.any()


def _fabric(pkg, topo, replication=2, shards=2):
    if pkg is jsparse:
        dense = {"w": jnp.zeros((2 * JAX_TILE,), jnp.float32)}
        space = JaxSpace.build(dense, chunk_elems=JAX_TILE)
        return JaxFabric(space, jsgd(0.1), space.flatten(dense),
                         num_shards=shards, num_workers=2, topology=topo,
                         replication=replication)
    dense = {"w": torch.zeros(2 * TILE_ELEMS)}
    space = ParamSpace.build(dense, chunk_elems=TILE_ELEMS)
    return PBoxFabric(space, sgd(0.1), space.flatten(dense), num_shards=shards,
                      num_workers=2, topology=topo, replication=replication,
                      device="cpu")


def test_fabric_attached_tier_inherits_and_fails_over():
    def run(pkg):
        topo = _topo(pkg, num_workers=2, num_racks=2)
        fab = _fabric(pkg, topo)
        kw = {"device": "cpu"} if pkg is tsparse else {}
        tier = pkg.SparseTier(fabric=fab, lr=0.1, **kw)
        tier.add_table("t0", INIT)
        drive(tier, rounds=2)
        before = _bits(tier.table("t0")).copy()
        plane = _plane_cls(pkg)(tier, cache_rows=8)
        res = [plane.read_rows(0, "t0", np.array([1, 2]))]
        snap = fab.snapshot()
        fate = fab.crash_shard(0)
        after = _bits(tier.table("t0")).copy()
        fab.restore(snap)
        res.append(plane.read_rows(0, "t0", np.array([1, 2])))
        return fab, tier, topo, plane, res, fate, before, after

    jout, tout = both(run)
    fab, tier, topo, plane, res, fate, before, after = tout
    assert_tier_same(jout[1], tier)
    assert_plane_same(jout[3], plane)
    for a, b in zip(jout[4], res):
        assert_rows_same(a, b)
    assert tier.num_shards == 2 and tier.replication == 2
    assert tier.topology is topo
    assert fate == "failed_over" and tier.stats.failovers == 1
    np.testing.assert_array_equal(after, before)
    assert not res[1].hits.any()


@pytest.mark.parametrize("replication", [1, 2, 3])
def test_serving_across_failover_and_restore_matches_jax(replication):
    """SparseReadPlane over a 2-rack fabric-attached tier at R = 1-3: reads
    interleaved with rounds, a shard crash (failed over at R >= 2, lost at
    R = 1), a fabric ``restore`` and a reshard between reads; every read
    equals the direct table read and JAX's."""
    def run(pkg):
        topo = _topo(pkg, num_workers=2, num_racks=2)
        fab = _fabric(pkg, topo, replication=replication, shards=4)
        kw = {"device": "cpu"} if pkg is tsparse else {}
        tier = pkg.SparseTier(fabric=fab, lr=0.05, codec="int8", **kw)
        tier.add_table("t0", INIT)
        plane = _plane_cls(pkg)(tier, num_frontends=2, cache_rows=20)
        trace = jserving.zipfian_trace(V, 160, 1.0, seed=replication)
        res, direct, fates = [], [], []

        def read(step):
            ids = trace[step * 20:(step + 1) * 20]
            res.append(plane.read_rows(step % 2, "t0", ids))
            direct.append(_bits(tier.table("t0"))[ids].copy())

        read(0)
        drive(tier, rounds=2)
        snap = fab.snapshot()
        read(1)
        try:
            fates.append(fab.crash_shard(1))
        except (JaxShardLost, ShardLost) as e:
            fates.append(type(e).__name__)
        read(2)
        drive(tier, rounds=1, seed=8)
        read(3)
        fab.restore(snap)
        read(4)
        tier.reshard(2)
        read(5)
        drive(tier, rounds=1, seed=9)
        read(6)
        read(7)
        return tier, plane, res, direct, fates

    (jt, jp, jres, _, jfates), (tier, plane, res, direct, fates) = both(run)
    assert fates == jfates
    assert fates == (["ShardLost"] if replication == 1 else ["failed_over"])
    assert_tier_same(jt, tier)
    assert_plane_same(jp, plane)
    for a, b, rows in zip(jres, res, direct):
        assert_rows_same(a, b)
        np.testing.assert_array_equal(_bits(b.rows), rows)
    assert not res[4].hits.any()  # the restore dropped every cache


def test_served_rows_keep_their_bits_after_in_place_rounds():
    """At R = 1 a round updates the slabs in place; rows a read handed out
    (and the rows its cache keeps) still hold their stamped bits."""
    tier = make_tier(tsparse, 2, racks=2)
    plane = tserving.SparseReadPlane(tier, cache_rows=V)
    first = plane.read_rows(0, "t0", np.arange(V))
    want = _bits(first.rows).copy()
    drive(tier, rounds=2)
    np.testing.assert_array_equal(_bits(first.rows), want)
    again = plane.read_rows(0, "t0", np.arange(V))
    stale = ~again.hits
    assert stale.any() and again.hits.any()
    np.testing.assert_array_equal(_bits(again.rows)[again.hits],
                                  want[again.hits])
    np.testing.assert_array_equal(_bits(again.rows),
                                  _bits(tier.table("t0")))


def test_describe_smoke():
    def run(pkg):
        tier = drive(make_tier(pkg, 2, racks=2, codec="int8",
                               replication=2))
        plane = _plane_cls(pkg)(tier, cache_rows=8)
        res = plane.read_rows(0, "t0", np.array([1, 2, 3]))
        return tier, plane, res

    (jt, jp, jres), (tier, plane, res) = both(run)
    assert_tier_same(jt, tier)
    assert_plane_same(jp, plane)
    assert_rows_same(jres, res)
    assert "SparseTier" in tier.describe()
    assert "SparseReadPlane" in plane.describe()
    assert plane.stats.hit_rate == 0.0


def test_sparse_plane_config_equals_legacy_kwargs():
    def run(pkg):
        tier = make_tier(pkg, 2, racks=2, replication=2)
        cfgmod = (jserving if pkg is jsparse else tserving)
        legacy = cfgmod.SparseReadPlane(tier, num_frontends=2, cache_rows=8,
                                        serve_us_per_read=0.2)
        return legacy.config

    jcfg, tcfg = both(run)
    assert dataclasses.astuple(tcfg) == dataclasses.astuple(jcfg)
    assert tcfg.name == "sparse-serve"
