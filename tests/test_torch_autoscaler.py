"""The port's closed-loop autoscaler (``repro_torch.runtime.autoscaler``)
against the JAX one, bitwise.

Mirrors tests/test_autoscaler.py test for test: every scenario runs once on
the JAX package and once on the port (on the CPU), with the same quadratic
job (workers minimize ``||w - t_w||^2``; the gradient ``2 * (w - t_w)`` is
one f32 subtract and one multiply in either package) and the same numpy
sparse pushes.  Inside each package the JAX test's own assertions hold
(the autoscaled run equals its undisturbed twin); across the packages
every case holds the autoscaled fabric equal bit for bit (params,
optimizer state, residuals, every ``ServerStats`` / ``ShardStats`` field
with the event clock's ``sim_*`` floats, ``export_fault_trace()``, chunk
ownership and chain racks: ``assert_fault_same``), the ``ScaleEvent`` list
(round, kind, detail), ``telemetry()`` key for key and float for float,
``describe()``, the read planes' stats and reads, and the sparse tiers'
tables, row versions and ``SparseStats``.

Beyond the mirror: the ``tenant_shares`` lever routed through ``shared=``
on a ``MultiJobFabric`` (the box compared with ``assert_box_same``), and a
sparse autoscaled run whose plan carries a solved row map from a Zipf row
load.  ``test_chaos_soak_autoscale_under_faults`` keeps the ``slow`` mark
the JAX test carries.
"""
import dataclasses
import os
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import test_torch_tenancy as tenancy  # noqa: E402
from test_torch_replication import assert_fault_same  # noqa: E402
from test_torch_serving import assert_stats_same, bits, quad_setup  # noqa: E402

from repro.core import placement as jplacement  # noqa: E402
from repro.core import serving as jserving  # noqa: E402
from repro.core import sparse as jsparse  # noqa: E402
from repro.core.chunking import TILE_ELEMS as JAX_TILE  # noqa: E402
from repro.core.chunking import ParamSpace as JaxSpace  # noqa: E402
from repro.core.compression import CompressionConfig as JaxCompression  # noqa: E402
from repro.core.fabric import PBoxFabric as JaxFabric  # noqa: E402
from repro.core.fabric import WorkerHarness as JaxHarness  # noqa: E402
from repro.core.replication import FaultEvent as JaxEvent  # noqa: E402
from repro.core.replication import FaultPlan as JaxFaultPlan  # noqa: E402
from repro.core.topology import NetworkTopology as JaxTopology  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro.runtime import autoscaler as jauto  # noqa: E402
from repro.runtime import straggler as jstraggler  # noqa: E402
from repro_torch.core import placement as tplacement  # noqa: E402
from repro_torch.core import serving as tserving  # noqa: E402
from repro_torch.core import sparse as tsparse  # noqa: E402
from repro_torch.core.chunking import TILE_ELEMS, ParamSpace  # noqa: E402
from repro_torch.core.compression import CompressionConfig  # noqa: E402
from repro_torch.core.fabric import PBoxFabric, WorkerHarness  # noqa: E402
from repro_torch.core.replication import FaultEvent, FaultPlan  # noqa: E402
from repro_torch.core.topology import NetworkTopology  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402
from repro_torch.runtime import autoscaler as tauto  # noqa: E402
from repro_torch.runtime import straggler as tstraggler  # noqa: E402

K = 4
V, D = 64, 8

# one namespace per package: the same scenario code drives either
JAX = types.SimpleNamespace(
    name="jax", space=JaxSpace, tile=JAX_TILE, fabric=JaxFabric,
    harness=JaxHarness, topo=JaxTopology, comp=JaxCompression, opt=jopt,
    sv=jserving, sparse=jsparse, pl=jplacement, auto=jauto,
    straggler=jstraggler, event=JaxEvent, faults=JaxFaultPlan, kw={},
    rows=jnp.asarray, zeros=lambda n: jnp.zeros((n,)),
    full=lambda n, v: jnp.full((n,), v), arange=lambda n: jnp.arange(float(n)))
PORT = types.SimpleNamespace(
    name="port", space=ParamSpace, tile=TILE_ELEMS, fabric=PBoxFabric,
    harness=WorkerHarness, topo=NetworkTopology, comp=CompressionConfig,
    opt=topt, sv=tserving, sparse=tsparse, pl=tplacement, auto=tauto,
    straggler=tstraggler, event=FaultEvent, faults=FaultPlan,
    kw={"device": "cpu"}, rows=torch.from_numpy,
    zeros=lambda n: torch.zeros(n), full=lambda n, v: torch.full((n,), v),
    arange=lambda n: torch.arange(n, dtype=torch.float32))


def both(scenario):
    """``scenario(pkg)`` on the JAX package and on the port."""
    return scenario(JAX), scenario(PORT)


def build_stack(pkg, *, num_shards=2, num_racks=2, replication=2,
                codec="none", num_frontends=2, fault_plan=None):
    params, grad_fn = quad_setup(pkg)
    space = pkg.space.build(params, chunk_elems=pkg.tile)
    extra = {} if fault_plan is None else {"fault_plan": fault_plan}
    fab = pkg.fabric(
        space, pkg.opt.momentum(0.05, 0.9), space.flatten(params),
        num_workers=K, num_shards=num_shards, replication=replication,
        topology=pkg.topo(num_workers=K, num_racks=num_racks),
        compression=pkg.comp(codec=codec), **extra, **pkg.kw)
    h = pkg.harness(fab, grad_fn, lambda w, s: w)
    plane = (pkg.sv.ReadPlane(fab, num_frontends=num_frontends)
             if num_frontends else None)
    return fab, h, plane


def perturb_plan(base, num_racks):
    """A target plan that re-homes shard 0's whole chain and moves
    frontend 0: the two non-reshard placement levers."""
    rr = np.asarray(base.replica_racks).copy()
    rr[0] = (rr[0] + 1) % num_racks
    fe = list(base.frontend_racks)
    if fe:
        fe[0] = (fe[0] + 1) % num_racks
    return base.replace(replica_racks=rr, frontend_racks=tuple(fe),
                        origin="solved")


def events_of(auto_or_events):
    events = getattr(auto_or_events, "events", auto_or_events)
    return [(e.round, e.kind, e.detail) for e in events]


def assert_telemetry_same(jt, tt):
    """Key for key, float for float (arrays element for element)."""
    assert list(jt) == list(tt)
    for key, a in jt.items():
        b = tt[key]
        if isinstance(a, np.ndarray):
            assert isinstance(b, np.ndarray) and a.dtype == b.dtype, key
            np.testing.assert_array_equal(a, b)
        else:
            assert type(a) is type(b) and a == b, key


def telemetry_or_error(auto):
    """``telemetry()``, or the error it raises: the JAX loop reads SLO
    fields a ``SparseReadPlane``'s stats do not carry, and the port fails
    alike."""
    try:
        return auto.telemetry()
    except AttributeError as e:
        return f"AttributeError: {e}"


def assert_auto_same(ja, ta):
    assert events_of(ja) == events_of(ta)
    jt, tt = telemetry_or_error(ja), telemetry_or_error(ta)
    if isinstance(jt, str):
        assert tt == jt
    else:
        assert_telemetry_same(jt, tt)
    assert ja.describe() == ta.describe()
    assert_fault_same(ja.fabric, ta.fabric)
    for jp, tp in zip(ja.planes, ta.planes):
        assert_stats_same(jp.stats, tp.stats)
        assert [fe.rack for fe in jp.frontends] == \
            [fe.rack for fe in tp.frontends]


def assert_tier_same(jt, tt):
    np.testing.assert_array_equal(bits(jt.table("t0")), bits(tt.table("t0")))
    np.testing.assert_array_equal(jt.row_versions("t0"),
                                  tt.row_versions("t0"))
    assert dataclasses.asdict(jt.stats) == dataclasses.asdict(tt.stats)
    assert jt.describe() == tt.describe()
    for name, t in jt.tables.items():
        np.testing.assert_array_equal(t.placement.owner,
                                      tt.tables[name].placement.owner)


# ---------------------------------------------------------------------------
# the headline closed-loop invariant (dense)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("codec", ["none", "int8"])
@pytest.mark.parametrize("num_racks", [1, 2, 4])
@pytest.mark.parametrize("num_shards,target", [(1, 2), (2, 8), (8, 2)])
def test_autoscaled_dense_run_bit_identical(num_shards, target, num_racks,
                                            codec):
    """Mid-run: a replica re-placement + a frontend move (racks >= 2),
    then a shard-count change; final params equal the undisturbed twin's
    in each package, and the port's autoscaled run equals JAX's."""
    def run(pkg):
        fab_a, h_a, _ = build_stack(pkg, num_shards=num_shards,
                                    num_racks=num_racks, codec=codec)
        fab_b, h_b, plane_b = build_stack(pkg, num_shards=num_shards,
                                          num_racks=num_racks, codec=codec)
        auto = pkg.auto.Autoscaler(fab_b, policy=pkg.auto.AutoscalerPolicy(
            min_shards=1, max_shards=8, cooldown_rounds=0,
            solve_placement=False), planes=[plane_b])
        h_a.run(2)
        h_b.run(2)
        events = auto.apply_plan(perturb_plan(
            pkg.pl.current_plan(fab_b, planes=[plane_b]), num_racks))
        if num_racks > 1:
            kinds = {e.kind for e in events}
            assert "replica_racks" in kinds and "frontend_move" in kinds
            assert fab_b.stats.replica_moves >= 1
            assert plane_b.stats.frontend_moves >= 1
        h_a.run(4)
        h_b.run(4)
        auto.apply_delta(pkg.pl.PlanDelta(kind="shard_count",
                                          new_shards=target))
        assert fab_b.num_shards == target
        assert fab_b.stats.rescales == 1
        h_a.run(6)
        h_b.run(6)
        np.testing.assert_array_equal(bits(fab_a.params), bits(fab_b.params))
        # serving still reads the exact trained bits through moved frontends
        read = plane_b.read(0)
        np.testing.assert_array_equal(bits(read.flat), bits(fab_b.params))
        return auto, read

    (ja, jread), (ta, tread) = both(run)
    assert_auto_same(ja, ta)
    np.testing.assert_array_equal(bits(jread.flat), bits(tread.flat))
    assert (jread.version, jread.frontend, jread.sim_us) == \
        (tread.version, tread.frontend, tread.sim_us)


def test_closed_loop_scale_up_from_busy_telemetry():
    """The loop itself (no manual deltas): a zero up-threshold makes
    every decision tick double the engine count until max_shards, driven
    purely by the event-clock busy signal, and bits never move."""
    def run(pkg):
        fab_a, h_a, _ = build_stack(pkg, num_shards=1, num_racks=2)
        fab_b, h_b, _ = build_stack(pkg, num_shards=1, num_racks=2)
        auto = pkg.auto.Autoscaler(fab_b, policy=pkg.auto.AutoscalerPolicy(
            min_shards=1, max_shards=4, scale_up_busy_us=0.0,
            scale_down_busy_us=0.0, cooldown_rounds=1,
            solve_placement=False))
        teles = []
        for i in range(4):
            h_a.run(i + 1)
            h_b.run(i + 1)
            teles.append(auto.telemetry())
            auto.step()
        assert fab_b.num_shards == 4
        assert fab_b.stats.rescales == 2  # 1 -> 2 -> 4, then capped
        assert [e.kind for e in auto.events] == ["reshard", "reshard"]
        np.testing.assert_array_equal(bits(fab_a.params), bits(fab_b.params))
        return auto, teles

    (ja, jteles), (ta, tteles) = both(run)
    assert_auto_same(ja, ta)
    for jt, tt in zip(jteles, tteles):
        assert_telemetry_same(jt, tt)


def test_closed_loop_scale_down_when_idle():
    def run(pkg):
        fab, h, _ = build_stack(pkg, num_shards=8, num_racks=2)
        auto = pkg.auto.Autoscaler(fab, policy=pkg.auto.AutoscalerPolicy(
            min_shards=2, max_shards=8, scale_up_busy_us=1e12,
            scale_down_busy_us=1e12, cooldown_rounds=0,
            solve_placement=False))
        h.run(1)
        auto.step()
        assert fab.num_shards == 4  # halved, not slammed to min
        auto.step()
        assert fab.num_shards == 2
        auto.step()
        assert fab.num_shards == 2  # floored at min_shards
        h.run(3)
        return auto

    assert_auto_same(*both(run))


def test_straggler_proposals_ride_the_delta_path():
    """ShardRebalancer.propose() -> Autoscaler -> apply_plan_delta drains
    the slow shard exactly like the self-applying loop."""
    def run(pkg):
        fab_a, h_a, _ = build_stack(pkg, num_shards=4, num_racks=2)
        fab_b, h_b, _ = build_stack(pkg, num_shards=4, num_racks=2)
        reb_a = pkg.straggler.ShardRebalancer(fab_a, cooldown=0)
        reb_b = pkg.straggler.ShardRebalancer(fab_b, cooldown=0)
        auto = pkg.auto.Autoscaler(
            fab_b, rebalancer=reb_b,
            policy=pkg.auto.AutoscalerPolicy(solve_placement=False))
        h_a.run(2)
        h_b.run(2)
        for _ in range(25):
            for reb in (reb_a, reb_b):
                reb.record(0, 10.0)
                for s in range(1, 4):
                    reb.record(s, 0.1)
        legacy = reb_a.maybe_rebalance()  # the self-applying path
        events = auto.step()  # the delta path
        assert legacy == [0]
        assert [e.kind for e in events] == ["chunk_moves"]
        assert fab_b.shards[0].num_chunks == 0
        np.testing.assert_array_equal(fab_a.chunk_owner, fab_b.chunk_owner)
        assert np.asarray(reb_b.speeds()).shape == (4,)
        # cooldown advanced on the delta path too
        assert reb_b.propose() is None or reb_b.cooldown == 0
        h_a.run(4)
        h_b.run(4)
        np.testing.assert_array_equal(bits(fab_a.params), bits(fab_b.params))
        return auto

    assert_auto_same(*both(run))


def test_resolve_placement_is_deterministic_and_neutral():
    """A full re-solve applied mid-run: same seed => same events; bits
    unchanged either way; the port's events equal JAX's."""
    def run(pkg):
        runs = []
        for _ in range(2):
            fab, h, plane = build_stack(pkg, num_shards=4, num_racks=2)
            auto = pkg.auto.Autoscaler(fab, planes=[plane], seed=3)
            h.run(2)
            events = auto.resolve_placement()
            h.run(4)
            runs.append((auto, events, bits(fab.params)))
        (auto_a, ev_a, params_a), (_, ev_b, params_b) = runs
        assert events_of(ev_a) == events_of(ev_b)
        np.testing.assert_array_equal(params_a, params_b)
        fab_plain, h_plain, _ = build_stack(pkg, num_shards=4, num_racks=2)
        h_plain.run(4)
        np.testing.assert_array_equal(bits(fab_plain.params), params_a)
        return auto_a, ev_a

    (ja, jev), (ta, tev) = both(run)
    assert events_of(jev) == events_of(tev)
    assert_auto_same(ja, ta)


def test_autoscaler_telemetry_snapshot():
    def run(pkg):
        fab, h, plane = build_stack(pkg, num_shards=2, num_racks=2)
        reb = pkg.straggler.ShardRebalancer(fab)
        auto = pkg.auto.Autoscaler(fab, rebalancer=reb, planes=[plane])
        h.run(3)
        plane.read(0)
        tele = auto.telemetry()
        assert tele["round"] == 3 and tele["num_shards"] == 2
        assert tele["busy_us_per_round"] > 0.0
        assert tele["shard_speeds"].shape == (2,)
        assert len(tele["serve_us"]) == 1
        assert "events" not in tele  # flat signal dict only
        assert "no events" in auto.describe()
        return auto

    assert_auto_same(*both(run))


def test_policy_validation():
    for kw in (dict(min_shards=4, max_shards=2), dict(min_shards=0),
               dict(scale_up_busy_us=1.0, scale_down_busy_us=2.0),
               dict(cooldown_rounds=-1), dict(solve_every=-1)):
        with pytest.raises(ValueError) as je:
            jauto.AutoscalerPolicy(**kw)
        with pytest.raises(ValueError) as te:
            tauto.AutoscalerPolicy(**kw)
        assert str(te.value) == str(je.value)
    assert dataclasses.asdict(tauto.AutoscalerPolicy()) == \
        dataclasses.asdict(jauto.AutoscalerPolicy())
    # a frontend index past every plane raises alike
    for pkg in (JAX, PORT):
        fab, _, plane = build_stack(pkg, num_shards=2, num_racks=2)
        auto = pkg.auto.Autoscaler(fab, planes=[plane])
        with pytest.raises(ValueError, match="no frontend 5 across 1 planes"):
            auto.apply_delta(pkg.pl.PlanDelta(kind="frontend_move",
                                              frontend=5, rack=1))


# ---------------------------------------------------------------------------
# the headline closed-loop invariant (sparse)
# ---------------------------------------------------------------------------
def drive_sparse(pkg, tier, rounds, *, seed):
    rng = np.random.default_rng(seed)
    for _ in range(rounds):
        for w in range(tier.num_workers):
            ids = rng.integers(0, V, size=12)
            g = rng.standard_normal((12, D)).astype(np.float32)
            tier.push(w, {"t0": (ids, pkg.rows(g))})


SPARSE_INIT = np.random.default_rng(7).standard_normal((V, D)).astype(
    np.float32)


def build_sparse(pkg, codec):
    fab, h, plane = build_stack(pkg, num_shards=2, num_racks=2, codec="none")
    tier = pkg.sparse.SparseTier(fabric=fab, codec=codec, lr=0.1)
    tier.add_table("t0", SPARSE_INIT)
    splane = pkg.sv.SparseReadPlane(tier, num_frontends=2)
    return fab, h, plane, tier, splane


@pytest.mark.parametrize("codec", ["none", "int8"])
def test_autoscaled_sparse_run_bit_identical(codec):
    """The sparse tier reshards with the dense fabric and its table bits
    never move; the sparse read plane keeps serving exact bits through a
    moved frontend."""
    def run(pkg):
        fab_a, h_a, _, tier_a, _ = build_sparse(pkg, codec)
        fab_b, h_b, plane_b, tier_b, splane_b = build_sparse(pkg, codec)
        auto = pkg.auto.Autoscaler(
            fab_b, planes=[plane_b, splane_b],
            policy=pkg.auto.AutoscalerPolicy(cooldown_rounds=0,
                                             solve_placement=False))
        h_a.run(2)
        drive_sparse(pkg, tier_a, 2, seed=11)
        h_b.run(2)
        drive_sparse(pkg, tier_b, 2, seed=11)
        events = auto.apply_plan(perturb_plan(
            pkg.pl.current_plan(fab_b, planes=[plane_b, splane_b]), 2))
        assert any(e.kind == "frontend_move" for e in events)
        auto.apply_delta(pkg.pl.PlanDelta(kind="shard_count", new_shards=8))
        assert fab_b.num_shards == 8 and tier_b.num_shards == 8
        assert tier_b.stats.rescales == 1
        h_a.run(4)
        drive_sparse(pkg, tier_a, 2, seed=13)
        h_b.run(4)
        drive_sparse(pkg, tier_b, 2, seed=13)
        np.testing.assert_array_equal(bits(fab_a.params), bits(fab_b.params))
        np.testing.assert_array_equal(bits(tier_a.table("t0")),
                                      bits(tier_b.table("t0")))
        np.testing.assert_array_equal(tier_a.row_versions("t0"),
                                      tier_b.row_versions("t0"))
        # sparse serving: exact bits through the rescaled tier
        ids = np.arange(16)
        res = splane_b.read_rows(0, "t0", ids)
        np.testing.assert_array_equal(bits(res.rows),
                                      bits(tier_b.table("t0"))[ids])
        return auto, tier_b, res

    (ja, jtier, jres), (ta, ttier, tres) = both(run)
    assert_auto_same(ja, ta)
    assert_tier_same(jtier, ttier)
    np.testing.assert_array_equal(bits(jres.rows), bits(tres.rows))


def test_sparse_reshard_round_edge_and_failover():
    def run(pkg):
        fab, h, _ = build_stack(pkg, num_shards=2, num_racks=2)
        tier = pkg.sparse.SparseTier(fabric=fab, replication=2)
        init = np.random.default_rng(3).standard_normal((V, D)).astype(
            np.float32)
        tier.add_table("t0", init)
        drive_sparse(pkg, tier, 1, seed=5)
        ones = pkg.rows(np.ones((4, D), np.float32))
        tier.push(0, {"t0": (np.arange(4), ones)})
        with pytest.raises(RuntimeError) as err:
            tier.reshard(4)  # mid-round: one worker staged
        for w in range(1, tier.num_workers):
            tier.push(w, {"t0": (np.arange(4), ones)})
        before = bits(tier.table("t0")).copy()
        tier.reshard(4)
        np.testing.assert_array_equal(bits(tier.table("t0")), before)
        # chains were rebuilt at the new count and still fail over
        # bit-exactly
        assert len(tier._chains) == 4
        tier.failover(1)
        np.testing.assert_array_equal(bits(tier.table("t0")), before)
        return tier, str(err.value)

    (jtier, jerr), (ttier, terr) = both(run)
    assert terr == jerr
    assert_tier_same(jtier, ttier)


# ---------------------------------------------------------------------------
# beyond the mirror: tenant shares through shared=, solved row maps
# ---------------------------------------------------------------------------
def test_tenant_shares_route_through_shared_box():
    """The ``tenant_shares`` lever: a plan's shares (hand-made, then the
    solver's from a tenant demand) reach ``MultiJobFabric`` through
    ``shared=``; an unchanged share applies no event.  Timing only: the
    box equals JAX's, and each tenant's bits equal a run without the
    autoscaler."""
    def run(pkg, autoscale=True):
        ten = tenancy.JAX if pkg is JAX else tenancy.PORT
        b = tenancy.box(ten, num_shards=2, num_racks=2)
        jobs = [tenancy.make_job(ten, "A", 1.0, priority=2.0),
                tenancy.make_job(ten, "B", 1.5)]
        handles = [b.attach(s) for s, _ in jobs]
        pairs = [(h, g) for h, (_, g) in zip(handles, jobs)]
        hs = tenancy.drive(ten, pairs, steps=2)
        if not autoscale:
            hs = tenancy.drive(ten, pairs, steps=4)
            return b, None
        auto = pkg.auto.Autoscaler(handles[0].fabric, shared=b)
        base = pkg.pl.current_plan(handles[0].fabric)
        events = auto.apply_plan(base.replace(
            tenant_shares={"A": 1.0, "B": 3.0}))
        assert [e.kind for e in events] == ["tenant_shares"]
        assert auto.apply_plan(base.replace(
            tenant_shares={"A": 1.0, "B": 3.0})) == []
        solved = pkg.pl.PlacementProblem.standard(
            num_shards=2, num_racks=2,
            tenant_demand={"A": 2.0, "B": 5.0}).solve(seed=0)
        auto.apply_delta(pkg.pl.diff_plans(base, solved)[-1])
        hs = tenancy.drive(ten, pairs, steps=4)
        assert set(auto.telemetry()["link_busy_us"]) == set(b.links)
        return b, auto

    (jb, ja), (tb, ta) = both(run)
    tenancy.assert_box_same(jb, tb)
    assert events_of(ja) == events_of(ta)
    assert_telemetry_same(ja.telemetry(), ta.telemetry())
    assert ja.describe() == ta.describe()
    assert tb._share_override == {"A": 1.0, "B": 2.5}
    plain, _ = run(PORT, autoscale=False)
    for name, h in plain.jobs.items():
        assert torch.equal(h.fabric.params.view(torch.int32),
                           tb.jobs[name].fabric.params.view(torch.int32))


@pytest.mark.parametrize("codec", ["none", "int8"])
def test_sparse_solved_row_map_autoscaled(codec):
    """A 2 -> 8 reshard carrying a plan whose ``row_owner`` comes from the
    solver on a Zipf row load: the tier places its rows by the solved map
    (JAX's placement exactly), trains on bit-identical to the fixed run,
    and equals the JAX tier."""
    load = 1.0 / (np.arange(V) + 1.0)

    def run(pkg):
        fab_a, h_a, _, tier_a, _ = build_sparse(pkg, codec)
        fab_b, h_b, plane_b, tier_b, splane_b = build_sparse(pkg, codec)
        auto = pkg.auto.Autoscaler(fab_b, planes=[plane_b, splane_b],
                                   policy=pkg.auto.AutoscalerPolicy(
                                       cooldown_rounds=0))
        h_a.run(2)
        drive_sparse(pkg, tier_a, 2, seed=11)
        h_b.run(2)
        drive_sparse(pkg, tier_b, 2, seed=11)
        plan = pkg.pl.PlacementProblem.standard(
            num_shards=8, num_racks=2, replication=2, num_frontends=4,
            chunk_elems=fab_b.space.chunk_elems,
            row_load={"t0": load}).solve(seed=0)
        events = auto.apply_plan(plan)
        assert [e.kind for e in events] == ["reshard"]
        assert tier_b.tables["t0"].placement.policy == "plan"
        np.testing.assert_array_equal(tier_b.tables["t0"].placement.owner,
                                      plan.row_owner["t0"])
        h_a.run(4)
        drive_sparse(pkg, tier_a, 2, seed=13)
        h_b.run(4)
        drive_sparse(pkg, tier_b, 2, seed=13)
        np.testing.assert_array_equal(bits(fab_a.params), bits(fab_b.params))
        np.testing.assert_array_equal(bits(tier_a.table("t0")),
                                      bits(tier_b.table("t0")))
        res = splane_b.read_rows(1, "t0", np.arange(V))
        np.testing.assert_array_equal(bits(res.rows),
                                      bits(tier_b.table("t0")))
        return auto, tier_b, plan

    (ja, jtier, jplan), (ta, ttier, tplan) = both(run)
    np.testing.assert_array_equal(jplan.row_owner["t0"],
                                  tplan.row_owner["t0"])
    assert_auto_same(ja, ta)
    assert_tier_same(jtier, ttier)


# ---------------------------------------------------------------------------
# chaos: autoscaling during an active FaultPlan
# ---------------------------------------------------------------------------
@pytest.mark.slow
def test_chaos_soak_autoscale_under_faults():
    """Seeded soak: the autoscaler rescales and re-places while a
    FaultPlan crashes shards; every few rounds the run still matches the
    failure-free, fixed-placement twin, and the port matches JAX."""
    seed = int(os.environ.get("CHAOS_SEED", "0"))
    rounds = int(os.environ.get("CHAOS_ROUNDS", "24"))

    def run(pkg):
        fault_plan = pkg.faults(
            [pkg.event(3 + 4 * i, "shard_crash", i % 2)
             for i in range(max(1, rounds // 8))])
        fab_a, h_a, _ = build_stack(pkg, num_frontends=0)
        fab_b, h_b, _ = build_stack(pkg, num_frontends=0,
                                    fault_plan=fault_plan)
        rng = np.random.default_rng(seed)
        auto = pkg.auto.Autoscaler(fab_b, policy=pkg.auto.AutoscalerPolicy(
            min_shards=2, max_shards=8, cooldown_rounds=0,
            solve_placement=False), seed=seed)
        for r in range(rounds):
            h_a.run(r + 1)
            h_b.run(r + 1)
            if r % 6 == 2:
                auto.apply_delta(pkg.pl.PlanDelta(
                    kind="shard_count",
                    new_shards=int(rng.choice([2, 4, 8]))))
            if r % 6 == 4:
                auto.apply_plan(perturb_plan(pkg.pl.current_plan(fab_b), 2))
            if r % 4 == 3:
                np.testing.assert_array_equal(
                    bits(fab_a.params), bits(fab_b.params),
                    err_msg=f"seed={seed}: diverged at round {r + 1}")
        np.testing.assert_array_equal(bits(fab_a.params), bits(fab_b.params),
                                      err_msg=f"seed={seed}: final divergence")
        assert fab_b.stats.rescales >= 1
        assert fab_b.stats.failovers >= 1
        assert isinstance(auto.events[0], pkg.auto.ScaleEvent)
        return auto

    assert_auto_same(*both(run))
