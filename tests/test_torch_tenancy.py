"""The PyTorch tenancy tier against the JAX one, bitwise.

Mirrors tests/test_tenancy.py function for function: every scenario runs
once on the JAX ``MultiJobFabric`` and once on the port's (on the CPU),
with the same quadratic jobs (workers minimize ``||w - t_w||^2`` on
targets made with numpy from a seed; the gradient ``2 * (w - t_w)`` is one
f32 subtract and one multiply in either package).  Each case holds, for
every tenant, params, optimizer state, residuals and every ``ServerStats``
/ ``ShardStats`` / ``RackStats`` field (the event clock's ``sim_*`` floats
included) equal bit for bit (``tests/test_torch_topology.assert_same``),
and for the box ``utilization()``, ``shard_occupancy()``, ``route()``,
each tenant's ``telemetry()`` and ``describe()`` exactly
(``assert_box_same``); then the JAX test's own assertions run on the
port's results.

Beyond the mirror: a tenant detached on one package re-attaches on the
other; ``JobSpec.params`` stays untouched, a detach snapshot stays equal
after the re-attached job trains on (and restores twice to the same
bits), and no two tenants share storage; ``apply_tenant_shares`` /
``apply_plan_delta`` in mid-run; a serve tenant beside two training jobs
(the rest of the serve-tenant cases are in test_torch_serving.py).  The
switch-grant, failover and fused-wire tenancy cases are in
test_torch_switch.py, test_torch_replication.py and
test_torch_wire_path.py.
"""
import dataclasses
import types
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from test_torch_topology import assert_same  # noqa: E402

from repro.core import tenancy as jten  # noqa: E402
from repro.core.chunking import TILE_ELEMS as JAX_TILE  # noqa: E402
from repro.core.config import SwitchConfig as JaxSwitch  # noqa: E402
from repro.core.fabric import LinkModel as JaxLink  # noqa: E402
from repro.core.fabric import WorkerHarness as JaxHarness  # noqa: E402
from repro.core.placement import PlanDelta as JaxDelta  # noqa: E402
from repro.core.replication import FaultEvent as JaxEvent  # noqa: E402
from repro.core.replication import FaultPlan as JaxPlan  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro_torch.core import tenancy as tten  # noqa: E402
from repro_torch.core.chunking import TILE_ELEMS  # noqa: E402
from repro_torch.core.config import SwitchConfig  # noqa: E402
from repro_torch.core.fabric import LinkModel, PBoxFabric, WorkerHarness  # noqa: E402
from repro_torch.core.placement import PlanDelta  # noqa: E402
from repro_torch.core.replication import FaultEvent, FaultPlan  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402

LINK = dict(wire_us_per_chunk=1.0, agg_us_per_chunk=0.2)

# one namespace per package: the same scenario code drives either
JAX = types.SimpleNamespace(
    ten=jten, harness=JaxHarness, opt=jopt, link=JaxLink(**LINK),
    switch=JaxSwitch, delta=JaxDelta, event=JaxEvent, plan=JaxPlan,
    box_kw={}, arr=lambda a: jnp.asarray(a),
    zeros=lambda n: jnp.zeros((n,)), tile=JAX_TILE)
PORT = types.SimpleNamespace(
    ten=tten, harness=WorkerHarness, opt=topt, link=LinkModel(**LINK),
    switch=SwitchConfig, delta=PlanDelta, event=FaultEvent, plan=FaultPlan,
    box_kw={"device": "cpu"},
    arr=lambda a: torch.from_numpy(np.array(a, np.float32)),
    zeros=lambda n: torch.zeros(n), tile=TILE_ELEMS)


def fault_plan(pkg, events):
    """``pkg``'s FaultPlan of (round, kind, target[, factor]) tuples."""
    return pkg.plan(pkg.event(*e) for e in events) if events else None


def make_job(pkg, name, target_scale, *, workers=4, elems=3000,
             optimizer=lambda o: o.momentum(0.05, 0.9), **kw):
    """A quadratic job: workers minimize ||w - target_w||^2 on per-worker
    targets made with numpy from a seed of the job's name (batch = worker
    id, so runs are schedule-independent).  The same job in either
    package."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    targets_np = [
        {"w": (target_scale * (i + 1)
               + 0.1 * rng.standard_normal(elems)).astype(np.float32),
         "b": (np.arange(50.0) * (i + 1)).astype(np.float32)}
        for i in range(workers)
    ]
    targets = [{k: pkg.arr(v) for k, v in t.items()} for t in targets_np]
    params = {"w": pkg.zeros(elems), "b": pkg.zeros(50)}

    def grad_fn(p, batch):
        return {k: 2 * (p[k] - targets[batch][k]) for k in p}

    if "fault_plan" in kw:
        kw["fault_plan"] = fault_plan(pkg, kw["fault_plan"])
    spec = pkg.ten.JobSpec(name=name, params=params, num_workers=workers,
                           chunk_elems=pkg.tile,
                           optimizer=optimizer(pkg.opt), **kw)
    return spec, grad_fn


def box(pkg, **kw):
    kw.setdefault("link", pkg.link)
    if "switch" in kw:
        kw["switch"] = pkg.switch(**kw["switch"])
    return pkg.ten.MultiJobFabric(**kw, **pkg.box_kw)


def drive(pkg, handles_and_grads, steps):
    """Interleave the tenants' worker harnesses tick by tick."""
    hs = [pkg.harness(h, g, lambda w, s: w) for h, g in handles_and_grads]
    guard = 0
    while any(min(h.steps_done) < steps for h in hs):
        for h in hs:
            if min(h.steps_done) < steps:
                h.tick()
        guard += 1
        assert guard < steps * 100, "tenant scheduler livelock"
    return hs


def dedicated(pkg, spec, grad_fn, the_box, steps):
    ded = pkg.ten.dedicated_fabric(spec, the_box)
    pkg.harness(ded, grad_fn, lambda w, s: w).run(steps)
    return ded


def both(scenario):
    """``scenario(pkg)`` on the JAX package and on the port."""
    return scenario(JAX), scenario(PORT)


def _route_or_error(b, gid):
    try:
        return b.route(gid)
    except KeyError as e:
        return f"KeyError: {e}"


def assert_box_same(jbox, tbox):
    """Every tenant's bits and counters, and the box's views, equal."""
    assert list(jbox.jobs) == list(tbox.jobs)
    for name, jh in jbox.jobs.items():
        th = tbox.jobs[name]
        assert_same(jh.fabric, th.fabric)
        assert jh.chunk_base == th.chunk_base
        assert jh.telemetry() == th.telemetry()
        assert jh.sim_step_time_us() == th.sim_step_time_us()
        np.testing.assert_array_equal(jh.global_chunks(), th.global_chunks())
        gids = jh.global_chunks()
        for gid in (int(gids[0]), int(gids[len(gids) // 2]), int(gids[-1])):
            assert jbox.route(gid) == tbox.route(gid)
    end = max((h.chunk_base + h.fabric.space.num_chunks
               for h in jbox.jobs.values()), default=0)
    for gid in range(end + 1):
        assert _route_or_error(jbox, gid) == _route_or_error(tbox, gid)
    assert jbox.utilization() == tbox.utilization()
    assert jbox.shard_occupancy() == tbox.shard_occupancy()
    assert jbox.describe() == tbox.describe()
    assert dataclasses.asdict(jbox.aggregate_stats()) == \
        dataclasses.asdict(tbox.aggregate_stats())
    assert {n: dataclasses.astuple(g) for n, g in jbox.switch_grants.items()} \
        == {n: dataclasses.astuple(g) for n, g in tbox.switch_grants.items()}
    assert (jbox._tor_slots_left, jbox._core_slots_left, jbox.rounds,
            jbox._next_chunk_base, jbox._share_override) == \
        (tbox._tor_slots_left, tbox._core_slots_left, tbox.rounds,
         tbox._next_chunk_base, tbox._share_override)


def params_np(fab):
    p = fab.params
    return p.numpy() if isinstance(p, torch.Tensor) else np.asarray(p)


# ---------------------------------------------------------------------------
# isolation: bit-identity vs a dedicated fabric
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("num_racks", [1, 2])
@pytest.mark.parametrize("num_shards", [1, 4])
def test_cotenants_bit_identical_to_dedicated(num_shards, num_racks):
    def run(pkg):
        b = box(pkg, num_shards=num_shards, num_racks=num_racks)
        spec_a, grad_a = make_job(pkg, "A", 1.0, priority=3.0)
        spec_b, grad_b = make_job(pkg, "B", 2.0,
                                  optimizer=lambda o: o.adamw(3e-3),
                                  codec="int8", elems=5000)
        ha, hb = b.attach(spec_a), b.attach(spec_b)
        drive(pkg, [(ha, grad_a), (hb, grad_b)], steps=5)
        deds = [dedicated(pkg, s, g, b, 5)
                for s, g in ((spec_a, grad_a), (spec_b, grad_b))]
        return b, (ha, hb), deds

    (jb, _, jdeds), (tb, handles, tdeds) = both(run)
    assert_box_same(jb, tb)
    for jd, td, h in zip(jdeds, tdeds, handles):
        assert_same(jd, td)
        assert torch.equal(td.params, h.fabric.params)
        # co-tenancy did inflate the clock, never the numerics
        assert h.stats.sim_pipelined_us > td.stats.sim_pipelined_us


def test_three_tenants_with_quorum_and_ssp_stay_isolated():
    """Admission modes are per-job state: a quorum job and an SSP job
    sharing the box behave exactly as they do alone."""
    def run(pkg):
        b = box(pkg, num_shards=4, num_racks=2)
        jobs = [make_job(pkg, "sync", 1.0),
                make_job(pkg, "quorum", 1.5, optimizer=lambda o: o.sgd(0.01),
                         min_push_fraction=0.75),
                make_job(pkg, "ssp", 0.5, mode="stale", staleness=2)]
        handles = [b.attach(s) for s, _ in jobs]
        drive(pkg, [(h, g) for h, (_, g) in zip(handles, jobs)], steps=4)
        deds = [dedicated(pkg, s, g, b, 4) for s, g in jobs]
        return b, handles, deds

    (jb, _, jdeds), (tb, handles, tdeds) = both(run)
    assert_box_same(jb, tb)
    for jd, td, h in zip(jdeds, tdeds, handles):
        assert_same(jd, td)
        assert td.stats.steps == h.stats.steps
        assert torch.equal(td.params, h.fabric.params)


# ---------------------------------------------------------------------------
# fairness: priority ordering and bandwidth caps
# ---------------------------------------------------------------------------
def test_priority_orders_sim_step_time_strictly():
    def run(pkg):
        b = box(pkg, num_shards=2, num_racks=2)
        spec_hi, grad_hi = make_job(pkg, "hi", 1.0, priority=4.0)
        spec_lo, grad_lo = make_job(pkg, "lo", 1.0, priority=1.0)
        hi, lo = b.attach(spec_hi), b.attach(spec_lo)
        drive(pkg, [(hi, grad_hi), (lo, grad_lo)], steps=4)
        return b, hi, lo

    (jb, _, _), (tb, hi, lo) = both(run)
    assert_box_same(jb, tb)
    assert hi.sim_step_time_us() < lo.sim_step_time_us()
    assert tb.wire_scales(hi.fabric) == (1.25, 1.25)
    assert tb.wire_scales(lo.fabric) == (5.0, 5.0)


def test_bandwidth_cap_floors_the_share():
    """A capped job pays 1/cap even with the box otherwise idle."""
    def run(pkg):
        b = box(pkg, num_shards=2, num_racks=1)
        spec, grad_fn = make_job(pkg, "capped", 1.0, bandwidth_cap=0.25)
        h = b.attach(spec)
        scales = b.wire_scales(h.fabric)
        drive(pkg, [(h, grad_fn)], steps=3)
        return b, h, scales, dedicated(pkg, spec, grad_fn, b, 3)

    (jb, _, jscales, jded), (tb, h, scales, ded) = both(run)
    assert_box_same(jb, tb)
    assert_same(jded, ded)
    assert scales == jscales == (4.0, 4.0)
    assert torch.equal(ded.params, h.fabric.params)
    assert h.stats.sim_wire_us == pytest.approx(4 * ded.stats.sim_wire_us)
    assert tb.links["rack0"].stats.contention_factor == pytest.approx(4.0)


def test_link_queues_account_cotenant_occupancy():
    def run(pkg):
        b = box(pkg, num_shards=2, num_racks=2)
        spec_a, grad_a = make_job(pkg, "A", 1.0)
        spec_b, grad_b = make_job(pkg, "B", 1.0)
        ha, hb = b.attach(spec_a), b.attach(spec_b)
        drive(pkg, [(ha, grad_a), (hb, grad_b)], steps=3)
        return b, ha, hb

    (jb, _, _), (tb, ha, hb) = both(run)
    assert_box_same(jb, tb)
    util = tb.utilization()
    for name in ("rack0", "rack1", "core"):
        u = util[name]
        assert set(u["by_job"]) == {"A", "B"}
        assert u["queued_us"] > 0.0
        assert u["busy_us"] == pytest.approx(sum(u["by_job"].values()))
        assert u["contention_factor"] == pytest.approx(2.0)
    agg = tb.aggregate_stats()
    assert agg.steps == ha.stats.steps + hb.stats.steps
    assert agg.sim_core_wire_us == pytest.approx(
        ha.stats.sim_core_wire_us + hb.stats.sim_core_wire_us)


# ---------------------------------------------------------------------------
# namespaces on the shared shard set
# ---------------------------------------------------------------------------
def test_namespace_mapping_is_disjoint_and_routable():
    def run(pkg):
        b = box(pkg, num_shards=4, num_racks=1, link=None)
        ha = b.attach(make_job(pkg, "A", 1.0)[0])
        hb = b.attach(make_job(pkg, "B", 1.0, elems=9000)[0])
        return b, ha, hb

    (jb, _, _), (tb, ha, hb) = both(run)
    assert_box_same(jb, tb)
    ga, gb = ha.global_chunks(), hb.global_chunks()
    assert len(np.intersect1d(ga, gb)) == 0
    assert gb[0] == ga[-1] + 1
    for gid in (int(ga[0]), int(ga[-1])):
        job, shard = tb.route(gid)
        assert job == "A" and 0 <= shard < 4
    assert tb.route(int(gb[0]))[0] == "B"
    with pytest.raises(KeyError):
        tb.route(int(gb[-1]) + 1)
    for occ in tb.shard_occupancy():
        assert set(occ) == {"A", "B"}
    assert sum(sum(o.values()) for o in tb.shard_occupancy()) == (
        len(ga) + len(gb))
    assert "job A" in tb.describe() and "link core" in tb.describe()
    # each tenant's fabric names its namespace as the JAX fabric does
    assert hb.fabric.describe().startswith("[B] PBoxFabric: 4 shards x ")
    assert "ns=B@" in hb.fabric.config.describe().splitlines()[0]
    assert jb.jobs["B"].fabric.describe().splitlines()[0].startswith(
        "[B] PBoxFabric: 4 shards x ")


# ---------------------------------------------------------------------------
# attach/detach at runtime (elastic snapshot/restore reuse)
# ---------------------------------------------------------------------------
def test_detach_reattach_resumes_bit_identically():
    def run(pkg):
        b = box(pkg, num_shards=4, num_racks=2)
        spec_a, grad_a = make_job(pkg, "A", 1.0,
                                  optimizer=lambda o: o.adamw(3e-3))
        spec_b, grad_b = make_job(pkg, "B", 2.0)
        ha, hb = b.attach(spec_a), b.attach(spec_b)
        drive(pkg, [(ha, grad_a), (hb, grad_b)], steps=3)
        old_space = ha.fabric.space
        snap = b.detach("A")
        detached = (ha.detached, "A" in b.jobs, b.wire_scales(hb.fabric))
        drive(pkg, [(hb, grad_b)], steps=5)
        ha2 = b.attach(spec_a, snapshot=snap, snapshot_space=old_space)
        step = ha2.fabric.step
        drive(pkg, [(ha2, grad_a), (hb, grad_b)], steps=2)
        return b, ha2, detached, step, dedicated(pkg, spec_a, grad_a, b, 5)

    (jb, _, jdet, jstep, jded), (tb, ha2, det, step, ded) = both(run)
    assert_box_same(jb, tb)
    assert_same(jded, ded)
    assert det == jdet == (True, False, (1.0, 1.0))
    assert step == jstep == 3
    assert torch.equal(ded.params, ha2.fabric.params)
    # the namespace only grows: A's new range starts past B's
    hb = tb.jobs["B"]
    assert ha2.chunk_base == hb.chunk_base + hb.fabric.space.num_chunks


def test_reattach_across_shard_counts_goes_through_elastic():
    """A snapshot taken on a 4-shard box re-targets onto a 1-shard box
    through runtime/elastic.elastic_restore, and training continues
    bit-identically to a dedicated fabric."""
    def run(pkg):
        box4 = box(pkg, num_shards=4, num_racks=1)
        spec, grad_fn = make_job(pkg, "mig", 1.0,
                                 optimizer=lambda o: o.adamw(3e-3))
        h4 = box4.attach(spec)
        drive(pkg, [(h4, grad_fn)], steps=3)
        space4 = h4.fabric.space
        snap = box4.detach("mig")
        box1 = box(pkg, num_shards=1, num_racks=1)
        h1 = box1.attach(spec, snapshot=snap, snapshot_space=space4)
        re_padded = h1.fabric.space.flat_elems != space4.flat_elems
        step = h1.fabric.step
        drive(pkg, [(h1, grad_fn)], steps=2)
        return box1, h1, re_padded, step, dedicated(pkg, spec, grad_fn,
                                                     box4, 5)

    (jb, _, jre, jstep, jded), (tb, h1, re_padded, step, ded) = both(run)
    assert_box_same(jb, tb)
    assert_same(jded, ded)
    assert re_padded and jre and step == jstep == 3
    n = h1.fabric.space.payload_elems
    assert torch.equal(ded.params[:n], h1.fabric.params[:n])


def test_detached_handle_keeps_working_as_dedicated():
    def run(pkg):
        b = box(pkg, num_shards=2, num_racks=1)
        spec_a, grad_a = make_job(pkg, "A", 1.0)
        spec_b, _ = make_job(pkg, "B", 1.0)
        ha = b.attach(spec_a)
        b.attach(spec_b)
        b.detach("A")
        pkg.harness(ha, grad_a, lambda w, s: w).run(2)
        return b, ha, dedicated(pkg, spec_a, grad_a, b, 2)

    (jb, jha, jded), (tb, ha, ded) = both(run)
    assert_box_same(jb, tb)
    assert_same(jha.fabric, ha.fabric)
    assert_same(jded, ded)
    assert ha.stats.sim_wire_us == pytest.approx(ded.stats.sim_wire_us)


# ---------------------------------------------------------------------------
# harness/job-handle integration + validation
# ---------------------------------------------------------------------------
def test_worker_harness_telemetry_carries_job_namespace():
    def run(pkg):
        b = box(pkg, num_shards=2, num_racks=2)
        spec, grad_fn = make_job(pkg, "tenant-x", 1.0)
        h = b.attach(spec)
        wh = pkg.harness(h, grad_fn, lambda w, s: w)
        wh.run(2)
        return b, h, wh

    (jb, _, jwh), (tb, h, wh) = both(run)
    assert_box_same(jb, tb)
    t = wh.telemetry()
    assert t == jwh.telemetry()
    assert wh.job == "tenant-x" and t["job"] == "tenant-x"
    assert t["server_steps"] == 2 and t["worker_steps"] == [2] * 4
    assert t["sim_step_us"] == pytest.approx(h.sim_step_time_us())
    assert set(t["steps_done_by_rack"]) == {0, 1}
    jt = h.telemetry()
    assert jt["job"] == "tenant-x" and jt["steps"] == 2
    # the harness reads these through the handle
    assert (h.num_workers, h.topology.num_racks, h.namespace) == \
        (4, 2, "tenant-x")
    assert [h.rack_of(w) for w in range(4)] == [0, 0, 1, 1]
    assert h.stats is h.fabric.stats


def test_jobspec_and_lifecycle_validation():
    def run(pkg):
        b = box(pkg, num_shards=2)
        spec, _ = make_job(pkg, "dup", 1.0)
        b.attach(spec)
        errors = []

        def err(fn):
            try:
                fn()
            except (ValueError, KeyError) as e:
                errors.append(f"{type(e).__name__}: {e}")
            else:
                errors.append(None)

        err(lambda: b.attach(spec))
        err(lambda: b.detach("nope"))
        err(lambda: make_job(pkg, "bad", 1.0, priority=0.0))
        err(lambda: make_job(pkg, "bad", 1.0, bandwidth_cap=1.5))
        err(lambda: pkg.ten.JobSpec(name="", params={},
                                    optimizer=pkg.opt.sgd(0.01),
                                    num_workers=1))
        err(lambda: make_job(pkg, "bad", 1.0, workers=0))
        err(lambda: make_job(pkg, "bad", 1.0, replication=0))
        err(lambda: b.wire_scales(pkg.ten.dedicated_fabric(spec, b)))
        err(lambda: b.crash_shard(2))
        err(lambda: pkg.ten.MultiJobFabric(num_shards=0, **pkg.box_kw))
        err(lambda: pkg.ten.MultiJobFabric(num_racks=0, **pkg.box_kw))
        err(lambda: b.apply_tenant_shares({"dup": 0.0}))
        err(lambda: b.apply_plan_delta(pkg.delta(kind="shard_count",
                                                 new_shards=2)))
        return errors

    jerr, terr = both(run)
    assert terr == jerr
    assert terr[0] == "ValueError: tenant 'dup' is already attached"
    assert terr[1].startswith("KeyError") and terr[7].startswith("KeyError")
    assert all(e is not None for e in terr)


def test_handle_is_a_job_handle_not_a_fabric_subclass():
    """JobHandle is a facade: the worker API delegates, the tenancy API is
    its own."""
    b = box(PORT, num_shards=2)
    spec, _ = make_job(PORT, "f", 1.0)
    h = b.attach(spec)
    assert isinstance(h, tten.JobHandle)
    assert not isinstance(h, PBoxFabric)
    flat = h.pull(0)
    assert tuple(flat.shape) == (h.space.flat_elems,)
    h.push(0, torch.zeros_like(flat))
    assert h.num_workers == 4 and h.name == "f"
    assert h.fabric.shared_clock is b and h.fabric.device.type == "cpu"


# ---------------------------------------------------------------------------
# across the two packages, aliasing, plan deltas, refusals
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("src,dst", [("jax", "torch"), ("torch", "jax")])
def test_detach_in_one_package_reattaches_in_the_other(src, dst):
    """A tenant detached from one package's box re-attaches onto the other
    package's box (the snapshot is host numpy under the same keys) and
    trains on exactly as it would have at home."""
    pkgs = {"jax": JAX, "torch": PORT}
    a, b = pkgs[src], pkgs[dst]
    spec_a, grad_a = make_job(a, "A", 1.0, optimizer=lambda o: o.adamw(3e-3))
    box_a = box(a, num_shards=4, num_racks=2)
    drive(a, [(box_a.attach(spec_a), grad_a)], steps=3)
    space_a = box_a.jobs["A"].fabric.space
    snap = box_a.detach("A")

    spec_b, grad_b = make_job(b, "A", 1.0, optimizer=lambda o: o.adamw(3e-3))
    box_b = box(b, num_shards=2, num_racks=2)
    h = box_b.attach(spec_b, snapshot=snap, snapshot_space=space_a)
    drive(b, [(h, grad_b)], steps=2)

    home = box(a, num_shards=2, num_racks=2)
    hh = home.attach(spec_a, snapshot=snap, snapshot_space=space_a)
    drive(a, [(hh, grad_a)], steps=2)
    jh, th = (hh, h) if a is JAX else (h, hh)
    np.testing.assert_array_equal(params_np(jh.fabric).view(np.uint32),
                                  params_np(th.fabric).view(np.uint32))
    for js, ts in zip(jh.fabric.shards, th.fabric.shards):
        for x, y in zip(js.state, ts.state):
            np.testing.assert_array_equal(
                np.asarray(x).view(np.uint32), y.numpy().view(np.uint32))
    assert dataclasses.asdict(jh.stats) == dataclasses.asdict(th.stats)
    assert jh.fabric.step == th.fabric.step == 5


def test_tenants_never_alias_specs_snapshots_or_each_other():
    """The kernels write each tenant's slabs in place: ``JobSpec.params``
    stays untouched (the dedicated twin is rebuilt from it), a detach
    snapshot stays equal after the re-attached job trains on and restores
    twice to the same bits, and no two tenants share storage."""
    b = box(PORT, num_shards=2, num_racks=2)
    spec_a, grad_a = make_job(PORT, "A", 1.0, optimizer=lambda o: o.adamw(3e-3))
    spec_b, grad_b = make_job(PORT, "B", 2.0, codec="int8")
    before = {k: v.clone() for k, v in spec_a.params.items()}
    ha, hb = b.attach(spec_a), b.attach(spec_b)
    drive(PORT, [(ha, grad_a), (hb, grad_b)], steps=2)
    for k, v in spec_a.params.items():
        assert torch.equal(v, before[k])

    def storages(h):
        out = set()
        for sh in h.fabric.shards:
            for t in (sh.params, *sh.state):
                out.add(t.untyped_storage().data_ptr())
        return out

    assert not storages(ha) & storages(hb)
    assert not storages(ha) & {v.untyped_storage().data_ptr()
                               for v in spec_a.params.values()}

    space = ha.fabric.space
    snap = b.detach("A")
    frozen = {k: (np.copy(v) if not isinstance(v, tuple)
                  else tuple(np.copy(s) for s in v))
              for k, v in snap.items()}
    ha2 = b.attach(spec_a, snapshot=snap, snapshot_space=space)
    first = [ha2.fabric.params.clone()] + [
        s.clone() for s in ha2.fabric.shards[0].state]
    drive(PORT, [(ha2, grad_a), (hb, grad_b)], steps=2)
    for k, v in frozen.items():
        got = snap[k]
        if isinstance(v, tuple):
            for x, y in zip(v, got):
                np.testing.assert_array_equal(x, y)
        else:
            np.testing.assert_array_equal(v, got)
    b.detach("A")
    ha3 = b.attach(spec_a, snapshot=snap, snapshot_space=space)
    again = [ha3.fabric.params] + list(ha3.fabric.shards[0].state)
    for x, y in zip(first, again):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))
    assert not storages(ha3) & storages(hb)


def test_tenant_shares_mid_run_match_jax():
    """``apply_tenant_shares`` / ``apply_plan_delta`` between rounds:
    timing only, on both packages alike."""
    def run(pkg):
        b = box(pkg, num_shards=2, num_racks=2)
        jobs = [make_job(pkg, "A", 1.0, priority=2.0),
                make_job(pkg, "B", 1.5, bandwidth_cap=0.5)]
        handles = [b.attach(s) for s, _ in jobs]
        pairs = [(h, g) for h, (_, g) in zip(handles, jobs)]
        drive(pkg, pairs, steps=2)
        changed = [b.apply_tenant_shares({"A": 1.0, "B": 4.0, "gone": 3.0}),
                   b.apply_tenant_shares({"A": 1.0})]
        hs = drive(pkg, pairs, steps=4)
        changed.append(b.apply_plan_delta(
            pkg.delta(kind="tenant_shares", shares=(("A", 8.0),))))
        for h in hs:
            h.run(6)
        return b, changed, [b.wire_scales(h.fabric) for h in handles]

    (jb, jchanged, jscales), (tb, changed, scales) = both(run)
    assert_box_same(jb, tb)
    assert changed == jchanged == [2, 0, 1]
    assert scales == jscales == [(1.5, 1.5), (3.0, 3.0)]


def test_serving_tenants_are_refused():
    """Serve tenants are ported now: nothing is refused.  A read plane
    attached as a co-tenant (priority 2, bandwidth cap 0.5) beside two
    training jobs contends on the fair-share clock exactly as in JAX: the
    box, the link queues' bookings, the plane's stats and reads, the serve
    share and ``_total_priority`` all equal, and a detach of the source
    job detaches the serve tenant with it."""
    def run(pkg):
        b = box(pkg, num_shards=2, num_racks=2)
        jobs = [make_job(pkg, "A", 1.0, replication=2),
                make_job(pkg, "B", 1.5, priority=2.0)]
        handles = [b.attach(s) for s, _ in jobs]
        plane = b.attach_serving(
            pkg.ten.JobSpec(name="S", params=None, optimizer=None,
                            num_workers=2, priority=2.0, bandwidth_cap=0.5),
            "A", max_staleness=1)
        shares = [b.serve_scale(plane), b._total_priority(),
                  [b.wire_scales(h.fabric) for h in handles]]
        pairs = [(h, g) for h, (_, g) in zip(handles, jobs)]
        reads = []
        for step in range(3):
            drive(pkg, pairs, steps=step + 1)
            reads.append(plane.read_batch(step % 2, 2)[0])
        desc = b.describe()
        by_job = {n: dict(q.stats.by_job) for n, q in b.links.items()}
        b.detach("A")
        return b, plane, shares, reads, desc, by_job

    (jb, jp, jshares, jreads, jdesc, jby), (tb, tp, shares, reads, desc,
                                             by) = both(run)
    assert shares == jshares and desc == jdesc and by == jby
    assert "serve S (reads A)" in desc and by["core"].get("S", 0.0) > 0.0
    assert_box_same(jb, tb)
    assert tp.stats.sim_serve_us == jp.stats.sim_serve_us
    assert tp.describe() == jp.describe()
    for jr, tr in zip(jreads, reads):
        assert (tr.version, tr.staleness, tr.cache_hit, tr.sim_us) == \
            (jr.version, jr.staleness, jr.cache_hit, jr.sim_us)
        np.testing.assert_array_equal(
            tr.flat.numpy().view(np.uint32),
            np.asarray(jr.flat, np.float32).view(np.uint32))
    assert tb.serving == {} and tp.shared is None
    assert tb._total_priority() == jb._total_priority() == 2.0


@pytest.mark.parametrize("codec", ["none", "bf16", "int8"])
def test_shared_clock_floats_match_jax_with_uneven_link(codec):
    """The shared-clock terms product for product: with a link whose costs
    and fair shares are not powers of two, a reordered product in
    ``_simulate_round`` (which the unit link of the mirrored tests cannot
    see) changes the ``sim_*`` floats, the queues' µs and ``describe()``."""
    link = dict(wire_us_per_chunk=0.7, agg_us_per_chunk=0.11)

    def run(pkg):
        b = box(pkg, num_shards=3, num_racks=2, oversubscription=3.0,
                link=(JaxLink if pkg is JAX else LinkModel)(**link))
        jobs = [make_job(pkg, "A", 1.0, priority=3.0, codec=codec),
                make_job(pkg, "B", 0.5, priority=0.7, codec=codec,
                         workers=3, elems=5000, bandwidth_cap=0.9),
                make_job(pkg, "C", 2.0, workers=2, mode="stale",
                         staleness=1)]
        handles = [b.attach(s) for s, _ in jobs]
        drive(pkg, [(h, g) for h, (_, g) in zip(handles, jobs)], steps=3)
        b.detach("C")
        drive(pkg, [(h, g) for h, (_, g) in zip(handles[:2], jobs[:2])],
              steps=2)
        return b

    jb, tb = both(run)
    assert_box_same(jb, tb)
    assert tb.utilization()["core"]["contention_factor"] > 1.0
