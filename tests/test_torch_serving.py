"""The port's read plane (``repro_torch.core.serving``) against the JAX one.

Mirrors tests/test_serving.py case for case: every scenario runs once on
the JAX package and once on the port (on the CPU), with the same
quadratic training job (workers minimize ``||w - t_w||^2``; the gradient
``2 * (w - t_w)`` is one f32 subtract and one multiply in either package).
Each case holds, read by read, the served bits and every ``ReadResult``
field (version, staleness, cache hit, frontend, the ``sim_us`` float) equal,
and every ``ServeStats`` field (the latency histogram's bins and the
``sim_serve_us`` float included) bit for bit (``assert_stats_same``); then
the JAX test's own assertions run on the port's results.  Front-door runs
compare every ``ServedRequest``; the serve-tenant cases compare the whole
box (``tests/test_torch_tenancy.assert_box_same``).

Beyond the mirror: a read cached at ``max_staleness=1`` keeps its stamped
version's bits after another round at R = 1, 2 and 3 (the port's kernels
write slabs and chain buffers in place, JAX's arrays are immutable); a
``SnapshotSource`` owns a copy of what it is given; and an uneven link
(0.7 µs a chunk) on a shared box catches a reordered fair-share product.

Not mirrored: ``test_trainer_telemetry_advances_snapshot_plane`` needs
``runtime/trainer.py`` (ROADMAP queue 1, item 6), and
``test_serve_load_reports_percentiles_and_invariants`` /
``test_serve_load_staleness_zero_refreshes_every_round`` need
``benchmarks/serve_load.py``, which is not ported.
"""
import dataclasses
import gc
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from test_torch_tenancy import assert_box_same  # noqa: E402

from repro.checkpoint import checkpointer as jckpt  # noqa: E402
from repro.core import config as jconfig  # noqa: E402
from repro.core import serving as jserving  # noqa: E402
from repro.core import tenancy as jten  # noqa: E402
from repro.core import workload as jworkload  # noqa: E402
from repro.core.chunking import TILE_ELEMS as JAX_TILE  # noqa: E402
from repro.core.chunking import ParamSpace as JaxSpace  # noqa: E402
from repro.core.fabric import LinkModel as JaxLink  # noqa: E402
from repro.core.fabric import PBoxFabric as JaxFabric  # noqa: E402
from repro.core.fabric import WorkerHarness as JaxHarness  # noqa: E402
from repro.core.topology import NetworkTopology as JaxTopology  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro_torch.checkpoint import checkpointer as tckpt  # noqa: E402
from repro_torch.core import config as tconfig  # noqa: E402
from repro_torch.core import serving as tserving  # noqa: E402
from repro_torch.core import tenancy as tten  # noqa: E402
from repro_torch.core import workload as tworkload  # noqa: E402
from repro_torch.core.chunking import TILE_ELEMS, ParamSpace  # noqa: E402
from repro_torch.core.fabric import LinkModel, PBoxFabric, WorkerHarness  # noqa: E402
from repro_torch.core.topology import NetworkTopology  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402

K = 4

# one namespace per package: the same scenario code drives either
JAX = types.SimpleNamespace(
    name="jax", sv=jserving, cfg=jconfig, ten=jten, wl=jworkload,
    ckpt=jckpt, space=JaxSpace, tile=JAX_TILE, fabric=JaxFabric,
    harness=JaxHarness, topo=JaxTopology, opt=jopt, link=JaxLink, kw={},
    zeros=lambda n: jnp.zeros((n,)), full=lambda n, v: jnp.full((n,), v),
    arange=lambda n: jnp.arange(float(n)))
PORT = types.SimpleNamespace(
    name="port", sv=tserving, cfg=tconfig, ten=tten, wl=tworkload,
    ckpt=tckpt, space=ParamSpace, tile=TILE_ELEMS, fabric=PBoxFabric,
    harness=WorkerHarness, topo=NetworkTopology, opt=topt, link=LinkModel,
    kw={"device": "cpu"},
    zeros=lambda n: torch.zeros(n), full=lambda n, v: torch.full((n,), v),
    arange=lambda n: torch.arange(n, dtype=torch.float32))


def both(scenario):
    """``scenario(pkg)`` on the JAX package and on the port."""
    return scenario(JAX), scenario(PORT)


def bits(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32).view(np.uint32)


def quad_setup(pkg):
    params = {"w": pkg.zeros(9000), "b": pkg.zeros(77)}
    targets = [{"w": pkg.full(9000, float(i + 1)),
                "b": pkg.arange(77) * (i + 1)} for i in range(K)]

    def grad_fn(p, batch):
        t = targets[batch]
        return {k: 2 * (p[k] - t[k]) for k in p}

    return params, grad_fn


def space_of(pkg, params):
    return pkg.space.build(params, chunk_elems=pkg.tile)


def build_fabric(pkg, space, params, *, racks=1, shards=1, replication=1,
                 **kw):
    topo = (pkg.topo(num_workers=K, num_racks=racks) if racks > 1 else None)
    return pkg.fabric(space, pkg.opt.momentum(0.05, 0.9),
                      space.flatten(params), num_shards=shards, num_workers=K,
                      topology=topo, replication=replication, **kw, **pkg.kw)


def harness(pkg, fab, grad_fn, **kw):
    return pkg.harness(fab, grad_fn, lambda w, s: w, **kw)


def assert_tracker_same(jt, tt):
    np.testing.assert_array_equal(jt.counts, tt.counts)
    assert (jt.count, jt.total_us, jt.min_us, jt.max_us, jt.lo_us,
            jt.bins_per_decade) == (tt.count, tt.total_us, tt.min_us,
                                    tt.max_us, tt.lo_us, tt.bins_per_decade)
    for q in (0.0, 0.5, 0.9, 0.99, 0.999, 1.0):
        assert jt.quantile(q) == tt.quantile(q)
    assert jt.mean_us == tt.mean_us and repr(jt) == repr(tt)


def assert_stats_same(js, ts):
    """Every ServeStats / SparseServeStats field, bit for bit."""
    names = [f.name for f in dataclasses.fields(js)]
    assert names == [f.name for f in dataclasses.fields(ts)]
    for name in names:
        a, b = getattr(js, name), getattr(ts, name)
        if name == "latency":
            assert_tracker_same(a, b)
        else:
            assert a == b, name
    assert js.hit_rate == ts.hit_rate


def assert_read_same(jr, tr):
    assert (jr.version, jr.staleness, jr.cache_hit, jr.frontend,
            jr.sim_us) == (tr.version, tr.staleness, tr.cache_hit,
                           tr.frontend, tr.sim_us)
    np.testing.assert_array_equal(bits(jr.flat), bits(tr.flat))


def assert_reads_same(jreads, treads):
    assert len(jreads) == len(treads)
    for a, b in zip(jreads, treads):
        assert_read_same(a, b)


def assert_served_same(ja, tb):
    assert (ja.tenant, ja.arrival_us, ja.admitted, ja.shed, ja.tier,
            ja.frontend, ja.finish_us, ja.latency_us, ja.slo_met) == \
        (tb.tenant, tb.arrival_us, tb.admitted, tb.shed, tb.tier,
         tb.frontend, tb.finish_us, tb.latency_us, tb.slo_met)
    assert (ja.result is None) == (tb.result is None)
    if ja.result is not None:
        assert_read_same(ja.result, tb.result)


def assert_plane_same(jp, tp):
    assert_stats_same(jp.stats, tp.stats)
    assert jp.describe() == tp.describe()
    assert [(f.fid, f.rack, f.version) for f in jp.frontends] == \
        [(f.fid, f.rack, f.version) for f in tp.frontends]


# ---------------------------------------------------------------------------
# headline: version-stamped bit-identity across the whole config grid
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("racks", [1, 2, 4])
@pytest.mark.parametrize("shards", [1, 2, 8])
@pytest.mark.parametrize("replication", [1, 2])
def test_reads_bit_identical_at_stamped_version(racks, shards, replication):
    def run(pkg):
        params, grad_fn = quad_setup(pkg)
        space = space_of(pkg, params)
        fab = build_fabric(pkg, space, params, racks=racks, shards=shards,
                           replication=replication)
        plane = pkg.sv.ReadPlane(fab, max_staleness=1, num_frontends=2)
        h = harness(pkg, fab, grad_fn)
        history = {fab.step: bits(fab.params)}
        reads = []
        for step in range(3):
            h.run(step + 1)
            history[fab.step] = bits(fab.params)
            for f in range(2):
                reads.append(plane.read(f))
        return plane, reads, history

    (jp, jreads, jhist), (tp, reads, history) = both(run)
    assert_reads_same(jreads, reads)
    assert_plane_same(jp, tp)
    assert len(reads) == 6 and tp.stats.reads == 6
    for r in reads:
        np.testing.assert_array_equal(bits(r.flat), history[r.version])
        assert 0 <= r.staleness <= 1
    if replication > 1:
        assert tp.stats.replica_streams > 0
        assert tp.stats.primary_streams == 0
    else:
        assert tp.stats.primary_streams > 0
        assert tp.stats.replica_streams == 0


@pytest.mark.parametrize("mode,kw", [
    ("stale", {"mode": "stale", "staleness": 2}),
    ("async", {"mode": "async"}),
])
def test_staleness_bound_under_ssp_and_async(mode, kw):
    bound = 3

    def run(pkg):
        params, grad_fn = quad_setup(pkg)
        space = space_of(pkg, params)
        fab = build_fabric(pkg, space, params, racks=2, shards=2,
                           replication=2, **kw)
        plane = pkg.sv.ReadPlane(fab, max_staleness=bound, num_frontends=2)
        h = harness(pkg, fab, grad_fn, speed=[1, 1, 1, 3])
        history = {fab.step: bits(fab.params)}
        reads = []
        for _ in range(25):
            h.tick()
            history[fab.step] = bits(fab.params)
            reads.append(plane.read(0))
        return fab, plane, reads, history

    (jfab, jp, jreads, _), (fab, tp, reads, history) = both(run)
    assert_reads_same(jreads, reads)
    assert_plane_same(jp, tp)
    assert fab.step == jfab.step > 0
    for r in reads:
        assert 0 <= r.staleness <= bound
        np.testing.assert_array_equal(bits(r.flat), history[r.version])
    assert tp.stats.max_staleness_served <= bound


def test_training_bit_identical_with_read_plane_attached():
    def run(pkg):
        params, grad_fn = quad_setup(pkg)
        space = space_of(pkg, params)
        ref = build_fabric(pkg, space, params, racks=2, shards=2,
                           replication=2)
        harness(pkg, ref, grad_fn).run(5)
        fab = build_fabric(pkg, space, params, racks=2, shards=2,
                           replication=2)
        plane = pkg.sv.ReadPlane(fab, max_staleness=0, num_frontends=2)
        h = harness(pkg, fab, grad_fn)
        reads = []
        for step in range(5):
            h.run(step + 1)
            reads.append(plane.read(0))
            reads.extend(plane.read_batch(1, 5))
        return ref, fab, plane, reads

    (jref, jfab, jp, jreads), (ref, fab, tp, reads) = both(run)
    assert_reads_same(jreads, reads)
    assert_plane_same(jp, tp)
    np.testing.assert_array_equal(bits(ref.params), bits(fab.params))
    np.testing.assert_array_equal(bits(jfab.params), bits(fab.params))
    assert fab.stats.steps == ref.stats.steps
    assert fab.stats.bytes_pushed == ref.stats.bytes_pushed


# ---------------------------------------------------------------------------
# cache semantics
# ---------------------------------------------------------------------------
def test_cache_invalidated_by_round_version():
    def run(pkg):
        params, grad_fn = quad_setup(pkg)
        space = space_of(pkg, params)
        fab = build_fabric(pkg, space, params, shards=2)
        plane = pkg.sv.ReadPlane(fab, max_staleness=1)
        h = harness(pkg, fab, grad_fn)
        reads = [plane.read(), plane.read()]
        h.run(1)
        reads.append(plane.read())
        h.run(2)
        reads.append(plane.read())
        errors = []
        for call in (lambda: plane.read(frontend=5),
                     lambda: plane.read_batch(0, 0)):
            with pytest.raises(ValueError) as e:
                call()
            errors.append(str(e.value))
        return fab, plane, reads, errors

    (_, jp, jreads, jerr), (fab, tp, reads, err) = both(run)
    assert_reads_same(jreads, reads)
    assert_plane_same(jp, tp)
    assert err == jerr
    r0, hit, r1, r2 = reads
    assert not r0.cache_hit and r0.version == 0 and hit.cache_hit
    assert r1.cache_hit and r1.version == 0 and r1.staleness == 1
    assert not r2.cache_hit and r2.version == fab.step and r2.staleness == 0
    assert tp.stats.refreshes == 2


def test_read_batch_amortizes_one_refresh():
    def run(pkg):
        params, grad_fn = quad_setup(pkg)
        space = space_of(pkg, params)
        fab = build_fabric(pkg, space, params, shards=2)
        harness(pkg, fab, grad_fn).run(1)
        plane = pkg.sv.ReadPlane(fab, serve_us_per_read=0.5)
        return fab, plane, plane.read_batch(0, 8)

    (_, jp, jbatch), (fab, tp, batch) = both(run)
    assert_reads_same(jbatch, batch)
    assert_plane_same(jp, tp)
    assert len(batch) == 8
    assert tp.stats.refreshes == 1 and tp.stats.reads == 8
    assert {r.version for r in batch} == {fab.step}
    assert batch[0].sim_us > 8 * 0.5
    assert all(r.sim_us == 0.0 for r in batch[1:])
    assert tp.stats.sim_serve_us == batch[0].sim_us


def test_restore_invalidates_serving_caches():
    def run(pkg):
        params, grad_fn = quad_setup(pkg)
        space = space_of(pkg, params)
        fab = build_fabric(pkg, space, params, shards=2, replication=2)
        plane = pkg.sv.ReadPlane(fab, max_staleness=5)
        h = harness(pkg, fab, grad_fn)
        h.run(2)
        snap = fab.snapshot()
        h.run(4)
        cached = plane.read(0)
        fab.restore(snap)
        return fab, plane, [cached, plane.read(0)]

    (_, jp, jreads), (fab, tp, reads) = both(run)
    assert_reads_same(jreads, reads)
    assert_plane_same(jp, tp)
    cached, r = reads
    assert cached.version == 4
    assert not r.cache_hit and r.version == fab.step == 2
    np.testing.assert_array_equal(bits(r.flat), bits(fab.params))


# ---------------------------------------------------------------------------
# routing + accounting
# ---------------------------------------------------------------------------
def test_rack_local_replica_routing_and_byte_split():
    def run(pkg):
        params, grad_fn = quad_setup(pkg)
        space = space_of(pkg, params)
        fab = build_fabric(pkg, space, params, racks=2, shards=2,
                           replication=2)
        harness(pkg, fab, grad_fn).run(1)
        src = pkg.sv.FabricSource(fab)
        routes = [src.serve_rack(s, frontend_rack=f) for s in range(2)
                  for f in range(2)]
        streams = [(s.num_chunks, s.src_rack, s.kind)
                   for f in range(2) for s in src.streams(f)]
        plane = pkg.sv.ReadPlane(fab, num_frontends=1)
        read = plane.read(0)
        return fab, space, plane, read, routes, streams

    (_, _, jp, jread, jroutes, jstreams), \
        (fab, space, tp, read, routes, streams) = both(run)
    assert_read_same(jread, read)
    assert_plane_same(jp, tp)
    assert routes == jroutes and streams == jstreams
    src = tserving.FabricSource(fab)
    assert src.serve_rack(0, frontend_rack=1) == 1
    assert src.serve_rack(1, frontend_rack=0) == 0
    elems = {s.shard_id: s.num_elems for s in fab.shards}
    assert tp.stats.bytes_rack_link == 4 * elems[1]
    assert tp.stats.bytes_core_link == 4 * elems[0]
    assert tp.stats.bytes_refreshed == 4 * space.flat_elems
    wire = fab.link.wire_us_per_chunk
    expect = (fab.shards[1].num_chunks * wire
              + fab.shards[0].num_chunks * wire
              * fab.topology.oversubscription)
    assert tp.stats.sim_serve_us == pytest.approx(
        expect + tp.serve_us_per_read)


def test_reads_survive_failover_bit_exactly():
    def run(pkg):
        params, grad_fn = quad_setup(pkg)
        space = space_of(pkg, params)
        fab = build_fabric(pkg, space, params, racks=2, shards=2,
                           replication=2)
        plane = pkg.sv.ReadPlane(fab)
        harness(pkg, fab, grad_fn).run(2)
        before = bits(fab.params)
        fab.crash_shard(0)
        return fab, plane, plane.read(0), before

    (_, jp, jread, _), (fab, tp, r, before) = both(run)
    assert_read_same(jread, r)
    assert_plane_same(jp, tp)
    assert r.version == fab.step
    np.testing.assert_array_equal(bits(r.flat), before)
    np.testing.assert_array_equal(bits(r.flat), bits(fab.params))


# ---------------------------------------------------------------------------
# tenancy: serve jobs as co-tenants
# ---------------------------------------------------------------------------
def _serve_tenant_run(pkg, link=None):
    params, grad_fn = quad_setup(pkg)
    spec = pkg.ten.JobSpec(name="train", params=params,
                           optimizer=pkg.opt.momentum(0.05, 0.9),
                           num_workers=K, chunk_elems=pkg.tile, replication=2)
    kw = {} if link is None else {"link": pkg.link(**link)}
    box = pkg.ten.MultiJobFabric(num_shards=2, num_racks=2, **kw, **pkg.kw)
    handle = box.attach(spec)
    plane = box.attach_serving(
        pkg.ten.JobSpec(name="serve", params=None, optimizer=None,
                        num_workers=2, priority=1.0, bandwidth_cap=0.25),
        "train", max_staleness=1)
    scales = (box.serve_scale(plane), box.wire_scales(handle.fabric),
              plane._scale())
    h = harness(pkg, handle, grad_fn)
    history = {handle.fabric.step: bits(handle.fabric.params)}
    reads = []
    for step in range(3):
        h.run(step + 1)
        history[handle.fabric.step] = bits(handle.fabric.params)
        for f in range(2):
            reads.append(plane.read(f))
    ded = pkg.ten.dedicated_fabric(spec, box)
    harness(pkg, ded, grad_fn).run(3)
    return box, handle, plane, scales, reads, history, ded


def test_serve_tenant_contends_but_never_perturbs_training():
    jout, tout = both(_serve_tenant_run)
    jbox, _, jp, jscales, jreads, _, _ = jout
    box, handle, plane, scales, reads, history, ded = tout
    assert_box_same(jbox, box)
    assert_reads_same(jreads, reads)
    assert_plane_same(jp, plane)
    assert scales == jscales
    assert {n: q.stats.by_job for n, q in box.links.items()} == \
        {n: q.stats.by_job for n, q in jbox.links.items()}
    assert box.serve_scale(plane) == pytest.approx(2.0)
    assert box.wire_scales(handle.fabric) == (pytest.approx(2.0),) * 2
    assert plane._scale() == pytest.approx(4.0)
    for r in reads:
        np.testing.assert_array_equal(bits(r.flat), history[r.version])
    assert sum(q.stats.by_job.get("serve", 0.0)
               for q in box.links.values()) > 0.0
    np.testing.assert_array_equal(bits(ded.params),
                                  bits(handle.fabric.params))


def test_serve_tenant_floats_match_jax_with_uneven_link():
    """A 0.7 µs-a-chunk link on the shared box: the refresh streams'
    ``demand * scale`` products, the queues' booked µs and ``sim_us`` are
    not powers of two, so a reordered product shows (the mirrored
    unit-link case cannot see one)."""
    link = dict(wire_us_per_chunk=0.7, agg_us_per_chunk=0.11)
    jout, tout = both(lambda pkg: _serve_tenant_run(pkg, link))
    jbox, _, jp, jscales, jreads, _, _ = jout
    box, _, plane, scales, reads, _, _ = tout
    assert_box_same(jbox, box)
    assert_reads_same(jreads, reads)
    assert_plane_same(jp, plane)
    assert scales == jscales
    assert {n: (q.stats.by_job, q.describe()) for n, q in box.links.items()} \
        == {n: (q.stats.by_job, q.describe()) for n, q in jbox.links.items()}
    assert plane.stats.sim_serve_us != round(plane.stats.sim_serve_us)


def test_serve_tenant_lifecycle_and_validation():
    def run(pkg):
        params, _ = quad_setup(pkg)
        spec = pkg.ten.JobSpec(name="train", params=params,
                               optimizer=pkg.opt.momentum(0.05, 0.9),
                               num_workers=K, chunk_elems=pkg.tile)
        box = pkg.ten.MultiJobFabric(num_shards=2, **pkg.kw)
        box.attach(spec)
        serve_spec = pkg.ten.JobSpec(name="serve", params=None,
                                     optimizer=None, num_workers=1)
        errors = []

        def expect(exc, call):
            with pytest.raises(exc) as e:
                call()
            errors.append(str(e.value))

        expect(KeyError, lambda: box.attach_serving(serve_spec, "nope"))
        plane = box.attach_serving(serve_spec, "train")
        described = box.describe()
        expect(ValueError, lambda: box.attach_serving(serve_spec, "train"))
        expect(ValueError, lambda: box.attach(pkg.ten.JobSpec(
            name="serve", params=quad_setup(pkg)[0],
            optimizer=pkg.opt.momentum(0.05, 0.9), num_workers=K,
            chunk_elems=pkg.tile)))
        expect(KeyError, lambda: box.detach_serving("nope"))
        box.detach("train")
        read = plane.read(0)
        expect(KeyError, lambda: box.serve_scale(plane))
        return box, plane, read, errors, described

    (jbox, jp, jread, jerr, jdesc), (box, plane, read, err, desc) = \
        both(run)
    assert err == jerr and desc == jdesc
    assert "serve serve (reads train)" in desc
    assert_read_same(jread, read)
    assert_plane_same(jp, plane)
    assert_box_same(jbox, box)
    assert not box.serving and plane.shared is None
    assert read.version == 0


def test_serve_tenants_with_hierarchy_and_shares_match_jax():
    """A hierarchical serve tenant beside a flat one on a 2-rack box with
    tenant shares applied mid-run: both planes' reads and stats, the box
    and its link queues equal JAX's."""
    def run(pkg):
        params, grad_fn = quad_setup(pkg)
        spec = pkg.ten.JobSpec(name="train", params=params,
                               optimizer=pkg.opt.sgd(0.05), num_workers=K,
                               chunk_elems=pkg.tile, replication=3)
        box = pkg.ten.MultiJobFabric(num_shards=2, num_racks=2, **pkg.kw)
        handle = box.attach(spec)
        hier = box.attach_serving(
            pkg.ten.JobSpec(name="geo", params=None, optimizer=None,
                            num_workers=1, priority=2.0),
            "train", config=hier_config(pkg))
        flat = box.attach_serving(
            pkg.ten.JobSpec(name="flat", params=None, optimizer=None,
                            num_workers=2, priority=0.5,
                            bandwidth_cap=0.5), "train", max_staleness=2)
        h = harness(pkg, handle, grad_fn)
        reads = []
        for step in range(4):
            h.run(step + 1)
            if step == 1:
                box.apply_tenant_shares({"geo": 3.0, "flat": 1.5})
            for f in range(len(hier.frontends)):
                reads.append(hier.read(f))
            reads.extend(flat.read_batch(step % 2, 3))
        return box, hier, flat, reads

    (jbox, jh, jf, jreads), (box, th, tf, reads) = both(run)
    assert_reads_same(jreads, reads)
    assert_stats_same(jh.stats, th.stats)
    assert jh.describe() == th.describe()
    assert_plane_same(jf, tf)
    assert_box_same(jbox, box)
    assert {n: q.stats.by_job for n, q in box.links.items()} == \
        {n: q.stats.by_job for n, q in jbox.links.items()}


# ---------------------------------------------------------------------------
# snapshot / checkpoint sources
# ---------------------------------------------------------------------------
def test_snapshot_source_serves_checkpointed_bits(tmp_path):
    def run(pkg):
        params, grad_fn = quad_setup(pkg)
        space = space_of(pkg, params)
        fab = build_fabric(pkg, space, params, shards=2, replication=2)
        harness(pkg, fab, grad_fn).run(3)
        ckpt = pkg.ckpt.Checkpointer(tmp_path / pkg.name)
        ckpt.save_fabric(fab.step, fab)
        state, _ = ckpt.restore()
        source = pkg.sv.SnapshotSource.from_snapshot(
            pkg.ckpt.flat_to_fabric_snapshot(state),
            chunk_elems=space.chunk_elems, **pkg.kw)
        plane = pkg.sv.ReadPlane(source, max_staleness=0)
        r = plane.read()
        source.advance(4)
        r2 = plane.read()
        with pytest.raises(ValueError) as e:
            source.publish(np.asarray(bits(r.flat).view(np.float32)),
                           r.version)
        source.publish(np.zeros(space.flat_elems, np.float32), r.version + 9)
        r3 = plane.read()
        return fab, plane, [r, r2, r3], str(e.value)

    (_, jp, jreads, jerr), (fab, plane, reads, err) = both(run)
    assert_reads_same(jreads, reads)
    assert_plane_same(jp, plane)
    assert err == jerr
    r, r2, r3 = reads
    assert r.version == fab.step and not r.cache_hit
    np.testing.assert_array_equal(bits(r.flat), bits(fab.params))
    assert plane.stats.snapshot_streams == 2  # the first read, the publish
    assert r2.cache_hit and r2.version == fab.step and r2.staleness == 4
    assert not r3.cache_hit and r3.version == r.version + 9
    assert float(r3.flat.abs().max()) == 0.0


def test_snapshot_source_owns_its_bits():
    """The caller's array or tensor may be overwritten after construction
    (or a publish): the source serves the bits it was given."""
    flat = np.arange(5000, dtype=np.float32)
    tensor = torch.arange(5000, dtype=torch.float32)
    for given in (flat, tensor):
        want = bits(given).copy()
        source = tserving.SnapshotSource(given, device="cpu")
        plane = tserving.ReadPlane(source)
        given[:] = -1
        np.testing.assert_array_equal(bits(plane.read().flat), want)
        source.publish(given, 1)
        given[:] = 7
        assert float(plane.read().flat.max()) == -1.0
    assert source.device == torch.device("cpu")


def test_dropped_planes_are_not_pinned_by_the_fabric():
    def run(pkg):
        params, grad_fn = quad_setup(pkg)
        space = space_of(pkg, params)
        fab = build_fabric(pkg, space, params, shards=2)
        plane = pkg.sv.ReadPlane(fab)
        keep = pkg.sv.ReadPlane(fab)
        harness(pkg, fab, grad_fn).run(1)
        plane.read(0)
        kept_read = keep.read(0)
        counts = [len(fab.read_planes)]
        del plane
        gc.collect()
        counts.append(sum(r() is not None for r in fab.read_planes))
        fab.restore(fab.snapshot())
        counts.append(len(fab.read_planes))
        return keep, [kept_read, keep.read(0)], counts

    (jkeep, jreads, jcounts), (keep, reads, counts) = both(run)
    assert_reads_same(jreads, reads)
    assert_plane_same(jkeep, keep)
    assert counts == jcounts == [2, 1, 1]
    assert not reads[1].cache_hit and reads[1].version == reads[0].version


def test_read_plane_rejects_bad_config():
    def run(pkg):
        params, _ = quad_setup(pkg)
        space = space_of(pkg, params)
        fab = build_fabric(pkg, space, params)
        errors = []
        for kw in ({"max_staleness": -1}, {"num_frontends": 0},
                   {"priority": 0.0}, {"bandwidth_cap": 1.5}):
            with pytest.raises(ValueError) as e:
                pkg.sv.ReadPlane(fab, **kw)
            errors.append((type(e.value).__name__, str(e.value),
                           e.value.rule))
        with pytest.raises(TypeError) as e:
            pkg.sv.FabricSource(object())
        errors.append(str(e.value))
        with pytest.raises(TypeError) as e:
            pkg.sv.ReadPlane(fab, config=pkg.cfg.ServeConfig(),
                             max_staleness=1)
        errors.append(str(e.value))
        return errors

    jerr, err = both(run)
    assert err == jerr


def test_sgd_plane_smoke_no_topology_no_replication():
    def run(pkg):
        params, grad_fn = quad_setup(pkg)
        space = space_of(pkg, params)
        fab = pkg.fabric(space, pkg.opt.sgd(0.01), space.flatten(params),
                         num_workers=K, **pkg.kw)
        plane = pkg.sv.ReadPlane(fab)
        harness(pkg, fab, grad_fn).run(1)
        return fab, plane, plane.read()

    (jfab, jp, jr), (fab, plane, r) = both(run)
    assert_read_same(jr, r)
    assert_plane_same(jp, plane)
    assert r.version == 1 and r.staleness == 0
    np.testing.assert_array_equal(bits(r.flat), bits(fab.params))
    assert "ReadPlane" in fab.describe()
    jlines = [ln for ln in jfab.describe().splitlines() if "ReadPlane" in ln]
    assert jlines == [ln for ln in fab.describe().splitlines()
                      if "ReadPlane" in ln]


# ---------------------------------------------------------------------------
# aliasing: the port's kernels write in place, a cached read must not move
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("racks", [1, 2])
@pytest.mark.parametrize("replication", [1, 2, 3])
def test_cached_read_keeps_its_versions_bits(replication, racks):
    """Read with ``max_staleness=1``, run one more round, serve the cached
    read: it must still hold its stamped version's bits (snapshotted at
    that version), though the kernels updated the slabs and the chain's
    kept buffers in place since."""
    params, grad_fn = quad_setup(PORT)
    space = space_of(PORT, params)
    fab = build_fabric(PORT, space, params, racks=racks, shards=2,
                       replication=replication)
    plane = tserving.ReadPlane(fab, max_staleness=1)
    h = harness(PORT, fab, grad_fn)
    h.run(1)
    first = plane.read(0)
    at_v1 = bits(fab.snapshot()["params"]).copy()
    np.testing.assert_array_equal(bits(first.flat), at_v1)
    h.run(2)
    cached = plane.read(0)
    assert cached.cache_hit and cached.version == 1 and cached.staleness == 1
    np.testing.assert_array_equal(bits(cached.flat), at_v1)
    np.testing.assert_array_equal(bits(first.flat), at_v1)
    assert not np.array_equal(bits(fab.params), at_v1)
    # no served tensor shares storage with a shard slab or a chain buffer
    live = [s.params for s in fab.shards]
    live += [g.tail()[1] for g in fab.replicas]
    for t in live:
        assert cached.flat.untyped_storage().data_ptr() != \
            t.untyped_storage().data_ptr()
    fresh = tserving.ReadPlane(fab, max_staleness=0).read(0)
    assert fresh.version == 2
    np.testing.assert_array_equal(bits(fresh.flat), bits(fab.params))


# ---------------------------------------------------------------------------
# SLO tier: latency tracking, admission, shedding, the hierarchical plane
# ---------------------------------------------------------------------------
def test_latency_tracker_streams_quantiles_deterministically():
    samples = np.random.default_rng(1).exponential(50.0, size=5000)

    def run(pkg):
        t = pkg.sv.LatencyTracker()
        empty = (t.quantile(0.5), t.mean_us, repr(t))
        for s in samples:
            t.record(float(s))
        a, b = pkg.sv.LatencyTracker(), pkg.sv.LatencyTracker()
        for s in samples[:2500]:
            a.record(float(s))
        for s in samples[2500:]:
            b.record(float(s))
        a.merge(b)
        errors = []
        for call in (lambda: t.record(-1.0), lambda: t.quantile(1.5),
                     lambda: t.merge(pkg.sv.LatencyTracker(
                         bins_per_decade=32)),
                     lambda: pkg.sv.LatencyTracker(lo_us=0.0)):
            with pytest.raises(ValueError) as e:
                call()
            errors.append(str(e.value))
        return t, a, empty, errors

    (jt, ja, jempty, jerr), (t, a, empty, err) = both(run)
    assert_tracker_same(jt, t)
    assert_tracker_same(ja, a)
    assert empty == jempty and err == jerr
    for q in (0.5, 0.9, 0.99, 0.999):
        exact = float(np.quantile(samples, q, method="inverted_cdf"))
        assert t.quantile(q) == pytest.approx(exact, rel=0.04)
    assert t.quantile(1.0) == samples.max() and a == t


def test_token_bucket_refills_on_the_event_clock():
    probes = [0.0, 0.0, 0.0, 1.0, 2.0, 2.0, 1000.0, 1000.0, 1000.0, 999.0,
              1000.3, 1003.7]

    def run(pkg):
        b = pkg.sv.TokenBucket(rate_per_us=0.5, burst=2)
        fates = [(b.admit(t), b.tokens, b._t) for t in probes]
        errors = []
        for args in ((0.0, 2), (1.0, 0)):
            with pytest.raises(ValueError) as e:
                pkg.sv.TokenBucket(*args)
            errors.append(str(e.value))
        return fates, errors

    (jfates, jerr), (fates, err) = both(run)
    assert fates == jfates and err == jerr
    assert [f[0] for f in fates[:10]] == [True, True, False, False, True,
                                          False, True, True, False, False]


def door_setup(pkg, *, config, serve_us_per_read=10.0):
    params, _ = quad_setup(pkg)
    space = space_of(pkg, params)
    source = pkg.sv.SnapshotSource(space.flatten(params), version=0,
                                   **pkg.kw)
    cfg = dataclasses.replace(config, serve_us_per_read=serve_us_per_read)
    plane = pkg.sv.ReadPlane(source, config=cfg)
    plane.read(0)
    return pkg.sv.FrontDoor(plane)


def _door_case(config_fn, requests_fn):
    def run(pkg):
        door = door_setup(pkg, config=config_fn(pkg.cfg))
        outs = [door.submit(r) for r in requests_fn(pkg.wl)]
        return door, outs

    (jdoor, jouts), (door, outs) = both(run)
    assert len(outs) == len(jouts)
    for a, b in zip(jouts, outs):
        assert_served_same(a, b)
    assert_stats_same(jdoor.stats, door.stats)
    assert jdoor.describe() == door.describe()
    return door, outs


def test_front_door_defaults_admit_everything():
    door, outs = _door_case(
        lambda c: c.ServeConfig(),
        lambda wl: [wl.Request(float(i), "t") for i in range(5)])
    assert all(o.admitted and o.shed is None for o in outs)
    s = door.stats
    assert s.admitted == 5 and s.shed == 0
    assert s.slo_met == 5 and s.goodput == 1.0
    assert door.stats is door.plane.stats
    assert door.plane.stats.latency.count == 5


def test_front_door_rate_limit_sheds_at_the_door():
    door, outs = _door_case(
        lambda c: c.ServeConfig(
            slos=(("t", c.SLOConfig(latency_budget_us=1e9)),),
            admission=c.AdmissionConfig(enabled=True, rate_per_us=0.01,
                                        burst=2)),
        lambda wl: [wl.Request(0.0, "t") for _ in range(5)]
        + [wl.Request(200.0, "t")])
    assert [o.shed for o in outs[:5]] == [None, None, "rate_limit",
                                          "rate_limit", "rate_limit"]
    assert not outs[2].admitted and outs[2].finish_us == outs[2].arrival_us
    s = door.stats
    assert s.shed_rate_limit == 3 and s.shed_overload == 0
    assert s.offered == 6 and s.admitted == 3 and s.slo_violations == 0
    assert outs[5].admitted


def test_overload_sheds_lower_priority_first():
    door, outs = _door_case(
        lambda c: c.ServeConfig(
            slos=(("hi", c.SLOConfig(latency_budget_us=100.0,
                                     priority=2.0)),
                  ("lo", c.SLOConfig(latency_budget_us=100.0,
                                     priority=1.0))),
            admission=c.AdmissionConfig(enabled=True, rate_per_us=10.0,
                                        burst=64, shed_slack=0.5)),
        lambda wl: [wl.Request(0.0, "lo" if i % 2 else "hi")
                    for i in range(12)] + [wl.Request(0.0, "bulk")])
    lo_fate = [o.shed for o in outs[:12] if o.tenant == "lo"]
    hi_fate = [o.shed for o in outs[:12] if o.tenant == "hi"]
    assert "overload" in lo_fate and "overload" in hi_fate
    assert lo_fate.index("overload") < hi_fate.index("overload")
    assert outs[12].admitted
    assert door.stats.shed_overload == lo_fate.count("overload") + \
        hi_fate.count("overload")


def test_admitted_requests_meet_or_violate_slo_by_latency():
    door, outs = _door_case(
        lambda c: c.ServeConfig(
            slos=(("t", c.SLOConfig(latency_budget_us=25.0)),)),
        lambda wl: [wl.Request(0.0, "t") for _ in range(4)])
    assert [o.slo_met for o in outs] == [True, True, False, False]
    assert [o.latency_us for o in outs] == [10.0, 20.0, 30.0, 40.0]
    s = door.stats
    assert s.slo_met == 2 and s.slo_violations == 2
    assert s.goodput == pytest.approx(0.5)
    assert s.latency.count == 4 and s.latency.max_us == 40.0


def test_read_plane_config_equals_legacy_kwargs():
    def run(pkg):
        params, grad_fn = quad_setup(pkg)
        space = space_of(pkg, params)
        fab = build_fabric(pkg, space, params, racks=2, shards=2,
                           replication=2)
        legacy = pkg.sv.ReadPlane(fab, max_staleness=2, num_frontends=2,
                                  serve_us_per_read=0.5)
        cfg = pkg.sv.ReadPlane(fab, config=pkg.cfg.ServeConfig(
            max_staleness=2, num_frontends=2, serve_us_per_read=0.5))
        h = harness(pkg, fab, grad_fn)
        reads = []
        for step in range(3):
            h.run(step + 1)
            for f in range(2):
                reads += [legacy.read(f), cfg.read(f)]
        return legacy, cfg, reads

    (jl, jc, jreads), (legacy, cfg, reads) = both(run)
    assert_reads_same(jreads, reads)
    assert_plane_same(jl, legacy)
    assert_plane_same(jc, cfg)
    assert legacy.config == cfg.config
    assert dataclasses.astuple(legacy.config) == dataclasses.astuple(
        jl.config)
    assert_stats_same(legacy.stats, cfg.stats)


def hier_config(pkg, **kw):
    c = pkg.cfg
    base = dict(
        max_staleness=0,
        slos=(("rt", c.SLOConfig(latency_budget_us=500.0, staleness_bound=0,
                                 priority=2.0)),
              ("bulk", c.SLOConfig(latency_budget_us=500.0,
                                   staleness_bound=8, priority=1.0))),
        hierarchy=c.HierarchyConfig(enabled=True, staleness_ladder=(0, 2, 8),
                                    frontends_per_tier=(1, 1, 2),
                                    geo_oversubscription=8.0),
    )
    base.update(kw)
    return c.ServeConfig(**base)


def test_hierarchical_plane_serves_bit_identical_on_every_tier():
    def run(pkg):
        params, grad_fn = quad_setup(pkg)
        space = space_of(pkg, params)
        fab = build_fabric(pkg, space, params, racks=2, shards=2,
                           replication=2)
        plane = pkg.sv.HierarchicalReadPlane(fab, config=hier_config(pkg))
        h = harness(pkg, fab, grad_fn)
        history = {fab.step: bits(fab.params)}
        reads = []
        for step in range(4):
            h.run(step + 1)
            history[fab.step] = bits(fab.params)
            for f in range(len(plane.frontends)):
                reads.append(plane.read(f))
        routes = [plane.route(s) for s in (0, 1, 2, 7, 8, 99)]
        total = plane.stats
        tier_stats = [plane.tier_stats(t) for t in range(3)]
        plane.move_frontend(3, 0)
        moved = plane.stats
        plane.invalidate()
        reads.append(plane.read(0))
        errors = []
        with pytest.raises(ValueError) as e:
            plane.read(4)
        errors.append(str(e.value))
        with pytest.raises(ValueError) as e:
            pkg.sv.HierarchicalReadPlane(fab, config=pkg.cfg.ServeConfig())
        errors.append(str(e.value))
        return (plane, reads, history, routes, total, tier_stats, moved,
                errors)

    jout, tout = both(run)
    jp, jreads, _, jroutes, jtotal, jtiers, jmoved, jerr = jout
    plane, reads, history, routes, total, tiers, moved, err = tout
    assert_reads_same(jreads, reads)
    assert routes == jroutes == [0, 0, 1, 1, 2, 2]
    assert err == jerr
    for a, b in zip([jtotal, jmoved] + jtiers, [total, moved] + tiers):
        assert_stats_same(a, b)
    assert_stats_same(jp.stats, plane.stats)
    assert jp.describe() == plane.describe()
    assert plane.tiers == tuple(
        type(plane.tiers[0])(**dataclasses.asdict(t)) for t in jp.tiers)
    assert len(plane.frontends) == 4
    assert plane.frontend_range(2) == (2, 4)
    for r in reads[:-1]:
        np.testing.assert_array_equal(bits(r.flat), history[r.version])
    assert total.reads == 16
    assert tiers[0].refreshes > tiers[2].refreshes
    assert total.frontend_moves == 0 and moved.frontend_moves == 1
    assert not reads[-1].cache_hit
    assert "3 tiers" in plane.describe()


def test_front_door_routes_tiers_and_lands_stats_in_slo_sink():
    def run(pkg):
        params, grad_fn = quad_setup(pkg)
        space = space_of(pkg, params)
        fab = build_fabric(pkg, space, params, racks=2, shards=2,
                           replication=2)
        plane = pkg.sv.HierarchicalReadPlane(fab, config=hier_config(pkg))
        for f in range(len(plane.frontends)):
            plane.read(f)
        door = pkg.sv.FrontDoor(plane)
        R = pkg.wl.Request
        outs = [door.submit(R(0.0, "rt", staleness_req=0)),
                door.submit(R(0.0, "bulk", staleness_req=8)),
                door.submit(R(0.0, "bulk", staleness_req=8))]
        return plane, door, outs

    (jp, jdoor, jouts), (plane, door, outs) = both(run)
    for a, b in zip(jouts, outs):
        assert_served_same(a, b)
    assert_stats_same(jp.stats, plane.stats)
    assert_stats_same(jdoor.stats, door.stats)
    assert jdoor.describe() == door.describe()
    rt, bulk, again = outs
    assert rt.tier == 0 and bulk.tier == 2
    assert rt.latency_us == pytest.approx(
        plane.tiers[0].latency_floor_us + rt.result.sim_us)
    assert bulk.latency_us == pytest.approx(bulk.result.sim_us)
    assert door.stats is plane.slo_stats
    assert plane.stats.admitted == 3 and plane.stats.latency.count == 3
    lo, _ = plane.frontend_range(2)
    assert bulk.frontend == lo and again.frontend == lo + 1


def _trace_config(c):
    return c.WorkloadConfig(tenants=(
        c.TenantLoadConfig(name="rt",
                           arrival=c.ArrivalConfig(process="poisson",
                                                   interarrival_us=20.0),
                           n_requests=15, staleness_req=0),
        c.TenantLoadConfig(name="bulk",
                           arrival=c.ArrivalConfig(process="mmpp",
                                                   interarrival_us=10.0,
                                                   burst_factor=5.0,
                                                   burst_dwell_us=60.0),
                           n_requests=25, staleness_req=8),
        c.TenantLoadConfig(name="cl", clients=2, think_us=15.0,
                           requests_per_client=6, staleness_req=8),
    ))


def test_trace_replay_yields_bit_identical_stats():
    """The same trace against the two packages' stacks, and against the
    port's twice (the second time through the trace's JSON round trip):
    every outcome, every stat and the trained bits equal."""
    def run_once(pkg, trace):
        params, grad_fn = quad_setup(pkg)
        space = space_of(pkg, params)
        fab = build_fabric(pkg, space, params, racks=2, shards=2,
                           replication=2)
        plane = pkg.sv.HierarchicalReadPlane(fab, config=hier_config(
            pkg, admission=pkg.cfg.AdmissionConfig(
                enabled=True, rate_per_us=0.5, burst=4, shed_slack=0.8)))
        for f in range(len(plane.frontends)):
            plane.read(f)
        h = harness(pkg, fab, grad_fn)
        fired = [0]

        def on_time(now):
            while fired[0] < 5 and now >= (fired[0] + 1) * 60.0:
                h.run(fired[0] + 1)
                fired[0] += 1

        door = pkg.sv.FrontDoor(plane)
        return door, door.run(trace, on_time=on_time), bits(fab.params)

    jtrace = jworkload.generate_trace(_trace_config(jconfig), 21)
    ttrace = tworkload.generate_trace(_trace_config(tconfig), 21)
    assert ttrace.to_json() == jtrace.to_json()
    jd, jo, jbits = run_once(JAX, jtrace)
    d1, o1, bits1 = run_once(PORT, ttrace)
    d2, o2, bits2 = run_once(
        PORT, tworkload.WorkloadTrace.from_json(ttrace.to_json()))
    for door, outs, b in ((d1, o1, bits1), (d2, o2, bits2)):
        assert len(outs) == len(jo)
        for a, o in zip(jo, outs):
            assert_served_same(a, o)
        assert_stats_same(jd.stats, door.stats)
        assert jd.describe() == door.describe()
        np.testing.assert_array_equal(b, jbits)
    assert {o.shed for o in o1} >= {None} and any(o.admitted for o in o1)
    assert "FrontDoor" in d1.describe()


@pytest.mark.parametrize("variant", ["open", "closed", "diurnal", "flash"])
def test_front_door_runs_generated_traces_like_jax(variant):
    """``FrontDoor.run`` over ``generate_trace`` traces of each shape, on
    a flat 2-frontend plane over a 2-rack R = 2 fabric with admission on:
    every outcome and stat equal to JAX's (the chip's SMOKE sweep runs the
    same four traces card against CPU)."""
    def tenants(c):
        if variant == "closed":
            return (c.TenantLoadConfig(name="c", clients=3, think_us=12.0,
                                       requests_per_client=5,
                                       staleness_req=1),)
        mods = {}
        if variant == "diurnal":
            mods["diurnal"] = c.DiurnalConfig(enabled=True, amplitude=0.6,
                                              period_us=300.0, phase=0.1)
        if variant == "flash":
            mods["flash"] = c.FlashCrowdConfig(enabled=True, at_us=50.0,
                                               duration_us=80.0,
                                               magnitude=6.0)
        return (c.TenantLoadConfig(name="o", n_requests=30, batch_max=2,
                                   arrival=c.ArrivalConfig(
                                       interarrival_us=7.0), **mods),
                c.TenantLoadConfig(name="p", n_requests=20,
                                   arrival=c.ArrivalConfig(
                                       process="poisson",
                                       interarrival_us=9.0)))

    def run(pkg):
        c = pkg.cfg
        trace = pkg.wl.generate_trace(c.WorkloadConfig(tenants=tenants(c)),
                                      3)
        params, grad_fn = quad_setup(pkg)
        space = space_of(pkg, params)
        fab = build_fabric(pkg, space, params, racks=2, shards=2,
                           replication=2)
        plane = pkg.sv.ReadPlane(fab, config=c.ServeConfig(
            num_frontends=2, max_staleness=1, serve_us_per_read=2.0,
            slos=(("o", c.SLOConfig(latency_budget_us=40.0, priority=2.0)),
                  ("c", c.SLOConfig(latency_budget_us=60.0,
                                    staleness_bound=1))),
            admission=c.AdmissionConfig(enabled=True, rate_per_us=0.2,
                                        burst=3, shed_slack=0.7)))
        h = harness(pkg, fab, grad_fn)
        fired = [0]

        def on_time(now):
            while fired[0] < 4 and now >= (fired[0] + 1) * 50.0:
                h.run(fired[0] + 1)
                fired[0] += 1

        door = pkg.sv.FrontDoor(plane)
        return trace, door, door.run(trace, on_time=on_time)

    (jtrace, jd, jo), (trace, d, o) = both(run)
    assert trace.to_json() == jtrace.to_json()
    assert len(o) == len(jo) > 0
    for a, b in zip(jo, o):
        assert_served_same(a, b)
    assert_plane_same(jd.plane, d.plane)
    assert jd.describe() == d.describe()
