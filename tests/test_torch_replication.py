"""The PyTorch fault tier against the JAX one, bitwise.

Mirrors tests/test_replication.py: chain-replicated shards, deterministic
fault injection, failover, worker crash and re-entry, link faults, the
snapshot/restore hooks and the seeded chaos soaks.  Both fabrics are built
from ``FabricConfig`` with the same numpy-made gradients, and every case
holds params, optimizer state, every ``ServerStats`` / ``ShardStats`` /
``RackStats`` field (the event clock's ``sim_*`` floats included), the
residuals, ``fault_trace`` and ``export_fault_trace()`` equal bit for bit
(``assert_fault_same``).  Inside the port, a sync run that crashes and
fails over at any round is bitwise equal to the failure-free run, for 1
and 2 racks, 1-4 shards and every codec (the JAX package's headline
invariant), and the chain never aliases the slab the kernels write.  The
two tenancy cases (a co-tenant's shard crash, a box-wide engine crash) run
each ``MultiJobFabric`` on both packages and compare them with
``tests/test_torch_tenancy.assert_box_same``.

``test_chaos_sparse_table_failover`` runs in its 1-rack form and, with the
sparse tier under a topology, its 2-rack form (the JAX test's).
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import test_torch_tenancy as tenancy  # noqa: E402
from test_torch_topology import assert_same  # noqa: E402

from repro.core import sparse as jsparse  # noqa: E402
from repro.core.chunking import TILE_ELEMS as JAX_TILE  # noqa: E402
from repro.core.chunking import ParamSpace as JaxSpace  # noqa: E402
from repro.core.compression import CompressionConfig as JaxCompression  # noqa: E402
from repro.core.config import FabricConfig as JaxConfig  # noqa: E402
from repro.core.config import FaultConfig as JaxFaults  # noqa: E402
from repro.core.config import PlacementConfig as JaxPlacement  # noqa: E402
from repro.core.config import WireConfig as JaxWire  # noqa: E402
from repro.core.fabric import LinkModel as JaxLink  # noqa: E402
from repro.core.fabric import PBoxFabric as JaxFabric  # noqa: E402
from repro.core.fabric import WorkerHarness as JaxHarness  # noqa: E402
from repro.core.replication import FaultEvent as JaxEvent  # noqa: E402
from repro.core.replication import FaultPlan as JaxPlan  # noqa: E402
from repro.core.replication import ReplicaGroup as JaxGroup  # noqa: E402
from repro.core.replication import ShardLost as JaxShardLost  # noqa: E402
from repro.core.topology import NetworkTopology as JaxTopology  # noqa: E402
from repro.core.placement import PlacementPlan as JaxPlacementPlan  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro.runtime.elastic import worker_reentry as jax_reentry  # noqa: E402
from repro_torch.core import sparse as tsparse  # noqa: E402
from repro_torch.core.chunking import TILE_ELEMS, ParamSpace  # noqa: E402
from repro_torch.core.compression import CompressionConfig  # noqa: E402
from repro_torch.core.config import (  # noqa: E402
    FabricConfig,
    FaultConfig,
    PlacementConfig,
    WireConfig,
)
from repro_torch.core.fabric import LinkModel, PBoxFabric, WorkerHarness  # noqa: E402
from repro_torch.core.replication import (  # noqa: E402
    FaultEvent,
    FaultPlan,
    ReplicaGroup,
    ShardLost,
)
from repro_torch.core.topology import NetworkTopology  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402
from repro_torch.runtime.elastic import worker_reentry  # noqa: E402

K = 4  # workers
LINK = dict(wire_us_per_chunk=1.0, agg_us_per_chunk=0.2)
SPECS = {"momentum": lambda o: o.momentum(0.1, 0.9),
         "sgd": lambda o: o.sgd(0.1),
         "adamw": lambda o: o.adamw(3e-3)}


# ---------------------------------------------------------------------------
# the pair of fabrics
# ---------------------------------------------------------------------------
def jax_plan(plan):
    """The JAX package's twin of a port ``PlacementPlan``."""
    return JaxPlacementPlan(
        num_shards=plan.num_shards, num_racks=plan.num_racks,
        replication=plan.replication,
        replica_racks=np.asarray(plan.replica_racks),
        frontend_racks=plan.frontend_racks, chunk_owner=plan.chunk_owner,
        origin=plan.origin)


def configs(*, shards=2, racks=1, codec="none", replication=1, events=(),
            link=LINK, policy="contiguous", plan=None, **fields):
    """(JAX config, port config) of one fabric; ``events`` are (round,
    kind, target[, factor]) tuples of its fault plan, ``plan`` a port
    ``PlacementPlan``."""
    events = list(events)
    return (
        JaxConfig(num_shards=shards, num_workers=K, **fields,
                  placement=JaxPlacement(
                      policy=policy,
                      plan=None if plan is None else jax_plan(plan)),
                  wire=JaxWire(
                      topology=JaxTopology(K, racks) if racks > 1 else None,
                      compression=JaxCompression(codec=codec),
                      link=JaxLink(**link)),
                  faults=JaxFaults(
                      replication=replication,
                      fault_plan=JaxPlan(JaxEvent(*e) for e in events)
                      if events else None)),
        FabricConfig(num_shards=shards, num_workers=K, **fields,
                     placement=PlacementConfig(policy=policy, plan=plan),
                     wire=WireConfig(
                         topology=(NetworkTopology(K, racks) if racks > 1
                                   else None),
                         compression=CompressionConfig(codec=codec),
                         link=LinkModel(**link)),
                     faults=FaultConfig(
                         replication=replication,
                         fault_plan=FaultPlan(FaultEvent(*e) for e in events)
                         if events else None)),
    )


def elems(chunks=8):
    return chunks * TILE_ELEMS - 200


def pair(*, chunks=8, spec="momentum", init=None, **kw):
    """The JAX fabric and the port's (on the CPU) over one flat space of
    ``chunks`` chunks."""
    n = elems(chunks)
    jspace = JaxSpace.build({"w": jnp.zeros((n,))}, chunk_elems=JAX_TILE)
    tspace = ParamSpace.build({"w": torch.zeros(n)}, chunk_elems=TILE_ELEMS)
    init = np.zeros(jspace.flat_elems, np.float32) if init is None else init
    jcfg, tcfg = configs(**kw)
    ref = JaxFabric(jspace, SPECS[spec](jopt), jnp.asarray(init),
                    config=jcfg)
    fab = PBoxFabric(tspace, SPECS[spec](topt), torch.from_numpy(init.copy()),
                     config=tcfg, device="cpu")
    return ref, fab


def port(**kw):
    return pair(**kw)[1]


def make_grads(flat_elems, seed=0, n=K):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(flat_elems).astype(np.float32)
            for _ in range(n)]


def _to(fab, g):
    return torch.from_numpy(g) if isinstance(fab, PBoxFabric) else \
        jnp.asarray(g)


def drive(fab, grads, rounds, start=0):
    """Sync rounds with per-round gradient rotation (the pull keeps the
    push fresh for quorum admission)."""
    for r in range(start, start + rounds):
        for w in range(K):
            fab.pull(w)
            fab.push(w, _to(fab, grads[(w + r) % len(grads)]))


def outcome(fn):
    """The exception ``fn()`` raised, or None."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - compared across packages
        return e
    return None


def both(ref, fab, run):
    """Run ``run(fabric)`` on both fabrics; they must raise alike."""
    je, te = outcome(lambda: run(ref)), outcome(lambda: run(fab))
    assert type(je).__name__ == type(te).__name__, (je, te)
    assert str(je) == str(te)
    return te


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def assert_fault_same(ref, fab):
    """``assert_same`` (params, state, every stats field, residuals,
    clocks, fault_trace) plus the fault tier's own state."""
    assert_same(ref, fab)
    assert ref.export_fault_trace() == fab.export_fault_trace()
    assert ref.dead_workers == fab.dead_workers
    assert ref._link_degrade == fab._link_degrade
    np.testing.assert_array_equal(ref.chunk_owner, fab.chunk_owner)
    np.testing.assert_array_equal(ref.plan.replica_racks,
                                  fab.plan.replica_racks)
    assert len(ref.replicas) == len(fab.replicas)
    for jg, tg in zip(ref.replicas, fab.replicas):
        assert (jg.racks, jg.synced_round, jg.num_backups) == \
            (tg.racks, tg.synced_round, tg.num_backups)
        for (jids, jp, js), (tids, tp, ts) in zip(jg.copies, tg.copies):
            np.testing.assert_array_equal(jids, tids)
            np.testing.assert_array_equal(_bits(jp), _bits(tp.numpy()))
            for a, b in zip(js, ts):
                np.testing.assert_array_equal(_bits(a), _bits(b.numpy()))


def same_bits(a: PBoxFabric, b: PBoxFabric) -> bool:
    return torch.equal(a.params.view(torch.int32), b.params.view(torch.int32))


# ---------------------------------------------------------------------------
# FaultPlan: determinism, serialization, validation
# ---------------------------------------------------------------------------
def test_fault_plan_generate_is_deterministic():
    kw = dict(rounds=50, num_shards=8, num_workers=K, num_racks=4,
              shard_crash_rate=0.3, worker_crash_rate=0.2,
              link_degrade_rate=0.2, switch_fail_rate=0.1)
    a, b = FaultPlan.generate(7, **kw), FaultPlan.generate(7, **kw)
    assert a.events == b.events and len(a) > 0
    assert a.events != FaultPlan.generate(8, **kw).events
    assert a.to_json() == JaxPlan.generate(7, **kw).to_json()


def test_fault_plan_json_roundtrip():
    plan = FaultPlan.generate(3, rounds=20, num_shards=2, num_workers=K,
                              shard_crash_rate=0.5, worker_crash_rate=0.3,
                              link_degrade_rate=0.3)
    doc = json.dumps(plan.to_json())
    assert FaultPlan.from_json(doc).events == plan.events
    assert JaxPlan.from_json(doc).to_json() == plan.to_json()
    assert plan.describe() == JaxPlan.from_json(doc).describe()


def test_fault_plan_validation():
    for args, match in (((1, "meteor_strike", 0), "unknown fault kind"),
                        ((0, "shard_crash", 0), "rounds start at 1"),
                        ((1, "link_degrade", 0, 0.5), "factor")):
        with pytest.raises(ValueError, match=match) as te:
            FaultEvent(*args)
        with pytest.raises(ValueError) as je:
            JaxEvent(*args)
        assert str(te.value) == str(je.value)
    plan = FaultPlan([FaultEvent(3, "shard_crash", 0),
                      FaultEvent(1, "worker_crash", 1)])
    assert [e.round for e in plan.events] == [1, 3]  # sorted
    assert plan.between(0, 2) == (plan.events[0],)
    assert plan.between(2, 3) == (plan.events[1],)
    assert plan.max_round == 3


def test_replica_group_promote_and_chain():
    group, ref = ReplicaGroup(0, 3, racks=(0, 1, 2)), JaxGroup(0, 3, (0, 1, 2))
    assert group.hop_racks() == ref.hop_racks() == ((0, 1), (1, 2))
    assert group.state_bytes(2, 1000) == ref.state_bytes(2, 1000) == 12000
    assert group.describe() == ref.describe()
    for bad in ((0, 1, (0,)), (0, 2, (0,))):
        with pytest.raises(ValueError) as te:
            ReplicaGroup(*bad)
        with pytest.raises(ValueError) as je:
            JaxGroup(*bad)
        assert str(te.value) == str(je.value)
    with pytest.raises(ShardLost) as te:
        group.promote()
    with pytest.raises(JaxShardLost) as je:
        ref.promote()
    assert str(te.value) == str(je.value)
    with pytest.raises(ShardLost):
        group.tail()
    # one shared copy for both backups, copied (not referenced) on sync
    fab = port(shards=2, replication=3)
    group = fab.replicas[0]
    (ids0, p0, s0), (ids1, p1, s1) = group.copies
    assert p0 is p1 and s0 is s1 and group.tail()[1] is p1
    shard = fab.shards[0]
    assert p0.data_ptr() != shard.params.data_ptr()
    assert torch.equal(p0, shard.params)
    np.testing.assert_array_equal(ids0, shard.chunk_ids)


# ---------------------------------------------------------------------------
# the headline invariant: failover bit-identity, port == JAX
# ---------------------------------------------------------------------------
CRASHES = lambda shards: [(1, "shard_crash", 0),  # noqa: E731
                          (3, "shard_crash", shards - 1),
                          (4, "shard_crash", 0)]


@pytest.mark.parametrize("racks", [1, 2, 4])
@pytest.mark.parametrize("shards", [1, 2, 8])
def test_failover_bit_identical(racks, shards):
    """R=2: shard crash + failover + re-silvering at scheduled rounds, the
    port against the JAX fabric, and against its own failure-free run."""
    ref, fab = pair(shards=shards, racks=racks, replication=2,
                    events=CRASHES(shards))
    base = port(shards=shards, racks=racks)
    grads = make_grads(fab.space.flat_elems)
    for f in (ref, fab, base):
        drive(f, grads, 6)
    assert_fault_same(ref, fab)
    assert same_bits(base, fab)
    assert (fab.stats.failovers, fab.stats.resilvers,
            fab.stats.shards_crashed) == (3, 3, 3)
    assert fab.stats.bytes_resilver > 0


@pytest.mark.parametrize("codec", ["none", "bf16", "int8"])
def test_failover_bit_identical_under_codecs(codec):
    ref, fab = pair(shards=2, racks=2, codec=codec, replication=2,
                    events=[(2, "shard_crash", 1)])
    base = port(shards=2, racks=2, codec=codec)
    grads = make_grads(fab.space.flat_elems, seed=3)
    for f in (ref, fab, base):
        drive(f, grads, 5)
    assert_fault_same(ref, fab)
    assert same_bits(base, fab) and fab.stats.failovers == 1


@pytest.mark.parametrize("codec", ["none", "bf16", "int8"])
@pytest.mark.parametrize("shards", [1, 2, 3, 4])
@pytest.mark.parametrize("racks", [1, 2])
def test_failover_at_any_round_equals_failure_free(racks, shards, codec):
    """Inside the port: a crash of any shard at any scheduled round fails
    over to the failure-free run's bits (params and optimizer state)."""
    rounds = 3
    base = port(shards=shards, racks=racks, codec=codec, spec="adamw")
    grads = make_grads(base.space.flat_elems, seed=shards)
    drive(base, grads, rounds)
    want = [base.params] + [base._assemble_rows(lambda s, k=k: s.state[k])
                            for k in range(2)]
    for r in range(1, rounds + 1):
        fab = port(shards=shards, racks=racks, codec=codec, spec="adamw",
                   replication=2,
                   events=[(r, "shard_crash", (r - 1) % shards)])
        drive(fab, grads, rounds)
        got = [fab.params] + [fab._assemble_rows(lambda s, k=k: s.state[k])
                              for k in range(2)]
        assert all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for a, b in zip(want, got)), f"crash at round {r}"
        assert fab.stats.failovers == 1


def test_failover_uses_post_round_state_not_initial():
    ref, fab = pair(chunks=4, shards=2, replication=2)
    grads = make_grads(fab.space.flat_elems, seed=5)
    for f in (ref, fab):
        drive(f, grads, 3)
    before = fab.params.clone()
    assert fab.replicas[0].synced_round == fab.step
    assert fab.crash_shard(0) == ref.crash_shard(0) == "failed_over"
    assert torch.equal(before, fab.params)
    assert_fault_same(ref, fab)


def test_shard_lost_with_r1_is_diagnosable():
    ref, fab = pair(shards=2, events=[(2, "shard_crash", 1)])
    grads = make_grads(fab.space.flat_elems)
    exc = both(ref, fab, lambda f: drive(f, grads, 6))
    assert isinstance(exc, ShardLost)
    assert (exc.shard_id, exc.num_chunks, exc.round, exc.replication) == \
        (1, 4, 2, 1)
    assert "replication>=2" in str(exc)
    assert fab.fault_trace[-1]["event"]["kind"] == "shard_crash"
    assert ref.fault_trace == fab.fault_trace
    assert ref.export_fault_trace() == fab.export_fault_trace()


def test_async_failover_keeps_serving():
    ref, fab = pair(chunks=4, shards=2, mode="async", replication=2,
                    events=[(3, "shard_crash", 0)])
    grads = make_grads(fab.space.flat_elems)
    for f in (ref, fab):
        for _ in range(3):
            for w in range(K):
                f.pull(w)
                f.push(w, _to(f, grads[w]))
    assert fab.stats.failovers == 1
    assert torch.isfinite(fab.params).all()
    assert_fault_same(ref, fab)


def test_consecutive_crashes_never_alias_the_live_slab():
    """R=3 with crashes of one shard in consecutive rounds: after each
    failover the replacement's slab is the promoted copy itself, the chain
    holds the crashed engine's buffers (nothing allocated), and no backup
    shares storage with the slab the kernels write in place."""
    ref, fab = pair(shards=2, replication=3, spec="adamw",
                    events=[(1, "shard_crash", 0), (2, "shard_crash", 0),
                            (3, "shard_crash", 1)])
    base = port(shards=2, spec="adamw")
    grads = make_grads(fab.space.flat_elems, seed=9)

    def ptrs(tensors):
        return {t.untyped_storage().data_ptr() for t in tensors}

    dead = []
    crash = fab.crash_shard

    def spy(shard_id):
        sh = fab.shards[shard_id]
        dead.append(ptrs([sh.params, *sh.state]))
        return crash(shard_id)

    fab.crash_shard = spy
    for r in range(4):
        chain = fab.replicas[0]
        held = ptrs([chain._buf[0], *chain._buf[1]])
        for f in (ref, fab, base):
            drive(f, grads, 1, start=r)
        if r in (0, 1):  # shard 0 crashed at this round's edge
            new = fab.shards[0]
            assert ptrs([new.params, *new.state]) == held  # promoted as is
            chain = fab.replicas[0]
            # the crashed engine's buffers took the re-silvered copy
            assert ptrs([chain._buf[0], *chain._buf[1]]) == dead[-1]
        for group, shard in zip(fab.replicas, fab.shards):
            for _, p, st in group.copies:
                assert not ptrs([p, *st]) & ptrs([shard.params, *shard.state])
                before = [p.clone(), *(s.clone() for s in st)]
                live = shard.params.clone()
                shard.params.add_(1.0)  # what an in-place kernel would do
                assert all(torch.equal(a, b) for a, b in
                           zip(before, [p, *st]))
                shard.params.copy_(live)
    assert fab.stats.failovers == 3
    assert same_bits(base, fab)
    assert_fault_same(ref, fab)


def test_replication_one_allocates_no_chain():
    fab = port(shards=2, events=[(1, "link_degrade", 0, 2.0)])
    assert fab.replicas == [] and fab.replication == 1
    drive(fab, make_grads(fab.space.flat_elems), 2)
    assert fab.replicas == [] and fab.stats.bytes_replication == 0
    assert fab.stats.replication_rounds == 0


# ---------------------------------------------------------------------------
# replication accounting
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("spec,slots", [("momentum", 1), ("sgd", 0)])
def test_replication_byte_accounting_exact(spec, slots):
    rounds, r = 3, 3
    ref, fab = pair(shards=2, replication=r, spec=spec)
    grads = make_grads(fab.space.flat_elems)
    for f in (ref, fab):
        drive(f, grads, rounds)
    assert fab.stats.bytes_replication == \
        rounds * (r - 1) * 4 * fab.space.flat_elems * (1 + slots)
    assert fab.stats.replication_rounds == rounds
    assert fab.stats.sim_replication_us > 0.0
    assert_fault_same(ref, fab)


def test_replication_traffic_lands_on_link_tiers():
    ref, fab = pair(shards=2, racks=2, replication=2)
    flat = port(shards=2, racks=2)
    grads = make_grads(fab.space.flat_elems)
    for f in (ref, fab, flat):
        drive(f, grads, 2)
    extra = fab.stats.bytes_core_link - flat.stats.bytes_core_link
    assert extra == fab.stats.bytes_replication > 0
    assert fab.stats.bytes_rack_link == flat.stats.bytes_rack_link
    assert_fault_same(ref, fab)


def test_anti_affine_replica_placement():
    topo, jtopo = NetworkTopology(8, 4), JaxTopology(8, 4)
    racks = topo.replica_racks(num_shards=8, factor=3)
    np.testing.assert_array_equal(racks, jtopo.replica_racks(8, 3))
    assert all(len(set(racks[s])) == 3 for s in range(8))
    fab = port(shards=4, racks=4, replication=3)
    assert [g.racks for g in fab.replicas] == \
        [tuple(int(r) for r in row) for row in jtopo.replica_racks(4, 3)]
    assert topo.hop_cost(0, 1) == topo.oversubscription


@pytest.mark.parametrize("racks", [1, 2])
def test_link_degrade_slows_the_clock_like_jax(racks):
    """A degraded rack link scales the rack stage of the event clock by
    the worst active factor until it is restored: timing only."""
    events = [(1, "link_degrade", racks - 1, 3.0), (2, "link_degrade", 0, 2.5),
              (3, "link_restore", racks - 1), (4, "link_restore", 0)]
    ref, fab = pair(shards=2, racks=racks, events=events)
    base = port(shards=2, racks=racks)
    grads = make_grads(fab.space.flat_elems)
    for f in (ref, fab, base):
        drive(f, grads, 5)
    assert_fault_same(ref, fab)
    assert same_bits(base, fab)
    assert fab.stats.sim_wire_us > base.stats.sim_wire_us
    assert fab.stats.link_degrades == 2 and not fab._link_degrade
    assert [t["action"] for t in fab.fault_trace] == [
        "link_degraded_x3", "link_degraded_x2.5", "link_restored",
        "link_restored"]
    if racks > 1:  # a rack outside the topology is refused alike
        bad = pair(racks=racks, events=[(1, "link_degrade", 5, 2.0)])
        assert "link_degrade targets rack 5" in str(
            both(*bad, lambda f: drive(f, grads, 1)))


# ---------------------------------------------------------------------------
# worker crash / re-entry
# ---------------------------------------------------------------------------
def quadratic_pair(seed=0, *, shards=2, **kw):
    """The quadratic job (workers minimize ||w - t_w||^2) on both
    fabrics: (ref, fab, JAX grad_fn, port grad_fn)."""
    n = elems(3)
    rng = np.random.default_rng(seed)
    targets = [rng.standard_normal(n).astype(np.float32) for _ in range(K)]
    ref, fab = pair(chunks=3, shards=shards, **kw)
    jt = [jnp.asarray(t) for t in targets]
    tt = [torch.from_numpy(t) for t in targets]

    def jgrad(p, batch):
        return {"w": 2 * (p["w"] - jt[batch % K])}

    def tgrad(p, batch):
        return {"w": 2 * (p["w"] - tt[batch % K])}

    return ref, fab, jgrad, tgrad


def test_worker_crash_shrinks_barrier_and_reenters():
    ref, fab, jgrad, tgrad = quadratic_pair(
        spec="momentum", min_push_fraction=0.75,
        events=[(2, "worker_crash", 3), (5, "worker_recover", 3)])
    hj = JaxHarness(ref, jgrad, lambda w, s: w)
    ht = WorkerHarness(fab, tgrad, lambda w, s: w)
    hj.run(8)
    ht.run(8)
    assert hj.steps_done == ht.steps_done
    assert fab.stats.workers_crashed == fab.stats.workers_recovered == 1
    assert not fab.dead_workers
    assert min(ht.steps_done) >= 8 - 3
    assert [t["event"]["kind"] for t in fab.fault_trace] == \
        ["worker_crash", "worker_recover"]
    assert_fault_same(ref, fab)


def test_worker_crash_full_barrier_does_not_deadlock():
    ref, fab, jgrad, tgrad = quadratic_pair(
        seed=1, shards=1, events=[(1, "worker_crash", 0)])
    hj = JaxHarness(ref, jgrad, lambda w, s: w)
    ht = WorkerHarness(fab, tgrad, lambda w, s: w)
    hj.run(4)
    ht.run(4)
    assert fab.stats.steps >= 4 and 0 in fab.dead_workers
    assert ht.steps_done[0] < 4 and hj.steps_done == ht.steps_done
    assert_fault_same(ref, fab)


def test_crashed_worker_push_raises():
    ref, fab = pair(chunks=2, shards=1)
    for f in (ref, fab):
        f.crash_worker(2)
    exc = both(ref, fab, lambda f: f.push(2, _to(f, np.zeros(
        f.space.flat_elems, np.float32))))
    assert "worker 2 crashed" in str(exc)
    for bad in (-1, K):
        assert isinstance(both(ref, fab, lambda f: f.crash_worker(bad)),
                          ValueError)


def test_crash_drops_in_flight_stream_and_fires_barrier():
    ref, fab = pair(chunks=2, shards=1)
    grads = make_grads(fab.space.flat_elems)
    for f in (ref, fab):
        for w in range(K - 1):
            f.pull(w)
            f.push(w, _to(f, grads[w]))
        assert f.stats.steps == 0  # waiting on worker 3
        f.crash_worker(K - 1)
        assert f.stats.steps == 1  # barrier shrank, round fired
        assert int(f.worker_clock[K - 1]) == 0
    assert_fault_same(ref, fab)
    # a crash that takes an inboxed push rolls its clock back
    for f in (ref, fab):
        f.pull(0)
        f.push(0, _to(f, grads[0]))
        f.crash_worker(0)
    assert int(fab.worker_clock[0]) == 1 and not fab._inbox
    assert_fault_same(ref, fab)


def test_worker_reentry_reuses_snapshot_contract():
    ref, fab = pair(chunks=2, shards=2, min_push_fraction=0.5)
    grads = make_grads(fab.space.flat_elems)
    for f in (ref, fab):
        drive(f, grads, 3)
        f.crash_worker(1)
    jsnap, snap = jax_reentry(ref, 1), worker_reentry(fab, 1)
    np.testing.assert_array_equal(_bits(snap["params"]),
                                  _bits(fab.params.numpy()))
    np.testing.assert_array_equal(_bits(snap["params"]),
                                  _bits(jsnap["params"]))
    assert fab.alive(1)
    assert int(fab.worker_clock[1]) == int(snap["step"]) == fab.step
    before = fab.stats.late_pushes_dropped
    for f in (ref, fab):
        f.pull(1)
        f.push(1, _to(f, grads[1]))
    assert fab.stats.late_pushes_dropped == before
    assert_fault_same(ref, fab)


def test_ssp_staleness_excludes_dead_worker():
    ref, fab = pair(chunks=2, shards=1, mode="stale", staleness=1)
    grads = make_grads(fab.space.flat_elems)
    for f in (ref, fab):
        f.crash_worker(0)
        assert not f.can_proceed(0)
        for _ in range(3):
            for w in range(1, K):
                f.pull(w)
                f.push(w, _to(f, grads[w]))
        assert all(f.can_proceed(w) for w in range(1, K))
    assert_fault_same(ref, fab)


# ---------------------------------------------------------------------------
# snapshot / restore with the fault tier
# ---------------------------------------------------------------------------
def test_snapshot_rolls_back_in_flight_pushes():
    ref, fab = pair(chunks=2, shards=1)
    grads = make_grads(fab.space.flat_elems)
    for f in (ref, fab):
        drive(f, grads, 2)
        f.pull(0)
        f.push(0, _to(f, grads[0]))
    snap = fab.snapshot()
    assert int(fab.worker_clock[0]) == 3
    assert list(snap["worker_clock"]) == [2] * K
    jsnap = ref.snapshot()
    ref2, fab2 = pair(chunks=2, shards=1)
    ref2.restore(jsnap)
    fab2.restore(snap)
    for f in (ref2, fab2):
        drive(f, grads, 2, start=2)
    want = port(chunks=2, shards=1)
    drive(want, grads, 4)
    assert same_bits(want, fab2)
    assert_fault_same(ref2, fab2)


def test_restore_round_trips_dead_workers():
    ref, fab = pair(chunks=2, shards=2, replication=2)
    for f in (ref, fab):
        f.crash_worker(2)
    snap = fab.snapshot()
    assert list(snap["dead_workers"]) == [2] and snap["replication"] == 2
    ref2, fab2 = pair(chunks=2, shards=2, replication=2)
    ref2.restore(ref.snapshot())
    fab2.restore(snap)
    assert fab2.dead_workers == {2}
    assert_fault_same(ref2, fab2)
    legacy = {k: v for k, v in snap.items()
              if k not in ("dead_workers", "replication")}
    ref3, fab3 = pair(chunks=2, shards=2, replication=2)
    for f in (ref3, fab3):
        f.crash_worker(1)
        f.restore(legacy)
        assert not f.dead_workers
        f.crash_shard(0)  # chains re-synced from the restored bits
    assert torch.equal(fab2.params, fab3.params)
    assert_fault_same(ref3, fab3)


def test_restore_rewinds_fault_cursor_for_replay():
    ref, fab = pair(chunks=4, shards=2, replication=2,
                    events=[(4, "shard_crash", 0),
                            (3, "link_degrade", 0, 2.0)])
    grads = make_grads(fab.space.flat_elems)
    snaps = {}
    for f in (ref, fab):
        for r in range(6):
            drive(f, grads, 1, start=r)
            if f.step == 2:
                snaps[id(f)] = f.snapshot()
    assert fab.stats.failovers == 1
    first = fab.params.clone()
    for f in (ref, fab):
        f.restore(snaps[id(f)])
        assert not f._link_degrade and f._fault_cursor == 2
        drive(f, grads, 4, start=2)
    assert fab.stats.failovers == 2  # cumulative stats count both passes
    assert torch.equal(first, fab.params)
    doc = fab.export_fault_trace()
    assert len([r for r in doc["trace"]
                if r["event"]["kind"] == "shard_crash"]) == 1
    assert doc["stats"]["failovers"] == doc["stats"]["shards_crashed"] == 1
    assert_fault_same(ref, fab)


def test_fractional_full_barrier_never_drops_pushes():
    ref, fab = pair(chunks=2, shards=1, min_push_fraction=0.9)
    grads = make_grads(fab.space.flat_elems)
    assert fab.min_pushes == ref.min_pushes == K
    for f in (ref, fab):
        for _ in range(3):
            for w in range(K):
                f.push(w, _to(f, grads[w]))
    assert fab.stats.steps == 3 and fab.stats.late_pushes_dropped == 0
    assert_fault_same(ref, fab)


def test_describe_reports_the_chain():
    ref, fab = pair(shards=2, replication=2, events=[(1, "shard_crash", 1)])
    grads = make_grads(fab.space.flat_elems)
    for f in (ref, fab):
        drive(f, grads, 2)
    line = [ln for ln in fab.describe().splitlines() if "replication:" in ln]
    assert line == [ln for ln in ref.describe().splitlines()
                    if "replication:" in ln]
    assert "1 failovers (1 re-silvered)" in line[0]


# ---------------------------------------------------------------------------
# tenancy: per-job failover isolation (tests/test_replication.py:466-530)
# ---------------------------------------------------------------------------
def _tenant_specs(pkg, events):
    """Two R = 2 tenants of tests/test_replication.py; job0 carries the
    fault schedule ``events``.  Targets made with numpy from a seed."""
    jobs = []
    n = 2 * TILE_ELEMS - 128
    for j, ev in ((0, events), (1, ())):
        rng = np.random.default_rng(10 + j)
        targets = [pkg.arr(rng.standard_normal((n,)).astype(np.float32))
                   for _ in range(K)]

        def grad_fn(p, batch, targets=targets):
            return {"w": 2 * (p["w"] - targets[batch % K])}

        spec = pkg.ten.JobSpec(
            name=f"job{j}", params={"w": pkg.zeros(n)},
            optimizer=pkg.opt.momentum(0.05, 0.9), num_workers=K,
            chunk_elems=pkg.tile, replication=2,
            fault_plan=tenancy.fault_plan(pkg, list(ev)))
        jobs.append((spec, grad_fn))
    return jobs


def test_cotenant_shard_crash_isolated():
    """A tenant's shard crash + failover perturbs no co-tenant's bits, and
    the crashing tenant itself stays bit-identical to its dedicated twin
    (same plan, R = 2); every bit, counter and fault trace as in JAX."""
    def run(pkg):
        b = tenancy.box(pkg, num_shards=2, num_racks=2)
        specs = _tenant_specs(pkg, [(2, "shard_crash", 0)])
        handles = [b.attach(s) for s, _ in specs]
        harnesses = [pkg.harness(h, g, lambda w, s: w)
                     for h, (_, g) in zip(handles, specs)]
        for _ in range(60):
            for h in harnesses:
                if min(h.steps_done) < 5:
                    h.tick()
        assert all(min(h.steps_done) >= 5 for h in harnesses)
        return b, handles, [tenancy.dedicated(pkg, s, g, b, 5)
                            for s, g in specs]

    (jb, jhandles, jdeds), (tb, handles, deds) = tenancy.both(run)
    tenancy.assert_box_same(jb, tb)
    for jh, th, jd, td in zip(jhandles, handles, jdeds, deds):
        assert_fault_same(jh.fabric, th.fabric)
        assert_fault_same(jd, td)
        assert same_bits(td, th.fabric), (
            f"{th.name}: co-tenant crash perturbed tenant bits")
    assert handles[0].stats.failovers == 1
    assert handles[1].stats.failovers == 0


def test_box_wide_engine_crash_every_tenant_fails_over():
    """``MultiJobFabric.crash_shard``: the physical engine dies for every
    tenant; each promotes its own chain replica, and an R = 1 tenant
    raises ``ShardLost`` only after the replicated tenants failed over."""
    def run(pkg):
        b = tenancy.box(pkg, num_shards=2)
        specs = _tenant_specs(pkg, ())
        handles = [b.attach(s) for s, _ in specs]
        for h, (_, g) in zip(handles, specs):
            pkg.harness(h, g, lambda w, s: w).run(3)
        before = [tenancy.params_np(h.fabric).copy() for h in handles]
        actions = b.crash_shard(1)
        kept = [np.array_equal(x, tenancy.params_np(h.fabric))
                for x, h in zip(before, handles)]
        b.attach(pkg.ten.JobSpec(
            name="fragile", params={"w": pkg.zeros(TILE_ELEMS)},
            optimizer=pkg.opt.sgd(0.1), num_workers=K,
            chunk_elems=pkg.tile, replication=1))
        err = outcome(lambda: b.crash_shard(0))
        return b, handles, actions, kept, err

    (jb, jhandles, jactions, jkept, jerr), \
        (tb, handles, actions, kept, err) = tenancy.both(run)
    tenancy.assert_box_same(jb, tb)
    for jh, th in zip(jhandles, handles):
        assert_fault_same(jh.fabric, th.fabric)
    assert actions == jactions == {"job0": "failed_over",
                                   "job1": "failed_over"}
    assert kept == jkept == [True, True]
    assert isinstance(err, ShardLost) and isinstance(jerr, JaxShardLost)
    assert str(err) == str(jerr)
    # the replicated tenants recovered before the fragile one raised
    assert [h.stats.failovers for h in handles] == [2, 2]
    assert tb.jobs["fragile"].stats.shards_crashed == 1


# ---------------------------------------------------------------------------
# seeded chaos soaks (the JAX package's slow tier, at a few rounds)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1])
def test_chaos_soak_seeded(seed):
    """Shard crashes and link degradation on one seeded plan: port == JAX
    bitwise, and the port == its failure-free twin."""
    rounds = 10
    plan = FaultPlan.generate(
        seed, rounds=rounds, num_shards=4, num_workers=K, num_racks=2,
        shard_crash_rate=0.35, link_degrade_rate=0.25)
    events = [(e.round, e.kind, e.target, e.factor) for e in plan.events]
    ref, fab = pair(shards=4, racks=2, replication=2, events=events)
    base = port(shards=4, racks=2)
    grads = make_grads(fab.space.flat_elems, seed=seed)
    for r in range(rounds):
        for f in (ref, fab, base):
            drive(f, grads, 1, start=r)
        if r % 5 == 4:
            assert same_bits(base, fab), f"diverged at round {r + 1}"
    n_crashes = sum(e.kind == "shard_crash" for e in plan.events)
    assert n_crashes and fab.stats.failovers == fab.stats.resilvers == \
        n_crashes
    assert_fault_same(ref, fab)


def test_chaos_soak_worker_churn():
    plan = FaultPlan.generate(0, rounds=15, num_shards=2, num_workers=K,
                              worker_crash_rate=0.3, recover_after=2)
    events = [(e.round, e.kind, e.target) for e in plan.events]
    ref, fab, jgrad, tgrad = quadratic_pair(
        spec="momentum", min_push_fraction=0.75, replication=2,
        events=events)
    JaxHarness(ref, jgrad, lambda w, s: w).run(10)
    ht = WorkerHarness(fab, tgrad, lambda w, s: w)
    ht.run(10)
    crashed = sum(e.kind == "worker_crash" for e in plan.events
                  if e.round <= fab.step)
    assert crashed and fab.stats.workers_crashed == crashed
    assert min(d for w, d in enumerate(ht.steps_done) if fab.alive(w)) >= 10
    assert_fault_same(ref, fab)


def test_chaos_sparse_table_failover():
    """Dense slabs through the fabric and embedding rows through an
    attached SparseTier (replication inherited, no topology), a seeded
    plan of shard crashes: both tiers fail over bit-exactly, port == JAX
    and port == its failure-free twin."""
    seed, rounds, v, d = 0, 8, 96, 8
    plan = FaultPlan.generate(seed, rounds=rounds, num_shards=4,
                              num_workers=K, shard_crash_rate=0.4)
    events = [(e.round, e.kind, e.target) for e in plan.events]
    init = np.random.default_rng(seed).standard_normal((v, d)).astype(
        np.float32)

    def build(pkg, fab):
        kw = {} if pkg is jsparse else {"device": "cpu"}
        tier = pkg.SparseTier(fabric=fab, codec="int8", lr=0.05, **kw)
        tier.add_table("t0", init)
        return tier

    ref, fab = pair(shards=4, replication=2, events=events)
    base = port(shards=4, replication=2)
    tiers = [build(jsparse, ref), build(tsparse, fab), build(tsparse, base)]
    assert tiers[1].replication == 2
    np.testing.assert_array_equal(tiers[1].chain_racks, tiers[0].chain_racks)
    grads = make_grads(fab.space.flat_elems, seed=seed)
    for r in range(rounds):
        for w in range(K):
            rng = np.random.default_rng((seed, r, w))
            ids = rng.integers(0, v, size=10)
            rows = rng.standard_normal((10, d)).astype(np.float32)
            for f, tier in zip((ref, fab, base), tiers):
                tier.push(w, {"t0": (ids, _to(f, rows))})
                f.pull(w)
                f.push(w, _to(f, grads[(w + r) % K]))
    n_crashes = sum(e.kind == "shard_crash" for e in plan.events)
    assert n_crashes and tiers[1].stats.failovers == n_crashes
    assert_fault_same(ref, fab)
    assert same_bits(base, fab)
    for tier in tiers[1:]:
        np.testing.assert_array_equal(_bits(tier.table("t0").numpy()),
                                      _bits(tiers[0].table("t0")))
        np.testing.assert_array_equal(tier.row_versions("t0"),
                                      tiers[0].row_versions("t0"))
    assert dataclasses.asdict(tiers[1].stats) == \
        dataclasses.asdict(tiers[0].stats)


def test_chaos_sparse_table_failover_two_racks():
    """tests/test_replication.py's form of the sparse chaos soak: the
    fabric over 2 racks (1:4 core), a seeded plan of shard crashes over 2
    racks, the attached int8 SparseTier inheriting the topology.  Both
    tiers fail over bit-exactly; port == JAX (tables, versions, every
    SparseStats field incl. the rack and core bytes and ``sim_*`` floats)
    and port == its failure-free twin."""
    seed, rounds, v, d = 0, 10, 96, 8
    plan = FaultPlan.generate(seed, rounds=rounds, num_shards=4,
                              num_workers=K, num_racks=2,
                              shard_crash_rate=0.25)
    events = [(e.round, e.kind, e.target) for e in plan.events]
    init = np.random.default_rng(seed).standard_normal((v, d)).astype(
        np.float32)

    def build(pkg, fab):
        kw = {} if pkg is jsparse else {"device": "cpu"}
        tier = pkg.SparseTier(fabric=fab, codec="int8", lr=0.05, **kw)
        tier.add_table("t0", init)
        return tier

    ref, fab = pair(shards=4, racks=2, replication=2, events=events)
    base = port(shards=4, racks=2, replication=2)
    tiers = [build(jsparse, ref), build(tsparse, fab), build(tsparse, base)]
    assert tiers[1].topology is fab.topology is not None
    np.testing.assert_array_equal(tiers[1].chain_racks, tiers[0].chain_racks)
    grads = make_grads(fab.space.flat_elems, seed=seed)
    for r in range(rounds):
        for w in range(K):
            rng = np.random.default_rng((seed, r, w))
            ids = rng.integers(0, v, size=10)
            rows = rng.standard_normal((10, d)).astype(np.float32)
            for f, tier in zip((ref, fab, base), tiers):
                tier.push(w, {"t0": (ids, _to(f, rows))})
                f.pull(w)
                f.push(w, _to(f, grads[(w + r) % K]))
    n_crashes = sum(e.kind == "shard_crash" for e in plan.events
                    if e.round <= fab.step)
    assert n_crashes and tiers[1].stats.failovers == n_crashes
    assert_fault_same(ref, fab)
    assert same_bits(base, fab)
    for tier in tiers[1:]:
        np.testing.assert_array_equal(_bits(tier.table("t0").numpy()),
                                      _bits(tiers[0].table("t0")))
        np.testing.assert_array_equal(tier.row_versions("t0"),
                                      tiers[0].row_versions("t0"))
    assert dataclasses.asdict(tiers[1].stats) == \
        dataclasses.asdict(tiers[0].stats)
    assert tiers[1].stats.bytes_core_link > 0
