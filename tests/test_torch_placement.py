"""The PyTorch placement plan and its fabric hooks against the JAX ones.

Mirrors the plan half of tests/test_placement.py: ``PlacementPlan`` (the
default plan is the anti-affine heuristic, validation, ``replace``,
``describe``), a fabric built under an explicit plan (chain racks and a
pinned ``chunk_owner``), and the timing-only plan deltas:
``test_replica_move_is_timing_only``, ``test_reshard_is_bit_identical``
and ``test_reshard_requires_round_edge``.  Every fabric case holds the
port against the JAX fabric bit for bit (params, optimizer state, every
stats field, ``fault_trace`` and ``export_fault_trace()``), and against
its own undisturbed twin.

Not mirrored here: the solver (``PlacementProblem``, objectives,
constraints), ``current_plan`` and ``diff_plans``, which wait for the rest
of ``core/placement.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from test_torch_replication import (  # noqa: E402
    K,
    assert_fault_same,
    both,
    configs,
    drive,
    jax_plan,
    make_grads,
    pair,
    same_bits,
)

from repro.core.placement import PlacementPlan as JaxPlan  # noqa: E402
from repro.core.placement import PlanDelta as JaxDelta  # noqa: E402
from repro.core.topology import NetworkTopology as JaxTopology  # noqa: E402
from repro_torch.core import config as tconfig  # noqa: E402
from repro_torch.core.placement import PlacementPlan, PlanDelta  # noqa: E402
from repro_torch.core.topology import NetworkTopology  # noqa: E402


# ---------------------------------------------------------------------------
# the plan itself
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("num_shards", [1, 2, 8])
@pytest.mark.parametrize("num_racks", [1, 2, 4])
@pytest.mark.parametrize("replication", [1, 2, 3])
def test_default_plan_matches_jax(num_shards, num_racks, replication):
    plan = PlacementPlan.default(num_shards, num_racks=num_racks,
                                 replication=replication,
                                 num_frontends=num_racks + 1)
    ref = JaxPlan.default(num_shards, num_racks=num_racks,
                          replication=replication,
                          num_frontends=num_racks + 1)
    expect = np.array([[(s + r) % num_racks for r in range(replication)]
                       for s in range(num_shards)], dtype=np.int64)
    np.testing.assert_array_equal(plan.replica_racks, expect)
    np.testing.assert_array_equal(plan.replica_racks, ref.replica_racks)
    np.testing.assert_array_equal(plan.home_racks, ref.home_racks)
    assert plan.frontend_racks == ref.frontend_racks
    assert plan.describe() == ref.describe()
    assert not plan.replica_racks.flags.writeable
    topo = NetworkTopology(8, num_racks)
    np.testing.assert_array_equal(
        topo.with_plan(plan).replica_racks(num_shards, replication),
        topo.replica_racks(num_shards, replication))


def test_plan_validation_matches_jax():
    bad = [dict(num_shards=0), dict(num_shards=2, num_racks=0),
           dict(num_shards=2, replication=0),
           dict(num_shards=2, num_racks=2, replica_racks=np.array([[0], [5]])),
           dict(num_shards=2, replica_racks=np.zeros((3, 1))),
           dict(num_shards=2, replication=2, replica_racks=np.zeros((2, 1))),
           dict(num_shards=2, frontend_racks=(1,)),
           dict(num_shards=2, chunk_owner=np.array([0, 2])),
           dict(num_shards=2, chunk_owner=np.zeros((2, 2))),
           dict(num_shards=2, row_owner={"t": np.array([3])}),
           dict(num_shards=2, tenant_shares={"a": 0.0})]
    for kw in bad:
        with pytest.raises(ValueError) as te:
            PlacementPlan(**kw)
        with pytest.raises(ValueError) as je:
            JaxPlan(**kw)
        assert str(te.value) == str(je.value)
    plan = PlacementPlan.default(2, num_racks=2, replication=2)
    moved = plan.replace(replica_racks=np.array([[1, 0], [1, 0]]),
                         origin="solved")
    np.testing.assert_array_equal(plan.replica_racks, [[0, 1], [1, 0]])
    np.testing.assert_array_equal(moved.home_racks, [1, 1])
    assert moved.describe() == jax_plan(moved).describe()
    with pytest.raises(ValueError):
        plan.replace(replica_racks=np.array([[0, 2], [1, 0]]))
    with pytest.raises(ValueError, match="unknown delta kind"):
        PlanDelta(kind="nonsense")


# ---------------------------------------------------------------------------
# fabrics under a plan
# ---------------------------------------------------------------------------
def test_planless_fabric_equals_default_plan_fabric():
    grads = make_grads(pair()[1].space.flat_elems)
    a = pair(shards=2, racks=2, replication=2)[1]
    ref, b = pair(plan=PlacementPlan.default(2, num_racks=2, replication=2),
                  shards=2, racks=2, replication=2)
    for f in (a, b, ref):
        drive(f, grads, 3)
    assert same_bits(a, b)
    assert [g.racks for g in a.replicas] == [g.racks for g in b.replicas]
    assert_fault_same(ref, b)


def test_explicit_plan_places_chains_and_chunks():
    """A solved-style plan: chains on chosen racks, chunks pinned to
    shards against the policy.  Bits stay those of the 1-shard run."""
    owner = np.array([1, 1, 0, 1, 0, 0, 1, 0])
    plan = PlacementPlan(num_shards=2, num_racks=2, replication=2,
                         replica_racks=np.array([[1, 0], [1, 0]]),
                         chunk_owner=owner, origin="solved")
    ref, fab = pair(plan=plan, shards=2, racks=2, replication=2,
                    events=[(2, "shard_crash", 1)])
    base = pair(shards=1, racks=2)[1]
    assert fab.topology.plan is plan
    np.testing.assert_array_equal(fab.chunk_owner, owner)
    assert [g.racks for g in fab.replicas] == [(1, 0), (1, 0)]
    grads = make_grads(fab.space.flat_elems, seed=4)
    for f in (ref, fab, base):
        drive(f, grads, 3)
    assert same_bits(base, fab)
    assert_fault_same(ref, fab)
    with pytest.raises(ValueError, match="plan places 3 chunks"):
        pair(plan=plan.replace(chunk_owner=np.array([0, 1, 0])), shards=2,
             racks=2)


def test_plan_validation_rejects_mismatched_shapes():
    for plan, kw, rule in (
            (PlacementPlan.default(3, num_racks=2), dict(racks=2),
             "plan_shards"),
            (PlacementPlan.default(2, num_racks=4), dict(racks=2),
             "plan_racks"),
            (PlacementPlan.default(2, num_racks=2), dict(racks=2,
                                                       replication=2),
             "plan_replication")):
        jcfg, tcfg = configs(plan=plan, shards=2, **kw)
        with pytest.raises(tconfig.FabricConfigError, match=rule) as te:
            tcfg.validate()
        with pytest.raises(ValueError) as je:
            jcfg.validate()
        assert str(te.value) == str(je.value)


# ---------------------------------------------------------------------------
# timing-only plan deltas
# ---------------------------------------------------------------------------
def test_replica_move_is_timing_only():
    """Re-homing a chain mid-run: params identical to the undisturbed
    twin, only byte/time accounting differs; the JAX fabric agrees on
    both."""
    ref, fab = pair(shards=2, racks=2, replication=2)
    twin = pair(shards=2, racks=2, replication=2)[1]
    grads = make_grads(fab.space.flat_elems)
    for f in (ref, fab, twin):
        drive(f, grads, 2)
    assert fab.replace_chain_racks(0, (1, 0)) == \
        ref.replace_chain_racks(0, (1, 0)) == 2
    assert fab.replace_chain_racks(0, (1, 0)) == 0
    assert fab.topology.replica_racks(2, 2).tolist() == [[1, 0], [1, 0]]
    for f in (ref, fab, twin):
        drive(f, grads, 3, start=2)
    assert same_bits(twin, fab)
    assert fab.stats.bytes_resilver > twin.stats.bytes_resilver
    for f in (ref, fab):
        f.crash_shard(0)  # failover after the move still promotes bits
    assert same_bits(twin, fab)
    assert_fault_same(ref, fab)
    for args in ((0, (0,)), (5, (0, 1)), (0, (0, 7))):
        both(ref, fab, lambda f: f.replace_chain_racks(*args))
    bare_ref, bare = pair(shards=2, racks=2)
    assert "replication < 2" in str(both(
        bare_ref, bare, lambda f: f.replace_chain_racks(0, (1, 0))))


def test_apply_plan_delta_replica_racks_and_shard_count():
    ref, fab = pair(shards=4, racks=2, replication=2)
    grads = make_grads(fab.space.flat_elems)
    for f in (ref, fab):
        drive(f, grads, 2)
    for tdelta, jdelta in (
            (PlanDelta("replica_racks", shard=1, racks=(0, 1)),
             JaxDelta("replica_racks", shard=1, racks=(0, 1))),
            (PlanDelta("shard_count", new_shards=3),
             JaxDelta("shard_count", new_shards=3)),
            (PlanDelta("shard_count", new_shards=3),
             JaxDelta("shard_count", new_shards=3))):
        assert fab.apply_plan_delta(tdelta) == ref.apply_plan_delta(jdelta)
        assert_fault_same(ref, fab)
    for f in (ref, fab):
        drive(f, grads, 2, start=2)
    assert fab.num_shards == 3 and fab.stats.rescales == 1
    assert_fault_same(ref, fab)


@pytest.mark.parametrize("grow,shrink", [(1, 2), (2, 1), (2, 8), (8, 2)])
def test_reshard_is_bit_identical(grow, shrink):
    """In-place reshard mid-run: the same chunk space over another engine
    count; params and optimizer state never move a bit, port == JAX."""
    ref, fab = pair(shards=grow, racks=2, replication=2, spec="adamw")
    twin = pair(shards=grow, racks=2, replication=2, spec="adamw")[1]
    grads = make_grads(fab.space.flat_elems)
    for f in (ref, fab, twin):
        drive(f, grads, 2)
    assert fab.reshard(shrink) == ref.reshard(shrink)
    assert fab.num_shards == shrink and fab.stats.rescales == 1
    assert len(fab.replicas) == shrink
    assert_fault_same(ref, fab)
    for f in (ref, fab, twin):
        drive(f, grads, 3, start=2)
    assert same_bits(twin, fab)
    assert torch.equal(twin.pull(0), fab.pull(0))
    ref.pull(0)
    assert_fault_same(ref, fab)


@pytest.mark.parametrize("policy", ["contiguous", "round_robin"])
def test_reshard_regathers_one_slot_at_a_time(policy):
    """The reshard's slabs are fresh gathers of the old ones, slot by slot
    (the old shards are emptied as they go), and a chunk-pinning plan is
    followed."""
    ref, fab = pair(shards=3, replication=2, spec="adamw", policy=policy)
    grads = make_grads(fab.space.flat_elems, seed=2)
    for f in (ref, fab):
        drive(f, grads, 2)
    old = list(fab.shards)
    assert fab.reshard(2) == ref.reshard(2)
    assert all(s.params is None and all(x is None for x in s.state)
               for s in old)
    assert_fault_same(ref, fab)
    owner = np.arange(fab.space.num_chunks) % 3
    plan = PlacementPlan(num_shards=3, chunk_owner=owner, replication=2)
    assert fab.reshard(3, plan=plan) == ref.reshard(3, plan=jax_plan(plan))
    np.testing.assert_array_equal(fab.chunk_owner, owner)
    for f in (ref, fab):
        drive(f, grads, 2, start=2)
    assert_fault_same(ref, fab)


def test_reshard_requires_round_edge():
    ref, fab = pair(shards=2, racks=2)
    grads = make_grads(fab.space.flat_elems)
    for f in (ref, fab):
        drive(f, grads, 1)
        f.pull(0)
    fab.push(0, torch.from_numpy(grads[0]))
    ref.push(0, jnp.asarray(grads[0]))
    for n in (4, 2):
        assert isinstance(both(ref, fab, lambda f: f.reshard(n)),
                          RuntimeError)
    assert isinstance(both(ref, fab, lambda f: f.reshard(0)), ValueError)
    assert fab.num_shards == 2


def test_jax_topology_plan_agrees():
    """The port's plan-backed topology answers like the JAX one."""
    plan = PlacementPlan(num_shards=3, num_racks=2, replication=2,
                         replica_racks=np.array([[1, 0], [0, 1], [1, 0]]))
    t = NetworkTopology(K, 2).with_plan(plan)
    j = JaxTopology(K, 2).with_plan(jax_plan(plan))
    for shards, factor in ((3, 2), (3, 1), (4, 2), (3, 3)):
        np.testing.assert_array_equal(t.replica_racks(shards, factor),
                                      j.replica_racks(shards, factor))
    np.testing.assert_array_equal(t.home_racks(3), j.home_racks(3))
