"""The PyTorch placement plan and its fabric hooks against the JAX ones.

Mirrors every test of tests/test_placement.py: ``PlacementPlan`` (the
default plan is the anti-affine heuristic, validation, ``replace``,
``describe``), a fabric built under an explicit plan (chain racks and a
pinned ``chunk_owner``), the row placement's ``"plan"`` policy, the solver
(determinism, feasibility, never worse than the default plan, solved row
maps, tenant shares), ``diff_plans``, ``rebalance_chunks``,
``current_plan`` and the timing-only plan deltas.  Every fabric case holds
the port against the JAX fabric bit for bit (params, optimizer state,
every stats field, ``fault_trace`` and ``export_fault_trace()``), and
against its own undisturbed twin.

``test_solve_matches_jax`` holds ``PlacementProblem.solve(seed)`` equal to
the JAX solver's plan field for field (chain racks, frontends, row maps,
tenant shares, origin, ``describe()``) and ``evaluate``'s terms,
violations and total equal to the float, over shards 1 / 3 / 8 x racks
1 / 2 / 4 x R 1 / 2 / 3 x frontends 0 / 2 x codec none / int8, with and
without a row load and a tenant demand.  Where the JAX solver raises, the
port raises the same error.
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

from repro.core import placement as jplacement  # noqa: E402
from repro.core import sparse as jsparse  # noqa: E402
from repro.core.placement import PlacementPlan as JaxPlan  # noqa: E402
from repro.core.placement import PlanDelta as JaxDelta  # noqa: E402
from repro.core.topology import NetworkTopology as JaxTopology  # noqa: E402
from repro_torch.core import config as tconfig  # noqa: E402
from repro_torch.core import placement as tplacement  # noqa: E402
from repro_torch.core import sparse as tsparse  # noqa: E402
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


# ---------------------------------------------------------------------------
# row placement under a plan
# ---------------------------------------------------------------------------
def test_row_placement_plan_policy_golden():
    """'plan' rows wrap an explicit owner array verbatim; the default
    'hash' policy stays splitmix64; the port's maps and errors equal
    JAX's."""
    owner = np.array([1, 0, 1, 2, 0, 2, 1, 0])
    for pkg in (tsparse, jsparse):
        rp = pkg.RowPlacement.from_owner(owner, 3)
        np.testing.assert_array_equal(rp.owner, owner)
        assert rp.policy == "plan"
        np.testing.assert_array_equal(rp.shard_rows[1], [0, 2, 6])
        np.testing.assert_array_equal(rp.local_of(1, np.array([2, 6])),
                                      [1, 2])
    for bad in (lambda pkg: pkg.RowPlacement.from_owner(np.array([0, 3]), 3),
                lambda pkg: pkg.RowPlacement(4, 2, "plan")):
        with pytest.raises(ValueError) as te:
            bad(tsparse)
        with pytest.raises(ValueError) as je:
            bad(jsparse)
        assert str(te.value) == str(je.value)
    hash_rp = tsparse.RowPlacement(64, 4, "hash")
    assert hash_rp.owner.min() >= 0 and hash_rp.owner.max() <= 3
    np.testing.assert_array_equal(hash_rp.owner,
                                  jsparse.RowPlacement(64, 4, "hash").owner)


# ---------------------------------------------------------------------------
# solver: determinism, feasibility, parity with JAX
# ---------------------------------------------------------------------------
def assert_plan_same(jp, tp):
    """Every field of two plans (JAX's and the port's), exactly."""
    for name in ("num_shards", "num_racks", "replication", "frontend_racks",
                 "origin"):
        assert getattr(jp, name) == getattr(tp, name), name
    np.testing.assert_array_equal(jp.replica_racks, tp.replica_racks)
    assert (jp.chunk_owner is None) == (tp.chunk_owner is None)
    if jp.chunk_owner is not None:
        np.testing.assert_array_equal(jp.chunk_owner, tp.chunk_owner)
    assert list(jp.row_owner) == list(tp.row_owner)
    for name, owner in jp.row_owner.items():
        np.testing.assert_array_equal(owner, tp.row_owner[name])
    assert list(jp.tenant_shares.items()) == list(tp.tenant_shares.items())
    assert jp.describe() == tp.describe()


def assert_score_same(js, ts):
    """``evaluate``'s terms (insertion order), violations and total, to
    the float."""
    assert list(js.terms.items()) == list(ts.terms.items())
    assert [type(v) for v in js.terms.values()] == \
        [type(v) for v in ts.terms.values()]
    assert js.violations == ts.violations
    assert js.total == ts.total and js.feasible == ts.feasible


def problems(**kw):
    """(JAX problem, port problem) of ``PlacementProblem.standard(**kw)``."""
    return (jplacement.PlacementProblem.standard(**kw),
            tplacement.PlacementProblem.standard(**kw))


def test_solver_is_deterministic_and_feasible():
    kw = dict(num_shards=8, num_racks=4, replication=2, num_frontends=3,
              chunks_per_shard=[5, 1, 1, 1, 5, 1, 1, 1],
              row_load={"emb": np.arange(32.0) + 1.0})
    jprob, prob = problems(**kw)
    a = prob.solve(seed=7)
    b = prob.solve(seed=7)
    np.testing.assert_array_equal(a.replica_racks, b.replica_racks)
    assert a.frontend_racks == b.frontend_racks
    np.testing.assert_array_equal(a.row_owner["emb"], b.row_owner["emb"])
    score = prob.evaluate(a)
    assert score.feasible
    assert score.total <= prob.evaluate(prob.default_plan()).total
    assert_plan_same(jprob.solve(seed=7), a)
    assert_score_same(jprob.evaluate(jprob.solve(seed=7)), score)


def test_solver_never_worsens_the_default_plan():
    for seed in (0, 1, 2):
        jprob, prob = problems(num_shards=4, num_racks=2, replication=2,
                               num_frontends=2, chunks_per_shard=[7, 1, 1, 1])
        solved = prob.solve(seed=seed)
        assert (prob.evaluate(solved).total
                <= prob.evaluate(prob.default_plan()).total)
        assert_plan_same(jprob.solve(seed=seed), solved)


def test_solved_row_map_balances_hot_rows():
    """LPT rows: a Zipf-ish load lands with lower skew than the hash map;
    the map equals JAX's."""
    load = 1.0 / (np.arange(256) + 1.0)
    jprob, prob = problems(num_shards=4, num_racks=1, row_load={"emb": load})
    solved = prob.solve(seed=0)
    owner = solved.row_owner["emb"]
    per_shard = np.array([load[owner == s].sum() for s in range(4)])
    hash_owner = tsparse.RowPlacement(256, 4, "hash").owner
    hash_load = np.array([load[hash_owner == s].sum() for s in range(4)])
    assert per_shard.max() <= hash_load.max()
    # deterministic tie-break: lowest row ids first
    assert int(owner[0]) == 0
    np.testing.assert_array_equal(owner, jprob.solve(seed=0).row_owner["emb"])
    np.testing.assert_array_equal(prob.default_row_owner("emb"), hash_owner)


def test_tenant_shares_follow_demand():
    jprob, prob = problems(num_shards=2, num_racks=1,
                           tenant_demand={"big": 3.0, "small": 1.0})
    solved = prob.solve(seed=0)
    assert solved.tenant_shares == {"big": 3.0, "small": 1.0}
    assert_plan_same(jprob.solve(seed=0), solved)


def _outcome(fn):
    try:
        return fn(), None
    except Exception as e:  # noqa: BLE001 - compared across packages
        return None, e


@pytest.mark.parametrize("codec", ["none", "int8"])
@pytest.mark.parametrize("frontends", [0, 2])
@pytest.mark.parametrize("replication", [1, 2, 3])
@pytest.mark.parametrize("racks", [1, 2, 4])
@pytest.mark.parametrize("shards", [1, 3, 8])
def test_solve_matches_jax(shards, racks, replication, frontends, codec):
    """The port's solver picks JAX's plan, field for field, and scores it
    to the float, with and without a row load and a tenant demand, from
    the default start and from a perturbed one."""
    rng = np.random.default_rng(shards * 100 + racks * 10 + replication)
    chunks = rng.integers(1, 9, size=shards).tolist()
    for extra in ({}, {"row_load": {"emb": 1.0 / (np.arange(48) + 1.0),
                                    "user": rng.random(40)},
                       "tenant_demand": {"b": 3.0, "a": 1.5}}):
        kw = dict(num_shards=shards, num_racks=racks,
                  replication=replication, num_frontends=frontends,
                  oversubscription=3.0, codec=codec, chunk_elems=1024,
                  chunks_per_shard=chunks, **extra)
        jprob, jerr = _outcome(
            lambda: jplacement.PlacementProblem.standard(**kw))
        prob, terr = _outcome(
            lambda: tplacement.PlacementProblem.standard(**kw))
        if jerr is not None:
            assert type(terr) is type(jerr) and str(terr) == str(jerr)
            continue
        starts = [(None, None)]
        rr = (np.arange(shards)[:, None] * 3
              + np.arange(replication)[None, :]) % racks
        starts.append((JaxPlan(shards, num_racks=racks,
                               replication=replication, replica_racks=rr,
                               frontend_racks=(racks - 1,) * frontends),
                       PlacementPlan(shards, num_racks=racks,
                                     replication=replication,
                                     replica_racks=rr,
                                     frontend_racks=(racks - 1,) * frontends)))
        for jstart, tstart in starts:
            for seed in (0, 5):
                jplan, jerr = _outcome(
                    lambda: jprob.solve(start=jstart, seed=seed))
                plan, terr = _outcome(
                    lambda: prob.solve(start=tstart, seed=seed))
                if jerr is not None:
                    assert type(terr) is type(jerr)
                    assert str(terr) == str(jerr)
                    continue
                assert terr is None
                assert_plan_same(jplan, plan)
                assert_score_same(jprob.evaluate(jplan), prob.evaluate(plan))
        assert_score_same(jprob.evaluate(jprob.default_plan()),
                          prob.evaluate(prob.default_plan()))
        assert prob.shard_bytes_total() == jprob.shard_bytes_total()


def test_objectives_and_constraints_match_jax():
    """Each objective and constraint alone, on a plan that violates every
    constraint, against JAX's; and the problem's validation errors."""
    owner = np.array([0, 0, 0, 1])
    kw = dict(num_shards=2, num_racks=2, replication=2, num_frontends=2,
              chunk_elems=1024, row_load={"t": np.arange(6.0)})
    jprob, prob = jplacement.PlacementProblem(**kw), \
        tplacement.PlacementProblem(**kw)
    jplan = JaxPlan(2, num_racks=2, replication=2,
                    replica_racks=np.array([[0, 0], [0, 1]]),
                    frontend_racks=(1, 0), chunk_owner=owner)
    tplan = PlacementPlan(2, num_racks=2, replication=2,
                          replica_racks=np.array([[0, 0], [0, 1]]),
                          frontend_racks=(1, 0), chunk_owner=owner)
    for name in ("CoreByteCost", "LoadBalance", "HotRowSkew"):
        jo, to = getattr(jplacement, name)(), getattr(tplacement, name)()
        assert jo.name == to.name
        assert jo.score(jplan, jprob) == to.score(tplan, prob)
    for name in ("RackCapacity", "ReplicaAntiAffinity", "ChunkBalance"):
        jc, tc = getattr(jplacement, name)(), getattr(tplacement, name)()
        assert jc.name == tc.name
        assert tc.violations(tplan, prob) == jc.violations(jplan, jprob)
        assert tc.violations(tplan, prob)
    assert tplacement.RackCapacity(max_primaries=0).violations(tplan, prob) \
        == jplacement.RackCapacity(max_primaries=0).violations(jplan, jprob)
    for pkg, p in ((jplacement, jprob), (tplacement, prob)):
        p.add_objective(pkg.CoreByteCost(serve_weight=0.5), weight=2.0)
        p.add_constraint(pkg.ChunkBalance())
    assert_score_same(jprob.evaluate(jplan), prob.evaluate(tplan))
    for bad in (dict(num_shards=0), dict(num_shards=2, oversubscription=0.5),
                dict(num_shards=2, chunks_per_shard=[1])):
        with pytest.raises(ValueError) as te:
            tplacement.PlacementProblem(**bad)
        with pytest.raises(ValueError) as je:
            jplacement.PlacementProblem(**bad)
        assert str(te.value) == str(je.value)
    for pkg, p in ((jplacement, jprob), (tplacement, prob)):
        with pytest.raises(ValueError, match="objective weight must be > 0"):
            p.add_objective(pkg.LoadBalance(), weight=0.0)
        with pytest.raises(ValueError, match="start plan does not match"):
            p.solve(start=p.default_plan().replace(num_racks=4))


# ---------------------------------------------------------------------------
# diff / apply round-trips
# ---------------------------------------------------------------------------
def test_diff_plans_kinds_and_shard_count_subsumption():
    def deltas(pkg, a, b):
        return [(d.kind, d.moves, d.shard, d.racks, d.frontend, d.rack,
                 d.new_shards, d.shares, d.describe())
                for d in pkg.diff_plans(a, b)]

    for pkg, plan_cls in ((tplacement, PlacementPlan),
                          (jplacement, JaxPlan)):
        a = plan_cls.default(2, num_racks=2, replication=2, num_frontends=2)
        b = a.replace(replica_racks=np.array([[1, 0], [1, 0]]),
                      frontend_racks=(1, 1), origin="solved")
        ds = pkg.diff_plans(a, b)
        assert [d.kind for d in ds] == ["replica_racks", "frontend_move"]
        assert ds[1].frontend == 0 and ds[1].rack == 1  # fe 1 unchanged
        grown = plan_cls.default(4, num_racks=2, replication=2)
        ds = pkg.diff_plans(a, grown)
        assert [d.kind for d in ds] == ["shard_count"]
        assert ds[0].new_shards == 4
        with pytest.raises(ValueError, match="different rack counts"):
            pkg.diff_plans(a, plan_cls.default(2, num_racks=4,
                                               replication=2))
        assert pkg.diff_plans(a, a) == ()
    # every kind at once, in the JAX order, against JAX
    out = []
    for pkg, plan_cls in ((tplacement, PlacementPlan),
                          (jplacement, JaxPlan)):
        a = plan_cls(3, num_racks=3, replication=2,
                     frontend_racks=(0, 1, 2), chunk_owner=[0, 1, 2, 0],
                     tenant_shares={"x": 1.0})
        b = a.replace(replica_racks=np.array([[0, 1], [2, 0], [2, 1]]),
                      chunk_owner=np.array([2, 1, 0, 0]),
                      frontend_racks=(0, 2), tenant_shares={"y": 2.0,
                                                            "x": 1.0})
        out.append(deltas(pkg, a, b))
    assert out[0] == out[1]
    assert [d[0] for d in out[0]] == ["replica_racks", "replica_racks",
                                      "chunk_moves", "frontend_move",
                                      "tenant_shares"]


def test_rebalance_chunks_golden_and_delta():
    owner = np.array([0, 1, 2, 0, 1, 2])
    out = tplacement.rebalance_chunks(owner, [0], 3)
    assert not np.any(out == 0)
    counts = np.bincount(out, minlength=3)
    assert counts.max() - counts[1:].min() <= 1
    np.testing.assert_array_equal(
        out, jplacement.rebalance_chunks(owner, [0], 3))
    delta = tplacement.chunk_rebalance_delta(owner, [0], 3)
    assert delta.kind == "chunk_moves"
    assert {c for c, _ in delta.moves} == {0, 3}
    assert delta.moves == jplacement.chunk_rebalance_delta(owner, [0],
                                                           3).moves
    assert tplacement.chunk_rebalance_delta(owner, [], 3) is None


def test_apply_plan_delta_lands_the_target_layout():
    ref, fab = pair(shards=2, racks=2, replication=2)
    grads = make_grads(fab.space.flat_elems)
    for f in (ref, fab):
        drive(f, grads, 2)
    for pkg, f in ((jplacement, ref), (tplacement, fab)):
        base = pkg.current_plan(f)
        target = base.replace(
            replica_racks=np.array([[1, 0], [1, 0]]), origin="solved")
        for delta in pkg.diff_plans(base, target):
            f.apply_plan_delta(delta)
        live = pkg.current_plan(f)
        np.testing.assert_array_equal(live.replica_racks,
                                      target.replica_racks)
        assert f.stats.replica_moves > 0
        # plan-backed topology sees the move too
        np.testing.assert_array_equal(
            f.topology.replica_racks(2, 2), target.replica_racks)
    assert_fault_same(ref, fab)
    assert_plan_same(jplacement.current_plan(ref),
                     tplacement.current_plan(fab))


def test_fabric_rejects_foreign_delta_kinds():
    ref, fab = pair(shards=2, racks=2)
    for kw in (dict(kind="frontend_move", frontend=0, rack=1),
               dict(kind="tenant_shares", shares=(("a", 1.0),))):
        err = both(ref, fab, lambda f: f.apply_plan_delta(
            (PlanDelta if f is fab else JaxDelta)(**kw)))
        assert isinstance(err, ValueError)


def test_chunk_move_delta_is_timing_only():
    ref, fab = pair(shards=2, racks=2)
    twin = pair(shards=2, racks=2)[1]
    grads = make_grads(fab.space.flat_elems)
    for f in (ref, fab, twin):
        drive(f, grads, 2)
    delta = tplacement.chunk_rebalance_delta(fab.chunk_owner, [0], 2)
    jdelta = jplacement.chunk_rebalance_delta(ref.chunk_owner, [0], 2)
    assert fab.apply_plan_delta(delta) == len(delta.moves) == \
        ref.apply_plan_delta(jdelta)
    assert fab.shards[0].num_chunks == 0
    for f in (ref, fab, twin):
        drive(f, grads, 3, start=2)
    assert same_bits(twin, fab)
    assert_fault_same(ref, fab)


def test_current_plan_reflects_live_layout():
    ref, fab = pair(shards=2, racks=2, replication=2)
    grads = make_grads(fab.space.flat_elems)
    for f in (ref, fab):
        drive(f, grads, 1)
    live = tplacement.current_plan(fab)
    assert live.origin == "live"
    np.testing.assert_array_equal(live.chunk_owner, fab.chunk_owner)
    assert not np.shares_memory(live.chunk_owner, fab.chunk_owner)
    for f in (ref, fab):
        f.replace_chain_racks(1, (0, 1))
    live2 = tplacement.current_plan(fab)
    assert tuple(live2.replica_racks[1]) == (0, 1)
    assert_plan_same(jplacement.current_plan(ref), live2)


def test_rebalance_chunks_all_shards_slow_is_a_no_op():
    """No healthy target left: the assignment comes back unchanged and
    the delta form is None (nowhere to move to is not an error)."""
    owner = np.array([0, 1, 0, 1, 2])
    np.testing.assert_array_equal(
        tplacement.rebalance_chunks(owner, [0, 1, 2], 3), owner)
    assert tplacement.chunk_rebalance_delta(owner, [0, 1, 2], 3) is None
    ref, fab = pair(shards=2)
    grads = make_grads(fab.space.flat_elems)
    for f in (ref, fab):
        drive(f, grads, 1)
    before = fab.chunk_owner.copy()
    assert fab.rebalance([0, 1]) == ref.rebalance([0, 1]) == 0
    np.testing.assert_array_equal(fab.chunk_owner, before)
    assert_fault_same(ref, fab)


def test_rebalance_chunks_single_shard_fabric_is_a_no_op():
    one = np.zeros(4, dtype=np.int64)
    np.testing.assert_array_equal(tplacement.rebalance_chunks(one, [0], 1),
                                  one)
    assert tplacement.chunk_rebalance_delta(one, [0], 1) is None
    ref, fab = pair(shards=1)
    grads = make_grads(fab.space.flat_elems)
    for f in (ref, fab):
        drive(f, grads, 1)
    params = fab.params.clone()
    assert fab.rebalance([0]) == ref.rebalance([0]) == 0
    assert fab.shards[0].num_chunks == fab.space.num_chunks
    for f in (ref, fab):
        drive(f, grads, 2, start=1)  # still trains normally afterwards
    assert not torch.equal(fab.params, params)
    assert_fault_same(ref, fab)
