"""The port's sparse tier (``repro_torch.core.sparse``) against the JAX tier.

Mirrors the topology-free, serving-free cases of tests/test_sparse_tier.py
(the topology and serving cases are in test_torch_sparse_serving.py).
Both tiers see the same numpy inputs; the port runs on the CPU, where its
kernels take their plain versions (bitwise equal to the CUDA kernels).
Because the port repeats the JAX tier's float operations in the same
order — the batch-order duplicate fold, the ascending-worker union fold,
``acc * f32(lr / K)``, ``slab + (-step)``, the eager per-row codec — the
tables, the row versions and every ``SparseStats`` field are held equal
bit for bit, for codecs none, bf16 and int8, with error feedback on and
off, and for 1, 2 and 8 shards.  Inside the port, 1 and 8 shards give the
same tables (the tier's sharding-independence invariant), failover is
byte-exact and a reshard leaves later training unchanged.
"""
import dataclasses
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core import sparse as jsparse  # noqa: E402
from repro.models.recsys.embedding import jagged_to_padded as jax_j2p  # noqa: E402
from repro.runtime.sparse_push import coalesce_ids_rows as jax_coalesce  # noqa: E402
from repro_torch.core import sparse as tsparse  # noqa: E402
from repro_torch.core.chunking import TILE_ELEMS, ParamSpace  # noqa: E402
from repro_torch.core.config import FabricConfig, WireConfig  # noqa: E402
from repro_torch.core.fabric import LinkModel, PBoxFabric  # noqa: E402
from repro_torch.core.placement import PlacementPlan  # noqa: E402
from repro_torch.core.replication import ShardLost  # noqa: E402
from repro_torch.models.recsys.embedding import jagged_to_padded  # noqa: E402
from repro_torch.optim.optimizers import sgd  # noqa: E402
from repro_torch.runtime.sparse_push import coalesce_ids_rows  # noqa: E402

V, D, K = 64, 16, 2  # vocab rows, embedding dim, workers
INIT = np.random.default_rng(1805).standard_normal((V, D)).astype(np.float32)


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def make_tier(pkg, num_shards=2, *, codec="none", replication=1,
              placement="hash", workers=K, lr=0.1, error_feedback=True):
    kw = {"device": "cpu"} if pkg is tsparse else {}
    tier = pkg.SparseTier(num_shards=num_shards, num_workers=workers,
                          codec=codec, replication=replication,
                          placement=placement, lr=lr,
                          error_feedback=error_feedback, **kw)
    tier.add_table("t0", INIT)
    return tier


def drive(tier, rounds=3, seed=5, batch=12, workers=K, vocab=V):
    """``rounds`` deterministic sparse-gradient rounds (duplicate ids
    included: 12 draws from 64 rows, and a repeated id per push)."""
    rng = np.random.default_rng(seed)
    to = ((lambda g: torch.from_numpy(g)) if isinstance(tier, tsparse.SparseTier)
          else jnp.asarray)
    for _ in range(rounds):
        for w in range(workers):
            ids = rng.integers(0, vocab, size=batch)
            ids[-1] = ids[0]
            g = rng.standard_normal((batch, D)).astype(np.float32)
            tier.push(w, {"t0": (ids, to(g))})
    return tier


def jagged_batch(rng, nbags, vocab, max_len):
    """A random jagged batch including empty bags and duplicate ids."""
    lens = rng.integers(0, max_len + 1, size=nbags)
    values = rng.integers(0, vocab, size=int(lens.sum()))
    offsets = np.concatenate([[0], np.cumsum(lens)])
    return values.astype(np.int64), offsets.astype(np.int64)


def assert_tiers_equal(port, ref):
    np.testing.assert_array_equal(_bits(port.table("t0").numpy()),
                                  _bits(ref.table("t0")))
    np.testing.assert_array_equal(port.row_versions("t0"),
                                  ref.row_versions("t0"))
    assert dataclasses.asdict(port.stats) == dataclasses.asdict(ref.stats)


# ---------------------------------------------------------------------------
# placement, codec, jagged format, coalescing
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("policy", ["hash", "range"])
@pytest.mark.parametrize("rows,shards", [(1, 1), (101, 8), (4096, 3),
                                         (100_003, 4)])
def test_placement_owners_equal_jax(rows, shards, policy):
    port = tsparse.RowPlacement(rows, shards, policy)
    ref = jsparse.RowPlacement(rows, shards, policy)
    np.testing.assert_array_equal(port.owner, ref.owner)
    for a, b in zip(port.shard_rows, ref.shard_rows):
        np.testing.assert_array_equal(a, b)
    assert port.balance == ref.balance


def test_placement_plan_and_errors():
    owner = np.array([1, 0, 1, 1])
    port = tsparse.RowPlacement.from_owner(owner, 2)
    np.testing.assert_array_equal(port.owner, owner)
    np.testing.assert_array_equal(port.local_of(1, np.array([2, 3])), [1, 2])
    with pytest.raises(ValueError):
        tsparse.RowPlacement(10, 2, "zigzag")
    with pytest.raises(ValueError):
        tsparse.RowPlacement(3, 4, "hash")
    with pytest.raises(ValueError):
        tsparse.RowPlacement(0, 1, "hash")
    with pytest.raises(ValueError):
        tsparse.RowPlacement(4, 2, "plan")
    with pytest.raises(ValueError):
        tsparse.RowPlacement.from_owner(np.array([0, 2]), 2)


@pytest.mark.parametrize("codec", ["none", "bf16", "int8"])
def test_row_wire_bytes_equal_jax(codec):
    for dim, n in ((16, 1), (128, 7), (130, 0)):
        assert (tsparse.row_wire_bytes(codec, dim, n)
                == jsparse.row_wire_bytes(codec, dim, n))
    with pytest.raises(ValueError):
        tsparse.row_wire_bytes("fp8", 16, 1)


@pytest.mark.parametrize("codec", ["none", "bf16", "int8"])
def test_encode_rows_bitwise(codec):
    rng = np.random.default_rng(11)
    rows = (rng.standard_normal((9, D)) * rng.uniform(0.001, 1000, (9, 1))
            ).astype(np.float32)
    rows[0] = 0.0  # scale pinned to 1.0
    rows[1, 3] = np.nan  # scale 1.0, NaN encodes as 0
    rows[2, 5] = np.inf
    rows[3, 1] = -np.inf
    rows[4, 7] = 127.5 * (np.abs(rows[4]).max() / 127)  # near a rounding tie
    got = tsparse.encode_rows(codec, torch.from_numpy(rows)).numpy()
    want = np.asarray(jsparse.encode_rows(codec, jnp.asarray(rows)))
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_encode_rows_zero_row_and_error_bound():
    rows = np.random.default_rng(2).standard_normal((5, D)).astype(np.float32)
    rows[2] = 0.0
    dec = tsparse.encode_rows("int8", torch.from_numpy(rows)).numpy()
    np.testing.assert_array_equal(dec[2], 0.0)
    amax = np.abs(rows).max(axis=1, keepdims=True)
    assert np.all(np.abs(dec - rows) <= amax / 254 + 1e-7)
    with pytest.raises(ValueError):
        tsparse.encode_rows("fp8", torch.from_numpy(rows))


def test_check_jagged_errors_match_jax():
    cases = [
        (np.array([1, 2]), np.array([0.0, 2.0])),  # float offsets
        (np.array([1, 2]), np.array([2])),  # too short
        (np.array([1, 2]), np.array([1, 2])),  # not from 0
        (np.array([1, 2]), np.array([0, 1])),  # not spanning
        (np.array([1, 2, 3]), np.array([0, 2, 1, 3])),  # decreasing
        (np.array([1.5, 2.0]), np.array([0, 2])),  # float ids
        (np.array([1, V]), np.array([0, 2])),  # out of range
        (np.array([-1, 2]), np.array([0, 2])),
    ]
    for values, offsets in cases:
        with pytest.raises((TypeError, ValueError)) as want:
            jsparse.check_jagged(values, offsets, V)
        with pytest.raises(want.type):
            tsparse.check_jagged(values, offsets, V)
    tsparse.check_jagged(np.array([], np.int64), np.array([0, 0]), V)


@pytest.mark.parametrize("seed", range(6))
def test_jagged_to_padded_equals_jax(seed):
    rng = np.random.default_rng(seed)
    values, offsets = jagged_batch(rng, int(rng.integers(1, 9)), V,
                                   int(rng.integers(0, 6)))
    weights = (rng.standard_normal(values.size).astype(np.float32)
               if seed % 2 else None)
    idx, w = jagged_to_padded(values, offsets, weights, device="cpu")
    jidx, jw = jax_j2p(values, offsets, weights)
    assert idx.dtype == torch.int32 and w.dtype == torch.float32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(_bits(w.numpy()), _bits(jw))


def test_jagged_to_padded_errors_and_empty():
    idx, w = jagged_to_padded(np.array([], np.int64), np.array([0, 0, 0]),
                              device="cpu")
    assert tuple(idx.shape) == (2, 1) and not w.any()
    with pytest.raises(ValueError):
        jagged_to_padded(np.array([1, 2]), np.array([0, 1]), device="cpu")
    with pytest.raises(ValueError):
        jagged_to_padded(np.array([1, 2]), np.array([0, 2, 1, 2]),
                         device="cpu")
    with pytest.raises(ValueError):
        jagged_to_padded(np.array([1, 2]), np.array([0, 2]),
                         np.ones(3, np.float32), device="cpu")


@pytest.mark.parametrize("seed", range(4))
def test_coalesce_ids_rows_bitwise(seed):
    rng = np.random.default_rng(seed)
    n = 40
    ids = rng.zipf(1.5, n) % 9
    rows = (rng.standard_normal((n, D)) * 3).astype(np.float32)
    uniq, summed = coalesce_ids_rows(ids, torch.from_numpy(rows))
    juniq, jsummed = jax_coalesce(ids, jnp.asarray(rows))
    np.testing.assert_array_equal(uniq, juniq)
    assert uniq.dtype == np.int64
    np.testing.assert_array_equal(_bits(summed.numpy()), _bits(jsummed))
    empty_ids, empty = coalesce_ids_rows(np.array([], np.int64),
                                         torch.zeros((0, D)))
    assert empty_ids.size == 0 and tuple(empty.shape) == (0, D)
    with pytest.raises(ValueError):
        coalesce_ids_rows(np.array([1, 2]), torch.zeros((3, D)))


# ---------------------------------------------------------------------------
# lookups
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("policy", ["hash", "range"])
@pytest.mark.parametrize("shards", [1, 2, 8])
def test_lookup_bitwise_against_jax_tier(shards, policy):
    rng = np.random.default_rng(shards * 10 + len(policy))
    values, offsets = jagged_batch(rng, 6, V, 4)
    weights = rng.standard_normal(values.size).astype(np.float32)
    port = make_tier(tsparse, shards, placement=policy)
    ref = make_tier(jsparse, shards, placement=policy)
    single = make_tier(tsparse, 1)
    for mode in ("sum", "mean"):
        got = port.lookup(0, "t0", values, offsets, weights, mode=mode)
        want = ref.lookup(0, "t0", values, offsets, weights, mode=mode)
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
        one = single.lookup(0, "t0", values, offsets, weights, mode=mode)
        np.testing.assert_array_equal(_bits(one.numpy()), _bits(got.numpy()))
    assert dataclasses.asdict(port.stats) == dataclasses.asdict(ref.stats)


def test_lookup_empty_and_out_of_range():
    tier = make_tier(tsparse, 2)
    out = tier.lookup(0, "t0", np.array([], np.int64), np.array([0, 0, 0]))
    assert tuple(out.shape) == (2, D) and not out.any()
    with pytest.raises(ValueError):
        tier.lookup(0, "t0", np.array([V]), np.array([0, 1]))
    with pytest.raises(ValueError):
        tier.lookup(0, "t0", np.array([-1]), np.array([0, 1]))
    with pytest.raises(ValueError):
        tier.lookup(K, "t0", np.array([1]), np.array([0, 1]))
    with pytest.raises(KeyError):
        tier.lookup(0, "nope", np.array([1]), np.array([0, 1]))


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("codec,error_feedback", [
    ("none", True), ("bf16", True), ("bf16", False), ("int8", True),
    ("int8", False)], ids=["none", "bf16-ef", "bf16-noef", "int8-ef",
                           "int8-noef"])
@pytest.mark.parametrize("shards", [1, 2, 8])
def test_training_bitwise_against_jax_tier(shards, codec, error_feedback):
    port = drive(make_tier(tsparse, shards, codec=codec,
                           error_feedback=error_feedback))
    ref = drive(make_tier(jsparse, shards, codec=codec,
                          error_feedback=error_feedback))
    assert_tiers_equal(port, ref)
    for key, res in port._ef.items():
        np.testing.assert_array_equal(_bits(res.numpy()), _bits(ref._ef[key]))


@pytest.mark.parametrize("codec", ["none", "int8"])
@pytest.mark.parametrize("policy", ["hash", "range"])
def test_sharded_training_bit_identical_to_single(policy, codec):
    single = drive(make_tier(tsparse, 1, codec=codec), seed=9)
    sharded = drive(make_tier(tsparse, 8, codec=codec, placement=policy),
                    seed=9)
    np.testing.assert_array_equal(_bits(single.table("t0").numpy()),
                                  _bits(sharded.table("t0").numpy()))
    np.testing.assert_array_equal(single.row_versions("t0"),
                                  sharded.row_versions("t0"))


def test_lazy_sgd_leaves_untouched_rows_alone():
    tier = make_tier(tsparse, 2, workers=1)
    tier.push(0, {"t0": (np.array([3, 3, 9]), torch.ones((3, D)))})
    table = tier.table("t0").numpy()
    cold = np.setdiff1d(np.arange(V), [3, 9])
    np.testing.assert_array_equal(_bits(table[cold]), _bits(INIT[cold]))
    np.testing.assert_array_equal(tier.row_versions("t0")[[3, 9]], [1, 1])
    assert tier.stats.rows_pushed == 2 and tier.stats.rows_coalesced == 1
    assert tier.stats.bytes_pushed == tsparse.row_wire_bytes("none", D, 2)


def test_push_rejects_bad_ids_and_shapes():
    tier = make_tier(tsparse, 2)
    with pytest.raises(ValueError):
        tier.push(0, {"t0": (np.array([V]), torch.zeros((1, D)))})
    with pytest.raises(ValueError):
        tier.push(0, {"t0": (np.array([0]), torch.zeros((1, D + 1)))})
    with pytest.raises(TypeError):
        tier.push(0, {"t0": (np.array([0.5]), torch.zeros((1, D)))})
    with pytest.raises(KeyError):
        tier.push(0, {"t9": (np.array([0]), torch.zeros((1, D)))})
    tier.push(0, {"t0": (np.array([0]), torch.zeros((1, D)))})
    with pytest.raises(RuntimeError):
        tier.push(0, {"t0": (np.array([0]), torch.zeros((1, D)))})
    with pytest.raises(ValueError):
        tier.add_table("t0", INIT)


# ---------------------------------------------------------------------------
# replication, reshard, fabric attachment
# ---------------------------------------------------------------------------
def test_failover_every_shard_bit_exact():
    ref = drive(drive(make_tier(tsparse, 4, replication=2), rounds=2),
                rounds=2, seed=50)
    for crash in range(4):
        tier = drive(make_tier(tsparse, 4, replication=2), rounds=2)
        assert tier.failover(crash) == "failed_over"
        drive(tier, rounds=2, seed=50)
        np.testing.assert_array_equal(_bits(tier.table("t0").numpy()),
                                      _bits(ref.table("t0").numpy()))
        np.testing.assert_array_equal(tier.row_versions("t0"),
                                      ref.row_versions("t0"))
        assert tier.stats.failovers == 1 and tier.stats.resilvers == 1


def test_replicated_stats_match_jax_tier():
    port = drive(make_tier(tsparse, 4, replication=3, codec="int8"))
    ref = drive(make_tier(jsparse, 4, replication=3, codec="int8"))
    port.failover(2)
    ref.failover(2)
    drive(port, rounds=1, seed=8)
    drive(ref, rounds=1, seed=8)
    assert_tiers_equal(port, ref)


def test_chain_copy_never_sees_a_later_round():
    tier = drive(make_tier(tsparse, 2, replication=2), rounds=1)
    held = {s: tier._chains[s].copies[0]["t0"][0].clone() for s in range(2)}
    refs = {s: tier._chains[s].copies[0]["t0"][0] for s in range(2)}
    drive(tier, rounds=1, seed=77)
    for s in range(2):
        assert torch.equal(refs[s], held[s])


def test_failover_without_replica_raises_shard_lost():
    tier = drive(make_tier(tsparse, 2, replication=1), rounds=1)
    with pytest.raises(ShardLost):
        tier.failover(0)
    with pytest.raises(ValueError):
        tier.failover(5)


def test_reshard_leaves_later_training_bitwise():
    base = drive(drive(make_tier(tsparse, 2, codec="int8"), rounds=2),
                 rounds=2, seed=31)
    tier = drive(make_tier(tsparse, 2, codec="int8"), rounds=2)
    tier.reshard(4)
    assert tier.num_shards == 4 and tier.stats.rescales == 1
    assert len(tier.tables["t0"].slabs) == 4
    drive(tier, rounds=2, seed=31)
    np.testing.assert_array_equal(_bits(tier.table("t0").numpy()),
                                  _bits(base.table("t0").numpy()))
    np.testing.assert_array_equal(tier.row_versions("t0"),
                                  base.row_versions("t0"))
    ref = drive(make_tier(jsparse, 2, codec="int8"), rounds=2)
    ref.reshard(4)
    drive(ref, rounds=2, seed=31)
    np.testing.assert_array_equal(_bits(tier.table("t0").numpy()),
                                  _bits(ref.table("t0")))


def test_reshard_errors():
    tier = make_tier(tsparse, 2)
    with pytest.raises(ValueError):
        tier.reshard(0)
    with pytest.raises(ValueError):
        tier.reshard(V + 1)
    tier.push(0, {"t0": (np.array([1]), torch.ones((1, D)))})
    with pytest.raises(RuntimeError):
        tier.reshard(4)
    # a plan with a solved row map (once refused) places the resharded
    # rows by that map, as the JAX tier does: tables, row versions and
    # every SparseStats field equal, and equal to the unresharded run; a
    # map that does not fit the table falls back to the policy
    from repro.core.placement import PlacementPlan as JaxPlacementPlan
    from repro_torch.core.placement import PlacementProblem

    owner = PlacementProblem.standard(
        num_shards=4, row_load={"t0": 1.0 / (np.arange(V) + 1.0)}).solve(
        seed=0).row_owner["t0"]
    base = drive(drive(make_tier(tsparse, 2, codec="int8", replication=2),
                       rounds=2), rounds=2, seed=31)
    for row_owner, policy in (({"t0": owner}, "plan"),
                              ({"t0": owner[:-1]}, "hash")):
        port = drive(make_tier(tsparse, 2, codec="int8", replication=2),
                     rounds=2)
        ref = drive(make_tier(jsparse, 2, codec="int8", replication=2),
                    rounds=2)
        port.reshard(4, plan=PlacementPlan(4, replication=2,
                                           row_owner=row_owner))
        ref.reshard(4, plan=JaxPlacementPlan(4, replication=2,
                                             row_owner=row_owner))
        assert port.tables["t0"].placement.policy == policy
        np.testing.assert_array_equal(port.tables["t0"].placement.owner,
                                      ref.tables["t0"].placement.owner)
        assert_tiers_equal(port, ref)
        drive(port, rounds=2, seed=31)
        drive(ref, rounds=2, seed=31)
        assert_tiers_equal(port, ref)
        np.testing.assert_array_equal(_bits(port.table("t0").numpy()),
                                      _bits(base.table("t0").numpy()))
        port.failover(1)
        ref.failover(1)
        assert_tiers_equal(port, ref)


def _fabric(num_shards, num_workers, link=None):
    dense = {"w": torch.zeros(2 * TILE_ELEMS)}
    space = ParamSpace.build(dense, chunk_elems=TILE_ELEMS)
    return PBoxFabric(space, sgd(0.1), space.flatten(dense), device="cpu",
                      config=FabricConfig(num_shards=num_shards,
                                          num_workers=num_workers,
                                          wire=WireConfig(link=link)))


def test_fabric_attached_tier_inherits():
    fab = _fabric(2, 3, LinkModel(wire_us_per_chunk=2.5))
    tier = tsparse.SparseTier(fabric=fab, lr=0.1)
    assert (tier.num_shards, tier.num_workers, tier.replication) == (2, 3, 1)
    assert tier.wire_us_per_chunk == 2.5
    assert tier.chunk_elems == fab.space.chunk_elems == TILE_ELEMS
    assert tier.device == fab.device and tier.topology is None
    assert [r() for r in fab.sparse_tiers] == [tier]
    tier.add_table("t0", INIT)
    drive(tier, rounds=1, workers=3)
    assert tier.round == 1
    assert tier.stats.sim_push_us == pytest.approx(
        2.5 * tier.stats.bytes_pushed / (4 * TILE_ELEMS))


def test_tier_barrier_follows_fabric_dead_workers():
    fab = _fabric(1, 3)
    tier = tsparse.SparseTier(fabric=fab)
    tier.add_table("t0", INIT)
    fab.dead_workers.add(2)
    tier.push(0, {"t0": (np.array([1]), torch.ones((1, D)))})
    assert tier.round == 0
    tier.push(1, {"t0": (np.array([2]), torch.ones((1, D)))})
    assert tier.round == 1


def test_unported_knobs_raise():
    # a topology is ported now: the tier takes the JAX tier's home and
    # chain racks from it and refuses one that places too few workers with
    # the JAX tier's message
    from repro.core.topology import NetworkTopology as JaxTopology
    from repro_torch.core.topology import NetworkTopology

    racked = tsparse.SparseTier(num_shards=4, num_workers=2, replication=2,
                                device="cpu",
                                topology=NetworkTopology(num_workers=4,
                                                         num_racks=2))
    jracked = jsparse.SparseTier(num_shards=4, num_workers=2, replication=2,
                                 topology=JaxTopology(num_workers=4,
                                                      num_racks=2))
    np.testing.assert_array_equal(racked.chain_racks, jracked.chain_racks)
    np.testing.assert_array_equal(racked.home_racks, jracked.home_racks)
    with pytest.raises(ValueError) as e:
        tsparse.SparseTier(num_shards=2, num_workers=3, device="cpu",
                           topology=NetworkTopology(num_workers=2,
                                                    num_racks=2))
    with pytest.raises(ValueError) as je:
        jsparse.SparseTier(num_shards=2, num_workers=3,
                           topology=JaxTopology(num_workers=2, num_racks=2))
    assert str(e.value) == str(je.value)
    # a plan without row maps gives the chain racks, as in the JAX tier;
    # one with a solved row map (once refused) places that table's rows
    # by it, as in the JAX tier, unless add_table names a policy
    from repro.core.placement import PlacementPlan as JaxPlacementPlan

    racks = np.array([[0, 1], [1, 0]])
    tier = tsparse.SparseTier(
        num_shards=2, num_workers=2, replication=2, device="cpu",
        plan=PlacementPlan(2, num_racks=2, replication=2,
                           replica_racks=racks))
    ref = jsparse.SparseTier(
        num_shards=2, num_workers=2, replication=2,
        plan=JaxPlacementPlan(2, num_racks=2, replication=2,
                              replica_racks=racks))
    np.testing.assert_array_equal(tier.chain_racks, ref.chain_racks)
    np.testing.assert_array_equal(tier.home_racks, ref.home_racks)
    owner = np.arange(V) % 3 % 2
    for placement, policy in ((None, "plan"), ("range", "range")):
        tier = tsparse.SparseTier(num_shards=2, num_workers=K, device="cpu",
                                  plan=PlacementPlan(2, row_owner={
                                      "t0": owner, "t1": [0, 1]}))
        ref = jsparse.SparseTier(num_shards=2, num_workers=K,
                                 plan=JaxPlacementPlan(2, row_owner={
                                     "t0": owner, "t1": [0, 1]}))
        for t in (tier, ref):
            t.add_table("t0", INIT, placement=placement)
            t.add_table("t1", INIT[:5])  # the map does not fit: hash
            drive(t)
        assert tier.tables["t0"].placement.policy == policy
        assert tier.tables["t1"].placement.policy == "hash"
        for name in ("t0", "t1"):
            np.testing.assert_array_equal(
                tier.tables[name].placement.owner,
                ref.tables[name].placement.owner)
        assert_tiers_equal(tier, ref)
    np.testing.assert_array_equal(
        tsparse.SparseTier(num_shards=2, num_workers=K, device="cpu",
                           plan=PlacementPlan(2, row_owner={"t0": owner}))
        .add_table("t0", INIT).placement.owner, owner)
    with pytest.raises(ValueError):
        tsparse.SparseTier(codec="fp8", device="cpu")
    with pytest.raises(ValueError):
        tsparse.SparseTier(placement="zigzag", device="cpu")
    with pytest.raises(ValueError):
        tsparse.SparseTier(replication=0, device="cpu")


def test_describe_and_restore_hook():
    tier = drive(make_tier(tsparse, 2, codec="int8", replication=2))
    ref = drive(make_tier(jsparse, 2, codec="int8", replication=2))
    assert tier.describe() == ref.describe()
    assert tier.stats.coalesce_rate == ref.stats.coalesce_rate > 0.0

    class Plane:
        invalidated = 0

        def invalidate(self):
            self.invalidated += 1

    plane = Plane()
    tier.read_planes.append(weakref.ref(plane))
    tier.on_restore()
    assert plane.invalidated == 1
