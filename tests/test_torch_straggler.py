"""The port's straggler policies (``runtime/straggler.py``) and placement
deltas (``core/placement.py``) against the JAX package's: the monitor,
the policy, ``rebalance_chunks`` (the golden of tests/test_placement.py),
and the rebalancer's loop on a live fabric, drained shards included."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core import placement as jplacement  # noqa: E402
from repro.runtime import straggler as jstraggler  # noqa: E402
from repro_torch.core import placement as tplacement  # noqa: E402
from repro_torch.core.chunking import TILE_ELEMS, ParamSpace  # noqa: E402
from repro_torch.core.config import FabricConfig  # noqa: E402
from repro_torch.core.fabric import PBoxFabric  # noqa: E402
from repro_torch.optim.optimizers import momentum  # noqa: E402
from repro_torch.runtime import straggler  # noqa: E402
from repro_torch.runtime.straggler import (  # noqa: E402
    ShardRebalancer,
    StragglerMonitor,
    StragglerPolicy,
    rebalance_chunks,
)

K = 4


def test_monitor_flags_the_persistent_straggler():
    mon = StragglerMonitor(4, threshold=2.0)
    ref = jstraggler.StragglerMonitor(4, threshold=2.0)
    for _ in range(10):
        for w, lat in enumerate([0.1, 0.1, 0.1, 0.9]):
            mon.record(w, lat)
            ref.record(w, lat)
    assert mon.stragglers() == ref.stragglers() == [3]
    assert StragglerMonitor(3).stragglers() == []  # no samples, no flags


def test_monitor_window_forgets_old_spikes():
    mon = StragglerMonitor(3, threshold=2.0, window=5)
    for _ in range(5):
        for w, lat in enumerate([0.1, 5.0, 0.1]):
            mon.record(w, lat)
    assert mon.stragglers() == [1]
    for _ in range(5):
        for w in range(3):
            mon.record(w, 0.1)
    assert mon.stragglers() == [] and len(mon.lat[1]) == 5


@pytest.mark.parametrize("policy", [
    dict(), dict(mode="backup", min_push_fraction=0.75),
    dict(mode="stale", staleness=3)], ids=["sync", "backup", "stale"])
def test_policy_server_kwargs_match_jax(policy):
    kw = StragglerPolicy(**policy).server_kwargs()
    assert kw == jstraggler.StragglerPolicy(**policy).server_kwargs()
    FabricConfig(num_workers=K, **kw).validate()  # the port builds it


def test_rebalance_chunks_golden_and_delta():
    owner = np.array([0, 1, 2, 0, 1, 2])
    out = rebalance_chunks(owner, [0], 3)
    assert not np.any(out == 0)
    counts = np.bincount(out, minlength=3)
    assert counts.max() - counts[1:].min() <= 1
    delta = straggler.chunk_rebalance_delta(owner, [0], 3)
    assert delta.kind == "chunk_moves"
    assert {c for c, _ in delta.moves} == {0, 3}
    assert straggler.chunk_rebalance_delta(owner, [], 3) is None
    assert straggler.PlanDelta is tplacement.PlanDelta
    # nowhere to move to: unchanged
    np.testing.assert_array_equal(rebalance_chunks(owner, [0, 1, 2], 3), owner)


@pytest.mark.parametrize("seed", range(6))
def test_rebalance_chunks_matches_jax(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 9))
    owner = rng.integers(0, n, int(rng.integers(1, 200)))
    slow = sorted(set(rng.integers(0, n, int(rng.integers(1, n))).tolist()))
    np.testing.assert_array_equal(
        rebalance_chunks(owner, slow, n),
        jplacement.rebalance_chunks(owner, slow, n))
    mine = tplacement.chunk_rebalance_delta(owner, slow, n)
    theirs = jplacement.chunk_rebalance_delta(owner, slow, n)
    assert (mine is None) == (theirs is None)
    if mine is not None:
        assert (mine.kind, mine.moves) == (theirs.kind, theirs.moves)
        assert mine.describe() == theirs.describe()


def test_plan_delta_validates_like_jax():
    for kw in (dict(kind="chunk_moves", moves=[(np.int64(3), 1.0)]),
               dict(kind="replica_racks", shard=1, racks=[np.int32(0), 1]),
               dict(kind="shard_count", new_shards=4),
               dict(kind="frontend_move", frontend=0, rack=1),
               dict(kind="tenant_shares", shares=[("a", 2)])):
        mine, theirs = tplacement.PlanDelta(**kw), jplacement.PlanDelta(**kw)
        assert mine.describe() == theirs.describe()
        assert (mine.moves, mine.racks, mine.shares) == (
            theirs.moves, theirs.racks, theirs.shares)
    with pytest.raises(ValueError, match="unknown delta kind"):
        tplacement.PlanDelta(kind="resize")


def _fabric(num_shards=4, steps=2):
    params = {"w": torch.linspace(-1, 1, 9000), "b": torch.zeros(77)}
    space = ParamSpace.build(params, chunk_elems=TILE_ELEMS)
    fab = PBoxFabric(space, momentum(0.05, 0.9), space.flatten(params),
                     config=FabricConfig(num_shards=num_shards,
                                         num_workers=K),
                     device="cpu")
    for _ in range(steps):
        for w in range(K):
            fab.push(w, fab.pull(w) * (w + 1))
    return fab


def test_shard_rebalancer_hook():
    fab = _fabric()
    reb = ShardRebalancer(fab, threshold=2.0, cooldown=0)
    for _ in range(10):
        for s, lat in enumerate([0.1, 0.1, 0.1, 0.9]):
            reb.record(s, lat)
    np.testing.assert_allclose(reb.speeds(), [0.1, 0.1, 0.1, 0.9])
    assert reb.maybe_rebalance() == [3]
    assert fab.shards[3].num_chunks == 0
    assert fab.stats.rebalances == 1
    # drained shard still flagged but empty; nothing left to move
    assert reb.maybe_rebalance() == []
    assert reb.propose() is None


def test_rebalancer_never_targets_drained_slow_shard():
    """A shard drained earlier but still slow must not become the
    minimum-count destination when another shard goes slow later."""
    fab = _fabric()
    reb = ShardRebalancer(fab, threshold=1.5, cooldown=0)
    for _ in range(10):
        for s, lat in enumerate([0.1, 0.1, 0.1, 0.9]):
            reb.record(s, lat)
    assert reb.maybe_rebalance() == [3]
    for _ in range(20):
        for s, lat in enumerate([0.1, 0.1, 0.9, 0.9]):
            reb.record(s, lat)
    assert reb.maybe_rebalance() == [2]
    assert fab.shards[2].num_chunks == 0
    assert fab.shards[3].num_chunks == 0  # NOT refilled with 2's chunks
    counts = np.bincount(fab.chunk_owner, minlength=4)[:2]
    assert counts.sum() == fab.space.num_chunks
    assert counts.max() - counts.min() <= 1


def test_propose_and_cooldown():
    fab = _fabric()
    reb = ShardRebalancer(fab, threshold=2.0, cooldown=3)
    for _ in range(10):
        for s, lat in enumerate([0.1, 0.9, 0.1, 0.1]):
            reb.record(s, lat)
    delta = reb.propose()
    assert delta.kind == "chunk_moves"
    assert {fab.chunk_owner[c] for c, _ in delta.moves} == {1}
    assert fab.apply_plan_delta(delta) == len(delta.moves)
    reb.mark_applied()
    assert reb.propose() is None and reb.maybe_rebalance() == []  # cooldown
    for _ in range(3):  # the cooldown counts fabric steps
        for w in range(K):
            fab.push(w, fab.pull(w))
    assert reb.propose() is None  # past the cooldown, but shard 1 is empty
    for _ in range(20):  # a full window: shard 1 recovered, 3 is slow
        for s, lat in enumerate([0.1, 0.1, 0.1, 0.9]):
            reb.record(s, lat)
    assert reb.maybe_rebalance() == [3] and fab.stats.rebalances == 2
