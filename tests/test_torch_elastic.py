"""The PyTorch ``runtime/elastic.py`` against the JAX one.

Mirrors tests/test_elastic.py and the ``elastic_restore`` /
``reshard_flat`` cases of tests/test_topology.py: the flat re-slice
primitives give the JAX functions' arrays and errors; a snapshot of either
package's fabric, re-targeted onto another owner count, restores into the
port's fabric (clocks reset where the worker count changes, legacy
snapshots without clocks, a stateless optimizer), and training continues
bit for bit as the JAX fabric's does.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core.chunking import TILE_ELEMS as JAX_TILE  # noqa: E402
from repro.core.chunking import ParamSpace as JaxSpace  # noqa: E402
from repro.core.config import FabricConfig as JaxConfig  # noqa: E402
from repro.core.config import WireConfig as JaxWire  # noqa: E402
from repro.core.fabric import PBoxFabric as JaxFabric  # noqa: E402
from repro.core.fabric import WorkerHarness as JaxHarness  # noqa: E402
from repro.core.topology import NetworkTopology as JaxTopology  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro.runtime import elastic as jelastic  # noqa: E402
from repro_torch.core.chunking import TILE_ELEMS, ParamSpace  # noqa: E402
from repro_torch.core.config import FabricConfig, WireConfig  # noqa: E402
from repro_torch.core.fabric import PBoxFabric, WorkerHarness  # noqa: E402
from repro_torch.core.topology import NetworkTopology  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402
from repro_torch.runtime import elastic  # noqa: E402
from repro_torch.runtime.elastic import (  # noqa: E402
    elastic_restore,
    owner_slabs,
    rebuild_space,
    reshard_flat,
)

K = 4
SPECS = {"momentum": lambda o: o.momentum(0.05, 0.9),
         "adamw": lambda o: o.adamw(3e-3),
         "sgd": lambda o: o.sgd(0.01)}


def setup(elems=3000):
    """tests/test_elastic.py's job on both packages: (JAX space, port
    space, JAX grad_fn, port grad_fn)."""
    tw = [np.full(elems, float(i + 1), np.float32) for i in range(K)]
    tb = [np.arange(40, dtype=np.float32) * (i + 1) for i in range(K)]
    jspace = JaxSpace.build({"w": jnp.zeros((elems,)), "b": jnp.zeros((40,))},
                            chunk_elems=JAX_TILE, num_owners=4)
    tspace = ParamSpace.build({"w": torch.zeros(elems), "b": torch.zeros(40)},
                              chunk_elems=TILE_ELEMS, num_owners=4)

    def jgrad(p, batch):
        return {"w": 2 * (p["w"] - jnp.asarray(tw[batch])),
                "b": 2 * (p["b"] - jnp.asarray(tb[batch]))}

    def tgrad(p, batch):
        return {"w": 2 * (p["w"] - torch.from_numpy(tw[batch])),
                "b": 2 * (p["b"] - torch.from_numpy(tb[batch]))}

    return jspace, tspace, jgrad, tgrad


def jax_fab(space, spec, init, shards, workers=K, racks=1):
    topo = JaxTopology(workers, racks) if racks > 1 else None
    return JaxFabric(space, SPECS[spec](jopt), jnp.asarray(init),
                     config=JaxConfig(num_shards=shards, num_workers=workers,
                                      wire=JaxWire(topology=topo)))


def torch_fab(space, spec, init, shards, workers=K, racks=1):
    topo = NetworkTopology(workers, racks) if racks > 1 else None
    return PBoxFabric(space, SPECS[spec](topt),
                      torch.from_numpy(np.array(init, np.float32)),
                      config=FabricConfig(num_shards=shards,
                                          num_workers=workers,
                                          wire=WireConfig(topology=topo)),
                      device="cpu")


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def same_snapshots(a: dict, b: dict) -> None:
    assert sorted(a) == sorted(b)
    for k in a:
        if k in ("params", "state"):
            np.testing.assert_array_equal(_bits(np.asarray(a[k])),
                                          _bits(np.asarray(b[k])))
        else:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


# ---------------------------------------------------------------------------
# the flat re-slice primitives
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("old,new", [(4, 3), (2, 3), (4, 8), (4, 1)])
def test_reshard_flat_matches_jax(old, new):
    chunk = TILE_ELEMS
    flat = np.arange(4 * chunk, dtype=np.float32)
    out = reshard_flat(flat, old_owners=old, new_owners=new,
                       chunk_elems=chunk)
    np.testing.assert_array_equal(
        out, jelastic.reshard_flat(flat, old, new, chunk))
    np.testing.assert_array_equal(out[: 4 * chunk], flat)  # payload intact
    assert (out[4 * chunk:] == 0).all()  # padding at the tail
    slabs = owner_slabs(out, new)
    assert len(slabs) == new
    for a, b in zip(slabs, jelastic.owner_slabs(out, new)):
        np.testing.assert_array_equal(a, b)


def test_reshard_flat_rejects_misaligned_input():
    chunk = TILE_ELEMS
    for args in ((np.zeros((chunk + 1,), np.float32), 1, 2, chunk),
                 (np.zeros((4 * chunk,), np.float32), 3, 2, chunk),
                 (np.zeros((4 * chunk,), np.float32), 0, 2, chunk)):
        with pytest.raises(ValueError) as te:
            reshard_flat(*args)
        with pytest.raises(ValueError) as je:
            jelastic.reshard_flat(*args)
        assert str(te.value) == str(je.value)


@pytest.mark.parametrize("owners", [1, 3, 8])
def test_rebuild_space_repads_chunks_for_new_owner_count(owners):
    jspace, tspace, _, _ = setup()
    assert tspace.num_owners == 4 and tspace.num_chunks == 4
    t, j = rebuild_space(tspace, owners), jelastic.rebuild_space(jspace,
                                                                owners)
    assert (t.num_owners, t.num_chunks, t.flat_elems, t.payload_elems) == \
        (j.num_owners, j.num_chunks, j.flat_elems, j.payload_elems)
    assert t.slots == tspace.slots and t.treedef == tspace.treedef
    assert t.num_chunks == {1: 3, 3: 3, 8: 8}[owners]


# ---------------------------------------------------------------------------
# elastic_restore paths
# ---------------------------------------------------------------------------
def test_elastic_restore_legacy_snapshot_without_worker_clock():
    jspace, tspace, jgrad, tgrad = setup()
    zeros = np.zeros(tspace.flat_elems, np.float32)
    ref = jax_fab(jspace, "momentum", zeros, 4)
    JaxHarness(ref, jgrad, lambda w, s: w).run(3)
    fab = torch_fab(tspace, "momentum", zeros, 4)
    WorkerHarness(fab, tgrad, lambda w, s: w).run(3)
    legacy = {k: v for k, v in fab.snapshot().items() if k != "worker_clock"}
    out, new_space = elastic_restore(legacy, tspace, new_owners=2)
    jout, _ = jelastic.elastic_restore(
        {k: v for k, v in ref.snapshot().items() if k != "worker_clock"},
        jspace, 2)
    same_snapshots(out, jout)
    assert "worker_clock" not in out and out["step"] == 3
    fab2 = torch_fab(new_space, "momentum", out["params"], 2)
    fab2.restore(out)
    assert fab2.step == 3
    np.testing.assert_array_equal(fab2.worker_clock, [3] * K)
    for w in range(K):
        g = tgrad(new_space.unflatten(fab2.pull(w)), w)
        fab2.push(w, new_space.flatten(g))
    assert fab2.step == 4 and fab2.stats.late_pushes_dropped == 0


@pytest.mark.parametrize("new_workers", [2, 8])
def test_elastic_restore_worker_count_change_resets_clocks(new_workers):
    _, tspace, _, tgrad = setup()
    fab = torch_fab(tspace, "adamw", np.zeros(tspace.flat_elems), 4)
    WorkerHarness(fab, tgrad, lambda w, s: w).run(3)
    snap = fab.snapshot()
    out, new_space = elastic_restore(snap, tspace, new_owners=2)
    np.testing.assert_array_equal(out["worker_clock"], snap["worker_clock"])
    fab2 = torch_fab(new_space, "adamw", out["params"], 2,
                     workers=new_workers)
    fab2.restore(out)
    assert fab2.worker_clock.shape == (new_workers,)
    assert (fab2.worker_clock == 3).all()


@pytest.mark.parametrize("new_owners", [1, 3, 8])
def test_elastic_restore_training_continues_identically(new_owners):
    """Grow and shrink: AdamW's two slots re-target with the params; the
    port, restored from the JAX fabric's snapshot, trains on as the JAX
    fabric restored from its own does, and as the uninterrupted run on
    the payload."""
    jspace, tspace, jgrad, tgrad = setup()
    zeros = np.zeros(tspace.flat_elems, np.float32)
    full = torch_fab(tspace, "adamw", zeros, 4)
    WorkerHarness(full, tgrad, lambda w, s: w).run(5)
    ref = jax_fab(jspace, "adamw", zeros, 4)
    JaxHarness(ref, jgrad, lambda w, s: w).run(3)
    jout, jnew = jelastic.elastic_restore(ref.snapshot(), jspace, new_owners)
    out, new_space = elastic_restore(ref.snapshot(), tspace, new_owners)
    same_snapshots(out, jout)
    assert np.asarray(out["state"]).shape == (2, new_space.flat_elems)
    ref2 = jax_fab(jnew, "adamw", jout["params"], new_owners)
    ref2.restore(jout)
    fab2 = torch_fab(new_space, "adamw", out["params"], new_owners)
    fab2.restore(out)
    JaxHarness(ref2, jgrad, lambda w, s: w).run(2)
    WorkerHarness(fab2, tgrad, lambda w, s: w).run(2)
    np.testing.assert_array_equal(_bits(ref2.params),
                                  _bits(fab2.params.numpy()))
    assert dataclasses.asdict(ref2.stats) == dataclasses.asdict(fab2.stats)
    n = min(tspace.payload_elems, new_space.payload_elems)
    assert torch.equal(full.params[:n], fab2.params[:n])


def test_elastic_restore_preserves_empty_state_and_scalars():
    jspace, tspace, _, _ = setup()
    snap = {"params": np.zeros((tspace.flat_elems,), np.float32),
            "state": (), "step": 7, "worker_clock": np.arange(K)}
    out, new_space = elastic_restore(snap, tspace, new_owners=3)
    jout, _ = jelastic.elastic_restore(snap, jspace, 3)
    same_snapshots(out, jout)
    assert out["state"] == () and out["step"] == 7
    np.testing.assert_array_equal(out["worker_clock"], np.arange(K))
    assert out["params"].shape == (new_space.flat_elems,)
    assert elastic.METADATA_KEYS == jelastic.METADATA_KEYS


# ---------------------------------------------------------------------------
# tests/test_topology.py's elastic cases
# ---------------------------------------------------------------------------
def test_elastic_restore_shrink_grow_keeps_worker_clock():
    """worker_clock passes through elastic_restore untouched; restore
    resets clocks when the worker count changed, on a flat fabric and on a
    rack fabric, and the restored fabrics admit pushes at once."""
    _, tspace, _, tgrad = setup()
    fab = torch_fab(tspace, "momentum", np.zeros(tspace.flat_elems), 2)
    WorkerHarness(fab, tgrad, lambda w, s: w).run(3)
    snap = fab.snapshot()
    out, new_space = elastic_restore(snap, tspace, new_owners=2)
    np.testing.assert_array_equal(out["worker_clock"], snap["worker_clock"])
    assert out["step"] == 3
    shrunk = torch_fab(new_space, "momentum", out["params"], 2, workers=2)
    shrunk.restore(out)
    assert shrunk.worker_clock.shape == (2,)
    assert (shrunk.worker_clock == 3).all()
    grown = torch_fab(new_space, "momentum", out["params"], 2, workers=8,
                      racks=2)
    grown.restore(out)
    assert (grown.worker_clock == 3).all()
    g = torch.zeros(new_space.flat_elems)
    shrunk.push(0, g)
    shrunk.push(1, g)
    assert shrunk.stats.late_pushes_dropped == 0
    assert shrunk.step == 4


def test_elastic_restore_stateless_optimizer():
    """sgd has no optimizer slots: the empty state tuple survives
    elastic_restore as an empty tuple and restores."""
    jspace, tspace, jgrad, tgrad = setup()
    zeros = np.zeros(tspace.flat_elems, np.float32)
    fab = torch_fab(tspace, "sgd", zeros, 2)
    WorkerHarness(fab, tgrad, lambda w, s: w).run(2)
    snap = fab.snapshot()
    assert snap["state"] == ()
    out, new_space = elastic_restore(snap, tspace, new_owners=2)
    assert out["state"] == ()
    fab2 = torch_fab(new_space, "sgd", out["params"], 2)
    fab2.restore(out)
    assert fab2.step == 2
    ref = jax_fab(jspace, "sgd", zeros, 2)
    ref.restore(out)
    for f, space, grad in ((fab2, new_space, tgrad), (ref, jspace, jgrad)):
        for w in range(K):
            f.push(w, space.flatten(grad(space.unflatten(f.pull(w)), w)))
    np.testing.assert_array_equal(_bits(ref.params),
                                  _bits(fab2.params.numpy()))


def test_reshard_flat_validates_old_owners():
    chunk = TILE_ELEMS
    flat = np.zeros((4 * chunk,), np.float32)
    with pytest.raises(ValueError):
        reshard_flat(flat, old_owners=3, new_owners=2, chunk_elems=chunk)
    out = reshard_flat(flat, old_owners=2, new_owners=3, chunk_elems=chunk)
    assert out.shape[0] == 6 * chunk
