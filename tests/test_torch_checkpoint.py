"""The port's checkpointer: the file and fabric cases of
tests/test_checkpoint.py (roundtrip, async, atomic commits, GC,
crash-consistent mid-round fabric checkpoints, legacy checkpoints), plus
checkpoint directories crossing between the two packages and a
``save_async`` whose tensor changes in place after the call."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import Checkpointer as JaxCheckpointer  # noqa: E402
from repro.core.chunking import ParamSpace as JaxSpace  # noqa: E402
from repro.core.config import FabricConfig as JaxConfig  # noqa: E402
from repro.core.config import FaultConfig as JaxFaults  # noqa: E402
from repro.core.fabric import PBoxFabric as JaxFabric  # noqa: E402
from repro.optim.optimizers import momentum as jax_momentum  # noqa: E402
from repro_torch.checkpoint import (  # noqa: E402
    Checkpointer,
    fabric_snapshot_to_flat,
    flat_to_fabric_snapshot,
)
from repro_torch.core.chunking import TILE_ELEMS, ParamSpace  # noqa: E402
from repro_torch.core.config import FabricConfig  # noqa: E402
from repro_torch.core.fabric import PBoxFabric  # noqa: E402
from repro_torch.optim.optimizers import momentum  # noqa: E402

K = 4
N = 4 * TILE_ELEMS - 100


def state(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "pflat": rng.normal(size=(2, 4096)).astype(np.float32),
        "slot0": rng.normal(size=(2, 4096)).astype(np.float32),
        "step": np.int64(7),
    }


def test_roundtrip(tmp_path):
    ck = Checkpointer(tmp_path)
    s = state()
    ck.save(7, {**s, "gone": None, "t": torch.arange(5.0)})
    out, meta = ck.restore()
    for k in s:
        np.testing.assert_array_equal(out[k], s[k])
    np.testing.assert_array_equal(out["t"], np.arange(5.0, dtype=np.float32))
    assert "gone" not in out and meta == {}


def test_async_and_wait(tmp_path):
    ck = Checkpointer(tmp_path)
    ck.save_async(1, state(1))
    ck.save_async(2, state(2))  # waits for the first internally
    ck.wait()
    assert ck.latest_step() == 2


def test_save_async_copies_before_it_returns(tmp_path):
    """The fabric's kernels write its state in place on the card: a tensor
    changed after ``save_async`` returns must not reach the file."""
    ck = Checkpointer(tmp_path)
    t = torch.arange(1 << 16, dtype=torch.float32)
    a = np.arange(8, dtype=np.float32)
    before = t.clone()
    ck.save_async(3, {"t": t, "a": a})
    t.mul_(-1.0)
    a += 1.0
    ck.wait()
    out, _ = ck.restore(3)
    np.testing.assert_array_equal(out["t"], before.numpy())
    np.testing.assert_array_equal(out["a"], np.arange(8, dtype=np.float32))


def test_async_error_surfaces_on_wait(tmp_path):
    ck = Checkpointer(tmp_path)
    ck.save_async(1, {"bad/name": np.zeros(3), "x": np.ones(2)})
    ck.wait()  # '/' is mapped to '_' in the file name: no error
    assert ck.restore(1)[0]["bad/name"].shape == (3,)
    (tmp_path / "blocker").write_text("")
    ck.dir = tmp_path / "blocker"  # a file where the directory should be
    ck.save_async(2, state())
    with pytest.raises(OSError):
        ck.wait()


def test_atomic_no_partial_visible(tmp_path):
    ck = Checkpointer(tmp_path)
    ck.save(5, state())
    # a crashed writer: a stale tmp dir and a step dir without a manifest
    (tmp_path / "tmp-9-123").mkdir()
    broken = tmp_path / "step-0000000009"
    broken.mkdir()
    (broken / "pflat.npy").write_bytes(b"garbage")
    assert ck.latest_step() == 5
    out, _ = ck.restore()
    np.testing.assert_array_equal(out["step"], state()["step"])


def test_gc_keeps_latest(tmp_path):
    ck = Checkpointer(tmp_path, keep=2)
    for i in range(5):
        ck.save(i, state(i))
    assert len(list(tmp_path.glob("step-*"))) == 2
    assert ck.latest_step() == 4
    with pytest.raises(FileNotFoundError):
        Checkpointer(tmp_path / "empty").restore()


# ---------------------------------------------------------------------------
# crash-consistent fabric checkpoints
# ---------------------------------------------------------------------------
def _grads(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(N + 100).astype(np.float32) for _ in range(K)]


def _torch_fabric():
    space = ParamSpace.build({"w": torch.zeros(N)}, chunk_elems=TILE_ELEMS)
    return PBoxFabric(space, momentum(0.1, 0.9), torch.zeros(space.flat_elems),
                      config=FabricConfig(num_shards=2, num_workers=K),
                      device="cpu")


def _jax_fabric(replication=1):
    space = JaxSpace.build({"w": jnp.zeros((N,))}, chunk_elems=TILE_ELEMS)
    return JaxFabric(space, jax_momentum(0.1, 0.9),
                     jnp.zeros((space.flat_elems,)),
                     config=JaxConfig(num_shards=2, num_workers=K,
                                      faults=JaxFaults(replication=replication)))


def _round(fab, grads, r, workers=range(K)):
    for w in workers:
        fab.pull(w)
        g = grads[(w + r) % K]
        fab.push(w, jnp.asarray(g) if isinstance(fab, JaxFabric)
                 else torch.from_numpy(g))


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def test_mid_round_checkpoint_reconverges_bit_identically(tmp_path):
    """A checkpoint taken between push admission and apply (two pushes
    staged) restores to a state from which training re-converges
    bit-identically to the failure-free run: the in-flight pushes are
    rolled back and replayed, never half-applied."""
    grads = _grads()
    fab = _torch_fabric()
    _round(fab, grads, 0)
    _round(fab, grads, 1)
    _round(fab, grads, 2, workers=(0, 1))
    assert fab.stats.steps == 2
    ck = Checkpointer(tmp_path)
    assert ck.save_fabric(2, fab, meta={"note": "mid-round"}).exists()
    fab2 = _torch_fabric()
    meta = ck.restore_fabric(fab2)
    assert meta["fabric_schema"] == 2 and meta["fault_round"] == 2
    assert meta["note"] == "mid-round" and meta["num_workers"] == K
    assert meta["replication"] == 1
    assert (fab2.worker_clock == 2).all()  # in-flight pushes rolled back
    for r in (2, 3):
        _round(fab2, grads, r)
    twin = _torch_fabric()
    for r in range(4):
        _round(twin, grads, r)
    assert torch.equal(twin.params, fab2.params)
    assert twin.step == fab2.step == 4


def test_legacy_fabric_checkpoint_without_metadata(tmp_path):
    """A checkpoint without worker_clock / dead_workers / replication
    arrays (and without fabric meta) restores an all-alive fabric with
    every clock at the checkpointed step."""
    grads = _grads()
    fab = _torch_fabric()
    _round(fab, grads, 0)
    flat = fabric_snapshot_to_flat(fab.snapshot())
    legacy = {k: v for k, v in flat.items()
              if k not in ("worker_clock", "dead_workers", "replication")}
    ck = Checkpointer(tmp_path)
    ck.save(1, legacy)
    fab2 = _torch_fabric()
    fab2.dead_workers = {0}  # restore must clear earlier crash state
    assert ck.restore_fabric(fab2) == {}
    assert not fab2.dead_workers
    assert (fab2.worker_clock == 1).all()
    assert torch.equal(fab.params, fab2.params)


def test_flat_snapshot_helpers_roundtrip():
    fab = _torch_fabric()
    _round(fab, _grads(), 0)
    snap = fab.snapshot()
    back = flat_to_fabric_snapshot(fabric_snapshot_to_flat(snap))
    np.testing.assert_array_equal(back["params"], snap["params"])
    assert len(back["state"]) == len(snap["state"]) == 1
    for a, b in zip(back["state"], snap["state"]):
        np.testing.assert_array_equal(a, b)
    assert back["step"] == snap["step"]
    assert int(back["replication"]) == snap["replication"]


@pytest.mark.parametrize("mid_round", [False, True], ids=["edge", "mid"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_directory_crosses_packages(tmp_path, writer, mid_round):
    """Each package restores a fabric checkpoint directory the other wrote,
    and the restored fabric runs on bitwise equal to the writer's."""
    grads = _grads(1)
    jfab, tfab = _jax_fabric(), _torch_fabric()
    src, dst = (jfab, tfab) if writer == "jax" else (tfab, jfab)
    write_ck, read_ck = ((JaxCheckpointer, Checkpointer) if writer == "jax"
                         else (Checkpointer, JaxCheckpointer))
    _round(src, grads, 0)
    _round(src, grads, 1)
    if mid_round:
        _round(src, grads, 2, workers=(1, 3))
    write_ck(tmp_path).save_fabric(7, src)
    manifest = json.loads((tmp_path / "step-0000000007" /
                           "manifest.json").read_text())
    assert sorted(manifest["arrays"]) == sorted(
        ["params", "step", "slot0", "worker_clock", "dead_workers",
         "replication"])
    meta = read_ck(tmp_path).restore_fabric(dst)
    assert meta["fault_round"] == 2 and dst.step == 2
    write_ck(tmp_path).restore_fabric(src)  # the writer resumes from it too
    for f in (src, dst):
        _round(f, grads, 2)
        _round(f, grads, 3)
    np.testing.assert_array_equal(_bits(jfab.params), _bits(tfab.params))
    np.testing.assert_array_equal(jfab.worker_clock, tfab.worker_clock)


def test_dead_workers_cross_from_a_jax_checkpoint(tmp_path):
    """A JAX fabric with replication and a crashed worker checkpoints; the
    port restores the crash (not the replication, which it lacks)."""
    grads = _grads()
    jfab = _jax_fabric(replication=2)
    _round(jfab, grads, 0)
    jfab.crash_worker(3)
    JaxCheckpointer(tmp_path).save_fabric(1, jfab)
    fab = _torch_fabric()
    meta = Checkpointer(tmp_path).restore_fabric(fab)
    assert meta["replication"] == 2
    assert fab.dead_workers == {3} and fab.replication == 1
    np.testing.assert_array_equal(_bits(jfab.params), _bits(fab.params))
