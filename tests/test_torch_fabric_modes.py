"""The PyTorch fabric's straggler modes against the JAX fabric, bitwise.

Both fabrics are built from ``FabricConfig`` and driven with the same
numpy-made targets: the workers minimize ``||w - t_w||^2``, whose gradient
``2 * (w - t_w)`` is one f32 subtract and one multiply in either package.
The modes:

  quorum  sync with a backup quorum of 3 of 4 workers, driven by hand:
          every worker pulls, then all four push in order, so the round
          fires on the third push and worker 3's push (computed against
          the superseded params) is dropped at admission, before the codec;
  ssp     stale mode, staleness 2, worker speeds [1, 1, 1, 4];
  async   every push applied at once (K = 1, no averaging), worker speeds
          [1, 1, 1, 3].

Each runs with codec none, bf16 and int8 (error feedback on), on the fused
wire route and the unfused one (the port reaches it by declaring the
geometry unsupported, the JAX package by its ``fused_wire_path`` switch),
over 1, 2 and 8 shards.  Params, optimizer state, the error-feedback
residuals, the clocks and every ``ServerStats`` / ``ShardStats`` field
must match exactly."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core.chunking import ParamSpace as JaxSpace  # noqa: E402
from repro.core.compression import CompressionConfig as JaxCompression  # noqa: E402
from repro.core.config import FabricConfig as JaxConfig  # noqa: E402
from repro.core.config import WireConfig as JaxWire  # noqa: E402
from repro.core.fabric import PBoxFabric as JaxFabric  # noqa: E402
from repro.core.fabric import WorkerHarness as JaxHarness  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro_torch.core import fabric as tfabric  # noqa: E402
from repro_torch.core.chunking import ParamSpace  # noqa: E402
from repro_torch.core.compression import CompressionConfig  # noqa: E402
from repro_torch.core.config import FabricConfig, WireConfig  # noqa: E402
from repro_torch.core.fabric import PBoxFabric, WorkerHarness  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402

K = 4
W_ELEMS, B_ELEMS = 33000, 77  # 9 chunks of 4096: every shard of 8 owns one
CHUNK = {"none": 1024, "bf16": 4096, "int8": 4096}
MODES = {
    "quorum": dict(mode="sync", min_push_fraction=0.75),
    "ssp": dict(mode="stale", staleness=2),
    "async": dict(mode="async"),
}
SPEED = {"ssp": [1, 1, 1, 4], "async": [1, 1, 1, 3]}
STEPS = 3  # rounds (quorum) or steps of the slowest worker


def _targets():
    rng = np.random.default_rng(7)
    return [{"w": rng.standard_normal(W_ELEMS).astype(np.float32) * (i + 1),
             "b": rng.standard_normal(B_ELEMS).astype(np.float32)}
            for i in range(K)]


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def jax_fabric(mode, codec, fused, num_shards):
    targets = [{k: jnp.asarray(v) for k, v in t.items()} for t in _targets()]
    params = {"w": jnp.zeros((W_ELEMS,)), "b": jnp.zeros((B_ELEMS,))}
    space = JaxSpace.build(params, chunk_elems=CHUNK[codec])
    fab = JaxFabric(space, jopt.adamw(3e-3), space.flatten(params),
                    config=JaxConfig(
                        num_shards=num_shards, num_workers=K,
                        wire=JaxWire(compression=JaxCompression(codec=codec),
                                     fused_wire_path=fused),
                        **MODES[mode]))

    def grad_fn(p, w):
        return jax.tree.map(lambda a, b: 2 * (a - b), p, targets[w])

    return fab, grad_fn, JaxHarness


def torch_fabric(mode, codec, num_shards):
    targets = [{k: torch.from_numpy(v) for k, v in t.items()}
               for t in _targets()]
    params = {"w": torch.zeros(W_ELEMS), "b": torch.zeros(B_ELEMS)}
    space = ParamSpace.build(params, chunk_elems=CHUNK[codec])
    fab = PBoxFabric(space, topt.adamw(3e-3), space.flatten(params),
                     config=FabricConfig(
                         num_shards=num_shards, num_workers=K,
                         wire=WireConfig(
                             compression=CompressionConfig(codec=codec)),
                         **MODES[mode]),
                     device="cpu")

    def grad_fn(p, w):
        return {k: 2 * (p[k] - targets[w][k]) for k in p}

    return fab, grad_fn, WorkerHarness


def drive(mode, fab, grad_fn, harness):
    """The mode's schedule; ``quorum`` pulls all, then pushes all."""
    if mode != "quorum":
        harness(fab, grad_fn, lambda w, s: w, speed=SPEED[mode]).run(STEPS)
        return
    for _ in range(STEPS):
        pulled = [fab.space.unflatten(fab.pull(w)) for w in range(K)]
        for w in range(K):
            fab.push(w, fab.space.flatten(grad_fn(pulled[w], w)))


def assert_same(ref, fab):
    np.testing.assert_array_equal(_bits(ref.params), _bits(fab.params.numpy()))
    assert len(ref.shards) == len(fab.shards)
    for js, ts in zip(ref.shards, fab.shards):
        np.testing.assert_array_equal(js.chunk_ids, ts.chunk_ids)
        for a, b in zip(js.state, ts.state):
            np.testing.assert_array_equal(_bits(a), _bits(b.numpy()))
        assert dataclasses.asdict(js.stats) == dataclasses.asdict(ts.stats)
    assert sorted(ref._worker_ef) == sorted(fab._worker_ef)
    for w, ef in ref._worker_ef.items():
        np.testing.assert_array_equal(_bits(ef), _bits(fab._worker_ef[w].numpy()))
    assert dataclasses.asdict(ref.stats) == dataclasses.asdict(fab.stats)
    np.testing.assert_array_equal(ref.worker_clock, fab.worker_clock)
    np.testing.assert_array_equal(ref._pull_step, fab._pull_step)
    assert ref.step == fab.step


ROUTES = [("none", True), ("bf16", True), ("bf16", False), ("int8", True),
          ("int8", False)]


@pytest.mark.parametrize("num_shards", [1, 2, 8])
@pytest.mark.parametrize("codec,fused", ROUTES,
                         ids=["none", "bf16-fused", "bf16-unfused",
                              "int8-fused", "int8-unfused"])
@pytest.mark.parametrize("mode", list(MODES))
def test_mode_matches_jax_bitwise(mode, codec, fused, num_shards,
                                  monkeypatch):
    ref, jgrad, jharness = jax_fabric(mode, codec, fused, num_shards)
    drive(mode, ref, jgrad, jharness)
    if not fused:
        monkeypatch.setattr(tfabric, "wire_path_supported", lambda *a: False)
    fab, tgrad, tharness = torch_fabric(mode, codec, num_shards)
    drive(mode, fab, tgrad, tharness)
    assert fab._fused_wire == ref._fused_wire == (fused and codec != "none")
    assert_same(ref, fab)
    st = fab.stats
    if mode == "quorum":
        assert (st.steps, st.partial_aggregations,
                st.late_pushes_dropped) == (STEPS, STEPS, STEPS)
    elif mode == "async":
        assert st.steps == st.pushes and st.partial_aggregations == 0
        assert st.fused_wire_rounds == (st.steps if fab._fused_wire else 0)
    else:
        assert st.late_pushes_dropped == 0 and st.steps >= STEPS


@pytest.mark.parametrize("codec", ["none", "int8"])
@pytest.mark.parametrize("mode", list(MODES))
def test_rebalance_mid_mode_matches_jax_bitwise(mode, codec):
    """Shards 1 and 2 of 4 drained between two stretches of each mode:
    the moved chunks (now a non-contiguous stripe on their new owners)
    keep their state, so every bit, the per-shard stats and the event
    clock still match the JAX fabric's."""
    ref, jgrad, jharness = jax_fabric(mode, codec, True, 4)
    fab, tgrad, tharness = torch_fabric(mode, codec, 4)
    for f, g, h in ((ref, jgrad, jharness), (fab, tgrad, tharness)):
        drive(mode, f, g, h)
        assert f.rebalance([1, 2]) > 0
        drive(mode, f, g, h)
    assert fab.shards[1].num_chunks == fab.shards[2].num_chunks == 0
    assert not isinstance(fab.shards[0].rows, slice)
    np.testing.assert_array_equal(ref.chunk_owner, fab.chunk_owner)
    assert fab.stats.rebalances == 1
    assert_same(ref, fab)
