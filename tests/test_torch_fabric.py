"""The PyTorch fabric against the JAX fabric, synchronous slice.

``quad_setup`` (tests/test_fabric.py) drives both fabrics from the same
numpy inputs, the port on the CPU.  With the same scalar packet the port's
CPU kernel path (the plain version of the CUDA kernel) equals the JAX
Pallas kernel in interpret mode bit for bit, and torch's and XLA's f32
``pow`` agree on these steps, so the parameters and every ``ServerStats``
field must match exactly — momentum and AdamW alike.  Inside the port,
1, 2 and 8 shards and chunk-staged pushes are bit-identical, as in the JAX
package.

With a wire codec (bf16, int8 with error feedback) both fabrics run the
codec on each worker's push; the fused wire path ships the push encoded to
the shards' single-pass kernel, the unfused path decodes at the hop.  The
port routes on ``wire_path_supported`` alone (the JAX ``fused_wire_path``
switch has no counterpart), so its fused fabric is held against the JAX
fabric with the switch on and off.  Params, state, the error-feedback
residuals and every ``ServerStats`` field match bitwise either way, and
the port's unfused route (an unsupported geometry) equals its fused one
(tests/test_wire_path.py:188-260 for the JAX package)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from test_fabric import K, quad_setup  # noqa: E402

from repro.core.chunking import TILE_ELEMS as JAX_TILE  # noqa: E402
from repro.core.chunking import ParamSpace as JaxSpace  # noqa: E402
from repro.core.compression import CompressionConfig as JaxCompression  # noqa: E402
from repro.core.config import FabricConfig as JaxConfig  # noqa: E402
from repro.core.config import PlacementConfig as JaxPlacement  # noqa: E402
from repro.core.config import WireConfig as JaxWire  # noqa: E402
from repro.core.fabric import LinkModel as JaxLink  # noqa: E402
from repro.core.fabric import PBoxFabric as JaxFabric  # noqa: E402
from repro.core.fabric import WorkerHarness as JaxHarness  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro_torch.core import config as tconfig  # noqa: E402
from repro_torch.core.chunking import TILE_ELEMS, ParamSpace  # noqa: E402
from repro_torch.core.compression import CompressionConfig  # noqa: E402
from repro_torch.core.config import FabricConfig  # noqa: E402
from repro_torch.core.fabric import LinkModel, PBoxFabric, WorkerHarness  # noqa: E402
from repro_torch.core.server import PHubServer  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402

SPECS = {
    "momentum": lambda o: o.momentum(0.05, 0.9),
    "adamw": lambda o: o.adamw(3e-3),
    "sgd": lambda o: o.sgd(0.01, weight_decay=0.01),
}


def torch_quad_setup():
    """The port's twin of ``quad_setup``: same params, targets and f32
    gradient arithmetic, as torch tensors on the CPU."""
    params = {"w": torch.zeros(9000), "b": torch.zeros(77)}
    targets = [
        {"w": torch.full((9000,), float(i + 1)),
         "b": torch.arange(77.0) * (i + 1)}
        for i in range(K)
    ]

    def grad_fn(p, batch):
        t = targets[batch]
        return {k: 2 * (p[k] - t[k]) for k in p}

    return params, grad_fn


def run_torch(spec_name, *, num_shards, steps=5, chunk_groups=1,
              chunk_elems=TILE_ELEMS, **cfg):
    params, grad_fn = torch_quad_setup()
    space = ParamSpace.build(params, chunk_elems=chunk_elems)
    fab = PBoxFabric(space, SPECS[spec_name](topt), space.flatten(params),
                     config=FabricConfig(num_shards=num_shards,
                                         num_workers=K, **cfg),
                     device="cpu")
    WorkerHarness(fab, grad_fn, lambda w, s: w,
                  chunk_groups=chunk_groups).run(steps)
    return fab


def run_jax(spec_name, *, num_shards, steps=5, chunk_elems=JAX_TILE, **cfg):
    params, _, grad_fn = quad_setup()
    space = JaxSpace.build(params, chunk_elems=chunk_elems)
    fab = JaxFabric(space, SPECS[spec_name](jopt), space.flatten(params),
                    config=JaxConfig(num_shards=num_shards, num_workers=K,
                                     **cfg))
    JaxHarness(fab, grad_fn, lambda w, s: w).run(steps)
    return fab


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


@pytest.mark.parametrize("num_shards", [1, 2, 8])
@pytest.mark.parametrize("spec_name", ["momentum", "adamw"])
def test_fabric_matches_jax_bitwise(spec_name, num_shards):
    ref = run_jax(spec_name, num_shards=num_shards)
    fab = run_torch(spec_name, num_shards=num_shards)
    np.testing.assert_array_equal(_bits(ref.params), _bits(fab.params.numpy()))
    for js, ts in zip(ref.shards, fab.shards):
        np.testing.assert_array_equal(js.chunk_ids, ts.chunk_ids)
        for a, b in zip(js.state, ts.state):
            np.testing.assert_array_equal(_bits(a), _bits(b.numpy()))
        assert dataclasses.asdict(js.stats) == dataclasses.asdict(ts.stats)
    # every counter and event-clock field, bit for bit
    assert dataclasses.asdict(ref.stats) == dataclasses.asdict(fab.stats)
    assert ref.stats.pipeline_speedup == fab.stats.pipeline_speedup
    assert ref.step == fab.step == 5
    np.testing.assert_array_equal(ref.chunk_owner, fab.chunk_owner)


def test_round_robin_event_clock_matches_jax():
    link = dict(wire_us_per_chunk=0.2, agg_us_per_chunk=1.0)
    for n in (1, 2, 8):
        ref = run_jax("momentum", num_shards=n, steps=2,
                      wire=JaxWire(link=JaxLink(**link)),
                      placement=JaxPlacement(policy="round_robin"))
        fab = run_torch("momentum", num_shards=n, steps=2,
                        wire=tconfig.WireConfig(link=LinkModel(**link)),
                        placement=tconfig.PlacementConfig(policy="round_robin"))
        assert dataclasses.asdict(ref.stats) == dataclasses.asdict(fab.stats)
        np.testing.assert_array_equal(_bits(ref.params),
                                      _bits(fab.params.numpy()))
        assert fab.stats.sim_pipelined_us < fab.stats.sim_serialized_us


@pytest.mark.parametrize("spec_name", ["momentum", "adamw", "sgd"])
def test_shard_counts_bit_identical(spec_name):
    """Port-internal: sharding the chunk space changes no bit
    (tests/test_fabric.py:54 for the JAX package)."""
    one = run_torch(spec_name, num_shards=1)
    for n in (2, 8):
        fab = run_torch(spec_name, num_shards=n)
        assert torch.equal(one.params, fab.params)


def test_push_chunks_equals_push():
    ref = run_torch("momentum", num_shards=2)
    fab = run_torch("momentum", num_shards=2, chunk_groups=4)
    assert torch.equal(ref.params, fab.params)
    assert fab.stats.pushes == ref.stats.pushes


def test_per_shard_byte_accounting_splits_evenly():
    fab = run_torch("momentum", num_shards=3, steps=4)
    n = 3
    total_push = sum(s.stats.bytes_pushed for s in fab.shards)
    total_pull = sum(s.stats.bytes_pulled for s in fab.shards)
    assert total_push == fab.stats.bytes_pushed
    assert total_pull == fab.stats.bytes_pulled
    for shard in fab.shards:
        assert shard.stats.bytes_pushed == total_push // n
        assert shard.stats.agg_events == 4
    assert fab.stats.chunk_pushes == fab.stats.pushes * fab.space.num_chunks


def test_phub_server_is_one_shard_fabric():
    params, grad_fn = torch_quad_setup()
    space = ParamSpace.build(params, chunk_elems=TILE_ELEMS)
    srv = PHubServer(space, topt.momentum(0.05, 0.9), space.flatten(params),
                     num_workers=K, device="cpu")
    WorkerHarness(srv, grad_fn, lambda w, s: w).run(5)
    assert srv.num_shards == 1
    assert torch.equal(srv.params, run_torch("momentum", num_shards=1).params)


def test_fabric_does_not_write_init_flat():
    """The kernel updates shard state in place; the caller's initial flat
    must stay untouched."""
    params, grad_fn = torch_quad_setup()
    space = ParamSpace.build(params, chunk_elems=TILE_ELEMS)
    init = space.flatten(params)
    before = init.clone()
    fab = PBoxFabric(space, topt.adamw(3e-3), init,
                     config=FabricConfig(num_shards=2, num_workers=K),
                     device="cpu")
    WorkerHarness(fab, grad_fn, lambda w, s: w).run(2)
    assert torch.equal(init, before)
    assert not torch.equal(fab.params, before)


@pytest.mark.parametrize("cfg", [
    dict(mode="async"),
    dict(mode="stale", staleness=2),
    dict(min_push_fraction=0.75),
    dict(faults=tconfig.FaultConfig(replication=2)),
    dict(faults=tconfig.FaultConfig(fault_plan=object())),
    dict(mode="async", wire=tconfig.WireConfig(
        compression=CompressionConfig(codec="int8"))),
    dict(wire=tconfig.WireConfig(switch=tconfig.SwitchConfig(
        enabled=True, tor_slots=4))),
    dict(namespace="job0"),
])
def test_unported_knobs_raise(cfg):
    with pytest.raises(NotImplementedError):
        FabricConfig(num_workers=K, **cfg).validate()


def test_unported_topology_and_plan_raise():
    topo = type("T", (), {"num_workers": K, "num_racks": 1})()
    with pytest.raises(NotImplementedError):
        FabricConfig(num_workers=K,
                     wire=tconfig.WireConfig(topology=topo)).validate()
    plan = type("P", (), {"num_shards": 1, "num_racks": 1,
                          "replica_racks": np.zeros((1, 1))})()
    with pytest.raises(NotImplementedError):
        FabricConfig(placement=tconfig.PlacementConfig(plan=plan)).validate()


@pytest.mark.parametrize("cfg,rule", [
    (dict(mode="bogus"), "mode"),
    (dict(num_shards=0), "num_shards"),
    (dict(num_workers=0), "num_workers"),
    (dict(min_push_fraction=0.0), "min_push_fraction"),
    (dict(placement=tconfig.PlacementConfig(policy="random")),
     "placement_policy"),
])
def test_config_rules_match_jax(cfg, rule):
    """The port keeps every validation rule, by name, before the
    not-ported checks."""
    from repro.core.config import FabricConfigError as JaxConfigError

    jcfg = {k: (JaxPlacement(policy=v.policy)
                if isinstance(v, tconfig.PlacementConfig) else v)
            for k, v in cfg.items()}
    with pytest.raises(JaxConfigError) as je:
        JaxConfig(**jcfg).validate()
    with pytest.raises(tconfig.FabricConfigError) as te:
        FabricConfig(**cfg).validate()
    assert je.value.rule == te.value.rule == rule


def test_no_device_and_no_card_raises(monkeypatch):
    params, _ = torch_quad_setup()
    space = ParamSpace.build(params, chunk_elems=TILE_ELEMS)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PBoxFabric(space, topt.sgd(0.1), space.flatten(params),
                   config=FabricConfig())


def _assert_fabrics_equal(ref, fab, *, skip=()):
    np.testing.assert_array_equal(_bits(ref.params), _bits(fab.params.numpy()))
    for js, ts in zip(ref.shards, fab.shards):
        for a, b in zip(js.state, ts.state):
            np.testing.assert_array_equal(_bits(a), _bits(b.numpy()))
        assert dataclasses.asdict(js.stats) == dataclasses.asdict(ts.stats)
    assert sorted(ref._worker_ef) == sorted(fab._worker_ef)
    for w, ef in ref._worker_ef.items():
        np.testing.assert_array_equal(_bits(ef), _bits(fab._worker_ef[w].numpy()))
    # every counter and event-clock field, bit for bit
    want, got = dataclasses.asdict(ref.stats), dataclasses.asdict(fab.stats)
    for name in skip:
        want.pop(name), got.pop(name)
    assert want == got


CODEC_CHUNK = 8192  # whole int8 (4096) and bf16 (2048) granules


@pytest.mark.parametrize("num_shards", [1, 2])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("codec", ["bf16", "int8"])
def test_codec_fabric_matches_jax_bitwise(codec, fused, num_shards):
    """The port's fused route against the JAX fabric's fused and unfused
    routes: the same bits and accounting, apart from the JAX unfused run's
    ``fused_wire_rounds`` of 0."""
    ref = run_jax("adamw", num_shards=num_shards, chunk_elems=CODEC_CHUNK,
                  wire=JaxWire(compression=JaxCompression(codec=codec),
                               fused_wire_path=fused))
    fab = run_torch("adamw", num_shards=num_shards, chunk_elems=CODEC_CHUNK,
                    wire=tconfig.WireConfig(
                        compression=CompressionConfig(codec=codec)))
    assert fab._fused_wire and ref._fused_wire == fused
    _assert_fabrics_equal(ref, fab,
                          skip=() if fused else ("fused_wire_rounds",))
    assert fab.stats.fused_wire_rounds == 5
    assert ref.stats.fused_wire_rounds == (5 if fused else 0)
    # int8 pushes 1 byte an element plus a 4-byte scale a chunk; pulls f32
    flat = fab.space.flat_elems
    per_push = flat + 4 * (flat // CODEC_CHUNK) if codec == "int8" else 2 * flat
    assert fab.stats.bytes_pushed == fab.stats.pushes * per_push
    assert fab.stats.bytes_pulled == fab.stats.pulls * 4 * flat


@pytest.mark.parametrize("codec", ["bf16", "int8"])
@pytest.mark.parametrize("spec_name", ["momentum", "adamw", "sgd"])
def test_codec_fused_equals_unfused(spec_name, codec, monkeypatch):
    """Port-internal: shipping the push encoded changes no bit, and the
    wire accounting does not depend on the form shipped.  The unfused run
    is the route the fabric takes for a geometry the fused kernel does not
    support, reached here by declaring this one unsupported."""
    from repro_torch.core import fabric as tfabric

    def run():
        return run_torch(
            spec_name, num_shards=2, chunk_elems=CODEC_CHUNK,
            wire=tconfig.WireConfig(compression=CompressionConfig(codec=codec)))

    ff = run()
    monkeypatch.setattr(tfabric, "wire_path_supported", lambda *a: False)
    fu = run()
    assert ff._fused_wire and not fu._fused_wire
    assert torch.equal(ff.params, fu.params)
    assert ff.stats.fused_wire_rounds == 5 and fu.stats.fused_wire_rounds == 0
    assert ff.stats.bytes_pushed == fu.stats.bytes_pushed
    assert ff.stats.bytes_core_link == fu.stats.bytes_core_link
    assert ff.stats.sim_pipelined_us == fu.stats.sim_pipelined_us


def test_codec_none_falls_back():
    """Raw f32 has no decode stage to fuse: an explicit codec "none" takes
    the f32 path with no error feedback, as no codec does."""
    ff = run_torch("momentum", num_shards=2, chunk_elems=CODEC_CHUNK,
                   wire=tconfig.WireConfig(
                       compression=CompressionConfig(codec="none")))
    fu = run_torch("momentum", num_shards=2, chunk_elems=CODEC_CHUNK)
    assert not ff._fused_wire and not ff._worker_ef
    assert torch.equal(ff.params, fu.params)
    assert ff.stats.fused_wire_rounds == fu.stats.fused_wire_rounds == 0


def test_unsupported_chunk_falls_back_like_jax():
    """A chunk that is not whole int8 granules takes the unfused route, in
    both packages (the JAX one with its fused_wire_path switch on)."""
    ref = run_jax("sgd", num_shards=1, steps=2, chunk_elems=2048,
                  wire=JaxWire(compression=JaxCompression(codec="int8")))
    fab = run_torch("sgd", num_shards=1, steps=2, chunk_elems=2048,
                    wire=tconfig.WireConfig(
                        compression=CompressionConfig(codec="int8")))
    assert not fab._fused_wire and not ref._fused_wire
    assert fab.stats.fused_wire_rounds == 0 and fab.step == 2
    _assert_fabrics_equal(ref, fab)


def test_codec_event_clock_scales_with_wire_bytes():
    link = dict(wire_us_per_chunk=1.0, agg_us_per_chunk=0.25)
    runs = {codec: run_torch(
        "momentum", num_shards=2, steps=1, chunk_elems=CODEC_CHUNK,
        wire=tconfig.WireConfig(link=LinkModel(**link),
                                compression=CompressionConfig(codec=codec)))
        for codec in ("none", "bf16", "int8")}
    chunks = runs["none"].space.num_chunks
    assert runs["none"].stats.sim_wire_us == chunks * 1.0
    assert runs["bf16"].stats.sim_wire_us == chunks * 0.5
    assert runs["int8"].stats.sim_wire_us == chunks * (
        (CODEC_CHUNK + 4) / (4.0 * CODEC_CHUNK))


def test_describe_names_the_config():
    fab = run_torch("momentum", num_shards=2, steps=1)
    text = fab.describe()
    assert "PBoxFabric: 2 shards" in text
    assert f"FabricConfig: shards=2 mode=sync workers={K}" in text
    assert "device=cpu" in text
    assert "codec=none" in text
    fab = run_torch("momentum", num_shards=1, steps=1, chunk_elems=CODEC_CHUNK,
                    wire=tconfig.WireConfig(
                        compression=CompressionConfig(codec="int8")))
    assert "workers=4, codec=int8, fused_wire=on" in fab.describe()
    assert "wire: codec=int8 (no topology)" in fab.describe()
