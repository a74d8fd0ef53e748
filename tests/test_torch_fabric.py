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
from repro.core.config import FaultConfig as JaxFaults  # noqa: E402
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
from repro_torch.core.replication import FaultEvent, FaultPlan  # noqa: E402
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
    dict(namespace="job0"),
    dict(chunk_base=8),
    dict(namespace="job1", chunk_base=40),
    dict(chunk_base=-1),
])
def test_unported_knobs_raise(cfg):
    """The tenancy namespace, once refused, validates since the tenancy
    tier was ported: ``namespace`` / ``chunk_base`` validate as in the JAX
    package (``chunk_base=-1`` raises the named ``[chunk_base]`` error on
    both), a fabric under one maps its chunks into the box-wide namespace
    as the JAX fabric does (``global_chunk_ids``, the out-of-range refusal)
    and names it in ``describe()`` (the ``[namespace]`` prefix and the
    config's ``ns=<name>@<base>``), and trains bit for bit as JAX does."""
    from repro.core.config import FabricConfigError as JaxConfigError

    if cfg.get("chunk_base", 0) < 0:
        with pytest.raises(tconfig.FabricConfigError,
                           match=r"\[chunk_base\]") as ei:
            FabricConfig(num_workers=K, **cfg).validate()
        with pytest.raises(JaxConfigError) as ej:
            JaxConfig(num_workers=K, **cfg).validate()
        assert (ei.value.rule, str(ei.value)) == (ej.value.rule,
                                                  str(ej.value))
        return
    assert FabricConfig(num_workers=K, **cfg).validate().namespace == \
        cfg.get("namespace")
    ref, jgrad = _jax_fabric("adamw", 2, **cfg)
    fab, tgrad = _torch_fabric("adamw", 2, **cfg)
    for f, g in ((ref, jgrad), (fab, tgrad)):
        for _ in range(2):
            _push_round(f, g)
    np.testing.assert_array_equal(_bits(ref.params), _bits(fab.params.numpy()))
    assert dataclasses.asdict(ref.stats) == dataclasses.asdict(fab.stats)
    assert (fab.namespace, fab.chunk_base) == (ref.namespace, ref.chunk_base)
    np.testing.assert_array_equal(ref.global_chunk_ids(),
                                  fab.global_chunk_ids())
    np.testing.assert_array_equal(ref.global_chunk_ids([0, 3]),
                                  fab.global_chunk_ids([0, 3]))
    for bad in ([-1], [fab.space.num_chunks]):
        with pytest.raises(ValueError, match="out of range"):
            fab.global_chunk_ids(bad)
    jtop, ttop = ref.describe().splitlines()[0], fab.describe().splitlines()[0]
    ns = cfg.get("namespace")
    prefix = f"[{ns}] PBoxFabric: " if ns else "PBoxFabric: "
    assert jtop.startswith(prefix) and ttop.startswith(prefix)
    jcfg = ref.config.describe().splitlines()[0]
    tcfg = fab.config.describe().splitlines()[0]
    if ns:
        assert jcfg.endswith(f" ns={ns}@{cfg.get('chunk_base', 0)}")
        assert tcfg.endswith(f" ns={ns}@{cfg.get('chunk_base', 0)}")
    else:
        assert " ns=" not in jcfg and " ns=" not in tcfg


@pytest.mark.parametrize("knob", ["replication", "seeded_plan",
                                  "switch_then_shard_crash"])
def test_fault_knobs_match_jax(knob):
    """The fault tier's knobs, once refused, run against the JAX fabric:
    replication 2; a seeded plan of every non-switch kind; a switch event
    then a shard crash at R = 2.  Params, state, every stats field and the
    exported fault trace match."""
    from repro.core.replication import FaultEvent as JaxEvent
    from repro.core.replication import FaultPlan as JaxPlan

    if knob == "seeded_plan":
        events = [(e.round, e.kind, e.target, e.factor)
                  for e in FaultPlan.generate(
                      0, rounds=5, num_shards=2, num_workers=K,
                      shard_crash_rate=0.4, worker_crash_rate=0.4,
                      link_degrade_rate=0.4, recover_after=1).events]
    elif knob == "switch_then_shard_crash":
        events = [(1, "switch_fail", 0, 1.0), (2, "shard_crash", 0, 1.0)]
    else:
        events = []
    kinds = {e[1] for e in events}
    jplan = JaxPlan(JaxEvent(*e) for e in events) if events else None
    tplan = FaultPlan(FaultEvent(*e) for e in events) if events else None
    ref, jgrad = _jax_fabric("adamw", 2, min_push_fraction=0.5,
                             faults=JaxFaults(replication=2,
                                              fault_plan=jplan))
    fab, tgrad = _torch_fabric("adamw", 2, min_push_fraction=0.5,
                               faults=tconfig.FaultConfig(
                                   replication=2, fault_plan=tplan))
    for f, g in ((ref, jgrad), (fab, tgrad)):
        for _ in range(5):
            for w in range(K):
                if f.alive(w):  # a crash fires mid-loop at a round edge
                    f.push(w, g(f.pull(w), w))
    np.testing.assert_array_equal(_bits(ref.params), _bits(fab.params.numpy()))
    for js, ts in zip(ref.shards, fab.shards):
        for a, b in zip(js.state, ts.state):
            np.testing.assert_array_equal(_bits(a), _bits(b.numpy()))
    assert dataclasses.asdict(ref.stats) == dataclasses.asdict(fab.stats)
    assert ref.export_fault_trace() == fab.export_fault_trace()
    assert fab.stats.replication_rounds == fab.step >= 5
    assert {t["event"]["kind"] for t in fab.fault_trace} == kinds
    if knob == "seeded_plan":
        assert {"shard_crash", "worker_crash", "link_degrade"} <= kinds


def test_unported_topology_and_plan_raise():
    """A topology (duck-typed) and the switch tier validate since the rack
    tier was ported, and an explicit placement plan since the fault tier
    was: a fabric under one runs as the JAX fabric does."""
    from repro.core.placement import PlacementPlan as JaxPlacementPlan
    from repro_torch.core.placement import PlacementPlan

    topo = type("T", (), {"num_workers": K, "num_racks": 1})()
    FabricConfig(num_workers=K, wire=tconfig.WireConfig(
        topology=topo, switch=tconfig.SwitchConfig(
            enabled=True, tor_slots=4))).validate()
    owner = (np.arange(_torch_fabric("momentum", 1)[0].space.num_chunks)
             + 1) % 2
    plan = PlacementPlan(num_shards=2, chunk_owner=owner, origin="solved")
    jplan = JaxPlacementPlan(num_shards=2, chunk_owner=owner, origin="solved")
    ref, jgrad = _jax_fabric("momentum", 2,
                             placement=JaxPlacement(plan=jplan))
    fab, tgrad = _torch_fabric("momentum", 2,
                               placement=tconfig.PlacementConfig(plan=plan))
    assert fab.plan is plan
    np.testing.assert_array_equal(fab.chunk_owner, owner)
    for f, g in ((ref, jgrad), (fab, tgrad)):
        for _ in range(3):
            _push_round(f, g)
    np.testing.assert_array_equal(_bits(ref.params), _bits(fab.params.numpy()))
    assert dataclasses.asdict(ref.stats) == dataclasses.asdict(fab.stats)


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


# ---------------------------------------------------------------------------
# straggler modes, rebalancing and snapshots (the mode x codec x shard
# matrix against JAX is tests/test_torch_fabric_modes.py)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("codec", ["none", "bf16", "int8"])
@pytest.mark.parametrize("cfg", [
    dict(mode="async"),
    dict(mode="stale", staleness=2),
    dict(min_push_fraction=0.75),
    dict(mode="stale", staleness=1, min_push_fraction=0.5),
], ids=["async", "stale", "quorum", "stale-quorum"])
def test_straggler_knobs_validate_and_build(cfg, codec):
    params, _ = torch_quad_setup()
    space = ParamSpace.build(params, chunk_elems=CODEC_CHUNK)
    config = FabricConfig(num_workers=K, num_shards=2, **cfg,
                          wire=tconfig.WireConfig(
                              compression=CompressionConfig(codec=codec)))
    assert config.validate() is config
    fab = PBoxFabric(space, topt.adamw(3e-3), space.flatten(params),
                     config=config, device="cpu")
    assert fab.mode == cfg.get("mode", "sync")
    assert fab.staleness == {"async": 1 << 30, "stale": cfg.get("staleness"),
                             "sync": 0}[fab.mode]
    assert fab.min_pushes == int(np.ceil(cfg.get("min_push_fraction", 1.0)
                                         * K))


@pytest.mark.parametrize("frac,workers", [(0.5, 3), (0.34, 3), (0.75, 4),
                                          (0.1, 2), (1.0, 5)])
def test_min_pushes_is_jax_ceil(frac, workers):
    params, _ = torch_quad_setup()
    space = ParamSpace.build(params, chunk_elems=TILE_ELEMS)
    fab = PBoxFabric(space, topt.sgd(0.1), space.flatten(params),
                     config=FabricConfig(num_workers=workers,
                                         min_push_fraction=frac),
                     device="cpu")
    jparams, _, _ = quad_setup()
    jspace = JaxSpace.build(jparams, chunk_elems=JAX_TILE)
    ref = JaxFabric(jspace, jopt.sgd(0.1), jspace.flatten(jparams),
                    config=JaxConfig(num_workers=workers,
                                     min_push_fraction=frac))
    assert fab.min_pushes == ref.min_pushes
    assert fab.num_alive_workers == ref.num_alive_workers == workers


def _torch_grad(grad_fn, space, fab, w):
    return space.flatten(grad_fn(space.unflatten(fab.pull(w)), w))


def test_all_superseded_pushes_raise_like_jax():
    """A caller that never re-pulls after a quorum round pushes only
    superseded gradients: both fabrics drop them, then raise."""
    params, grad_fn = torch_quad_setup()
    space = ParamSpace.build(params, chunk_elems=TILE_ELEMS)
    fab = PBoxFabric(space, topt.sgd(0.1), space.flatten(params),
                     config=FabricConfig(num_workers=K, min_push_fraction=0.5),
                     device="cpu")
    jparams, _, jgrad = quad_setup()
    jspace = JaxSpace.build(jparams, chunk_elems=JAX_TILE)
    ref = JaxFabric(jspace, jopt.sgd(0.1), jspace.flatten(jparams),
                    config=JaxConfig(num_workers=K, min_push_fraction=0.5))
    tg = [_torch_grad(grad_fn, space, fab, w) for w in range(K)]
    jg = [jspace.flatten(jgrad(jspace.unflatten(ref.pull(w)), w))
          for w in range(K)]
    for w in range(K):  # the round fires on push 2; pushes 3 and 4 drop
        fab.push(w, tg[w])
        ref.push(w, jg[w])
    assert fab.stats.late_pushes_dropped == ref.stats.late_pushes_dropped == 2
    fab.push(0, tg[0])
    ref.push(0, jg[0])
    assert dataclasses.asdict(fab.stats) == dataclasses.asdict(ref.stats)
    with pytest.raises(RuntimeError, match="superseded"):
        ref.push(1, jg[1])
    with pytest.raises(RuntimeError, match="superseded"):
        fab.push(1, tg[1])


def _jax_fabric(spec_name, num_shards, **cfg):
    params, _, grad_fn = quad_setup()
    space = JaxSpace.build(params, chunk_elems=cfg.pop("chunk_elems", JAX_TILE))
    fab = JaxFabric(space, SPECS[spec_name](jopt), space.flatten(params),
                    config=JaxConfig(num_shards=num_shards, num_workers=K,
                                     **cfg))
    return fab, lambda p, w: space.flatten(grad_fn(space.unflatten(p), w))


def _torch_fabric(spec_name, num_shards, **cfg):
    params, grad_fn = torch_quad_setup()
    space = ParamSpace.build(params, chunk_elems=cfg.pop("chunk_elems",
                                                         TILE_ELEMS))
    fab = PBoxFabric(space, SPECS[spec_name](topt), space.flatten(params),
                     config=FabricConfig(num_shards=num_shards, num_workers=K,
                                         **cfg),
                     device="cpu")
    return fab, lambda p, w: space.flatten(grad_fn(space.unflatten(p), w))


def _push_round(fab, grad, workers=range(K)):
    for w in workers:
        fab.push(w, grad(fab.pull(w), w))


@pytest.mark.parametrize("placement", ["contiguous", "round_robin"])
@pytest.mark.parametrize("spec_name", ["momentum", "adamw"])
def test_rebalance_matches_jax_bitwise(spec_name, placement):
    """Rebalancing mid-training moves chunks with their state: numerics
    stay those of a 1-shard fabric, and ownership, per-shard stats and the
    event clock after the move match the JAX fabric's."""
    link = dict(wire_us_per_chunk=0.2, agg_us_per_chunk=1.0)
    ref, jgrad = _jax_fabric(spec_name, 4, wire=JaxWire(link=JaxLink(**link)),
                             placement=JaxPlacement(policy=placement))
    fab, tgrad = _torch_fabric(
        spec_name, 4, wire=tconfig.WireConfig(link=LinkModel(**link)),
        placement=tconfig.PlacementConfig(policy=placement))
    one, _ = _torch_fabric(spec_name, 1)
    for f, g in ((ref, jgrad), (fab, tgrad), (one, tgrad)):
        for _ in range(3):
            _push_round(f, g)
    assert fab.rebalance([0]) == ref.rebalance([0]) > 0
    assert fab.shards[0].num_chunks == 0 and fab.rebalance([0]) == 0
    counts = np.bincount(fab.chunk_owner, minlength=4)[1:]
    assert counts.max() - counts.min() <= 1
    for f, g in ((ref, jgrad), (fab, tgrad), (one, tgrad)):
        for _ in range(2):
            _push_round(f, g)
    np.testing.assert_array_equal(ref.chunk_owner, fab.chunk_owner)
    for js, ts in zip(ref.shards, fab.shards):
        np.testing.assert_array_equal(js.chunk_ids, ts.chunk_ids)
        for a, b in zip(js.state, ts.state):
            np.testing.assert_array_equal(_bits(a), _bits(b.numpy()))
        assert dataclasses.asdict(js.stats) == dataclasses.asdict(ts.stats)
    assert dataclasses.asdict(ref.stats) == dataclasses.asdict(fab.stats)
    assert fab.stats.rebalances == 1
    np.testing.assert_array_equal(_bits(ref.params), _bits(fab.params.numpy()))
    assert torch.equal(one.params, fab.params)


def test_apply_plan_delta_kinds():
    from repro.core.placement import PlanDelta as JaxDelta
    from repro_torch.core.placement import PlanDelta

    ref, jgrad = _jax_fabric("adamw", 4)
    fab, tgrad = _torch_fabric("adamw", 4)
    _push_round(ref, jgrad)
    _push_round(fab, tgrad)
    before = fab.params.clone()
    moves = ((0, 3), (1, 3), (8, 0))
    assert fab.apply_plan_delta(PlanDelta("chunk_moves", moves=moves)) == \
        ref.apply_plan_delta(JaxDelta("chunk_moves", moves=moves)) == 3
    assert fab.apply_plan_delta(PlanDelta("chunk_moves", moves=moves)) == 0
    np.testing.assert_array_equal(fab.chunk_owner, ref.chunk_owner)
    assert fab.shards[3].chunk_ids.tolist() == [0, 1, 7]
    assert isinstance(fab.shards[3].rows, torch.Tensor)  # no longer a run
    assert torch.equal(fab.params, before)
    # chain re-homing needs chains (R = 1 here); a reshard runs as in JAX
    with pytest.raises(ValueError, match="replication < 2"):
        fab.apply_plan_delta(PlanDelta("replica_racks", shard=0, racks=(0,)))
    assert fab.apply_plan_delta(PlanDelta("shard_count", new_shards=2)) == \
        ref.apply_plan_delta(JaxDelta("shard_count", new_shards=2))
    assert fab.num_shards == 2
    np.testing.assert_array_equal(fab.chunk_owner, ref.chunk_owner)
    for foreign in (PlanDelta("frontend_move", frontend=0, rack=0),
                    PlanDelta("tenant_shares", shares=(("a", 1.0),))):
        with pytest.raises(ValueError, match="not fabric-applied"):
            fab.apply_plan_delta(foreign)
    with pytest.raises(ValueError, match="unknown delta kind"):
        PlanDelta("bogus")
    with pytest.raises(ValueError, match="no chunk"):
        fab.apply_plan_delta(PlanDelta("chunk_moves", moves=((99, 0),)))
    with pytest.raises(ValueError, match="no shard"):
        fab.apply_plan_delta(PlanDelta("chunk_moves", moves=((0, 4),)))
    _push_round(ref, jgrad)
    _push_round(fab, tgrad)
    assert dataclasses.asdict(ref.stats) == dataclasses.asdict(fab.stats)
    np.testing.assert_array_equal(_bits(ref.params), _bits(fab.params.numpy()))


def test_release_and_adopt_copy_rows():
    """Released rows are copies: writing them, or the shard afterwards,
    changes neither the other nor the shard's remaining rows."""
    fab, tgrad = _torch_fabric("adamw", 2)
    _push_round(fab, tgrad)
    shard, other = fab.shards
    kept = shard.params[1:].clone()
    p_rows, s_rows = shard.release(np.array([0]))
    p_copy = p_rows.clone()
    p_rows.add_(1.0)
    shard.params.add_(2.0)
    assert torch.equal(shard.params, kept + 2.0)
    other.adopt(np.array([0]), p_copy, s_rows)
    assert other.chunk_ids[0] == 0 and torch.equal(other.params[0], p_copy[0])
    p_copy.add_(3.0)
    assert not torch.equal(other.params[0], p_copy[0])
    with pytest.raises(ValueError, match="does not own"):
        shard.release(np.array([0]))


def _snapshot_copy(snap):
    return {k: (tuple(np.array(a) for a in v) if k == "state" else
                np.array(v)) for k, v in snap.items()}


def _assert_snap_equal(a, b):
    assert sorted(a) == sorted(b)
    np.testing.assert_array_equal(_bits(a["params"]), _bits(b["params"]))
    for x, y in zip(a["state"], b["state"], strict=True):
        np.testing.assert_array_equal(_bits(x), _bits(y))
    for key in ("step", "worker_clock", "dead_workers", "replication"):
        np.testing.assert_array_equal(a[key], b[key])


@pytest.mark.parametrize("mid_round", [False, True], ids=["edge", "mid"])
@pytest.mark.parametrize("src,dst", [(1, 8), (8, 1), (2, 3)])
def test_snapshot_restore_across_shard_counts(src, dst, mid_round):
    """A snapshot of an N-shard fabric restores into an M-shard one and
    training continues bitwise; taken mid-round (two pushes admitted), the
    restored run replays the in-flight pushes."""
    fab, grad = _torch_fabric("adamw", src)
    for _ in range(3):
        _push_round(fab, grad)
    if mid_round:
        _push_round(fab, grad, workers=(0, 1))
    snap = fab.snapshot()
    kept = _snapshot_copy(snap)
    np.testing.assert_array_equal(snap["worker_clock"], [3] * K)
    if mid_round:
        np.testing.assert_array_equal(fab.worker_clock, [4, 4, 3, 3])
    _push_round(fab, grad, workers=(2, 3) if mid_round else range(K))
    _push_round(fab, grad)
    twin, tgrad = _torch_fabric("adamw", dst)
    twin.restore(snap)
    assert twin.step == 3 and not twin._inbox
    for _ in range(2):
        _push_round(twin, tgrad)
    assert torch.equal(fab.params, twin.params)
    for k in range(2):
        assert torch.equal(fab._assemble_rows(lambda s: s.state[k]),
                           twin._assemble_rows(lambda s: s.state[k]))
    # neither the later rounds nor the restore wrote into the snapshot,
    # and restoring it again gives its bits back
    _assert_snap_equal(snap, kept)
    twin.restore(snap)
    _assert_snap_equal(twin.snapshot(), kept)


@pytest.mark.parametrize("mid_round", [False, True], ids=["edge", "mid"])
@pytest.mark.parametrize("codec", ["none", "int8"])
@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
def test_snapshot_crosses_packages(direction, codec, mid_round):
    """A JAX snapshot restores into the port and a port snapshot into JAX;
    the restored fabric then runs bitwise equal to its source (the
    error-feedback residuals restart at zero on both sides)."""
    chunk = CODEC_CHUNK if codec != "none" else None
    cfg = {} if chunk is None else {"chunk_elems": chunk}
    ref, jgrad = _jax_fabric("adamw", 2, **cfg, wire=JaxWire(
        compression=JaxCompression(codec=codec)))
    fab, tgrad = _torch_fabric("adamw", 3, **cfg, wire=tconfig.WireConfig(
        compression=CompressionConfig(codec=codec)))
    src, sgrad, dst, dgrad = ((ref, jgrad, fab, tgrad)
                              if direction == "jax-to-port"
                              else (fab, tgrad, ref, jgrad))
    for _ in range(2):
        _push_round(src, sgrad)
    if mid_round:
        _push_round(src, sgrad, workers=(0, 2))
    snap = src.snapshot()
    src.restore(snap)  # both sides resume from the same restored state
    dst.restore(snap)
    for f, g in ((src, sgrad), (dst, dgrad)):
        for _ in range(2):
            _push_round(f, g)
    np.testing.assert_array_equal(_bits(ref.params), _bits(fab.params.numpy()))
    for k in range(2):
        np.testing.assert_array_equal(
            _bits(ref._assemble_rows(lambda s: s.state[k])),
            _bits(fab._assemble_rows(lambda s: s.state[k]).numpy()))
    for w, ef in ref._worker_ef.items():
        np.testing.assert_array_equal(_bits(ef),
                                      _bits(fab._worker_ef[w].numpy()))
    assert ref.step == fab.step == 4
    np.testing.assert_array_equal(ref.worker_clock, fab.worker_clock)


def test_restore_reads_dead_workers_and_legacy_snapshots():
    """A JAX snapshot with a crashed worker restores it as dead (it neither
    proceeds nor counts toward the quorum); a legacy snapshot without
    clocks or fault metadata restores an all-alive fabric at its step."""
    ref, jgrad = _jax_fabric("momentum", 2,
                             faults=JaxFaults(replication=2))
    _push_round(ref, jgrad)
    ref.crash_worker(3)
    snap = ref.snapshot()
    fab, tgrad = _torch_fabric("momentum", 2, min_push_fraction=0.5)
    fab.restore(snap)
    assert fab.dead_workers == {3} and not fab.alive(3)
    assert not fab.can_proceed(3) and fab.can_proceed(0)
    assert fab.num_alive_workers == 3 and fab.min_pushes == 2
    with pytest.raises(RuntimeError, match="worker 3 crashed"):
        fab.push(3, torch.zeros(fab.space.flat_elems))
    legacy = {k: snap[k] for k in ("params", "state", "step")}
    fab.restore(legacy)
    assert not fab.dead_workers
    np.testing.assert_array_equal(fab.worker_clock, [1] * K)
    np.testing.assert_array_equal(_bits(ref.params), _bits(fab.params.numpy()))


def test_restore_onto_another_worker_count_resets_clocks():
    """A snapshot restored onto a fabric with another worker count resets
    every clock to the restored step, as in JAX."""
    fab, grad = _torch_fabric("adamw", 2)
    for _ in range(2):
        _push_round(fab, grad)
    snap = fab.snapshot()
    params, _ = torch_quad_setup()
    space = ParamSpace.build(params, chunk_elems=TILE_ELEMS)
    small = PBoxFabric(space, topt.adamw(3e-3), space.flatten(params),
                       config=FabricConfig(num_shards=3, num_workers=2),
                       device="cpu")
    small.restore(snap)
    np.testing.assert_array_equal(small.worker_clock, [2, 2])
    np.testing.assert_array_equal(small._pull_step, [2, 2])
    assert torch.equal(small.params, fab.params)


def test_restore_tells_attached_sparse_tiers():
    """A fabric-attached SparseTier hears of a restore (``on_restore``),
    and a collected tier's weakref is pruned."""
    from repro_torch.core.sparse import SparseTier

    fab, grad = _torch_fabric("sgd", 2)
    _push_round(fab, grad)
    tier = SparseTier(fabric=fab, lr=0.1)
    gone = SparseTier(fabric=fab, lr=0.1)
    calls = []
    tier.on_restore = lambda: calls.append("restored")
    del gone
    assert len(fab.sparse_tiers) == 2
    fab.restore(fab.snapshot())
    assert calls == ["restored"] and len(fab.sparse_tiers) == 1


def test_harness_runs_past_a_dead_worker():
    """``WorkerHarness.run`` counts only alive workers: a worker restored
    as dead neither blocks the others nor the run."""
    ref, jgrad = _jax_fabric("momentum", 2, faults=JaxFaults(replication=2))
    _push_round(ref, jgrad)
    ref.crash_worker(1)
    params, grad_fn = torch_quad_setup()
    space = ParamSpace.build(params, chunk_elems=TILE_ELEMS)
    fab = PBoxFabric(space, topt.momentum(0.05, 0.9), space.flatten(params),
                     config=FabricConfig(num_shards=2, num_workers=K),
                     device="cpu")
    fab.restore(ref.snapshot())
    h = WorkerHarness(fab, grad_fn, lambda w, s: w)
    h.run(2)
    assert h.steps_done[1] == 0 and min(h.steps_done[w] for w in (0, 2, 3)) == 2
    assert fab.step == 3  # each round waited for the 3 alive workers only
    jh = JaxHarness(ref, quad_setup()[2], lambda w, s: w)
    jh.run(2)
    np.testing.assert_array_equal(_bits(ref.params), _bits(fab.params.numpy()))


def test_ssp_double_push_replaces_inbox_entry_like_jax():
    """In stale mode a worker that pushes twice before the barrier replaces
    its own earlier push (the JAX fabric's ``_inbox[worker] = ...``): the
    round averages its second gradient with the others'."""
    ref, jgrad = _jax_fabric("sgd", 1, mode="stale", staleness=1)
    fab, tgrad = _torch_fabric("sgd", 1, mode="stale", staleness=1)
    for f, g in ((ref, jgrad), (fab, tgrad)):
        f.push(0, g(f.pull(0), 0))
        f.push(0, g(f.pull(0), 1))  # the clock runs one ahead: admitted
        assert len(f._inbox) == 1 and f.stats.steps == 0
        _push_round(f, g, workers=(1, 2, 3))
        assert f.stats.steps == 1 and f.stats.pushes == 5
    np.testing.assert_array_equal(_bits(ref.params), _bits(fab.params.numpy()))
    np.testing.assert_array_equal(fab.worker_clock, [2, 1, 1, 1])
