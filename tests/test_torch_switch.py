"""The PyTorch switch tier against the JAX one, bitwise.

Mirrors tests/test_switch.py: the ToR and core aggregation pools
(``core/topology.SwitchCompute`` and the fabric's switch path), their
``FaultPlan``-driven failures and restores, and the integer math
(``group_scale``, ``integer_quantize``, the int32 slot sum).  The fabrics
are ``tests/test_torch_topology.py``'s pair; every case compares params,
optimizer state, every stats field (``ServerStats``, ``ShardStats``,
``RackStats``, ``SwitchStats``, the ``sim_*`` clock floats), the
error-feedback residuals and ``fault_trace`` exactly.  The tenancy
cases (a ``MultiJobFabric``'s switch-register grants: a granted tenant
against its identically granted dedicated twin, the full-slab-or-nothing
budget returned at detach, the ineligible jobs) run each box on both
packages and compare them with ``tests/test_torch_tenancy.assert_box_same``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import test_torch_tenancy as tenancy  # noqa: E402
from test_torch_topology import (  # noqa: E402
    K,
    MODES,
    assert_same,
    drive,
    jax_fabric,
    run_pair,
    torch_fabric,
)

from repro.core import topology as jtopo  # noqa: E402
from repro.core.replication import FaultEvent as JaxEvent  # noqa: E402
from repro.core.replication import FaultPlan as JaxPlan  # noqa: E402
from repro_torch.core import config as tconfig  # noqa: E402
from repro_torch.core.chunking import ParamSpace  # noqa: E402
from repro_torch.core.compression import CompressionConfig, wire_bytes  # noqa: E402
from repro_torch.core.config import (  # noqa: E402
    FabricConfig,
    FaultConfig,
    SwitchConfig,
    WireConfig,
)
from repro_torch.core.replication import (  # noqa: E402
    FAULT_KINDS,
    FaultEvent,
    FaultPlan,
)
from repro_torch.core.topology import (  # noqa: E402
    NetworkTopology,
    RackAggregator,
    SwitchCompute,
    group_scale,
    integer_quantize,
)

VARIANTS = ["on", "starved", "tor_fail", "core_fail"]


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


# ---------------------------------------------------------------------------
# the whole matrix against the JAX fabric
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("racks", [1, 2, 4])
@pytest.mark.parametrize("codec", ["none", "bf16", "int8"])
@pytest.mark.parametrize("mode", list(MODES))
def test_switch_matrix_matches_jax_bitwise(mode, codec, racks, variant):
    """codec x racks x mode x switch (on, starved, a ToR pool or the core
    pool failed at round 2 and restored at round 3)."""
    ref, fab = run_pair(mode, codec, racks, switch=variant)
    assert_same(ref, fab)
    st = fab.stats
    if codec != "int8" or mode == "async" or variant == "starved":
        # the pools never engage: integer math over the int8 wire, in
        # rounds, on slabs that fit
        assert st.switch_rounds == st.core_switch_rounds == 0
        assert st.bytes_switch_agg == 0
    if variant.endswith("fail"):
        assert [r["event"]["kind"] for r in fab.fault_trace] == \
            ["switch_fail", "switch_restore"]


# ---------------------------------------------------------------------------
# pool admission: full-slab-or-nothing, inside the port
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("racks", [2, 4])
@pytest.mark.parametrize("shards", [1, 2])
def test_starved_pool_is_bit_identical_to_no_switch(racks, shards):
    fab, g, h = torch_fabric("sync", "int8", racks, switch="starved",
                             num_shards=shards, spec="momentum")
    drive("sync", fab, g, h, 3)
    base, g, h = torch_fabric("sync", "int8", racks, num_shards=shards,
                              spec="momentum")
    drive("sync", base, g, h, 3)
    assert fab.stats.switch_rounds == fab.stats.core_switch_rounds == 0
    assert fab.stats.bytes_switch_agg == 0
    assert torch.equal(fab.params.view(torch.int32),
                       base.params.view(torch.int32))


@pytest.mark.parametrize("codec", ["none", "bf16"])
def test_non_int8_codecs_never_engage(codec):
    fab, g, h = torch_fabric("sync", codec, 2, switch="on")
    drive("sync", fab, g, h, 3)
    base, g, h = torch_fabric("sync", codec, 2)
    drive("sync", base, g, h, 3)
    assert fab.stats.switch_rounds == fab.stats.core_switch_rounds == 0
    assert torch.equal(fab.params, base.params)


def test_tor_offload_engages_and_stays_ef_bounded():
    """The shared group scale is another quantizer than the per-worker
    software path: not bit-identical, but error feedback keeps the
    divergence at quantization-noise scale."""
    fab = _run(2, None, core_slots=0)
    base = _run(2, None, switch=False)
    s = fab.stats
    assert s.switch_rounds == 3 and s.core_switch_rounds == 0
    assert s.switch_fallback_rounds == 0 and s.bytes_switch_agg > 0
    a, b = fab.params.numpy(), base.params.numpy()
    rel = np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12)
    assert 0 < rel < 0.05


# ---------------------------------------------------------------------------
# FaultPlan-driven failure and restore
# ---------------------------------------------------------------------------
def _plan(*events):
    return FaultPlan(FaultEvent(*e) for e in events)


def _run(racks, plan, rounds=3, switch=True, core_slots=None):
    """An int8 sync fabric over ``racks`` racks with pools holding every
    chunk (the core pool ``core_slots``), driven ``rounds`` rounds."""
    fab, grad_fn, _ = torch_fabric("sync", "int8", racks)
    c = fab.space.num_chunks
    sw = SwitchConfig(enabled=True, tor_slots=c,
                      core_slots=c if core_slots is None else core_slots)
    config = dataclasses.replace(
        fab.config,
        wire=dataclasses.replace(fab.config.wire,
                                 switch=sw if switch else SwitchConfig()),
        faults=FaultConfig(fault_plan=plan))
    fab = type(fab)(fab.space, fab.spec, torch.zeros(fab.space.flat_elems),
                    config=config, device="cpu")
    for _ in range(rounds):
        for w in range(K):
            p = fab.space.unflatten(fab.pull(w))
            fab.push(w, fab.space.flatten(grad_fn(p, w)))
    return fab


def test_switch_failure_falls_back_bit_identically():
    plan = _plan((1, "switch_fail", 0), (1, "switch_fail", 1))
    fab = _run(2, plan, core_slots=0)
    base = _run(2, plan, switch=False)
    # round 1's pushes were parked when the fault fired: one fallback
    # round, then later pushes bypass the dead pools at push time
    assert fab.stats.switch_rounds == 0
    assert fab.stats.switch_fallback_rounds == 1
    assert fab.stats.switch_failures == 2
    assert torch.equal(fab.params, base.params)
    actions = [r["action"] for r in fab.fault_trace]
    assert actions == ["switch_failed:tor0", "switch_failed:tor1"]
    assert all(r["action"] == "ignored_no_switch_tier"
               for r in base.fault_trace)


def test_partial_failure_mixes_offload_and_fallback():
    fab = _run(2, _plan((1, "switch_fail", 0)), core_slots=0)
    s = fab.stats
    assert (s.switch_rounds, s.switch_fallback_rounds,
            s.switch_failures) == (3, 1, 1)


def test_switch_restore_resumes_offloading():
    plan = _plan((1, "switch_fail", 0), (1, "switch_fail", 1),
                 (3, "switch_restore", 0), (3, "switch_restore", 1))
    fab = _run(2, plan, rounds=4, core_slots=0)
    s = fab.stats
    assert s.switch_failures == 2 and s.switch_restores == 2
    assert s.switch_fallback_rounds == 1 and s.switch_rounds == 1


def test_fabric_restore_revives_failed_pools():
    fab = _run(2, _plan((1, "switch_fail", 0), (1, "switch_fail", 2)))
    assert not fab.rack_aggs[0].switch.alive and not fab.core_switch.alive
    trace = list(fab.fault_trace)
    fab.restore(fab.snapshot())
    assert fab.rack_aggs[0].switch.alive and fab.core_switch.alive
    assert fab.fault_trace == trace  # no event lies past the restored round
    assert not torch.count_nonzero(fab._core_ef)


def test_fault_target_out_of_range_raises():
    with pytest.raises(ValueError, match="2 ToR pools"):
        _run(2, _plan((1, "switch_fail", 3)))


def test_generate_and_json_match_jax():
    kw = dict(rounds=60, num_shards=2, num_workers=4, num_racks=2,
              switch_fail_rate=0.4, shard_crash_rate=0.1,
              worker_crash_rate=0.2, link_degrade_rate=0.2)
    plan = FaultPlan.generate(seed=3, **kw)
    ref = JaxPlan.generate(seed=3, **kw)
    assert plan.to_json() == ref.to_json()
    assert FaultPlan.from_json(ref.to_json()).to_json() == ref.to_json()
    assert JaxPlan.from_json(plan.to_json()).to_json() == plan.to_json()
    assert plan.describe() == ref.describe()
    assert len(plan) == len(ref) and plan.max_round == ref.max_round
    assert plan.between(5, 9) == tuple(
        FaultEvent(**e.to_json()) for e in ref.between(5, 9))
    fails = [e for e in plan.events if e.kind == "switch_fail"]
    assert fails and all(0 <= e.target <= 2 for e in fails)
    for f in fails:
        if f.round + 1 <= 60:
            assert any(r.kind == "switch_restore" and r.round == f.round + 1
                       and r.target == f.target for r in plan.events)
    quiet = FaultPlan.generate(seed=3, rounds=60, num_shards=2,
                               num_workers=4, num_racks=2)
    assert not quiet.events
    with pytest.raises(ValueError, match="not a FaultPlan"):
        FaultPlan.from_json({"schema": 2, "events": []})
    for bad in (dict(round=0, kind="switch_fail", target=0),
                dict(round=1, kind="meteor", target=0),
                dict(round=1, kind="switch_fail", target=-1),
                dict(round=1, kind="link_degrade", target=0, factor=0.5)):
        with pytest.raises(ValueError):
            FaultEvent(**bad)
        with pytest.raises(ValueError):
            JaxEvent(**bad)
    with pytest.raises(TypeError):
        FaultPlan([dict(round=1)])
    assert FAULT_KINDS == jax_fault_kinds()


def jax_fault_kinds():
    from repro.core.replication import FAULT_KINDS as JAX_KINDS

    return JAX_KINDS


# ---------------------------------------------------------------------------
# the config surface
# ---------------------------------------------------------------------------
def test_validate_accepts_topology_switch_and_switch_plans():
    topo = NetworkTopology(4, 2)
    plan = _plan((2, "switch_fail", 0), (3, "switch_restore", 2))
    cfg = FabricConfig(
        num_workers=4,
        wire=WireConfig(topology=topo,
                        compression=CompressionConfig(codec="int8"),
                        switch=SwitchConfig(enabled=True, tor_slots=4,
                                            core_slots=4)),
        faults=FaultConfig(fault_plan=plan))
    assert cfg.validate() is cfg
    assert "racks=2 oversub=1:4" in cfg.describe()
    assert "switch: on tor_slots=4 core_slots=4" in cfg.describe()
    # a JAX plan of switch events is read duck-typed, like the topology
    FabricConfig(num_workers=4, faults=FaultConfig(fault_plan=JaxPlan(
        [JaxEvent(1, "switch_restore", 0)]))).validate()


@pytest.mark.parametrize("kind", [k for k in FAULT_KINDS
                                  if not k.startswith("switch")])
def test_validate_accepts_fault_kind(kind):
    """A switch event and one of every other kind on one plan (the fault
    tier is ported): the port's int8 switch fabric (2 racks, R = 2) runs
    it as the JAX fabric does, traces and all."""
    from repro.core.config import FaultConfig as JaxFaults
    from test_torch_replication import assert_fault_same

    events = [(1, "switch_fail", 0), (2, kind, 0, 2.0)]
    FabricConfig(num_workers=4, faults=FaultConfig(
        fault_plan=_plan(*events))).validate()
    ref, jgrad, jh = jax_fabric("sync", "int8", 2, switch="on")
    fab, tgrad, th = torch_fabric("sync", "int8", 2, switch="on")
    ref = type(ref)(ref.space, ref.spec, jnp.zeros(ref.space.flat_elems),
                    config=dataclasses.replace(ref.config, faults=JaxFaults(
                        replication=2, fault_plan=JaxPlan(
                            JaxEvent(*e) for e in events))))
    fab = type(fab)(fab.space, fab.spec, torch.zeros(fab.space.flat_elems),
                    config=dataclasses.replace(fab.config, faults=FaultConfig(
                        replication=2, fault_plan=_plan(*events))),
                    device="cpu")
    drive("sync", ref, jgrad, jh, 3)
    drive("sync", fab, tgrad, th, 3)
    assert_fault_same(ref, fab)
    assert [t["event"]["kind"] for t in fab.fault_trace] == \
        ["switch_fail", kind]


@pytest.mark.parametrize("cfg,rule", [
    (dict(wire=WireConfig(switch=SwitchConfig(enabled=True, tor_slots=0))),
     "switch_slots"),
    (dict(wire=WireConfig(switch=SwitchConfig(tor_slots=-1))),
     "switch_slots"),
    (dict(faults=FaultConfig(replication=2, anti_affine=True),
          wire=WireConfig(topology=NetworkTopology(4, 1))), "anti_affine"),
])
def test_switch_config_rules_match_jax(cfg, rule):
    from repro.core.config import FabricConfig as JaxConfig
    from repro.core.config import FabricConfigError as JaxError
    from repro.core.config import FaultConfig as JaxFaults
    from repro.core.config import SwitchConfig as JaxSwitch
    from repro.core.config import WireConfig as JaxWire

    def to_jax(v):
        if isinstance(v, WireConfig):
            return JaxWire(topology=v.topology, switch=JaxSwitch(
                **dataclasses.asdict(v.switch)))
        if isinstance(v, FaultConfig):
            return JaxFaults(**dataclasses.asdict(v))
        return v

    with pytest.raises(JaxError) as je:
        JaxConfig(num_workers=4, **{k: to_jax(v) for k, v in cfg.items()}
                  ).validate()
    with pytest.raises(tconfig.FabricConfigError) as te:
        FabricConfig(num_workers=4, **cfg).validate()
    assert je.value.rule == te.value.rule == rule


# ---------------------------------------------------------------------------
# integer numerics, against the JAX package
# ---------------------------------------------------------------------------
def _special_slabs(rng, e, n_chunks):
    """Random slabs plus chunks of zeros, tiny values, exact halves, NaN
    and inf, where the scale and rounding edges live."""
    slabs = [(rng.standard_normal(n_chunks * e) * s).astype(np.float32)
             for s in (1.0, 1e-30, 3e4)]
    edge = np.zeros(n_chunks * e, np.float32)
    edge[e:2 * e] = np.arange(e, dtype=np.float32) - e / 2 + 0.5
    edge[2 * e] = np.nan
    edge[3 * e] = np.inf
    edge[3 * e + 1] = -np.inf
    return slabs + [edge]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_group_scale_and_quantize_bitwise_against_jax(seed):
    e, n_chunks = 64, 5
    rng = np.random.default_rng(seed)
    slabs = _special_slabs(rng, e, n_chunks)
    for group in (slabs[:1], slabs[:3], slabs):
        s = group_scale([torch.from_numpy(x) for x in group], e)
        js = jtopo.group_scale([jnp.asarray(x) for x in group], e)
        np.testing.assert_array_equal(_bits(js), _bits(s.numpy()))
        for x in group:
            q = integer_quantize(torch.from_numpy(x), s, e)
            jq = jtopo.integer_quantize(jnp.asarray(x), js, e)
            assert q.dtype == torch.int8
            np.testing.assert_array_equal(np.asarray(jq), q.numpy())


def test_group_scale_and_quantize_bounds():
    e = 64
    rng = np.random.default_rng(0)
    slabs = [torch.from_numpy(rng.standard_normal(2 * e).astype(np.float32))
             for _ in range(3)]
    s = group_scale(slabs, e)
    assert tuple(s.shape) == (2,)
    amax = torch.stack(slabs).reshape(3, 2, e).abs().amax(dim=(0, 2))
    assert torch.equal(s, amax / torch.full_like(amax, 127.0))
    for slab in slabs:
        q = integer_quantize(slab, s, e)
        assert q.dtype == torch.int8 and int(q.abs().max()) <= 127
    assert torch.equal(group_scale([torch.zeros(2 * e)], e), torch.ones(2))


def test_accumulate_is_int32_exact_under_adversarial_payloads():
    e = 128
    sw, jsw = SwitchCompute("t", 4), jtopo.SwitchCompute("t", 4)
    qs = [torch.full((4 * e,), 127, dtype=torch.int8) for _ in range(300)]
    acc = sw.accumulate(qs, e)
    assert acc.dtype == torch.int32
    assert torch.equal(acc, torch.full((4 * e,), 300 * 127, dtype=torch.int32))
    assert all(int(q[0]) == 127 for q in qs)  # the payloads stay unwritten
    alt = [torch.full((4 * e,), 127 if i % 2 == 0 else -127, dtype=torch.int8)
           for i in range(10)]
    assert not torch.count_nonzero(sw.accumulate(alt, e))
    for batch in (qs, alt):
        jsw.accumulate([jnp.asarray(q.numpy()) for q in batch], e)
    assert dataclasses.asdict(sw.stats) == dataclasses.asdict(jsw.stats)
    assert sw.describe() == jsw.describe()
    with pytest.raises(ValueError, match="slots must be >= 0"):
        SwitchCompute("bad", -1)


def test_switch_admission_and_liveness_match_jax():
    sw, jsw = SwitchCompute("tor0", 4), jtopo.SwitchCompute("tor0", 4)
    for s in (sw, jsw):
        assert s.can_offload(4) and not s.can_offload(5)
        s.fail()
        assert not s.can_offload(1)
        s.restore()
        s.fail()
        s.reset()
        assert s.alive
    assert dataclasses.asdict(sw.stats) == dataclasses.asdict(jsw.stats)
    assert sw.describe() == jsw.describe()


@pytest.mark.parametrize("error_feedback", [True, False])
def test_rack_aggregator_methods_bitwise_against_jax(error_feedback):
    """Every ``RackAggregator`` method, called in the same order on the
    same slabs: decoded slabs, encoded payloads, residuals and stats."""
    e, n = 128, 4 * 128
    cfg = CompressionConfig(codec="int8", chunk_elems=e,
                            error_feedback=error_feedback)
    from repro.core.compression import CompressionConfig as JaxCompression

    jcfg = JaxCompression(codec="int8", chunk_elems=e,
                          error_feedback=error_feedback)
    rack = RackAggregator(1, (2, 3), cfg, n, SwitchCompute("tor1", 4),
                          device="cpu")
    jrack = jtopo.RackAggregator(1, (2, 3), jcfg, n,
                                 jtopo.SwitchCompute("tor1", 4))
    rng = np.random.default_rng(5)
    x = [rng.standard_normal(n).astype(np.float32) for _ in range(8)]
    T, J = (lambda a: torch.from_numpy(a)), jnp.asarray

    def same(a, b):
        np.testing.assert_array_equal(np.asarray(b), a.numpy())

    same(rack.ingest(2, T(x[0])), jrack.ingest(2, J(x[0])))
    wp, jwp = rack.ingest_wire(3, T(x[1])), jrack.ingest_wire(3, J(x[1]))
    same(wp.payload, jwp.payload)
    same(wp.scale, jwp.scale)
    rack.ingest_deferred(2)
    jrack.ingest_deferred(2)
    pushes = [(2, x[2]), (3, x[3])]
    same(rack.switch_combine([(w, T(a)) for w, a in pushes]),
         jrack.switch_combine([(w, J(a)) for w, a in pushes]))
    same(rack.software_combine([(w, T(a)) for w, a in pushes]),
         jrack.software_combine([(w, J(a)) for w, a in pushes]))
    rack.drop_stale()
    jrack.drop_stale()
    same(rack.uplink(T(x[4])), jrack.uplink(J(x[4])))
    up, jup = rack.uplink_wire(T(x[5])), jrack.uplink_wire(J(x[5]))
    same(up.payload, jup.payload)
    slab2, jslab2 = rack.uplink_pool(T(x[6])), jrack.uplink_pool(J(x[6]))
    same(slab2, jslab2)
    s = group_scale([slab2], e)
    js = jtopo.group_scale([jslab2], e)
    q = integer_quantize(slab2, s, e)
    jq = jtopo.integer_quantize(jslab2, js, e)
    rack.commit_uplink(slab2, q, s)  # per chunk; JAX repeats it
    jrack.commit_uplink(jslab2, jq, jnp.repeat(js, e))
    for w in (2, 3):
        if error_feedback:
            same(rack._worker_ef[w], jrack._worker_ef[w])
        else:
            assert rack._worker_ef[w] is None and jrack._worker_ef[w] is None
    if error_feedback:
        same(rack._uplink_ef, jrack._uplink_ef)
    assert dataclasses.asdict(rack.stats) == dataclasses.asdict(jrack.stats)
    assert dataclasses.asdict(rack.switch.stats) == \
        dataclasses.asdict(jrack.switch.stats)
    with pytest.raises(ValueError, match="not in rack 1"):
        rack.ingest(0, T(x[7]))
    with pytest.raises(RuntimeError, match="no switch pool"):
        RackAggregator(0, (0,), cfg, n, device="cpu").switch_combine([])
    rack.switch.fail()
    rack.reset()
    assert rack.switch.alive
    if error_feedback:
        assert not torch.count_nonzero(rack._uplink_ef)


# ---------------------------------------------------------------------------
# core pool
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("racks", [2, 4])
def test_core_pool_absorbs_ingress_with_exact_bytes(racks):
    fab = _run(racks, None, rounds=2)
    c = fab.space.num_chunks
    s = fab.stats
    assert s.core_switch_rounds == 2 and s.switch_rounds == 2
    assert s.bytes_switch_saved == 2 * (racks - 1) * wire_bytes(
        fab.compression, fab.space.flat_elems)
    assert fab.core_switch.stats.pool_high_water == c
    # shard ingress: one stream a round
    assert sum(sh.stats.bytes_pushed for sh in fab.shards) == \
        2 * wire_bytes(fab.compression, fab.space.flat_elems)
    tor_only = _run(racks, None, rounds=2, core_slots=c - 1)
    assert tor_only.stats.core_switch_rounds == 0
    assert tor_only.stats.switch_rounds == 2
    assert tor_only.stats.bytes_switch_saved == 0


def test_core_pool_failure_falls_back_to_per_rack_uplinks():
    fab = _run(2, _plan((1, "switch_fail", 2)), rounds=2)
    s = fab.stats
    assert s.core_switch_rounds == 0 and s.bytes_switch_saved == 0
    assert s.switch_rounds == 2
    assert [r["action"] for r in fab.fault_trace] == ["switch_failed:core"]


# ---------------------------------------------------------------------------
# tenancy: register-budget grants (tests/test_switch.py:314-370)
# ---------------------------------------------------------------------------
def tenant_job(pkg, name, *, workers=4, elems=3000, **kw):
    """tests/test_switch.py's int8 tenant: targets made with numpy from a
    seed of the job's name, in either package."""
    kw.setdefault("codec", "int8")
    return tenancy.make_job(pkg, name, 0.5, workers=workers, elems=elems,
                            **kw)


def test_granted_tenant_matches_dedicated_twin():
    def run(pkg):
        b = tenancy.box(pkg, num_shards=2, num_racks=2,
                        switch=dict(enabled=True, tor_slots=16,
                                    core_slots=16))
        spec, grad_fn = tenant_job(pkg, "a")
        handle = b.attach(spec)
        pkg.harness(handle, grad_fn, lambda w, s: w).run(4)
        return b, handle, tenancy.dedicated(pkg, spec, grad_fn, b, 4)

    (jb, _, jtwin), (tb, handle, twin) = tenancy.both(run)
    tenancy.assert_box_same(jb, tb)
    assert_same(jtwin, twin)
    grant = tb.switch_grants["a"]
    assert grant.enabled and grant.tor_slots == handle.space.num_chunks
    assert handle.stats.switch_rounds == twin.stats.switch_rounds == 4
    assert torch.equal(handle.fabric.params, twin.params)
    # pool occupancy is booked on the shared switch link
    assert "switch" in tb.links and tb.links["switch"].stats.busy_us > 0


def test_grant_budget_is_full_slab_or_nothing_and_returned_on_detach():
    def run(pkg):
        spec_a, _ = tenant_job(pkg, "a")
        # the two packages lay a tree out alike: the port's count serves
        chunks = ParamSpace.build(
            {"w": torch.zeros(3000), "b": torch.zeros(50)},
            chunk_elems=pkg.tile, num_owners=2).num_chunks
        b = tenancy.box(pkg, num_shards=2, num_racks=2,
                        switch=dict(enabled=True, tor_slots=chunks))
        b.attach(spec_a)
        seen = [b._tor_slots_left]
        spec_b, grad_b = tenant_job(pkg, "b")
        hb = b.attach(spec_b)
        seen.append("b" in b.switch_grants)
        pkg.harness(hb, grad_b, lambda w, s: w).run(2)
        seen.append(hb.stats.switch_rounds)
        b.detach("a")
        seen.append(b._tor_slots_left)
        b.attach(tenant_job(pkg, "c")[0])
        seen.append(b.switch_grants["c"].tor_slots)
        return b, chunks, seen

    (jb, _, jseen), (tb, chunks, seen) = tenancy.both(run)
    tenancy.assert_box_same(jb, tb)
    assert seen == jseen == [0, False, 0, chunks, chunks]


def test_ineligible_jobs_are_never_granted():
    def run(pkg):
        b = tenancy.box(pkg, num_shards=2, num_racks=2,
                        switch=dict(enabled=True, tor_slots=64,
                                    core_slots=64))
        for spec, grad_fn in (tenant_job(pkg, "bf16", codec="bf16"),
                              tenant_job(pkg, "async", mode="async")):
            pkg.harness(b.attach(spec), grad_fn, lambda w, s: w).run(2)
        return b

    jb, tb = tenancy.both(run)
    tenancy.assert_box_same(jb, tb)
    assert not tb.switch_grants
    assert tb._tor_slots_left == 64 and tb._core_slots_left == 64
