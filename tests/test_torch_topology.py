"""The PyTorch rack topology tier against the JAX one, bitwise.

Mirrors tests/test_topology.py.  Both fabrics are built from
``FabricConfig`` with a ``NetworkTopology`` and driven with the same
numpy-made targets: the workers minimize ``||w - t_w||^2``, whose gradient
``2 * (w - t_w)`` is one f32 subtract and one multiply in either package.
Params, optimizer state, every ``ServerStats`` / ``ShardStats`` /
``RackStats`` / ``SwitchStats`` field (the event clock's ``sim_*`` floats
included), the ToRs' and the core pool's error-feedback residuals, the
clocks and ``fault_trace`` must match exactly: for codec none, bf16 and
int8, 1, 2, 3 (ragged) and 4 racks, sync, a backup quorum, SSP and
async, on the fused wire route and the unfused one.  Inside the port,
codec-"none" rack aggregation is bit-identical to the flat fabric.

Not mirrored here: the ``elastic_restore`` / ``reshard_flat`` cases, which
tests/test_torch_elastic.py holds, and the SPMD trainer's telemetry
(``attach_telemetry``, with the SPMD path).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core.chunking import ParamSpace as JaxSpace  # noqa: E402
from repro.core.compression import CompressionConfig as JaxCompression  # noqa: E402
from repro.core.config import FabricConfig as JaxConfig  # noqa: E402
from repro.core.config import FaultConfig as JaxFaults  # noqa: E402
from repro.core.config import SwitchConfig as JaxSwitch  # noqa: E402
from repro.core.config import WireConfig as JaxWire  # noqa: E402
from repro.core.fabric import LinkModel as JaxLink  # noqa: E402
from repro.core.fabric import PBoxFabric as JaxFabric  # noqa: E402
from repro.core.fabric import WorkerHarness as JaxHarness  # noqa: E402
from repro.core.replication import FaultEvent as JaxEvent  # noqa: E402
from repro.core.replication import FaultPlan as JaxPlan  # noqa: E402
from repro.core.topology import NetworkTopology as JaxTopology  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro_torch.core import fabric as tfabric  # noqa: E402
from repro_torch.core.chunking import ParamSpace  # noqa: E402
from repro_torch.core.compression import CompressionConfig, wire_bytes  # noqa: E402
from repro_torch.core.config import (  # noqa: E402
    FabricConfig,
    FaultConfig,
    SwitchConfig,
    WireConfig,
)
from repro_torch.core.fabric import LinkModel, PBoxFabric, WorkerHarness  # noqa: E402
from repro_torch.core.replication import FaultEvent, FaultPlan  # noqa: E402
from repro_torch.core.topology import NetworkTopology  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402

K = 4
W_ELEMS, B_ELEMS = 13000, 77  # 4 chunks of 4096, 13 of 1024
CHUNK = {"none": 1024, "bf16": 4096, "int8": 4096}
MODES = {
    "sync": dict(mode="sync"),
    "quorum": dict(mode="sync", min_push_fraction=0.75),
    "ssp": dict(mode="stale", staleness=2),
    "async": dict(mode="async"),
}
SPEED = {"sync": [1, 1, 1, 1], "ssp": [1, 1, 1, 4], "async": [1, 1, 1, 3]}
STEPS = 4  # rounds (sync, quorum) or steps of the slowest worker
LINK = dict(wire_us_per_chunk=1.0, agg_us_per_chunk=0.2)


def _targets():
    rng = np.random.default_rng(11)
    return [{"w": rng.standard_normal(W_ELEMS).astype(np.float32) * (i + 1),
             "b": rng.standard_normal(B_ELEMS).astype(np.float32)}
            for i in range(K)]


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def switch_config(variant, num_chunks):
    """(enabled, tor_slots, core_slots) of a switch variant: ``off``;
    ``on`` (pools hold every chunk); ``starved`` (one slot short);
    ``tor_fail`` / ``core_fail`` (``on``, with a plan that fails a ToR pool
    or the core pool at round 2 and restores it at round 3)."""
    if variant == "off":
        return dict(enabled=False)
    slots = num_chunks - (variant == "starved")
    return dict(enabled=True, tor_slots=slots, core_slots=slots)


def fault_events(variant, num_racks):
    """(round, kind, target) of a variant's plan, or None."""
    if variant not in ("tor_fail", "core_fail"):
        return None
    target = 0 if variant == "tor_fail" else num_racks
    return [(2, "switch_fail", target), (3, "switch_restore", target)]


def jax_fabric(mode, codec, racks, *, fused=True, switch="off",
               rack_aggregation=True, num_shards=2, spec="adamw",
               num_workers=K):
    targets = [{k: jnp.asarray(v) for k, v in t.items()} for t in _targets()]
    params = {"w": jnp.zeros((W_ELEMS,)), "b": jnp.zeros((B_ELEMS,))}
    space = JaxSpace.build(params, chunk_elems=CHUNK[codec])
    topo = (None if racks is None else
            JaxTopology(num_workers=num_workers, num_racks=racks,
                        rack_aggregation=rack_aggregation))
    events = fault_events(switch, racks or 1)
    plan = None if events is None else JaxPlan(JaxEvent(*e) for e in events)
    fab = JaxFabric(space, getattr(jopt, spec)(3e-3), space.flatten(params),
                    config=JaxConfig(
                        num_shards=num_shards, num_workers=num_workers,
                        wire=JaxWire(topology=topo,
                                     compression=JaxCompression(codec=codec),
                                     link=JaxLink(**LINK),
                                     fused_wire_path=fused,
                                     switch=JaxSwitch(**switch_config(
                                         switch, space.num_chunks))),
                        faults=JaxFaults(fault_plan=plan),
                        **MODES[mode]))

    def grad_fn(p, w):
        return jax.tree.map(lambda a, b: 2 * (a - b), p, targets[w])

    return fab, grad_fn, JaxHarness


def torch_fabric(mode, codec, racks, *, switch="off", rack_aggregation=True,
                 num_shards=2, spec="adamw", num_workers=K):
    targets = [{k: torch.from_numpy(v) for k, v in t.items()}
               for t in _targets()]
    params = {"w": torch.zeros(W_ELEMS), "b": torch.zeros(B_ELEMS)}
    space = ParamSpace.build(params, chunk_elems=CHUNK[codec])
    topo = (None if racks is None else
            NetworkTopology(num_workers=num_workers, num_racks=racks,
                            rack_aggregation=rack_aggregation))
    events = fault_events(switch, racks or 1)
    plan = None if events is None else FaultPlan(FaultEvent(*e)
                                                 for e in events)
    fab = PBoxFabric(space, getattr(topt, spec)(3e-3), space.flatten(params),
                     config=FabricConfig(
                         num_shards=num_shards, num_workers=num_workers,
                         wire=WireConfig(
                             topology=topo,
                             compression=CompressionConfig(codec=codec),
                             link=LinkModel(**LINK),
                             switch=SwitchConfig(**switch_config(
                                 switch, space.num_chunks))),
                         faults=FaultConfig(fault_plan=plan),
                         **MODES[mode]),
                     device="cpu")

    def grad_fn(p, w):
        return {k: 2 * (p[k] - targets[w][k]) for k in p}

    return fab, grad_fn, WorkerHarness


def drive(mode, fab, grad_fn, harness, steps=STEPS, chunk_groups=1):
    """The mode's schedule; ``quorum`` pulls all, then pushes all (the
    last push, against superseded params, is dropped)."""
    if mode != "quorum":
        harness(fab, grad_fn, lambda w, s: w, speed=SPEED[mode],
                chunk_groups=chunk_groups).run(steps)
        return
    for _ in range(steps):
        pulled = [fab.space.unflatten(fab.pull(w))
                  for w in range(fab.num_workers)]
        for w in range(fab.num_workers):
            fab.push(w, fab.space.flatten(grad_fn(pulled[w], w)))


def _same_ef(a, b):
    if a is None or b is None:
        assert a is None and b is None
    else:
        np.testing.assert_array_equal(_bits(a), _bits(b.numpy()))


def assert_same(ref, fab):
    """Every bit and counter of the two fabrics."""
    np.testing.assert_array_equal(_bits(ref.params), _bits(fab.params.numpy()))
    assert len(ref.shards) == len(fab.shards)
    for js, ts in zip(ref.shards, fab.shards):
        np.testing.assert_array_equal(js.chunk_ids, ts.chunk_ids)
        for a, b in zip(js.state, ts.state):
            np.testing.assert_array_equal(_bits(a), _bits(b.numpy()))
        assert dataclasses.asdict(js.stats) == dataclasses.asdict(ts.stats)
    assert sorted(ref._worker_ef) == sorted(fab._worker_ef)
    for w, ef in ref._worker_ef.items():
        _same_ef(ef, fab._worker_ef[w])
    assert len(ref.rack_aggs) == len(fab.rack_aggs)
    for jr, tr in zip(ref.rack_aggs, fab.rack_aggs):
        assert jr.members == tr.members
        assert dataclasses.asdict(jr.stats) == dataclasses.asdict(tr.stats)
        assert sorted(jr._worker_ef) == sorted(tr._worker_ef)
        for w, ef in jr._worker_ef.items():
            _same_ef(ef, tr._worker_ef[w])
        _same_ef(jr._uplink_ef, tr._uplink_ef)
        assert (jr.switch is None) == (tr.switch is None)
        if jr.switch is not None:
            assert dataclasses.asdict(jr.switch.stats) == \
                dataclasses.asdict(tr.switch.stats)
            assert jr.switch.alive == tr.switch.alive
    assert (ref.core_switch is None) == (fab.core_switch is None)
    if ref.core_switch is not None:
        assert dataclasses.asdict(ref.core_switch.stats) == \
            dataclasses.asdict(fab.core_switch.stats)
        assert ref.core_switch.alive == fab.core_switch.alive
    _same_ef(ref._core_ef, fab._core_ef)
    # every counter and event-clock float, bit for bit
    assert dataclasses.asdict(ref.stats) == dataclasses.asdict(fab.stats)
    assert ref.fault_trace == fab.fault_trace
    np.testing.assert_array_equal(ref.worker_clock, fab.worker_clock)
    np.testing.assert_array_equal(ref._pull_step, fab._pull_step)
    assert ref.step == fab.step


def run_pair(mode, codec, racks, **kw):
    ref, jgrad, jharness = jax_fabric(mode, codec, racks, **kw)
    drive(mode, ref, jgrad, jharness)
    kw.pop("fused", None)
    fab, tgrad, tharness = torch_fabric(mode, codec, racks, **kw)
    drive(mode, fab, tgrad, tharness)
    return ref, fab


# ---------------------------------------------------------------------------
# topology layout
# ---------------------------------------------------------------------------
def test_topology_layout_and_validation_match_jax():
    for n, r in ((8, 4), (5, 3), (4, 1), (7, 7)):
        t, j = NetworkTopology(n, r), JaxTopology(n, r)
        assert t.rack_of == j.rack_of
        assert [t.members(i) for i in range(r)] == \
            [j.members(i) for i in range(r)]
        assert t.workers_per_rack == j.workers_per_rack
        assert t.describe() == j.describe()
        np.testing.assert_array_equal(t.replica_racks(5, 3),
                                      j.replica_racks(5, 3))
        np.testing.assert_array_equal(t.home_racks(6), j.home_racks(6))
    assert NetworkTopology(8, 4).rack_of == (0, 0, 1, 1, 2, 2, 3, 3)
    assert NetworkTopology(5, 3).rack_of == (0, 0, 1, 1, 2)
    for bad in (dict(num_workers=4, num_racks=2, rack_of=(0, 1, 0, 1)),
                dict(num_workers=4, num_racks=5),
                dict(num_workers=4, num_racks=2, oversubscription=0.5),
                dict(num_workers=0),
                dict(num_workers=4, num_racks=2, rack_of=(0, 0, 0)),
                dict(num_workers=4, num_racks=2, rack_of=(0, 0, 0, 0)),
                dict(num_workers=4, num_racks=2, rack_of=(0, 0, 1, 2))):
        with pytest.raises(ValueError) as te:
            NetworkTopology(**bad)
        with pytest.raises(ValueError) as je:
            JaxTopology(**bad)
        assert str(te.value) == str(je.value)
    # a topology for another worker count is refused by the config
    with pytest.raises(ValueError, match="topology_workers"):
        FabricConfig(num_workers=2, wire=WireConfig(
            topology=NetworkTopology(4, 2))).validate()


def test_hop_cost_and_plan_attachment():
    topo = NetworkTopology(num_workers=4, num_racks=2, oversubscription=3.0)
    assert topo.hop_cost(0, 0) == 1.0 and topo.hop_cost(0, 1) == 3.0
    with pytest.raises(ValueError, match="not in the topology"):
        topo.hop_cost(0, 2)
    plan = type("P", (), {"num_racks": 2, "num_shards": 3,
                          "replica_racks": np.array([[1, 0], [1, 0],
                                                     [0, 1]])})()
    planned = topo.with_plan(plan)
    assert planned == topo  # the plan is left out of equality
    np.testing.assert_array_equal(planned.replica_racks(3, 2),
                                  plan.replica_racks)
    np.testing.assert_array_equal(planned.replica_racks(2, 1),
                                  topo.replica_racks(2, 1))
    with pytest.raises(ValueError, match="plan places 2 racks"):
        NetworkTopology(num_workers=4, num_racks=1, plan=plan)


def test_nearest_rack_tie_breaks_to_lowest_id():
    """The pinned tie-break: among equally cheap candidates the lowest
    rack id wins, as in the JAX package."""
    topo, jtopo = NetworkTopology(8, 4), JaxTopology(8, 4)
    for cands, to in (([3, 1, 2], 2), ([3, 1], 0), ([1, 3], 0),
                      ([3, 2, 1], 0), ([3], 0), ([1, 2, 3], 0)):
        assert topo.nearest_rack(cands, to) == jtopo.nearest_rack(cands, to)
    assert topo.nearest_rack([3, 1, 2], to_rack=2) == 2
    assert topo.nearest_rack([3, 2, 1], to_rack=0) == 1
    with pytest.raises(ValueError):
        topo.nearest_rack([], to_rack=0)
    with pytest.raises(ValueError):
        topo.nearest_rack([4], to_rack=0)


def test_link_queue_matches_jax():
    """The weighted-fair link queue tenancy will use: the same occupancy,
    contention and description for the same reservations."""
    from repro.core.topology import LinkQueue as JaxLinkQueue
    from repro_torch.core.topology import LinkQueue

    q, jq = LinkQueue("core"), JaxLinkQueue("core")
    assert q.stats.contention_factor == 1.0
    for job, demand, scale in (("a", 10.0, 1.0), ("b", 4.0, 2.5),
                               ("a", 0.0, 3.0), ("c", 7.5, 1.25)):
        assert q.reserve(job, demand, scale) == jq.reserve(job, demand, scale)
    assert dataclasses.asdict(q.stats) == dataclasses.asdict(jq.stats)
    assert q.stats.queued_us == jq.stats.queued_us
    assert q.stats.contention_factor == jq.stats.contention_factor
    assert q.describe() == jq.describe()
    for bad in ((-1.0, 1.0), (1.0, 0.5)):
        with pytest.raises(ValueError):
            q.reserve("a", *bad)


# ---------------------------------------------------------------------------
# the rack path against the JAX fabric
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("racks", [1, 2, 3, 4])
@pytest.mark.parametrize("codec", ["none", "bf16", "int8"])
@pytest.mark.parametrize("mode", list(MODES))
def test_rack_path_matches_jax_bitwise(mode, codec, racks):
    """codec x racks (3 is ragged: 2/1/1) x mode, fused wire route."""
    ref, fab = run_pair(mode, codec, racks)
    assert fab._fused_wire == ref._fused_wire == (codec != "none")
    assert_same(ref, fab)
    st = fab.stats
    if mode == "async":
        assert st.rack_streams == 0 and st.steps == st.pushes
    else:
        assert st.bytes_rack_link == sum(
            r.stats.bytes_in for r in fab.rack_aggs)
        assert st.bytes_core_link == sum(
            r.stats.bytes_up for r in fab.rack_aggs)
    if mode == "sync":
        assert st.rack_streams == racks * st.steps
    if mode == "quorum":
        assert st.late_pushes_dropped == STEPS
        assert sum(r.stats.stale_drops for r in fab.rack_aggs) == STEPS


@pytest.mark.parametrize("codec", ["bf16", "int8"])
@pytest.mark.parametrize("mode", ["sync", "quorum", "async"])
def test_rack_path_unfused_matches_jax_bitwise(mode, codec, monkeypatch):
    """The unfused route (decode at the hop, f32 rows to the shards): the
    port reaches it by declaring the geometry unsupported, the JAX package
    by its ``fused_wire_path`` switch."""
    monkeypatch.setattr(tfabric, "wire_path_supported", lambda *a: False)
    ref, fab = run_pair(mode, codec, 2, fused=False)
    assert not fab._fused_wire and not ref._fused_wire
    assert_same(ref, fab)


@pytest.mark.parametrize("codec", ["none", "int8"])
@pytest.mark.parametrize("mode", ["sync", "quorum", "async"])
def test_rack_aggregation_off_matches_jax_bitwise(mode, codec):
    """ToR combining off: the two-tier wire is modelled, every worker
    stream crosses the core itself (the fused route ships pushes encoded
    through the ToR)."""
    ref, fab = run_pair(mode, codec, 2, rack_aggregation=False)
    assert_same(ref, fab)
    assert fab.stats.rack_streams == 0
    assert fab.stats.bytes_core_link == fab.stats.bytes_rack_link


@pytest.mark.parametrize("num_shards", [1, 2, 8])
@pytest.mark.parametrize("spec", ["momentum", "adamw"])
def test_rack_aggregation_bit_identical_to_flat(spec, num_shards):
    """Inside the port: codec "none" rack aggregation over 1, 2, 3 (ragged)
    and 4 racks equals the flat fabric bit for bit (the chained prefix
    plus zero rows is the kernel's left fold), under a backup quorum too."""
    for mode in ("sync", "quorum"):
        flat, g, h = torch_fabric(mode, "none", None, spec=spec,
                                  num_shards=num_shards)
        drive(mode, flat, g, h)
        for racks in (1, 2, 3, 4):
            fab, g, h = torch_fabric(mode, "none", racks, spec=spec,
                                     num_shards=num_shards)
            drive(mode, fab, g, h)
            assert torch.equal(flat.params.view(torch.int32),
                               fab.params.view(torch.int32))
            assert fab.stats.late_pushes_dropped == \
                flat.stats.late_pushes_dropped


def test_rack_path_with_staged_chunk_pushes():
    """Chunk-by-chunk staged pushes complete into the same rack path,
    against the JAX fabric and the port's whole pushes."""
    ref, jgrad, jharness = jax_fabric("sync", "int8", 2)
    drive("sync", ref, jgrad, jharness, chunk_groups=3)
    fab, tgrad, tharness = torch_fabric("sync", "int8", 2)
    drive("sync", fab, tgrad, tharness, chunk_groups=3)
    assert_same(ref, fab)
    whole, tgrad, tharness = torch_fabric("sync", "int8", 2)
    drive("sync", whole, tgrad, tharness)
    assert torch.equal(whole.params, fab.params)


# ---------------------------------------------------------------------------
# wire byte accounting and the event clock
# ---------------------------------------------------------------------------
def test_core_link_bytes_shrink_with_rack_aggregation_and_codec():
    steps = 3
    flat, g, h = torch_fabric("sync", "none", None)
    drive("sync", flat, g, h, steps)
    racked, g, h = torch_fabric("sync", "none", 2)
    drive("sync", racked, g, h, steps)
    int8, g, h = torch_fabric("sync", "int8", 2)
    drive("sync", int8, g, h, steps)
    topo = racked.topology
    stream = 4 * racked.space.flat_elems
    assert flat.stats.bytes_core_link == steps * K * stream
    assert flat.stats.bytes_rack_link == 0
    assert racked.stats.bytes_core_link == steps * topo.num_racks * stream
    assert flat.stats.bytes_core_link == \
        racked.stats.bytes_core_link * topo.workers_per_rack
    assert racked.stats.bytes_rack_link == steps * K * stream
    assert racked.stats.rack_streams == steps * topo.num_racks
    int8_stream = wire_bytes(int8.compression, int8.space.flat_elems)
    assert int8.stats.bytes_core_link == steps * topo.num_racks * int8_stream
    for fab in (racked, int8):
        assert sum(s.stats.bytes_pushed for s in fab.shards) == \
            fab.stats.bytes_core_link


def test_event_clock_rewards_rack_aggregation():
    on, g, h = torch_fabric("sync", "none", 2)
    drive("sync", on, g, h, 2)
    off, g, h = torch_fabric("sync", "none", 2, rack_aggregation=False)
    drive("sync", off, g, h, 2)
    assert on.stats.sim_core_wire_us > 0
    assert on.stats.sim_pipelined_us < off.stats.sim_pipelined_us
    assert on.stats.sim_pipelined_us < on.stats.sim_serialized_us


def test_int8_rack_error_feedback_unbiased():
    """With error feedback, sub-quantum components survive the two codec
    stages (worker NIC and ToR) over time; without it they never move."""
    chunk = 1024
    space = ParamSpace.build({"w": torch.zeros(2 * chunk)}, chunk_elems=chunk)
    g = np.full(space.flat_elems, 0.003, np.float32)
    g[::chunk] = 1.0
    steps, scale = 30, 1.0 / 127.0
    errs = {}
    for ef in (True, False):
        fab = PBoxFabric(
            space, topt.sgd(1.0), torch.zeros(space.flat_elems),
            config=FabricConfig(num_workers=1, wire=WireConfig(
                topology=NetworkTopology(1, 1),
                compression=CompressionConfig(codec="int8",
                                              error_feedback=ef))),
            device="cpu")
        for _ in range(steps):
            fab.pull(0)
            fab.push(0, torch.from_numpy(g))
        errs[ef] = np.abs(-fab.params.numpy() - steps * g)
    assert errs[True].max() <= 3 * scale
    small = np.ones(space.flat_elems, bool)
    small[::chunk] = False
    assert errs[False][small].max() == pytest.approx(steps * 0.003, rel=1e-4)


def test_bf16_rack_path_close_to_f32():
    flat, g, h = torch_fabric("sync", "none", None)
    drive("sync", flat, g, h, 3)
    bf16, g, h = torch_fabric("sync", "bf16", 2)
    drive("sync", bf16, g, h, 3)
    a = flat.space.unflatten(flat.params)
    b = bf16.space.unflatten(bf16.params)  # another chunk size, other padding
    for key in a:
        np.testing.assert_allclose(a[key].numpy(), b[key].numpy(),
                                   rtol=2e-2, atol=2e-2)


# ---------------------------------------------------------------------------
# quorum admission at the ToR
# ---------------------------------------------------------------------------
def test_stale_push_dropped_at_the_tor():
    fab, grad_fn, _ = torch_fabric("quorum", "none", 2, spec="sgd")
    space = fab.space
    p0 = space.unflatten(fab.pull(0))
    g = [space.flatten(grad_fn(p0, w)) for w in range(K)]
    for w in range(3):
        fab.push(w, g[w])
    assert fab.stats.steps == 1
    core, shard_bytes = (fab.stats.bytes_core_link,
                         [s.stats.bytes_pushed for s in fab.shards])
    fab.push(3, g[3])  # superseded: dropped at the ToR, no core bytes
    assert fab.stats.late_pushes_dropped == 1 and not fab._inbox
    assert fab.stats.bytes_core_link == core
    assert [s.stats.bytes_pushed for s in fab.shards] == shard_bytes
    assert fab.rack_aggs[1].stats.stale_drops == 1
    assert sum(r.stats.bytes_in for r in fab.rack_aggs) == \
        fab.stats.bytes_rack_link
    # without an aggregating ToR the PS drops it after the core crossing
    off, grad_fn, _ = torch_fabric("quorum", "none", 2, spec="sgd",
                                   rack_aggregation=False)
    for w in range(K):
        off.push(w, g[w])
    assert off.stats.late_pushes_dropped == 1
    assert off.stats.bytes_core_link == 4 * 4 * off.space.flat_elems


# ---------------------------------------------------------------------------
# restore, harness and describe
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("codec", ["none", "int8"])
def test_restore_and_rebalance_on_a_topology_fabric_match_jax(codec):
    """A snapshot taken mid-run restores into a fresh topology fabric (the
    ToR residuals reset, as in the JAX package), and a rebalance inside
    the run keeps every bit."""
    fabs = []
    for build in (jax_fabric, torch_fabric):
        fab, g, h = build("sync", codec, 2, num_shards=4)
        drive("sync", fab, g, h, 2)
        assert fab.rebalance([1]) > 0
        drive("sync", fab, g, h, 2)
        snap = fab.snapshot()
        fresh, g, h = build("sync", codec, 2, num_shards=2)
        fresh.restore(snap)
        drive("sync", fresh, g, h, 2)
        fabs.append(fresh)
    assert_same(*fabs)
    assert fabs[1].step == 6


def test_harness_rack_views_match_jax():
    ref, jgrad, _ = jax_fabric("sync", "none", 2, spec="sgd")
    fab, tgrad, _ = torch_fabric("sync", "none", 2, spec="sgd")
    jh = JaxHarness(ref, jgrad, lambda w, s: w, speed_by_rack={1: 3})
    th = WorkerHarness(fab, tgrad, lambda w, s: w, speed_by_rack={1: 3})
    assert [th.rack_of(w) for w in range(K)] == [0, 0, 1, 1]
    assert th.speed == jh.speed == [1, 1, 3, 3]
    jh.run(2)
    th.run(2)
    assert th.steps_done_by_rack() == jh.steps_done_by_rack()
    tel, jtel = th.telemetry(), jh.telemetry()
    assert tel["job"] is None and jtel["job"] is None
    assert tel == jtel
    assert_same(ref, fab)
    flat, g, _ = torch_fabric("sync", "none", None)
    with pytest.raises(ValueError, match="needs a fabric topology"):
        WorkerHarness(flat, g, lambda w, s: w, speed_by_rack={0: 2})
    with pytest.raises(ValueError, match="names racks"):
        WorkerHarness(fab, tgrad, lambda w, s: w, speed_by_rack={7: 2})
    assert WorkerHarness(flat, g, lambda w, s: w).steps_done_by_rack() == \
        {0: 0}


def test_describe_names_the_topology():
    fab, g, h = torch_fabric("sync", "int8", 2, switch="on")
    drive("sync", fab, g, h, 1)
    text = fab.describe()
    assert "NetworkTopology: 4 workers / 2 racks [2, 2]" in text
    assert "core link:" in text and "switch tier: 1 rounds offloaded" in text
    assert "switch tor0: 4 slots up" in text and "switch core:" in text
    assert fab.rack_of(3) == 1
    flat, g, h = torch_fabric("sync", "int8", None)
    assert flat.rack_of(3) == 0 and "NetworkTopology" not in flat.describe()


def test_sparse_tier_on_a_topology_fabric_still_raises():
    """Attaching a sparse tier to a topology fabric no longer raises (the
    sparse tier under a topology is ported): the tier inherits the
    fabric's topology and chain racks, and a round of pushes and a lookup
    price their rack and core bytes and ``sim_*`` floats as the JAX tier
    attached to the JAX fabric does."""
    from repro.core.sparse import SparseTier as JaxSparseTier
    from repro_torch.core.sparse import SparseTier

    fab, _, _ = torch_fabric("sync", "none", 2)
    ref, _, _ = jax_fabric("sync", "none", 2)
    tier = SparseTier(fabric=fab, codec="int8")
    jtier = JaxSparseTier(fabric=ref, codec="int8")
    assert tier.topology is fab.topology
    np.testing.assert_array_equal(tier.chain_racks, jtier.chain_racks)
    init = np.random.default_rng(3).standard_normal((40, 8)).astype(
        np.float32)
    for t, to in ((tier, torch.from_numpy), (jtier, jnp.asarray)):
        t.add_table("e", init)
        rng = np.random.default_rng(4)
        for w in range(fab.num_workers):
            ids = rng.integers(0, 40, size=6)
            t.push(w, {"e": (ids, to(rng.standard_normal((6, 8)).astype(
                np.float32)))})
        t.lookup(3, "e", np.array([1, 5, 5, 39]), np.array([0, 2, 4]))
    np.testing.assert_array_equal(_bits(tier.table("e").numpy()),
                                  _bits(jtier.table("e")))
    assert dataclasses.asdict(tier.stats) == dataclasses.asdict(jtier.stats)
    assert tier.stats.bytes_core_link > 0 and tier.stats.bytes_rack_link > 0