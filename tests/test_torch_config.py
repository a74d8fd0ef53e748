"""The port's construction surface against the JAX package's.

Mirrors the fabric-side cases of tests/test_config.py: a port fabric built
from the legacy keywords equals one built from the equivalent
``FabricConfig`` and the JAX fabric built from the same legacy keywords,
bit for bit (params, state, residuals, every stats field, the ``sim_*``
floats included) across mode x codec x shards; the adapter warns once per
call site and the config path never; config and legacy keywords are
mutually exclusive; ``LEGACY_KWARGS`` names the JAX package's keywords and
lands each at its path; every validation rule raises the same named
``FabricConfigError`` as the JAX package, before any state exists; and
``describe()`` names the whole surface.  ``use_pallas`` and
``fused_wire_path`` have no field in the port: the adapter accepts their
JAX default ``True`` and refuses anything else.
"""
import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from test_torch_topology import assert_same  # noqa: E402

from repro.core import config as jconfig  # noqa: E402
from repro.core.chunking import TILE_ELEMS as JAX_TILE  # noqa: E402
from repro.core.chunking import ParamSpace as JaxSpace  # noqa: E402
from repro.core.compression import CompressionConfig as JaxCompression  # noqa: E402
from repro.core.fabric import LinkModel as JaxLink  # noqa: E402
from repro.core.fabric import PBoxFabric as JaxFabric  # noqa: E402
from repro.core.topology import NetworkTopology as JaxTopology  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro_torch.core import config as tconfig  # noqa: E402
from repro_torch.core.chunking import TILE_ELEMS, ParamSpace  # noqa: E402
from repro_torch.core.compression import CompressionConfig  # noqa: E402
from repro_torch.core.config import (  # noqa: E402
    LEGACY_KWARGS,
    FabricConfig,
    FabricConfigError,
    FaultConfig,
    SwitchConfig,
    WireConfig,
)
from repro_torch.core.fabric import LinkModel, PBoxFabric  # noqa: E402
from repro_torch.core.topology import NetworkTopology  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402

K = 4


def make_setup():
    """The two packages' spaces over one flat of 3 chunks, and K
    gradients made with numpy from a seed."""
    n = 3 * TILE_ELEMS - 64
    jspace = JaxSpace.build({"w": jnp.zeros((n,))}, chunk_elems=JAX_TILE)
    tspace = ParamSpace.build({"w": torch.zeros(n)}, chunk_elems=TILE_ELEMS)
    rng = np.random.default_rng(11)
    grads = [rng.standard_normal(tspace.flat_elems).astype(np.float32)
             for _ in range(K)]
    return jspace, tspace, grads


def drive(fab, grads, rounds=3):
    to = jnp.asarray if isinstance(fab, JaxFabric) else torch.from_numpy
    for r in range(rounds):
        for w in range(K):
            fab.pull(w)
            fab.push(w, to(grads[(w + r) % K]))
    return fab


def quiet_legacy(cls, *args, **kw):
    """Build through the deprecated keyword path without tripping the
    warning filters (the cadence itself is pinned separately below)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return cls(*args, **kw)


def port_fabric(tspace, **kw):
    return PBoxFabric(tspace, topt.momentum(0.1, 0.9),
                      torch.zeros(tspace.flat_elems), device="cpu", **kw)


# ---------------------------------------------------------------------------
# config == legacy, bit for bit, and == JAX
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shards", [1, 2, 4])
@pytest.mark.parametrize("codec", ["none", "bf16", "int8"])
@pytest.mark.parametrize("mode", ["sync", "async", "stale"])
def test_config_equivalent_to_legacy_kwargs(mode, codec, shards):
    jspace, tspace, grads = make_setup()
    stale = 2 if mode == "stale" else 0
    ref = quiet_legacy(
        JaxFabric, jspace, jopt.momentum(0.1, 0.9),
        jnp.zeros((jspace.flat_elems,)),
        num_shards=shards, mode=mode, staleness=stale, num_workers=K,
        topology=JaxTopology(num_workers=K, num_racks=2),
        compression=JaxCompression(codec=codec),
        link=JaxLink(wire_us_per_chunk=1.0), replication=2)
    legacy = quiet_legacy(
        port_fabric, tspace,
        num_shards=shards, mode=mode, staleness=stale, num_workers=K,
        topology=NetworkTopology(num_workers=K, num_racks=2),
        compression=CompressionConfig(codec=codec),
        link=LinkModel(wire_us_per_chunk=1.0), replication=2)
    cfg_fab = port_fabric(tspace, config=FabricConfig(
        num_shards=shards, mode=mode, staleness=stale, num_workers=K,
        wire=WireConfig(
            topology=NetworkTopology(num_workers=K, num_racks=2),
            compression=CompressionConfig(codec=codec),
            link=LinkModel(wire_us_per_chunk=1.0)),
        faults=FaultConfig(replication=2)))
    for f in (ref, legacy, cfg_fab):
        drive(f, grads)
    assert_same(ref, legacy)
    assert_same(ref, cfg_fab)
    # the adapter produced the very config the primary path was given
    assert legacy.config == cfg_fab.config


def test_rebuild_from_live_config_is_bit_identical_twin():
    jspace, tspace, grads = make_setup()
    cfg = FabricConfig(
        num_shards=2, num_workers=K,
        wire=WireConfig(
            topology=NetworkTopology(num_workers=K, num_racks=2),
            compression=CompressionConfig(codec="int8"),
            switch=SwitchConfig(enabled=True, tor_slots=8)))
    fab = drive(port_fabric(tspace, config=cfg), grads)
    assert fab.config is cfg
    twin = drive(port_fabric(tspace, config=fab.config), grads)
    assert torch.equal(fab.params, twin.params)
    ref = drive(JaxFabric(jspace, jopt.momentum(0.1, 0.9),
                          jnp.zeros((jspace.flat_elems,)),
                          config=jconfig.FabricConfig(
                              num_shards=2, num_workers=K,
                              wire=jconfig.WireConfig(
                                  topology=JaxTopology(num_workers=K,
                                                       num_racks=2),
                                  compression=JaxCompression(codec="int8"),
                                  switch=jconfig.SwitchConfig(
                                      enabled=True, tor_slots=8)))), grads)
    assert_same(ref, twin)


# ---------------------------------------------------------------------------
# deprecation cadence
# ---------------------------------------------------------------------------
def _deprecations(rec):
    return [w for w in rec if issubclass(w.category, DeprecationWarning)
            and "FabricConfig" in str(w.message)]


def test_legacy_kwargs_warn_exactly_once_per_call_site():
    _, tspace, _ = make_setup()

    def site_a():
        return PBoxFabric(tspace, topt.momentum(0.1, 0.9),
                          torch.zeros(tspace.flat_elems), device="cpu",
                          num_workers=K)

    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        site_a()
        site_a()
        site_a()
    dep = _deprecations(rec)
    assert len(dep) == 1, "one site, three calls: exactly one warning"
    assert "docs/api.md" in str(dep[0].message)
    # a *different* call site warns again, even in the same process
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        PBoxFabric(tspace, topt.momentum(0.1, 0.9),
                   torch.zeros(tspace.flat_elems), device="cpu",
                   num_workers=K)
    assert len(_deprecations(rec)) == 1


def test_config_path_never_warns():
    _, tspace, _ = make_setup()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        port_fabric(tspace, config=FabricConfig(num_workers=K))
    assert not [w for w in rec if issubclass(w.category, DeprecationWarning)]


def test_config_and_legacy_kwargs_are_mutually_exclusive():
    _, tspace, _ = make_setup()
    with pytest.raises(TypeError, match="not.*both"):
        port_fabric(tspace, config=FabricConfig(num_workers=K),
                    num_shards=2)


def test_unknown_legacy_kwarg_is_a_typeerror():
    with pytest.raises(TypeError, match="unknown PBoxFabric argument"):
        FabricConfig.from_legacy_kwargs(compresion=CompressionConfig())


@pytest.mark.parametrize("name", ["use_pallas", "fused_wire_path"])
def test_route_knobs_accept_only_the_jax_default(name):
    """The JAX route knobs have no field: ``True`` (their default) builds
    the same config as leaving them out; anything else says why not."""
    assert FabricConfig.from_legacy_kwargs(**{name: True}, num_workers=K) \
        == FabricConfig.from_legacy_kwargs(num_workers=K)
    for value in (False, 0, None):
        with pytest.raises(TypeError, match="device picks") as ei:
            FabricConfig.from_legacy_kwargs(**{name: value})
        assert "same bits" in str(ei.value) and name in str(ei.value)


# ---------------------------------------------------------------------------
# the migration table is faithful
# ---------------------------------------------------------------------------
def _resolve(cfg, path):
    obj = cfg
    for part in path.split("."):
        obj = getattr(obj, part)
    return obj


def test_every_legacy_kwarg_lands_at_its_documented_path():
    assert set(LEGACY_KWARGS) == set(jconfig.LEGACY_KWARGS), (
        "the port accepts exactly the JAX package's legacy keywords")
    sentinels = {
        "num_shards": 3, "mode": "stale", "staleness": 2, "num_workers": 7,
        "min_push_fraction": 0.5, "use_pallas": True, "namespace": "ns",
        "chunk_base": 4, "topology": object(), "compression": object(),
        "link": object(), "fused_wire_path": True, "replication": 2,
        "fault_plan": object(), "placement": "round_robin",
        "plan": object(),
    }
    assert set(sentinels) == set(LEGACY_KWARGS)
    cfg = FabricConfig.from_legacy_kwargs(**sentinels)
    jcfg = jconfig.FabricConfig.from_legacy_kwargs(**sentinels)
    for kw, path in LEGACY_KWARGS.items():
        if path is None:  # no field in the port
            assert jconfig.LEGACY_KWARGS[kw] is not None
            continue
        assert path == jconfig.LEGACY_KWARGS[kw]
        assert _resolve(cfg, path) is sentinels[kw] or \
            _resolve(cfg, path) == sentinels[kw], (
                f"legacy {kw!r} did not land at config path {path!r}")
        assert _resolve(cfg, path) is _resolve(jcfg, path) or \
            _resolve(cfg, path) == _resolve(jcfg, path)


# ---------------------------------------------------------------------------
# named validation, before any state exists
# ---------------------------------------------------------------------------
RULES = [
    (dict(mode="turbo"), "mode"),
    (dict(num_shards=0), "num_shards"),
    (dict(num_workers=0), "num_workers"),
    (dict(mode="stale", staleness=-1), "staleness"),
    (dict(min_push_fraction=0.0), "min_push_fraction"),
    (dict(chunk_base=-1), "chunk_base"),
    (dict(placement=("policy", "best")), "placement_policy"),
    (dict(num_workers=2, wire=("topology", (4, 2))), "topology_workers"),
    (dict(faults=("replication", 0)), "replication"),
    (dict(faults=("replication", 2), anti_affine=True), "anti_affine"),
    (dict(wire=("switch", dict(enabled=True))), "switch_slots"),
    (dict(wire=("switch", dict(enabled=False, core_slots=-1))),
     "switch_slots"),
]


def _build_cfg(m, fields):
    """``m``'s (either package's config module) FabricConfig of a rule
    case; ``topo`` builds the package's topology."""
    topo = JaxTopology if m is jconfig else NetworkTopology
    kw = dict(fields)
    anti = kw.pop("anti_affine", False)
    if "placement" in kw:
        kw["placement"] = m.PlacementConfig(**dict([kw["placement"]]))
    if "faults" in kw:
        kw["faults"] = m.FaultConfig(**dict([kw["faults"]]),
                                     anti_affine=anti)
    if "wire" in kw:
        key, val = kw["wire"]
        if key == "topology":
            kw["wire"] = m.WireConfig(topology=topo(num_workers=val[0],
                                                    num_racks=val[1]))
        else:
            kw["wire"] = m.WireConfig(switch=m.SwitchConfig(**val))
    return m.FabricConfig(**kw)


@pytest.mark.parametrize("fields,rule", RULES,
                         ids=[f"{r}{i}" for i, (_, r) in enumerate(RULES)])
def test_validation_rules_are_named(fields, rule):
    with pytest.raises(FabricConfigError, match=rf"\[{rule}\]") as ei:
        _build_cfg(tconfig, fields).validate()
    with pytest.raises(jconfig.FabricConfigError) as ej:
        _build_cfg(jconfig, fields).validate()
    assert ei.value.rule == ej.value.rule == rule
    assert str(ei.value) == str(ej.value)


def test_invalid_config_fails_before_any_fabric_state():
    _, tspace, _ = make_setup()
    bad = FabricConfig(num_workers=K, mode="turbo")
    with pytest.raises(FabricConfigError, match=r"\[mode\]"):
        port_fabric(tspace, config=bad)
    # the legacy path hits the same validator
    with pytest.raises(FabricConfigError, match=r"\[mode\]"):
        quiet_legacy(port_fabric, tspace, num_workers=K, mode="turbo")


def test_valid_config_round_trips_validate():
    cfg = FabricConfig(num_shards=2, num_workers=K, namespace="job",
                       chunk_base=12)
    assert cfg.validate() is cfg
    assert dataclasses.is_dataclass(cfg) and cfg == FabricConfig(
        num_shards=2, num_workers=K, namespace="job", chunk_base=12)


# ---------------------------------------------------------------------------
# describe round-trip
# ---------------------------------------------------------------------------
def test_describe_names_the_whole_construction_surface():
    _, tspace, grads = make_setup()
    cfg = FabricConfig(
        num_shards=2, num_workers=K, mode="stale", staleness=1,
        namespace="t0", chunk_base=6,
        wire=WireConfig(
            topology=NetworkTopology(num_workers=K, num_racks=2),
            compression=CompressionConfig(codec="int8"),
            switch=SwitchConfig(enabled=True, tor_slots=8, core_slots=8)),
        faults=FaultConfig(replication=2))
    fab = drive(port_fabric(tspace, config=cfg), grads)
    text = cfg.describe()
    for token in ("shards=2", "mode=stale", "codec=int8", "racks=2",
                  "tor_slots=8", "core_slots=8", "replication=2",
                  "ns=t0@6"):
        assert token in text, f"describe() lost {token}"
    fab_text = fab.describe()
    assert fab_text.startswith("[t0] PBoxFabric: 2 shards x ")
    for line in text.splitlines():
        assert line.strip() in fab_text


# ---------------------------------------------------------------------------
# the serving surface: ServeConfig and its legacy adapters
# ---------------------------------------------------------------------------
def snapshot_plane(**kw):
    """The lightest ReadPlane: a static snapshot source on the CPU, no
    fabric (construction-surface tests only need the adapter)."""
    from repro_torch.core.serving import ReadPlane, SnapshotSource

    return ReadPlane(SnapshotSource(np.zeros(TILE_ELEMS, np.float32),
                                    device="cpu"), **kw)


def test_serve_config_equivalent_to_legacy_kwargs():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        legacy = snapshot_plane(max_staleness=3, num_frontends=2,
                                name="edge", priority=2.0,
                                bandwidth_cap=0.5, serve_us_per_read=0.1)
    cfg = snapshot_plane(config=tconfig.ServeConfig(
        max_staleness=3, num_frontends=2, name="edge", priority=2.0,
        bandwidth_cap=0.5, serve_us_per_read=0.1))
    assert legacy.config == cfg.config
    assert tconfig.SERVE_LEGACY_KWARGS == jconfig.SERVE_LEGACY_KWARGS
    assert tconfig.SPARSE_SERVE_LEGACY_KWARGS == \
        jconfig.SPARSE_SERVE_LEGACY_KWARGS
    sentinels = {"max_staleness": 3, "num_frontends": 2, "name": "edge",
                 "priority": 2.0, "bandwidth_cap": 0.5,
                 "serve_us_per_read": 0.1}
    assert set(sentinels) == set(tconfig.SERVE_LEGACY_KWARGS)
    built = tconfig.ServeConfig.from_legacy_kwargs(**sentinels)
    for kw, path in tconfig.SERVE_LEGACY_KWARGS.items():
        assert _resolve(built, path) == sentinels[kw]
    assert dataclasses.astuple(built) == dataclasses.astuple(
        jconfig.ServeConfig.from_legacy_kwargs(**sentinels))
    sparse_sentinels = {"num_frontends": 4, "cache_rows": 99,
                        "name": "rows", "serve_us_per_read": 0.2}
    sparse = tconfig.ServeConfig.from_sparse_legacy_kwargs(
        **sparse_sentinels)
    for kw, path in tconfig.SPARSE_SERVE_LEGACY_KWARGS.items():
        assert _resolve(sparse, path) == sparse_sentinels[kw]
    assert dataclasses.astuple(sparse) == dataclasses.astuple(
        jconfig.ServeConfig.from_sparse_legacy_kwargs(**sparse_sentinels))
    assert tconfig.ServeConfig.from_sparse_legacy_kwargs().name == \
        "sparse-serve"
    assert tconfig.ServeConfig.from_legacy_kwargs().name == "serve"


def test_serve_legacy_kwargs_warn_once_per_site_config_never():
    from repro_torch.core.serving import ReadPlane, SnapshotSource

    flat = np.zeros(TILE_ELEMS, np.float32)

    def site():
        return ReadPlane(SnapshotSource(flat, device="cpu"), max_staleness=1)

    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        site()
        site()
    dep = [w for w in rec if issubclass(w.category, DeprecationWarning)
           and "ServeConfig" in str(w.message)]
    assert len(dep) == 1, "one site, two calls: exactly one warning"
    assert "ReadPlane" in str(dep[0].message)
    assert "docs/api.md" in str(dep[0].message)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        snapshot_plane(config=tconfig.ServeConfig(max_staleness=1))
        snapshot_plane()
    assert not [w for w in rec if issubclass(w.category, DeprecationWarning)]
    for call, jcall in (
            (lambda: tconfig.ServeConfig.from_legacy_kwargs(staleness=1),
             lambda: jconfig.ServeConfig.from_legacy_kwargs(staleness=1)),
            (lambda: tconfig.ServeConfig.from_sparse_legacy_kwargs(
                max_staleness=1),
             lambda: jconfig.ServeConfig.from_sparse_legacy_kwargs(
                 max_staleness=1))):
        with pytest.raises(TypeError) as e:
            call()
        with pytest.raises(TypeError) as je:
            jcall()
        assert str(e.value) == str(je.value)
    with pytest.raises(TypeError, match="not.*both"):
        snapshot_plane(config=tconfig.ServeConfig(), max_staleness=1)


def _hier(m, **kw):
    return m.HierarchyConfig(enabled=True, **kw)


SERVE_RULES = [
    (lambda m: m.ServeConfig(num_frontends=0), "serve_frontends"),
    (lambda m: m.ServeConfig(max_staleness=-1), "serve_staleness"),
    (lambda m: m.ServeConfig(priority=0.0), "serve_priority"),
    (lambda m: m.ServeConfig(bandwidth_cap=1.5), "serve_bandwidth_cap"),
    (lambda m: m.ServeConfig(serve_us_per_read=-0.1), "serve_cost"),
    (lambda m: m.ServeConfig(cache_rows=0), "serve_cache_rows"),
    (lambda m: m.ServeConfig(slos=(("", m.SLOConfig()),)), "slo_tenant"),
    (lambda m: m.ServeConfig(slos=(("a", m.SLOConfig()),
                                   ("a", m.SLOConfig()))), "slo_tenant"),
    (lambda m: m.ServeConfig(slos=(("a", m.SLOConfig(
        latency_budget_us=0.0)),)), "slo_budget"),
    (lambda m: m.ServeConfig(slos=(("a", m.SLOConfig(
        staleness_bound=-1)),)), "slo_staleness"),
    (lambda m: m.ServeConfig(slos=(("a", m.SLOConfig(priority=0.0)),)),
     "slo_priority"),
    (lambda m: m.ServeConfig(admission=m.AdmissionConfig(
        enabled=True, rate_per_us=0.0)), "admission_rate"),
    (lambda m: m.ServeConfig(admission=m.AdmissionConfig(
        enabled=True, burst=0)), "admission_burst"),
    (lambda m: m.ServeConfig(admission=m.AdmissionConfig(
        enabled=True, shed_slack=0.0)), "admission_slack"),
    (lambda m: m.ServeConfig(hierarchy=_hier(
        m, staleness_ladder=(0,), frontends_per_tier=(1,))),
     "hierarchy_ladder"),
    (lambda m: m.ServeConfig(hierarchy=_hier(
        m, staleness_ladder=(1, 4), frontends_per_tier=(1, 1))),
     "hierarchy_ladder"),
    (lambda m: m.ServeConfig(hierarchy=_hier(
        m, staleness_ladder=(0, 4, 4), frontends_per_tier=(1, 1, 1))),
     "hierarchy_ladder"),
    (lambda m: m.ServeConfig(hierarchy=_hier(
        m, staleness_ladder=(0, 4), frontends_per_tier=(1,))),
     "hierarchy_frontends"),
    (lambda m: m.ServeConfig(hierarchy=_hier(
        m, staleness_ladder=(0, 4), frontends_per_tier=(1, 0))),
     "hierarchy_frontends"),
    (lambda m: m.ServeConfig(hierarchy=_hier(
        m, staleness_ladder=(0, 4), frontends_per_tier=(1, 1),
        geo_oversubscription=0.5)), "hierarchy_geo"),
]


@pytest.mark.parametrize("build,rule", SERVE_RULES,
                         ids=[f"{r}{i}" for i, (_, r) in
                              enumerate(SERVE_RULES)])
def test_serve_validation_rules_are_named(build, rule):
    cfg = build(tconfig)
    with pytest.raises(FabricConfigError, match=rf"\[{rule}\]") as ei:
        cfg.validate()
    with pytest.raises(jconfig.FabricConfigError) as ej:
        build(jconfig).validate()
    assert ei.value.rule == ej.value.rule == rule
    assert str(ei.value) == str(ej.value)
    with pytest.raises(FabricConfigError):
        snapshot_plane(config=cfg)
    relaxed = dataclasses.replace(
        cfg,
        admission=dataclasses.replace(cfg.admission, enabled=False),
        hierarchy=dataclasses.replace(cfg.hierarchy, enabled=False))
    if rule.startswith(("admission", "hierarchy")):
        assert relaxed.validate() is relaxed


def test_serve_describe_round_trips_the_surface():
    def build(m):
        return m.ServeConfig(
            num_frontends=2, max_staleness=3, name="edge",
            bandwidth_cap=0.25,
            slos=(("rt", m.SLOConfig(latency_budget_us=120.0,
                                     priority=2.0)),),
            admission=m.AdmissionConfig(enabled=True, rate_per_us=1.5,
                                        burst=6, shed_slack=0.4),
            hierarchy=m.HierarchyConfig(enabled=True,
                                        staleness_ladder=(0, 2, 8),
                                        frontends_per_tier=(1, 1, 2)))

    text = build(tconfig).validate().describe()
    assert text == build(jconfig).validate().describe()
    for token in ("edge", "frontends=2", "stale<=3", "cap=0.25",
                  "rt(<120us", "1.5/us burst=6", "ladder=0/2/8",
                  "frontends=1/1/2", "geo=1:8"):
        assert token in text, f"describe() lost {token}"


def test_workload_config_describes_and_validates_like_jax():
    """The workload surface (its rules are held one by one, message for
    message, in test_torch_workload.py): describe() equal for a mix of
    every arrival shape and loop kind."""
    def build(m):
        return m.WorkloadConfig(tenants=(
            m.TenantLoadConfig(name="o", n_requests=5,
                               diurnal=m.DiurnalConfig(enabled=True),
                               flash=m.FlashCrowdConfig(enabled=True)),
            m.TenantLoadConfig(name="p", n_requests=3, batch_max=2,
                               arrival=m.ArrivalConfig(process="mmpp")),
            m.TenantLoadConfig(name="c", clients=2, think_us=4.0,
                               requests_per_client=3, staleness_req=2),
        ))

    cfg = build(tconfig)
    assert cfg.validate() is cfg
    assert cfg.describe() == build(jconfig).validate().describe()
    assert dataclasses.astuple(cfg) == dataclasses.astuple(build(jconfig))
