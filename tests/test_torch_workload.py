"""The port's workload tier (``repro_torch.core.workload``) against the JAX
one.

Mirrors tests/test_workload.py case for case.  The module is numpy only in
both packages, so each case builds the same ``WorkloadConfig`` in either
package and holds ``generate_trace(config, seed)`` equal draw for draw:
``to_json()`` equal as a document (every arrival time, batch hint and
staleness requirement, every think time), the closed-loop clients' issue
times equal, every validation rule's ``FabricConfigError`` equal in name
and message; then the JAX test's own assertions run on the port's traces.
"""
import math

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core import config as jconfig  # noqa: E402
from repro.core import workload as jworkload  # noqa: E402
from repro_torch.core import config as tconfig  # noqa: E402
from repro_torch.core import workload as tworkload  # noqa: E402
from repro_torch.core.config import (  # noqa: E402
    ArrivalConfig,
    DiurnalConfig,
    FabricConfigError,
    FlashCrowdConfig,
    TenantLoadConfig,
    WorkloadConfig,
)
from repro_torch.core.workload import (  # noqa: E402
    Request,
    WorkloadTrace,
    generate_trace,
    rate_factor,
)

PKGS = ((jconfig, jworkload), (tconfig, tworkload))


def open_tenant(c, name="load", n=20, gap=3.0, **kw):
    return c.TenantLoadConfig(
        name=name, arrival=c.ArrivalConfig(process="open", interarrival_us=gap),
        n_requests=n, **kw)


def traces(build, seed):
    """``generate_trace(build(config module), seed)`` in both packages,
    held equal as JSON documents; returns the port's trace."""
    jt, tt = (wl.generate_trace(build(c), seed) for c, wl in PKGS)
    assert tt.to_json() == jt.to_json()
    assert tt.describe() == jt.describe()
    assert len(tt) == len(jt) and tt.duration_us == jt.duration_us
    return tt


# ---------------------------------------------------------------------------
# determinism + replay
# ---------------------------------------------------------------------------
def _mixed(c):
    return c.WorkloadConfig(tenants=(
        c.TenantLoadConfig(name="p", n_requests=30,
                           arrival=c.ArrivalConfig(process="poisson",
                                                   interarrival_us=5.0)),
        c.TenantLoadConfig(name="m", n_requests=30,
                           arrival=c.ArrivalConfig(process="mmpp",
                                                   interarrival_us=5.0,
                                                   burst_factor=4.0,
                                                   burst_dwell_us=50.0)),
        c.TenantLoadConfig(name="c", clients=3, think_us=7.0,
                           requests_per_client=5),
    ))


def test_same_config_same_seed_same_trace():
    a, b = traces(_mixed, 42), traces(_mixed, 42)
    assert a.requests == b.requests
    for k in a.think:
        np.testing.assert_array_equal(a.think[k], b.think[k])
    assert a.requests != traces(_mixed, 43).requests
    assert _mixed(tconfig).describe() == _mixed(jconfig).describe()


def test_per_tenant_seeding_is_isolated():
    def base(c):
        return (c.TenantLoadConfig(name="p", n_requests=25,
                                   arrival=c.ArrivalConfig(
                                       process="poisson",
                                       interarrival_us=4.0)),)

    def extra(c):
        return base(c) + (c.TenantLoadConfig(name="q", n_requests=25,
                                             arrival=c.ArrivalConfig(
                                                 process="poisson",
                                                 interarrival_us=4.0)),)

    solo = traces(lambda c: c.WorkloadConfig(tenants=base(c)), 7)
    both = traces(lambda c: c.WorkloadConfig(tenants=extra(c)), 7)
    assert [r for r in both.requests if r.tenant == "p"] == list(solo.requests)
    p = [r.arrival_us for r in both.requests if r.tenant == "p"]
    q = [r.arrival_us for r in both.requests if r.tenant == "q"]
    assert p != q


def test_json_round_trip_is_exact():
    def build(c):
        return c.WorkloadConfig(tenants=(
            open_tenant(c, n=10, staleness_req=3),
            c.TenantLoadConfig(name="c", clients=2, think_us=5.0,
                               requests_per_client=4, staleness_req=8),
        ))

    trace = traces(build, 9)
    back = WorkloadTrace.from_json(trace.to_json())
    assert back.requests == trace.requests
    assert back.staleness_req == trace.staleness_req
    for k in trace.think:
        np.testing.assert_array_equal(back.think[k], trace.think[k])
    # each package reads the other's document
    jtrace = jworkload.generate_trace(build(jconfig), 9)
    assert WorkloadTrace.from_json(jtrace.to_json()).to_json() == \
        jtrace.to_json()
    assert jworkload.WorkloadTrace.from_json(trace.to_json()).to_json() == \
        trace.to_json()
    with pytest.raises(ValueError):
        WorkloadTrace.from_json({"schema": 2})


# ---------------------------------------------------------------------------
# arrival shapes
# ---------------------------------------------------------------------------
def test_unmodulated_open_is_the_legacy_schedule():
    trace = traces(lambda c: c.WorkloadConfig(tenants=(open_tenant(c),)), 0)
    for i, r in enumerate(trace.requests):
        assert r.arrival_us == i * 3.0
        assert r.tenant == "load" and r.n == 1


def test_diurnal_open_compresses_peak_spacing():
    def tenant(c):
        return open_tenant(c, n=40, gap=2.0, diurnal=c.DiurnalConfig(
            enabled=True, amplitude=0.5, period_us=100.0))

    t = tenant(tconfig)
    for at in (0.0, 12.5, 25.0, 60.1, 75.0):
        assert rate_factor(t, at) == jworkload.rate_factor(tenant(jconfig),
                                                           at)
    assert rate_factor(t, 25.0) == pytest.approx(1.5)
    assert rate_factor(t, 75.0) == pytest.approx(0.5)
    trace = traces(lambda c: c.WorkloadConfig(tenants=(tenant(c),)), 0)
    gaps = np.diff([r.arrival_us for r in trace.requests])
    assert gaps.min() == pytest.approx(2.0 / 1.5, rel=1e-3)
    assert gaps.max() > 2.0


def test_flash_crowd_floods_its_window():
    def flash(c):
        return c.FlashCrowdConfig(enabled=True, at_us=30.0, duration_us=30.0,
                                  magnitude=10.0)

    calm = traces(lambda c: c.WorkloadConfig(tenants=(
        open_tenant(c, n=60, gap=2.0),)), 0)
    flood = traces(lambda c: c.WorkloadConfig(tenants=(
        open_tenant(c, n=60, gap=2.0, flash=flash(c)),)), 0)

    def in_window(tr):
        return sum(1 for r in tr.requests if 30.0 <= r.arrival_us < 60.0)

    assert in_window(flood) > 2 * in_window(calm)
    assert flood.requests[0].arrival_us == 0.0
    cfg = open_tenant(tconfig, flash=flash(tconfig))
    assert rate_factor(cfg, 29.9) == 1.0
    assert rate_factor(cfg, 30.0) == 10.0
    assert rate_factor(cfg, 60.0) == 1.0


def test_poisson_matches_mean_and_mmpp_is_burstier():
    n = 4000
    pois = traces(lambda c: c.WorkloadConfig(tenants=(
        c.TenantLoadConfig(name="p", n_requests=n,
                           arrival=c.ArrivalConfig(process="poisson",
                                                   interarrival_us=5.0)),)),
        3)
    mmpp = traces(lambda c: c.WorkloadConfig(tenants=(
        c.TenantLoadConfig(name="m", n_requests=n,
                           arrival=c.ArrivalConfig(process="mmpp",
                                                   interarrival_us=5.0,
                                                   burst_factor=8.0,
                                                   burst_dwell_us=100.0)),)),
        3)
    pg = np.diff([r.arrival_us for r in pois.requests])
    mg = np.diff([r.arrival_us for r in mmpp.requests])
    assert np.mean(pg) == pytest.approx(5.0, rel=0.1)

    def cv(g):
        return np.std(g) / np.mean(g)

    assert cv(pg) == pytest.approx(1.0, abs=0.15)
    assert cv(mg) > cv(pg) + 0.2
    assert (pg > 0).all() and (mg > 0).all()


# ---------------------------------------------------------------------------
# closed-loop clients
# ---------------------------------------------------------------------------
def test_closed_loop_client_paces_off_completions():
    def build(c):
        return c.WorkloadConfig(tenants=(
            c.TenantLoadConfig(name="c", clients=2, think_us=10.0,
                               requests_per_client=3, staleness_req=4),))

    trace = traces(build, 5)
    jtrace = jworkload.generate_trace(build(jconfig), 5)
    assert len(trace.requests) == 0
    clients, jclients = trace.clients("c"), jtrace.clients("c")
    assert len(clients) == len(jclients) == 2
    for c, jc in zip(clients, jclients):
        issued = []
        for finish in (100.0, 130.0, 150.0):
            r, jr = c.issue(), jc.issue()
            assert r == Request(jr.arrival_us, jr.tenant, jr.n,
                                jr.staleness_req)
            issued.append(r)
            c.completed(finish)
            jc.completed(finish)
        assert c.done and jc.done
    c = trace.clients("c")[0]
    think = trace.think["c"][0]
    r0 = c.issue()
    assert r0.arrival_us == pytest.approx(float(think[0]))
    assert r0.tenant == "c" and r0.staleness_req == 4
    c.completed(100.0)
    assert c.issue().arrival_us == pytest.approx(100.0 + float(think[1]))
    c.completed(130.0)
    assert c.issue().arrival_us == pytest.approx(130.0 + float(think[2]))
    c.completed(150.0)
    assert c.done
    with pytest.raises(RuntimeError):
        c.issue()
    with pytest.raises(RuntimeError):
        c.completed(160.0)
    again = trace.clients("c")[0]
    assert again.issue().arrival_us == pytest.approx(float(think[0]))
    with pytest.raises(KeyError):
        trace.clients("nope")


def test_zero_think_clients_fire_back_to_back():
    trace = traces(lambda c: c.WorkloadConfig(tenants=(
        c.TenantLoadConfig(name="c", clients=1, think_us=0.0,
                           requests_per_client=3),)), 0)
    c = trace.clients("c")[0]
    assert c.issue().arrival_us == 0.0
    c.completed(7.0)
    assert c.issue().arrival_us == 7.0


# ---------------------------------------------------------------------------
# trace surface + validation
# ---------------------------------------------------------------------------
def test_trace_sorts_and_describes():
    def build(wl):
        return wl.WorkloadTrace([wl.Request(5.0, "b"), wl.Request(1.0, "a"),
                                 wl.Request(5.0, "a")])

    trace, jtrace = build(tworkload), build(jworkload)
    assert trace.to_json() == jtrace.to_json()
    assert trace.describe() == jtrace.describe()
    assert [r.arrival_us for r in trace.requests] == [1.0, 5.0, 5.0]
    assert [r.tenant for r in trace.requests] == ["a", "b", "a"]
    assert len(trace) == 3 and trace.duration_us == 5.0
    assert "3 open-loop arrivals" in trace.describe()
    assert WorkloadTrace().duration_us == 0.0
    with pytest.raises(TypeError):
        WorkloadTrace([object()])
    for args, kw in (((-1.0, "a"), {}), ((0.0, "a"), {"n": 0}),
                     ((0.0, "a"), {"staleness_req": -1})):
        with pytest.raises(ValueError) as e:
            Request(*args, **kw)
        with pytest.raises(ValueError) as je:
            jworkload.Request(*args, **kw)
        assert str(e.value) == str(je.value)


RULES = [
    (lambda c: c.WorkloadConfig(), "workload_tenants"),
    (lambda c: c.WorkloadConfig(tenants=(open_tenant(c, name=""),)),
     "tenant_name"),
    (lambda c: c.WorkloadConfig(tenants=(open_tenant(c), open_tenant(c))),
     "tenant_name"),
    (lambda c: c.WorkloadConfig(tenants=(c.TenantLoadConfig(
        arrival=c.ArrivalConfig(process="lognormal")),)), "arrival_process"),
    (lambda c: c.WorkloadConfig(tenants=(c.TenantLoadConfig(
        arrival=c.ArrivalConfig(interarrival_us=0.0)),)), "arrival_rate"),
    (lambda c: c.WorkloadConfig(tenants=(c.TenantLoadConfig(
        arrival=c.ArrivalConfig(process="mmpp", burst_factor=0.5)),)),
     "mmpp_shape"),
    (lambda c: c.WorkloadConfig(tenants=(open_tenant(
        c, diurnal=c.DiurnalConfig(enabled=True, amplitude=1.0)),)),
     "diurnal_amplitude"),
    (lambda c: c.WorkloadConfig(tenants=(open_tenant(
        c, diurnal=c.DiurnalConfig(enabled=True, period_us=0.0)),)),
     "diurnal_period"),
    (lambda c: c.WorkloadConfig(tenants=(open_tenant(
        c, flash=c.FlashCrowdConfig(enabled=True, magnitude=0.5)),)),
     "flash_shape"),
    (lambda c: c.WorkloadConfig(tenants=(open_tenant(c, batch_max=0),)),
     "batch_max"),
    (lambda c: c.WorkloadConfig(tenants=(open_tenant(c, staleness_req=-1),)),
     "staleness_req"),
    (lambda c: c.WorkloadConfig(tenants=(c.TenantLoadConfig(clients=-1),)),
     "closed_loop"),
    (lambda c: c.WorkloadConfig(tenants=(c.TenantLoadConfig(clients=1),)),
     "closed_loop"),
]


@pytest.mark.parametrize("build,rule", RULES,
                         ids=[f"{i}-{r}" for i, (_, r) in enumerate(RULES)])
def test_workload_validation_rules_are_named(build, rule):
    cfg = build(tconfig)
    with pytest.raises(FabricConfigError, match=rf"\[{rule}\]") as ei:
        cfg.validate()
    assert ei.value.rule == rule
    with pytest.raises(jconfig.FabricConfigError) as je:
        build(jconfig).validate()
    assert str(ei.value) == str(je.value)
    with pytest.raises(FabricConfigError):
        generate_trace(cfg, 0)


def test_valid_workload_round_trips_validate():
    cfg = WorkloadConfig(tenants=(TenantLoadConfig(
        name="load", arrival=ArrivalConfig(interarrival_us=3.0),
        n_requests=20, diurnal=DiurnalConfig(), flash=FlashCrowdConfig()),))
    assert cfg.validate() is cfg
    assert math.isfinite(generate_trace(cfg, 0).duration_us)
