"""The port's ``PHubServer`` (a 1-shard fabric) with the semantics of
tests/test_server.py: sync == DP-SGD, async progress, the SSP bound, the
backup quorum, snapshot/restore and the straggler monitor."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.chunking import ParamSpace  # noqa: E402
from repro_torch.core.server import PHubServer, WorkerHarness  # noqa: E402
from repro_torch.optim.optimizers import (  # noqa: E402
    apply_update,
    init_opt_state,
    momentum,
    sgd,
)
from repro_torch.runtime.straggler import StragglerMonitor, rebalance_chunks  # noqa: E402

K = 4


def quad_setup():
    """Workers minimize ||w - target_w||^2 on per-worker targets."""
    params = {"w": torch.zeros(300), "b": torch.zeros(7)}
    targets = [{"w": torch.full((300,), float(i + 1)),
                "b": torch.arange(7.0) * (i + 1)} for i in range(K)]

    def grad_fn(p, batch):
        t = targets[batch]
        return {k: 2 * (p[k] - t[k]) for k in p}

    return params, targets, grad_fn


def _server(spec, **kw):
    params, targets, grad_fn = quad_setup()
    space = ParamSpace.build(params, num_owners=1)
    srv = PHubServer(space, spec, space.flatten(params), num_workers=K,
                     device="cpu", **kw)
    return srv, space, params, grad_fn


def test_sync_matches_reference_dp():
    spec = momentum(0.05, 0.9)
    srv, space, params, grad_fn = _server(spec, mode="sync")
    WorkerHarness(srv, grad_fn, lambda w, s: w).run(5)
    out = space.unflatten(srv.params)
    ref_p = dict(params)
    st = {k: init_opt_state(spec, v) for k, v in ref_p.items()}
    for step in range(1, 6):
        gs = [grad_fn(ref_p, w) for w in range(K)]
        for k in ref_p:
            g = sum(g[k] for g in gs) / K
            ref_p[k], st[k] = apply_update(spec, ref_p[k], g, st[k], step)
    for k in params:
        np.testing.assert_allclose(out[k].numpy(), ref_p[k].numpy(),
                                   rtol=1e-5, atol=1e-6)


def test_async_progresses_and_converges_direction():
    srv, space, _, grad_fn = _server(sgd(0.02), mode="async")
    WorkerHarness(srv, grad_fn, lambda w, s: w, speed=[1, 1, 1, 3]).run(10)
    out = space.unflatten(srv.params)
    # mean target is 2.5 for w; async SGD should move toward it
    assert 0.5 < float(out["w"].mean()) < 4.5
    assert srv.stats.steps >= 10


def test_ssp_staleness_bound_enforced():
    srv, _, _, grad_fn = _server(sgd(0.01), mode="stale", staleness=2)
    h = WorkerHarness(srv, grad_fn, lambda w, s: w, speed=[1, 1, 1, 4])
    max_gap = 0
    for _ in range(60):
        h.tick()
        max_gap = max(max_gap, srv.worker_clock.max() - srv.worker_clock.min())
    assert max_gap <= 2 + 1, f"staleness bound violated: {max_gap}"


def test_backup_worker_quorum():
    srv, space, params, grad_fn = _server(sgd(0.01), mode="sync",
                                          min_push_fraction=0.75)
    for w in range(3):  # only 3 of 4 workers push
        srv.push(w, space.flatten(grad_fn(params, w)))
    assert srv.stats.steps == 1
    assert srv.stats.partial_aggregations == 1


def test_snapshot_restore():
    srv, _, _, grad_fn = _server(momentum(0.05, 0.9))
    WorkerHarness(srv, grad_fn, lambda w, s: w).run(3)
    snap = srv.snapshot()
    WorkerHarness(srv, grad_fn, lambda w, s: w).run(5)
    after8 = srv.params.clone()
    srv.restore(snap)
    assert srv.step == snap["step"]
    WorkerHarness(srv, grad_fn, lambda w, s: w).run(5)
    assert torch.equal(srv.params, after8)


def test_straggler_monitor_and_rebalance():
    mon = StragglerMonitor(4, threshold=2.0)
    for _ in range(10):
        for w, lat in enumerate([0.1, 0.1, 0.1, 0.9]):
            mon.record(w, lat)
    assert mon.stragglers() == [3]
    owner = np.repeat(np.arange(4), 8)  # 32 chunks, balanced
    new = rebalance_chunks(owner, [3], 4)
    assert not np.isin(new, [3]).any()
    counts = np.bincount(new, minlength=4)[:3]
    assert counts.max() - counts.min() <= 1
