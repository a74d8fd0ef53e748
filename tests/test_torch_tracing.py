"""The port's own spans and counters (``repro_torch.tracing``): under a CPU
``torch.profiler`` a fabric round and a world-1 SPMD step emit their
``ps.*`` spans nested as the layers nest; with no profiler no
``record_function`` is entered; the GC hook counts collections; the
exchange books the bytes it hands to each collective; and tracing changes
no bit of what either path computes."""
import gc
import json

import pytest
import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile

from repro_torch import tracing
from repro_torch.core.chunking import ParamSpace
from repro_torch.core.compression import CompressionConfig
from repro_torch.core.config import FabricConfig, WireConfig
from repro_torch.core.exchange import ExchangeConfig, PSExchange
from repro_torch.core.fabric import PBoxFabric, WorkerHarness
from repro_torch.launch.mesh import init_process_group, make_mesh
from repro_torch.models.common import Dist
from repro_torch.optim import optimizers as O
from repro_torch.runtime.trainer import (
    init_train_state,
    local_state,
    make_ps_train_step,
)

CHUNK = 4096  # a whole int8 granule of the fused wire
WORKERS = 2


def _spans(prof, tmp_path) -> list:
    """The trace's ``ps.*`` ranges: (start, end, name, thread)."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [(e["ts"], e["ts"] + e["dur"], e["name"], e["tid"])
            for e in events if e.get("ph") == "X"
            and e.get("cat") == "user_annotation"
            and e["name"].startswith("ps.")]


def _inside(spans, child: str, parent: str) -> bool:
    """Every ``child`` span lies inside a ``parent`` span of its thread."""
    kids = [s for s in spans if s[2] == child]
    return bool(kids) and all(
        any(p[2] == parent and p[3] == k[3] and p[0] <= k[0] and k[1] <= p[1]
            for p in spans)
        for k in kids)


# ---------------------------------------------------------------------------
# the fabric: 2 workers, int8 on the fused wire
# ---------------------------------------------------------------------------

def _fabric(codec="int8"):
    gen = torch.Generator().manual_seed(0)
    params = {"w": torch.randn(9000, generator=gen),
              "b": torch.randn(77, generator=gen)}
    targets = [{k: torch.randn(v.shape, generator=gen) for k, v in
                params.items()} for _ in range(WORKERS)]
    space = ParamSpace.build(params, chunk_elems=CHUNK)
    fab = PBoxFabric(space, O.adamw(3e-3), space.flatten(params),
                     config=FabricConfig(
                         num_shards=2, num_workers=WORKERS,
                         wire=WireConfig(compression=CompressionConfig(
                             codec=codec))),
                     device="cpu")

    def grad_fn(p, w):
        return {k: 2 * (p[k] - targets[w][k]) for k in p}

    return fab, WorkerHarness(fab, grad_fn, lambda w, s: w)


def test_fabric_round_spans_nest(tmp_path):
    fab, harness = _fabric()
    assert fab._fused_wire
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        harness.run(1)
    spans = _spans(prof, tmp_path)
    names = {s[2] for s in spans}
    assert {"ps.pull", "ps.unflatten", "ps.worker_grad", "ps.flatten",
            "ps.push", "ps.encode", "ps.aggregate",
            "ps.shard_apply"} <= names
    assert sum(s[2] == "ps.push" for s in spans) == WORKERS
    assert sum(s[2] == "ps.encode" for s in spans) == WORKERS
    # the last push fires the round: each shard's update inside it
    assert sum(s[2] == "ps.shard_apply" for s in spans) == 2
    assert _inside(spans, "ps.encode", "ps.push")
    assert _inside(spans, "ps.aggregate", "ps.push")
    assert _inside(spans, "ps.shard_apply", "ps.aggregate")


def test_fabric_f32_push_has_no_encode_span(tmp_path):
    fab, harness = _fabric("none")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        harness.run(1)
    names = {s[2] for s in _spans(prof, tmp_path)}
    assert "ps.push" in names and "ps.encode" not in names


@pytest.mark.parametrize("codec", ["none", "int8"])
def test_fabric_bits_same_with_profiler_on(codec):
    fab_a, harness_a = _fabric(codec)
    harness_a.run(3)
    fab_b, harness_b = _fabric(codec)
    with profile(activities=[ProfilerActivity.CPU]):
        harness_b.run(3)
    assert torch.equal(fab_a.params.view(torch.int32),
                       fab_b.params.view(torch.int32))
    assert fab_a.stats == fab_b.stats


# ---------------------------------------------------------------------------
# the SPMD step, world 1 over gloo
# ---------------------------------------------------------------------------

def _loss(p, batch, d):
    err = (p["w"] * batch["x"]).sum(-1) - batch["y"]
    loss = err.pow(2).mean() + p["b"].pow(2).sum() * 1e-3
    return loss, {"w_norm": p["w"].pow(2).sum()}


@pytest.fixture
def world_one(tmp_path):
    init_process_group("cpu", init_method=f"file://{tmp_path}/rendezvous")
    try:
        yield make_mesh((1, 1), ("data", "model"))
    finally:
        dist.destroy_process_group()


def _step(mesh, strategy="pbox"):
    gen = torch.Generator().manual_seed(1)
    params = {"w": torch.randn(40, 30, generator=gen),
              "b": torch.randn(100, generator=gen)}
    batch = {"x": torch.randn(40, 30, generator=gen),
             "y": torch.randn(40, generator=gen)}
    ex = PSExchange(O.momentum(0.1, 0.9), ExchangeConfig(strategy=strategy),
                    ("data",))
    step, space, _, ng = make_ps_train_step(
        mesh, loss_fn=_loss, global_param_template=params, exchange=ex,
        dist=Dist(model_axis="model", data_axes=("data",), tp=1, mesh=mesh),
        sync_tags={"w": "none", "b": "scale_2"})
    state = init_train_state(mesh, init_params_fn=lambda _: params,
                             exchange=ex, space=space, n_groups=ng, key=None,
                             device="cpu")
    return step, space, ex, list(local_state(state, mesh, ex)), batch


def _run(step, st, batch, steps=2):
    for _ in range(steps):
        *st, met = step(*st, batch)
    return st, met


def test_step_spans_nest(world_one, tmp_path):
    step, _, _, st, batch = _step(world_one)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _run(step, st, batch, 1)
    spans = _spans(prof, tmp_path)
    for name in ("ps.forward", "ps.backward", "ps.grad_sync", "ps.exchange",
                 "ps.reduce_scatter", "ps.shard_apply", "ps.all_gather",
                 "ps.metrics", "ps.flatten", "ps.unflatten"):
        assert sum(s[2] == name for s in spans) == 1, name
    assert _inside(spans, "ps.reduce_scatter", "ps.exchange")
    assert _inside(spans, "ps.shard_apply", "ps.exchange")
    assert _inside(spans, "ps.all_gather", "ps.exchange")
    assert _inside(spans, "ps.flatten", "ps.grad_sync")
    order = [s[2] for s in sorted(spans) if s[2] in (
        "ps.forward", "ps.backward", "ps.grad_sync", "ps.exchange",
        "ps.metrics")]
    assert order == ["ps.forward", "ps.backward", "ps.grad_sync",
                     "ps.exchange", "ps.metrics"]


def test_allreduce_step_has_one_all_reduce(world_one, tmp_path):
    step, _, _, st, batch = _step(world_one, "allreduce")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _run(step, st, batch, 1)
    spans = _spans(prof, tmp_path)
    assert sum(s[2] == "ps.all_reduce" for s in spans) == 1
    assert not {"ps.reduce_scatter", "ps.all_gather"} & {s[2] for s in spans}
    assert _inside(spans, "ps.shard_apply", "ps.exchange")


@pytest.mark.parametrize("strategy, calls", [
    ("pbox", {"reduce_scatter": 1, "all_gather": 1}),
    ("allreduce", {"all_reduce": 1}),
])
def test_exchange_books_collective_bytes(world_one, strategy, calls):
    """pbox hands the reduce-scatter the flat gradient and gets the flat
    back from the all-gather (2 x 4 bytes an element at world 1);
    allreduce hands one all-reduce the flat gradient."""
    step, space, ex, st, batch = _step(world_one, strategy)
    _run(step, st, batch, 3)
    assert ex.stats.rounds == 3
    assert ex.stats.collective_calls == {k: 3 * n for k, n in calls.items()}
    per_round = 4 * space.flat_elems
    assert ex.stats.collective_bytes == {k: 3 * per_round for k in calls}
    assert sum(ex.stats.collective_bytes.values()) == (
        3 * len(calls) * per_round)


def test_step_bits_same_with_profiler_on(world_one):
    step, _, _, st, batch = _step(world_one)
    out_a, met_a = _run(step, st, batch)
    step, _, _, st, batch = _step(world_one)
    with profile(activities=[ProfilerActivity.CPU]):
        out_b, met_b = _run(step, st, batch)
    for a, b in zip(out_a, out_b):
        if isinstance(a, tuple):
            assert all(torch.equal(x, y) for x, y in zip(a, b))
        elif a is None:
            assert b is None
        else:
            assert torch.equal(a, b)
    assert torch.equal(met_a["loss"], met_b["loss"])


# ---------------------------------------------------------------------------
# off: no record_function; the GC hook
# ---------------------------------------------------------------------------

def test_no_profiler_enters_no_record_function(world_one, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    fab, harness = _fabric()
    harness.run(2)
    step, _, _, st, batch = _step(world_one)
    _run(step, st, batch)
    gc.collect()
    with tracing.span("ps.x"):
        pass
    assert tracing.span("ps.y")(lambda v: v + 1)(1) == 2


def test_span_is_a_range_under_a_profiler(tmp_path):
    @tracing.span("ps.decorated")
    def f():
        with tracing.span("ps.inner"):
            return torch.ones(3) + 1

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        f()
    spans = _spans(prof, tmp_path)
    assert _inside(spans, "ps.inner", "ps.decorated")


def test_gc_hook_counts_collections(tmp_path):
    before = tracing.counters()
    gc.collect()
    after = tracing.counters()
    assert after["gc_collections"] >= before["gc_collections"] + 1
    assert after["gc_collections.2"] >= before["gc_collections.2"] + 1
    assert after["gc_ms"] > before["gc_ms"]
    # a snapshot, not the live dict
    after["gc_ms"] = -1.0
    assert tracing.counters()["gc_ms"] >= 0
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        gc.collect()
    assert any(s[2] == "ps.gc" for s in _spans(prof, tmp_path))

