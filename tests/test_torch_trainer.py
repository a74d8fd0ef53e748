"""The port's SPMD PS train step (``repro_torch.runtime.trainer``) against
the JAX trainer and a one-process reference.

Mirrors tests/scripts/grad_equivalence.py's data-parallel half (its TP
half, on a (2, 4) mesh, is tests/test_torch_tp_train.py): gemma3-1b's SMOKE
config, the JAX package's weights (through ``repro_torch.interop``), a
(2, 1) ("data", "model") mesh of 2 gloo ranks spawned once for the file
(``tests/torch_spmd.py``), each rank holding its half of the global batch.

  * Every ``TRAINER_CASES`` case (pbox and allreduce, SGD, momentum under a
    ``linear_warmup`` schedule with 2 and 3 microbatches, AdamW) against
    ``make_ps_train_step`` of the JAX package on a (2, 1) mesh in a
    subprocess: losses, params and every rank's slots at its owner index,
    to the bounds below (the two packages' forward and backward round
    differently: XLA's fused CPU kernels against eager torch).
  * The SGD cases against a one-process reference of 2 logical workers
    (each worker's gradient by ``lm_loss_and_grad``, their mean, the
    tree-wise ``make_optimizer``), at the script's atol 2e-6.
  * At world 1, ``pbox`` and ``allreduce`` end bitwise equal.
  * The flat gradient autograd gives through views of the flat equals
    ``space.flatten`` of the tree's gradients, zero padding included.
  * The telemetry cases of tests/test_fabric.py:237, tests/test_serving.py
    :387 and tests/test_topology.py:604, run on both packages and compared
    field by field.
"""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import torch_spmd as S  # noqa: E402

from repro.core.chunking import TILE_ELEMS  # noqa: E402
from repro.core.chunking import ParamSpace as JaxSpace  # noqa: E402
from repro.core.compression import wire_bytes as jax_wire_bytes  # noqa: E402
from repro.core.exchange import ExchangeConfig as JaxExchangeConfig  # noqa: E402
from repro.core.exchange import PSExchange as JaxExchange  # noqa: E402
from repro.core.fabric import ServerStats as JaxStats  # noqa: E402
from repro.core.serving import ReadPlane as JaxPlane  # noqa: E402
from repro.core.serving import SnapshotSource as JaxSource  # noqa: E402
from repro.core.topology import NetworkTopology as JaxTopology  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro.runtime.trainer import attach_telemetry as jax_attach  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.core.chunking import ParamSpace  # noqa: E402
from repro_torch.core.compression import wire_bytes  # noqa: E402
from repro_torch.core.exchange import ExchangeConfig, PSExchange  # noqa: E402
from repro_torch.core.fabric import ServerStats  # noqa: E402
from repro_torch.core.serving import ReadPlane, SnapshotSource  # noqa: E402
from repro_torch.core.topology import NetworkTopology  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402
from repro_torch.runtime.trainer import (  # noqa: E402
    attach_telemetry,
    tracked_params,
)

# port against JAX after 2 steps: SGD and momentum move a param by lr times
# a gradient that differs in its last f32 bits; AdamW's first steps move
# each param by ~lr whatever the gradient's size, so its bound is a tenth
# of lr (a gradient within rounding of 0 would need 2 x lr)
TOL = {"sgd": (1e-4, 1e-5), "momentum": (1e-4, 1e-5), "adamw": (0.0, 1e-4)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX side (its weights first) alongside the 2 ranks."""
    root = tmp_path_factory.mktemp("trainer")
    proc = S.start_jax("trainer", root)
    try:
        S.wait_for(root / "jax_params.npz")
        S.spawn(2, S.trainer_ranks, root)
    finally:
        S.finish_jax(proc)
    return root


def _params_np(root):
    return S._unflat(dict(np.load(root / "jax_params.npz")))


@pytest.mark.parametrize("name", list(S.TRAINER_CASES))
def test_trainer_matches_jax(runs, name):
    strategy, opt, *_ = S.TRAINER_CASES[name]
    rtol, atol = TOL[opt]
    j = dict(np.load(runs / f"{name}.npz"))
    for r in range(2):
        got = dict(np.load(runs / f"{name}_r{r}.npz"))
        np.testing.assert_allclose(got["losses"], j["losses"], rtol=1e-5)
        np.testing.assert_allclose(got["pflat"][0], j["pflat"][0],
                                   rtol=rtol, atol=atol)
        o = int(got["coords"][0]) if strategy == "pbox" else 0
        for i in range({"sgd": 0, "momentum": 1, "adamw": 2}[opt]):
            n = got[f"slot{i}"].shape[-1]
            np.testing.assert_allclose(
                got[f"slot{i}"][0], j[f"slot{i}"][0, o * n:(o + 1) * n],
                rtol=1e-3, atol=1e-6 if opt == "adamw" else 1e-4)


def _reference_two_workers(params_np, gb, steps):
    """grad_equivalence.py's reference: one process, 2 logical workers."""
    cfg = get_arch("gemma3-1b").smoke_config
    p = params_from_numpy(params_np, "cpu")
    init_fn, upd_fn = topt.make_optimizer(topt.sgd(1e-1))
    st = init_fn(p)
    toks, labs = S.lm_tokens(cfg.vocab, gb)
    h = gb // 2
    for _ in range(steps):
        gs = [T.lm_loss_and_grad(p, torch.from_numpy(toks[w * h:(w + 1) * h]),
                                 torch.from_numpy(labs[w * h:(w + 1) * h]),
                                 cfg)[1] for w in range(2)]
        g = jax.tree.map(lambda a, b: (a + b) / 2, gs[0], gs[1])
        p, st = upd_fn(p, g, st)
    return ParamSpace.build(p).flatten(p)


@pytest.mark.parametrize("name", ["pbox_sgd", "allreduce_sgd"])
def test_trainer_matches_one_process_reference(runs, name):
    ref = _reference_two_workers(_params_np(runs), S.TRAINER_CASES[name][4],
                                 S.TRAINER_STEPS).numpy()
    for r in range(2):
        got = dict(np.load(runs / f"{name}_r{r}.npz"))["pflat"][0]
        np.testing.assert_allclose(got, ref, rtol=0, atol=2e-6)


def test_world_one_pbox_equals_allreduce_bitwise(tmp_path):
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_process_group, make_mesh

    cfg = get_arch("gemma3-1b").smoke_config
    params_np = S._tree(T.init_params(cfg, torch.Generator().manual_seed(3)),
                        lambda t: t.numpy())
    toks, labs = S.lm_tokens(cfg.vocab, 2)
    batch = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labs)}
    init_process_group("cpu", init_method=f"file://{tmp_path}/rendezvous")
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        out = {}
        for strategy in ("pbox", "allreduce"):
            step, space, ex, pflat, slots, ef, stc = S.trainer_setup(
                mesh, (strategy, "adamw", 1, True, 2), params_np)
            for _ in range(2):
                pflat, slots, ef, stc, met = step(pflat, slots, ef, stc, batch)
            out[strategy] = (pflat, slots, float(met["loss"]))
    finally:
        dist.destroy_process_group()
    (pa, sa, la), (pb, sb, lb) = out["pbox"], out["allreduce"]
    assert torch.equal(pa, pb) and la == lb
    assert all(torch.equal(x, y) for x, y in zip(sa, sb))


def test_flat_gradient_through_views_equals_flatten():
    cfg = get_arch("gemma3-1b").smoke_config
    params = T.init_params(cfg, torch.Generator().manual_seed(1))
    space = ParamSpace.build(params, num_owners=4)
    assert space.padding_elems > 0
    toks, labs = (torch.from_numpy(a) for a in S.lm_tokens(cfg.vocab, 2))
    leaf = space.flatten(params).requires_grad_(True)
    loss, _ = T.lm_loss(tracked_params(space, leaf), toks, labs, cfg)
    (gflat,) = torch.autograd.grad(loss, leaf)
    _, grads = T.lm_loss_and_grad(params, toks, labs, cfg)
    want = space.flatten(grads)
    assert torch.equal(gflat.view(torch.int32), want.view(torch.int32))


# ---------------------------------------------------------------------------
# attach_telemetry, on both packages
# ---------------------------------------------------------------------------

def quad_setup(n: int = 3000):
    rng = np.random.default_rng(0)
    return {"w": rng.standard_normal((n // 30, 30)).astype(np.float32),
            "b": rng.standard_normal(n // 10).astype(np.float32)}


def spaces():
    params = quad_setup()
    return (ParamSpace.build({k: torch.from_numpy(v) for k, v in params.items()},
                             chunk_elems=TILE_ELEMS),
            JaxSpace.build(jax.tree.map(jnp.asarray, params),
                           chunk_elems=TILE_ELEMS))


def assert_stats_same(a, b):
    da, db = dataclasses.asdict(a), dataclasses.asdict(b)
    assert da == db


def exchanges(strategy="pbox", **kw):
    port = PSExchange(topt.momentum(0.1, 0.9), ExchangeConfig(strategy, **kw),
                      ("data",))
    ref = JaxExchange(jopt.momentum(0.1, 0.9), JaxExchangeConfig(strategy,
                                                                 **kw),
                      ("data",))
    return port, ref


def test_trainer_telemetry_matches_wire_model():
    space, jspace = spaces()
    ex, jex = exchanges()
    mesh = types.SimpleNamespace(shape={"data": 4})
    stats, jstats = ServerStats(), JaxStats()
    calls = []
    step = attach_telemetry(lambda *a: calls.append(a) or "out", ex, space,
                            mesh, stats)
    jstep = jax_attach(lambda *a: "out", jex, jspace, mesh, jstats)
    for _ in range(3):
        assert step("x") == "out" and jstep("x") == "out"
    mb = ex.modeled_bytes(space.flat_elems, 1, 4)
    assert mb == jex.modeled_bytes(jspace.flat_elems, 1, 4)
    assert len(calls) == 3
    assert stats.steps == 3
    assert stats.pushes == stats.pulls == 3 * 4
    assert stats.bytes_pushed == 3 * 4 * int(mb["push"])
    assert stats.bytes_pulled == 3 * 4 * int(mb["pull"])
    assert stats.chunk_pushes == 3 * 4 * space.num_chunks
    assert_stats_same(stats, jstats)


@pytest.mark.parametrize("strategy,codec,replication", [
    ("pbox", "none", 1), ("allreduce", "none", 2), ("pbox_hier", "int8", 3),
    ("pbox_hier", "bf16", 1)])
def test_trainer_telemetry_topology_tier(strategy, codec, replication):
    from repro.core.compression import CompressionConfig as JaxCompression
    from repro_torch.core.compression import CompressionConfig

    space, jspace = spaces()
    pod = "pod" if strategy == "pbox_hier" else None
    ex = PSExchange(topt.momentum(0.1, 0.9), ExchangeConfig(
        strategy, compression=CompressionConfig(codec=codec)),
        ("pod", "data"), pod)
    jex = JaxExchange(jopt.momentum(0.1, 0.9), JaxExchangeConfig(
        strategy, compression=JaxCompression(codec=codec)),
        ("pod", "data"), pod)
    mesh = types.SimpleNamespace(shape={"pod": 2, "data": 2})
    topo, jtopo = (NetworkTopology(num_workers=4, num_racks=2),
                   JaxTopology(num_workers=4, num_racks=2))
    stats, jstats = ServerStats(), JaxStats()
    step = attach_telemetry(lambda *a: "out", ex, space, mesh, stats,
                            topology=topo, replication=replication)
    jstep = jax_attach(lambda *a: "out", jex, jspace, mesh, jstats,
                       topology=jtopo, replication=replication)
    for _ in range(2):
        assert step("x") == "out" and jstep("x") == "out"
    assert_stats_same(stats, jstats)
    if strategy == "pbox" and replication == 1:
        stream = wire_bytes(ex.cfg.compression, space.flat_elems)
        assert stream == jax_wire_bytes(jex.cfg.compression, jspace.flat_elems)
        assert stats.bytes_rack_link == 2 * 4 * stream
        assert stats.bytes_core_link == 2 * topo.num_racks * stream
    # a topology sized for a different worker count is rejected up front
    with pytest.raises(ValueError):
        attach_telemetry(lambda *a: "out", ex, space, mesh, stats,
                         topology=NetworkTopology(num_workers=8, num_racks=2))
    with pytest.raises(ValueError):
        attach_telemetry(lambda *a: "out", ex, space, mesh, stats,
                         replication=0)
    with pytest.raises(ValueError):
        attach_telemetry(lambda *a: "out", ex, space, mesh)


def test_trainer_telemetry_advances_snapshot_plane():
    space, jspace = spaces()
    params = quad_setup()
    source = SnapshotSource(space.flatten(
        {k: torch.from_numpy(v) for k, v in params.items()}), version=0,
        device="cpu")
    jsource = JaxSource(jspace.flatten(jax.tree.map(jnp.asarray, params)),
                        version=0)
    plane, jplane = ReadPlane(source, max_staleness=0), JaxPlane(
        jsource, max_staleness=0)
    ex, jex = exchanges()
    mesh = types.SimpleNamespace(shape={"data": 4})
    step = attach_telemetry(lambda *a: "out", ex, space, mesh, ServerStats(),
                            read_plane=plane)
    jstep = jax_attach(lambda *a: "out", jex, jspace, mesh, JaxStats(),
                       read_plane=jplane)
    first, jfirst = plane.read(), jplane.read()
    for _ in range(3):
        assert step("x") == "out" and jstep("x") == "out"
    r, jr = plane.read(), jplane.read()
    assert r.version == first.version == jr.version == jfirst.version
    assert r.staleness == jr.staleness == 3  # the SPMD round clock moved
    assert torch.equal(r.flat, first.flat)


def test_trainer_telemetry_defaults_from_a_job():
    """``job=`` fills stats, topology and replication from a tenancy
    handle (duck-typed here, as the JAX function reads only those)."""
    space, jspace = spaces()
    ex, jex = exchanges()
    mesh = types.SimpleNamespace(shape={"data": 4})
    job = types.SimpleNamespace(stats=ServerStats(), replication=2,
                                topology=NetworkTopology(num_workers=4,
                                                         num_racks=2))
    jjob = types.SimpleNamespace(stats=JaxStats(), replication=2,
                                 topology=JaxTopology(num_workers=4,
                                                      num_racks=2))
    attach_telemetry(lambda: None, ex, space, mesh, job=job)()
    jax_attach(lambda: None, jex, jspace, mesh, job=jjob)()
    assert_stats_same(job.stats, jjob.stats)
    assert job.stats.bytes_replication > 0
