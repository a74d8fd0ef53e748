"""The port's example programs (``repro_torch.examples``) against the JAX
examples' computations (``examples/*.py``), on the CPU.

Each JAX example's loop is written out here with the JAX package's
functions; the port's ``main(device="cpu", ...)`` runs from the same
weights (JAX's init carried over by ``interop.params_from_numpy``) on the
same numpy-seeded batches.  Tolerances:

  * losses: rtol 1e-4, the AdamW bound tests/test_torch_quickstart.py
    states (AdamW's normalised update can turn a 1e-9 gradient difference
    near zero into a step the size of lr);
  * ``dlrm_score`` logits and retrieval scores: rtol 1e-5, atol 1e-6; the
    top-5 ids where the gap between neighbouring scores exceeds that
    tolerance (a near tie may order either way);
  * ``train_distributed_ps``'s crash: the state restored from the step-20
    checkpoint bitwise equal to the state saved there, and the loss after
    the restart within rtol 1e-4 of JAX's.

``train_100m_e2e`` runs at a cut config (2 layers, d 64, vocab 512) for
20 steps: over fewer, its 20-step warmup keeps the rate near zero and the
loss need not fall, and the example's own check (JAX's ``assert
losses[-1] < losses[0]``) stops the run, as it stops JAX's.  Its
published ``CFG`` is checked field by field and by parameter count
against the JAX example's.  The two multi-rank examples run once
for the file: 8 gloo ranks (``tests/torch_spmd.py``'s spawn, with a
deadline) for ``train_distributed_ps`` at its (2, 4) mesh, then 2 of them
for ``serve_lm`` at its ``--mesh 1x2``, beside ``tests/torch_spmd_jax.py
examples`` (the JAX side on 8 host devices).
"""
import contextlib
import dataclasses
import importlib.util
import io
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch_spmd as S  # noqa: E402

from repro.configs.registry import get_arch as jax_get_arch  # noqa: E402
from repro.core.chunking import ParamSpace as JaxSpace  # noqa: E402
from repro.core.config import FabricConfig as JaxConfig  # noqa: E402
from repro.core.fabric import PBoxFabric as JaxFabric  # noqa: E402
from repro.core.fabric import WorkerHarness as JaxHarness  # noqa: E402
from repro.data.synthetic import lm_batches as jax_lm_batches  # noqa: E402
from repro.models.common import Dist  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro_torch.examples import (  # noqa: E402
    gnn_molecules,
    quickstart,
    recsys_serving,
    serve_lm,
    train_100m_e2e,
    train_distributed_ps,
)
from repro_torch.interop import params_from_numpy  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
LOSS_RTOL = 1e-4
SCORE_RTOL, SCORE_ATOL = 1e-5, 1e-6


def _port(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def _jax_example(name: str):
    """``examples/<name>.py`` imported as a module (its ``main`` is not
    run)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _quiet(fn, *a, **kw):
    """``fn(*a, **kw)`` and what it printed."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*a, **kw)
    return out, buf.getvalue()


# ---- quickstart -----------------------------------------------------------

QS_ROUNDS = 3


def test_quickstart_main_matches_jax():
    """examples/quickstart.py's loop for QS_ROUNDS rounds: the losses, the
    push count and bytes, the chunk space's description and the simulated
    pipeline speedup, as printed."""
    cfg = jax_get_arch("gemma3-1b").smoke_config
    params = jT.init_params(cfg, jax.random.PRNGKey(0), tp=1)
    space = JaxSpace.build(params)
    srv = JaxFabric(space, jopt.adamw(3e-3), space.flatten(params),
                    config=JaxConfig(num_shards=4, num_workers=2))
    streams = [jax_lm_batches(cfg.vocab, 4, 32, seed=w) for w in range(2)]
    lossg = jax.jit(jax.value_and_grad(
        lambda p, t, lab: jT.lm_loss(p, t, lab, cfg, Dist.none(), 1)[0]))
    losses = []

    def grad_fn(p, wstep):
        b = next(streams[wstep[0]])
        loss, g = lossg(p, jnp.asarray(b["tokens"]), jnp.asarray(b["labels"]))
        losses.append(float(loss))
        return g

    JaxHarness(srv, grad_fn, lambda w, s: (w, s)).run(QS_ROUNDS)
    out, printed = _quiet(quickstart.main, device="cpu", rounds=QS_ROUNDS,
                          params=_port(params))
    np.testing.assert_allclose(out["losses"], losses, rtol=LOSS_RTOL)
    assert out["pushes"] == srv.stats.pushes == 2 * QS_ROUNDS
    assert out["bytes_pushed"] == srv.stats.bytes_pushed
    assert out["space"] == space.describe()
    assert out["pipeline_speedup"] == srv.stats.pipeline_speedup
    lines = printed.splitlines()
    assert lines[0] == space.describe()
    assert lines[1] == (f"loss first->last: {round(out['losses'][0], 3)} -> "
                        f"{round(out['losses'][-1], 3)}")
    assert lines[2] == (f"pushes: {srv.stats.pushes}  bytes pushed: "
                        f"{srv.stats.bytes_pushed >> 20} MiB")
    assert lines[-1] == (
        "simulated pipeline speedup vs monolithic store-and-forward: "
        f"{srv.stats.pipeline_speedup:.2f}x")


# ---- train_100m_e2e -------------------------------------------------------

E2E_STEPS, E2E_BATCH, E2E_SEQ = 20, 4, 128
E2E_CUT = dict(n_layers=2, d_model=64, head_dim=8, d_ff=256, vocab=512)


def _jax_e2e(jcfg, steps: int):
    """examples/train_100m_e2e.py's loop at ``jcfg`` for ``steps`` steps
    (its stream read directly: the Prefetcher keeps its order)."""
    from repro.core.exchange import ExchangeConfig, PSExchange
    from repro.kernels.fused_agg_opt.ops import fused_aggregate_update
    from repro.optim.schedules import warmup_cosine_schedule

    params = jT.init_params(jcfg, jax.random.PRNGKey(0), tp=1)
    space = JaxSpace.build(params)
    ex = PSExchange(jopt.adamw(3e-4, weight_decay=0.01),
                    ExchangeConfig("allreduce"), worker_axes=())
    sched = warmup_cosine_schedule(20, steps)
    pflat = space.flatten(params)
    state = ex.init_slab_state(space)
    lossg = jax.jit(jax.value_and_grad(
        lambda pf, t, lab: jT.lm_loss(space.unflatten(pf), t, lab, jcfg,
                                      Dist.none(), 1)[0]))

    @jax.jit
    def update(pflat, slots, step, gflat):
        newp, newslots = fused_aggregate_update(
            gflat[None], pflat, slots, ex.spec, step + 1, sched(step + 1),
            average=False, use_pallas=False)
        return newp, newslots, step + 1

    data = jax_lm_batches(jcfg.vocab, E2E_BATCH, E2E_SEQ, seed=0)
    slots, step = state["slots"], state["step"]
    losses = []
    for _ in range(steps):
        b = next(data)
        loss, gflat = lossg(pflat, b["tokens"], b["labels"])
        pflat, slots, step = update(pflat, slots, step, gflat)
        losses.append(float(loss))
    return params, losses, np.asarray(pflat)


def test_train_100m_e2e_matches_jax_at_a_cut_config(tmp_path):
    """The e2e program at E2E_CUT for E2E_STEPS steps from JAX's weights:
    JAX's losses within rtol 1e-4, the parameter count it prints, and the
    checkpoint of the last step (saved asynchronously while the kernel
    updates in place) bitwise equal to the state the run returns."""
    from repro.models.transformer import TransformerConfig as JaxCfg
    from repro_torch.checkpoint import Checkpointer

    jex = _jax_example("train_100m_e2e")
    jcfg = dataclasses.replace(jex.CFG, **E2E_CUT)
    assert isinstance(jcfg, JaxCfg)
    jparams, jlosses, jflat = _jax_e2e(jcfg, E2E_STEPS)
    cfg = dataclasses.replace(train_100m_e2e.CFG, **E2E_CUT)
    out, printed = _quiet(
        train_100m_e2e.main,
        ["--steps", str(E2E_STEPS), "--ckpt-dir", str(tmp_path)],
        device="cpu", cfg=cfg, params=_port(jparams), ckpt_every=E2E_STEPS)
    np.testing.assert_allclose(out["losses"], jlosses, rtol=LOSS_RTOL)
    n = sum(int(x.size) for x in jax.tree.leaves(jparams))
    assert out["params"] == n
    lines = printed.splitlines()
    assert lines[0] == f"model: {n/1e6:.1f}M params"
    assert lines[2].startswith(
        f"step   20 loss={out['losses'][-1]:.4f} "
        f"(avg20={sum(out['losses'][-20:]) / 20:.4f}, ")
    assert lines[-1].startswith(f"final loss {out['losses'][-1]:.4f} "
                                f"(start {out['losses'][0]:.4f}); ")
    assert out["step"] == E2E_STEPS and out["flat"] == jflat.shape[0]
    host, _ = Checkpointer(tmp_path).restore()
    assert int(host["step"]) == E2E_STEPS
    np.testing.assert_array_equal(host["pflat"][0].view(np.uint32),
                                  out["pflat"].numpy().view(np.uint32))
    for i, s in enumerate(out["slots"]):
        np.testing.assert_array_equal(host[f"slot{i}"][0].view(np.uint32),
                                      s.numpy().view(np.uint32))


def test_train_100m_e2e_config_is_the_jax_examples():
    """The published ``CFG``: every field and the parameter count of the
    JAX example's (the ~100M of its name), and the JAX argparser's
    defaults but the checkpoint directory (the port's is under the
    process's temporary directory)."""
    jex = _jax_example("train_100m_e2e")
    cfg, jcfg = train_100m_e2e.CFG, jex.CFG
    for f in dataclasses.fields(jcfg):
        a, b = getattr(cfg, f.name), getattr(jcfg, f.name)
        if f.name in ("dtype", "param_dtype"):
            assert str(a).split(".")[-1] == jnp.dtype(b).name
        else:
            assert a == b, f.name
    assert cfg.param_count() == jcfg.param_count()
    shapes = jax.eval_shape(lambda: jT.init_params(
        jcfg, jax.random.PRNGKey(0), tp=1))
    from repro_torch.models.transformer import abstract_params
    tleaves = jax.tree.leaves(jax.tree.map(
        lambda t: t.numel(), abstract_params(cfg, 1)))
    assert sum(tleaves) == sum(int(x.size) for x in jax.tree.leaves(shapes))
    args = train_100m_e2e.build_argparser().parse_args([])
    assert (args.steps, args.batch, args.seq) == (200, 4, 128)
    assert Path(args.ckpt_dir).name == "pbox_100m_ckpt"


# ---- gnn_molecules --------------------------------------------------------

GNN_STEPS = 7


def test_gnn_molecules_matches_jax():
    """examples/gnn_molecules.py's loop for GNN_STEPS steps (its 4 batch
    seeds each seen, the print at steps 0, 3 and 6): every step's MSE
    within rtol 1e-4."""
    from repro.data.graphs import random_molecule_batch
    from repro.models.gnn.equiformer_v2 import init_params, loss_fn

    cfg = dataclasses.replace(jax_get_arch("equiformer-v2").smoke_config,
                              task="graph_reg", n_out=1)
    params = init_params(cfg, jax.random.PRNGKey(0))
    init_fn, upd_fn = jopt.make_optimizer(jopt.adamw(2e-3))

    @jax.jit
    def step(p, o, g):
        (loss, _), grads = jax.value_and_grad(
            lambda p_: loss_fn(p_, g, cfg, Dist.none()), has_aux=True)(p)
        p, o = upd_fn(p, grads, o)
        return p, o, loss

    p, opt, losses = params, init_fn(params), []
    for i in range(GNN_STEPS):
        g = random_molecule_batch(8, 8, 16, cfg.d_in, cfg.l_max, cfg.n_rbf,
                                  seed=i % 4)
        p, opt, loss = step(p, opt, jax.tree.map(jnp.asarray, g))
        losses.append(float(loss))
    out, printed = _quiet(gnn_molecules.main, device="cpu", steps=GNN_STEPS,
                          params=_port(params))
    np.testing.assert_allclose(out["losses"], losses, rtol=LOSS_RTOL)
    assert printed.splitlines() == [
        *(f"step {i:2d} mse={out['losses'][i]:.4f}"
          for i in range(0, GNN_STEPS, 3)),
        "done — molecular energies fitted on synthetic targets"]


# ---- recsys_serving -------------------------------------------------------

def test_recsys_serving_matches_jax():
    """examples/recsys_serving.py from JAX's DLRM SMOKE weights: the 64
    logits and the 4096 retrieval scores within rtol 1e-5 / atol 1e-6, the
    same candidate draw, and the top-5 ids wherever neighbouring scores
    are further apart than that tolerance."""
    from repro.data.synthetic import recsys_batches
    from repro.models.recsys import models as RS

    cfg = jax_get_arch("dlrm-mlperf").smoke_config
    params = RS.dlrm_init(cfg, jax.random.PRNGKey(0))
    b = jax.tree.map(jnp.asarray, next(recsys_batches(
        "dlrm-mlperf", cfg, batch=64, seed=0)))
    s = np.asarray(jax.jit(lambda p, b: RS.dlrm_score(
        p, b, cfg, Dist.none()))(params, b))
    b["cand_ids"] = jnp.asarray(
        np.random.default_rng(0).integers(0, cfg.vocabs[0], 4096), jnp.int32)
    scores = np.asarray(jax.jit(lambda p, b: RS.bulk_retrieval(
        p, b, RS.dlrm_user_tower, "t0", cfg.embed_dim, cfg, Dist.none()))(
            params, b))
    top = np.argsort(scores)[-5:][::-1]
    out, printed = _quiet(recsys_serving.main, device="cpu",
                          params=_port(params))
    assert out["logits"].shape == s.shape == (64,)
    np.testing.assert_allclose(out["logits"], s, rtol=SCORE_RTOL,
                               atol=SCORE_ATOL)
    np.testing.assert_array_equal(out["cand_ids"],
                                  np.asarray(b["cand_ids"]))
    np.testing.assert_allclose(out["scores"], scores, rtol=SCORE_RTOL,
                               atol=SCORE_ATOL)
    np.testing.assert_allclose(out["top_scores"], scores[top],
                               rtol=SCORE_RTOL, atol=SCORE_ATOL)
    tol = SCORE_ATOL + SCORE_RTOL * np.abs(scores[top])
    ranked = np.sort(scores)[::-1][:6]
    for i in range(5):  # the id at rank i is settled when it stands apart
        if ranked[i] - ranked[i + 1] > tol[i] and (
                i == 0 or ranked[i - 1] - ranked[i] > tol[i]):
            assert out["top_ids"][i] == np.asarray(b["cand_ids"])[top][i]
    assert printed.splitlines()[0].startswith("scored 64 requests; logits[:4]")
    assert printed.splitlines()[1].startswith(
        "retrieved top-5 of 4096 candidates: ids")


# ---- the multi-rank examples ----------------------------------------------

@pytest.fixture(scope="module")
def ranks_out(tmp_path_factory):
    root = tmp_path_factory.mktemp("examples")
    proc = S.start_jax("examples", root)
    try:
        S.spawn(8, S.examples_ranks, root)
    finally:
        S.finish_jax(proc)
    return root


def test_train_distributed_ps_matches_jax(ranks_out):
    """At its (2, 4) mesh from JAX's tp = 4 weights: the losses printed at
    steps 5-20 and after the restart within rtol 1e-4 of JAX's, the
    restart from step 20, every rank's restored state bitwise equal to
    the state it saved, and every rank reporting the same numbers."""
    jax_out = dict(np.load(ranks_out / "jax_ex_ps.npz"))
    ranks = [dict(np.load(ranks_out / f"ex_ps_r{r}.npz")) for r in range(8)]
    for r, got in enumerate(ranks):
        assert bool(got["restored_is_saved"]), f"rank {r}"
        assert int(got["restart_step"]) == int(jax_out["restart_step"]) == 20
        assert int(got["step"]) == 25
        np.testing.assert_array_equal(got["losses"], ranks[0]["losses"])
        assert got["loss_after_restart"] == ranks[0]["loss_after_restart"]
    assert ranks[0]["losses"].shape == (4,)
    np.testing.assert_allclose(ranks[0]["losses"], jax_out["losses"],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(ranks[0]["loss_after_restart"],
                               jax_out["loss_after_restart"], rtol=LOSS_RTOL)
    assert ranks[0]["saved_pflat"].shape[0] == S.EX_TP  # a row a model group


def test_serve_lm_matches_jax(ranks_out):
    """At its ``--mesh 1x2`` from JAX's tp = 2 weights: both ranks
    generate the JAX example's ids from a read of the same version."""
    jax_out = dict(np.load(ranks_out / "jax_ex_serve.npz"))
    for r in range(2):
        got = dict(np.load(ranks_out / f"ex_serve_r{r}.npz"))
        assert got["generated"].shape == (4, 12)
        np.testing.assert_array_equal(got["generated"], jax_out["generated"])
        assert int(got["version"]) == int(jax_out["version"])


@pytest.mark.parametrize("mod", [serve_lm, train_distributed_ps],
                         ids=["serve_lm", "train_distributed_ps"])
def test_multi_rank_examples_take_a_device_only_inside_a_group(mod):
    """Outside a process group a multi-rank example starts its own ranks
    under torchrun (one card a rank); asked for the CPU there it raises
    before it starts anything."""
    with pytest.raises(ValueError, match="inside a group"):
        mod.main(device="cpu")
