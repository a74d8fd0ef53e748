"""The four recsys models of the port against the JAX package at their
SMOKE configs, from the JAX package's ``*_init`` output carried across
through ``repro_torch.interop`` (tests/test_models_smoke.py's
``test_recsys_smoke`` on the port, then parity):

  * the loss is finite and near ln 2, the score has shape (B,), every
    gradient is finite;
  * loss and score within rtol 1e-6 / atol 1e-7, every parameter's
    gradient within rtol 1e-5 / atol 1e-7 of its largest element's
    scale (the frameworks' f32 matmuls and reductions sum in other
    orders; DIEN's 12-step recurrences compound them), the user tower
    within rtol 1e-6 / atol 1e-7, ``bulk_retrieval``'s scores within
    rtol 1e-5 / atol 1e-7;
  * ``*_specs`` and ``*_grad_sync`` equal JAX's for tp 1, 2 and 4 (specs
    as tuples), and ``*_init(..., device="meta")`` gives JAX's
    ``jax.eval_shape`` shapes, padded tables included.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_arch as jax_get_arch  # noqa: E402
from repro.launch.steps import _RS_FNS as JAX_FNS  # noqa: E402
from repro.models.common import Dist as JaxDist  # noqa: E402
from repro.models.recsys import models as JRS  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.launch.steps import _RS_FNS  # noqa: E402
from repro_torch.models.recsys import models as RS  # noqa: E402

ARCHS = ("dlrm-mlperf", "autoint", "dien", "xdeepfm")
B = 16


def _batch(arch_id, cfg):
    """test_models_smoke.py's batch, in numpy."""
    rng = np.random.default_rng(0)
    batch = {"labels": rng.integers(0, 2, (B,)).astype(np.int32)}
    if arch_id == "dlrm-mlperf":
        batch["dense"] = rng.normal(size=(B, cfg.n_dense)).astype(np.float32)
    if arch_id == "dien":
        batch["hist_items"] = rng.integers(0, cfg.n_items, (B, cfg.seq_len)
                                           ).astype(np.int32)
        batch["hist_cats"] = rng.integers(0, cfg.n_cats, (B, cfg.seq_len)
                                          ).astype(np.int32)
        batch["sparse"] = np.stack([rng.integers(0, cfg.n_items, B),
                                    rng.integers(0, cfg.n_cats, B)], 1
                                   ).astype(np.int32)
    else:
        batch["sparse"] = np.stack([rng.integers(0, v, B) for v in cfg.vocabs],
                                   1).astype(np.int32)
    return batch


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k],
                                                         f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    arch_id = request.param
    jcfg = jax_get_arch(arch_id).smoke_config
    cfg = get_arch(arch_id).smoke_config
    jp = JAX_FNS[arch_id][0](jcfg, jax.random.PRNGKey(0), 1)
    batch = _batch(arch_id, cfg)
    return arch_id, cfg, jcfg, jax.tree.map(np.asarray, jp), batch


def test_smoke_loss_score_and_grads(case):
    arch_id, cfg, _, jp, batch = case
    _, _, _, loss_f, score_f, _, _ = _RS_FNS[arch_id]
    params = params_from_numpy(jp, "cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    leaves = [p.requires_grad_(True) for _, p in _leaves(params)]
    loss, met = loss_f(params, tb, cfg)
    assert np.isfinite(loss.item()) and 0 < loss.item() < 2.0
    assert tuple(score_f(params, tb, cfg).shape) == (B,)
    grads = torch.autograd.grad(loss, leaves)
    assert all(torch.isfinite(g).all() for g in grads)
    assert set(met) == {"bce"}


def test_loss_score_grads_and_tower_match_jax(case):
    arch_id, cfg, jcfg, jp, batch = case
    _, _, _, loss_f, score_f, tower_f, _ = _RS_FNS[arch_id]
    _, _, _, jloss_f, jscore_f, jtower_f, _ = JAX_FNS[arch_id]
    dist = JaxDist.none()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jparams = jax.tree.map(jnp.asarray, jp)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jloss_f(p, jb, jcfg, dist)[0])(jparams)
    params = params_from_numpy(jp, "cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    named = _leaves(params)
    for _, p in named:
        p.requires_grad_(True)
    loss, _ = loss_f(params, tb, cfg)
    grads = torch.autograd.grad(loss, [p for _, p in named])
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-6,
                               atol=1e-7)
    for (name, _), g, (_, jg) in zip(named, grads, _leaves(jgrads)):
        jg = np.asarray(jg)
        scale = max(float(np.abs(jg).max()), 1e-30)
        np.testing.assert_allclose(g.numpy(), jg, rtol=1e-5,
                                   atol=1e-7 * max(scale, 1.0),
                                   err_msg=name)
    with torch.no_grad():
        np.testing.assert_allclose(
            score_f(params, tb, cfg).numpy(),
            np.asarray(jscore_f(jparams, jb, jcfg, dist)), rtol=1e-6,
            atol=1e-7)
        np.testing.assert_allclose(
            tower_f(params, tb, cfg).numpy(),
            np.asarray(jtower_f(jparams, jb, jcfg, dist)), rtol=1e-6,
            atol=1e-7)


def test_bulk_retrieval_matches_jax(case):
    arch_id, cfg, jcfg, jp, batch = case
    tower_f, jtower_f = _RS_FNS[arch_id][5], JAX_FNS[arch_id][5]
    rng = np.random.default_rng(4)
    cand = rng.integers(0, cfg.vocabs[0] + 5, 64).astype(np.int32)
    rb = {k: v[:2] for k, v in batch.items() if k != "labels"}
    jb = {k: jnp.asarray(v) for k, v in rb.items()}
    jb["cand_ids"] = jnp.asarray(cand)
    want = JRS.bulk_retrieval(jax.tree.map(jnp.asarray, jp), jb, jtower_f,
                              "t0", jcfg.embed_dim, jcfg, JaxDist.none())
    tb = {k: torch.from_numpy(v) for k, v in rb.items()}
    tb["cand_ids"] = torch.from_numpy(cand)
    with torch.no_grad():
        got = RS.bulk_retrieval(params_from_numpy(jp, "cpu"), tb, tower_f,
                                "t0", cfg.embed_dim, cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-7)


def _jax_spec(tree):
    if isinstance(tree, dict):
        return {k: _jax_spec(v) for k, v in tree.items()}
    return tuple(tree)


@pytest.mark.parametrize("tp", [1, 2, 4])
@pytest.mark.parametrize("arch_id", ARCHS)
def test_specs_grad_sync_and_shapes_match_jax(arch_id, tp):
    init_f, specs_f, sync_f = _RS_FNS[arch_id][:3]
    jinit, jspecs, jsync = JAX_FNS[arch_id][:3]
    cfg = get_arch(arch_id).config
    jcfg = jax_get_arch(arch_id).config
    assert specs_f(cfg, tp) == _jax_spec(jspecs(jcfg, tp))
    assert sync_f(cfg, tp) == jsync(jcfg, tp)
    want = jax.eval_shape(lambda: jinit(jcfg, jax.random.PRNGKey(0), tp))
    got = init_f(cfg, None, tp, device="meta")
    assert [(n, tuple(x.shape)) for n, x in _leaves(got)] == [
        (n, tuple(x.shape)) for n, x in _leaves(want)]
    assert all(x.device.type == "meta" for _, x in _leaves(got))
    assert cfg.param_count() == jcfg.param_count()


@pytest.mark.parametrize("arch_id", ARCHS)
def test_init_draws_from_its_generator(arch_id):
    """A seeded generator gives the same parameters twice, the tables at
    std 0.01, the biases zero; ``tp`` pads every table to a multiple."""
    init_f = _RS_FNS[arch_id][0]
    cfg = get_arch(arch_id).smoke_config
    a = init_f(cfg, torch.Generator().manual_seed(3), 1)
    b = init_f(cfg, torch.Generator().manual_seed(3), 1)
    assert all(torch.equal(x, y) for (_, x), (_, y) in zip(_leaves(a),
                                                          _leaves(b)))
    assert 0.005 < float(a["tables"]["t0"].std()) < 0.015
    padded = init_f(cfg, torch.Generator().manual_seed(3), 3)
    for name, t in padded["tables"].items():
        assert t.shape[0] % 3 == 0 and t.shape[0] >= a["tables"][name].shape[0]
