"""DLRM and the sparse training loop: the port against the JAX package.

(a) ``recsys_batches`` gives the JAX stream's batches, array for array;
(b) the DLRM SMOKE loss and its gradients with respect to the dense
    parameters and the looked-up embeddings ``e``, from the JAX package's
    ``dlrm_init`` output loaded through numpy: loss within rtol 1e-6,
    gradients within rtol 1e-5 / atol 1e-7 (the two frameworks' f32
    matmuls and reductions sum in different orders);
(c) the slice as a whole: the sparse training loop composed from public
    pieces, as ``chip_smoke.py`` composes it at full width — per worker and
    round, one ``SparseTier.lookup`` per table (one-hot bags), autograd of
    ``dlrm_loss_from_emb`` with respect to the dense parameters and ``e``,
    a dense push into a ``PBoxFabric`` and one ``SparseTier.push`` of the
    (ids, cot_e) rows.  SMOKE, 2 workers, 2 shards, SGD(0.1) on both tiers,
    3 rounds, against the same loop composed from the JAX pieces: losses
    within rtol 1e-5, tables and dense parameters within atol 1e-6 (the
    gradients' last-bit differences, scaled by lr 0.1), row versions and
    every ``SparseStats`` field exactly.  Inside the port, 1 and 4 shards
    give bitwise-equal tables, versions and dense parameters, with codec
    none and with int8 plus error feedback.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_arch as jax_get_arch  # noqa: E402
from repro.core.chunking import ParamSpace as JaxSpace  # noqa: E402
from repro.core.config import FabricConfig as JaxConfig  # noqa: E402
from repro.core.fabric import PBoxFabric as JaxFabric  # noqa: E402
from repro.core.sparse import SparseTier as JaxTier  # noqa: E402
from repro.data.synthetic import recsys_batches as jax_batches  # noqa: E402
from repro.models.common import Dist  # noqa: E402
from repro.models.recsys import models as jmodels  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.core.chunking import TILE_ELEMS, ParamSpace  # noqa: E402
from repro_torch.core.config import FabricConfig  # noqa: E402
from repro_torch.core.fabric import PBoxFabric  # noqa: E402
from repro_torch.core.sparse import SparseTier  # noqa: E402
from repro_torch.data.synthetic import recsys_batches  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.models.recsys import models as tmodels  # noqa: E402
from repro_torch.optim.optimizers import sgd  # noqa: E402

ARCH = "dlrm-mlperf"
BATCH, WORKERS, ROUNDS, LR = 64, 2, 3, 0.1


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def _smoke():
    return get_arch(ARCH).smoke_config, jax_get_arch(ARCH).smoke_config


def _jax_params():
    jcfg = jax_get_arch(ARCH).smoke_config
    return jax.tree.map(np.asarray, jmodels.dlrm_init(jcfg, jax.random.PRNGKey(0)))


def _torch_batch(b):
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


# ---------------------------------------------------------------------------
# (a) data, config, init
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("which", ["smoke", "full"])
def test_recsys_batches_equal_jax(which):
    tcfg = getattr(get_arch(ARCH), "smoke_config" if which == "smoke" else "config")
    jcfg = getattr(jax_get_arch(ARCH), "smoke_config" if which == "smoke" else "config")
    ours, theirs = recsys_batches(ARCH, tcfg, 32, seed=3), jax_batches(ARCH, jcfg, 32, seed=3)
    for _ in range(3):
        a, b = next(ours), next(theirs)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_config_copies_the_jax_config():
    for attr in ("config", "smoke_config"):
        t, j = getattr(get_arch(ARCH), attr), getattr(jax_get_arch(ARCH), attr)
        for f in ("name", "n_dense", "vocabs", "embed_dim", "bot_mlp", "top_mlp"):
            assert getattr(t, f) == getattr(j, f)
        assert (t.n_sparse, t.top_in, t.param_count()) == (
            j.n_sparse, j.top_in, j.param_count())
    assert tmodels.CRITEO_VOCABS == jmodels.CRITEO_VOCABS
    assert [c.name for c in get_arch(ARCH).cells] == [
        c.name for c in jax_get_arch(ARCH).cells]


def test_dlrm_init_shapes_and_generators():
    cfg, _ = _smoke()
    want = _jax_params()
    gens = lambda: tuple(torch.Generator().manual_seed(s) for s in range(3))  # noqa: E731
    got = tmodels.dlrm_init(cfg, gens())
    again = tmodels.dlrm_init(cfg, gens())
    for group in want:
        assert sorted(got[group]) == sorted(want[group])
        for k, v in want[group].items():
            assert tuple(got[group][k].shape) == v.shape
            assert torch.equal(got[group][k], again[group][k])
    assert 0.005 < float(got["tables"]["t0"].std()) < 0.015
    assert not got["bot"]["b0"].any()


# ---------------------------------------------------------------------------
# (b) loss and gradients
# ---------------------------------------------------------------------------
def test_dlrm_loss_and_grads_match_jax():
    cfg, jcfg = _smoke()
    params_np = _jax_params()
    batch = next(recsys_batches(ARCH, cfg, 32, seed=1))
    dist = Dist()
    jparams = jax.tree.map(jnp.asarray, params_np)
    je = jmodels.dlrm_lookup(jparams["tables"], batch, dist)
    dense_np = {"bot": params_np["bot"], "top": params_np["top"]}

    def jloss(dp, e):
        return jmodels.dlrm_loss_from_emb(dp, e, batch, jcfg, dist)[0]

    jl, (jg, jge) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, dense_np), je)
    jfull = jmodels.dlrm_loss(jparams, batch, jcfg, dist)[0]

    params = params_from_numpy(params_np, device="cpu")
    tb = _torch_batch(batch)
    e = tmodels.dlrm_lookup(params["tables"], tb)
    np.testing.assert_array_equal(_bits(e.numpy()), _bits(je))
    dense = {g: {k: v.clone().requires_grad_() for k, v in params[g].items()}
             for g in ("bot", "top")}
    e = e.clone().requires_grad_()
    loss, aux = tmodels.dlrm_loss_from_emb(dense, e, tb, cfg)
    leaves = [dense[g][k] for g in ("bot", "top") for k in sorted(dense[g])]
    grads = torch.autograd.grad(loss, leaves + [e])
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-6)
    assert aux["bce"] is loss
    np.testing.assert_allclose(tmodels.dlrm_loss(params, tb, cfg)[0].item(),
                               float(jfull), rtol=1e-6)
    want = [np.asarray(jg[g][k]) for g in ("bot", "top") for k in sorted(dense[g])]
    for got, ref in zip(grads, want + [np.asarray(jge)]):
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-7)
    scores = tmodels.dlrm_score(params, tb, cfg)
    assert tuple(scores.shape) == (32,) and torch.isfinite(scores).all()


def test_dot_interact_pair_order_matches_jax():
    rng = np.random.default_rng(0)
    z = rng.standard_normal((3, 8)).astype(np.float32)
    e = rng.standard_normal((3, 4, 8)).astype(np.float32)
    got = tmodels._dot_interact(torch.from_numpy(z), torch.from_numpy(e))
    want = jmodels._dot_interact(jnp.asarray(z), jnp.asarray(e))
    assert tuple(got.shape) == (3, 10)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# (c) the sparse training loop, composed from public pieces
# ---------------------------------------------------------------------------
def port_loop(params_np, num_shards, codec="none"):
    cfg = get_arch(ARCH).smoke_config
    params = params_from_numpy(params_np, device="cpu")
    dense = {"bot": params["bot"], "top": params["top"]}
    space = ParamSpace.build(dense, chunk_elems=TILE_ELEMS)
    fab = PBoxFabric(space, sgd(LR), space.flatten(dense), device="cpu",
                     config=FabricConfig(num_shards=num_shards,
                                         num_workers=WORKERS))
    tier = SparseTier(fabric=fab, lr=LR, codec=codec)
    for name, table in params["tables"].items():
        tier.add_table(name, table)
    streams = [recsys_batches(ARCH, cfg, BATCH, seed=w) for w in range(WORKERS)]
    bags = np.arange(BATCH + 1)
    losses = []
    for _ in range(ROUNDS):
        for w in range(WORKERS):
            b = next(streams[w])
            p = space.unflatten(fab.pull(w))
            p = {g: {k: v.detach().requires_grad_() for k, v in p[g].items()}
                 for g in p}
            e = torch.stack([tier.lookup(w, f"t{i}", b["sparse"][:, i], bags)
                             for i in range(cfg.n_sparse)], dim=1)
            e.requires_grad_()
            loss, _ = tmodels.dlrm_loss_from_emb(p, e, _torch_batch(b), cfg)
            leaves = [p[g][k] for g in sorted(p) for k in sorted(p[g])]
            *g_dense, cot_e = torch.autograd.grad(loss, leaves + [e])
            it = iter(g_dense)
            grads = {g: {k: next(it) for k in sorted(p[g])} for g in sorted(p)}
            fab.push(w, space.flatten(grads))
            tier.push(w, {f"t{i}": (b["sparse"][:, i], cot_e[:, i])
                          for i in range(cfg.n_sparse)})
            losses.append(loss.item())
    return losses, fab, tier


def jax_loop(params_np, num_shards):
    cfg = jax_get_arch(ARCH).smoke_config
    dense = {"bot": params_np["bot"], "top": params_np["top"]}
    dense = jax.tree.map(jnp.asarray, dense)
    space = JaxSpace.build(dense, chunk_elems=TILE_ELEMS)
    fab = JaxFabric(space, jopt.sgd(LR), space.flatten(dense),
                    config=JaxConfig(num_shards=num_shards,
                                     num_workers=WORKERS))
    tier = JaxTier(fabric=fab, lr=LR)
    for name, table in params_np["tables"].items():
        tier.add_table(name, table)
    streams = [jax_batches(ARCH, cfg, BATCH, seed=w) for w in range(WORKERS)]
    bags = np.arange(BATCH + 1)
    dist = Dist()
    grad_fn = jax.value_and_grad(
        lambda dp, e, b: jmodels.dlrm_loss_from_emb(dp, e, b, cfg, dist)[0],
        argnums=(0, 1))
    losses = []
    for _ in range(ROUNDS):
        for w in range(WORKERS):
            b = next(streams[w])
            p = space.unflatten(fab.pull(w))
            e = jnp.stack([tier.lookup(w, f"t{i}", b["sparse"][:, i], bags)
                           for i in range(cfg.n_sparse)], axis=1)
            loss, (g_dense, cot_e) = grad_fn(p, e, b)
            fab.push(w, space.flatten(g_dense))
            tier.push(w, {f"t{i}": (b["sparse"][:, i], cot_e[:, i])
                          for i in range(cfg.n_sparse)})
            losses.append(float(loss))
    return losses, fab, tier


def test_sparse_training_loop_matches_jax():
    params_np = _jax_params()
    losses, fab, tier = port_loop(params_np, 2)
    jlosses, jfab, jtier = jax_loop(params_np, 2)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    assert losses[-1] < losses[0] + 0.5  # finite and not diverging
    np.testing.assert_allclose(fab.params.numpy(), np.asarray(jfab.params),
                               rtol=0, atol=1e-6)
    for name in tier.tables:
        np.testing.assert_allclose(tier.table(name).numpy(),
                                   np.asarray(jtier.table(name)), rtol=0,
                                   atol=1e-6)
        np.testing.assert_array_equal(tier.row_versions(name),
                                      jtier.row_versions(name))
    assert vars(tier.stats) == vars(jtier.stats)
    assert tier.stats.rounds == ROUNDS and tier.stats.rows_coalesced > 0


@pytest.mark.parametrize("codec", ["none", "int8"])
def test_sparse_training_loop_sharding_independent(codec):
    params_np = _jax_params()
    one = port_loop(params_np, 1, codec)
    four = port_loop(params_np, 4, codec)
    assert one[0] == four[0]
    assert torch.equal(one[1].params, four[1].params)
    for name in one[2].tables:
        np.testing.assert_array_equal(_bits(one[2].table(name).numpy()),
                                      _bits(four[2].table(name).numpy()))
        np.testing.assert_array_equal(one[2].row_versions(name),
                                      four[2].row_versions(name))
