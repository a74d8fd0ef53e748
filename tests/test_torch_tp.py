"""Tensor parallelism in the port's transformer (``models/common.Dist``'s
model-axis collectives, ``models/transformer`` at tp > 1) against its own
tp = 1 model and the JAX package's.

Four gloo ranks spawned once for the file (``tests/torch_spmd.py``), the
JAX side (``tests/torch_spmd_jax.py tp``) on 4 host devices beside them:

  * tests/scripts/psum_transpose.py: each rank's dw is 2 * sum(c) = 200,
    and the all-gather / psum-scatter transposes route the cotangents as
    JAX's do;
  * tests/scripts/tp_equivalence.py's non-MoE cases (``gqa_kvrep``: kv
    replicated; ``dup_R2``: 2 heads over 4 ranks, the duplicated layout;
    ``kvshard_bias``: kv sharded with QKV biases), on the JAX package's
    weights at tp = 4 and tp = 1 (one random model, two layouts): the loss
    at tp = 4 matches tp = 1 and JAX's tp = 4 at rtol 2e-5 / atol 1e-5,
    greedy prefill and decode ids are equal, the tp = 1 decode equals the
    prefill of the longer sequence, and each rank's cache shard matches
    JAX's at rtol 1e-5 / atol 1e-5;
  * its MoE case (8 experts top-2 and a shared expert, sharded over
    d_ff_expert, the router replicated) at tp = 2 on a (2, 2) mesh, each
    data group on the whole batch, against tp = 1 and JAX's tp = 2 in the
    same way.

In this process: ``make_param_specs`` and ``grad_sync`` equal JAX's for tp
in {1, 2, 4, 8} on gemma3-1b and the four cases; ``init_params(tp=N)``
has JAX's tree, shapes and dtypes, duplicates q/o R times, zero-pads the
vocab and draws the tp = 1 model; ``local_params`` cuts JAX's global tree
as JAX's ``init_train_state`` does."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import torch_spmd as S  # noqa: E402

from repro.models import transformer as jT  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.runtime.trainer import local_params  # noqa: E402

TOL = dict(rtol=2e-5, atol=1e-5)
CACHE_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("tp")
    proc = S.start_jax("tp", root)
    try:
        S.spawn(S.TP, S.tp_ranks, root)
    finally:
        S.finish_jax(proc)
    return root


def _rank(root, name, r):
    return dict(np.load(root / f"{name}_r{r}.npz"))


def test_psum_transpose_is_psum(runs):
    for r in range(S.TP):
        got = _rank(runs, "psum", r)
        assert float(got["dw"]) == 200.0
        j = int(got["j"])
        # all_gather's transpose: the (j' + 1)-weighted cotangents of this
        # rank's block, summed over the ranks (1 + 2 + 3 + 4 = 10)
        np.testing.assert_array_equal(got["gx"],
                                      10.0 * np.arange(4.0 * j, 4.0 * j + 4))
        # psum_scatter's transpose: every rank's block of the cotangent,
        # gathered, times this rank's factor
        np.testing.assert_array_equal(got["gy"],
                                      (j + 1.0) * np.tile(np.arange(4.0), 4))


@pytest.mark.parametrize("name", list(S.TP_CASES))
def test_tp4_matches_tp1(runs, name):
    ref = _rank(runs, f"tp_{name}", 0)
    for r in range(S.TP):
        got = _rank(runs, f"tp_{name}", r)
        np.testing.assert_allclose(got["loss4"], ref["loss1"], **TOL)
        np.testing.assert_array_equal(got["nxt4"], ref["nxt1"])
        np.testing.assert_array_equal(got["dec4"], ref["dec1"])
        # each rank holds its quarter of the sequence with every kv head
        n = got["k4"].shape[2]
        np.testing.assert_allclose(got["k4"], ref["k1"][:, :, r * n:(r + 1) * n],
                                   **CACHE_TOL)
    np.testing.assert_array_equal(ref["dec1"], ref["pre17"])


@pytest.mark.parametrize("name", list(S.TP_CASES))
def test_tp4_matches_jax(runs, name):
    j = dict(np.load(runs / f"jax_tp_{name}.npz"))
    for r in range(S.TP):
        got = _rank(runs, f"tp_{name}", r)
        np.testing.assert_allclose(got["loss4"], j["loss"], **TOL)
        np.testing.assert_array_equal(got["nxt4"], j["nxt"])
        np.testing.assert_array_equal(got["dec4"], j["dec"])
        n = got["k4"].shape[2]
        for key in ("k", "v"):
            np.testing.assert_allclose(
                got[f"{key}4"], j[key][:, :, r * n:(r + 1) * n], **CACHE_TOL)


@pytest.mark.parametrize("name", list(S.TP_MOE_CASES))
def test_moe_tp2_matches_tp1_and_jax(runs, name):
    ref = _rank(runs, f"tp_{name}", 0)
    j = dict(np.load(runs / f"jax_tp_{name}.npz"))
    tp = S.TP_MOE
    for r in range(S.TP):
        got = _rank(runs, f"tp_{name}", r)
        for want in (ref["loss1"], j["loss"]):
            np.testing.assert_allclose(got[f"loss{tp}"], want, **TOL)
        for key in ("nxt", "dec"):
            np.testing.assert_array_equal(got[f"{key}{tp}"], ref[f"{key}1"])
            np.testing.assert_array_equal(got[f"{key}{tp}"], j[key])
        # the model coordinate's half of the sequence, every kv head
        m = r % tp
        n = got[f"k{tp}"].shape[2]
        for key in ("k", "v"):
            np.testing.assert_allclose(got[f"{key}{tp}"],
                                       j[key][:, :, m * n:(m + 1) * n],
                                       **CACHE_TOL)
            np.testing.assert_allclose(got[f"{key}{tp}"],
                                       ref[f"{key}1"][:, :, m * n:(m + 1) * n],
                                       **CACHE_TOL)
    np.testing.assert_array_equal(ref["dec1"], ref["pre17"])


ALL_CASES = {**S.TP_CASES, **S.TP_MOE_CASES}


def _configs():
    out = {"gemma3-1b": (get_arch("gemma3-1b").config,
                         jax_config("gemma3-1b"))}
    for name, kw in ALL_CASES.items():
        out[name] = (S.tp_config(kw), jax_config(name))
    return out


def jax_config(name):
    import jax.numpy as jnp

    from repro.configs.registry import get_arch as jax_get_arch
    from repro.models.moe import MoEConfig

    if name == "gemma3-1b":
        return jax_get_arch("gemma3-1b").config
    kw = ALL_CASES[name]
    if "moe" in kw:
        kw = dict(kw, moe=MoEConfig(**kw["moe"]))
    return jT.TransformerConfig("tp", dtype=jnp.float32,
                                param_dtype=jnp.float32, attn_chunk=8, **kw)


@pytest.mark.parametrize("tp", [1, 2, 4, 8])
@pytest.mark.parametrize("name", ["gemma3-1b", *ALL_CASES])
def test_param_specs_and_grad_sync_match_jax(name, tp):
    tcfg, jcfg = _configs()[name]
    jspecs = jT.make_param_specs(jcfg, tp)
    tspecs = T.make_param_specs(tcfg, tp)
    jflat, tflat = S.flat_keys(jspecs), S.flat_keys(tspecs)
    assert jflat.keys() == tflat.keys()
    for k in jflat:
        assert tuple(jflat[k]) == tflat[k], k
    assert T.grad_sync(tcfg, tp) == jT.grad_sync(jcfg, tp)
    for fn in ("tp_attn", "attn_replicas", "heads_local", "kv_sharded",
               "kv_heads_local", "vocab_padded"):
        assert getattr(tcfg, fn)(tp) == getattr(jcfg, fn)(tp), fn
    assert tcfg.param_count() == jcfg.param_count()
    assert tcfg.active_param_count() == jcfg.active_param_count()
    # the abstract global tree is JAX's eval_shape of init_params
    jshape = S.flat_keys(jax.eval_shape(
        lambda: jT.init_params(jcfg, jax.random.PRNGKey(0), tp=tp)))
    tshape = S.flat_keys(T.abstract_params(tcfg, tp))
    assert jshape.keys() == tshape.keys()
    for k in jshape:
        assert tuple(jshape[k].shape) == tuple(tshape[k].shape), k


@pytest.mark.parametrize("tp", [2, 4, 8])
@pytest.mark.parametrize("name", list(ALL_CASES))
def test_init_params_layout_matches_jax(name, tp):
    """The port's tp = N tree: JAX's leaves and shapes, q/o duplicated R
    times, the vocab padding zero, and the same model as tp = 1; JAX's own
    tree has the same structure."""
    tcfg, jcfg = _configs()[name]
    R = tcfg.attn_replicas(tp)
    pn = T.init_params(tcfg, torch.Generator().manual_seed(2), tp=tp)
    p1 = T.init_params(tcfg, torch.Generator().manual_seed(2), tp=1)
    jn = jT.init_params(jcfg, jax.random.PRNGKey(0), tp=tp)
    j1 = jT.init_params(jcfg, jax.random.PRNGKey(0), tp=1)
    for tree_n, tree_1, as_np in ((pn, p1, lambda t: t.numpy()),
                                  (jn, j1, np.asarray)):
        fn, f1 = S.flat_keys(tree_n), S.flat_keys(tree_1)
        assert fn.keys() == f1.keys() == S.flat_keys(
            T.abstract_params(tcfg, tp)).keys()
        for k in fn:
            a, b = as_np(fn[k]), as_np(f1[k])
            if k in ("layers/wq", "layers/bq"):
                b = np.concatenate([b] * R, axis=-1)
            elif k == "layers/wo":
                b = np.concatenate([b] * R, axis=1)
            elif k in ("embed", "head"):
                assert not a[b.shape[0]:].any()  # zero padding rows
                a = a[:b.shape[0]]
            np.testing.assert_array_equal(a, b, err_msg=k)
    assert {k: tuple(v.shape) for k, v in S.flat_keys(pn).items()} == {
        k: tuple(v.shape) for k, v in S.flat_keys(jn).items()}


@pytest.mark.parametrize("name", list(ALL_CASES))
def test_local_params_cut_the_jax_tree(name):
    import types

    from repro_torch.interop import params_from_numpy

    tcfg, jcfg = _configs()[name]
    jtree = jax.tree.map(np.asarray, jT.init_params(
        jcfg, jax.random.PRNGKey(0), tp=S.TP))
    tree = params_from_numpy(jtree, "cpu")
    specs = jT.make_param_specs(jcfg, S.TP)
    for g in range(S.TP):
        mesh = types.SimpleNamespace(shape={"data": 1, "model": S.TP},
                                     coords={"data": 0, "model": g})
        mine = S.flat_keys(local_params(tree, T.make_param_specs(tcfg, S.TP),
                                        mesh))
        for k, spec in S.flat_keys(specs).items():
            want = S.flat_keys(jtree)[k]
            for i, s in enumerate(spec):
                if s == "model":
                    n = want.shape[i] // S.TP
                    want = np.take(want, np.arange(g * n, (g + 1) * n),
                                   axis=i)
            np.testing.assert_array_equal(mine[k].numpy(), want, err_msg=k)


def test_dist_refuses_tp_without_a_mesh():
    from repro_torch.models.common import Dist

    with pytest.raises(ValueError, match="mesh"):
        Dist(model_axis="model", tp=2)
