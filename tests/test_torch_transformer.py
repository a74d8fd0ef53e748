"""The port's transformer against the JAX package's, gemma3 SMOKE in f32.

The JAX package's ``init_params`` output goes to the port through
``interop.params_from_numpy``; the same seeded batch goes through both.
Tolerances: loss rtol 1e-5; every gradient leaf rtol 1e-4, atol 1e-5 (the
matmul and reduction summation orders differ between XLA and torch)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_arch as jax_get_arch  # noqa: E402
from repro.data.synthetic import lm_batches as jax_lm_batches  # noqa: E402
from repro.models.common import Dist  # noqa: E402
from repro.models.common import apply_rope as jax_rope  # noqa: E402
from repro.models.common import rms_norm as jax_rms  # noqa: E402
from repro.models.transformer import init_params as jax_init  # noqa: E402
from repro.models.transformer import lm_loss as jax_lm_loss  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.data.synthetic import lm_batches  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.models.common import apply_rope, rms_norm, rope_freqs  # noqa: E402


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree, np.float32)}


@pytest.mark.parametrize("seq", [16, 32])
def test_loss_and_grads_match_jax(seq):
    jcfg = jax_get_arch("gemma3-1b").smoke_config
    tcfg = get_arch("gemma3-1b").smoke_config
    jparams = jax_init(jcfg, jax.random.PRNGKey(0), tp=1)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    batch = next(lm_batches(tcfg.vocab, 2, seq, seed=3))
    jloss, jgrads = jax.value_and_grad(
        lambda p: jax_lm_loss(p, jnp.asarray(batch["tokens"]),
                              jnp.asarray(batch["labels"]), jcfg,
                              Dist.none(), 1)[0])(jparams)
    tloss, tgrads = tt.lm_loss_and_grad(
        tparams, torch.from_numpy(batch["tokens"]),
        torch.from_numpy(batch["labels"]), tcfg)
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    jflat, tflat = _flat(jgrads), _flat(tgrads)
    assert jflat.keys() == tflat.keys()
    for name in jflat:
        np.testing.assert_allclose(tflat[name], jflat[name], rtol=1e-4,
                                   atol=1e-5, err_msg=name)


def test_rms_norm_and_rope_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    w = rng.standard_normal(16).astype(np.float32)
    pos = np.broadcast_to(np.arange(5), (2, 5))
    np.testing.assert_allclose(
        rms_norm(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        np.asarray(jax_rms(jnp.asarray(x), jnp.asarray(w))), rtol=1e-5,
        atol=1e-6)
    np.testing.assert_allclose(
        apply_rope(torch.from_numpy(x), torch.from_numpy(pos.copy()), 1e6).numpy(),
        np.asarray(jax_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)),
        rtol=1e-5, atol=1e-5)


def test_rope_freqs_defaults_to_the_card(monkeypatch):
    """``device=None`` means the card, as at every entry point; with no
    card it raises instead of building on the CPU."""
    assert rope_freqs(8, device="cpu").device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rope_freqs(8)


def test_init_params_layout_and_generator():
    cfg = get_arch("gemma3-1b").smoke_config
    jtree = jax_init(jax_get_arch("gemma3-1b").smoke_config,
                     jax.random.PRNGKey(0), tp=1)
    a = tt.init_params(cfg, torch.Generator().manual_seed(5))
    b = tt.init_params(cfg, torch.Generator().manual_seed(5))
    fa, fj = _flat(a), _flat(jtree)
    assert fa.keys() == fj.keys()
    assert all(fa[k].shape == fj[k].shape for k in fa)
    assert all(np.array_equal(fa[k], v) for k, v in _flat(b).items())
    assert sum(v.size for v in fa.values()) == cfg.param_count()
    assert not np.array_equal(fa["/head"], fa["/embed"])


def test_lm_batches_are_the_same_stream():
    for a, b in zip(range(3), zip(lm_batches(512, 2, 9, seed=4),
                                  jax_lm_batches(512, 2, 9, seed=4))):
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(b[0][k], b[1][k])


def test_unported_model_options_raise():
    import dataclasses

    cfg = get_arch("gemma3-1b").smoke_config
    for bad in (dict(moe=object()), dict(seq_parallel=True), dict(act="gelu")):
        with pytest.raises(NotImplementedError):
            tt.init_params(dataclasses.replace(cfg, **bad),
                           torch.Generator().manual_seed(0))
    with pytest.raises(KeyError, match="not ported"):
        get_arch("qwen2-72b")


def test_full_config_is_gemma3_1b():
    cfg = get_arch("gemma3-1b").config
    jcfg = jax_get_arch("gemma3-1b").config
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab) == (
        jcfg.n_layers, jcfg.d_model, jcfg.n_heads, jcfg.n_kv_heads,
        jcfg.head_dim, jcfg.d_ff, jcfg.vocab)
    assert cfg.param_count() == jcfg.param_count() == 1_301_802_624
    assert cfg.dtype == torch.bfloat16 and cfg.param_dtype == torch.bfloat16


def test_loss_and_grad_frees_the_weights_without_gc():
    """A worker's weight copy dies with its last reference, not at the
    next cyclic garbage collection (at full width each copy is 2.6 GB)."""
    import gc
    import weakref

    cfg = get_arch("gemma3-1b").smoke_config
    params = tt.init_params(cfg, torch.Generator().manual_seed(0))
    batch = next(lm_batches(cfg.vocab, 1, 16, seed=0))
    gc.collect()
    gc.disable()
    try:
        alive = weakref.ref(params["embed"])
        loss, grads = tt.lm_loss_and_grad(
            params, torch.from_numpy(batch["tokens"]),
            torch.from_numpy(batch["labels"]), cfg)
        del params, loss, grads
        assert alive() is None
    finally:
        gc.enable()
