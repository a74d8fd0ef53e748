"""The port's wire codecs (``repro_torch.core.compression``) against the JAX
package's.

(a) ``decode_wire(encode_wire(x))`` and ``roundtrip(x)`` agree bitwise on
    the decoded view and on the sender's error-feedback residual, through a
    chain of pushes (tests/test_wire_path.py:163-178 for the JAX package);
(b) a 4-push error-feedback chain equals the JAX codec's bitwise: payload,
    scales, decoded view and residual after every push;
(c) ``wire_bytes``, ``wire_bytes_per_elem``, ``init_ef_state``, the tuple
    forms ``encode``/``decode``, and the unknown-codec errors.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core import compression as J  # noqa: E402
from repro_torch.core import compression as T  # noqa: E402

CHUNK = 4096


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def _assert_bit_equal(a, b, what):
    bad = int((_bits(a) != _bits(b)).sum())
    assert bad == 0, f"{what}: {bad} elements differ bitwise"


@pytest.mark.parametrize("codec", ["bf16", "int8"])
def test_encode_wire_matches_roundtrip(codec):
    cfg = T.CompressionConfig(codec=codec, chunk_elems=CHUNK)
    rng = np.random.default_rng(5)
    n = 2 * CHUNK
    ef_a = T.init_ef_state(cfg, n, device="cpu")
    ef_b = T.init_ef_state(cfg, n, device="cpu")
    for trial in range(3):  # EF accumulates: the chain must stay locked
        slab = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
        wp, ef_a = T.encode_wire(cfg, slab, ef_a)
        dec_w = T.decode_wire(cfg, wp)
        dec_r, ef_b = T.roundtrip(cfg, slab, ef_b)
        _assert_bit_equal(dec_w, dec_r, f"decoded view ({codec}, {trial})")
        _assert_bit_equal(ef_a, ef_b, f"EF residual ({codec}, {trial})")


@pytest.mark.parametrize("error_feedback", [True, False])
@pytest.mark.parametrize("codec", ["none", "bf16", "int8"])
def test_ef_chain_matches_jax_bitwise(codec, error_feedback):
    """Four pushes through ``encode_wire`` in both packages from the same
    numpy slabs; the slabs grow by 10x a push so chunk scales move."""
    jcfg = J.CompressionConfig(codec=codec, chunk_elems=CHUNK,
                               error_feedback=error_feedback)
    tcfg = T.CompressionConfig(codec=codec, chunk_elems=CHUNK,
                               error_feedback=error_feedback)
    n = 3 * CHUNK
    jef = J.init_ef_state(jcfg, n)
    tef = T.init_ef_state(tcfg, n, device="cpu")
    assert (jef is None) == (tef is None)
    rng = np.random.default_rng(17)
    for push in range(4):
        slab = (rng.standard_normal(n) * 10.0**push).astype(np.float32)
        jwp, jef = J.encode_wire(jcfg, jnp.asarray(slab), jef)
        twp, tef = T.encode_wire(tcfg, torch.from_numpy(slab), tef)
        what = f"{codec}/ef={error_feedback}/push {push}"
        assert twp.codec == jwp.codec == codec
        if codec == "int8":
            np.testing.assert_array_equal(twp.payload.numpy(),
                                          np.asarray(jwp.payload), what)
            _assert_bit_equal(twp.scale.numpy(), jwp.scale, f"scales {what}")
        _assert_bit_equal(T.decode_wire(tcfg, twp).numpy(),
                          J.decode_wire(jcfg, jwp), f"decoded {what}")
        if jef is None:
            assert tef is None
        else:
            _assert_bit_equal(tef.numpy(), jef, f"residual {what}")


@pytest.mark.parametrize("codec", ["none", "bf16", "int8"])
def test_tuple_forms_match_wire_forms(codec):
    cfg = T.CompressionConfig(codec=codec, chunk_elems=CHUNK)
    slab = torch.from_numpy(
        np.random.default_rng(2).standard_normal(2 * CHUNK).astype(np.float32))
    ef = T.init_ef_state(cfg, 2 * CHUNK, device="cpu")
    payload, ef1 = T.encode(cfg, slab, ef)
    wp, ef2 = T.encode_wire(cfg, slab, ef)
    assert len(payload) == (2 if codec == "int8" else 1)
    assert torch.equal(T.decode(cfg, payload), T.decode_wire(cfg, wp))
    assert (ef1 is None and ef2 is None) or torch.equal(ef1, ef2)


@pytest.mark.parametrize("n", [1, 4095, 4096, 4097, 3 * 4096])
@pytest.mark.parametrize("codec", ["none", "bf16", "int8"])
def test_wire_bytes_match_jax(codec, n):
    jcfg = J.CompressionConfig(codec=codec, chunk_elems=CHUNK)
    tcfg = T.CompressionConfig(codec=codec, chunk_elems=CHUNK)
    assert T.wire_bytes(tcfg, n) == J.wire_bytes(jcfg, n)
    assert tcfg.wire_bytes_per_elem == jcfg.wire_bytes_per_elem


def test_init_ef_state():
    assert T.init_ef_state(T.CompressionConfig("none"), 8) is None
    assert T.init_ef_state(
        T.CompressionConfig("int8", error_feedback=False), 8) is None
    ef = T.init_ef_state(T.CompressionConfig("bf16"), 8, device="cpu")
    assert ef.dtype == torch.float32 and tuple(ef.shape) == (8,)
    assert not ef.any()


def test_init_ef_state_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.init_ef_state(T.CompressionConfig("int8"), 8)


def test_unknown_codec_rejected_everywhere():
    cfg = T.CompressionConfig(codec="fp4", chunk_elems=128)
    slab = torch.zeros(128)
    with pytest.raises(ValueError, match="fp4"):
        _ = cfg.wire_bytes_per_elem
    with pytest.raises(ValueError, match="fp4"):
        T.wire_bytes(cfg, 128)
    with pytest.raises(ValueError, match="fp4"):
        T.encode(cfg, slab, None)
    with pytest.raises(ValueError, match="fp4"):
        T.encode_wire(cfg, slab, None)
    with pytest.raises(ValueError, match="fp4"):
        T.decode(cfg, (slab,))
    with pytest.raises(ValueError, match="fp4"):
        T.roundtrip(cfg, slab, None)
    wp = T.WirePayload(codec="fp4", payload=torch.zeros(128, dtype=torch.int8),
                       scale=torch.ones(1))
    with pytest.raises(ValueError, match="fp4"):
        T.decode_wire(T.CompressionConfig("int8", chunk_elems=128), wp)
