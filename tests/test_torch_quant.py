"""The port's int8 codec kernels (``repro_torch.kernels.quant``).

(a) ``quantize_chunks`` / ``dequantize_chunks`` on CPU tensors (the CUDA
    kernels' plain versions) against the JAX ops with ``use_pallas=True``
    (the Pallas kernels in interpret mode): payload, scales and decoded
    values bitwise, including an all-zero chunk, a chunk holding NaN and
    chunks holding +-inf (tests/test_kernels.py:49-80 for the JAX package);
(b) the symmetric-rounding error bound, amax/254 per chunk;
(c) every validation error of the JAX ops, with the same message;
(d) the dispatch: CPU tensors launch nothing.
The CUDA kernels themselves are held against the plain versions on the
card by tests/test_torch_cuda_kernels.py and chip_smoke.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.quant import ops as jops  # noqa: E402
from repro_torch.kernels.quant import kernel as tkernel  # noqa: E402
from repro_torch.kernels.quant import ops as tops  # noqa: E402
from repro_torch.kernels.quant.ref import (  # noqa: E402
    dequantize_chunks_ref,
    quantize_chunks_ref,
)


def _slab(n, seed, scale=13.0, specials=()):
    """Seeded normal f32 slab; ``specials`` are (index, value) overrides."""
    x = (np.random.default_rng(seed).standard_normal(n) * scale).astype(
        np.float32)
    for i, v in specials:
        x[i] = v
    return x


def _both(x, chunk):
    jq, js = jops.quantize_chunks(jnp.asarray(x), chunk, use_pallas=True)
    tq, ts = tops.quantize_chunks(torch.from_numpy(x.copy()), chunk)
    return (np.asarray(jq), np.asarray(js)), (tq.numpy(), ts.numpy())


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("n_chunks", [1, 4])
@pytest.mark.parametrize("chunk", [128, 1024, 8192])
def test_quant_matches_jax_bitwise(n_chunks, chunk):
    x = _slab(n_chunks * chunk, seed=n_chunks * 7 + chunk)
    (jq, js), (tq, ts) = _both(x, chunk)
    assert tq.dtype == np.int8 and ts.dtype == np.float32
    np.testing.assert_array_equal(tq, jq)
    np.testing.assert_array_equal(_bits(ts), _bits(js))
    jd = jops.dequantize_chunks(jnp.asarray(jq), jnp.asarray(js), chunk,
                                use_pallas=True)
    td = tops.dequantize_chunks(torch.from_numpy(tq), torch.from_numpy(ts),
                                chunk)
    np.testing.assert_array_equal(_bits(td.numpy()), _bits(jd))


def test_special_chunks_match_jax_bitwise():
    """Chunk 0 all zeros (scale 1.0), chunk 1 a NaN (scale 1.0, the NaN
    encodes as 0), chunk 2 +inf and -inf (scale inf, all zeros), chunk 3
    NaN beside inf (scale 1.0, inf clips to 127), chunk 4 ordinary, chunk 5
    values on rounding ties."""
    chunk = 128
    x = _slab(6 * chunk, seed=3, specials=[(130, np.nan), (260, np.inf),
                                           (300, -np.inf), (389, np.nan),
                                           (390, np.inf), (391, -np.inf)])
    x[:chunk] = 0.0
    # amax 127 gives scale 1.0: x/scale lands exactly on .5 ties
    x[5 * chunk:6 * chunk] = np.resize(
        np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5],
                 np.float32), chunk)
    (jq, js), (tq, ts) = _both(x, chunk)
    np.testing.assert_array_equal(tq, jq)
    np.testing.assert_array_equal(_bits(ts), _bits(js))
    assert ts[0] == 1.0 and ts[1] == 1.0 and np.isinf(ts[2]) and ts[3] == 1.0
    assert tq[130] == 0 and not tq[256:384].any() and tq[390] == 127
    assert list(tq[5 * chunk:5 * chunk + 8]) == [127, 0, 2, 2, 0, -2, -2, 126]
    jd = jops.dequantize_chunks(jnp.asarray(jq), jnp.asarray(js), chunk,
                                use_pallas=True)
    td = tops.dequantize_chunks(torch.from_numpy(tq), torch.from_numpy(ts),
                                chunk)
    np.testing.assert_array_equal(_bits(td.numpy()), _bits(jd))


def test_plain_version_against_the_oracle():
    """The oracle divides ``amax / 127``; the compiled kernel (and so the
    plain version) multiplies by f32(1/127), one ulp apart at most, which
    moves a payload value by at most one step."""
    x = torch.from_numpy(_slab(512 * 128, seed=5) * np.resize(
        np.linspace(0.1, 100, 512, dtype=np.float32), 512 * 128))
    q, s = tkernel.quantize_chunks_torch(x, 128)
    qr, sr = quantize_chunks_ref(x, 128)
    amax = x.reshape(512, 128).abs().amax(dim=1).numpy()
    np.testing.assert_array_equal(_bits(s), _bits(amax * np.float32(1 / 127)))
    np.testing.assert_array_equal(_bits(sr), _bits(amax / np.float32(127)))
    ulps = np.abs(_bits(s).astype(np.int64) - _bits(sr).astype(np.int64))
    assert ulps.max() <= 1 and (ulps == 1).any()
    assert (q.int() - qr.int()).abs().max() <= 1
    assert torch.equal(tkernel.dequantize_chunks_torch(q, s, 128),
                       dequantize_chunks_ref(q, s, 128))


def test_quant_error_bound():
    """Per-chunk error <= scale/2 = amax/254 (symmetric int8 rounding)."""
    chunk = 1024
    x = torch.from_numpy(_slab(8 * chunk, seed=3, scale=5.0))
    q, s = tops.quantize_chunks(x, chunk)
    xd = tops.dequantize_chunks(q, s, chunk)
    err = (xd - x).abs().reshape(8, chunk).amax(dim=1)
    amax = x.abs().reshape(8, chunk).amax(dim=1)
    assert bool((err <= amax / 254 + 1e-7).all())


def test_cpu_tensors_launch_nothing(monkeypatch):
    monkeypatch.setattr(tkernel, "quantize_launches", 0)
    monkeypatch.setattr(tkernel, "dequantize_launches", 0)
    q, s = tops.quantize_chunks(torch.from_numpy(_slab(256, seed=1)), 128)
    tops.dequantize_chunks(q, s, 128)
    assert tkernel.quantize_launches == tkernel.dequantize_launches == 0


# -- validation: the JAX ops' errors, message for message --------------------
QUANT_ERRORS = [
    ("flat slab", lambda m: m.zeros((2, 128), "f32"), 128),
    ("f32", lambda m: m.zeros(256, "bf16"), 128),
    ("f32", lambda m: m.zeros(256, "int8"), 128),
    ("whole number", lambda m: m.zeros(300, "f32"), 128),
    ("whole number", lambda m: m.zeros(0, "f32"), 128),
    ("chunk_elems", lambda m: m.zeros(256, "f32"), 0),
    ("chunk_elems", lambda m: m.zeros(256, "f32"), 64),
    ("chunk_elems", lambda m: m.zeros(256, "f32"), 100),
    ("chunk_elems", lambda m: m.zeros(256, "f32"), 129),
]
DEQUANT_ERRORS = [
    ("flat payload", lambda m: (m.zeros((2, 128), "int8"), m.ones((2,)))),
    ("int8", lambda m: (m.zeros(256, "f32"), m.ones((2,)))),
    ("whole number", lambda m: (m.zeros(257, "int8"), m.ones((2,)))),
    (r"\(2,\)", lambda m: (m.zeros(256, "int8"), m.ones((3,)))),
    (r"\(2,\)", lambda m: (m.zeros(256, "int8"), m.ones((2, 1)))),
]


class _Jax:
    T = {"f32": jnp.float32, "bf16": jnp.bfloat16, "int8": jnp.int8}

    def zeros(self, shape, dt):
        return jnp.zeros(shape, self.T[dt])

    def ones(self, shape):
        return jnp.ones(shape, jnp.float32)


class _Torch:
    T = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}

    def zeros(self, shape, dt):
        return torch.zeros(shape, dtype=self.T[dt])

    def ones(self, shape):
        return torch.ones(shape)


@pytest.mark.parametrize("match,make,chunk", QUANT_ERRORS)
def test_quantize_rejects_like_jax(match, make, chunk):
    with pytest.raises(ValueError, match=match) as je:
        jops.quantize_chunks(make(_Jax()), chunk)
    with pytest.raises(ValueError, match=match) as te:
        tops.quantize_chunks(make(_Torch()), chunk)
    assert str(je.value).split(",")[0].split(" got")[0] == \
        str(te.value).split(",")[0].split(" got")[0]


@pytest.mark.parametrize("match,make", DEQUANT_ERRORS)
def test_dequantize_rejects_like_jax(match, make):
    with pytest.raises(ValueError, match=match):
        jops.dequantize_chunks(*make(_Jax()), 128)
    with pytest.raises(ValueError, match=match):
        tops.dequantize_chunks(*make(_Torch()), 128)


def test_valid_call_roundtrips_after_rejections():
    x = torch.from_numpy(
        np.random.default_rng(7).normal(size=256).astype(np.float32))
    q, s = tops.quantize_chunks(x, 128)
    dec = tops.dequantize_chunks(q, s, 128)
    assert q.dtype == torch.int8 and tuple(s.shape) == (2,)
    np.testing.assert_allclose(dec.numpy(), x.numpy(), atol=float(s.max()))


def test_ops_refuse_other_devices():
    x = torch.zeros(256, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tops.quantize_chunks(x, 128)
