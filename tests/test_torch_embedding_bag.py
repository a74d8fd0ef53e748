"""The port's embedding-bag kernel family (``repro_torch.kernels.embedding_bag``).

(a) ``embedding_bag`` on CPU tensors (the CUDA kernel's plain version)
    against the JAX op with ``use_pallas=True`` (the Pallas kernel in
    interpret mode), bitwise: sum and mean, L 1-8, D 16 and 128, zero-weight
    padding, empty (all-padding) bags, int32 and int64 indices.  The fold
    is an FMA a slot, in slot order (tests/test_sparse_tier.py:190-205 for
    the JAX package).  The mean's weight sum matches XLA's sequential fold
    up to 32 slots; above that XLA sums the row in chunks (33 slots: 17 +
    16), so ``mean`` at L > 32 is held at rtol 1e-6, the reordered f32 sum's
    error;
(b) the port's ``ref.py`` (gather + einsum) against the JAX ``ref.py`` at
    rtol 1e-5 / atol 1e-5: two einsums that may sum in different orders;
(c) ``segment_sum`` (the sparse push's duplicate fold) against
    ``jax.ops.segment_sum`` bitwise, duplicates and signed zeros included;
(d) every validation error of the JAX op;
(e) the dispatch: CPU tensors take the plain version and launch nothing.
The CUDA kernel itself is held against the plain version on the card by
tests/test_torch_cuda_kernels.py and chip_smoke.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.embedding_bag.ops import embedding_bag as jax_bag  # noqa: E402
from repro.kernels.embedding_bag.ref import embedding_bag_ref as jax_ref  # noqa: E402
from repro_torch.kernels.embedding_bag import kernel as tkernel  # noqa: E402
from repro_torch.kernels.embedding_bag import ops as tops  # noqa: E402
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref  # noqa: E402

V = 64


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def _bags(seed, b, length, d, *, pad=True, empty=False, scale=None):
    """Seeded table, indices and weights; the upper half of each bag's
    slots are zero-weight padding (index 0, as ``jagged_to_padded`` pads)
    when ``pad``, and bag 0 is all padding when ``empty``."""
    rng = np.random.default_rng(seed)
    scale = rng.uniform(0.01, 100) if scale is None else scale
    table = (rng.standard_normal((V, d)) * scale).astype(np.float32)
    idx = rng.integers(0, V, (b, length)).astype(np.int32)
    w = rng.standard_normal((b, length)).astype(np.float32)
    if pad and length > 1:
        w[:, length // 2 + 1:] = 0.0
        idx[:, length // 2 + 1:] = 0
    if empty:
        w[0] = 0.0
        idx[0] = 0
    return table, idx, w


def _jax(table, idx, w, mode):
    return np.asarray(jax_bag(jnp.asarray(table), jnp.asarray(idx),
                              jnp.asarray(w), mode, use_pallas=True))


def _port(table, idx, w, mode, idx_dtype=torch.int32):
    return tops.embedding_bag(torch.from_numpy(table),
                              torch.from_numpy(idx).to(idx_dtype),
                              torch.from_numpy(w), mode).numpy()


@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("d", [16, 128])
@pytest.mark.parametrize("length", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("b", [1, 4, 7])
def test_plain_version_matches_pallas_bitwise(b, length, d, mode):
    table, idx, w = _bags(100 * b + 10 * length + d, b, length, d,
                          empty=b > 1)
    np.testing.assert_array_equal(_bits(_port(table, idx, w, mode)),
                                  _bits(_jax(table, idx, w, mode)))


@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64],
                         ids=["int32", "int64"])
@pytest.mark.parametrize("seed", range(6))
def test_plain_version_matches_pallas_unpadded_and_signed_zeros(seed,
                                                                idx_dtype):
    """No padding, weights of both signs, a zero weight on a negative row
    (signed zeros) and an index width of each kind."""
    table, idx, w = _bags(900 + seed, 5, 4, 16, pad=False)
    w[0, 0] = 0.0
    table[idx[0, 0]] = -np.abs(table[idx[0, 0]])
    for mode in ("sum", "mean"):
        np.testing.assert_array_equal(
            _bits(_port(table, idx, w, mode, idx_dtype)),
            _bits(_jax(table, idx, w, mode)))


@pytest.mark.parametrize("b", [1, 3])
def test_one_slot_bags_match_pallas_signed_zero(b):
    """A zero weight on a negative row: the one-step TPU grid (B = L = 1)
    is a plain product (-0), every other bag an FMA from +0."""
    table = -np.ones((V, 16), np.float32)
    idx = np.zeros((b, 1), np.int32)
    w = np.zeros((b, 1), np.float32)
    for mode in ("sum", "mean"):
        got = _port(table, idx, w, mode)
        np.testing.assert_array_equal(_bits(got), _bits(_jax(table, idx, w, mode)))
        assert np.signbit(got).all() == (b == 1)


@pytest.mark.parametrize("length", [33, 40])
def test_long_bags_sum_bitwise_mean_at_tolerance(length):
    """Past 32 slots XLA sums the weights in chunks; the FMA fold (sum)
    still matches bit for bit, the mean's divisor within one reordered
    f32 sum (rtol 1e-6)."""
    table, idx, w = _bags(7 + length, 6, length, 16, pad=False, scale=1.0)
    w = np.abs(w)  # a positive weight sum keeps the quotient well-conditioned
    np.testing.assert_array_equal(_bits(_port(table, idx, w, "sum")),
                                  _bits(_jax(table, idx, w, "sum")))
    np.testing.assert_allclose(_port(table, idx, w, "mean"),
                               _jax(table, idx, w, "mean"), rtol=1e-6,
                               atol=0)


def test_special_rows_match_pallas_bitwise():
    """NaN and +-inf table rows, read by live slots and by zero-weight
    padding (0 * inf is NaN in both)."""
    table, idx, w = _bags(31, 6, 4, 16)
    table[3, 2] = np.nan
    table[5, 7], table[9, 1] = np.inf, -np.inf
    idx[0, 0], idx[1, 3], idx[2, 1], idx[3, 3] = 3, 5, 9, 3  # [1, 3] is padding
    for mode in ("sum", "mean"):
        np.testing.assert_array_equal(_bits(_port(table, idx, w, mode)),
                                      _bits(_jax(table, idx, w, mode)))


@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("seed", range(4))
def test_ref_matches_jax_ref(seed, mode):
    table, idx, w = _bags(50 + seed, 6, 5, 16)
    got = embedding_bag_ref(torch.from_numpy(table), torch.from_numpy(idx),
                            torch.from_numpy(w), mode).numpy()
    want = np.asarray(jax_ref(jnp.asarray(table), jnp.asarray(idx),
                              jnp.asarray(w), mode))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_plain_version_is_the_slot_order_fma_fold():
    """Against a float64 fold rounded to f32 each slot: within an ulp."""
    table, idx, w = _bags(3, 4, 5, 16, pad=False, scale=1.0)
    fold = np.zeros((4, 16), np.float32)
    for slot in range(5):
        fold = (w[:, slot, None].astype(np.float64)
                * table[idx[:, slot]].astype(np.float64)
                + fold).astype(np.float32)
    np.testing.assert_array_equal(_bits(_port(table, idx, w, "sum")),
                                  _bits(fold))


@pytest.mark.parametrize("seed", range(6))
def test_segment_sum_matches_jax_bitwise(seed):
    rng = np.random.default_rng(seed)
    n, d = int(rng.integers(1, 200)), 16
    ids = rng.zipf(1.3, n) % int(rng.integers(1, 20))
    rows = (rng.standard_normal((n, d)) * 10).astype(np.float32)
    rows[0, :4] = -0.0
    uniq, inv = np.unique(ids, return_inverse=True)
    want = np.asarray(jax.ops.segment_sum(jnp.asarray(rows), jnp.asarray(inv),
                                          num_segments=uniq.size))
    got = tops.segment_sum(torch.from_numpy(rows), inv, uniq.size).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_segment_sum_strided_rows_and_empty():
    rng = np.random.default_rng(4)
    block = torch.from_numpy(rng.standard_normal((30, 3, 8)).astype(np.float32))
    ids = rng.integers(0, 5, 30)
    strided = tops.segment_sum(block[:, 1], ids, 5)
    dense = tops.segment_sum(block[:, 1].contiguous(), ids, 5)
    assert torch.equal(strided, dense)
    assert tops.segment_sum(torch.zeros((0, 8)), np.array([], np.int64),
                            3).shape == (3, 8)


def test_validation_errors():
    table = torch.arange(32.0).reshape(4, 8)
    one = torch.ones((1, 1))
    with pytest.raises(TypeError):
        tops.embedding_bag(table, torch.tensor([[0.5]]), one)
    for bad in ([[4]], [[-1]], [[99]]):
        with pytest.raises(ValueError, match="out of range"):
            tops.embedding_bag(table, torch.tensor(bad), one)
    with pytest.raises(ValueError, match="mode"):
        tops.embedding_bag(table, torch.tensor([[0]]), one, "max")
    with pytest.raises(ValueError):
        tops.embedding_bag(table, torch.tensor([[0, 1]]), one)
    with pytest.raises(TypeError):
        tops.segment_sum(torch.ones((2, 8)), np.array([0.5, 1.0]), 2)
    with pytest.raises(ValueError, match="out of range"):
        tops.segment_sum(torch.ones((2, 8)), np.array([0, 2]), 2)


def test_cpu_dispatch_takes_the_plain_version(monkeypatch):
    monkeypatch.setattr(tkernel, "launches", 0)
    monkeypatch.setattr(tkernel, "segment_launches", 0)
    table, idx, w = _bags(8, 3, 2, 16)
    got = _port(table, idx, w, "sum")
    want = tkernel.embedding_bag_torch(torch.from_numpy(table),
                                       torch.from_numpy(idx),
                                       torch.from_numpy(w)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    tops.segment_sum(torch.ones((3, 4)), np.array([1, 0, 1]), 2)
    assert (tkernel.launches, tkernel.segment_launches) == (0, 0)
