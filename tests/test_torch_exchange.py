"""The port's SPMD exchange (``repro_torch.core.exchange``) against the JAX
one and the tree-wise reference.

Mirrors tests/scripts/exchange_equivalence.py on 8 gloo ranks laid out as
a (2, 2, 2) ("pod", "data", "model") mesh, every axis a worker axis, as in
the script: each worker pushes exchange_equivalence.py's small-integer
gradients for 3 Adam steps.  Every sum is exact, so the port is held bit
for bit to the JAX exchange (run in a subprocess on 8 host devices, its
fused update and codec on their Pallas kernels): params, every rank's
slots at its owner index of JAX's global slots, and the residuals, for
allreduce, pbox and pbox_hier, codecs none / bf16 / int8 on the cross-pod
stage, a bf16 pull, and bf16 PS slabs (gemma3's); the int8 cases with
error feedback to a stated bound (``INT8_EF_RTOL``: XLA fuses the jitted
residual's multiply-subtract).  The codec-free
strategies also match the tree-wise DP-Adam reference at the script's
rtol 2e-5 / atol 2e-6.  On a (3,) mesh, sums that are not multiples of 3
pin the division by the worker count to JAX's form (a product with
f32(1/3)).  ``modeled_bytes`` equals JAX's over a grid, and the
constructor raises JAX's errors.  Both worlds and the JAX script run once
for the file (~25 s).
"""
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import torch_spmd as S  # noqa: E402

from repro.core.compression import CompressionConfig as JaxCompression  # noqa: E402
from repro.core.exchange import ExchangeConfig as JaxExchangeConfig  # noqa: E402
from repro.core.exchange import PSExchange as JaxExchange  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro_torch.core.compression import CompressionConfig  # noqa: E402
from repro_torch.core.exchange import ExchangeConfig, PSExchange  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX side and both worlds, the JAX side alongside the ranks."""
    root = tmp_path_factory.mktemp("exchange")
    proc = S.start_jax("exchange", root / "jax")
    try:
        S.spawn(8, S.exchange_ranks, root / "w8")
        S.spawn(3, S.exchange_ranks, root / "w3")
    finally:
        S.finish_jax(proc)
    return root


def _ranks(d: Path, name: str, world: int):
    return [dict(np.load(d / f"{name}_r{r}.npz")) for r in range(world)]


def _owner_index(coords, owner_dims, shape):
    i = 0
    for d in owner_dims:
        i = i * shape[d] + int(coords[d])
    return i


def _same(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and np.array_equal(
        a.view(np.uint8), b.view(np.uint8))


def _check_against_jax(ranks, jax_npz, owner_dims, shape, exact=True):
    """Every rank's params equal JAX's; its slots and residual equal the
    slab of JAX's global arrays at its owner index.  A residual replicated
    over pods is compared on pod 0's ranks: JAX's global output of a
    pod-replicated spec holds pod 0's copy."""
    j = dict(np.load(jax_npz))
    for r in ranks:
        assert int(r["step"]) == int(j["step"]) == S.EXCHANGE_STEPS
        o = _owner_index(r["coords"], owner_dims, shape)
        pairs = [("pflat", r["pflat"], j["pflat"])]
        for key in ("slot0", "slot1", "ef"):
            if key not in j:
                assert key not in r
                continue
            if key == "ef" and len(shape) == 3 and r["coords"][0] != 0:
                continue
            n = r[key].shape[0]
            pairs.append((key, r[key], j[key][o * n:(o + 1) * n]))
        for key, got, want in pairs:
            if exact:
                assert _same(got, want), key
            else:
                np.testing.assert_allclose(got, want, rtol=INT8_EF_RTOL,
                                           atol=INT8_EF_ATOL, err_msg=key)


# Inside the jitted exchange XLA contracts the int8 residual
# ``slab - f32(q) * scale`` into one fused multiply-subtract (one rounding);
# the port's codec, like the JAX codec run eagerly (the fabric's), rounds
# the dequantized value first.  The residuals then differ by an ulp of
# the product, and that carries into the next push: the int8 cases with
# error feedback are held to these bounds (a residual is at most half a
# quantization step, ~0.02 here; an ulp of it ~2e-9), every other case
# bit for bit.
INT8_EF_RTOL, INT8_EF_ATOL = 1e-5, 1e-6


OWNER_DIMS = {"allreduce": (), "pbox": (0, 1, 2), "pbox_hier": (1, 2)}


@pytest.mark.parametrize("name", [n for n in S.EXCHANGE_CASES
                                  if not n.endswith("_noef")])
def test_exchange_bitwise_against_jax(runs, name):
    strategy, codec, _, _, ef_on = S.EXCHANGE_CASES[name]
    _check_against_jax(_ranks(runs / "w8", name, 8), runs / "jax" / f"{name}.npz",
                       OWNER_DIMS[strategy], (2, 2, 2),
                       exact=not (codec == "int8" and ef_on))


@pytest.mark.parametrize("name", S.NW3_CASES)
def test_exchange_three_workers_bitwise_against_jax(runs, name):
    strategy = S.EXCHANGE_CASES[name][0]
    _check_against_jax(_ranks(runs / "w3", name, 3),
                       runs / "jax" / f"nw3_{name}.npz",
                       (0,) if strategy != "allreduce" else (), (3,))


def test_three_workers_divide_as_jax_does(runs):
    """The (3,) mesh's sums are not all multiples of 3, so a true division
    would differ from the product with f32(1/3) somewhere; the port
    matched JAX bitwise above, so it multiplies."""
    s = sum(S.toy_grads(w, "nw3")["w"] for w in range(3)).ravel()
    assert not np.array_equal(s / np.float32(3), s * np.float32(1 / 3))


def reference_dp_adam():
    """Tree-wise Adam on the mean gradient of 8 workers (the port's
    ``make_optimizer``), as the script's reference."""
    init_fn, upd_fn = topt.make_optimizer(topt.adam(1e-2))
    p = {k: torch.from_numpy(v) for k, v in S.toy_params().items()}
    st = init_fn(p)
    for _ in range(S.EXCHANGE_STEPS):
        g = {k: sum(torch.from_numpy(S.toy_grads(w)[k]) for w in range(8)) / 8
             for k in p}
        p, st = upd_fn(p, g, st)
    return p


@pytest.mark.parametrize("name", ["allreduce", "pbox", "pbox_hier"])
def test_strategies_match_reference_dp_adam(runs, name):
    ref = reference_dp_adam()
    sizes = {k: v.size for k, v in S.toy_params().items()}
    for r in _ranks(runs / "w8", name, 8):
        # the flat layout: leaves in sorted key order ("b" then "w")
        off = 0
        for k in sorted(sizes):
            got = r["pflat"][off:off + sizes[k]]
            np.testing.assert_allclose(got, ref[k].numpy().ravel(),
                                       rtol=2e-5, atol=2e-6)
            off += sizes[k]


def test_int8_cross_pod_is_close_not_exact(runs):
    """pbox_hier + int8: small but nonzero error against the reference (the
    script's expectation), and error feedback carried per owner."""
    ref = reference_dp_adam()
    r = _ranks(runs / "w8", "pbox_hier_int8", 8)[0]
    flat = np.concatenate([ref["b"].numpy().ravel(), ref["w"].numpy().ravel()])
    err = np.abs(r["pflat"][:flat.size] - flat).max()
    assert 0 < err < 1e-2
    assert "ef" in r


def test_int8_without_error_feedback_refuses_bf16_slabs(runs):
    """JAX's quantize_chunks refuses bf16 input; gemma3's bf16 slabs reach
    the int8 codec only through error feedback's f32 ``slab + ef``."""
    name = "pbox_hier_int8_bf16_noef"
    jerr = (runs / "jax" / f"{name}.err").read_text()
    for r in range(8):
        err = (runs / "w8" / f"{name}_r{r}.err").read_text()
        assert err.startswith("ValueError: quantize_chunks wants f32 input")
        assert jerr.startswith("ValueError: quantize_chunks wants f32 input")


GRID = [(s, c, pull, pods, data)
        for s in ("allreduce", "pbox", "pbox_hier")
        for c in ("none", "bf16", "int8")
        for pull in (False, True)
        for pods, data in ((1, 1), (1, 8), (2, 4), (4, 16))]


@pytest.mark.parametrize("strategy,codec,pull,pods,data", GRID)
def test_modeled_bytes_equal_jax(strategy, codec, pull, pods, data):
    kw = dict(strategy=strategy)
    pod = "pod" if strategy == "pbox_hier" else None
    port = PSExchange(topt.momentum(0.1), ExchangeConfig(
        compression=CompressionConfig(codec=codec),
        pull_dtype=torch.bfloat16 if pull else None, **kw),
        ("pod", "data"), pod)
    import jax.numpy as jnp
    ref = JaxExchange(jopt.momentum(0.1), JaxExchangeConfig(
        compression=JaxCompression(codec=codec),
        pull_dtype=jnp.bfloat16 if pull else None, **kw), ("pod", "data"), pod)
    flat = 3 * (1 << 16) + 8192
    assert port.modeled_bytes(flat, pods, data) == ref.modeled_bytes(
        flat, pods, data)


def test_modeled_bytes_hierarchy_reduces_cross_pod():
    spec = topt.momentum(0.1)
    flat = 1 << 20
    pb = PSExchange(spec, ExchangeConfig("pbox"), ("pod", "data"))
    hi = PSExchange(spec, ExchangeConfig("pbox_hier"), ("pod", "data"), "pod")
    m_pb = pb.modeled_bytes(flat, 2, 16)
    m_hi = hi.modeled_bytes(flat, 2, 16)
    # hierarchical cross-pod bytes ~ G/n_data vs pbox's ~G-scale push
    assert m_hi["xpod"] < m_pb["push"] / 4
    # int8 compression shrinks the cross-pod stage further
    hi8 = PSExchange(
        spec,
        ExchangeConfig("pbox_hier",
                       compression=CompressionConfig(codec="int8")),
        ("pod", "data"), "pod")
    assert hi8.modeled_bytes(flat, 2, 16)["xpod"] < m_hi["xpod"] / 3


@pytest.mark.parametrize("strategy,wa,pod", [
    ("pbox_hier", ("pod", "data"), None),
    ("pbox_hier", ("data", "pod"), "pod"),
    ("ring", ("data",), None),
])
def test_constructor_errors_match_jax(strategy, wa, pod):
    with pytest.raises(ValueError) as e:
        PSExchange(topt.sgd(), ExchangeConfig(strategy), wa, pod)
    with pytest.raises(ValueError) as je:
        JaxExchange(jopt.sgd(), JaxExchangeConfig(strategy), wa, pod)
    assert str(e.value) == str(je.value)


def test_route_knobs_are_accepted_and_read_nowhere():
    """A JAX call site's ``ExchangeConfig(strategy=..., use_pallas=...)``
    builds; the fields change nothing the exchange does."""
    a = PSExchange(topt.sgd(), ExchangeConfig("pbox", use_pallas=True,
                                              interpret=False), ("data",))
    b = PSExchange(topt.sgd(), ExchangeConfig("pbox"), ("data",))
    assert a.owner_axes == b.owner_axes
    assert a.modeled_bytes(8192, 1, 4) == b.modeled_bytes(8192, 1, 4)
    with pytest.raises(TypeError, match="mesh"):
        b.device_update(torch.zeros(8192), torch.zeros(8192),
                        b.init_slab_state(b.build_space(
                            {"w": torch.zeros(8192)}, {"data": 1}),
                            device="cpu"))
