"""The port's fused wire-path kernel family (``repro_torch.kernels.wire_path``).

(a) ``fused_wire_update`` on CPU tensors (the CUDA kernel's plain version,
    ``wire_fused_torch``) against the port's ``unfused_wire_update`` (the
    quant and fused_agg_opt plain versions) and against the JAX package's
    ``fused_wire_update`` with ``use_pallas=True`` (the Pallas kernel in
    interpret mode), all bitwise, over codec {none, bf16, int8} x {sgd,
    momentum, adam, adamw} x K in {1, 2, 8}
    (tests/test_wire_path.py:70-160 for the JAX package);
(b) the oracle (``ref.py``) at the JAX test's tolerance;
(c) the support matrix, which must route like the JAX package's, and the
    error paths;
(d) the tenancy box's int8 tenant, on the fused route, against the JAX
    tenant with ``fused_wire_path`` on and off
    (tests/test_wire_path.py:262 for the JAX package).
The CUDA kernel is held against the plain version and the unfused kernel
pipeline on the card by tests/test_torch_cuda_kernels.py and chip_smoke.py.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.wire_path import ops as jops  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro_torch.kernels.wire_path import kernel as tkernel  # noqa: E402
from repro_torch.kernels.wire_path import ops as tops  # noqa: E402
from repro_torch.kernels.wire_path.ref import fused_wire_update_ref  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402

CHUNK = 4096  # int8 granule (32x128); bf16/f32 granules divide it
SPECS = {
    "sgd": ("sgd", dict(lr=0.05, weight_decay=1e-4)),
    "momentum": ("momentum", dict(lr=0.05, mu=0.9, weight_decay=1e-4,
                                  nesterov=True)),
    "adam": ("adam", dict(lr=1e-3)),
    "adamw": ("adamw", dict(lr=1e-3, weight_decay=0.01)),
}
TORCH_WIRE = {"none": torch.float32, "bf16": torch.bfloat16,
              "int8": torch.int8}


def _specs(name):
    fn, kw = SPECS[name]
    return getattr(jopt, fn)(**kw), getattr(topt, fn)(**kw)


def _streams(rng, codec, k, n, chunk):
    """Random wire streams for ``codec`` as numpy: (payload as f32 or int8,
    scales or None).  bf16 payloads are carried as their f32 values."""
    g = rng.standard_normal((k, n)).astype(np.float32)
    if codec == "none":
        return g, None
    if codec == "bf16":
        return np.asarray(jnp.asarray(g).astype(jnp.bfloat16), np.float32), None
    gr = g.reshape(k, n // chunk, chunk)
    s = (np.abs(gr).max(axis=2) / 127.0).astype(np.float32)
    q = np.clip(np.rint(gr / s[:, :, None]), -127, 127).astype(np.int8)
    return q.reshape(k, n), s


def _state(rng, spec, n):
    out = []
    for slot in range(spec.num_state_slots):
        s = (rng.standard_normal(n) * 0.1).astype(np.float32)
        out.append(np.abs(s) if slot == 1 else s)
    return out


def _to_jax(codec, pay, sc, p, st):
    jpay = jnp.asarray(pay)
    if codec == "bf16":
        jpay = jpay.astype(jnp.bfloat16)
    return (jpay, None if sc is None else jnp.asarray(sc), jnp.asarray(p),
            tuple(jnp.asarray(s) for s in st))


def _to_torch(codec, pay, sc, p, st):
    return (torch.from_numpy(pay.copy()).to(TORCH_WIRE[codec]),
            None if sc is None else torch.from_numpy(sc.copy()),
            torch.from_numpy(p.copy()),
            tuple(torch.from_numpy(s.copy()) for s in st))


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def _assert_bit_equal(a, b, what):
    bad = int((_bits(a) != _bits(b)).sum())
    assert bad == 0, f"{what}: {bad} elements differ bitwise"


def _case(codec, name, k, n, seed):
    jspec, tspec = _specs(name)
    rng = np.random.default_rng(seed)
    pay, sc = _streams(rng, codec, k, n, CHUNK)
    p = rng.standard_normal(n).astype(np.float32)
    st = _state(rng, jspec, n)
    return jspec, tspec, pay, sc, p, st


@pytest.mark.parametrize("codec", ["none", "bf16", "int8"])
@pytest.mark.parametrize("name", list(SPECS))
@pytest.mark.parametrize("k", [1, 2, 8])
def test_fused_matches_unfused_and_jax_bitwise(codec, name, k):
    jspec, tspec, pay, sc, p, st = _case(codec, name, k, CHUNK,
                                         seed=k * 31 + len(name) * 7 +
                                         len(codec))
    step = 3
    jp, js = jops.fused_wire_update(*_to_jax(codec, pay, sc, p, st),
                                    jspec, jnp.int32(step), codec=codec,
                                    chunk_elems=CHUNK, use_pallas=True)
    fp, fs = tops.fused_wire_update(*_to_torch(codec, pay, sc, p, st), tspec,
                                    step, codec=codec, chunk_elems=CHUNK)
    up, us = tops.unfused_wire_update(*_to_torch(codec, pay, sc, p, st),
                                      tspec, step, codec=codec,
                                      chunk_elems=CHUNK)
    what = f"{codec}/{name}/k={k}"
    _assert_bit_equal(fp.numpy(), up.numpy(), f"params fused vs unfused ({what})")
    _assert_bit_equal(fp.numpy(), jp, f"params vs JAX ({what})")
    assert len(fs) == len(us) == len(js) == jspec.num_state_slots
    for i, (a, b, c) in enumerate(zip(fs, us, js)):
        _assert_bit_equal(a.numpy(), b.numpy(), f"state[{i}] unfused ({what})")
        _assert_bit_equal(a.numpy(), c, f"state[{i}] vs JAX ({what})")


def test_multichunk_matches_jax_bitwise():
    """Three chunks with lr_scale and no averaging: the JAX kernel's
    double-buffered stage/drain pipeline and its block_chunks blocking
    against the port's one pass."""
    jspec, tspec, pay, sc, p, st = _case("int8", "adamw", 2, 3 * CHUNK, 11)
    jp, js = jops.fused_wire_update(*_to_jax("int8", pay, sc, p, st), jspec,
                                    jnp.int32(7), 0.5, codec="int8",
                                    chunk_elems=CHUNK, average=False,
                                    use_pallas=True, block_chunks=3)
    tp, ts = tops.fused_wire_update(*_to_torch("int8", pay, sc, p, st), tspec,
                                    7, 0.5, codec="int8", chunk_elems=CHUNK,
                                    average=False, block_chunks=3)
    _assert_bit_equal(tp.numpy(), jp, "params (int8/adamw/c=3)")
    for a, b in zip(ts, js):
        _assert_bit_equal(a.numpy(), b, "state (int8/adamw/c=3)")


def test_fused_close_to_ref():
    _, tspec, pay, sc, p, st = _case("int8", "momentum", 4, 2 * CHUNK, 3)
    args = _to_torch("int8", pay, sc, p, st)
    fp, fs = tops.fused_wire_update(*args, tspec, 2, codec="int8",
                                    chunk_elems=CHUNK)
    rp, rs = fused_wire_update_ref(*args, tspec, 2, codec="int8",
                                   chunk_elems=CHUNK)
    np.testing.assert_allclose(fp.numpy(), rp.numpy(), rtol=1e-6, atol=1e-6)
    for a, b in zip(fs, rs):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-6)


def test_cpu_tensors_launch_nothing(monkeypatch):
    monkeypatch.setattr(tkernel, "launches", 0)
    _, tspec, pay, sc, p, st = _case("int8", "sgd", 2, CHUNK, 0)
    tops.fused_wire_update(*_to_torch("int8", pay, sc, p, st), tspec, 1,
                           codec="int8", chunk_elems=CHUNK)
    assert tkernel.launches == 0


# -- support matrix --------------------------------------------------------
MATRIX = [
    (codec, name, chunk)
    for codec in ("none", "bf16", "int8", "fp4")
    for name in ("sgd", "momentum", "adam", "adamw", "lion")
    for chunk in (0, 1024, 2048, 4096, 8192, 12288)
]


def test_supported_matrix_matches_jax():
    for codec, name, chunk in MATRIX:
        if name == "lion":
            jspec = dataclasses.replace(jopt.sgd(1e-2), name="lion")
            tspec = dataclasses.replace(topt.sgd(1e-2), name="lion")
        else:
            jspec, tspec = _specs(name)
        assert (tops.wire_path_supported(codec, tspec, chunk)
                == jops.wire_path_supported(codec, jspec, chunk)), \
            (codec, name, chunk)
    # the JAX test's spot checks
    assert tops.wire_path_supported("int8", topt.sgd(1e-2), 4096)
    assert tops.wire_path_supported("bf16", topt.adam(1e-3), 2048)
    assert not tops.wire_path_supported("none", topt.sgd(1e-2), 8192)
    assert not tops.wire_path_supported("int8", topt.sgd(1e-2), 2048)
    assert not tops.wire_path_supported("bf16", topt.sgd(1e-2), 1024)


# -- error paths: the JAX kernel's, in its order -----------------------------
@pytest.mark.parametrize("kw,match", [
    (dict(codec="fp4", chunk_elems=CHUNK), "codec"),
    (dict(codec="int8", chunk_elems=CHUNK + 1), "chunk"),
    (dict(codec="int8", chunk_elems=CHUNK, drop_scales=True), "scales"),
    (dict(codec="int8", chunk_elems=CHUNK, block_chunks=2), "block_chunks"),
    (dict(codec="int8", chunk_elems=3 * CHUNK), "whole chunks"),
])
def test_kernel_error_paths_match_jax(kw, match):
    kw = dict(kw)
    drop = kw.pop("drop_scales", False)
    jspec, tspec, pay, sc, p, _ = _case("int8", "sgd", 2, CHUNK, 0)
    jpay, jsc, jp, _ = _to_jax("int8", pay, sc, p, [])
    tpay, tsc, tp, _ = _to_torch("int8", pay, sc, p, [])
    with pytest.raises(ValueError, match=match):
        jops.fused_wire_update(jpay, None if drop else jsc, jp, (), jspec,
                               jnp.int32(1), **kw)
    with pytest.raises(ValueError, match=match):
        tops.fused_wire_update(tpay, None if drop else tsc, tp, (), tspec, 1,
                               **kw)


def test_unfused_error_paths():
    _, tspec, pay, sc, p, _ = _case("int8", "sgd", 2, CHUNK, 0)
    tpay, _, tp, _ = _to_torch("int8", pay, sc, p, [])
    with pytest.raises(ValueError, match="scales"):
        tops.unfused_wire_update(tpay, None, tp, (), tspec, 1, codec="int8",
                                 chunk_elems=CHUNK)
    with pytest.raises(ValueError, match="codec"):
        tops.unfused_wire_update(tpay, None, tp, (), tspec, 1, codec="fp4",
                                 chunk_elems=CHUNK)


def test_operand_shapes_checked():
    _, tspec, pay, sc, p, _ = _case("int8", "adam", 2, CHUNK, 0)
    tpay, tsc, tp, _ = _to_torch("int8", pay, sc, p, [])
    with pytest.raises(ValueError, match="state slots"):
        tops.fused_wire_update(tpay, tsc, tp, (), tspec, 1, codec="int8",
                               chunk_elems=CHUNK)
    with pytest.raises(ValueError, match="param has shape"):
        tops.fused_wire_update(tpay, tsc, tp[:128], (torch.zeros(CHUNK),) * 2,
                               tspec, 1, codec="int8", chunk_elems=CHUNK)


@pytest.mark.parametrize("fused", [True, False])
def test_tenancy_threads_fused_wire_knob(fused):
    """tests/test_wire_path.py:262 for the port.  The port's box has no
    ``fused_wire_path`` knob: its int8 tenant (and the dedicated twin)
    takes the fused route wherever ``wire_path_supported`` allows, and
    equals the JAX tenant trained with the knob on and off, bitwise in
    every tenant field and box view (``assert_box_same``)."""
    from test_torch_tenancy import JAX, PORT, assert_box_same, dedicated

    from repro.core import tenancy as jten
    from repro_torch.core import tenancy as tten

    n, k = 8192, 2
    rng = np.random.default_rng(21)
    targets = [rng.standard_normal(n).astype(np.float32) for _ in range(k)]
    jbox = jten.MultiJobFabric(num_shards=2, num_racks=2,
                               fused_wire_path=fused)
    tbox = tten.MultiJobFabric(num_shards=2, num_racks=2, device="cpu")
    runs = []
    for pkg, b in ((JAX, jbox), (PORT, tbox)):
        tt = [pkg.arr(t) for t in targets]
        spec = pkg.ten.JobSpec(name="j", params={"w": pkg.zeros(n)},
                               optimizer=pkg.opt.sgd(lr=0.05),
                               num_workers=k, codec="int8")

        def grad_fn(p, batch, tt=tt):
            return {"w": 2 * (p["w"] - tt[batch])}

        h = b.attach(spec)
        pkg.harness(h, grad_fn, lambda w, s: w).run(3)
        runs.append((h, dedicated(pkg, spec, grad_fn, b, 3)))
    (jh, jded), (th, tded) = runs
    assert jh.fabric._fused_wire is fused and jded._fused_wire is fused
    assert th.fabric._fused_wire and tded._fused_wire
    assert th.stats.fused_wire_rounds == 3
    assert jh.stats.fused_wire_rounds == (3 if fused else 0)
    # the one counter that names the route; every other field must match
    jh.stats.fused_wire_rounds = th.stats.fused_wire_rounds
    assert_box_same(jbox, tbox)
    assert torch.equal(tded.params, th.fabric.params)
