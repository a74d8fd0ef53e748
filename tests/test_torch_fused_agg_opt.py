"""The port's fused aggregate+optimize kernel family.

(a) ``fused_agg_opt_torch`` (the CUDA kernel's plain version) against the
    JAX Pallas kernel in interpret mode, given JAX's own scalar packet:
    bitwise, over the sweep of tests/test_kernels.py.
(b) the port's ``ops`` against the port's oracle (``ref.py``), at the JAX
    test's tolerances (the two differ in op order: ``* 1/K`` against
    ``/ K``, ``m * bc1`` against ``m / (1 - beta1**t)``).
(c) the dispatch: CPU tensors take the plain version and launch nothing;
    validation; the kernel module imports without ``nvcc``.
The CUDA kernel itself is held against the plain version on the card by
tests/test_torch_cuda_kernels.py and chip_smoke.py.
"""
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.fused_agg_opt import ops as jops  # noqa: E402
from repro.kernels.fused_agg_opt.kernel import fused_agg_opt_pallas  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.kernels.fused_agg_opt import kernel as tkernel  # noqa: E402
from repro_torch.kernels.fused_agg_opt import ops as tops  # noqa: E402
from repro_torch.kernels.fused_agg_opt.ref import fused_aggregate_update_ref  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402

SLAB = 8 * 128 * 8  # one chunk, the Pallas kernel's unit
SPECS = [
    ("sgd", dict(lr=1e-2, weight_decay=0.01)),
    ("momentum", dict(lr=1e-2, mu=0.9)),
    ("momentum", dict(lr=1e-2, mu=0.9, nesterov=True)),
    ("adam", dict(lr=1e-3)),
    ("adamw", dict(lr=1e-3, weight_decay=0.1)),
]
SPEC_IDS = ["sgd_wd", "momentum", "nesterov", "adam", "adamw_wd"]
DTYPES = [("f32", "f32"), ("bf16", "bf16"), ("bf16", "f32"), ("f32", "bf16")]
JNP = {"f32": jnp.float32, "bf16": jnp.bfloat16}


def make_inputs(spec, k, n, gdt, pdt, seed):
    """Seeded numpy inputs, as JAX arrays (grads/param in their dtypes) and
    as the same bits in torch on the CPU."""
    rng = np.random.default_rng(seed)
    g = jnp.asarray(rng.standard_normal((k, n)).astype(np.float32), JNP[gdt])
    p = jnp.asarray(rng.standard_normal(n).astype(np.float32), JNP[pdt])
    st = [(rng.standard_normal(n) * 0.1).astype(np.float32)
          for _ in range(spec.num_state_slots)]
    if len(st) == 2:
        st[1] = np.abs(st[1])  # Adam's second moment is non-negative
    jst = tuple(jnp.asarray(s) for s in st)
    tg = params_from_numpy(np.asarray(g), "cpu")
    tp = params_from_numpy(np.asarray(p), "cpu")
    tst = tuple(torch.from_numpy(s.copy()) for s in st)
    return (g, p, jst), (tg, tp, tst)


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("gdt,pdt", DTYPES)
@pytest.mark.parametrize("k", [1, 2, 8])
@pytest.mark.parametrize("spec_i", range(len(SPECS)), ids=SPEC_IDS)
def test_plain_version_matches_pallas_bitwise(spec_i, k, gdt, pdt):
    name, kw = SPECS[spec_i]
    jspec, tspec = getattr(jopt, name)(**kw), getattr(topt, name)(**kw)
    (g, p, jst), (tg, tp, tst) = make_inputs(jspec, k, SLAB, gdt, pdt,
                                             seed=17 * k + spec_i)
    packet = jops.scalar_packet(jspec, jnp.int32(5), 0.7)
    jp, js = fused_agg_opt_pallas(g, p, jst, packet, jspec, interpret=True)
    tp1, ts1 = tkernel.fused_agg_opt_torch(
        tg, tp, tst, torch.from_numpy(np.array(packet)), tspec)
    assert tp1.dtype == tp.dtype
    np.testing.assert_array_equal(_bits(jp), _bits(tp1.float().numpy()))
    assert len(js) == len(ts1) == jspec.num_state_slots
    for a, b in zip(js, ts1):
        np.testing.assert_array_equal(_bits(a), _bits(b.numpy()))


def test_plain_version_matches_pallas_multi_chunk():
    """Three chunks (the Pallas kernel's multi-block grid), AdamW, K=2."""
    jspec, tspec = jopt.adamw(1e-3, weight_decay=0.1), topt.adamw(
        1e-3, weight_decay=0.1)
    (g, p, jst), (tg, tp, tst) = make_inputs(jspec, 2, 3 * SLAB, "f32", "f32",
                                             seed=3)
    packet = jops.scalar_packet(jspec, jnp.int32(3), 1.0)
    jp, js = fused_agg_opt_pallas(g, p, jst, packet, jspec, interpret=True)
    tp1, ts1 = tkernel.fused_agg_opt_torch(
        tg, tp, tst, torch.from_numpy(np.array(packet)), tspec)
    np.testing.assert_array_equal(_bits(jp), _bits(tp1.numpy()))
    for a, b in zip(js, ts1):
        np.testing.assert_array_equal(_bits(a), _bits(b.numpy()))


@pytest.mark.parametrize("spec_i", range(len(SPECS)), ids=SPEC_IDS)
@pytest.mark.parametrize("step", [1, 2, 5, 100])
def test_scalar_packet_matches_jax(spec_i, step):
    """torch's and XLA's f32 pow agree on these steps, so the fabric's
    packet needs no help from JAX."""
    name, kw = SPECS[spec_i]
    jp = jops.scalar_packet(getattr(jopt, name)(**kw), jnp.int32(step), 0.7)
    tp = tops.scalar_packet(getattr(topt, name)(**kw), step, 0.7,
                            device="cpu")
    assert tuple(tp.shape) == (1, 4) and tp.dtype == torch.float32
    np.testing.assert_array_equal(_bits(jp), _bits(tp.numpy()))


@pytest.mark.parametrize("gdt,pdt", DTYPES)
@pytest.mark.parametrize("n_chunks", [1, 3])
@pytest.mark.parametrize("k", [1, 2, 8])
@pytest.mark.parametrize("spec_i", range(len(SPECS)), ids=SPEC_IDS)
def test_ops_matches_ref(spec_i, k, n_chunks, gdt, pdt):
    """The port's own layering, as tests/test_kernels.py holds the JAX
    package's: ops (kernel path) against the oracle."""
    name, kw = SPECS[spec_i]
    spec = getattr(topt, name)(**kw)
    _, (g, p, st) = make_inputs(spec, k, SLAB * n_chunks + 77, gdt, pdt,
                                seed=n_chunks * 100 + k)
    p1, s1 = tops.fused_aggregate_update(g, p, st, spec, 5, lr_scale=0.7)
    p2, s2 = fused_aggregate_update_ref(g, p, st, spec, 5, lr_scale=0.7)
    tol = 1e-6 if pdt == "f32" else 1e-2
    np.testing.assert_allclose(p1.float().numpy(), p2.float().numpy(),
                               rtol=tol, atol=tol)
    for a, b in zip(s1, s2):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)


def test_ops_refuses_other_devices():
    """Only CUDA and CPU tensors have an update path; any other device is
    refused rather than sent to some other implementation."""
    spec = topt.adam(1e-3)
    n = 1000
    g = torch.empty((2, n), device="meta")
    p, st = torch.empty(n, device="meta"), (torch.empty(n, device="meta"),
                                            torch.empty(n, device="meta"))
    with pytest.raises(ValueError, match="runs on cuda or cpu, not meta"):
        tops.fused_aggregate_update(g, p, st, spec, 4)


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    """CPU tensors never reach the CUDA wrapper, and the launch count
    stays where it was."""
    monkeypatch.setattr(tkernel, "launches", 0)

    def no_launch(*a, **kw):
        raise AssertionError("the CUDA wrapper was called for CPU tensors")

    monkeypatch.setattr(tkernel, "fused_agg_opt_cuda", no_launch)
    spec = topt.momentum(1e-2, 0.9)
    _, (g, p, st) = make_inputs(spec, 2, 3 * SLAB + 77, "f32", "f32", seed=1)
    p1, s1 = tops.fused_aggregate_update(g, p, st, spec, 1)
    packet = tops.scalar_packet(spec, 1, device="cpu")
    p2, s2 = tkernel.fused_agg_opt_torch(g, p, st, packet, spec)
    assert torch.equal(p1, p2) and torch.equal(s1[0], s2[0])
    assert tkernel.launches == 0


@pytest.mark.parametrize("bad", ["state_count", "param_len", "grads_rank"])
def test_ops_validation_errors_mirror_jax(bad):
    """Malformed operands that the JAX wrapper refuses, the port refuses
    too, with a ValueError before any dispatch."""
    jspec, tspec = jopt.adamw(1e-3), topt.adamw(1e-3)
    (g, p, jst), (tg, tp, tst) = make_inputs(jspec, 2, SLAB, "f32", "f32",
                                             seed=2)
    if bad == "state_count":
        jst, tst = jst[:1], tst[:1]
    elif bad == "param_len":
        p, tp = p[:-8], tp[:-8]
    else:
        g, tg = g[0], tg[0]
    with pytest.raises((ValueError, TypeError)):
        jax.block_until_ready(
            jops.fused_aggregate_update(g, p, jst, jspec, jnp.int32(1)))
    with pytest.raises(ValueError):
        tops.fused_aggregate_update(tg, tp, tst, tspec, 1)


def test_ops_refuses_non_f32_state():
    """The kernel reads state slots as f32; the wrapper refuses others."""
    spec = topt.adamw(1e-3)
    _, (g, p, st) = make_inputs(spec, 2, SLAB, "f32", "f32", seed=2)
    with pytest.raises(ValueError, match="state slots"):
        tops.fused_aggregate_update(g, p, (st[0], st[1].to(torch.bfloat16)),
                                    spec, 1)


def test_unknown_optimizer_raises():
    spec = topt.OptimizerSpec(name="lamb")
    with pytest.raises(ValueError, match="unknown optimizer"):
        tops.fused_aggregate_update(torch.zeros(1, 8), torch.zeros(8), (),
                                    spec, 1)


def test_kernel_module_imports_without_nvcc():
    """Importing the kernel family needs neither nvcc nor a card: the build
    runs only when a CUDA tensor first reaches the wrapper."""
    code = (
        "import os, shutil; os.environ['PATH'] = ''\n"
        "assert shutil.which('nvcc') is None\n"
        "import repro_torch.kernels.fused_agg_opt.ops as ops\n"
        "import repro_torch.kernels.fused_agg_opt.kernel as k\n"
        "import sys\n"
        "assert 'repro_torch.kernels._build' not in sys.modules\n"
        "assert k.launches == 0\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
