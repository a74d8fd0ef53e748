"""The port's optimizer rules against the JAX package's ``apply_update``.

Same seeded numpy inputs through both.  Tolerance rtol 1e-6 with atol
1e-7: XLA on the CPU may contract a multiply-add into an FMA inside the
jitted oracle, eager torch never does, so the two can differ by half an
ulp of a rounded product such as ``lr * upd`` (about 5e-9 here), which is
large relative to a result that nearly cancels."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.optim import optimizers as jopt  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402

SPECS = [
    ("sgd", dict(lr=1e-2, weight_decay=0.01)),
    ("momentum", dict(lr=1e-2, mu=0.9)),
    ("momentum", dict(lr=1e-2, mu=0.9, nesterov=True)),
    ("adam", dict(lr=1e-3)),
    ("adamw", dict(lr=1e-3, weight_decay=0.1)),
]
IDS = ["sgd_wd", "momentum", "nesterov", "adam", "adamw_wd"]


@pytest.mark.parametrize("step", [1, 7])
@pytest.mark.parametrize("spec_i", range(len(SPECS)), ids=IDS)
def test_apply_update_matches_jax(spec_i, step):
    name, kw = SPECS[spec_i]
    jspec, tspec = getattr(jopt, name)(**kw), getattr(topt, name)(**kw)
    rng = np.random.default_rng(spec_i)
    n = 4099
    p = rng.standard_normal(n).astype(np.float32)
    g = rng.standard_normal(n).astype(np.float32)
    st = [(rng.standard_normal(n) * 0.1).astype(np.float32)
          for _ in range(jspec.num_state_slots)]
    if len(st) == 2:
        st[1] = np.abs(st[1])
    jp, js = jax.jit(jopt.apply_update, static_argnums=0)(
        jspec, jnp.asarray(p), jnp.asarray(g),
        tuple(jnp.asarray(s) for s in st), jnp.int32(step), 0.7)
    tp, ts = topt.apply_update(tspec, torch.from_numpy(p), torch.from_numpy(g),
                               tuple(torch.from_numpy(s) for s in st), step,
                               0.7)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6, atol=1e-7)
    assert len(ts) == len(js) == jspec.num_state_slots
    for a, b in zip(ts, js):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("spec_i", range(len(SPECS)), ids=IDS)
def test_spec_fields_match_jax(spec_i):
    name, kw = SPECS[spec_i]
    jspec, tspec = getattr(jopt, name)(**kw), getattr(topt, name)(**kw)
    import dataclasses

    assert dataclasses.asdict(jspec) == dataclasses.asdict(tspec)
    assert jspec.num_state_slots == tspec.num_state_slots


def test_init_opt_state_is_f32_zeros_on_the_params_device():
    st = topt.init_opt_state(topt.adamw(), torch.ones(5, dtype=torch.bfloat16))
    assert len(st) == 2
    assert all(s.dtype == torch.float32 and s.device.type == "cpu"
               and not s.any() for s in st)


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError, match="unknown optimizer"):
        topt.apply_update(topt.OptimizerSpec(name="lamb"), torch.zeros(2),
                          torch.zeros(2), (), 1)
