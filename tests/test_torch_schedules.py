"""The port's learning-rate schedules and tree-wise optimizer
(``repro_torch.optim.schedules``, ``optimizers.make_optimizer``) against
the JAX package's.

``constant_schedule`` and ``linear_warmup`` are held bit for bit over
steps -2..N.  The cosine schedules differ only where the two ``cos``
implementations round differently (the port computes the cosine in f64
and rounds once to f32; XLA's f32 cosine is not correctly rounded
everywhere), so they are held to one f32 ulp at the peak:
``|port - jax| <= peak * 2**-23``.  ``make_optimizer`` is held bit for bit
against JAX's for SGD, momentum (Nesterov, weight decay), Adam and AdamW
over eight steps of gemma3-1b's SMOKE tree (nested dicts), with no schedule and with a
linear warmup, and to 1e-6 relative with the warmup-cosine schedule.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from test_torch_chunking import as_numpy, smoke_tree  # noqa: E402

from repro.optim import optimizers as jopt  # noqa: E402
from repro.optim import schedules as jsched  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402
from repro_torch.optim import schedules as tsched  # noqa: E402

EXACT = [("constant_schedule", (0.3,)), ("constant_schedule", ()),
         ("linear_warmup", (7, 0.5)), ("linear_warmup", (0,)),
         ("linear_warmup", (3,))]
COSINE = [("cosine_schedule", (13, 0.1, 2.0)), ("cosine_schedule", (1,)),
          ("cosine_schedule", (100, 0.0, 2.5)),
          ("cosine_schedule", (1000, 0.05, 3e-3)),
          ("warmup_cosine_schedule", (5, 37, 0.05, 3e-3)),
          ("warmup_cosine_schedule", (0, 9)),
          ("warmup_cosine_schedule", (10, 4106, 0.1, 1.0)),
          ("warmup_cosine_schedule", (4, 3))]


def values(name, args, steps):
    """(JAX values, port values from int32 tensors, port values from
    Python ints) over ``steps``."""
    jf, tf = getattr(jsched, name)(*args), getattr(tsched, name)(*args)
    j = np.array([np.asarray(jf(jnp.asarray(s, jnp.int32))) for s in steps],
                 np.float32)
    outs = [tf(torch.tensor(int(s), dtype=torch.int32)) for s in steps]
    for o in outs:
        assert o.dtype == torch.float32 and o.shape == ()
    t = np.array([o.numpy() for o in outs], np.float32)
    i = np.array([tf(int(s)).numpy() for s in steps], np.float32)
    return j, t, i


@pytest.mark.parametrize("name,args", EXACT,
                         ids=[f"{n}{a}" for n, a in EXACT])
def test_exact_schedules_match_jax(name, args):
    j, t, i = values(name, args, np.arange(-2, 45))
    np.testing.assert_array_equal(t.view(np.uint32), j.view(np.uint32))
    np.testing.assert_array_equal(i.view(np.uint32), j.view(np.uint32))


@pytest.mark.parametrize("name,args", COSINE,
                         ids=[f"{n}{a}" for n, a in COSINE])
def test_cosine_schedules_match_jax(name, args):
    total = args[1] if name == "warmup_cosine_schedule" else args[0]
    peak = args[-1] if len(args) == (4 if "warmup" in name else 3) else 1.0
    j, t, i = values(name, args, np.arange(-2, total + 3))
    np.testing.assert_array_equal(t.view(np.uint32), i.view(np.uint32))
    err = np.abs(j.astype(np.float64) - t.astype(np.float64))
    assert err.max() <= peak * 2.0**-23, (err.max(), peak)


def test_schedules_follow_the_step_device():
    step = torch.tensor(4, dtype=torch.int32)
    for fn in (tsched.constant_schedule(2.0), tsched.linear_warmup(8),
               tsched.cosine_schedule(10), tsched.warmup_cosine_schedule(2, 9)):
        out = fn(step)
        assert out.device == step.device and out.dtype == torch.float32


SPECS = {"sgd": dict(lr=0.1, weight_decay=0.01),
         "momentum": dict(lr=0.05, nesterov=True, weight_decay=1e-3),
         "adam": dict(lr=1e-3),
         "adamw": dict(lr=3e-3)}
SCHEDULES = {"none": None, "warmup": ("linear_warmup", (3, 1.0)),
             "warmup_cosine": ("warmup_cosine_schedule", (3, 20, 0.1, 1.0))}


def _bits(x):
    x = np.asarray(x)
    return x.view(np.uint16 if x.dtype.itemsize == 2 else np.uint32)


@pytest.mark.parametrize("schedule", list(SCHEDULES))
@pytest.mark.parametrize("name", list(SPECS))
def test_make_optimizer_matches_jax(name, schedule):
    jtree = smoke_tree()
    ntree = as_numpy(jtree)
    sched = SCHEDULES[schedule]
    jinit, jupdate = jopt.make_optimizer(
        getattr(jopt, name)(**SPECS[name]),
        None if sched is None else getattr(jsched, sched[0])(*sched[1]))
    tinit, tupdate = topt.make_optimizer(
        getattr(topt, name)(**SPECS[name]),
        None if sched is None else getattr(tsched, sched[0])(*sched[1]))
    jp = jtree
    tp = params_from_numpy(ntree, "cpu")
    js, ts = jinit(jp), tinit(tp)
    assert ts["step"].dtype == torch.int32 and int(ts["step"]) == 0
    assert len(ts["slots"]) == len(js["slots"])
    rng = np.random.default_rng(19)
    for _ in range(8):
        g = jax.tree.map(
            lambda a: rng.standard_normal(a.shape).astype(np.float32), ntree)
        jp, js = jupdate(jp, jax.tree.map(jnp.asarray, g), js)
        tp, ts = tupdate(tp, params_from_numpy(g, "cpu"), ts)
    assert int(ts["step"]) == int(js["step"]) == 8
    jleaves = {"p": as_numpy(jp)}
    tleaves = {"p": tp}
    for k, (jsl, tsl) in enumerate(zip(js["slots"], ts["slots"])):
        jleaves[f"s{k}"] = as_numpy(jsl)
        tleaves[f"s{k}"] = tsl
    flat_j = jax.tree_util.tree_leaves_with_path(jleaves)
    for path, a in flat_j:
        b = tleaves
        for key in path:
            b = b[key.key]
        b = b.float().numpy() if b.dtype == torch.bfloat16 else b.numpy()
        a = np.asarray(a, np.float32) if a.dtype != np.float32 else a
        if schedule == "warmup_cosine":
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=0)
        else:
            np.testing.assert_array_equal(_bits(np.asarray(b, np.float32)),
                                          _bits(np.asarray(a, np.float32)))
