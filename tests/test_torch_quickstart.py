"""The slice as a whole: the quickstart loop (examples/quickstart.py) in both
packages, the port's through its example program
(``repro_torch.examples.quickstart``), from the same initial weights (JAX's
``init_params`` through ``interop``) and the same batch streams.

gemma3 SMOKE, 4 shards, 2 workers, 3 rounds.  With adamw(3e-3) the
per-round losses agree within rtol 1e-4: AdamW's normalised update can turn
a 1e-9 gradient difference near zero into a step the size of lr, so AdamW
parameters are held through the loss.  With momentum(0.05, 0.9) the
fabric's parameters also agree after every round within atol 1e-4.  The
int8 wire (error feedback on, fused wire path) is held to the momentum
case's tolerances: a gradient that differs by 1e-9 can move an int8 value
by one step at a rounding tie, which is a scale (amax/127) before the
average and lr 0.05 after it, far under 1e-4 at these gradient sizes.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_arch as jax_get_arch  # noqa: E402
from repro.core.chunking import ParamSpace as JaxSpace  # noqa: E402
from repro.core.compression import CompressionConfig as JaxCompression  # noqa: E402
from repro.core.config import FabricConfig as JaxConfig  # noqa: E402
from repro.core.config import WireConfig as JaxWire  # noqa: E402
from repro.core.fabric import PBoxFabric as JaxFabric  # noqa: E402
from repro.core.fabric import WorkerHarness as JaxHarness  # noqa: E402
from repro.data.synthetic import lm_batches as jax_lm_batches  # noqa: E402
from repro.models.common import Dist  # noqa: E402
from repro.models.transformer import init_params as jax_init  # noqa: E402
from repro.models.transformer import lm_loss as jax_lm_loss  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro_torch.examples import quickstart  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402

ROUNDS, WORKERS, SHARDS = 3, 2, 4


def jax_loop(spec, codec="none"):
    """examples/quickstart.py, round by round; returns (losses, params
    after each round)."""
    cfg = jax_get_arch("gemma3-1b").smoke_config
    params = jax_init(cfg, jax.random.PRNGKey(0), tp=1)
    space = JaxSpace.build(params)
    fab = JaxFabric(space, spec, space.flatten(params),
                    config=JaxConfig(num_shards=SHARDS, num_workers=WORKERS,
                                     wire=JaxWire(compression=JaxCompression(
                                         codec=codec))))
    streams = [jax_lm_batches(cfg.vocab, 4, 32, seed=w) for w in range(WORKERS)]
    lossg = jax.jit(jax.value_and_grad(
        lambda p, t, lab: jax_lm_loss(p, t, lab, cfg, Dist.none(), 1)[0]))
    losses = []

    def grad_fn(p, wstep):
        b = next(streams[wstep[0]])
        loss, g = lossg(p, jnp.asarray(b["tokens"]), jnp.asarray(b["labels"]))
        losses.append(float(loss))
        return g

    h = JaxHarness(fab, grad_fn, lambda w, s: (w, s))
    flats = []
    for r in range(1, ROUNDS + 1):
        h.run(r)
        flats.append(np.asarray(fab.params))
    assert fab.stats.fused_wire_rounds == (ROUNDS if codec != "none" else 0)
    return losses, flats, params


def torch_loop(spec, jax_params, codec="none"):
    """The port's example (``repro_torch.examples.quickstart``), its fabric
    and workers from ``build`` run round by round."""
    params = params_from_numpy(jax.tree.map(np.asarray, jax_params), "cpu")
    run = quickstart.build(device="cpu", spec=spec, codec=codec,
                           params=params)
    fab, h = run["fabric"], run["harness"]
    flats = []
    for r in range(1, ROUNDS + 1):
        h.run(r)
        flats.append(fab.params.numpy().copy())
    assert fab.stats.steps == ROUNDS
    assert fab.stats.fused_wire_rounds == (ROUNDS if codec != "none" else 0)
    return run["losses"], flats


def test_quickstart_adamw_losses_match_jax():
    """The example's ``main`` (its AdamW(3e-3) default) for ROUNDS rounds
    from JAX's weights: JAX's per-round losses within rtol 1e-4, and its
    fabric's final params."""
    jlosses, jflats, jparams = jax_loop(jopt.adamw(3e-3))
    out = quickstart.main(device="cpu", rounds=ROUNDS,
                          params=params_from_numpy(
                              jax.tree.map(np.asarray, jparams), "cpu"))
    tlosses = out["losses"]
    assert len(tlosses) == len(jlosses) == ROUNDS * WORKERS
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4)
    assert all(np.isfinite(tlosses))
    assert out["pushes"] == ROUNDS * WORKERS
    assert out["params"].shape == jflats[-1].shape


def test_quickstart_momentum_params_match_jax_every_round():
    jlosses, jflats, jparams = jax_loop(jopt.momentum(0.05, 0.9))
    tlosses, tflats = torch_loop(topt.momentum(0.05, 0.9), jparams)
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4)
    for r, (a, b) in enumerate(zip(tflats, jflats), start=1):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4,
                                   err_msg=f"round {r}")


def test_quickstart_int8_wire_params_match_jax_every_round():
    jlosses, jflats, jparams = jax_loop(jopt.momentum(0.05, 0.9), "int8")
    tlosses, tflats = torch_loop(topt.momentum(0.05, 0.9), jparams, "int8")
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4)
    for r, (a, b) in enumerate(zip(tflats, jflats), start=1):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4,
                                   err_msg=f"round {r}")
