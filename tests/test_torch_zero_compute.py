"""The port's ZeroComputeEngine (``repro_torch.core.zero_compute``).

Mirrors the zero-compute half of tests/scripts/hier_and_zero_compute.py
on 8 gloo ranks, a (2, 2, 2) ("pod", "data", "model") mesh with every axis
a worker axis, spawned once for the file (``tests/torch_spmd.py``, ~10 s):
one exchange-only step per strategy under momentum(0.1, 0.9) with equal
unit gradients on every rank moves every parameter to -0.1 (m = g = 1,
p -= lr * m), here bit for bit: every sum and scale is exact.  Each rank's
state is its own slab (the JAX initial state is the global view).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_spmd as S  # noqa: E402

from repro_torch.core.exchange import ExchangeConfig, PSExchange  # noqa: E402
from repro_torch.optim.optimizers import momentum  # noqa: E402


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("zero")
    S.spawn(8, S.zero_compute_ranks, out)
    return out


@pytest.mark.parametrize("strategy", [s for s, _ in S.ZERO_CASES])
def test_zero_compute_moves_params_by_lr(ranks, strategy):
    for r in range(8):
        got = dict(np.load(ranks / f"zero_{strategy}_r{r}.npz"))
        assert got["p"].shape == (S.ZERO_FLAT,)
        assert np.array_equal(got["p"], np.full(S.ZERO_FLAT, -0.1, np.float32))
        owners = {"pbox": 8, "pbox_hier": 4, "allreduce": 1}[strategy]
        np.testing.assert_array_equal(
            got["slot0"], np.ones(S.ZERO_FLAT // owners, np.float32))
        assert int(got["step"]) == 1


def test_init_state_is_this_ranks_slab():
    """The state's slab sizes per strategy, without a process group: only
    ``mesh.shape`` is read."""
    import types

    from repro_torch.core.compression import CompressionConfig
    from repro_torch.core.zero_compute import init_zero_compute_state

    mesh = types.SimpleNamespace(shape={"pod": 2, "data": 2, "model": 2})
    for strategy, pod, n in (("pbox", None, 8192), ("pbox_hier", "pod", 16384),
                             ("allreduce", None, 65536)):
        ex = PSExchange(momentum(0.1, 0.9), ExchangeConfig(
            strategy, compression=CompressionConfig(codec="int8")),
            ("pod", "data", "model"), pod)
        st = init_zero_compute_state(mesh, ex, 65536, device="cpu")
        assert [tuple(s.shape) for s in st["slots"]] == [(n,)]
        assert st["ef"].shape == (n,) and int(st["step"]) == 0
