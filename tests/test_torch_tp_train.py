"""The port's PS train step with tensor parallelism on a (2, 4) ("data",
"model") mesh of 8 gloo ranks, spawned once for the file
(``tests/torch_spmd.py``), the JAX side (``tests/torch_spmd_jax.py
tp_train``) on 8 host devices beside them.

  * tests/scripts/grad_equivalence.py's cases (``dense_gqa``: kv
    replicated, QKV biases; ``dup_R2``: the duplicated q/o layout, R = 2),
    pbox with SGD(0.1), two steps from the JAX package's tp = 4 weights:
    every rank's local params against the matching shard of a one-process
    reference of 2 logical workers on the tp = 1 weights (each worker's
    gradient by ``lm_loss_and_grad``, their mean, the tree-wise
    ``make_optimizer``; q/o tiled R times), at the script's 2e-6; and
    against JAX's pipeline at the same bound.
  * tests/scripts/train_restart_elastic.py's TP half through
    ``launch/train.main`` at ``--mesh 2x4`` (gemma3-1b SMOKE, 4 heads over
    4 ranks, kv replicated): the loss falls, and a run stopped after step
    3 and resumed to step 6 ends bitwise equal to the uninterrupted one
    (params, both AdamW slots, losses) on every rank; the checkpoint holds
    every model group's row.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import torch_spmd as S  # noqa: E402

from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim.optimizers import make_optimizer, sgd  # noqa: E402

WORLD = 2 * S.TP
BOUND = 2e-6  # grad_equivalence.py's max param error


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("tp_train")
    proc = S.start_jax("tp_train", root)
    try:
        S.spawn(WORLD, S.tp_train_ranks, root, timeout=240.0)
    finally:
        S.finish_jax(proc, timeout=240.0)
    return root


def _rank(root, name, r):
    return dict(np.load(root / f"{name}_r{r}.npz"))


def _reference(cfg, p1_np):
    """Two SGD steps of 2 logical workers on the tp = 1 model, then the
    tree in the tp = 4 layout (q/o tiled R times)."""
    params = params_from_numpy(p1_np, "cpu")
    init_fn, upd_fn = make_optimizer(sgd(1e-1))
    state = init_fn(params)
    toks, labs = (torch.from_numpy(a) for a in S.lm_tokens(cfg.vocab, 4))
    for _ in range(S.TP_TRAIN_STEPS):
        grads = [T.lm_loss_and_grad(params, toks[w * 2:(w + 1) * 2],
                                    labs[w * 2:(w + 1) * 2], cfg)[1]
                 for w in range(2)]
        params, state = upd_fn(params, _mean(*grads), state)
    R = cfg.attn_replicas(S.TP)
    lay = dict(params["layers"])
    lay["wq"] = lay["wq"].repeat(1, 1, R)
    lay["wo"] = lay["wo"].repeat(1, R, 1)
    if "bq" in lay:
        lay["bq"] = lay["bq"].repeat(1, R)
    return {**params, "layers": lay}


def _mean(a, b):
    if isinstance(a, dict):
        return {k: _mean(a[k], b[k]) for k in a}
    return (a + b) / 2


def _shard(x, spec, g):
    for i, s in enumerate(spec):
        if s == "model":
            n = x.shape[i] // S.TP
            return x.narrow(i, g * n, n)
    return x


@pytest.mark.parametrize("name", list(S.TP_TRAIN_CASES))
def test_tp_step_matches_the_one_process_reference(runs, name):
    cfg = S.tp_config(S.TP_TRAIN_CASES[name])
    j = dict(np.load(runs / f"jax_tp_train_{name}.npz"))
    ref = S.flat_keys(_reference(cfg, S._unflat(
        {k[3:]: v for k, v in j.items() if k.startswith("p1/")})))
    specs = S.flat_keys(T.make_param_specs(cfg, S.TP))
    for r in range(WORLD):
        got = _rank(runs, f"tp_train_{name}", r)
        g = int(got["model"])
        for k, spec in specs.items():
            want = _shard(ref[k], spec, g).numpy()
            mine = got[f"p/{k}"]
            if k in ("embed", "head"):  # rows past the vocab stay zero
                rows = mine.shape[0]
                want = ref[k].numpy()[g * rows:(g + 1) * rows]
                assert not mine[want.shape[0]:].any()
                mine = mine[:want.shape[0]]
            err = np.max(np.abs(mine - want)) if mine.size else 0.0
            assert err <= BOUND, (r, k, err)


@pytest.mark.parametrize("name", list(S.TP_TRAIN_CASES))
def test_tp_step_matches_jax(runs, name):
    j = dict(np.load(runs / f"jax_tp_train_{name}_out.npz"))
    for r in range(WORLD):
        got = _rank(runs, f"tp_train_{name}", r)
        g = int(got["model"])
        err = np.max(np.abs(got["pflat"][0] - j["pflat"][g]))
        assert err <= BOUND, (r, err)


def test_tp_loss_falls(runs):
    for r in range(WORLD):
        losses = _rank(runs, "tp_launch_full", r)["losses"]
        assert len(losses) == 6 and np.isfinite(losses).all()
        assert losses[-1] < losses[0], losses
        np.testing.assert_array_equal(
            losses, _rank(runs, "tp_launch_full", 0)["losses"])


def test_tp_crash_restart_is_bitwise(runs):
    for r in range(WORLD):
        full = _rank(runs, "tp_launch_full", r)
        res = _rank(runs, "tp_launch_resumed", r)
        assert int(res["start"]) == 3
        np.testing.assert_array_equal(res["losses"], full["losses"][3:])
        for key in ("pflat", "slot0", "slot1"):
            assert np.array_equal(res[key].view(np.uint32),
                                  full[key].view(np.uint32)), (r, key)


def test_tp_checkpoint_holds_every_model_group(runs):
    host, _ = Checkpointer(runs / "full").restore()
    assert int(host["step"]) == 6 and host["pflat"].shape[0] == S.TP
    for r in range(WORLD):
        got = _rank(runs, "tp_launch_full", r)
        g = int(got["model"])
        np.testing.assert_array_equal(host["pflat"][g], got["pflat"][0])
        n = got["slot0"].shape[-1]
        w = r // S.TP  # the data coordinate: its owned slab
        np.testing.assert_array_equal(host["slot0"][g, w * n:(w + 1) * n],
                                      got["slot0"][0])
