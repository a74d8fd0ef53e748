"""The recsys cells on the SPMD path: a (2, 4) ("data", "model") mesh of 8
gloo ranks spawned once for the file (``tests/torch_spmd.py
recsys_ranks``), the JAX side (``tests/torch_spmd_jax.py recsys``) on 8
host devices beside them, both from the JAX package's tp = 4 SMOKE weights
of each of the four recsys archs (tables row-sharded over the 4 model
ranks, the batch over the 2 workers):

  * one step of the ``train_batch`` cell (pbox, SGD 0.01): every rank's
    flat against JAX's row for its model group, and the loss;
  * the ``serve_p99`` cell's scores on each rank's rows against JAX's
    block, and **bitwise** against tp = 1 (whole tables, no collective)
    on the same rows: the lookup's psum_scatter adds only zeros to the
    owning shard's row;
  * the ``retrieval_cand`` cell's scores on each rank's candidate slice
    against JAX's block;
  * DLRM's ``pbox_sparse`` step (``runtime/sparse_push``) against JAX's,
    and tests/scripts/sparse_push_equivalence.py: the sparse step against
    the dense one from the same weights and batch, loss within 1e-6, MLPs
    at rtol 1e-5 / atol 1e-6, tables within 5e-3 (the bf16 wire).

The JAX bounds: f32 parameters after one SGD step at rtol 1e-5 / atol
1e-6 and losses within 1e-6 (the frameworks sum in other orders), scores
at rtol 1e-5 / atol 1e-6.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import torch_spmd as S  # noqa: E402

WORLD = S.RS_MESH[0] * S.RS_MESH[1]
TP = S.RS_MESH[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("recsys_spmd")
    proc = S.start_jax("recsys", root)
    try:
        S.spawn(WORLD, S.recsys_ranks, root, timeout=240.0)
    finally:
        S.finish_jax(proc, timeout=240.0)
    return root


def _rank(root, arch, r):
    return dict(np.load(root / f"rs_{arch}_r{r}.npz"))


def _jax(root, arch):
    return dict(np.load(root / f"jax_rs_{arch}.npz"))


@pytest.mark.parametrize("arch", S.RS_ARCHS)
def test_train_step_matches_jax(runs, arch):
    j = _jax(runs, arch)
    for r in range(WORLD):
        got = _rank(runs, arch, r)
        g = int(got["model"])
        np.testing.assert_allclose(got["train_pflat"][0], j["train_pflat"][g],
                                   rtol=1e-5, atol=1e-6)
        assert abs(float(got["train_loss"]) - float(j["train_loss"])) < 1e-6


@pytest.mark.parametrize("arch", S.RS_ARCHS)
def test_serve_matches_jax_and_tp1_bitwise(runs, arch):
    j = _jax(runs, arch)["serve"]
    per = j.shape[0] // WORLD
    for r in range(WORLD):
        got = _rank(runs, arch, r)
        # out spec P(("data", "model")): rank r's block is block r
        np.testing.assert_allclose(got["serve"], j[r * per:(r + 1) * per],
                                   rtol=1e-5, atol=1e-6)
        assert np.array_equal(got["serve"].view(np.uint32),
                              got["serve_tp1"].view(np.uint32)), r


@pytest.mark.parametrize("arch", S.RS_ARCHS)
def test_retrieval_matches_jax(runs, arch):
    j = _jax(runs, arch)["retrieval"]
    per = j.shape[0] // WORLD
    for r in range(WORLD):
        got = _rank(runs, arch, r)["retrieval"]
        assert got.shape == (per,) and np.isfinite(got).all()
        np.testing.assert_allclose(got, j[r * per:(r + 1) * per], rtol=1e-5,
                                   atol=1e-6)


def test_sparse_step_matches_jax(runs):
    j = _jax(runs, "dlrm-mlperf")
    for r in range(WORLD):
        got = _rank(runs, "dlrm-mlperf", r)
        g = int(got["model"])
        np.testing.assert_allclose(got["sparse_pflat"][0], j["sparse_pflat"][g],
                                   rtol=1e-5, atol=1e-6)
        assert abs(float(got["sparse_loss"]) - float(j["sparse_loss"])) < 1e-6
        for key in (k for k in got if k.startswith("sparse_tables/")):
            n = got[key].shape[0]
            np.testing.assert_allclose(got[key], j[key][g * n:(g + 1) * n],
                                       rtol=1e-5, atol=1e-6)


def test_sparse_equals_dense_within_the_script_bounds(runs):
    """sparse_push_equivalence.py on the port: the sparse step's loss, MLPs
    and tables against the dense step's from the same weights and batch."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.chunking import ParamSpace
    from repro_torch.models.recsys import models as RS
    from repro_torch.runtime.trainer import local_template

    cfg = get_arch("dlrm-mlperf").smoke_config
    # a rank's local shapes, and the two steps' flat spaces (2 owners)
    full = local_template(RS.dlrm_init(cfg, None, TP, device="meta"),
                          RS.dlrm_specs(cfg, TP), _RanksMesh())
    dense_space = ParamSpace.build({k: v for k, v in full.items()
                                    if k != "tables"}, num_owners=2)
    full_space = ParamSpace.build(full, num_owners=2)
    for r in range(WORLD):
        got = _rank(runs, "dlrm-mlperf", r)
        assert abs(float(got["sparse_loss"]) - float(got["train_loss"])) < 1e-6
        dense = full_space.unflatten(torch.from_numpy(got["train_pflat"][0]))
        sparse = dense_space.unflatten(
            torch.from_numpy(got["sparse_pflat"][0]))
        for k in ("bot", "top"):
            for kk in dense[k]:
                np.testing.assert_allclose(sparse[k][kk].numpy(),
                                           dense[k][kk].numpy(), rtol=1e-5,
                                           atol=1e-6)
        err = max(float(np.max(np.abs(got[f"sparse_tables/{name}"]
                                      - dense["tables"][name].numpy())))
                  for name in dense["tables"])
        assert err < 5e-3, err


class _RanksMesh:
    shape = {"data": S.RS_MESH[0], "model": TP}
