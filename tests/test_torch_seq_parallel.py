"""Sequence parallelism in the port (``TransformerConfig.seq_parallel``
and ``build_cell(..., variant="sp")``) against the port without it and
against the JAX package, on a (2, 4) ("data", "model") mesh of 8 gloo
ranks spawned once for the file (``tests/torch_spmd.py``), the JAX side
(``tests/torch_spmd_jax.py seq_parallel``) on 8 host devices beside them.

tests/scripts/seq_parallel_equivalence.py's model (2 layers, d = 64, 8
heads over 2 kv heads, ``attn_chunk`` 8, QKV biases, f32) and two more
(``torch_spmd.SP_CASES``): 2 heads over 4 model ranks (R = 2: the
duplicated layout's division after the psum-scatter) and the MoE FFN.
From the JAX package's tp = 4 weights, each case holds:

  * the cross entropy with SP equal to the one without, rtol 1e-5 (the
    script's bound);
  * the parameters after one pbox SGD step through
    ``make_ps_train_step`` equal with and without SP, within 2e-6 (the
    script's), and equal to JAX's SP step within 2e-6, its loss metric
    within rtol 1e-5 (and JAX's step without SP for the script's model);
  * prefill and decode, which ignore ``seq_parallel`` as JAX's do, bitwise
    equal with and without it.

``build_cell(..., variant="sp")`` builds JAX's plan: the microbatches (a
quarter of the config's, floored at 1) and the abstract shapes.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import torch_spmd as S  # noqa: E402

WORLD = 2 * S.SP_TP
CE_RTOL = 1e-5  # seq_parallel_equivalence.py's loss bound
PARAM_BOUND = 2e-6  # its parameter bound after one SGD step


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("seq_parallel")
    proc = S.start_jax("seq_parallel", root)
    try:
        S.spawn(WORLD, S.seq_parallel_ranks, root, timeout=240.0)
    finally:
        S.finish_jax(proc, timeout=240.0)
    return root


def _ranks(root, case):
    return [dict(np.load(root / f"sp_{case}_r{r}.npz")) for r in range(WORLD)]


@pytest.mark.parametrize("case", list(S.SP_CASES))
def test_sp_cross_entropy_equals_baseline(runs, case):
    for got in _ranks(runs, case):
        assert np.isfinite(got["ce_sp"])
        np.testing.assert_allclose(got["ce_sp"], got["ce_base"],
                                   rtol=CE_RTOL)


@pytest.mark.parametrize("case", list(S.SP_CASES))
def test_sp_step_equals_baseline(runs, case):
    for got in _ranks(runs, case):
        err = np.abs(got["pflat_sp"] - got["pflat_base"]).max()
        assert err < PARAM_BOUND, err
        # the step moved the parameters by far more than the bound
        assert np.abs(got["pflat_sp"]).max() > 0
        np.testing.assert_allclose(got["loss_sp"], got["loss_base"],
                                   rtol=CE_RTOL)


@pytest.mark.parametrize("case", list(S.SP_CASES))
def test_sp_step_matches_jax(runs, case):
    want = dict(np.load(runs / f"jax_sp_{case}_out.npz"))
    tags = ("sp", "base") if case in S.SP_JAX_BASELINE else ("sp",)
    for got in _ranks(runs, case):
        g = int(got["model"])
        for tag in tags:
            err = np.abs(got[f"pflat_{tag}"][0] - want[f"pflat_{tag}"][g]).max()
            print(f"{case} {tag} model rank {g}: max |port - JAX| {err:.3g}")
            assert err < PARAM_BOUND, (tag, err)
            np.testing.assert_allclose(got[f"loss_{tag}"],
                                       want[f"loss_{tag}"], rtol=CE_RTOL)


@pytest.mark.parametrize("case", list(S.SP_CASES))
def test_prefill_and_decode_ignore_sp(runs, case):
    for got in _ranks(runs, case):
        for key in ("nxt", "dec", "k", "v"):
            np.testing.assert_array_equal(got[f"{key}_sp"], got[f"{key}_base"])


@pytest.mark.parametrize("arch,smoke", [("gemma3-1b", False),
                                        ("qwen2-72b", False),
                                        ("qwen2-72b", True)])
def test_build_cell_sp_variant_matches_jax(arch, smoke):
    """The port's ``train_4k`` plan with and without ``variant="sp"``
    against JAX's on a 1 x 1 mesh: the microbatches (qwen2-72b's 8 become
    2 under SP), the scalar meta and the global abstract shapes."""
    from repro.launch.mesh import make_mesh as jax_mesh
    from repro.launch.steps import build_cell as jax_build
    from repro_torch.launch.mesh import RecordingMesh
    from repro_torch.launch.steps import build_cell

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [shapes(v) for v in tree]
        return None if tree is None else tuple(tree.shape)

    for variant in (None, "sp"):
        plan = build_cell(arch, "train_4k", RecordingMesh((1, 1), (
            "data", "model")), smoke=smoke, variant=variant)
        jplan = jax_build(arch, "train_4k", jax_mesh((1, 1), (
            "data", "model")), smoke=smoke, variant=variant)
        scalars = {k: v for k, v in jplan.meta.items()
                   if isinstance(v, (int, float, str))}
        assert {k: plan.meta[k] for k in scalars} == scalars
        assert shapes(plan.abstract_args) == shapes(jplan.abstract_args)
        if arch == "qwen2-72b" and not smoke:
            assert plan.meta["microbatches"] == (2 if variant else 8)
