"""EquiformerV2's parallel regimes in the port against the JAX package's
``shard_map``: 4 gloo ranks spawned once for the file
(``tests/torch_spmd.py gnn_ranks``), the JAX side (``tests/torch_spmd_jax.py
gnn``) on 4 host devices beside them.  Every ``GNN_CASES`` case runs
``EQ.loss_fn`` on the rank's pieces of JAX's SMOKE weights and its cut of
one global batch (``shard_batch`` by the plan's batch spec), then
``grad_sync``:

  * channel TP at (1, 2) (``full_graph_sm``, the graph whole) and (2, 2)
    (``minibatch_lg``, each worker's padded subgraph);
  * edge parallelism at (2, 2): ``full_graph_sm`` (edges over the model
    axis, tests/scripts/edge_parallel_equivalence.py) and ``molecule``
    (edges over (data, model), each worker's ids rebased to its block);
  * node-sharded full graphs at (2, 1) (``ogb_products``: global
    ``edge_src``, local ``edge_dst``, the bf16 carry).

Each rank's loss matches its worker's in JAX at rtol 1e-5 (bf16: 1e-3)
and its gradients the rank's block of its worker's within 1e-5 of the leaf's largest
entry (bf16: 2e-2).  As the equivalence script holds it: on a replicated
graph, loss x tp equals the single-device loss, and the synced
gradients equal the single-device ones within 1e-4.  The ranks 0-1 also
build every graph cell's ``variant="ep"`` plan on a (1, 2) mesh, at SMOKE
and full size, against JAX's builder (shapes, dtypes, specs, flat,
FLOPs)."""
import json

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import torch_spmd as S  # noqa: E402

LOSS_RTOL = {"f32": 1e-5, "bf16": 1e-3}
GRAD_TOL = {"f32": 1e-5, "bf16": 2e-2}  # of the leaf's largest entry
SINGLE_GRAD_ATOL = 1e-4  # edge_parallel_equivalence.py's bound


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("gnn")
    proc = S.start_jax("gnn", root)
    try:
        S.spawn(4, S.gnn_ranks, root)
    finally:
        S.finish_jax(proc)
    return root


def _ranks(name):
    mesh = S.GNN_CASES[name][1]
    first = 0 if mesh != (2, 1) else 2
    return range(first, first + mesh[0] * mesh[1])


def _case(root, name, r):
    return dict(np.load(root / f"gnn_{name}_r{r}.npz"))


def _block(want, got, j):
    """JAX's global gradient cut to model coordinate ``j``'s block along
    the dimension the spec shards (where the local length differs)."""
    for d, (a, n) in enumerate(zip(want.shape, got.shape)):
        if a != n:
            return np.take(want, np.arange(j * n, (j + 1) * n), axis=d)
    return want


@pytest.mark.parametrize("name", list(S.GNN_CASES))
def test_loss_and_synced_grads_match_jax(runs, name):
    j = dict(np.load(runs / f"jax_gnn_{name}.npz"))
    kind = "bf16" if S.GNN_CASES[name][0] == "ogb_products" else "f32"
    for r in _ranks(name):
        got = _case(runs, name, r)
        w = int(got["data"])  # JAX's outputs are stacked by worker
        np.testing.assert_allclose(got["loss"], j["loss"][w],
                                   rtol=LOSS_RTOL[kind])
        keys = sorted(k for k in got if k.startswith("g/"))
        assert keys == sorted(k for k in j if k.startswith("g/"))
        for k in keys:
            want = _block(j[k][w], got[k], int(got["model"]))
            scale = float(np.max(np.abs(want)))
            err = float(np.max(np.abs(got[k] - want)))
            assert err <= GRAD_TOL[kind] * scale + 1e-12, (r, k, err, scale)


@pytest.mark.parametrize("name", ["tp_1x2", "ep_2x2"])
def test_replicated_graph_equals_the_single_device_run(runs, name):
    """edge_parallel_equivalence.py: loss x tp equals the single-device
    loss, and the synced gradients (the rank's block under channel TP,
    the whole under ep) equal the single-device ones within 1e-4."""
    j = dict(np.load(runs / f"jax_gnn_{name}.npz"))
    tp = S.GNN_CASES[name][1][1]
    for r in _ranks(name):
        got = _case(runs, name, r)
        np.testing.assert_allclose(got["loss"] * tp, j["loss1"], rtol=1e-5)
        for k in (k for k in got if k.startswith("g/")):
            want = _block(j["g1/" + k[2:]], got[k], int(got["model"]))
            assert float(np.max(np.abs(got[k] - want))) < SINGLE_GRAD_ATOL, k


def test_ep_plans_on_a_1x2_mesh_match_jax(runs):
    want = json.loads((runs / "jax_gnn_plans.json").read_text())
    for r in range(2):
        got = json.loads((runs / f"gnn_plans_r{r}.json").read_text())
        assert got == want
    # ep pads every edge array to a multiple of the shards, in both
    assert want["full_graph_sm/0"]["args"]["edge_src"][2] == ["model"]
    assert want["molecule/1"]["args"]["wigner"][2] == [["data", "model"]]
