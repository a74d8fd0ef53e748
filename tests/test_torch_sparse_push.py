"""``runtime/sparse_push.sparse_table_update``: the four cases of
tests/test_sparse_push.py on the port (the hybrid step's dense half
through the port's ``PBoxFabric``), and parity with the JAX function.

  * one worker (no collective), on the same tables, ids and bf16
    cotangents: **bitwise** with unique ids, and with duplicates too: the
    port's ``index_put_(accumulate=True)`` folds them one at a time from
    the table row in batch order on the CPU, as XLA's scatter-add does;
  * three workers inside JAX's jitted ``shard_map`` (a subprocess on 3
    host devices, ``tests/torch_spmd_jax.py sparse_push``) against the
    port over a mesh whose all-gather concatenates the three workers'
    ids and cotangents (the gloo all-gather's result, made in-process):
    bitwise.  The ``exact`` case (zero tables, unit cotangents, lr 0.01)
    tells f32(lr) / 3 from f32(lr) * f32(1/3), one ulp apart: JAX folds
    the constant by a true division, and so does the port;
  * row 0 keeps its bits when only foreign ids land on it.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import torch_spmd as S  # noqa: E402

from repro.models.common import Dist as JaxDist  # noqa: E402
from repro.runtime.sparse_push import (  # noqa: E402
    sparse_table_update as jax_update,
)
from repro_torch.core.chunking import TILE_ELEMS, ParamSpace  # noqa: E402
from repro_torch.core.config import FabricConfig  # noqa: E402
from repro_torch.core.fabric import PBoxFabric  # noqa: E402
from repro_torch.models.common import Dist  # noqa: E402
from repro_torch.optim.optimizers import sgd  # noqa: E402
from repro_torch.runtime.sparse_push import sparse_table_update  # noqa: E402

V, D, B = 32, 8, 6  # vocab rows, embedding dim, batch
LR = 0.1


def make_tables(key=0):
    rng = np.random.default_rng(key)
    return {"t0": torch.from_numpy(rng.standard_normal((V, D))
                                   .astype(np.float32))}


def _bf16(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)


def dense_reference(tables, ids, cot, lr, nw=1):
    """The dense-gradient SGD the sparse path must reproduce: scatter the
    cotangents into a full (V, D) gradient, then t -= lr * g / nw."""
    out = {}
    for name, t in tables.items():
        g = np.zeros_like(t.numpy())
        for b in range(ids.shape[0]):
            g[int(ids[b, 0])] += cot[b, 0].float().numpy()
        out[name] = t.numpy() - lr * g / nw
    return out


def _copy(tables):
    return {k: v.clone() for k, v in tables.items()}


def test_sparse_update_matches_dense_sgd_single_device():
    tables = make_tables()
    rng = np.random.default_rng(1)
    ids = torch.from_numpy(rng.integers(0, V, size=(B, 1)).astype(np.int32))
    cot = _bf16(rng.standard_normal((B, 1, D)))
    new = sparse_table_update(_copy(tables), ids, cot, Dist.none(), (), LR)
    ref = dense_reference(tables, ids.numpy(), cot, LR)
    np.testing.assert_allclose(new["t0"].numpy(), ref["t0"], rtol=1e-5,
                               atol=1e-6)
    # untouched rows are bit-identical (no dense gradient materialized)
    untouched = np.setdiff1d(np.arange(V), ids.numpy()[:, 0])
    np.testing.assert_array_equal(new["t0"].numpy()[untouched],
                                  tables["t0"].numpy()[untouched])


def test_duplicate_ids_accumulate():
    tables = make_tables()
    ids = torch.tensor([[3], [3], [3]], dtype=torch.int32)
    cot = torch.ones((3, 1, D), dtype=torch.bfloat16)
    new = sparse_table_update(_copy(tables), ids, cot, Dist.none(), (), LR)
    expect = tables["t0"][3].numpy() - LR * 3.0
    np.testing.assert_allclose(new["t0"][3].numpy(), expect, rtol=1e-5,
                               atol=1e-6)


def test_rows_outside_this_shard_are_ignored():
    """A shard owns rows [midx*V_loc, (midx+1)*V_loc); foreign ids neither
    update anything nor corrupt row 0 (the masked scatter target)."""
    tables = make_tables()
    ids = torch.tensor([[V + 5], [2 * V]], dtype=torch.int32)
    cot = torch.ones((2, 1, D), dtype=torch.bfloat16) * 7.0
    new = sparse_table_update(_copy(tables), ids, cot, Dist.none(), (), LR)
    assert torch.equal(new["t0"].view(torch.int32),
                       tables["t0"].view(torch.int32))


def test_hybrid_step_dense_through_sharded_fabric_sparse_tables():
    """One step of a model with a dense head and an embedding table: the
    dense half through a 2-shard port ``PBoxFabric``, the table through
    ``sparse_table_update``; both against the all-dense reference."""
    K = 2  # workers
    rng = np.random.default_rng(2)
    dense = {"w": torch.from_numpy(rng.standard_normal(2 * TILE_ELEMS)
                                   .astype(np.float32))}
    tables = make_tables()
    space = ParamSpace.build(dense, chunk_elems=TILE_ELEMS)
    fab = PBoxFabric(space, sgd(LR), space.flatten(dense),
                     config=FabricConfig(num_shards=2, num_workers=K),
                     device="cpu")
    gdense = [torch.from_numpy(rng.standard_normal(space.flat_elems)
                               .astype(np.float32)) for _ in range(K)]
    ids = [torch.from_numpy(rng.integers(0, V, size=(B, 1)).astype(np.int32))
           for _ in range(K)]
    cot = [_bf16(rng.standard_normal((B, 1, D))) for _ in range(K)]
    for w in range(K):
        fab.pull(w)
        fab.push(w, gdense[w])
    ids_all, cot_all = torch.cat(ids), torch.cat(cot)
    new_tables = sparse_table_update(_copy(tables), ids_all, cot_all,
                                     Dist.none(), (), LR)
    expect_dense = space.flatten(dense).numpy() - LR * np.mean(
        [g.numpy() for g in gdense], axis=0)
    np.testing.assert_allclose(fab.params.numpy(), expect_dense, rtol=1e-6,
                               atol=1e-7)
    ref = dense_reference(tables, ids_all.numpy(), cot_all, LR, nw=1)
    np.testing.assert_allclose(new_tables["t0"].numpy(), ref["t0"],
                               rtol=1e-5, atol=1e-6)
    # the wire win the module exists for: ids + cot bytes << dense slab
    assert ids_all.numel() * 4 + cot_all.numel() * 2 < V * D * 4


@pytest.mark.parametrize("dups", [False, True], ids=["unique", "dups"])
def test_one_worker_matches_jax_bitwise(dups):
    rng = np.random.default_rng(3)
    t = rng.standard_normal((2, V, D)).astype(np.float32)
    n = 3 * B
    ids = (rng.integers(0, 4, (n, 2)) if dups
           else np.stack([rng.permutation(V)[:n]] * 2, 1)).astype(np.int32)
    cot = rng.standard_normal((n, 2, D)).astype(np.float32)
    want = jax_update({f"t{i}": jnp.asarray(t[i]) for i in range(2)},
                      jnp.asarray(ids), jnp.asarray(cot), JaxDist.none(), (),
                      LR)
    got = sparse_table_update(
        {f"t{i}": torch.from_numpy(t[i].copy()) for i in range(2)},
        torch.from_numpy(ids), torch.from_numpy(cot), Dist.none(), (), LR)
    for k in got:
        assert np.array_equal(got[k].numpy().view(np.uint32),
                              np.asarray(want[k]).view(np.uint32)), k


class _Workers:
    """A 3-worker ``("data",)`` mesh seen from one rank: the all-gather
    returns every worker's tensor in worker order, as gloo's does."""

    def __init__(self, parts: dict):
        self.parts = parts  # dtype -> every worker's tensor of that dtype

    def all_gather(self, x, axes, axis=0, tiled=True):
        return torch.cat(self.parts[x.dtype], dim=axis)

    def axis_size(self, axes):
        return S.SP_NW


@pytest.fixture(scope="module")
def jax_nw3(tmp_path_factory):
    root = tmp_path_factory.mktemp("sparse_push")
    S.finish_jax(S.start_jax("sparse_push", root))
    return root


@pytest.mark.parametrize("name", list(S.SPARSE_PUSH_CASES))
def test_three_workers_match_jax_bitwise(jax_nw3, name):
    lr, kind = S.SPARSE_PUSH_CASES[name]
    inp = S.sparse_push_inputs(kind)
    ids = [torch.from_numpy(x) for x in inp["ids"]]
    cot = [torch.from_numpy(x).to(torch.bfloat16) for x in inp["cot"]]
    mesh = _Workers({torch.int32: ids, torch.bfloat16: cot})
    tables = {k: torch.from_numpy(v.copy()) for k, v in inp["tables"].items()}
    got = sparse_table_update(tables, ids[0], torch.from_numpy(inp["cot"][0]),
                              Dist.none(), ("data",), lr, mesh=mesh)
    want = dict(np.load(jax_nw3 / f"jax_sp_{name}.npz"))
    for k in got:
        assert np.array_equal(got[k].numpy().view(np.uint32),
                              want[k].view(np.uint32)), k
    if name == "exact":  # each touched element is -scale: a division
        scale = np.float32(lr) / np.float32(S.SP_NW)
        assert scale != np.float32(lr) * np.float32(1.0 / S.SP_NW)
        assert (want["t0"][0] == -scale).all()
