"""The fused aggregate+optimize kernel's row interface, on the CPU.

The kernel takes its K gradient rows as pointers: a sequence of rows
(``None`` for a zero row), optionally each a worker's whole push read at
the shard's chunk ids, and a ``grad_scale`` folded into its pass.  These
tests hold the plain version (``fused_agg_opt_torch``, the CUDA kernel's
bitwise twin) and the public ``ops`` to:
(a) the (K, N) form and JAX's ``fused_agg_opt_pallas`` in interpret mode,
    bitwise, for every optimizer x K in {1, 2, 3, 8} x the four dtype
    pairs, with zero rows meeting a -0.0 accumulator;
(b) ``slab * inv_nw`` followed by the kernel, bitwise, for f32 and bf16
    slabs at nw = 1, 2, 3;
(c) the wrapper's refusals (row shapes, dtypes, devices, the K capacity);
(d) the f32 fabric path, flat and rack-aggregated, which stacks no
    gradient rows and still matches the JAX fabric bitwise.
The CUDA kernel itself is held against the plain version on the card by
tests/test_torch_cuda_kernels.py and chip_smoke.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core.chunking import ParamSpace as JaxSpace  # noqa: E402
from repro.core.config import FabricConfig as JaxConfig  # noqa: E402
from repro.core.config import PlacementConfig as JaxPlacement  # noqa: E402
from repro.core.config import WireConfig as JaxWire  # noqa: E402
from repro.core.fabric import PBoxFabric as JaxFabric  # noqa: E402
from repro.core.fabric import WorkerHarness as JaxHarness  # noqa: E402
from repro.core.placement import PlacementPlan as JaxPlan  # noqa: E402
from repro.core.topology import NetworkTopology as JaxTopology  # noqa: E402
from repro.kernels.fused_agg_opt import ops as jops  # noqa: E402
from repro.kernels.fused_agg_opt.kernel import fused_agg_opt_pallas  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro_torch.core import fabric as tfabric  # noqa: E402
from repro_torch.core.chunking import ParamSpace  # noqa: E402
from repro_torch.core.config import (  # noqa: E402
    FabricConfig,
    PlacementConfig,
    WireConfig,
)
from repro_torch.core.placement import PlacementPlan  # noqa: E402
from repro_torch.core.topology import NetworkTopology  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.kernels.fused_agg_opt import kernel as tkernel  # noqa: E402
from repro_torch.kernels.fused_agg_opt import ops as tops  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402

CHUNK = 1024
SHARD_CHUNKS, PUSH_CHUNKS = 8, 20  # the Pallas kernel's unit is 8 chunks
N = SHARD_CHUNKS * CHUNK
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
TORCH = {"f32": torch.float32, "bf16": torch.bfloat16}
NULL_ROWS = {1: (), 2: (1,), 3: (1,), 8: (1, 5)}
NEG_ZERO = 64  # leading elements where every row is -0.0 and the param too


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def _pushes(spec, k, gdt, pdt, seed):
    """Seeded whole pushes (K, PUSH_CHUNKS, CHUNK), the shard's chunk ids
    (not one run), the shard's param and state, as numpy f32."""
    rng = np.random.default_rng(seed)
    pushes = rng.standard_normal((k, PUSH_CHUNKS, CHUNK)).astype(np.float32)
    ids = np.array([7, 3, 12, 0, 19, 8, 9, 15])  # no run, both directions
    p = rng.standard_normal(N).astype(np.float32)
    st = [(rng.standard_normal(N) * 0.1).astype(np.float32)
          for _ in range(spec.num_state_slots)]
    if len(st) == 2:
        st[1] = np.abs(st[1])
    # -0.0 rows meeting the zero rows: -0 + 0 is +0, which the sign of the
    # update of a -0.0 param with zero state shows
    for c in ids[:1]:
        pushes[:, c, :NEG_ZERO] = -0.0
    p[:NEG_ZERO] = -0.0
    for s in st:
        s[:NEG_ZERO] = 0.0
    # round through the dtypes once, so every form sees the same values
    pushes = np.asarray(jnp.asarray(pushes, JNP[gdt]).astype(jnp.float32))
    p = np.asarray(jnp.asarray(p, JNP[pdt]).astype(jnp.float32))
    return pushes, ids, p, st


@pytest.mark.parametrize("gdt,pdt", DTYPES)
@pytest.mark.parametrize("k", [1, 2, 3, 8])
@pytest.mark.parametrize("spec_i", range(len(SPECS)), ids=SPEC_IDS)
def test_row_forms_match_tensor_form_and_pallas(spec_i, k, gdt, pdt):
    name, kw = SPECS[spec_i]
    jspec, tspec = getattr(jopt, name)(**kw), getattr(topt, name)(**kw)
    pushes, ids, p, st = _pushes(jspec, k, gdt, pdt, seed=31 * k + spec_i)
    null = NULL_ROWS[k]
    shard = pushes[:, ids].reshape(k, N)
    shard[list(null)] = 0.0  # what the null rows stand for
    packet = jops.scalar_packet(jspec, jnp.int32(5), 0.7)
    jp, js = fused_agg_opt_pallas(
        jnp.asarray(shard, JNP[gdt]), jnp.asarray(p, JNP[pdt]),
        tuple(jnp.asarray(s) for s in st), packet, jspec, interpret=True)

    tg = params_from_numpy(shard, "cpu").to(TORCH[gdt])
    tp = params_from_numpy(p, "cpu").to(TORCH[pdt])
    tst = tuple(torch.from_numpy(s.copy()) for s in st)
    tpacket = torch.from_numpy(np.array(packet))
    whole = params_from_numpy(pushes, "cpu").to(TORCH[gdt])
    rows = [None if i in null else tg[i].clone() for i in range(k)]
    pushed = [None if i in null else whole[i].clone() for i in range(k)]
    got = {
        "(K, N)": tkernel.fused_agg_opt_torch(tg, tp, tst, tpacket, tspec),
        "rows": tkernel.fused_agg_opt_torch(rows, tp, tst, tpacket, tspec),
        "chunk ids": tkernel.fused_agg_opt_torch(
            pushed, tp, tst, tpacket, tspec,
            chunk_ids=torch.from_numpy(ids.astype(np.int64))),
        "ops, chunk ids": tops.fused_aggregate_update(
            pushed, tp, tst, tspec, 5, lr_scale=0.7,
            chunk_ids=torch.from_numpy(ids.astype(np.int64))),
    }
    for form, (p1, s1) in got.items():
        assert p1.dtype == tp.dtype, form
        np.testing.assert_array_equal(_bits(jp), _bits(p1.float().numpy()),
                                      err_msg=form)
        for a, b in zip(js, s1):
            np.testing.assert_array_equal(_bits(a), _bits(b.numpy()),
                                          err_msg=form)


def test_zero_row_turns_the_negative_zero_sum_positive():
    """The case the null rows exist for: -0.0 + 0.0 is +0.0.  SGD on a
    -0.0 param: a +0.0 gradient keeps it -0.0, a -0.0 one makes it +0.0,
    so a fold that skipped the zero row would show."""
    spec = topt.sgd(1e-2)
    row = torch.full((CHUNK,), -0.0)
    p = torch.full((CHUNK,), -0.0)
    packet = tops.scalar_packet(spec, 1, device="cpu")
    alone, _ = tkernel.fused_agg_opt_torch([row], p, (), packet, spec,
                                           average=False)
    with_zero, _ = tkernel.fused_agg_opt_torch([row, None], p, (), packet,
                                               spec, average=False)
    stacked, _ = tkernel.fused_agg_opt_torch(
        torch.stack([row, torch.zeros(CHUNK)]), p, (), packet, spec,
        average=False)
    assert not torch.signbit(alone).any()
    assert torch.signbit(with_zero).all()
    assert torch.equal(with_zero.view(torch.int32), stacked.view(torch.int32))


@pytest.mark.parametrize("spec_name", ["sgd", "adamw"])
@pytest.mark.parametrize("nw", [1, 2, 3])
@pytest.mark.parametrize("gdt,pdt", DTYPES)
def test_grad_scale_equals_the_eager_product(gdt, pdt, nw, spec_name):
    """``grad_scale=1/nw`` inside the pass == ``slab * (1/nw)`` then the
    kernel, bitwise: the exchange's ``allreduce`` / ``pbox`` update."""
    spec = getattr(topt, spec_name)(1e-3)
    rng = np.random.default_rng(nw)
    slab = torch.from_numpy(
        rng.standard_normal(3 * CHUNK + 5).astype(np.float32) * 3
    ).to(TORCH[gdt])
    p = torch.from_numpy(rng.standard_normal(slab.numel()).astype(
        np.float32)).to(TORCH[pdt])
    st = tuple(torch.from_numpy(np.abs(rng.standard_normal(
        slab.numel())).astype(np.float32) * 0.1)
        for _ in range(spec.num_state_slots))
    inv_nw = 1.0 / nw
    want = tops.fused_aggregate_update([slab * inv_nw], p, st, spec, 3,
                                       average=False)
    got = tops.fused_aggregate_update([slab], p, st, spec, 3, average=False,
                                      grad_scale=inv_nw)
    for a, b in zip((want[0], *want[1]), (got[0], *got[1])):
        np.testing.assert_array_equal(_bits(a.float().numpy()),
                                      _bits(b.float().numpy()))


@pytest.mark.parametrize("gdt", ["f32", "bf16"])
def test_grad_scale_multiplies_the_folded_sum(gdt):
    """With K > 1 rows the scale applies to the f32 fold, rounded once to
    the rows' dtype: the same as one row holding that rounded product."""
    spec = topt.momentum(1e-2, 0.9)
    rng = np.random.default_rng(4)
    rows = [torch.from_numpy(rng.standard_normal(2 * CHUNK).astype(
        np.float32)).to(TORCH[gdt]) for _ in range(3)]
    p = torch.from_numpy(rng.standard_normal(2 * CHUNK).astype(np.float32))
    st = (torch.zeros(2 * CHUNK),)
    acc = rows[0].float() + rows[1].float() + rows[2].float()
    one = (acc * (1.0 / 3)).to(TORCH[gdt])
    want = tops.fused_aggregate_update([one], p, st, spec, 2, average=False)
    got = tops.fused_aggregate_update(rows, p, st, spec, 2, average=False,
                                      grad_scale=1.0 / 3)
    assert torch.equal(want[0], got[0]) and torch.equal(want[1][0], got[1][0])


def _refusal_case(bad):
    spec = topt.adamw(1e-3)
    n = 2 * CHUNK
    rows = [torch.zeros(n), torch.zeros(n)]
    p, st = torch.zeros(n), (torch.zeros(n), torch.zeros(n))
    ids = None
    if bad == "row_shape":
        rows[1] = torch.zeros(n - 8)
    elif bad == "row_dtype":
        rows[1] = torch.zeros(n, dtype=torch.bfloat16)
    elif bad == "row_device":
        rows[1] = torch.empty(n, device="meta")
    elif bad == "row_int":
        rows = [torch.zeros(n, dtype=torch.int32)]
    elif bad == "capacity":
        rows = [torch.zeros(n)] * (tkernel.MAX_ROWS + 1)
    elif bad == "all_null":
        rows = [None, None]
    elif bad == "ids_dtype":
        ids = torch.tensor([0, 1], dtype=torch.int32)
    elif bad == "ids_split":
        ids = torch.tensor([0, 1, 2], dtype=torch.int64)
    elif bad == "ids_partial":
        rows = [torch.zeros(5 * CHUNK + 3)]
        ids = torch.tensor([4, 0], dtype=torch.int64)
    elif bad == "non_contiguous":
        rows[0] = torch.zeros(n, 2)[:, 0]  # stride 2
    return spec, rows, p, st, ids


REFUSALS = ["row_shape", "row_dtype", "row_device", "row_int", "capacity",
            "all_null", "ids_dtype", "ids_split", "ids_partial",
            "non_contiguous"]


@pytest.mark.parametrize("bad", REFUSALS)
def test_rows_are_refused_before_any_launch(bad):
    """Both the public entry point and the CUDA wrapper itself refuse
    malformed rows with a ValueError, before anything reaches the card
    (the wrapper is called here with CPU tensors, which it checks first)."""
    spec, rows, p, st, ids = _refusal_case(bad)
    with pytest.raises(ValueError):
        tops.fused_aggregate_update(rows, p, st, spec, 1, chunk_ids=ids)
    packet = tops.scalar_packet(spec, 1, device="cpu")
    launches = tkernel.launches
    with pytest.raises(ValueError):
        tkernel.fused_agg_opt_cuda(rows, p, st, packet, spec, chunk_ids=ids)
    assert tkernel.launches == launches


def test_capacity_is_inclusive():
    """MAX_ROWS rows are taken (the largest row-pointer capacity)."""
    spec = topt.sgd(1e-2)
    rows = [torch.ones(CHUNK)] * tkernel.MAX_ROWS
    p, _ = tops.fused_aggregate_update(rows, torch.zeros(CHUNK), (), spec, 1)
    assert torch.equal(p, torch.full((CHUNK,), -1e-2))


# -- the fabric: no stacked inbox ----------------------------------------
WORKERS, ROUNDS = 4, 3
W_ELEMS, B_ELEMS = 13000, 77  # 13 chunks of 1024 (12 + the ragged b)


class _NoStack:
    """``torch`` as the fabric module sees it, with ``stack`` refused."""

    def __getattr__(self, name):
        if name == "stack":
            raise AssertionError("the f32 fabric path stacked gradient rows")
        return getattr(torch, name)


def _targets():
    rng = np.random.default_rng(23)
    return [{"w": rng.standard_normal(W_ELEMS).astype(np.float32) * (i + 1),
             "b": rng.standard_normal(B_ELEMS).astype(np.float32)}
            for i in range(WORKERS)]


def _owner(num_chunks, layout):
    if layout == "interleaved":  # no shard owns one run of chunks
        return np.arange(num_chunks) % 2
    return None


def _jax_run(layout, racks, quorum):
    targets = [{k: jnp.asarray(v) for k, v in t.items()} for t in _targets()]
    params = {"w": jnp.zeros((W_ELEMS,)), "b": jnp.zeros((B_ELEMS,))}
    space = JaxSpace.build(params, chunk_elems=CHUNK)
    owner = _owner(space.num_chunks, layout)
    fab = JaxFabric(space, jopt.adamw(3e-3), space.flatten(params),
                    config=JaxConfig(
                        num_shards=2, num_workers=WORKERS,
                        min_push_fraction=0.75 if quorum else 1.0,
                        wire=JaxWire(topology=None if racks is None else
                                     JaxTopology(num_workers=WORKERS,
                                                 num_racks=racks)),
                        placement=JaxPlacement(plan=None if owner is None else
                                               JaxPlan(num_shards=2,
                                                       num_racks=racks or 1,
                                                       chunk_owner=owner,
                                                       origin="solved"))))
    JaxHarness(fab, lambda p, w: jax.tree.map(lambda a, b: 2 * (a - b), p,
                                              targets[w]),
               lambda w, s: w).run(ROUNDS)
    return fab


def _torch_run(layout, racks, quorum):
    targets = [{k: torch.from_numpy(v) for k, v in t.items()}
               for t in _targets()]
    params = {"w": torch.zeros(W_ELEMS), "b": torch.zeros(B_ELEMS)}
    space = ParamSpace.build(params, chunk_elems=CHUNK)
    owner = _owner(space.num_chunks, layout)
    fab = tfabric.PBoxFabric(
        space, topt.adamw(3e-3), space.flatten(params), device="cpu",
        config=FabricConfig(
            num_shards=2, num_workers=WORKERS,
            min_push_fraction=0.75 if quorum else 1.0,
            wire=WireConfig(topology=None if racks is None else
                            NetworkTopology(num_workers=WORKERS,
                                            num_racks=racks)),
            placement=PlacementConfig(plan=None if owner is None else
                                      PlacementPlan(num_shards=2,
                                                    num_racks=racks or 1,
                                                    chunk_owner=owner,
                                                    origin="solved"))))
    tfabric.WorkerHarness(fab, lambda p, w: {k: 2 * (p[k] - targets[w][k])
                                             for k in p},
                          lambda w, s: w).run(ROUNDS)
    return fab


@pytest.mark.parametrize("quorum", [False, True], ids=["sync", "quorum"])
@pytest.mark.parametrize("racks", [None, 2], ids=["flat", "racks2"])
@pytest.mark.parametrize("layout", ["runs", "interleaved"])
def test_f32_fabric_stacks_no_rows_and_matches_jax(layout, racks, quorum,
                                                   monkeypatch):
    """``_aggregate`` and ``_rack_aggregate`` hand the kernel the workers'
    pushes as they are (the rack chain's absorbed streams as null rows, an
    interleaved layout through its chunk-id table): ``torch.stack`` is
    refused inside the fabric module, and the bits still equal JAX's."""
    ref = _jax_run(layout, racks, quorum)
    monkeypatch.setattr(tfabric, "torch", _NoStack())
    fab = _torch_run(layout, racks, quorum)
    monkeypatch.undo()
    assert fab.stats.steps == ref.stats.steps
    if layout == "interleaved":
        assert all(isinstance(s.rows, torch.Tensor) for s in fab.shards)
    np.testing.assert_array_equal(_bits(ref.params),
                                  _bits(fab.params.numpy()))
    for js, ts in zip(ref.shards, fab.shards):
        for a, b in zip(js.state, ts.state):
            np.testing.assert_array_equal(_bits(a), _bits(b.numpy()))
