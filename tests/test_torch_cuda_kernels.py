"""The port's CUDA kernels on the card, against their plain versions.

These tests need a CUDA card, ``nvcc`` and nothing of JAX; without a card
they skip.  On the card run them with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda_kernels.py

The first test builds every ``csrc/*.cu`` into ``build/torch_kernels``.
"""
import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.core.chunking import ParamSpace  # noqa: E402
from repro_torch.core.compression import CompressionConfig  # noqa: E402
from repro_torch.core.config import FabricConfig, WireConfig  # noqa: E402
from repro_torch.core.fabric import PBoxFabric, WorkerHarness  # noqa: E402
from repro_torch.core.sparse import SparseTier  # noqa: E402
from repro_torch.data.synthetic import lm_batches  # noqa: E402
from repro_torch.kernels.embedding_bag import kernel as ekernel  # noqa: E402
from repro_torch.kernels.embedding_bag import ops as eops  # noqa: E402
from repro_torch.kernels.fused_agg_opt import kernel as tkernel  # noqa: E402
from repro_torch.kernels.fused_agg_opt import ops as tops  # noqa: E402
from repro_torch.kernels.quant import kernel as qkernel  # noqa: E402
from repro_torch.kernels.quant import ops as qops  # noqa: E402
from repro_torch.kernels.wire_path import kernel as wkernel  # noqa: E402
from repro_torch.kernels.wire_path import ops as wops  # noqa: E402
from repro_torch.models.transformer import init_params, lm_loss_and_grad  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402

SLAB = 8192
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
CHIP_SMOKE = Path(__file__).resolve().parents[1] / "chip_smoke.py"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(spec, k, n, gdt, pdt, seed, device):
    rng = np.random.default_rng(seed)
    g = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32))
    p = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    st = [torch.from_numpy((rng.standard_normal(n) * 0.1).astype(np.float32))
          for _ in range(spec.num_state_slots)]
    if len(st) == 2:
        st[1] = st[1].abs()
    return (g.to(device, DTYPES[gdt]), p.to(device, DTYPES[pdt]),
            tuple(s.to(device) for s in st))


@functools.lru_cache(maxsize=None)
def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", CHIP_SMOKE)
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    return chip_smoke


@pytest.mark.gpu
def test_kernel_matches_plain_version_bitwise(cuda):
    """chip_smoke.py's kernel sweep (5 optimizers x K in {1, 2, 3, 8} x 4
    dtype pairs x 2 sizes x average on and off), which raises on the first
    case that differs."""
    assert _chip_smoke().kernel_sweep(cuda) == 0.0


@pytest.mark.gpu
def test_quant_kernels_match_plain_versions_bitwise(cuda):
    """chip_smoke.py's quant sweep: N in {8192, 37*8192} x chunk in {128,
    8192}, and chunk 65536 (the two-pass route), with zero, NaN and inf
    chunks, each slab also off alignment."""
    worst = _chip_smoke().quant_sweep(cuda)
    assert worst == {"quantize_chunks": 0.0, "dequantize_chunks": 0.0}


@pytest.mark.gpu
def test_wire_kernel_matches_plain_and_unfused_bitwise(cuda):
    """chip_smoke.py's wire sweep: none/bf16/int8 x 5 optimizers x K in
    {1, 2, 3, 8} x average on and off, against wire_fused_torch and the
    unfused kernel pipeline."""
    assert _chip_smoke().wire_sweep(cuda) == 0.0


@pytest.mark.gpu
def test_codec_ops_launch_the_kernels_on_cuda_tensors(cuda, monkeypatch):
    for mod, attr in ((qkernel, "quantize_launches"),
                      (qkernel, "dequantize_launches"),
                      (wkernel, "launches"), (tkernel, "launches")):
        monkeypatch.setattr(mod, attr, 0)
    spec = topt.adamw(1e-3)
    x = torch.randn(2 * SLAB, device=cuda)
    q, s = qops.quantize_chunks(x, SLAB)
    dec = qops.dequantize_chunks(q, s, SLAB)
    assert q.is_cuda and dec.is_cuda
    _, p, st = _inputs(spec, 1, 2 * SLAB, "f32", "f32", 0, cuda)
    wops.fused_wire_update(torch.stack([q, q]), torch.stack([s, s]), p, st,
                           spec, 1, codec="int8", chunk_elems=SLAB)
    assert (qkernel.quantize_launches, qkernel.dequantize_launches,
            wkernel.launches, tkernel.launches) == (1, 1, 1, 0)
    with pytest.raises(ValueError, match="f32"):
        wkernel.wire_fused_cuda(
            torch.stack([q, q]), torch.stack([s, s]), p.double(), st,
            tops.scalar_packet(spec, 1, device=cuda), spec, codec="int8",
            chunk_elems=SLAB)


@pytest.mark.gpu
def test_ops_launches_the_kernel_on_cuda_tensors(cuda, monkeypatch):
    monkeypatch.setattr(tkernel, "launches", 0)
    spec = topt.adamw(1e-3)
    g, p, st = _inputs(spec, 2, SLAB, "f32", "f32", 0, cuda)
    tops.fused_aggregate_update(g, p, st, spec, 1)
    assert tkernel.launches == 1


@pytest.mark.gpu
def test_smoke_fabric_on_card_matches_cpu(cuda):
    """The quickstart loop (gemma3 SMOKE, f32) on the card and on the CPU
    from the same weights: the card's matmuls sum in another order, so the
    losses agree to rtol 1e-4 and the momentum params to atol 1e-4."""
    cfg = get_arch("gemma3-1b").smoke_config
    base = init_params(cfg, torch.Generator().manual_seed(0))
    runs = {}
    for dev in ("cpu", cuda):
        params = {k: ({kk: vv.to(dev) for kk, vv in v.items()}
                      if isinstance(v, dict) else v.to(dev))
                  for k, v in base.items()}
        space = ParamSpace.build(params)
        fab = PBoxFabric(space, topt.momentum(0.05, 0.9),
                         space.flatten(params),
                         config=FabricConfig(num_shards=4, num_workers=2),
                         device=dev)
        streams = [lm_batches(cfg.vocab, 4, 32, seed=w) for w in range(2)]
        losses = []

        def grad_fn(p, wstep, dev=dev, streams=streams, losses=losses):
            b = next(streams[wstep[0]])
            loss, g = lm_loss_and_grad(
                p, torch.from_numpy(b["tokens"]).to(dev),
                torch.from_numpy(b["labels"]).to(dev), cfg)
            losses.append(loss.item())
            return g

        WorkerHarness(fab, grad_fn, lambda w, s: (w, s)).run(3)
        runs[str(dev)] = (losses, fab.params.cpu())
    (cl, cp), (gl, gp) = runs["cpu"], runs[str(cuda)]
    np.testing.assert_allclose(gl, cl, rtol=1e-4)
    np.testing.assert_allclose(gp.numpy(), cp.numpy(), rtol=0, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_int8_fabric_on_card_matches_cpu(cuda, fused, monkeypatch):
    """A small int8-wire fabric on the card and on the CPU from the same
    gradients: the kernels equal their plain versions bitwise, so the
    params, the residuals and the stats agree exactly.  The unfused case
    declares the geometry unsupported, which is how the fabric reaches
    that route."""
    from repro_torch.core import fabric as tfabric

    if not fused:
        monkeypatch.setattr(tfabric, "wire_path_supported", lambda *a: False)
    runs = {}
    for dev in ("cpu", cuda):
        params = {"w": torch.linspace(-1, 1, 3 * SLAB + 5, device=dev)}
        space = ParamSpace.build(params, chunk_elems=SLAB)
        fab = PBoxFabric(
            space, topt.adamw(1e-2), space.flatten(params), device=dev,
            config=FabricConfig(num_shards=2, num_workers=2, wire=WireConfig(
                compression=CompressionConfig(codec="int8"))))
        gen = np.random.default_rng(5)
        grads = [torch.from_numpy(gen.standard_normal(space.flat_elems)
                                  .astype(np.float32)) for _ in range(6)]
        for r in range(3):
            for w in range(2):
                fab.pull(w)
            for w in range(2):
                fab.push(w, grads[2 * r + w].to(dev))
        runs[str(dev)] = fab
    cpu, card = runs["cpu"], runs[str(cuda)]
    assert torch.equal(cpu.params, card.params.cpu())
    for w in range(2):
        assert torch.equal(cpu._worker_ef[w], card._worker_ef[w].cpu())
    assert cpu.stats == card.stats
    assert card.stats.fused_wire_rounds == (3 if fused else 0)


@pytest.mark.gpu
def test_fabric_on_card_leaves_init_flat_alone(cuda):
    """The kernel updates shard state in place; the caller's initial flat
    (whose contiguous slabs the shards were cut from) must not change."""
    params = {"w": torch.linspace(-1, 1, 3 * SLAB + 5, device=cuda)}
    space = ParamSpace.build(params, chunk_elems=1024)
    init = space.flatten(params)
    before = init.clone()
    fab = PBoxFabric(space, topt.adamw(1e-2), init,
                     config=FabricConfig(num_shards=2, num_workers=1),
                     device=cuda)
    WorkerHarness(fab, lambda p, b: {"w": p["w"] * 2}, lambda w, s: 0).run(2)
    torch.cuda.synchronize()
    assert torch.equal(init, before)
    assert not torch.equal(fab.params, before)


@pytest.mark.gpu
def test_embedding_bag_kernels_match_plain_versions_bitwise(cuda):
    """chip_smoke.py's embedding-bag sweep: B in {1, 7, 4096} x L in {1, 3,
    33} x D in {16, 128, 130} x {sum, mean} with padding, NaN/inf rows and
    both index widths, and segment_sum with duplicate-heavy, strided and
    special rows."""
    worst = _chip_smoke().bag_sweep(cuda)
    assert worst == {"embedding_bag": 0.0, "segment_sum": 0.0}


@pytest.mark.gpu
def test_embedding_bag_ops_launch_the_kernels_on_cuda_tensors(cuda, monkeypatch):
    monkeypatch.setattr(ekernel, "launches", 0)
    monkeypatch.setattr(ekernel, "segment_launches", 0)
    table = torch.randn((50, 16), device=cuda)
    out = eops.embedding_bag(table, torch.tensor([[1, 2], [3, 0]]),
                             torch.tensor([[1.0, 0.5], [2.0, 0.0]]), "mean")
    summed = eops.segment_sum(torch.randn((4, 16), device=cuda),
                              np.array([1, 0, 1, 1]), 2)
    assert out.is_cuda and summed.is_cuda
    assert (ekernel.launches, ekernel.segment_launches) == (1, 1)
    with pytest.raises(ValueError, match="out of range"):
        eops.embedding_bag(table, torch.tensor([[50]]), torch.ones((1, 1)))


@pytest.mark.gpu
@pytest.mark.parametrize("codec", ["none", "int8"])
def test_sparse_tier_on_card_matches_cpu(cuda, codec):
    """The same pushes and lookups through a 4-shard tier on the card and
    on the CPU: the kernels equal their plain versions bitwise, so the
    tables, the lookups and the stats agree exactly."""
    init = np.random.default_rng(0).standard_normal((300, 16)).astype(np.float32)
    runs = {}
    for dev in ("cpu", cuda):
        tier = SparseTier(num_shards=4, num_workers=2, codec=codec, device=dev)
        tier.add_table("t0", init)
        rng = np.random.default_rng(1)
        outs = []
        for _ in range(3):
            for w in range(2):
                ids = rng.integers(0, 40, 200)
                outs.append(tier.lookup(w, "t0", ids, np.arange(201)).cpu())
                g = torch.from_numpy(rng.standard_normal((200, 16)).astype(
                    np.float32)).to(dev)
                tier.push(w, {"t0": (ids, g)})
        runs[str(dev)] = (tier, outs)
    (ct, co), (gt, go) = runs["cpu"], runs[str(cuda)]
    assert torch.equal(ct.table("t0"), gt.table("t0").cpu())
    assert all(torch.equal(a, b) for a, b in zip(co, go))
    assert ct.stats == gt.stats


@pytest.mark.gpu
def test_smoke_modes_on_card_match_cpu(cuda):
    """chip_smoke.py's SMOKE-mode check: quorum, SSP and async x codec none
    and int8, each with a mid-round checkpoint round trip, the fabric on
    the card against the fabric on the CPU, bitwise; the card's updates
    went through the kernels."""
    launches = _chip_smoke().smoke_modes_check(cuda)
    assert launches["async/none"]["fused_agg_opt"] > 0
    assert launches["async/int8"]["fused_agg_opt"] == 0
    assert launches["async/int8"]["wire_fused"] > 0
    assert all(c["quantize_chunks"] == 0 for k, c in launches.items()
               if k.endswith("/none"))


@pytest.mark.gpu
def test_smoke_topology_on_card_matches_cpu(cuda):
    """chip_smoke.py's SMOKE topology sweep: the f32 rack chain, the int8
    and bf16 rack paths and the switch pools (on, starved, a ToR or the
    core pool failed and restored) x sync, quorum, SSP and async over 2
    racks, the fabric on the card against the fabric on the CPU, bitwise;
    the card's updates went through the kernels."""
    launches = _chip_smoke().smoke_topology_check(cuda)
    assert len(launches) == 60
    # the f32 chain: fused_agg_opt only
    assert launches["none/sync/off"]["fused_agg_opt"] > 0
    assert launches["none/sync/off"]["wire_fused"] == 0
    # pools of one slot per chunk take every int8 round: no codec kernel
    # runs, the pool's egress reaches the shards through wire_fused
    assert launches["int8/sync/on"]["quantize_chunks"] == 0
    assert launches["int8/sync/on"]["wire_fused"] > 0
    # starved pools take the software path, as with no switch tier
    assert launches["int8/sync/starved"] == launches["int8/sync/off"]
    assert launches["int8/sync/off"]["quantize_chunks"] > 0


@pytest.mark.gpu
def test_failover_on_card_equals_fault_free(cuda):
    """A replicated fabric on the card (R = 3, AdamW through the in-place
    fused_agg_opt kernel, shard 0 crashing after rounds 1 and 2) equals
    the card's fault-free run bitwise: the promoted copy is the post-round
    slab, and no backup aliases the slab the kernel writes."""
    from repro_torch.core.config import FaultConfig
    from repro_torch.core.replication import FaultEvent, FaultPlan

    rng = np.random.default_rng(3)
    n = 6 * SLAB
    grads = [torch.from_numpy(rng.standard_normal(n).astype(np.float32))
             for _ in range(2)]
    space = ParamSpace.build({"w": torch.zeros(n, device=cuda)},
                             chunk_elems=SLAB)
    runs = []
    for faults in (FaultConfig(), FaultConfig(replication=3, fault_plan=(
            FaultPlan([FaultEvent(1, "shard_crash", 0),
                       FaultEvent(2, "shard_crash", 0)])))):
        fab = PBoxFabric(space, topt.adamw(3e-3),
                         torch.zeros(n, device=cuda),
                         config=FabricConfig(num_shards=2, num_workers=2,
                                             faults=faults),
                         device=cuda)
        tkernel.launches = 0
        for _ in range(4):
            for w in range(2):
                fab.pull(w)
                fab.push(w, grads[w].to(cuda))
        assert tkernel.launches == 8
        runs.append(fab)
    base, fab = runs
    assert fab.stats.failovers == 2
    assert torch.equal(base.params.view(torch.int32),
                       fab.params.view(torch.int32))
    for a, b in zip(base.shards, fab.shards):
        for x, y in zip(a.state, b.state):
            assert torch.equal(x.view(torch.int32), y.view(torch.int32))
    for group, shard in zip(fab.replicas, fab.shards):
        for _, p, st in group.copies:
            assert p.data_ptr() != shard.params.data_ptr()
            assert torch.equal(p, shard.params)


@pytest.mark.gpu
def test_smoke_faults_on_card_match_cpu(cuda):
    """chip_smoke.py's SMOKE fault sweep: codec x replication x racks x
    crash round, worker re-entry and a sparse-tier failover, the fabric on
    the card against the fabric on the CPU and its own fault-free run,
    bitwise; the card's updates went through the kernels."""
    launches = _chip_smoke().smoke_fault_check(cuda)
    assert len(launches) == 40
    assert launches["none/racks2/R3/crash1"]["fused_agg_opt"] > 0
    assert launches["int8/racks1/R2/crash2"]["wire_fused"] > 0
    assert launches["none/racks1/R2/sparse_tier"]["embedding_bag"] > 0


@pytest.mark.gpu
def test_smoke_tenancy_on_card_matches_cpu(cuda):
    """chip_smoke.py's phase 18: the tenancy tier at the SMOKE config,
    every box on the card against the same box on the CPU and each tenant
    against its dedicated twin on the card, bitwise."""
    launches = _chip_smoke().smoke_tenancy_check(cuda)
    assert len(launches) == 41
    assert launches["2t/shards4/racks2/none"]["fused_agg_opt"] > 0
    assert launches["3t/shards1/racks1/int8"]["wire_fused"] > 0
    assert launches["switch/grant+refuse+return"]["wire_fused"] > 0


@pytest.mark.gpu
def test_smoke_serving_on_card_matches_cpu(cuda):
    """chip_smoke.py's phase 22: the read planes, the front door over
    generated traces, serve tenants and sparse serving at the SMOKE
    config, every case on the card against the CPU bitwise, and prefill
    and decode card against CPU within the stated tolerance."""
    launches = _chip_smoke().smoke_serve_check(cuda)
    assert len(launches) == 15
    assert launches["plane/racks2/R3"]["fused_agg_opt"] > 0
    assert launches["tenants/int8"]["wire_fused"] > 0
    assert launches["sparse/R2/racks2"]["embedding_bag"] > 0


@pytest.mark.gpu
def test_smoke_autoscale_on_card_matches_cpu(cuda):
    """chip_smoke.py's phase 24 on two cases: a SMOKE autoscaled dense run
    on the int8 wire over 2 racks (a chain re-home and a frontend move,
    then a reshard 2 -> 8) and a placement re-solve, each card == CPU
    bitwise and equal to its fixed-layout twin on the card."""
    cases = ("dense/int8/racks2/2->8", "resolve/seed3")
    launches = _chip_smoke().smoke_autoscale_check(cuda, only=cases)
    assert list(launches) == list(cases)
    assert launches["dense/int8/racks2/2->8"]["wire_fused"] > 0
    assert launches["resolve/seed3"]["fused_agg_opt"] > 0


@pytest.mark.gpu
def test_cached_read_keeps_its_bits_on_card(cuda):
    """On the card the kernels write slabs and chain buffers in place: a
    read cached at ``max_staleness=1`` still holds its version's bits after
    another round, at R = 1, 2 and 3, and a fresh read equals the card
    fabric and the same fabric run on the CPU."""
    from repro_torch.core.config import FaultConfig, ServeConfig
    from repro_torch.core.serving import ReadPlane
    from repro_torch.core.topology import NetworkTopology

    space = ParamSpace.build({"w": torch.zeros(5 * SLAB + 77)},
                             chunk_elems=SLAB)
    rng = np.random.default_rng(3)
    grads = [torch.from_numpy(rng.standard_normal(space.flat_elems)
                              .astype(np.float32)) for _ in range(4)]
    for replication in (1, 2, 3):
        runs = {}
        for dev in (cuda, torch.device("cpu")):
            fab = PBoxFabric(
                space, topt.momentum(0.05, 0.9), torch.zeros(
                    space.flat_elems), device=dev,
                config=FabricConfig(
                    num_shards=3, num_workers=2,
                    wire=WireConfig(topology=NetworkTopology(2, 2)),
                    faults=FaultConfig(replication=replication)))
            plane = ReadPlane(fab, config=ServeConfig(max_staleness=1))
            reads = []
            for r in range(3):
                for w in range(2):
                    fab.pull(w)
                for w in range(2):
                    fab.push(w, grads[(w + r) % 4].to(dev))
                reads.append(plane.read(0))
                reads.append(ReadPlane(fab, config=ServeConfig()).read(0))
            runs[dev.type] = [(r.version, r.cache_hit, r.flat.cpu().clone())
                              for r in reads]
            # a read cached at version 1 kept its bits through round 2
            assert reads[2].cache_hit and reads[2].version == 1
            assert torch.equal(reads[2].flat.cpu(), reads[0].flat.cpu())
            assert torch.equal(reads[-1].flat.cpu(), fab.params.cpu())
        for a, b in zip(runs["cuda"], runs["cpu"]):
            assert a[:2] == b[:2]
            assert torch.equal(a[2].view(torch.int32), b[2].view(torch.int32))
