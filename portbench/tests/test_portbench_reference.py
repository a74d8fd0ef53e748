"""The reference against the program on the CPU at the small sizes: the
same loss and gradients from the same inputs, the same flat layout, the
same int8 codec and the same optimizer steps, and the frozen molecule
generator equal to the program's."""
import numpy as np
import pytest
import torch

from portbench.families import equiformer, resnet
from portbench.reference import equiformer as ref_eq
from portbench.reference import resnet as ref_rn
from portbench.reference.train import Layout, int8_roundtrip, optimizer_step
from portbench.tests.small import files
from portbench.yardstick.inputs import leaves, make_params
from portbench.yardstick.molecules import random_molecule_batch

# f32 sums in another order: the gap the CPU shows is ~1e-6 relative
RTOL, ATOL = 2e-5, 1e-6


def _grads(loss_fn, params, batch):
    tracked = [t.detach().requires_grad_(True) for _, t in leaves(params)]
    it = iter(tracked)
    tree = _rebuild(params, it)
    loss = loss_fn(tree, batch)
    return loss.detach(), torch.autograd.grad(loss, tracked)


def _rebuild(tree, it):
    return {k: (_rebuild(tree[k], it) if isinstance(tree[k], dict)
                else next(it)) for k in sorted(tree)}


def test_resnet_reference_matches_the_program():
    from repro_torch.models import resnet as RN

    f = files("resnet50.phub_k2_f32")
    cfg, tr = f["config"], f["traffic"]
    params = make_params(resnet.param_spec(cfg, tr), 3, "cpu")
    batch = resnet.batches(cfg, tr, 3, "cpu")[0][0]
    pcfg = resnet.port_config(cfg, tr)
    lr, gr = _grads(lambda p, b: ref_rn.loss(p, b, cfg), params, batch)
    lp, gp = _grads(lambda p, b: RN.loss_fn(p, b, pcfg)[0], params, batch)
    torch.testing.assert_close(lr, lp, rtol=RTOL, atol=ATOL)
    for a, b in zip(gr, gp):
        torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)


def test_equiformer_reference_matches_the_program():
    from repro_torch.models.gnn import equiformer_v2 as EQ

    f = files("equiformer-v2.spmd_molecule")
    cfg, tr = f["config"], f["traffic"]
    params = make_params(equiformer.param_spec(cfg, tr), 4, "cpu")
    batch = equiformer.batches(cfg, tr, 4, "cpu")[0][0]
    pcfg = equiformer.port_config(cfg, tr)
    lr, gr = _grads(lambda p, b: ref_eq.loss(p, b, cfg), params, batch)
    lp, gp = _grads(lambda p, b: EQ.loss_fn(p, b, pcfg)[0], params, batch)
    torch.testing.assert_close(lr, lp, rtol=RTOL, atol=ATOL)
    for a, b in zip(gr, gp):
        torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)
    # the reference's recomputation changes no value
    lr2, gr2 = _grads(lambda p, b: ref_eq.loss(p, b, cfg, remat=True),
                      params, batch)
    assert torch.equal(lr, lr2) and all(torch.equal(a, b)
                                        for a, b in zip(gr, gr2))


@pytest.mark.parametrize("workload", ["resnet50.phub_k2_f32",
                                      "equiformer-v2.spmd_molecule"])
def test_layout_is_the_program_flat_space(workload):
    from repro_torch.core.chunking import ParamSpace

    f = files(workload)
    fam = resnet if f["config"]["family"] == "resnet" else equiformer
    params = make_params(fam.param_spec(f["config"], f["traffic"]), 1, "cpu")
    chunk = f["traffic"]["chunk_elems"]
    mine = Layout(params, chunk)
    space = ParamSpace.build(params, chunk_elems=chunk)
    assert mine.flat == space.flat_elems and mine.payload == space.payload_elems
    assert torch.equal(mine.flatten(params), space.flatten(params))


def test_int8_roundtrip_is_the_program_codec_bitwise():
    from repro_torch.kernels.quant.ref import (
        dequantize_chunks_ref,
        quantize_chunks_ref,
    )

    x = torch.randn(8 * 1024, generator=torch.Generator().manual_seed(0))
    x[:1024] = 0.0  # a chunk of zeros: scale 1
    x[1024:2048] *= 1e-30
    q, s = quantize_chunks_ref(x, 1024)
    assert torch.equal(int8_roundtrip(x, 1024), dequantize_chunks_ref(q, s, 1024))


@pytest.mark.parametrize("name", ["momentum", "adamw"])
def test_optimizer_steps_match_the_program(name):
    from repro_torch.optim.optimizers import adamw, apply_update, momentum

    opt = ({"name": "momentum", "lr": 0.1, "mu": 0.9} if name == "momentum"
           else {"name": "adamw", "lr": 1e-3, "b1": 0.9, "b2": 0.999,
                 "eps": 1e-8, "weight_decay": 0.01})
    spec = (momentum(0.1, 0.9) if name == "momentum"
            else adamw(1e-3, 0.9, 0.999, 1e-8, 0.01))
    gen = torch.Generator().manual_seed(1)
    p = torch.randn(4096, generator=gen)
    mine, theirs, state = p.clone(), p.clone(), {}
    slots = tuple(torch.zeros_like(p) for _ in range(spec.num_state_slots))
    for t in (1, 2, 3):
        g = torch.randn(4096, generator=gen)
        mine = optimizer_step(opt, mine, g, state, t)
        theirs, slots = apply_update(spec, theirs, g, slots, t)
    torch.testing.assert_close(mine, theirs, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5])
def test_molecules_are_the_program_generator(seed):
    from repro_torch.data.graphs import random_molecule_batch as theirs

    a = random_molecule_batch(3, 8, 16, 12, 2, 8, seed=seed)
    b = theirs(3, 8, 16, 12, 2, 8, seed=seed)
    assert a.keys() == b.keys()
    assert all(np.array_equal(a[k], b[k]) for k in a)


def test_inputs_follow_the_seed():
    f = files("resnet50.phub_k2_f32")
    spec = resnet.param_spec(f["config"], f["traffic"])
    a, b = make_params(spec, 2**31 + 9, "cpu"), make_params(spec, 2**31 + 9, "cpu")
    c = make_params(spec, 2**31 + 10, "cpu")
    la, lb, lc = leaves(a), leaves(b), leaves(c)
    assert all(torch.equal(x, y) for (_, x), (_, y) in zip(la, lb))
    assert not torch.equal(la[-1][1], lc[-1][1]) or not torch.equal(
        la[0][1], lc[0][1])
    xa = resnet.batches(f["config"], f["traffic"], 11, "cpu")
    xb = resnet.batches(f["config"], f["traffic"], 11, "cpu")
    assert torch.equal(xa[1][2]["images"], xb[1][2]["images"])
    assert not torch.equal(xa[0][0]["images"], xa[0][1]["images"])
