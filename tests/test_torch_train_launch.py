"""The port's train driver (``repro_torch.launch.train``), the SPMD
checkpoints and the step builders.

Mirrors tests/scripts/train_restart_elastic.py on a (2, 1) ("data",
"model") mesh of 2 gloo ranks spawned once for the file
(``tests/torch_spmd.py``), each rank calling ``main(argv, device="cpu")``:

  * six steps of gemma3-1b SMOKE with checkpoints at steps 3 and 6: the
    loss falls;
  * a run that stops after step 3 and a ``--resume`` to step 6 end
    **bitwise** equal to the uninterrupted run (params, both AdamW slots,
    losses; the JAX script allows 2e-3, the port is deterministic on the
    CPU);
  * ``elastic_restore`` of the checkpoint to 4 owners keeps the payload;
  * a checkpoint the JAX driver's pieces wrote (subprocess, 2 host
    devices) after step 3 restores into the port, whose step 4 then
    matches JAX's step 4 (the slots land at their owners: a swap would
    show), and the port's checkpoint restores into JAX's ``TrainState``
    with the same bits.

The same 2 ranks then run ``main`` at ``--mesh 1x2``: the model sharded
over both (tensor parallelism), whose losses match the world-1 run's; and
dlrm-mlperf SMOKE at ``--mesh 2x1`` (the batch over two workers) and
``1x2`` (the tables row-sharded over two model ranks), whose losses agree
at rtol 1e-5 (the 1x2 metric times tp).
Beside them, in this process: ``main`` at ``--mesh 1x1`` starts and ends
its own world-1 group, a mesh larger than the world raises, and
``build_cell`` builds the LM serving cells and the recsys cells of all
four recsys archs as JAX's builder does, and builds the GNN.  The new
archs: ``main --arch resnet50`` (momentum SGD on ``image_batches``) and ``--arch granite-moe-1b-a400m`` (AdamW, the MoE
aux loss in the loss) resume from a step-0 checkpoint of JAX's initial
state and take three steps as JAX's driver pieces do; ``build_cell``
builds every cell of internlm2, qwen2-72b, granite-moe, qwen2-moe and
resnet50 as JAX's builder does (resnet50 through its ``build_vision_train``
with a data-axis exchange: JAX's own spans "model" too, which the
installed JAX refuses).  EquiformerV2: ``build_cell`` builds its four
graph cells (and ``variant="ep"``) at SMOKE and full size with JAX's
shapes, dtypes, flat sizes and FLOPs; ``main --arch equiformer-v2`` at
``--mesh 1x1`` resumes from JAX's initial state and takes three steps as
JAX's driver does; at ``--mesh 2x1`` (each worker's molecule ids rebased
to its block) it equals a one-process run of the same global batch, and
at ``1x2`` (channel TP) the world-1 run.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import torch_spmd as S  # noqa: E402

from repro.checkpoint import Checkpointer as JaxCheckpointer  # noqa: E402
from repro.checkpoint.checkpointer import flat_to_train_state as jax_restore  # noqa: E402
from repro.runtime.trainer import TrainState as JaxTrainState  # noqa: E402
from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.checkpoint.checkpointer import (  # noqa: E402
    flat_to_train_state,
    train_state_to_flat,
)
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.core.chunking import ParamSpace  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.runtime.elastic import elastic_restore  # noqa: E402
from repro_torch.runtime.trainer import TrainState  # noqa: E402

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX side alongside the 2 ranks (whose last run waits for the
    JAX checkpoint)."""
    root = tmp_path_factory.mktemp("launch")
    proc = S.start_jax("launch", root)
    try:
        S.spawn(2, S.train_launch_ranks, root)
    finally:
        S.finish_jax(proc)
    return root


def _rank(root, name, r):
    return dict(np.load(root / f"launch_{name}_r{r}.npz"))


def test_loss_falls(runs):
    for r in range(2):
        losses = _rank(runs, "full", r)["losses"]
        assert len(losses) == 6 and np.isfinite(losses).all()
        assert losses[-1] < losses[0], losses


def test_crash_restart_is_bitwise(runs):
    for r in range(2):
        full, res = _rank(runs, "full", r), _rank(runs, "resumed", r)
        assert int(res["start"]) == 3 and int(res["step"]) == 6
        np.testing.assert_array_equal(res["losses"], full["losses"][3:])
        for key in ("pflat", "slot0", "slot1"):
            assert np.array_equal(res[key].view(np.uint32),
                                  full[key].view(np.uint32)), key


def test_checkpoint_holds_the_global_layout(runs):
    """The step-6 checkpoint is every rank's final state, each rank's slab
    of the slots at its owner index."""
    host, _ = Checkpointer(runs / "full").restore()
    assert int(host["step"]) == 6
    st = flat_to_train_state(host, TrainState, device="cpu")
    for r in range(2):
        got = _rank(runs, "full", r)
        np.testing.assert_array_equal(st.pflat.numpy(), got["pflat"])
        for i in range(2):
            n = got[f"slot{i}"].shape[-1]
            np.testing.assert_array_equal(
                st.slots[i].numpy()[:, r * n:(r + 1) * n], got[f"slot{i}"])


def test_elastic_restore_to_four_owners_keeps_payload(runs):
    host, _ = Checkpointer(runs / "full").restore()
    cfg = get_arch("gemma3-1b").smoke_config
    space = ParamSpace.build(T.abstract_params(cfg), num_owners=2)
    new_state, new_space = elastic_restore(dict(host), space, new_owners=4)
    assert new_space.num_owners == 4
    assert new_state["pflat"].shape[-1] % 4 == 0
    np.testing.assert_array_equal(
        new_state["pflat"][0][: space.payload_elems],
        host["pflat"][0][: space.payload_elems])


def test_jax_checkpoint_restores_into_the_port(runs):
    j = dict(np.load(runs / "jax_launch.npz"))
    for r in range(2):
        got = _rank(runs, "from_jax", r)
        assert int(got["start"]) == 3 and int(got["step"]) == 4
        np.testing.assert_allclose(got["losses"], j["losses"][3:], rtol=1e-5)
        np.testing.assert_allclose(got["pflat"][0], j["pflat"][0],
                                   rtol=0, atol=1e-4)
        for i in range(2):
            n = got[f"slot{i}"].shape[-1]
            np.testing.assert_allclose(got[f"slot{i}"][0],
                                       j[f"slot{i}"][0, r * n:(r + 1) * n],
                                       rtol=1e-3, atol=1e-6)


def test_port_checkpoint_restores_into_jax(runs):
    host, _ = JaxCheckpointer(runs / "full").restore()
    jst = jax_restore(host, JaxTrainState)
    mine, _ = Checkpointer(runs / "full").restore()
    assert int(jst.step) == 6
    for key, arr in (("pflat", jst.pflat), ("slot0", jst.slots[0]),
                     ("slot1", jst.slots[1])):
        assert arr.shape == mine[key].shape == (1, 212992)
        np.testing.assert_array_equal(np.asarray(arr), mine[key])
    # and the JAX checkpoint reads back into the port bit for bit
    jhost, _ = JaxCheckpointer(runs / "jax").restore()
    st = flat_to_train_state(jhost, TrainState, device="cpu")
    for key, t in (("pflat", st.pflat), ("slot0", st.slots[0])):
        np.testing.assert_array_equal(t.numpy(), jhost[key])
    assert int(st.step) == 3


def test_bf16_state_round_trips_as_raw_two_byte_values(tmp_path):
    """bf16 arrays go to disk as numpy ``V2`` (np.save's form of JAX's
    bf16) and come back as the same bf16 bits."""
    x = torch.randn(1, 64, generator=torch.Generator().manual_seed(0))
    st = TrainState(pflat=x.to(torch.bfloat16), slots=(x.clone(),), ef=None,
                    step=torch.tensor(5, dtype=torch.int32))
    ck = Checkpointer(tmp_path)
    ck.save(5, train_state_to_flat(st))
    host, _ = ck.restore()
    assert host["pflat"].dtype == np.dtype("V2")
    back = flat_to_train_state(host, TrainState, device="cpu")
    assert back.pflat.dtype == torch.bfloat16
    assert torch.equal(back.pflat.view(torch.int16), st.pflat.view(torch.int16))
    assert torch.equal(back.slots[0], st.slots[0]) and int(back.step) == 5


def test_main_at_world_one_on_the_cpu(tmp_path, capsys):
    import torch.distributed as dist

    from repro_torch.launch.train import main

    out = main(["--steps", "2", "--log-every", "1", "--strategy", "pbox_hier",
                "--ckpt-dir", str(tmp_path)], device="cpu")
    assert not dist.is_initialized()  # the group it started is gone
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
    assert out["step"] == 2 and "done" in capsys.readouterr().out
    assert Checkpointer(tmp_path).latest_step() == 2


def test_main_refuses_a_model_axis_and_a_mismatched_world(runs):
    """A model axis of 2 now trains over the 2 ranks (the losses of the
    world-1 run of the same model at rtol 1e-4: the block outputs are
    summed over the ranks in another order); a mesh larger than a world
    the driver cannot start still raises."""
    from repro_torch.launch.train import main

    one = main(["--arch", "gemma3-1b", "--mesh", "1x1", "--steps", "3",
                "--log-every", "1"], device="cpu")
    for r in range(2):
        got = _rank(runs, "tp2", r)
        assert int(got["step"]) == 3
        np.testing.assert_allclose(got["losses"], one["losses"], rtol=1e-4)
        assert got["pflat"].shape[-1] < one["pflat"].shape[-1]  # a shard
    np.testing.assert_array_equal(_rank(runs, "tp2", 0)["losses"],
                                  _rank(runs, "tp2", 1)["losses"])
    with pytest.raises(SystemExit, match="torchrun"):
        main(["--mesh", "2x1", "--steps", "1"], device="cpu")


@pytest.mark.parametrize("arch,shape,item", [
    ("gemma3-1b", "prefill_32k", None),
    ("gemma3-1b", "decode_32k", None),
    ("gemma3-1b", "long_500k", None),
    ("dlrm-mlperf", "train_batch", "item 6c"),
])
def test_build_cell_refuses_what_is_not_ported(tmp_path, arch, shape, item):
    """The LM serving cells build at SMOKE and at full size with JAX's
    kind, global abstract shapes and meta; the SMOKE plan's step runs on
    the CPU.  The recsys family (ported by ``item``) builds every cell of
    its four archs, pbox_sparse for DLRM only, as JAX's builder does; the
    GNN family builds."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_process_group, make_mesh
    from repro_torch.launch.steps import build_cell

    init_process_group("cpu", init_method=f"file://{tmp_path}/rendezvous")
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        if item is not None:
            _recsys_plans_match_jax(mesh)
            # the GNN family builds (its plans against JAX's: below)
            gnn = build_cell("equiformer-v2", "molecule", mesh, smoke=True)
            assert gnn.kind == "train" and gnn.meta["config"].task == \
                "graph_reg"
        else:
            for smoke in (True, False):
                _same_plan_as_jax(build_cell(arch, shape, mesh, smoke=smoke),
                                  arch, shape, smoke)
            _run_serving_plan(build_cell(arch, shape, mesh, smoke=True))
        plan = build_cell("gemma3-1b", "train_4k", mesh, smoke=True)
        assert plan.kind == "train"
        assert tuple(plan.abstract_args[4]["tokens"].shape) == (2, 32)
        assert plan.abstract_args[0].dtype == torch.float32
        full = build_cell("gemma3-1b", "train_4k", mesh)
        assert full.meta["space"].flat_elems == 1_301_807_104
        assert tuple(full.abstract_args[4]["tokens"].shape) == (256, 4096)
    finally:
        dist.destroy_process_group()


RS_ARCHS = ("dlrm-mlperf", "autoint", "dien", "xdeepfm")
RS_SHAPES = ("train_batch", "serve_p99", "serve_bulk", "retrieval_cand")


def _recsys_plans_match_jax(mesh):
    """Every recsys cell at SMOKE and full size: kind, global abstract
    shapes, the scalar meta and the flat size against JAX's builder at
    ``--mesh 1x1``; ``pbox_sparse`` for DLRM (other archs raise)."""
    from repro.launch.mesh import make_mesh as jax_mesh
    from repro.launch.steps import build_cell as jax_build

    from repro_torch.launch.steps import build_cell

    jm = jax_mesh((1, 1), ("data", "model"))
    for arch in RS_ARCHS:
        for shape in RS_SHAPES:
            for smoke in (True, False):
                plan = build_cell(arch, shape, mesh, smoke=smoke)
                jplan = jax_build(arch, shape, jm, smoke=smoke)
                _same_recsys_plan(plan, jplan)
        for smoke in (True, False):
            if arch != "dlrm-mlperf":
                with pytest.raises(NotImplementedError, match="dlrm"):
                    build_cell(arch, "train_batch", mesh,
                               strategy="pbox_sparse", smoke=smoke)
                continue
            _same_recsys_plan(
                build_cell(arch, "train_batch", mesh, strategy="pbox_sparse",
                           smoke=smoke),
                jax_build(arch, "train_batch", jm, strategy="pbox_sparse",
                          smoke=smoke))


def _same_recsys_plan(plan, jplan):
    assert plan.kind == jplan.kind
    scalars = {k: v for k, v in jplan.meta.items()
               if k not in ("space", "sspecs")}
    assert {k: plan.meta[k] for k in scalars} == scalars
    if "space" in jplan.meta:
        assert plan.meta["space"].flat_elems == jplan.meta["space"].flat_elems
        assert plan.meta["n_groups"] == jplan.meta["n_groups"]
    assert _shapes(plan.abstract_args) == _shapes(jplan.abstract_args)


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_shapes(v) for v in tree]
    return None if tree is None else tuple(tree.shape)


def test_recsys_main_on_two_ranks(runs):
    """dlrm-mlperf SMOKE through ``main`` at ``--mesh 2x1`` and ``1x2``:
    both ranks agree, the two layouts agree (the same global batch of 4
    and the same draw; the 1x2 metric is the loss over tp = 2), the loss
    is finite and in (0, 2) (BCE near ln 2, test_models_smoke.py's
    bound)."""
    for mesh in ("2x1", "1x2"):
        got = [_rank(runs, f"dlrm_{mesh}", r) for r in range(2)]
        assert int(got[0]["step"]) == 3
        losses = got[0]["losses"]
        assert len(losses) == 3 and np.isfinite(losses).all()
        assert ((0 < losses) & (losses < 2.0)).all(), losses  # BCE near ln 2
        np.testing.assert_array_equal(got[1]["losses"], losses)
    # the metric is the pmean of bce_loss's per-rank loss / tp, as in JAX
    np.testing.assert_allclose(_rank(runs, "dlrm_1x2", 0)["losses"] * 2,
                               _rank(runs, "dlrm_2x1", 0)["losses"],
                               rtol=1e-5)


def _same_plan_as_jax(plan, arch, shape, smoke):
    from repro.launch.mesh import make_mesh as jax_mesh
    from repro.launch.steps import build_cell as jax_build

    jplan = jax_build(arch, shape, jax_mesh((1, 1), ("data", "model")),
                      smoke=smoke)
    assert plan.kind == jplan.kind
    assert plan.meta == jplan.meta
    assert _shapes(plan.abstract_args) == _shapes(jplan.abstract_args)


def _run_serving_plan(plan):
    from repro_torch.models import transformer as T

    cfg = get_arch("gemma3-1b").smoke_config
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    if plan.kind == "prefill":
        toks = torch.zeros(plan.abstract_args[1].shape, dtype=torch.int32)
        ids, cache = plan.fn(params, toks)
        assert ids.shape == (toks.shape[0],)
        assert tuple(cache["k"].shape)[2] == toks.shape[1]
        return
    cache = plan.abstract_args[2]
    new = (lambda t: torch.zeros(t.shape, dtype=t.dtype))
    cache = ([{k: new(v) for k, v in c.items()} for c in cache]
             if isinstance(cache, list) else {k: new(v)
                                              for k, v in cache.items()})
    tok = torch.zeros(plan.abstract_args[1].shape, dtype=torch.int32)
    ids, out = plan.fn(params, tok, cache, 3)
    assert out is cache and ids.shape == tok.shape


def _jax_plan(arch_id, shape, mesh, smoke):
    """(plan, exchange): JAX's ``build_cell`` and ``make_exchange``; for
    resnet50, its ``build_vision_train`` given
    an exchange over the data axis alone.  JAX's own vision exchange spans
    every mesh axis, "model" included, and its state specs then name
    "model" twice (``P("model", ("data", "model"))``), which this JAX
    refuses on any mesh; on a 1 x 1 mesh the data axis alone is the same
    computation."""
    from repro.configs.registry import get_arch as jax_get_arch
    from repro.core.exchange import ExchangeConfig, PSExchange
    from repro.launch.steps import build_cell as jax_build
    from repro.launch.steps import (
        build_vision_train,
        default_optimizer,
        make_exchange,
    )

    arch = jax_get_arch(arch_id)
    if arch.family != "vision":
        return (jax_build(arch_id, shape, mesh, smoke=smoke),
                make_exchange(mesh, arch.family))
    ex = PSExchange(default_optimizer("vision"), ExchangeConfig("pbox"),
                    ("data",), None)
    return build_vision_train(arch, arch.cell(shape), mesh, ex, smoke), ex


def _jax_steps_from_init(arch_id, ckpt_dir, steps):
    """JAX's train driver, step by step at ``--mesh 1x1``: its SMOKE plan,
    its initial state (seed 0) checkpointed at step 0, then ``steps`` steps
    on the driver's stream (seed 0).  Returns (losses, final pflat)."""
    import jax.numpy as jnp

    from repro.checkpoint.checkpointer import train_state_to_flat
    from repro.configs.registry import get_arch as jax_get_arch
    from repro.data.synthetic import image_batches, lm_batches
    from repro.launch.mesh import make_mesh as jax_mesh
    from repro.models import resnet as jR
    from repro.models import transformer as jT
    from repro.runtime.trainer import init_train_state

    arch = jax_get_arch(arch_id)
    cfg = arch.smoke_config
    mesh = jax_mesh((1, 1), ("data", "model"))
    shape = {"vision": "imagenet_train", "gnn": "molecule"}.get(arch.family,
                                                               "train_4k")
    plan, exchange = _jax_plan(arch_id, shape, mesh, True)
    bt = plan.abstract_args[4]
    if arch.family == "gnn":
        import dataclasses

        from repro.data.graphs import random_molecule_batch
        from repro.models.gnn import equiformer_v2 as jEQ

        # the JAX driver's SMOKE branch: its config, 8 atoms a molecule
        gcfg = dataclasses.replace(cfg, n_out=1, task="graph_reg")
        init_fn = lambda k: jEQ.init_params(gcfg, k, 1)  # noqa: E731
        specs = jEQ.make_param_specs(gcfg, 1)
        n_mol = bt["targets"].shape[0]
        data = iter([random_molecule_batch(
            n_mol, 8, bt["edge_src"].shape[0] // n_mol, cfg.d_in, cfg.l_max,
            cfg.n_rbf, seed=i) for i in range(steps)])
    elif arch.family == "vision":
        init_fn = lambda k: jR.init_params(cfg, k)  # noqa: E731
        specs = jax.tree.map(
            lambda _: jax.sharding.PartitionSpec(),
            jax.eval_shape(lambda: jR.init_params(cfg, jax.random.PRNGKey(0))),
            is_leaf=lambda x: isinstance(x, jax.ShapeDtypeStruct))
        data = image_batches(bt["images"].shape[0], bt["images"].shape[1],
                             cfg.n_classes, 0)
    else:
        init_fn = lambda k: jT.init_params(cfg, k, tp=1)  # noqa: E731
        specs = jT.make_param_specs(cfg, 1)
        data = lm_batches(cfg.vocab, *bt["tokens"].shape, 0)
    st = init_train_state(
        mesh, init_params_fn=init_fn, param_specs=specs, exchange=exchange,
        space=plan.meta["space"], n_groups=plan.meta["n_groups"],
        key=jax.random.PRNGKey(0), ps_dtype=plan.abstract_args[0].dtype)
    JaxCheckpointer(ckpt_dir).save(0, train_state_to_flat(st))
    pflat, slots, ef, stc = st.pflat, st.slots, st.ef, st.step
    losses = []
    for _ in range(steps):
        b = jax.tree.map(jnp.asarray, next(data))
        pflat, slots, ef, stc, met = plan.fn(pflat, slots, ef, stc, b)
        losses.append(float(met["loss"]))
    return np.asarray(losses), np.asarray(pflat, np.float32)


def test_resnet_main_is_data_parallel_over_every_axis(runs):
    """resnet50 SMOKE through ``main`` at ``--mesh 2x1`` and ``1x2``: the
    workers span both axes, so the two layouts are the same run (one
    model group, each rank its rows of the batch and its half of the
    momentum), bitwise, on both ranks."""
    got = {mesh: [_rank(runs, f"resnet_{mesh}", r) for r in range(2)]
           for mesh in ("2x1", "1x2")}
    ref = got["2x1"][0]
    assert int(ref["step"]) == 2 and np.isfinite(ref["losses"]).all()
    assert ref["pflat"].shape[0] == 1  # one model group
    for r in range(2):
        for out in (got["2x1"][r], got["1x2"][r]):
            for key in ("losses", "pflat"):
                np.testing.assert_array_equal(out[key], ref[key], err_msg=key)
        # each rank owns its half of the momentum, the same in both layouts
        np.testing.assert_array_equal(got["1x2"][r]["slot0"],
                                      got["2x1"][r]["slot0"])


@pytest.mark.parametrize("arch", ["resnet50", "granite-moe-1b-a400m",
                                  "equiformer-v2"])
def test_main_trains_the_new_archs_as_jax_does(tmp_path, arch):
    """``main(["--arch", arch, "--resume"])`` at ``--mesh 1x1`` from JAX's
    initial state (a step-0 checkpoint JAX's checkpointer wrote): resnet50
    by momentum(0.1, 0.9) on ``image_batches``, granite-moe by AdamW on
    ``lm_batches`` (its aux loss in the logged loss), equiformer-v2 by
    AdamW(1e-3) on ``random_molecule_batch`` (8 atoms and 12 features a
    node at SMOKE, as JAX's driver draws them).  Three steps: the
    losses at rtol 1e-4 and the final flat at rtol 1e-4 / atol 1e-4 against
    JAX's driver pieces, step for step (the test_torch_resnet.py fabric
    bound; AdamW's normalised steps keep granite's parameters within it
    over three steps)."""
    from repro_torch.launch.train import main

    steps = 3
    jlosses, jpflat = _jax_steps_from_init(arch, tmp_path / "ck", steps)
    out = main(["--arch", arch, "--steps", str(steps), "--log-every", "1",
                "--ckpt-dir", str(tmp_path / "ck"), "--resume"], device="cpu")
    assert out["start"] == 0 and out["step"] == steps
    np.testing.assert_allclose(out["losses"], jlosses, rtol=1e-4)
    np.testing.assert_allclose(out["pflat"].float().numpy(), jpflat,
                               rtol=1e-4, atol=1e-4)


NEW_LM = ("internlm2-1.8b", "qwen2-72b", "granite-moe-1b-a400m",
          "qwen2-moe-a2.7b")


@pytest.mark.parametrize("arch", NEW_LM + ("resnet50",))
def test_build_cell_builds_the_new_archs_as_jax_does(tmp_path, arch):
    """Every cell of the four new LM archs and resnet50's
    ``imagenet_train``, at SMOKE and at full size, against JAX's builder:
    the kind, the scalar meta, the flat size, the groups and the global
    abstract shapes; a cell JAX skips at full size raises in both."""
    import torch.distributed as dist

    from repro.configs.registry import get_arch as jax_get_arch
    from repro.launch.mesh import make_mesh as jax_mesh

    from repro_torch.launch.mesh import init_process_group, make_mesh
    from repro_torch.launch.steps import build_cell

    init_process_group("cpu", init_method=f"file://{tmp_path}/rendezvous")
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        jm = jax_mesh((1, 1), ("data", "model"))
        for cell in jax_get_arch(arch).cells:
            for smoke in (True, False):
                if cell.skip_reason and not smoke:
                    with pytest.raises(ValueError, match="skipped"):
                        build_cell(arch, cell.name, mesh, smoke=smoke)
                    with pytest.raises(ValueError, match="skipped"):
                        _jax_plan(arch, cell.name, jm, smoke)
                    continue
                plan = build_cell(arch, cell.name, mesh, smoke=smoke)
                _same_recsys_plan(plan, _jax_plan(arch, cell.name, jm,
                                                  smoke)[0])
    finally:
        dist.destroy_process_group()


GNN_SHAPES = ("full_graph_sm", "minibatch_lg", "ogb_products", "molecule")


def _same_gnn_plan(plan, jplan):
    """JAX's kind, scalar meta, flat size and groups, and the batch's
    global shapes and dtypes (dtype names compared)."""
    _same_recsys_plan(plan, jplan)
    for k, v in jplan.abstract_args[4].items():
        assert str(plan.abstract_args[4][k].dtype).split(".")[-1] == \
            str(v.dtype), k
    assert sorted(plan.abstract_args[4]) == sorted(jplan.abstract_args[4])
    assert plan.meta["space"].payload_elems == \
        jplan.meta["space"].payload_elems


@pytest.mark.parametrize("shape", GNN_SHAPES)
def test_build_cell_builds_the_gnn_cells_as_jax_does(tmp_path, shape):
    """Each graph cell at SMOKE and at full size, channel TP and
    ``variant="ep"``, on a 1 x 1 mesh against JAX's builder: the kind,
    the scalar meta (``model_flops``, ``nodes``, ``edges``), the flat and
    payload sizes, the groups, and the graph batch's global shapes and
    dtypes; the effective config's ``d_in``, ``n_out``, task and compute
    dtype equal the one JAX's template derives (full_graph_sm's flat is
    35,274,752, molecule's 35,086,336)."""
    import torch.distributed as dist

    from repro.configs.registry import get_arch as jax_get_arch
    from repro.launch import steps as jST
    from repro.launch.mesh import make_mesh as jax_mesh

    from repro_torch.launch.mesh import init_process_group, make_mesh
    from repro_torch.launch.steps import build_cell

    init_process_group("cpu", init_method=f"file://{tmp_path}/rendezvous")
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        jm = jax_mesh((1, 1), ("data", "model"))
        jarch = jax_get_arch("equiformer-v2")
        for smoke in (True, False):
            for variant in (None, "ep"):
                plan = build_cell("equiformer-v2", shape, mesh, smoke=smoke,
                                  variant=variant)
                jplan = jST.build_cell("equiformer-v2", shape, jm,
                                       smoke=smoke, variant=variant)
                _same_gnn_plan(plan, jplan)
                base = jarch.smoke_config if smoke else jarch.config
                jcfg = jST._gnn_graph_template(jm, jarch.cell(shape), base,
                                               ("data",), smoke)[2]
                cfg = plan.meta["config"]
                assert (cfg.d_in, cfg.n_out, cfg.task) == (
                    jcfg.d_in, jcfg.n_out, jcfg.task)
                assert str(cfg.dtype).split(".")[-1] == str(
                    np.dtype(jcfg.dtype))
                assert cfg.edge_parallel == (variant == "ep")
                assert plan.meta["dist_nodes"] == (shape == "ogb_products")
        flat = {"full_graph_sm": 35_274_752, "molecule": 35_086_336}
        if shape in flat:
            full = build_cell("equiformer-v2", shape, mesh)
            assert full.meta["space"].flat_elems == flat[shape]
    finally:
        dist.destroy_process_group()


def test_gnn_driver_refuses_a_cell_without_a_stream(tmp_path):
    """The GNN driver trains ``molecule`` only, as JAX's draws molecules
    only: another graph cell raises before any step."""
    from repro_torch.launch.train import main

    with pytest.raises(ValueError, match="molecule cell only"):
        main(["--arch", "equiformer-v2", "--shape", "full_graph_sm",
              "--steps", "1"], device="cpu")


def test_gnn_main_on_two_ranks(runs):
    """equiformer-v2 SMOKE through ``main`` on the 2 ranks.  ``--mesh
    2x1``: both ranks agree, and the run equals a one-process run of the
    same 4-molecule global batches (the driver's seeds 0-2) from the same
    seeded init, its step over the whole batch: each loss at rtol 1e-5
    (the mean of the workers' 2-molecule MSEs is the 4-molecule MSE) and
    the final flat at rtol 1e-5 / atol 1e-6.  Without the rebase worker
    1's node ids would index past its block and the step would raise.
    ``--mesh 1x2``: channel TP, the losses times tp equal to the world-1
    run's at rtol 1e-4."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.configs.registry import ShapeCell
    from repro_torch.data.graphs import random_molecule_batch
    from repro_torch.launch.mesh import init_process_group, make_mesh
    from repro_torch.launch.steps import build_gnn_cell, make_exchange
    from repro_torch.launch.train import main
    from repro_torch.models.gnn import equiformer_v2 as EQ
    from repro_torch.runtime.trainer import init_train_state, local_state

    got = [_rank(runs, "gnn_2x1", r) for r in range(2)]
    assert int(got[0]["step"]) == 3 and np.isfinite(got[0]["losses"]).all()
    for key in ("losses", "pflat"):
        np.testing.assert_array_equal(got[0][key], got[1][key])
    arch = get_arch("equiformer-v2")
    smoke = arch.smoke_config
    arch = dataclasses.replace(arch, config=smoke)
    cell = ShapeCell("molecule", "graph_molecule",
                     {"n_nodes": 8, "n_edges": 16, "batch": 4,
                      "n_species": smoke.d_in})
    tmp = runs / "gnn_one"
    tmp.mkdir(exist_ok=True)
    init_process_group("cpu", init_method=f"file://{tmp}/rendezvous")
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        ex = make_exchange(mesh, "gnn")
        plan = build_gnn_cell(arch, cell, mesh, ex)
        cfg = plan.meta["config"]
        st = init_train_state(
            mesh, init_params_fn=lambda g: EQ.init_params(cfg, g),
            param_specs=EQ.make_param_specs(cfg, 1), exchange=ex,
            space=plan.meta["space"], n_groups=1,
            key=torch.Generator().manual_seed(0), device="cpu")
        pflat, slots, ef, stc = local_state(st, mesh, ex)
        losses = []
        for i in range(3):
            b = random_molecule_batch(4, 8, 16, cfg.d_in, cfg.l_max,
                                      cfg.n_rbf, seed=i)
            pflat, slots, ef, stc, met = plan.fn(
                pflat, slots, ef, stc,
                {k: torch.from_numpy(v) for k, v in b.items()})
            losses.append(met["loss"].item())
    finally:
        dist.destroy_process_group()
    np.testing.assert_allclose(got[0]["losses"], losses, rtol=1e-5)
    np.testing.assert_allclose(got[0]["pflat"], pflat.numpy(), rtol=1e-5,
                               atol=1e-6)
    one = main(["--arch", "equiformer-v2", "--mesh", "1x1", "--steps", "3",
                "--log-every", "3"], device="cpu")
    for r in range(2):
        tp2 = _rank(runs, "gnn_1x2", r)
        np.testing.assert_allclose(tp2["losses"] * 2, one["losses"],
                                   rtol=1e-4)
