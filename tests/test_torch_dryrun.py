"""``launch/dryrun`` (the port's counterpart of ``launch/dryrun.py``):
the counterpart of tests/scripts/smoke_all_cells.py (every registered
cell at SMOKE runs one rank's step on meta tensors over a recording
(2, 2, 2) mesh, with 0 failures; the four ``long_500k`` cells recorded
as skipped at full size), gemma3-1b ``train_4k`` on the production mesh
with and without sequence parallelism, a failing cell recorded as an
error, and the CLI with ``roofline`` reading its records."""
import json

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.registry import get_arch, list_cells  # noqa: E402
from repro_torch.launch import dryrun, roofline  # noqa: E402

SMOKE_MESH = ((2, 2, 2), ("pod", "data", "model"))
LONG_SKIPS = {("internlm2-1.8b", "long_500k"), ("qwen2-72b", "long_500k"),
              ("granite-moe-1b-a400m", "long_500k"),
              ("qwen2-moe-a2.7b", "long_500k")}


def test_every_cell_runs_at_smoke_on_a_recording_mesh(tmp_path):
    """smoke_all_cells.py's sweep: 40 cells, 0 failures; every train step
    charges one fused_agg_opt launch, counts FLOPs and records its
    exchange's collectives."""
    failed, train = [], 0
    for arch_id, shape in list_cells():
        rec = dryrun.run_cell(arch_id, shape, False, "pbox", tmp_path,
                              smoke=True, layout=SMOKE_MESH)
        if rec["status"] != "ok":
            failed.append((arch_id, shape, rec.get("error")))
            continue
        assert rec["n_devices"] == 8 and rec["mesh"] == "2x2x2"
        assert rec["memory"]["peak_estimate"] > 0
        assert rec["bytes_per_device"] > 0 and rec["ops"] > 0
        kind = get_arch(arch_id).cell(shape).kind
        if kind == "train" or kind.startswith("graph"):
            train += 1
            assert rec["kernels"]["fused_agg_opt"]["launches"] == 1
            assert rec["flops_per_device"] > 0
            assert rec["collective_bytes_per_device"]["wire_total"] > 0
    assert not failed, failed
    assert train == 13  # 5 LM, 4 graph and 4 recsys train cells
    assert len(list(tmp_path.glob("*.json"))) == 40


def test_long_500k_cells_recorded_as_skipped(tmp_path):
    for arch_id, shape in list_cells():
        if shape != "long_500k":
            continue
        rec = dryrun.run_cell(arch_id, shape, False, "pbox", tmp_path)
        if (arch_id, shape) in LONG_SKIPS:
            assert rec["status"] == "skipped" and rec["reason"]
        else:
            assert rec["status"] == "ok", rec.get("error")


@pytest.mark.parametrize("variant", [None, "sp"])
def test_production_train_4k(tmp_path, variant):
    """gemma3-1b ``train_4k`` on the 16 x 16 production mesh: ``ok``,
    with all-gather, reduce-scatter and all-reduce recorded, bf16 FLOPs
    only, JAX's record keys; under ``sp`` the same FLOPs, the sequence's
    psum-scatters and all-gathers in place of the psums, and a lower peak
    of live bytes."""
    rec = dryrun.run_cell("gemma3-1b", "train_4k", False, "pbox", tmp_path,
                          variant=variant)
    assert rec["status"] == "ok", rec.get("error")
    coll = rec["collective_bytes_per_device"]
    for kind in ("all-gather", "reduce-scatter", "all-reduce"):
        assert coll[f"raw_{kind}"] > 0 and coll[f"wire_{kind}"] > 0
    assert coll["total"] == sum(coll[f"raw_{k}"] for k in (
        "all-gather", "reduce-scatter", "all-reduce"))
    assert set(rec["flops_by_dtype"]) == {"bf16"}
    assert rec["n_devices"] == 256 and rec["mesh"] == "16x16"
    for key in ("flops_per_device", "bytes_per_device", "bytes_min_per_device",
                "memory", "meta"):
        assert key in rec
    assert rec["meta"]["microbatches"] == 1
    if variant == "sp":
        base = dryrun.run_cell("gemma3-1b", "train_4k", False, "pbox",
                               tmp_path)
        assert rec["flops_per_device"] == base["flops_per_device"]
        bc = base["collective_bytes_per_device"]
        assert coll["raw_reduce-scatter"] > 10 * bc["raw_reduce-scatter"]
        assert coll["raw_all-reduce"] < bc["raw_all-reduce"] / 10
        assert rec["memory"]["peak_estimate"] < \
            base["memory"]["peak_estimate"]
    a = roofline.analyze(rec)
    assert a["status"] == "ok" and a["bound_s"] > 0
    assert 0 < a["model_flops_ratio"] <= 1.0


@pytest.mark.parametrize("smoke", [True, False])
def test_sparse_push_cell(tmp_path, smoke):
    """DLRM's ``pbox_sparse`` step (the dense MLPs through the exchange,
    the tables by the sparse push) takes this rank's table shards too:
    one fused_agg_opt launch, the ids' and cotangents' all-gathers."""
    rec = dryrun.run_cell("dlrm-mlperf", "train_batch", False, "pbox_sparse",
                          tmp_path, smoke=smoke,
                          layout=SMOKE_MESH if smoke else None)
    assert rec["status"] == "ok", rec.get("error")
    assert rec["kernels"]["fused_agg_opt"]["launches"] == 1
    assert rec["collective_bytes_per_device"]["raw_all-gather"] > 0
    assert rec["flops_per_device"] > 0


def test_a_failing_cell_is_recorded_and_the_sweep_goes_on(tmp_path):
    rec = dryrun.run_cell("gemma3-1b", "train_4k", False, "no-such-strategy",
                          tmp_path, smoke=True, layout=SMOKE_MESH)
    assert rec["status"] == "error" and "no-such-strategy" in rec["error"]
    assert "Traceback" in rec["traceback"]
    assert roofline.analyze(rec)["status"] == "error"


def test_cli_and_roofline_table(tmp_path, capsys):
    out = tmp_path / "dry"
    argv = ["--arch", "gemma3-1b", "--shape", "decode_32k", "--out", str(out)]
    assert dryrun.main(argv) == 0
    files = list(out.glob("*.json"))
    assert [f.name for f in files] == [
        "gemma3-1b__decode_32k__16x16__pbox.json"]
    rec = json.loads(files[0].read_text())
    assert rec["status"] == "ok" and rec["flops_per_device"] > 0
    assert dryrun.main(argv + ["--variant", "sp", "--multipod", "multi"]) == 0
    printed = capsys.readouterr().out
    assert "[ok     ] gemma3-1b" in printed
    roofline.main(["--dir", str(out)])
    table = capsys.readouterr().out
    assert "decode_32k+sp" in table and "2x16x16" in table
    roofline.main(["--dir", str(out), "--mesh", "16x16"])
    assert "2x16x16" not in capsys.readouterr().out


@pytest.mark.parametrize("arch_id,shape", [("gemma3-1b", "train_4k"),
                                           ("equiformer-v2", "molecule")])
def test_meta_flops_equal_a_real_steps(tmp_path, arch_id, shape):
    """A SMOKE train step's FLOPs by dtype on meta tensors over a recording
    1 x 1 mesh equal the same cost mode's count over one real step of the
    same plan on the CPU (a world-1 gloo mesh), exactly: what phase 44 of
    chip_smoke.py holds on the card at full width."""
    import torch.distributed as dist

    from repro_torch.data.graphs import cell_batch
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.launch.cost_analysis import step_costs
    from repro_torch.launch.mesh import (
        RecordingMesh,
        init_process_group,
        make_mesh,
    )
    from repro_torch.launch.steps import build_cell
    from repro_torch.models import transformer as T
    from repro_torch.models.gnn import equiformer_v2 as EQ
    from repro_torch.runtime.trainer import init_train_state, local_state

    rec = RecordingMesh((1, 1), ("data", "model"))
    plan = build_cell(arch_id, shape, rec, smoke=True)
    meta = dryrun.dry_run(plan, rec, dryrun.plan_config(plan, True))
    init_process_group("cpu", init_method=f"file://{tmp_path}/rendezvous")
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        plan = build_cell(arch_id, shape, mesh, smoke=True)
        cfg = dryrun.plan_config(plan, True)
        if arch_id == "equiformer-v2":
            init, specs = EQ.init_params, EQ.make_param_specs(cfg, 1)
            kind = get_arch(arch_id).cell(shape).kind
            batch = cell_batch(kind, plan.abstract_args[4], cfg.l_max,
                               cfg.n_rbf, seed=0)
        else:
            init, specs = T.init_params, T.make_param_specs(cfg, 1)
            gb, sl = plan.abstract_args[4]["tokens"].shape
            batch = next(lm_batches(cfg.vocab, gb, sl, seed=0))
        state = init_train_state(
            mesh, init_params_fn=lambda g: init(cfg, g), param_specs=specs,
            exchange=plan.meta["exchange"], space=plan.meta["space"],
            n_groups=1, key=torch.Generator().manual_seed(0),
            ps_dtype=cfg.param_dtype if arch_id == "gemma3-1b"
            else torch.float32, device="cpu")
        args = local_state(state, mesh, plan.meta["exchange"])
        batch = {k: torch.from_numpy(v) for k, v in batch.items()}
        _, real = step_costs(plan.fn, *args, batch)
    finally:
        dist.destroy_process_group()
    assert meta["flops_per_device"] > 0
    assert real["flops_by_dtype"] == meta["flops_by_dtype"]
    assert real["kernels"] == {}  # the plain version ran: no meta charge
