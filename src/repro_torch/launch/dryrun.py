"""Multi-pod dry run: build every (arch x shape x mesh) cell and run one
rank's step on meta tensors (torch counterpart of
``repro/launch/dryrun.py``).

Proves the production layout is coherent without the cards: for each cell
the plan is built on a ``launch/mesh.RecordingMesh`` of the production
layout (16 x 16, or 2 x 16 x 16 with ``--multipod``), its global
``abstract_args`` are cut to rank 0's pieces (``runtime/trainer``'s
``local_state`` / ``local_params`` / ``shard_batch``, on meta tensors),
and one step runs under ``launch/cost_analysis.CostMode``: no storage is
allocated and no kernel runs (each hand-written kernel is charged as one
launch).  No process group of 256 ranks is needed: the recording mesh
returns the collectives' shapes and records their bytes.

The record has JAX's keys: ``status``, ``n_devices``, ``flops_per_device``,
``bytes_per_device``, ``bytes_min_per_device``,
``collective_bytes_per_device`` (``raw_<kind>`` / ``wire_<kind>``,
``total``, ``wire_total``), ``memory.peak_estimate`` and ``meta``; and
``flops_by_dtype`` (the roofline's peak depends on it), ``kernels`` (the
launches charged) and ``ops``.  JAX's ``xla_*_once`` fields (XLA's
module-level counts, loop bodies once) and ``lower_s`` / ``compile_s``
have no meaning for an eager step and are left out; ``seconds`` is the
host time of the meta step.  The step's host scalars are given as Python
ints: a decode step's position is its cache's last one.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-1b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multipod both]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-1b --shape train_4k --variant sp
Results are cached as JSON under artifacts/dryrun_torch/ (``--out``);
``python -m repro_torch.launch.roofline`` tabulates them.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from pathlib import Path

import torch

from repro_torch.launch.cost_analysis import step_costs

DEFAULT_OUT = "artifacts/dryrun_torch"


def _narrow(x, dim: int, n: int, i: int):
    b = x.shape[dim] // n
    return x.narrow(dim, i * b, b)


def local_args(plan, mesh, cfg) -> tuple:
    """Rank ``mesh.rank``'s pieces of ``plan.abstract_args`` (meta tensors
    of the global shapes), as the plan's ``fn`` takes them, each a meta
    tensor of its own (not a view of the global one, whose storage would
    count as the argument's); ``cfg`` is the config the plan was built
    from."""
    from torch.utils._pytree import tree_map

    def own(x):
        return (torch.empty(x.shape, dtype=x.dtype, device=x.device)
                if isinstance(x, torch.Tensor) else x)

    return tree_map(own, _local_views(plan, mesh, cfg))


def _local_views(plan, mesh, cfg) -> tuple:
    from repro_torch.launch import mesh as meshlib
    from repro_torch.runtime.trainer import (
        TrainState,
        local_params,
        local_state,
        shard_batch,
    )

    a, kind = plan.abstract_args, plan.kind
    tp = mesh.shape["model"]

    def specs():
        if plan.arch_id in _lm_archs():
            from repro_torch.models import transformer as T

            return T.make_param_specs(cfg, tp)
        from repro_torch.launch.steps import _RS_FNS

        return _RS_FNS[plan.arch_id][1](cfg, tp)

    if kind == "train":
        ex = plan.meta["exchange"]
        pflat, slots, ef, step = local_state(TrainState(*a[:4]), mesh, ex)
        # the sparse push's step also takes this rank's table shards
        tables = ((local_params(a[4], specs()["tables"], mesh),)
                  if len(a) == 6 else ())
        return (pflat, slots, ef, step, *tables,
                shard_batch(a[-1], mesh, ex, plan.meta.get("batch_spec")))
    wa = meshlib.worker_axes(mesh)
    nw = meshlib.num_workers(mesh)
    j = mesh.coords["model"]
    params = local_params(a[0], specs(), mesh)
    w = mesh.axis_index(wa)
    if kind == "prefill":
        return params, _narrow(a[1], 0, nw, w)
    if kind == "serve":
        return params, {k: _narrow(v, 0, nw, w) for k, v in a[1].items()}
    if kind == "retrieval":
        all_ax = tuple(mesh.axis_names)
        batch = dict(a[1])
        batch["cand_ids"] = _narrow(batch["cand_ids"], 0, mesh.size,
                                    mesh.axis_index(all_ax))
        return params, batch
    token, cache = a[1], a[2]
    if kind == "decode":
        rows = token.shape[0] >= nw  # else every worker holds the batch

        def cut(x, dim):
            x = _narrow(x, dim, nw, w) if rows else x
            return _narrow(x, dim + 1, tp, j)

        cache = {k: cut(v, 1) for k, v in cache.items()}
        token = _narrow(token, 0, nw, w) if rows else token
        return params, token, cache, a[2]["k"].shape[2] - 1
    if kind == "decode_long":
        caches = [{k: (_narrow(v, 1, tp, j) if cfg.is_global_layer(li)
                       else v) for k, v in c.items()}
                  for li, c in enumerate(cache)]
        s = max(c["k"].shape[1] for c in cache)
        return params, token, caches, s - 1
    raise ValueError(f"no local cut for a {kind} plan")


def _lm_archs() -> set:
    from repro_torch.configs.registry import get_arch, list_archs

    return {a for a in list_archs() if get_arch(a).family == "lm"}


def plan_config(plan, smoke: bool):
    """The config ``build_cell`` built ``plan`` from."""
    from repro_torch.configs.registry import get_arch

    if "config" in plan.meta:
        return plan.meta["config"]
    arch = get_arch(plan.arch_id)
    return arch.smoke_config if smoke else arch.config


def dry_run(plan, mesh, cfg) -> dict:
    """One step of ``plan`` (built on the ``RecordingMesh`` ``mesh``) on
    rank ``mesh.rank``'s meta pieces under a ``CostMode``: the record's
    measured fields (``n_devices``, the per-device FLOPs, bytes and
    collective bytes, ``memory``, ``flops_by_dtype``, ``kernels``,
    ``ops``, ``seconds``)."""
    if mesh.collectives:
        raise ValueError("dry_run needs a mesh that recorded nothing yet")
    args = local_args(plan, mesh, cfg)
    t0 = time.perf_counter()
    _, costs = step_costs(plan.fn, *args)
    seconds = time.perf_counter() - t0
    return {
        "n_devices": mesh.size,
        "flops_per_device": costs["flops"],
        "flops_by_dtype": costs["flops_by_dtype"],
        "bytes_per_device": costs["bytes"],
        "bytes_min_per_device": costs["bytes_min"],
        "collective_bytes_per_device": mesh.collective_bytes(),
        "collective_calls": {k: v["calls"]
                             for k, v in mesh.collectives.items()},
        "memory": {"peak_estimate": costs["peak_estimate"]},
        "kernels": costs["kernels"],
        "ops": costs["ops"],
        "seconds": round(seconds, 2),
    }


def run_cell(arch_id: str, shape: str, multi_pod: bool, strategy: str,
             out_dir: Path, force: bool = False,
             variant: str | None = None, *, smoke: bool = False,
             layout: tuple | None = None) -> dict:
    """Dry-run one cell and cache its JSON record under ``out_dir``.
    ``smoke`` and ``layout`` (``(shape, axes)`` in place of the production
    mesh) are the port's, for small sweeps."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.mesh import RecordingMesh, make_production_mesh
    from repro_torch.launch.steps import build_cell

    mshape, axes = layout or make_production_mesh(multi_pod=multi_pod)
    mname = "x".join(str(d) for d in mshape)
    tag = f"{arch_id}__{shape}__{mname}__{strategy}"
    if variant:
        tag += f"__{variant}"
    if smoke:
        tag += "__smoke"
    out_file = Path(out_dir) / f"{tag}.json"
    if out_file.exists() and not force:
        return json.loads(out_file.read_text())

    rec = {"arch": arch_id, "shape": shape, "mesh": mname,
           "strategy": strategy}
    cell = get_arch(arch_id).cell(shape)
    if cell.skip_reason and not smoke:
        rec["status"] = "skipped"
        rec["reason"] = cell.skip_reason
        out_file.write_text(json.dumps(rec, indent=1))
        return rec
    try:
        mesh = RecordingMesh(mshape, axes)
        plan = build_cell(arch_id, shape, mesh, strategy=strategy,
                          variant=variant, smoke=smoke)
        rec.update(status="ok", **dry_run(plan, mesh,
                                          plan_config(plan, smoke)))
        rec["meta"] = {k: v for k, v in plan.meta.items()
                       if isinstance(v, (int, float, str))}
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    out_file.write_text(json.dumps(rec, indent=1))
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multipod", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--strategy", default="pbox")
    ap.add_argument("--variant", default=None,
                    help="optimized variant, e.g. 'sp' (sequence parallel)")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    pods = {"single": [False], "multi": [True],
            "both": [False, True]}[args.multipod]

    from repro_torch.configs.registry import list_cells

    cells = list_cells() if args.all else [(args.arch, args.shape)]
    failures = 0
    for arch_id, shape in cells:
        for mp in pods:
            rec = run_cell(arch_id, shape, mp, args.strategy, out_dir,
                           force=args.force, variant=args.variant)
            status = rec["status"]
            extra = ""
            if status == "ok":
                gb = rec["memory"]["peak_estimate"] / 2**30
                extra = (f" flops/dev={rec['flops_per_device']:.3g}"
                         f" peak={gb:.2f}GiB"
                         f" coll={rec['collective_bytes_per_device']['total'] / 2**20:.1f}MiB"
                         f" meta step={rec['seconds']}s")
            elif status == "error":
                failures += 1
                extra = " " + rec["error"][:160]
            print(f"[{status:7s}] {arch_id:22s} {shape:14s} "
                  f"{'multi ' if mp else 'single'}{extra}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
