"""Rank bodies and the spawn harness for the port's SPMD tests.

``spawn(world, fn, out_dir, ...)`` starts ``world`` processes (the
``spawn`` start method), each joining a gloo group that rendezvouses in a
file under ``out_dir`` (no port to collide with other test workers), runs
``fn(rank, world, out_dir, *args)`` with one intra-op thread, and writes
its results as ``.npz`` files under ``out_dir``.  Every join has a
deadline, so a hung collective fails the test instead of the suite.

This module imports torch and the port only, never JAX: spawn re-imports
it in every child.  The JAX references run in a subprocess
(``tests/torch_spmd_jax.py``).  Inputs are made with numpy by functions
both sides share (``toy_params``, ``toy_grads``, ``lm_tokens``).
"""
from __future__ import annotations

import os
import time
import traceback
from pathlib import Path

import numpy as np

SPAWN_TIMEOUT = 120.0

# -- shared inputs (numpy, imported by the JAX script as well) -------------


def toy_params() -> dict:
    """exchange_equivalence.py's toy model, made in numpy."""
    return {"w": np.arange(24, dtype=np.float32).reshape(4, 6)
            / np.float32(10),
            "b": np.ones((5,), np.float32)}


def toy_grads(widx: int, kind: str = "int") -> dict:
    """Worker ``widx``'s gradients: exchange_equivalence.py's small
    integers (every sum exact), or ``"nw3"`` integers whose sums over three
    workers are mostly not multiples of 3."""
    w = float(widx)
    if kind == "int":
        return {"w": np.full((4, 6), w + 1.0, np.float32),
                "b": (np.arange(5, dtype=np.float32) * (w + 1))}
    return {"w": ((np.arange(24, dtype=np.float32).reshape(4, 6) + 1)
                  * (w + 1) + w * w),
            "b": np.arange(5, dtype=np.float32) * (w + 2) + 7 * w}


EXCHANGE_CASES = {
    # name: (strategy, codec, ps dtype, pull dtype, error feedback)
    "allreduce": ("allreduce", "none", "f32", None, True),
    "pbox": ("pbox", "none", "f32", None, True),
    "pbox_hier": ("pbox_hier", "none", "f32", None, True),
    "pbox_hier_int8": ("pbox_hier", "int8", "f32", None, True),
    "pbox_hier_bf16": ("pbox_hier", "bf16", "f32", None, True),
    "pbox_pull_bf16": ("pbox", "none", "f32", "bf16", True),
    "pbox_bf16": ("pbox", "none", "bf16", None, True),
    "pbox_hier_int8_bf16": ("pbox_hier", "int8", "bf16", None, True),
    "pbox_hier_bf16_bf16": ("pbox_hier", "bf16", "bf16", None, False),
    # int8 without error feedback refuses a bf16 slab, in both packages
    "pbox_hier_int8_bf16_noef": ("pbox_hier", "int8", "bf16", None, False),
}
NW3_CASES = ("allreduce", "pbox", "pbox_pull_bf16", "pbox_bf16")
EXCHANGE_STEPS = 3


def lm_tokens(vocab: int, batch: int, seq: int = 16, seed: int = 1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (batch, seq)).astype(np.int32)
    labs = rng.integers(0, vocab, (batch, seq)).astype(np.int32)
    return toks, labs


TRAINER_CASES = {
    # name: (strategy, optimizer, microbatches, lr schedule, global batch)
    "pbox_sgd": ("pbox", "sgd", 1, False, 4),
    "allreduce_sgd": ("allreduce", "sgd", 1, False, 4),
    "pbox_momentum_mb2": ("pbox", "momentum", 2, True, 4),
    "pbox_momentum_mb3": ("pbox", "momentum", 3, True, 6),
    "pbox_adamw_mb1": ("pbox", "adamw", 1, True, 4),
}
TRAINER_STEPS = 2


# sparse_table_update over 3 workers: (name: lr, the ids' draw).  "exact"
# starts from zero tables with unit cotangents, so each touched element
# is -scale itself and lr / 3 as a division differs from a product with
# 1/3 (at lr 0.01, by one f32 ulp); "dups" draws random tables and bf16
# cotangents with every id repeated within and across the workers.
SPARSE_PUSH_CASES = {"exact": (0.01, "unique"), "dups": (0.1, "dups")}
SP_V, SP_D, SP_B, SP_F, SP_NW = 24, 8, 6, 2, 3


def sparse_push_inputs(kind: str) -> dict:
    """Tables {t0, t1} (SP_V, SP_D) and each worker's ids (SP_NW, SP_B,
    SP_F) int32 and cotangents (SP_NW, SP_B, SP_F, SP_D) f32."""
    rng = np.random.default_rng(5)
    if kind == "unique":
        tables = {f"t{i}": np.zeros((SP_V, SP_D), np.float32)
                  for i in range(SP_F)}
        ids = np.arange(SP_NW * SP_B * SP_F, dtype=np.int32).reshape(
            SP_F, SP_NW, SP_B).transpose(1, 2, 0) % SP_V
        cot = np.ones((SP_NW, SP_B, SP_F, SP_D), np.float32)
    else:
        tables = {f"t{i}": rng.standard_normal((SP_V, SP_D)).astype(np.float32)
                  for i in range(SP_F)}
        ids = rng.integers(0, 4, (SP_NW, SP_B, SP_F)).astype(np.int32)
        cot = rng.standard_normal((SP_NW, SP_B, SP_F, SP_D)).astype(np.float32)
    return {"tables": tables, "ids": ids, "cot": cot}


# the recsys SPMD file: a (2, 4) ("data", "model") mesh, every arch's SMOKE
# config, one step of each train cell, the serve and retrieval cells
RS_ARCHS = ("dlrm-mlperf", "autoint", "dien", "xdeepfm")
RS_MESH = (2, 4)


def rs_batch(arch_id: str, cfg, batch: int, seed: int) -> dict:
    from repro_torch.data.synthetic import recsys_batches

    return next(recsys_batches(arch_id, cfg, batch, seed))


def rs_candidates(cfg, n: int) -> np.ndarray:
    """Candidate ids over table t0's rows and a few past its end."""
    rng = np.random.default_rng(9)
    return rng.integers(0, cfg.vocabs[0] + 8, n).astype(np.int32)


# -- the harness -----------------------------------------------------------


def _entry(rank, world, fn, out_dir, args):
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_process_group

    torch.set_num_threads(1)
    try:
        init_process_group("cpu", init_method=f"file://{out_dir}/rendezvous",
                           rank=rank, world_size=world)
        try:
            fn(rank, world, out_dir, *args)
        finally:
            dist.destroy_process_group()
    except BaseException:
        Path(out_dir, f"error_r{rank}.txt").write_text(traceback.format_exc())
        raise


def spawn(world: int, fn, out_dir, *args, timeout: float = SPAWN_TIMEOUT):
    """Run ``fn`` on ``world`` gloo ranks; raise with the first rank's
    traceback if any rank fails, or if the ranks outlive ``timeout``."""
    import torch.multiprocessing as mp

    out_dir = str(out_dir)
    os.makedirs(out_dir, exist_ok=True)
    ctx = mp.start_processes(_entry, args=(world, fn, out_dir, args),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks still running after "
                                   f"{timeout:.0f} s")
    except BaseException:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
        for p in ctx.processes:
            p.join(timeout=10)
        errs = sorted(Path(out_dir).glob("error_r*.txt"))
        if errs:
            raise RuntimeError(errs[0].read_text()) from None
        raise


def start_jax(group: str, out_dir):
    """Start ``tests/torch_spmd_jax.py <group> <out_dir>`` (the JAX side)
    in a subprocess that sees ``n`` host devices; ``finish_jax`` waits."""
    import subprocess
    import sys

    here = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(here.parent / "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    return subprocess.Popen(
        [sys.executable, str(here / "torch_spmd_jax.py"), group,
         str(out_dir)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env)


def finish_jax(proc, timeout: float = SPAWN_TIMEOUT) -> None:
    try:
        _, err = proc.communicate(timeout=timeout)
    except BaseException:
        proc.kill()
        proc.communicate()
        raise
    if proc.returncode != 0:
        raise RuntimeError(f"the JAX side failed:\n{err[-4000:]}")


def wait_for(path, timeout: float = SPAWN_TIMEOUT) -> None:
    """Wait until ``path`` exists (the JAX side writes it atomically)."""
    deadline = time.monotonic() + timeout
    while not Path(path).exists():
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} did not appear in {timeout:.0f} s")
        time.sleep(0.2)


def _save(out_dir, name: str, **arrays) -> None:
    np.savez(Path(out_dir, f"{name}.npz"),
             **{k: v for k, v in arrays.items() if v is not None})


def _np(t):
    """A tensor as a numpy array; bf16 as f32 (exact)."""
    import torch

    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree(v, fn) for k, v in tree.items()}
    return fn(tree)


# -- rank bodies: the exchange ---------------------------------------------


def _exchange_run(mesh, case, worker_axes, pod, kind):
    import torch

    from repro_torch.core.compression import CompressionConfig
    from repro_torch.core.exchange import ExchangeConfig, PSExchange
    from repro_torch.optim.optimizers import adam

    strategy, codec, dt, pull, ef_on = case
    dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[dt]
    cfg = ExchangeConfig(
        strategy=strategy,
        compression=CompressionConfig(codec=codec, error_feedback=ef_on),
        pull_dtype=torch.bfloat16 if pull == "bf16" else None)
    ex = PSExchange(adam(1e-2), cfg, worker_axes,
                    pod if strategy == "pbox_hier" else None)
    params = _tree(toy_params(), torch.from_numpy)
    space = ex.build_space(params, dict(mesh.shape))
    state = ex.init_slab_state(space, device="cpu")
    pflat = space.flatten(params, dtype)
    widx = mesh.axis_index(ex.worker_axes)
    grads = _tree(toy_grads(widx, kind), torch.from_numpy)
    for _ in range(EXCHANGE_STEPS):
        pflat, state = ex.device_update(space.flatten(grads, dtype), pflat,
                                        state, mesh=mesh)
    return pflat, state


def exchange_ranks(rank, world, out_dir):
    """Every ``EXCHANGE_CASES`` case on the (2, 2, 2) mesh, or every
    ``NW3_CASES`` case on a (3,) mesh; each rank saves its params, slots,
    residual and coordinates (or the error its case raised)."""
    from repro_torch.launch.mesh import Mesh

    if world == 8:
        mesh = Mesh((2, 2, 2), ("pod", "data", "model"))
        cases, wa, kind = EXCHANGE_CASES, ("pod", "data", "model"), "int"
    else:
        mesh = Mesh((3,), ("data",))
        cases = {k: EXCHANGE_CASES[k] for k in NW3_CASES}
        wa, kind = ("data",), "nw3"
    coords = np.array([mesh.coords[a] for a in mesh.axis_names])
    for name, case in cases.items():
        try:
            pflat, state = _exchange_run(mesh, case, wa, "pod", kind)
        except ValueError as e:
            Path(out_dir, f"{name}_r{rank}.err").write_text(
                f"{type(e).__name__}: {e}")
            continue
        _save(out_dir, f"{name}_r{rank}", pflat=_np(pflat),
              coords=coords, ef=_np(state["ef"]) if state["ef"] is not None
              else None, step=np.asarray(int(state["step"])),
              **{f"slot{i}": _np(s) for i, s in enumerate(state["slots"])})


# -- rank bodies: hierarchy and zero-compute -------------------------------


def hierarchy_ranks(rank, world, out_dir):
    """tests/scripts/hier_and_zero_compute.py's collectives on the
    (2, 2, 2) mesh, each rank holding row ``(pod, data)`` of arange(32)."""
    import torch

    from repro_torch.core import hierarchy as H
    from repro_torch.launch.mesh import Mesh

    mesh = Mesh((2, 2, 2), ("pod", "data", "model"))
    row = mesh.axis_index(("pod", "data"))
    x = torch.arange(32.0).reshape(4, 8)[row]
    m2 = torch.arange(12.0).reshape(3, 4) + 100 * row
    out = {
        "flat": mesh.psum(x, ("pod", "data")),
        "hier": H.hierarchical_psum(x, ("data",), "pod", mesh=mesh),
        "hier_mean": H.hierarchical_pmean(x, ("data",), "pod", mesh=mesh),
        "inner_only": H.hierarchical_psum(x, ("data",), None, mesh=mesh),
        "gather": H.two_level_all_gather(x, ("data",), "pod", mesh=mesh),
        "gather_ax1": H.two_level_all_gather(m2, ("data",), "pod", axis=1,
                                             mesh=mesh),
        "gather_inner": H.two_level_all_gather(x, "data", None, mesh=mesh),
        "pmean3": H.hierarchical_pmean(x + 1.0 / 3.0, ("data", "model"),
                                       "pod", mesh=mesh),
        "flat_mean3": mesh.pmean(x + 1.0 / 3.0, ("pod", "data", "model")),
    }
    _save(out_dir, f"hier_r{rank}", row=np.asarray(row),
          **{k: _np(v) for k, v in out.items()})


ZERO_FLAT = 8192 * 8
ZERO_CASES = (("pbox", None), ("pbox_hier", "pod"), ("allreduce", None))


def zero_compute_ranks(rank, world, out_dir):
    """One zero-compute step per strategy under momentum(0.1, 0.9): every
    param moves to -0.1."""
    import torch

    from repro_torch.core.exchange import ExchangeConfig, PSExchange
    from repro_torch.core.zero_compute import (
        init_zero_compute_state,
        make_zero_compute_step,
    )
    from repro_torch.launch.mesh import Mesh
    from repro_torch.optim.optimizers import momentum

    mesh = Mesh((2, 2, 2), ("pod", "data", "model"))
    for strategy, pod in ZERO_CASES:
        ex = PSExchange(momentum(0.1, 0.9), ExchangeConfig(strategy=strategy),
                        ("pod", "data", "model"), pod)
        step = make_zero_compute_step(mesh, ex, ZERO_FLAT)
        state = init_zero_compute_state(mesh, ex, ZERO_FLAT, device="cpu")
        p2, state = step(torch.zeros(ZERO_FLAT), torch.ones(ZERO_FLAT), state)
        _save(out_dir, f"zero_{strategy}_r{rank}", p=_np(p2),
              slot0=_np(state["slots"][0]), step=np.asarray(int(state["step"])))


# -- rank bodies: the trainer ----------------------------------------------


def trainer_setup(mesh, case, params_np, device="cpu"):
    """The port's train step for a ``TRAINER_CASES`` case on gemma3-1b's
    SMOKE config: (step, space, exchange, pflat, slots, ef, stc)."""
    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.core.exchange import ExchangeConfig, PSExchange
    from repro_torch.interop import params_from_numpy
    from repro_torch.launch import mesh as meshlib
    from repro_torch.models import transformer as T
    from repro_torch.models.common import Dist
    from repro_torch.optim import optimizers as O
    from repro_torch.optim.schedules import linear_warmup
    from repro_torch.runtime.trainer import (
        init_train_state,
        local_state,
        make_ps_train_step,
    )

    strategy, opt, mb, sched, _gb = case
    cfg = get_arch("gemma3-1b").smoke_config
    spec = {"sgd": O.sgd(1e-1), "momentum": O.momentum(1e-1, 0.9),
            "adamw": O.adamw(1e-3, weight_decay=0.1)}[opt]
    ex = PSExchange(spec, ExchangeConfig(strategy=strategy),
                    meshlib.worker_axes(mesh), None)
    dist = Dist(model_axis="model", data_axes=("data",), tp=1, mesh=mesh)
    step, space, _, ng = make_ps_train_step(
        mesh, global_param_template=T.abstract_params(cfg), exchange=ex,
        dist=dist, loss_fn=lambda p, b, d: T.lm_loss(p, b["tokens"],
                                                     b["labels"], cfg),
        ps_dtype=cfg.param_dtype, microbatches=mb,
        lr_schedule=linear_warmup(4) if sched else None)
    state = init_train_state(
        mesh, init_params_fn=lambda tree: params_from_numpy(tree, device),
        exchange=ex, space=space, n_groups=ng, key=params_np,
        ps_dtype=cfg.param_dtype, device=device)
    return (step, space, ex, *local_state(state, mesh, ex))


def trainer_ranks(rank, world, out_dir):
    """Every ``TRAINER_CASES`` case on a (2, 1) mesh, from the weights the
    JAX script saved; each rank saves its losses, params and slots."""
    import torch

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime.trainer import shard_batch

    mesh = make_mesh((2, 1), ("data", "model"))
    params_np = dict(np.load(Path(out_dir, "jax_params.npz")))
    params_np = _unflat(params_np)
    for name, case in TRAINER_CASES.items():
        step, space, ex, pflat, slots, ef, stc = trainer_setup(
            mesh, case, params_np)
        toks, labs = lm_tokens(512, case[4])
        batch = shard_batch({"tokens": torch.from_numpy(toks),
                             "labels": torch.from_numpy(labs)}, mesh, ex)
        losses = []
        for _ in range(TRAINER_STEPS):
            pflat, slots, ef, stc, met = step(pflat, slots, ef, stc, batch)
            losses.append(float(met["loss"]))
        _save(out_dir, f"{name}_r{rank}", pflat=_np(pflat),
              losses=np.asarray(losses), coords=np.asarray(
                  [mesh.coords["data"]]),
              **{f"slot{i}": _np(s) for i, s in enumerate(slots)})


def _unflat(flat: dict) -> dict:
    """``{"layers/wq": a}`` -> ``{"layers": {"wq": a}}``."""
    tree: dict = {}
    for k, v in flat.items():
        node = tree
        *head, last = k.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    return tree


def flat_keys(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_keys(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


# -- rank bodies: the train driver -----------------------------------------


def train_launch_ranks(rank, world, out_dir):
    """launch/train.main on a (2, 1) mesh: six steps with checkpoints at 3
    and 6; a crash after step 3 and a resume to 6; a resume of the JAX
    driver's step-3 checkpoint to step 4; then three steps at ``--mesh
    1x2`` (the model over both ranks); then dlrm-mlperf SMOKE for three
    steps at ``--mesh 2x1`` and ``1x2``; then resnet50 SMOKE for two steps
    at ``--mesh 2x1`` and ``1x2`` (pure data parallelism over both
    axes); then equiformer-v2 SMOKE for three steps at ``--mesh 2x1`` and
    ``1x2``."""
    import shutil

    import torch.distributed as dist

    from repro_torch.launch.train import main

    base = ["--arch", "gemma3-1b", "--mesh", "2x1", "--log-every", "1"]
    full = main(base + ["--steps", "6", "--ckpt-dir", f"{out_dir}/full",
                        "--ckpt-every", "3"], device="cpu")
    main(base + ["--steps", "3", "--ckpt-dir", f"{out_dir}/crash",
                 "--ckpt-every", "3"], device="cpu")
    resumed = main(base + ["--steps", "6", "--ckpt-dir", f"{out_dir}/crash",
                           "--resume"], device="cpu")
    # the JAX side's step-3 checkpoint, copied: the resumed run writes its
    # own step 4 beside it
    wait_for(Path(out_dir, "jax_launch.npz"))
    if rank == 0:
        shutil.copytree(Path(out_dir, "jax"), Path(out_dir, "jax_resume"))
    dist.barrier()
    from_jax = main(base + ["--steps", "4", "--ckpt-dir",
                            f"{out_dir}/jax_resume", "--resume"],
                    device="cpu")
    tp2 = main(["--arch", "gemma3-1b", "--mesh", "1x2", "--steps", "3",
                "--log-every", "1"], device="cpu")
    # dlrm-mlperf SMOKE: the workers' split, then the tables row-sharded
    rs = {f"dlrm_{mesh}": main(["--arch", "dlrm-mlperf", "--mesh", mesh,
                                "--steps", "3", "--log-every", "3"],
                               device="cpu")
          for mesh in ("2x1", "1x2")}
    rs.update({f"resnet_{mesh}": main(["--arch", "resnet50", "--mesh", mesh,
                                       "--steps", "2", "--log-every", "2"],
                                      device="cpu")
               for mesh in ("2x1", "1x2")})
    # equiformer-v2 SMOKE (molecule): the batch over two workers, each
    # worker's ids rebased to its block; then channel TP over two ranks
    rs.update({f"gnn_{mesh}": main(["--arch", "equiformer-v2", "--mesh",
                                    mesh, "--steps", "3", "--log-every",
                                    "3"], device="cpu")
               for mesh in ("2x1", "1x2")})
    for name, out in (("full", full), ("resumed", resumed),
                      ("from_jax", from_jax), ("tp2", tp2), *rs.items()):
        _save(out_dir, f"launch_{name}_r{rank}", pflat=_np(out["pflat"]),
              losses=np.asarray(out["losses"]), start=np.asarray(out["start"]),
              step=np.asarray(out["step"]),
              **{f"slot{i}": _np(s) for i, s in enumerate(out["slots"])})


# -- rank bodies: tensor parallelism ---------------------------------------

# tests/scripts/tp_equivalence.py's non-MoE cases (f32, attn_chunk 8)
TP_CASES = {
    "gqa_kvrep": dict(n_layers=2, d_model=64, n_heads=8, n_kv_heads=2,
                      head_dim=16, d_ff=128, vocab=256),
    "dup_R2": dict(n_layers=2, d_model=64, n_heads=2, n_kv_heads=1,
                   head_dim=16, d_ff=128, vocab=256),
    "kvshard_bias": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                         head_dim=16, d_ff=128, vocab=256, qkv_bias=True),
}
TP = 4
# tests/scripts/tp_equivalence.py's MoE case, at tp = 2: experts sharded
# over d_ff_expert, the router replicated (capacity factor 4 drops nothing)
TP_MOE_CASES = {
    "moe": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
                d_ff=0, vocab=256,
                moe=dict(n_experts=8, top_k=2, d_ff_expert=32, shared_d_ff=64,
                         capacity_factor=4.0)),
}
TP_MOE = 2
# tests/scripts/grad_equivalence.py's cases (remat off there)
TP_TRAIN_CASES = {
    "dense_gqa": dict(TP_CASES["gqa_kvrep"], qkv_bias=True, remat=False),
    "dup_R2": dict(TP_CASES["dup_R2"], remat=False),
}
TP_TRAIN_STEPS = 2


def tp_config(kw: dict):
    """A case's port config: f32, q-chunks of 8 (a ``moe`` dict becomes the
    ``MoEConfig``)."""
    import torch

    from repro_torch.models.moe import MoEConfig
    from repro_torch.models.transformer import TransformerConfig

    if "moe" in kw:
        kw = dict(kw, moe=MoEConfig(**kw["moe"]))
    return TransformerConfig("tp", dtype=torch.float32,
                             param_dtype=torch.float32, attn_chunk=8, **kw)


def psum_transpose_ranks(mesh, out_dir, rank):
    """tests/scripts/psum_transpose.py: per rank y = psum(2 w_j), loss_j =
    y c_j; each dw_j is 2 sum(c) = 200 when psum's transpose is psum."""
    import torch

    from repro_torch.models.common import Dist

    dist = Dist("model", (), TP, mesh)
    j = mesh.coords["model"]
    w = torch.tensor(float(j + 1), requires_grad=True)
    c = (10.0, 20.0, 30.0, 40.0)[j]
    loss = dist.psum_model(2.0 * w) * c
    (g,) = torch.autograd.grad(loss, w)
    # and the other transposes: all_gather <-> psum_scatter
    x = torch.arange(4.0, requires_grad=True) + 4 * j
    ag = dist.all_gather_model(x[None], axis=1)  # (1, 16)
    (gx,) = torch.autograd.grad((ag * torch.arange(16.0)).sum() * (j + 1), x)
    y = torch.arange(16.0, requires_grad=True)
    ps = dist.psum_scatter_model(y[None] * (j + 1), axis=1)  # (1, 4)
    (gy,) = torch.autograd.grad((ps * torch.arange(4.0)).sum(), y)
    _save(out_dir, f"psum_r{rank}", dw=_np(g), gx=_np(gx), gy=_np(gy),
          j=np.asarray(j))


def tp_ranks(rank, world, out_dir):
    """The psum transpose, then every ``TP_CASES`` case at tp = 4 on a
    (1, 4) mesh from the JAX package's tp = 4 weights: the loss, greedy
    prefill and decode ids and this rank's cache shard; rank 0 also runs
    the tp = 1 model on the JAX package's tp = 1 weights.  Then every
    ``TP_MOE_CASES`` case at tp = 2 on a (2, 2) mesh, each data group on
    the whole batch, the same way."""
    import torch

    from repro_torch.interop import params_from_numpy
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import transformer as T
    from repro_torch.models.common import Dist
    from repro_torch.runtime.trainer import local_params

    mesh = Mesh((TP,), ("model",))
    psum_transpose_ranks(mesh, out_dir, rank)
    mesh4 = Mesh((1, TP), ("data", "model"))
    mesh2 = Mesh((TP // TP_MOE, TP_MOE), ("data", "model"))
    cases = [(name, kw, TP, mesh4) for name, kw in TP_CASES.items()]
    cases += [(name, kw, TP_MOE, mesh2) for name, kw in TP_MOE_CASES.items()]
    for name, kw, TPN, mesh in cases:
        dist = Dist("model", ("data",), TPN, mesh)
        cfg = tp_config(kw)
        wait_for(Path(out_dir, f"jax_tp_{name}.npz"))
        jax_out = dict(np.load(Path(out_dir, f"jax_tp_{name}.npz")))
        toks, labs = (torch.from_numpy(a) for a in lm_tokens(cfg.vocab, 4))
        out = {}
        for tp in ((TPN, 1) if rank == 0 else (TPN,)):
            params = params_from_numpy(_unflat(
                {k[len(f"p{tp}/"):]: v for k, v in jax_out.items()
                 if k.startswith(f"p{tp}/")}), "cpu")
            d = dist if tp > 1 else None
            if tp > 1:
                params = local_params(params, T.make_param_specs(cfg, tp),
                                      mesh)
            with torch.no_grad():
                loss = T.lm_loss(params, toks, labs, cfg, d)[1]["ce"]
                nxt, cache = T.prefill(params, toks, cfg, 32, dist=d)
                nxt_b, cache = T.decode_step(params, nxt, cache, 16, cfg, d)
                out.update({f"loss{tp}": _np(loss), f"nxt{tp}": _np(nxt),
                            f"dec{tp}": _np(nxt_b),
                            f"k{tp}": _np(cache["k"]),
                            f"v{tp}": _np(cache["v"])})
                if tp == 1:  # decode == prefill of the 17 tokens
                    t17 = torch.cat([toks, nxt[:, None]], dim=1)
                    out["pre17"] = _np(T.prefill(params, t17, cfg, 32)[0])
        _save(out_dir, f"tp_{name}_r{rank}", **out)


def tp_train_ranks(rank, world, out_dir):
    """On a (2, 4) ("data", "model") mesh: every ``TP_TRAIN_CASES`` case
    (pbox, SGD 0.1, ``TP_TRAIN_STEPS`` steps from the JAX package's tp = 4
    weights, each data rank holding 2 of 4 rows) saves this rank's local
    params; then ``launch/train.main`` at ``--mesh 2x4``: six steps with
    checkpoints at 3 and 6, and a run stopped at 3 and resumed to 6."""
    import torch

    from repro_torch.core.exchange import ExchangeConfig, PSExchange
    from repro_torch.interop import params_from_numpy
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import main
    from repro_torch.models import transformer as T
    from repro_torch.models.common import Dist
    from repro_torch.optim.optimizers import sgd
    from repro_torch.runtime.trainer import (
        init_train_state,
        local_state,
        make_ps_train_step,
        shard_batch,
    )

    mesh = make_mesh((2, TP), ("data", "model"))
    dist = Dist("model", ("data",), TP, mesh)
    for name, kw in TP_TRAIN_CASES.items():
        cfg = tp_config(kw)
        wait_for(Path(out_dir, f"jax_tp_train_{name}.npz"))
        jax_out = dict(np.load(Path(out_dir, f"jax_tp_train_{name}.npz")))
        params_np = _unflat({k[3:]: v for k, v in jax_out.items()
                             if k.startswith("p4/")})
        ex = PSExchange(sgd(1e-1), ExchangeConfig("pbox"), ("data",), None)
        specs = T.make_param_specs(cfg, TP)
        step, space, _, ng = make_ps_train_step(
            mesh, loss_fn=lambda p, b, d, cfg=cfg: T.lm_loss(
                p, b["tokens"], b["labels"], cfg, d),
            param_specs=specs, sync_tags=T.grad_sync(cfg, TP),
            global_param_template=T.abstract_params(cfg, TP), exchange=ex,
            dist=dist, donate=False)
        state = init_train_state(
            mesh, init_params_fn=lambda tree: params_from_numpy(tree, "cpu"),
            param_specs=specs, exchange=ex, space=space, n_groups=ng,
            key=params_np, device="cpu")
        pflat, slots, ef, stc = local_state(state, mesh, ex)
        toks, labs = lm_tokens(cfg.vocab, 4)
        batch = shard_batch({"tokens": torch.from_numpy(toks),
                             "labels": torch.from_numpy(labs)}, mesh, ex)
        for _ in range(TP_TRAIN_STEPS):
            pflat, slots, ef, stc, met = step(pflat, slots, ef, stc, batch)
        local = flat_keys(_tree(space.unflatten(pflat[0]), _np))
        _save(out_dir, f"tp_train_{name}_r{rank}", pflat=_np(pflat),
              model=np.asarray(mesh.coords["model"]), **{
                  f"p/{k}": v for k, v in local.items()})
    base = ["--arch", "gemma3-1b", "--mesh", "2x4", "--log-every", "3"]
    full = main(base + ["--steps", "6", "--ckpt-dir", f"{out_dir}/full",
                        "--ckpt-every", "3"], device="cpu")
    main(base + ["--steps", "3", "--ckpt-dir", f"{out_dir}/crash",
                 "--ckpt-every", "3"], device="cpu")
    resumed = main(base + ["--steps", "6", "--ckpt-dir", f"{out_dir}/crash",
                           "--resume"], device="cpu")
    for label, out in (("full", full), ("resumed", resumed)):
        _save(out_dir, f"tp_launch_{label}_r{rank}", pflat=_np(out["pflat"]),
              losses=np.asarray(out["losses"]), start=np.asarray(out["start"]),
              model=np.asarray(mesh.coords["model"]),
              **{f"slot{i}": _np(s) for i, s in enumerate(out["slots"])})


# -- rank bodies: sequence parallelism --------------------------------------

# tests/scripts/seq_parallel_equivalence.py's model (f32, attn_chunk 8, 16
# tokens, QKV biases) at tp = 4 on a (2, 4) mesh, and two more: R = 2 (2
# heads over 4 model ranks) and the MoE FFN (TP_MOE_CASES' model)
SP_TP = 4
SP_CASES = {
    "gqa": dict(TP_CASES["gqa_kvrep"], qkv_bias=True),
    "dup_R2": dict(TP_CASES["dup_R2"], qkv_bias=True),
    "moe": TP_MOE_CASES["moe"],
}
SP_JAX_BASELINE = ("gqa",)  # JAX also runs these without SP
SP_LR = 0.1


def _sp_step(cfg, mesh, dist, params_np, toks, labs):
    """One pbox SGD(SP_LR) step of ``make_ps_train_step`` from the global
    weights ``params_np``: (this rank's new pflat, the loss metric)."""
    import torch

    from repro_torch.core.exchange import ExchangeConfig, PSExchange
    from repro_torch.interop import params_from_numpy
    from repro_torch.models import transformer as T
    from repro_torch.optim.optimizers import sgd
    from repro_torch.runtime.trainer import (
        init_train_state,
        local_state,
        make_ps_train_step,
        shard_batch,
    )

    ex = PSExchange(sgd(SP_LR), ExchangeConfig("pbox"), ("data",), None)
    specs = T.make_param_specs(cfg, SP_TP)
    step, space, _, ng = make_ps_train_step(
        mesh, loss_fn=lambda p, b, d: T.lm_loss(p, b["tokens"], b["labels"],
                                                cfg, d),
        param_specs=specs, sync_tags=T.grad_sync(cfg, SP_TP),
        global_param_template=T.abstract_params(cfg, SP_TP), exchange=ex,
        dist=dist, donate=False)
    state = init_train_state(
        mesh, init_params_fn=lambda tree: params_from_numpy(tree, "cpu"),
        param_specs=specs, exchange=ex, space=space, n_groups=ng,
        key=params_np, device="cpu")
    pflat, slots, ef, stc = local_state(state, mesh, ex)
    batch = shard_batch({"tokens": torch.from_numpy(toks),
                         "labels": torch.from_numpy(labs)}, mesh, ex)
    pflat, _, _, _, met = step(pflat, slots, ef, stc, batch)
    return _np(pflat), _np(met["loss"])


def seq_parallel_ranks(rank, world, out_dir):
    """Every ``SP_CASES`` case on a (2, 4) ("data", "model") mesh from the
    JAX package's tp = 4 weights, with and without sequence parallelism:
    the cross entropy (pmean over "data"), one ``_sp_step``, and greedy
    prefill (max_seq 32) and one decode step of this data rank's rows."""
    import dataclasses

    import torch

    from repro_torch.interop import params_from_numpy
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as T
    from repro_torch.models.common import Dist
    from repro_torch.runtime.trainer import local_params

    mesh = make_mesh((2, SP_TP), ("data", "model"))
    dist = Dist("model", ("data",), SP_TP, mesh)
    d = mesh.coords["data"]
    for name, kw in SP_CASES.items():
        wait_for(Path(out_dir, f"jax_sp_{name}_params.npz"))
        params_np = _unflat(dict(np.load(
            Path(out_dir, f"jax_sp_{name}_params.npz"))))
        toks, labs = lm_tokens(kw["vocab"], 4)
        out = {}
        for sp in (False, True):
            cfg = dataclasses.replace(tp_config(kw), seq_parallel=sp)
            params = local_params(params_from_numpy(params_np, "cpu"),
                                  T.make_param_specs(cfg, SP_TP), mesh)
            t, lab = (torch.from_numpy(a[2 * d:2 * d + 2])
                      for a in (toks, labs))
            with torch.no_grad():
                ce = T.lm_loss(params, t, lab, cfg, dist)[1]["ce"]
                nxt, cache = T.prefill(params, t, cfg, 32, dist=dist)
                dec, cache = T.decode_step(params, nxt, cache, 16, cfg, dist)
            pflat, loss = _sp_step(cfg, mesh, dist, params_np, toks, labs)
            tag = "sp" if sp else "base"
            out.update({f"ce_{tag}": _np(mesh.pmean(ce, "data")),
                        f"pflat_{tag}": pflat, f"loss_{tag}": loss,
                        f"nxt_{tag}": _np(nxt), f"dec_{tag}": _np(dec),
                        f"k_{tag}": _np(cache["k"]),
                        f"v_{tag}": _np(cache["v"])})
        _save(out_dir, f"sp_{name}_r{rank}", model=np.asarray(
            mesh.coords["model"]), **out)


# -- rank bodies: the serve driver -----------------------------------------

SERVE_MESH_ARGV = ["--arch", "gemma3-1b", "--mesh", "1x2", "--batch", "2",
                   "--prompt-len", "8", "--tokens", "3", "--seed", "0"]
SERVE_MESH_SOURCES = {
    "model": ["--source", "model"],
    "fabric": ["--source", "fabric", "--train-rounds", "2",
               "--serve-shards", "2", "--serve-replication", "2"],
    "checkpoint": ["--source", "checkpoint", "--train-rounds", "1",
                   "--serve-shards", "2"],
}


def serve_launch_ranks(rank, world, out_dir):
    """launch/serve.main at ``--mesh 1x2`` over both ranks, per source
    (the checkpoint written by rank 0 under ``out_dir``)."""
    from repro_torch.launch.serve import main

    for name, extra in SERVE_MESH_SOURCES.items():
        if name == "checkpoint":
            extra = extra + ["--checkpoint", f"{out_dir}/ckpt"]
        out = main(SERVE_MESH_ARGV + extra, device="cpu")
        read = out["read"] or {}
        _save(out_dir, f"serve_{name}_r{rank}", generated=out["generated"],
              version=np.asarray(read.get("version", -1)))


# -- rank bodies: the recsys cells -----------------------------------------


def recsys_ranks(rank, world, out_dir):
    """Every ``RS_ARCHS`` arch on the ``RS_MESH`` mesh from the JAX
    package's tp = 4 SMOKE weights: one step of its ``train_batch`` cell
    (pbox), its ``serve_p99`` cell on this worker's rows (and tp = 1 on
    this rank's block of them, whole tables), its ``retrieval_cand`` cell
    on this rank's slice of the candidates; for DLRM also the
    ``pbox_sparse`` step.  Each rank saves its pieces."""
    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.interop import params_from_numpy
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import _RS_FNS, build_cell
    from repro_torch.runtime.trainer import (
        init_train_state,
        local_params,
        local_state,
        shard_batch,
    )

    mesh = make_mesh(RS_MESH, ("data", "model"))
    tp = RS_MESH[1]
    g = mesh.coords["model"]
    for arch in RS_ARCHS:
        cfg = get_arch(arch).smoke_config
        specs_fn, score_f = _RS_FNS[arch][1], _RS_FNS[arch][4]
        specs = specs_fn(cfg, tp)
        wait_for(Path(out_dir, f"jax_rs_{arch}.npz"))
        jax_out = dict(np.load(Path(out_dir, f"jax_rs_{arch}.npz")))
        params_np = _unflat({k[2:]: v for k, v in jax_out.items()
                             if k.startswith("p/")})
        params = params_from_numpy(params_np, "cpu")
        out = {"model": np.asarray(g)}

        plan = build_cell(arch, "train_batch", mesh, smoke=True)
        ex = plan.meta["exchange"]
        state = init_train_state(
            mesh, init_params_fn=lambda tree: params_from_numpy(tree, "cpu"),
            param_specs=specs, exchange=ex, space=plan.meta["space"],
            n_groups=plan.meta["n_groups"], key=params_np, device="cpu")
        pflat, slots, ef, stc = local_state(state, mesh, ex)
        gb = plan.abstract_args[4]["sparse"].shape[0]
        batch = {k: torch.from_numpy(v) for k, v in
                 rs_batch(arch, cfg, gb, 0).items()}
        mine = shard_batch(batch, mesh, ex)
        p1, _, _, _, met = plan.fn(pflat.clone(), slots, ef, stc, mine)
        out.update(train_pflat=_np(p1), train_loss=_np(met["loss"]))

        local = local_params(params, specs, mesh)
        serve = build_cell(arch, "serve_p99", mesh, smoke=True)
        sb = {k: v for k, v in mine.items() if k != "labels"}
        out["serve"] = _np(serve.fn(local, sb))
        b_loc = sb["sparse"].shape[0] // tp
        block = {k: v[g * b_loc:(g + 1) * b_loc] for k, v in sb.items()}
        with torch.no_grad():
            out["serve_tp1"] = _np(score_f(params, block, cfg, None))

        retr = build_cell(arch, "retrieval_cand", mesh, smoke=True)
        n = retr.abstract_args[1]["cand_ids"].shape[0]
        rb = {k: torch.from_numpy(v) for k, v in
              rs_batch(arch, cfg, tp, 1).items() if k != "labels"}
        cand = torch.from_numpy(rs_candidates(cfg, n))
        per = n // world
        rb["cand_ids"] = cand[mesh.rank * per:(mesh.rank + 1) * per]
        out["retrieval"] = _np(retr.fn(local, rb))

        if arch == "dlrm-mlperf":
            sp = build_cell(arch, "train_batch", mesh, strategy="pbox_sparse",
                            smoke=True)
            dense = {k: v for k, v in local.items() if k != "tables"}
            pf0 = sp.meta["space"].flatten(dense).reshape(1, -1)
            tables = {k: v.clone() for k, v in local["tables"].items()}
            p2, _, _, _, tables1, met2 = sp.fn(
                pf0, (), None, torch.zeros((), dtype=torch.int32), tables,
                mine)
            out.update(sparse_pflat=_np(p2), sparse_loss=_np(met2["loss"]),
                       **{f"sparse_tables/{k}": _np(v)
                          for k, v in tables1.items()})
        _save(out_dir, f"rs_{arch}_r{rank}", **out)


# -- rank bodies: EquiformerV2 -----------------------------------------------

# the GNN SPMD file: 4 gloo ranks on a (2, 2) mesh, then two worlds of 2
# (ranks 0-1 and 2-3).  name: (cell, mesh, variant); every case at SMOKE
GNN_CASES = {
    "tp_1x2": ("full_graph_sm", (1, 2), None),  # channel TP, graph whole
    "tp_2x2": ("minibatch_lg", (2, 2), None),  # + each worker's subgraph
    "ep_2x2": ("full_graph_sm", (2, 2), "ep"),  # edges over the model axis
    "ep_2x2_mol": ("molecule", (2, 2), "ep"),  # edges over (data, model)
    "nodes_2x1": ("ogb_products", (2, 1), None),  # node-sharded, bf16
}
GNN_SHAPES = ("full_graph_sm", "minibatch_lg", "ogb_products", "molecule")
GNN_MOL_REBASE = {"edge_src": "node_feat", "edge_dst": "node_feat",
                  "graph_ids": "targets"}


def gnn_batch(shape: str, template: dict, l_max: int, n_rbf: int,
              workers: int) -> dict:
    """The case's global batch (numpy, both sides): ``cell_batch`` for the
    cell's regime, seed 4."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.graphs import cell_batch

    kind = get_arch("equiformer-v2").cell(shape).kind
    return cell_batch(kind, template, l_max, n_rbf, seed=4, workers=workers)


def gnn_rebased(batch: dict, workers: int) -> dict:
    """A molecule batch with each worker's block of ids shifted to start at
    0, as ``shard_batch(rebase=GNN_MOL_REBASE)`` hands them to the ranks
    (for the JAX side, which cuts the global arrays as they are)."""
    out = dict(batch)
    for k, ref in GNN_MOL_REBASE.items():
        v = batch[k].copy()
        per, rows = v.shape[0] // workers, batch[ref].shape[0] // workers
        for w in range(workers):
            v[w * per:(w + 1) * per] -= w * rows
        out[k] = v
    return out


def _gnn_case(name: str, mesh, out_dir, rank: int) -> None:
    """One ``GNN_CASES`` case on this rank: JAX's SMOKE weights cut to the
    rank's pieces, its rows of the global batch (``shard_batch`` by the
    plan's batch spec; molecule ids rebased), the loss of
    ``EQ.loss_fn`` and the gradients after ``grad_sync``."""
    import torch

    from repro_torch.interop import params_from_numpy
    from repro_torch.launch.steps import build_cell
    from repro_torch.models.gnn import equiformer_v2 as EQ
    from repro_torch.runtime.trainer import (
        _tree_map,
        apply_grad_sync,
        local_params,
        shard_batch,
    )

    shape, _, variant = GNN_CASES[name]
    plan = build_cell("equiformer-v2", shape, mesh, smoke=True,
                      variant=variant)
    cfg, tp = plan.meta["config"], mesh.shape["model"]
    wait_for(Path(out_dir, f"jax_gnn_{name}.npz"))
    jax_out = dict(np.load(Path(out_dir, f"jax_gnn_{name}.npz")))
    params = params_from_numpy(_unflat(
        {k[2:]: v for k, v in jax_out.items() if k.startswith("p/")}), "cpu")
    local = local_params(params, EQ.make_param_specs(cfg, tp), mesh)
    local = _tree_map(lambda t: t.clone().requires_grad_(True), local)
    batch = gnn_batch(shape, plan.abstract_args[4], cfg.l_max, cfg.n_rbf,
                      mesh.shape["data"])
    mine = {k: torch.from_numpy(v) for k, v in shard_batch(
        batch, mesh, None, plan.meta["batch_spec"],
        GNN_MOL_REBASE if shape == "molecule" else None).items()}
    dist = EQ.Dist("model", ("data",), tp, mesh)
    loss, _ = EQ.loss_fn(local, mine, cfg, dist, plan.meta["dist_nodes"])
    keys = sorted(flat_keys(local))
    leaves = [flat_keys(local)[k] for k in keys]
    grads = dict(zip(keys, torch.autograd.grad(loss, leaves)))
    synced = flat_keys(apply_grad_sync(_unflat(grads),
                                       EQ.grad_sync(cfg, tp), dist))
    _save(out_dir, f"gnn_{name}_r{rank}", loss=_np(loss),
          model=np.asarray(mesh.coords["model"]),
          data=np.asarray(mesh.coords["data"]),
          **{f"g/{k}": _np(v) for k, v in synced.items()})


def _gnn_ep_plans(mesh, out_dir, rank: int) -> None:
    """Every graph cell's ``variant="ep"`` plan at SMOKE and full size on
    this (1, 2) mesh: flat, groups, scalar meta and the batch's global
    shapes, dtypes and specs."""
    import json

    from repro_torch.launch.steps import build_cell

    out = {}
    for shape in GNN_SHAPES:
        for smoke in (True, False):
            plan = build_cell("equiformer-v2", shape, mesh, smoke=smoke,
                              variant="ep")
            out[f"{shape}/{int(smoke)}"] = {
                "flat": plan.meta["space"].flat_elems,
                "n_groups": plan.meta["n_groups"],
                **{k: plan.meta[k] for k in ("model_flops", "nodes",
                                             "edges")},
                "args": {k: [list(v.shape), str(v.dtype).split(".")[-1],
                             gnn_spec(plan.meta["batch_spec"][k])]
                         for k, v in plan.abstract_args[4].items()}}
    Path(out_dir, f"gnn_plans_r{rank}.json").write_text(json.dumps(out))


def gnn_spec(spec) -> list:
    """A batch spec (the port's tuples, or a JAX ``PartitionSpec``) as a
    JSON list: each entry an axis name, a list of two or more names, or
    None (a one-axis tuple is its axis, as JAX's shardings write it)."""
    return [(s[0] if len(s) == 1 else list(s)) if isinstance(s, tuple)
            else s for s in spec]


def gnn_ranks(rank, world, out_dir):
    """4 ranks: the (2, 2) cases; then ranks 0-1 and 2-3 each close the
    group and open a world of 2: ranks 0-1 the (1, 2) case and the ep
    plans, ranks 2-3 the (2, 1) node-sharded case."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_process_group, make_mesh

    mesh = make_mesh((2, 2), ("data", "model"))
    for name, (_, shape, _) in GNN_CASES.items():
        if shape == (2, 2):
            _gnn_case(name, mesh, out_dir, rank)
    dist.destroy_process_group()
    half = rank // 2
    init_process_group("cpu", init_method=f"file://{out_dir}/rendezvous_{half}",
                       rank=rank % 2, world_size=2)
    shape = (1, 2) if half == 0 else (2, 1)
    mesh = make_mesh(shape, ("data", "model"))
    for name, (_, s, _) in GNN_CASES.items():
        if s == shape:
            _gnn_case(name, mesh, out_dir, rank)
    if half == 0:
        _gnn_ep_plans(mesh, out_dir, rank)


# -- rank bodies: the example programs -------------------------------------

EX_TP = 4  # examples/train_distributed_ps.py's (2, 4) mesh
EX_SERVE_ARGV = ["--arch", "gemma3-1b", "--mesh", "1x2", "--batch", "4",
                 "--prompt-len", "16", "--tokens", "12"]  # serve_lm.py's


def _jax_tree(path, template: dict) -> dict:
    """A ``flat_keys`` npz of the JAX side's weights (f32, exact for bf16)
    as the port's tree, each leaf in ``template``'s dtype."""
    import torch

    arrays = dict(np.load(path))
    return _tree(_unflat({k: k for k in arrays}), lambda k: torch.from_numpy(
        arrays[k]).to(_leaf(template, k).dtype))


def _leaf(tree: dict, key: str):
    for part in key.split("/"):
        tree = tree[part]
    return tree


def examples_ranks(rank, world, out_dir):
    """8 ranks: ``repro_torch.examples.train_distributed_ps`` at its (2, 4)
    mesh from the JAX side's weights; then ranks 0-1 close the group and
    open a world of 2 for ``repro_torch.examples.serve_lm`` at its
    ``--mesh 1x2`` (ranks 2-7 a world of their own, idle)."""
    import torch.distributed as dist

    from repro_torch.configs.registry import get_arch
    from repro_torch.examples import serve_lm, train_distributed_ps
    from repro_torch.launch.mesh import init_process_group
    from repro_torch.models import transformer as T

    cfg = get_arch("internlm2-1.8b").smoke_config
    wait_for(Path(out_dir, "jax_ex_params.npz"))
    params = _jax_tree(Path(out_dir, "jax_ex_params.npz"),
                       T.abstract_params(cfg, EX_TP))
    out = train_distributed_ps.main(device="cpu", params=params,
                                    ckpt_dir=f"{out_dir}/ckpt")
    same = all(torch_equal(out["saved"][k], out["restored"][k])
               for k in out["saved"]) and out["saved"].keys() == \
        out["restored"].keys()
    _save(out_dir, f"ex_ps_r{rank}", losses=np.asarray(out["losses"]),
          restart_step=np.asarray(out["restart_step"]),
          loss_after_restart=np.asarray(out["loss_after_restart"]),
          step=np.asarray(out["step"]), restored_is_saved=np.asarray(same),
          **({f"saved_{k}": _np(v) for k, v in out["saved"].items()}
             if rank == 0 else {}))
    dist.destroy_process_group()
    serving = rank < 2
    init_process_group("cpu", init_method=f"file://{out_dir}/rendezvous_"
                       f"{'serve' if serving else 'idle'}",
                       rank=rank if serving else rank - 2,
                       world_size=2 if serving else world - 2)
    if not serving:
        return
    scfg = get_arch("gemma3-1b").smoke_config
    wait_for(Path(out_dir, "jax_ex_serve_params.npz"))
    sparams = _jax_tree(Path(out_dir, "jax_ex_serve_params.npz"),
                        T.abstract_params(scfg, 2))
    res = serve_lm.main(device="cpu", params=sparams)
    _save(out_dir, f"ex_serve_r{rank}", generated=res["generated"],
          version=np.asarray(res["read"]["version"]))


def torch_equal(a, b) -> bool:
    """Bitwise equality of two tensors: dtype, shape and every byte."""
    import torch

    def raw(t):
        return t.detach().cpu().contiguous().reshape(-1).view(torch.uint8)

    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        raw(a), raw(b))
