"""Distributed PS training, 2 workers x 4-way tensor parallelism: the
production path (the SPMD PS train step, the pbox exchange, the fused
aggregation kernel, a checkpoint, a crash and a restart); torch
counterpart of ``examples/train_distributed_ps.py``.

  PYTHONPATH=src python -m repro_torch.examples.train_distributed_ps

internlm2-1.8b at its SMOKE config through ``build_cell(..., "train_4k",
mesh, smoke=True)`` on a (2, 4) ("data", "model") mesh: 20 steps with the
global state saved every 5 (``Checkpointer.save_async``), then a
simulated crash: the latest checkpoint restored and 5 more steps.  The 8
ranks are started here under ``torchrun --nproc-per-node 8`` (one card a
rank), or, when ``main`` is called inside a process group of as many
ranks as the mesh holds (``torchrun``'s, or one its caller started, e.g.
gloo ranks with ``device="cpu"``), they are that group.
"""
from __future__ import annotations

import argparse
import math
import os
import sys
import tempfile

import torch

from repro_torch.examples import has_ranks, torchrun

MESH = (2, 4)
STEPS, CKPT_EVERY, AFTER = 20, 5, 5


def main(argv=None, *, device=None, mesh_shape: tuple = MESH, params=None,
         ckpt_dir: str | None = None) -> dict:
    """Train, crash and restart on a ``mesh_shape`` ("data", "model")
    mesh from ``params`` (the global tree at the mesh's tp; the init
    seeded 0 unless given), checkpointing under ``ckpt_dir``
    (``<tmp>/pbox_example_ckpt`` unless given).  Returns on every rank the
    losses printed, the global state saved at step 20 and the one
    restored from the checkpoint (host tensors), and the loss after the
    restart."""
    import torch.distributed as dist

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.checkpoint.checkpointer import (
        flat_to_train_state,
        train_state_to_flat,
    )
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.pipeline import to_device
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.launch.mesh import make_mesh, start_group
    from repro_torch.launch.steps import build_cell, make_exchange
    from repro_torch.models import transformer as T
    from repro_torch.runtime.trainer import (
        TrainState,
        global_state,
        init_train_state,
        local_state,
        shard_batch,
    )

    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args(
        argv or [])
    world = math.prod(mesh_shape)
    if not has_ranks():
        torchrun(__name__, world, list(argv or []), device)
        return {}
    dev, cleanup = start_group(world, device)
    try:
        mesh = make_mesh(mesh_shape, ("data", "model"))
        tp = mesh.shape["model"]
        cfg = get_arch("internlm2-1.8b").smoke_config
        plan = build_cell("internlm2-1.8b", "train_4k", mesh, smoke=True)
        exchange = make_exchange(mesh, "lm")
        space, ng = plan.meta["space"], plan.meta["n_groups"]
        state = init_train_state(
            mesh, init_params_fn=(lambda g: T.init_params(cfg, g, tp=tp))
            if params is None else (lambda g: params),
            param_specs=T.make_param_specs(cfg, tp), exchange=exchange,
            space=space, n_groups=ng,
            key=torch.Generator(device=dev).manual_seed(0),
            ps_dtype=plan.abstract_args[0].dtype, device=dev)

        gb, s = plan.abstract_args[4]["tokens"].shape
        data = lm_batches(cfg.vocab, gb, s, seed=0)

        def batch():
            return to_device(shard_batch(next(data), mesh, exchange,
                                         plan.meta.get("batch_spec")), dev)

        def say(*a):
            if mesh.rank == 0:
                print(*a, flush=True)

        ck = Checkpointer(ckpt_dir or os.path.join(tempfile.gettempdir(),
                                                   "pbox_example_ckpt"))
        pflat, slots, ef, stc = local_state(state, mesh, exchange)
        del state
        losses = []
        for i in range(STEPS):
            pflat, slots, ef, stc, met = plan.fn(pflat, slots, ef, stc,
                                                 batch())
            if (i + 1) % CKPT_EVERY == 0:
                losses.append(float(met["loss"]))
                say(f"step {i+1:3d} loss={losses[-1]:.4f}")
                st = global_state(mesh, exchange, pflat, slots, ef, stc)
                if mesh.rank == 0:
                    ck.save_async(i + 1, train_state_to_flat(st))
        saved = {k: v.cpu() for k, v in train_state_to_flat(st).items()}
        del st
        ck.wait()
        dist.barrier()  # the checkpoint is on disk for every rank

        # simulate a crash + restart from the latest checkpoint
        host, _ = ck.restore()
        st = flat_to_train_state(host, TrainState, device=dev)
        restored = {k: v.cpu() for k, v in train_state_to_flat(st).items()}
        say(f"restarted from step {int(host['step'])}; continuing "
            f"{AFTER} steps")
        p2, sl2, ef2, sc2 = local_state(st, mesh, exchange)
        del st
        for i in range(AFTER):
            p2, sl2, ef2, sc2, met = plan.fn(p2, sl2, ef2, sc2, batch())
        loss = float(met["loss"])
        say(f"after restart loss={loss:.4f} — done")
        return {"losses": losses, "restart_step": int(host["step"]),
                "loss_after_restart": loss, "saved": saved,
                "restored": restored, "step": int(sc2)}
    finally:
        if cleanup is not None:
            cleanup()


if __name__ == "__main__":
    main(sys.argv[1:])
