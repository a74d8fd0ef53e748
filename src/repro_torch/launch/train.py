"""End-to-end training driver (torch counterpart of ``repro/launch/train.py``).

Runs real PS train steps (synthetic data) over ``torch.distributed``: one
process per rank, NCCL on the card, gloo on the CPU.  Demonstrates the
full runtime: the PS exchange, the prefetching pipeline, async
checkpointing and crash-restart (``--resume``).

  # one card, a world of one rank (the driver starts its own group)
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b \\
      --steps 50 --mesh 1x1 --ckpt-dir /tmp/ckpt --ckpt-every 20
  # one rank per card under torchrun (RANK / WORLD_SIZE / LOCAL_RANK)
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --mesh 4x1

``--mesh DATAxMODEL`` must hold exactly the world's ranks; a model axis
above one shards the model over its ranks (tensor parallelism for the LM
archs, row-sharded embedding tables for the recsys archs; each model
group with its own flat space).  The recsys archs (``--arch dlrm-mlperf``,
``autoint``, ``dien``, ``xdeepfm``) train their ``train_batch`` cell on
``recsys_batches``:

  PYTHONPATH=src python -m repro_torch.launch.train --arch dlrm-mlperf \\
      --steps 20 --mesh 1x1

ResNet-50 (``--arch resnet50``, the paper's ImageNet workload) trains its
``imagenet_train`` cell on ``image_batches`` with momentum SGD, pure data
parallelism over every mesh axis:

  PYTHONPATH=src python -m repro_torch.launch.train --arch resnet50 \\
      --steps 20 --mesh 1x1

EquiformerV2 (``--arch equiformer-v2``) trains its ``molecule`` cell (graph
regression over batched molecules, AdamW) on ``random_molecule_batch``,
with as many atoms a graph and input features as the plan has (8 and 12 at
SMOKE, 30 and 16 at ``--full``); the other graph cells have no stream here
and raise.  Over several workers each worker's node, edge and graph ids
are rebased to its own block of the batch (a molecule's edges never leave
its graph):

  PYTHONPATH=src python -m repro_torch.launch.train --arch equiformer-v2 \\
      --steps 20 --mesh 1x1

``main(argv, device=...)`` is the body: it runs on the card unless ``device`` says
otherwise, joins a process group its caller already started, and returns
the losses, the final step and this rank's final state.  ``--resume``
skips the batches the restored steps consumed, so a restarted run goes on
with the same stream as an uninterrupted one (the JAX driver restarts the
stream from its first batch).
"""
from __future__ import annotations

import argparse
import time


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--shape", default=None, help="defaults to the train cell")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--mesh", default="1x1", help="DATAxMODEL, e.g. 2x4")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--strategy", default="pbox",
                    choices=["allreduce", "pbox", "pbox_hier"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    return ap


def main(argv=None, *, device=None) -> dict:
    import torch
    import torch.distributed as dist

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.checkpoint.checkpointer import (
        flat_to_train_state,
        train_state_to_flat,
    )
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.pipeline import Prefetcher, to_device
    from repro_torch.data.synthetic import (
        image_batches,
        lm_batches,
        recsys_batches,
    )
    from repro_torch.launch.mesh import make_mesh, start_group
    from repro_torch.launch.steps import _RS_FNS, build_cell
    from repro_torch.models import resnet as RN
    from repro_torch.models import transformer as T
    from repro_torch.models.gnn import equiformer_v2 as EQ
    from repro_torch.runtime.trainer import (
        TrainState,
        global_state,
        init_train_state,
        local_state,
        shard_batch,
    )

    args = build_argparser().parse_args(argv)
    d, m = (int(x) for x in args.mesh.split("x"))
    dev, cleanup = start_group(d * m, device)
    try:
        if dist.get_world_size() != d * m:
            raise ValueError(f"--mesh {args.mesh} needs {d * m} ranks, the "
                             f"world has {dist.get_world_size()}")
        mesh = make_mesh((d, m), ("data", "model"))
        arch = get_arch(args.arch)
        shape = args.shape or {
            "lm": "train_4k", "recsys": "train_batch", "gnn": "molecule",
            "vision": "imagenet_train",
        }[arch.family]
        plan = build_cell(args.arch, shape, mesh, strategy=args.strategy,
                          smoke=args.smoke)
        cfg = arch.smoke_config if args.smoke else arch.config
        space, exchange = plan.meta["space"], plan.meta["exchange"]

        # ---- data: every rank draws the global batch, keeps its rows ----
        bt = plan.abstract_args[4]
        rebase = None
        if arch.family == "lm":
            gb, s = bt["tokens"].shape
            it = lm_batches(cfg.vocab, gb, s, args.seed)
            init_fn = lambda g: T.init_params(cfg, g, tp=m)  # noqa: E731
            specs = T.make_param_specs(cfg, m)
        elif arch.family == "vision":
            it = image_batches(bt["images"].shape[0], bt["images"].shape[1],
                               cfg.n_classes, args.seed)
            init_fn = lambda g: RN.init_params(cfg, g)  # noqa: E731
            specs = None  # replicated: whole tensors on every rank
        elif arch.family == "gnn":
            it = _molecule_stream(plan, arch.arch_id, args.seed)
            gcfg = plan.meta["config"]
            init_fn = lambda g: EQ.init_params(gcfg, g, m)  # noqa: E731
            specs = EQ.make_param_specs(gcfg, m)
            # each worker's ids index its own block of nodes and graphs
            rebase = {"edge_src": "node_feat", "edge_dst": "node_feat",
                      "graph_ids": "targets"}
        else:  # recsys
            it = recsys_batches(args.arch, cfg, bt["sparse"].shape[0],
                                args.seed)
            fi, fs = _RS_FNS[args.arch][:2]
            init_fn = lambda g: fi(cfg, g, m)  # noqa: E731
            specs = fs(cfg, m)
        data = Prefetcher(
            it, depth=2,
            transform=lambda b: to_device(shard_batch(
                b, mesh, exchange, plan.meta.get("batch_spec"), rebase), dev))

        # ---- state (fresh or restored) ----
        ckpt = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
        start = 0
        if args.resume and ckpt and ckpt.latest_step() is not None:
            host, _meta = ckpt.restore()
            state = flat_to_train_state(host, TrainState, device=dev)
            start = int(host["step"])
            print(f"resumed from step {start}")
            # replay the stream to the restored step
            for _ in range(start):
                next(data)
        else:
            gen = torch.Generator(device=dev).manual_seed(args.seed)
            state = init_train_state(
                mesh, init_params_fn=init_fn, param_specs=specs,
                exchange=exchange,
                space=space, n_groups=plan.meta["n_groups"], key=gen,
                ps_dtype=plan.abstract_args[0].dtype, device=dev)

        pflat, slots, ef, stc = local_state(state, mesh, exchange)
        del state
        losses = []
        t0 = time.time()
        for i in range(start, args.steps):
            batch = next(data)
            pflat, slots, ef, stc, met = plan.fn(pflat, slots, ef, stc, batch)
            losses.append(float(met["loss"]))
            if (i + 1) % args.log_every == 0 or i == start:
                dt = (time.time() - t0) / (i - start + 1)
                print(f"step {i+1:5d} loss={losses[-1]:.4f} "
                      + " ".join(f"{k}={float(v):.4f}" for k, v in met.items()
                                 if k != "loss")
                      + f" ({dt*1e3:.0f} ms/step)", flush=True)
            if ckpt and args.ckpt_every and (i + 1) % args.ckpt_every == 0:
                st = global_state(mesh, exchange, pflat, slots, ef, stc)
                if mesh.rank == 0:
                    ckpt.save_async(i + 1, train_state_to_flat(st))
                del st
        if ckpt:
            ckpt.wait()
            st = global_state(mesh, exchange, pflat, slots, ef, stc)
            if mesh.rank == 0:
                ckpt.save(args.steps, train_state_to_flat(st))
            del st
        data.close()
        print("done")
        return {"losses": losses, "start": start, "step": int(stc),
                "pflat": pflat, "slots": slots, "ef": ef}
    finally:
        if cleanup is not None:
            cleanup()


def _molecule_stream(plan, arch_id: str, seed: int):
    """The GNN driver's stream: ``random_molecule_batch`` at the plan's
    graphs, atoms and edges a graph and input width, seeded ``seed + i``
    for batch ``i``, as the JAX driver draws it."""
    from repro_torch.data.graphs import random_molecule_batch

    bt, cfg = plan.abstract_args[4], plan.meta["config"]
    if "targets" not in bt:
        raise ValueError(
            f"{arch_id}/{plan.shape}: the GNN driver trains the molecule "
            "cell only (its stream is batched molecules)")
    b = bt["targets"].shape[0]
    npg, epg = bt["node_feat"].shape[0] // b, bt["edge_src"].shape[0] // b

    def gen():
        i = 0
        while True:
            yield random_molecule_batch(b, npg, epg, cfg.d_in, cfg.l_max,
                                        cfg.n_rbf, seed=seed + i)
            i += 1

    return gen()


if __name__ == "__main__":
    main()
