"""Serving driver: batched LM generation against the fabric's read plane
(torch counterpart of ``repro/launch/serve.py``).

The model is served the way the PS serves it: the parameters live in a
``PBoxFabric`` (optionally chain-replicated and rack-aware, under live
synthetic training) or in a checkpoint, and generation pulls a
version-stamped, staleness-bounded read (``core/serving.ReadPlane``) whose
bits are checked identical to the source's flat space at the stamped round.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b \\
      --tokens 16 --batch 4 --source fabric --train-rounds 2

Sources:
  fabric      build a PBoxFabric over the model, run ``--train-rounds``
              rounds of seeded synthetic-gradient training, then serve
              reads from the chain replica tails (``--serve-replication``
              >= 2) or the primary slabs.
  checkpoint  the same fabric, saved through ``checkpoint.Checkpointer``
              and served back through a ``SnapshotSource``.  With
              ``--train-rounds 0`` and an existing ``--checkpoint`` dir,
              serves it as-is.
  model       the freestanding path (no read plane): generation straight
              off the init params.

The body is ``serve(cfg, args)``, which takes the model config: ``main``
calls it with the arch's SMOKE config, as the JAX driver does, and
``chip_smoke.py`` calls it with the full config.  It runs on the card
unless it is given ``device="cpu"``.  ``--mesh DATAxMODEL`` with more than
one rank serves over the world's ranks (``torchrun``'s, or a group its
caller started), as the JAX driver's ``shard_map`` does: rank 0 assembles
the global tree through the read plane and sends the read to every rank,
each rank takes its local pieces (``trainer.local_params``), generates for
its rows of the batch with the model sharded over the model axis, and the
ids are gathered over the data axis.  ``main(argv)`` returns a result
dict (generated ids, read provenance, timings); ``serve`` adds the live
objects (``fabric``, ``plane``, ``params``) for callers that
keep serving from them.
"""
from __future__ import annotations

import argparse
import time


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--mesh", default="1x1")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    # read-plane source (core/serving.py)
    ap.add_argument("--source", default="fabric",
                    choices=("fabric", "checkpoint", "model"),
                    help="where generation's parameters come from: a live "
                         "PBox fabric's read plane, a checkpointed read "
                         "plane, or the legacy freestanding model")
    ap.add_argument("--serve-shards", type=int, default=2)
    ap.add_argument("--serve-racks", type=int, default=1)
    ap.add_argument("--serve-replication", type=int, default=2,
                    help=">= 2 serves reads from chain replica tails")
    ap.add_argument("--serve-workers", type=int, default=2,
                    help="synthetic training workers pushing to the fabric")
    ap.add_argument("--train-rounds", type=int, default=2,
                    help="synthetic-gradient rounds to run before serving "
                         "(the 'live training' the reads happen under)")
    ap.add_argument("--max-staleness", type=int, default=0)
    ap.add_argument("--frontends", type=int, default=1)
    ap.add_argument("--checkpoint", default=None, metavar="DIR",
                    help="checkpoint directory (source=checkpoint)")
    return ap


def _build_fabric(args, space, flat, device):
    """The serving-side fabric: the model's flat space on a small sharded,
    optionally replicated and rack-aware box under synthetic training."""
    from repro_torch.core.config import FabricConfig, FaultConfig, WireConfig
    from repro_torch.core.fabric import PBoxFabric
    from repro_torch.core.topology import NetworkTopology
    from repro_torch.optim.optimizers import sgd

    workers = max(1, args.serve_workers)
    topology = None
    if args.serve_racks > 1 and workers > 1:
        topology = NetworkTopology(num_workers=workers,
                                   num_racks=min(args.serve_racks, workers))
    config = FabricConfig(
        num_shards=max(1, args.serve_shards),
        num_workers=workers,
        wire=WireConfig(topology=topology),
        faults=FaultConfig(replication=max(1, args.serve_replication)),
    )
    return PBoxFabric(space, sgd(1e-3), flat, config=config, device=device)


def _train_rounds(args, fabric, space) -> None:
    """Seeded synthetic-gradient rounds: the live training the serve reads
    contend with.  Each gradient is drawn in float64 by numpy and rounded
    to f32, as the JAX driver draws it, so the two drivers serve the same
    bits."""
    import numpy as np

    rng = np.random.default_rng(args.seed + 1)
    for _ in range(args.train_rounds):
        grads = [_draw_grad(rng, space.flat_elems, fabric.device)
                 for _ in range(fabric.num_workers)]
        for w in range(fabric.num_workers):
            fabric.pull(w)
        for w in range(fabric.num_workers):
            fabric.push(w, grads[w])
        del grads


_DRAW_CHUNK = 1 << 22  # float64 normals a block: 32 MiB, cache-sized


def _draw_grad(rng, n: int, device):
    """``(1e-3 * rng.standard_normal(n)).astype(np.float32)`` on ``device``,
    drawn block by block into one reused float64 buffer: the generator
    yields the same stream whatever the block size, and the scale and the
    rounding are elementwise, so the bits equal the one-shot draw's
    without its two full-length float64 temporaries."""
    import numpy as np
    import torch

    out = np.empty(n, np.float32)
    buf = np.empty(min(n, _DRAW_CHUNK))
    for lo in range(0, n, _DRAW_CHUNK):
        b = buf[:min(n, lo + _DRAW_CHUNK) - lo]
        rng.standard_normal(out=b)
        b *= 1e-3
        out[lo:lo + b.shape[0]] = b
    return torch.from_numpy(out).to(device)


def _serve_params(args, params, space, device):
    """Route the model's parameters through a read plane per ``--source``.

    Returns (served param tree, provenance dict, fabric, plane).  The
    headline check runs here: the read's bits must be identical to the
    source's flat space at the stamped version."""
    import torch

    from repro_torch.core.config import ServeConfig
    from repro_torch.core.serving import ReadPlane, SnapshotSource

    flat = space.flatten(params)
    fabric = _build_fabric(args, space, flat, device)
    del flat
    _train_rounds(args, fabric, space)

    if args.source == "checkpoint":
        from repro_torch.checkpoint.checkpointer import (
            Checkpointer,
            flat_to_fabric_snapshot,
        )

        if args.checkpoint is None:
            raise SystemExit("--source checkpoint needs --checkpoint DIR")
        ckpt = Checkpointer(args.checkpoint)
        restore_step = None  # latest, when serving an existing dir as-is
        if ckpt.latest_step() is None or args.train_rounds > 0:
            ckpt.save_fabric(fabric.step, fabric)
            # pin the restore to the step just saved: the dir may hold a
            # later checkpoint from a longer previous run
            restore_step = fabric.step
        state, _meta = ckpt.restore(restore_step)
        snap = flat_to_fabric_snapshot(state)
        source = SnapshotSource.from_snapshot(
            snap, chunk_elems=space.chunk_elems, device=device)
        del state, snap
        plane = ReadPlane(source, config=ServeConfig(
            max_staleness=args.max_staleness,
            num_frontends=args.frontends))
        expect = source.assemble()
    else:
        plane = ReadPlane(fabric, config=ServeConfig(
            max_staleness=args.max_staleness,
            num_frontends=args.frontends))
        expect = fabric.params

    read = plane.read(0)
    if not torch.equal(read.flat.view(torch.int32), expect.view(torch.int32)):
        raise AssertionError(
            f"read at version {read.version} is not bit-identical to the "
            "source's flat parameter space — the read plane's headline "
            "invariant broke"
        )
    info = {
        "version": read.version,
        "staleness": read.staleness,
        "cache_hit": read.cache_hit,
        "plane": plane.describe(),
        "replication": fabric.replication,
        "shards": fabric.num_shards,
    }
    return space.unflatten(read.flat), info, fabric, plane


def _broadcast_read(space, params, read_info):
    """Rank 0's served tree and provenance on every rank: the read's flat
    (f32, as the fabric holds it) sent over the world group; the other
    ranks' ``params`` only give the buffer."""
    import torch.distributed as tdist

    flat = space.flatten(params)
    tdist.broadcast(flat, src=0)
    info = [read_info]
    tdist.broadcast_object_list(info, src=0)
    return space.unflatten(flat), info[0]


def serve(cfg, args, *, device=None, params=None) -> dict:
    """Generate per ``args`` with the model config ``cfg``: init params
    (seeded ``args.seed``, unless ``params`` is given), the read plane per
    ``--source``, then a prefill of ``--batch`` x ``--prompt-len`` seeded
    prompt tokens and ``--tokens`` greedy tokens in all.  Returns ``main``'s
    dict plus ``fabric``, ``plane`` and the served ``params``."""
    import numpy as np
    import torch

    from repro_torch.core.chunking import ParamSpace
    from repro_torch.device import resolve_device
    from repro_torch.models import transformer as T
    from repro_torch.models.common import Dist

    d, m = (int(x) for x in args.mesh.split("x"))
    if args.batch % d:
        raise ValueError(f"--batch {args.batch} does not split over the "
                         f"{d} data ranks of --mesh {args.mesh}")
    device = resolve_device(device)
    mesh, dist = None, Dist.none()
    if d * m > 1:
        from repro_torch.launch.mesh import make_mesh

        mesh = make_mesh((d, m), ("data", "model"))
        dist = Dist(model_axis="model", data_axes=("data",), tp=m, mesh=mesh)
    if params is None:
        gen = torch.Generator(device=device).manual_seed(args.seed)
        params = T.init_params(cfg, gen, tp=m)
    max_seq = args.prompt_len + args.tokens
    max_seq = -(-max_seq // m) * m

    read_info: dict | None = None
    fabric = plane = None
    if args.source != "model":
        space = ParamSpace.build(params)
        if mesh is None or mesh.rank == 0:
            params, read_info, fabric, plane = _serve_params(
                args, params, space, device)
        if mesh is not None:
            params, read_info = _broadcast_read(space, params, read_info)
        print(f"read plane [{args.source}]: version {read_info['version']}, "
              f"staleness {read_info['staleness']}, "
              f"{read_info['shards']} shards, "
              f"R={read_info['replication']} — bits verified against the "
              "source")
        print(read_info["plane"])

    rng = np.random.default_rng(args.seed)
    prompts = torch.from_numpy(
        rng.integers(0, cfg.vocab, (args.batch, args.prompt_len))
        .astype(np.int32)).to(device)
    if mesh is not None:
        from repro_torch.runtime.trainer import local_params

        params = local_params(params, T.make_param_specs(cfg, m), mesh)
        rows = args.batch // d
        w = mesh.coords["data"]
        prompts = prompts[w * rows:(w + 1) * rows]
    with torch.no_grad():
        if device.type == "cuda":  # the prefill's clock starts idle
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        nxt, cache = T.prefill(params, prompts, cfg, max_seq, dist=dist)
        out = [nxt]
        t_prefill = time.perf_counter() - t0
        t0 = time.perf_counter()
        for i in range(args.tokens - 1):
            nxt, cache = T.decode_step(params, nxt, cache,
                                       args.prompt_len + i, cfg, dist)
            out.append(nxt)
        ids = torch.stack(out, dim=1)
        if mesh is not None:
            ids = mesh.all_gather(ids, "data")
        gen_ids = ids.cpu().numpy()
        t_dec = time.perf_counter() - t0
    print(f"prefill {args.batch}x{args.prompt_len} in {t_prefill*1e3:.1f} ms; "
          f"{args.tokens-1} decode steps in {t_dec*1e3:.1f} ms "
          f"({t_dec/max(1, args.tokens-1)*1e3:.2f} ms/tok)")
    print("generated ids:\n", gen_ids)
    return {
        "generated": gen_ids,
        "source": args.source,
        "read": read_info,
        "prefill_ms": t_prefill * 1e3,
        "decode_ms": t_dec * 1e3,
        "fabric": fabric,
        "plane": plane,
        "params": params,
    }


def main(argv=None, *, device=None, params=None) -> dict:
    """The CLI: ``serve`` at the arch's SMOKE config (the JAX driver's
    ``main`` serves ``arch.smoke_config`` too), on the card unless
    ``device`` says otherwise, from ``params`` when given (else the init
    seeded ``--seed``)."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.mesh import start_group

    args = build_argparser().parse_args(argv)
    arch = get_arch(args.arch)
    if arch.family != "lm":
        raise SystemExit("serve.py drives LM archs; recsys serving is "
                         "exercised via launch/steps.py serve cells")
    d, m = (int(x) for x in args.mesh.split("x"))
    cleanup = None
    if d * m > 1:  # torchrun's world, or the caller's group
        device, cleanup = start_group(d * m, device)
    try:
        out = serve(arch.smoke_config, args, device=device, params=params)
    finally:
        if cleanup is not None:
            cleanup()
    return {k: out[k] for k in ("generated", "source", "read", "prefill_ms",
                                "decode_ms")}


if __name__ == "__main__":
    main()
