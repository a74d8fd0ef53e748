"""Quickstart: train a tiny LM through the chunk-sharded PBox fabric and
watch the loss fall (torch counterpart of ``examples/quickstart.py``).

  PYTHONPATH=src python -m repro_torch.examples.quickstart

gemma3-1b at its SMOKE config, a 4-shard ``PBoxFabric`` fed by 2 workers,
AdamW(3e-3), 40 rounds.  On the card every shard's update is one
``fused_agg_opt`` launch over both workers' pushes (K = 2).
``main(device="cpu")`` runs it on the CPU.
"""
from __future__ import annotations

import argparse
import sys

import torch

from repro_torch.configs.registry import get_arch
from repro_torch.core.chunking import ParamSpace
from repro_torch.core.compression import CompressionConfig
from repro_torch.core.config import FabricConfig, WireConfig
from repro_torch.core.fabric import PBoxFabric, WorkerHarness
from repro_torch.data.synthetic import lm_batches
from repro_torch.device import resolve_device
from repro_torch.models.transformer import init_params, lm_loss_and_grad
from repro_torch.optim.optimizers import adamw

SHARDS, WORKERS, ROUNDS = 4, 2, 40


def build(*, device=None, spec=None, codec: str = "none",
          params=None) -> dict:
    """The example's fabric and its workers: gemma3-1b SMOKE (``params``,
    or the init seeded 0), a ``SHARDS``-shard fabric over the ``codec``
    wire with the server optimizer ``spec`` (AdamW(3e-3) unless given),
    and a ``WorkerHarness`` whose ``WORKERS`` workers each read their own
    ``lm_batches`` stream (seeded by the worker) and append their losses
    to ``losses``."""
    dev = resolve_device(device)
    cfg = get_arch("gemma3-1b").smoke_config
    if params is None:
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             tp=1)
    space = ParamSpace.build(params)
    srv = PBoxFabric(space, spec or adamw(3e-3), space.flatten(params),
                     config=FabricConfig(
                         num_shards=SHARDS, num_workers=WORKERS,
                         wire=WireConfig(compression=CompressionConfig(
                             codec=codec))),
                     device=dev)
    streams = [lm_batches(cfg.vocab, 4, 32, seed=w) for w in range(WORKERS)]
    losses: list[float] = []

    def grad_fn(p, wstep):
        b = next(streams[wstep[0]])
        loss, g = lm_loss_and_grad(p, torch.from_numpy(b["tokens"]).to(dev),
                                   torch.from_numpy(b["labels"]).to(dev), cfg)
        losses.append(loss.item())
        return g

    harness = WorkerHarness(srv, grad_fn, lambda w, s: (w, s))
    return {"space": space, "fabric": srv, "harness": harness,
            "losses": losses}


def main(argv=None, *, device=None, rounds: int = ROUNDS,
         params=None) -> dict:
    """Run ``rounds`` rounds (40, as the JAX example) and print the loss,
    the push totals, the fabric and its simulated pipeline speedup.
    ``argv`` (none: the program takes no arguments) is parsed for
    ``--help``."""
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args(
        argv or [])
    run = build(device=device, params=params)
    space, srv, losses = run["space"], run["fabric"], run["losses"]
    print(space.describe())
    run["harness"].run(rounds)
    print("loss first->last:", round(losses[0], 3), "->", round(losses[-1], 3))
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")
    print("pushes:", srv.stats.pushes, " bytes pushed:",
          srv.stats.bytes_pushed >> 20, "MiB")
    print(srv.describe())
    print(f"simulated pipeline speedup vs monolithic store-and-forward: "
          f"{srv.stats.pipeline_speedup:.2f}x")
    return {"losses": losses, "pushes": srv.stats.pushes,
            "bytes_pushed": srv.stats.bytes_pushed,
            "space": space.describe(), "fabric": srv.describe(),
            "pipeline_speedup": srv.stats.pipeline_speedup,
            "params": srv.params}


if __name__ == "__main__":
    main(sys.argv[1:])
