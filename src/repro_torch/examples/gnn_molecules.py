"""Train the eSCN EquiformerV2 on batched synthetic molecules (graph-level
regression): the geometric featurization pipeline (spherical harmonics
and numeric Wigner rotations) end to end; torch counterpart of
``examples/gnn_molecules.py``.

  PYTHONPATH=src python -m repro_torch.examples.gnn_molecules

EquiformerV2 at its SMOKE config with ``task="graph_reg", n_out=1``,
AdamW(2e-3) over the parameter tree (``make_optimizer``), 15 steps over
4 seeded batches of 8 molecules (8 atoms, 16 edges each), the MSE printed
every 3 steps.  ``main(device="cpu")`` runs it on the CPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys

import torch

from repro_torch.configs.registry import get_arch
from repro_torch.core.chunking import ParamSpace
from repro_torch.data.graphs import random_molecule_batch
from repro_torch.data.pipeline import to_device
from repro_torch.device import resolve_device
from repro_torch.models.gnn.equiformer_v2 import init_params, loss_fn
from repro_torch.optim.optimizers import adamw, make_optimizer
from repro_torch.runtime.trainer import tracked_params

STEPS = 15


def main(argv=None, *, device=None, steps: int = STEPS,
         params=None) -> dict:
    """``steps`` AdamW steps (15, as the JAX example) from ``params`` (the
    init seeded 0 unless given); returns every step's MSE."""
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args(
        argv or [])
    dev = resolve_device(device)
    cfg = dataclasses.replace(get_arch("equiformer-v2").smoke_config,
                              task="graph_reg", n_out=1)
    if params is None:
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    init_fn, upd_fn = make_optimizer(adamw(2e-3))
    opt = init_fn(params)
    space = ParamSpace.build(params)

    def step(p, o, g):
        # the tree as views of one flat leaf: its gradient is every
        # tensor's gradient, each in its own slot
        leaf = space.flatten(p).requires_grad_(True)
        loss, _ = loss_fn(tracked_params(space, leaf), g, cfg)
        (gflat,) = torch.autograd.grad(loss, leaf)
        p, o = upd_fn(p, space.unflatten(gflat), o)
        return p, o, loss.detach()

    losses = []
    for i in range(steps):
        g = random_molecule_batch(8, 8, 16, cfg.d_in, cfg.l_max, cfg.n_rbf,
                                  seed=i % 4)
        params, opt, loss = step(params, opt, to_device(g, dev))
        losses.append(float(loss))
        if i % 3 == 0:
            print(f"step {i:2d} mse={losses[-1]:.4f}")
    print("done — molecular energies fitted on synthetic targets")
    return {"losses": losses, "params": params}


if __name__ == "__main__":
    main(sys.argv[1:])
