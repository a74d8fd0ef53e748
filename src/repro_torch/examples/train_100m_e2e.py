"""End-to-end program: train a ~100M-parameter LM for a few hundred steps
through the PBox pipeline (the chunked PS exchange's fused update, the
prefetch pipeline, async checkpointing); torch counterpart of
``examples/train_100m_e2e.py``.

  PYTHONPATH=src python -m repro_torch.examples.train_100m_e2e --steps 200

The model is the JAX example's ``CFG`` (12 layers, d 512, ff 2048, 8
heads, vocab 32768, f32, no remat).  One worker: each step's flat
gradient goes straight into ``fused_aggregate_update`` (K = 1, no
averaging, AdamW(3e-4, wd 0.01) under a 20-step warmup and cosine decay),
which on the card is the ``fused_agg_opt`` kernel updating the flat
parameters and both AdamW slots in place.  ``main(device="cpu")`` runs it
on the CPU.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.checkpoint.checkpointer import train_state_to_flat
from repro_torch.core.chunking import ParamSpace
from repro_torch.core.exchange import ExchangeConfig, PSExchange
from repro_torch.data.pipeline import Prefetcher
from repro_torch.data.synthetic import lm_batches
from repro_torch.device import resolve_device
from repro_torch.kernels.fused_agg_opt.ops import fused_aggregate_update
from repro_torch.models.common import count_params
from repro_torch.models.transformer import (
    TransformerConfig,
    init_params,
    lm_loss,
)
from repro_torch.optim.optimizers import adamw
from repro_torch.optim.schedules import warmup_cosine_schedule
from repro_torch.runtime.trainer import TrainState, tracked_params

# ~102M params: 12L, d=512, ff=2048, 8H, vocab 32768 (tied dims untied)
CFG = TransformerConfig(
    name="lm-100m", n_layers=12, d_model=512, n_heads=8, n_kv_heads=8,
    head_dim=64, d_ff=2048, vocab=32768, dtype=torch.float32,
    param_dtype=torch.float32, attn_chunk=128, remat=False,
)


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "pbox_100m_ckpt"))
    return ap


def main(argv=None, *, device=None, cfg: TransformerConfig = CFG,
         params=None, ckpt_every: int = 100) -> dict:
    """Train ``--steps`` steps, printing the loss every 20 and saving the
    state every ``ckpt_every`` (100, as the JAX example).  ``cfg`` and
    ``params`` (the init seeded 0 unless given) let a test run a narrower
    model from the JAX package's weights.  Returns the losses, the final
    flat parameters, slots and step, and the seconds a step."""
    args = build_argparser().parse_args(argv or [])
    dev = resolve_device(device)
    if params is None:
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             tp=1)
    n = count_params(params)
    print(f"model: {n/1e6:.1f}M params")
    space = ParamSpace.build(params)
    print(space.describe())

    # single-worker PS exchange (the allreduce path degenerates to a fused
    # optimizer step over the chunk space: the server-side data path)
    ex = PSExchange(adamw(3e-4, weight_decay=0.01),
                    ExchangeConfig("allreduce"), worker_axes=())
    sched = warmup_cosine_schedule(20, args.steps)
    pflat = space.flatten(params)
    del params
    state = ex.init_slab_state(space, device=dev)

    def lossg(pf, tokens, labels):
        leaf = pf.detach().requires_grad_(True)
        loss, _ = lm_loss(tracked_params(space, leaf), tokens, labels, cfg)
        (g,) = torch.autograd.grad(loss, leaf)
        return loss.detach(), g

    def update(pflat, slots, step, gflat):
        # the schedule's value stays an f32 scalar on the device
        newp, newslots = fused_aggregate_update(
            gflat[None], pflat, slots, ex.spec, step + 1, sched(step + 1),
            average=False)
        return newp, newslots, step + 1

    data = Prefetcher(lm_batches(cfg.vocab, args.batch, args.seq, seed=0),
                      depth=2, device=dev)
    ck = Checkpointer(args.ckpt_dir, keep=2)
    slots, step = state["slots"], state["step"]
    try:
        t0 = time.time()
        losses = []
        for i in range(args.steps):
            b = next(data)
            loss, gflat = lossg(pflat, b["tokens"], b["labels"])
            pflat, slots, step = update(pflat, slots, step, gflat)
            del gflat
            losses.append(float(loss))
            if (i + 1) % 20 == 0:
                dt = (time.time() - t0) / (i + 1)
                print(f"step {i+1:4d} loss={losses[-1]:.4f} "
                      f"(avg20={sum(losses[-20:])/20:.4f}, {dt:.2f}s/step)",
                      flush=True)
            if (i + 1) % ckpt_every == 0:
                # save_async copies every tensor to the host before it
                # returns, so the in-place updates after it do not reach
                # the file
                ck.save_async(i + 1, train_state_to_flat(TrainState(
                    pflat=pflat[None], slots=tuple(s[None] for s in slots),
                    ef=None, step=step)))
        ck.wait()
    finally:
        data.close()
    sec = (time.time() - t0) / args.steps
    print(f"final loss {losses[-1]:.4f} (start {losses[0]:.4f}); "
          f"{sec:.2f}s/step")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses[0]} -> "
                             f"{losses[-1]}")
    return {"losses": losses, "params": n, "flat": space.flat_elems,
            "pflat": pflat, "slots": slots, "step": int(step),
            "s_per_step": sec}


if __name__ == "__main__":
    main(sys.argv[1:])
