"""RecSys serving: CTR scoring and bulk candidate retrieval against
PS-sharded embedding tables (the paper's canonical workload); torch
counterpart of ``examples/recsys_serving.py``.

  PYTHONPATH=src python -m repro_torch.examples.recsys_serving

dlrm-mlperf at its SMOKE config: ``dlrm_score`` on a batch of 64 requests,
then one user against 4096 candidate items of table t0 (drawn by
``np.random.default_rng(0)``) through ``bulk_retrieval`` and the top 5 by
``np.argsort``.  ``main(device="cpu")`` runs it on the CPU.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from repro_torch.configs.registry import get_arch
from repro_torch.data.pipeline import to_device
from repro_torch.data.synthetic import recsys_batches
from repro_torch.device import resolve_device
from repro_torch.models.recsys import models as RS

BATCH, CANDIDATES, TOP = 64, 4096, 5


def main(argv=None, *, device=None, params=None) -> dict:
    """Score a batch and retrieve one user's top items from ``params``
    (the init seeded 0 unless given); returns the logits, the candidate
    ids, their scores and the top ids and scores."""
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args(
        argv or [])
    dev = resolve_device(device)
    cfg = get_arch("dlrm-mlperf").smoke_config
    if params is None:
        params = RS.dlrm_init(cfg, torch.Generator(device=dev).manual_seed(0))
    b = to_device(next(recsys_batches("dlrm-mlperf", cfg, batch=BATCH,
                                      seed=0)), dev)
    with torch.no_grad():
        s = RS.dlrm_score(params, b, cfg).cpu().numpy()
        print(f"scored {s.shape[0]} requests; logits[:4] = {s[:4].round(3)}")

        # bulk retrieval: 1 user vs 4096 candidates
        cand = np.random.default_rng(0).integers(
            0, cfg.vocabs[0], CANDIDATES).astype(np.int32)
        b["cand_ids"] = torch.from_numpy(cand).to(dev)
        scores = RS.bulk_retrieval(params, b, RS.dlrm_user_tower, "t0",
                                   cfg.embed_dim, cfg).cpu().numpy()
    top = np.argsort(scores)[-TOP:][::-1]
    print(f"retrieved top-{TOP} of {scores.shape[0]} candidates: ids "
          f"{cand[top]} scores {scores[top].round(3)}")
    return {"logits": s, "cand_ids": cand, "scores": scores,
            "top_ids": cand[top], "top_scores": scores[top]}


if __name__ == "__main__":
    main(sys.argv[1:])
