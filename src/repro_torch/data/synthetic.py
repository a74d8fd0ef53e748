"""Synthetic data generators (deterministic, seeded): a copy of the LM
stream of ``repro/data/synthetic.py``.  It is numpy, so both packages see
the same batches for the same seed."""
from __future__ import annotations

import numpy as np


def lm_batches(vocab: int, batch: int, seq: int, seed: int = 0):
    """Infinite stream of (tokens, labels) with a learnable structure
    (next-token = affine function of current, mod vocab) so smoke training
    shows loss decreasing."""
    rng = np.random.default_rng(seed)
    step = 0
    while True:
        first = rng.integers(0, vocab, (batch, 1))
        mult = 31
        toks = np.zeros((batch, seq + 1), np.int64)
        toks[:, :1] = first
        for i in range(1, seq + 1):
            toks[:, i] = (toks[:, i - 1] * mult + 7) % vocab
        noise = rng.random((batch, seq + 1)) < 0.05
        toks = np.where(noise, rng.integers(0, vocab, toks.shape), toks)
        yield {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }
        step += 1
