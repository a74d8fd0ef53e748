"""Synthetic data generators (deterministic, seeded): copies of the LM,
recsys and image streams of ``repro/data/synthetic.py``.  They are numpy, so both
packages see the same batches for the same seed."""
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


def recsys_batches(arch_id: str, cfg, batch: int, seed: int = 0):
    """Criteo-like stream with a planted logistic structure (numpy arrays:
    dense (B, n_dense) f32 for dlrm-mlperf, sparse (B, F) int32, labels
    (B,) int32)."""
    rng = np.random.default_rng(seed)
    while True:
        b: dict = {}
        if arch_id == "dlrm-mlperf":
            b["dense"] = rng.normal(size=(batch, cfg.n_dense)).astype(np.float32)
        if arch_id == "dien":
            b["hist_items"] = rng.integers(0, cfg.n_items, (batch, cfg.seq_len)).astype(np.int32)
            b["hist_cats"] = rng.integers(0, cfg.n_cats, (batch, cfg.seq_len)).astype(np.int32)
            sparse = np.stack(
                [rng.integers(0, cfg.n_items, batch), rng.integers(0, cfg.n_cats, batch)],
                axis=1,
            )
        else:
            sparse = np.stack(
                [rng.integers(0, v, batch) for v in cfg.vocabs], axis=1
            )
        b["sparse"] = sparse.astype(np.int32)
        # planted signal: label depends on parity of a few fields
        sig = (sparse[:, 0] % 2 + sparse[:, -1] % 3).astype(np.float32)
        if "dense" in b:
            sig = sig + b["dense"][:, 0]
        p = 1.0 / (1.0 + np.exp(-(sig - sig.mean())))
        b["labels"] = (rng.random(batch) < p).astype(np.int32)
        yield b


def image_batches(batch: int, img: int, n_classes: int, seed: int = 0):
    """Infinite stream of NHWC f32 images (B, img, img, 3) with a planted
    class-dependent mean, and int32 labels (B,)."""
    rng = np.random.default_rng(seed)
    while True:
        labels = rng.integers(0, n_classes, batch)
        imgs = rng.normal(size=(batch, img, img, 3)).astype(np.float32)
        # plant class-dependent mean so training can learn
        imgs += (labels / n_classes)[:, None, None, None].astype(np.float32)
        yield {"images": imgs, "labels": labels.astype(np.int32)}
