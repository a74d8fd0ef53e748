"""Embedding tables and the dense MLP stage of the recsys models (torch
counterpart of ``repro/models/recsys/embedding.py``).

The port runs the single-device (tp = 1) case: tables are whole, a lookup
is a plain gather, and the JAX package's model-axis specs, grad-sync maps
and ``split_batch_model`` wait for the port's SPMD path.  Row sharding
over PS engines is the sparse tier's job (``core/sparse.py``).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.common import dense_init, embed_init


def padded_vocab(v: int, tp: int) -> int:
    return -(-v // tp) * tp


def init_tables(generator: torch.Generator, vocabs, dim: int, tp: int = 1,
                dtype: torch.dtype = torch.float32) -> dict:
    """``t{i}``: a (padded_vocab(v, tp), dim) table per vocab, drawn from
    ``generator`` in order (std 0.01)."""
    return {
        f"t{i}": embed_init(generator, (padded_vocab(v, tp), dim), dtype,
                            std=0.01)
        for i, v in enumerate(vocabs)
    }


def jagged_to_padded(values: Any, offsets: Any, weights: Any = None, *,
                     device: torch.device | str | None = None):
    """KeyedJaggedTensor-style jagged bags -> the padded ``(idx, w)``
    layout the embedding-bag kernel consumes: (B, L) int32 and f32 tensors
    on ``device`` (the card unless given).

    Bag ``b`` is ``values[offsets[b]:offsets[b+1]]``; every bag is padded
    to the longest length (min 1, so empty batches still shape-check),
    with ``w`` carrying 0.0 at padded slots and padded indices 0 —
    torchrec's jagged->dense bridge.  ``weights`` defaults to 1.0 per
    value.  The layout is built in numpy with one scatter (no loop over
    bags): value ``j`` of bag ``b`` lands in column ``j - offsets[b]``.
    Offset validation (monotone, spanning) lives in core/sparse.check_jagged;
    this converter just requires the spanning invariant it needs."""
    off = np.asarray(offsets, dtype=np.int64)
    val = np.asarray(values, dtype=np.int64)
    if off.ndim != 1 or off.size < 2 or off[0] != 0 or off[-1] != val.size:
        raise ValueError(
            f"offsets must be 1-D spanning [0, {val.size}]")
    lens = np.diff(off)
    if np.any(lens < 0):
        raise ValueError("offsets must be non-decreasing")
    w_in = (np.ones(val.size, dtype=np.float32) if weights is None
            else np.asarray(weights, dtype=np.float32).reshape(-1))
    if w_in.size != val.size:
        raise ValueError(f"weights must have {val.size} entries")
    nbags = off.size - 1
    pad = max(1, int(lens.max()) if nbags else 1)
    idx = np.zeros((nbags, pad), dtype=np.int32)
    w = np.zeros((nbags, pad), dtype=np.float32)
    bag = np.repeat(np.arange(nbags), lens)
    col = np.arange(val.size) - off[:-1][bag]
    idx[bag, col] = val
    w[bag, col] = w_in
    dev = resolve_device(device)
    return torch.from_numpy(idx).to(dev), torch.from_numpy(w).to(dev)


def lookup_fields(tables: dict, ids: torch.Tensor) -> torch.Tensor:
    """ids (B, F), one id per field -> (B, F, D) embeddings.

    Per field a gather from table ``t{i}``; an id outside the table reads
    a zero row, as the JAX package's masked gather does."""
    parts = []
    for i in range(ids.shape[1]):
        t = tables[f"t{i}"]
        v = t.shape[0]
        col = ids[:, i].long()
        ok = (col >= 0) & (col < v)
        rows = t[col.clamp(0, v - 1)]
        parts.append(torch.where(ok[:, None], rows, torch.zeros_like(rows)))
    return torch.stack(parts, dim=1)


# ---------------------------------------------------------------------------
# plain MLP machinery (dense stage)
# ---------------------------------------------------------------------------

def init_mlp(generator: torch.Generator, dims,
             dtype: torch.dtype = torch.float32) -> dict:
    """``w{i}`` (dims[i], dims[i+1]) drawn from ``generator`` in order, then
    zero ``b{i}``, on the generator's device."""
    n = len(dims) - 1
    ws = {f"w{i}": dense_init(generator, (dims[i], dims[i + 1]), dims[i], dtype)
          for i in range(n)}
    return ws | {f"b{i}": torch.zeros((dims[i + 1],), dtype=dtype,
                                      device=generator.device)
                 for i in range(n)}


def apply_mlp(p: dict, x: torch.Tensor, act=torch.relu, final_act=None):
    n = len([k for k in p if k.startswith("w")])
    for i in range(n):
        x = x @ p[f"w{i}"] + p[f"b{i}"]
        if i < n - 1:
            x = act(x)
        elif final_act is not None:
            x = final_act(x)
    return x


def bce_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy on logits, in the numerically stable
    form ``max(z, 0) - z*y + log1p(exp(-|z|))``."""
    z = logits.float()
    y = labels.float()
    per = (torch.maximum(z, torch.zeros_like(z)) - z * y
           + torch.log1p(torch.exp(-torch.abs(z))))
    return per.mean()
