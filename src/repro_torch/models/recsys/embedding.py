"""PS-sharded embedding tables and the dense MLP stage of the recsys models
(torch counterpart of ``repro/models/recsys/embedding.py``).

Tables are row-sharded over the ``model`` axis (each rank is a PBox
micro-shard holding a contiguous row range of every table).  A lookup is
the PS "pull": each shard gathers the rows it owns (mask + clipped gather)
producing a *partial* (B, F, D); one ``psum_scatter`` over the model axis
(``Dist.psum_scatter_model``) then combines the shard partials and
re-shards the batch over the model axis, so the dense stage runs
batch-parallel on the full mesh.  Its transpose (an all-gather) routes
the gradients back to the owning rows.  With ``dist=None`` (or no model
axis) a table is whole and a lookup a plain masked gather.  Row sharding
over in-process PS engines is the sparse tier's job (``core/sparse.py``).
Specs are tuples of an axis name or ``None`` per dimension, ``()`` for
replicated (JAX's ``PartitionSpec``s).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.common import Dist, dense_init, embed_init, gen_device


def padded_vocab(v: int, tp: int) -> int:
    return -(-v // tp) * tp


def init_tables(generator: torch.Generator | None, vocabs, dim: int,
                tp: int = 1, dtype: torch.dtype = torch.float32) -> dict:
    """``t{i}``: a (padded_vocab(v, tp), dim) table per vocab, drawn from
    ``generator`` in order (std 0.01; meta tensors for ``None``)."""
    return {
        f"t{i}": embed_init(generator, (padded_vocab(v, tp), dim), dtype,
                            std=0.01)
        for i, v in enumerate(vocabs)
    }


def table_specs(vocabs, tp: int, axis: str = "model") -> dict:
    m = axis if tp > 1 else None
    return {f"t{i}": (m, None) for i in range(len(vocabs))}


def table_grad_sync(vocabs) -> dict:
    return {f"t{i}": "none" for i in range(len(vocabs))}


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


def masked_rows(table: torch.Tensor, ids: torch.Tensor,
                dist: Dist | None) -> torch.Tensor:
    """The rows of ``ids`` this shard owns (local id = id - model_index *
    V_loc), zero where it owns none: the shard's partial lookup."""
    vloc = table.shape[0]
    midx = dist.model_index() if dist is not None else 0
    local = ids.long() - midx * vloc
    ok = (local >= 0) & (local < vloc)
    rows = table[local.clamp(0, vloc - 1)]
    return torch.where(ok[..., None], rows, torch.zeros_like(rows))


def _combine(e: torch.Tensor, dist: Dist | None) -> torch.Tensor:
    if dist is None or dist.model_axis is None:
        return e
    return dist.psum_scatter_model(e, 0)


def lookup_fields(tables: dict, ids: torch.Tensor,
                  dist: Dist | None = None) -> torch.Tensor:
    """ids (B, F), one id per field -> (B/tp, F, D) batch-resharded
    embeddings: per field the masked gather from the row shard ``t{i}``
    (a partial), then one psum_scatter over the model axis combining the
    partials and splitting the batch.  An id outside the table reads a zero
    row."""
    parts = [masked_rows(tables[f"t{i}"], ids[:, i], dist)
             for i in range(ids.shape[1])]
    return _combine(torch.stack(parts, dim=1), dist)


def lookup_sequence(table: torch.Tensor, ids: torch.Tensor,
                    dist: Dist | None = None) -> torch.Tensor:
    """ids (B, T) from a single table -> (B/tp, T, D) (history sequences)."""
    return _combine(masked_rows(table, ids, dist), dist)


def split_batch_model(x: torch.Tensor, dist: Dist | None) -> torch.Tensor:
    """This rank's model-axis block of the worker batch's rows (aligned
    with the lookup's psum_scatter batch split)."""
    if dist is None or dist.model_axis is None:
        return x
    b_loc = x.shape[0] // dist.tp
    midx = dist.model_index()
    return x[midx * b_loc:(midx + 1) * b_loc]


# ---------------------------------------------------------------------------
# plain MLP machinery (dense stage)
# ---------------------------------------------------------------------------

def init_mlp(generator: torch.Generator | None, dims,
             dtype: torch.dtype = torch.float32) -> dict:
    """``w{i}`` (dims[i], dims[i+1]) drawn from ``generator`` in order, then
    zero ``b{i}``, on the generator's device (meta for ``None``)."""
    n = len(dims) - 1
    ws = {f"w{i}": dense_init(generator, (dims[i], dims[i + 1]), dims[i], dtype)
          for i in range(n)}
    return ws | {f"b{i}": torch.zeros((dims[i + 1],), dtype=dtype,
                                      device=gen_device(generator))
                 for i in range(n)}


def mlp_specs(dims) -> dict:
    n = len(dims) - 1
    return {f"w{i}": () for i in range(n)} | {f"b{i}": () for i in range(n)}


def mlp_grad_sync(dims, tp: int) -> dict:
    s = "psum_model" if tp > 1 else "none"
    n = len(dims) - 1
    return {f"w{i}": s for i in range(n)} | {f"b{i}": s for i in range(n)}


def apply_mlp(p: dict, x: torch.Tensor, act=torch.relu, final_act=None):
    n = len([k for k in p if k.startswith("w")])
    for i in range(n):
        x = x @ p[f"w{i}"] + p[f"b{i}"]
        if i < n - 1:
            x = act(x)
        elif final_act is not None:
            x = final_act(x)
    return x


def bce_loss(logits: torch.Tensor, labels: torch.Tensor,
             dist: Dist | None = None) -> torch.Tensor:
    """Mean binary cross-entropy on logits, in the numerically stable
    form ``max(z, 0) - z*y + log1p(exp(-|z|))``; under a model axis the
    per-rank mean is divided by tp (the ranks' losses then sum to the
    worker mean over the model-axis batch split), as a product with the
    f32 reciprocal, which XLA compiles the JAX package's ``/ tp`` to."""
    z = logits.float()
    y = labels.float()
    per = (torch.maximum(z, torch.zeros_like(z)) - z * y
           + torch.log1p(torch.exp(-torch.abs(z))))
    loss = per.mean()
    if dist is not None and dist.model_axis is not None:
        loss = loss * (1.0 / dist.tp)
    return loss
