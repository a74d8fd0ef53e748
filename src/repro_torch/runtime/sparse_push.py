"""Sparse embedding push: the PS key-value insight applied to recsys tables
(torch counterpart of ``repro/runtime/sparse_push.py``).

The loss is differentiated with respect to the *post-lookup* embeddings
``e``, and table gradients travel as (ids, cotangent-rows) pairs instead
of dense table gradients: a batch touches a tiny key subset per step.

Only the NIC-side duplicate-id coalescing is ported so far;
``sparse_table_update`` and ``make_sparse_recsys_train_step`` are SPMD code
and wait for the port's SPMD path.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.kernels.embedding_bag.ops import segment_sum


def coalesce_ids_rows(ids: Any, rows: torch.Tensor) -> tuple[np.ndarray,
                                                             torch.Tensor]:
    """NIC-side duplicate-id coalescing: ``(ids (n,), rows (n, D))`` ->
    ``(unique ascending ids, per-id summed rows)``.

    A batch that touches row 7 five times routes *one* wire row carrying
    the sum — the key-value dedup the PS push exists for.  Duplicates fold
    in batch order from 0 (``kernels.embedding_bag.segment_sum``: the JAX
    segment sum's order on the CPU, kept on the card, where an atomic
    scatter-add would fold them in no fixed order), before any routing
    decision, so the summed bits are independent of how the table is
    sharded; ``core/sparse.SparseTier`` leans on that for its bit-identity
    invariant."""
    ids_np = np.asarray(ids).reshape(-1)
    rows = torch.as_tensor(rows, dtype=torch.float32)
    if rows.shape[0] != ids_np.size:
        raise ValueError(
            f"rows leading dim {rows.shape[0]} != {ids_np.size} ids")
    if ids_np.size == 0:
        return ids_np.astype(np.int64), rows
    uniq, inv = np.unique(ids_np, return_inverse=True)
    summed = segment_sum(rows, inv.reshape(-1), int(uniq.size))
    return uniq.astype(np.int64), summed
