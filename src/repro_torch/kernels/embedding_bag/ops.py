"""Validated entry points of the embedding-bag kernel (torch counterpart of
``repro/kernels/embedding_bag/ops.py``).

Validation contract, the JAX wrapper's: ``mode`` is "sum" or "mean"
(``ValueError``), indices are integers (``TypeError``: a float index would
be reinterpreted as a row number), and every index lies in ``[0, V)``
(``ValueError``: the kernel would read whatever row an index names).  torch
has no tracing split, so the bounds check always runs, and the JAX
wrapper's clamp for traced indices has no counterpart.

Dispatch is on the table's device alone:
  * a CUDA table launches the CUDA kernel (``kernel.*_cuda``); a failed
    build or launch raises, nothing falls back;
  * a CPU table takes the kernel's plain version (``kernel.*_torch``);
  * a meta table inside a dry run (an active ``launch/cost_analysis``
    mode: ``launch/dryrun.py``) computes nothing: the call is charged as
    one kernel launch (its operands and outputs once) and returns an empty
    output of the card's shape; meta indices skip the bounds check (they
    hold no ids).  Outside a dry run a meta table is refused like any
    other device.
Indices and weights built on the host (the sparse tier's bags) may come as
CPU tensors or numpy arrays: they are checked there, without waiting for
the card, and then copied to the table's device.  The JAX wrapper's
``use_pallas`` has no counterpart: a caller that wants the oracle calls
``ref.py`` itself.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.kernels.embedding_bag import kernel as _kernel
from repro_torch.launch.cost_analysis import charging, record_kernel

_INT_TYPES = (torch.uint8, torch.int8, torch.int16, torch.int32, torch.int64)


def _device_type(name: str, t: torch.Tensor) -> str:
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name} runs on cuda or cpu, not {t.device.type}")
    return t.device.type


def embedding_bag(table: torch.Tensor, indices: Any, weights: Any,
                  mode: str = "sum") -> torch.Tensor:
    """Weighted embedding-bag lookup: bags of table rows, summed or meaned.

    Bag ``b`` returns ``sum_l weights[b, l] * table[indices[b, l]]``
    (``mode="mean"`` divides by the weight sum; pad slots carry weight
    0.0), as a (B, D) f32 tensor on the table's device."""
    if mode not in ("sum", "mean"):
        raise ValueError(f"mode must be 'sum' or 'mean', got {mode!r}")
    idx = torch.as_tensor(indices)
    if idx.dtype not in _INT_TYPES:
        raise TypeError(
            f"embedding_bag indices must be integers, got {idx.dtype} — a "
            "float index would be reinterpreted as a row number")
    w = torch.as_tensor(weights)
    if idx.dim() != 2 or tuple(w.shape) != tuple(idx.shape):
        raise ValueError(
            f"indices and weights must both be (B, L), got {tuple(idx.shape)} "
            f"and {tuple(w.shape)}")
    if table.dim() != 2:
        raise ValueError(f"table must be (V, D), got {tuple(table.shape)}")
    v = table.shape[0]
    if idx.numel() and idx.device.type != "meta":
        lo, hi = int(idx.min()), int(idx.max())
        if lo < 0 or hi >= v:
            raise ValueError(
                f"embedding_bag indices [{lo}, {hi}] out of range for a "
                f"{v}-row table — the kernel would silently read the wrong rows")
    if idx.dtype not in (torch.int32, torch.int64):
        idx = idx.to(torch.int32)
    dev = table.device
    idx = idx.to(dev).contiguous()
    w = w.to(dev, torch.float32).contiguous()
    table = table.float()
    if table.device.type == "meta" and charging():
        out = torch.empty((idx.shape[0], table.shape[1]), device="meta")
        record_kernel("embedding_bag", [table, idx, w], [out])
        return out
    if _device_type("embedding_bag", table) == "cuda":
        return _kernel.embedding_bag_cuda(table, idx, w, mode)
    return _kernel.embedding_bag_torch(table, idx, w, mode)


def segment_sum(rows: torch.Tensor, segment_ids: Any,
                num_segments: int) -> torch.Tensor:
    """``jax.ops.segment_sum`` with the fold order pinned: row ``j`` adds
    into segment ``segment_ids[j]``, and each segment adds its rows in
    ascending ``j`` from 0 (the CPU segment sum's order, kept on the card).

    ``rows`` is (n, D) f32 on any device (rows may be strided);
    ``segment_ids`` are n host integers in ``[0, num_segments)``.  Returns
    (num_segments, D) f32 on the rows' device."""
    ids = np.asarray(segment_ids).reshape(-1)
    if ids.size and not np.issubdtype(ids.dtype, np.integer):
        raise TypeError(f"segment ids must be integers, got {ids.dtype}")
    if rows.dim() != 2 or rows.shape[0] != ids.size:
        raise ValueError(
            f"rows must be ({ids.size}, D), got {tuple(rows.shape)}")
    if ids.size and (int(ids.min()) < 0 or int(ids.max()) >= num_segments):
        raise ValueError(
            f"segment ids [{int(ids.min())}, {int(ids.max())}] out of range "
            f"for {num_segments} segments")
    ids = ids.astype(np.int64, copy=False)
    # group the rows by segment, keeping batch order inside each (stable)
    order = np.argsort(ids, kind="stable").astype(np.int64)
    seg = np.zeros(num_segments + 1, dtype=np.int64)
    np.cumsum(np.bincount(ids, minlength=num_segments), out=seg[1:])
    dev = rows.device
    order_t = torch.from_numpy(order).to(dev)
    seg_t = torch.from_numpy(seg).to(dev)
    rows = rows.float()
    if rows.device.type == "meta" and charging():
        out = torch.empty((num_segments, rows.shape[1]), device="meta")
        record_kernel("segment_sum", [rows, order_t, seg_t], [out])
        return out
    if _device_type("segment_sum", rows) == "cuda":
        return _kernel.segment_sum_cuda(rows, order_t, seg_t)
    return _kernel.segment_sum_torch(rows, order_t, seg_t)
