"""The embedding-bag kernel: CUDA wrappers and plain versions.

Torch counterpart of ``repro/kernels/embedding_bag/kernel.py``, whose
Pallas TPU kernel ``embedding_bag_pallas`` this replaces.  One CUDA source,
``csrc/embedding_bag.cu`` (built at first use by ``kernels/_build.py``),
with two entry points, each beside its plain PyTorch version:

``embedding_bag_cuda`` / ``embedding_bag_torch``
    padded (B, L) bags: ``out[b] = fold_l fma(w[b, l], table[idx[b, l]],
    acc)`` from 0, in slot order.  XLA compiles the TPU kernel's
    ``o += w * row`` into a fused multiply-add, so the fold is one FMA a
    slot (the CUDA kernel's ``__fmaf_rn``).  A single one-slot bag (B = L
    = 1, a TPU grid of one step) is the plain product ``w * row``: XLA
    drops the add of the zero accumulator there, which differs from the
    FMA only in the sign of a zero.  Eager torch has no f32 FMA, so the
    plain version forms the exact product in f64, adds with an exact
    error term (TwoSum) and rounds to odd before the one rounding to f32,
    which is the correctly rounded FMA.  ``mean`` divides by
    ``max(sum_l w, 1e-9)`` with the weight sum a sequential fold from 0.
``segment_sum_cuda`` / ``segment_sum_torch``
    the sparse push's duplicate-id fold (``jax.ops.segment_sum`` in the
    JAX package): segment ``u`` sums the rows ``order[seg[u]:seg[u+1]]``
    in that order from 0.  On the CPU the JAX segment sum is that
    sequential fold; the kernel keeps it on the card, where an atomic
    scatter-add would add duplicates in no fixed order.

Each entry point has its own launch count, which the wrapper adds one to
where it launches the kernel and nowhere else; callers reset it by
assignment.
"""
from __future__ import annotations

import ctypes
import functools

import torch

launches = 0  # embedding_bag_cuda
segment_launches = 0  # segment_sum_cuda

_MEAN_FLOOR = torch.tensor(1e-9, dtype=torch.float32).item()  # f32(1e-9)


# -- the plain versions -------------------------------------------------------
def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """f32 ``a * b + c`` rounded once (a correctly rounded FMA).

    The product of two f32 is exact in f64.  ``s = p + c`` rounds, and
    TwoSum gives the exact remainder; where it is not zero and ``s`` is
    even, ``s`` moves one f64 ulp toward it (round to odd), so the final
    f32 rounding of ``s`` is that of the exact sum.  A NaN result takes
    its bits from f32 arithmetic on the same device, as the kernel's FMA
    does: the card writes the canonical NaN 0x7fffffff, the CPU keeps the
    input's payload (as XLA's FMA does there), and a NaN that went through
    f64 would carry neither."""
    p = a.double() * b.double()
    c64 = c.double()
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)
    bits = s.view(torch.int64)
    nudge = torch.isfinite(s) & (err != 0) & ((bits & 1) == 0)
    toward = torch.where((err > 0) == (s > 0), 1, -1)
    out = torch.where(nudge, bits + toward, bits).view(torch.float64).float()
    return torch.where(out.isnan(), a * b + c, out)


def embedding_bag_torch(table: torch.Tensor, indices: torch.Tensor,
                        weights: torch.Tensor, mode: str = "sum") -> torch.Tensor:
    """Plain version of the embedding-bag kernel: (V, D) f32 table, (B, L)
    int indices, (B, L) f32 weights -> (B, D) f32, bitwise equal to it."""
    b, length = indices.shape
    idx = indices.long()
    w = weights.float()
    acc = torch.zeros((b, table.shape[1]), dtype=torch.float32,
                      device=table.device)
    if b == 1 and length == 1:  # one grid step: XLA drops the 0 +
        acc = w[:, :1] * table[idx[:, 0]].float()
    for slot in range(0 if b == 1 and length == 1 else length):
        acc = _fma(w[:, slot, None], table[idx[:, slot]].float(), acc)
    if mode == "mean":
        wsum = torch.zeros(b, dtype=torch.float32, device=table.device)
        for slot in range(length):
            wsum = wsum + w[:, slot]
        floor = torch.full_like(wsum, _MEAN_FLOOR)
        denom = torch.where((wsum > floor) | wsum.isnan(), wsum, floor)
        acc = acc / denom[:, None]
    return acc


def segment_sum_torch(rows: torch.Tensor, order: torch.Tensor,
                      seg: torch.Tensor) -> torch.Tensor:
    """Plain version of the segment fold: (n, D) rows, ``order`` (n,) the
    row numbers grouped by segment, ``seg`` (U+1,) the segment offsets ->
    (U, D), each segment's rows added in ``order`` from 0.  Rank r of every
    segment is added in one step (the segments of a step are distinct), so
    the steps are as many as the longest segment."""
    u = seg.numel() - 1
    out = torch.zeros((u, rows.shape[1]), dtype=torch.float32,
                      device=rows.device)
    if order.numel() == 0:
        return out
    counts = seg[1:] - seg[:-1]
    owner = torch.repeat_interleave(torch.arange(u, device=rows.device), counts)
    rank = torch.arange(order.numel(), device=rows.device) - seg[owner]
    by_rank = torch.argsort(rank, stable=True)
    bounds = torch.bincount(rank).cumsum(0).tolist()
    start = 0
    for stop in bounds:
        slots = by_rank[start:stop]
        segs = owner[slots]
        out[segs] = out[segs] + rows[order[slots]].float()
        start = stop
    return out


# -- the CUDA kernel ------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from repro_torch.kernels import _build

    lib = _build.load("embedding_bag")
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.embedding_bag_launch.argtypes = [ptr, i64, ptr, i32, ptr, ptr, i64,
                                         i64, i64, i32, ptr]
    lib.embedding_bag_launch.restype = ctypes.c_int
    lib.segment_sum_launch.argtypes = [ptr, i64, ptr, ptr, ptr, i64, i64, ptr]
    lib.segment_sum_launch.restype = ctypes.c_int
    return lib


def _check_rows(name: str, rows: torch.Tensor) -> None:
    """Rows of f32 with unit stride along D (any row stride), on CUDA."""
    if rows.device.type != "cuda" or rows.dtype != torch.float32:
        raise ValueError(f"{name}: rows must be f32 on a CUDA device")
    if rows.dim() != 2 or (rows.shape[1] > 1 and rows.stride(1) != 1) or (
            rows.shape[0] > 1 and rows.stride(0) < rows.shape[1]):
        raise ValueError(
            f"{name}: rows must be 2-D with unit stride along D, got shape "
            f"{tuple(rows.shape)} and strides {rows.stride()}")


def _check_on(name: str, dev: torch.device, *tensors: torch.Tensor) -> None:
    if any(t.device != dev or not t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: every tensor must be contiguous on {dev}")


def embedding_bag_cuda(table: torch.Tensor, indices: torch.Tensor,
                       weights: torch.Tensor, mode: str = "sum") -> torch.Tensor:
    """Launch the embedding-bag kernel on the current stream: (V, D) f32
    table (rows may be strided), (B, L) int32/int64 indices, (B, L) f32
    weights, all on one card -> a new (B, D) f32.  Indices are not range
    checked here (``ops.embedding_bag`` does that); raises if the launch
    fails."""
    global launches
    _check_rows("embedding_bag", table)
    _check_on("embedding_bag", table.device, indices, weights)
    if indices.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"embedding_bag: indices must be int32 or int64, got "
                         f"{indices.dtype}")
    if weights.dtype != torch.float32 or weights.shape != indices.shape:
        raise ValueError("embedding_bag: weights must be f32 of the indices' shape")
    b, length = indices.shape
    d = table.shape[1]
    out = torch.empty((b, d), dtype=torch.float32, device=table.device)
    with torch.cuda.device(table.device):
        rc = _lib().embedding_bag_launch(
            table.data_ptr(), table.stride(0) if table.shape[0] > 1 else d,
            indices.data_ptr(), int(indices.dtype == torch.int64),
            weights.data_ptr(), out.data_ptr(), b, length, d,
            int(mode == "mean"), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"embedding_bag kernel launch failed: CUDA error {rc}")
    launches += 1
    return out


def segment_sum_cuda(rows: torch.Tensor, order: torch.Tensor,
                     seg: torch.Tensor) -> torch.Tensor:
    """Launch the segment fold on the current stream: (n, D) f32 rows (may
    be strided), int64 ``order`` (n,) and ``seg`` (U+1,) on the same card
    -> a new (U, D) f32.  Raises if the launch fails."""
    global segment_launches
    _check_rows("segment_sum", rows)
    _check_on("segment_sum", rows.device, order, seg)
    if order.dtype != torch.int64 or seg.dtype != torch.int64:
        raise ValueError("segment_sum: order and seg must be int64")
    u, d = seg.numel() - 1, rows.shape[1]
    out = torch.empty((u, d), dtype=torch.float32, device=rows.device)
    with torch.cuda.device(rows.device):
        rc = _lib().segment_sum_launch(
            rows.data_ptr(), rows.stride(0) if rows.shape[0] > 1 else d,
            order.data_ptr(), seg.data_ptr(), out.data_ptr(), u, d,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"segment_sum kernel launch failed: CUDA error {rc}")
    segment_launches += 1
    return out
