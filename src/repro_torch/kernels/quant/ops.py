"""Public entry points of the chunk quantization codec (torch counterpart
of ``repro/kernels/quant/ops.py``).

Argument validation lives here, at the public boundary: slabs must be flat
f32 and a whole number of ``chunk_elems`` chunks, payloads must be int8
with one f32 scale per chunk.  Then dispatch is on the device alone:

  * CUDA tensors launch the CUDA kernel (``kernel.*_cuda``) — a failed
    build or launch raises, nothing falls back;
  * CPU tensors take the kernel's plain version (``kernel.*_torch``);
  * meta tensors inside a dry run (an active ``launch/cost_analysis``
    mode: ``launch/dryrun.py``) compute nothing: each call is charged as
    one kernel launch (its operands and outputs once) and returns empty
    outputs of the card's shapes and dtypes.  Outside one, meta tensors
    are refused like any other device.

The JAX wrapper's ``use_pallas`` has no counterpart: a caller that wants
the oracle calls ``ref.py`` itself.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.quant import kernel as _kernel
from repro_torch.launch.cost_analysis import charging, record_kernel

LANES = 128


def _check_chunking(n: int, chunk_elems: int) -> None:
    if chunk_elems < LANES or chunk_elems % LANES:
        raise ValueError(
            f"chunk_elems {chunk_elems} must be a positive multiple of "
            f"{LANES} lanes")
    if n == 0 or n % chunk_elems:
        raise ValueError(
            f"slab of {n} elements is not a whole number of "
            f"{chunk_elems}-element chunks")


def _device_type(name: str, t: torch.Tensor) -> str:
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name} runs on cuda or cpu, not {t.device.type}")
    return t.device.type


def quantize_chunks(x: torch.Tensor, chunk_elems: int):
    """Quantize a flat f32 slab to (int8 payload, per-chunk f32 scales)."""
    if x.dim() != 1:
        raise ValueError(f"expected a flat slab, got shape {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise ValueError(f"quantize_chunks wants f32 input, got {x.dtype}")
    _check_chunking(x.shape[0], chunk_elems)
    if x.device.type == "meta" and charging():
        q = torch.empty(x.shape, dtype=torch.int8, device="meta")
        scale = torch.empty(x.shape[0] // chunk_elems, device="meta")
        record_kernel("quantize_chunks", [x], [q, scale])
        return q, scale
    if _device_type("quantize_chunks", x) == "cuda":
        return _kernel.quantize_chunks_cuda(x, chunk_elems)
    return _kernel.quantize_chunks_torch(x, chunk_elems)


def dequantize_chunks(q: torch.Tensor, scale: torch.Tensor, chunk_elems: int):
    """Decode an (int8 payload, per-chunk f32 scales) pair back to f32."""
    if q.dim() != 1:
        raise ValueError(f"expected a flat payload, got shape {tuple(q.shape)}")
    if q.dtype != torch.int8:
        raise ValueError(
            f"dequantize_chunks wants an int8 payload, got {q.dtype}")
    _check_chunking(q.shape[0], chunk_elems)
    c = q.shape[0] // chunk_elems
    if tuple(scale.shape) != (c,):
        raise ValueError(
            f"payload of {c} chunks needs scales of shape ({c},), got "
            f"{tuple(scale.shape)}")
    if q.device.type == "meta" and charging():
        out = torch.empty(q.shape, device="meta")
        record_kernel("dequantize_chunks", [q, scale], [out])
        return out
    if _device_type("dequantize_chunks", q) == "cuda":
        return _kernel.dequantize_chunks_cuda(q, scale, chunk_elems)
    return _kernel.dequantize_chunks_torch(q, scale, chunk_elems)
