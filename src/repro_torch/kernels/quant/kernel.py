"""The int8 codec kernels: CUDA wrappers and plain versions.

Torch counterpart of ``repro/kernels/quant/kernel.py``, whose Pallas TPU
kernels ``quantize_chunks_pallas`` and ``dequantize_chunks_pallas`` these
replace.  Two functions per kernel, with one contract:

``quantize_chunks_cuda`` / ``dequantize_chunks_cuda``
    launch ``csrc/quant.cu`` (built at first use by ``kernels/_build.py``)
    on the current CUDA stream, into outputs allocated here.
``quantize_chunks_torch`` / ``dequantize_chunks_torch``
    the kernels' plain PyTorch versions, in the compiled TPU kernel's op
    sequence.  It differs from the oracle (``ref.py``) in one place: XLA
    compiles ``amax / 127.0``, a division by a constant, into a product
    with the constant's f32 reciprocal, which is one ulp off the quotient
    for about one chunk in twenty-five.  The scale is therefore
    ``amax * f32(1/127)`` here and in the CUDA kernel, and the payload and
    decoded values then follow bit for bit.  ``x / scale`` divides by a
    value, which XLA leaves a true division.

Each kernel has its own launch count, which the wrapper adds one to where
it launches the kernel and nowhere else; callers reset it by assignment.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.quant.ref import (
    dequantize_chunks_ref as dequantize_chunks_torch,
)

# f32(1/127): the constant XLA multiplies by for ``amax / 127.0``
INV_127 = torch.tensor(1.0 / 127.0, dtype=torch.float32).item()

quantize_launches = 0
dequantize_launches = 0


def quantize_chunks_torch(
    x: torch.Tensor, chunk_elems: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the quantize kernel: (N,) f32 -> ((N,) int8,
    (N/chunk_elems,) f32 scales).  The chunk's max propagates NaN (scale
    1.0 then) and a NaN quotient encodes as 0, as in the JAX package."""
    n = x.shape[0]
    xc = x.reshape(n // chunk_elems, chunk_elems)
    amax = torch.amax(torch.abs(xc), dim=1)
    scale = torch.where(amax > 0, amax * INV_127, torch.ones_like(amax))
    q = torch.clamp(torch.round(xc / scale[:, None]), -127, 127)
    q = torch.where(torch.isnan(q), torch.zeros_like(q), q)
    return q.to(torch.int8).reshape(n), scale


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from repro_torch.kernels import _build

    lib = _build.load("quant")
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.quantize_chunks_launch.argtypes = [ptr, ptr, ptr, i64, i64, ptr]
    lib.quantize_chunks_launch.restype = ctypes.c_int
    lib.dequantize_chunks_launch.argtypes = [ptr, ptr, ptr, i64, i64, ptr]
    lib.dequantize_chunks_launch.restype = ctypes.c_int
    return lib


def _check_cuda(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: every tensor must be on one CUDA device")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: every tensor must be contiguous")


def quantize_chunks_cuda(
    x: torch.Tensor, chunk_elems: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the quantize kernel on the current stream: (N,) f32 on the
    card -> ((N,) int8 payload, (N/chunk_elems,) f32 scales).  Raises if
    the launch fails."""
    global quantize_launches
    _check_cuda("quantize_chunks", x)
    n = x.shape[0]
    q = torch.empty(n, dtype=torch.int8, device=x.device)
    scale = torch.empty(n // chunk_elems, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = _lib().quantize_chunks_launch(
            x.data_ptr(), q.data_ptr(), scale.data_ptr(), n, chunk_elems,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"quantize_chunks kernel launch failed: CUDA error {rc}")
    quantize_launches += 1
    return q, scale


def dequantize_chunks_cuda(
    q: torch.Tensor, scale: torch.Tensor, chunk_elems: int
) -> torch.Tensor:
    """Launch the dequantize kernel on the current stream: ``f32(q) *
    scale[chunk]`` as a new (N,) f32 tensor.  Raises if the launch fails."""
    global dequantize_launches
    _check_cuda("dequantize_chunks", q, scale)
    if scale.dtype != torch.float32:
        raise ValueError(f"dequantize_chunks: scales must be f32, got {scale.dtype}")
    n = q.shape[0]
    out = torch.empty(n, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        rc = _lib().dequantize_chunks_launch(
            q.data_ptr(), scale.data_ptr(), out.data_ptr(), n, chunk_elems,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"dequantize_chunks kernel launch failed: CUDA error {rc}")
    dequantize_launches += 1
    return out
