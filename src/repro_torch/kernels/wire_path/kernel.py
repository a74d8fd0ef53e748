"""The fused wire-path kernel: CUDA wrapper and plain version.

Torch counterpart of ``repro/kernels/wire_path/kernel.py``, whose Pallas
TPU kernel ``wire_fused_pallas`` this replaces.  Two functions with one
contract:

``wire_fused_cuda``   launches ``csrc/wire_path.cu`` (built at first use by
                      ``kernels/_build.py``) on the current CUDA stream.  It
                      updates ``param`` and the state slots IN PLACE and
                      returns them.
``wire_fused_torch``  the kernel's plain PyTorch version, in the TPU
                      kernel's op sequence: decode each stream to rounded
                      f32 (the dequantize kernel's expression), fold the
                      streams in ascending order, ``acc * inv_k``, then the
                      optimizer bodies of ``fused_agg_opt``.  Eager torch
                      rounds every op, so this equals the Pallas kernel,
                      the CUDA kernel and the unfused pipeline bit for bit.
                      It returns new tensors.

Both take the (1, 4) f32 scalar packet ``[lr_t, bc1, bc2, tok]`` built by
``fused_agg_opt.ops.scalar_packet``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.fused_agg_opt.kernel import (
    HYPER_ARGTYPES,
    hyper_args,
    optimizer_step,
)
from repro_torch.kernels.quant.kernel import dequantize_chunks_torch
from repro_torch.optim.optimizers import OptimizerSpec

WIRE_DTYPES = {"none": torch.float32, "bf16": torch.bfloat16,
               "int8": torch.int8}
_CODEC_CODES = {"none": 0, "bf16": 1, "int8": 2}

# Kernel launches since the count was last reset: the wrapper adds one
# where it launches the kernel and nowhere else.  Callers reset it by
# assignment.
launches = 0


def _decode(payload: torch.Tensor, scales: torch.Tensor | None, i: int,
            codec: str, chunk_elems: int) -> torch.Tensor:
    if codec == "int8":
        return dequantize_chunks_torch(payload[i], scales[i], chunk_elems)
    return payload[i].float()


def wire_fused_torch(
    payload: torch.Tensor,  # (K, N) wire dtype
    scales: torch.Tensor | None,  # (K, N/chunk_elems) f32 for int8
    param: torch.Tensor,  # (N,)
    state: tuple,  # num_state_slots tensors of (N,) f32
    scalars: torch.Tensor,  # (1, 4) f32: [lr_t, bc1, bc2, tok]
    spec: OptimizerSpec,
    *,
    codec: str,
    chunk_elems: int,
    average: bool = True,
) -> tuple[torch.Tensor, tuple]:
    """Plain PyTorch version of the kernel.  Returns (new_param, new_state)
    as new tensors; the inputs are not modified."""
    k = payload.shape[0]
    acc = _decode(payload, scales, 0, codec, chunk_elems)
    for i in range(1, k):
        acc = acc + _decode(payload, scales, i, codec, chunk_elems)
    return optimizer_step(spec, scalars, acc * (1.0 / k if average else 1.0),
                          param, state)


# -- the CUDA kernel ------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from repro_torch.kernels import _build

    lib = _build.load("wire_path")
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.wire_fused_launch.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr,  # payload, scales, param, m, v, scalars
        i64, i64, i64, i32,  # k, n, chunk_elems, codec
        *HYPER_ARGTYPES,
        ptr,  # stream
    ]
    lib.wire_fused_launch.restype = ctypes.c_int
    return lib


def _check_cuda_args(payload, scales, param, state, scalars, codec,
                     chunk_elems) -> None:
    dev = param.device
    tensors = [payload, param, scalars, *state]
    if codec == "int8":
        tensors.append(scales)
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("wire_fused: every tensor must be on one CUDA device")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError("wire_fused: every tensor must be contiguous")
    if payload.dtype != WIRE_DTYPES[codec]:
        raise ValueError(
            f"wire_fused: codec {codec!r} streams are {WIRE_DTYPES[codec]}, "
            f"got {payload.dtype}")
    if any(t.dtype != torch.float32 for t in (param, scalars, *state)):
        raise ValueError("wire_fused: param, state and scalars must be f32")
    if scalars.numel() != 4:
        raise ValueError("wire_fused: scalars must be 4 f32 values")
    if codec == "int8":
        k, n = payload.shape
        if (scales.dtype != torch.float32
                or tuple(scales.shape) != (k, n // chunk_elems)):
            raise ValueError(
                f"wire_fused: int8 scales must be ({k}, {n // chunk_elems}) "
                f"f32, got {tuple(scales.shape)} {scales.dtype}")


def wire_fused_cuda(
    payload: torch.Tensor,  # (K, N) wire dtype, on the card
    scales: torch.Tensor | None,  # (K, N/chunk_elems) f32 for int8
    param: torch.Tensor,  # (N,) f32, updated in place
    state: tuple,  # num_state_slots (N,) f32 tensors, updated in place
    scalars: torch.Tensor,  # (1, 4) f32 on the card
    spec: OptimizerSpec,
    *,
    codec: str,
    chunk_elems: int,
    average: bool = True,
) -> tuple[torch.Tensor, tuple]:
    """Launch the CUDA kernel on the current stream; returns (param, state),
    the same tensors, updated in place.  Raises if the launch fails."""
    global launches
    _check_cuda_args(payload, scales, param, state, scalars, codec,
                     chunk_elems)
    k, n = payload.shape
    slots = list(state) + [None] * (2 - len(state))
    ptrs = [None if s is None else s.data_ptr() for s in slots]
    with torch.cuda.device(param.device):
        rc = _lib().wire_fused_launch(
            payload.data_ptr(), scales.data_ptr() if codec == "int8" else None,
            param.data_ptr(), ptrs[0], ptrs[1], scalars.data_ptr(),
            k, n, chunk_elems, _CODEC_CODES[codec],
            *hyper_args(spec, 1.0 / k if average else 1.0),
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"wire_fused kernel launch failed: CUDA error {rc}")
    launches += 1
    return param, tuple(state)
