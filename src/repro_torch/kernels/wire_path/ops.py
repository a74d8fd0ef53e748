"""Public entry points of the fused wire-path kernel (torch counterpart of
``repro/kernels/wire_path/ops.py``).

``fused_wire_update``
    the single-pass path: wire payload -> (decode + aggregate + optimize)
    in one kernel.  CUDA tensors launch the CUDA kernel, which updates
    ``param`` and the state in place; CPU tensors take its plain version;
    meta tensors inside a dry run (an active ``launch/cost_analysis``
    mode) charge one launch and return ``param`` and the state.
``unfused_wire_update``
    the pipeline the fused kernel must match bit for bit: one dequantize
    per int8 stream (``kernels/quant``), the decoded f32 gradients
    materialized, then the aggregate+optimize kernel
    (``kernels/fused_agg_opt``).  The fabric's fallback path and the parity
    oracle of tests and ``chip_smoke.py``.
``wire_path_supported``
    the codec x optimizer x chunk-geometry support matrix the fabric
    routes on, the JAX package's exactly, so the two fabrics take the
    fused route for the same configurations.

The JAX wrappers' ``use_pallas``/``interpret`` have no counterpart: a
caller that wants the oracle calls ``ref.py`` itself.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.fused_agg_opt.ops import (
    fused_aggregate_update,
    scalar_packet,
)
from repro_torch.kernels.quant.ops import dequantize_chunks
from repro_torch.launch.cost_analysis import charging, record_kernel
from repro_torch.kernels.wire_path import kernel as _kernel
from repro_torch.optim.optimizers import OptimizerSpec

LANES = 128
# per-codec chunk granule: the JAX package's (a chunk's rows fill whole
# native TPU tiles of the wire dtype: f32 (8, 128), bf16 (16, 128), int8
# (32, 128)).  The CUDA kernel needs only multiples of 4; the granules are
# kept so both packages take the fused route for the same configurations.
_CHUNK_GRANULE = {"none": 8 * LANES, "bf16": 16 * LANES, "int8": 32 * LANES}
_SUPPORTED_OPTS = ("sgd", "momentum", "adam", "adamw")


def wire_path_supported(
    codec: str, spec: OptimizerSpec, chunk_elems: int
) -> bool:
    """Whether the fused kernel consumes this wire format directly.

    True iff the codec is one it decodes in-register (``bf16``/``int8``;
    codec ``"none"`` has no decode stage to fuse, the raw-f32 path already
    runs single-pass through ``fused_agg_opt``), the optimizer is one of
    the fused bodies, and ``chunk_elems`` is a whole number of the codec's
    granules.  The fabric takes the unfused path whenever this is False."""
    if codec not in ("bf16", "int8"):
        return False
    if spec.name not in _SUPPORTED_OPTS:
        return False
    return chunk_elems > 0 and chunk_elems % _CHUNK_GRANULE[codec] == 0


def _validate(payload, scales, param, state, spec, codec, chunk_elems,
              block_chunks) -> None:
    """The JAX kernel's checks, in its order, then the operand shapes."""
    if codec not in _kernel.WIRE_DTYPES:
        raise ValueError(f"unknown wire codec {codec!r}")
    if payload.dim() != 2 or payload.shape[0] < 1:
        raise ValueError(
            f"payload must be (K, N) with K >= 1, got {tuple(payload.shape)}")
    k, n = payload.shape
    if chunk_elems % LANES:
        raise ValueError(f"chunk_elems {chunk_elems} not a multiple of {LANES}")
    if n == 0 or n % chunk_elems:
        raise ValueError(f"slab size {n} not whole chunks of {chunk_elems}")
    c = n // chunk_elems
    # the TPU kernel's grid blocks chunks; the CUDA kernel needs no
    # blocking, but the argument keeps its contract
    if block_chunks is not None and (block_chunks < 1 or c % block_chunks):
        raise ValueError(f"block_chunks {block_chunks} does not divide {c} chunks")
    if codec == "int8" and scales is None:
        raise ValueError("int8 wire streams need per-chunk scales")
    if spec.name not in _SUPPORTED_OPTS:
        raise ValueError(f"unknown optimizer {spec.name}")
    if tuple(param.shape) != (n,):
        raise ValueError(
            f"param has shape {tuple(param.shape)}, streams have {n} elements")
    if len(state) != spec.num_state_slots:
        raise ValueError(
            f"{spec.name} takes {spec.num_state_slots} state slots, got "
            f"{len(state)}")
    for s in state:
        if tuple(s.shape) != (n,) or s.dtype != torch.float32:
            raise ValueError(
                f"state slots must be ({n},) f32, got {tuple(s.shape)} {s.dtype}")


def fused_wire_update(
    payload: torch.Tensor,  # (K, N) wire-dtype streams
    scales: torch.Tensor | None,  # (K, N/chunk_elems) f32 (int8), else None
    param: torch.Tensor,  # (N,) f32
    state: tuple,  # opt state slots, each (N,) f32
    spec: OptimizerSpec,
    step: int,  # 1-based
    lr_scale: float = 1.0,
    *,
    codec: str,
    chunk_elems: int,
    average: bool = True,
    block_chunks: int | None = None,
) -> tuple[torch.Tensor, tuple]:
    """Apply K wire streams to ``param``/``state`` in a single pass.

    ``payload`` rows are whole codec'd slabs in ascending stream order (the
    fold order, load-bearing for bit-parity with the unfused left fold);
    ``N`` must be a whole number of ``chunk_elems`` chunks.  Returns
    ``(new_param, new_state)``; on the card the kernel updates ``param`` and
    ``state`` in place and returns them."""
    _validate(payload, scales, param, state, spec, codec, chunk_elems,
              block_chunks)
    if param.device.type == "meta" and charging():  # one charged launch
        record_kernel("wire_fused", [payload, scales, param, *state],
                      [param, *state])
        return param, tuple(state)
    scalars = scalar_packet(spec, step, lr_scale, device=param.device)
    if param.device.type == "cuda":
        return _kernel.wire_fused_cuda(
            payload, scales, param, state, scalars, spec, codec=codec,
            chunk_elems=chunk_elems, average=average)
    if param.device.type == "cpu":
        return _kernel.wire_fused_torch(
            payload, scales, param, state, scalars, spec, codec=codec,
            chunk_elems=chunk_elems, average=average)
    raise ValueError(
        f"fused_wire_update runs on cuda or cpu, not {param.device.type}")


def unfused_wire_update(
    payload: torch.Tensor,
    scales: torch.Tensor | None,
    param: torch.Tensor,
    state: tuple,
    spec: OptimizerSpec,
    step: int,
    lr_scale: float = 1.0,
    *,
    codec: str,
    chunk_elems: int,
    average: bool = True,
) -> tuple[torch.Tensor, tuple]:
    """The unfused pipeline (decode -> device memory -> agg+opt), with the
    same signature and return contract as ``fused_wire_update``.  On the
    card it launches the dequantize kernel once per int8 stream, then
    ``fused_agg_opt`` (which updates ``param`` and ``state`` in place)."""
    if codec in ("none", "bf16"):
        grads = payload  # the kernel widens bf16 exactly, as .float() would
    elif codec == "int8":
        if scales is None:
            raise ValueError("int8 wire streams need per-chunk scales")
        grads = [dequantize_chunks(payload[i], scales[i], chunk_elems)
                 for i in range(payload.shape[0])]
    else:
        raise ValueError(f"unknown wire codec {codec!r}")
    return fused_aggregate_update(grads, param, state, spec, step, lr_scale,
                                  average=average)
