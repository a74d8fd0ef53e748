"""Plain-torch oracle for the fused wire-path update (torch counterpart of
``repro/kernels/wire_path/ref.py``).

The oracle is the literal composition the fused kernel replaces: decode
each stream from its wire form (per-chunk int8 dequantize, bf16 widening,
or identity for raw f32), stack the decoded f32 slabs, and run the
aggregate+optimize oracle.  It is held against the kernel at tolerance;
the kernel's own op order is followed bit for bit by
``kernel.wire_fused_torch``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.fused_agg_opt.ref import fused_aggregate_update_ref
from repro_torch.kernels.quant.ref import dequantize_chunks_ref
from repro_torch.optim.optimizers import OptimizerSpec


def decode_streams_ref(
    payload: torch.Tensor, scales: torch.Tensor | None, codec: str,
    chunk_elems: int,
) -> torch.Tensor:
    """Decode K wire streams to f32.

    ``payload``: (K, N) wire-dtype slabs (int8 / bf16 / f32); ``scales``:
    (K, N/chunk_elems) f32 per-chunk scales (int8 only, else ``None``).
    Returns (K, N) f32: the gradients the unfused path materializes."""
    if codec in ("none", "bf16"):
        return payload.float()
    if codec == "int8":
        if scales is None:
            raise ValueError("int8 wire streams need per-chunk scales")
        return torch.stack([
            dequantize_chunks_ref(payload[i], scales[i], chunk_elems)
            for i in range(payload.shape[0])
        ])
    raise ValueError(f"unknown wire codec {codec!r}")


def fused_wire_update_ref(
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
    """Decode + aggregate + optimize, oracle semantics; returns
    ``(new_param, new_state)`` shaped like ``param``/``state``."""
    grads = decode_streams_ref(payload, scales, codec, chunk_elems)
    return fused_aggregate_update_ref(
        grads, param, state, spec, step, lr_scale, average=average)
