"""Plain-torch oracle for per-chunk symmetric int8 gradient quantization
(torch counterpart of ``repro/kernels/quant/ref.py``).

Each chunk gets one f32 scale (``amax/127``, 1.0 when not ``amax > 0``) and
an int8 payload, so chunks aggregate with integer adds on the wire and
rescale at the PS.

A NaN quotient encodes as 0, which is what XLA's float-to-int conversion
gives the JAX oracle; torch's ``.to(torch.int8)`` of NaN is not defined, so
the mapping is written out.  NaN propagates through the chunk's max as it
does through ``jnp.max``: a chunk holding a NaN has scale 1.0.
"""
from __future__ import annotations

import torch


def quantize_chunks_ref(
    x: torch.Tensor, chunk_elems: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """(N,) f32 -> ((N,) int8 payload, (N/chunk_elems,) f32 scales)."""
    n = x.shape[0]
    c = n // chunk_elems
    xc = x.reshape(c, chunk_elems).float()
    amax = torch.amax(torch.abs(xc), dim=1)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(xc / scale[:, None]), -127, 127)
    q = torch.where(torch.isnan(q), torch.zeros_like(q), q).to(torch.int8)
    return q.reshape(n), scale


def dequantize_chunks_ref(
    q: torch.Tensor, scale: torch.Tensor, chunk_elems: int
) -> torch.Tensor:
    """Oracle dequantize: ``f32(q) * scale`` broadcast per chunk."""
    n = q.shape[0]
    c = n // chunk_elems
    qc = q.reshape(c, chunk_elems).float()
    return (qc * scale[:, None]).reshape(n)
