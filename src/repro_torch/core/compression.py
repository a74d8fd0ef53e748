"""Gradient compression codecs for the wire exchange stage (torch
counterpart of ``repro/core/compression.py``).

The paper's in-network aggregation proposal is constrained to integer
arithmetic with per-packet metadata.  That constraint is modelled as a
chunked int8 codec: one f32 scale per PS chunk plus an int8 payload, with
error feedback (residual accumulation) so compression error does not bias
convergence.  A cheaper bf16 codec halves wire bytes with no state.

The int8 codec runs the quant kernels (``kernels/quant``): the CUDA
kernels on CUDA tensors, their plain versions on CPU tensors.  Error
feedback (``slab + ef``, ``slab - dec``) and the bf16 codec
(``.to(torch.bfloat16)``, round to nearest even) are plain torch ops, as
they are plain ``jnp`` outside any kernel in the JAX package.  The JAX
field ``use_pallas`` has no counterpart.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.quant.ops import dequantize_chunks, quantize_chunks


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    """Codec policy for one logical link: what bits cross the wire.

    ``codec`` picks the representation ("none" | "bf16" | "int8"),
    ``chunk_elems`` the int8 scale granularity (one f32 scale per chunk),
    ``error_feedback`` whether the sender carries the quantization residual
    into its next push."""

    codec: str = "none"  # "none" | "bf16" | "int8"
    chunk_elems: int = 8192
    error_feedback: bool = True

    @property
    def wire_bytes_per_elem(self) -> float:
        """Average wire bytes per f32 element under this codec (a modelling
        convenience; exact integer accounting lives in ``wire_bytes``)."""
        if self.codec == "none":
            return 4.0
        if self.codec == "bf16":
            return 2.0
        if self.codec == "int8":
            # int8 payload + one f32 scale per chunk
            return 1.0 + 4.0 / self.chunk_elems
        raise ValueError(self.codec)


def wire_bytes(cfg: CompressionConfig, n_elems: int) -> int:
    """Exact wire bytes for an ``n_elems`` slab under ``cfg``; for int8 the
    per-chunk f32 scale is charged per started chunk."""
    if cfg.codec == "none":
        return 4 * n_elems
    if cfg.codec == "bf16":
        return 2 * n_elems
    if cfg.codec == "int8":
        return n_elems + 4 * -(-n_elems // cfg.chunk_elems)
    raise ValueError(cfg.codec)


@dataclasses.dataclass(frozen=True)
class WirePayload:
    """One codec'd slab in its on-the-wire form, kept encoded end to end.

    The fused wire path (``kernels/wire_path``) consumes this directly: the
    receiving shard's kernel decodes in registers.  ``payload`` is the flat
    (N,) slab in wire dtype (f32 / bf16 / int8); ``scale`` is the (C,)
    per-chunk f32 scale vector for the int8 codec, ``None`` otherwise.

    Invariant: ``decode_wire`` of this payload is bit-identical to what
    ``roundtrip`` returns for the same slab and error-feedback state."""

    codec: str
    payload: torch.Tensor
    scale: torch.Tensor | None = None


def encode_wire(
    cfg: CompressionConfig, slab: torch.Tensor, ef: torch.Tensor | None
) -> tuple[WirePayload, torch.Tensor | None]:
    """Encode one hop for wire-direct consumption: ``(WirePayload, new_ef)``.

    Error feedback is updated exactly as ``roundtrip`` updates it (the
    residual still costs a local dequantize for int8); only the shipped
    form differs: the payload stays encoded for the fused kernel."""
    if cfg.codec == "none":
        return WirePayload("none", slab), ef
    use_ef = cfg.error_feedback and ef is not None
    if use_ef:
        slab = slab + ef
    if cfg.codec == "bf16":
        wire = slab.to(torch.bfloat16)
        return WirePayload("bf16", wire), (slab - wire.float()) if use_ef else ef
    if cfg.codec == "int8":
        q, scale = quantize_chunks(slab, cfg.chunk_elems)
        if use_ef:
            new_ef = slab - dequantize_chunks(q, scale, cfg.chunk_elems)
        else:
            new_ef = ef
        return WirePayload("int8", q, scale), new_ef
    raise ValueError(cfg.codec)


def decode_wire(cfg: CompressionConfig, wp: WirePayload) -> torch.Tensor:
    """Decode a ``WirePayload`` to f32: the receiving end of the hop, the
    fused kernel's decode expression."""
    if wp.codec == "none":
        return wp.payload
    if wp.codec == "bf16":
        return wp.payload.float()
    if wp.codec == "int8":
        return dequantize_chunks(wp.payload, wp.scale, cfg.chunk_elems)
    raise ValueError(wp.codec)


def encode(cfg: CompressionConfig, slab: torch.Tensor,
           ef: torch.Tensor | None):
    """slab (N,) f32 -> (payload tuple, new error-feedback state): the
    ``encode_wire`` payload as ``(q, scale)`` for int8, else ``(wire,)``."""
    wp, new_ef = encode_wire(cfg, slab, ef)
    return ((wp.payload, wp.scale) if wp.codec == "int8"
            else (wp.payload,)), new_ef


def decode(cfg: CompressionConfig, payload: tuple) -> torch.Tensor:
    """Decode an ``encode`` payload tuple back to an (N,) f32 slab."""
    return decode_wire(cfg, WirePayload(cfg.codec, *payload))


def roundtrip(
    cfg: CompressionConfig, slab: torch.Tensor, ef: torch.Tensor | None
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Encode then decode one hop: what the receiving end of a codec'd link
    sees, plus the sender's updated error-feedback state.  The decoded view
    is computed once and shared with the residual."""
    if cfg.codec == "none":
        return slab, ef
    use_ef = cfg.error_feedback and ef is not None
    if use_ef:
        slab = slab + ef
    if cfg.codec == "bf16":
        dec = slab.to(torch.bfloat16).float()
    elif cfg.codec == "int8":
        q, scale = quantize_chunks(slab, cfg.chunk_elems)
        dec = dequantize_chunks(q, scale, cfg.chunk_elems)
    else:
        raise ValueError(cfg.codec)
    return dec, (slab - dec) if use_ef else ef


def init_ef_state(cfg: CompressionConfig, n: int, *,
                  device: torch.device | str | None = None
                  ) -> torch.Tensor | None:
    """Zero error-feedback residual for an ``n``-element slab on ``device``
    (the card unless the caller passes another), or ``None`` when the
    codec/config pair never accumulates one (codec "none", or error
    feedback off)."""
    if cfg.codec in ("int8", "bf16") and cfg.error_feedback:
        return torch.zeros((n,), dtype=torch.float32,
                           device=resolve_device(device))
    return None
