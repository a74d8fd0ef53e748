"""Shared model machinery: init, norms, rotary embeddings (torch counterpart
of ``repro/models/common.py``).

The port runs the single-device (tp=1) case, so the JAX package's ``Dist``
collectives context has no counterpart here.  Initializers draw from an
explicit ``torch.Generator`` on the generator's device; they give other
numbers than ``jax.random`` for the same seed, so parity tests load the
JAX package's parameters through ``repro_torch.interop`` instead.
"""
from __future__ import annotations

import math

import torch

from repro_torch.device import resolve_device


# ---------------------------------------------------------------------------
# initializers (explicit generator threading)
# ---------------------------------------------------------------------------

def dense_init(generator: torch.Generator, shape, in_dim: int,
               dtype: torch.dtype = torch.float32, scale: float = 1.0):
    std = scale / math.sqrt(in_dim)
    x = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=generator.device)
    return (x * std).to(dtype)


def embed_init(generator: torch.Generator, shape,
               dtype: torch.dtype = torch.float32, std: float = 0.02):
    x = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=generator.device)
    return (x * std).to(dtype)


# ---------------------------------------------------------------------------
# numerics
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6):
    """RMSNorm with gemma's ``(1 + weight)`` scale, computed in f32."""
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + weight.float())
    return out.to(dt)


def rope_freqs(head_dim: int, theta: float = 1e4, device=None):
    """RoPE inverse frequencies on ``device`` (the card unless the caller
    passes another)."""
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=resolve_device(device))
                            / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 1e4):
    """x: (..., S, H, hd); positions: (..., S).  Rotates split halves
    (``[x1, x2]``), not interleaved pairs, as the JAX package does."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)  # (hd/2,)
    ang = positions[..., :, None].float() * freqs  # (..., S, hd/2)
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)

