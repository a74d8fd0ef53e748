"""Shared model machinery: the distribution context, init, norms, rotary
embeddings (torch counterpart of ``repro/models/common.py``).

``Dist`` names the model (tensor-parallel) axis and the batch axes, as the
JAX one does, and its collectives run over a ``launch.mesh.Mesh``'s
process groups; each is the identity when its axis is ``None``.  The port
trains at tp = 1 (tensor parallelism is ROADMAP queue 1, item 6b), so a
``Dist`` with ``tp > 1`` raises.  Initializers draw from an explicit
``torch.Generator`` on the generator's device; they give other numbers
than ``jax.random`` for the same seed, so parity tests load the JAX
package's parameters through ``repro_torch.interop`` instead.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Dist:
    """Distribution context (static).  ``mesh`` is the port's addition: the
    ``launch.mesh.Mesh`` whose groups the collectives use (JAX code finds
    its axes in the enclosing ``shard_map``)."""

    model_axis: str | None = None  # TP axis name (None = single device)
    data_axes: tuple[str, ...] = ()  # batch-sharding axes
    tp: int = 1  # size of model axis
    mesh: Any = None

    def __post_init__(self):
        if self.tp > 1:
            raise NotImplementedError(
                f"tp = {self.tp}: the port trains at tp = 1; tensor "
                "parallelism is ROADMAP queue 1, item 6b")

    @staticmethod
    def none() -> "Dist":
        return Dist()

    @property
    def distributed(self) -> bool:
        return self.model_axis is not None

    # -- collectives (identity when single-device) ----------------------
    def psum_model(self, x):
        if self.model_axis is None:
            return x
        return self.mesh.psum(x, self.model_axis)

    def pmax_model(self, x):
        if self.model_axis is None:
            return x
        out = x.clone()
        torch.distributed.all_reduce(out, torch.distributed.ReduceOp.MAX,
                                     group=self.mesh.group(self.model_axis))
        return out

    def psum_scatter_model(self, x, axis: int):
        """Combine partial results AND split ``axis`` over the model axis."""
        if self.model_axis is None:
            return x
        y = self.mesh.psum_scatter(x.movedim(axis, 0), self.model_axis)
        return y.movedim(0, axis)

    def all_gather_model(self, x, axis: int):
        if self.model_axis is None:
            return x
        return self.mesh.all_gather(x, self.model_axis, axis=axis)

    def all_gather_data(self, x, axis: int):
        if not self.data_axes:
            return x
        return self.mesh.all_gather(x, self.data_axes, axis=axis)

    def model_index(self):
        if self.model_axis is None:
            return 0
        return self.mesh.axis_index(self.model_axis)


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

