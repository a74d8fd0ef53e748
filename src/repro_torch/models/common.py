"""Shared model machinery: the distribution context, init, norms, rotary
embeddings (torch counterpart of ``repro/models/common.py``).

``Dist`` names the model (tensor-parallel) axis and the batch axes, as the
JAX one does, and its collectives run over a ``launch.mesh.Mesh``'s
process groups; each is the identity when there is no model axis or it
has one rank.  The model-axis collectives are differentiable with the
transposes ``jax.grad`` uses inside a manual ``shard_map``: ``psum``'s
backward is a ``psum``, ``psum_scatter``'s an ``all_gather`` and
``all_gather``'s a ``psum_scatter`` (``pmax`` takes no gradient: the JAX
model stops the gradient before it).  So a rank's backward computes the
gradient of the sum over ranks of the per-rank loss with respect to its
local parameters, as JAX's does.  Initializers draw from an explicit
``torch.Generator`` on the generator's device (a ``None`` generator gives
meta tensors: shapes only); they give other numbers than ``jax.random``
for the same seed, so parity tests load the JAX package's parameters
through ``repro_torch.interop`` instead.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device


class _Psum(torch.autograd.Function):
    """Sum over the model axis; the backward sums the cotangents."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return mesh.psum(x, axis)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.psum(g.contiguous(), ctx.axis), None, None


def _scatter(mesh, x, axis_name, dim):
    """Tiled reduce-scatter of ``x`` along ``dim``."""
    y = mesh.psum_scatter(x.movedim(dim, 0).contiguous(), axis_name)
    return y.movedim(0, dim)


class _PsumScatter(torch.autograd.Function):
    """Sum over the model axis and keep this rank's block of ``dim``; the
    backward all-gathers the cotangent blocks."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _scatter(mesh, x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return (ctx.mesh.all_gather(g.contiguous(), ctx.axis, axis=ctx.dim),
                None, None, None)


class _AllGather(torch.autograd.Function):
    """Every rank's block along ``dim``, in rank order; the backward sums
    the cotangents and keeps this rank's block."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return mesh.all_gather(x.contiguous(), axis, axis=dim)

    @staticmethod
    def backward(ctx, g):
        return _scatter(ctx.mesh, g, ctx.axis, ctx.dim), None, None, None


@dataclasses.dataclass(frozen=True)
class Dist:
    """Distribution context (static).  ``mesh`` is the port's addition: the
    ``launch.mesh.Mesh`` whose groups the collectives use (JAX code finds
    its axes in the enclosing ``shard_map``).  With no model axis, or one
    of a single rank, the model collectives are the identity, as JAX's are
    over a one-device axis."""

    model_axis: str | None = None  # TP axis name (None = single device)
    data_axes: tuple[str, ...] = ()  # batch-sharding axes
    tp: int = 1  # size of model axis
    mesh: Any = None

    def __post_init__(self):
        if self.tp > 1 and (self.model_axis is None or self.mesh is None):
            raise ValueError(f"tp = {self.tp} needs a model axis and a mesh")

    @staticmethod
    def none() -> "Dist":
        return Dist()

    @property
    def distributed(self) -> bool:
        return self.model_axis is not None

    @property
    def _model(self) -> bool:
        return self.model_axis is not None and self.tp > 1

    # -- collectives (identity when single-device) ----------------------
    def psum_model(self, x):
        if not self._model:
            return x
        return _Psum.apply(x, self.mesh, self.model_axis)

    def pmax_model(self, x):
        """Max over the model axis; takes no gradient (detach first)."""
        if not self._model:
            return x
        return self.mesh.pmax(x.detach(), self.model_axis)

    def psum_scatter_model(self, x, axis: int):
        """Combine partial results AND split ``axis`` over the model axis."""
        if not self._model:
            return x
        return _PsumScatter.apply(x, self.mesh, self.model_axis,
                                  axis % x.dim())

    def all_gather_model(self, x, axis: int):
        if not self._model:
            return x
        return _AllGather.apply(x, self.mesh, self.model_axis, axis % x.dim())

    def all_gather_data(self, x, axis: int):
        """Every data rank's block along ``axis``, differentiable (the
        backward psum-scatters the cotangents); the identity over one rank."""
        if not self.data_axes or self.mesh is None or self.mesh.axis_size(
                self.data_axes) == 1:
            return x
        return _AllGather.apply(x, self.mesh, self.data_axes, axis % x.dim())

    def model_index(self) -> int:
        """This rank's coordinate on the model axis (0 without one)."""
        if not self._model:
            return 0
        return self.mesh.axis_index(self.model_axis)


# ---------------------------------------------------------------------------
# initializers (explicit generator threading)
# ---------------------------------------------------------------------------

def gen_device(generator: torch.Generator | None) -> torch.device:
    """The device an initializer draws on: the generator's, or ``meta``
    for ``None`` (shapes and dtypes only, as ``jax.eval_shape`` gives)."""
    return torch.device("meta") if generator is None else generator.device


def _normal(generator: torch.Generator | None, shape) -> torch.Tensor:
    if generator is None:
        return torch.empty(shape, dtype=torch.float32, device="meta")
    return torch.randn(shape, generator=generator, dtype=torch.float32,
                       device=generator.device)


def dense_init(generator: torch.Generator | None, shape, in_dim: int,
               dtype: torch.dtype = torch.float32, scale: float = 1.0):
    std = scale / math.sqrt(in_dim)
    return (_normal(generator, shape) * std).to(dtype)


def embed_init(generator: torch.Generator | None, shape,
               dtype: torch.dtype = torch.float32, std: float = 0.02):
    return (_normal(generator, shape) * std).to(dtype)


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


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5):
    """LayerNorm over the last dim in f32 (biased variance), cast back."""
    dt = x.dtype
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, unbiased=False, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * weight.float() + bias.float()).to(dt)


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


_ACTS = {"relu": F.relu, "gelu": _gelu_tanh, "silu": F.silu,
         "tanh": torch.tanh, "sigmoid": torch.sigmoid}


def act_fn(name: str):
    """The activation JAX's ``act_fn`` names.  ``"gelu"`` is
    ``jax.nn.gelu``, whose default is the tanh approximation (torch's
    default is the erf form)."""
    return _ACTS[name]


def count_params(tree) -> int:
    """Elements in a tree (nested dicts) of tensors."""
    if isinstance(tree, dict):
        return sum(count_params(v) for v in tree.values())
    return tree.numel()


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

