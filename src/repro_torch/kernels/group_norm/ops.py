"""Validated, differentiable entry point of the fused GroupNorm.

``group_norm_act(x, s, b, groups, relu=..., residual=None)`` is
``relu(GroupNorm(x) * s + b [+ residual])`` (``relu=False`` leaves the
ReLU out) for an NCHW f32 ``x``: groups of ``C / groups`` contiguous
channels, biased variance, eps 1e-5, as ``F.group_norm``.

Validation lives here: ``x`` is 4-D f32, ``s`` and ``b`` are ``(C,)``,
``groups`` divides ``C``, a residual has ``x``'s shape, dtype and device.  Then dispatch is
on the device alone:

  * CUDA tensors run ``kernel.group_norm_act_*_cuda`` through one
    ``torch.autograd.Function``.  The forward's output equals
    ``F.relu(residual + F.group_norm(x, ...))`` bit for bit; it saves ``x``,
    the output (whose sign is the ReLU's mask) and the per-(sample, group)
    mean and rstd, and the backward kernels return the gradients of ``x``,
    ``s``, ``b`` and the residual in one pass.  A failed build or launch
    raises, nothing falls back;
  * tensors on any other device (the CPU; the meta tensors of a dry run)
    take the plain version (``kernel.group_norm_act_torch``),
    differentiated by autograd.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.group_norm import kernel as _kernel


class _GroupNormAct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, s, b, residual, groups, relu):
        y, x, mean, rstd = _kernel.group_norm_act_fwd_cuda(
            x, s, b, residual, groups, relu)
        ctx.groups, ctx.residual = groups, residual is not None
        ctx.save_for_backward(x, s, mean, rstd, y if relu else None)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, s, mean, rstd, y = ctx.saved_tensors
        dx, ds, db, dr = _kernel.group_norm_act_bwd_cuda(
            dy, y, x, s, mean, rstd, ctx.groups, ctx.residual)
        return dx, ds, db, dr, None, None


def group_norm_act(x: torch.Tensor, s: torch.Tensor, b: torch.Tensor,
                   groups: int, *, relu: bool,
                   residual: torch.Tensor | None = None) -> torch.Tensor:
    """``relu(GroupNorm(x) * s + b [+ residual])`` of NCHW f32 ``x``."""
    if x.dim() != 4:
        raise ValueError(f"expected (N, C, H, W), got shape {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise ValueError(f"group_norm_act wants f32 input, got {x.dtype}")
    c = x.shape[1]
    if groups <= 0 or c % groups:
        raise ValueError(f"{groups} groups do not divide {c} channels")
    for name, t in (("s", s), ("b", b)):
        if tuple(t.shape) != (c,):
            raise ValueError(f"{name} must have shape ({c},), got "
                             f"{tuple(t.shape)}")
    if residual is not None and (residual.shape != x.shape
                                 or residual.dtype != x.dtype
                                 or residual.device != x.device):
        raise ValueError(f"residual ({tuple(residual.shape)}, "
                         f"{residual.dtype}, {residual.device}) does not "
                         f"match x ({tuple(x.shape)}, {x.dtype}, {x.device})")
    if x.is_cuda:
        return _GroupNormAct.apply(x, s, b, residual, groups, relu)
    return _kernel.group_norm_act_torch(x, s, b, groups, relu, residual)
