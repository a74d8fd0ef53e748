"""Plain-torch oracle of the fused GroupNorm: the function written out,
as the JAX package's ``_gn`` writes it (``repro/models/resnet.py``).

``y = (x - mean) * rsqrt(var + eps) * s + b``, with mean and the biased
variance over each sample's group of ``C / groups`` contiguous channels
and every pixel; then ``+ residual`` where given, then ``relu`` where
asked.  NCHW-shaped ``x`` in any memory layout.
"""
from __future__ import annotations

import torch

EPS = 1e-5


def group_norm_act_ref(x: torch.Tensor, s: torch.Tensor, b: torch.Tensor,
                       groups: int, relu: bool,
                       residual: torch.Tensor | None = None) -> torch.Tensor:
    n, c, h, w = x.shape
    xg = x.reshape(n, groups, c // groups, h, w)
    mean = xg.mean(dim=(2, 3, 4), keepdim=True)
    var = ((xg - mean) ** 2).mean(dim=(2, 3, 4), keepdim=True)
    y = ((xg - mean) * torch.rsqrt(var + EPS)).reshape(n, c, h, w)
    y = y * s[:, None, None] + b[:, None, None]
    if residual is not None:
        y = y + residual
    return torch.relu(y) if relu else y
