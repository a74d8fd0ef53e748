"""Validated entry point of the channels-last copy.

``to_channels_last(t)`` returns a 4-D f32 tensor's values in channels-last
memory (``t`` itself where they are already).  Dispatch is on the device
alone: CUDA tensors take the kernel (``kernel.to_channels_last_cuda``; a
failed build or launch raises, nothing falls back), CPU tensors the plain
version; any other device is refused.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.layout import kernel as _kernel


def to_channels_last(t: torch.Tensor) -> torch.Tensor:
    if t.dim() != 4:
        raise ValueError(f"expected a 4-D tensor, got shape {tuple(t.shape)}")
    if t.dtype != torch.float32:
        raise ValueError(f"to_channels_last wants f32, got {t.dtype}")
    if t.device.type == "cuda":
        return _kernel.to_channels_last_cuda(t)
    if t.device.type != "cpu":
        raise ValueError(f"to_channels_last runs on cuda or cpu, not "
                         f"{t.device.type}")
    return _kernel.to_channels_last_torch(t)
