"""Where the port runs: the card unless the caller asks for the CPU.

Every entry point of the port that creates tensors takes ``device=None``
and resolves it here.  ``None`` means the CUDA card; with no card present
that raises instead of falling back, so a run that meant to measure the
card can never quietly measure the CPU.  Tests pass ``device="cpu"``.
"""
from __future__ import annotations

import torch


def resolve_device(device: torch.device | str | None = None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` is the CUDA card."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)
