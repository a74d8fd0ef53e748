"""Plain-torch oracle of ``to_channels_last``: the same values, shape and
dtype, in channels-last memory."""
from __future__ import annotations

import torch


def to_channels_last_ref(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous(memory_format=torch.channels_last)
