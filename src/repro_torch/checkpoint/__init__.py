"""Checkpointing of the port's fabric (torch counterpart of
``repro.checkpoint``)."""
from repro_torch.checkpoint.checkpointer import (
    Checkpointer,
    fabric_snapshot_to_flat,
    flat_to_fabric_snapshot,
)

__all__ = [
    "Checkpointer",
    "fabric_snapshot_to_flat",
    "flat_to_fabric_snapshot",
]
