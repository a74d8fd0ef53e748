"""Checkpointing of the port's fabric and SPMD trainer (torch counterpart
of ``repro.checkpoint``)."""
from repro_torch.checkpoint.checkpointer import (
    Checkpointer,
    fabric_snapshot_to_flat,
    flat_to_fabric_snapshot,
    flat_to_train_state,
    train_state_to_flat,
)

__all__ = [
    "Checkpointer",
    "fabric_snapshot_to_flat",
    "flat_to_fabric_snapshot",
    "flat_to_train_state",
    "train_state_to_flat",
]
