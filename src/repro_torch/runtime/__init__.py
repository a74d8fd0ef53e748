"""The port's runtime tier (torch counterpart of ``repro.runtime``): the
closed-loop autoscaler, the straggler loop, elastic recovery and the
sparse push helpers."""
from repro_torch.runtime.autoscaler import (
    Autoscaler,
    AutoscalerPolicy,
    ScaleEvent,
)

__all__ = [
    "Autoscaler",
    "AutoscalerPolicy",
    "ScaleEvent",
]
