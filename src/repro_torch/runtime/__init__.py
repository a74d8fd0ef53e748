"""The port's runtime tier (torch counterpart of ``repro.runtime``): the
SPMD PS train step, the closed-loop autoscaler, the straggler loop,
elastic recovery and the sparse push helpers."""
from repro_torch.runtime.autoscaler import (
    Autoscaler,
    AutoscalerPolicy,
    ScaleEvent,
)
from repro_torch.runtime.trainer import (
    TrainState,
    apply_grad_sync,
    init_train_state,
    make_ps_train_step,
)

__all__ = [
    "TrainState",
    "make_ps_train_step",
    "init_train_state",
    "apply_grad_sync",
    "Autoscaler",
    "AutoscalerPolicy",
    "ScaleEvent",
]
