"""Server-side optimizers as flat update rules, their tree-wise wrapper
and the learning-rate schedules (torch counterpart of ``repro.optim``)."""
from repro_torch.optim.optimizers import (
    OptimizerSpec,
    adam,
    adamw,
    apply_update,
    init_opt_state,
    make_optimizer,
    momentum,
    sgd,
)
from repro_torch.optim.schedules import (
    constant_schedule,
    cosine_schedule,
    linear_warmup,
    warmup_cosine_schedule,
)

__all__ = [
    "OptimizerSpec",
    "sgd",
    "momentum",
    "adam",
    "adamw",
    "init_opt_state",
    "apply_update",
    "make_optimizer",
    "constant_schedule",
    "cosine_schedule",
    "warmup_cosine_schedule",
    "linear_warmup",
]
