"""Plain-torch oracle for the fused aggregate+optimize kernel (torch
counterpart of ``repro/kernels/fused_agg_opt/ref.py``).

Semantics: given K worker gradient slabs for the chunks a PS shard owns,
sum them in f32, average by 1/K (sync SGD), then apply the server-side
optimizer.  This is ``apply_update`` on the averaged sum: the oracle the
kernel is held against at tolerance.  The kernel's own op order (``* 1/K``,
``m * bc1``, ...) is followed bit for bit by ``kernel.fused_agg_opt_torch``
instead.
"""
from __future__ import annotations

import torch

from repro_torch.optim.optimizers import OptimizerSpec, apply_update


def fused_aggregate_update_ref(
    grads: torch.Tensor,  # (K, N) worker gradient slabs, any float dtype
    param: torch.Tensor,  # (N,) parameters
    state: tuple,  # optimizer state slots, each (N,) f32
    spec: OptimizerSpec,
    step: int,  # 1-based
    lr_scale: float = 1.0,
    average: bool = True,
) -> tuple[torch.Tensor, tuple]:
    """Oracle for the fused kernel: f32 sum, optional 1/K, then optimizer."""
    agg = torch.sum(grads.float(), dim=0)
    if average:
        agg = agg / grads.shape[0]
    return apply_update(spec, param, agg, state, step, lr_scale)
