"""Optimizers as pure chunk-wise update rules (torch counterpart of
``repro/optim/optimizers.py``).

The PS applies the optimizer at the server, per chunk, right after
aggregation (PHub's fused "aggregator + optimizer").  Every optimizer is a
flat-tensor update rule

    new_param, new_state = apply_update(spec, param, grad, state, step)

where ``state`` is a tuple of 0..2 f32 tensors shaped like the param slab.
All math is f32 at the server, whatever the model's compute dtype.

``apply_update`` is the oracle the fused kernel is held against
(``kernels/fused_agg_opt/ref.py`` delegates here).  Python-float
hyperparameters meet f32 tensors the way JAX's weak-typed constants do:
each is rounded to f32 and the op runs in f32.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class OptimizerSpec:
    """Static description of a server-side optimizer."""

    name: str  # 'sgd' | 'momentum' | 'adam' | 'adamw'
    lr: float = 1e-3
    momentum: float = 0.9
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    nesterov: bool = False

    @property
    def num_state_slots(self) -> int:
        return {"sgd": 0, "momentum": 1, "adam": 2, "adamw": 2}[self.name]


def sgd(lr: float = 1e-3, weight_decay: float = 0.0) -> OptimizerSpec:
    return OptimizerSpec(name="sgd", lr=lr, weight_decay=weight_decay)


def momentum(
    lr: float = 1e-3,
    mu: float = 0.9,
    weight_decay: float = 0.0,
    nesterov: bool = False,
) -> OptimizerSpec:
    return OptimizerSpec(
        name="momentum", lr=lr, momentum=mu, weight_decay=weight_decay,
        nesterov=nesterov,
    )


def adam(
    lr: float = 1e-3, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8
) -> OptimizerSpec:
    return OptimizerSpec(name="adam", lr=lr, beta1=b1, beta2=b2, eps=eps)


def adamw(
    lr: float = 1e-3,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.01,
) -> OptimizerSpec:
    return OptimizerSpec(
        name="adamw", lr=lr, beta1=b1, beta2=b2, eps=eps,
        weight_decay=weight_decay,
    )


def init_opt_state(spec: OptimizerSpec, param_like: torch.Tensor) -> tuple:
    """State slots for a flat param slab (all f32, same shape and device)."""
    return tuple(
        torch.zeros(param_like.shape, dtype=torch.float32,
                    device=param_like.device)
        for _ in range(spec.num_state_slots)
    )


def step_tensor(step: int, device) -> torch.Tensor:
    """The 1-based step as an f32 scalar on ``device``.  ``torch.full``
    launches a fill kernel: no host-to-device copy, so no sync."""
    return torch.full((), float(step), dtype=torch.float32, device=device)


def apply_update(
    spec: OptimizerSpec,
    param: torch.Tensor,
    grad: torch.Tensor,
    state: tuple,
    step: int,
    lr_scale: float = 1.0,
) -> tuple[torch.Tensor, tuple]:
    """Plain-torch update rule.  ``step`` is the 1-based step count (it
    drives Adam's bias correction)."""
    p = param.float()
    g = grad.float()
    lr = spec.lr * lr_scale
    if spec.name == "sgd":
        if spec.weight_decay:
            g = g + spec.weight_decay * p
        return (p - lr * g).to(param.dtype), ()
    if spec.name == "momentum":
        (m,) = state
        if spec.weight_decay:
            g = g + spec.weight_decay * p
        m = spec.momentum * m + g
        upd = g + spec.momentum * m if spec.nesterov else m
        return (p - lr * upd).to(param.dtype), (m,)
    if spec.name in ("adam", "adamw"):
        m, v = state
        if spec.name == "adam" and spec.weight_decay:
            g = g + spec.weight_decay * p
        m = spec.beta1 * m + (1.0 - spec.beta1) * g
        v = spec.beta2 * v + (1.0 - spec.beta2) * g * g
        t = step_tensor(step, p.device)
        mhat = m / (1.0 - spec.beta1**t)
        vhat = v / (1.0 - spec.beta2**t)
        upd = mhat / (torch.sqrt(vhat) + spec.eps)
        if spec.name == "adamw" and spec.weight_decay:
            upd = upd + spec.weight_decay * p
        return (p - lr * upd).to(param.dtype), (m, v)
    raise ValueError(f"unknown optimizer {spec.name}")
