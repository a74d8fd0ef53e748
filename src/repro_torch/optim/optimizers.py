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
from typing import Callable

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


def step_tensor(step: int | torch.Tensor, device) -> torch.Tensor:
    """The 1-based step as an f32 scalar on ``device``.  For an int,
    ``torch.full`` launches a fill kernel: no host-to-device copy, so no
    sync; a step tensor (``make_optimizer``'s int32 counter) is cast."""
    if isinstance(step, torch.Tensor):
        return step.to(device=device, dtype=torch.float32)
    return torch.full((), float(step), dtype=torch.float32, device=device)


def apply_update(
    spec: OptimizerSpec,
    param: torch.Tensor,
    grad: torch.Tensor,
    state: tuple,
    step: int | torch.Tensor,
    lr_scale: float | torch.Tensor = 1.0,
) -> tuple[torch.Tensor, tuple]:
    """Plain-torch update rule.  ``step`` is the 1-based step count (it
    drives Adam's bias correction); ``lr_scale`` may be a schedule's 0-d
    f32 tensor."""
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
        # the correctly rounded f32 square root (XLA's): torch.sqrt on the
        # CPU is off by an ulp on some inputs, the f64 root rounded to f32
        # is exact on every device
        upd = mhat / (torch.sqrt(vhat.double()).float() + spec.eps)
        if spec.name == "adamw" and spec.weight_decay:
            upd = upd + spec.weight_decay * p
        return (p - lr * upd).to(param.dtype), (m, v)
    raise ValueError(f"unknown optimizer {spec.name}")


# ---------------------------------------------------------------------------
# tree-wise wrapper (for the non-PS baseline path and generic loops)
# ---------------------------------------------------------------------------
def _tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of nested dicts of tensors (``rest`` are
    trees of the same structure)."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def make_optimizer(spec: OptimizerSpec, lr_schedule: Callable | None = None):
    """Returns ``(init_fn, update_fn)`` over parameter trees (nested dicts
    of tensors).

    ``update_fn(params, grads, state) -> (new_params, new_state)``;
    ``state`` is ``{"step": int32 0-d tensor, "slots": tuple of trees}``
    with f32 slots shaped like the params, as in the JAX package.  Each
    leaf goes through ``apply_update`` with the incremented step and, when
    given, ``lr_schedule(step)`` as its learning-rate scale."""

    def init_fn(params: dict) -> dict:
        slots = tuple(
            _tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device), params)
            for _ in range(spec.num_state_slots)
        )
        leaves: list = []
        _tree_map(leaves.append, params)
        device = leaves[0].device if leaves else None
        return {"step": torch.zeros((), dtype=torch.int32, device=device),
                "slots": slots}

    def update_fn(params: dict, grads: dict, state: dict):
        step = state["step"] + 1
        lr_scale = lr_schedule(step) if lr_schedule is not None else 1.0
        out = _tree_map(
            lambda p, g, *s: apply_update(spec, p, g, s, step, lr_scale),
            params, grads, *state["slots"])
        new_params = _tree_map(lambda r: r[0], out)
        slots = tuple(_tree_map(lambda r, k=k: r[1][k], out)
                      for k in range(spec.num_state_slots))
        return new_params, {"step": step, "slots": slots}

    return init_fn, update_fn
