"""What the drivers share: the program's optimizer from a traffic file,
the gradient read back from the optimizer's state, and the ranges that a
traced run puts around the calls into each layer."""
from __future__ import annotations

import contextlib

import torch


def optimizer_spec(opt: dict):
    """The program's ``OptimizerSpec`` for a traffic file's optimizer."""
    from repro_torch.optim import optimizers as O

    if opt["name"] == "momentum":
        return O.momentum(opt["lr"], opt["mu"])
    if opt["name"] == "adamw":
        return O.adamw(opt["lr"], opt["b1"], opt["b2"], opt["eps"],
                       opt["weight_decay"])
    raise ValueError(f"unknown optimizer {opt['name']!r}")


def grad_from_state(opt: dict, m: torch.Tensor) -> torch.Tensor:
    """The gradient of step 1 from the first slot after it: momentum
    keeps it whole, Adam keeps ``(1 - beta1)`` of it."""
    if opt["name"] == "momentum":
        return m
    if opt["name"] == "adamw":
        return m / (1 - opt["b1"])
    raise ValueError(f"unknown optimizer {opt['name']!r}")


@contextlib.contextmanager
def ranged(name: str, on: bool):
    """A ``record_function`` range named ``name`` where ``on`` (a traced
    run's ranged stretch); an untraced run opens no range."""
    if not on:
        yield
        return
    with torch.profiler.record_function(name):
        yield


@contextlib.contextmanager
def wrap_attr(obj, attr: str, name: str):
    """``obj.attr`` called inside a range named ``name`` for the block (set
    on the instance, frozen dataclasses included, and restored)."""
    real = getattr(obj, attr)
    own = attr in vars(obj)

    def wrapped(*args, **kwargs):
        with torch.profiler.record_function(name):
            return real(*args, **kwargs)

    object.__setattr__(obj, attr, wrapped)
    try:
        yield
    finally:
        if own:
            object.__setattr__(obj, attr, real)
        else:
            object.__delattr__(obj, attr)
