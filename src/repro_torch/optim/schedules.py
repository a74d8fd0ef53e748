"""Learning-rate schedules, pure functions of the step counter (torch
counterpart of ``repro/optim/schedules.py``).

Each schedule maps a step (an int or a 0-d tensor) to a 0-d f32 tensor,
as the JAX schedules return f32 arrays; the result lives on the step's
device when the step is a tensor, else on the CPU.  Where the JAX package
divides, the port divides by an f32 tensor: torch on the card turns a
division by a Python scalar into a product with its f32 reciprocal, one
ulp off a true division.
"""
from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step.to(torch.float32)
    return torch.tensor(step, dtype=torch.float32)


def _scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.float32, device=like.device)


def constant_schedule(value: float = 1.0):
    def fn(step):
        device = step.device if isinstance(step, torch.Tensor) else None
        return torch.tensor(value, dtype=torch.float32, device=device)

    return fn


def linear_warmup(warmup_steps: int, peak: float = 1.0):
    def fn(step):
        s = _f32(step)
        frac = torch.clamp(s / _scalar(max(warmup_steps, 1), s), max=1.0)
        return peak * frac

    return fn


def cosine_schedule(total_steps: int, final_frac: float = 0.1,
                    peak: float = 1.0):
    def fn(step):
        s = torch.clamp(_f32(step), 0, total_steps)
        # cos in f64, rounded once to f32: XLA's f32 cos is correctly
        # rounded where torch's f32 cos can be one ulp off
        x = math.pi * s / _scalar(total_steps, s)
        cos = 0.5 * (1.0 + torch.cos(x.double()).float())
        return peak * (final_frac + (1.0 - final_frac) * cos)

    return fn


def warmup_cosine_schedule(warmup_steps: int, total_steps: int,
                           final_frac: float = 0.1, peak: float = 1.0):
    warm = linear_warmup(warmup_steps, peak)
    cos = cosine_schedule(max(total_steps - warmup_steps, 1), final_frac, peak)

    def fn(step):
        s = _f32(step)
        return torch.where(s < warmup_steps, warm(s), cos(s - warmup_steps))

    return fn
