"""The yardstick's arithmetic: FLOPs of a step, the least bytes of a
parameter-server update, and the H100's peaks.

``FlopMode`` is a frozen copy of the FLOP part of ``CostMode`` in
``src/repro_torch/launch/cost_analysis.py``: a ``TorchDispatchMode`` that
counts the matrix products and convolutions of every aten op it sees,
forward and backward, by ``torch.utils.flop_counter``'s formulas
(``2 * prod(out) * prod(contracted)``).  The benchmark runs the
reference's forward and backward under it on meta tensors, once and
without recomputation, so the count is the model's and not the
program's.

``update_bytes`` is the least traffic of one update of the server
optimizer over ``n`` parameters: the K gradient rows read once, at the
wire's dtype (int8 rows carry one f32 scale a chunk), the parameters and
each optimizer slot read and written once, all f32.  It is reckoned from
what the update does, whichever kernels do it.

The peaks are NVIDIA's H100 SXM data sheet's (dense, no sparsity, at the
700 W limit): the products run in f32 with TF32 off, so the f32 rate.
"""
from __future__ import annotations

import torch
from torch.utils import flop_counter
from torch.utils._python_dispatch import TorchDispatchMode

PEAK_F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12

SLOTS = {"sgd": 0, "momentum": 1, "adam": 2, "adamw": 2}


class FlopMode(TorchDispatchMode):
    """Counts the FLOPs of the products dispatched while it is active."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        formula = flop_counter.flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += float(formula(*args, **kwargs, out_val=out))
        return out


def step_flops(loss_fn, params: dict, batch: dict) -> float:
    """FLOPs of one forward and backward of ``loss_fn(params, batch)``
    (meta tensors are enough: nothing is computed)."""
    flat = [t for t in _leaves(params)]
    tracked = [t.detach().requires_grad_(True) for t in flat]
    it = iter(tracked)
    tree = _rebuild(params, it)
    with FlopMode() as mode:
        loss = loss_fn(tree, batch)
        torch.autograd.grad(loss, tracked)
    return mode.flops


def _leaves(tree):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k])
        else:
            yield tree[k]


def _rebuild(tree, it):
    return {k: (_rebuild(tree[k], it) if isinstance(tree[k], dict)
                else next(it)) for k in sorted(tree)}


def update_bytes(n: int, workers: int, optimizer: str, codec: str,
                 chunk_elems: int) -> int:
    """The least bytes of one server update over ``n`` parameters."""
    if codec == "none":
        row = 4 * n
    elif codec == "int8":
        row = n + 4 * -(-n // chunk_elems)
    elif codec == "bf16":
        row = 2 * n
    else:
        raise ValueError(f"unknown codec {codec!r}")
    return workers * row + 2 * 4 * n * (1 + SLOTS[optimizer])
