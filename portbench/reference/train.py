"""The reference's training: the first steps of a cell, in plain PyTorch.

It takes the benchmark's inputs (the seed's initial weights and
batches) and works out again everything the program derives from them:
the gradients (``loss`` of a ``reference`` model and autograd), the flat
chunked space the parameter server sums over, the int8 wire codec with
its error feedback, the K-way mean and the server optimizer.  Nothing of
the program is imported.

The flat space: the leaves in sorted-key order, depth first, each
flattened, one after another, zero-padded to a whole number of
``chunk_elems`` chunks.  The int8 codec, per chunk of that space: the
scale is ``amax / 127`` (1 where ``amax`` is 0), the payload
``clamp(round_half_even(x / scale), -127, 127)``, the decode
``payload * scale``; the sender adds its residual before encoding and
keeps ``slab - decode`` as the next residual.
"""
from __future__ import annotations

import math

import torch

from portbench.yardstick.inputs import build_tree, leaves


class Layout:
    """The flat chunked space of a parameter tree."""

    def __init__(self, tree: dict, chunk_elems: int):
        self.paths = [p for p, _ in leaves(tree)]
        self.shapes = [tuple(t.shape) for _, t in leaves(tree)]
        self.sizes = [math.prod(s) for s in self.shapes]
        self.payload = sum(self.sizes)
        self.chunk_elems = chunk_elems
        self.flat = -(-self.payload // chunk_elems) * chunk_elems

    def flatten(self, tree: dict) -> torch.Tensor:
        parts = [t.reshape(-1) for _, t in leaves(tree)]
        flat = torch.cat(parts)
        return torch.cat([flat, flat.new_zeros(self.flat - self.payload)])

    def unflatten(self, flat: torch.Tensor) -> dict:
        parts = torch.split(flat[:self.payload], self.sizes)
        return build_tree((p, t.view(s)) for p, t, s in
                          zip(self.paths, parts, self.shapes))


def int8_roundtrip(x: torch.Tensor, chunk_elems: int) -> torch.Tensor:
    """The decode of the int8 encode of ``x`` (flat, f32), per chunk."""
    xc = x.reshape(-1, chunk_elems)
    amax = xc.abs().amax(dim=1)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(xc / scale[:, None]), -127, 127)
    return (q * scale[:, None]).reshape(-1)


def optimizer_step(opt: dict, p, g, state: dict, t: int):
    """One step of ``opt`` (momentum or AdamW, as the traffic file names
    it) on flat f32 tensors; ``state`` is updated in place."""
    if opt["name"] == "momentum":
        m = state.get("m", torch.zeros_like(p))
        m = opt["mu"] * m + g
        state["m"] = m
        return p - opt["lr"] * m
    if opt["name"] == "adamw":
        b1, b2 = opt["b1"], opt["b2"]
        m = b1 * state.get("m", torch.zeros_like(p)) + (1 - b1) * g
        v = b2 * state.get("v", torch.zeros_like(p)) + (1 - b2) * g * g
        state["m"], state["v"] = m, v
        mhat = m / (1 - b1 ** t)
        vhat = v / (1 - b2 ** t)
        upd = mhat / (torch.sqrt(vhat) + opt["eps"]) + opt["weight_decay"] * p
        return p - opt["lr"] * upd
    raise ValueError(f"unknown optimizer {opt['name']!r}")


def first_steps(loss_fn, params0: dict, batches, opt: dict, *, steps: int,
                codec: str = "none", chunk_elems: int = 8192) -> dict:
    """``steps`` synchronous steps from ``params0``: at step ``s`` worker
    ``w`` takes ``batches[w][s - 1]``, every worker's gradient crosses the
    codec, the server takes their mean and applies ``opt``.

    Returns the loss of each step and worker (``losses[s][w]``), the
    gradient the optimizer got at step 1 and the change of the parameters
    after the last step, each a tree of host tensors."""
    layout = Layout(params0, chunk_elems)
    p0 = layout.flatten(params0).detach().float()
    p = p0.clone()
    workers = len(batches)
    residual = [torch.zeros_like(p) for _ in range(workers)]
    state: dict = {}
    losses, first_grad = [], None
    for s in range(1, steps + 1):
        total, row = None, []
        for w in range(workers):
            leaf = p.detach().requires_grad_(True)
            lv = loss_fn(layout.unflatten(leaf), batches[w][s - 1])
            (g,) = torch.autograd.grad(lv, leaf)
            row.append(float(lv.detach()))
            if codec == "int8":
                slab = g + residual[w]
                g = int8_roundtrip(slab, chunk_elems)
                residual[w] = slab - g
            elif codec != "none":
                raise ValueError(f"unknown codec {codec!r}")
            total = g if total is None else total + g
        g = total / workers
        if s == 1:
            first_grad = g.cpu()
        p = optimizer_step(opt, p, g, state, s).detach()
        losses.append(row)
    return {"losses": losses,
            "first_grad": layout.unflatten(first_grad),
            "change": layout.unflatten((p - p0).cpu())}
