"""The comparison that decides ``correct`` for a training cell.

Four numbers, each a gap between the program's reading and the
reference's over the cell's first steps:

``loss_gap``    the largest ``|loss_p - loss_r| / |loss_r|`` over every
                step and worker;
``step1_loss_gap``  the same over step 1 alone, where both sides start
                from the same parameters (steady from seed to seed where
                the later steps are not: under an int8 wire or Adam the
                first update magnifies rounding);
``grad_gap``    the worst leaf of the gradient the optimizer got at step 1:
                ``|norm_p - norm_r|`` over the larger of the reference's
                norm of that leaf and its median leaf's norm;
``change_gap``  the same for the change of the parameters over the steps,
                leaving out the leaves whose reference gradient norm is
                under ``ZERO_GRAD`` of the median leaf's: such a leaf (a
                bias that a normalisation cancels) moves by round-off
                alone, and under Adam round-off moves it a whole step.

A cell compares the numbers that its ``limits/<workload>.json`` names,
each against a limit of its own; a run is correct when every one is
finite and within its limit.
"""
from __future__ import annotations

import math
import statistics

import torch

from portbench.yardstick.inputs import leaves

NUMBERS = ("loss_gap", "step1_loss_gap", "grad_gap", "change_gap")
ZERO_GRAD = 1e-3


def _norms(tree: dict) -> dict:
    return {p: float(torch.linalg.vector_norm(t.double()))
            for p, t in leaves(tree)}


def _leaf_gaps(prog: dict, ref: dict, keep=None) -> dict:
    np_, nr = _norms(prog), _norms(ref)
    if set(np_) != set(nr):
        return {"?": math.inf}
    keys = [k for k in nr if keep is None or k in keep]
    med = statistics.median(nr[k] for k in keys)
    return {k: abs(np_[k] - nr[k]) / max(nr[k], med, 1e-30) for k in keys}


def _worst_leaf(prog: dict, ref: dict, keep=None) -> float:
    return max(_leaf_gaps(prog, ref, keep).values())


def detail(prog: dict, ref: dict) -> dict:
    """Where the gaps come from: each step's worst loss gap and the three
    worst leaves of each norm gap (``calibrate.py``'s look)."""
    gnorm = _norms(ref["first_grad"])
    med = statistics.median(gnorm.values())
    keep = {k for k, v in gnorm.items() if v >= ZERO_GRAD * med}

    def worst(gaps):
        top = sorted(gaps.items(), key=lambda kv: -kv[1])[:3]
        return [["/".join(map(str, k)), v] for k, v in top]

    return {
        "loss_by_step": [max(abs(a - b) / max(abs(b), 1e-30)
                             for a, b in zip(rp, rr))
                         for rp, rr in zip(prog["losses"], ref["losses"])],
        "grad_worst": worst(_leaf_gaps(prog["first_grad"], ref["first_grad"])),
        "change_worst": worst(_leaf_gaps(prog["change"], ref["change"], keep)),
        "left_out": len(gnorm) - len(keep)}


def numbers(prog: dict, ref: dict) -> dict:
    """The gaps of ``prog`` against ``ref`` (each a dict with
    ``losses``, ``first_grad`` and ``change``, as
    ``reference.train.first_steps`` returns them)."""
    def gap(rows_p, rows_r):
        lp = [x for row in rows_p for x in row]
        lr = [x for row in rows_r for x in row]
        if len(lp) != len(lr) or not lp:
            return math.inf
        return max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(lp, lr))

    gnorm = _norms(ref["first_grad"])
    med = statistics.median(gnorm.values())
    keep = {k for k, v in gnorm.items() if v >= ZERO_GRAD * med}
    out = {"loss_gap": gap(prog["losses"], ref["losses"]),
           "step1_loss_gap": gap(prog["losses"][:1], ref["losses"][:1]),
           "grad_gap": _worst_leaf(prog["first_grad"], ref["first_grad"]),
           "change_gap": _worst_leaf(prog["change"], ref["change"], keep)}
    return {k: (v if math.isfinite(v) else math.inf) for k, v in out.items()}


def judge(values: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value": v, "limit": l}}) for the numbers that
    ``limits`` names, in ``NUMBERS`` order."""
    if not limits or set(limits) - set(NUMBERS):
        raise ValueError(f"limits name {sorted(limits)}, known: {NUMBERS}")
    checks = {k: {"value": values[k], "limit": limits[k]} for k in NUMBERS
              if k in limits}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
