"""Public entry point of the fused aggregate+optimize kernel (torch
counterpart of ``repro/kernels/fused_agg_opt/ops.py``).

``fused_aggregate_update`` validates its operands (the K gradient rows as
a (K, N) tensor or as a sequence of rows, ``None`` for a zero row,
optionally read through a chunk-id table), builds the scalar packet on
the operands' device, and dispatches:

  * CUDA tensors launch the CUDA kernel (``kernel.fused_agg_opt_cuda``),
    which updates ``param`` and the state slots in place — a failed build
    or launch raises, nothing falls back;
  * CPU tensors take the kernel's plain version
    (``kernel.fused_agg_opt_torch``), bit-identical to it;
  * meta tensors inside a dry run (an active ``launch/cost_analysis``
    mode: ``launch/dryrun.py``) compute nothing: the launch is charged as
    one kernel call (its operands and outputs once) and the outputs are
    ``param`` and the state, as the card's are.  Outside one, meta
    tensors are refused like any other device.

The JAX wrapper's ``use_pallas=False`` has no counterpart: a caller that
wants the oracle calls ``ref.fused_aggregate_update_ref`` itself.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.launch.cost_analysis import charging, record_kernel
from repro_torch.kernels.fused_agg_opt import kernel as _kernel
from repro_torch.optim.optimizers import OptimizerSpec, step_tensor


def scalar_packet(spec: OptimizerSpec, step: int, lr_scale: float = 1.0, *,
                  device: torch.device | str | None = None) -> torch.Tensor:
    """The (1, 4) f32 scalar operand ``[lr_t, bc1, bc2, tok]``, on ``device``.

    ``lr_t`` is the scheduled learning rate (``spec.lr * lr_scale``, in
    f32 when ``lr_scale`` is a schedule's 0-d tensor, as JAX's traced
    scale is);
    ``bc1``/``bc2`` are Adam's bias corrections ``1/(1-beta^t)`` for
    1-based ``step`` (1.0 for stateless/momentum optimizers).  ``tok`` is
    the JAX package's fence token, always ``0.0``; it rides along so the
    packet has the same layout in both packages.  Every value is computed
    on ``device`` by fill and elementwise kernels, so building the packet
    never waits for the card."""
    device = resolve_device(device)
    t = step_tensor(step, device)
    if isinstance(lr_scale, torch.Tensor):  # a schedule's f32 scalar
        lr_t = spec.lr * lr_scale.to(device=device, dtype=torch.float32)
    else:
        lr_t = torch.full((), spec.lr * lr_scale, dtype=torch.float32,
                          device=device)
    if spec.num_state_slots == 2:
        bc1 = torch.reciprocal(1.0 - spec.beta1**t)
        bc2 = torch.reciprocal(1.0 - spec.beta2**t)
    else:
        bc1 = bc2 = torch.ones((), dtype=torch.float32, device=device)
    tok = t * 0.0
    return torch.stack([lr_t, bc1, bc2, tok]).reshape(1, 4)


def _validate(grads, param, state, spec: OptimizerSpec,
              chunk_ids: torch.Tensor | None) -> None:
    if spec.name not in ("sgd", "momentum", "adam", "adamw"):
        raise ValueError(f"unknown optimizer {spec.name}")
    if isinstance(grads, torch.Tensor) and (grads.dim() != 2
                                            or grads.shape[0] < 1):
        raise ValueError(
            f"grads must be (K, N) with K >= 1, got {tuple(grads.shape)}")
    if param.dim() != 1:
        raise ValueError(f"param must be (N,), got {tuple(param.shape)}")
    _kernel.check_rows(_kernel.gradient_rows(grads), param, chunk_ids)
    n = param.shape[0]
    if len(state) != spec.num_state_slots:
        raise ValueError(
            f"{spec.name} takes {spec.num_state_slots} state slots, got "
            f"{len(state)}")
    for s in state:
        if tuple(s.shape) != (n,) or s.dtype != torch.float32:
            raise ValueError(
                f"state slots must be ({n},) f32, got {tuple(s.shape)} {s.dtype}")


def fused_aggregate_update(
    grads,  # (K, N) worker slabs, or K rows (None for a zero row)
    param: torch.Tensor,  # (N,)
    state: tuple,  # opt state slots
    spec: OptimizerSpec,
    step: int | torch.Tensor,  # 1-based
    lr_scale: float | torch.Tensor = 1.0,
    *,
    average: bool = True,
    chunk_ids: torch.Tensor | None = None,
    grad_scale: float | None = None,
) -> tuple[torch.Tensor, tuple]:
    """Aggregate K worker gradient slabs and apply the server optimizer.

    Sums the rows in f32 in ascending worker order (a ``None`` row is a
    zero row), multiplies by ``grad_scale`` rounded to the rows' dtype when
    one is given, averages by 1/K when ``average``, then applies ``spec``
    at ``step`` with ``lr_scale`` folded into the rate.  With
    ``chunk_ids`` each row is a worker's whole (num_chunks, chunk_elems)
    push, read at the shard's chunks.  Returns (new_param, new_state).  On
    the card the kernel reads the rows where they lie, updates ``param``
    and ``state`` in place and returns them; callers use the returned
    tensors either way."""
    _validate(grads, param, state, spec, chunk_ids)
    if param.device.type == "meta" and charging():
        rows = [r for r in _kernel.gradient_rows(grads) if r is not None]
        record_kernel("fused_agg_opt", [*rows, param, *state],
                      [param, *state])
        return param, tuple(state)
    scalars = scalar_packet(spec, step, lr_scale, device=param.device)
    kw = dict(average=average, chunk_ids=chunk_ids, grad_scale=grad_scale)
    if param.device.type == "cuda":
        return _kernel.fused_agg_opt_cuda(grads, param, state, scalars, spec,
                                          **kw)
    if param.device.type == "cpu":
        return _kernel.fused_agg_opt_torch(grads, param, state, scalars, spec,
                                           **kw)
    raise ValueError(
        f"fused_aggregate_update runs on cuda or cpu, not {param.device.type}")
