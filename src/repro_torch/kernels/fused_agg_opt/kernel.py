"""The fused aggregate+optimize kernel: CUDA wrapper and plain version.

Torch counterpart of ``repro/kernels/fused_agg_opt/kernel.py``, whose
Pallas TPU kernel ``fused_agg_opt_pallas`` this replaces.  Two functions
with one contract:

``fused_agg_opt_cuda``   launches ``csrc/fused_agg_opt.cu`` (built at first
                         use by ``kernels/_build.py``) on the current CUDA
                         stream.  It updates ``param`` and the state slots
                         IN PLACE and returns them.
``fused_agg_opt_torch``  the kernel's plain PyTorch version: eager ops in
                         the TPU kernel's exact op sequence.  Eager torch
                         rounds every op, which is the strict
                         multiply-then-add the TPU kernel forces with its
                         ``fence``, so this equals the Pallas kernel (and
                         the CUDA kernel) bit for bit.  It returns new
                         tensors.

Both take the (1, 4) f32 scalar packet ``[lr_t, bc1, bc2, tok]`` built by
``ops.scalar_packet``.  The op order differs from the oracle
(``optim.apply_update``) in three places: ``acc * inv_k`` against
``sum / K``, ``m * bc1`` against ``m / (1 - beta1**t)``, and
``(1 - beta2) * (g * g)`` against ``(1 - beta2) * g * g``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.optim.optimizers import OptimizerSpec

_OPT_CODES = {"sgd": 0, "momentum": 1, "adam": 2, "adamw": 3}
_FLOAT_TYPES = (torch.float32, torch.bfloat16)

# Kernel launches since the count was last reset: the wrapper adds one
# where it launches the kernel and nowhere else, so a run can show that it
# went through the kernel.  Callers reset it by assignment.
launches = 0


# -- the plain version: the TPU kernel's op sequence ----------------------
def _sgd_body(spec: OptimizerSpec, lr, g, p):
    if spec.weight_decay:
        g = g + spec.weight_decay * p
    return p - lr * g


def _momentum_body(spec: OptimizerSpec, lr, g, p, m):
    if spec.weight_decay:
        g = g + spec.weight_decay * p
    m = spec.momentum * m + g
    upd = g + spec.momentum * m if spec.nesterov else m
    return p - lr * upd, m


def _adam_body(spec: OptimizerSpec, lr, bc1, bc2, g, p, m, v):
    if spec.name == "adam" and spec.weight_decay:
        g = g + spec.weight_decay * p
    m = spec.beta1 * m + (1.0 - spec.beta1) * g
    v = spec.beta2 * v + (1.0 - spec.beta2) * (g * g)
    mhat = m * bc1
    vhat = v * bc2
    upd = mhat / (_sqrt_rn(vhat) + spec.eps)
    if spec.name == "adamw" and spec.weight_decay:
        upd = upd + spec.weight_decay * p
    return p - lr * upd, m, v


def _sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 square root.  ``torch.sqrt`` on the CPU goes
    through a vector math library that is off by an ulp on some inputs;
    the square root of an f32 value taken in f64 and rounded back to f32
    is the correctly rounded one on every device."""
    return torch.sqrt(x.double()).float()


def fused_agg_opt_torch(
    grads: torch.Tensor,  # (K, N)
    param: torch.Tensor,  # (N,)
    state: tuple,  # num_state_slots tensors of (N,) f32
    scalars: torch.Tensor,  # (1, 4) f32: [lr_t, bc1, bc2, tok]
    spec: OptimizerSpec,
    *,
    average: bool = True,
) -> tuple[torch.Tensor, tuple]:
    """Plain PyTorch version of the kernel.  Returns (new_param, new_state)
    as new tensors; the inputs are not modified."""
    k = grads.shape[0]
    acc = grads[0].float()
    for i in range(1, k):
        acc = acc + grads[i].float()
    return optimizer_step(spec, scalars, acc * (1.0 / k if average else 1.0),
                          param, state)


def optimizer_step(spec: OptimizerSpec, scalars: torch.Tensor,
                   g: torch.Tensor, param: torch.Tensor,
                   state: tuple) -> tuple[torch.Tensor, tuple]:
    """The optimizer body on the averaged f32 gradient ``g``, as the
    kernels run it after their fold (``wire_path`` shares it, as the TPU
    wire kernel shares the ``*_body`` helpers).  Returns (new_param in
    ``param``'s dtype, new_state) as new tensors."""
    lr, bc1, bc2 = scalars.reshape(4)[:3]
    p = param.float()
    if spec.num_state_slots == 0:
        new_p, new_s = _sgd_body(spec, lr, g, p), ()
    elif spec.num_state_slots == 1:
        new_p, m = _momentum_body(spec, lr, g, p, state[0])
        new_s = (m,)
    else:
        new_p, m, v = _adam_body(spec, lr, bc1, bc2, g, p, *state)
        new_s = (m, v)
    return new_p.to(param.dtype), new_s


# -- the CUDA kernel ------------------------------------------------------
# ctypes types of ``hyper_args``: opt, has_wd, wd, mu, nesterov, b1, b2,
# eps, 1-b1, 1-b2, inv_k (the C side's ``Hyper`` and optimizer code)
HYPER_ARGTYPES = (ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
                  ctypes.c_int, *[ctypes.c_float] * 6)


def hyper_args(spec: OptimizerSpec, inv_k: float) -> tuple:
    """The optimizer's arguments to a kernel entry point, in
    ``HYPER_ARGTYPES`` order.  Each float crosses as f32 rounded from the
    double here, as JAX's weak-typed constants are rounded."""
    return (_OPT_CODES[spec.name], int(bool(spec.weight_decay)),
            spec.weight_decay, spec.momentum, int(spec.nesterov), spec.beta1,
            spec.beta2, spec.eps, 1.0 - spec.beta1, 1.0 - spec.beta2, inv_k)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from repro_torch.kernels import _build

    lib = _build.load("fused_agg_opt")
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.fused_agg_opt_launch.argtypes = [
        ptr, ptr, ptr, ptr, ptr,  # grads, param, m, v, scalars
        i64, i64, i32, i32,  # k, n, grad_bf16, param_bf16
        *HYPER_ARGTYPES,
        ptr,  # stream
    ]
    lib.fused_agg_opt_launch.restype = ctypes.c_int
    return lib


def _check_cuda_args(grads, param, state, scalars, spec) -> None:
    dev = param.device
    tensors = [grads, param, scalars, *state]
    if any(t.device != dev for t in tensors):
        raise ValueError("fused_agg_opt: every tensor must be on one device")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError("fused_agg_opt: every tensor must be contiguous")
    if grads.dtype not in _FLOAT_TYPES or param.dtype not in _FLOAT_TYPES:
        raise ValueError(
            f"fused_agg_opt: grads/param must be f32 or bf16, got "
            f"{grads.dtype}/{param.dtype}")
    if scalars.dtype != torch.float32 or scalars.numel() != 4:
        raise ValueError("fused_agg_opt: scalars must be 4 f32 values")
    if spec.name not in _OPT_CODES:
        raise ValueError(f"unknown optimizer {spec.name}")


def fused_agg_opt_cuda(
    grads: torch.Tensor,  # (K, N) on the card
    param: torch.Tensor,  # (N,), updated in place
    state: tuple,  # num_state_slots (N,) f32 tensors, updated in place
    scalars: torch.Tensor,  # (1, 4) f32 on the card
    spec: OptimizerSpec,
    *,
    average: bool = True,
) -> tuple[torch.Tensor, tuple]:
    """Launch the CUDA kernel on the current stream; returns (param, state),
    the same tensors, updated in place.  Raises if the launch fails."""
    global launches
    _check_cuda_args(grads, param, state, scalars, spec)
    k, n = grads.shape
    slots = list(state) + [None] * (2 - len(state))
    ptrs = [None if s is None else s.data_ptr() for s in slots]
    with torch.cuda.device(param.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().fused_agg_opt_launch(
            grads.data_ptr(), param.data_ptr(), ptrs[0], ptrs[1],
            scalars.data_ptr(),
            k, n, int(grads.dtype == torch.bfloat16),
            int(param.dtype == torch.bfloat16),
            *hyper_args(spec, 1.0 / k if average else 1.0),
            stream,
        )
    if rc != 0:
        raise RuntimeError(f"fused_agg_opt kernel launch failed: CUDA error {rc}")
    launches += 1
    return param, tuple(state)
