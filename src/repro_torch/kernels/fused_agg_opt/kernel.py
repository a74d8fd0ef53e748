"""The fused aggregate+optimize kernel: CUDA wrapper and plain version.

Torch counterpart of ``repro/kernels/fused_agg_opt/kernel.py``, whose
Pallas TPU kernel ``fused_agg_opt_pallas`` this replaces.  Two functions
with one contract:

``fused_agg_opt_cuda``   launches ``csrc/fused_agg_opt.cu`` (built at first
                         use by ``kernels/_build.py``) on the current CUDA
                         stream.  It updates ``param`` and the state slots
                         IN PLACE and returns them.  Each stream's launches
                         claim tiles from that stream's own counter
                         (``claim_counter``), so launches on two streams may
                         overlap.
``fused_agg_opt_torch``  the kernel's plain PyTorch version: eager ops in
                         the TPU kernel's exact op sequence.  Eager torch
                         rounds every op, which is the strict
                         multiply-then-add the TPU kernel forces with its
                         ``fence``, so this equals the Pallas kernel (and
                         the CUDA kernel) bit for bit.  It returns new
                         tensors.

Both take the (1, 4) f32 scalar packet ``[lr_t, bc1, bc2, tok]`` built by
``ops.scalar_packet``, and the K gradient rows as a (K, N) tensor or as a
sequence of rows: ``None`` for a zero row, and with ``chunk_ids`` each row
a worker's whole push read at the shard's chunks, so no caller stacks
its inbox.  ``grad_scale`` multiplies the folded sum, rounded to the
rows' dtype (an eager ``slab * grad_scale`` folded into the pass).  The op order differs from the oracle
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


def gradient_rows(grads) -> list:
    """The K gradient rows of a (K, N) tensor (views) or of a sequence of
    rows (``None`` for a zero row), as a list."""
    if isinstance(grads, torch.Tensor):
        return list(grads.unbind(0))
    return list(grads)


def _shard_row(row: torch.Tensor, n: int, chunk_ids) -> torch.Tensor:
    """A row's N elements of the shard: the row itself, or, with a chunk-id
    table, its chunks gathered from the worker's whole push."""
    if chunk_ids is None:
        return row.reshape(n)
    return row.reshape(-1, n // len(chunk_ids))[chunk_ids].reshape(n)


def fused_agg_opt_torch(
    grads,  # (K, N) tensor, or K rows: (N,) each, None for a zero row
    param: torch.Tensor,  # (N,)
    state: tuple,  # num_state_slots tensors of (N,) f32
    scalars: torch.Tensor,  # (1, 4) f32: [lr_t, bc1, bc2, tok]
    spec: OptimizerSpec,
    *,
    average: bool = True,
    chunk_ids: torch.Tensor | None = None,
    grad_scale: float | None = None,
) -> tuple[torch.Tensor, tuple]:
    """Plain PyTorch version of the kernel.  Returns (new_param, new_state)
    as new tensors; the inputs are not modified.

    ``chunk_ids``: the shard's chunk ids; each row is then a worker's whole
    (num_chunks, chunk_elems) push, read at those chunks.  ``grad_scale``
    multiplies the folded sum, rounded to the gradients' dtype (an eager
    ``slab * grad_scale``), before ``x 1/K``."""
    rows = gradient_rows(grads)
    n = param.numel()
    acc = None
    for row in rows:  # left fold, ascending worker order
        if row is None:
            acc = (torch.zeros(n, dtype=torch.float32, device=param.device)
                   if acc is None else acc + 0.0)
        else:
            x = _shard_row(row, n, chunk_ids).float()
            acc = x if acc is None else acc + x
    if grad_scale is not None:
        gdt = next(r.dtype for r in rows if r is not None)
        acc = (acc * grad_scale).to(gdt).float()
    k = len(rows)
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


# the most gradient rows a launch takes: the largest row-pointer capacity
# of csrc/fused_agg_opt.cu (``kCaps``)
MAX_ROWS = 256

# The tile-claim counters: one device word for each stream that launches
# the kernel, so overlapping launches on two streams never share claims.
# A device's CLAIM_SLOTS words are zeroed once, at its first launch, and
# kept; a launch leaves its word zero for the stream's next one, so no
# launch pays for a memset.
CLAIM_SLOTS = 256
_claims: dict = {}  # device index -> (the words, {stream handle: slot})


def claim_counter(device: torch.device, stream: int) -> int:
    """The address of the claim counter of ``stream`` (a CUDA stream
    handle) on ``device``."""
    entry = _claims.get(device.index)
    if entry is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "fused_agg_opt: the first launch on a device cannot be "
                "captured (its claim counters are zeroed at that launch)")
        words = torch.zeros(CLAIM_SLOTS, dtype=torch.int64, device=device)
        # zeroed before a launch on any other stream reads a word
        torch.cuda.current_stream(device).synchronize()
        entry = _claims[device.index] = (words, {})
    words, slots = entry
    slot = slots.get(stream)
    if slot is None:
        if len(slots) == CLAIM_SLOTS:
            raise RuntimeError(f"fused_agg_opt: more than {CLAIM_SLOTS} "
                               f"streams launched the kernel on {device}")
        slot = slots[stream] = len(slots)
    return words.data_ptr() + words.element_size() * slot


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from repro_torch.kernels import _build

    lib = _build.load("fused_agg_opt")
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.fused_agg_opt_launch.argtypes = [
        ctypes.POINTER(ptr), i32, i32,  # present rows, their count, has_zero
        ptr, i64,  # chunk_ids, chunk_elems
        ptr, ptr, ptr, ptr,  # param, m, v, scalars
        i64, i32, i32,  # n, grad_bf16, param_bf16
        *HYPER_ARGTYPES,
        i32, ctypes.c_float,  # has_scale, grad_scale
        ptr, ptr,  # the stream's claim counter, the stream
    ]
    lib.fused_agg_opt_launch.restype = ctypes.c_int
    return lib


def check_rows(rows: list, param: torch.Tensor,
               chunk_ids: torch.Tensor | None) -> None:
    """The gradient rows' contract on any device: 1 to ``MAX_ROWS`` rows,
    at least one present; the present ones contiguous, of one dtype (f32 or
    bf16), on ``param``'s device, each with the shard's N elements or, with
    a chunk-id table, whole chunks of N / len(chunk_ids) elements."""
    if not 1 <= len(rows) <= MAX_ROWS:
        raise ValueError(
            f"fused_agg_opt takes 1 to {MAX_ROWS} gradient rows, got {len(rows)}")
    present = [r for r in rows if r is not None]
    if not present:
        raise ValueError("fused_agg_opt: every gradient row is None")
    n, dev, dtype = param.numel(), param.device, present[0].dtype
    if dtype not in _FLOAT_TYPES:
        raise ValueError(f"fused_agg_opt: gradient rows must be f32 or bf16, "
                         f"got {dtype}")
    if chunk_ids is not None:
        if (chunk_ids.dim() != 1 or chunk_ids.dtype != torch.int64
                or chunk_ids.device != dev or not len(chunk_ids)
                or n % len(chunk_ids)):
            raise ValueError(
                f"fused_agg_opt: chunk_ids must be a non-empty 1-D int64 "
                f"table on {dev} that splits the shard's {n} elements")
        chunk = n // len(chunk_ids)
    for r in present:
        if r.dtype != dtype:
            raise ValueError(f"fused_agg_opt: gradient rows mix {dtype} and "
                             f"{r.dtype}")
        if r.device != dev:
            raise ValueError(f"fused_agg_opt: a gradient row is on {r.device},"
                             f" the param on {dev}")
        if not r.is_contiguous():
            raise ValueError("fused_agg_opt: gradient rows must be contiguous")
        if (r.numel() != n if chunk_ids is None else r.numel() % chunk):
            raise ValueError(
                f"fused_agg_opt: a gradient row has {r.numel()} elements, "
                + (f"the param {n}" if chunk_ids is None else
                   f"not whole chunks of {chunk}"))


def _check_cuda_args(param, state, scalars, spec) -> None:
    dev = param.device
    tensors = [param, scalars, *state]
    if any(t.device != dev for t in tensors):
        raise ValueError("fused_agg_opt: every tensor must be on one device")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError("fused_agg_opt: every tensor must be contiguous")
    if param.dtype not in _FLOAT_TYPES:
        raise ValueError(
            f"fused_agg_opt: param must be f32 or bf16, got {param.dtype}")
    if scalars.dtype != torch.float32 or scalars.numel() != 4:
        raise ValueError("fused_agg_opt: scalars must be 4 f32 values")
    if spec.name not in _OPT_CODES:
        raise ValueError(f"unknown optimizer {spec.name}")


def fused_agg_opt_cuda(
    grads,  # (K, N) tensor, or K rows (None for a zero row), on the card
    param: torch.Tensor,  # (N,), updated in place
    state: tuple,  # num_state_slots (N,) f32 tensors, updated in place
    scalars: torch.Tensor,  # (1, 4) f32 on the card
    spec: OptimizerSpec,
    *,
    average: bool = True,
    chunk_ids: torch.Tensor | None = None,
    grad_scale: float | None = None,
) -> tuple[torch.Tensor, tuple]:
    """Launch the CUDA kernel on the current stream, claiming tiles from
    that stream's counter; returns (param, state), the same tensors,
    updated in place.  The rows cross as pointers (a
    (K, N) tensor as K pointers at stride N), read where they lie.  Raises
    if the launch fails."""
    global launches
    rows = gradient_rows(grads)
    check_rows(rows, param, chunk_ids)
    _check_cuda_args(param, state, scalars, spec)
    present = [r for r in rows if r is not None]
    row_ptrs = (ctypes.c_void_p * len(present))(*[r.data_ptr() for r in present])
    k = len(rows)
    slots = list(state) + [None] * (2 - len(state))
    ptrs = [None if s is None else s.data_ptr() for s in slots]
    with torch.cuda.device(param.device):
        stream = torch.cuda.current_stream().cuda_stream
        claims = claim_counter(param.device, stream)
        rc = _lib().fused_agg_opt_launch(
            row_ptrs, len(present), int(len(present) < k),
            None if chunk_ids is None else chunk_ids.data_ptr(),
            0 if chunk_ids is None else param.numel() // len(chunk_ids),
            param.data_ptr(), ptrs[0], ptrs[1], scalars.data_ptr(),
            param.numel(), int(present[0].dtype == torch.bfloat16),
            int(param.dtype == torch.bfloat16),
            *hyper_args(spec, 1.0 / k if average else 1.0),
            int(grad_scale is not None),
            1.0 if grad_scale is None else grad_scale,
            claims, stream,
        )
    if rc != 0:
        raise RuntimeError(f"fused_agg_opt kernel launch failed: CUDA error {rc}")
    launches += 1
    return param, tuple(state)
