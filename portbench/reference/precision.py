"""The precision the reference computes in.

``"f32"`` is the configurations' own: float32 products with TF32 off,
in cuBLAS and in cuDNN alike.  ``"tf32"`` is the control, the nearest
precision below it: on the card the products round their operands to
TF32 (10 mantissa bits) and accumulate in float32; the CPU has no TF32,
so there the operands of every matrix product and convolution of the
forward pass are rounded to it by ``round_tf32`` (``emulated``), which is
the same arithmetic up to the order of the sums.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

PRECISIONS = ("f32", "tf32")


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (f32) rounded to TF32's 10 mantissa bits, to nearest even; the
    gradient passes through the rounding unchanged."""
    bits = x.detach().contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0xFFF + lsb) & ~0x1FFF
    return x + (bits.view(torch.float32) - x).detach()


@contextlib.contextmanager
def _cpu_tf32():
    """Round the operands of ``@``, ``bmm`` and ``conv2d`` to TF32."""
    saved = (torch.Tensor.__matmul__, torch.bmm, F.conv2d)

    def matmul(a, b):
        return saved[0](round_tf32(a), round_tf32(b))

    def bmm(a, b):
        return saved[1](round_tf32(a), round_tf32(b))

    def conv2d(x, w, *args, **kwargs):
        return saved[2](round_tf32(x), round_tf32(w), *args, **kwargs)

    torch.Tensor.__matmul__, torch.bmm, F.conv2d = matmul, bmm, conv2d
    try:
        yield
    finally:
        torch.Tensor.__matmul__, torch.bmm, F.conv2d = saved


@contextlib.contextmanager
def precision(name: str, device):
    """Run the block's products in ``name`` (one of ``PRECISIONS``)."""
    if name not in PRECISIONS:
        raise ValueError(f"unknown precision {name!r}")
    tf32 = name == "tf32"
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        if tf32 and torch.device(device).type == "cpu":
            with _cpu_tf32():
                yield
        else:
            yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
