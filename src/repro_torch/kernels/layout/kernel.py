"""The channels-last copy: CUDA wrapper and plain version.

No TPU kernel is replaced.  ``csrc/channels_last.cu`` (built at first use
by ``kernels/_build.py``) transposes a batch of (C, P) matrices into (P,
C) on the current stream.  ``to_channels_last_cuda`` maps a 4-D f32
(N, C, H, W) tensor onto it as N matrices of (C, H W):

  * channels-last already: returned as it is, nothing launched;
  * NCHW-contiguous: copied by the kernel;
  * any other strides: made NCHW-contiguous first (PyTorch's copy).

``to_channels_last_torch`` is the plain version, ``Tensor.contiguous``.
The launch count goes up by one a launch; callers reset it by assignment.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.layout.ref import (
    to_channels_last_ref as to_channels_last_torch,
)

launches = 0

CL = torch.channels_last


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from repro_torch.kernels import _build

    lib = _build.load("channels_last")
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.channels_last_launch.argtypes = [ptr, ptr, i64, i64, i64, ptr]
    lib.channels_last_launch.restype = ctypes.c_int
    return lib


def plan(t: torch.Tensor) -> tuple[torch.Tensor, int, int, int]:
    """How the kernel copies 4-D ``t`` (not yet channels-last): ``(src,
    batch, c, p)`` with ``src`` contiguous and holding ``batch`` (c, p)
    matrices whose transposes, in order, are the channels-last memory."""
    n, c, h, w = t.shape
    return (t if t.is_contiguous() else t.contiguous()), n, c, h * w


def to_channels_last_cuda(t: torch.Tensor) -> torch.Tensor:
    """``t`` (4-D f32 on the card) in channels-last memory, by the kernel on
    the current stream.  Raises if the launch fails.  The host's cost is
    most of a launch here, so the stream comes from torch's raw getter and
    the device switches only where it is not current already."""
    global launches
    if t.is_contiguous(memory_format=CL):
        return t
    src, batch, c, p = plan(t)
    out = torch.empty_like(src, memory_format=CL)
    idx = t.device.index
    args = (src.data_ptr(), out.data_ptr(), batch, c, p)
    if torch._C._cuda_getDevice() == idx:
        rc = _lib().channels_last_launch(
            *args, torch._C._cuda_getCurrentRawStream(idx))
    else:
        with torch.cuda.device(t.device):
            rc = _lib().channels_last_launch(
                *args, torch._C._cuda_getCurrentRawStream(idx))
    if rc != 0:
        raise RuntimeError(f"channels_last launch failed: CUDA error {rc}")
    launches += 1
    return out
