"""The fused GroupNorm's kernels: CUDA wrappers and the plain version.

No TPU kernel is replaced (the JAX package leaves GroupNorm to XLA).  One
CUDA source, ``csrc/group_norm_act.cu`` (built at first use by
``kernels/_build.py``), with two entry points on the current stream:

``group_norm_act_fwd_cuda``
    PyTorch's own GroupNorm kernel (``aten.native_group_norm``, the one
    ``F.group_norm`` runs, so the output keeps its bits), then one kernel
    that adds the residual and applies the ReLU in place, with PyTorch's
    arithmetic: the output equals ``relu(r + F.group_norm(x))`` bit for
    bit.  Returns the per-(sample, group) mean and rstd for the backward.
``group_norm_act_bwd_cuda``
    the backward of the three in three kernels: ``dy``, the saved ``x``
    and output ``y`` (its ReLU mask), mean and rstd -> ``dx``, ``ds``,
    ``db`` and, with a residual, ``dr``.
``group_norm_act_torch``
    the plain version for tensors off the card: ``F.group_norm`` with its affine,
    then ``residual + y``, then ``relu``, the sequence ResNet-50 ran
    before the kernel, so the CPU path keeps its bits.

Each entry point has its own launch count, which the wrapper adds one to
where it launches and nowhere else (a forward without an add or a ReLU
launches nothing); callers reset it by assignment.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

forward_launches = 0  # group_norm_act_fwd_cuda's epilogue
backward_launches = 0  # group_norm_act_bwd_cuda

EPS = 1e-5


def group_norm_act_torch(x: torch.Tensor, s: torch.Tensor, b: torch.Tensor,
                         groups: int, relu: bool,
                         residual: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version: ``relu(F.group_norm(x) * s + b [+ residual])``."""
    y = F.group_norm(x, groups, s, b, EPS)
    if residual is not None:
        y = residual + y
    return F.relu(y) if relu else y


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from repro_torch.kernels import _build

    lib = _build.load("group_norm_act")
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.group_norm_act_fwd_launch.argtypes = [ptr, ptr, i64, ctypes.c_int, ptr]
    lib.group_norm_act_fwd_launch.restype = ctypes.c_int
    lib.group_norm_act_bwd_launch.argtypes = [ptr] * 9 + [i64] * 4 + [ptr]
    lib.group_norm_act_bwd_launch.restype = ctypes.c_int
    return lib


def _launch(fn, dev: torch.device, *args) -> int:
    """``fn(*args, stream)`` on ``dev``'s current stream.  The host's cost
    is most of a launch here, so the stream comes from torch's raw getter
    and the device switches only where it is not current already."""
    if torch._C._cuda_getDevice() == dev.index:
        return fn(*args, torch._C._cuda_getCurrentRawStream(dev.index))
    with torch.cuda.device(dev):
        return fn(*args, torch._C._cuda_getCurrentRawStream(dev.index))


def group_norm_act_fwd_cuda(x: torch.Tensor, s: torch.Tensor, b: torch.Tensor,
                            residual: torch.Tensor | None, groups: int,
                            relu: bool):
    """``relu(GroupNorm(x) * s + b [+ residual])`` on the current stream:
    ``(y, x_read, mean, rstd)``, all contiguous; ``x_read`` is ``x`` as the
    norm read it (``x`` itself where it was contiguous).  Raises if the
    launch fails."""
    global forward_launches
    n, c, h, w = x.shape
    if not x.is_contiguous():
        x = x.contiguous()
    y, mean, rstd = torch.ops.aten.native_group_norm.default(
        x, s.contiguous(), b.contiguous(), n, c, h * w, groups, EPS)
    if relu or residual is not None:
        r = residual
        if r is not None and not r.is_contiguous():
            r = r.contiguous()
        rc = _launch(_lib().group_norm_act_fwd_launch, x.device,
                     y.data_ptr(), None if r is None else r.data_ptr(),
                     y.numel(), int(relu))
        if rc != 0:
            raise RuntimeError(
                f"group_norm_act forward launch failed: CUDA error {rc}")
        forward_launches += 1
    return y, x, mean, rstd


def group_norm_act_bwd_cuda(dy: torch.Tensor, y: torch.Tensor | None,
                            x: torch.Tensor, s: torch.Tensor,
                            mean: torch.Tensor, rstd: torch.Tensor,
                            groups: int, residual: bool):
    """The backward on the current stream: ``(dx, ds, db, dr)``, ``dr``
    None without a residual; ``y`` (the forward's output, whose sign is
    the ReLU's mask) None without the ReLU.  ``x``, ``y``, ``mean``,
    ``rstd`` and ``s`` are the forward's, and ``dy`` autograd's gradient of
    its output (so on its device, in f32).  Raises if the launch fails."""
    global backward_launches
    dev = x.device
    n, c, h, w = x.shape
    if not dy.is_contiguous():
        dy = dy.contiguous()
    if not s.is_contiguous():
        s = s.contiguous()
    dx = torch.empty_like(x)
    dr = torch.empty_like(x) if residual else None
    # ds, db, then the kernels' scratch (csrc: the backward's entry point)
    work = torch.empty(2 * c + 2 * n * c + 2 * n * groups,
                       dtype=torch.float32, device=dev)
    rc = _launch(_lib().group_norm_act_bwd_launch, dev,
                 dy.data_ptr(), None if y is None else y.data_ptr(),
                 x.data_ptr(), s.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
                 dx.data_ptr(), None if dr is None else dr.data_ptr(),
                 work.data_ptr(), n, c, h * w, groups)
    if rc != 0:
        raise RuntimeError(
            f"group_norm_act backward launch failed: CUDA error {rc}")
    backward_launches += 1
    return dx, work[:c], work[c:2 * c], dr
