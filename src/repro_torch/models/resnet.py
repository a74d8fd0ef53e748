"""ResNet-50, the paper's own evaluation workload (ImageNet CNNs); torch
counterpart of ``repro/models/resnet.py``.

Pure data-parallel: the parameters are replicated and the PS exchange
aggregates the gradients, the paper's MXNet setting.  BatchNorm is
replaced by per-device GroupNorm, as in the JAX package.

Parameters keep the JAX package's tree and layout: HWIO kernels,
``{"s", "b"}`` norm dicts and ``s{i}b{j}`` block keys, so ``ParamSpace``,
checkpoints and ``TrainState`` are shared with it.  Images arrive NHWC as
in JAX; ``permute(0, 3, 1, 2)`` of an NHWC tensor is already a
channels-last NCHW tensor, which is what the convolutions take.
Convolutions are ``F.conv2d`` and the norms ``F.group_norm`` (biased
variance, eps 1e-5, groups of contiguous channels): JAX computes both
outside any Pallas kernel.  The convolutions run with cuDNN's TF32 off,
forward and backward (``_conv2d``): torch lets cuDNN round f32 operands to
10 mantissa bits by default, which is not the f32 function the config
names.

On the card in f32 two things change, neither of them in the forward's
bits.  Each norm with the ReLU and residual add after it is one op
(``kernels/group_norm``, which runs the plain library sequence on the
CPU): PyTorch's GroupNorm kernel, then one hand-written pass for the add
and the ReLU with PyTorch's arithmetic, and one hand-written backward for
all three.  And the weight gradient of a 1x1 convolution over at least
56 x 56 pixels (and the stem's, whose input is channels-last already)
runs on channels-last copies of its input and incoming gradient
(``kernels/layout``, ``_wgrad_channels_last``): cuDNN's f32
weight gradient from NCHW operands is its indexed implicit GEMM behind
layout conversions there, 8 to 14 times slower at 32 images, while at
ResNet-50's other shapes the copies cost about what they save.  The
forward stays NCHW, bit for bit as before: the forward's roundings decide
every ReLU and max-pool, and a flip among them moves the gradient by far
more than the rounding itself.  ``repro_torch.tracing.counters()`` counts
the weight gradients on the card by the layout cuDNN got
(``wgrad_channels_last``, ``wgrad_nchw``).  On the CPU, and in any other
dtype, the model runs ``F.group_norm``, ``F.relu``, the add and
autograd's convolution backward as before.

XLA's "SAME" padding puts the odd extra row and column on the high side:
the 7x7/2 stem on an even size pads (2, 3), a 3x3/2 on an even size
(0, 1), and the 3x3/2 max-pool pads (0, 1) with ``-inf``.  ``conv2d``'s
padding is symmetric (and ``padding="same"`` refuses stride 2), so an
asymmetric pad goes through ``F.pad`` first.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch
import torch.nn.functional as F

from repro_torch import tracing
from repro_torch.kernels.group_norm import group_norm_act
from repro_torch.kernels.layout import to_channels_last
from repro_torch.models.common import Dist, count_params, dense_init, gen_device


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    name: str = "resnet50"
    blocks: tuple = (3, 4, 6, 3)
    widths: tuple = (256, 512, 1024, 2048)
    n_classes: int = 1000
    groups: int = 32
    dtype: torch.dtype = torch.float32

    def param_count(self) -> int:
        return count_params(init_params(self, None, device="meta"))


def init_params(cfg: ResNetConfig, generator: torch.Generator | None = None,
                device: torch.device | str | None = None) -> dict:
    """Random parameters drawn from ``generator`` in the JAX init's order
    (stem, each block's c1, c2, c3 and its projection, the head), on the
    generator's device; ``generator=None`` or ``device="meta"`` gives meta
    tensors (shapes and dtypes only)."""
    if device is not None and torch.device(device).type == "meta":
        generator = None
    elif (generator is not None and device is not None
          and torch.device(device).type != generator.device.type):
        raise ValueError(
            f"generator lives on {generator.device}, device is {device}")
    dev = gen_device(generator)
    dt = cfg.dtype

    def conv(kh, kw, cin, cout):
        return dense_init(generator, (kh, kw, cin, cout), kh * kw * cin, dt)

    def norm(c):
        return {"s": torch.ones((c,), dtype=dt, device=dev),
                "b": torch.zeros((c,), dtype=dt, device=dev)}

    p: dict = {"stem": conv(7, 7, 3, 64), "stem_gn": norm(64)}
    cin = 64
    for si, (n, w) in enumerate(zip(cfg.blocks, cfg.widths)):
        mid = w // 4
        for bi in range(n):
            blk = {"c1": conv(1, 1, cin, mid), "g1": norm(mid),
                   "c2": conv(3, 3, mid, mid), "g2": norm(mid),
                   "c3": conv(1, 1, mid, w), "g3": norm(w)}
            if bi == 0:
                blk["proj"] = conv(1, 1, cin, w)
                blk["gproj"] = norm(w)
            p[f"s{si}b{bi}"] = blk
            cin = w
    last = cfg.widths[-1]
    p["head"] = dense_init(generator, (last, cfg.n_classes), last, dt)
    p["head_b"] = torch.zeros((cfg.n_classes,), dtype=dt, device=dev)
    return p


def _same_pad(n: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's "SAME" (low, high) padding of one spatial dim."""
    out = -(-n // stride)
    total = max((out - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


@contextlib.contextmanager
def _no_tf32():
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def _fused(x: torch.Tensor) -> bool:
    """Whether the convolution backward of ``x`` may take channels-last
    weight gradients: on the card, in f32."""
    return x.is_cuda and x.dtype == torch.float32


def _wgrad_channels_last(x: torch.Tensor, w: torch.Tensor) -> bool:
    """Whether the weight gradient of ``x`` convolved by ``w`` runs on
    channels-last operands: a 1x1 kernel over at least 56 x 56 pixels
    (cuDNN's f32 NCHW weight gradient is 8 to 14 times slower there), or
    an ``x`` in channels-last memory already (the stem's padded images:
    only the incoming gradient is copied).  A rule by shape, so every
    process picks the same algorithms and the same gradient bits."""
    return x.is_contiguous(memory_format=torch.channels_last) or (
        w.shape[2] == w.shape[3] == 1 and x.shape[2] * x.shape[3] >= 56 * 56)


def _weight_grad(g, x, w, stride: int, padding: tuple[int, int]):
    """The weight gradient of ``_conv2d`` on channels-last copies of ``g``
    and ``x`` (``kernels/layout``; TF32 off by the caller).  A weight
    gradient reads only the weight's shape and layout, so an empty
    channels-last tensor stands in for ``w``: nothing is copied."""
    return torch.ops.aten.convolution_backward(
        to_channels_last(g), to_channels_last(x),
        torch.empty_like(w, memory_format=torch.channels_last), None,
        [stride] * 2, list(padding), [1, 1], False, [0, 0], 1,
        [False, True, False])[1]


class _Conv2dF32(torch.autograd.Function):
    """``F.conv2d`` and its backward (``aten.convolution_backward``, what
    autograd calls for it) with cuDNN's TF32 off: the backward reads the
    flag when it runs, so a block around the forward does not cover it.
    On the card in f32 the weight gradient runs in channels-last where
    ``_wgrad_channels_last`` says so."""

    @staticmethod
    def forward(ctx, x, w, stride, padding):
        ctx.save_for_backward(x, w)
        ctx.stride, ctx.padding = stride, padding
        with _no_tf32():
            return F.conv2d(x, w, stride=stride, padding=padding)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dgrad, wgrad = ctx.needs_input_grad[0], ctx.needs_input_grad[1]
        gx = gw = None
        with _no_tf32():
            if wgrad and _fused(x):
                if _wgrad_channels_last(x, w):
                    gw = _weight_grad(g, x, w, ctx.stride, ctx.padding)
                    wgrad = False
                    tracing.count("wgrad_channels_last")
                else:
                    tracing.count("wgrad_nchw")
            if dgrad or wgrad:
                gx, gw_nchw, _ = torch.ops.aten.convolution_backward(
                    g, x, w, None, [ctx.stride] * 2, list(ctx.padding),
                    [1, 1], False, [0, 0], 1, [dgrad, wgrad, False])
                if wgrad:
                    gw = gw_nchw
        return gx, gw, None, None


def _conv2d(x, w, stride: int, padding: tuple[int, int]):
    """NCHW ``x`` by an OIHW ``w``, symmetric ``padding``, f32 on cuDNN."""
    return _Conv2dF32.apply(x, w, stride, padding)


def _conv(x, w, stride: int = 1):
    """SAME convolution of NCHW ``x`` with an HWIO kernel ``w``."""
    kh, kw = w.shape[0], w.shape[1]
    ph = _same_pad(x.shape[2], kh, stride)
    pw = _same_pad(x.shape[3], kw, stride)
    w = w.permute(3, 2, 0, 1)  # HWIO -> OIHW
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return _conv2d(x, w, stride, (ph[0], pw[0]))
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    return _conv2d(x, w, stride, (0, 0))


def _max_pool(x):
    """``reduce_window(max, -inf, 3x3, stride 2, "SAME")`` of NCHW ``x``."""
    ph = _same_pad(x.shape[2], 3, 2)
    pw = _same_pad(x.shape[3], 3, 2)
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=float("-inf"))
    return F.max_pool2d(x, 3, 2)


def _gn(x, g, groups: int):
    """GroupNorm of NCHW ``x`` in f32, cast back, then ``x * s + b``."""
    if x.dtype == torch.float32:
        return F.group_norm(x, groups, g["s"], g["b"], 1e-5)
    x = F.group_norm(x.float(), groups, eps=1e-5).to(x.dtype)
    return x * g["s"] + g["b"]


def _norm(x, g, groups: int, relu: bool = True, residual=None):
    """``relu(_gn(x) [+ residual])`` (no ReLU for ``relu=False``): in f32
    one op, with a hand-written backward on the card, the same bits."""
    if x.dtype == torch.float32:
        return group_norm_act(x, g["s"], g["b"], groups, relu=relu,
                              residual=residual)
    x = _gn(x, g, groups)
    if residual is not None:
        x = residual + x
    return F.relu(x) if relu else x


def forward(params, images, cfg: ResNetConfig):
    """images (N, H, W, 3) -> logits (N, n_classes) in ``cfg.dtype``."""
    x = images.to(cfg.dtype).permute(0, 3, 1, 2)
    x = _conv(x, params["stem"], 2)
    x = _norm(x, params["stem_gn"], cfg.groups)
    x = _max_pool(x)
    for si, n in enumerate(cfg.blocks):
        for bi in range(n):
            blk = params[f"s{si}b{bi}"]
            stride = 2 if (bi == 0 and si > 0) else 1
            h = _norm(_conv(x, blk["c1"]), blk["g1"], cfg.groups)
            h = _norm(_conv(h, blk["c2"], stride), blk["g2"], cfg.groups)
            if "proj" in blk:
                x = _norm(_conv(x, blk["proj"], stride), blk["gproj"],
                          cfg.groups, relu=False)
            x = _norm(_conv(h, blk["c3"]), blk["g3"], cfg.groups,
                      residual=x)
    x = torch.mean(x, dim=(2, 3))
    return x @ params["head"] + params["head_b"]


def loss_fn(params, batch, cfg: ResNetConfig, dist: Dist | None = None):
    """(mean cross-entropy, {"acc": top-1 accuracy}) of a batch of
    ``images`` (N, H, W, 3) and integer ``labels`` (N,)."""
    logits = forward(params, batch["images"], cfg).float()
    labels = batch["labels"].long()
    logp = torch.log_softmax(logits, dim=-1)
    ce = -torch.gather(logp, -1, labels[:, None]).mean()
    acc = (torch.argmax(logits, -1) == labels).float().mean()
    return ce, {"acc": acc}
