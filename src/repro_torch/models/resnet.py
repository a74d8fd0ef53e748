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


class _Conv2dF32(torch.autograd.Function):
    """``F.conv2d`` and its backward (``aten.convolution_backward``, what
    autograd calls for it) with cuDNN's TF32 off: the backward reads the
    flag when it runs, so a block around the forward does not cover it."""

    @staticmethod
    def forward(ctx, x, w, stride, padding):
        ctx.save_for_backward(x, w)
        ctx.stride, ctx.padding = stride, padding
        with _no_tf32():
            return F.conv2d(x, w, stride=stride, padding=padding)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        with _no_tf32():
            gx, gw, _ = torch.ops.aten.convolution_backward(
                g, x, w, None, [ctx.stride] * 2, list(ctx.padding), [1, 1],
                False, [0, 0], 1,
                [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
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


def forward(params, images, cfg: ResNetConfig):
    """images (N, H, W, 3) -> logits (N, n_classes) in ``cfg.dtype``."""
    x = images.to(cfg.dtype).permute(0, 3, 1, 2)
    x = _conv(x, params["stem"], 2)
    x = F.relu(_gn(x, params["stem_gn"], cfg.groups))
    x = _max_pool(x)
    for si, n in enumerate(cfg.blocks):
        for bi in range(n):
            blk = params[f"s{si}b{bi}"]
            stride = 2 if (bi == 0 and si > 0) else 1
            h = F.relu(_gn(_conv(x, blk["c1"]), blk["g1"], cfg.groups))
            h = F.relu(_gn(_conv(h, blk["c2"], stride), blk["g2"], cfg.groups))
            h = _gn(_conv(h, blk["c3"]), blk["g3"], cfg.groups)
            if "proj" in blk:
                x = _gn(_conv(x, blk["proj"], stride), blk["gproj"],
                        cfg.groups)
            x = F.relu(x + h)
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
