"""ResNet-50 (He et al., arXiv:1512.03385) in plain PyTorch: the
benchmark's reference for the ``resnet50`` configuration.

A frozen copy of the forward pass and loss of
``src/repro_torch/models/resnet.py``, written with ``F.conv2d`` and
``F.group_norm`` only.  Departures from the paper, as in the program:
GroupNorm over ``groups`` groups in place of BatchNorm, and XLA's "SAME"
padding (the odd extra row and column on the high side).  Parameters are
HWIO kernels, ``{"s", "b"}`` norm dicts and ``s{i}b{j}`` block keys; images
arrive NHWC.  The precision of the products is set by
``reference.precision``, never here.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def param_spec(cfg: dict) -> dict:
    """Each leaf's kind, shape and fan-in (``yardstick.inputs.make_params``)."""

    def conv(kh, kw, cin, cout):
        return ("normal", (kh, kw, cin, cout), kh * kw * cin)

    def norm(c):
        return {"s": ("ones", (c,)), "b": ("zeros", (c,))}

    p: dict = {"stem": conv(7, 7, 3, 64), "stem_gn": norm(64)}
    cin = 64
    for si, (n, w) in enumerate(zip(cfg["blocks"], cfg["widths"])):
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
    last = cfg["widths"][-1]
    p["head"] = ("normal", (last, cfg["n_classes"]), last)
    p["head_b"] = ("zeros", (cfg["n_classes"],))
    return p


def _same_pad(n: int, k: int, stride: int) -> tuple[int, int]:
    out = -(-n // stride)
    total = max((out - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def _conv(x, w, stride: int = 1):
    """SAME convolution of NCHW ``x`` by an HWIO kernel ``w``."""
    ph = _same_pad(x.shape[2], w.shape[0], stride)
    pw = _same_pad(x.shape[3], w.shape[1], stride)
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    return F.conv2d(x, w.permute(3, 2, 0, 1), stride=stride)


def _max_pool(x):
    ph = _same_pad(x.shape[2], 3, 2)
    pw = _same_pad(x.shape[3], 3, 2)
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=float("-inf"))
    return F.max_pool2d(x, 3, 2)


def forward(params: dict, images: torch.Tensor, cfg: dict) -> torch.Tensor:
    """images (N, H, W, 3) f32 -> logits (N, n_classes)."""
    groups = cfg["groups"]

    def gn(x, g):
        return F.group_norm(x, groups, g["s"], g["b"], 1e-5)

    x = images.permute(0, 3, 1, 2)
    x = F.relu(gn(_conv(x, params["stem"], 2), params["stem_gn"]))
    x = _max_pool(x)
    for si, n in enumerate(cfg["blocks"]):
        for bi in range(n):
            blk = params[f"s{si}b{bi}"]
            stride = 2 if (bi == 0 and si > 0) else 1
            h = F.relu(gn(_conv(x, blk["c1"]), blk["g1"]))
            h = F.relu(gn(_conv(h, blk["c2"], stride), blk["g2"]))
            h = gn(_conv(h, blk["c3"]), blk["g3"])
            if "proj" in blk:
                x = gn(_conv(x, blk["proj"], stride), blk["gproj"])
            x = F.relu(x + h)
    return x.mean(dim=(2, 3)) @ params["head"] + params["head_b"]


def loss(params: dict, batch: dict, cfg: dict) -> torch.Tensor:
    """Mean cross-entropy of ``images`` against integer ``labels``."""
    logp = torch.log_softmax(forward(params, batch["images"], cfg), dim=-1)
    return -torch.gather(logp, -1, batch["labels"].long()[:, None]).mean()
