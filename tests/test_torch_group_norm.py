"""The fused GroupNorm (``repro_torch.kernels.group_norm``) and ResNet-50's
fused path that runs it.

On the CPU (no card needed):

* the plain version and the ops entry point are ``F.group_norm`` + affine
  (+ add) + ``relu`` bit for bit, output and every gradient, in all three
  modes, on channels-last and contiguous inputs; against the oracle
  (``ref.py``, the function written out) at rtol 1e-5 / atol 1e-6, the
  gradients by autograd through both;
* the CUDA backward's algorithm written out in torch f32 (per-(sample,
  channel) sums of dz and dz xhat, per-group A and B, ``dx = rstd (s dz -
  A - xhat B)``) against autograd of the library sequence at rtol 1e-4 /
  atol 1e-5: the closed form is the kernel's own arithmetic, the library
  sums in another order;
* validation; meta tensors take the plain version; the model's CPU path
  and its counters as before; the channels-last weight gradient helper
  against autograd's (rtol 1e-5 / atol 1e-5: another summation order);
  the weight gradient's layout as a rule by shape at every convolution of
  ResNet-50 at 224^2.

On the card (``gpu``; ``PYTHONPATH=src python -m pytest -q -m gpu
tests/test_torch_group_norm.py``):

* the fused op in all three modes at every (C, H, W) of ResNet-50's norms
  at 224^2, batch 2, 32 groups, against the library sequence: the output
  bit for bit (PyTorch's GroupNorm kernel, then the add and the ReLU with
  PyTorch's arithmetic); ``dx`` ``dr`` at rtol 1e-4 / atol 1e-5 and
  ``ds`` ``db`` at rtol 1e-4 / atol 1e-4 of their largest entry (sums over
  up to 25,088 terms a sample, in another order); the launch counts move;
  two backward calls give the same bits;
* the channels-last weight gradient at every convolution of ResNet-50 at
  224^2, batch 2, against cuDNN's NCHW one at rtol 1e-4 / atol 1e-5 of the
  largest entry (f32 sums in another order);
* ``loss_fn`` on the fused path against the library path
  (``models/resnet._fused`` refusing every tensor, the norms as the plain
  version), SMOKE and the published widths: the loss bit for bit, every
  gradient leaf at rtol 1e-4 / atol 1e-5; every weight gradient counted
  by its layout, 10 of ResNet-50's 53 at 224^2 in channels-last; and at
  the cells' 32 x 224^2, the 1x1 64 -> 256 convolution at 56^2 (cuDNN's
  slow NCHW weight gradient) takes channels-last and runs there in under
  half the NCHW call's device time.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.nn.functional as F  # noqa: E402

from repro_torch import tracing  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.kernels.group_norm import kernel as K  # noqa: E402
from repro_torch.kernels.group_norm import ops as gops  # noqa: E402
from repro_torch.kernels.group_norm.ref import group_norm_act_ref  # noqa: E402
from repro_torch.models import resnet as RN  # noqa: E402

CL = torch.channels_last
MODES = {"affine": (False, False), "relu": (True, False),
         "residual": (True, True)}
# (C, H, W) of every GroupNorm of ResNet-50 at 224^2
RESNET50_NORMS = [(64, 112, 112), (64, 56, 56), (256, 56, 56), (128, 56, 56),
                  (128, 28, 28), (512, 28, 28), (256, 28, 28), (256, 14, 14),
                  (1024, 14, 14), (512, 14, 14), (512, 7, 7), (2048, 7, 7)]


def _inputs(shape, groups, mode, seed, layout, device="cpu"):
    rng = np.random.default_rng(seed)
    n, c, h, w = shape
    fmt = CL if layout == "channels_last" else torch.contiguous_format

    def t(*dims, scale=1.0, shift=0.0):
        a = (rng.standard_normal(dims) * scale + shift).astype(np.float32)
        return torch.from_numpy(a).to(device)

    x = t(n, c, h, w, scale=3.0, shift=0.5).contiguous(memory_format=fmt)
    s, b = t(c), t(c, scale=0.5)
    r = (t(n, c, h, w).contiguous(memory_format=fmt)
         if MODES[mode][1] else None)
    dy = t(n, c, h, w).contiguous(memory_format=fmt)
    return x, s, b, r, dy


def _library(x, s, b, groups, relu, r):
    y = F.group_norm(x, groups, s, b, 1e-5)
    if r is not None:
        y = r + y
    return F.relu(y) if relu else y


def _grads(fn, x, s, b, r, dy):
    """(output, dx, ds, db, dr) of ``fn`` by autograd."""
    leaves = [t.detach().clone().requires_grad_(True)
              for t in (x, s, b) + ((r,) if r is not None else ())]
    y = fn(*leaves[:3], leaves[3] if r is not None else None)
    y.backward(dy)
    grads = [t.grad for t in leaves]
    return (y.detach(), *grads, *([None] if r is None else []))


@pytest.mark.parametrize("layout", ["channels_last", "contiguous"])
@pytest.mark.parametrize("mode", list(MODES))
def test_plain_version_is_the_library_sequence(mode, layout):
    relu, _ = MODES[mode]
    x, s, b, r, dy = _inputs((2, 16, 5, 7), 4, mode, 1, layout)
    want = _grads(lambda *a: _library(*a[:3], 4, relu, a[3]), x, s, b, r, dy)
    for fn in (lambda *a: K.group_norm_act_torch(*a[:3], 4, relu, a[3]),
               lambda *a: gops.group_norm_act(*a[:3], 4, relu=relu,
                                              residual=a[3])):
        got = _grads(fn, x, s, b, r, dy)
        for g, w in zip(got, want):
            assert (g is None) == (w is None)
            if g is not None:
                assert torch.equal(g, w)


@pytest.mark.parametrize("layout", ["channels_last", "contiguous"])
@pytest.mark.parametrize("mode", list(MODES))
def test_plain_version_matches_the_oracle(mode, layout):
    relu, _ = MODES[mode]
    x, s, b, r, dy = _inputs((3, 24, 6, 5), 6, mode, 2, layout)
    want = _grads(lambda *a: group_norm_act_ref(*a[:3], 6, relu, a[3]),
                  x, s, b, r, dy)
    got = _grads(lambda *a: gops.group_norm_act(*a[:3], 6, relu=relu,
                                                residual=a[3]),
                 x, s, b, r, dy)
    for g, w in zip(got, want):
        if w is not None:
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)


def _kernel_backward(x, s, b, r, dy, groups, relu):
    """The CUDA backward's arithmetic in torch f32, from the library
    forward's output and statistics: per-(sample, channel) sums u of dz and
    v of dz xhat; per group A = sum s u / M and B = sum s v / M over M = H W
    C/G; dx = rstd (s dz - A - xhat B), ds = sum_n v, db = sum_n u, dr =
    dz.  Returns (y, dx, ds, db, dr)."""
    n, c, h, w = x.shape
    cg = c // groups
    y, mean, rstd = torch.ops.aten.native_group_norm(x.contiguous(), s, b, n,
                                                     c, h * w, groups, 1e-5)
    if r is not None:
        y = r + y
    if relu:
        y = F.relu(y)
    dz = torch.where(y > 0, dy, torch.zeros_like(dy)) if relu else dy
    m = mean.repeat_interleave(cg, 1)[:, :, None, None]
    rs = rstd.repeat_interleave(cg, 1)[:, :, None, None]
    xhat = (x - m) * rs
    u = dz.sum(dim=(2, 3))
    v = (dz * xhat).sum(dim=(2, 3))
    big_m = float(h * w * cg)
    a = (s * u).reshape(n, groups, cg).sum(-1) / big_m
    bb = (s * v).reshape(n, groups, cg).sum(-1) / big_m
    a = a.repeat_interleave(cg, 1)[:, :, None, None]
    bb = bb.repeat_interleave(cg, 1)[:, :, None, None]
    dx = rs * ((dz * s[:, None, None] - a) - xhat * bb)
    return y, dx, v.sum(0), u.sum(0), (dz if r is not None else None)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("shape,groups", [((2, 64, 9, 10), 32),
                                          ((2, 8, 6, 6), 8),
                                          ((2, 512, 3, 5), 32)])
def test_kernel_backward_matches_autograd(shape, groups, mode):
    relu, _ = MODES[mode]
    x, s, b, r, dy = _inputs(shape, groups, mode, 3, "contiguous")
    want = _grads(lambda *a: _library(*a[:3], groups, relu, a[3]),
                  x, s, b, r, dy)
    got = _kernel_backward(x, s, b, r, dy, groups, relu)
    assert torch.equal(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        if w is not None:
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("case,error", [
    ("3d", "expected"), ("bf16", "f32"), ("groups", "do not divide"),
    ("s_shape", "s must have shape"), ("residual", "does not match"),
    ("residual_dtype", "does not match"), ("b_shape", "b must have shape")])
def test_ops_validates_its_arguments(case, error):
    x, s, b, r, _ = _inputs((2, 8, 4, 4), 4, "residual", 4, "contiguous")
    args = {"x": x, "s": s, "b": b, "groups": 4, "residual": r}
    if case == "3d":
        args["x"] = x[0]
    elif case == "bf16":
        args["x"] = x.bfloat16()
    elif case == "groups":
        args["groups"] = 3
    elif case == "s_shape":
        args["s"] = s[:4]
    elif case == "b_shape":
        args["b"] = b[None]
    elif case == "residual_dtype":
        args["residual"] = r.double()
    else:
        args["residual"] = r[:1]
    with pytest.raises(ValueError, match=error):
        gops.group_norm_act(args["x"], args["s"], args["b"], args["groups"],
                            relu=True, residual=args["residual"])


# (kh, kw, cin, cout, stride, size): a 1x1, a 3x3, the stem, strided and odd
CONVS = [(1, 1, 8, 16, 1, 9), (3, 3, 8, 8, 1, 8), (7, 7, 3, 16, 2, 16),
         (3, 3, 8, 8, 2, 9), (1, 1, 16, 8, 2, 10)]


def _conv_case(kh, kw, cin, cout, stride, size, device="cpu", batch=2):
    rng = np.random.default_rng(kh * 100 + cin + size)
    ph = RN._same_pad(size, kh, stride)
    if ph[0] != ph[1]:
        size, ph = size + 1, (ph[1], ph[1])  # a symmetric case of that size
    x = torch.from_numpy(rng.standard_normal(
        (batch, cin, size, size)).astype(np.float32)).to(device)
    w = torch.from_numpy(rng.standard_normal(
        (cout, cin, kh, kw)).astype(np.float32) * 0.1).to(device)
    out = F.conv2d(x, w, stride=stride, padding=ph)
    g = torch.from_numpy(rng.standard_normal(
        tuple(out.shape)).astype(np.float32)).to(device)
    return x, w, g, (ph[0], ph[0])


@pytest.mark.parametrize("case", CONVS, ids=[f"{c[0]}x{c[1]}_{c[2]}to{c[3]}"
                                             f"_s{c[4]}_{c[5]}" for c in CONVS])
def test_channels_last_weight_gradient_matches_autograd(case):
    x, w, g, pad = _conv_case(*case)
    xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
    F.conv2d(xa, wa, stride=case[4], padding=pad).backward(g)
    got = RN._weight_grad(g, x, w, case[4], pad)
    assert got.shape == w.shape
    torch.testing.assert_close(got, wa.grad, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", list(MODES))
def test_model_norm_on_the_cpu_is_the_library_sequence(mode):
    relu, _ = MODES[mode]
    x, s, b, r, _ = _inputs((2, 16, 5, 5), 8, mode, 5, "channels_last")
    got = RN._norm(x, {"s": s, "b": b}, 8, relu=relu, residual=r)
    assert torch.equal(got, _library(x, s, b, 8, relu, r))


@pytest.mark.parametrize("mode", list(MODES))
def test_meta_tensors_take_the_plain_version(mode):
    relu, _ = MODES[mode]
    x, s, b, r, _ = _inputs((2, 8, 4, 4), 4, mode, 6, "contiguous")
    got = gops.group_norm_act(*(t.to("meta") for t in (x, s, b)), 4,
                              relu=relu,
                              residual=None if r is None else r.to("meta"))
    assert got.device.type == "meta" and got.shape == x.shape


def test_fused_path_only_on_the_card_in_f32():
    assert not RN._fused(torch.empty(2, 3, 4, 4))
    assert not RN._fused(torch.empty(2, 3, 4, 4, dtype=torch.bfloat16))
    assert not RN._fused(torch.empty(2, 3, 4, 4, device="meta"))


def test_wgrad_counters_ignore_the_cpu():
    cfg = get_arch("resnet50").smoke_config
    params = _tree({k: v.requires_grad_(True) for k, v in _leaves(
        RN.init_params(cfg, torch.Generator().manual_seed(0),
                       device="cpu")).items()})
    batch = {"images": torch.randn(2, 16, 16, 3),
             "labels": torch.tensor([1, 2])}
    keys = ("wgrad_channels_last", "wgrad_nchw")
    before = [tracing.counters()[k] for k in keys]
    loss, _ = RN.loss_fn(params, batch, cfg)
    loss.backward()
    assert [tracing.counters()[k] for k in keys] == before


# -- on the card ---------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _rel_close(got, want, rtol, atol_of_max):
    atol = atol_of_max * float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("chw", RESNET50_NORMS,
                         ids=[f"{c}x{h}x{w}" for c, h, w in RESNET50_NORMS])
def test_fused_op_matches_the_library_on_card(cuda, chw, mode):
    relu, _ = MODES[mode]
    x, s, b, r, dy = _inputs((2, *chw), 32, mode, chw[0] + chw[1],
                             "contiguous", device=cuda)
    want = _grads(lambda *a: _library(*a[:3], 32, relu, a[3]), x, s, b, r, dy)
    f0, b0 = K.forward_launches, K.backward_launches
    fused = lambda *a: gops.group_norm_act(*a[:3], 32, relu=relu,  # noqa: E731
                                           residual=a[3])
    got = _grads(fused, x, s, b, r, dy)
    assert (K.forward_launches - f0, K.backward_launches - b0) == (
        int(relu or r is not None), 1)
    assert torch.equal(got[0], want[0])
    _rel_close(got[1], want[1], 1e-4, 1e-5)
    _rel_close(got[2], want[2], 1e-4, 1e-4)
    _rel_close(got[3], want[3], 1e-4, 1e-4)
    if r is not None:
        assert torch.equal(got[4], torch.where(want[0] > 0, dy,
                                               torch.zeros_like(dy)))
    again = _grads(fused, x, s, b, r, dy)
    for g, a in zip(got, again):
        if g is not None:
            assert torch.equal(g, a)


@pytest.mark.gpu
def test_fused_op_takes_channels_last_and_odd_sizes_on_card(cuda):
    for shape, layout in (((3, 64, 7, 7), "channels_last"),
                          ((2, 32, 5, 3), "contiguous")):
        x, s, b, r, dy = _inputs(shape, 32, "residual", 9, layout, cuda)
        want = _grads(lambda *a: _library(*a[:3], 32, True, a[3]),
                      x, s, b, r, dy)
        got = _grads(lambda *a: gops.group_norm_act(*a[:3], 32, relu=True,
                                                    residual=a[3]),
                     x, s, b, r, dy)
        assert torch.equal(got[0], want[0])
        for g, w in zip(got[1:4], want[1:4]):
            _rel_close(g, w, 1e-4, 1e-4)


RESNET50_CONVS = [  # (kh, kw, cin, cout, stride, size) at 224^2
    (7, 7, 3, 64, 2, 229), (1, 1, 64, 64, 1, 56), (3, 3, 64, 64, 1, 56),
    (1, 1, 64, 256, 1, 56), (1, 1, 256, 64, 1, 56), (1, 1, 256, 128, 1, 56),
    (3, 3, 128, 128, 2, 57), (1, 1, 128, 512, 1, 28),
    (1, 1, 256, 512, 2, 56), (1, 1, 512, 128, 1, 28),
    (3, 3, 128, 128, 1, 28), (1, 1, 512, 256, 1, 28),
    (3, 3, 256, 256, 2, 29), (1, 1, 256, 1024, 1, 14),
    (1, 1, 512, 1024, 2, 28), (1, 1, 1024, 256, 1, 14),
    (3, 3, 256, 256, 1, 14), (1, 1, 1024, 512, 1, 14),
    (3, 3, 512, 512, 2, 15), (1, 1, 512, 2048, 1, 7),
    (1, 1, 1024, 2048, 2, 14), (1, 1, 2048, 512, 1, 7),
    (3, 3, 512, 512, 1, 7)]


@pytest.mark.gpu
@pytest.mark.parametrize("case", RESNET50_CONVS,
                         ids=[f"{c[0]}x{c[1]}_{c[2]}to{c[3]}_s{c[4]}_{c[5]}"
                              for c in RESNET50_CONVS])
def test_channels_last_weight_gradient_on_card(cuda, case):
    x, w, g, pad = _conv_case(*case, device=cuda)
    with RN._no_tf32():
        want = torch.ops.aten.convolution_backward(
            g, x, w, None, [case[4]] * 2, list(pad), [1, 1], False, [0, 0],
            1, [False, True, False])[1]
        got = RN._weight_grad(g, x, w, case[4], pad)
    _rel_close(got, want, 1e-4, 1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("arch,img,batch", [("smoke", 32, 4),
                                            ("resnet50", 64, 2)])
def test_fused_loss_matches_the_library_path(cuda, monkeypatch, arch, img,
                                             batch):
    spec = get_arch("resnet50")
    cfg = spec.smoke_config if arch == "smoke" else spec.config
    params = RN.init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                            device=cuda)
    rng = np.random.default_rng(7)
    data = {"images": torch.from_numpy(rng.standard_normal(
                (batch, img, img, 3)).astype(np.float32)).to(cuda),
            "labels": torch.from_numpy(rng.integers(
                0, cfg.n_classes, batch)).to(cuda)}
    names = sorted(_leaves(params))

    def run():
        leaves = {k: v.detach().clone().requires_grad_(True)
                  for k, v in _leaves(params).items()}
        loss, _ = RN.loss_fn(_tree(leaves), data, cfg)
        grads = torch.autograd.grad(loss, [leaves[k] for k in names])
        return loss.detach(), dict(zip(names, grads))

    keys = ("wgrad_channels_last", "wgrad_nchw")
    before = sum(tracing.counters()[k] for k in keys)
    f0, b0 = K.forward_launches, K.backward_launches
    loss, grads = run()
    n_convs = 1 + 3 * sum(cfg.blocks) + len(cfg.blocks)
    assert sum(tracing.counters()[k] for k in keys) - before == n_convs
    n_norms = n_convs
    assert K.forward_launches - f0 == n_norms - len(cfg.blocks)
    assert K.backward_launches - b0 == n_norms
    monkeypatch.setattr(RN, "_fused", lambda x: False)
    monkeypatch.setattr(RN, "group_norm_act",
                        lambda x, s, b, groups, relu, residual=None:
                        K.group_norm_act_torch(x, s, b, groups, relu,
                                               residual))
    want_loss, want = run()
    assert torch.equal(loss, want_loss)
    for k in names:
        torch.testing.assert_close(grads[k], want[k], rtol=1e-4, atol=1e-5,
                                   msg=lambda m, k=k: f"{k}: {m}")


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _tree(leaves):
    out: dict = {}
    for path, v in leaves.items():
        node = out
        *heads, last = path.split("/")
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = v
    return out


# the weight gradients ``_wgrad_channels_last`` runs in channels-last at
# 224^2: the 1x1 convolutions at 56^2 (cuDNN's slow NCHW weight gradient)
# and the stem (whose padded images are channels-last already)
CL_WGRAD = {(7, 7, 3, 64, 2, 229), (1, 1, 64, 64, 1, 56),
            (1, 1, 64, 256, 1, 56), (1, 1, 256, 64, 1, 56),
            (1, 1, 256, 128, 1, 56), (1, 1, 256, 512, 2, 56)}


@pytest.mark.parametrize("case", RESNET50_CONVS,
                         ids=[f"{c[0]}x{c[1]}_{c[2]}to{c[3]}_s{c[4]}_{c[5]}"
                              for c in RESNET50_CONVS])
def test_weight_gradient_layout_is_a_rule_by_shape(case):
    kh, kw, cin, cout, _, size = case
    x = torch.empty((32, cin, size, size), device="meta")
    if cin == 3:  # the stem: the images' permute, padded
        x = torch.empty((32, size, size, cin), device="meta").permute(
            0, 3, 1, 2)
    w = torch.empty((kh, kw, cin, cout), device="meta").permute(3, 2, 0, 1)
    assert RN._wgrad_channels_last(x, w) == (case in CL_WGRAD)
    assert RN._wgrad_channels_last(x[:2], w) == (case in CL_WGRAD)


def test_the_stem_input_is_channels_last():
    images = torch.zeros((2, 224, 224, 3))
    x = F.pad(images.permute(0, 3, 1, 2), (2, 3, 2, 3))
    assert x.is_contiguous(memory_format=CL)


@pytest.mark.gpu
def test_slow_nchw_weight_gradient_picks_channels_last(cuda):
    """At the cells' 32 images the 1x1 64 -> 256 convolution at 56^2 takes
    channels-last, and its device time there (copies included) is under
    half the NCHW call's (3.6 against 0.25 ms + copies, PERF.md)."""
    x, w, g, pad = _conv_case(1, 1, 64, 256, 1, 56, device=cuda, batch=32)
    assert RN._wgrad_channels_last(x, w)

    def nchw():
        torch.ops.aten.convolution_backward(
            g, x, w, None, [1, 1], list(pad), [1, 1], False, [0, 0], 1,
            [False, True, False])

    def split():
        RN._weight_grad(g, x, w, 1, pad)

    ms = {}
    with RN._no_tf32():
        for fn in (nchw, split):
            fn()
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            for _ in range(5):
                fn()
            end.record()
            end.synchronize()
            ms[fn.__name__] = start.elapsed_time(end) / 5
    assert ms["split"] < 0.5 * ms["nchw"], ms


@pytest.mark.gpu
def test_resnet50_weight_gradients_by_layout_on_card(cuda):
    """One forward and backward of ResNet-50 at 224^2 counts 10 weight
    gradients in channels-last (``CL_WGRAD`` with its calls) and 43 in
    NCHW, and launches the copy 19 times (two a split, one for the stem)."""
    from repro_torch.kernels.layout import kernel as L

    cfg = get_arch("resnet50").config
    params = RN.init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                            device=cuda)
    leaves = {k: v.requires_grad_(True) for k, v in _leaves(params).items()}
    data = {"images": torch.randn(2, 224, 224, 3, device=cuda),
            "labels": torch.tensor([1, 2], device=cuda)}
    keys = ("wgrad_channels_last", "wgrad_nchw")
    before = [tracing.counters()[k] for k in keys]
    n0 = L.launches
    loss, _ = RN.loss_fn(_tree(leaves), data, cfg)
    torch.autograd.grad(loss, list(leaves.values()))
    assert [tracing.counters()[k] - c for k, c in zip(keys, before)] == [
        10, 43]
    assert L.launches - n0 == 19
