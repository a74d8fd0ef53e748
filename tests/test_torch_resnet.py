"""The port's ResNet-50 (``repro_torch.models.resnet``) against the JAX
package's, on the same seeded inputs.

* ``_conv`` (stride 1 and 2, kernels 1, 3 and 7, even and odd sizes: XLA's
  "SAME" puts the odd pad on the high side) at rtol 1e-5 / atol 1e-5;
  the max-pool bitwise (a max rounds nothing); ``_gn`` at rtol 1e-5 /
  atol 1e-5.
* SMOKE ``loss_fn`` at rtol 1e-5 and every gradient leaf at rtol 1e-4 /
  atol 1e-5 (XLA and torch sum the convolutions in other orders), at the
  SMOKE image size 32 and at the odd sizes 33 and 17.
* ``_conv2d`` (the convolution with cuDNN's TF32 off) against autograd's
  ``F.conv2d``: output and both gradients bitwise, the flag off inside the
  forward and the backward and restored after.
* ``param_count`` equal to JAX's 25,557,032; the meta-device init has
  JAX's tree, shapes and dtypes.
* ``image_batches`` bitwise.
* 3 rounds of a 4-shard ``PBoxFabric``, K = 2 workers, momentum(0.1,
  0.9) (the vision family's default), against JAX's fabric from the same
  weights: the losses at rtol 1e-4, the parameters after every round at
  rtol 1e-4 / atol 1e-4 (the quickstart's momentum bound: lr 0.1 with
  momentum 0.9 grows a 1e-7 gradient difference over the rounds).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import torch.nn.functional as F  # noqa: E402

import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

from repro.configs.registry import get_arch as jax_get_arch  # noqa: E402
from repro.core.chunking import ParamSpace as JaxSpace  # noqa: E402
from repro.core.config import FabricConfig as JaxConfig  # noqa: E402
from repro.core.fabric import PBoxFabric as JaxFabric  # noqa: E402
from repro.core.fabric import WorkerHarness as JaxHarness  # noqa: E402
from repro.data.synthetic import image_batches as jax_image_batches  # noqa: E402
from repro.models import resnet as jr  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.core.chunking import ParamSpace  # noqa: E402
from repro_torch.core.config import FabricConfig  # noqa: E402
from repro_torch.core.fabric import PBoxFabric, WorkerHarness  # noqa: E402
from repro_torch.data.synthetic import image_batches  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.models import resnet as tr  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}/{k}"))
        return out
    if isinstance(tree, torch.Tensor):
        return {prefix: tree.detach().numpy()}
    return {prefix: np.asarray(tree)}


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("size", [8, 9, 16, 17])
@pytest.mark.parametrize("k,stride", [(1, 1), (3, 1), (1, 2), (3, 2),
                                      (7, 2)])
def test_conv_same_padding_matches_jax(size, k, stride):
    rng = np.random.default_rng(size * 10 + k + stride)
    x = rng.standard_normal((2, size, size, 5)).astype(np.float32)
    w = rng.standard_normal((k, k, 5, 6)).astype(np.float32)
    want = np.asarray(jr._conv(jnp.asarray(x), jnp.asarray(w), stride))
    got = _nhwc(tr._conv(_nchw(x), torch.from_numpy(w), stride))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("stride,padding", [(1, (0, 0)), (1, (1, 1)),
                                            (2, (0, 0)), (2, (3, 3))])
def test_conv2d_is_f32_convolution_forward_and_backward(stride, padding,
                                                        monkeypatch):
    rng = np.random.default_rng(stride * 10 + padding[0])
    x = torch.from_numpy(rng.standard_normal((2, 5, 9, 9)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((6, 5, 3, 3)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal(
        F.conv2d(x, w, stride=stride, padding=padding).shape
    ).astype(np.float32))

    def run(conv):
        xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
        y = conv(xa, wa)
        y.backward(g)
        return y.detach(), xa.grad, wa.grad

    want = run(lambda a, b: F.conv2d(a, b, stride=stride, padding=padding))
    seen = []
    conv2d, conv_bwd = F.conv2d, torch.ops.aten.convolution_backward

    def spy(fn):
        def call(*a, **k):
            seen.append(torch.backends.cudnn.allow_tf32)
            return fn(*a, **k)
        return call

    monkeypatch.setattr(F, "conv2d", spy(conv2d))
    monkeypatch.setattr(torch.ops.aten, "convolution_backward",
                        spy(conv_bwd))
    before = torch.backends.cudnn.allow_tf32
    got = run(lambda a, b: tr._conv2d(a, b, stride, padding))
    assert seen == [False, False]
    assert torch.backends.cudnn.allow_tf32 == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("size", [8, 9, 16, 17, 112])
def test_max_pool_matches_jax_bitwise(size):
    rng = np.random.default_rng(size)
    x = rng.standard_normal((2, size, size, 4)).astype(np.float32)
    x[0, -1, -1, :] = 9.0  # the high edge, inside only the padded window
    want = np.asarray(lax.reduce_window(
        jnp.asarray(x), -jnp.inf, lax.max, (1, 3, 3, 1), (1, 2, 2, 1),
        "SAME"))
    got = _nhwc(tr._max_pool(_nchw(x)))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("groups", [1, 4, 8])
def test_group_norm_matches_jax(groups):
    rng = np.random.default_rng(groups)
    x = (rng.standard_normal((3, 7, 5, 16)) * 3 + 1).astype(np.float32)
    g = {"s": rng.standard_normal(16).astype(np.float32),
         "b": rng.standard_normal(16).astype(np.float32)}
    want = np.asarray(jr._gn(jnp.asarray(x),
                             {k: jnp.asarray(v) for k, v in g.items()},
                             groups))
    got = _nhwc(tr._gn(_nchw(x), {k: torch.from_numpy(v)
                                  for k, v in g.items()}, groups))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _configs():
    return (jax_get_arch("resnet50").smoke_config,
            get_arch("resnet50").smoke_config)


@pytest.mark.parametrize("img", [32, 33, 17])
def test_smoke_loss_and_every_gradient_match_jax(img):
    jcfg, tcfg = _configs()
    jparams = jr.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    batch = next(image_batches(2, img, tcfg.n_classes, seed=1))
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jr.loss_fn(p, b, jcfg), has_aux=True))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    leaves = _flat(tparams)
    tracked = {k: torch.from_numpy(v.copy()).requires_grad_(True)
               for k, v in leaves.items()}

    def tree(prefix, node):
        if isinstance(node, dict):
            return {k: tree(f"{prefix}/{k}", v) for k, v in node.items()}
        return tracked[prefix]

    tloss, tmet = tr.loss_fn(tree("", tparams),
                             {k: torch.from_numpy(v) for k, v in batch.items()},
                             tcfg)
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    assert tmet["acc"].item() == float(jmet["acc"])
    jflat = _flat(jgrads)
    assert jflat.keys() == tracked.keys()
    for name, want in jflat.items():
        np.testing.assert_allclose(tracked[name].grad.numpy(), want,
                                   rtol=1e-4, atol=1e-5, err_msg=name)


def test_param_count_and_meta_init_match_jax():
    cfg = get_arch("resnet50").config
    jcfg = jax_get_arch("resnet50").config
    assert cfg.param_count() == jcfg.param_count() == 25_557_032
    meta = tr.init_params(cfg, None, device="meta")
    jshapes = jax.eval_shape(lambda: jr.init_params(jcfg,
                                                    jax.random.PRNGKey(0)))
    got = _map(lambda v: (tuple(v.shape), str(v.dtype)), meta)
    want = jax.tree.map(lambda s: (tuple(s.shape), f"torch.{s.dtype}"),
                        jshapes)
    assert got == want
    assert all(v.device.type == "meta" for v in _flat_t(meta))


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _flat_t(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _flat_t(v)]
    return [tree]


def test_init_draws_on_the_generator_device():
    cfg = get_arch("resnet50").smoke_config
    a = tr.init_params(cfg, torch.Generator().manual_seed(3))
    b = tr.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(_flat_t(a), _flat_t(b)))
    assert a["s0b0"]["g1"]["s"].dtype == torch.float32
    with pytest.raises(ValueError, match="generator lives on"):
        tr.init_params(cfg, torch.Generator().manual_seed(0), device="cuda")


@pytest.mark.parametrize("batch,img,seed", [(2, 32, 0), (3, 17, 5)])
def test_image_batches_are_the_same_stream(batch, img, seed):
    a, b = image_batches(batch, img, 10, seed), jax_image_batches(
        batch, img, 10, seed)
    for _ in range(3):
        x, y = next(a), next(b)
        assert x.keys() == y.keys()
        for k in x:
            assert x[k].dtype == y[k].dtype
            np.testing.assert_array_equal(x[k], y[k])


ROUNDS, WORKERS, SHARDS = 3, 2, 4


def _jax_fabric_loop(jparams, jcfg):
    space = JaxSpace.build(jparams)
    fab = JaxFabric(space, jopt.momentum(0.1, 0.9), space.flatten(jparams),
                    config=JaxConfig(num_shards=SHARDS, num_workers=WORKERS))
    streams = [jax_image_batches(2, 32, jcfg.n_classes, seed=w)
               for w in range(WORKERS)]
    lossg = jax.jit(jax.value_and_grad(
        lambda p, b: jr.loss_fn(p, b, jcfg)[0]))
    losses = []

    def grad_fn(p, w):
        loss, g = lossg(p, {k: jnp.asarray(v)
                            for k, v in next(streams[w]).items()})
        losses.append(float(loss))
        return g

    h = JaxHarness(fab, grad_fn, lambda w, s: w)
    flats = []
    for r in range(1, ROUNDS + 1):
        h.run(r)
        flats.append(np.asarray(fab.params))
    return losses, flats


def _torch_fabric_loop(jparams, tcfg):
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    space = ParamSpace.build(params)
    fab = PBoxFabric(space, topt.momentum(0.1, 0.9), space.flatten(params),
                     config=FabricConfig(num_shards=SHARDS,
                                         num_workers=WORKERS),
                     device="cpu")
    streams = [image_batches(2, 32, tcfg.n_classes, seed=w)
               for w in range(WORKERS)]
    losses = []

    def grad_fn(p, w):
        b = {k: torch.from_numpy(v) for k, v in next(streams[w]).items()}
        tracked = _map(lambda x: x.detach().requires_grad_(True), p)
        loss, _ = tr.loss_fn(tracked, b, tcfg)
        grads = iter(torch.autograd.grad(loss, _flat_t(tracked)))
        losses.append(loss.item())
        return _map(lambda _: next(grads), tracked)

    h = WorkerHarness(fab, grad_fn, lambda w, s: w)
    flats = []
    for r in range(1, ROUNDS + 1):
        h.run(r)
        flats.append(fab.params.numpy().copy())
    assert fab.stats.steps == ROUNDS
    return losses, flats


def test_fabric_rounds_match_jax():
    jcfg, tcfg = _configs()
    jparams = jr.init_params(jcfg, jax.random.PRNGKey(0))
    jlosses, jflats = _jax_fabric_loop(jparams, jcfg)
    tlosses, tflats = _torch_fabric_loop(jparams, tcfg)
    assert len(tlosses) == len(jlosses) == ROUNDS * WORKERS
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4)
    for r, (a, b) in enumerate(zip(tflats, jflats), start=1):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4,
                                   err_msg=f"round {r}")
