"""The channels-last copy (``repro_torch.kernels.layout``).

On the CPU: the plain version is ``Tensor.contiguous(channels_last)``; the
CUDA wrapper's plan (which matrices the kernel transposes) reproduces the
channels-last memory of NCHW tensors and of other strides (OIHW views of
HWIO weights among them), written out with torch's transposes;
validation.

On the card (``gpu``): the kernel bit for bit against ``contiguous`` (a
copy rounds nothing) at ResNet-50's activation shapes at 224^2, batch 2,
and at other strides, and its launch count.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.layout import kernel as L  # noqa: E402
from repro_torch.kernels.layout import ops as lops  # noqa: E402

CL = torch.channels_last


def _tensor(shape, seed, device="cpu"):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                            ).to(device)


def _cases(device="cpu"):
    """(name, tensor): NCHW, an HWIO weight's OIHW view (3x3 and 1x1), a
    channels-last tensor, a sliced (non-contiguous) one, odd sizes."""
    return [
        ("nchw", _tensor((2, 5, 7, 3), 1, device)),
        ("hwio_3x3", _tensor((3, 3, 6, 8), 2, device).permute(3, 2, 0, 1)),
        ("hwio_1x1", _tensor((1, 1, 16, 4), 3, device).permute(3, 2, 0, 1)),
        ("already", _tensor((2, 4, 3, 3), 4, device).contiguous(
            memory_format=CL)),
        ("sliced", _tensor((2, 6, 9, 9), 5, device)[:, :, 1:, :-2]),
        ("odd", _tensor((3, 33, 5, 7), 6, device)),
    ]


@pytest.mark.parametrize("name,t", _cases(), ids=[c[0] for c in _cases()])
def test_plain_version_is_contiguous_channels_last(name, t):
    got = lops.to_channels_last(t)
    assert got.is_contiguous(memory_format=CL)
    assert torch.equal(got, t)


@pytest.mark.parametrize("name,t", _cases(), ids=[c[0] for c in _cases()])
def test_the_plan_transposes_into_channels_last_memory(name, t):
    if t.is_contiguous(memory_format=CL):
        return
    src, batch, c, p = L.plan(t)
    assert src.is_contiguous()
    moved = src.reshape(batch, c, p).transpose(1, 2).contiguous()
    want = t.contiguous(memory_format=CL)
    # the channels-last memory of ``t``, element for element
    mem = want.permute(0, 2, 3, 1).reshape(-1)
    assert torch.equal(moved.reshape(-1), mem)


@pytest.mark.parametrize("bad,error", [((2, 3, 4), "4-D"),
                                       ("bf16", "f32"), ("meta", "cuda or cpu")])
def test_ops_validates_its_argument(bad, error):
    if isinstance(bad, tuple):
        t = torch.zeros(bad)
    elif bad == "bf16":
        t = torch.zeros((1, 2, 3, 3), dtype=torch.bfloat16)
    else:
        t = torch.zeros((1, 2, 3, 3), device="meta")
    with pytest.raises(ValueError, match=error):
        lops.to_channels_last(t)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_kernel_matches_contiguous_on_card(cuda):
    for name, t in _cases(cuda):
        n0 = L.launches
        got = lops.to_channels_last(t)
        assert got.is_contiguous(memory_format=CL), name
        assert torch.equal(got, t), name
        assert L.launches - n0 == int(not t.is_contiguous(memory_format=CL))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 64, 112, 112), (2, 256, 56, 56),
                                   (2, 128, 57, 57), (2, 2048, 7, 7),
                                   (2, 512, 15, 15)])
def test_kernel_at_resnet50_activation_shapes(cuda, shape):
    t = _tensor(shape, 7, cuda)
    assert torch.equal(lops.to_channels_last(t), t)


@pytest.mark.gpu
@pytest.mark.parametrize("hwio", [(7, 7, 3, 64), (1, 1, 64, 256),
                                  (3, 3, 512, 512), (1, 1, 2048, 512)])
def test_kernel_at_resnet50_weight_shapes(cuda, hwio):
    w = _tensor(hwio, 8, cuda).permute(3, 2, 0, 1)
    got = lops.to_channels_last(w)
    assert got.is_contiguous(memory_format=CL) and torch.equal(got, w)
