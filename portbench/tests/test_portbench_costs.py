"""The yardstick's arithmetic against closed forms: the FLOPs of a forward
and backward counted on meta tensors, and the least bytes of a server
update."""
import math

import pytest

from portbench import harness
from portbench.families import equiformer, resnet
from portbench.tests.small import files
from portbench.yardstick.costs import step_flops, update_bytes
from portbench.yardstick.inputs import make_params


def _same(n, stride):
    return -(-n // stride)


def resnet_flops(cfg, batch, img):
    """2 N Ho Wo Cout Cin kh kw a convolution, three times over (forward,
    input and weight gradients) but the stem's (its input, the images,
    takes no gradient); the head's product three times."""
    total = 0

    def conv(h, cin, cout, k, stride, first=False):
        nonlocal total
        ho = _same(h, stride)
        total += 2 * batch * ho * ho * cout * cin * k * k * (2 if first else 3)
        return ho

    h = conv(img, 3, 64, 7, 2, first=True)
    h = _same(h, 2)  # max-pool
    cin = 64
    for si, (n, w) in enumerate(zip(cfg["blocks"], cfg["widths"])):
        for bi in range(n):
            stride = 2 if (bi == 0 and si > 0) else 1
            conv(h, cin, w // 4, 1, 1)
            ho = conv(h, w // 4, w // 4, 3, stride)
            conv(ho, w // 4, w, 1, 1)
            if bi == 0:
                conv(h, cin, w, 1, stride)
            h, cin = ho, w
    return total + 3 * 2 * batch * cin * cfg["n_classes"]


def equiformer_flops(cfg, batch, atoms, edges):
    """Per layer: the two rotations (Wigner blocks by the irreps, the
    blocks take no gradient), the radial gates (the basis takes none), the
    SO(2) maps, the attention logits and the four channel mixes; the
    embedding (its features take none) and the head once."""
    n, e = batch * atoms, batch * edges
    c, h, r = cfg["channels"], cfg["n_heads"], cfg["n_rbf"]
    n0, m = cfg["l_max"] + 1, cfg["m_max"]
    k = n0 * n0
    wig = sum((2 * l + 1) ** 2 for l in range(n0))
    layer = 2 * (2 * 2 * e * wig * c)  # rotate, rotate back: fwd + dx
    layer += 2 * 2 * e * r * (m + 1)  # gates: fwd + dw
    so2 = (n0 * c) ** 2 + sum(4 * ((n0 - j) * c) ** 2 for j in range(1, m + 1))
    layer += 3 * 2 * e * so2
    layer += 3 * 2 * e * n0 * c * h  # attention logits
    layer += 3 * 2 * n * (k * c * c + k * c * 2 * c + c * 2 * c + k * 2 * c * c)
    return (cfg["n_layers"] * layer + 2 * 2 * n * cfg["d_in"] * c
            + 3 * 2 * n * c * cfg["n_out"])


@pytest.mark.parametrize("small", [True, False])
def test_resnet_flops_closed_form(small):
    f = files("resnet50.phub_k2_f32") if small else harness.cell_files(
        "resnet50.phub_k2_f32")
    cfg, tr = f["config"], f["traffic"]
    meta = make_params(resnet.param_spec(cfg, tr), 0, "meta")
    got = step_flops(resnet.meta_loss(cfg, tr), meta, resnet.meta_batch(cfg, tr))
    assert got == resnet_flops(cfg, tr["batch"], tr["img"])
    if not small:  # ResNet-50: ~4.1 GMACs an image forward at 224^2
        assert 3 * 2 * 4.0e9 < got / tr["batch"] < 3 * 2 * 4.2e9


@pytest.mark.parametrize("small", [True, False])
def test_equiformer_flops_closed_form(small):
    w = "equiformer-v2.spmd_molecule"
    f = files(w) if small else harness.cell_files(w)
    cfg, tr = f["config"], f["traffic"]
    meta = make_params(equiformer.param_spec(cfg, tr), 0, "meta")
    got = step_flops(equiformer.meta_loss(cfg, tr), meta,
                     equiformer.meta_batch(cfg, tr))
    assert got == equiformer_flops(cfg, tr["batch"], tr["atoms"], tr["edges"])


@pytest.mark.parametrize("k,opt,codec,per_n", [
    (2, "momentum", "none", 24), (1, "adamw", "none", 28),
    (1, "momentum", "none", 20), (4, "sgd", "none", 24),
    (2, "adamw", "bf16", 28)])
def test_update_bytes_closed_form(k, opt, codec, per_n):
    n = 25_557_032
    assert update_bytes(n, k, opt, codec, 8192) == per_n * n


def test_update_bytes_int8_counts_a_scale_a_chunk():
    n, chunk = 25_557_032, 8192
    scales = 4 * math.ceil(n / chunk)
    assert update_bytes(n, 8, "momentum", "int8", chunk) == 8 * (n + scales) + 16 * n
