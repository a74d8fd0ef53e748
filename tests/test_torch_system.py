"""The mirror of tests/test_system.py on the port: the cell matrix, a tiny
LM learning through the port's ``PHubServer``, the error-feedback codec's
unbiasedness and the codecs' wire bytes.  (The modeled-bytes hierarchy
case has its mirror in tests/test_torch_exchange.py.)"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.registry import get_arch, list_cells  # noqa: E402
from repro_torch.core.chunking import ParamSpace  # noqa: E402
from repro_torch.core.compression import (  # noqa: E402
    CompressionConfig,
    decode,
    encode,
    init_ef_state,
)
from repro_torch.core.server import PHubServer, WorkerHarness  # noqa: E402
from repro_torch.data.synthetic import lm_batches  # noqa: E402
from repro_torch.models.transformer import (  # noqa: E402
    init_params,
    lm_loss_and_grad,
)
from repro_torch.optim.optimizers import adamw  # noqa: E402


def test_cell_matrix_is_complete():
    cells = list_cells()
    assert len(cells) == 40  # 5 LM x 4 + 1 GNN x 4 + 4 recsys x 4
    skips = [
        (a, s) for a, s in cells
        if get_arch(a).cell(s).skip_reason is not None
    ]
    # long_500k skipped exactly for the 4 pure full-attention LMs
    assert sorted(skips) == sorted([
        ("internlm2-1.8b", "long_500k"), ("qwen2-72b", "long_500k"),
        ("granite-moe-1b-a400m", "long_500k"), ("qwen2-moe-a2.7b", "long_500k"),
    ])


def test_single_device_training_learns():
    """Tiny LM through the PHub server: loss decreases over 30 steps."""
    torch.manual_seed(0)
    cfg = get_arch("gemma3-1b").smoke_config
    params = init_params(cfg, torch.Generator().manual_seed(0))
    space = ParamSpace.build(params, num_owners=1)
    srv = PHubServer(space, adamw(3e-3), space.flatten(params),
                     num_workers=2, device="cpu")
    data = [lm_batches(cfg.vocab, 4, 16, seed=w) for w in range(2)]
    batches = [[next(d) for _ in range(30)] for d in data]
    losses = []

    def grad_fn(p, wb):
        w, step = wb
        b = batches[w][step]
        loss, g = lm_loss_and_grad(p, torch.from_numpy(b["tokens"]),
                                   torch.from_numpy(b["labels"]), cfg)
        losses.append(float(loss))
        return g

    WorkerHarness(srv, grad_fn, lambda w, s: (w, s)).run(30)
    first = np.mean(losses[:4])
    last = np.mean(losses[-4:])
    assert last < first - 0.5, f"no learning: {first:.3f} -> {last:.3f}"


def test_compression_error_feedback_unbiased():
    """With EF, the long-run sum of decoded grads tracks the true sum."""
    cfg = CompressionConfig(codec="int8", chunk_elems=1024,
                            error_feedback=True)
    rng = np.random.default_rng(0)
    n = 4096
    ef = init_ef_state(cfg, n, device="cpu")
    true_sum = np.zeros(n)
    dec_sum = np.zeros(n)
    for _ in range(50):
        g = torch.from_numpy(rng.normal(size=n).astype(np.float32) * 0.1)
        payload, ef = encode(cfg, g, ef)
        d = decode(cfg, payload)
        true_sum += g.numpy()
        dec_sum += d.numpy()
    # residual bounded by the EF state, not growing with steps
    resid = np.abs(true_sum - dec_sum).max()
    assert resid < 0.02, resid


def test_compression_wire_bytes():
    assert CompressionConfig(codec="none").wire_bytes_per_elem == 4.0
    assert CompressionConfig(codec="bf16").wire_bytes_per_elem == 2.0
    assert CompressionConfig(codec="int8",
                             chunk_elems=8192).wire_bytes_per_elem < 1.01
