"""Per-arch smoke tests of the port (mirroring tests/test_models_smoke.py):
the reduced configs of the five LM archs, ResNet-50 and EquiformerV2, one
forward and backward on the CPU, finite values of the expected shapes;
the LMs also check decode == prefill (the greedy id after a decode step
equals the one a prefill of the longer prompt gives).

Against the JAX package: every full config's parameter count (and active
count) exactly, every config field, and the registry's ``list_archs`` /
``list_cells`` (with every cell's kind, params and skip reason) equal to
JAX's, every arch included.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import registry as jax_registry  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402

LM_ARCHS = ["gemma3-1b", "internlm2-1.8b", "qwen2-72b", "granite-moe-1b-a400m",
            "qwen2-moe-a2.7b"]
UNPORTED = ()  # every arch of the JAX registry is ported


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


@pytest.mark.parametrize("arch_id", LM_ARCHS)
def test_lm_smoke_train_and_decode(arch_id):
    from repro_torch.models import transformer as T

    cfg = get_arch(arch_id).smoke_config
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 16)))
    labs = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 16)))
    loss, met = T.lm_loss(params, toks, labs, cfg)
    assert np.isfinite(loss.item())
    assert met["ce"].item() < np.log(cfg.vocab) + 1.0
    assert (met["aux"].item() > 0) == (cfg.moe is not None)
    _, g = T.lm_loss_and_grad(params, toks, labs, cfg)
    gn = sum(float(torch.sum(x.float() ** 2)) for x in _leaves(g))
    assert np.isfinite(gn) and gn > 0

    with torch.no_grad():
        nxt, cache = T.prefill(params, toks, cfg, 32, dist=None)
        assert nxt.shape == (2,)
        nxt2, _ = T.decode_step(params, nxt, cache, 16, cfg)
        toks17 = torch.cat([toks, nxt[:, None].long()], dim=1)
        nxt2b, _ = T.prefill(params, toks17, cfg, 32)
    np.testing.assert_array_equal(nxt2.numpy(), nxt2b.numpy())


def test_lm_unrolled_decode_matches_prefill_for_global_only():
    """For an all-global arch the unrolled path replays the prompt to the
    prefill's next token."""
    from repro_torch.models import transformer as T

    cfg = get_arch("internlm2-1.8b").smoke_config
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 16)))
    with torch.no_grad():
        nxt, _ = T.prefill(params, toks, cfg, 32)
        cu = T.init_cache_unrolled(cfg, 2, 32, 1, device="cpu")
        cur = toks[:, 0]
        for i in range(1, 17):
            cur, cu = T.decode_step_unrolled(params, cur, cu, i - 1, cfg)
            if i < 16:
                cur = toks[:, i]
    np.testing.assert_array_equal(cur.numpy(), nxt.numpy())


def test_resnet_smoke():
    from repro_torch.models import resnet as RN

    cfg = get_arch("resnet50").smoke_config
    p = RN.init_params(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    b = {"images": torch.from_numpy(
        rng.normal(size=(2, 32, 32, 3)).astype(np.float32)),
        "labels": torch.from_numpy(
            rng.integers(0, cfg.n_classes, (2,)).astype(np.int32))}
    logits = RN.forward(p, b["images"], cfg)
    assert logits.shape == (2, cfg.n_classes)
    loss, met = RN.loss_fn(p, b, cfg)
    assert np.isfinite(loss.item()) and 0.0 <= met["acc"].item() <= 1.0


def test_gnn_smoke():
    """tests/test_models_smoke.py's GNN case on the port: the SMOKE config
    on a random graph, a finite loss and finite, nonzero gradients, the
    hidden state's shape; and the molecule regime's graph regression."""
    from repro_torch.data.graphs import random_graph, random_molecule_batch
    from repro_torch.models.gnn import equiformer_v2 as EQ

    cfg = get_arch("equiformer-v2").smoke_config
    params = EQ.init_params(cfg, torch.Generator().manual_seed(0))
    g = {k: torch.from_numpy(v) for k, v in random_graph(
        24, 80, cfg.d_in, cfg.n_out, cfg.l_max, cfg.n_rbf, seed=3).items()}
    x = EQ.forward(params, g, cfg)
    assert x.shape == (24, cfg.num_coef, cfg.channels)
    leaves = _leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    loss, met = EQ.loss_fn(params, g, cfg)
    assert np.isfinite(loss.item()) and 0.0 <= met["acc"].item() <= 1.0
    grads = torch.autograd.grad(loss, leaves)
    gn = sum(float(torch.sum(x ** 2)) for x in grads)
    assert np.isfinite(gn) and gn > 0
    import dataclasses

    rcfg = dataclasses.replace(cfg, n_out=1, task="graph_reg")
    m = {k: torch.from_numpy(v) for k, v in random_molecule_batch(
        4, 8, 16, cfg.d_in, cfg.l_max, cfg.n_rbf, seed=0).items()}
    with torch.no_grad():
        loss, met = EQ.loss_fn(EQ.init_params(rcfg, torch.Generator()
                                              .manual_seed(0)), m, rcfg)
    assert np.isfinite(loss.item()) and loss.item() == met["mse"].item()


@pytest.mark.parametrize("arch_id", LM_ARCHS + ["resnet50"])
def test_full_configs_param_counts(arch_id):
    """Exact parameter counts of the full configs against JAX's, inside
    the public sizes test_models_smoke.py bounds them by."""
    cfg = get_arch(arch_id).config
    jcfg = jax_registry.get_arch(arch_id).config
    assert cfg.param_count() == jcfg.param_count()
    if arch_id != "resnet50":
        assert cfg.active_param_count() == jcfg.active_param_count()
    bounds = {"gemma3-1b": (0.9e9, 1.6e9), "internlm2-1.8b": (1.5e9, 2.1e9),
              "qwen2-72b": (70e9, 76e9),
              "granite-moe-1b-a400m": (1.0e9, 1.7e9),
              "qwen2-moe-a2.7b": (13e9, 16e9),
              "resnet50": (25_557_032, 25_557_032)}[arch_id]
    assert bounds[0] <= cfg.param_count() <= bounds[1]
    if arch_id == "qwen2-moe-a2.7b":
        assert cfg.active_param_count() < 4.5e9
    if arch_id == "granite-moe-1b-a400m":
        assert cfg.active_param_count() < 0.8e9


def _cfg_fields(cfg):
    import dataclasses

    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if dataclasses.is_dataclass(v):
            v = _cfg_fields(v)
        elif isinstance(v, torch.dtype):
            v = str(v).removeprefix("torch.")
        elif not isinstance(v, (int, float, str, bool, tuple, type(None))):
            v = np.dtype(v).name  # a JAX dtype
        out[f.name] = v
    return out


@pytest.mark.parametrize("arch_id", LM_ARCHS + ["resnet50", "equiformer-v2"])
def test_configs_match_jax(arch_id):
    """Every field of the full and SMOKE configs (dtypes by name) and the
    arch's family, cells and microbatches."""
    a, j = get_arch(arch_id), jax_registry.get_arch(arch_id)
    assert _cfg_fields(a.config) == _cfg_fields(j.config)
    assert _cfg_fields(a.smoke_config) == _cfg_fields(j.smoke_config)
    assert (a.family, a.microbatches) == (j.family, j.microbatches)
    assert [(c.name, c.kind, c.params, c.skip_reason is None)
            for c in a.cells] == [(c.name, c.kind, c.params,
                                   c.skip_reason is None) for c in j.cells]


def test_registry_lists_match_jax_less_the_gnn():
    jarchs = [a for a in jax_registry.list_archs() if a not in UNPORTED]
    assert registry.list_archs() == jarchs
    for assigned in (True, False):
        jcells = [c for c in jax_registry.list_cells(assigned)
                  if c[0] not in UNPORTED]
        assert registry.list_cells(assigned) == jcells
    assert ("resnet50", "imagenet_train") not in registry.list_cells()
    assert ("resnet50", "imagenet_train") in registry.list_cells(False)
    assert registry.list_archs() == jax_registry.list_archs()
    assert get_arch("equiformer-v2").family == "gnn"
    assert ("equiformer-v2", "molecule") in registry.list_cells()
    with pytest.raises(KeyError, match="unknown arch"):
        get_arch("no-such-arch")
