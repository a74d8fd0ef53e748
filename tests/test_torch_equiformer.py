"""EquiformerV2 in the port (``repro_torch.models.gnn.equiformer_v2``)
against the JAX package's, on the CPU, from JAX's parameters carried
across by ``repro_torch.interop``:

  * ``init_params`` has JAX's tree, shapes and dtypes (SMOKE, the full
    config and each cell's effective config, meta tensors for the full
    sizes), and the same parameter count; ``make_param_specs`` and
    ``grad_sync`` equal JAX's for tp in {1, 2, 4}, channel TP and edge
    parallelism;
  * the loss and every gradient for ``node_class`` (a random graph with
    masked edges) and ``graph_reg`` (a molecule batch), with remat on and
    off: the loss at rtol 1e-5, each gradient within 1e-5 of its leaf's
    largest entry (f32 sums in other orders); remat on == off bitwise;
  * the bf16 regime (``graph_full_large``'s carry): the carry's dtype
    after the embedding and after each layer equal to JAX's, the hidden
    states equal, the loss at rtol 1e-5 and each gradient within 2e-2 of
    its leaf's largest entry (bf16 cotangents summed in other orders);
  * the published degrees (l_max 6, m_max 2, 8 heads) at 16 channels,
    each gradient within 5e-5 of its leaf's largest entry;
  * the segment softmax with empty segments (their max is 0, not -inf)
    and masked edges (the -1e30 logits), at rtol 1e-6;
  * tests/test_models_smoke.py's rotation invariance: rotating every
    coordinate leaves the loss unchanged within 1e-4;
  * ``forward(dist_nodes=True)`` at one worker equals the plain forward.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_arch as jax_get_arch  # noqa: E402
from repro.data.graphs import random_graph, random_molecule_batch  # noqa: E402
from repro.models.common import Dist as JDist  # noqa: E402
from repro.models.gnn import equiformer_v2 as jEQ  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.models.common import count_params  # noqa: E402
from repro_torch.models.gnn import equiformer_v2 as EQ  # noqa: E402

GRAD_TOL = 1e-5  # of the leaf's largest entry, f32
BF16_GRAD_TOL = 2e-2


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k],
                                                         f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


def _cfgs(**kw):
    j = jax_get_arch("equiformer-v2").smoke_config
    t = get_arch("equiformer-v2").smoke_config
    jkw = {k: (jnp.bfloat16 if v is torch.bfloat16 else v)
           for k, v in kw.items()}
    return dataclasses.replace(j, **jkw), dataclasses.replace(t, **kw)


def _graph(task, cfg, seed=3):
    if task == "graph_reg":
        return random_molecule_batch(4, 8, 16, cfg.d_in, cfg.l_max,
                                     cfg.n_rbf, seed=seed)
    g = random_graph(24, 80, cfg.d_in, cfg.n_out, cfg.l_max, cfg.n_rbf,
                     seed=seed)
    g["edge_mask"][::7] = 0.0  # masked edges
    g["node_mask"][::5] = 0.0
    return g


def _both(jcfg, tcfg, g, jp=None):
    """(JAX loss, metrics, grads), (port loss, metrics, grads): JAX's
    parameters in both."""
    jp = jEQ.init_params(jcfg, jax.random.PRNGKey(0)) if jp is None else jp
    gj = jax.tree.map(jnp.asarray, g)
    (jl, jm), jg = jax.value_and_grad(
        lambda p: jEQ.loss_fn(p, gj, jcfg, JDist.none()), has_aux=True)(jp)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    tracked = {k: v for k, v in _leaves(tp)}
    for v in tracked.values():
        v.requires_grad_(True)
    gt = {k: torch.from_numpy(np.asarray(v)) for k, v in g.items()}
    tl, tm = EQ.loss_fn(tp, gt, tcfg)
    grads = torch.autograd.grad(tl, list(tracked.values()))
    jgrads = dict(_leaves(jax.tree.map(np.asarray, jg)))
    return ((float(jl), {k: float(v) for k, v in jm.items()}, jgrads),
            (tl.item(), {k: v.item() for k, v in tm.items()},
             dict(zip(tracked, grads))))


def _grads_close(got, want, tol):
    assert sorted(got) == sorted(want)
    for k in want:
        w, a = np.asarray(want[k], np.float32), got[k].float().numpy()
        scale = float(np.max(np.abs(w)))
        err = float(np.max(np.abs(a - w)))
        assert err <= tol * scale + 1e-12, (k, err, scale)


# -- parameters, specs, grad-sync ------------------------------------------


def _shapes(tree):
    return {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in _leaves(tree)}


def _eff_cfgs():
    """The SMOKE and full configs and every cell's effective full config
    (JAX's and the port's), as ``build_cell`` derives them."""
    import repro.launch.steps as jST

    from repro.launch.mesh import make_mesh

    out = [_cfgs(), (jax_get_arch("equiformer-v2").config,
                     get_arch("equiformer-v2").config)]
    jm = make_mesh((1, 1), ("data", "model"))
    for cell in jax_get_arch("equiformer-v2").cells:
        j = jST._gnn_graph_template(jm, cell, jax_get_arch(
            "equiformer-v2").config, ("data",), False)[2]
        t = get_arch("equiformer-v2").config
        t = dataclasses.replace(t, d_in=j.d_in, n_out=j.n_out, task=j.task,
                                dtype=torch.bfloat16 if j.dtype == jnp.bfloat16
                                else torch.float32)
        out.append((j, t))
    return out


@pytest.mark.parametrize("i", range(6))
def test_init_params_tree_shapes_and_count_equal_jax(i):
    jcfg, tcfg = _eff_cfgs()[i]
    want = jax.eval_shape(lambda: jEQ.init_params(jcfg,
                                                  jax.random.PRNGKey(0)))
    got = EQ.init_params(tcfg, None)
    assert all(v.device.type == "meta" for _, v in _leaves(got))
    assert _shapes(got) == _shapes(want)
    n = sum(int(np.prod(v.shape)) for _, v in _leaves(want))
    assert count_params(got) == n
    if i == 0:  # the SMOKE init draws real, finite, scaled numbers
        p = EQ.init_params(tcfg, torch.Generator().manual_seed(0))
        assert _shapes(p) == _shapes(want)
        assert torch.equal(p["layers"]["ln_a"], torch.ones_like(
            p["layers"]["ln_a"]))
        assert all(torch.isfinite(v).all() for _, v in _leaves(p))
        assert EQ.init_params(tcfg, None, device="meta")["embed"].is_meta


def test_full_config_count_is_the_published_size():
    """12 layers at C = 128, l_max 6: 35,085,736 parameters in molecule's
    config, the payload of its 35,086,336-element flat."""
    jcfg, tcfg = _eff_cfgs()[-1]  # molecule's effective config
    assert count_params(EQ.init_params(tcfg, None)) == 35_085_736


@pytest.mark.parametrize("tp", [1, 2, 4])
@pytest.mark.parametrize("ep", [False, True])
def test_specs_and_grad_sync_equal_jax(tp, ep):
    jcfg, tcfg = _cfgs(edge_parallel=ep)
    jspecs = jax.tree.map(tuple, jEQ.make_param_specs(jcfg, tp),
                          is_leaf=lambda x: not isinstance(x, dict))
    assert EQ.make_param_specs(tcfg, tp) == jspecs
    assert EQ.grad_sync(tcfg, tp) == jEQ.grad_sync(jcfg, tp)


# -- loss and gradients ----------------------------------------------------


@pytest.mark.parametrize("task", ["node_class", "graph_reg"])
@pytest.mark.parametrize("remat", [True, False])
def test_loss_and_grads_match_jax(task, remat):
    kw = {} if task == "node_class" else {"n_out": 1, "task": task}
    jcfg, tcfg = _cfgs(remat=remat, **kw)
    (jl, jm, jg), (tl, tm, tg) = _both(jcfg, tcfg, _graph(task, jcfg))
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    for k in jm:
        np.testing.assert_allclose(tm[k], jm[k], rtol=1e-5, atol=1e-7)
    _grads_close(tg, jg, GRAD_TOL)


def test_remat_on_equals_off_bitwise():
    _, on = _cfgs(remat=True)
    off = dataclasses.replace(on, remat=False)
    g = {k: torch.from_numpy(v) for k, v in _graph("node_class", on).items()}
    p = EQ.init_params(on, torch.Generator().manual_seed(1))
    out = []
    for cfg in (on, off):
        tracked = {k: v.detach().clone().requires_grad_(True)
                   for k, v in _leaves(p)}
        tree = {"embed": tracked["embed"], "head": tracked["head"],
                "layers": {k.split("/")[1]: v for k, v in tracked.items()
                           if k.startswith("layers/")}}
        loss, _ = EQ.loss_fn(tree, g, cfg)
        out.append((loss, torch.autograd.grad(loss, list(tracked.values()))))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


def test_bf16_carry_dtypes_values_and_grads_match_jax():
    """``graph_full_large``'s regime: bf16 compute over f32 parameters and
    f32 Wigner blocks.  The carry is bf16 after the embedding and after
    every layer in both packages, with the same values."""
    jcfg, tcfg = _cfgs(dtype=torch.bfloat16, remat=False)
    g = _graph("node_class", jcfg)
    jp = jEQ.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    gj = jax.tree.map(jnp.asarray, g)
    gt = {k: torch.from_numpy(np.asarray(v)) for k, v in g.items()}
    # the embedding's carry, then one layer at a time
    jx = jnp.zeros((24, jcfg.num_coef, jcfg.channels), jcfg.dtype).at[
        :, 0].set(gj["node_feat"].astype(jcfg.dtype) @ jp["embed"])
    tx = EQ.forward(dict(tp, layers={k: v[:0] for k, v in
                                     tp["layers"].items()}),
                    gt, dataclasses.replace(tcfg, n_layers=0))
    assert jx.dtype == jnp.bfloat16 and tx.dtype == torch.bfloat16
    np.testing.assert_array_equal(tx.float().numpy(),
                                  np.asarray(jx.astype(jnp.float32)))
    jdist, tdist = JDist.none(), None
    for li in range(jcfg.n_layers):
        jlp = jax.tree.map(lambda v: v[li], jp["layers"])
        tlp = {k: v[li] for k, v in tp["layers"].items()}
        jx = jEQ._layer(jx, jlp, gj, jcfg, jdist,
                        lambda h, s: jnp.take(h, s, axis=0))
        tx = EQ._layer(tx, tlp, gt, tcfg, EQ.Dist.none(),
                       lambda h, s: h.index_select(0, s))
        assert jx.dtype == jnp.bfloat16 and tx.dtype == torch.bfloat16
        np.testing.assert_array_equal(tx.float().numpy(),
                                      np.asarray(jx.astype(jnp.float32)))
    del tdist
    (jl, _, jg), (tl, _, tg) = _both(jcfg, tcfg, g, jp)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    _grads_close(tg, jg, BF16_GRAD_TOL)


def test_segment_softmax_empty_segments_and_masked_edges():
    rng = np.random.default_rng(0)
    seg = np.array([0, 0, 2, 2, 2, 5, 5, 3], np.int32)  # 1 and 4 empty
    logits = rng.normal(size=(8, 3)).astype(np.float32) * 4
    logits[5:7] = -1e30  # segment 5: every edge masked
    logits[2, 1] = -1e30  # one masked edge in segment 2
    want = np.asarray(jEQ._segment_softmax(jnp.asarray(logits),
                                           jnp.asarray(seg), 6))
    got = EQ._segment_softmax(torch.from_numpy(logits),
                              torch.from_numpy(seg), 6).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    # a segment of masked edges spreads its weight evenly, as in JAX
    np.testing.assert_allclose(got[5:7], 0.5)
    assert got[2, 1] == 0.0


def test_rotation_invariance():
    """tests/test_models_smoke.py:96 on the port: the graph-level output
    does not change when every coordinate is rotated."""
    from repro_torch.data.graphs import edge_geometry
    from repro_torch.data.graphs import random_graph as t_random_graph
    from repro_torch.models.gnn.spherical import rotation_to_z

    cfg = get_arch("equiformer-v2").smoke_config
    params = EQ.init_params(cfg, torch.Generator().manual_seed(0))
    g = t_random_graph(24, 80, cfg.d_in, cfg.n_out, cfg.l_max, cfg.n_rbf,
                       seed=3)
    rng = np.random.default_rng(0)
    R = rotation_to_z(rng.normal(size=(1, 3)))[0]
    coords = rng.normal(size=(24, 3))
    base = {k: g[k] for k in ("node_feat", "edge_src", "edge_dst",
                              "edge_mask", "node_mask", "labels")}
    losses = []
    for c in (coords, coords @ R.T):
        gg = dict(base)
        gg.update(edge_geometry(c, g["edge_src"], g["edge_dst"], cfg.l_max,
                                cfg.n_rbf))
        with torch.no_grad():
            loss, _ = EQ.loss_fn(params, {k: torch.from_numpy(v)
                                          for k, v in gg.items()}, cfg)
        assert np.isfinite(loss.item())
        losses.append(loss.item())
    assert abs(losses[0] - losses[1]) < 1e-4


def test_dist_nodes_at_one_worker_is_the_plain_forward():
    """Node-sharded mode over one data rank: the all-gather is the
    identity (as JAX's over a one-device axis)."""
    cfg = get_arch("equiformer-v2").smoke_config
    p = EQ.init_params(cfg, torch.Generator().manual_seed(2))
    g = {k: torch.from_numpy(v)
         for k, v in _graph("node_class", cfg).items()}
    d = EQ.Dist(model_axis=None, data_axes=("data",), tp=1)
    with torch.no_grad():
        a = EQ.forward(p, g, cfg, d, dist_nodes=True)
        b = EQ.forward(p, g, cfg)
    assert torch.equal(a, b)


@pytest.mark.parametrize("task", ["node_class", "graph_reg"])
def test_published_degrees_match_jax(task):
    """The published l_max 6, m_max 2, 8 heads and 32 radial bases (the
    index plans, the m = 2 maps and the head layout the SMOKE config does
    not reach) at 16 channels and 2 layers: the loss at rtol 1e-5, each
    gradient within 5e-5 of its leaf's largest entry (49 coefficients a
    node: ``gate_rbf``'s gradient, a sum over every edge and coefficient,
    reads 1.0e-5 of its largest entry in f32 sums of another order)."""
    kw = dict(l_max=6, m_max=2, n_heads=8, n_rbf=32, channels=16)
    if task == "graph_reg":
        kw.update(n_out=1, task=task)
    jcfg, tcfg = _cfgs(**kw)
    (jl, _, jg), (tl, _, tg) = _both(jcfg, tcfg, _graph(task, jcfg, seed=5))
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    _grads_close(tg, jg, 5 * GRAD_TOL)
