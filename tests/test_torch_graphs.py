"""The port's spherical harmonics and graph featurization
(``repro_torch.models.gnn.spherical``, ``repro_torch.data.graphs``):
tests/test_data.py's graph and spherical cases on the port (fanout
invariants with hypothesis, no self-loops, molecule edges inside their
graph, SH orthonormality, the Wigner hold-out), and every function held
bitwise against the JAX package's numpy modules for the same seeds,
``fanout_sample``'s ``rng.choice`` draws included."""
import numpy as np
import pytest

pytest.importorskip("torch")

try:
    from hypothesis import given, settings
    import hypothesis.strategies as st
except ImportError:  # optional dep: fixed-seed stand-in, no shrinking
    from _hypo_fallback import given, settings, st

from repro.data import graphs as jG  # noqa: E402
from repro.models.gnn import spherical as jS  # noqa: E402
from repro_torch.data import graphs as G  # noqa: E402
from repro_torch.models.gnn import spherical as S  # noqa: E402


def _same(a, b):
    """Equal dtype, shape and bits (dicts key by key, dataclasses field by
    field)."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _same(a[k], b[k])
        return
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def _dirs(n, seed):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    return d / np.linalg.norm(d, axis=1, keepdims=True)


# -- tests/test_data.py's cases on the port --------------------------------


@settings(max_examples=10, deadline=None)
@given(n=st.integers(20, 200), deg=st.integers(2, 8),
       fan1=st.integers(1, 5), fan2=st.integers(1, 5))
def test_fanout_sampler_invariants(n, deg, fan1, fan2):
    g = G.random_csr_graph(n, deg, 8, 3, seed=1)
    rng = np.random.default_rng(0)
    seeds = rng.choice(n, size=min(8, n), replace=False)
    pn, pe = 8 * (1 + fan1 + fan1 * fan2) + 8, 8 * (fan1 + fan1 * fan2) + 8
    sub = G.fanout_sample(g, seeds, (fan1, fan2), l_max=2, n_rbf=4, rng=rng,
                          pad_nodes=pn, pad_edges=pe)
    e = int(sub["edge_mask"].sum())
    assert (sub["edge_src"][:e] < pn).all()
    assert (sub["edge_dst"][:e] < pn).all()
    direct = sub["edge_dst"][:e][sub["edge_dst"][:e] < len(seeds)]
    counts = np.bincount(direct, minlength=len(seeds))
    assert (counts <= fan1 + fan2).all()
    assert sub["node_mask"][: len(seeds)].all()
    assert not sub["node_mask"][len(seeds):].any()
    # and the same subgraph, bit for bit, as the JAX package samples
    jrng = np.random.default_rng(0)
    jseeds = jrng.choice(n, size=min(8, n), replace=False)
    _same(sub, jG.fanout_sample(jG.random_csr_graph(n, deg, 8, 3, seed=1),
                                jseeds, (fan1, fan2), l_max=2, n_rbf=4,
                                rng=jrng, pad_nodes=pn, pad_edges=pe))


def test_no_self_loops_in_generators():
    g = G.random_graph(50, 300, 8, 3, l_max=2, n_rbf=4, seed=0)
    assert (g["edge_src"] != g["edge_dst"]).all()
    m = G.random_molecule_batch(4, 6, 12, 5, l_max=2, n_rbf=4, seed=0)
    assert (m["edge_src"] != m["edge_dst"]).all()
    # molecule edges stay within their graph block
    assert (m["edge_src"] // 6 == m["edge_dst"] // 6).all()


def test_sph_harm_orthonormality():
    """Monte-Carlo orthonormality of the real SH basis (l <= 3)."""
    dirs = _dirs(200000, 0)
    y = S.real_sph_harm(3, dirs)
    gram = 4 * np.pi * (y.T @ y) / len(dirs)
    np.testing.assert_allclose(gram, np.eye(16), atol=0.05)


def test_wigner_property_holdout():
    rng = np.random.default_rng(1)
    rot = S.rotation_to_z(rng.normal(size=(3, 3)))
    blocks = S.wigner_blocks(4, rot)
    dirs = rng.normal(size=(10, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    y = S.real_sph_harm(4, dirs)
    yr = S.real_sph_harm(4, np.einsum("eij,kj->eki", rot, dirs)
                         .reshape(-1, 3)).reshape(3, 10, -1)
    for l in range(5):
        pred = np.einsum("emn,kn->ekm", blocks[l], y[:, l * l:(l + 1) ** 2])
        np.testing.assert_allclose(pred, yr[:, :, l * l:(l + 1) ** 2],
                                   atol=1e-5)


def test_rotation_to_z_maps_edges_to_z_and_handles_the_poles():
    v = np.concatenate([_dirs(64, 2), [[0, 0, 1.0], [0, 0, -2.0]]])
    rot = S.rotation_to_z(v)
    z = np.einsum("eij,ej->ei", rot, v / np.linalg.norm(v, axis=1)[:, None])
    np.testing.assert_allclose(z, np.tile([0, 0, 1.0], (len(v), 1)),
                               atol=1e-12)
    np.testing.assert_allclose(np.einsum("eij,ekj->eik", rot, rot),
                               np.tile(np.eye(3), (len(v), 1, 1)), atol=1e-12)


# -- bitwise against the JAX package ---------------------------------------


@pytest.mark.parametrize("l_max", [0, 1, 2, 6])
def test_spherical_functions_equal_jax_bitwise(l_max):
    dirs = np.concatenate([_dirs(257, l_max), [[0, 0, 1.0], [0, 0, -1.0]]])
    _same(S._legendre_assoc(l_max, dirs[:, 2]),
          jS._legendre_assoc(l_max, dirs[:, 2]))
    _same(S.real_sph_harm(l_max, dirs), jS.real_sph_harm(l_max, dirs))
    _same(S._fit_basis(l_max), jS._fit_basis(l_max))
    rot = S.rotation_to_z(dirs * 3.0)
    _same(rot, jS.rotation_to_z(dirs * 3.0))
    blocks = S.wigner_blocks(l_max, rot)
    _same(blocks, jS.wigner_blocks(l_max, rot))
    _same(S.pack_wigner(blocks), jS.pack_wigner(blocks))
    assert S.wigner_layout(l_max) == jS.wigner_layout(l_max)
    assert S.packed_wigner_size(l_max) == jS.packed_wigner_size(l_max)
    assert S.pack_wigner(blocks).shape[1] == S.packed_wigner_size(l_max)


@pytest.mark.parametrize("seed", [0, 5])
def test_graph_generators_equal_jax_bitwise(seed):
    _same(G.radial_basis(np.linspace(0, 6, 41), 8),
          jG.radial_basis(np.linspace(0, 6, 41), 8))
    coords = np.random.default_rng(seed).normal(size=(12, 3))
    src, dst = np.arange(11), np.arange(1, 12)
    _same(G.edge_geometry(coords, src, dst, 3, 8),
          jG.edge_geometry(coords, src, dst, 3, 8))
    _same(G.random_graph(40, 160, 9, 5, 2, 8, seed=seed),
          jG.random_graph(40, 160, 9, 5, 2, 8, seed=seed))
    # the published molecule cell's shape and the driver's SMOKE one
    for b, npg, epg, d in ((4, 30, 64, 16), (2, 8, 16, 12)):
        _same(G.random_molecule_batch(b, npg, epg, d, 2, 8, seed=seed),
              jG.random_molecule_batch(b, npg, epg, d, 2, 8, seed=seed))
    a = G.random_csr_graph(300, 6, 7, 4, seed=seed)
    j = jG.random_csr_graph(300, 6, 7, 4, seed=seed)
    for f in ("indptr", "indices", "coords", "feats", "labels"):
        _same(getattr(a, f), getattr(j, f))
    assert a.n_nodes == j.n_nodes == 300


@pytest.mark.parametrize("pads", [(None, None), (40, 60), (12, 10)])
def test_fanout_sample_equals_jax_bitwise(pads):
    """Unpadded, padded, and truncated (pads below the sample's size)."""
    g = G.random_csr_graph(200, 5, 6, 3, seed=2)
    jg = jG.random_csr_graph(200, 5, 6, 3, seed=2)
    seeds = np.arange(0, 200, 25)
    got = G.fanout_sample(g, seeds, (3, 2), 2, 4, np.random.default_rng(9),
                          pad_nodes=pads[0], pad_edges=pads[1])
    want = jG.fanout_sample(jg, seeds, (3, 2), 2, 4, np.random.default_rng(9),
                            pad_nodes=pads[0], pad_edges=pads[1])
    _same(got, want)


@pytest.mark.parametrize("kind,workers", [
    ("graph_full", 1), ("graph_minibatch", 2), ("graph_full_large", 2),
    ("graph_molecule", 2)])
def test_cell_batch_layouts(kind, workers):
    """``cell_batch`` fills a template's shapes and dtypes in the layout
    its regime's batch spec cuts: minibatch ids local to each worker's
    block, full-large sources global and destinations local to the
    worker's node block, molecules the generator's."""
    n, e = 32 * workers, 96 * workers
    tmpl = {"node_feat": np.zeros((n, 5), np.float32),
            "edge_src": np.zeros((e,), np.int32)}
    if kind == "graph_molecule":
        tmpl["targets"] = np.zeros((4,), np.float32)
    g = G.cell_batch(kind, tmpl, 2, 4, seed=3, workers=workers)
    assert g["node_feat"].shape == (n, 5) and g["edge_src"].shape == (e,)
    assert g["wigner"].shape == (e, S.packed_wigner_size(2))
    assert g["edge_src"].dtype == g["edge_dst"].dtype == np.int32
    nl, el = n // workers, e // workers
    if kind == "graph_molecule":
        _same(g, G.random_molecule_batch(4, n // 4, e // 4, 5, 2, 4, seed=3))
    elif kind == "graph_minibatch":
        for w in range(workers):
            blk = slice(w * el, (w + 1) * el)
            assert (g["edge_src"][blk] < nl).all()
            assert (g["edge_dst"][blk] < nl).all()
    elif kind == "graph_full_large":
        dst = (np.arange(e) // el) * nl + g["edge_dst"]
        assert (g["edge_dst"] < nl).all() and (g["edge_src"] < n).all()
        assert (g["edge_src"] != dst).all()
    else:
        assert (g["edge_src"] != g["edge_dst"]).all()
