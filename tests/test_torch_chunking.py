"""The port's chunk space against the JAX package's: the same slot names,
offsets, sizes and chunk counts for the same trees, and the same flat bits,
so every chunk id means the same tensor elements in both packages."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from test_fabric import quad_setup  # noqa: E402

from repro.configs.registry import get_arch as jax_get_arch  # noqa: E402
from repro.core.chunking import ParamSpace as JaxSpace  # noqa: E402
from repro.core.chunking import tensor_chunk_map as jax_chunk_map  # noqa: E402
from repro.models.transformer import init_params as jax_init  # noqa: E402
from repro_torch.core.chunking import TILE_ELEMS, ParamSpace, tensor_chunk_map  # noqa: E402
from repro_torch.interop import params_from_numpy, params_to_numpy  # noqa: E402


def smoke_tree():
    cfg = jax_get_arch("gemma3-1b").smoke_config
    return jax_init(cfg, jax.random.PRNGKey(0), tp=1)


def quad_tree():
    return quad_setup()[0]


def as_numpy(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("make", [smoke_tree, quad_tree], ids=["smoke", "quad"])
@pytest.mark.parametrize("chunk,owners", [(TILE_ELEMS, 1), (8192, 4), (2048, 3)])
def test_layout_matches_jax(make, chunk, owners):
    jtree = make()
    ttree = params_from_numpy(as_numpy(jtree), "cpu")
    js = JaxSpace.build(jtree, chunk_elems=chunk, num_owners=owners)
    ts = ParamSpace.build(ttree, chunk_elems=chunk, num_owners=owners)
    assert [s.name for s in ts.slots] == [s.name for s in js.slots]
    assert [(s.offset, s.size, s.shape) for s in ts.slots] == [
        (s.offset, s.size, s.shape) for s in js.slots]
    assert (ts.flat_elems, ts.num_chunks, ts.payload_elems) == (
        js.flat_elems, js.num_chunks, js.payload_elems)
    assert tensor_chunk_map(ts) == jax_chunk_map(js)
    assert ts.describe() == js.describe()
    # the same flat bits
    np.testing.assert_array_equal(
        np.asarray(js.flatten(jtree)).view(np.uint32),
        ts.flatten(ttree).numpy().view(np.uint32))


def test_transformer_slot_order_is_sorted_keys():
    ts = ParamSpace.build(params_from_numpy(as_numpy(smoke_tree()), "cpu"))
    assert [s.name for s in ts.slots] == [
        "['embed']", "['head']",
        *[f"['layers']['{k}']" for k in
          ("ln1", "ln2", "w1", "w2", "w3", "wk", "wo", "wq", "wv")],
        "['ln_f']"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_unflatten_roundtrips(dtype):
    rng = np.random.default_rng(0)
    tree = {"a": torch.from_numpy(rng.standard_normal((3, 5)).astype(np.float32)).to(dtype),
            "z": {"b": torch.from_numpy(rng.standard_normal(7).astype(np.float32)).to(dtype),
                  "c": torch.ones((), dtype=dtype)}}
    space = ParamSpace.build(tree, chunk_elems=TILE_ELEMS, num_owners=2)
    out = space.unflatten(space.flatten(tree))
    assert out.keys() == tree.keys() and out["z"].keys() == tree["z"].keys()
    for got, want in ((out["a"], tree["a"]), (out["z"]["b"], tree["z"]["b"]),
                      (out["z"]["c"], tree["z"]["c"])):
        assert got.dtype == dtype and got.shape == want.shape
        assert torch.equal(got, want)
    assert not space.flatten(tree)[space.payload_elems:].any()


def test_interop_roundtrips_bf16_bits():
    x = jnp.asarray(np.random.default_rng(1).standard_normal((4, 9)),
                    jnp.bfloat16)
    t = params_from_numpy({"x": np.asarray(x)}, "cpu")["x"]
    assert t.dtype == torch.bfloat16
    back = params_to_numpy({"x": t}, bf16_dtype=np.asarray(x).dtype)["x"]
    assert back.dtype == np.asarray(x).dtype
    np.testing.assert_array_equal(back.view(np.uint16),
                                  np.asarray(x).view(np.uint16))
    # and the values agree with JAX's own widening to f32
    np.testing.assert_array_equal(t.float().numpy(),
                                  np.asarray(x.astype(jnp.float32)))


def test_build_validation_matches_jax():
    tree = {"a": torch.zeros(4)}
    for bad in (dict(chunk_elems=1000), dict(num_owners=0)):
        with pytest.raises(ValueError):
            ParamSpace.build(tree, **bad)
        with pytest.raises(ValueError):
            JaxSpace.build({"a": jnp.zeros(4)}, **bad)
    with pytest.raises(TypeError):
        ParamSpace.build({"a": [torch.zeros(2)]})


@pytest.mark.parametrize("make", [smoke_tree, quad_tree], ids=["smoke", "quad"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_zeros_like_space_matches_jax(make, dtype):
    """A zero slab of the padded flat length, in the asked dtype, on the
    asked device (the card when none is given, which raises here)."""
    from repro.core.chunking import zeros_like_space as jax_zeros
    from repro_torch.core.chunking import zeros_like_space

    jtree = make()
    js = JaxSpace.build(jtree, chunk_elems=2048, num_owners=3)
    ts = ParamSpace.build(params_from_numpy(as_numpy(jtree), "cpu"),
                          chunk_elems=2048, num_owners=3)
    ref = np.asarray(jax_zeros(js, getattr(jnp, dtype)))
    out = zeros_like_space(ts, getattr(torch, dtype), device="cpu")
    assert out.shape == ref.shape == (ts.flat_elems,)
    assert out.dtype == getattr(torch, dtype) and out.device.type == "cpu"
    np.testing.assert_array_equal(out.float().numpy(), ref.astype(np.float32))
    assert zeros_like_space(ts, device="cpu").dtype == torch.float32
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            zeros_like_space(ts)
