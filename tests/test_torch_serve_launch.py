"""The port's serving driver (``python -m repro_torch.launch.serve``),
in-process on the CPU.

Mirrors the six tests of tests/test_serve_launch.py: generation's
parameters come from a version-stamped read plane over a live fabric or a
checkpoint (bit-checked against the source inside the driver), the
freestanding-model path still works, and a fabric that ran zero training
rounds serves exactly the init params.  Beyond the mirror: with the JAX
package's init params carried over (``interop.params_from_numpy``), the
same arguments give JAX's read bits, read provenance and generated ids;
and a ``--mesh`` other than ``1x1`` raises.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro_torch.launch.serve import build_argparser, main, serve  # noqa: E402

FAST = ["--arch", "gemma3-1b", "--mesh", "1x1", "--batch", "2",
        "--prompt-len", "8", "--tokens", "3", "--seed", "0"]


def run(argv):
    return main(argv, device="cpu")


def test_fabric_source_serves_verified_read():
    out = run(FAST + ["--source", "fabric", "--train-rounds", "2",
                      "--serve-shards", "2", "--serve-replication", "2"])
    assert out["source"] == "fabric"
    assert out["generated"].shape == (2, 3)
    info = out["read"]
    assert info["version"] == 2 and info["staleness"] == 0
    assert info["replication"] == 2 and info["shards"] == 2
    assert "ReadPlane" in info["plane"]


def test_fabric_zero_rounds_matches_freestanding_model():
    served = run(FAST + ["--source", "fabric", "--train-rounds", "0"])
    legacy = run(FAST + ["--source", "model"])
    assert legacy["read"] is None
    np.testing.assert_array_equal(served["generated"], legacy["generated"])
    assert served["read"]["version"] == 0


def test_checkpoint_source_roundtrips_fabric_bits(tmp_path):
    args = FAST + ["--train-rounds", "1", "--serve-shards", "2"]
    live = run(args + ["--source", "fabric"])
    ckpt = run(args + ["--source", "checkpoint",
                       "--checkpoint", str(tmp_path)])
    np.testing.assert_array_equal(live["generated"], ckpt["generated"])
    assert ckpt["read"]["version"] == 1
    again = run(FAST + ["--source", "checkpoint", "--train-rounds", "0",
                        "--checkpoint", str(tmp_path)])
    np.testing.assert_array_equal(again["generated"], ckpt["generated"])


def test_checkpoint_source_serves_its_own_save_not_latest(tmp_path):
    run(FAST + ["--source", "checkpoint", "--train-rounds", "3",
                "--checkpoint", str(tmp_path)])
    out = run(FAST + ["--source", "checkpoint", "--train-rounds", "1",
                      "--checkpoint", str(tmp_path)])
    assert out["read"]["version"] == 1


def test_checkpoint_source_requires_dir():
    with pytest.raises(SystemExit):
        run(FAST + ["--source", "checkpoint"])


def test_argparser_defaults_route_through_the_fabric():
    from repro.launch.serve import build_argparser as jax_argparser

    args = build_argparser().parse_args([])
    assert args.source == "fabric"
    assert args.serve_replication >= 2
    assert vars(args) == vars(jax_argparser().parse_args([]))


def test_mesh_beyond_one_device_raises():
    with pytest.raises(NotImplementedError, match="item 6"):
        run(FAST + ["--mesh", "1x2", "--source", "model"])


@pytest.mark.parametrize("source,extra", [
    ("fabric", ["--train-rounds", "2", "--serve-shards", "2",
                "--serve-racks", "2", "--serve-replication", "2",
                "--max-staleness", "1"]),
    ("fabric", ["--train-rounds", "1", "--serve-shards", "3",
                "--serve-replication", "1", "--frontends", "2"]),
    ("checkpoint", ["--train-rounds", "1", "--serve-shards", "2"]),
    ("model", []),
])
def test_jax_weights_give_jax_bits_and_ids(source, extra, tmp_path):
    """JAX's init params carried over: the same argv gives the JAX
    driver's read bits (the served tree flattened), read provenance and
    generated ids."""
    from repro.core.chunking import ParamSpace as JaxSpace
    from repro.launch import serve as jserve
    from repro.configs.registry import get_arch as jax_get_arch
    from repro.models import transformer as jT
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.chunking import ParamSpace
    from repro_torch.interop import params_from_numpy

    argv = FAST + ["--source", source] + extra
    if source == "checkpoint":
        jargv = argv + ["--checkpoint", str(tmp_path / "jax")]
        argv = argv + ["--checkpoint", str(tmp_path / "port")]
    else:
        jargv = argv
    jout = jserve.main(jargv)
    jcfg = jax_get_arch("gemma3-1b").smoke_config
    jparams = jT.init_params(jcfg, jax.random.PRNGKey(0), tp=1)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    args = build_argparser().parse_args(argv)
    out = serve(get_arch("gemma3-1b").smoke_config, args, device="cpu",
                params=tparams)
    np.testing.assert_array_equal(out["generated"], jout["generated"])
    assert out["read"] == jout["read"]
    if source == "model":
        return
    jargs = jserve.build_argparser().parse_args(jargv)
    jspace = JaxSpace.build(jparams)
    jserved, _ = jserve._serve_params(jargs, jparams, jspace)
    jbits = np.asarray(jspace.flatten(jserved)).view(np.uint32)
    tbits = ParamSpace.build(out["params"]).flatten(out["params"])
    np.testing.assert_array_equal(tbits.numpy().view(np.uint32), jbits)
    # the whole read, chunk padding included (the tree above drops it):
    # the JAX driver's fabric after the same rounds
    jfab = jserve._build_fabric(jargs, jspace, jspace.flatten(jparams))
    jserve._train_rounds(jargs, jfab, jspace)
    read = out["plane"].frontends[0].flat
    np.testing.assert_array_equal(read.numpy().view(np.uint32),
                                  np.asarray(jfab.params).view(np.uint32))
