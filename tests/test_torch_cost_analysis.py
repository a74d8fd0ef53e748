"""``launch/cost_analysis`` (the port's counterpart of
``launch/hlo_analysis.py``) and ``launch/roofline``: the counterparts of
tests/test_hlo_analysis.py on meta tensors, the kernels charged as custom
calls, the peak of live bytes, the meta count against a real step's, the
FLOP count against JAX's ``analyze_hlo`` on the same model, and the
roofline's terms on a hand-made record."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import roofline  # noqa: E402
from repro_torch.launch.cost_analysis import CostMode, step_costs  # noqa: E402
from repro_torch.launch.mesh import RecordingMesh  # noqa: E402
from repro_torch.models.common import Dist  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _layer_loop(ws, x):
    for w in ws:
        x = x @ w
    return x


def test_layer_loop_flops_exact():
    """A 10-layer loop of 4x128 @ 128x128 counts 2*4*128*128 a layer."""
    w = _meta(10, 128, 128)
    _, c = step_costs(lambda x: _layer_loop(w.unbind(0), x), _meta(4, 128))
    assert c["flops"] == 2 * 4 * 128 * 128 * 10
    assert c["flops_by_dtype"] == {"f32": 2 * 4 * 128 * 128 * 10}


def test_loop_matches_unrolled():
    """The layers of one unbound stack cost what six separate weights
    called one by one cost, FLOPs and bytes."""
    stack = _meta(6, 128, 128)
    ws = [_meta(128, 128) for _ in range(6)]
    x = _meta(4, 128)
    _, rolled = step_costs(lambda x: _layer_loop(stack.unbind(0), x), x)
    _, unrolled = step_costs(
        lambda x: x @ ws[0] @ ws[1] @ ws[2] @ ws[3] @ ws[4] @ ws[5], x)
    assert rolled["flops"] == unrolled["flops"]
    assert rolled["bytes"] == unrolled["bytes"]


def test_nested_loops():
    w = _meta(10, 128, 128)

    def outer(x):
        for _ in range(3):
            x = _layer_loop(w.unbind(0), x)
        return x

    _, c = step_costs(outer, _meta(4, 128))
    assert c["flops"] == 2 * 4 * 128 * 128 * 10 * 3


def test_stacked_params_bytes_not_multiplied():
    """An (L, D, D) stack unbound once is charged ~once, not L times."""
    L, D = 16, 256
    w = _meta(L, D, D)

    def f(x):
        for wl in w.unbind(0):
            x = torch.tanh(x @ wl)
        return x

    _, c = step_costs(f, _meta(8, D))
    stack_bytes = L * D * D * 4
    assert c["bytes"] < 3.5 * stack_bytes, c["bytes"] / stack_bytes
    assert c["bytes"] >= stack_bytes  # every layer's weights read once


@pytest.mark.parametrize("through", ["mesh", "dist"])
def test_collectives_inside_loop_multiplied(through):
    """7 psums of 1024 f32 over a recording model axis of 4: 7*1024*4 raw
    all-reduce bytes, 2 (g-1)/g of that on the wire."""
    mesh = RecordingMesh((4,), ("model",))
    dist = Dist("model", (), 4, mesh)

    def f(x):
        for _ in range(7):
            x = mesh.psum(x, "model") if through == "mesh" else \
                dist.psum_model(x)
        return x

    step_costs(f, _meta(1024))
    c = mesh.collective_bytes()
    assert c["raw_all-reduce"] == 7 * 1024 * 4
    assert c["wire_all-reduce"] == 7 * 1024 * 4 * 2 * 3 / 4
    assert c["total"] == 7 * 1024 * 4
    assert mesh.collectives["all-reduce"]["calls"] == 7


def test_recording_mesh_shapes_and_factors():
    mesh = RecordingMesh((2, 16, 16), ("pod", "data", "model"), rank=37)
    assert mesh.coords == {"pod": 0, "data": 2, "model": 5}
    assert mesh.axis_index(("pod", "data")) == 2
    x = _meta(64, 3)
    assert mesh.psum_scatter(x, ("pod", "data")).shape == (2, 3)
    assert mesh.all_gather(x, "model", axis=1).shape == (64, 48)
    assert mesh.all_gather(x, "model", tiled=False).shape == (16, 64, 3)
    assert mesh.pmax(x, "model").shape == (64, 3)
    assert mesh.psum(x, ()) is x  # no axes: the identity, not recorded
    c = mesh.collective_bytes()
    assert c["wire_reduce-scatter"] == 2 * 3 * 4 * 31
    assert c["wire_all-gather"] == 64 * 48 * 4 * 15 / 16 + 16 * 64 * 3 * 4 * 15 / 16
    assert mesh.collectives["all-reduce"]["calls"] == 1


def test_kernels_charged_as_custom_calls():
    """On meta tensors ``fused_aggregate_update`` runs nothing: one launch,
    its operands and outputs once, 0 FLOPs, the state updated in place;
    the plain version's many ops are not charged."""
    from repro_torch.kernels.fused_agg_opt.ops import fused_aggregate_update
    from repro_torch.kernels.quant.ops import dequantize_chunks, quantize_chunks
    from repro_torch.optim.optimizers import adamw

    n = 8192
    g, p, m, v = _meta(2, n), _meta(n), _meta(n), _meta(n)
    step = _meta(dtype=torch.int32)

    def f():
        new_p, new_s = fused_aggregate_update(g, p, (m, v), adamw(1e-3), step)
        assert new_p is p and new_s[0] is m and new_s[1] is v
        q, s = quantize_chunks(p, 1024)
        return dequantize_chunks(q, s, 1024)

    _, c = step_costs(f)
    assert c["flops"] == 0
    assert c["kernels"]["fused_agg_opt"] == {"launches": 1,
                                             "bytes": (2 * n + 3 * n) * 4}
    assert c["kernels"]["quantize_chunks"] == {
        "launches": 1, "bytes": n * 4 + n + 8 * 4}
    assert c["kernels"]["dequantize_chunks"]["launches"] == 1
    assert c["bytes"] == sum(k["bytes"] for k in c["kernels"].values())
    cpu = [torch.randn(t.shape) for t in (g, p, m)] + [torch.rand(n)]
    _, plain = step_costs(lambda: fused_aggregate_update(
        cpu[0], cpu[1], (cpu[2], cpu[3]), adamw(1e-3), 1))
    assert plain["ops"] > 20 and not plain["kernels"]


def test_peak_estimate_tracks_frees():
    """Live bytes rise with each new storage and fall when it is freed;
    views add nothing."""
    x = _meta(1024)  # 4 KiB argument

    def f(x):
        a = x * 2  # +4 KiB
        b = a.view(32, 32)  # a view: no new storage
        del a
        c = b + 1  # +4 KiB: 12 KiB live
        del b, c  # a and c freed
        return x.sum()

    _, c = step_costs(f, x)
    assert c["peak_estimate"] == 3 * 4096
    mode = CostMode()
    with mode:
        y = torch.empty(256, device="meta") + 1
    assert mode.live >= 1024 and mode.peak >= 2048
    del y
    assert mode.live == 0


def test_flops_split_by_dtype():
    a, b = _meta(4, 8, dtype=torch.bfloat16), _meta(8, 16,
                                                     dtype=torch.bfloat16)
    _, c = step_costs(lambda: (a @ b, a.float() @ b.float()))
    assert c["flops_by_dtype"] == {"bf16": 2 * 4 * 8 * 16,
                                   "f32": 2 * 4 * 8 * 16}


def _smoke_lm_costs(device):
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.models import transformer as T

    cfg = get_arch("gemma3-1b").smoke_config
    b = next(lm_batches(cfg.vocab, 2, 32, seed=0))
    toks, labs = (torch.from_numpy(b[k]).to(device)
                  for k in ("tokens", "labels"))
    params = (T.abstract_params(cfg) if device == "meta" else
              T.init_params(cfg, torch.Generator().manual_seed(0)))
    return step_costs(T.lm_loss_and_grad, params, toks, labs, cfg)[1]


def test_meta_count_equals_a_real_steps():
    """The SMOKE LM loss and gradient counted on meta tensors and over a
    real CPU step: the same FLOPs by dtype, exactly."""
    meta, real = _smoke_lm_costs("meta"), _smoke_lm_costs("cpu")
    assert meta["flops"] > 0
    assert meta["flops_by_dtype"] == real["flops_by_dtype"]


_JAX_FLOPS = r"""
import json, sys
import jax, jax.numpy as jnp
from repro.configs.registry import get_arch
from repro.data.synthetic import lm_batches
from repro.launch.hlo_analysis import analyze_hlo
from repro.models.common import Dist
from repro.models import transformer as T
import dataclasses
cfg = dataclasses.replace(get_arch("gemma3-1b").smoke_config, remat=False)
b = next(lm_batches(cfg.vocab, 2, 32, seed=0))
p = jax.eval_shape(lambda: T.init_params(cfg, jax.random.PRNGKey(0), tp=1))
f = jax.jit(jax.value_and_grad(
    lambda p, t, l: T.lm_loss(p, t, l, cfg, Dist.none(), 1)[0]))
txt = f.lower(p, jnp.asarray(b["tokens"]), jnp.asarray(b["labels"])).compile().as_text()
print("FLOPS " + json.dumps(analyze_hlo(txt)["flops"]))
"""


def test_flops_match_jax_analyze_hlo():
    """The port's FLOPs for the gemma3-1b SMOKE loss and gradient (remat
    off, 2 x 32 tokens) within rtol 2e-2 of JAX's trip-aware HLO count on
    the same config and batch (JAX in a subprocess)."""
    import dataclasses

    from repro_torch.configs.registry import get_arch
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.models import transformer as T

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _JAX_FLOPS],
                         capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    jax_flops = json.loads(out.stdout.split("FLOPS ")[-1])
    cfg = dataclasses.replace(get_arch("gemma3-1b").smoke_config, remat=False)
    b = next(lm_batches(cfg.vocab, 2, 32, seed=0))
    toks, labs = (torch.from_numpy(b[k]).to("meta")
                  for k in ("tokens", "labels"))
    _, c = step_costs(T.lm_loss_and_grad, T.abstract_params(cfg), toks, labs,
                      cfg)
    print(f"port {c['flops']:.6g} FLOPs, JAX analyze_hlo {jax_flops:.6g}")
    assert c["flops"] == pytest.approx(jax_flops, rel=2e-2)


def test_roofline_on_a_hand_made_record():
    rec = {"status": "ok", "n_devices": 4,
           "flops_per_device": 67e12 + 989.4e12,
           "flops_by_dtype": {"f32": 67e12, "bf16": 989.4e12},
           "bytes_per_device": 4 * 3.35e12, "bytes_min_per_device": 3.35e12,
           "collective_bytes_per_device": {"wire_total": 450e9 * 3},
           "memory": {"peak_estimate": 2**31},
           "meta": {"model_flops": 4 * 528.2e12}}
    a = roofline.analyze(rec)
    assert a["compute_s"] == pytest.approx(2.0)  # 1 s at each dtype's peak
    assert a["memory_hi_s"] == pytest.approx(4.0)
    assert a["memory_lo_s"] == pytest.approx(1.0)
    assert a["memory_s"] == pytest.approx(2.0)  # the geometric midpoint
    assert a["collective_s"] == pytest.approx(3.0)
    assert a["dominant"] == "collective" and a["bound_s"] == pytest.approx(3)
    assert a["roofline_fraction"] == pytest.approx(2.0 / 3.0)
    assert a["model_flops_ratio"] == pytest.approx(0.5)
    assert a["peak_gib"] == 2.0
    assert roofline.analyze({"status": "skipped", "reason": "x"}) == {
        "status": "skipped", "reason": "x"}
    assert [roofline.fmt_s(x) for x in (0, 5e-5, 0.25, 3.0)] == [
        "0", "50.0us", "250.00ms", "3.00s"]


def test_roofline_carries_only_h100_data_sheet_constants():
    src = (ROOT / "src/repro_torch/launch/roofline.py").read_text()
    assert "H100" in src and "v5e" not in src and "TPU" not in src
    assert roofline.PEAK_FLOPS["f32"] == 67e12
    assert roofline.PEAK_FLOPS["bf16"] == 989.4e12
    assert roofline.HBM_BW == 3.35e12 and roofline.NVLINK_BW == 450e9
