"""The JAX side of the port's SPMD tests, run as a subprocess:

    python tests/torch_spmd_jax.py <group> <out_dir>

It sets ``XLA_FLAGS=--xla_force_host_platform_device_count`` before it
imports JAX (the test process's JAX keeps seeing one device), runs the
JAX package on the inputs ``tests/torch_spmd.py`` makes with numpy, and
saves what the port is compared with under ``out_dir``.  Groups:

  exchange   every ``EXCHANGE_CASES`` case on a (2, 2, 2) mesh and every
             ``NW3_CASES`` case on a (3,) mesh, the fused update and the
             codec on their Pallas kernels (interpret mode);
  trainer    gemma3-1b SMOKE weights (``jax_params.npz``) and every
             ``TRAINER_CASES`` case of ``make_ps_train_step`` on a (2, 1)
             mesh;
  launch     the JAX driver's pieces on a (2, 1) mesh: three steps, a
             checkpoint at step 3 (``jax/``), then step 4;
  tp         every ``TP_CASES`` case's weights at tp = 1 and 4, then its
             loss, prefill and decode at tp = 4 on a (1, 4) mesh;
  tp_train   every ``TP_TRAIN_CASES`` case's tp = 4 weights, then
             ``TP_TRAIN_STEPS`` SGD steps of ``make_ps_train_step`` on a
             (2, 4) mesh (tests/scripts/grad_equivalence.py);
  sparse_push  ``sparse_table_update`` over 3 workers for every
             ``SPARSE_PUSH_CASES`` case, inside a jitted ``shard_map``;
  recsys     every ``RS_ARCHS`` arch's SMOKE weights at tp = 4, one step
             of its ``train_batch`` cell (pbox), its ``serve_p99`` and
             ``retrieval_cand`` cells on a (2, 4) mesh, and DLRM's
             ``pbox_sparse`` step (tests/scripts/sparse_push_equivalence.py);
  seq_parallel  every ``SP_CASES`` case's tp = 4 weights, then one pbox
             SGD step of ``make_ps_train_step`` with sequence parallelism
             on a (2, 4) mesh (and without it for ``SP_JAX_BASELINE``):
             tests/scripts/seq_parallel_equivalence.py;
  examples   examples/train_distributed_ps.py written out on a (2, 4)
             mesh (its tp = 4 weights first, ``jax_ex_params.npz``; then
             its losses, the restart step and the loss after the restart,
             ``jax_ex_ps.npz``), and examples/serve_lm.py's serve
             (``repro.launch.serve`` at ``--mesh 1x2``: its weights,
             ``jax_ex_serve_params.npz``, and its ids, ``jax_ex_serve.npz``);
  gnn        every ``GNN_CASES`` case: EquiformerV2's SMOKE weights, the
             loss and the gradients after ``grad_sync`` inside a jitted
             ``shard_map`` on the case's mesh (tests/scripts/
             edge_parallel_equivalence.py), the single-device loss and
             gradients beside them; and every graph cell's
             ``variant="ep"`` plan on a (1, 2) mesh.
"""
import os
import sys
from pathlib import Path

DEVICES = {"examples": 8, "exchange": 8, "trainer": 2, "launch": 2, "tp": 4,
           "tp_train": 8, "sparse_push": 3, "recsys": 8, "gnn": 4,
           "seq_parallel": 8}


def _np32(x):
    import jax.numpy as jnp
    import numpy as np

    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)


def exchange(out: Path):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import PartitionSpec as P

    from repro import compat
    from repro.core.compression import CompressionConfig
    from repro.core.exchange import ExchangeConfig, PSExchange
    from repro.optim.optimizers import adam
    from torch_spmd import (EXCHANGE_CASES, EXCHANGE_STEPS, NW3_CASES,
                            toy_grads, toy_params)

    def run(mesh, wa, name, case, kind):
        strategy, codec, dt, pull, ef_on = case
        dtype = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dt]
        cfg = ExchangeConfig(
            strategy=strategy, use_pallas=True,
            compression=CompressionConfig(codec=codec, error_feedback=ef_on),
            pull_dtype=jnp.bfloat16 if pull == "bf16" else None)
        ex = PSExchange(adam(1e-2), cfg, wa,
                        "pod" if strategy == "pbox_hier" else None)
        params = jax.tree.map(jnp.asarray, toy_params())
        space = ex.build_space(params, dict(mesh.shape))
        has_ef = codec != "none" and ef_on

        def body(pflat, slots, ef, step):
            widx = jax.lax.axis_index(ex.worker_axes)
            st = {"slots": slots, "ef": ef, "step": step}
            g = space.flatten(jax.tree.map(
                jnp.asarray, toy_grads_traced(widx, kind)), dtype)
            for _ in range(EXCHANGE_STEPS):
                pflat, st = ex.device_update(g, pflat, st)
            return pflat, st["slots"], st["ef"], st["step"]

        slab = P(ex.owner_axes) if ex.owner_axes else P()
        sl = (slab, slab)
        efs = slab if has_ef else None
        f = jax.jit(compat.shard_map(
            body, mesh=mesh, in_specs=(P(), sl, efs, P()),
            out_specs=(P(), sl, efs, P()), check_vma=False))
        glob = space.flat_elems
        ef0 = jnp.zeros((glob,), jnp.float32) if has_ef else None
        try:
            pf, slots, ef, step = f(space.flatten(params, dtype),
                                    (jnp.zeros((glob,)), jnp.zeros((glob,))),
                                    ef0, jnp.zeros((), jnp.int32))
        except ValueError as e:
            (out / f"{name}.err").write_text(f"{type(e).__name__}: {e}")
            return
        arrays = {"pflat": _np32(pf), "slot0": _np32(slots[0]),
                  "slot1": _np32(slots[1]), "step": np.asarray(step)}
        if ef is not None:
            arrays["ef"] = _np32(ef)
        np.savez(out / f"{name}.npz", **arrays)

    def toy_grads_traced(widx, kind):
        # toy_grads with a traced worker index
        w = widx.astype(jnp.float32)
        if kind == "int":
            return {"w": jnp.full((4, 6), w + 1.0),
                    "b": jnp.arange(5, dtype=jnp.float32) * (w + 1)}
        return {"w": ((jnp.arange(24, dtype=jnp.float32).reshape(4, 6) + 1)
                      * (w + 1) + w * w),
                "b": jnp.arange(5, dtype=jnp.float32) * (w + 2) + 7 * w}

    # the traced grads equal the numpy ones worker by worker
    for kind in ("int", "nw3"):
        for w in range(3):
            ref = toy_grads(w, kind)
            got = toy_grads_traced(jnp.int32(w), kind)
            for k in ref:
                assert np.array_equal(np.asarray(got[k]), ref[k]), (kind, w, k)

    mesh = compat.make_mesh((2, 2, 2), ("pod", "data", "model"))
    for name, case in EXCHANGE_CASES.items():
        run(mesh, ("pod", "data", "model"), name, case, "int")
    mesh3 = jax.sharding.Mesh(np.asarray(jax.devices()[:3]), ("data",))
    for name in NW3_CASES:
        run(mesh3, ("data",), f"nw3_{name}", EXCHANGE_CASES[name], "nw3")


def trainer(out: Path):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import PartitionSpec as P

    from repro import compat
    from repro.configs.registry import get_arch
    from repro.core.exchange import ExchangeConfig, PSExchange
    from repro.models import transformer as T
    from repro.models.common import Dist
    from repro.optim import optimizers as O
    from repro.optim.schedules import linear_warmup
    from repro.runtime.trainer import init_train_state, make_ps_train_step
    from torch_spmd import TRAINER_CASES, TRAINER_STEPS, flat_keys, lm_tokens

    cfg = get_arch("gemma3-1b").smoke_config
    params = T.init_params(cfg, jax.random.PRNGKey(0), tp=1)
    np.savez(out / "jax_params.tmp.npz",
             **flat_keys(jax.tree.map(np.asarray, params)))
    os.replace(out / "jax_params.tmp.npz", out / "jax_params.npz")
    mesh = compat.make_mesh((2, 1), ("data", "model"))
    for name, (strategy, opt, mb, sched, gb) in TRAINER_CASES.items():
        spec = {"sgd": O.sgd(1e-1), "momentum": O.momentum(1e-1, 0.9),
                "adamw": O.adamw(1e-3, weight_decay=0.1)}[opt]
        ex = PSExchange(spec, ExchangeConfig(strategy=strategy,
                                             use_pallas=True), ("data",))
        dist = Dist(model_axis="model", data_axes=("data",), tp=1)
        gshape = jax.eval_shape(
            lambda: T.init_params(cfg, jax.random.PRNGKey(0), tp=1))
        step, space, _, ng = make_ps_train_step(
            mesh, loss_fn=lambda p, b, d: T.lm_loss(
                p, b["tokens"], b["labels"], cfg, d, 1),
            param_specs=T.make_param_specs(cfg, 1),
            sync_tags=T.grad_sync(cfg, 1), global_param_template=gshape,
            exchange=ex, dist=dist,
            batch_spec={"tokens": P("data"), "labels": P("data")},
            ps_dtype=cfg.param_dtype, microbatches=mb,
            lr_schedule=linear_warmup(4) if sched else None)
        st = init_train_state(
            mesh, init_params_fn=lambda k: params,
            param_specs=T.make_param_specs(cfg, 1), exchange=ex,
            space=space, n_groups=ng, key=jax.random.PRNGKey(0),
            ps_dtype=cfg.param_dtype)
        toks, labs = lm_tokens(cfg.vocab, gb)
        batch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labs)}
        pflat, slots, ef, stc = st.pflat, st.slots, st.ef, st.step
        losses = []
        for _ in range(TRAINER_STEPS):
            pflat, slots, ef, stc, met = step(pflat, slots, ef, stc, batch)
            losses.append(float(met["loss"]))
        np.savez(out / f"{name}.npz", pflat=_np32(pflat),
                 losses=np.asarray(losses),
                 **{f"slot{i}": _np32(s) for i, s in enumerate(slots)})


def launch(out: Path):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from repro.checkpoint import Checkpointer
    from repro.checkpoint.checkpointer import train_state_to_flat
    from repro.configs.registry import get_arch
    from repro.data.synthetic import lm_batches
    from repro.launch.mesh import make_mesh
    from repro.launch.steps import build_cell, make_exchange
    from repro.models import transformer as T
    from repro.runtime.trainer import TrainState, init_train_state

    mesh = make_mesh((2, 1), ("data", "model"))
    arch = get_arch("gemma3-1b")
    cfg = arch.smoke_config
    plan = build_cell("gemma3-1b", "train_4k", mesh, smoke=True)
    exchange = make_exchange(mesh, "lm")
    st = init_train_state(
        mesh, init_params_fn=lambda k: T.init_params(cfg, k, tp=1),
        param_specs=T.make_param_specs(cfg, 1), exchange=exchange,
        space=plan.meta["space"], n_groups=plan.meta["n_groups"],
        key=jax.random.PRNGKey(0), ps_dtype=plan.abstract_args[0].dtype)
    gb, s = plan.abstract_args[4]["tokens"].shape
    data = lm_batches(cfg.vocab, gb, s, 0)
    pflat, slots, ef, stc = st.pflat, st.slots, st.ef, st.step
    losses = []
    for i in range(4):
        b = jax.tree.map(jnp.asarray, next(data))
        pflat, slots, ef, stc, met = plan.fn(pflat, slots, ef, stc, b)
        losses.append(float(met["loss"]))
        if i == 2:
            Checkpointer(out / "jax").save(3, train_state_to_flat(
                TrainState(pflat=pflat, slots=slots, ef=ef, step=stc)))
    np.savez(out / "jax_launch.tmp.npz", pflat=_np32(pflat),
             losses=np.asarray(losses),
             **{f"slot{i}": _np32(s) for i, s in enumerate(slots)})
    os.replace(out / "jax_launch.tmp.npz", out / "jax_launch.npz")


def _jax_config(kw: dict):
    import jax.numpy as jnp

    from repro.models.moe import MoEConfig
    from repro.models.transformer import TransformerConfig

    if "moe" in kw:
        kw = dict(kw, moe=MoEConfig(**kw["moe"]))
    return TransformerConfig("tp", dtype=jnp.float32, param_dtype=jnp.float32,
                             attn_chunk=8, **kw)


def _save_atomic(path: Path, **arrays) -> None:
    import numpy as np

    tmp = path.with_suffix(".tmp.npz")
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def tp(out: Path):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import PartitionSpec as P

    from repro import compat
    from repro.models import transformer as T
    from repro.models.common import Dist
    from torch_spmd import (TP, TP_CASES, TP_MOE, TP_MOE_CASES, flat_keys,
                            lm_tokens)

    cases = [(name, kw, TP) for name, kw in TP_CASES.items()]
    cases += [(name, kw, TP_MOE) for name, kw in TP_MOE_CASES.items()]
    for name, kw, TP in cases:
        mesh = compat.make_mesh((1, TP), ("data", "model"))
        dist = Dist(model_axis="model", data_axes=("data",), tp=TP)
        cfg = _jax_config(kw)
        p1 = T.init_params(cfg, jax.random.PRNGKey(0), tp=1)
        p4 = T.init_params(cfg, jax.random.PRNGKey(0), tp=TP)
        if cfg.qkv_bias:  # nonzero biases, the same model at both layouts
            rng = np.random.default_rng(4)
            for k in ("bq", "bk", "bv"):
                b = jnp.asarray(rng.standard_normal(
                    p1["layers"][k].shape).astype(np.float32) * 0.1)
                p1["layers"][k] = b
                p4["layers"][k] = b if k != "bq" else jnp.tile(
                    b, (1, cfg.attn_replicas(TP)))
        toks, labs = (jnp.asarray(a) for a in lm_tokens(cfg.vocab, 4))
        specs = T.make_param_specs(cfg, TP)
        cache_spec = {"k": P(None, "data", "model"),
                      "v": P(None, "data", "model")}

        def body(p, t, lab):
            ce = T.lm_loss(p, t, lab, cfg, dist, TP)[1]["ce"]
            nxt, cache = T.prefill(p, t, cfg, dist, TP, 32)
            nb, cache = T.decode_step(p, nxt, cache, jnp.int32(16), cfg, dist,
                                      TP)
            return ce, nxt, nb, cache

        f = jax.jit(compat.shard_map(
            body, mesh=mesh, in_specs=(specs, P("data"), P("data")),
            out_specs=(P(), P("data"), P("data"), cache_spec),
            check_vma=False))
        ce, nxt, nb, cache = f(p4, toks, labs)
        arrays = {f"p1/{k}": np.asarray(v) for k, v in flat_keys(p1).items()}
        arrays.update({f"p{TP}/{k}": np.asarray(v)
                       for k, v in flat_keys(p4).items()})
        _save_atomic(out / f"jax_tp_{name}.npz", **arrays, loss=np.asarray(ce),
                     nxt=np.asarray(nxt), dec=np.asarray(nb),
                     k=np.asarray(cache["k"]), v=np.asarray(cache["v"]))


def tp_train(out: Path):
    import jax
    import numpy as np
    from jax.sharding import PartitionSpec as P

    from repro import compat
    from repro.core.exchange import ExchangeConfig, PSExchange
    from repro.models import transformer as T
    from repro.models.common import Dist
    from repro.optim.optimizers import sgd
    from repro.runtime.trainer import init_train_state, make_ps_train_step
    from torch_spmd import (TP, TP_TRAIN_CASES, TP_TRAIN_STEPS, flat_keys,
                            lm_tokens)

    mesh = compat.make_mesh((2, TP), ("data", "model"))
    dist = Dist(model_axis="model", data_axes=("data",), tp=TP)
    for name, kw in TP_TRAIN_CASES.items():
        cfg = _jax_config(kw)
        p4 = T.init_params(cfg, jax.random.PRNGKey(0), tp=TP)
        arrays = {f"p4/{k}": np.asarray(v) for k, v in flat_keys(p4).items()}
        p1 = T.init_params(cfg, jax.random.PRNGKey(0), tp=1)
        arrays.update({f"p1/{k}": np.asarray(v)
                       for k, v in flat_keys(p1).items()})
        _save_atomic(out / f"jax_tp_train_{name}.npz", **arrays)
        specs = T.make_param_specs(cfg, TP)
        ex = PSExchange(sgd(1e-1), ExchangeConfig(strategy="pbox"),
                        worker_axes=("data",), pod_axis=None)
        gshape = jax.eval_shape(
            lambda: T.init_params(cfg, jax.random.PRNGKey(0), tp=TP))
        step, space, _, ng = make_ps_train_step(
            mesh, loss_fn=lambda p, b, d: T.lm_loss(
                p, b["tokens"], b["labels"], cfg, d, TP),
            param_specs=specs, sync_tags=T.grad_sync(cfg, TP),
            global_param_template=gshape, exchange=ex, dist=dist,
            batch_spec={"tokens": P("data"), "labels": P("data")},
            donate=False)
        st = init_train_state(
            mesh, init_params_fn=lambda k: p4, param_specs=specs,
            exchange=ex, space=space, n_groups=ng, key=jax.random.PRNGKey(0))
        toks, labs = lm_tokens(cfg.vocab, 4)
        pflat, slots, ef, stc = st.pflat, st.slots, st.ef, st.step
        for _ in range(TP_TRAIN_STEPS):
            pflat, slots, ef, stc, _ = step(pflat, slots, ef, stc,
                                            {"tokens": toks, "labels": labs})
        np.savez(out / f"jax_tp_train_{name}_out.npz", pflat=_np32(pflat))


def seq_parallel(out: Path):
    import dataclasses

    import jax
    import numpy as np
    from jax.sharding import PartitionSpec as P

    from repro import compat
    from repro.core.exchange import ExchangeConfig, PSExchange
    from repro.models import transformer as T
    from repro.models.common import Dist
    from repro.optim.optimizers import sgd
    from repro.runtime.trainer import init_train_state, make_ps_train_step
    from torch_spmd import (SP_CASES, SP_JAX_BASELINE, SP_LR, SP_TP,
                            flat_keys, lm_tokens)

    mesh = compat.make_mesh((2, SP_TP), ("data", "model"))
    dist = Dist(model_axis="model", data_axes=("data",), tp=SP_TP)
    for name, kw in SP_CASES.items():
        cfg0 = _jax_config(kw)
        p4 = T.init_params(cfg0, jax.random.PRNGKey(0), tp=SP_TP)
        _save_atomic(out / f"jax_sp_{name}_params.npz",
                     **{k: np.asarray(v) for k, v in flat_keys(p4).items()})
        toks, labs = lm_tokens(cfg0.vocab, 4)
        res = {}
        for sp in ((False, True) if name in SP_JAX_BASELINE else (True,)):
            cfg = dataclasses.replace(cfg0, seq_parallel=sp)
            specs = T.make_param_specs(cfg, SP_TP)
            ex = PSExchange(sgd(SP_LR), ExchangeConfig(strategy="pbox"),
                            worker_axes=("data",), pod_axis=None)
            gshape = jax.eval_shape(
                lambda: T.init_params(cfg, jax.random.PRNGKey(0), tp=SP_TP))
            step, space, _, ng = make_ps_train_step(
                mesh, loss_fn=lambda p, b, d, cfg=cfg: T.lm_loss(
                    p, b["tokens"], b["labels"], cfg, d, SP_TP),
                param_specs=specs, sync_tags=T.grad_sync(cfg, SP_TP),
                global_param_template=gshape, exchange=ex, dist=dist,
                batch_spec={"tokens": P("data"), "labels": P("data")},
                donate=False)
            st = init_train_state(
                mesh, init_params_fn=lambda k: p4, param_specs=specs,
                exchange=ex, space=space, n_groups=ng,
                key=jax.random.PRNGKey(0))
            pflat, _, _, _, met = step(st.pflat, st.slots, st.ef, st.step,
                                       {"tokens": toks, "labels": labs})
            tag = "sp" if sp else "base"
            res[f"pflat_{tag}"] = _np32(pflat)
            res[f"loss_{tag}"] = np.asarray(met["loss"])
        _save_atomic(out / f"jax_sp_{name}_out.npz", **res)


def sparse_push(out: Path):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import PartitionSpec as P

    from repro import compat
    from repro.models.common import Dist
    from repro.runtime.sparse_push import sparse_table_update
    from torch_spmd import SP_NW, SPARSE_PUSH_CASES, sparse_push_inputs

    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:SP_NW]), ("data",))
    for name, (lr, kind) in SPARSE_PUSH_CASES.items():
        inp = sparse_push_inputs(kind)
        ids = jnp.asarray(np.concatenate(list(inp["ids"])))
        cot = jnp.asarray(np.concatenate(list(inp["cot"])))

        def body(tables, i, c, lr=lr):
            return sparse_table_update(tables, i, c, Dist.none(), ("data",),
                                       lr)

        tables = {k: jnp.asarray(v) for k, v in inp["tables"].items()}
        specs = {k: P() for k in tables}
        f = jax.jit(compat.shard_map(
            body, mesh=mesh, in_specs=(specs, P("data"), P("data")),
            out_specs=specs, check_vma=False))
        new = f(tables, ids, cot)
        np.savez(out / f"jax_sp_{name}.npz",
                 **{k: np.asarray(v) for k, v in new.items()})


def recsys(out: Path):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from repro.configs.registry import get_arch
    from repro.data.synthetic import recsys_batches
    from repro.launch.mesh import make_mesh
    from repro.launch.steps import _RS_FNS, build_cell, make_exchange
    from repro.runtime.trainer import init_train_state
    from torch_spmd import RS_ARCHS, RS_MESH, flat_keys, rs_candidates

    mesh = make_mesh(RS_MESH, ("data", "model"))
    tp = RS_MESH[1]
    for arch in RS_ARCHS:
        cfg = get_arch(arch).smoke_config
        init_fn, specs_fn = _RS_FNS[arch][:2]
        params = init_fn(cfg, jax.random.PRNGKey(0), tp)
        arrays = {f"p/{k}": np.asarray(v) for k, v in flat_keys(params).items()}
        plan = build_cell(arch, "train_batch", mesh, smoke=True)
        st = init_train_state(
            mesh, init_params_fn=lambda k: params,
            param_specs=specs_fn(cfg, tp),
            exchange=make_exchange(mesh, "recsys"),
            space=plan.meta["space"], n_groups=plan.meta["n_groups"],
            key=jax.random.PRNGKey(0))
        gb = plan.abstract_args[4]["sparse"].shape[0]
        batch = jax.tree.map(jnp.asarray,
                             next(recsys_batches(arch, cfg, gb, 0)))
        p1, _, _, _, met = plan.fn(st.pflat, st.slots, st.ef, st.step, batch)
        arrays.update(train_pflat=_np32(p1), train_loss=np.asarray(met["loss"]))
        serve = build_cell(arch, "serve_p99", mesh, smoke=True)
        sb = {k: v for k, v in batch.items() if k != "labels"}
        arrays["serve"] = np.asarray(serve.fn(params, sb))
        retr = build_cell(arch, "retrieval_cand", mesh, smoke=True)
        n = retr.abstract_args[1]["cand_ids"].shape[0]
        rb = {k: jnp.asarray(v) for k, v in
              next(recsys_batches(arch, cfg, tp, 1)).items() if k != "labels"}
        rb["cand_ids"] = jnp.asarray(rs_candidates(cfg, n))
        arrays["retrieval"] = np.asarray(retr.fn(params, rb))
        if arch == "dlrm-mlperf":
            sp = build_cell(arch, "train_batch", mesh, strategy="pbox_sparse",
                            smoke=True)
            dense = {k: v for k, v in params.items() if k != "tables"}
            pflat0 = jnp.stack([sp.meta["space"].flatten(dense)] * tp)
            p2, _, _, _, tables1, met2 = sp.fn(
                pflat0, (), None, jnp.int32(0), params["tables"], batch)
            arrays.update(sparse_pflat=_np32(p2),
                          sparse_loss=np.asarray(met2["loss"]),
                          **{f"sparse_tables/{k}": np.asarray(v)
                             for k, v in tables1.items()})
        _save_atomic(out / f"jax_rs_{arch}.npz", **arrays)


def examples(out: Path):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from repro.checkpoint import Checkpointer
    from repro.checkpoint.checkpointer import (flat_to_train_state,
                                               train_state_to_flat)
    from repro.configs.registry import get_arch
    from repro.data.synthetic import lm_batches
    from repro.launch import serve as jserve
    from repro.launch.mesh import make_mesh
    from repro.launch.steps import build_cell, make_exchange
    from repro.models import transformer as T
    from repro.runtime.trainer import TrainState, init_train_state
    from torch_spmd import EX_SERVE_ARGV, EX_TP, flat_keys

    # examples/train_distributed_ps.py, its checkpoints under ``out``
    mesh = make_mesh((2, EX_TP), ("data", "model"))
    cfg = get_arch("internlm2-1.8b").smoke_config
    plan = build_cell("internlm2-1.8b", "train_4k", mesh, smoke=True)
    exchange = make_exchange(mesh, "lm")
    space, ng = plan.meta["space"], plan.meta["n_groups"]
    p4 = T.init_params(cfg, jax.random.PRNGKey(0), tp=EX_TP)
    _save_atomic(out / "jax_ex_params.npz",
                 **{k: _np32(v) for k, v in flat_keys(p4).items()})
    state = init_train_state(
        mesh, init_params_fn=lambda k: T.init_params(cfg, k, tp=EX_TP),
        param_specs=T.make_param_specs(cfg, EX_TP), exchange=exchange,
        space=space, n_groups=ng, key=jax.random.PRNGKey(0),
        ps_dtype=plan.abstract_args[0].dtype)
    gb, s = plan.abstract_args[4]["tokens"].shape
    data = lm_batches(cfg.vocab, gb, s, seed=0)
    ck = Checkpointer(out / "jax_ex_ckpt")
    pflat, slots, ef, stc = state.pflat, state.slots, state.ef, state.step
    losses = []
    for i in range(20):
        b = jax.tree.map(jnp.asarray, next(data))
        pflat, slots, ef, stc, met = plan.fn(pflat, slots, ef, stc, b)
        if (i + 1) % 5 == 0:
            losses.append(float(met["loss"]))
            ck.save_async(i + 1, train_state_to_flat(
                TrainState(pflat=pflat, slots=slots, ef=ef, step=stc)))
    ck.wait()
    host, _ = ck.restore()
    st = flat_to_train_state(host, TrainState)
    p2, sl2, ef2, sc2 = st.pflat, st.slots, st.ef, st.step
    for i in range(5):
        b = jax.tree.map(jnp.asarray, next(data))
        p2, sl2, ef2, sc2, met = plan.fn(p2, sl2, ef2, sc2, b)
    _save_atomic(out / "jax_ex_ps.npz", losses=np.asarray(losses),
                 restart_step=np.asarray(int(host["step"])),
                 loss_after_restart=np.asarray(float(met["loss"])))

    # examples/serve_lm.py: the serve program at --mesh 1x2 (its weights:
    # the init it draws, at tp = 2)
    scfg = get_arch("gemma3-1b").smoke_config
    p2 = T.init_params(scfg, jax.random.PRNGKey(0), tp=2)
    _save_atomic(out / "jax_ex_serve_params.npz",
                 **{k: _np32(v) for k, v in flat_keys(p2).items()})
    res = jserve.main(EX_SERVE_ARGV)
    _save_atomic(out / "jax_ex_serve.npz", generated=res["generated"],
                 version=np.asarray(res["read"]["version"]))


def gnn(out: Path):
    import dataclasses
    import json

    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P

    from repro import compat
    from repro.configs.registry import get_arch
    from repro.launch import steps as jST
    from repro.models.common import Dist
    from repro.models.gnn import equiformer_v2 as EQ
    from repro.runtime.trainer import apply_grad_sync
    from torch_spmd import (GNN_CASES, GNN_SHAPES, flat_keys, gnn_batch,
                            gnn_rebased, gnn_spec)

    arch = get_arch("equiformer-v2")

    def mesh_of(shape):
        n = shape[0] * shape[1]
        return Mesh(np.asarray(jax.devices()[:n]).reshape(shape),
                    ("data", "model"))

    for name, (shape, mshape, variant) in GNN_CASES.items():
        mesh = mesh_of(mshape)
        dp, tp = mshape
        plan = jST.build_cell("equiformer-v2", shape, mesh, smoke=True,
                              variant=variant)
        cfg = jST._gnn_graph_template(mesh, arch.cell(shape),
                                      arch.smoke_config, ("data",), True)[2]
        cfg = dataclasses.replace(cfg, edge_parallel=variant == "ep")
        dist_nodes = arch.cell(shape).kind == "graph_full_large"
        bt = plan.abstract_args[4]
        bspec = {k: v.sharding.spec for k, v in bt.items()}
        raw = gnn_batch(shape, bt, cfg.l_max, cfg.n_rbf, dp)
        batch = gnn_rebased(raw, dp) if shape == "molecule" else raw
        params = EQ.init_params(cfg, jax.random.PRNGKey(0), tp)
        specs = EQ.make_param_specs(cfg, tp)
        tags = EQ.grad_sync(cfg, tp)
        dist = Dist(model_axis="model", data_axes=("data",), tp=tp)

        def body(p, b):
            loss, grads = jax.value_and_grad(
                lambda q: EQ.loss_fn(q, b, cfg, dist, dist_nodes)[0])(p)
            grads = apply_grad_sync(grads, tags, dist)
            # each worker's own: stacked over the data axis
            return loss[None], jax.tree.map(lambda g: g[None], grads)

        by_worker = jax.tree.map(lambda sp: P("data", *sp), specs,
                                 is_leaf=lambda x: isinstance(x, P))
        f = jax.jit(compat.shard_map(
            body, mesh=mesh, in_specs=(specs, bspec),
            out_specs=(P("data"), by_worker), check_vma=False))
        loss, grads = f(params, jax.tree.map(jnp.asarray, batch))
        # the single-device reference on the global batch (global ids)
        one = dataclasses.replace(cfg, edge_parallel=False)
        gr = jax.tree.map(jnp.asarray, raw)
        l1, g1 = jax.value_and_grad(
            lambda q: EQ.loss_fn(q, gr, one, Dist.none())[0])(params)
        arrays = {f"p/{k}": np.asarray(v) for k, v in flat_keys(params).items()}
        arrays.update({f"g/{k}": _np32(v) for k, v in flat_keys(grads).items()})
        arrays.update({f"g1/{k}": _np32(v) for k, v in flat_keys(g1).items()})
        _save_atomic(out / f"jax_gnn_{name}.npz", **arrays,
                     loss=np.asarray(loss, np.float32),
                     loss1=np.asarray(l1, np.float32))

    mesh = mesh_of((1, 2))
    plans = {}
    for shape in GNN_SHAPES:
        for smoke in (True, False):
            plan = jST.build_cell("equiformer-v2", shape, mesh, smoke=smoke,
                                  variant="ep")
            plans[f"{shape}/{int(smoke)}"] = {
                "flat": plan.meta["space"].flat_elems,
                "n_groups": plan.meta["n_groups"],
                **{k: plan.meta[k] for k in ("model_flops", "nodes",
                                             "edges")},
                "args": {k: [list(v.shape), str(v.dtype),
                             gnn_spec(v.sharding.spec)]
                         for k, v in plan.abstract_args[4].items()}}
    (out / "jax_gnn_plans.tmp").write_text(json.dumps(plans))
    os.replace(out / "jax_gnn_plans.tmp", out / "jax_gnn_plans.json")


if __name__ == "__main__":
    group, out_dir = sys.argv[1], Path(sys.argv[2])
    os.environ["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={DEVICES[group]}")
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    out_dir.mkdir(parents=True, exist_ok=True)
    {"examples": examples, "exchange": exchange, "trainer": trainer,
     "launch": launch, "tp": tp, "tp_train": tp_train,
     "sparse_push": sparse_push, "recsys": recsys, "gnn": gnn,
     "seq_parallel": seq_parallel}[group](out_dir)
    print("OK")
