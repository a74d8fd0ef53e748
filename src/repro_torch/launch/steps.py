"""Per-cell step builders: (arch x shape x mesh) -> per-rank step + abstract
args (torch counterpart of ``repro/launch/steps.py``).

Every builder returns a ``CellPlan`` whose ``fn`` is the per-rank step and
whose ``abstract_args`` carry the global shapes and dtypes of its
arguments as meta tensors (JAX's carry ``NamedSharding``s too; the port's
dry run, ``launch/dryrun.py``, cuts them to a rank's pieces).  The LM cells (train, prefill, decode,
decode_long) and the recsys cells (train, serve, retrieval, and DLRM's
sparse-push train step under ``strategy="pbox_sparse"``) build at any
model-axis size; ResNet-50's ``imagenet_train`` is pure data parallelism
over every mesh axis; EquiformerV2's four graph cells build with channel
tensor parallelism over the model axis, or edge parallelism under
``variant="ep"``.  A serving plan's ``fn`` takes the rank's local
parameters (cut from the global tree by ``runtime.trainer.local_params``),
its rows of the batch (and, for the LM cells, its sequence shard of the
cache), and runs without autograd.  A recsys retrieval plan takes the
``tp`` replicated user rows and this rank's slice of the candidates
(sharded over every mesh axis, in rank order).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.registry import ArchDef, ShapeCell, get_arch
from repro_torch.core.exchange import ExchangeConfig, PSExchange
from repro_torch.launch import mesh as meshlib
from repro_torch.models import resnet as RN
from repro_torch.models.gnn import equiformer_v2 as EQ
from repro_torch.models.gnn.spherical import packed_wigner_size
from repro_torch.models import transformer as T
from repro_torch.models.common import Dist
from repro_torch.models.recsys import models as RS
from repro_torch.optim.optimizers import OptimizerSpec, adamw, momentum, sgd
from repro_torch.runtime.trainer import make_ps_train_step


@dataclasses.dataclass
class CellPlan:
    arch_id: str
    shape: str
    kind: str
    fn: Any  # the per-rank step
    abstract_args: tuple
    meta: dict


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def default_optimizer(family: str) -> OptimizerSpec:
    # per-family production defaults: LMs/GNN AdamW; recsys SGD (MLPerf DLRM);
    # vision momentum (the paper's ImageNet setting)
    return {
        "lm": adamw(3e-4, weight_decay=0.1),
        "gnn": adamw(1e-3),
        "recsys": sgd(1e-2),
        "vision": momentum(0.1, 0.9),
    }[family]


def make_exchange(mesh, family: str, strategy: str = "pbox",
                  opt: OptimizerSpec | None = None,
                  exchange_cfg: ExchangeConfig | None = None) -> PSExchange:
    wa = meshlib.worker_axes(mesh)
    pa = meshlib.pod_axis(mesh)
    if family == "vision":
        wa = tuple(mesh.axis_names)  # pure DP over every axis
    cfg = exchange_cfg or ExchangeConfig(strategy=strategy)
    if cfg.strategy == "pbox_hier" and pa is None:
        cfg = dataclasses.replace(cfg, strategy="pbox")
    return PSExchange(opt or default_optimizer(family), cfg, wa,
                      pa if cfg.strategy == "pbox_hier" else None)


# ===========================================================================
# LM cells
# ===========================================================================

def _lm_dist(mesh) -> Dist:
    return Dist(model_axis="model", data_axes=meshlib.worker_axes(mesh),
                tp=mesh.shape["model"], mesh=mesh)


def build_lm_train(arch: ArchDef, cell: ShapeCell, mesh,
                   exchange: PSExchange, smoke: bool = False,
                   variant: str | None = None) -> CellPlan:
    """``variant="sp"``: sequence-parallel activations (``seq_parallel``),
    whose 1/tp activations afford a quarter of the microbatches; any other
    variant changes nothing, as in JAX."""
    cfg = arch.smoke_config if smoke else arch.config
    tp = mesh.shape["model"]
    if variant == "sp":
        cfg = dataclasses.replace(cfg, seq_parallel=True)
    dist = _lm_dist(mesh)
    gb, s = cell.params["global_batch"], cell.params["seq_len"]
    if smoke:
        gb, s = meshlib.num_workers(mesh) * 2, 32
    mb = (arch.microbatches or {}).get(cell.name, 1) if not smoke else 1
    if variant == "sp" and mb > 1:
        mb = max(mb // 4, 1)

    def loss_fn(params, batch, dist):
        return T.lm_loss(params, batch["tokens"], batch["labels"], cfg, dist)

    step, space, sspecs, ng = make_ps_train_step(
        mesh, loss_fn=loss_fn, param_specs=T.make_param_specs(cfg, tp),
        sync_tags=T.grad_sync(cfg, tp),
        global_param_template=T.abstract_params(cfg, tp), exchange=exchange,
        dist=dist, ps_dtype=cfg.param_dtype, microbatches=mb,
    )
    n_state = exchange.spec.num_state_slots
    args = (
        _meta((ng, space.flat_elems), cfg.param_dtype),
        tuple(_meta((ng, space.flat_elems), torch.float32)
              for _ in range(n_state)),
        None,
        _meta((), torch.int32),
        {"tokens": _meta((gb, s), torch.int32),
         "labels": _meta((gb, s), torch.int32)},
    )
    n_act = cfg.active_param_count()
    return CellPlan(arch.arch_id, cell.name, "train", step, args, {
        "space": space, "sspecs": sspecs, "n_groups": ng,
        "exchange": exchange,  # the port's: the driver needs its axes
        "model_flops": 6.0 * n_act * gb * s,
        "tokens": gb * s, "params": cfg.param_count(),
        "microbatches": mb,
    })


def build_lm_prefill(arch: ArchDef, cell: ShapeCell, mesh,
                     smoke: bool = False) -> CellPlan:
    """``fn(local_params, tokens)``: this rank's rows (B/nw, S) ->
    (greedy ids, this rank's cache shard)."""
    cfg = arch.smoke_config if smoke else arch.config
    tp = mesh.shape["model"]
    dist = _lm_dist(mesh)
    gb, s = cell.params["global_batch"], cell.params["seq_len"]
    if smoke:
        gb, s = meshlib.num_workers(mesh), 32

    def fn(params, tokens):
        with torch.no_grad():
            return T.prefill(params, tokens, cfg, s, dist=dist)

    n_act = cfg.active_param_count()
    attn_flops = (
        4.0 * gb * cfg.n_layers * cfg.n_heads * cfg.head_dim * s * s / 2
    )
    return CellPlan(arch.arch_id, cell.name, "prefill", fn, (
        T.abstract_params(cfg, tp), _meta((gb, s), torch.int32)),
        {"model_flops": 2.0 * n_act * gb * s + attn_flops, "tokens": gb * s})


def build_lm_decode(arch: ArchDef, cell: ShapeCell, mesh,
                    smoke: bool = False) -> CellPlan:
    """``fn(local_params, token, cache, pos)``: one greedy step of this
    rank's rows (all of them when the batch is smaller than the workers)
    against its sequence shard of the cache, written in place."""
    cfg = arch.smoke_config if smoke else arch.config
    tp = mesh.shape["model"]
    dist = _lm_dist(mesh)
    gb, s = cell.params["global_batch"], cell.params["seq_len"]
    if smoke:
        gb, s = meshlib.num_workers(mesh), 64

    def fn(params, token, cache, pos):
        with torch.no_grad():
            return T.decode_step(params, token, cache, pos, cfg, dist)

    cache_shape = (cfg.n_layers, gb, s, cfg.n_kv_heads, cfg.head_dim)
    cache = {"k": _meta(cache_shape, cfg.dtype),
             "v": _meta(cache_shape, cfg.dtype)}
    n_act = cfg.active_param_count()
    kv_flops = 4.0 * gb * cfg.n_layers * cfg.n_heads * cfg.head_dim * s
    return CellPlan(arch.arch_id, cell.name, "decode", fn, (
        T.abstract_params(cfg, tp), _meta((gb,), torch.int32), cache,
        _meta((), torch.int32)),
        {"model_flops": 2.0 * n_act * gb + kv_flops, "tokens": gb})


def build_lm_decode_long(arch: ArchDef, cell: ShapeCell, mesh,
                         smoke: bool = False) -> CellPlan:
    """Unrolled decode with per-layer cache sizes (sliding-window archs):
    ``fn(local_params, token, caches, pos)``, the batch replicated over the
    workers, global layers' caches sequence-sharded, window caches
    replicated."""
    cfg = arch.smoke_config if smoke else arch.config
    tp = mesh.shape["model"]
    dist = _lm_dist(mesh)
    gb, s = cell.params["global_batch"], cell.params["seq_len"]
    if smoke:
        gb, s = 1, 64

    def fn(params, token, caches, pos):
        with torch.no_grad():
            return T.decode_step_unrolled(params, token, caches, pos, cfg,
                                          dist)

    cache_args = []
    for li in range(cfg.n_layers):
        if cfg.is_global_layer(li):
            shape = (gb, s, cfg.n_kv_heads, cfg.head_dim)
        else:
            shape = (gb, min(cfg.sliding_window, s), cfg.n_kv_heads,
                     cfg.head_dim)
        cache_args.append({"k": _meta(shape, cfg.dtype),
                           "v": _meta(shape, cfg.dtype)})
    n_act = cfg.active_param_count()
    n_glob = sum(1 for li in range(cfg.n_layers)
                 if cfg.global_every > 0 and (li + 1) % cfg.global_every == 0)
    kv_flops = 4.0 * gb * cfg.n_heads * cfg.head_dim * (
        n_glob * s + (cfg.n_layers - n_glob) * (cfg.sliding_window or s))
    return CellPlan(arch.arch_id, cell.name, "decode_long", fn, (
        T.abstract_params(cfg, tp), _meta((gb,), torch.int32), cache_args,
        _meta((), torch.int32)),
        {"model_flops": 2.0 * n_act * gb + kv_flops, "tokens": gb})


# ===========================================================================
# recsys cells
# ===========================================================================

_RS_FNS = {
    "dlrm-mlperf": (RS.dlrm_init, RS.dlrm_specs, RS.dlrm_grad_sync,
                    RS.dlrm_loss, RS.dlrm_score, RS.dlrm_user_tower,
                    RS.DLRMConfig),
    "autoint": (RS.autoint_init, RS.autoint_specs, RS.autoint_grad_sync,
                RS.autoint_loss, RS.autoint_score, RS.autoint_user_tower,
                RS.AutoIntConfig),
    "dien": (RS.dien_init, RS.dien_specs, RS.dien_grad_sync, RS.dien_loss,
             RS.dien_score, RS.dien_user_tower, RS.DIENConfig),
    "xdeepfm": (RS.xdeepfm_init, RS.xdeepfm_specs, RS.xdeepfm_grad_sync,
                RS.xdeepfm_loss, RS.xdeepfm_score, RS.xdeepfm_user_tower,
                RS.XDeepFMConfig),
}


def rs_abstract_params(arch_id: str, cfg, tp: int) -> dict:
    """The recsys init's global tree for ``tp`` as meta tensors (the JAX
    package's ``jax.eval_shape`` of the init)."""
    return _RS_FNS[arch_id][0](cfg, None, tp, device="meta")


def _rs_batch_template(arch_id, cfg, gb, mesh, wa, retrieval_n=None):
    """(meta tensors, specs) for a recsys batch."""
    tp = mesh.shape["model"]
    if retrieval_n is not None:
        b = tp  # replicated user rows, one per model shard
        spec_b = (None,)
    else:
        b = gb
        spec_b = (wa,)
    batch, specs = {}, {}
    if arch_id == "dlrm-mlperf":
        batch["dense"] = _meta((b, cfg.n_dense), torch.float32)
        specs["dense"] = spec_b
    if arch_id == "dien":
        batch["hist_items"] = _meta((b, cfg.seq_len), torch.int32)
        batch["hist_cats"] = _meta((b, cfg.seq_len), torch.int32)
        specs["hist_items"] = spec_b
        specs["hist_cats"] = spec_b
        nf = 2
    else:
        nf = len(cfg.vocabs)
    batch["sparse"] = _meta((b, nf), torch.int32)
    specs["sparse"] = spec_b
    batch["labels"] = _meta((b,), torch.int32)
    specs["labels"] = spec_b
    if retrieval_n is not None:
        all_ax = tuple(mesh.axis_names)
        batch["cand_ids"] = _meta((retrieval_n,), torch.int32)
        specs["cand_ids"] = (all_ax,)
    return batch, specs


def _rs_dist(mesh) -> Dist:
    return Dist(model_axis="model", data_axes=meshlib.worker_axes(mesh),
                tp=mesh.shape["model"], mesh=mesh)


def build_recsys_cell(arch: ArchDef, cell: ShapeCell, mesh,
                      exchange: PSExchange | None,
                      smoke: bool = False) -> CellPlan:
    cfg = arch.smoke_config if smoke else arch.config
    _, specs_fn, sync_fn, loss_f, score_f, tower_f, _ = _RS_FNS[arch.arch_id]
    tp = mesh.shape["model"]
    wa = meshlib.worker_axes(mesh)
    dist = _rs_dist(mesh)
    specs = specs_fn(cfg, tp)
    gshape = rs_abstract_params(arch.arch_id, cfg, tp)
    nw = meshlib.num_workers(mesh)

    if cell.kind == "train":
        gb = cell.params["batch"] if not smoke else nw * tp * 2
        exchange = exchange or make_exchange(mesh, "recsys")
        batch_t, batch_spec = _rs_batch_template(arch.arch_id, cfg, gb, mesh,
                                                 wa)
        step, space, sspecs, ng = make_ps_train_step(
            mesh, loss_fn=lambda p, b, d: loss_f(p, b, cfg, d),
            param_specs=specs, sync_tags=sync_fn(cfg, tp),
            global_param_template=gshape, exchange=exchange, dist=dist,
            batch_spec=batch_spec, loss_div_tp=False,  # bce_loss divides
        )
        args = (
            _meta((ng, space.flat_elems), torch.float32),
            tuple(_meta((ng, space.flat_elems), torch.float32)
                  for _ in sspecs["slots"]),
            None, _meta((), torch.int32), batch_t,
        )
        return CellPlan(arch.arch_id, cell.name, "train", step, args, {
            "space": space, "sspecs": sspecs, "n_groups": ng,
            "exchange": exchange,  # the port's: the driver needs its axes
            "model_flops": 6.0 * _rs_dense_flops(arch.arch_id, cfg) * gb,
            "examples": gb})

    if cell.kind == "serve":
        gb = cell.params["batch"] if not smoke else nw * tp * 2
        batch_t, _ = _rs_batch_template(arch.arch_id, cfg, gb, mesh, wa)
        batch_t.pop("labels")

        def fn(params, batch):
            with torch.no_grad():
                return score_f(params, batch, cfg, dist)

        return CellPlan(arch.arch_id, cell.name, "serve", fn,
                        (gshape, batch_t),
                        {"model_flops": 2.0 * _rs_dense_flops(arch.arch_id, cfg)
                         * gb, "examples": gb})

    if cell.kind == "retrieval":
        n = cell.params["n_candidates"] if not smoke else nw * tp * 8
        batch_t, _ = _rs_batch_template(arch.arch_id, cfg, 1, mesh, wa,
                                        retrieval_n=n)
        batch_t.pop("labels")

        def fn(params, batch):
            with torch.no_grad():
                return RS.bulk_retrieval(params, batch, tower_f, "t0",
                                         cfg.embed_dim, cfg, dist)

        return CellPlan(arch.arch_id, cell.name, "retrieval", fn,
                        (gshape, batch_t),
                        {"model_flops": 2.0 * n * cfg.embed_dim,
                         "examples": n})
    raise ValueError(cell.kind)


def _rs_dense_flops(arch_id: str, cfg) -> float:
    """Per-example dense-stage MAC count (embedding lookups are bytes, not
    flops)."""
    if arch_id == "dlrm-mlperf":
        dims_b = (cfg.n_dense,) + cfg.bot_mlp
        dims_t = (cfg.top_in,) + cfg.top_mlp
        f = sum(a * b for a, b in zip(dims_b, dims_b[1:]))
        f += sum(a * b for a, b in zip(dims_t, dims_t[1:]))
        f += (cfg.n_sparse + 1) ** 2 * cfg.embed_dim / 2
        return f
    if arch_id == "autoint":
        d_in, f = cfg.embed_dim, 0
        for _ in range(cfg.n_attn_layers):
            f += cfg.n_sparse * (4 * d_in * cfg.d_attn
                                 + 2 * cfg.n_sparse * cfg.d_attn)
            d_in = cfg.d_attn
        return f
    if arch_id == "dien":
        g = 3 * (cfg.in_dim + cfg.gru_dim) * cfg.gru_dim
        f = 2 * cfg.seq_len * g  # GRU + AUGRU
        dims = (cfg.mlp_in,) + cfg.mlp
        return f + sum(a * b for a, b in zip(dims, dims[1:]))
    if arch_id == "xdeepfm":
        f, h_prev = 0, cfg.n_sparse
        for h in cfg.cin_layers:
            f += h * h_prev * cfg.n_sparse * cfg.embed_dim
            h_prev = h
        dims = (cfg.n_sparse * cfg.embed_dim,) + cfg.mlp
        return f + sum(a * b for a, b in zip(dims, dims[1:]))
    raise ValueError(arch_id)


def build_recsys_train_sparse(arch: ArchDef, cell: ShapeCell, mesh,
                              smoke: bool = False) -> CellPlan:
    """Recsys training with the dense params through the chunked PBox
    exchange and the embedding tables by the sparse key-value push
    (``runtime/sparse_push.py``).  Wired for dlrm-mlperf, as in the JAX
    package.  ``fn(pflat, slots, ef, step, tables, batch)`` takes this
    rank's table shards and updates them in place."""
    from repro_torch.runtime.sparse_push import make_sparse_recsys_train_step

    if arch.arch_id != "dlrm-mlperf":
        raise NotImplementedError("sparse push is wired for dlrm-mlperf")
    cfg = arch.smoke_config if smoke else arch.config
    tp = mesh.shape["model"]
    wa = meshlib.worker_axes(mesh)
    nw = meshlib.num_workers(mesh)
    dist = _rs_dist(mesh)
    gb = cell.params["batch"] if not smoke else nw * tp * 2
    exchange = make_exchange(mesh, "recsys", "pbox")

    full_specs = RS.dlrm_specs(cfg, tp)
    table_specs_ = full_specs["tables"]
    dense_specs = {k: v for k, v in full_specs.items() if k != "tables"}
    full_sync = RS.dlrm_grad_sync(cfg, tp)
    dense_sync = {k: v for k, v in full_sync.items() if k != "tables"}
    gshape = rs_abstract_params(arch.arch_id, cfg, tp)
    dense_template = {k: v for k, v in gshape.items() if k != "tables"}
    batch_t, batch_spec = _rs_batch_template(arch.arch_id, cfg, gb, mesh, wa)

    step, space, sspecs = make_sparse_recsys_train_step(
        mesh,
        lookup_fn=lambda tables, b, d: RS.dlrm_lookup(tables, b, d),
        loss_from_emb=lambda dp, e, b, d: RS.dlrm_loss_from_emb(dp, e, b, cfg,
                                                               d),
        dense_specs=dense_specs, dense_sync=dense_sync,
        dense_template=dense_template, table_specs=table_specs_,
        exchange=exchange, dist=dist, batch_spec=batch_spec,
        table_lr=exchange.spec.lr,
    )
    args = (
        _meta((tp, space.flat_elems), torch.float32),
        tuple(_meta((tp, space.flat_elems), torch.float32)
              for _ in sspecs["slots"]),
        None, _meta((), torch.int32), gshape["tables"], batch_t,
    )
    return CellPlan(arch.arch_id, cell.name, "train", step, args, {
        "space": space, "sspecs": sspecs, "n_groups": tp,
        "exchange": exchange,
        "model_flops": 6.0 * _rs_dense_flops(arch.arch_id, cfg) * gb,
        "examples": gb, "variant": "sparse_push"})


# ===========================================================================
# GNN cells
# ===========================================================================

def _gnn_graph_template(mesh, cell: ShapeCell, cfg: EQ.EquiformerConfig,
                        wa, smoke: bool):
    """(graph meta tensors, specs, effective cfg, dist_nodes) for each
    graph regime."""
    nw = meshlib.num_workers(mesh)
    pw = packed_wigner_size(cfg.l_max)
    kind = cell.kind
    p = cell.params

    def node_edge(n, e, d_in, spec):
        g = {
            "node_feat": ((n, d_in), torch.float32),
            "edge_src": ((e,), torch.int32),
            "edge_dst": ((e,), torch.int32),
            "edge_mask": ((e,), torch.float32),
            "node_mask": ((n,), torch.float32),
            "wigner": ((e, pw), torch.float32),
            "rbf": ((e, cfg.n_rbf), torch.float32),
        }
        return ({k: _meta(s, dt) for k, (s, dt) in g.items()},
                {k: spec for k in g})

    if kind == "graph_full":
        n, e = (p["n_nodes"], p["n_edges"]) if not smoke else (64, 256)
        cfg = dataclasses.replace(
            cfg, d_in=p["d_feat"] if not smoke else cfg.d_in,
            n_out=p["n_classes"] if not smoke else cfg.n_out)
        meta, specs = node_edge(n, e, cfg.d_in, ())  # replicated full graph
        meta["labels"] = _meta((n,), torch.int32)
        specs["labels"] = ()
        return meta, specs, cfg, False
    if kind == "graph_minibatch":
        pn = p["pad_nodes"] if not smoke else 64
        pe = p["pad_edges"] if not smoke else 256
        cfg = dataclasses.replace(
            cfg, d_in=p["d_feat"] if not smoke else cfg.d_in,
            n_out=p["n_classes"] if not smoke else cfg.n_out)
        meta, specs = node_edge(nw * pn, nw * pe, cfg.d_in, (wa,))
        meta["labels"] = _meta((nw * pn,), torch.int32)
        specs["labels"] = (wa,)
        return meta, specs, cfg, False
    if kind == "graph_full_large":
        n = p["n_nodes"] if not smoke else 64 * nw
        e = p["n_edges"] if not smoke else 256 * nw
        n = -(-n // nw) * nw
        e = -(-e // nw) * nw
        cfg = dataclasses.replace(
            cfg, d_in=p["d_feat"] if not smoke else cfg.d_in,
            n_out=p["n_classes"] if not smoke else cfg.n_out,
            dtype=torch.bfloat16)
        meta, specs = node_edge(n, e, cfg.d_in, (wa,))
        meta["labels"] = _meta((n,), torch.int32)
        specs["labels"] = (wa,)
        return meta, specs, cfg, True  # dist_nodes
    if kind == "graph_molecule":
        b = p["batch"] if not smoke else nw * 2
        npg, epg = (p["n_nodes"], p["n_edges"]) if not smoke else (8, 16)
        cfg = dataclasses.replace(
            cfg, d_in=p["n_species"] if not smoke else cfg.d_in, n_out=1,
            task="graph_reg")
        n, e = b * npg, b * epg
        meta, specs = node_edge(n, e, cfg.d_in, (wa,))
        meta["graph_ids"] = _meta((n,), torch.int32)
        meta["targets"] = _meta((b,), torch.float32)
        meta["graph_mask"] = _meta((b,), torch.float32)
        specs.update(graph_ids=(wa,), targets=(wa,), graph_mask=(wa,))
        return meta, specs, cfg, False
    raise ValueError(kind)


def build_gnn_cell(arch: ArchDef, cell: ShapeCell, mesh,
                   exchange: PSExchange | None, smoke: bool = False,
                   variant: str | None = None) -> CellPlan:
    """EquiformerV2's train step on one graph regime.  ``meta`` adds to
    JAX's the exchange, the batch spec (``runtime.trainer.shard_batch``
    cuts a global graph batch by it), the effective config and
    ``dist_nodes``."""
    base = arch.smoke_config if smoke else arch.config
    if variant == "ep":
        # edge-parallel model axis (tests/scripts/edge_parallel_equivalence.py)
        base = dataclasses.replace(base, edge_parallel=True)
    tp = mesh.shape["model"]
    wa = meshlib.worker_axes(mesh)
    # the model axis stays named at tp = 1, as in JAX: the model's branches
    # on it go JAX's way, and its collectives are the identity there
    dist = Dist(model_axis="model", data_axes=wa, tp=tp, mesh=mesh)
    meta, bspecs, cfg, dist_nodes = _gnn_graph_template(mesh, cell, base, wa,
                                                        smoke)
    if cfg.edge_parallel and tp > 1:
        # edge arrays shard over (workers x model); node arrays over workers
        ea = wa + ("model",)
        nw = meshlib.num_workers(mesh)
        for k in ("edge_src", "edge_dst", "edge_mask", "wigner", "rbf"):
            sp = (ea,) if bspecs[k] != () else ("model",)
            div = nw * tp if sp == (ea,) else tp
            shape = list(meta[k].shape)
            shape[0] = -(-shape[0] // div) * div  # pad edges to shard evenly
            bspecs[k] = sp
            meta[k] = _meta(tuple(shape), meta[k].dtype)
    exchange = exchange or make_exchange(mesh, "gnn")

    step, space, sspecs, ng = make_ps_train_step(
        mesh,
        loss_fn=lambda p, b, d: EQ.loss_fn(p, b, cfg, d, dist_nodes),
        param_specs=EQ.make_param_specs(cfg, tp),
        sync_tags=EQ.grad_sync(cfg, tp),
        global_param_template=EQ.init_params(cfg, None, tp, device="meta"),
        exchange=exchange, dist=dist, batch_spec=bspecs,
        loss_div_tp=False,  # EQ.loss_fn divides by tp itself
    )
    args = (
        _meta((ng, space.flat_elems), torch.float32),
        tuple(_meta((ng, space.flat_elems), torch.float32)
              for _ in sspecs["slots"]),
        None, _meta((), torch.int32), meta,
    )
    n_edges = meta["edge_src"].shape[0]
    n_nodes = meta["node_feat"].shape[0]
    return CellPlan(arch.arch_id, cell.name, "train", step, args, {
        "space": space, "sspecs": sspecs, "n_groups": ng,
        "model_flops": _gnn_flops(cfg, n_nodes, n_edges) * 3.0,  # fwd+bwd
        "nodes": n_nodes, "edges": n_edges,
        # the port's: the driver needs the exchange's axes, the batch's
        # cut and the config the cell trains
        "exchange": exchange, "batch_spec": bspecs, "config": cfg,
        "dist_nodes": dist_nodes})


def _gnn_flops(cfg: EQ.EquiformerConfig, n: int, e: int) -> float:
    c, k = cfg.channels, cfg.num_coef
    n0 = cfg.l_max + 1
    so2 = 2.0 * n0 * n0 * c * c  # m=0 block MACs
    for m in range(1, cfg.m_max + 1):
        nl = cfg.l_max + 1 - m
        so2 += 4 * 2.0 * nl * nl * c * c
    rot = 2.0 * sum((2 * l + 1) ** 2 for l in range(cfg.l_max + 1)) * c * 2
    mix = 2.0 * k * c * c * (1 + 2 + 2)  # w_upd + f1 + f2
    return cfg.n_layers * (e * (so2 + rot) + n * mix) * 2.0


# ===========================================================================
# vision (resnet50, the paper's workload)
# ===========================================================================

def build_vision_train(arch: ArchDef, cell: ShapeCell, mesh,
                       exchange: PSExchange | None,
                       smoke: bool = False) -> CellPlan:
    """Pure data parallelism over every mesh axis: whole parameters on
    every rank, each rank its rows of the global image batch."""
    cfg = arch.smoke_config if smoke else arch.config
    wa = tuple(mesh.axis_names)
    dist = Dist(model_axis=None, data_axes=wa, tp=1)
    gb = cell.params["global_batch"] if not smoke else mesh.size * 2
    img = cell.params.get("img", 224) if not smoke else 32
    exchange = exchange or make_exchange(mesh, "vision")
    gshape = RN.init_params(cfg, None, device="meta")
    step, space, sspecs, ng = make_ps_train_step(
        mesh, loss_fn=lambda p, b, d: RN.loss_fn(p, b, cfg, d),
        global_param_template=gshape, exchange=exchange, dist=dist,
        batch_spec={"images": (wa,), "labels": (wa,)}, loss_div_tp=False,
    )
    args = (
        _meta((ng, space.flat_elems), torch.float32),
        tuple(_meta((ng, space.flat_elems), torch.float32)
              for _ in sspecs["slots"]),
        None, _meta((), torch.int32),
        {"images": _meta((gb, img, img, 3), torch.float32),
         "labels": _meta((gb,), torch.int32)},
    )
    return CellPlan(arch.arch_id, cell.name, "train", step, args, {
        "space": space, "sspecs": sspecs, "n_groups": ng,
        "exchange": exchange,  # the port's: the driver needs its axes
        "model_flops": 3 * 2 * 4.1e9 * gb,  # ~4.1 GMACs/img fwd
        "examples": gb})


# ===========================================================================
# dispatch
# ===========================================================================

def build_cell(arch_id: str, shape: str, mesh, *, strategy: str = "pbox",
               exchange_cfg: ExchangeConfig | None = None,
               opt: OptimizerSpec | None = None, smoke: bool = False,
               variant: str | None = None) -> CellPlan:
    arch = get_arch(arch_id)
    cell = arch.cell(shape)
    if cell.skip_reason and not smoke:
        raise ValueError(f"cell skipped: {cell.skip_reason}")
    if arch.family == "lm":
        if cell.kind == "train":
            ex = make_exchange(mesh, "lm", strategy, opt, exchange_cfg)
            return build_lm_train(arch, cell, mesh, ex, smoke, variant)
        if cell.kind == "prefill":
            return build_lm_prefill(arch, cell, mesh, smoke)
        if cell.kind == "decode":
            return build_lm_decode(arch, cell, mesh, smoke)
        if cell.kind == "decode_long":
            return build_lm_decode_long(arch, cell, mesh, smoke)
    if arch.family == "recsys":
        if cell.kind == "train" and strategy == "pbox_sparse":
            return build_recsys_train_sparse(arch, cell, mesh, smoke)
        ex = (make_exchange(mesh, "recsys", strategy, opt, exchange_cfg)
              if cell.kind == "train" else None)
        return build_recsys_cell(arch, cell, mesh, ex, smoke)
    if arch.family == "gnn":
        ex = make_exchange(mesh, "gnn", strategy, opt, exchange_cfg)
        return build_gnn_cell(arch, cell, mesh, ex, smoke, variant)
    if arch.family == "vision":
        ex = make_exchange(mesh, "vision", strategy, opt, exchange_cfg)
        return build_vision_train(arch, cell, mesh, ex, smoke)
    raise ValueError(f"{arch_id}/{shape}")
