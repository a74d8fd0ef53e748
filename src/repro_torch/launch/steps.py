"""Per-cell step builders: (arch x shape x mesh) -> per-rank step + abstract
args (torch counterpart of ``repro/launch/steps.py``).

Every builder returns a ``CellPlan`` whose ``fn`` is the per-rank step and
whose ``abstract_args`` carry the global shapes and dtypes of its
arguments as meta tensors (JAX's carry ``NamedSharding``s too, for its
dry-run; the port has no dry-run).  The LM cells (train, prefill, decode,
decode_long) build at any model-axis size; the recsys family raises
``NotImplementedError`` naming the ROADMAP item that ports it.  A serving
plan's ``fn`` takes the rank's local parameters (cut from the global tree
by ``runtime.trainer.local_params``), its rows of the batch and its
sequence shard of the cache, and runs without autograd.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.registry import ArchDef, ShapeCell, get_arch
from repro_torch.core.exchange import ExchangeConfig, PSExchange
from repro_torch.launch import mesh as meshlib
from repro_torch.models import transformer as T
from repro_torch.models.common import Dist
from repro_torch.optim.optimizers import OptimizerSpec, adamw, momentum, sgd
from repro_torch.runtime.trainer import make_ps_train_step

# what build_cell refuses among the registered archs' cells (the gnn and
# vision archs are not registered yet: ROADMAP queue 1, item 7)
NOT_PORTED = {"recsys": "ROADMAP queue 1, item 6c"}


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
    if variant is not None:
        raise NotImplementedError(
            f"variant {variant!r} (sequence-parallel activations): "
            "ROADMAP queue 1, item 7")
    cfg = arch.smoke_config if smoke else arch.config
    tp = mesh.shape["model"]
    dist = _lm_dist(mesh)
    gb, s = cell.params["global_batch"], cell.params["seq_len"]
    if smoke:
        gb, s = meshlib.num_workers(mesh) * 2, 32
    mb = (arch.microbatches or {}).get(cell.name, 1) if not smoke else 1

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
    if arch.family in NOT_PORTED:
        raise NotImplementedError(
            f"{arch_id}/{shape} ({arch.family} {cell.kind}) is not ported "
            f"yet: {NOT_PORTED[arch.family]}")
    raise ValueError(f"{arch_id}/{shape}")
