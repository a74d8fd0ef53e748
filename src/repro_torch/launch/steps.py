"""Per-cell step builders: (arch x shape x mesh) -> per-rank step + abstract
args (torch counterpart of ``repro/launch/steps.py``).

Every builder returns a ``CellPlan`` whose ``fn`` is the per-rank step and
whose ``abstract_args`` carry the global shapes and dtypes of its
arguments as meta tensors (JAX's carry ``NamedSharding``s too, for its
dry-run; the port has no dry-run).  The port builds the LM train cell at
tp = 1; every other kind and family raises ``NotImplementedError`` naming
the ROADMAP item that ports it.
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
NOT_PORTED = {
    "prefill": meshlib.TP_ITEM, "decode": meshlib.TP_ITEM,
    "decode_long": meshlib.TP_ITEM, "recsys": "ROADMAP queue 1, item 6c",
}


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
    dist = _lm_dist(mesh)
    gb, s = cell.params["global_batch"], cell.params["seq_len"]
    if smoke:
        gb, s = meshlib.num_workers(mesh) * 2, 32
    mb = (arch.microbatches or {}).get(cell.name, 1) if not smoke else 1
    gshape = T.abstract_params(cfg)

    def loss_fn(params, batch, dist):
        return T.lm_loss(params, batch["tokens"], batch["labels"], cfg)

    step, space, sspecs, ng = make_ps_train_step(
        mesh, loss_fn=loss_fn, global_param_template=gshape,
        exchange=exchange, dist=dist, ps_dtype=cfg.param_dtype,
        microbatches=mb,
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
    n_act = cfg.param_count()
    return CellPlan(arch.arch_id, cell.name, "train", step, args, {
        "space": space, "sspecs": sspecs, "n_groups": ng,
        "exchange": exchange,  # the port's: the driver needs its axes
        "model_flops": 6.0 * n_act * gb * s,
        "tokens": gb * s, "params": cfg.param_count(),
        "microbatches": mb,
    })


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
    if arch.family == "lm" and cell.kind == "train":
        ex = make_exchange(mesh, "lm", strategy, opt, exchange_cfg)
        return build_lm_train(arch, cell, mesh, ex, smoke, variant)
    what = cell.kind if arch.family == "lm" else arch.family
    if what in NOT_PORTED:
        raise NotImplementedError(
            f"{arch_id}/{shape} ({arch.family} {cell.kind}) is not ported "
            f"yet: {NOT_PORTED[what]}")
    raise ValueError(f"{arch_id}/{shape}")
