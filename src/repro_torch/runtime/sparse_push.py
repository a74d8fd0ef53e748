"""Sparse embedding push: the PS key-value insight applied to recsys tables
(torch counterpart of ``repro/runtime/sparse_push.py``).

Baseline (pbox over the full chunk space) treats the embedding tables as
dense parameters: the push reduce-scatters gigabytes of mostly zero
gradient.  The paper's PS is a *key-value* store precisely because
embedding-style workloads touch a tiny key subset per step; this module
routes table gradients as (ids, cotangent-rows) pairs instead:

  1. the loss is differentiated with respect to the *post-lookup*
     embeddings ``e`` (the dense interaction stage's input), giving cot_e
     (B_w/tp, F, D);
  2. cot_e is all-gathered over the model axis (the manual transpose of the
     lookup's psum_scatter) -> (B_w, F, D), cast to bf16 (wire dtype);
  3. ids + cotangents are all-gathered over the worker axes — wire bytes =
     global_batch x F x (D x 2 + 4), independent of table size;
  4. each table shard scatter-adds the rows it owns with the SGD step fused
     into the scatter (sparse/"lazy" update semantics, the MLPerf DLRM
     convention) — no dense table gradient is ever materialized.

Dense (bot/top MLP) parameters still flow through the chunked PBox exchange
(``PSExchange.device_update``, whose ``fused_agg_opt`` kernel updates them).
These are per-rank functions over a ``launch.mesh.Mesh``, as the rest of
the SPMD path; the tables are this rank's row shards, updated IN PLACE (the
JAX step donates them).  ``coalesce_ids_rows`` is the NIC-side dedup the
in-process sparse tier (``core/sparse.py``) uses.
"""
from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.exchange import PSExchange
from repro_torch.kernels.embedding_bag.ops import segment_sum
from repro_torch.models.common import Dist
from repro_torch.runtime.trainer import (
    _leaves,
    apply_grad_sync,
    local_template,
    tracked_params,
)


def coalesce_ids_rows(ids: Any, rows: torch.Tensor) -> tuple[np.ndarray,
                                                             torch.Tensor]:
    """NIC-side duplicate-id coalescing: ``(ids (n,), rows (n, D))`` ->
    ``(unique ascending ids, per-id summed rows)``.

    A batch that touches row 7 five times routes *one* wire row carrying
    the sum — the key-value dedup the PS push exists for.  Duplicates fold
    in batch order from 0 (``kernels.embedding_bag.segment_sum``: the JAX
    segment sum's order on the CPU, kept on the card, where an atomic
    scatter-add would fold them in no fixed order), before any routing
    decision, so the summed bits are independent of how the table is
    sharded; ``core/sparse.SparseTier`` leans on that for its bit-identity
    invariant."""
    ids_np = np.asarray(ids).reshape(-1)
    rows = torch.as_tensor(rows, dtype=torch.float32)
    if rows.shape[0] != ids_np.size:
        raise ValueError(
            f"rows leading dim {rows.shape[0]} != {ids_np.size} ids")
    if ids_np.size == 0:
        return ids_np.astype(np.int64), rows
    uniq, inv = np.unique(ids_np, return_inverse=True)
    summed = segment_sum(rows, inv.reshape(-1), int(uniq.size))
    return uniq.astype(np.int64), summed


def sparse_table_update(
    tables: dict,  # name -> (V_loc, D) local shard, updated in place
    ids: torch.Tensor,  # (B_w, F) this worker's ids (global)
    cot_e: torch.Tensor,  # (B_w/tp, F, D) cotangent at the lookup output
    dist: Dist,
    worker_axes,
    lr: torch.Tensor | float,
    wire_dtype: torch.dtype = torch.bfloat16,
    *,
    mesh=None,
) -> dict:
    """Apply one sparse SGD step to every table shard (per-rank code; the
    collectives run over ``mesh``, which only a model axis above one or
    worker axes need).  Returns ``tables``, whose tensors it updated.

    The scale is f32(lr) / nw divided in f32 on the host: inside the
    jitted JAX step lr and nw are constants, folded by a true division.
    Per table (in ``int(name[1:])`` order) the rows this shard owns take
    ``t[rows] += -(f32(cot) * scale)`` by one ``index_put_`` with
    ``accumulate=True``: duplicates fold one at a time from the table row
    in batch order, as the JAX scatter-add does (a sequential loop on the
    CPU; on the card a stable sort by row, then an in-order fold).  Ids
    the shard does not own land on row 0 with a zero update, which keeps
    row 0's bits."""
    if dist.model_axis is not None and dist.tp > 1:
        cot = mesh.all_gather(cot_e, dist.model_axis, axis=0)
    else:
        cot = cot_e
    cot = cot.to(wire_dtype)
    if worker_axes:
        ids_all = mesh.all_gather(ids, worker_axes, axis=0)
        cot_all = mesh.all_gather(cot, worker_axes, axis=0)
        nw = mesh.axis_size(worker_axes)
    else:
        ids_all, cot_all, nw = ids, cot, 1
    scale = float(np.float32(float(lr)) / np.float32(nw))
    midx = dist.model_index()
    for i, name in enumerate(sorted(tables, key=lambda k: int(k[1:]))):
        t = tables[name]
        vloc = t.shape[0]
        local = ids_all[:, i].long() - midx * vloc
        ok = (local >= 0) & (local < vloc)
        rows = torch.where(ok, local, torch.zeros_like(local))
        upd = cot_all[:, i].float() * (ok.float() * scale)[:, None]
        # (4) fused sparse SGD: rows this shard owns, one scatter-add
        t.index_put_((rows,), -upd.to(t.dtype), accumulate=True)
    return tables


def make_sparse_recsys_train_step(
    mesh,
    *,
    lookup_fn: Callable,  # (tables, batch, dist) -> e
    loss_from_emb: Callable,  # (dense_params, e, batch, dist) -> (loss, met)
    dense_specs: Any,
    dense_sync: Any,
    dense_template: Any,  # global meta tensors for the dense params
    table_specs: Any,
    exchange: PSExchange,  # dense-parameter exchange
    dist: Dist,
    batch_spec: Any = None,
    table_lr: float = 1e-2,
):
    """Returns (step, space, sspecs).

    step(pflat, slots, ef, step_cnt, tables, batch) ->
        (pflat', slots', ef', step', tables', metrics)

    on this rank's pieces, as ``runtime.trainer.make_ps_train_step``'s step
    takes them, plus its table shards (updated in place).  The dense half
    goes through ``exchange.device_update``; the loss is differentiated
    with respect to the dense params and a leaf ``e`` made after the
    lookup, so no backward runs through the lookup's psum_scatter.
    ``table_specs`` and ``batch_spec`` are accepted for JAX call sites: the
    tables and the batch arrive as this rank's pieces."""
    wa = exchange.worker_axes
    local = local_template(dense_template, dense_specs, mesh)
    space = exchange.build_space(local, dict(mesh.shape))
    n_state = exchange.spec.num_state_slots
    syncs = dist.model_axis is not None and any(
        tag != "none" for tag in _leaves(dense_sync))
    all_axes = tuple(mesh.axis_names)

    def step(pflat, slots, ef, step_cnt, tables, batch):
        pf = pflat.reshape(-1)
        with torch.no_grad():
            e = lookup_fn(tables, batch, dist)
        leaf = pf.detach().requires_grad_(True)
        e_leaf = e.detach().requires_grad_(True)
        loss, met = loss_from_emb(tracked_params(space, leaf), e_leaf, batch,
                                  dist)
        gflat, g_e = torch.autograd.grad(loss, (leaf, e_leaf))
        del e, e_leaf
        if syncs:
            gflat = space.flatten(apply_grad_sync(
                space.unflatten(gflat), dense_sync, dist), torch.float32)
        state = {"slots": tuple(s.reshape(-1) for s in slots), "ef": None,
                 "step": step_cnt}
        new_pf, new_state = exchange.device_update(gflat.float(), pf, state,
                                                   mesh=mesh)
        del gflat
        new_tables = sparse_table_update(tables, batch["sparse"], g_e, dist,
                                         wa, table_lr, mesh=mesh)
        met = {k: mesh.pmean(v.detach(), all_axes) for k, v in met.items()}
        loss = mesh.pmean(loss.detach(), all_axes)
        return (new_pf.reshape(1, -1),
                tuple(s.reshape(1, -1) for s in new_state["slots"]),
                None, new_state["step"], new_tables, {"loss": loss, **met})

    owner = ("model", exchange.owner_axes or None)
    sspecs = {
        "pflat": ("model", None),
        "slots": tuple(owner for _ in range(n_state)),
        "ef": None,
        "step": (),
    }
    return step, space, sspecs
