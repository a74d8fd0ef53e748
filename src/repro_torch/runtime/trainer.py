"""Training runtime: the PS train step, per rank (torch counterpart of
``repro/runtime/trainer.py``).

Data flow per step (per rank):

  pflat (flat chunked params, this model group)      <- this rank's state
    -> views of the flat as the model's local tensors
    -> loss / tp and the flat gradient by autograd (PHub key chunking)
    -> grad-sync tags (psum_model / scale_R for replicated copies)
    -> exchange.device_update: push / fused-update / pull (PBox)
  -> new pflat, new PS state, metrics averaged over every rank

The JAX step is one jitted ``shard_map`` over global arrays.  Here every
rank of a ``launch.mesh.Mesh`` calls the step on its own pieces:

  * ``pflat``: its model group's flat (the group is its coordinate on the
    ``model`` axis), (1, flat), replicated over the workers;
  * ``slots`` / ``ef``: its owned slab of its group, (1, slab) each (the
    whole flat under ``allreduce``);
  * ``batch``: its rows of the global batch, in mesh order, as ``P(wa)``
    shards them (``shard_batch``); every rank of a model group gets the
    same rows.

The flat space is the local shard's: ``local_template`` cuts the global
parameter shapes by ``param_specs``, as JAX's does.  The model's tensors
are views of one leaf (``torch.split`` of the flat, then ``view``), so
autograd's backward of the split concatenates the leaves' gradients
straight into the flat gradient, zero padding included: bit for bit
``space.flatten(grads, ps_dtype)`` without the extra copy.  On the card
the kernel updates the owned slab of ``pflat`` and the slots in place:
the step consumes its inputs (the JAX step donates them), unless
``donate=False`` asks it to work on copies.

``TrainState`` is the JAX package's global host view (``(n_groups, flat)``
arrays, group ``g``'s row its model shard, owner ``i``'s slab of the slots
at its linear index), the layout of the checkpoints, so each package
restores the other's.  ``local_state`` cuts a rank's pieces from it and
``global_state`` gathers them back; with ``local_template`` and
``local_params`` they take the place of JAX's shardings, so JAX's
``state_shardings`` has no counterpart here.

The step's pieces are ``repro_torch.tracing`` spans: ``ps.forward`` (the
loss), ``ps.backward`` (autograd, recomputation included), ``ps.grad_sync``
and ``ps.metrics`` (the means after the exchange).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.core.chunking import ParamSpace, _unflatten_paths
from repro_torch.core.exchange import PSExchange
from repro_torch.core.fabric import ServerStats
from repro_torch.device import resolve_device
from repro_torch.models.common import Dist
from repro_torch.tracing import span


@dataclasses.dataclass
class TrainState:
    """Global (host-view) training state."""

    pflat: torch.Tensor  # (n_groups, flat_local) — model-axis groups
    slots: tuple  # each (n_groups, flat_local) f32 (sharded over owners)
    ef: torch.Tensor | None
    step: torch.Tensor  # scalar int32


def _tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def local_template(global_tree: Any, specs: Any, mesh) -> Any:
    """Global parameter shapes cut to a rank's local ones (meta tensors):
    each dimension a spec names divided by its axes' sizes."""

    def shrink(x, spec):
        shape = list(x.shape)
        for i, s in enumerate(spec):
            for a in _spec_axes(s):
                shape[i] //= mesh.shape[a]
        return torch.empty(shape, dtype=x.dtype, device="meta")

    return _tree_map(shrink, global_tree, specs)


def _spec_axes(s) -> tuple:
    if s is None:
        return ()
    return s if isinstance(s, tuple) else (s,)


def take_local(x: torch.Tensor, spec, group: int, n_groups: int):
    """Model group ``group``'s block of ``x``: each dimension the spec
    shards over ``model`` cut into ``n_groups`` blocks (JAX's
    ``init_train_state`` ``take_local``)."""
    idx = [slice(None)] * x.dim()
    for i, s in enumerate(spec):
        if "model" in _spec_axes(s):
            n = x.shape[i] // n_groups
            idx[i] = slice(group * n, (group + 1) * n)
    return x[tuple(idx)]


def local_params(params: Any, specs: Any, mesh) -> Any:
    """This rank's pieces of a global parameter tree (for instance one
    carried across from the JAX package by ``repro_torch.interop``), cut
    by ``specs`` (``transformer.make_param_specs``) at the rank's
    coordinate on the ``model`` axis; views of ``params``."""
    tp = mesh.shape.get("model", 1)
    g = mesh.coords["model"] if tp > 1 else 0
    return _tree_map(lambda x, s: take_local(x, s, g, tp), params, specs)


def apply_grad_sync(grads: Any, tags: Any, dist: Dist) -> Any:
    """Apply per-tensor gradient corrections (see the JAX
    ``transformer.grad_sync``): ``psum_model`` sums a replicated copy's
    gradient over the model axis, ``scale_R`` multiplies by R."""

    def fix(g, tag):
        if tag == "none" or dist.model_axis is None:
            return g
        if tag == "psum_model":
            return dist.psum_model(g)
        if tag.startswith("scale_"):
            return g * float(tag.split("_")[1])
        raise ValueError(f"unknown grad-sync tag {tag}")

    return _tree_map(fix, grads, tags)


def attach_telemetry(
    step_fn: Callable,
    exchange: PSExchange,
    space: ParamSpace,
    mesh,
    stats: ServerStats | None = None,
    topology=None,
    job=None,
    replication: int | None = None,
    read_plane=None,
) -> Callable:
    """Wrap a PS train step so every invocation records the modeled wire
    traffic into a fabric-style ``ServerStats``.

    It records the exchange's analytic wire model
    (``PSExchange.modeled_bytes``, the bytes a ring moves on the links)
    scaled by the worker count, as the JAX package does, so both PS
    implementations share one accounting surface; ``PSExchange.stats``
    beside it counts the bytes of the tensors actually handed to the
    collectives.  Only ``mesh.shape`` is read.

    ``topology`` (a ``core/topology.NetworkTopology``) splits the push
    traffic into the rack and core tiers the fabric tracks; ``job`` (a
    tenancy ``JobHandle``) defaults ``stats``, ``topology`` and
    ``replication`` from the job; ``replication`` models the fault tier's
    ``R - 1`` raw-f32 state streams a step into ``bytes_replication``;
    ``read_plane`` (a ``core/serving.ReadPlane``) has its round clock
    advanced once a step (``notify_round``)."""
    from repro_torch.core.compression import wire_bytes as _wire_bytes

    if job is not None:
        stats = job.stats if stats is None else stats
        topology = job.topology if topology is None else topology
        if replication is None:
            replication = getattr(job, "replication", None)
    replication = 1 if replication is None else replication
    if replication < 1:
        raise ValueError("replication factor must be >= 1")
    if stats is None:
        raise ValueError("attach_telemetry needs stats= or job=")
    n_pod = mesh.shape[exchange.pod_axis] if exchange.pod_axis else 1
    n_workers = 1
    for a in exchange.worker_axes:
        n_workers *= mesh.shape[a]
    if topology is not None and topology.num_workers != n_workers:
        raise ValueError(
            f"topology is for {topology.num_workers} workers, mesh worker "
            f"axes give {n_workers}"
        )
    n_data = n_workers // n_pod
    mb = exchange.modeled_bytes(space.flat_elems, n_pod, n_data)
    push = int(mb["push"] + (mb["xpod"] or 0.0))
    pull = int(mb["pull"])
    # only pbox_hier compresses its wire, and only on the cross-pod (core)
    # stage; every strategy's intra-pod push is raw f32
    compresses = (exchange.cfg.strategy == "pbox_hier"
                  and exchange.cfg.compression.codec != "none")
    raw_stream = 4 * space.flat_elems
    core_stream = (_wire_bytes(exchange.cfg.compression, space.flat_elems)
                   if compresses else raw_stream)
    if topology is not None:
        rack_bytes = raw_stream * n_workers
        core_streams = (topology.num_racks if topology.rack_aggregation
                        else n_workers)
        core_bytes = core_stream * core_streams
    else:
        rack_bytes = 0
        core_bytes = core_stream * n_workers
    repl_stream = 4 * space.flat_elems * (1 + exchange.spec.num_state_slots)
    repl_bytes = repl_stream * (replication - 1)
    repl_cross_rack = topology is not None and topology.num_racks > 1

    def wrapped(*args, **kwargs):
        out = step_fn(*args, **kwargs)
        stats.steps += 1
        stats.pushes += n_workers
        stats.pulls += n_workers
        stats.bytes_pushed += push * n_workers
        stats.bytes_pulled += pull * n_workers
        stats.bytes_rack_link += rack_bytes
        stats.bytes_core_link += core_bytes
        stats.chunk_pushes += space.num_chunks * n_workers
        stats.chunk_pulls += space.num_chunks * n_workers
        if repl_bytes:
            stats.bytes_replication += repl_bytes
            stats.replication_rounds += 1
            if repl_cross_rack:
                stats.bytes_core_link += repl_bytes
            elif topology is not None:
                stats.bytes_rack_link += repl_bytes
        if read_plane is not None:
            read_plane.notify_round()
        return out

    return wrapped


def _state_specs(exchange: PSExchange, n_state: int, has_ef: bool) -> dict:
    """Each piece's axes as JAX's ``PartitionSpec``s name them: dim 0 over
    the model groups, dim 1 over the owner axes (or replicated)."""
    owner = ("model", exchange.owner_axes or None)
    return {
        "pflat": ("model", None),
        "slots": tuple(owner for _ in range(n_state)),
        "ef": owner if has_ef else None,
        "step": (),
    }


def _has_ef(exchange: PSExchange) -> bool:
    c = exchange.cfg.compression
    return c.codec != "none" and c.error_feedback


def tracked_params(space: ParamSpace, leaf: torch.Tensor) -> dict:
    """The parameter tree as views of the flat ``leaf`` (see the module
    docstring): autograd's gradient of ``leaf`` is the flat gradient."""
    sizes = [slot.size for slot in space.slots] + [space.padding_elems]
    parts = torch.split(leaf, sizes)
    leaves = [p.view(slot.shape).to(slot.dtype)
              for p, slot in zip(parts, space.slots)]
    return _unflatten_paths(space.treedef, leaves)


def make_ps_train_step(
    mesh,
    *,
    loss_fn: Callable,  # (params, batch, dist) -> (loss, metrics); per rank
    param_specs: Any = None,
    sync_tags: Any = None,
    global_param_template: Any,  # tree of tensors (meta ones do): shapes
    exchange: PSExchange,
    dist: Dist,
    batch_spec: Any = None,
    ps_dtype=torch.float32,
    loss_div_tp: bool = True,
    lr_schedule: Callable | None = None,
    donate: bool = True,
    microbatches: int = 1,
    telemetry: ServerStats | None = None,
):
    """Returns (step, ParamSpace, state_specs, n_groups).

    step(pflat, slots, ef, step_count, batch) ->
        (new_pflat, new_slots, new_ef, new_step, metrics)

    on this rank's pieces (module docstring).  ``param_specs`` cut
    ``global_param_template`` to the local shapes of the flat space (whole
    tensors when None); ``sync_tags`` (``transformer.grad_sync``) correct
    the gradients before the exchange.  ``batch_spec`` is accepted for JAX
    call sites: the batch arrives as this rank's rows.  ``microbatches``
    accumulates that many gradients (in ``ps_dtype``, from zeros) before
    one exchange; ``lr_schedule(step)`` scales the rate; ``telemetry``
    wraps the step with ``attach_telemetry``."""
    tp = dist.tp if dist.model_axis is not None else 1
    n_groups = tp if dist.model_axis is not None else 1
    local = (global_param_template if param_specs is None else
             local_template(global_param_template, param_specs, mesh))
    space = exchange.build_space(local, dict(mesh.shape))
    n_state = exchange.spec.num_state_slots
    sspecs = _state_specs(exchange, n_state, _has_ef(exchange))
    syncs = sync_tags is not None and dist.model_axis is not None and any(
        tag != "none" for tag in _leaves(sync_tags))
    all_axes = tuple(mesh.axis_names)

    def grads_of(pf, mb):
        leaf = pf.detach().requires_grad_(True)
        with span("ps.forward"):
            loss, met = loss_fn(tracked_params(space, leaf), mb, dist)
            lossd = loss / tp if (loss_div_tp and tp > 1) else loss
        with span("ps.backward"):
            (gflat,) = torch.autograd.grad(lossd, leaf)
        if syncs:
            with span("ps.grad_sync"):
                grads = apply_grad_sync(space.unflatten(gflat), sync_tags,
                                        dist)
                gflat = space.flatten(grads, ps_dtype)
        return (gflat.to(ps_dtype), loss.detach(),
                {k: v.detach() for k, v in met.items()})

    def step(pflat, slots, ef, step_cnt, batch):
        if not donate:
            pflat = pflat.clone()
            slots = tuple(s.clone() for s in slots)
            ef = ef.clone() if ef is not None else None
        pf = pflat.reshape(-1)  # (flat_local,)
        if microbatches <= 1:
            gflat, loss, met = grads_of(pf, batch)
        else:
            # gradient accumulation: one PS exchange per global batch
            gflat = torch.zeros((space.flat_elems,), dtype=ps_dtype,
                                device=pf.device)
            losses, mets = [], []
            for i in range(microbatches):
                mb = {k: _rows(v, i, microbatches) for k, v in batch.items()}
                g, loss_i, met_i = grads_of(pf, mb)
                gflat = gflat + g
                del g
                losses.append(loss_i)
                mets.append(met_i)
            gflat = gflat * (1.0 / microbatches)
            loss = _mean(losses)
            met = {k: _mean([m[k] for m in mets]) for k in mets[0]}

        lr_scale = lr_schedule(step_cnt + 1) if lr_schedule is not None else 1.0
        state = {"slots": tuple(s.reshape(-1) for s in slots),
                 "ef": ef.reshape(-1) if ef is not None else None,
                 "step": step_cnt}
        new_pf, new_state = exchange.device_update(gflat, pf, state, lr_scale,
                                                   mesh=mesh)
        del gflat
        # metrics: mean over every axis
        with span("ps.metrics"):
            met = {k: mesh.pmean(v, all_axes) for k, v in met.items()}
            loss = mesh.pmean(loss, all_axes)
        new_slots = tuple(s.reshape(1, -1) for s in new_state["slots"])
        new_ef = (new_state["ef"].reshape(1, -1)
                  if new_state["ef"] is not None else None)
        return (new_pf.reshape(1, -1), new_slots, new_ef, new_state["step"],
                {"loss": loss, **met})

    if telemetry is not None:
        step = attach_telemetry(step, exchange, space, mesh, telemetry)
    return step, space, sspecs, n_groups


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def _rows(x: torch.Tensor, i: int, n: int) -> torch.Tensor:
    """Microbatch ``i`` of ``n``: the rows JAX's ``reshape(n, B/n, ...)``
    gives it."""
    b = x.shape[0] // n
    return x[i * b:(i + 1) * b]


def _mean(xs: list) -> torch.Tensor:
    """``jnp.mean`` of a stack under ``jit``: a left-fold sum times the
    f32 reciprocal of the count."""
    acc = xs[0]
    for x in xs[1:]:
        acc = acc + x
    return acc * (1.0 / len(xs))


def init_train_state(
    mesh,
    *,
    init_params_fn: Callable,  # (key) -> param tree (concrete)
    param_specs: Any = None,
    exchange: PSExchange,
    space: ParamSpace,
    n_groups: int,
    key,
    ps_dtype=torch.float32,
    device: torch.device | str | None = None,
) -> TrainState:
    """The global ``TrainState`` from ``init_params_fn(key)`` (``key`` is
    whatever the function takes, e.g. a seeded ``torch.Generator``), on
    ``device`` (the card unless the caller passes another).  Row ``g`` of
    ``pflat`` is model group ``g``'s local shard of every tensor, cut by
    ``param_specs`` (the whole model when None)."""
    dev = resolve_device(device)
    params = init_params_fn(key)
    if param_specs is None:
        flat = space.flatten(params, ps_dtype).to(dev)
        pflat = flat.reshape(1, -1).expand(n_groups, -1).contiguous()
        del flat
    else:
        pflat = torch.stack([space.flatten(_tree_map(
            lambda x, s, g=g: take_local(x, s, g, n_groups), params,
            param_specs), ps_dtype).to(dev) for g in range(n_groups)])
    del params
    slots = tuple(
        torch.zeros((n_groups, space.flat_elems), dtype=torch.float32,
                    device=dev)
        for _ in range(exchange.spec.num_state_slots)
    )
    # NB: slots/ef global second dim is flat_elems (= slab * owners)
    ef = (torch.zeros((n_groups, space.flat_elems), dtype=torch.float32,
                      device=dev) if _has_ef(exchange) else None)
    return TrainState(pflat=pflat, slots=slots, ef=ef,
                      step=torch.zeros((), dtype=torch.int32, device=dev))


def _group(mesh, exchange: PSExchange) -> tuple[int, int]:
    """(this rank's model group, the number of groups).  An exchange whose
    workers span the model axis (the vision family's pure data
    parallelism) has one group."""
    tp = mesh.shape.get("model", 1)
    if tp == 1 or "model" in exchange.worker_axes:
        return 0, 1
    return mesh.coords["model"], tp


def local_state(state: TrainState, mesh, exchange: PSExchange) -> tuple:
    """This rank's ``(pflat, slots, ef, step)`` from the global state: its
    model group's flat and its owned slab of the group's slots and
    residual (views, which the step then consumes)."""
    n_owner = mesh.axis_size(exchange.owner_axes)
    o = mesh.axis_index(exchange.owner_axes)
    g, _ = _group(mesh, exchange)

    def mine(x):
        n = x.shape[-1] // n_owner
        return x[g:g + 1, o * n:(o + 1) * n]

    return (state.pflat[g:g + 1], tuple(mine(s) for s in state.slots),
            mine(state.ef) if state.ef is not None else None, state.step)


def global_state(mesh, exchange: PSExchange, pflat, slots, ef,
                 step) -> TrainState:
    """The global ``TrainState`` from every rank's pieces: each owner's slab
    gathered at its linear index, each model group's row at its
    coordinate (a collective: every rank calls it)."""
    _, tp = _group(mesh, exchange)

    def groups(x):
        x = x.reshape(1, -1)
        return mesh.all_gather(x, "model") if tp > 1 else x

    def gather(x):
        return groups(mesh.all_gather(x.reshape(-1), exchange.owner_axes))

    return TrainState(pflat=groups(pflat),
                      slots=tuple(gather(s) for s in slots),
                      ef=gather(ef) if ef is not None else None, step=step)


def shard_batch(batch: dict, mesh, exchange: PSExchange,
                spec: dict | None = None, rebase: dict | None = None) -> dict:
    """This rank's rows of a global batch.  With no ``spec``, worker ``w``
    (the linear index over the worker axes) takes rows ``[w*b, (w+1)*b)``,
    whatever its model coordinate.  A ``spec`` (the plan's batch spec, one
    JAX ``PartitionSpec`` tuple a key) cuts dim 0 of each key by the linear
    index over the axes its first entry names: ``()`` keeps the key whole,
    ``(("data", "model"),)`` cuts by workers then the model coordinate.
    ``rebase`` maps an id key to the key whose rows it indexes (``{"edge_src":
    "node_feat"}``): this rank's ids are shifted down by the offset of its
    block of those rows, so ids that never leave their block become local."""
    def cut(v, axes):
        n, i = mesh.axis_size(axes), mesh.axis_index(axes)
        b = v.shape[0] // n
        return v[i * b:(i + 1) * b], i * b

    def axes_of(k):
        if spec is None:
            return exchange.worker_axes
        s = spec[k]
        return _spec_axes(s[0]) if len(s) else ()

    out = {k: cut(v, axes_of(k))[0] for k, v in batch.items()}
    for k, ref in (rebase or {}).items():
        out[k] = out[k] - cut(batch[ref], axes_of(ref))[1]
    return out
