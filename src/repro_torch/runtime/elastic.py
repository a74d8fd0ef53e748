"""Elastic scaling: re-shard chunked PS state across owner-count changes
(torch counterpart of ``repro/runtime/elastic.py``).

All training state lives in one flat chunk space, so growing or shrinking
the owner set is a re-slice of the same 1-D buffer: no per-tensor
resharding plans.  The module covers three events:

  * node loss (shrink): restore the latest snapshot onto fewer owners;
  * capacity add (grow): re-slice onto more owners (zero chunks pad the
    tail so every owner gets the same count);
  * worker crash and re-entry (the fault tier): ``worker_reentry``
    re-admits a crashed worker onto a live fabric through the
    snapshot/restore contract, so its clock and pull version align with
    the committed round and its first gradient is fresh.

Snapshots are host (numpy) arrays under the fabric's keys, so this module
is numpy only apart from the ``ParamSpace`` it rebuilds.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.chunking import ParamSpace

# snapshot keys that are not chunk-space data: scalars, worker-indexed
# clocks and fault-tier metadata pass through elastic re-targeting
# untouched (PBoxFabric.restore revalidates them against the new fabric)
METADATA_KEYS = ("step", "worker_clock", "dead_workers", "replication")


def reshard_flat(flat: np.ndarray, old_owners: int, new_owners: int,
                 chunk_elems: int) -> np.ndarray:
    """Re-balance a flat chunk space from ``old_owners`` to ``new_owners``.

    ``flat`` is a (flat_elems,) host array laid out for ``old_owners``
    (its chunk count must tile over them).  Returns the same logical
    array, padded at the tail with zero chunks where the new owner count
    needs them; payload offsets are unchanged."""
    n = flat.shape[0]
    if n % chunk_elems:
        raise ValueError("flat not chunk aligned")
    chunks = n // chunk_elems
    if old_owners < 1 or chunks % old_owners:
        raise ValueError(
            f"flat has {chunks} chunks, not a valid layout for "
            f"{old_owners} owners"
        )
    new_chunks = -(-chunks // new_owners) * new_owners
    if new_chunks != chunks:
        flat = np.concatenate(
            [flat, np.zeros(((new_chunks - chunks) * chunk_elems,), flat.dtype)]
        )
    return flat


def owner_slabs(flat: np.ndarray, owners: int) -> list[np.ndarray]:
    """The per-owner slabs of a flat array that tiles over ``owners``."""
    return list(flat.reshape(owners, -1))


def rebuild_space(space: ParamSpace, new_owners: int) -> ParamSpace:
    """Same tensor layout, new owner count (num_chunks re-padded)."""
    num_chunks = -(-space.payload_elems // space.chunk_elems)
    num_chunks = max(num_chunks, 1)
    num_chunks = -(-num_chunks // new_owners) * new_owners
    return ParamSpace(
        slots=space.slots,
        treedef=space.treedef,
        chunk_elems=space.chunk_elems,
        num_owners=new_owners,
        payload_elems=space.payload_elems,
        flat_elems=num_chunks * space.chunk_elems,
    )


def elastic_restore(host_state: dict, old_space: ParamSpace,
                    new_owners: int) -> tuple[dict, ParamSpace]:
    """Re-target a snapshotted flat state onto a new owner count.

    Scalar and worker-indexed keys (``METADATA_KEYS``) pass through
    untouched: they are not chunk-space data, and ``PBoxFabric.restore``
    resets the clocks itself when the worker count differs."""
    new_space = rebuild_space(old_space, new_owners)
    out = {}
    for k, v in host_state.items():
        if k in METADATA_KEYS:
            out[k] = v
            continue
        if isinstance(v, (tuple, list)) and len(v) == 0:
            # a stateless optimizer (sgd): no slots to reshard
            out[k] = type(v)()
            continue
        arr = np.asarray(v)
        groups = arr.reshape(arr.shape[0], -1) if arr.ndim > 1 else arr[None]
        resized = []
        for g in groups:
            g = g[: old_space.flat_elems]
            if new_space.flat_elems > g.shape[0]:
                g = np.concatenate(
                    [g, np.zeros((new_space.flat_elems - g.shape[0],), g.dtype)]
                )
            else:
                g = g[: new_space.flat_elems]
            resized.append(g)
        out[k] = np.stack(resized) if arr.ndim > 1 else resized[0]
    return out, new_space


def worker_reentry(fabric, worker: int) -> dict:
    """Re-admit a crashed worker onto a live fabric.

    The fabric's current snapshot is what the worker's replacement process
    restores (params, optimizer state, the committed round, crash-consistent
    clocks), and ``revive_worker`` aligns the worker's admission state with
    it: its clock at the snapshot's step and its pull version current, so
    its first gradient is fresh and SSP's window is not tripped by the
    outage.  Returns the snapshot handed to the replacement worker."""
    snap = fabric.snapshot()
    fabric.revive_worker(worker, clock=int(snap["step"]))
    return snap
