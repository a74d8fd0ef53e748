"""Fault-tolerant checkpointing of the fabric's training state (torch
counterpart of ``repro/checkpoint/checkpointer.py``).

The file format is the JAX package's, so either package reads the other's
checkpoints: ``<dir>/step-<step:010d>/`` holds one ``.npy`` file per array
and a ``manifest.json`` (step, time, each array's file, shape and dtype,
and the caller's meta).

  * **Atomic commits**: writes go to ``<dir>/tmp-<step>-<pid>`` and are
    renamed to ``<dir>/step-<step>`` only after an fsync'd manifest lands;
    a crashed writer never corrupts the latest checkpoint, and
    ``latest_step`` skips a directory without a manifest.
  * **Async**: ``save_async`` copies tensors to host memory before it
    returns and hands the I/O to a background thread.  The copy cannot
    wait for the thread: on the card the fabric's kernels update its
    state in place.
  * **Crash-consistent for the fabric**: ``save_fabric`` persists
    ``PBoxFabric.snapshot()``, safe to take mid-round (the snapshot rolls
    in-flight pushes back out of the worker clocks), with the metadata a
    replayable recovery needs.  Checkpoints without that metadata still
    load: ``restore_fabric`` treats them as an all-alive fabric.

``train_state_to_flat`` / ``flat_to_train_state`` carry the SPMD
trainer's global ``TrainState`` (``pflat``, ``slot{i}``, ``ef`` as
``(n_groups, flat)`` arrays, each owner's slab at its linear index), the
JAX trainer's layout.  bf16 arrays go to disk as 2-byte raw values (numpy
dtype ``V2``), which is how ``np.save`` writes the JAX package's bf16
arrays, and come back as bf16 tensors.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.device import resolve_device


def _host_array(v) -> np.ndarray:
    if not torch.is_tensor(v):
        return np.array(v)
    v = v.detach().to("cpu", copy=True)
    if v.dtype == torch.bfloat16:  # raw 2-byte values, as np.save keeps JAX's
        return v.view(torch.int16).numpy().view(np.dtype("V2"))
    return v.numpy()


def _to_host(state: dict) -> dict:
    """name -> a host numpy copy of each tensor or array (None dropped)."""
    return {k: _host_array(v) for k, v in state.items() if v is not None}


def _from_host(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A restored array as a tensor on ``device``; 2-byte raw values (and
    ``ml_dtypes`` bf16 arrays) as bf16."""
    a = np.array(a, copy=True)
    if a.dtype == np.dtype("V2") or a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


class Checkpointer:
    def __init__(self, directory: str | os.PathLike, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    # ------------------------------------------------------------------
    def save(self, step: int, state: dict, meta: dict | None = None) -> Path:
        """Blocking save.  ``state``: flat dict name -> tensor or array (or
        None)."""
        host = _to_host(state)
        return self._write(step, host, meta or {})

    def save_async(self, step: int, state: dict, meta: dict | None = None) -> None:
        """Copy ``state`` to host memory now, then write it on a background
        thread: a tensor the caller (or an in-place kernel) changes after
        this returns does not reach the file."""
        self.wait()
        host = _to_host(state)

        def work():
            try:
                self._write(step, host, meta or {})
            except BaseException as e:  # noqa: BLE001
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # ------------------------------------------------------------------
    def _write(self, step: int, host: dict, meta: dict) -> Path:
        tmp = self.dir / f"tmp-{step}-{os.getpid()}"
        final = self.dir / f"step-{step:010d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        arrays = {}
        for k, v in host.items():
            fn = f"{k.replace('/', '_')}.npy"
            np.save(tmp / fn, v)
            arrays[k] = {"file": fn, "shape": list(v.shape), "dtype": str(v.dtype)}
        manifest = {
            "step": step,
            "time": time.time(),
            "arrays": arrays,
            "meta": meta,
        }
        mf = tmp / "manifest.json"
        with open(mf, "w") as f:
            json.dump(manifest, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()
        return final

    def _gc(self) -> None:
        steps = sorted(self.dir.glob("step-*"))
        for old in steps[: -self.keep]:
            shutil.rmtree(old, ignore_errors=True)

    # ------------------------------------------------------------------
    def latest_step(self) -> int | None:
        steps = sorted(self.dir.glob("step-*"))
        for cand in reversed(steps):
            if (cand / "manifest.json").exists():
                return int(cand.name.split("-")[1])
        return None

    # -- fabric snapshots (fault tier) ---------------------------------
    def save_fabric(self, step: int, fabric, meta: dict | None = None) -> Path:
        """Persist a crash-consistent ``PBoxFabric.snapshot()`` (safe
        mid-round — see module docstring) with replication metadata."""
        snap = fabric.snapshot()
        meta = dict(meta or {})
        meta.update(
            fabric_schema=2,
            replication=int(snap.get("replication", 1)),
            num_workers=int(fabric.num_workers),
            fault_round=int(snap["step"]),
            fault_events_fired=len(getattr(fabric, "fault_trace", ())),
        )
        return self.save(step, fabric_snapshot_to_flat(snap), meta)

    def restore_fabric(self, fabric, step: int | None = None) -> dict:
        """Load a checkpoint into a live fabric.  Legacy checkpoints —
        written before the fault tier, without replication metadata or
        ``worker_clock``/``dead_workers`` arrays — restore to an
        all-alive fabric at the checkpointed step."""
        flat, meta = self.restore(step)
        snap = flat_to_fabric_snapshot(flat)
        fabric.restore(snap)
        return meta

    def restore(self, step: int | None = None) -> tuple[dict, dict]:
        """Returns (state dict of np arrays, manifest meta).  Partial /
        corrupted checkpoints (no manifest) are skipped by latest_step."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoint under {self.dir}")
        d = self.dir / f"step-{step:010d}"
        manifest = json.loads((d / "manifest.json").read_text())
        state = {
            k: np.load(d / info["file"])
            for k, info in manifest["arrays"].items()
        }
        return state, manifest["meta"]


def fabric_snapshot_to_flat(snap: dict) -> dict:
    """``PBoxFabric.snapshot()`` -> flat name->array dict for the
    checkpointer (numbered ``slot{i}`` arrays like TrainState)."""
    out = {
        "params": np.asarray(snap["params"]),
        "step": np.int64(snap["step"]),
    }
    for i, s in enumerate(snap["state"]):
        out[f"slot{i}"] = np.asarray(s)
    if "worker_clock" in snap:
        out["worker_clock"] = np.asarray(snap["worker_clock"], np.int64)
    dead = snap.get("dead_workers")
    if dead is not None:
        out["dead_workers"] = np.asarray(dead, np.int64)
    if "replication" in snap:
        out["replication"] = np.int64(snap["replication"])
    return out


def flat_to_fabric_snapshot(flat: dict) -> dict:
    """Inverse of ``fabric_snapshot_to_flat``, tolerant of legacy
    checkpoints: missing ``worker_clock``/``dead_workers``/``replication``
    just aren't in the returned snapshot (``PBoxFabric.restore`` defaults
    them to all-alive, clocks at the restored step)."""
    slots = []
    i = 0
    while f"slot{i}" in flat:
        slots.append(np.asarray(flat[f"slot{i}"]))
        i += 1
    snap = {
        "params": np.asarray(flat["params"]),
        "state": tuple(slots),
        "step": int(flat["step"]),
    }
    for key in ("worker_clock", "dead_workers", "replication"):
        if key in flat:
            snap[key] = flat[key]
    return snap


def train_state_to_flat(state) -> dict:
    """TrainState -> flat dict for the checkpointer."""
    out = {"pflat": state.pflat, "step": state.step}
    for i, s in enumerate(state.slots):
        out[f"slot{i}"] = s
    if state.ef is not None:
        out["ef"] = state.ef
    return out


def flat_to_train_state(flat: dict, cls, *,
                        device: torch.device | str | None = None):
    """Inverse of ``train_state_to_flat``: ``cls`` (the trainer's
    ``TrainState``) of tensors on ``device`` (the card unless the caller
    passes another)."""
    dev = resolve_device(device)
    slots = []
    i = 0
    while f"slot{i}" in flat:
        slots.append(_from_host(flat[f"slot{i}"], dev))
        i += 1
    return cls(
        pflat=_from_host(flat["pflat"], dev),
        slots=tuple(slots),
        ef=_from_host(flat["ef"], dev) if "ef" in flat else None,
        step=_from_host(flat["step"], dev).to(torch.int32),
    )
