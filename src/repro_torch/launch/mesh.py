"""Named device meshes over ``torch.distributed`` (torch counterpart of
``repro/launch/mesh.py``).

A JAX mesh names the axes of a device array, and ``shard_map`` code reduces
or gathers over axis names.  Here every rank is one process on one device,
and ``Mesh`` lays the ranks of the default process group row-major over the
named axes, as ``compat.make_mesh`` orders devices: rank ``r`` sits at the
row-major coordinates of ``r`` in ``shape``.  For every nonempty tuple of
axes (in mesh order) the constructor builds one process group per coset,
so the collectives below can run over any axis tuple.  ``dist.new_group``
is collective: every rank builds the groups in the same order, in the
constructor, before any collective runs.  ``torch.distributed`` orders a
group's members by global rank, which for axes in mesh order is their
row-major index over those axes: member ``i`` of a group is the rank whose
linear index over the group's axes is ``i``, as in a tiled JAX
``psum_scatter`` / ``all_gather``.

The collectives (``psum``, ``psum_scatter``, ``all_gather``, ``pmean``) are
per-rank functions on tensors, the counterparts of ``lax.psum`` & co. inside
``shard_map``; over the empty axis tuple they are the identity, as JAX's
are.  A division by the axis size is a product with its f32 reciprocal:
XLA compiles JAX's ``x / n`` under ``jit`` to that product.

``RecordingMesh`` is one rank of a layout without a process group, whose
collectives return shaped tensors and record their bytes: the dry run's
mesh (``launch/dryrun.py``).

The backend follows the device: NCCL for the card, gloo for the CPU
(``init_process_group``).  NCCL takes one rank per card, so one card runs
the mesh at world 1 over NCCL, or at a larger world over gloo.  A
``model`` axis above one is tensor parallelism: the model's collectives
(``models/common.Dist``) run over its groups, and the trainer keeps one
flat space per model group.
"""
from __future__ import annotations

import itertools
import math
import os
import shutil
import tempfile

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.launch import cost_analysis


def init_process_group(device: torch.device | str | None = None, *,
                       init_method: str, rank: int = 0,
                       world_size: int = 1) -> None:
    """Start the default process group with the backend ``device`` needs:
    NCCL for the card, gloo for the CPU.  A failed init raises; nothing
    falls back to another backend."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:  # "cuda": the current card
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=init_method,
                            rank=rank, world_size=world_size,
                            **({"device_id": dev} if dev.type == "cuda"
                               else {}))


def start_group(world: int, device=None):
    """Start a driver's process group: join ``torchrun``'s world, or start
    a world of one rank (rendezvous in a fresh directory).  Returns the
    device and the group's cleanup, or None for the cleanup when the
    caller already started the group."""
    if dist.is_initialized():
        return resolve_device(device), None
    env = env_rank()
    tmp = None
    if env is not None:
        rank, size, local = env
        if device is None:
            torch.cuda.set_device(local)
        init_process_group(device, init_method="env://", rank=rank,
                           world_size=size)
    elif world == 1:
        tmp = tempfile.mkdtemp(prefix="repro_torch_")
        try:
            init_process_group(device, init_method=f"file://{tmp}/rendezvous")
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
    else:
        raise SystemExit(f"--mesh of {world} ranks: run under torchrun "
                         f"--nproc-per-node {world}")

    def cleanup():
        dist.destroy_process_group()
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)

    return resolve_device(device), cleanup


def _axes(axes) -> tuple:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


class _Layout:
    """Named axes laid row-major over ``prod(shape)`` ranks, and rank
    ``rank``'s place in them: the part of a mesh that needs no process
    group."""

    def __init__(self, shape, axes, rank: int):
        shape, axes = tuple(int(s) for s in shape), tuple(axes)
        if len(shape) != len(axes) or len(set(axes)) != len(axes):
            raise ValueError(f"mesh shape {shape} does not match axes {axes}")
        self.axis_names = axes
        self.shape = dict(zip(axes, shape))
        self.size = math.prod(shape)
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} is not in a mesh of {self.size}")
        self.rank = rank
        self.coords = dict(zip(axes, (int(c) for c in torch.unravel_index(
            torch.tensor(rank), shape))))

    # -- axes -----------------------------------------------------------
    def _canon(self, axes) -> tuple:
        axes = _axes(axes)
        for a in axes:
            if a not in self.shape:
                raise ValueError(f"{a!r} is not an axis of {self.axis_names}")
        order = [self.axis_names.index(a) for a in axes]
        if order != sorted(set(order)):
            raise ValueError(
                f"axes {axes} must be distinct and in mesh order "
                f"{self.axis_names}")
        return axes

    def axis_size(self, axes) -> int:
        return math.prod(self.shape[a] for a in self._canon(axes))

    def axis_index(self, axes) -> int:
        """This rank's row-major index over ``axes`` (``lax.axis_index``)."""
        i = 0
        for a in self._canon(axes):
            i = i * self.shape[a] + self.coords[a]
        return i

    def pmean(self, x: torch.Tensor, axes) -> torch.Tensor:
        return self.psum(x, axes) * (1.0 / self.axis_size(axes))


class Mesh(_Layout):
    """Named axes laid row-major over the ranks of the default process
    group (see the module docstring).  ``shape`` is a dict, as on a JAX
    mesh; ``rank`` and ``coords`` are this process's place in it."""

    def __init__(self, shape, axes):
        if not dist.is_initialized():
            raise RuntimeError(
                "Mesh needs an initialized default process group "
                "(launch.mesh.init_process_group)")
        super().__init__(shape, axes, dist.get_rank())
        shape, axes = tuple(self.shape.values()), self.axis_names
        world = dist.get_world_size()
        if world != self.size:
            raise ValueError(
                f"mesh {shape} needs {self.size} ranks, the process group "
                f"has {world}")
        idx = torch.arange(self.size).reshape(shape)
        self._groups: dict[tuple, dist.ProcessGroup] = {}
        n = len(axes)
        for r in range(1, n + 1):
            for dims in itertools.combinations(range(n), r):
                rest = [d for d in range(n) if d not in dims]
                # one group per coset: the other axes' coordinates fixed
                blocks = idx.permute(*rest, *dims).reshape(-1, math.prod(
                    shape[d] for d in dims))
                for ranks in blocks.tolist():
                    group = dist.new_group(ranks)
                    if self.rank in ranks:
                        self._groups[tuple(axes[d] for d in dims)] = group

    def group(self, axes) -> dist.ProcessGroup:
        return self._groups[self._canon(axes)]

    # -- collectives (identity over no axes) ----------------------------
    def psum(self, x: torch.Tensor, axes) -> torch.Tensor:
        """Sum over the ranks of ``axes`` into a new tensor."""
        axes = self._canon(axes)
        if not axes:
            return x
        out = x.clone()
        dist.all_reduce(out, group=self.group(axes))
        return out

    def pmax(self, x: torch.Tensor, axes) -> torch.Tensor:
        """Max over the ranks of ``axes`` into a new tensor."""
        axes = self._canon(axes)
        if not axes:
            return x
        out = x.clone()
        dist.all_reduce(out, dist.ReduceOp.MAX, group=self.group(axes))
        return out

    def psum_scatter(self, x: torch.Tensor, axes) -> torch.Tensor:
        """Tiled reduce-scatter along dim 0: member ``i`` of the group gets
        block ``i`` of the sum."""
        axes = self._canon(axes)
        if not axes:
            return x
        n = self.axis_size(axes)
        if x.shape[0] % n:
            raise ValueError(
                f"dim 0 of {tuple(x.shape)} does not split over {n} ranks")
        out = torch.empty((x.shape[0] // n, *x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        dist.reduce_scatter_tensor(out, x.contiguous(), group=self.group(axes))
        return out

    def all_gather(self, x: torch.Tensor, axes, axis: int = 0,
                   tiled: bool = True) -> torch.Tensor:
        """Member ``i``'s tensor at block ``i`` along ``axis`` (``tiled``),
        or stacked on a new ``axis``."""
        axes = self._canon(axes)
        if not axes:
            return x if tiled else x.unsqueeze(axis)
        n = self.axis_size(axes)
        out = torch.empty(n * x.numel(), dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, x.contiguous().reshape(-1),
                                    group=self.group(axes))
        out = out.reshape(n, *x.shape)
        if not tiled:
            return out.movedim(0, axis)
        if axis == 0:
            return out.reshape(n * x.shape[0], *x.shape[1:])
        return torch.cat(out.unbind(0), dim=axis)


def wire_factor(kind: str, g: int) -> float:
    """Wire bytes a rank moves per byte of a collective's output, by a ring
    over a group of ``g`` ranks (floored at 2), as
    ``repro/launch/dryrun.py`` models them: an all-reduce 2 (g-1)/g, an
    all-gather (g-1)/g of the gathered output, a reduce-scatter g - 1 of
    the scattered one."""
    g = max(g, 2)
    return {"all-reduce": 2.0 * (g - 1) / g, "all-gather": (g - 1) / g,
            "reduce-scatter": float(g - 1)}[kind]


class RecordingMesh(_Layout):
    """Rank ``rank`` of a mesh layout, with no process group: the dry
    run's mesh (``launch/dryrun.py``), for layouts of more ranks than a
    host has.  ``axis_size`` and ``axis_index`` are the rank's; the
    collectives return tensors of the right shapes, dtypes and devices
    whose values mean nothing (meta tensors on meta inputs), and record,
    per kind (``all-reduce``, ``reduce-scatter``, ``all-gather``), the
    calls, the output bytes (``raw``) and the wire bytes (``wire_factor``
    over the group's size), and charge their operands and outputs to an
    active ``cost_analysis.CostMode``.  Over no axes they are the
    identity, as ``Mesh``'s are; a one-rank group is recorded like any
    other (the port issues it)."""

    def __init__(self, shape, axes, rank: int = 0):
        super().__init__(shape, axes, rank)
        self.collectives: dict[str, dict] = {}

    def _record(self, kind: str, x, out, axes):
        size = out.numel() * out.element_size()
        rec = self.collectives.setdefault(kind, {"calls": 0, "raw": 0.0,
                                                 "wire": 0.0})
        rec["calls"] += 1
        rec["raw"] += size
        rec["wire"] += size * wire_factor(kind, self.axis_size(axes))
        cost_analysis.charge([x], [out])
        return out

    def psum(self, x: torch.Tensor, axes) -> torch.Tensor:
        axes = self._canon(axes)
        if not axes:
            return x
        return self._record("all-reduce", x, torch.empty_like(x), axes)

    def pmax(self, x: torch.Tensor, axes) -> torch.Tensor:
        return self.psum(x, axes)

    def psum_scatter(self, x: torch.Tensor, axes) -> torch.Tensor:
        axes = self._canon(axes)
        if not axes:
            return x
        n = self.axis_size(axes)
        if x.shape[0] % n:
            raise ValueError(
                f"dim 0 of {tuple(x.shape)} does not split over {n} ranks")
        return self._record("reduce-scatter", x, x.new_empty(
            (x.shape[0] // n, *x.shape[1:])), axes)

    def all_gather(self, x: torch.Tensor, axes, axis: int = 0,
                   tiled: bool = True) -> torch.Tensor:
        axes = self._canon(axes)
        if not axes:
            return x if tiled else x.unsqueeze(axis)
        n = self.axis_size(axes)
        shape = list(x.shape)
        if tiled:
            shape[axis] *= n
        else:
            shape.insert(axis % (x.dim() + 1), n)
        return self._record("all-gather", x, x.new_empty(shape), axes)

    def collective_bytes(self) -> dict:
        """The recorded bytes under ``repro/launch/dryrun.py``'s keys:
        ``raw_<kind>`` and ``wire_<kind>`` per kind, ``total`` (raw) and
        ``wire_total``."""
        out = {f"raw_{k}": v["raw"] for k, v in self.collectives.items()}
        out.update({f"wire_{k}": v["wire"]
                    for k, v in self.collectives.items()})
        out["total"] = sum(v["raw"] for v in self.collectives.values())
        out["wire_total"] = sum(v["wire"] for v in self.collectives.values())
        return out


def make_production_mesh(*, multi_pod: bool = False) -> tuple:
    """The production layout as ``(shape, axes)``: 16 x 16 = 256 ranks
    ("data", "model"), or 2 pods x 256 ("pod", "data", "model").  Only the
    layout: a 256-rank process group is the caller's."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return shape, axes


def make_mesh(shape: tuple, axes: tuple) -> Mesh:
    """A mesh for the trainer over the default process group."""
    return Mesh(shape, axes)


def worker_axes(mesh) -> tuple:
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def pod_axis(mesh) -> str | None:
    return "pod" if "pod" in mesh.axis_names else None


def num_workers(mesh) -> int:
    n = 1
    for a in worker_axes(mesh):
        n *= mesh.shape[a]
    return n


def env_rank() -> tuple[int, int, int] | None:
    """``(rank, world_size, local_rank)`` as ``torchrun`` sets them, or
    ``None`` outside ``torchrun``."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return None
    return (int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]),
            int(os.environ.get("LOCAL_RANK", 0)))
