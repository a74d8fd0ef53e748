"""Parameter-space chunking: the PHub "fine grained key chunking" layer
(torch counterpart of ``repro/core/chunking.py``).

The model's parameters — a nested ``dict[str, Tensor]`` — map into one
padded 1-D tensor partitioned into fixed-size chunks, independent of tensor
boundaries.  The layout is the JAX package's exactly:

  * leaves are ordered as ``jax.tree.flatten`` orders them (dict keys sorted
    at every level), and slot names are ``jax.tree_util.keystr`` paths
    (``"['layers']['wq']"``), so every flat offset and chunk id is the same
    in both packages;
  * chunk size is a multiple of ``TILE_ELEMS`` (kept so the two layouts
    agree; the CUDA kernel itself needs no tiling);
  * the chunk count is padded to a multiple of ``num_owners`` so every
    owner holds an identical-size slab.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.device import resolve_device

TILE_ELEMS = 8 * 128
DEFAULT_CHUNK_ELEMS = 8192


@dataclasses.dataclass(frozen=True)
class TensorSlot:
    """Placement of one leaf tensor inside the flat parameter space."""

    name: str
    shape: tuple[int, ...]
    dtype: torch.dtype
    offset: int  # element offset in the flat space
    size: int  # number of elements


def _leaves_with_path(tree: Any, path: tuple = ()) -> list[tuple[tuple, Any]]:
    """(key path, leaf) pairs in ``jax.tree.flatten`` order: a dict's keys
    sorted, depth first."""
    if isinstance(tree, dict):
        out = []
        for key in sorted(tree):
            out += _leaves_with_path(tree[key], path + (key,))
        return out
    if not isinstance(tree, torch.Tensor):
        raise TypeError(
            f"parameter trees are nested dicts of tensors; got "
            f"{type(tree).__name__} at {_keystr(path)}")
    return [(path, tree)]


def _keystr(path: tuple) -> str:
    return "".join(f"[{key!r}]" for key in path)


def _unflatten_paths(paths: tuple, leaves: list) -> dict:
    tree: dict = {}
    for path, leaf in zip(paths, leaves):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree


@dataclasses.dataclass(frozen=True)
class ParamSpace:
    """Static layout of a parameter tree in a chunked flat address space.

    The flat space is padded to ``num_chunks * chunk_elems`` where
    ``num_chunks`` is also padded up to a multiple of ``num_owners``, so the
    chunk space reshapes exactly to ``(num_owners, chunks_per_owner,
    chunk_elems)``."""

    slots: tuple[TensorSlot, ...]
    treedef: tuple  # key path of every slot, in slot order
    chunk_elems: int
    num_owners: int
    payload_elems: int  # sum of leaf sizes (no padding)
    flat_elems: int  # padded total

    # ---- derived ----
    @property
    def num_chunks(self) -> int:
        return self.flat_elems // self.chunk_elems

    @property
    def chunks_per_owner(self) -> int:
        return self.num_chunks // self.num_owners

    @property
    def elems_per_owner(self) -> int:
        return self.flat_elems // self.num_owners

    @property
    def padding_elems(self) -> int:
        return self.flat_elems - self.payload_elems

    # ---- construction ----
    @staticmethod
    def build(
        tree: Any,
        *,
        chunk_elems: int = DEFAULT_CHUNK_ELEMS,
        num_owners: int = 1,
    ) -> "ParamSpace":
        if chunk_elems % TILE_ELEMS != 0:
            raise ValueError(
                f"chunk_elems must be a multiple of {TILE_ELEMS}, got {chunk_elems}"
            )
        if num_owners < 1:
            raise ValueError("num_owners must be >= 1")
        slots = []
        paths = []
        offset = 0
        for path, leaf in _leaves_with_path(tree):
            size = math.prod(leaf.shape)
            slots.append(
                TensorSlot(
                    name=_keystr(path),
                    shape=tuple(leaf.shape),
                    dtype=leaf.dtype,
                    offset=offset,
                    size=size,
                )
            )
            paths.append(path)
            offset += size
        payload = offset
        # pad to a whole number of chunks, then to a multiple of num_owners
        num_chunks = -(-max(payload, 1) // chunk_elems)
        num_chunks = -(-num_chunks // num_owners) * num_owners
        return ParamSpace(
            slots=tuple(slots),
            treedef=tuple(paths),
            chunk_elems=chunk_elems,
            num_owners=num_owners,
            payload_elems=payload,
            flat_elems=num_chunks * chunk_elems,
        )

    # ---- flatten / unflatten ----
    def flatten(self, tree: Any, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """Pack a tree into the padded flat space, on the leaves' device.

        Every leaf is cast to ``dtype`` (the PS wire/accumulation dtype);
        original dtypes come back on unflatten.  Leaves are copied straight
        into one preallocated buffer, so the cast copies never coexist."""
        leaves = [leaf for _, leaf in _leaves_with_path(tree)]
        if len(leaves) != len(self.slots):
            raise ValueError("tree does not match ParamSpace layout")
        flat = torch.empty(self.flat_elems, dtype=dtype,
                           device=leaves[0].device)
        for slot, leaf in zip(self.slots, leaves):
            flat[slot.offset:slot.offset + slot.size].copy_(leaf.reshape(-1))
        flat[self.payload_elems:].zero_()
        return flat

    def unflatten(self, flat: torch.Tensor) -> dict:
        """The tree back from its flat space.  A leaf whose dtype is the
        flat dtype is a view into ``flat``; others are fresh casts."""
        if tuple(flat.shape) != (self.flat_elems,):
            raise ValueError(
                f"flat has shape {tuple(flat.shape)}, expected {(self.flat_elems,)}"
            )
        leaves = [
            flat[slot.offset:slot.offset + slot.size]
            .reshape(slot.shape).to(slot.dtype)
            for slot in self.slots
        ]
        return _unflatten_paths(self.treedef, leaves)

    # ---- introspection ----
    def describe(self) -> str:
        return (
            f"ParamSpace: {len(self.slots)} tensors, payload={self.payload_elems} "
            f"elems, flat={self.flat_elems} elems, chunks={self.num_chunks}x"
            f"{self.chunk_elems}, owners={self.num_owners} "
            f"({self.chunks_per_owner} chunks each), padding="
            f"{self.padding_elems} ({100.0 * self.padding_elems / self.flat_elems:.2f}%)"
        )


def zeros_like_space(space: ParamSpace, dtype: torch.dtype = torch.float32,
                     *, device: torch.device | str | None = None
                     ) -> torch.Tensor:
    """A zero flat slab of the space's padded length, on ``device`` (the
    card unless the caller passes another)."""
    return torch.zeros((space.flat_elems,), dtype=dtype,
                       device=resolve_device(device))


def tensor_chunk_map(space: ParamSpace) -> list[tuple[str, int, int]]:
    """For observability: (tensor name, first chunk, last chunk) per tensor."""
    out = []
    for slot in space.slots:
        first = slot.offset // space.chunk_elems
        last = (slot.offset + max(slot.size, 1) - 1) // space.chunk_elems
        out.append((slot.name, first, last))
    return out
