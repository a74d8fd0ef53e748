"""Architecture registry (torch counterpart of ``repro/configs/registry.py``).

Each arch module exposes ``ARCH: ArchDef``.  The port registers every
arch of the JAX package, in its order: the five LMs, the GNN
(``equiformer-v2``), the four recsys archs and the paper's ResNet-50.
"""
from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str  # train | prefill | decode | decode_long | ...
    params: dict
    skip_reason: str | None = None


@dataclasses.dataclass(frozen=True)
class ArchDef:
    arch_id: str
    family: str  # lm | gnn | recsys | vision
    config: Any
    smoke_config: Any
    cells: tuple
    microbatches: dict | None = None  # per-shape grad-accum override
    notes: str = ""

    def cell(self, name: str) -> ShapeCell:
        for c in self.cells:
            if c.name == name:
                return c
        raise KeyError(f"{self.arch_id} has no shape {name}")


def _build() -> dict:
    from repro_torch.configs import (
        autoint,
        dien,
        dlrm_mlperf,
        equiformer_v2,
        gemma3_1b,
        granite_moe_1b,
        internlm2_1_8b,
        qwen2_72b,
        qwen2_moe_a2_7b,
        resnet50,
        xdeepfm,
    )

    mods = [
        gemma3_1b, internlm2_1_8b, qwen2_72b, granite_moe_1b, qwen2_moe_a2_7b,
        equiformer_v2, dlrm_mlperf, autoint, dien, xdeepfm, resnet50,
    ]
    return {m.ARCH.arch_id: m.ARCH for m in mods}


ARCHS: dict | None = None


def _archs() -> dict:
    global ARCHS
    if ARCHS is None:
        ARCHS = _build()
    return ARCHS


def get_arch(arch_id: str) -> ArchDef:
    archs = _archs()
    if arch_id not in archs:
        raise KeyError(
            f"unknown arch {arch_id!r}; the registry has {sorted(archs)}")
    return archs[arch_id]


def list_archs() -> list:
    return list(_archs())


def list_cells(assigned_only: bool = True) -> list:
    """All (arch, shape) cells of the assigned matrix (excludes resnet50)."""
    out = []
    for a in list_archs():
        if assigned_only and a == "resnet50":
            continue
        for c in get_arch(a).cells:
            out.append((a, c.name))
    return out
