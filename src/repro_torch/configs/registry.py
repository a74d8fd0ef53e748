"""Architecture registry (torch counterpart of ``repro/configs/registry.py``).

Each arch module exposes ``ARCH: ArchDef``.  The port registers the archs
it has ported so far: ``gemma3-1b`` and the four recsys archs
(``dlrm-mlperf``, ``autoint``, ``dien``, ``xdeepfm``).
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
    from repro_torch.configs import autoint, dien, dlrm_mlperf, gemma3_1b, xdeepfm

    return {m.ARCH.arch_id: m.ARCH
            for m in (gemma3_1b, dlrm_mlperf, autoint, dien, xdeepfm)}


def get_arch(arch_id: str) -> ArchDef:
    archs = _build()
    if arch_id not in archs:
        raise KeyError(
            f"{arch_id!r} is not ported yet; the port has {sorted(archs)}")
    return archs[arch_id]

