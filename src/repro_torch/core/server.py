"""Back-compat shim: the monolithic ``PHubServer`` as a 1-shard fabric
(torch counterpart of ``repro/core/server.py``).

``PHubServer`` is exactly ``PBoxFabric`` with ``num_shards=1``; the
fabric's sync mode is bit-identical to a whole-space server.
"""
from __future__ import annotations

import torch

from repro_torch.core.chunking import ParamSpace
from repro_torch.core.config import FabricConfig
from repro_torch.core.fabric import (  # noqa: F401  (re-exported)
    LinkModel,
    PBoxFabric,
    PBoxShard,
    ServerStats,
    ShardStats,
    WorkerHarness,
)
from repro_torch.optim.optimizers import OptimizerSpec


class PHubServer(PBoxFabric):
    """Central PS over a chunked flat space, K-way fused aggregation.

    Deprecated spelling of ``PBoxFabric`` with ``num_shards=1``."""

    def __init__(
        self,
        space: ParamSpace,
        spec: OptimizerSpec,
        init_flat: torch.Tensor,
        *,
        mode: str = "sync",
        staleness: int = 0,
        num_workers: int = 1,
        min_push_fraction: float = 1.0,
        device: torch.device | str | None = None,
    ):
        super().__init__(
            space,
            spec,
            init_flat,
            config=FabricConfig(
                num_shards=1,
                mode=mode,
                staleness=staleness,
                num_workers=num_workers,
                min_push_fraction=min_push_fraction,
            ),
            device=device,
        )
