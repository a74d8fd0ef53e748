"""dlrm-mlperf [arXiv:1906.00091]: 13 dense + 26 sparse (Criteo-TB vocabs,
40M cap), embed 128, bot 512-256-128, top 1024-1024-512-256-1, dot.
(Copy of ``repro/configs/dlrm_mlperf.py`` with torch dtypes.)"""
from repro_torch.configs.recsys_shapes import recsys_cells
from repro_torch.configs.registry import ArchDef
from repro_torch.models.recsys.models import DLRMConfig

CONFIG = DLRMConfig()

SMOKE = DLRMConfig(
    name="dlrm-smoke",
    vocabs=(1000, 400, 300, 200),
    embed_dim=16,
    bot_mlp=(32, 16),
    top_mlp=(32, 16, 1),
)

ARCH = ArchDef(
    arch_id="dlrm-mlperf",
    family="recsys",
    config=CONFIG,
    smoke_config=SMOKE,
    cells=recsys_cells(has_history=False),
    notes="~24B embedding rows capped at 40M/table (MLPerf convention); "
    "tables row-sharded over model axis = PBox micro-shards",
)
