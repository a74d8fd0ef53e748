"""autoint [arXiv:1810.11921]: 39 fields, embed 16, 3 self-attn layers,
2 heads, d_attn 32.  (Copy of ``repro/configs/autoint.py`` with torch
dtypes.)"""
from repro_torch.configs.recsys_shapes import recsys_cells
from repro_torch.configs.registry import ArchDef
from repro_torch.models.recsys.models import AutoIntConfig

CONFIG = AutoIntConfig()

SMOKE = AutoIntConfig(
    name="autoint-smoke", n_sparse=6, vocab_per_field=200, embed_dim=8, d_attn=16
)

ARCH = ArchDef(
    arch_id="autoint",
    family="recsys",
    config=CONFIG,
    smoke_config=SMOKE,
    cells=recsys_cells(has_history=False),
)
