"""dien [arXiv:1809.03672]: embed 18, behavior seq 100, GRU+AUGRU 108,
MLP 200-80.  (Copy of ``repro/configs/dien.py`` with torch dtypes.)"""
from repro_torch.configs.recsys_shapes import recsys_cells
from repro_torch.configs.registry import ArchDef
from repro_torch.models.recsys.models import DIENConfig

CONFIG = DIENConfig()

SMOKE = DIENConfig(
    name="dien-smoke", n_items=500, n_cats=40, embed_dim=8, seq_len=12,
    gru_dim=16, mlp=(24, 8, 1),
)

ARCH = ArchDef(
    arch_id="dien",
    family="recsys",
    config=CONFIG,
    smoke_config=SMOKE,
    cells=recsys_cells(has_history=True),
    notes="AUGRU interest evolution via lax.scan over the behavior sequence",
)
