"""xdeepfm [arXiv:1803.05170]: 39 fields, embed 10, CIN 200-200-200,
MLP 400-400.  (Copy of ``repro/configs/xdeepfm.py`` with torch dtypes.)"""
from repro_torch.configs.recsys_shapes import recsys_cells
from repro_torch.configs.registry import ArchDef
from repro_torch.models.recsys.models import XDeepFMConfig

CONFIG = XDeepFMConfig()

SMOKE = XDeepFMConfig(
    name="xdeepfm-smoke", n_sparse=6, vocab_per_field=200, embed_dim=8,
    cin_layers=(16, 16), mlp=(32, 1),
)

ARCH = ArchDef(
    arch_id="xdeepfm",
    family="recsys",
    config=CONFIG,
    smoke_config=SMOKE,
    cells=recsys_cells(has_history=False),
)
