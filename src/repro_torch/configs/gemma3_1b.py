"""gemma3-1b [hf:google/gemma-3-1b-pt]: 26L d=1152 4H (GQA kv=1) ff=6912
vocab=262144, 5:1 local:global sliding-window attention, 128k context.
(Copy of ``repro/configs/gemma3_1b.py`` with torch dtypes.)"""
import torch

from repro_torch.configs.lm_shapes import lm_cells
from repro_torch.configs.registry import ArchDef
from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    name="gemma3-1b",
    n_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab=262144,
    rope_theta=1e6,
    sliding_window=512,
    global_every=6,  # layers 6,12,18,24 (1-indexed multiples) are global
    embed_scale=True,
    dtype=torch.bfloat16,
    param_dtype=torch.bfloat16,
)

SMOKE = TransformerConfig(
    name="gemma3-1b-smoke",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=1,
    head_dim=16,
    d_ff=128,
    vocab=512,
    rope_theta=1e6,
    sliding_window=8,
    global_every=2,
    embed_scale=True,
    dtype=torch.float32,
    param_dtype=torch.float32,
    attn_chunk=8,
)

ARCH = ArchDef(
    arch_id="gemma3-1b",
    family="lm",
    config=CONFIG,
    smoke_config=SMOKE,
    cells=lm_cells(long_ok=True),  # 5:1 local:global => sub-quadratic-dominant
    microbatches={"train_4k": 1},
    notes="q-heads (4) < tp (16): duplicated head layout R=4; kv replicated",
)
