"""granite-moe-1b-a400m [hf:ibm-granite/granite-3.0-1b-a400m-base]:
24L d=1024 16H (GQA kv=8) ff=512/expert, 32 experts top-8, vocab 49155.
(Copy of ``repro/configs/granite_moe_1b.py`` with torch dtypes.)"""
import torch

from repro_torch.configs.lm_shapes import lm_cells
from repro_torch.configs.registry import ArchDef
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    name="granite-moe-1b-a400m",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    head_dim=64,
    d_ff=0,
    vocab=49155,
    rope_theta=1e4,
    moe=MoEConfig(n_experts=32, top_k=8, d_ff_expert=512),
    dtype=torch.bfloat16,
    param_dtype=torch.bfloat16,
)

SMOKE = TransformerConfig(
    name="granite-smoke",
    n_layers=2,
    d_model=64,
    n_heads=8,
    n_kv_heads=4,
    head_dim=8,
    d_ff=0,
    vocab=512,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32, capacity_factor=2.0),
    dtype=torch.float32,
    param_dtype=torch.float32,
    attn_chunk=8,
)

ARCH = ArchDef(
    arch_id="granite-moe-1b-a400m",
    family="lm",
    config=CONFIG,
    smoke_config=SMOKE,
    cells=lm_cells(long_ok=False),
    notes="MoE 32e top-8; experts tensor-parallel over d_ff (32/16 per shard)",
)
