"""qwen2-moe-a2.7b [hf:Qwen/Qwen1.5-MoE-A2.7B]: 24L d=2048 16H (kv=16)
ff=1408/expert, 60 routed experts top-4 + shared expert (4x width),
vocab 151936.
(Copy of ``repro/configs/qwen2_moe_a2_7b.py`` with torch dtypes.)"""
import torch

from repro_torch.configs.lm_shapes import lm_cells
from repro_torch.configs.registry import ArchDef
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    name="qwen2-moe-a2.7b",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=0,
    vocab=151936,
    rope_theta=1e6,
    moe=MoEConfig(n_experts=60, top_k=4, d_ff_expert=1408, shared_d_ff=5632),
    dtype=torch.bfloat16,
    param_dtype=torch.bfloat16,
)

SMOKE = TransformerConfig(
    name="qwen2moe-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=0,
    vocab=512,
    moe=MoEConfig(n_experts=6, top_k=2, d_ff_expert=32, shared_d_ff=64,
                  capacity_factor=2.0),
    dtype=torch.float32,
    param_dtype=torch.float32,
    attn_chunk=8,
)

ARCH = ArchDef(
    arch_id="qwen2-moe-a2.7b",
    family="lm",
    config=CONFIG,
    smoke_config=SMOKE,
    cells=lm_cells(long_ok=False),
    notes="60 experts (not divisible by 16) — d_ff TP sidesteps the "
    "divisibility constraint; shared expert 4x width",
)
