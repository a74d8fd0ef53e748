"""qwen2-72b [arXiv:2407.10671]: 80L d=8192 64H (GQA kv=8) ff=29568
vocab=152064, QKV bias.
(Copy of ``repro/configs/qwen2_72b.py`` with torch dtypes.)"""
import torch

from repro_torch.configs.lm_shapes import lm_cells
from repro_torch.configs.registry import ArchDef
from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    name="qwen2-72b",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab=152064,
    qkv_bias=True,
    rope_theta=1e6,
    dtype=torch.bfloat16,
    param_dtype=torch.bfloat16,
)

SMOKE = TransformerConfig(
    name="qwen2-smoke",
    n_layers=2,
    d_model=64,
    n_heads=8,
    n_kv_heads=4,
    head_dim=8,
    d_ff=192,
    vocab=512,
    qkv_bias=True,
    dtype=torch.float32,
    param_dtype=torch.float32,
    attn_chunk=8,
)

ARCH = ArchDef(
    arch_id="qwen2-72b",
    family="lm",
    config=CONFIG,
    smoke_config=SMOKE,
    cells=lm_cells(long_ok=False),
    microbatches={"train_4k": 8},  # activation footprint (see EXPERIMENTS §Perf)
    notes="largest assigned model: 72.7B params; TP=16 + 32-way PS-chunked "
    "optimizer sharding",
)
