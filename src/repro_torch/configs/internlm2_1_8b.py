"""internlm2-1.8b [arXiv:2403.17297]: 24L d=2048 16H (GQA kv=8) ff=8192
vocab=92544.
(Copy of ``repro/configs/internlm2_1_8b.py`` with torch dtypes.)"""
import torch

from repro_torch.configs.lm_shapes import lm_cells
from repro_torch.configs.registry import ArchDef
from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    name="internlm2-1.8b",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab=92544,
    rope_theta=1e6,
    dtype=torch.bfloat16,
    param_dtype=torch.bfloat16,
)

SMOKE = TransformerConfig(
    name="internlm2-smoke",
    n_layers=2,
    d_model=64,
    n_heads=8,
    n_kv_heads=4,
    head_dim=8,
    d_ff=128,
    vocab=512,
    dtype=torch.float32,
    param_dtype=torch.float32,
    attn_chunk=8,
)

ARCH = ArchDef(
    arch_id="internlm2-1.8b",
    family="lm",
    config=CONFIG,
    smoke_config=SMOKE,
    cells=lm_cells(long_ok=False),
    notes="kv (8) < tp (16): kv weights replicated, grads psum_model",
)
