"""Fused K-way gradient aggregation + server optimizer (the PHub hot loop).

Torch counterpart of ``repro.kernels.fused_agg_opt``: ``ref.py`` is the
plain-torch oracle, ``kernel.py`` holds the CUDA kernel's wrapper and its
plain PyTorch version, ``ops.py`` the validated public entry point that
every ``PBoxShard`` calls.
"""
from repro_torch.kernels.fused_agg_opt.ops import fused_aggregate_update

__all__ = ["fused_aggregate_update"]
