"""Plain-torch oracle for the weighted embedding-bag (torch counterpart of
``repro/kernels/embedding_bag/ref.py``).

``indices`` is (B, L) fixed-width with ``weights`` (B, L) carrying 0.0 at
padded slots (a padded multi-hot bag, the standard recsys layout).  The
oracle gathers every (B, L) row and reduces with one einsum, so its sum
order is torch's, not the kernel's slot-order FMA fold: it is held to the
kernel at a tolerance, as the JAX package holds its own pair.
"""
from __future__ import annotations

import torch


def embedding_bag_ref(
    table: torch.Tensor,  # (V, D)
    indices: torch.Tensor,  # (B, L) int in [0, V)
    weights: torch.Tensor,  # (B, L) f32, 0 at padding
    mode: str = "sum",  # "sum" | "mean"
) -> torch.Tensor:
    """Oracle embedding-bag: gather all (B, L) rows, einsum-reduce in f32."""
    rows = table[indices.long()].float()  # (B, L, D)
    out = torch.einsum("bl,bld->bd", weights.float(), rows)
    if mode == "mean":
        denom = torch.maximum(weights.float().sum(dim=1, keepdim=True),
                              torch.tensor(1e-9, dtype=torch.float32,
                                           device=out.device))
        out = out / denom
    return out
