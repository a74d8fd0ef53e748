"""Fused embedding-bag lookup (gather + weighted reduce).

Torch counterpart of ``repro.kernels.embedding_bag``.  Bag ``b`` is
``sum_l weights[b, l] * table[indices[b, l]]`` (``mode="mean"`` divides by
the weight sum).  ``ref.py`` is the plain-torch oracle, ``kernel.py`` holds
the CUDA kernel's wrappers beside their plain PyTorch versions, ``ops.py``
the validated entry points: ``embedding_bag``, which the sparse tier's
lookups call, and ``segment_sum``, the in-order duplicate fold of its
pushes (the same kernel with every weight one).
"""
from repro_torch.kernels.embedding_bag.ops import embedding_bag, segment_sum

__all__ = ["embedding_bag", "segment_sum"]
