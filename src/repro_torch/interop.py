"""Parameters between the JAX package and the port, as numpy arrays.

``params_from_numpy`` turns a tree of numpy arrays (for instance
``jax.tree.map(np.asarray, params)`` of the JAX package's parameters) into
the port's ``dict[str, Tensor]``, so both packages compute on the same
weights; ``params_to_numpy`` is its inverse.  JAX hands bf16 out as
``ml_dtypes.bfloat16`` arrays, which torch cannot read: those are detected
by dtype name and passed through their 16-bit patterns (a numpy ``int16``
view, then ``torch.Tensor.view(torch.bfloat16)``), bit for bit, without
importing ``ml_dtypes``.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device


def _to_tensor(a: Any, device: torch.device) -> torch.Tensor:
    a = np.array(a, copy=True)  # writable and contiguous: torch shares it
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _to_numpy(t: torch.Tensor, bf16_dtype: Any) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(bf16_dtype)
    return t.numpy()


def params_from_numpy(tree: Any, device: torch.device | str | None = None) -> Any:
    """A nested dict of numpy arrays (any float type, bf16 included) as the
    same dict of tensors on ``device`` (the card unless given)."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, dev) for k, v in tree.items()}
    return _to_tensor(tree, dev)


def params_to_numpy(tree: Any, bf16_dtype: Any = np.int16) -> Any:
    """The inverse: tensors as numpy arrays.  bf16 tensors come out as
    their 16-bit patterns viewed as ``bf16_dtype``; pass the dtype of a JAX
    bf16 array (``ml_dtypes.bfloat16``) to get arrays JAX reads as bf16."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v, bf16_dtype) for k, v in tree.items()}
    return _to_numpy(tree, bf16_dtype)
