"""GroupNorm of NCHW f32 activations with the residual add and the ReLU
after it, forward and backward as one op.

No counterpart in ``repro.kernels``: the JAX package leaves GroupNorm to
XLA.  ResNet-50's worker step ran the norm, the add, the ReLU and their
backward as separate passes over its activations.  ``ref.py`` is the
plain-torch oracle, ``kernel.py`` holds the CUDA kernels' wrappers beside
their plain PyTorch version, ``ops.py`` the validated, differentiable
entry point that ``models/resnet.py`` calls.
"""
from repro_torch.kernels.group_norm.ops import group_norm_act

__all__ = ["group_norm_act"]
