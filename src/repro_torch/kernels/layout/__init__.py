"""A copy into channels-last memory.

No counterpart in ``repro.kernels``: XLA picks layouts itself.  ResNet-50's
weight gradients run on channels-last copies of their operands
(``models/resnet.py``), and PyTorch's copy makes those permutes slowly.
``ref.py`` is the plain-torch oracle, ``kernel.py`` the CUDA kernel's
wrapper beside its plain version, ``ops.py`` the validated entry point.
"""
from repro_torch.kernels.layout.ops import to_channels_last

__all__ = ["to_channels_last"]
