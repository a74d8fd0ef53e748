"""Single-pass wire -> kernel hot path: codec decode + K-stream aggregate +
server optimizer in one kernel (torch counterpart of
``repro.kernels.wire_path``).

``ref.py`` is the plain-torch oracle, ``kernel.py`` holds the CUDA kernel's
wrapper beside its plain PyTorch version, ``ops.py`` the validated public
entry points and the support matrix the fabric consults.
"""
from repro_torch.kernels.wire_path.ops import (
    fused_wire_update,
    unfused_wire_update,
    wire_path_supported,
)

__all__ = ["fused_wire_update", "unfused_wire_update", "wire_path_supported"]
