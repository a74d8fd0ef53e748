"""Chunked int8 quantization: the wire codec kernels.

Torch counterpart of ``repro.kernels.quant``.  A flat f32 slab becomes an
int8 payload plus one f32 scale per ``chunk_elems`` chunk (symmetric,
``scale = amax/127``); wire cost is ``N + 4·C`` bytes.  ``ref.py`` is the
plain-torch oracle, ``kernel.py`` holds the CUDA kernels' wrappers beside
their plain PyTorch versions, ``ops.py`` the validated public entry points
that ``core/compression.py`` calls.
"""
from repro_torch.kernels.quant.ops import dequantize_chunks, quantize_chunks

__all__ = ["quantize_chunks", "dequantize_chunks"]
