"""PBoxAX in PyTorch: the port of ``repro`` to PyTorch and CUDA on Hopper.

The layout mirrors ``src/repro/`` module for module; the JAX package stays
the reference every module here is tested against.  Nothing in this
package imports JAX or ``repro``.  Entry points run on the CUDA card unless
the caller passes ``device="cpu"``; kernels are built from
``repro_torch/csrc`` at first use (``kernels/_build.py``).
"""
