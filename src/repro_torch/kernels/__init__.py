"""The port's kernel tier: one package per kernel family, each a ``ref.py``
(plain-torch oracle) / ``kernel.py`` (the hand-written Hopper kernel's
wrapper beside its plain PyTorch version) / ``ops.py`` (validated public
entry point) triple, as in ``repro.kernels``.  CUDA sources live in
``repro_torch/csrc`` and are built at first use by ``kernels/_build.py``.

Ported: ``fused_agg_opt``, ``quant``, ``wire_path`` and
``embedding_bag``.  This namespace re-exports nothing.
"""
