"""The port's kernel tier: one package per kernel family, each a ``ref.py``
(plain-torch oracle) / ``kernel.py`` (the hand-written Hopper kernel's
wrapper beside its plain PyTorch version) / ``ops.py`` (validated public
entry point) triple, as in ``repro.kernels``.  CUDA sources live in
``repro_torch/csrc`` and are built at first use by ``kernels/_build.py``.

Ported: ``fused_agg_opt``, ``quant``, ``wire_path`` and
``embedding_bag``.  Beside them, two families that replace no TPU kernel,
for ResNet-50's worker step on the card: ``group_norm`` (the ReLU and
residual add after a GroupNorm, and the backward of all three) and
``layout`` (copies into channels-last memory).  This namespace re-exports
nothing.
"""
