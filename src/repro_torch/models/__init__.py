"""Models (torch counterpart of ``repro.models``): the transformer (dense
and MoE), the recsys models, ResNet-50 and EquiformerV2."""
