"""resnet50: the paper's own ImageNet workload, not part of the assigned
40-cell matrix (copy of ``repro/configs/resnet50.py`` with torch dtypes)."""
from repro_torch.configs.registry import ArchDef, ShapeCell
from repro_torch.models.resnet import ResNetConfig

CONFIG = ResNetConfig()

SMOKE = ResNetConfig(
    name="resnet-smoke", blocks=(1, 1, 1, 1), widths=(32, 64, 128, 256),
    n_classes=10, groups=8,
)

ARCH = ArchDef(
    arch_id="resnet50",
    family="vision",
    config=CONFIG,
    smoke_config=SMOKE,
    cells=(
        ShapeCell("imagenet_train", "train",
                  {"global_batch": 256, "img": 224}),
    ),
    notes="pure data-parallel over all mesh axes; the paper's Figure 3 "
    "workload class",
)
