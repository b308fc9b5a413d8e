"""The paper's own student/teacher model pairs (Table III).

| Type    | Name          | Parameters | GFLOPs |
|---------|---------------|------------|--------|
| Student | ResNet18      | 11.7M      | 1.82   |
| Student | ResNet34      | 21.8M      | 3.67   |
| Student | ViT-B/32      | 88.2M      | 4.37   |
| Teacher | WideResNet50  | 68.9M      | 11.43  |
| Teacher | ViT-B/16      | 86.6M      | 16.87  |
| Teacher | WideResNet101 | 126.9M     | 22.80  |
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    name: str
    kind: str  # resnet | vit
    depth: int = 18  # resnet depth (18/34/50/101)
    width_mult: int = 1  # 2 for wide resnets
    patch: int = 16  # vit patch size
    d_model: int = 768
    num_heads: int = 12
    d_ff: int = 3072
    num_layers: int = 12
    img_size: int = 224
    num_classes: int = 1000
    base: int = 64  # resnet stem width

    def reduced(self, img_size: int = 24, num_classes: int = 8) -> "VisionConfig":
        """Small same-family twin for the CPU-side CL loop; teacher/student
        capacity gap preserved (wide resnets keep width_mult=2, ViT-B/16
        keeps its 4x patch count)."""
        if self.kind == "vit":
            return dataclasses.replace(
                self, name=self.name + "-reduced", img_size=img_size,
                num_classes=num_classes, d_model=64, num_heads=4, d_ff=128,
                num_layers=2, patch=max(4, self.patch // 4))
        return dataclasses.replace(
            self, name=self.name + "-reduced", img_size=img_size,
            num_classes=num_classes, depth=min(self.depth, 18),
            width_mult=self.width_mult, base=24)


RESNET18 = VisionConfig("resnet18", "resnet", depth=18)
RESNET34 = VisionConfig("resnet34", "resnet", depth=34)
WIDERESNET50 = VisionConfig("wideresnet50", "resnet", depth=50, width_mult=2)
WIDERESNET101 = VisionConfig("wideresnet101", "resnet", depth=101, width_mult=2)
VIT_B32 = VisionConfig("vit-b32", "vit", patch=32)
VIT_B16 = VisionConfig("vit-b16", "vit", patch=16)

VISION_MODELS = {
    m.name: m
    for m in (RESNET18, RESNET34, WIDERESNET50, WIDERESNET101, VIT_B32, VIT_B16)
}

# (student, teacher) pairs exactly as evaluated in the paper (§VII-A).
PAIRS: Tuple[Tuple[VisionConfig, VisionConfig], ...] = (
    (RESNET18, WIDERESNET50),
    (VIT_B32, VIT_B16),
    (RESNET34, WIDERESNET101),
)

# Table III reference numbers for validation benches.
TABLE_III = {
    "resnet18": (11.7e6, 1.82),
    "resnet34": (21.8e6, 3.67),
    "vit-b32": (88.2e6, 4.37),
    "wideresnet50": (68.9e6, 11.43),
    "vit-b16": (86.6e6, 16.87),
    "wideresnet101": (126.9e6, 22.80),
}
