"""Model zoo (counterpart of the JAX package's ``models/__init__.py``).

``get(name)`` returns a :class:`ModelSpec`; ``spec.build(num_classes=...,
width=...)`` an ``nn.Module``. The whole zoo is ported: Inception-v3,
MobileNetV2 and ResNet-50 classify, SSD-MobileNet detects.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable

from .inception_v3 import InceptionV3
from .mobilenet_v2 import MobileNetV2
from .resnet50 import ResNet50
from .ssd_mobilenet import SSDMobileNet


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    name: str
    build: Callable  # (num_classes=..., width=...) -> nn.Module
    input_size: int
    preprocess: str
    task: str = "classify"
    num_classes: int = 1000
    # Stem conv padding: it decides when the serving preprocess may hand the
    # model pack_s2d cells (input_format="s2d"). The even-extent cell
    # convention is exact for a VALID stem at any size, and for a SAME stem
    # only at even sizes (an odd extent would shift the implicit padding).
    stem_padding: str = "SAME"

    def s2d_ok(self, h: int, w: int) -> bool:
        return self.stem_padding == "VALID" or (h % 2 == 0 and w % 2 == 0)


_ZOO: dict[str, ModelSpec] = {
    s.name: s
    for s in [
        ModelSpec("inception_v3", InceptionV3, 299, "inception", stem_padding="VALID"),
        ModelSpec("mobilenet_v2", MobileNetV2, 224, "inception"),
        ModelSpec("resnet50", ResNet50, 224, "caffe"),
        ModelSpec("ssd_mobilenet", SSDMobileNet, 300, "inception", task="detect",
                  num_classes=90),
    ]
}


def get(name: str) -> ModelSpec:
    if name not in _ZOO:
        raise KeyError(f"unknown zoo model '{name}' — have {sorted(_ZOO)}")
    return _ZOO[name]


def names() -> list[str]:
    return sorted(_ZOO)
