"""Model zoo (counterpart of the JAX package's ``models/__init__.py``).

``get(name)`` returns a :class:`ModelSpec`; ``spec.build(num_classes=...,
width=...)`` an ``nn.Module``. Inception-v3, MobileNetV2 and ResNet-50 are
ported; SSD-MobileNet is listed so that configs resolve, and building it
raises ``NotImplementedError`` naming the ROADMAP item that ports it.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable

from .inception_v3 import InceptionV3
from .mobilenet_v2 import MobileNetV2
from .resnet50 import ResNet50


def _not_ported(name: str, item: str) -> Callable:
    def build(**_):
        raise NotImplementedError(f"{name} is not ported yet: ROADMAP.md Queue 1, {item}")

    return build


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    name: str
    build: Callable  # (num_classes=..., width=...) -> nn.Module
    input_size: int
    preprocess: str
    task: str = "classify"
    num_classes: int = 1000


_ZOO: dict[str, ModelSpec] = {
    s.name: s
    for s in [
        ModelSpec("inception_v3", InceptionV3, 299, "inception"),
        ModelSpec("mobilenet_v2", MobileNetV2, 224, "inception"),
        ModelSpec("resnet50", ResNet50, 224, "caffe"),
        ModelSpec("ssd_mobilenet", _not_ported("ssd_mobilenet", "the SSD + detection item"),
                  300, "inception", task="detect", num_classes=90),
    ]
}


def get(name: str) -> ModelSpec:
    if name not in _ZOO:
        raise KeyError(f"unknown zoo model '{name}' — have {sorted(_ZOO)}")
    return _ZOO[name]


def names() -> list[str]:
    return sorted(_ZOO)
