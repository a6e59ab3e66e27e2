"""Model zoo (counterpart of the JAX package's ``models/__init__.py``).

``get(name)`` returns a :class:`ModelSpec`; ``spec.build(num_classes=...,
width=...)`` an ``nn.Module``. Only Inception-v3 is ported so far; the
other names are listed so that configs resolve, and building one raises
``NotImplementedError`` naming the ROADMAP item that ports it.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable

from .inception_v3 import InceptionV3


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
        ModelSpec("mobilenet_v2", _not_ported("mobilenet_v2", "the MobileNetV2 slice"),
                  224, "inception"),
        ModelSpec("resnet50", _not_ported("resnet50", "the ResNet-50 item"), 224, "caffe"),
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
