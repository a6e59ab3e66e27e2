"""MobileNetV2 in torch (counterpart of the JAX package's
``models/mobilenet_v2.py``), with the flax tree's module names.

Sandler et al. 2018: a 3×3 stride-2 stem, inverted residual bottlenecks
(1×1 expand → 3×3 depthwise → 1×1 linear project, residual where shapes
allow), ReLU6, a 1×1 head, global pool, dense logits. Every "SAME" stride-2
conv pads as the reference does: (0, 1) on even inputs, (1, 1) on odd ones.
"""

from __future__ import annotations

from torch import nn

from .common import ConvBN, DepthwiseConvBN, classifier_head, global_avg_pool, scale_ch

# (expansion t, output channels c, repeats n, first stride s) — Table 2.
_BLOCKS = [
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
]


class InvertedResidual(nn.Module):
    def __init__(self, cin: int, features: int, stride: int = 1, expansion: int = 6):
        super().__init__()
        hidden = cin * expansion
        self.expand = ConvBN(cin, hidden, (1, 1), act="relu6") if expansion != 1 else None
        self.dw = DepthwiseConvBN(hidden, stride=stride)
        self.project = ConvBN(hidden, features, (1, 1), act=None)  # linear bottleneck
        self.residual = stride == 1 and cin == features

    def forward(self, x):
        h = self.expand(x) if self.expand is not None else x
        h = self.project(self.dw(h))
        return h + x if self.residual else h


class MobileNetV2(nn.Module):
    """NCHW float images → logits [B, num_classes]."""

    def __init__(self, num_classes: int = 1000, width: float = 1.0):
        super().__init__()
        w = lambda c: scale_ch(c, width)  # noqa: E731
        self.stem = ConvBN(3, w(32), (3, 3), stride=2, act="relu6")
        c = w(32)
        self.block_names = []
        for i, (t, ch, n, s) in enumerate(_BLOCKS):
            for j in range(n):
                name = f"block{i}_{j}"
                setattr(self, name, InvertedResidual(c, w(ch), stride=s if j == 0 else 1,
                                                     expansion=t))
                self.block_names.append(name)
                c = w(ch)
        # The last conv does not shrink with width < 1 (per the paper).
        last = max(1280, scale_ch(1280, width)) if width > 1.0 else 1280
        self.head = ConvBN(c, last, (1, 1), act="relu6")
        self.logits = classifier_head(last, num_classes)

    def forward(self, x):
        x = self.stem(x)
        for name in self.block_names:
            x = getattr(self, name)(x)
        return self.logits(global_avg_pool(self.head(x)))
