"""ResNet-50 in torch (counterpart of the JAX package's
``models/resnet50.py``), with the flax tree's module names.

He et al. 2015, the v1.5 variant (stride 2 on the 3×3 of a bottleneck):
a 7×7 stride-2 stem, a 3×3 stride-2 max pool, bottleneck stages [3, 4, 6,
3], global pool, dense logits. Every BN has ε = 1e-5, the ResNet
convention (the rest of the zoo uses 1e-3). A block has a 1×1 projection
shortcut (``downsample``) when its channels change or its stride is not 1,
so stage 0's first block has one at stride 1 (64 → 256).

"SAME" pads are lax's: the stem pads (2, 3) at 224 and (3, 3) at 225, the
max pool and every stride-2 3×3 pad (0, 1) on an even input, and the 1×1
stride-2 shortcut pads nothing. The max pool pads with −inf
(``common.max_pool_same``).
"""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from .common import ConvBN, classifier_head, global_avg_pool, max_pool_same, scale_ch

# (inner width, blocks, first stride) per stage; a block's output is 4× its width
_STAGES = [(64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2)]
_BN_EPS = 1e-5


class Bottleneck(nn.Module):
    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        out_ch = features * 4
        self.downsample = (ConvBN(cin, out_ch, (1, 1), stride=stride, act=None, bn_eps=_BN_EPS)
                           if cin != out_ch or stride != 1 else None)
        self.conv1 = ConvBN(cin, features, (1, 1), bn_eps=_BN_EPS)
        self.conv2 = ConvBN(features, features, (3, 3), stride=stride, bn_eps=_BN_EPS)
        self.conv3 = ConvBN(features, out_ch, (1, 1), act=None, bn_eps=_BN_EPS)

    def forward(self, x):
        shortcut = self.downsample(x) if self.downsample is not None else x
        return F.relu(self.conv3(self.conv2(self.conv1(x))) + shortcut)


class ResNet50(nn.Module):
    """NCHW float images → logits [B, num_classes]."""

    def __init__(self, num_classes: int = 1000, width: float = 1.0):
        super().__init__()
        w = lambda c: scale_ch(c, width)  # noqa: E731
        self.stem = ConvBN(3, w(64), (7, 7), stride=2, bn_eps=_BN_EPS)
        c = w(64)
        self.block_names = []
        for i, (ch, n, s) in enumerate(_STAGES):
            for j in range(n):
                name = f"stage{i}_{j}"
                setattr(self, name, Bottleneck(c, w(ch), stride=s if j == 0 else 1))
                self.block_names.append(name)
                c = w(ch) * 4
        self.logits = classifier_head(c, num_classes)

    def forward(self, x):
        x = max_pool_same(self.stem(x))
        for name in self.block_names:
            x = getattr(self, name)(x)
        return self.logits(global_avg_pool(x))
