"""Inception-v3 in torch (counterpart of the JAX package's
``models/inception_v3.py``), with the flax tree's module names.

299×299 input, stem of plain convs, three 35×35 Inception-A blocks, grid
reduction, four 17×17 Inception-B blocks with 1×7/7×1 factorized convs,
grid reduction, two 8×8 Inception-C blocks, global pool, dense logits.
Every conv is ConvBN. NCHW; concatenations are on the channel axis.

Pooling follows flax: the 3×3 stride-1 SAME average pools divide by 9 at
the borders too (``count_include_pad=True``); max pools and the stride-2
convs are VALID.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .common import ConvBN, classifier_head, global_avg_pool, scale_ch


def _avg_pool_same(x):
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=True)


def _max_pool_valid(x):
    return F.max_pool2d(x, 3, stride=2)


class InceptionA(nn.Module):
    """35×35 block: 1×1 / 5×5 / double-3×3 / pool-proj branches."""

    def __init__(self, cin: int, width: float = 1.0, pool_features: int = 32):
        super().__init__()
        w = lambda c: scale_ch(c, width)
        self.b1x1 = ConvBN(cin, w(64), (1, 1))
        self.b5x5_1 = ConvBN(cin, w(48), (1, 1))
        self.b5x5_2 = ConvBN(w(48), w(64), (5, 5))
        self.b3x3dbl_1 = ConvBN(cin, w(64), (1, 1))
        self.b3x3dbl_2 = ConvBN(w(64), w(96), (3, 3))
        self.b3x3dbl_3 = ConvBN(w(96), w(96), (3, 3))
        self.bpool = ConvBN(cin, w(pool_features), (1, 1))
        self.out_channels = w(64) + w(64) + w(96) + w(pool_features)

    def forward(self, x):
        b1 = self.b1x1(x)
        b5 = self.b5x5_2(self.b5x5_1(x))
        b3 = self.b3x3dbl_3(self.b3x3dbl_2(self.b3x3dbl_1(x)))
        bp = self.bpool(_avg_pool_same(x))
        return torch.cat([b1, b5, b3, bp], dim=1)


class ReductionA(nn.Module):
    """35×35 → 17×17 grid reduction (stride-2 convs + maxpool)."""

    def __init__(self, cin: int, width: float = 1.0):
        super().__init__()
        w = lambda c: scale_ch(c, width)
        self.b3x3 = ConvBN(cin, w(384), (3, 3), stride=2, padding="VALID")
        self.b3x3dbl_1 = ConvBN(cin, w(64), (1, 1))
        self.b3x3dbl_2 = ConvBN(w(64), w(96), (3, 3))
        self.b3x3dbl_3 = ConvBN(w(96), w(96), (3, 3), stride=2, padding="VALID")
        self.out_channels = w(384) + w(96) + cin

    def forward(self, x):
        b3 = self.b3x3(x)
        bd = self.b3x3dbl_3(self.b3x3dbl_2(self.b3x3dbl_1(x)))
        return torch.cat([b3, bd, _max_pool_valid(x)], dim=1)


class InceptionB(nn.Module):
    """17×17 block with 1×7/7×1 factorized convolutions."""

    def __init__(self, cin: int, width: float = 1.0, c7: int = 128):
        super().__init__()
        w = lambda c: scale_ch(c, width)
        c7 = w(c7)
        self.b1x1 = ConvBN(cin, w(192), (1, 1))
        self.b7x7_1 = ConvBN(cin, c7, (1, 1))
        self.b7x7_2 = ConvBN(c7, c7, (1, 7))
        self.b7x7_3 = ConvBN(c7, w(192), (7, 1))
        self.b7x7dbl_1 = ConvBN(cin, c7, (1, 1))
        self.b7x7dbl_2 = ConvBN(c7, c7, (7, 1))
        self.b7x7dbl_3 = ConvBN(c7, c7, (1, 7))
        self.b7x7dbl_4 = ConvBN(c7, c7, (7, 1))
        self.b7x7dbl_5 = ConvBN(c7, w(192), (1, 7))
        self.bpool = ConvBN(cin, w(192), (1, 1))
        self.out_channels = 4 * w(192)

    def forward(self, x):
        b1 = self.b1x1(x)
        b7 = self.b7x7_3(self.b7x7_2(self.b7x7_1(x)))
        bd = self.b7x7dbl_1(x)
        for m in (self.b7x7dbl_2, self.b7x7dbl_3, self.b7x7dbl_4, self.b7x7dbl_5):
            bd = m(bd)
        bp = self.bpool(_avg_pool_same(x))
        return torch.cat([b1, b7, bd, bp], dim=1)


class ReductionB(nn.Module):
    """17×17 → 8×8 grid reduction."""

    def __init__(self, cin: int, width: float = 1.0):
        super().__init__()
        w = lambda c: scale_ch(c, width)
        self.b3x3_1 = ConvBN(cin, w(192), (1, 1))
        self.b3x3_2 = ConvBN(w(192), w(320), (3, 3), stride=2, padding="VALID")
        self.b7x7x3_1 = ConvBN(cin, w(192), (1, 1))
        self.b7x7x3_2 = ConvBN(w(192), w(192), (1, 7))
        self.b7x7x3_3 = ConvBN(w(192), w(192), (7, 1))
        self.b7x7x3_4 = ConvBN(w(192), w(192), (3, 3), stride=2, padding="VALID")
        self.out_channels = w(320) + w(192) + cin

    def forward(self, x):
        b3 = self.b3x3_2(self.b3x3_1(x))
        b7 = self.b7x7x3_1(x)
        for m in (self.b7x7x3_2, self.b7x7x3_3, self.b7x7x3_4):
            b7 = m(b7)
        return torch.cat([b3, b7, _max_pool_valid(x)], dim=1)


class InceptionC(nn.Module):
    """8×8 block with parallel 1×3 / 3×1 expanded branches."""

    def __init__(self, cin: int, width: float = 1.0):
        super().__init__()
        w = lambda c: scale_ch(c, width)
        self.b1x1 = ConvBN(cin, w(320), (1, 1))
        self.b3x3_1 = ConvBN(cin, w(384), (1, 1))
        self.b3x3_2a = ConvBN(w(384), w(384), (1, 3))
        self.b3x3_2b = ConvBN(w(384), w(384), (3, 1))
        self.b3x3dbl_1 = ConvBN(cin, w(448), (1, 1))
        self.b3x3dbl_2 = ConvBN(w(448), w(384), (3, 3))
        self.b3x3dbl_3a = ConvBN(w(384), w(384), (1, 3))
        self.b3x3dbl_3b = ConvBN(w(384), w(384), (3, 1))
        self.bpool = ConvBN(cin, w(192), (1, 1))
        self.out_channels = w(320) + 4 * w(384) + w(192)

    def forward(self, x):
        b1 = self.b1x1(x)
        b3 = self.b3x3_1(x)
        bd = self.b3x3dbl_2(self.b3x3dbl_1(x))
        bp = self.bpool(_avg_pool_same(x))
        return torch.cat([b1, self.b3x3_2a(b3), self.b3x3_2b(b3),
                          self.b3x3dbl_3a(bd), self.b3x3dbl_3b(bd), bp], dim=1)


class InceptionV3(nn.Module):
    """NCHW float images → logits [B, num_classes]."""

    def __init__(self, num_classes: int = 1000, width: float = 1.0):
        super().__init__()
        w = lambda c: scale_ch(c, width)
        # Stem: 299 → 35 spatial.
        self.stem1 = ConvBN(3, w(32), (3, 3), stride=2, padding="VALID")
        self.stem2 = ConvBN(w(32), w(32), (3, 3), padding="VALID")
        self.stem3 = ConvBN(w(32), w(64), (3, 3))
        self.stem4 = ConvBN(w(64), w(80), (1, 1), padding="VALID")
        self.stem5 = ConvBN(w(80), w(192), (3, 3), padding="VALID")
        blocks = [
            ("mixed5b", lambda c: InceptionA(c, width, pool_features=32)),
            ("mixed5c", lambda c: InceptionA(c, width, pool_features=64)),
            ("mixed5d", lambda c: InceptionA(c, width, pool_features=64)),
            ("mixed6a", lambda c: ReductionA(c, width)),
            ("mixed6b", lambda c: InceptionB(c, width, c7=128)),
            ("mixed6c", lambda c: InceptionB(c, width, c7=160)),
            ("mixed6d", lambda c: InceptionB(c, width, c7=160)),
            ("mixed6e", lambda c: InceptionB(c, width, c7=192)),
            ("mixed7a", lambda c: ReductionB(c, width)),
            ("mixed7b", lambda c: InceptionC(c, width)),
            ("mixed7c", lambda c: InceptionC(c, width)),
        ]
        c = w(192)
        self.block_names = [name for name, _ in blocks]
        for name, make in blocks:
            block = make(c)
            setattr(self, name, block)
            c = block.out_channels
        self.logits = classifier_head(c, num_classes)

    def forward(self, x):
        x = self.stem3(self.stem2(self.stem1(x)))
        x = _max_pool_valid(x)
        x = self.stem5(self.stem4(x))
        x = _max_pool_valid(x)
        for name in self.block_names:
            x = getattr(self, name)(x)
        return self.logits(global_avg_pool(x))
