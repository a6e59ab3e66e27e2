"""SSD-MobileNet detector in torch (counterpart of the JAX package's
``models/ssd_mobilenet.py``), with the flax tree's module names.

Liu et al. 2016: an SSD head on a MobileNetV2 feature pyramid. A 3×3
stride-2 stem, inverted residual blocks to stride 32 (``feat1``) and 64
(``feat2``), and on each of the two feature maps a box-regression and a
class-score conv (3×3, bias, no BN). The outputs are concatenated over the
anchor axis: the multi-output contract ``raw_boxes``, ``raw_scores`` (and
``anchors``, from :meth:`SSDMobileNet.anchors_for`); box decode and NMS
live in ``ops/detection.py``.

"SAME" pads are lax's: at stride 2, (0, 1) on an even input and (1, 1) on
an odd one. At 300 px the chain is 300 → 150 → 75 → 38 → 19 → 10 → 5, so
block1 and feat1 meet odd inputs (75 and 19).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .common import ConvBN, scale_ch, takes_cells
from .mobilenet_v2 import InvertedResidual

ASPECT_RATIOS = (1.0, 2.0, 0.5)
# (output channels, stride) of block0..block3; feat1 and feat2 follow
_BLOCKS = [(24, 2), (32, 2), (64, 2), (64, 1)]
_FEATS = [(128, 2), (256, 2)]
# anchor scale per feature map (feat1, feat2)
_SCALES = (0.2, 0.5)


def grid_anchors(feature_shapes, scales, aspect_ratios=ASPECT_RATIOS) -> np.ndarray:
    """Normalized (cy, cx, h, w) grid anchors per feature map, float32 [A, 4]
    (host-side constants, computed once at model build)."""
    boxes = []
    for (fh, fw), scale in zip(feature_shapes, scales):
        cy, cx = np.meshgrid(
            (np.arange(fh) + 0.5) / fh, (np.arange(fw) + 0.5) / fw, indexing="ij"
        )
        for ar in aspect_ratios:
            h = scale / np.sqrt(ar)
            w = scale * np.sqrt(ar)
            boxes.append(
                np.stack(
                    [cy.ravel(), cx.ravel(), np.full(fh * fw, h), np.full(fh * fw, w)],
                    axis=-1,
                )
            )
    return np.concatenate(boxes).astype(np.float32)


class SSDMobileNet(nn.Module):
    """NCHW float images (``input_format="s2d"``: their ``pack_s2d`` cells)
    → (raw_boxes [B, A, 4], raw_scores [B, A, C+1]).

    The head outputs are reshaped from NHWC order (position, then anchor,
    then coordinate or class), as the flax ``reshape`` of an NHWC conv
    output is."""

    def __init__(self, num_classes: int = 90, width: float = 1.0, input_format: str = "nhwc"):
        super().__init__()
        w = lambda c: scale_ch(c, width)  # noqa: E731
        self.num_classes = num_classes
        self.n_anchor = len(ASPECT_RATIOS)
        self.stem = ConvBN(3, w(16), (3, 3), stride=2, act="relu6",
                           s2d_input=takes_cells(input_format))
        c = w(16)
        for i, (ch, s) in enumerate(_BLOCKS):
            setattr(self, f"block{i}", InvertedResidual(c, w(ch), stride=s))
            c = w(ch)
        for i, (ch, s) in enumerate(_FEATS, start=1):
            setattr(self, f"feat{i}", InvertedResidual(c, w(ch), stride=s))
            c = w(ch)
        for i, feat in ((1, w(_FEATS[0][0])), (2, w(_FEATS[1][0]))):
            setattr(self, f"head{i}_loc", nn.Conv2d(feat, self.n_anchor * 4, 3, padding=1))
            setattr(self, f"head{i}_cls",
                    nn.Conv2d(feat, self.n_anchor * (num_classes + 1), 3, padding=1))

    def _heads(self, feat, i: int):
        loc = getattr(self, f"head{i}_loc")(feat)
        cls = getattr(self, f"head{i}_cls")(feat)
        b = loc.permute(0, 2, 3, 1).reshape(loc.shape[0], -1, 4)
        c = cls.permute(0, 2, 3, 1).reshape(cls.shape[0], -1, self.num_classes + 1)
        return b, c

    def forward(self, x):
        x = self.stem(x)
        for i in range(len(_BLOCKS)):
            x = getattr(self, f"block{i}")(x)
        f1 = self.feat1(x)  # stride 32
        f2 = self.feat2(f1)  # stride 64
        b1, c1 = self._heads(f1, 1)
        b2, c2 = self._heads(f2, 2)
        return torch.cat([b1, b2], dim=1), torch.cat([c1, c2], dim=1)

    @staticmethod
    def anchors_for(input_size: int) -> np.ndarray:
        """Anchors matching the two feature maps at ``input_size``: five
        SAME stride-2 stages reach ``feat1`` (stem, block0–2, feat1), six
        reach ``feat2``, each a ceil-div by 2."""
        f1 = input_size
        for _ in range(5):
            f1 = -(-f1 // 2)
        f2 = -(-f1 // 2)
        return grid_anchors([(f1, f1), (f2, f2)], scales=list(_SCALES))

