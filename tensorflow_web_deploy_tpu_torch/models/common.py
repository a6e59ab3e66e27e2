"""Shared building blocks of the model zoo (counterpart of the JAX
package's ``models/common.py``), as ``torch.nn`` modules in NCHW.

Module and parameter names follow the flax tree — ``<block>/conv/kernel``,
``<block>/bn/{scale,bias,mean,var}`` — so ``models/adapter.py`` maps the
JAX package's flat params onto these modules by name alone.

The JAX package routes stride-2 stems through an exact space-to-depth
rewrite for the TPU's matrix unit; that is an identity of the math, so
here the stem is a plain stride-2 convolution.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def scale_ch(c: int, width: float, divisor: int = 8) -> int:
    """Round ``c * width`` to a multiple of ``divisor`` (never below it) —
    the MobileNet width-multiplier rule the whole zoo uses."""
    v = max(divisor, int(c * width + divisor / 2) // divisor * divisor)
    if v < 0.9 * c * width:  # standard "round down less than 10%" guard
        v += divisor
    return v


class BatchNorm(nn.Module):
    """Inference BatchNorm with the flax variable names: parameters
    ``scale``/``bias``, buffers ``mean``/``var``."""

    def __init__(self, features: int, eps: float = 1e-3):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def affine(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(s, t) with bn(x) = x·s + t per channel."""
        s = self.scale / torch.sqrt(self.var + self.eps)
        return s, self.bias - self.mean * s

    def forward(self, x):
        s, t = self.affine()
        return x * s[:, None, None] + t[:, None, None]


class ConvBN(nn.Module):
    """Conv (no bias) → BatchNorm (ε=1e-3) → ReLU.

    ``padding`` is "SAME" (stride 1, odd kernels: (kh//2, kw//2), so a
    1×7 pads (0, 3)) or "VALID". :meth:`fold` folds the BN affine into the
    conv for serving: conv(x, k·s) + t, exact up to float rounding.
    """

    def __init__(self, cin: int, cout: int, kernel=(3, 3), stride: int = 1,
                 padding: str = "SAME"):
        super().__init__()
        kh, kw = kernel
        if padding == "SAME":
            if stride != 1:
                raise ValueError("SAME padding is only used with stride 1 here")
            pad = (kh // 2, kw // 2)
        elif padding == "VALID":
            pad = (0, 0)
        else:
            raise ValueError(f"padding must be SAME or VALID, got {padding!r}")
        self.conv = nn.Conv2d(cin, cout, (kh, kw), stride=stride, padding=pad, bias=False)
        self.bn = BatchNorm(cout)
        self.folded = False

    @torch.no_grad()
    def fold(self) -> None:
        s, t = self.bn.affine()
        self.conv.weight.mul_(s[:, None, None, None])
        self.conv.bias = nn.Parameter(t.clone())
        self.bn = nn.Identity()
        self.folded = True

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def fold_bn(module: nn.Module) -> nn.Module:
    """Fold every ConvBN's BatchNorm into its conv (serving form)."""
    for m in module.modules():
        if isinstance(m, ConvBN) and not m.folded:
            m.fold()
    return module


def global_avg_pool(x):
    """NCHW → NC mean over the spatial dims (classifier head input)."""
    return x.mean(dim=(2, 3))


def classifier_head(cin: int, num_classes: int) -> nn.Linear:
    """The Dense logits layer over global-pooled features."""
    return nn.Linear(cin, num_classes)
