"""Shared building blocks of the model zoo (counterpart of the JAX
package's ``models/common.py``), as ``torch.nn`` modules in NCHW.

Module and parameter names follow the flax tree — ``<block>/conv/kernel``,
``<block>/dwconv/kernel``, ``<block>/bn/{scale,bias,mean,var}`` — so
``models/adapter.py`` maps the JAX package's flat params onto these
modules by name alone.

The JAX package routes stride-2 stems through an exact space-to-depth
rewrite for the TPU's matrix unit; that is an identity of the math, so
here the stem is a plain stride-2 convolution. "SAME" padding is
``lax.padtype_to_pads``'s (``ops/depthwise.py::same_pads``): at stride 2
it is computed from each input's size and applied with ``F.pad``, because
its odd pad goes at the end.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.depthwise import (
    depthwise_conv2d,
    fused_depthwise,
    fused_depthwise_bn,
    kernel_taps,
    pad_nchw,
    resolve_pads,
)
from ..ops.quant import Int8Conv2d, dequantize_taps

ACTIVATIONS = {"relu": F.relu, "relu6": F.relu6, None: lambda x: x}


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


class ConvBNCell(nn.Module):
    """Conv (no bias, held as ``self.<conv_attr>``) → BatchNorm → activation,
    with the serving-time BN fold.

    "SAME" pads are static where they do not depend on the input size
    (stride 1, odd kernels: (k//2, k//2)) and computed per input otherwise.
    """

    conv_attr = "conv"

    def _init_cell(self, kernel, stride: int, padding: str, act: str | None) -> tuple[int, int]:
        if padding not in ("SAME", "VALID"):
            raise ValueError(f"padding must be SAME or VALID, got {padding!r}")
        if act not in ACTIVATIONS:
            raise ValueError(f"act must be one of {sorted(map(str, ACTIVATIONS))}, got {act!r}")
        kh, kw = kernel
        self.kernel, self.stride, self.padding, self.act = (kh, kw), stride, padding, act
        # pads that depend on the input size are applied in forward
        self.dynamic_pad = padding == "SAME" and not (stride == 1 and kh % 2 and kw % 2)
        if padding == "SAME" and not self.dynamic_pad:
            return kh // 2, kw // 2
        return 0, 0

    def _pad(self, x):
        if not self.dynamic_pad:
            return x
        return pad_nchw(x, resolve_pads("SAME", x.shape[2:], self.kernel, (self.stride,) * 2))

    @torch.no_grad()
    def fold(self, quant: tuple[torch.Tensor, torch.Tensor] | None = None) -> None:
        """Fold the BN affine (s, t) into the conv: conv(x, k·s) + t, exact
        up to float rounding. With ``quant`` = (q, scale), the int8 tier's
        quantized kernel k ≈ q·scale, the conv keeps ``q`` and folds s into
        its dequant scale instead: per-output-channel symmetric
        quantization commutes with a per-channel scale."""
        s, t = self.bn.affine()
        conv = getattr(self, self.conv_attr)
        if quant is None:
            conv.weight.mul_(s[:, None, None, None])
            conv.bias = nn.Parameter(t.clone())
        else:
            q, scale = quant
            setattr(self, self.conv_attr, Int8Conv2d(conv, q, scale * s, t.clone()))
        self.bn = nn.Identity()
        self.folded = True


class ConvBN(ConvBNCell):
    """Conv (no bias) → BatchNorm (ε ``bn_eps``, the reference's 1e-3 by
    default; ResNet-50 passes 1e-5) → activation ("relu", "relu6" or None).
    ``padding`` is "SAME" (the reference's pads) or "VALID"."""

    def __init__(self, cin: int, cout: int, kernel=(3, 3), stride: int = 1,
                 padding: str = "SAME", act: str | None = "relu", bn_eps: float = 1e-3):
        super().__init__()
        pad = self._init_cell(kernel, stride, padding, act)
        self.conv = nn.Conv2d(cin, cout, tuple(kernel), stride=stride, padding=pad, bias=False)
        self.bn = BatchNorm(cout, eps=bn_eps)
        self.folded = False

    def forward(self, x):
        return ACTIVATIONS[self.act](self.bn(self.conv(self._pad(x))))


class DepthwiseConvBN(ConvBNCell):
    """Depthwise conv → BN → activation (the MobileNet cell); the kernel is
    ``dwconv/kernel``, [C, 1, kh, kw] in torch.

    Unfused, the conv is the grouped ``F.conv2d`` (cuDNN on the card), then
    BN (folded into the conv for serving) and the activation. ``fused=True``
    with relu6 or no activation serves the cell through
    ``ops/depthwise.py::fused_depthwise`` — BN folded into the taps and
    bias, one op, on the fused depthwise kernel at stride 1 and 2 alike;
    the parameters are the same either way. The fold keeps
    the fused form's float32 operands once: ``taps`` [kh·kw, C] (an int8
    cell instead dequantizes into that layout on every call) and
    ``tap_bias`` [1, C].
    """

    conv_attr = "dwconv"

    def __init__(self, channels: int, kernel=(3, 3), stride: int = 1, padding: str = "SAME",
                 act: str | None = "relu6", fused: bool = False):
        super().__init__()
        self._init_cell(kernel, stride, padding, act)
        self.dwconv = nn.Conv2d(channels, channels, tuple(kernel), stride=stride,
                                groups=channels, bias=False)
        self.bn = BatchNorm(channels)
        self.folded = False
        self.fused = fused
        self.register_buffer("taps", None)
        self.register_buffer("tap_bias", None)

    @torch.no_grad()
    def fold(self, quant: tuple[torch.Tensor, torch.Tensor] | None = None) -> None:
        super().fold(quant)
        if quant is None:
            self.taps = kernel_taps(self.dwconv.weight)
        self.tap_bias = self.dwconv.bias.float().reshape(1, -1).clone()

    def _apply(self, fn, recurse=True):
        # A cast of the module rounds the fused operands to its dtype, as it
        # does the conv's weight and bias, and keeps them float32: the fused
        # op takes float32 taps and bias.
        super()._apply(fn, recurse)
        for name in ("taps", "tap_bias"):
            t = getattr(self, name)
            if t is not None:
                setattr(self, name, t.float())
        return self

    def forward(self, x):
        strides = (self.stride, self.stride)
        if self.fused and self.act in ("relu6", None):
            relu6 = self.act == "relu6"
            if not self.folded:
                s, t = self.bn.affine()
                return fused_depthwise_bn(x, self.dwconv.weight, s, t, strides, self.padding, relu6)
            taps = self.taps if self.taps is not None else dequantize_taps(self.dwconv.q,
                                                                           self.dwconv.scale)
            return fused_depthwise(x, taps, self.tap_bias, self.kernel, strides, self.padding,
                                   relu6)
        y = depthwise_conv2d(x, self.dwconv.weight, strides, self.padding, bias=self.dwconv.bias)
        return ACTIVATIONS[self.act](self.bn(y))


def fold_bn(module: nn.Module) -> nn.Module:
    """Fold every conv cell's BatchNorm into its conv (serving form)."""
    for m in module.modules():
        if isinstance(m, ConvBNCell) and not m.folded:
            m.fold()
    return module


def set_fused_dw(module: nn.Module, fused: bool) -> nn.Module:
    """Serve every depthwise cell fused or unfused; a no-op for a model
    without depthwise cells."""
    for m in module.modules():
        if isinstance(m, DepthwiseConvBN):
            m.fused = fused
    return module


def max_pool_same(x, kernel: int = 3, stride: int = 2):
    """flax's ``max_pool(padding="SAME")`` on NCHW: lax's pads (at stride 2
    on an even input, (0, 1)) filled with −inf, then a VALID max pool.
    ``F.max_pool2d(padding=1)`` would pad (1, 1) and shift every window of
    an even input by one row and one column. −inf is exact in every float
    dtype, so a padded tap never wins."""
    (pt, pb), (pl, pr) = resolve_pads("SAME", x.shape[2:], (kernel, kernel), (stride, stride))
    if pt or pb or pl or pr:
        x = F.pad(x, (pl, pr, pt, pb), value=float("-inf"))
    return F.max_pool2d(x, kernel, stride)


def global_avg_pool(x):
    """NCHW → NC mean over the spatial dims (classifier head input)."""
    return x.mean(dim=(2, 3))


def classifier_head(cin: int, num_classes: int) -> nn.Linear:
    """The Dense logits layer over global-pooled features."""
    return nn.Linear(cin, num_classes)
