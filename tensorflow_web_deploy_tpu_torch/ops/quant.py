"""Weight-only int8 quantization for the int8 serving tier (the port's own
copy of the JAX package's ``ops/quant.py``, plus torch layers that keep
their weights int8 on the device).

Kernels are stored as int8 with a per-output-channel symmetric scale
(``scale = amax / 127`` over the input axes) and dequantized on every call
as ``w = q.to(compute) * scale.to(compute)``, the reference's
``dequantize_tree`` rule; the engine computes in bf16.

In the flat JAX-layout tree each quantized leaf ``k`` gains a sibling
``k + QSCALE_SUFFIX``. Eligible: float32 leaves named
``kernel``/``weights``/``depthwise_weights`` with ndim 2 or 4 — conv,
depthwise and dense weights. BN affines, biases and statistics stay float.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

QSCALE_SUFFIX = "!qscale"

#: leaf names (last "/" component) eligible for int8 weight quantization
_KERNEL_LEAVES = ("kernel", "weights", "depthwise_weights")


def quantizable(key: str, value) -> bool:
    """True when ``value`` is a float32 conv/dense kernel worth quantizing."""
    if key.endswith(QSCALE_SUFFIX):
        return False
    leaf = key.rsplit("/", 1)[-1]
    return (
        leaf in _KERNEL_LEAVES
        and getattr(value, "dtype", None) == np.float32
        and getattr(value, "ndim", 0) in (2, 4)
    )


def quantize_leaf(value: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-output-channel symmetric int8: returns ``(q, scale)``.

    The output channel is the LAST axis in the JAX layout (HWIO convs,
    [kh, kw, 1, C] depthwise, [cin, cout] dense); amax runs over all other
    axes. Zero channels get scale 1.0 so dequant stays exact.
    """
    v = np.asarray(value, np.float32)
    axes = tuple(range(v.ndim - 1))
    amax = np.max(np.abs(v), axis=axes)
    scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.rint(v / scale), -127, 127).astype(np.int8)
    return q, scale


def quantize_params(params: dict, compute_dtype=np.float32) -> dict:
    """int8-quantize eligible kernels; cast the remaining float32 leaves to
    ``compute_dtype``. Returns a NEW flat dict of numpy arrays; the input
    tree is never mutated (it stays the float32 golden reference)."""
    out = {}
    for k, v in params.items():
        v = np.asarray(v)
        if quantizable(k, v):
            q, scale = quantize_leaf(v)
            out[k] = q
            out[k + QSCALE_SUFFIX] = scale
        elif v.dtype == np.float32:
            out[k] = v.astype(compute_dtype)
        else:
            out[k] = v
    return out


def topk_agreement(ref_probs: np.ndarray, q_probs: np.ndarray, k: int, tol: float) -> float:
    """Margin-aware top-k agreement between a quantized and a reference
    classifier head: a quantized top-k pick agrees when the REFERENCE gives
    it at least its own k-th best score − ``tol`` (near-ties may swap).
    Returns the agreeing fraction over batch·k picks."""
    ref = np.asarray(ref_probs, np.float32)
    q = np.asarray(q_probs, np.float32)
    k = min(k, ref.shape[-1])
    agree = 0
    for r_row, q_row in zip(ref, q):
        q_top = np.argsort(-q_row)[:k]
        kth_ref = np.sort(r_row)[-k]
        agree += int(np.sum(r_row[q_top] >= kth_ref - tol))
    return agree / float(ref.shape[0] * k)


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``q.to(d) * scale`` with d the scale's dtype (the compute dtype once
    the layer is cast); ``scale`` is per output channel, dim 0 of a torch
    weight. One op: int8 × d promotes to d, and every int8 value is exact
    in bf16, so the product rounds once, as the two-step cast does."""
    return q * scale.reshape(-1, *([1] * (q.dim() - 1)))


def dequantize_taps(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """A depthwise ``q`` [C, 1, kh, kw] dequantized as :func:`dequantize`
    does, written straight into the fused op's float32 taps layout [kh·kw,
    C] in one op: the product still rounds to the scale's dtype and is then
    stored as float32."""
    c = q.shape[0]
    out = torch.empty(q[0].numel(), c, dtype=torch.float32, device=q.device)
    return torch.mul(q.reshape(c, -1).t(), scale, out=out)


class Int8Conv2d(nn.Module):
    """A conv with a bias whose weight lives as int8 ``q`` + a float
    per-output-channel ``scale``, dequantized on every call. Casting the
    module casts ``scale`` and ``bias`` (the compute dtype) and leaves ``q``
    int8."""

    def __init__(self, conv: nn.Conv2d, q: torch.Tensor, scale: torch.Tensor,
                 bias: torch.Tensor):
        super().__init__()
        self.stride, self.padding, self.groups = conv.stride, conv.padding, conv.groups
        self.register_buffer("q", q)
        self.register_buffer("scale", scale)
        self.register_buffer("bias", bias)

    @property
    def weight(self) -> torch.Tensor:
        return dequantize(self.q, self.scale)

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self.stride, self.padding, 1, self.groups)


class Int8Linear(nn.Module):
    """The dense counterpart of :class:`Int8Conv2d`."""

    def __init__(self, q: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor):
        super().__init__()
        self.out_features = q.shape[0]
        self.register_buffer("q", q)
        self.register_buffer("scale", scale)
        self.register_buffer("bias", bias)

    @property
    def weight(self) -> torch.Tensor:
        return dequantize(self.q, self.scale)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)
