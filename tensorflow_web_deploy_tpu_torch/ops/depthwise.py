"""Depthwise convolution (counterpart of the JAX package's
``ops/depthwise.py``). NCHW tensors; kernels in torch's [C, 1, kh, kw].

- :func:`depthwise_conv2d` — the grouped convolution (cuDNN on the card,
  as XLA ran it on the TPU) after the reference's padding. Its gradient is
  the reference's custom VJP (:class:`_DepthwiseConv`): dx is the stock
  transpose of the grouped conv, dk the explicit shift-multiply-reduce
  over the kh·kw window (:func:`depthwise_kernel_grad`), accumulated in at
  least float32. A cell with a bias (BN folded in, serving only) is the
  bare ``F.conv2d``; under ``no_grad`` or ``inference_mode`` the Function
  runs the same pad and conv and records nothing.
- :func:`fused_depthwise_bn` — dwconv + folded-BN affine + optional relu6
  as one op; :func:`fused_depthwise` is the same op on operands already
  folded into float32 taps [kh·kw, C] and bias [1, C]. Every stride goes to
  :func:`..ops.fused_dw.fused_dw` (the hand-written kernel on a CUDA
  tensor, its plain version on a CPU tensor): stride 1 is the reference's
  Pallas kernel, stride 2 its ``_shift_mac``, the same arithmetic strided.

The reference's ``pallas_fused_ok`` trial compile, which warns and falls
back to XLA, is not carried over: a kernel that fails to build or launch
raises.

"SAME" padding follows ``lax.padtype_to_pads`` (:func:`same_pads`): at
stride 2 the odd pad goes at the end, so a 3×3 stride-2 conv pads (0, 1)
on a 224 input but (1, 1) on a 65 input. ``nn.Conv2d(padding=1)`` would pad
(1, 1) and shift every stride-2 output of an even input.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .fused_dw import fused_dw


def same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """(lo, hi) "SAME" pads of one axis, ``lax.padtype_to_pads``'s rule:
    the output has ⌈size/stride⌉ positions, and an odd total pad puts its
    extra row at the end."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def resolve_pads(padding: str, hw, kernel, strides) -> tuple[tuple[int, int], tuple[int, int]]:
    """((top, bottom), (left, right)) for "SAME" or "VALID"."""
    if padding == "SAME":
        return tuple(same_pads(n, k, s) for n, k, s in zip(hw, kernel, strides))
    if padding == "VALID":
        return (0, 0), (0, 0)
    raise ValueError(f"padding must be SAME or VALID, got {padding!r}")


def pad_nchw(x: torch.Tensor, pads) -> torch.Tensor:
    """Zero-pad the spatial dims of an NCHW tensor by ((top, bottom),
    (left, right))."""
    (pt, pb), (pl, pr) = pads
    return F.pad(x, (pl, pr, pt, pb)) if pt or pb or pl or pr else x


def depthwise_kernel_grad(xp: torch.Tensor, g: torch.Tensor, kernel_hw,
                          strides) -> torch.Tensor:
    """The reference's kernel gradient of a depthwise conv:
    dk[c, 0, dh, dw] = Σ_{b,i,j} xp[b, c, i·sh+dh, j·sw+dw] · g[b, c, i, j]
    over the padded input ``xp`` and the output gradient ``g``, one strided
    slice, multiply and reduction per tap, in ``promote(xp.dtype,
    float32)``: the sums run over B·H'·W' terms, too many for bf16, and a
    float64 caller stays float64. Returns [C, 1, kh, kw] in that dtype."""
    acc = torch.promote_types(xp.dtype, torch.float32)
    xp, g = xp.to(acc), g.to(acc)
    (kh, kw), (sh, sw), (oh, ow) = kernel_hw, strides, g.shape[2:]
    taps = [(xp[:, :, dh:dh + (oh - 1) * sh + 1:sh, dw:dw + (ow - 1) * sw + 1:sw] * g)
            .sum(dim=(0, 2, 3)) for dh in range(kh) for dw in range(kw)]
    return torch.stack(taps, dim=1).reshape(-1, 1, kh, kw)


class _DepthwiseConv(torch.autograd.Function):
    """The reference's ``jax.custom_vjp`` of ``depthwise_conv2d``: the
    forward is the grouped conv of the padded input; dx is its stock
    transpose on the padded shape with the pads cropped, dk
    :func:`depthwise_kernel_grad` cast to the kernel's dtype."""

    @staticmethod
    def forward(ctx, x, kernel, strides, pads):
        ctx.save_for_backward(x, kernel)
        ctx.strides, ctx.pads = strides, pads
        return F.conv2d(pad_nchw(x, pads), kernel, None, stride=strides, groups=x.shape[1])

    @staticmethod
    def backward(ctx, g):
        x, kernel = ctx.saved_tensors
        (pt, pb), (pl, pr) = ctx.pads
        h, w = x.shape[2:]
        dx = dk = None
        if ctx.needs_input_grad[0]:
            dxp = torch.nn.grad.conv2d_input((*x.shape[:2], h + pt + pb, w + pl + pr), kernel,
                                             g, stride=ctx.strides, groups=x.shape[1])
            dx = dxp[:, :, pt:pt + h, pl:pl + w]
        if ctx.needs_input_grad[1]:
            dk = depthwise_kernel_grad(pad_nchw(x, ctx.pads), g, kernel.shape[2:],
                                       ctx.strides).to(kernel.dtype)
        return dx, dk, None, None


def depthwise_conv2d(x: torch.Tensor, kernel: torch.Tensor, strides=(1, 1),
                     padding="SAME", bias: torch.Tensor | None = None) -> torch.Tensor:
    """Depthwise conv: x [B, C, H, W] ⊛ kernel [C, 1, kh, kw] (+ bias [C])
    → [B, C, H', W']. Without a bias (the unfolded cell that trains) it
    goes through :class:`_DepthwiseConv`."""
    pads = resolve_pads(padding, x.shape[2:], kernel.shape[2:], strides)
    if bias is None:
        return _DepthwiseConv.apply(x, kernel, tuple(strides), pads)
    return F.conv2d(pad_nchw(x, pads), kernel, bias, stride=tuple(strides), groups=x.shape[1])


def kernel_taps(kernel: torch.Tensor) -> torch.Tensor:
    """A depthwise kernel [C, 1, kh, kw] → the fused op's float32 taps
    [kh·kw, C], in (dh, dw) row-major order."""
    return kernel.reshape(kernel.shape[0], -1).t().float().contiguous()


def fused_depthwise(x: torch.Tensor, taps: torch.Tensor, bias: torch.Tensor, kernel_hw,
                    strides=(1, 1), padding="SAME", relu6: bool = True) -> torch.Tensor:
    """x [B, C, H, W] ⊛ taps [kh·kw, C] + bias [1, C] (both float32, BN
    already folded in), then an optional relu6 clamp; float32 accumulation,
    one rounding to x's dtype: :func:`..ops.fused_dw.fused_dw` at stride 1
    or 2 (the same along both axes)."""
    kh, kw = kernel_hw
    sh, sw = strides
    if sh != sw:
        raise ValueError(f"fused depthwise takes one stride for both axes, got {tuple(strides)}")
    pads = resolve_pads(padding, x.shape[2:], (kh, kw), (sh, sw))
    return fused_dw(x, taps, bias, kh, kw, pads, relu6, sh)


def fused_depthwise_bn(x: torch.Tensor, kernel: torch.Tensor, scale: torch.Tensor | None,
                       bias: torch.Tensor, strides=(1, 1), padding="SAME",
                       relu6: bool = True) -> torch.Tensor:
    """Fused dwconv(+BN+relu6): x [B, C, H, W] ⊛ kernel [C, 1, kh, kw], then
    the folded per-channel affine (``scale``, ``bias``: [C]) and an optional
    relu6 clamp, accumulated in float32 and returned in x's dtype
    (:func:`fused_depthwise`). ``scale=None`` means the kernel is already
    BN-folded."""
    kf = kernel if scale is None else kernel * scale[:, None, None, None]
    return fused_depthwise(x, kernel_taps(kf), bias.float().reshape(1, -1), kernel.shape[2:],
                           strides, padding, relu6)
