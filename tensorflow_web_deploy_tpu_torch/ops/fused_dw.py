"""Fused stride-1 depthwise conv + folded-BN bias + optional relu6.

The port of the JAX package's Pallas kernel
``ops/pallas_depthwise.py::fused_dw_call``. On a CUDA tensor
:func:`fused_dw` launches the hand-written kernel in ``csrc/fused_dw.cu``
(built at first use by ``ops/_build.py``); on a CPU tensor it pads and runs
:func:`fused_dw_call_plain`, the reference kernel's body in plain torch.
There is no fallback from one to the other: a CUDA tensor gets the kernel
or an error.

The kernel takes the reference caller's pad, cast-in and cast-out into
its one pass: it reads the unpadded activation (bf16 or float32) in NHWC
memory — a ``channels_last`` NCHW tensor, as the engine keeps its
activations — zero-pads by bounds checks, accumulates in float32 and
rounds once to the input type. :func:`fused_dw_plain` is the same
function in plain torch on any device.

``fused_dw.launches`` counts kernel launches (plain-version calls are not
counted), so a caller can show that a run went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# channels per thread in the kernel (one 16-byte bf16 vector)
VEC = 8


def fused_dw_call_plain(xp: torch.Tensor, taps: torch.Tensor, bias: torch.Tensor,
                        kh: int, kw: int, relu6: bool = True) -> torch.Tensor:
    """xp [B, oh+kh−1, ow+kw−1, C] (pre-padded NHWC) ⊛ taps [kh·kw, C] +
    bias [1, C] → [B, oh, ow, C] float32; stride 1. The reference kernel's
    arithmetic: taps in (dh, dw) row-major order, each a multiply then an
    add, in float32."""
    _, hp, wp, _ = xp.shape
    oh, ow = hp - kh + 1, wp - kw + 1
    x = xp.float()
    acc = None
    for dh in range(kh):
        for dw in range(kw):
            tap = x[:, dh:dh + oh, dw:dw + ow, :] * taps[dh * kw + dw]
            acc = tap if acc is None else acc + tap
    y = acc + bias[0]
    return y.clamp(0.0, 6.0) if relu6 else y


def fused_dw_plain(x: torch.Tensor, taps: torch.Tensor, bias: torch.Tensor, kh: int, kw: int,
                   pads, relu6: bool = True) -> torch.Tensor:
    """:func:`fused_dw` in plain torch: pad in float32, run
    :func:`fused_dw_call_plain` in NHWC, cast back to x's dtype."""
    (pt, pb), (pl, pr) = pads
    xp = F.pad(x.float(), (pl, pr, pt, pb)).permute(0, 2, 3, 1)
    return fused_dw_call_plain(xp, taps, bias, kh, kw, relu6).permute(0, 3, 1, 2).to(x.dtype)


def _out_hw(x: torch.Tensor, kh: int, kw: int, pads) -> tuple[int, int]:
    (pt, pb), (pl, pr) = pads
    return x.shape[2] + pt + pb - kh + 1, x.shape[3] + pl + pr - kw + 1


def _check(x, taps, bias, kh, kw, pads) -> None:
    if x.dim() != 4:
        raise ValueError(f"x must be [B, C, H, W], got {tuple(x.shape)}")
    c = x.shape[1]
    if tuple(taps.shape) != (kh * kw, c) or tuple(bias.shape) != (1, c):
        raise ValueError(f"taps must be [{kh * kw}, {c}] and bias [1, {c}], got "
                         f"{tuple(taps.shape)} and {tuple(bias.shape)}")
    if min(p for pair in pads for p in pair) < 0:
        raise ValueError(f"pads must be non-negative, got {pads}")
    oh, ow = _out_hw(x, kh, kw, pads)
    if oh < 1 or ow < 1:
        raise ValueError(f"a {kh}×{kw} window does not fit {tuple(x.shape[2:])} padded by {pads}")


def _launch(x, taps, bias, kh, kw, pads, relu6) -> torch.Tensor:
    if x.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    for name, t in (("taps", taps), ("bias", bias)):
        if t.dtype != torch.float32 or t.device != x.device or not t.is_contiguous():
            raise TypeError(f"{name} must be a contiguous float32 tensor on x's device")
    b, c, h, w = x.shape
    if c % VEC:
        raise ValueError(f"the kernel takes channel counts that are multiples of {VEC}, got {c}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("x must be NHWC in memory (a channels_last NCHW tensor)")
    if any(t.data_ptr() % 16 for t in (x, taps, bias)):
        raise ValueError("x, taps and bias must be 16-byte aligned")
    (pt, _), (pl, _) = pads
    oh, ow = _out_hw(x, kh, kw, pads)
    fn = _build.load("fused_dw").twd_fused_dw
    if fn.argtypes is None:  # declare the C signature once
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    out = torch.empty((b, c, oh, ow), dtype=x.dtype, device=x.device,
                      memory_format=torch.channels_last)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), taps.data_ptr(), bias.data_ptr(), out.data_ptr(), b, h, w, c, oh, ow,
             kh, kw, pt, pl, int(relu6), _KERNEL_DTYPES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"fused_dw kernel launch failed: CUDA error {err}")
    fused_dw.launches += 1
    return out


def fused_dw(x: torch.Tensor, taps: torch.Tensor, bias: torch.Tensor, kh: int, kw: int,
             pads, relu6: bool = True) -> torch.Tensor:
    """x [B, C, H, W] → [B, C, oh, ow] in x's dtype: zero-pad by ``pads`` =
    ((top, bottom), (left, right)), the stride-1 depthwise conv with
    ``taps`` [kh·kw, C] (float32), ``bias`` [1, C] (float32) added, clamped
    to [0, 6] when ``relu6``; float32 accumulation.

    On CUDA the result is channels_last, and ``x`` must be channels_last,
    float32 or bfloat16, with C a multiple of 8.
    """
    _check(x, taps, bias, kh, kw, pads)
    if x.device.type == "cpu":
        return fused_dw_plain(x, taps, bias, kh, kw, pads, relu6)
    if x.device.type != "cuda":
        raise ValueError(f"fused_dw runs on CUDA or CPU tensors, not {x.device}")
    return _launch(x, taps, bias, kh, kw, pads, relu6)


fused_dw.launches = 0
