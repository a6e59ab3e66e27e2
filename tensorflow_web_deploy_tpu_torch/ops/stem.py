"""Space-to-depth stem convolution (counterpart of the JAX package's
``ops/stem.py``). NCHW tensors, channels_last in memory; kernels in
torch's [cout, cin, kh, kw].

Every zoo model, and every frozen graph of the reference's genre, starts
with a stride-2 convolution over a 3-channel image. The JAX package
computes it by an exact identity of the math:

    conv(x, k, stride 2)  ==  conv(s2d₂(x), k', stride 1)

where ``s2d₂`` folds each 2×2 pixel block into the channel dim (C → 4C)
and ``k'`` is the same kernel zero-padded to even extent and re-indexed
into (block, phase) form. Channels go in the order (phase_h, phase_w,
cin), cin fastest, on the data side (:func:`pack_s2d`, the yuv420
preprocess's cell store) and on the kernel side (:func:`s2d_kernel`).
The parameter stays the logical [cout, cin, kh, kw] kernel; a serving
module keeps the rearranged kernel it built once (``rearranged=``), a
training step builds it from the parameter on every call and autograd
flows through it.

The convolution itself is ``F.conv2d`` at stride 1, VALID (cuDNN on the
card), as XLA's conv computed it for the JAX package: no hand-written
kernel replaces it. Whether the rewrite pays on the H100 is measured by
``chip_smoke.py``'s ``s2d_stem`` phase (PERF.md); the route follows the
reference's: :func:`worthwhile` gates it.

"SAME" pads are ``lax.padtype_to_pads``'s (``ops/depthwise.py``): at
stride 2 the odd pad goes at the end.

An image's answer must not depend on the batch it is served in. On the
H100 cuDNN takes another algorithm for the stride-1 conv at batch 1 than at
batch 8 and 32 when it has 16 output channels (SSD-MobileNet's stem), and
the two differ in bf16 rounding; with 32 or more (the other three stems)
it does not (``chip_smoke.py``'s ``s2d_stem`` phase holds each stem's
routes to that, per image, batch 1 against batch 32). So a stem with fewer
than ``MIN_CONV_COUT`` output channels convolves with its kernel padded by
zero filters to that many and keeps the first ``cout`` channels.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .depthwise import resolve_pads


def worthwhile(cin: int, strides, kernel, dilation=(1, 1)) -> bool:
    """Should this conv take the s2d path? The reference's gate: stride
    2×2, undilated, odd kernel, at most 4 input channels."""
    return (
        tuple(strides) == (2, 2)
        and tuple(dilation) == (1, 1)
        and all(int(k) % 2 == 1 for k in kernel)
        and cin <= 4
    )


MIN_CONV_COUT = 32


def _conv(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor | None) -> torch.Tensor:
    """The stride-1 VALID conv of the rewrite, its output channels padded
    with zero filters to ``MIN_CONV_COUT`` (see the module's note)."""
    cout = kernel.shape[0]
    if cout >= MIN_CONV_COUT:
        return F.conv2d(x, kernel, bias)
    pad = MIN_CONV_COUT - cout
    kernel = F.pad(kernel, (0, 0, 0, 0, 0, 0, 0, pad))
    bias = F.pad(bias, (0, pad)) if bias is not None else None
    return F.conv2d(x, kernel, bias)[:, :cout]


def _rearranged_kernel(weight: torch.Tensor, bh: int, bw: int) -> torch.Tensor:
    """[cout, cin, kh, kw] → [cout, 4·cin, bh, bw]: zero-pad to (2·bh, 2·bw)
    and fold each 2×2 tap phase into the input channels, ordered (phase_h,
    phase_w, cin) with cin fastest. A permutation and zeros, so it
    commutes with a dtype cast and with a per-output-channel scale."""
    cout, cin, kh, kw = weight.shape
    kp = F.pad(weight, (0, 2 * bw - kw, 0, 2 * bh - kh))
    return (kp.reshape(cout, cin, bh, 2, bw, 2).permute(0, 3, 5, 1, 2, 4)
            .reshape(cout, 4 * cin, bh, bw))


def stride2_pads(hw, kernel, padding) -> tuple[tuple[int, int], tuple[int, int]]:
    """((top, bottom), (left, right)) of a stride-2 conv over extent ``hw``:
    lax's for "SAME"/"VALID", else the explicit pads as ints."""
    if isinstance(padding, str):
        return resolve_pads(padding, hw, kernel, (2, 2))
    (pt, pb), (pl, pr) = padding
    return (int(pt), int(pb)), (int(pl), int(pr))


def _input_shift(padding, kernel) -> tuple[int, int]:
    """The kernel shift (top, left) that keeps a conv over cells 2-aligned:
    the parity of its leading pads on an even extent. A "SAME" pad of an
    even extent at stride 2 does not depend on the extent (k − 2 in all),
    so the shift of any even extent is the shift of every one."""
    (pt, _), (pl, _) = stride2_pads((2, 2), kernel, padding)
    return pt % 2, pl % 2


def pack_s2d(x: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] → [B, ⌈H/2⌉, ⌈W/2⌉, 4C]: fold 2×2 pixel blocks into the
    channel dim (odd extents zero-padded), channel order (p, q, c) with c
    fastest — the JAX package's ``pack_s2d``, NHWC as the preprocess
    emits it. ``.permute(0, 3, 1, 2)`` of the result is the NCHW,
    channels_last input of :func:`conv2d_s2d_input`."""
    b, h, w, c = x.shape
    ch, cw = (h + 1) // 2, (w + 1) // 2
    xp = F.pad(x, (0, 0, 0, 2 * cw - w, 0, 2 * ch - h))
    return xp.reshape(b, ch, 2, cw, 2, c).permute(0, 1, 3, 2, 4, 5).reshape(b, ch, cw, 4 * c)


def s2d_kernel(weight: torch.Tensor) -> torch.Tensor:
    """The rearranged kernel of :func:`conv2d_stride2_s2d` for a logical
    [cout, cin, kh, kw] ``weight``."""
    kh, kw = weight.shape[2:]
    return _rearranged_kernel(weight, (kh + 1) // 2, (kw + 1) // 2)


def s2d_input_kernel(weight: torch.Tensor, padding="SAME") -> torch.Tensor:
    """The rearranged kernel of :func:`conv2d_s2d_input`: ``weight`` shifted
    by a zero leading row and column where ``padding`` leads with an odd
    pad, then rearranged."""
    st, sl = _input_shift(padding, weight.shape[2:])
    if st or sl:
        weight = F.pad(weight, (sl, 0, st, 0))
    return s2d_kernel(weight)


def conv2d_s2d_input(x_cells: torch.Tensor, weight: torch.Tensor, padding="SAME",
                     bias: torch.Tensor | None = None,
                     rearranged: torch.Tensor | None = None) -> torch.Tensor:
    """Stride-2 conv consuming an ALREADY space-to-depth input.

    ``x_cells``: NCHW [B, 4·cin, ch, cw] in :func:`pack_s2d` channel order,
    standing for an image of extent (2·ch, 2·cw) — odd originals ride with
    a zero last row/col, exact for odd kernels. ``weight``: the logical
    [cout, cin, kh, kw] (with ``rearranged``, :func:`s2d_input_kernel` of
    it, only its shape is read). ``padding``: "SAME"/"VALID" on the
    even extent, or explicit ((top, bottom), (left, right)). Equals the
    stride-2 conv of the original image with those pads; odd leading pads
    are absorbed by shifting the kernel, so windows stay 2-aligned with
    the cells.
    """
    _, c4, ch, cw = x_cells.shape
    _, cin, kh, kw = weight.shape
    if c4 != 4 * cin:
        raise ValueError(f"kernel cin {cin} != s2d input cin {c4 // 4}")
    (pt, pb), (pl, pr) = stride2_pads((2 * ch, 2 * cw), (kh, kw), padding)
    out_h = (2 * ch + pt + pb - kh) // 2 + 1
    out_w = (2 * cw + pl + pr - kw) // 2 + 1
    st, sl = pt % 2, pl % 2
    if rearranged is None:
        rearranged = s2d_kernel(F.pad(weight, (sl, 0, st, 0)) if st or sl else weight)
    kh, kw, pt, pl = kh + st, kw + sl, pt + st, pl + sl
    bh, bw = (kh + 1) // 2, (kw + 1) // 2
    need_h, need_w = out_h - 1 + bh, out_w - 1 + bw
    pads = (pl // 2, need_w - cw - pl // 2, pt // 2, need_h - ch - pt // 2)
    return _conv(F.pad(x_cells, pads) if any(pads) else x_cells, rearranged, bias)


def conv2d_stride2_s2d(x: torch.Tensor, weight: torch.Tensor, padding="SAME",
                       bias: torch.Tensor | None = None,
                       rearranged: torch.Tensor | None = None) -> torch.Tensor:
    """Exact stride-2 conv via space-to-depth and a stride-1 conv.

    ``x``: NCHW [B, C, H, W]; ``weight``: [cout, C, kh, kw], kh and kw odd
    (with ``rearranged``, :func:`s2d_kernel` of it, only its shape is
    read); ``padding``: "SAME"/"VALID" or explicit ((top, bottom), (left,
    right)). The zero-padded kernel taps multiply only pixels the stock
    conv's padding also zeroes. The fold is one copy of the padded image
    in NHWC, read by the conv as channels_last.
    """
    b, c, h, w = x.shape
    kh, kw = weight.shape[2:]
    (pt, pb), (pl, pr) = stride2_pads((h, w), (kh, kw), padding)
    out_h = (h + pt + pb - kh) // 2 + 1
    out_w = (w + pl + pr - kw) // 2 + 1
    bh, bw = (kh + 1) // 2, (kw + 1) // 2
    # the padded image the cells cover, in whole 2×2 blocks
    cells_h, cells_w = out_h - 1 + bh, out_w - 1 + bw
    xp = F.pad(x.permute(0, 2, 3, 1), (0, 0, pl, 2 * cells_w - w - pl, pt, 2 * cells_h - h - pt))
    cells = (xp.reshape(b, cells_h, 2, cells_w, 2, c).permute(0, 1, 3, 2, 4, 5)
             .reshape(b, cells_h, cells_w, 4 * c))
    if rearranged is None:
        rearranged = s2d_kernel(weight)
    return _conv(cells.permute(0, 3, 1, 2), rearranged, bias)


def conv2d_padded(x: torch.Tensor, weight: torch.Tensor, strides, pads, dilation=(1, 1),
                  groups: int = 1) -> torch.Tensor:
    """The stock conv with TF's pads: symmetric pads go to ``F.conv2d``,
    asymmetric ones to an explicit ``F.pad`` first."""
    (pt, pb), (pl, pr) = pads
    if pt == pb and pl == pr:
        return F.conv2d(x, weight, None, tuple(strides), (pt, pl), tuple(dilation), groups)
    return F.conv2d(F.pad(x, (pl, pr, pt, pb)), weight, None, tuple(strides), 0,
                    tuple(dilation), groups)


def maybe_s2d_conv(x: torch.Tensor, weight: torch.Tensor, strides, pads, dilation=(1, 1),
                   groups: int = 1) -> torch.Tensor:
    """A stride-2 few-channel conv through :func:`conv2d_stride2_s2d`, any
    other through :func:`conv2d_padded`; ``pads`` explicit. The frozen-graph
    op library's ``Conv2D`` (``ops/tf_ops.py``)."""
    if groups == 1 and worthwhile(x.shape[1], strides, weight.shape[2:], dilation):
        return conv2d_stride2_s2d(x, weight, pads)
    return conv2d_padded(x, weight, strides, pads, dilation, groups)
