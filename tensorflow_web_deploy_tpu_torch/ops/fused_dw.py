"""Fused 3×3 depthwise conv + folded-BN bias + optional relu6, stride 1 or 2.

The port of the JAX package's Pallas kernel
``ops/pallas_depthwise.py::fused_dw_call`` (stride 1) and of its caller's
stride-2 path ``ops/depthwise.py::_shift_mac``, which does the same
arithmetic on strided slices. On a CUDA tensor :func:`fused_dw` launches
the hand-written kernel in ``csrc/fused_dw.cu`` (built at first use by
``ops/_build.py``) at both strides; on a CPU tensor it pads and runs
:func:`fused_dw_call_plain`, the reference's arithmetic in plain torch.
There is no fallback from one to the other: a CUDA tensor gets the kernel
or an error.

The kernel takes the reference caller's pad, cast-in and cast-out into
its one pass: it reads the unpadded activation (bf16 or float32) in NHWC
memory — a ``channels_last`` NCHW tensor, as the engine keeps its
activations — stages a halo tile of it in shared memory with the SAME pads
zero-filled, accumulates in float32 and rounds once to the input type.
:func:`launch_shape` picks the kernel's tiling per layer.
:func:`fused_dw_plain` is the same function in plain torch on any device.

``fused_dw.launches`` counts kernel launches (plain-version calls are not
counted), so a caller can show that a run went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import _build, launches

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# channels per thread in the kernel (one 16-byte bf16 vector)
VEC = 8
STRIDES = (1, 2)
# The kernel's limits (csrc/fused_dw.cu): threads, 8-channel groups and
# output rows per block.
MAX_THREADS = 256
MAX_GROUPS = 8
MAX_ROWS = 64
# The launch rule (launch_shape), fitted to the kernel's times on an H100
# under every launch shape that fits (chip_smoke.py --sweep-fused-dw):
# channel slabs of at most 32 channels (a power of two of 8-channel
# groups); per thread a run along its row of at most 14 outputs at stride 1
# and 7 at stride 2, with at least 2 (stride 1) or 4 (stride 2) threads on
# a row; blocks of at most 64 threads; 2 blocks per SM where the layer's
# work allows; a halo tile of at most 96 KB (two blocks fit one SM).
SLAB_GROUPS = 4
RUN_CAP = {1: 14, 2: 7}
ROW_THREADS = {1: 2, 2: 4}
BLOCK_THREADS = 64
BLOCKS_PER_SM = 2
SMEM_BUDGET = 96 * 1024


class LaunchShape(NamedTuple):
    """The kernel's tiling of one call: blocks of ``groups`` × ``nx`` ×
    ``th`` threads; a thread owns 8 channels and ``run`` outputs along one
    output row, so a block covers ``th`` rows × ``nx·run`` columns × a slab
    of ``8·groups`` channels of one image."""

    groups: int
    nx: int
    th: int
    run: int

    @property
    def threads(self) -> int:
        return self.groups * self.nx * self.th

    def tile(self) -> tuple[int, int, int]:
        """Output rows, columns and channels of one block."""
        return self.th, self.nx * self.run, self.groups * VEC

    def grid(self, b: int, c: int, oh: int, ow: int) -> tuple[int, int, int]:
        """Blocks along (image × channel slab, row tiles, column tiles)."""
        tw = self.nx * self.run
        return b * (c // (VEC * self.groups)), -(-oh // self.th), -(-ow // tw)

    def blocks(self, b: int, c: int, oh: int, ow: int) -> int:
        gx, gy, gz = self.grid(b, c, oh, ow)
        return gx * gy * gz

    def smem(self, stride: int, elt: int) -> int:
        """Bytes of the block's input halo tile in shared memory."""
        th, tw, cb = self.tile()
        return ((th - 1) * stride + 3) * ((tw - 1) * stride + 3) * cb * elt


def launch_shape(b: int, c: int, oh: int, ow: int, stride: int, elt: int,
                 sms: int) -> LaunchShape:
    """The kernel's tiling for one layer, chosen from its shape alone (see
    the rule's constants above): the slab, the run and the threads along a
    row first, then as many rows as ``BLOCK_THREADS`` allows, halved until
    the layer gives ``BLOCKS_PER_SM`` blocks per SM and the tile fits
    ``SMEM_BUDGET``; a row too wide for one block is cut into column
    tiles."""
    groups = max(d for d in (1, 2, SLAB_GROUPS) if (c // VEC) % d == 0)
    run = min(RUN_CAP[stride], -(-ow // ROW_THREADS[stride]))
    nx = min(-(-ow // run), MAX_THREADS // groups)
    th = max(1, min(oh, MAX_ROWS, BLOCK_THREADS // (groups * nx)))
    shape = LaunchShape(groups, nx, th, run)
    while shape.th > 1 and (shape.blocks(b, c, oh, ow) < BLOCKS_PER_SM * sms
                            or shape.smem(stride, elt) > SMEM_BUDGET):
        shape = shape._replace(th=(shape.th + 1) // 2)
    while shape.nx > 1 and shape.smem(stride, elt) > SMEM_BUDGET:
        shape = shape._replace(nx=(shape.nx + 1) // 2)
    return shape


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def fused_dw_call_plain(xp: torch.Tensor, taps: torch.Tensor, bias: torch.Tensor,
                        kh: int, kw: int, relu6: bool = True, stride: int = 1) -> torch.Tensor:
    """xp [B, Hp, Wp, C] (pre-padded NHWC) ⊛ taps [kh·kw, C] + bias [1, C]
    → [B, (Hp−kh)//s+1, (Wp−kw)//s+1, C] float32 at stride s. The
    reference's arithmetic (the Pallas kernel's at stride 1, ``_shift_mac``'s
    at stride 2): taps in (dh, dw) row-major order over strided slices, each
    a multiply then an add, in float32."""
    _, hp, wp, _ = xp.shape
    oh, ow = (hp - kh) // stride + 1, (wp - kw) // stride + 1
    x = xp.float()
    acc = None
    for dh in range(kh):
        for dw in range(kw):
            xs = x[:, dh:dh + (oh - 1) * stride + 1:stride, dw:dw + (ow - 1) * stride + 1:stride]
            tap = xs * taps[dh * kw + dw]
            acc = tap if acc is None else acc + tap
    y = acc + bias[0]
    return y.clamp(0.0, 6.0) if relu6 else y


def fused_dw_plain(x: torch.Tensor, taps: torch.Tensor, bias: torch.Tensor, kh: int, kw: int,
                   pads, relu6: bool = True, stride: int = 1) -> torch.Tensor:
    """:func:`fused_dw` in plain torch: pad in float32, run
    :func:`fused_dw_call_plain` in NHWC, cast back to x's dtype."""
    (pt, pb), (pl, pr) = pads
    xp = F.pad(x.float(), (pl, pr, pt, pb)).permute(0, 2, 3, 1)
    y = fused_dw_call_plain(xp, taps, bias, kh, kw, relu6, stride)
    return y.permute(0, 3, 1, 2).to(x.dtype)


def _out_hw(x: torch.Tensor, kh: int, kw: int, pads, stride: int) -> tuple[int, int]:
    (pt, pb), (pl, pr) = pads
    return ((x.shape[2] + pt + pb - kh) // stride + 1,
            (x.shape[3] + pl + pr - kw) // stride + 1)


def _check(x, taps, bias, kh, kw, pads, stride) -> None:
    if x.dim() != 4:
        raise ValueError(f"x must be [B, C, H, W], got {tuple(x.shape)}")
    if stride not in STRIDES:
        raise ValueError(f"stride must be 1 or 2, got {stride}")
    c = x.shape[1]
    if tuple(taps.shape) != (kh * kw, c) or tuple(bias.shape) != (1, c):
        raise ValueError(f"taps must be [{kh * kw}, {c}] and bias [1, {c}], got "
                         f"{tuple(taps.shape)} and {tuple(bias.shape)}")
    if min(p for pair in pads for p in pair) < 0:
        raise ValueError(f"pads must be non-negative, got {pads}")
    if min(_out_hw(x, kh, kw, pads, stride)) < 1:
        raise ValueError(f"a {kh}×{kw} window does not fit {tuple(x.shape[2:])} padded by {pads}")


def _launch(x, taps, bias, pads, relu6, stride, shape: LaunchShape) -> torch.Tensor:
    """Launch the kernel with the tiling ``shape``; x and the operands
    already checked by :func:`fused_dw`'s strict checks."""
    b, c, h, w = x.shape
    (pt, _), (pl, _) = pads
    oh, ow = _out_hw(x, 3, 3, pads, stride)
    fn = _build.load("fused_dw").twd_fused_dw
    if fn.argtypes is None:  # declare the C signature once
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 15 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    out = torch.empty((b, c, oh, ow), dtype=x.dtype, device=x.device,
                      memory_format=torch.channels_last)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), taps.data_ptr(), bias.data_ptr(), out.data_ptr(), b, h, w, c, oh, ow,
             stride, pt, pl, int(relu6), _KERNEL_DTYPES[x.dtype], shape.groups, shape.nx,
             shape.th, shape.run, stream)
    if err != 0:
        raise RuntimeError(f"fused_dw kernel launch failed: CUDA error {err}")
    launches.count(fused_dw)
    return out


def kernel_shape(x: torch.Tensor, kh: int, kw: int, pads, stride: int) -> LaunchShape:
    """The tiling :func:`fused_dw` launches the kernel with for ``x`` (a
    CUDA tensor), after the kernel's strict checks on x's shape, dtype,
    layout and alignment."""
    if (kh, kw) != (3, 3):
        raise ValueError(f"the kernel takes 3×3 windows, got {kh}×{kw}")
    if x.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    b, c, h, w = x.shape
    if c % VEC:
        raise ValueError(f"the kernel takes channel counts that are multiples of {VEC}, got {c}")
    if h * w * c >= 2 ** 31:
        raise ValueError(f"one image of {h}×{w}×{c} is too large for the kernel's 32-bit indices")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("x must be NHWC in memory (a channels_last NCHW tensor)")
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned")
    oh, ow = _out_hw(x, kh, kw, pads, stride)
    return launch_shape(b, c, oh, ow, stride, x.element_size(),
                        _sm_count(x.device.index))


def fused_dw(x: torch.Tensor, taps: torch.Tensor, bias: torch.Tensor, kh: int, kw: int,
             pads, relu6: bool = True, stride: int = 1) -> torch.Tensor:
    """x [B, C, H, W] → [B, C, oh, ow] in x's dtype: zero-pad by ``pads`` =
    ((top, bottom), (left, right)), the depthwise conv at ``stride`` (1 or
    2) with ``taps`` [kh·kw, C] (float32), ``bias`` [1, C] (float32)
    added, clamped to [0, 6] when ``relu6``; float32 accumulation.
    oh = (H + top + bottom − kh) // stride + 1, and ow likewise.

    On CUDA the result is channels_last, and ``x`` must be channels_last,
    float32 or bfloat16, with C a multiple of 8 and a 3×3 window.
    """
    _check(x, taps, bias, kh, kw, pads, stride)
    if x.device.type == "cpu":
        return fused_dw_plain(x, taps, bias, kh, kw, pads, relu6, stride)
    if x.device.type != "cuda":
        raise ValueError(f"fused_dw runs on CUDA or CPU tensors, not {x.device}")
    shape = kernel_shape(x, kh, kw, pads, stride)
    for name, t in (("taps", taps), ("bias", bias)):
        if t.dtype != torch.float32 or t.device != x.device or not t.is_contiguous():
            raise TypeError(f"{name} must be a contiguous float32 tensor on x's device")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    return _launch(x, taps, bias, pads, relu6, stride, shape)


fused_dw.launches = 0
