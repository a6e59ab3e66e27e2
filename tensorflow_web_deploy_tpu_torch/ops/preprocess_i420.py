"""Fused I420 → RGB → valid-region bilinear resize → normalize.

The port of the JAX package's Pallas kernel
``ops/pallas_preprocess.py::preprocess_i420``. Two entries launch the one
hand-written kernel in ``csrc/preprocess_i420.cu`` (built at first use by
``ops/_build.py``) on CUDA tensors:

- :func:`preprocess_i420` takes canvases and a ``[B, 2]`` table of valid
  sizes, the reference's API;
- :func:`preprocess_i420_wire` takes the engine's packed wire buffer, each
  row a canvas followed by its big-endian (h, w) trailer, and reads the
  trailer inside the kernel.

Both store ``out_dtype`` (float32 or bf16) directly. On CPU tensors they
run the plain version, :func:`preprocess_i420_plain` (the same function in
plain torch, then a cast), with the trailer decoded by
:func:`decode_trailer`. There is no fallback from one to the other: a CUDA
tensor gets the kernel or an error.

:func:`launch_shape` picks the kernel's bands and threads from the shapes
alone. ``preprocess_i420.launches`` counts kernel launches of either entry
(plain-version calls are not counted), so a caller can show that a run
went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from . import _build, launches
from .image import NORMALIZERS, resize_yuv_planes

MODES = {"inception": 0, "zero_one": 1, "raw": 2}
OUT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TRAILER_BYTES = 4  # big-endian u16 h, then w, after each canvas of the wire
# The kernel's limits (csrc/preprocess_i420.cu): output rows per band,
# threads per block, canvas side, dynamic shared memory per block.
MAX_ROWS = 32
MAX_THREADS = 512
MAX_SIDE = 8192
MAX_SMEM = 224 * 1024
# The launch rule (launch_shape), fitted to the kernel's times on an H100
# under every launch shape that fits (chip_smoke.py --sweep-preprocess):
# blocks of THREADS threads; bands of at most ROWS_CAP rows, halved until
# the grid gives BLOCKS_PER_SM blocks per SM and a block's shared memory
# fits SMEM_BUDGET (so that ~9 blocks share an SM).
ROWS_CAP = 4
THREADS = 128
BLOCKS_PER_SM = 2
SMEM_BUDGET = 24 * 1024


def _align16(x: int) -> int:
    return (x + 15) // 16 * 16


class LaunchShape(NamedTuple):
    """The kernel's tiling of one call: a block computes ``rows`` whole
    output rows of one image with ``threads`` threads."""

    rows: int
    threads: int

    def bands(self, out_h: int) -> int:
        return -(-out_h // self.rows)

    def blocks(self, b: int, out_h: int) -> int:
        return b * self.bands(out_h)

    def smem(self, s: int, out_w: int, elt: int) -> int:
        """Bytes of a block's dynamic shared memory (the kernel's
        ``Layout``): the column taps (8 bytes an output column), 2·rows
        staged Y rows and as many U and V rows (each with room for its
        start's offset from a 16-byte boundary), and the output band at its
        address mod 16."""
        y_pitch, c_pitch = _align16(s + 15), _align16(s // 2 + 15)
        cols = _align16(8 * out_w)
        staged = 2 * self.rows * (y_pitch + 2 * c_pitch)
        return cols + staged + _align16(self.rows * out_w * 3 * elt + 16)


def launch_shape(b: int, s: int, out_h: int, out_w: int, elt: int, sms: int) -> LaunchShape:
    """The kernel's tiling for one call, from its shapes alone (see the
    rule's constants above)."""
    shape = LaunchShape(ROWS_CAP, THREADS)
    while shape.rows > 1 and (shape.blocks(b, out_h) < BLOCKS_PER_SM * sms
                              or shape.smem(s, out_w, elt) > SMEM_BUDGET):
        shape = shape._replace(rows=shape.rows // 2)
    return shape


def axis_taps(out_size: int, valid, total: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The kernel's bilinear taps along one axis in numpy float32: (lo, hi)
    int64 and frac, each [out_size] for an int ``valid``, [N, out_size] for
    an int array [N] (``_dynamic_axis_coords``)."""
    i = np.arange(out_size, dtype=np.float32)
    in_f = np.asarray(valid, dtype=np.float32)[..., None]
    c = (i + np.float32(0.5)) * (in_f / np.float32(out_size)) - np.float32(0.5)
    c = np.minimum(np.maximum(c, np.float32(0)), in_f - np.float32(1))
    lo = np.floor(c)
    hi = np.minimum(np.minimum(lo + np.float32(1), in_f - np.float32(1)), np.float32(total - 1))
    return lo.astype(np.int64), hi.astype(np.int64), c - lo


def _check_mode(mode: str, out_dtype: torch.dtype) -> None:
    if mode not in MODES:
        raise ValueError(f"unsupported normalize mode for the preprocess kernel: {mode}")
    if out_dtype not in OUT_DTYPES:
        raise ValueError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")


def _check(packed: torch.Tensor, hws: torch.Tensor, mode: str, out_dtype: torch.dtype) -> None:
    if packed.dim() != 3 or packed.shape[1] != packed.shape[2] * 3 // 2 or packed.shape[2] % 4:
        raise ValueError(f"not an I420 canvas batch: {tuple(packed.shape)}")
    _check_mode(mode, out_dtype)
    if hws.shape != (packed.shape[0], 2):
        raise ValueError(f"hws must be [B, 2] for B={packed.shape[0]}, got {tuple(hws.shape)}")


def _check_wire(buf: torch.Tensor, s: int, mode: str, out_dtype: torch.dtype) -> None:
    if s < 4 or s % 4 or buf.dim() != 2 or buf.shape[1] != s * s * 3 // 2 + TRAILER_BYTES:
        raise ValueError(f"not a wire buffer of I420 canvases of side {s}: {tuple(buf.shape)}")
    _check_mode(mode, out_dtype)


def decode_trailer(buf: torch.Tensor) -> torch.Tensor:
    """[B, canvas bytes + 4] wire rows → int32 [B, 2] valid sizes from each
    row's big-endian (h, w) trailer (the reference engine's decode)."""
    hwb = buf[:, -TRAILER_BYTES:].to(torch.int32)
    return torch.stack([hwb[:, 0] * 256 + hwb[:, 1], hwb[:, 2] * 256 + hwb[:, 3]], dim=1)


def wire_canvases(buf: torch.Tensor, s: int) -> torch.Tensor:
    """[B, canvas bytes + 4] wire rows → [B, 3S/2, S] views of the canvases."""
    return buf[:, :-TRAILER_BYTES].unflatten(1, (s * 3 // 2, s))


def preprocess_i420_plain(packed: torch.Tensor, hws: torch.Tensor, out_h: int, out_w: int,
                          mode: str = "inception",
                          out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain-torch version: ``resize_yuv_planes`` + ``NORMALIZERS[mode]``,
    then a cast to ``out_dtype``."""
    _check(packed, hws, mode, out_dtype)
    return NORMALIZERS[mode](resize_yuv_planes(packed, hws, out_h, out_w)).to(out_dtype)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _rule(b: int, s: int, out_h: int, out_w: int, elt: int, device: int) -> LaunchShape:
    return launch_shape(b, s, out_h, out_w, elt, _sm_count(device))


_kernel_fn = None  # the C entry, resolved once per process


def _kernel():
    global _kernel_fn
    if _kernel_fn is None:
        fn = _build.load("preprocess_i420").twd_preprocess_i420
        fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
                       *[ctypes.c_int] * 8, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _kernel_fn = fn
    return _kernel_fn


def _launch(src: torch.Tensor, image_stride: int, hws: torch.Tensor | None, b: int, s: int,
            out_h: int, out_w: int, mode: str, out_dtype: torch.dtype,
            shape: LaunchShape | None = None) -> torch.Tensor:
    """Launch the kernel on images at ``src.data_ptr() + k·image_stride``;
    valid sizes from ``hws`` or, when it is None, from the trailers. The
    operands are already checked; ``shape`` overrides the launch rule."""
    if src.dtype != torch.uint8:
        raise TypeError(f"canvases must be uint8, got {src.dtype}")
    if s > MAX_SIDE or b > 65535:
        raise ValueError(f"the kernel takes canvases of side ≤ {MAX_SIDE} in batches ≤ 65535")
    dev = src.device
    out = torch.empty((b, out_h, out_w, 3), dtype=out_dtype, device=dev)
    if out.numel() == 0:
        return out
    if shape is None:
        shape = _rule(b, s, out_h, out_w, out.element_size(), dev.index)
    # the raw current stream, as torch's own kernel launchers take it
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    err = _kernel()(src.data_ptr(), image_stride, None if hws is None else hws.data_ptr(),
                    out.data_ptr(), OUT_DTYPES[out_dtype], b, s, out_h, out_w, MODES[mode],
                    shape.rows, shape.threads, stream)
    if err != 0:
        raise RuntimeError(f"preprocess_i420 kernel launch failed: CUDA error {err}")
    launches.count(preprocess_i420)
    return out


def preprocess_i420(packed: torch.Tensor, hws: torch.Tensor, out_h: int, out_w: int,
                    mode: str = "inception",
                    out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[B, 3S/2, S] uint8 I420 canvases + [B, 2] int32 valid sizes →
    [B, out_h, out_w, 3] normalized, in ``out_dtype`` (float32 or bf16).

    Valid sizes must lie in [1, S]; the kernel clamps others so that no
    tap leaves the canvas (the plain version does not). Each canvas must
    be row-major; the images may sit at any stride.
    """
    _check(packed, hws, mode, out_dtype)
    if packed.device.type == "cpu":
        return preprocess_i420_plain(packed, hws, out_h, out_w, mode, out_dtype)
    if packed.device.type != "cuda":
        raise ValueError(f"preprocess_i420 runs on CUDA or CPU tensors, not {packed.device}")
    b, _, s = packed.shape
    if packed.stride(2) != 1 or packed.stride(1) != s:
        raise ValueError("each I420 canvas must be row-major contiguous")
    if hws.dtype != torch.int32 or hws.device != packed.device or not hws.is_contiguous():
        raise TypeError("hws must be a contiguous int32 tensor on the canvases' device")
    return _launch(packed, packed.stride(0), hws, b, s, out_h, out_w, mode, out_dtype)


def preprocess_i420_wire(buf: torch.Tensor, s: int, out_h: int, out_w: int,
                         mode: str = "inception",
                         out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The engine's wire buffer, uint8 [B, 1.5·S² + 4] (each row an I420
    canvas of side ``s``, then its big-endian u16 valid h and w) →
    [B, out_h, out_w, 3] normalized, in ``out_dtype``: :func:`preprocess_i420`
    with the trailer read inside the kernel, one launch in all. The kernel
    clamps trailer sizes to [1, S]; the plain version does not."""
    _check_wire(buf, s, mode, out_dtype)
    if buf.device.type == "cpu":
        return preprocess_i420_plain(wire_canvases(buf, s), decode_trailer(buf), out_h, out_w,
                                     mode, out_dtype)
    if buf.device.type != "cuda":
        raise ValueError(f"preprocess_i420_wire runs on CUDA or CPU tensors, not {buf.device}")
    if buf.stride(1) != 1:
        raise ValueError("each wire row must be contiguous")
    return _launch(buf, buf.stride(0), None, buf.shape[0], s, out_h, out_w, mode, out_dtype)


preprocess_i420.launches = 0
