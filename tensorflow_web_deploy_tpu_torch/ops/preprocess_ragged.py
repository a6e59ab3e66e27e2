"""The ragged rgb wire's whole preprocess stage in one launch: the ragged
byte arena and its meta table → valid-region bilinear resize → normalize,
stored in the serving dtype.

:func:`preprocess_ragged` launches the hand-written kernel in
``csrc/preprocess_ragged.cu`` (built at first use by ``ops/_build.py``) on
CUDA tensors. It stands for three steps of the JAX package, none of them a
Pallas kernel: ``ops/image.py::unpack_ragged`` (the canvases rebuilt from
the arena), the rgb matmul resize (``_bilinear_matrix``,
``resize_from_valid_mm``) and the normalize of ``make_preprocess_fn``. The
kernel reads each tap row straight from the arena, so no canvas is
written. On CPU tensors it runs :func:`preprocess_ragged_plain`, that
composition in plain torch. There is no fallback from one to the other: a
CUDA tensor gets the kernel or an error.

:func:`launch_shape` picks the kernel's band height from the shapes
alone. ``preprocess_ragged.launches`` counts kernel launches (plain-version
calls are not counted), so a caller can show that a run went through the
kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build, launches
from .image import make_preprocess_fn, unpack_ragged_plain
from .preprocess_i420 import _sm_count

MODES = {"inception": 0, "zero_one": 1, "raw": 2, "caffe": 3}
OUT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# The kernel's limits (csrc/preprocess_ragged.cu): output rows per band,
# canvas side, dynamic shared memory per block, images.
MAX_ROWS = 32
MAX_SIDE = 8192
MAX_SMEM = 224 * 1024
MAX_IMAGES = 65535
# The launch rule (launch_shape), the yuv420 kernel's (ops/preprocess_i420.py)
# with room for an rgb row's three bytes a pixel (the kernel's blocks have
# 128 threads): bands of at most ROWS_CAP rows, halved until the grid gives
# BLOCKS_PER_SM blocks per SM and a block's shared memory fits SMEM_BUDGET.
ROWS_CAP = 4
BLOCKS_PER_SM = 2
SMEM_BUDGET = 32 * 1024


def _align16(x: int) -> int:
    return (x + 15) // 16 * 16


class LaunchShape(NamedTuple):
    """The kernel's tiling of one call: a block computes ``rows`` whole
    output rows of one image."""

    rows: int

    def bands(self, out_h: int) -> int:
        return -(-out_h // self.rows)

    def blocks(self, k: int, out_h: int) -> int:
        return k * self.bands(out_h)

    def smem(self, s: int, out_w: int, elt: int) -> int:
        """Bytes of a block's dynamic shared memory (the kernel's
        ``Layout``): the column taps (16 bytes an output column), 2·rows
        staged source rows of 3·S bytes (each with room for its start's
        offset from a 16-byte boundary), and the output band at its
        address mod 16."""
        cols = _align16(16 * out_w)
        staged = 2 * self.rows * _align16(3 * s + 15)
        return cols + staged + _align16(self.rows * out_w * 3 * elt + 16)


def launch_shape(k: int, s: int, out_h: int, out_w: int, elt: int, sms: int) -> LaunchShape:
    """The kernel's tiling for one call, from its shapes alone (see the
    rule's constants above)."""
    shape = LaunchShape(ROWS_CAP)
    while shape.rows > 1 and (shape.blocks(k, out_h) < BLOCKS_PER_SM * sms
                              or shape.smem(s, out_w, elt) > SMEM_BUDGET):
        shape = shape._replace(rows=shape.rows // 2)
    return shape


def _check(arena: torch.Tensor, meta: torch.Tensor, s: int, mode: str,
           out_dtype: torch.dtype) -> None:
    if mode not in MODES:
        raise ValueError(f"unsupported normalize mode for the ragged preprocess: {mode}")
    if out_dtype not in OUT_DTYPES:
        raise ValueError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    if arena.dtype != torch.uint8:
        raise TypeError(f"the arena must be uint8, got {arena.dtype}")
    if meta.dtype != torch.int32 or meta.dim() != 2 or meta.shape[1] != 4:
        raise TypeError(f"meta must be an int32 [K, 4] table, got {meta.dtype} "
                        f"{tuple(meta.shape)}")
    if not 1 <= s <= MAX_SIDE:
        raise ValueError(f"canvas side must lie in [1, {MAX_SIDE}], got {s}")


def preprocess_ragged_plain(arena: torch.Tensor, meta: torch.Tensor, s: int, out_h: int,
                            out_w: int, mode: str = "inception",
                            out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain-torch version: :func:`unpack_ragged_plain` (which checks the
    rows on the host and raises ValueError on one that does not fit), then
    the rgb matmul preprocess of ``make_preprocess_fn``."""
    _check(arena, meta, s, mode, out_dtype)
    return make_preprocess_fn(out_h, out_w, mode, wire="rgb", resize="matmul",
                              out_dtype=out_dtype)(*unpack_ragged_plain(arena, meta, s))


@functools.lru_cache(maxsize=None)
def _rule(k: int, s: int, out_h: int, out_w: int, elt: int, device: int) -> LaunchShape:
    return launch_shape(k, s, out_h, out_w, elt, _sm_count(device))


_kernel_fn = None  # the C entry, resolved once per process


def _kernel():
    global _kernel_fn
    if _kernel_fn is None:
        fn = _build.load("preprocess_ragged").twd_preprocess_ragged
        fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
                       *[ctypes.c_int] * 7, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _kernel_fn = fn
    return _kernel_fn


def preprocess_ragged(arena: torch.Tensor, meta: torch.Tensor, s: int, out_h: int, out_w: int,
                      mode: str = "inception",
                      out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Ragged arena + meta table → [K, out_h, out_w, 3] normalized, in
    ``out_dtype`` (float32 or bf16).

    ``arena``: uint8, contiguous (flattened); image ``i``'s pixel (y, x, c)
    is byte ``meta[i, 0] + (y·w + x)·3 + c``. ``meta``: int32 [K, 4] rows
    ``(byte_offset, h, w, valid)`` on the arena's device; a hole (``valid
    = 0``) gives what a zero 1 × 1 image gives. ``s``: the canvas side the
    valid sizes must fit. ``mode``: inception, zero_one, raw or caffe.

    On CUDA tensors, one launch of the kernel, which needs a 16-byte
    aligned arena, reads the meta table on the device (no host copy, so a
    CUDA graph can capture it) and treats a row that does not fit as a
    hole: callers check the rows on the host (``check_ragged_rows``; the
    engine does at dispatch). On CPU tensors, :func:`preprocess_ragged_plain`,
    which checks them and raises.
    """
    _check(arena, meta, s, mode, out_dtype)
    if arena.device.type == "cpu":
        return preprocess_ragged_plain(arena, meta, s, out_h, out_w, mode, out_dtype)
    if arena.device.type != "cuda":
        raise ValueError(f"preprocess_ragged runs on CUDA or CPU tensors, not {arena.device}")
    if not arena.is_contiguous() or arena.data_ptr() % 16:
        raise TypeError("the arena must be a contiguous, 16-byte aligned uint8 tensor")
    if not meta.is_contiguous() or meta.device != arena.device:
        raise TypeError("meta must be a contiguous int32 [K, 4] tensor on the arena's device")
    k = meta.shape[0]
    if k > MAX_IMAGES:
        raise ValueError(f"the kernel takes at most {MAX_IMAGES} images, got {k}")
    dev = arena.device
    out = torch.empty((k, out_h, out_w, 3), dtype=out_dtype, device=dev)
    if out.numel() == 0:
        return out
    shape = _rule(k, s, out_h, out_w, out.element_size(), dev.index)
    # the raw current stream, as torch's own kernel launchers take it
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    err = _kernel()(arena.data_ptr(), arena.numel(), meta.data_ptr(), out.data_ptr(),
                    OUT_DTYPES[out_dtype], k, s, out_h, out_w, MODES[mode], shape.rows, stream)
    if err != 0:
        raise RuntimeError(f"preprocess_ragged kernel launch failed: CUDA error {err}")
    launches.count(preprocess_ragged)
    return out


preprocess_ragged.launches = 0
