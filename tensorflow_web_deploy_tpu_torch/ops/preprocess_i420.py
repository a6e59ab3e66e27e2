"""Fused I420 → RGB → valid-region bilinear resize → normalize.

The port of the JAX package's Pallas kernel
``ops/pallas_preprocess.py::preprocess_i420``. On a CUDA tensor
:func:`preprocess_i420` launches the hand-written kernel in
``csrc/preprocess_i420.cu`` (built at first use by ``ops/_build.py``); on a
CPU tensor it runs :func:`preprocess_i420_plain`, the same function in
plain torch. There is no fallback from one to the other: a CUDA tensor
gets the kernel or an error.

``preprocess_i420.launches`` counts kernel launches (plain-version calls
are not counted), so a caller can show that a run went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .image import NORMALIZERS, resize_yuv_planes

MODES = {"inception": 0, "zero_one": 1, "raw": 2}


def _check(packed: torch.Tensor, hws: torch.Tensor, mode: str) -> None:
    if packed.dim() != 3 or packed.shape[1] != packed.shape[2] * 3 // 2 or packed.shape[2] % 4:
        raise ValueError(f"not an I420 canvas batch: {tuple(packed.shape)}")
    if mode not in MODES:
        raise ValueError(f"unsupported normalize mode for the preprocess kernel: {mode}")
    if hws.shape != (packed.shape[0], 2):
        raise ValueError(f"hws must be [B, 2] for B={packed.shape[0]}, got {tuple(hws.shape)}")


def preprocess_i420_plain(packed: torch.Tensor, hws: torch.Tensor, out_h: int, out_w: int,
                          mode: str = "inception") -> torch.Tensor:
    """Plain-torch version: ``resize_yuv_planes`` + ``NORMALIZERS[mode]``."""
    _check(packed, hws, mode)
    return NORMALIZERS[mode](resize_yuv_planes(packed, hws, out_h, out_w))


def _launch(packed: torch.Tensor, hws: torch.Tensor, out_h: int, out_w: int,
            mode: str) -> torch.Tensor:
    if packed.dtype != torch.uint8:
        raise TypeError(f"packed must be uint8, got {packed.dtype}")
    if hws.dtype != torch.int32 or hws.device != packed.device or not hws.is_contiguous():
        raise TypeError("hws must be a contiguous int32 tensor on the canvases' device")
    # Each image's plane rows must be contiguous; images may sit at any
    # stride (the engine passes views into its packed wire buffer).
    b, rows, s = packed.shape
    if packed.stride(2) != 1 or packed.stride(1) != s:
        raise ValueError("each I420 canvas must be row-major contiguous")
    fn = _build.load("preprocess_i420").twd_preprocess_i420
    if fn.argtypes is None:  # declare the C signature once
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    out = torch.empty((b, out_h, out_w, 3), dtype=torch.float32, device=packed.device)
    if b == 0:
        return out
    stream = torch.cuda.current_stream(packed.device).cuda_stream
    err = fn(packed.data_ptr(), packed.stride(0), hws.data_ptr(), out.data_ptr(),
             b, s, out_h, out_w, MODES[mode], stream)
    if err != 0:
        raise RuntimeError(f"preprocess_i420 kernel launch failed: CUDA error {err}")
    preprocess_i420.launches += 1
    return out


def preprocess_i420(packed: torch.Tensor, hws: torch.Tensor, out_h: int, out_w: int,
                    mode: str = "inception") -> torch.Tensor:
    """[B, 3S/2, S] uint8 I420 canvases + [B, 2] int32 valid sizes →
    [B, out_h, out_w, 3] normalized float32.

    Valid sizes must lie in [1, S]; the kernel clamps others so that no
    tap leaves the canvas (the plain version does not).
    """
    _check(packed, hws, mode)
    if packed.device.type == "cpu":
        return preprocess_i420_plain(packed, hws, out_h, out_w, mode)
    if packed.device.type != "cuda":
        raise ValueError(f"preprocess_i420 runs on CUDA or CPU tensors, not {packed.device}")
    return _launch(packed, hws, out_h, out_w, mode)


preprocess_i420.launches = 0
