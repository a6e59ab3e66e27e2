"""Image pipeline: host decode and padding (numpy), device resize and
normalize (torch). Counterpart of the JAX package's ``ops/image.py``.

The host does the one thing the device cannot do well — entropy-coded
JPEG/PNG decode — and pads the decoded uint8 image into a size-bucketed
square canvas (RGB, or packed I420 at 1.5 B/px on the yuv420 wire). The
device resizes from each image's valid (h, w) region, so canvas and output
shapes stay fixed per bucket while the valid size is data.

The device half here is plain torch: ``make_preprocess_fn`` with
``resize="matmul"`` is the separable bilinear resize as ``torch.matmul``
(the JAX package leaves this path to XLA). The fused I420 path with
``resize="kernel"`` lives in ``ops/preprocess_i420.py``.
"""

from __future__ import annotations

import io

import numpy as np
import torch

# --------------------------------------------------------------------------
# host side (numpy)
# --------------------------------------------------------------------------


def decode_image(data: bytes) -> np.ndarray:
    """Decode JPEG/PNG/... bytes → RGB uint8 array (host CPU, PIL)."""
    from PIL import Image

    img = Image.open(io.BytesIO(data))
    img = img.convert("RGB")
    return np.asarray(img, dtype=np.uint8)


def pick_bucket(size: int, buckets: tuple[int, ...]) -> int:
    for b in buckets:
        if size <= b:
            return b
    return buckets[-1]


def pad_to_canvas(img: np.ndarray, buckets: tuple[int, ...]) -> tuple[np.ndarray, tuple[int, int]]:
    """Pad (or downscale-then-pad) a decoded image into a square canvas.

    Returns (canvas uint8 [S, S, 3], (h, w) valid region). Images larger
    than the biggest bucket are downscaled on the host first.
    """
    h, w = img.shape[:2]
    s = pick_bucket(max(h, w), buckets)
    if max(h, w) > s:
        from PIL import Image

        scale = s / max(h, w)
        nh, nw = max(1, int(h * scale)), max(1, int(w * scale))
        img = np.asarray(Image.fromarray(img).resize((nw, nh), Image.BILINEAR), dtype=np.uint8)
        h, w = nh, nw
    canvas = np.zeros((s, s, 3), np.uint8)
    canvas[:h, :w] = img
    return canvas, (h, w)


# Full-range BT.601 (JPEG/JFIF): forward (RGB→YCbCr) and inverse.
BT601_FWD = (
    (0.299, 0.587, 0.114),
    (-0.168736, -0.331264, 0.5),
    (0.5, -0.418688, -0.081312),
)
BT601_INV = (1.402, -0.344136, -0.714136, 1.772)  # (kr_v, kg_u, kg_v, kb_u)


def rgb_to_yuv420_canvas(canvas: np.ndarray) -> np.ndarray:
    """RGB uint8 [S, S, 3] → I420 uint8 [3S/2, S].

    Layout: Y rows [0, S), then the (S/2, S/2) U and V planes, each stored
    as S/4 rows of S bytes. Chroma is 2×2 box-subsampled.
    """
    s = canvas.shape[0]
    if s % 4:
        raise ValueError(f"yuv420 canvas size must be a multiple of 4, got {s}")
    rgb = canvas.astype(np.float32)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    (yr, yg, yb), (ur, ug, ub), (vr, vg, vb) = BT601_FWD
    y = yr * r + yg * g + yb * b
    u = ur * r + ug * g + ub * b + 128.0
    v = vr * r + vg * g + vb * b + 128.0
    u = u.reshape(s // 2, 2, s // 2, 2).mean(axis=(1, 3))
    v = v.reshape(s // 2, 2, s // 2, 2).mean(axis=(1, 3))
    packed = np.empty((s * 3 // 2, s), np.uint8)
    packed[:s] = np.clip(y + 0.5, 0, 255).astype(np.uint8)
    packed[s : s + s // 4] = np.clip(u + 0.5, 0, 255).astype(np.uint8).reshape(s // 4, s)
    packed[s + s // 4 :] = np.clip(v + 0.5, 0, 255).astype(np.uint8).reshape(s // 4, s)
    return packed


# --------------------------------------------------------------------------
# device side (torch)
# --------------------------------------------------------------------------


def _dynamic_axis_coords(out_size: int, in_size: torch.Tensor, total: int):
    """Bilinear sample coordinates for valid extents ``in_size`` ([B] int)
    inside a canvas axis of length ``total`` (half-pixel centers).

    Returns float32 ``(lo, hi, frac)``, each [B, out_size]; ``lo``/``hi``
    are exact integers stored as float. Same formula as the reference:
    the divide comes first, ``c`` is clipped to [0, in - 1].
    """
    i = torch.arange(out_size, dtype=torch.float32, device=in_size.device)
    in_f = in_size.to(torch.float32)[:, None]
    # A true division: on CUDA, dividing by a Python scalar multiplies by
    # its reciprocal, which moves taps by an ulp (a visible error on
    # high-contrast canvases).
    scale = in_f / torch.full_like(in_f, float(out_size))
    c = (i + 0.5) * scale - 0.5
    c = torch.minimum(torch.maximum(c, torch.zeros_like(c)), in_f - 1.0)
    lo = torch.floor(c)
    hi = torch.minimum(torch.minimum(lo + 1.0, in_f - 1.0), torch.full_like(lo, total - 1))
    return lo, hi, c - lo


def _bilinear_matrix(out_size: int, in_size: torch.Tensor, total: int) -> torch.Tensor:
    """Dense [B, out_size, total] bilinear sampling matrices: each row holds
    the two taps for one output coordinate, so ``A @ x`` is the resize along
    that axis. ``hi == lo`` at the clamp edge adds, so rows sum to 1."""
    lo, hi, frac = _dynamic_axis_coords(out_size, in_size, total)
    cols = torch.arange(total, dtype=torch.float32, device=in_size.device)
    zero = torch.zeros((), dtype=torch.float32, device=in_size.device)
    a = torch.where(cols == lo[..., None], (1.0 - frac)[..., None], zero)
    return a + torch.where(cols == hi[..., None], frac[..., None], zero)


def _bilinear_matrix_chroma(out_size: int, in_size: torch.Tensor, total: int) -> torch.Tensor:
    """[B, out_size, total/2] matrices acting on a half-resolution chroma
    plane: the ×2 nearest upsample folded in (tap column px → px // 2;
    coinciding taps add)."""
    lo, hi, frac = _dynamic_axis_coords(out_size, in_size, total)
    cols = torch.arange(total // 2, dtype=torch.float32, device=in_size.device)
    zero = torch.zeros((), dtype=torch.float32, device=in_size.device)
    a = torch.where(cols == torch.floor(lo / 2)[..., None], (1.0 - frac)[..., None], zero)
    return a + torch.where(cols == torch.floor(hi / 2)[..., None], frac[..., None], zero)


def resize_from_valid_mm(canvases: torch.Tensor, hws: torch.Tensor, out_h: int, out_w: int):
    """Separable bilinear resize of each image's valid top-left region:
    ``A_h @ canvas @ A_w^T`` per channel.

    canvases: uint8/float [B, S, S, 3]; hws: int [B, 2] → float32
    [B, out_h, out_w, 3].
    """
    s = canvases.shape[1]
    a_h = _bilinear_matrix(out_h, hws[:, 0], s)  # [B, out_h, S]
    a_w = _bilinear_matrix(out_w, hws[:, 1], canvases.shape[2])  # [B, out_w, S]
    x = canvases.to(torch.float32).permute(0, 3, 1, 2)  # [B, 3, S, S]
    t = torch.matmul(a_h[:, None], x)  # [B, 3, out_h, S]
    out = torch.matmul(t, a_w[:, None].transpose(-1, -2))  # [B, 3, out_h, out_w]
    return out.permute(0, 2, 3, 1)


def _split_planes(packed: torch.Tensor):
    """I420 [B, 3S/2, S] uint8 → (y [B,S,S], u, v [B,S/2,S/2]) float32,
    chroma centered at 0 (the -128 offset folded in here)."""
    b, _, s = packed.shape
    y = packed[:, :s].to(torch.float32)
    u = packed[:, s : s + s // 4].reshape(b, s // 2, s // 2).to(torch.float32) - 128.0
    v = packed[:, s + s // 4 :].reshape(b, s // 2, s // 2).to(torch.float32) - 128.0
    return y, u, v


def _combine_rgb(y, u, v):
    kr, kgu, kgv, kb = BT601_INV
    r = y + kr * v
    g = y + kgu * u + kgv * v
    b = y + kb * u
    return torch.clamp(torch.stack([r, g, b], dim=-1), 0.0, 255.0)


def resize_yuv_planes(packed: torch.Tensor, hws: torch.Tensor, out_h: int, out_w: int):
    """I420 canvases [B, 3S/2, S] + valid hws → RGB float32 [B, out_h, out_w, 3].

    Resize the planes (chroma at half resolution), then convert and clip —
    the reference's order. Clipping does not commute with the resize on
    out-of-gamut YUV, so converting first would give another answer.
    """
    y, u, v = _split_planes(packed)
    s = y.shape[-1]
    a_h = _bilinear_matrix(out_h, hws[:, 0], s)
    a_w = _bilinear_matrix(out_w, hws[:, 1], s)
    a_hc = _bilinear_matrix_chroma(out_h, hws[:, 0], s)
    a_wc = _bilinear_matrix_chroma(out_w, hws[:, 1], s)
    rs = lambda a, p, b: a @ p @ b.transpose(-1, -2)
    return _combine_rgb(rs(a_h, y, a_w), rs(a_hc, u, a_wc), rs(a_hc, v, a_wc))


_CAFFE_MEAN = (103.939, 116.779, 123.68)

NORMALIZERS = {
    "inception": lambda x: x / 127.5 - 1.0,  # [-1, 1]; Inception/MobileNet family
    "zero_one": lambda x: x / 255.0,
    # Caffe-style ResNet-50: RGB→BGR + per-channel mean subtraction.
    "caffe": lambda x: x.flip(-1) - torch.tensor(_CAFFE_MEAN, dtype=torch.float32, device=x.device),
    "raw": lambda x: x,
}


def make_preprocess_fn(out_h: int, out_w: int, mode: str, wire: str = "rgb",
                       resize: str = "matmul", out_dtype: torch.dtype = torch.float32):
    """Preprocess callable ``(canvases, hws) → [B, out_h, out_w, 3]`` in
    ``out_dtype``.

    ``wire`` selects the canvas encoding: "rgb" takes uint8 [B, S, S, 3];
    "yuv420" takes packed I420 uint8 [B, 3S/2, S]. ``resize="matmul"`` is
    the plain-torch separable resize in float32, then a cast;
    ``resize="kernel"`` (yuv420 only) launches the fused CUDA kernel on
    CUDA tensors, which stores ``out_dtype`` itself.
    """
    if wire not in ("rgb", "yuv420"):
        raise ValueError(f"unknown wire format {wire!r}")
    if mode not in NORMALIZERS:
        raise ValueError(f"unknown normalize mode {mode!r}")
    if resize == "kernel":
        if wire != "yuv420":
            raise ValueError("resize='kernel' requires the yuv420 wire")
        from .preprocess_i420 import preprocess_i420

        return lambda packed, hws: preprocess_i420(packed, hws, out_h, out_w, mode, out_dtype)
    if resize != "matmul":
        raise ValueError(f"unknown resize {resize!r}")
    norm = NORMALIZERS[mode]
    if wire == "yuv420":
        return lambda packed, hws: norm(resize_yuv_planes(packed, hws, out_h, out_w)).to(
            out_dtype)
    return lambda canvases, hws: norm(resize_from_valid_mm(canvases, hws, out_h, out_w)).to(
        out_dtype)
