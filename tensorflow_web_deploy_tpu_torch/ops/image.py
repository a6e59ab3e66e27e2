"""Image pipeline: host decode and padding (numpy), device resize and
normalize (torch). Counterpart of the JAX package's ``ops/image.py``.

The host does the one thing the device cannot do well — entropy-coded
JPEG/PNG decode — and pads the decoded uint8 image into a size-bucketed
square canvas (RGB, or packed I420 at 1.5 B/px on the yuv420 wire). The
device resizes from each image's valid (h, w) region, so canvas and output
shapes stay fixed per bucket while the valid size is data.

On the ragged wire the host ships each image tight (``fit_to_bucket``,
or the native decoder's tight rows) in one flat byte arena, and the device
rebuilds the canvases (``unpack_ragged``) before the resize.

The device half here is plain torch, as XLA ran it for the JAX package:
``make_preprocess_fn`` with ``resize="matmul"`` is the separable bilinear
resize as ``torch.matmul``, with ``resize="gather"`` the same taps read by
index (``resize_from_valid``). The fused I420 path with
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


def fit_to_bucket(img: np.ndarray, buckets: tuple[int, ...]
                  ) -> tuple[np.ndarray, tuple[int, int], int]:
    """Tight sibling of :func:`pad_to_canvas` for the ragged wire: pick the
    canvas bucket and downscale an oversized image to fit it, without
    padding. Returns (tight uint8 [h, w, 3], (h, w), canvas bucket side)."""
    h, w = img.shape[:2]
    s = pick_bucket(max(h, w), buckets)
    if max(h, w) > s:
        from PIL import Image

        scale = s / max(h, w)
        nh, nw = max(1, int(h * scale)), max(1, int(w * scale))
        img = np.asarray(Image.fromarray(img).resize((nw, nh), Image.BILINEAR), dtype=np.uint8)
        h, w = nh, nw
    return np.ascontiguousarray(img, dtype=np.uint8), (h, w), s


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

# The ragged wire's layout version (the reference's RAGGED_UNPACK_VERSION):
# the arena holds each image's tight rows back to back, and meta row i is
# (byte_offset, h, w, valid) with valid = 0 for a hole.
RAGGED_UNPACK_VERSION = 1


def unpack_ragged(arena: torch.Tensor, meta: torch.Tensor, s: int,
                  meta_host: np.ndarray | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Flat ragged byte arena + per-image meta → canvases as the classic
    wire would have shipped them.

    ``arena``: uint8, any shape (flattened); image ``i``'s pixel (y, x, c)
    is byte ``meta[i, 0] + (y * w + x) * 3 + c``. ``meta``: int32 [K, 4]
    rows ``(byte_offset, h, w, valid)`` on the arena's device; a hole
    (``valid = 0``) is a zero canvas with hw (1, 1). ``meta_host``: the same
    table on the host, where the copies are planned (default: ``meta``
    read back, which waits for the device).

    Returns (canvases uint8 [K, s, s, 3], hws int32 [K, 2]), bit-identical
    to :func:`pad_to_canvas` of the same pixels: one zero fill, one copy of
    each image's h·w·3 bytes into its canvas (a copy, no resample; no
    per-element index is built), and a few small kernels for the hws.
    Raises ValueError on a row that does not fit the canvas or the arena.
    """
    flat = arena.reshape(-1)
    table = meta.cpu().numpy() if meta_host is None else np.asarray(meta_host)
    canvases = torch.zeros((table.shape[0], s, s, 3), dtype=torch.uint8, device=flat.device)
    for i, (off, h, w, valid) in enumerate(table.tolist()):
        if valid <= 0:
            continue
        if not (0 < h <= s and 0 < w <= s and 0 <= off and off + h * w * 3 <= flat.numel()):
            raise ValueError(f"ragged row {i} (offset {off}, {h}x{w}) does not fit a "
                             f"{s} canvas in a {flat.numel()}-byte arena")
        canvases[i, :h, :w] = flat[off : off + h * w * 3].view(h, w, 3)
    hws = torch.where(meta[:, 3:4] > 0, meta[:, 1:3], 1)
    return canvases, hws.to(torch.int32)


def yuv420_to_rgb(packed: torch.Tensor, s: int) -> torch.Tensor:
    """I420 uint8 [B, 3S/2, S] → RGB float32 [B, S, S, 3], clipped to
    [0, 255]; chroma upsampled ×2 by nearest neighbour (the reference's
    order of operations)."""
    b = packed.shape[0]
    y = packed[:, :s].to(torch.float32)
    u = packed[:, s : s + s // 4].reshape(b, s // 2, s // 2).to(torch.float32) - 128.0
    v = packed[:, s + s // 4 :].reshape(b, s // 2, s // 2).to(torch.float32) - 128.0
    up = lambda p: p.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)  # noqa: E731
    return _combine_rgb(y, up(u), up(v))


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


def resize_from_valid(canvases: torch.Tensor, hws: torch.Tensor, out_h: int, out_w: int):
    """Bilinear resize of each image's valid top-left region by gathering
    its two taps per axis ("gather"): rows first, then columns, each as
    ``x[lo] * (1 - frac) + x[hi] * frac`` in separate float32 operations,
    the reference's order.

    canvases: uint8/float [B, S, S, 3]; hws: int [B, 2] → float32
    [B, out_h, out_w, 3].
    """
    x = canvases.to(torch.float32)
    h_lo, h_hi, h_f = _dynamic_axis_coords(out_h, hws[:, 0], canvases.shape[1])  # [B, out_h]
    w_lo, w_hi, w_f = _dynamic_axis_coords(out_w, hws[:, 1], canvases.shape[2])  # [B, out_w]
    b = torch.arange(x.shape[0], device=x.device)[:, None]
    h_f = h_f[:, :, None, None]
    top = x[b, h_lo.long()] * (1.0 - h_f) + x[b, h_hi.long()] * h_f  # [B, out_h, S, 3]
    top = top.transpose(1, 2)  # [B, S, out_h, 3]: the gathered axis first
    w_f = w_f[:, :, None, None]
    out = top[b, w_lo.long()] * (1.0 - w_f) + top[b, w_hi.long()] * w_f  # [B, out_w, out_h, 3]
    return out.transpose(1, 2)


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


RESIZERS = {"gather": resize_from_valid, "matmul": resize_from_valid_mm}


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
    the plain-torch separable resize in float32, then a cast (on yuv420,
    plane by plane, converting after); ``resize="gather"`` reads the taps
    by index (on yuv420, converting to RGB first, as the reference does);
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
    if resize not in RESIZERS:
        raise ValueError(f"unknown resize {resize!r}")
    norm = NORMALIZERS[mode]
    if wire == "yuv420" and resize == "matmul":
        return lambda packed, hws: norm(resize_yuv_planes(packed, hws, out_h, out_w)).to(
            out_dtype)
    resize_one = RESIZERS[resize]
    if wire == "yuv420":  # gather: convert to RGB first, as the reference does
        return lambda packed, hws: norm(resize_one(
            yuv420_to_rgb(packed, packed.shape[-1]), hws, out_h, out_w)).to(out_dtype)
    return lambda canvases, hws: norm(resize_one(canvases, hws, out_h, out_w)).to(out_dtype)
