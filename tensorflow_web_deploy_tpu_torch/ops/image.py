"""Image pipeline: host decode and padding (numpy), device resize and
normalize (torch). Counterpart of the JAX package's ``ops/image.py``.

The host does the one thing the device cannot do well — entropy-coded
JPEG/PNG decode — and pads the decoded uint8 image into a size-bucketed
square canvas (RGB, or packed I420 at 1.5 B/px on the yuv420 wire). The
device resizes from each image's valid (h, w) region, so canvas and output
shapes stay fixed per bucket while the valid size is data.

On the ragged wire the host ships each image tight (``fit_to_bucket``,
or the native decoder's tight rows) in one flat byte arena, and the device
rebuilds the canvases before the resize: ``unpack_ragged``, one launch of
the hand-written kernel ``csrc/unpack_ragged.cu`` on the card.

The rest of the device half is plain torch, as XLA ran it for the JAX package:
``make_preprocess_fn`` with ``resize="matmul"`` is the separable bilinear
resize as ``torch.matmul``, with ``resize="gather"`` the same taps read by
index (``resize_from_valid``). The fused I420 path with
``resize="kernel"`` lives in ``ops/preprocess_i420.py``. With ``s2d`` the
preprocess emits the stem's space-to-depth cells (``ops/stem.py``): the
yuv420 matmul resize writes them from its plane-wise matmuls
(``resize_yuv_planes_s2d``), the other resizes fold their output.
"""

from __future__ import annotations

import ctypes
import io

import numpy as np
import torch

from . import launches

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


def check_ragged_rows(meta: np.ndarray, s: int, arena_bytes: int) -> None:
    """Raise ValueError on a valid meta row (int32 [K, 4] on the host) that
    does not fit a canvas of side ``s`` or an arena of ``arena_bytes``."""
    for i, (off, h, w, valid) in enumerate(np.asarray(meta).tolist()):
        if valid > 0 and not (0 < h <= s and 0 < w <= s and 0 <= off
                              and off + h * w * 3 <= arena_bytes):
            raise ValueError(f"ragged row {i} (offset {off}, {h}x{w}) does not fit a "
                             f"{s} canvas in a {arena_bytes}-byte arena")


def unpack_ragged_plain(arena: torch.Tensor, meta: torch.Tensor, s: int
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`unpack_ragged` in plain torch, the reference's form: a masked
    gather with static shapes (one index per canvas byte, clipped into the
    arena, then a select). Checks the rows first (:func:`check_ragged_rows`,
    which reads ``meta`` on the host)."""
    flat = arena.reshape(-1)
    n = flat.numel()
    check_ragged_rows(meta.cpu().numpy(), s, n)
    if n == 0:  # nothing to gather from: every row is a hole
        flat, n = torch.zeros(1, dtype=torch.uint8, device=flat.device), 1
    dev = flat.device
    m = meta.to(torch.int64)[:, :, None, None, None]  # [K, 4, 1, 1, 1]
    off, h, w, valid = m[:, 0], m[:, 1], m[:, 2], m[:, 3]
    y = torch.arange(s, device=dev)[:, None, None]
    x = torch.arange(s, device=dev)[None, :, None]
    c = torch.arange(3, device=dev)[None, None, :]
    idx = off + (y * w + x) * 3 + c  # [K, s, s, 3]
    px = flat[idx.clamp(0, n - 1)]
    canvases = torch.where((valid > 0) & (y < h) & (x < w), px, torch.zeros_like(px))
    hws = torch.where(meta[:, 3:4] > 0, meta[:, 1:3], torch.ones_like(meta[:, 1:3]))
    return canvases, hws.to(torch.int32)


_unpack_fn = None  # the C entry, resolved once per process


def _unpack_kernel():
    global _unpack_fn
    if _unpack_fn is None:
        from . import _build

        fn = _build.load("unpack_ragged").twd_unpack_ragged
        fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _unpack_fn = fn
    return _unpack_fn


def unpack_ragged(arena: torch.Tensor, meta: torch.Tensor, s: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Flat ragged byte arena + per-image meta → canvases as the classic
    wire would have shipped them.

    ``arena``: uint8, any shape (flattened); image ``i``'s pixel (y, x, c)
    is byte ``meta[i, 0] + (y * w + x) * 3 + c``. ``meta``: int32 [K, 4]
    rows ``(byte_offset, h, w, valid)`` on the arena's device; a hole
    (``valid = 0``) is a zero canvas with hw (1, 1).

    Returns (canvases uint8 [K, s, s, 3], hws int32 [K, 2]), bit-identical
    to :func:`pad_to_canvas` of the same pixels. On CUDA tensors, one launch
    of the hand-written kernel in ``csrc/unpack_ragged.cu``, which reads the
    meta table on the device (no host copy, so a CUDA graph can capture it)
    and writes a row that does not fit as a hole: callers check the rows on
    the host (:func:`check_ragged_rows`; the engine does at dispatch). On CPU
    tensors, :func:`unpack_ragged_plain`, which checks them and raises
    ValueError. ``unpack_ragged.launches`` counts kernel launches.
    """
    if arena.device.type == "cpu":
        return unpack_ragged_plain(arena, meta, s)
    if arena.device.type != "cuda":
        raise ValueError(f"unpack_ragged runs on CUDA or CPU tensors, not {arena.device}")
    if arena.dtype != torch.uint8 or not arena.is_contiguous() or arena.data_ptr() % 4:
        raise TypeError("arena must be a contiguous, 4-byte aligned uint8 tensor")
    if (meta.dtype != torch.int32 or meta.dim() != 2 or meta.shape[1] != 4
            or not meta.is_contiguous() or meta.device != arena.device):
        raise TypeError("meta must be a contiguous int32 [K, 4] tensor on the arena's device")
    k = meta.shape[0]
    if k > 65535 or s < 1:
        raise ValueError(f"the kernel takes at most 65535 images of canvas side >= 1, got {k}, {s}")
    canvases = torch.empty((k, s, s, 3), dtype=torch.uint8, device=arena.device)
    hws = torch.empty((k, 2), dtype=torch.int32, device=arena.device)
    if k == 0:
        return canvases, hws
    stream = torch._C._cuda_getCurrentRawStream(arena.device.index)
    err = _unpack_kernel()(arena.data_ptr(), arena.numel(), meta.data_ptr(), canvases.data_ptr(),
                           hws.data_ptr(), k, s, stream)
    if err != 0:
        raise RuntimeError(f"unpack_ragged kernel launch failed: CUDA error {err}")
    launches.count(unpack_ragged)
    return canvases, hws


unpack_ragged.launches = 0


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


def _fold_chroma(a: torch.Tensor) -> torch.Tensor:
    """[..., out, S] sampling matrices → [..., out, S/2] acting on the
    half-resolution plane: ``A @ R`` with R the ×2 nearest upsample, exact
    (each pair of columns summed)."""
    return a.unflatten(-1, (a.shape[-1] // 2, 2)).sum(-1)


def _bilinear_matrix_chroma_packed(out_size: int, in_size: torch.Tensor, total: int
                                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The chroma matrices split onto the wire's packed chroma rows. The
    canvas stores an (S/2, S/2) chroma plane as (S/4, S) rows: packed row k
    holds plane rows 2k (columns [0, S/2)) and 2k + 1 ([S/2, S)). Returns
    ``(even, odd)``, each [B, out_size, S/4], with ``A_c @ plane == even @
    rows[:, :S/2] + odd @ rows[:, S/2:]`` exactly (the same two taps a row,
    zeros elsewhere) — the reference's form for its Pallas kernel."""
    lo, hi, frac = _dynamic_axis_coords(out_size, in_size, total)
    rl, rh = torch.floor(lo / 2)[..., None], torch.floor(hi / 2)[..., None]
    cols4 = torch.arange(total // 4, dtype=torch.float32, device=in_size.device)
    zero = torch.zeros((), dtype=torch.float32, device=in_size.device)
    a, c = (1.0 - frac)[..., None], frac[..., None]

    def taps(col):
        return torch.where(col == rl, a, zero) + torch.where(col == rh, c, zero)

    return taps(2 * cols4), taps(2 * cols4 + 1)


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


def _s2d_pair(a: torch.Tensor, out: int) -> torch.Tensor:
    """Sampling matrices [B, out, S] → [B, ⌈out/2⌉, 2, S]: rows regrouped
    into (cell, phase), a zero row appended for an odd ``out`` (the stem's
    kernel has zero taps there)."""
    cells = (out + 1) // 2
    a = torch.nn.functional.pad(a, (0, 0, 0, 2 * cells - out))
    return a.unflatten(1, (cells, 2))


def resize_yuv_planes_s2d(packed: torch.Tensor, hws: torch.Tensor, out_h: int, out_w: int,
                          mode: str) -> torch.Tensor:
    """The plane resize emitting the stem's cells: I420 [B, 3S/2, S] →
    normalized float32 [B, ⌈out_h/2⌉, ⌈out_w/2⌉, 12], channels (p, q, rgb)
    with rgb fastest — ``pack_s2d(NORMALIZERS[mode](resize_yuv_planes(...)))``
    with the fold written by the matmuls (rows regrouped by phase). The
    normalize runs before the channels merge, so caffe's BGR flip acts on
    each rgb triple; the phase row or column an odd extent lacks holds
    literal zeros (the pack_s2d convention), not a normalized zero."""
    y, u, v = _split_planes(packed)
    b, s = y.shape[0], y.shape[-1]
    ah = _s2d_pair(_bilinear_matrix(out_h, hws[:, 0], s), out_h)  # [B, ch, 2, S]
    aw = _s2d_pair(_bilinear_matrix(out_w, hws[:, 1], s), out_w)  # [B, cw, 2, S]
    ahc, awc = _fold_chroma(ah), _fold_chroma(aw)
    ch, cw = ah.shape[1], aw.shape[1]

    def rs(a3, p, b3):  # [B, ch, 2, n] @ [B, n, m] @ [B, cw, 2, m]^T → [B, ch, cw, 2, 2]
        t = a3.flatten(1, 2) @ p @ b3.flatten(1, 2).transpose(-1, -2)  # [B, 2ch, 2cw]
        return t.unflatten(1, (ch, 2)).unflatten(3, (cw, 2)).permute(0, 1, 3, 2, 4)

    rgb = NORMALIZERS[mode](_combine_rgb(rs(ah, y, aw), rs(ahc, u, awc), rs(ahc, v, awc)))
    if out_h % 2 or out_w % 2:
        keep = torch.ones((ch, cw, 2, 2, 1), dtype=rgb.dtype, device=rgb.device)
        if out_h % 2:
            keep[-1, :, 1] = 0.0
        if out_w % 2:
            keep[:, -1, :, 1] = 0.0
        rgb = rgb * keep
    return rgb.reshape(b, ch, cw, 12)


_CAFFE_MEAN = (103.939, 116.779, 123.68)

def _divide(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` as a true float32 division on every device: on CUDA, torch
    divides by a Python scalar (or a CPU scalar) as a multiply by its
    reciprocal, an ulp off IEEE division for most values; by a 0-dim tensor
    on ``x``'s own device it divides. The divisor is filled on the device
    (no host copy, so a CUDA graph can capture it)."""
    return x / torch.full((), d, dtype=torch.float32, device=x.device)


def _caffe_mean(device: torch.device) -> torch.Tensor:
    """The caffe means as a float32 [3] tensor filled on the device (no host
    copy, so a CUDA graph can capture it)."""
    return torch.stack([torch.full((), m, dtype=torch.float32, device=device)
                        for m in _CAFFE_MEAN])


NORMALIZERS = {
    "inception": lambda x: _divide(x, 127.5) - 1.0,  # [-1, 1]; Inception/MobileNet family
    "zero_one": lambda x: _divide(x, 255.0),
    # Caffe-style ResNet-50: RGB→BGR + per-channel mean subtraction.
    "caffe": lambda x: x.flip(-1) - _caffe_mean(x.device),
    "raw": lambda x: x,
}


def make_preprocess_fn(out_h: int, out_w: int, mode: str, wire: str = "rgb",
                       resize: str = "matmul", out_dtype: torch.dtype = torch.float32,
                       s2d: bool = False):
    """Preprocess callable ``(canvases, hws) → [B, out_h, out_w, 3]`` in
    ``out_dtype``; with ``s2d``, the stem's cells [B, ⌈out_h/2⌉,
    ⌈out_w/2⌉, 12] (``ops/stem.py::pack_s2d``'s layout) for a model built
    with ``input_format="s2d"``: the yuv420 matmul resize writes them
    directly, the kernel stores them, the other paths fold their output.

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

        return lambda packed, hws: preprocess_i420(packed, hws, out_h, out_w, mode, out_dtype,
                                                   s2d)
    if resize not in RESIZERS:
        raise ValueError(f"unknown resize {resize!r}")
    norm = NORMALIZERS[mode]
    if wire == "yuv420" and resize == "matmul":
        if s2d:
            return lambda packed, hws: resize_yuv_planes_s2d(packed, hws, out_h, out_w,
                                                             mode).to(out_dtype)
        return lambda packed, hws: norm(resize_yuv_planes(packed, hws, out_h, out_w)).to(
            out_dtype)
    from .stem import pack_s2d

    fold = pack_s2d if s2d else (lambda x: x)
    resize_one = RESIZERS[resize]
    if wire == "yuv420":  # gather: convert to RGB first, as the reference does
        return lambda packed, hws: fold(norm(resize_one(
            yuv420_to_rgb(packed, packed.shape[-1]), hws, out_h, out_w)).to(out_dtype))
    return lambda canvases, hws: fold(norm(resize_one(canvases, hws, out_h, out_w)).to(
        out_dtype))
