"""Native host decode: libjpeg → wire bytes, through ctypes (counterpart
of the JAX package's ``native/``, with its own copy of ``decode.c``).

JPEG decode is the one compute stage of the request path that stays on
the host. ``decode.c`` drives libjpeg straight into the engine's wire
formats (an RGB canvas, a packed I420 canvas with its optional trailer, or
the tight rows of the ragged wire), with DCT-domain downscaling for
oversized uploads. The library is a ``ctypes.CDLL``, which releases the
interpreter lock for every call, so the server's request threads decode in
parallel.

The library is built at first use with the system C compiler (``cc``, or
``$CC``) into ``tensorflow_web_deploy_tpu_torch/.build/`` (listed in
``.gitignore``), under a name that hashes the source and the libjpeg it
links; ``python -m tensorflow_web_deploy_tpu_torch.native.build``
prebuilds it. Two routes, in order:

1. the system's libjpeg: ``cc … decode.c -ljpeg``;
2. where the system has no libjpeg (no header or no library), the libjpeg
   that the installed Pillow bundles (``pillow.libs/libjpeg*.so.62*``),
   compiled against the headers copied into ``native/include/`` and
   linked by its full path with an rpath to its directory.

Where neither route builds and loads (no C compiler, no libjpeg), the
decoder is unavailable: every call here returns None, the callers decode
with PIL, and :func:`status` says why. Any other build failure is a
fault and raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

from ..ops.image import pick_bucket
from ..utils.locks import named_lock

log = logging.getLogger("tpu_serve_torch.native")

_SRC = Path(__file__).resolve().parent / "decode.c"
_INCLUDE = Path(__file__).resolve().parent / "include"
BUILD_DIR = Path(__file__).resolve().parent.parent / ".build"
SYSTEM = "system -ljpeg"  # status()["library"] of the first route
# compiler messages that mean libjpeg itself is missing, not a fault
_NO_LIBJPEG = ("jpeglib.h: No such file", "cannot find -ljpeg", "unable to find library -ljpeg")

_lock = named_lock("native.build_lock")  # one build and load per process
_lib: ctypes.CDLL | None = None
_tried = False
_reason: str | None = None  # why the decoder is unavailable
_linked: tuple[str, str | None] | None = None  # (library, its version) once loaded

_u8p = ctypes.POINTER(ctypes.c_ubyte)
_intp = ctypes.POINTER(ctypes.c_int)
_SIGNATURES = {
    "twd_jpeg_lib_version": [],
    "twd_jpeg_dims": [ctypes.c_char_p, ctypes.c_size_t, _intp, _intp],
    "twd_decode_jpeg": [ctypes.c_char_p, ctypes.c_size_t, _u8p, ctypes.c_int, ctypes.c_int,
                        _intp, _intp],
    "twd_decode_jpeg_slot": [ctypes.c_char_p, ctypes.c_size_t, _u8p, ctypes.c_size_t,
                             ctypes.c_int, ctypes.c_int, ctypes.c_int, _intp, _intp],
    "twd_decode_jpeg_packed": [ctypes.c_char_p, ctypes.c_size_t, _u8p, ctypes.c_size_t,
                               ctypes.c_int, _intp, _intp],
}
ENTRIES = tuple(_SIGNATURES)  # every entry is bound at load; a missing one raises


def _compiler() -> str | None:
    return shutil.which(os.environ.get("CC", "cc"))


def pillow_libjpeg() -> Path | None:
    """The libjpeg (ABI 62) that the installed Pillow bundles beside its
    package, as its manylinux wheels ship it, or None."""
    import PIL

    libs = Path(PIL.__file__).resolve().parent.parent / "pillow.libs"
    found = sorted(libs.glob("libjpeg*.so.62*"))
    return found[0] if found else None


def _system_libjpeg(cc: str | None) -> Path | None:
    """The file ``cc … -ljpeg`` links (``-print-file-name``), or None where
    the compiler finds none."""
    if cc is None:
        return None
    out = subprocess.run([cc, "-print-file-name=libjpeg.so"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    return Path(out).resolve() if os.path.isabs(out) else None


def _routes(cc: str | None) -> list[tuple[str, Path | None]]:
    """(``status()["library"]``, the libjpeg file, None where unknown) for
    each route, in the order they are tried."""
    routes = [(SYSTEM, _system_libjpeg(cc))]
    bundled = pillow_libjpeg()
    if bundled is not None:
        routes.append((str(bundled), bundled))
    return routes


def library_path(libjpeg: Path | None = None) -> Path:
    """The built decoder for one libjpeg: its name hashes the source and
    that library's file, so a build that linked one libjpeg is never
    loaded for another."""
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(str(libjpeg or SYSTEM).encode())
    return BUILD_DIR / f"libtwd_decode-{h.hexdigest()[:16]}.so"


def _build(out: Path, bundled: Path | None = None) -> str | None:
    """Compile ``decode.c`` against the system's libjpeg (``-ljpeg``), or
    against ``bundled``, a libjpeg outside the system's paths (the copied
    headers, its full path and an rpath), into a temporary file and rename
    it into place, so a concurrent build never loads a half-written
    library. Returns why the decoder cannot be built on this host (no
    compiler, no libjpeg), or None once it is built; raises on any other
    failure."""
    cc = _compiler()
    if cc is None:
        return "no C compiler (cc) on this machine"
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [cc, "-O3", "-shared", "-fPIC", "-o", tmp]
    if bundled is None:
        cmd += [str(_SRC), "-ljpeg"]
    else:
        cmd += [f"-I{_INCLUDE}", str(_SRC), str(bundled), f"-Wl,-rpath,{bundled.parent}"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
        if proc.returncode != 0:
            msg = proc.stdout + proc.stderr
            if any(m in msg for m in _NO_LIBJPEG):
                return f"libjpeg is not installed: {msg.strip().splitlines()[0]}"
            raise RuntimeError(f"building {_SRC.name} failed (exit {proc.returncode}):\n{msg}")
        os.replace(tmp, out)
        return None
    finally:
        Path(tmp).unlink(missing_ok=True)


def _first_route() -> tuple[ctypes.CDLL | None, tuple[str, str | None] | None, str | None]:
    """Build (if needed) and load the library by the first route that
    works: (the library, (its route, the libjpeg version linked), None), or
    (None, None, why no route works)."""
    reasons = []
    for library, libjpeg in _routes(_compiler()):
        so = library_path(libjpeg)
        reason = None if so.exists() else _build(so, None if library == SYSTEM else libjpeg)
        if reason is None:
            try:
                lib = ctypes.CDLL(str(so))
            except OSError as e:  # built elsewhere; this machine lacks its libjpeg
                reason = f"cannot load {so.name}: {e}"
        if reason is None:
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = ctypes.c_int, argtypes
            log.info("native decoder loaded (%s, %s)", so.name, library)
            # the version of the file linked: libjpeg.so.62.3.0 → "62.3.0"
            return lib, (library, libjpeg.name.split(".so.")[-1] if libjpeg else None), None
        reasons.append(f"{library}: {reason}")
    reason = "; ".join(reasons)
    log.warning("native decoder unavailable (%s); decoding with PIL", reason)
    return None, None, reason


def _load() -> ctypes.CDLL | None:
    """The library, built and loaded once per process; None where no route
    works."""
    global _lib, _tried, _reason, _linked
    if _tried:
        return _lib
    with _lock:
        if not _tried:
            # twdlint: disable=no-blocking-under-lock(one-time lazy compile: the double-checked lock serializes concurrent builders so that only one cc runs and nobody loads a half-written library; steady-state callers return before the lock), lock-order(the build takes no lock: the analyzer resolves its os.close and Path.resolve by name to the serving classes' close and resolve)
            lib, linked, reason = _first_route()
            if lib is None:
                _reason = reason
            else:
                _lib, _linked = lib, linked
            _tried = True
    return _lib


def available() -> bool:
    return _load() is not None


def status() -> dict:
    """Whether the decoder is built, which libjpeg it links (``"system
    -ljpeg"`` or the path of Pillow's) and that file's version, the libjpeg
    API it was compiled for, and why not where it is unavailable
    (``/stats`` and ``chip_smoke.py`` read it)."""
    lib = _load()
    library, version = _linked if lib is not None else (None, None)
    return {"available": lib is not None, "library": library, "lib_version": version,
            "libjpeg_version": lib.twd_jpeg_lib_version() if lib is not None else None,
            "reason": _reason}


def jpeg_dims(data: bytes) -> tuple[int, int] | None:
    """(height, width) from the JPEG header, or None if not decodable here."""
    lib = _load()
    if lib is None or len(data) < 3 or data[:2] != b"\xff\xd8":
        return None
    h, w = ctypes.c_int(), ctypes.c_int()
    if lib.twd_jpeg_dims(data, len(data), ctypes.byref(h), ctypes.byref(w)) != 0:
        return None
    return h.value, w.value


def _denom(m: int, top: int) -> int | None:
    """The DCT scale denominator decode.c's ``pick_denom`` picks for a
    source of longest side ``m``: the least of 1, 2, 4, 8 that fits the
    top bucket; None over 8× the top bucket (PIL takes those)."""
    if m > 8 * top:
        return None
    denom = 1
    while denom <= 8 and (m + denom - 1) // denom > top:
        denom *= 2
    return denom


def plan_decode(data: bytes, buckets: tuple[int, ...], wire: str
                ) -> tuple[int, tuple[int, ...], tuple[int, int]] | None:
    """Canvas plan for a JPEG the native path can decode: ``(canvas bucket,
    canvas shape, original (h, w))`` from its header, before any decode.
    None means the bytes take the PIL path."""
    dims = jpeg_dims(data)
    if dims is None:
        return None
    m = max(dims)
    denom = _denom(m, buckets[-1])
    if denom is None:
        return None
    # bucket by the decoded size: the C side downscales by up to 1/8
    s = pick_bucket((m + denom - 1) // denom, buckets)
    shape = (s * 3 // 2, s) if wire == "yuv420" else (s, s, 3)
    return s, shape, dims


def plan_decode_packed(data: bytes, buckets: tuple[int, ...]
                       ) -> tuple[int, int, tuple[int, int], tuple[int, int]] | None:
    """Ragged-wire plan: ``(canvas bucket, bytes, decoded (h, w), original
    (h, w))`` from the JPEG header. The decoded extent is ``ceil(dim /
    denom)`` for the power-of-two denominator libjpeg's DCT downscale
    uses, so the byte span is exact before the decode. None means the
    bytes take the PIL path."""
    dims = jpeg_dims(data)
    if dims is None:
        return None
    h0, w0 = dims
    denom = _denom(max(h0, w0), buckets[-1])
    if denom is None:
        return None
    dh, dw = (h0 + denom - 1) // denom, (w0 + denom - 1) // denom
    return pick_bucket(max(dh, dw), buckets), dh * dw * 3, (dh, dw), (h0, w0)


def _writable(dst: np.ndarray) -> bool:
    return dst.dtype == np.uint8 and dst.flags["C_CONTIGUOUS"] and dst.flags["WRITEABLE"]


def decode_packed_into(data: bytes, dst: np.ndarray, max_side: int) -> tuple[int, int] | None:
    """Decode a JPEG as tight RGB rows (stride w*3, no padding) into
    ``dst``, a flat uint8 span, and return the decoded (h, w); None on any
    failure (the caller falls back to PIL). The C side checks the span's
    capacity before it writes a byte."""
    lib = _load()
    if lib is None or not _writable(dst):
        return None
    oh, ow = ctypes.c_int(), ctypes.c_int()
    rc = lib.twd_decode_jpeg_packed(data, len(data), dst.ctypes.data_as(_u8p), dst.nbytes,
                                    max_side, ctypes.byref(oh), ctypes.byref(ow))
    return (oh.value, ow.value) if rc == 0 else None


def decode_into_row(data: bytes, row: np.ndarray, canvas: int, wire: str,
                    trailer: bool = False) -> tuple[int, int] | None:
    """Decode a JPEG into ``row``, a caller-owned uint8 buffer, as the
    ``wire``'s canvas (zero/neutral-padded) and return the valid (h, w);
    None on any failure (the caller falls back to PIL). The C side checks
    the row's capacity first and, with ``trailer``, writes the wire's
    4-byte big-endian (h, w) after the canvas bytes."""
    lib = _load()
    if lib is None or not _writable(row):
        return None
    oh, ow = ctypes.c_int(), ctypes.c_int()
    rc = lib.twd_decode_jpeg_slot(data, len(data), row.ctypes.data_as(_u8p), row.nbytes,
                                  canvas, 1 if wire == "yuv420" else 0, 1 if trailer else 0,
                                  ctypes.byref(oh), ctypes.byref(ow))
    return (oh.value, ow.value) if rc == 0 else None


def decode_native(data: bytes, buckets: tuple[int, ...], wire: str
                  ) -> tuple[np.ndarray, tuple[int, int], tuple[int, int]] | None:
    """The native half of :func:`decode_to_canvas`; None where PIL must
    decode."""
    plan = plan_decode(data, buckets, wire)
    if plan is None:
        return None
    s, shape, orig = plan
    out = np.empty(shape, np.uint8)
    hw = decode_into_row(data, out, s, wire)
    return None if hw is None else (out, hw, orig)


def decode_pil(data: bytes, buckets: tuple[int, ...], wire: str
               ) -> tuple[np.ndarray, tuple[int, int], tuple[int, int]]:
    """The PIL half of :func:`decode_to_canvas`: PIL decode, pad (or
    downscale, then pad) into the bucket's canvas, the numpy I420 packer on
    the yuv420 wire. PIL's errors (``OSError``, ``ValueError``) pass
    through on bytes that are no image."""
    from ..ops.image import decode_image, pad_to_canvas, rgb_to_yuv420_canvas

    img = decode_image(data)
    canvas, hw = pad_to_canvas(img, buckets)
    if wire == "yuv420":
        canvas = rgb_to_yuv420_canvas(canvas)
    return canvas, hw, (img.shape[0], img.shape[1])


def decode_to_canvas(data: bytes, buckets: tuple[int, ...], wire: str = "rgb"
                     ) -> tuple[np.ndarray, tuple[int, int], tuple[int, int]]:
    """Image bytes → (wire canvas, valid (h, w), original (h, w)): native
    for JPEGs, PIL for the rest (PNG, CMYK, a stream the C side rejects
    after its header, a source over 8× the top bucket).

    The native path downscales oversized JPEGs in the DCT domain, by
    powers of two only: an image between 1× and 2× the top bucket decodes
    to below it (600 px → 300 px with a 512 bucket) where PIL would resize
    to 512. The device resize samples the valid region either way.
    """
    return decode_native(data, buckets, wire) or decode_pil(data, buckets, wire)
