"""The port's native libjpeg decoder (``tensorflow_web_deploy_tpu_torch/native``)
against the JAX package's on the same JPEG bytes: every entry must give
identical bytes (both drive the same libjpeg with the same arithmetic), and
the plans identical tuples. The JAX side builds its library into a
temporary directory.

Skipped, like ``tests/test_native_decode.py``, where this machine has no
C compiler or libjpeg.
"""

import io
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
from PIL import Image

from tensorflow_web_deploy_tpu import native as jnative
from tensorflow_web_deploy_tpu_torch import native
from tensorflow_web_deploy_tpu_torch.serving.engine import InferenceEngine
from tensorflow_web_deploy_tpu_torch.utils.config import ModelConfig, ServerConfig

BUCKETS = (128, 256)


@pytest.fixture(scope="module", autouse=True)
def jax_decoder(tmp_path_factory):
    """The JAX decoder, built into a temporary cache; both sides must be
    available (else the module skips)."""
    saved = (jnative._CACHE_DIR, jnative._lib, jnative._lib_tried)
    jnative._CACHE_DIR = tmp_path_factory.mktemp("native_cache")
    jnative._lib, jnative._lib_tried = None, False
    try:
        if not (native.available() and jnative.available()):
            pytest.skip(f"no compiler/libjpeg for the native decoder: {native.status()}")
        yield
    finally:
        jnative._CACHE_DIR, jnative._lib, jnative._lib_tried = saved


def _smooth(h, w, seed=0):
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([yy * 0.8, xx * 0.5, 255 - yy * 0.6], -1) + rs.normal(0, 8, (h, w, 3))
    return img.clip(0, 255).astype(np.uint8)


def _encode(arr, fmt="JPEG", **kw):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, fmt, **kw)
    return buf.getvalue()


def _jpeg(h, w, seed=0, gray=False):
    img = _smooth(h, w, seed)
    return _encode(img[..., 0] if gray else img, quality=90)


def _same(got, want):
    """Two (canvas, hw, orig) decodes are identical, byte for byte."""
    assert got[1:] == want[1:]
    assert got[0].shape == want[0].shape and got[0].dtype == want[0].dtype == np.uint8
    np.testing.assert_array_equal(got[0], want[0])


@pytest.mark.parametrize("wire", ["rgb", "yuv420"])
@pytest.mark.parametrize("h,w", [(200, 160), (201, 159)])
def test_decode_to_canvas_is_byte_identical(wire, h, w):
    data = _jpeg(h, w, seed=h)
    got = native.decode_to_canvas(data, BUCKETS, wire)
    _same(got, jnative.decode_to_canvas(data, BUCKETS, wire))
    assert got[1] == (h, w) and got[0].shape[1] == 256


@pytest.mark.parametrize("wire", ["rgb", "yuv420"])
def test_grayscale_decodes_with_neutral_chroma(wire):
    data = _jpeg(90, 61, gray=True)
    got = native.decode_to_canvas(data, BUCKETS, wire)
    _same(got, jnative.decode_to_canvas(data, BUCKETS, wire))
    canvas = got[0]
    if wire == "yuv420":
        assert (canvas[128:] == 128).all()  # U and V planes: neutral everywhere
    else:
        assert (canvas[..., 0] == canvas[..., 1]).all() and (canvas[..., 0] == canvas[..., 2]).all()


@pytest.mark.parametrize("wire", ["rgb", "yuv420"])
def test_oversized_jpeg_downscales_in_the_dct_domain(wire):
    data = _jpeg(1100, 700)  # 1100 / 8 = 138 ≤ 256 < 1100 / 4
    got = native.decode_to_canvas(data, BUCKETS, wire)
    _same(got, jnative.decode_to_canvas(data, BUCKETS, wire))
    assert got[1] == (138, 88) and got[2] == (1100, 700)
    tight = np.empty(138 * 88 * 3, np.uint8)
    assert native.decode_packed_into(data, tight, 256) == (138, 88)


@pytest.mark.parametrize("h,w", [(200, 160), (201, 159), (128, 128), (129, 40), (300, 520),
                                 (1100, 700), (2049, 100), (2048, 100)])
def test_plans_equal_the_reference(h, w):
    data = _jpeg(h, w)
    for wire in ("rgb", "yuv420"):
        assert native.plan_decode(data, BUCKETS, wire) == jnative.plan_decode(data, BUCKETS, wire)
    assert native.plan_decode_packed(data, BUCKETS) == jnative.plan_decode_packed(data, BUCKETS)
    plan = native.plan_decode_packed(data, BUCKETS)
    if max(h, w) > 8 * BUCKETS[-1]:
        assert plan is None  # PIL takes those
    else:
        s, need, (dh, dw), orig = plan
        assert orig == (h, w) and need == dh * dw * 3 and max(dh, dw) <= s
        tight = np.empty(need, np.uint8)  # the plan's span is exactly the decode's
        assert native.decode_packed_into(data, tight, s) == (dh, dw)


@pytest.mark.parametrize("wire", ["rgb", "yuv420"])
def test_decode_into_row_writes_the_trailer(wire):
    data = _jpeg(201, 159, seed=1)
    s, shape, _ = native.plan_decode(data, BUCKETS, wire)
    n = int(np.prod(shape)) + 4
    got, want = np.full(n, 7, np.uint8), np.full(n, 7, np.uint8)
    assert native.decode_into_row(data, got, s, wire, trailer=True) == (201, 159)
    assert jnative.decode_into_row(data, want, s, wire, trailer=True) == (201, 159)
    np.testing.assert_array_equal(got, want)
    assert got[-4:].tolist() == [0, 201, 0, 159]  # big-endian (h, w)


def test_decode_packed_into_is_byte_identical():
    data = _jpeg(121, 77, seed=2)
    s, need, hw, _ = native.plan_decode_packed(data, BUCKETS)
    got, want = np.empty(need, np.uint8), np.empty(need, np.uint8)
    assert native.decode_packed_into(data, got, s) == hw == (121, 77)
    assert jnative.decode_packed_into(data, want, s) == hw
    np.testing.assert_array_equal(got, want)
    # the tight rows are the RGB canvas's valid region
    canvas, _, _ = native.decode_to_canvas(data, BUCKETS, "rgb")
    np.testing.assert_array_equal(got.reshape(121, 77, 3), canvas[:121, :77])


@pytest.mark.parametrize("entry", ["packed", "row"])
def test_capacity_guard_writes_nothing(entry):
    data = _jpeg(100, 90, seed=3)
    if entry == "packed":
        short = np.full(100 * 90 * 3 - 1, 0xAB, np.uint8)
        assert native.decode_packed_into(data, short, 128) is None
        assert jnative.decode_packed_into(data, short, 128) is None
    else:
        short = np.full(128 * 128 * 3 + 3, 0xAB, np.uint8)  # no room for the trailer
        assert native.decode_into_row(data, short, 128, "rgb", trailer=True) is None
        assert jnative.decode_into_row(data, short, 128, "rgb", trailer=True) is None
    assert (short == 0xAB).all()


def test_png_takes_pil_and_garbage_raises():
    png = _encode(_smooth(70, 50), "PNG")
    assert native.plan_decode(png, BUCKETS, "rgb") is None
    assert native.plan_decode_packed(png, BUCKETS) is None
    for wire in ("rgb", "yuv420"):
        _same(native.decode_to_canvas(png, BUCKETS, wire),
              jnative.decode_to_canvas(png, BUCKETS, wire))
    with pytest.raises(OSError):
        native.decode_to_canvas(b"\xff\xd8 not really a jpeg", BUCKETS)
    with pytest.raises(OSError):
        jnative.decode_to_canvas(b"\xff\xd8 not really a jpeg", BUCKETS)


@pytest.mark.parametrize("ragged", [False, True])
def test_engine_counts_decoders_and_answers_garbage_with_valueerror(ragged):
    cfg = ServerConfig(model=ModelConfig(name="inception_v3", zoo_width=0.25, zoo_classes=4,
                                         input_size=(75, 75), dtype="float32"),
                       canvas_buckets=BUCKETS, max_batch=2, ragged=ragged, warmup=False)
    eng = InferenceEngine(cfg, device="cpu")
    prepare = eng.prepare_ragged if ragged else eng.prepare_bytes
    jpeg, png = _jpeg(60, 50), _encode(_smooth(60, 50), "PNG")
    a, b = prepare(jpeg), prepare(png)
    assert a[1] == b[1] == (60, 50)
    assert eng.stats()["decodes"] == {"native": 1, "pil": 1}
    assert eng.stats()["decoder"]["available"] and eng.stats()["decoder"]["reason"] is None
    for bad in (b"garbage", b"\xff\xd8\xff truncated"):
        with pytest.raises(ValueError, match="cannot decode"):
            prepare(bad)
    eng.close()


def test_prebuild_command_binds_every_entry(capsys):
    from tensorflow_web_deploy_tpu_torch.native import build

    assert build.main() == 0
    assert f"OK, {len(native.ENTRIES)} entries bound" in capsys.readouterr().out
    assert all(hasattr(native._load(), e) for e in native.ENTRIES)
    assert native.status()["libjpeg_version"] >= 62


def test_request_threads_decode_at_once():
    """Many threads decoding through the shared library give what one
    thread gives (ctypes.CDLL releases the interpreter lock per call)."""
    jpegs = [_jpeg(80 + 7 * i, 120 - 5 * i, seed=i) for i in range(16)]
    serial = [native.decode_to_canvas(d, BUCKETS, "yuv420") for d in jpegs]
    with ThreadPoolExecutor(16) as pool:
        for _ in range(3):
            for got, want in zip(pool.map(
                    lambda d: native.decode_to_canvas(d, BUCKETS, "yuv420"), jpegs), serial):
                _same(got, want)


def test_missing_compiler_or_libjpeg_leaves_the_decoder_unavailable(tmp_path, monkeypatch):
    """No compiler (or no libjpeg): ``_build`` gives a reason and the
    decoder stays unavailable, with PIL serving; a build that fails for
    another reason raises."""
    out = tmp_path / "lib.so"
    monkeypatch.setenv("CC", str(tmp_path / "no-such-cc"))
    assert "no C compiler" in native._build(out)
    fake = tmp_path / "cc"
    fake.write_text("#!/bin/sh\necho 'decode.c:1: fatal error: jpeglib.h: No such file or "
                    "directory' >&2\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setenv("CC", str(fake))
    assert "libjpeg is not installed" in native._build(out)
    fake.write_text("#!/bin/sh\necho 'internal compiler error' >&2\nexit 1\n")
    with pytest.raises(RuntimeError, match="internal compiler error"):
        native._build(out)
    assert not out.exists() and list(tmp_path.glob("*.so")) == []  # no half-written library

    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_reason", None)
    monkeypatch.setattr(native, "library_path", lambda: tmp_path / "absent.so")
    monkeypatch.setenv("CC", str(tmp_path / "no-such-cc"))
    assert not native.available()
    st = native.status()
    assert not st["available"] and "no C compiler" in st["reason"]
    data = _jpeg(40, 30)
    assert native.plan_decode_packed(data, BUCKETS) is None
    canvas, hw, orig = native.decode_to_canvas(data, BUCKETS, "rgb")  # PIL
    assert hw == orig == (40, 30) and canvas.shape == (128, 128, 3)
    # a library built on another machine whose libjpeg this one lacks
    (tmp_path / "absent.so").write_bytes(b"not a shared object")
    monkeypatch.setattr(native, "_tried", False)
    assert not native.available() and "cannot load" in native.status()["reason"]
