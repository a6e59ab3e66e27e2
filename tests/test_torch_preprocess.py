"""The redesigned preprocess kernel's CPU-side contract
(ops/preprocess_i420.py): the bf16 output against the JAX Pallas kernel,
the wire entry against the table entry and the JAX engine's trailer
decode, and the launch rule with its shared-memory sizing.

On the CPU both entries run the plain version; the JAX side runs the
Pallas kernel in interpret mode. bf16 results are held to one bf16 ulp of
the JAX float32 result rounded to bf16: the float32 values agree to a few
float32 ulps (tests/test_torch_image.py), which can move a rounding by one.
Near zero (below 2^-8) inception's x / 127.5 - 1 cancels, and float32
results ~1e-7 apart span many of bf16's finer ulps there; those are held to
the float32 tolerance (1e-5) plus bf16's rounding there (2^-17).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_web_deploy_tpu.ops import image as jimage
from tensorflow_web_deploy_tpu.ops.pallas_preprocess import preprocess_i420 as jax_i420
from tensorflow_web_deploy_tpu_torch.ops import image as timage
from tensorflow_web_deploy_tpu_torch.ops import preprocess_i420 as pp
from tensorflow_web_deploy_tpu_torch.serving.engine import InferenceEngine
from tensorflow_web_deploy_tpu_torch.utils import config as tcfg

torch.set_num_threads(2)

S, OUT = 64, 32
# full canvas, a 1×1 hole (padding rows), and uneven valid regions
HWS = np.array([[64, 64], [1, 1], [48, 60], [33, 41], [7, 64]], np.int32)
# trailers the engine never sends: the kernel clamps them, the plain
# version takes them as they are
ODD_HWS = np.array([[0, 0], [S + 9, 3], [70, 65535]], np.int32)
SIDES = (256, 512, 1024, 2048)
OUTS = (224, 299)
SMS = 132  # an H100's SMs


def _packed(rng, b=len(HWS), s=S):
    canv = rng.randint(0, 256, (b, s, s, 3)).astype(np.uint8)
    return np.stack([jimage.rgb_to_yuv420_canvas(c) for c in canv])


def _wire(packed, hws):
    """The engine's wire rows: canvas bytes, then (h, w) as big-endian u16
    (serving/engine.py::dispatch_batch)."""
    b = packed.shape[0]
    nbytes = packed[0].size
    buf = np.zeros((b, nbytes + 4), np.uint8)
    buf[:, :nbytes] = packed.reshape(b, -1)
    buf[:, nbytes:] = np.asarray(hws).astype(">u2").view(np.uint8).reshape(b, 4)
    return buf


def _bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Distance in bf16 ulps between two bf16 tensors (±0 equal)."""
    def order(x):
        bits = x.view(torch.int16).to(torch.int32)
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)
    return (order(a) - order(b)).abs()


@pytest.mark.parametrize("entry", ["table", "wire"])
@pytest.mark.parametrize("mode", ["inception", "zero_one", "raw"])
def test_bf16_matches_jax_pallas_interpret(rng, mode, entry):
    packed = _packed(rng)
    ref32 = jax_i420(packed, HWS, OUT, OUT, mode, interpret=True)
    ref = torch.from_numpy(np.array(ref32.astype(jnp.bfloat16).astype(jnp.float32)))
    ref, ref32 = ref.to(torch.bfloat16), torch.from_numpy(np.array(ref32))
    if entry == "table":
        got = pp.preprocess_i420(torch.from_numpy(packed), torch.from_numpy(HWS), OUT, OUT, mode,
                                 out_dtype=torch.bfloat16)
    else:
        got = pp.preprocess_i420_wire(torch.from_numpy(_wire(packed, HWS)), S, OUT, OUT, mode,
                                      out_dtype=torch.bfloat16)
    assert got.shape == (len(HWS), OUT, OUT, 3) and got.dtype == torch.bfloat16
    near = ref32.abs() < 2 ** -8
    assert int(_bf16_ulps(got, ref)[~near].max()) <= 1
    if near.any():
        assert float((got.float() - ref32)[near].abs().max()) <= 1e-5 + 2 ** -17
    # bf16 is the float32 result rounded once
    f32 = pp.preprocess_i420(torch.from_numpy(packed), torch.from_numpy(HWS), OUT, OUT, mode)
    assert torch.equal(got, f32.to(torch.bfloat16))


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_wire_matches_table_and_jax_trailer_decode(rng, out_dtype):
    hws = np.concatenate([HWS, ODD_HWS])
    packed = _packed(rng, b=len(hws))
    buf = torch.from_numpy(_wire(packed, hws))
    # the JAX engine's decode (serving/engine.py, serve_packed)
    hwb = jnp.asarray(buf.numpy()[:, -4:]).astype(jnp.int32)
    jax_hws = np.asarray(jnp.stack([hwb[:, 0] * 256 + hwb[:, 1], hwb[:, 2] * 256 + hwb[:, 3]],
                                   axis=1))
    decoded = pp.decode_trailer(buf)
    assert decoded.dtype == torch.int32
    np.testing.assert_array_equal(decoded.numpy(), jax_hws)
    np.testing.assert_array_equal(jax_hws, hws)
    canvases = pp.wire_canvases(buf, S)
    assert torch.equal(canvases, torch.from_numpy(packed))
    got = pp.preprocess_i420_wire(buf, S, OUT, OUT, "inception", out_dtype)
    want = pp.preprocess_i420(canvases, decoded, OUT, OUT, "inception", out_dtype)
    assert got.dtype == out_dtype and torch.equal(got, want)
    assert torch.isfinite(got.float()).all()
    # the valid rows, holes included, against the Pallas kernel on the table
    n = len(HWS)
    ref = np.asarray(jax_i420(packed[:n], jax_hws[:n], OUT, OUT, "inception", interpret=True))
    np.testing.assert_allclose(got[:n].float().numpy(), ref, atol=1e-5 if out_dtype == torch.float32
                               else 2 ** -7)


def test_wire_entry_checks_and_counts(rng):
    buf = torch.from_numpy(_wire(_packed(rng, b=2), HWS[:2]))
    before = pp.preprocess_i420.launches
    pp.preprocess_i420_wire(buf, S, OUT, OUT)
    assert pp.preprocess_i420.launches == before  # CPU tensors take the plain version
    with pytest.raises(ValueError, match="wire buffer"):
        pp.preprocess_i420_wire(buf, S + 4, OUT, OUT)
    with pytest.raises(ValueError, match="wire buffer"):
        pp.preprocess_i420_wire(buf[:, :-1], S, OUT, OUT)
    with pytest.raises(ValueError, match="normalize"):
        pp.preprocess_i420_wire(buf, S, OUT, OUT, "caffe")
    with pytest.raises(ValueError, match="out_dtype"):
        pp.preprocess_i420_wire(buf, S, OUT, OUT, out_dtype=torch.float16)
    with pytest.raises(ValueError, match="out_dtype"):
        pp.preprocess_i420(pp.wire_canvases(buf, S), pp.decode_trailer(buf), OUT, OUT,
                           out_dtype=torch.int8)


@pytest.mark.parametrize("wire,resize", [("yuv420", "kernel"), ("yuv420", "matmul"),
                                         ("rgb", "matmul")])
def test_make_preprocess_fn_stores_out_dtype(rng, wire, resize):
    if wire == "yuv420":
        canvases = torch.from_numpy(_packed(rng))
    else:
        canvases = torch.from_numpy(rng.randint(0, 256, (len(HWS), S, S, 3)).astype(np.uint8))
    hws = torch.from_numpy(HWS)
    f32 = timage.make_preprocess_fn(OUT, OUT, "inception", wire, resize)(canvases, hws)
    bf16 = timage.make_preprocess_fn(OUT, OUT, "inception", wire, resize,
                                     out_dtype=torch.bfloat16)(canvases, hws)
    assert f32.dtype == torch.float32 and bf16.dtype == torch.bfloat16
    assert torch.equal(bf16, f32.to(torch.bfloat16))


@pytest.mark.parametrize("resize", ["kernel", "matmul"])
def test_engine_preprocess_stage_stores_the_serving_dtype(rng, resize):
    model = tcfg.ModelConfig(name="inception_v3", source="native", zoo_width=0.25,
                             zoo_classes=10, input_size=(OUT, OUT), preprocess="inception",
                             topk=3, dtype="bfloat16")
    eng = InferenceEngine(tcfg.ServerConfig(model=model, canvas_buckets=(S,), max_batch=8,
                                            wire_format="yuv420", resize=resize, warmup=False),
                          device="cpu")
    packed = _packed(rng)
    x = eng.preprocess_packed(torch.from_numpy(_wire(packed, HWS)))
    # the yuv420 wire hands Inception-v3's VALID stem its space-to-depth cells
    assert eng.s2d
    want = pp.preprocess_i420_plain(torch.from_numpy(packed), torch.from_numpy(HWS), OUT, OUT,
                                    out_dtype=torch.bfloat16, s2d=True)
    assert x.dtype == torch.bfloat16 and torch.equal(x, want)
    eng.close()


def _div_exact(x: np.ndarray, d: float) -> np.ndarray:
    """The kernel's div_exact (csrc/preprocess_i420.cu) in numpy: the FMAs
    are exact in float64 here (a product of two float32 has 48 bits), and
    each rounds once to float32 as the FMA does."""
    d, r = np.float32(d), np.float32(1) / np.float32(d)
    q = x * r
    e = (x.astype(np.float64) - np.float64(d) * q).astype(np.float32)
    out = (q.astype(np.float64) + e.astype(np.float64) * np.float64(r)).astype(np.float32)
    tiny = (x != 0) & (x < np.float32(2.0 ** -64))
    return np.where(tiny, x / d, out)


@pytest.mark.parametrize("d", [127.5, 255.0])
def test_kernel_normalize_divide_is_ieee(d):
    """The kernel normalizes with div_exact, FMAs in place of the divide:
    equal bit for bit to IEEE x / d on float32 x in [0, 255], here on every
    173rd float32 bit pattern there, every integer and half, and the range's
    ends (a run over all 1.13e9 of them finds no difference either)."""
    top = int(np.float32(255).view(np.uint32))
    bits = np.concatenate([np.arange(0, top + 1, 173, dtype=np.uint32),
                           np.arange(top - 4096, top + 1, dtype=np.uint32),
                           np.arange(0, 4096, dtype=np.uint32)])
    x = np.concatenate([bits.view(np.float32), np.arange(0, 255.5, 0.5, dtype=np.float32)])
    got = _div_exact(x, d)
    want = x / np.float32(d)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def _band_slots(lo: np.ndarray, hi: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The kernel's ``band_slots`` (csrc/preprocess_i420.cu) on the taps of
    bands, vectorized: ``lo`` and ``hi`` are [..., R] (a band's rows along
    the last axis). Returns (slot_lo, slot_hi, distinct) — each tap's slot
    among the band's distinct source rows, and how many there are — from
    the same prefix counts the kernel takes with ballots."""
    prev_hi = np.concatenate([np.full(lo.shape[:-1] + (1,), -1), hi[..., :-1]], axis=-1)
    new_lo = lo > prev_hi
    new_hi = hi > np.maximum(lo, prev_hi)
    upto_lo = np.cumsum(new_lo, axis=-1)
    upto_hi = np.cumsum(new_hi, axis=-1)
    slot_lo = upto_lo + upto_hi - new_hi - 1 - (lo < prev_hi)
    slot_hi = upto_lo + upto_hi - 1
    return slot_lo, slot_hi, upto_lo[..., -1] + upto_hi[..., -1]


def _first_rank(vals: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """For values [..., n]: each one's rank among the distinct values of its
    row, and the count of distinct values."""
    eq = vals[..., :, None] == vals[..., None, :]
    first = ~np.any(np.tril(eq, -1), axis=-1)  # no equal value before it
    below = vals[..., None, :] < vals[..., :, None]
    return np.sum(below & first[..., None, :], axis=-1), first.sum(-1)


@pytest.mark.parametrize("s", SIDES)
def test_launch_rule_fits_and_covers(s):
    """For every batch the engine serves, both outputs and both dtypes, the
    rule's shape fits the kernel's limits. For every band height the kernel
    takes (1 to 32 rows, powers of two) and every valid h in [1, S], the
    band slots the kernel computes (_band_slots) are the ranks of each tap's
    row among its band's distinct Y (chroma) rows, at most 2 per band row,
    and the bands cover every output row exactly once."""
    for out in OUTS:
        for b in (1, 8, 32):
            for elt in (2, 4):
                shape = pp.launch_shape(b, s, out, out, elt, SMS)
                assert 1 <= shape.rows <= pp.ROWS_CAP <= pp.MAX_ROWS
                assert 64 <= shape.threads <= pp.MAX_THREADS and shape.threads % 32 == 0
                assert shape.smem(s, out, elt) <= pp.SMEM_BUDGET <= pp.MAX_SMEM
                assert shape.rows == 1 or shape.blocks(b, out) >= pp.BLOCKS_PER_SM * SMS
        for r in (1, 2, 4, 8, 16, 32):
            bands = -(-out // r)
            cover = np.zeros(out, np.int64)
            for band in range(bands):
                cover[band * r:min(out, (band + 1) * r)] += 1
            assert (cover == 1).all()
            for h0 in range(1, s + 1, 256):
                lo, hi, _ = pp.axis_taps(out, np.arange(h0, min(h0 + 256, s + 1)), s)
                n = lo.shape[0]
                # the last band's missing rows repeat its last row: never new
                pad = bands * r - out
                lo = np.concatenate([lo, np.repeat(lo[:, -1:], pad, 1)], 1).reshape(n, bands, r)
                hi = np.concatenate([hi, np.repeat(hi[:, -1:], pad, 1)], 1).reshape(n, bands, r)
                for y_lo, y_hi in ((lo, hi), (lo >> 1, hi >> 1)):
                    slot_lo, slot_hi, distinct = _band_slots(y_lo, y_hi)
                    rank, count = _first_rank(np.concatenate([y_lo, y_hi], -1))
                    np.testing.assert_array_equal(slot_lo, rank[..., :r])
                    np.testing.assert_array_equal(slot_hi, rank[..., r:])
                    np.testing.assert_array_equal(distinct, count)
                    assert distinct.max() <= 2 * r
