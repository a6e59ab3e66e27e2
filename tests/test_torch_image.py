"""The port's preprocess (ops/image.py, ops/preprocess_i420.py) against the
JAX package's on the same seeded inputs.

On the CPU the port's ``preprocess_i420`` runs its plain version; the JAX
side runs the Pallas kernel in interpret mode and its XLA matmul path.
Tolerances are those of tests/test_pallas_preprocess.py: 1e-5 for the
normalized modes, 1e-3 for raw (0..255), where only the float32 summation
order differs.
"""

import numpy as np
import pytest
import torch

from tensorflow_web_deploy_tpu.ops import image as jimage
from tensorflow_web_deploy_tpu.ops.pallas_preprocess import preprocess_i420 as jax_i420
from tensorflow_web_deploy_tpu_torch.ops import image as timage
from tensorflow_web_deploy_tpu_torch.ops.preprocess_i420 import (
    preprocess_i420,
    preprocess_i420_plain,
)

torch.set_num_threads(2)

ATOL = {"raw": 1e-3, "zero_one": 1e-5, "inception": 1e-5}
S, OUT = 64, 32
# full canvas, a 1×1 hole (padding rows), and uneven valid regions
HWS = np.array([[64, 64], [1, 1], [48, 60], [33, 41], [7, 64]], np.int32)


def _packed(rng, b=len(HWS), s=S):
    canv = rng.randint(0, 256, (b, s, s, 3)).astype(np.uint8)
    return np.stack([jimage.rgb_to_yuv420_canvas(c) for c in canv])


@pytest.mark.parametrize("mode", ["inception", "zero_one", "raw"])
def test_i420_matches_jax_pallas_interpret(rng, mode):
    packed = _packed(rng)
    ref = np.asarray(jax_i420(packed, HWS, OUT, OUT, mode, interpret=True))
    got = preprocess_i420(torch.from_numpy(packed), torch.from_numpy(HWS), OUT, OUT, mode)
    assert got.shape == (len(HWS), OUT, OUT, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL[mode])


@pytest.mark.parametrize("mode", ["inception", "zero_one", "raw"])
def test_i420_matches_jax_yuv_matmul(rng, mode):
    import jax

    packed = _packed(rng)
    ref = np.asarray(jax.jit(jimage.make_preprocess_fn(
        OUT, OUT, mode, wire="yuv420", resize="matmul"))(packed, HWS))
    got = preprocess_i420(torch.from_numpy(packed), torch.from_numpy(HWS), OUT, OUT, mode)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL[mode])
    # the port's own matmul path is the same function
    mm = timage.make_preprocess_fn(OUT, OUT, mode, wire="yuv420", resize="matmul")(
        torch.from_numpy(packed), torch.from_numpy(HWS))
    np.testing.assert_allclose(mm.numpy(), ref, atol=ATOL[mode])


def test_i420_plain_on_strided_wire_views(rng):
    """The engine hands the kernel views into its packed wire buffer (each
    image row followed by a 4-byte trailer); the result must not depend on
    that stride."""
    packed = _packed(rng)
    b, nbytes = packed.shape[0], packed[0].size
    buf = np.zeros((b, nbytes + 4), np.uint8)
    buf[:, :nbytes] = packed.reshape(b, -1)
    view = torch.from_numpy(buf)[:, :nbytes].unflatten(1, packed.shape[1:])
    assert not view.is_contiguous()
    hws = torch.from_numpy(HWS)
    got = preprocess_i420(view, hws, OUT, OUT, "inception")
    want = preprocess_i420(torch.from_numpy(packed), hws, OUT, OUT, "inception")
    assert torch.equal(got, want)


@pytest.mark.parametrize("mode", ["inception", "zero_one", "caffe", "raw"])
def test_rgb_matmul_matches_jax(rng, mode):
    import jax

    canv = rng.randint(0, 256, (len(HWS), S, S, 3)).astype(np.uint8)
    ref = np.asarray(jax.jit(jimage.make_preprocess_fn(OUT, OUT, mode, resize="matmul"))(
        canv, HWS))
    got = timage.make_preprocess_fn(OUT, OUT, mode)(torch.from_numpy(canv), torch.from_numpy(HWS))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-3 if mode in ("raw", "caffe") else 1e-5)


def test_rgb_to_yuv420_canvas_bit_equal(rng):
    for s in (16, 64):
        canv = rng.randint(0, 256, (s, s, 3)).astype(np.uint8)
        np.testing.assert_array_equal(timage.rgb_to_yuv420_canvas(canv),
                                      jimage.rgb_to_yuv420_canvas(canv))
    with pytest.raises(ValueError, match="multiple of 4"):
        timage.rgb_to_yuv420_canvas(np.zeros((18, 18, 3), np.uint8))


def test_pad_to_canvas_matches_jax(rng):
    for h, w in [(40, 30), (64, 64), (150, 90)]:  # the last one downscales
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        c_t, hw_t = timage.pad_to_canvas(img, (32, 64, 128))
        c_j, hw_j = jimage.pad_to_canvas(img, (32, 64, 128))
        assert hw_t == hw_j
        np.testing.assert_array_equal(c_t, c_j)


def test_i420_rejects_bad_shapes_and_modes(rng):
    packed = torch.from_numpy(_packed(rng, b=1))
    hws = torch.tensor([[64, 64]], dtype=torch.int32)
    with pytest.raises(ValueError, match="I420"):
        preprocess_i420(torch.zeros((1, 64, 64), dtype=torch.uint8), hws, OUT, OUT)
    with pytest.raises(ValueError, match="normalize"):
        preprocess_i420(packed, hws, OUT, OUT, "caffe")
    with pytest.raises(ValueError, match="I420"):
        preprocess_i420_plain(torch.zeros((1, 64, 64), dtype=torch.uint8), hws, OUT, OUT)


def test_cpu_tensors_take_the_plain_version(rng):
    before = preprocess_i420.launches
    packed = torch.from_numpy(_packed(rng))
    preprocess_i420(packed, torch.from_numpy(HWS), OUT, OUT)
    assert preprocess_i420.launches == before


@pytest.mark.cuda
def test_i420_kernel_matches_plain_on_card(rng):
    """Runs on a machine with a CUDA card and nvcc (chip_smoke.py covers
    the full shape sweep): both entries, float32 and bf16. The wire entry
    reads views into one wire buffer whose rows start at every address
    class mod 16, and equals the table entry bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from tensorflow_web_deploy_tpu_torch.ops.preprocess_i420 import (
        preprocess_i420_wire,
        wire_canvases,
    )

    packed_np = _packed(rng)
    b, nbytes = packed_np.shape[0], packed_np[0].size
    buf = np.zeros((b, nbytes + 4), np.uint8)
    buf[:, :nbytes] = packed_np.reshape(b, -1)
    buf[:, nbytes:] = HWS.astype(">u2").view(np.uint8).reshape(b, 4)
    buf = torch.from_numpy(buf).cuda()
    packed = wire_canvases(buf, S)
    hws = torch.from_numpy(HWS).cuda()
    for mode in ("inception", "zero_one", "raw"):
        ref = preprocess_i420_plain(packed, hws, OUT, OUT, mode)
        for dtype in (torch.float32, torch.bfloat16):
            got = preprocess_i420(packed, hws, OUT, OUT, mode, out_dtype=dtype)
            wire = preprocess_i420_wire(buf, S, OUT, OUT, mode, out_dtype=dtype)
            torch.cuda.synchronize()
            assert got.dtype == dtype and torch.equal(got, wire)
            if dtype == torch.float32:
                torch.testing.assert_close(got, ref, atol=ATOL[mode], rtol=0)
            else:  # the float32 result rounded to bf16, up to one bf16 ulp
                torch.testing.assert_close(got.float(), ref, atol=ATOL[mode],
                                           rtol=2 ** -8)


def _normalize_inputs():
    """Every float32 a uint8 can give, and a seeded sample of [0, 255]."""
    sample = np.random.RandomState(0).uniform(0, 255, 1 << 16).astype(np.float32)
    return np.concatenate([np.arange(256, dtype=np.float32), sample])


def _check_normalize(device):
    x = _normalize_inputs()
    got = {m: timage.NORMALIZERS[m](torch.from_numpy(x).to(device)).cpu().numpy()
           for m in ("inception", "zero_one")}
    # numpy float32 division, IEEE-exact, as XLA and the kernel divide
    np.testing.assert_array_equal(got["inception"], x / np.float32(127.5) - np.float32(1.0))
    np.testing.assert_array_equal(got["zero_one"], x / np.float32(255.0))


def test_normalize_divides_exactly():
    _check_normalize("cpu")


@pytest.mark.cuda
def test_normalize_divides_exactly_on_card():
    """On CUDA torch divides by a Python scalar as a multiply by its
    reciprocal; the normalize must still equal IEEE division bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _check_normalize("cuda")
