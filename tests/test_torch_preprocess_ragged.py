"""The ragged rgb preprocess stage (``ops/preprocess_ragged.py``) on the
CPU: its plain version against the JAX package's ``unpack_ragged``
followed by its rgb matmul ``make_preprocess_fn``, in every normalize mode,
float32 and bf16, with holes and rows that start at unaligned bytes; the
kernel's launch rule; the wrapper's argument checks; and a CPU engine that
serves the ragged matmul path through the plain version without counting
a launch. The kernel itself runs on the card only (``chip_smoke.py
--phase ragged_preprocess``).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_web_deploy_tpu.ops import image as jimage
from tensorflow_web_deploy_tpu_torch.ops import image as timage
from tensorflow_web_deploy_tpu_torch.ops import preprocess_ragged as pr
from tensorflow_web_deploy_tpu_torch.serving.engine import InferenceEngine
from tensorflow_web_deploy_tpu_torch.utils import config as tcfg

torch.set_num_threads(2)

MODES = ("inception", "zero_one", "raw", "caffe")
# float32 against the JAX package: the same taps, sums of two products in
# another BLAS (a fused multiply-add may round once where the other rounds
# twice), so a few float32 ulps of the largest value of each mode's range
TOL = {"inception": 1e-5, "zero_one": 1e-5, "raw": 1e-3, "caffe": 1e-3}
HOLES = (1, 4)


def _images(s: int, seed: int) -> list[np.ndarray]:
    """Five images that fit a canvas of side ``s``: the full canvas, odd
    widths (each row of an odd width starts at another byte mod 16), a
    1-pixel row and column; slots 1 and 4 become holes."""
    dims = ((s, s), (s - 3, s // 2 + 1), (s // 3, s - 5), (1, s // 4 + 3), (s // 2 + 7, 1))
    rs = np.random.RandomState(seed)
    return [(rs.rand(h, w, 3) * 255).astype(np.uint8) for h, w in dims]


def _arena(images, holes=HOLES):
    """The images tight, back to back, each starting at an odd byte after
    a 1-byte gap; a hole keeps a garbage offset and size."""
    arena = np.random.RandomState(7).randint(0, 256, sum(im.size + 1 for im in images) + 33)
    arena = arena.astype(np.uint8)
    meta = np.zeros((len(images), 4), np.int32)
    off = 1
    for i, im in enumerate(images):
        arena[off:off + im.size] = im.reshape(-1)
        meta[i] = (off, *im.shape[:2], 1)
        if i in holes:
            meta[i] = (off + 5, 9999, -3, 0)
        off += im.size + 1
    return arena, meta


@functools.lru_cache(maxsize=None)
def _case(s: int, out: int, mode: str):
    """A seeded arena and meta table for canvas ``s`` and the JAX
    package's float32 answer at ``out`` × ``out``."""
    arena, meta = _arena(_images(s, seed=s + out))
    canvases, hws = jimage.unpack_ragged(jnp.asarray(arena), jnp.asarray(meta), s)
    want = np.asarray(jimage.make_preprocess_fn(out, out, mode, wire="rgb", resize="matmul")(
        canvases, hws))
    return arena, meta, want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("s,out", [(64, 31), (64, 224), (256, 31), (256, 224), (256, 299)])
def test_plain_matches_jax_unpack_and_matmul_preprocess(s, out, mode, dtype):
    arena, meta, want = _case(s, out, mode)
    before = pr.preprocess_ragged.launches
    got = pr.preprocess_ragged(torch.from_numpy(arena), torch.from_numpy(meta), s, out, out,
                               mode, dtype)
    assert pr.preprocess_ragged.launches == before  # the CPU runs the plain version
    assert got.dtype == dtype and got.shape == (len(meta), out, out, 3)
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), want, atol=TOL[mode], rtol=0)
    else:
        # the float32 result rounded once to nearest even; against JAX's
        # float32, the float32 tolerance plus bf16's rounding (2^-8 relative)
        f32 = pr.preprocess_ragged(torch.from_numpy(arena), torch.from_numpy(meta), s, out, out,
                                   mode)
        assert torch.equal(got, f32.to(torch.bfloat16))
        err = np.abs(got.float().numpy() - want)
        assert (err <= TOL[mode] + 2.0 ** -8 * np.abs(want)).all()
    # a hole gives what a zero 1 × 1 image gives: the normalized zero
    zero = timage.NORMALIZERS[mode](torch.zeros(3)).to(dtype)
    for i in HOLES:
        assert torch.equal(got[i], zero.expand(out, out, 3))


@pytest.mark.parametrize("mode", MODES)
def test_plain_is_the_unpack_then_the_engine_preprocess(mode):
    arena, meta = (torch.from_numpy(a) for a in _arena(_images(64, seed=3)))
    for dtype in (torch.float32, torch.bfloat16):
        want = timage.make_preprocess_fn(40, 33, mode, out_dtype=dtype)(
            *timage.unpack_ragged(arena, meta, 64))
        assert torch.equal(pr.preprocess_ragged_plain(arena, meta, 64, 40, 33, mode, dtype),
                           want)


SERVED_OUT = (224, 299, 300)  # MobileNetV2 and ResNet-50, Inception-v3, SSD


@pytest.mark.parametrize("s", [64, 128, 256, 512, 1024, 2048])
def test_launch_shape_fits_and_covers_every_row(s):
    for out in SERVED_OUT:
        for k in (1, 2, 8, 32, 256):
            for elt in (2, 4):
                shape = pr.launch_shape(k, s, out, out, elt, sms=132)
                assert 1 <= shape.rows <= pr.MAX_ROWS and shape.rows & (shape.rows - 1) == 0
                smem = shape.smem(s, out, elt)
                # staged rows, column taps and the band within the block's shared memory
                assert smem <= pr.MAX_SMEM
                assert smem <= pr.SMEM_BUDGET or shape.rows == 1
                assert 2 * shape.rows * (3 * s + 15) + out * 3 * elt * shape.rows <= smem
                bands = shape.bands(out)
                assert (bands - 1) * shape.rows < out <= bands * shape.rows
                assert shape.blocks(k, out) == k * bands
                if shape.rows > 1:  # halved only while too few blocks or too much memory
                    assert (shape.blocks(k, out) >= pr.BLOCKS_PER_SM * 132
                            and smem <= pr.SMEM_BUDGET)


def test_launch_shape_shrinks_bands_on_a_2048_canvas():
    assert pr.launch_shape(8, 512, 299, 299, 2, 132).rows == pr.ROWS_CAP
    # a band row stages up to two 6 KB source rows of a 2048 canvas: one row a band
    assert pr.launch_shape(32, 2048, 299, 299, 4, 132).rows == 1


def test_wrapper_checks_its_arguments():
    arena, meta = (torch.from_numpy(a) for a in _arena(_images(64, seed=4)))
    call = functools.partial(pr.preprocess_ragged, arena, meta, 64, 31, 31)
    with pytest.raises(ValueError, match="normalize mode"):
        call("imagenet")
    with pytest.raises(ValueError, match="out_dtype"):
        call("inception", torch.float16)
    with pytest.raises(TypeError, match="uint8"):
        pr.preprocess_ragged(arena.to(torch.int32), meta, 64, 31, 31)
    with pytest.raises(TypeError, match="int32"):
        pr.preprocess_ragged(arena, meta.to(torch.int64), 64, 31, 31)
    with pytest.raises(TypeError, match=r"\[K, 4\]"):
        pr.preprocess_ragged(arena, meta[:, :3].contiguous(), 64, 31, 31)
    for s in (0, pr.MAX_SIDE + 1):
        with pytest.raises(ValueError, match="canvas side"):
            pr.preprocess_ragged(arena, meta, s, 31, 31)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        pr.preprocess_ragged(arena.to("meta"), meta.to("meta"), 64, 31, 31)
    # the plain version checks the rows on the host: one that does not fit raises
    bad = meta.clone()
    bad[0, 1] = 65
    with pytest.raises(ValueError, match="does not fit"):
        pr.preprocess_ragged(arena, bad, 64, 31, 31)
    bad = meta.clone()
    bad[2, 0] = arena.numel()
    with pytest.raises(ValueError, match="does not fit"):
        pr.preprocess_ragged(arena, bad, 64, 31, 31)
    # an empty batch
    assert pr.preprocess_ragged(arena, meta[:0], 64, 31, 31).shape == (0, 31, 31, 3)


MODEL = dict(name="mobilenet_v2", source="native", zoo_width=0.25, zoo_classes=10,
             input_size=(48, 40), preprocess="caffe", topk=3, dtype="float32")


@pytest.mark.parametrize("resize", ["matmul", "gather"])
def test_cpu_engine_serves_the_plain_path_without_a_launch(resize):
    eng = InferenceEngine(tcfg.ServerConfig(model=tcfg.ModelConfig(**MODEL), canvas_buckets=(64,),
                                            max_batch=4, ragged=True, resize=resize,
                                            warmup=False), device="cpu")
    try:
        assert eng.kernels == (["preprocess_ragged"] if resize == "matmul"
                               else ["unpack_ragged"])
        images = _images(64, seed=5)[:4]
        hws = np.array([im.shape[:2] for im in images], np.int32)
        counts = (pr.preprocess_ragged.launches, timage.unpack_ragged.launches)
        scores, idx = eng.run_ragged(images, hws, 64)
        assert (pr.preprocess_ragged.launches, timage.unpack_ragged.launches) == counts
        canvases = np.stack([timage.pad_to_canvas(im, (64,))[0] for im in images])
        classic = eng.run_batch(canvases, hws)
        np.testing.assert_array_equal(idx, classic[1])
        np.testing.assert_array_equal(scores, classic[0])
        st = eng.stats()
        assert st["kernel_launches"]["preprocess_ragged"] == counts[0]
        assert st["aot_cache"]["libraries"] == eng.kernels
    finally:
        eng.close()


@pytest.mark.cuda
def test_kernel_equals_plain_on_card():
    """Runs on a machine with a CUDA card and nvcc (``chip_smoke.py --phase
    ragged_preprocess`` covers the served shapes): the kernel equals its
    plain version bit for bit in every mode, float32 and bf16, holes and
    unaligned rows included, on an arena that starts 16-byte aligned."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    for s, out in ((64, 31), (256, 299)):
        arena, meta = (torch.from_numpy(a).cuda() for a in _arena(_images(s, seed=s)))
        for mode in MODES:
            for dtype in (torch.float32, torch.bfloat16):
                before = pr.preprocess_ragged.launches
                got = pr.preprocess_ragged(arena, meta, s, out, out, mode, dtype)
                assert pr.preprocess_ragged.launches == before + 1
                want = pr.preprocess_ragged_plain(arena, meta, s, out, out, mode, dtype)
                torch.cuda.synchronize()
                assert torch.equal(got, want), (s, out, mode, dtype)
