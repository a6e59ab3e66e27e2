"""The port's ragged wire and gather resize against the JAX package's, on
the CPU: ``unpack_ragged`` (bit-identical, holes and partial arenas
included), ``fit_to_bucket`` (identical), ``resize_from_valid`` (gather,
within 1e-5) and ``yuv420_to_rgb`` (within 1e-4); a small engine whose
ragged dispatch answers like its classic rgb dispatch and like the JAX
engine on the same weights; the yuv420 fallback to the classic wire; the
CLI's defaults; and an end-to-end POST through a ragged server.
"""

import io
import json
import logging
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tensorflow_web_deploy_tpu.ops import image as jimage
from tensorflow_web_deploy_tpu.parallel.mesh import build_mesh
from tensorflow_web_deploy_tpu.serving.engine import InferenceEngine as JaxEngine
from tensorflow_web_deploy_tpu.utils import config as jcfg
from tensorflow_web_deploy_tpu_torch.ops import image as timage
from tensorflow_web_deploy_tpu_torch.server import config_from_args, parse_args, start_server
from tensorflow_web_deploy_tpu_torch.serving.engine import InferenceEngine, RaggedSlab
from tensorflow_web_deploy_tpu_torch.utils import config as tcfg

torch.set_num_threads(2)

MODEL = dict(name="mobilenet_v2", source="native", zoo_width=0.25, zoo_classes=10,
             input_size=(64, 64), preprocess="inception", topk=3, dtype="float32")
CANVAS = 96


def _images(seed, dims=((96, 96), (72, 48), (48, 64), (17, 23), (95, 33))):
    rs = np.random.RandomState(seed)
    return [(rs.rand(h, w, 3) * 255).astype(np.uint8) for h, w in dims]


def _arena(images, s, holes=(), slack=0):
    """Pack ``images`` tight, back to back, as the ragged wire does; slots
    in ``holes`` keep their bytes but stay invalid. ``slack`` extra bytes
    after the used prefix (a partial arena)."""
    used = sum(im.size for im in images)
    arena = np.random.RandomState(1).randint(0, 256, used + slack).astype(np.uint8)
    meta = np.zeros((len(images), 4), np.int32)
    off = 0
    for i, im in enumerate(images):
        arena[off : off + im.size] = im.reshape(-1)
        meta[i] = (off, im.shape[0], im.shape[1], 0 if i in holes else 1)
        off += im.size
    return arena, meta


@pytest.mark.parametrize("holes,slack", [((), 0), ((1, 3), 0), ((), 5000), ((0, 4), 123)],
                         ids=["full", "holes", "partial", "holes-partial"])
def test_unpack_ragged_is_bit_identical_to_jax(holes, slack):
    images = _images(0)
    arena, meta = _arena(images, CANVAS, holes, slack)
    want_c, want_hw = (np.asarray(a) for a in jimage.unpack_ragged(arena, meta, CANVAS))
    got_c, got_hw = timage.unpack_ragged(torch.from_numpy(arena), torch.from_numpy(meta), CANVAS)
    assert got_c.dtype == torch.uint8 and got_hw.dtype == torch.int32
    np.testing.assert_array_equal(got_c.numpy(), want_c)
    np.testing.assert_array_equal(got_hw.numpy(), want_hw)
    # and both are the host's pad_to_canvas of the same pixels; holes are
    # zero canvases with hw (1, 1)
    for i, im in enumerate(images):
        if i in holes:
            assert not got_c[i].any() and got_hw[i].tolist() == [1, 1]
        else:
            canvas, hw = timage.pad_to_canvas(im, (CANVAS,))
            np.testing.assert_array_equal(got_c[i].numpy(), canvas)
            assert tuple(got_hw[i].tolist()) == hw
    # the unpack reads the table on the device, so bytes of the arena that no
    # valid row spans (a hole's, the slack's: stale bytes of an earlier batch)
    # never reach the canvases
    stale = arena.copy()
    for i, (off, h, w, valid) in enumerate(meta.tolist()):
        if not valid:
            stale[off : off + h * w * 3] = 255
    stale[sum(im.size for im in images):] = 255
    again, _ = timage.unpack_ragged(torch.from_numpy(stale), torch.from_numpy(meta), CANVAS)
    assert torch.equal(again, got_c)
    # on CPU tensors the wrapper is the plain version, the reference's gather
    plain_c, plain_hw = timage.unpack_ragged_plain(torch.from_numpy(arena),
                                                   torch.from_numpy(meta), CANVAS)
    assert torch.equal(plain_c, got_c) and torch.equal(plain_hw, got_hw)


@pytest.mark.parametrize("row", [(0, 97, 10, 1), (0, 10, 97, 1), (-1, 4, 4, 1),
                                 (10**6, 4, 4, 1)])
def test_unpack_ragged_rejects_rows_that_do_not_fit(row):
    arena = torch.zeros(CANVAS * CANVAS * 3, dtype=torch.uint8)
    with pytest.raises(ValueError, match="does not fit"):
        timage.unpack_ragged(arena, torch.tensor([row], dtype=torch.int32), CANVAS)


@pytest.mark.parametrize("row", [(0, 97, 10), (0, 10, 97), (-1, 4, 4), (27000, 40, 40)])
def test_dispatch_ragged_checks_rows_on_the_host(row):
    """The device unpack reads the meta table unchecked, so a committed row
    that does not fit its canvas or the shipped arena raises at dispatch;
    the slab goes back to its pool."""
    _, teng = _pair()
    slab = teng.acquire_ragged(CANVAS)
    slot, _ = slab.alloc(300)
    slab.meta[slot] = (row[0], row[1], row[2], 1)
    with pytest.raises(ValueError, match="does not fit"):
        teng.dispatch_ragged(slab, 1)
    teng.release_staging(slab)
    assert teng.stats()["batches"] == 0 and teng.stats()["slabs"]["pooled"] == 1
    teng.close()


def test_a_reused_arena_answers_like_a_fresh_one():
    """A pooled slab keeps its last batch's bytes: a smaller batch with a
    hole in the same (reused) arena answers as in a fresh engine."""
    big = _images(7, ((96, 96), (90, 80), (70, 96), (96, 50), (33, 40)))
    small = _images(8, ((20, 30), (41, 17), (12, 90)))

    def run(eng, images, holes=()):
        slab = eng.acquire_ragged(CANVAS)
        for i, im in enumerate(images):
            slot, span = slab.alloc(im.size)
            span[:] = im.reshape(-1)
            if i not in holes:
                slab.write_hw(slot, im.shape[:2])
        return eng.fetch_outputs(eng.dispatch_ragged(slab, len(images)))

    _, reused = _pair()
    run(reused, big)
    assert reused.stats()["slabs"]["allocated"] == 1
    got = run(reused, small, holes=(1,))
    assert reused.stats()["slabs"]["allocated"] == 1  # the same slab, stale bytes and all
    _, fresh = _pair()
    want = run(fresh, small, holes=(1,))
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])
    reused.close()
    fresh.close()


@pytest.mark.parametrize("h,w", [(20, 30), (64, 64), (200, 100), (65, 300), (1, 500)])
def test_fit_to_bucket_matches_jax(h, w):
    img = (np.random.RandomState(h + w).rand(h, w, 3) * 255).astype(np.uint8)
    got, want = timage.fit_to_bucket(img, (32, 64)), jimage.fit_to_bucket(img, (32, 64))
    assert got[1:] == want[1:]
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0].flags["C_CONTIGUOUS"] and got[0].shape[:2] == got[1]


@pytest.mark.parametrize("hw", [(1, 1), (17, 23), (33, 61), (95, 3), (96, 96), (63, 64)])
@pytest.mark.parametrize("out", [(64, 64), (75, 41)])
def test_gather_resize_matches_jax(hw, out):
    canvas = (np.random.RandomState(sum(hw)).rand(1, CANVAS, CANVAS, 3) * 255).astype(np.uint8)
    hws = np.array([hw], np.int32)
    want = np.asarray(jimage.resize_from_valid(canvas[0], hws[0], *out))
    got = timage.resize_from_valid(torch.from_numpy(canvas), torch.from_numpy(hws), *out)
    assert got.dtype == torch.float32 and got.shape == (1, *out, 3)
    np.testing.assert_allclose(got[0].numpy(), want, atol=1e-5, rtol=0)
    # the matmul resize computes the same taps
    mm = timage.resize_from_valid_mm(torch.from_numpy(canvas), torch.from_numpy(hws), *out)
    np.testing.assert_allclose(got.numpy(), mm.numpy(), atol=1e-3, rtol=0)


def test_yuv420_to_rgb_matches_jax():
    rs = np.random.RandomState(4)
    packed = (rs.rand(2, 3 * 64 // 2, 64) * 255).astype(np.uint8)
    got = timage.yuv420_to_rgb(torch.from_numpy(packed), 64)
    assert got.shape == (2, 64, 64, 3)
    for i in range(2):
        want = np.asarray(jimage.yuv420_to_rgb(jnp.asarray(packed[i]), 64))
        np.testing.assert_allclose(got[i].numpy(), want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("wire", ["rgb", "yuv420"])
def test_gather_preprocess_fn_matches_jax(wire):
    rs = np.random.RandomState(5)
    shape = (3, CANVAS * 3 // 2, CANVAS) if wire == "yuv420" else (3, CANVAS, CANVAS, 3)
    canvases = (rs.rand(*shape) * 255).astype(np.uint8)
    hws = np.array([[96, 96], [41, 77], [9, 13]], np.int32)
    want = np.asarray(jimage.make_preprocess_fn(64, 64, "inception", wire=wire,
                                                resize="gather")(canvases, hws))
    got = timage.make_preprocess_fn(64, 64, "inception", wire=wire, resize="gather")(
        torch.from_numpy(canvases), torch.from_numpy(hws))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_slab_packs_tight_and_ships_meta_after_the_prefix():
    slab = RaggedSlab(16, capacity=8, pinned=False)
    images = _images(2, dims=((16, 16), (5, 7), (9, 3)))
    for im in images:
        i, span = slab.alloc(im.size)
        span[:] = im.reshape(-1)
        slab.write_hw(i, im.shape[:2])
    hole, _ = slab.alloc(11)  # allocated, never committed
    assert slab.used == sum(im.size for im in images) + 11 and slab.slots == 4
    assert slab.rows_shipped(4) == 2  # 11 bytes past one canvas row, q = 1
    assert slab.rows_shipped(32) == 4  # q = 4 rows at bucket 32
    nbytes, meta_off = slab.stage(4)
    assert meta_off % 16 == 0 and meta_off >= 2 * slab.row_bytes and nbytes == meta_off + 64
    meta = slab.host[meta_off:nbytes].view(np.int32).reshape(4, 4)
    assert meta[hole].tolist() == [slab.used - 11, 0, 0, 0]
    assert meta[1].tolist() == [16 * 16 * 3, 5, 7, 1]
    assert slab.alloc(8 * slab.row_bytes) is None  # out of bytes
    slab.reset()
    assert slab.used == slab.slots == 0 and not slab.meta.any()


def _pair(model=MODEL, resize="matmul"):
    jeng = JaxEngine(jcfg.ServerConfig(model=jcfg.ModelConfig(**model), canvas_buckets=(CANVAS,),
                                       max_batch=8, batch_buckets=(8,), ragged=True,
                                       resize=resize, warmup=False),
                     mesh=build_mesh(jax.devices()[:1]))
    params = {k: np.asarray(v) for k, v in jeng.model.params.items()}
    teng = InferenceEngine(tcfg.ServerConfig(model=tcfg.ModelConfig(**model),
                                             canvas_buckets=(CANVAS,), max_batch=8, ragged=True,
                                             resize=resize, warmup=False),
                           device="cpu", params_flat=params)
    return jeng, teng


@pytest.mark.parametrize("resize", ["matmul", "gather"])
@pytest.mark.parametrize("name", ["mobilenet_v2", "inception_v3"])
def test_ragged_engine_matches_classic_and_jax(name, resize):
    model = {**MODEL, "name": name, "input_size": (75, 75) if name == "inception_v3" else (64, 64)}
    jeng, teng = _pair(model, resize)
    assert teng.ragged and jeng.ragged
    images = _images(3)
    hws = np.array([im.shape[:2] for im in images], np.int32)
    got = teng.run_ragged(images, hws, CANVAS)
    canvases = np.stack([timage.pad_to_canvas(im, (CANVAS,))[0] for im in images])
    classic = teng.run_batch(canvases, hws)
    # the same canvases reach the same serve path: identical answers
    np.testing.assert_array_equal(got[1], classic[1])
    np.testing.assert_array_equal(got[0], classic[0])
    slab = jeng.acquire_ragged(len(images), CANVAS)
    for im in images:
        i, view = slab.alloc(im.size)
        view[:] = im.reshape(-1)
        slab.write_hw(i, im.shape[:2])
    j_scores, j_idx = jeng.fetch_outputs(jeng.dispatch_ragged(slab, len(images)))
    assert got[0].shape == (5, 3) and got[1].dtype == np.int32
    np.testing.assert_array_equal(got[1], j_idx)
    np.testing.assert_allclose(got[0], j_scores, atol=1e-4)
    st = teng.stats()
    assert st["ragged"] and st["batches"] == 2 and st["images"] == 10
    teng.close()
    jeng.close()


def test_ragged_hole_answers_like_a_solo_batch():
    _, teng = _pair()
    img = _images(6)[1]
    solo = teng.run_batch(timage.pad_to_canvas(img, (CANVAS,))[0][None],
                          np.array([img.shape[:2]], np.int32))
    slab = teng.acquire_ragged(CANVAS)
    slab.alloc(300)  # a hole before the image, its bytes left as they were
    i, span = slab.alloc(img.size)
    span[:] = img.reshape(-1)
    slab.write_hw(i, img.shape[:2])
    scores, idx = teng.fetch_outputs(teng.dispatch_ragged(slab, 2))
    np.testing.assert_array_equal(idx[1], solo[1][0])
    np.testing.assert_allclose(scores[1], solo[0][0], atol=1e-6)
    teng.close()


def test_yuv420_ragged_serves_the_classic_wire_with_a_warning(caplog):
    cfg = tcfg.ServerConfig(model=tcfg.ModelConfig(**MODEL), canvas_buckets=(CANVAS,),
                            max_batch=2, wire_format="yuv420", ragged=True, warmup=False)
    with caplog.at_level(logging.WARNING, logger="tpu_serve_torch.engine"):
        eng = InferenceEngine(cfg, device="cpu")
    assert not eng.ragged and "requires wire_format='rgb'" in caplog.text
    jeng = JaxEngine(jcfg.ServerConfig(model=jcfg.ModelConfig(**MODEL), canvas_buckets=(CANVAS,),
                                       max_batch=2, wire_format="yuv420", ragged=True,
                                       warmup=False), mesh=build_mesh(jax.devices()[:1]))
    assert not jeng.ragged  # the reference does the same
    assert eng.stats()["ragged"] is False
    eng.close()
    jeng.close()


def test_server_cli_defaults_to_the_ragged_rgb_wire():
    cfg = config_from_args(parse_args([]))
    assert cfg.ragged and (cfg.wire_format, cfg.resize) == ("rgb", "matmul")
    assert cfg.model.name == "inception_v3"
    assert not config_from_args(parse_args(["--no-ragged"])).ragged
    assert config_from_args(parse_args(["--resize", "gather"])).resize == "gather"
    assert tcfg.ServerConfig(model=tcfg.ModelConfig(**MODEL)).ragged is False  # dataclass
    with pytest.raises(SystemExit):
        parse_args(["--resize", "pallas"])


def _jpeg(h, w, seed):
    img = (np.random.RandomState(seed).rand(h, w, 3) * 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG")
    return buf.getvalue()


def _png(h, w, seed):
    img = (np.random.RandomState(seed).rand(h, w, 3) * 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "PNG")
    return buf.getvalue()


def _post(url, data):
    req = urllib.request.Request(url, data=data, method="POST",
                                 headers={"Content-Type": "image/jpeg"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_post_through_the_ragged_server():
    args = parse_args(["--model", "native:mobilenet_v2", "--dtype", "f32", "--zoo-width", "0.25",
                       "--zoo-classes", "10", "--canvas-buckets", "64,128", "--max-batch", "4",
                       "--resize", "gather", "--host", "127.0.0.1", "--port", "0"])
    cfg = config_from_args(args)
    cfg.model.input_size = (64, 64)
    with start_server(cfg, device="cpu") as srv:
        bodies = [_jpeg(50, 60, 1), _jpeg(120, 90, 2), _png(40, 30, 3), _jpeg(300, 200, 4)]
        answers = [_post(srv.url + "/predict", b) for b in bodies]
        assert all(s == 200 and len(a["predictions"]) == 5 for s, a in answers)
        status, body = _post(srv.url + "/predict", b"\xff\xd8 not an image")
        assert status == 400 and "decode" in body["error"]
        with urllib.request.urlopen(srv.url + "/stats") as r:
            stats = json.loads(r.read())
        # the same image answers the same on the classic wire of the same weights
        engine = srv.engine
        tight, hw, s, _ = engine.prepare_ragged(bodies[1])
        canvas, hw2, _ = engine.prepare_bytes(bodies[1])
        assert hw == hw2 and s == canvas.shape[0] == 128
        idx_classic = engine.run_batch(canvas[None], np.array([hw], np.int32))[1][0]
    eng = stats["engine"]
    assert eng["ragged"] and eng["resize"] == "gather" and eng["wire_format"] == "rgb"
    assert eng["decodes"] == {"native": 3, "pil": 1}  # the PNG
    assert eng["decoder"]["available"] and eng["h2d_bytes"] > 0
    assert eng["kernel_launches"] == {"preprocess_i420": 0, "fused_dw": 0,
                                         "unpack_ragged": 0, "preprocess_ragged": 0,
                                         "nms_fixed": 0}  # CPU: plain
    assert [p["index"] for p in answers[1][1]["predictions"]] == idx_classic.tolist()
