"""The engine's executables (``serving/engine.py``: one per wire kind,
canvas side and batch bucket, over one static input per side) on the CPU,
where they run the serve function on the static inputs without a CUDA
graph: bit-identical to eager dispatch on both wires, including a smaller
batch with holes after a larger one (stale bytes in the static input) and
two buckets reading prefix views of one static input; the memo's keys,
``eager_batches`` for a shape warmup never captured, and warmup's three
timed phases with one capture per engine across launch threads. The
``cuda`` tests hold graph replays against eager runs on the card for
Inception-v3 bf16 and MobileNetV2 int8 on every wire and resize, and the
unpack kernel against its plain version."""

import logging
import threading

import numpy as np
import pytest
import torch

from tensorflow_web_deploy_tpu_torch.ops import image as timage
from tensorflow_web_deploy_tpu_torch.serving.batcher import Batcher
from tensorflow_web_deploy_tpu_torch.serving.engine import InferenceEngine
from tensorflow_web_deploy_tpu_torch.utils import config as tcfg

torch.set_num_threads(2)

MODEL = dict(name="mobilenet_v2", source="native", zoo_width=0.25, zoo_classes=10,
             input_size=(64, 64), preprocess="inception", topk=3, dtype="float32")
BUCKETS = (48, 96)
WIRES = {"ragged": dict(wire_format="rgb", ragged=True),
         "ragged-gather": dict(wire_format="rgb", ragged=True, resize="gather"),
         "classic-rgb": dict(wire_format="rgb", ragged=False),
         "yuv420-kernel": dict(wire_format="yuv420", resize="kernel"),
         "yuv420-matmul": dict(wire_format="yuv420", resize="matmul"),
         "yuv420-gather": dict(wire_format="yuv420", resize="gather")}


def _engine(wire, model=MODEL, device="cpu", buckets=BUCKETS, max_batch=4, **kw):
    cfg = tcfg.ServerConfig(model=tcfg.ModelConfig(**model), canvas_buckets=buckets,
                            max_batch=max_batch, warmup=False, **{**WIRES[wire], **kw})
    return InferenceEngine(cfg, device=device)


def _images(seed, dims):
    rs = np.random.RandomState(seed)
    return [(rs.rand(h, w, 3) * 255).astype(np.uint8) for h, w in dims]


# a full batch at the top bucket, then a shorter one with a hole at slot 1
# in the same bucket (the static input keeps the first batch's bytes past
# its prefix), then two images in bucket 2 (a prefix view of the same
# static input), all in the 96 canvas
SEQUENCE = [
    (_images(0, ((96, 96), (90, 70), (81, 96), (60, 88))), ()),
    (_images(1, ((49, 50), (96, 40), (70, 70))), (1,)),
    (_images(2, ((55, 93), (96, 61))), ()),
]


def _dispatch(eng, images, holes, s=96):
    """One batch through the engine's dispatch path, holes left uncommitted."""
    if eng.ragged:
        slab = eng.acquire_ragged(s)
        for i, im in enumerate(images):
            slot, span = slab.alloc(im.size)
            span[:] = im.reshape(-1)
            if i not in holes:
                slab.write_hw(slot, im.shape[:2])
        return eng.fetch_outputs(eng.dispatch_ragged(slab, len(images)))
    slab = eng.acquire_staging(s)
    for i, im in enumerate(images):
        canvas, hw = eng.prepare(im)
        slab.canvases[i] = canvas
        if i not in holes:
            slab.write_hw(i, hw)
    return eng.fetch_outputs(eng.dispatch_staged(slab, len(images)))


@pytest.mark.parametrize("wire", list(WIRES))
def test_static_path_is_bit_identical_to_eager(wire):
    eng = _engine(wire)
    eager = [_dispatch(eng, images, holes) for images, holes in SEQUENCE]
    st = eng.stats()["graphs"]
    assert (st["eager_batches"], st["replays"], st["executables"]) == (3, 0, 0)
    eng.warmup()
    replays = eng.stats()["graphs"]["replays"]
    static = [_dispatch(eng, images, holes) for images, holes in SEQUENCE]
    st = eng.stats()["graphs"]
    assert st["replays"] == replays + 3 and st["eager_batches"] == 3
    for (se, ie), (ss, is_) in zip(eager, static):
        np.testing.assert_array_equal(is_, ie)
        np.testing.assert_array_equal(ss, se)
    # the CPU runs the executables without capture
    assert st["captured"] == 0 and st["pool_bytes"] == 0
    # one static input per canvas side, at the top bucket's capacity: buckets
    # 4 and 2 above read prefix views of the 96 side's
    kind = "ragged" if eng.ragged else "classic"
    static = eng._replicas[0].shards[0].static  # the one device of the one replica
    assert sorted(static) == [(kind, s) for s in BUCKETS]
    assert st["static_bytes"] == sum(t.nbytes for t in static.values())
    eng.close()


def test_memo_keys_and_eager_batches():
    eng = _engine("ragged")
    eng.warmup()
    exes = eng._replicas[0].shards[0].exes  # the one device of the one replica
    assert sorted(exes) == sorted(("ragged", s, b) for s in BUCKETS
                                  for b in eng.batch_buckets)
    assert all(e.key == k and e.graph is None for k, e in exes.items())
    st = eng.stats()["graphs"]
    n = len(BUCKETS) * len(eng.batch_buckets)
    assert (st["executables"], st["replays"], st["eager_batches"]) == (n, n, 0)
    # a caller's own canvas side, never captured: the same function, eagerly
    images = _images(5, ((30, 20), (40, 44)))
    hws = np.array([im.shape[:2] for im in images], np.int32)
    got = eng.run_ragged(images, hws, 44)
    assert eng.stats()["graphs"]["eager_batches"] == 1
    want = eng.run_ragged(images, hws, 48)  # the same pixels in a captured side
    assert eng.stats()["graphs"]["replays"] == n + 1
    assert got[0].shape == want[0].shape == (2, 3)
    eng.close()


def test_warmup_phases_and_one_capture_per_engine(caplog, monkeypatch):
    eng = _engine("ragged")
    captures = []
    real = eng._capture

    def counted(*key):
        captures.append(key[:3])  # (kind, side, rows); the last is the device's shard
        return real(*key)

    monkeypatch.setattr(eng, "_capture", counted)
    with caplog.at_level(logging.INFO, logger="tpu_serve_torch.engine"):
        batcher = Batcher(eng).start(warmup=True)  # every launch thread warms
        batcher.stop()
    n = len(BUCKETS) * len(eng.batch_buckets)
    assert len(captures) == n  # once per engine, whichever thread came first
    assert captures[0] == ("ragged", 96, 4) and captures[-1] == ("ragged", 48, 1)  # largest first
    lines = [r.getMessage() for r in caplog.records if r.getMessage().startswith("warmup:")]
    assert [ln.split(" ")[1] for ln in lines] == ["one-time", "executables", "execution",
                                                  "execution"]
    phases = eng.stats()["warmup_s"]
    assert phases["one_time"] >= 0 and phases["executables"] >= 0
    assert len(phases["execution"]) == 2  # one pass per launch thread
    st = eng.stats()["graphs"]
    assert st["replays"] == 2 * n and st["eager_batches"] == 0
    # a later call captures nothing and runs the execution pass alone
    eng.warmup()
    assert len(captures) == n and len(eng.stats()["warmup_s"]["execution"]) == 3
    eng.close()


def test_engine_stats_carry_the_cache_and_graph_blocks():
    eng = _engine("yuv420-kernel", aot_cache_dir="0")
    st = eng.stats()
    assert st["aot_cache"]["enabled"] is False and st["aot_cache"]["dir"] is None
    assert st["aot_cache"]["libraries"] == ["preprocess_i420"]
    assert set(st["graphs"]) == {"captured", "executables", "replays", "eager_batches",
                                 "capture_s", "pool_bytes", "static_bytes",
                                 "memory_allocated", "memory_reserved"}
    # the process's device memory: none on the CPU
    assert st["graphs"]["memory_allocated"] is st["graphs"]["memory_reserved"] is None
    assert st["kernel_launches"].keys() == {"preprocess_i420", "fused_dw", "unpack_ragged",
                                            "preprocess_ragged", "nms_fixed"}
    eng.close()


def test_stats_holds_no_executable_past_its_lock(monkeypatch):
    """A ``stats()`` that is still running when ``close()`` drops the
    executables (``GET /models`` on a draining version) holds none of them
    afterwards: on the card a graph it held would keep its pool from being
    given back at close."""
    import gc
    import weakref

    from tensorflow_web_deploy_tpu_torch.serving import engine as engine_mod

    eng = _engine("ragged")
    eng.warmup()
    refs = [weakref.ref(e) for e in eng._replicas[0].shards[0].exes.values()]
    inside, go_on = threading.Event(), threading.Event()
    real_stats = engine_mod.aotcache.stats

    def held_stats(cache):  # stats() is past its lock section here
        inside.set()
        assert go_on.wait(30)
        return real_stats(cache)

    monkeypatch.setattr(engine_mod.aotcache, "stats", held_stats)
    out = {}
    reader = threading.Thread(target=lambda: out.update(eng.stats()))
    reader.start()
    try:
        assert inside.wait(30)
        eng.close()
        gc.collect()
        alive = sum(r() is not None for r in refs)
    finally:
        go_on.set()
        reader.join(30)
    assert refs and alive == 0
    assert out["graphs"]["executables"] == len(refs)


# ------------------------------------------------------------------ the card


CARD_MODELS = {
    "inception_v3-bf16": dict(MODEL, name="inception_v3", input_size=(75, 75),
                              dtype="bfloat16"),
    "mobilenet_v2-int8": dict(MODEL, dtype="int8"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("wire", list(WIRES))
@pytest.mark.parametrize("model", list(CARD_MODELS))
def test_replay_equals_eager_on_card(model, wire):
    """Runs on a machine with a CUDA card and nvcc: the same batches
    eagerly, then as graph replays, bit for bit; kernel launches counted
    per replay as eager counts them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from tensorflow_web_deploy_tpu_torch.ops.fused_dw import fused_dw
    from tensorflow_web_deploy_tpu_torch.ops.image import unpack_ragged
    from tensorflow_web_deploy_tpu_torch.ops.preprocess_i420 import preprocess_i420
    from tensorflow_web_deploy_tpu_torch.ops.preprocess_ragged import preprocess_ragged

    counters = (preprocess_i420, fused_dw, unpack_ragged, preprocess_ragged)
    eng = _engine(wire, CARD_MODELS[model], device="cuda")
    before = [c.launches for c in counters]
    eager = [_dispatch(eng, images, holes) for images, holes in SEQUENCE]
    per_eager = [c.launches - b for c, b in zip(counters, before)]
    eng.warmup()
    assert eng.stats()["graphs"]["captured"] == len(BUCKETS) * len(eng.batch_buckets)
    before = [c.launches for c in counters]
    static = [_dispatch(eng, images, holes) for images, holes in SEQUENCE]
    assert [c.launches - b for c, b in zip(counters, before)] == per_eager
    for (se, ie), (ss, is_) in zip(eager, static):
        np.testing.assert_array_equal(is_, ie)
        np.testing.assert_array_equal(ss, se)
    st = eng.stats()["graphs"]
    assert st["pool_bytes"] > 0 and st["eager_batches"] == 3
    eng.close()


@pytest.mark.cuda
def test_a_second_thread_only_replays_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    eng = _engine("ragged", CARD_MODELS["mobilenet_v2-int8"], device="cuda")
    threads = [threading.Thread(target=eng.warmup) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    st = eng.stats()
    n = len(BUCKETS) * len(eng.batch_buckets)
    assert st["graphs"]["captured"] == n and st["graphs"]["replays"] == 2 * n
    assert len(st["warmup_s"]["execution"]) == 2
    eng.close()


@pytest.mark.cuda
def test_close_gives_the_graph_pool_back_on_card():
    """``close()`` drops the graphs, static inputs and weights and returns
    the freed segments: allocated memory falls by at least the static
    bytes, reserved by at least those and the graph pool's bytes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    eng = _engine("ragged", CARD_MODELS["mobilenet_v2-int8"], device="cuda")
    eng.warmup()
    st = eng.stats()["graphs"]
    torch.cuda.synchronize()
    allocated, reserved = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    assert (st["memory_allocated"], st["memory_reserved"]) == (allocated, reserved)
    eng.close()
    assert st["pool_bytes"] > 0 and st["static_bytes"] > 0
    assert eng.pool_bytes == 0  # no segment of the pool is left
    assert allocated - torch.cuda.memory_allocated() >= st["static_bytes"]
    assert reserved - torch.cuda.memory_reserved() >= st["pool_bytes"] + st["static_bytes"]


@pytest.mark.cuda
def test_close_gives_memory_back_beside_a_later_engine_on_card():
    """An engine's weights and static inputs lie in its own pool: an engine
    built after it, and a tensor made in the freed blocks of a third one,
    never share its segments, so its close still returns its graph pool,
    static inputs and weights whole while the later engine serves."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    first = _engine("ragged", CARD_MODELS["mobilenet_v2-int8"], device="cuda")
    first.warmup()
    gone = _engine("ragged", CARD_MODELS["inception_v3-bf16"], device="cuda")
    gone.warmup()
    later = _engine("ragged", CARD_MODELS["inception_v3-bf16"], device="cuda")
    gone.close()
    later.warmup()
    filler = [torch.empty(1 << 20, dtype=torch.uint8, device="cuda") for _ in range(64)]
    st = first.stats()["graphs"]
    weights = sum(p.nbytes for p in first.model.state_dict().values())
    torch.cuda.synchronize()
    allocated, reserved = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    first.close()
    assert first.pool_bytes == 0
    assert allocated - torch.cuda.memory_allocated() >= st["static_bytes"] + weights
    assert reserved - torch.cuda.memory_reserved() >= (
        st["pool_bytes"] + st["static_bytes"] + weights)
    assert len(filler) == 64 and later.stats()["graphs"]["captured"] > 0
    later.close()


def _arena(images, holes=(), slack=0):
    """``images`` packed tight, back to back, with ``slack`` random bytes
    after them; slots in ``holes`` keep their bytes but stay invalid."""
    used = sum(im.size for im in images)
    arena = np.random.RandomState(1).randint(0, 256, used + slack).astype(np.uint8)
    meta = np.zeros((len(images), 4), np.int32)
    off = 0
    for i, im in enumerate(images):
        arena[off : off + im.size] = im.reshape(-1)
        meta[i] = (off, im.shape[0], im.shape[1], 0 if i in holes else 1)
        off += im.size
    return arena, meta


@pytest.mark.cuda
def test_unpack_kernel_matches_plain_on_card():
    """Runs on a machine with a CUDA card and nvcc (chip_smoke.py covers the
    main paths' batches): the kernel against its plain version bit for bit,
    with holes, odd offsets, an image ending at the arena's last byte, a
    canvas side that is not a multiple of 4 (byte stores), and one launch
    a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    for s, slack in ((96, 0), (96, 5000), (50, 3), (2, 0)):
        dims = ((s, s), (s - 1, 3), (1, 1), (s // 2 + 1, s - 3)) if s > 2 else ((2, 1), (1, 2))
        images = _images(9, dims)
        for holes in ((), (1,)):
            arena, meta = _arena(images, holes, slack)
            a = torch.from_numpy(arena).cuda()
            m = torch.from_numpy(meta).cuda()
            before = timage.unpack_ragged.launches
            got_c, got_hw = timage.unpack_ragged(a, m, s)
            assert timage.unpack_ragged.launches == before + 1
            want_c, want_hw = timage.unpack_ragged_plain(a.cpu(), m.cpu(), s)
            torch.cuda.synchronize()
            assert torch.equal(got_c.cpu(), want_c) and torch.equal(got_hw.cpu(), want_hw)
            # a view starting at a 4-byte aligned offset into a larger buffer
            pad = torch.full((4 + arena.size,), 255, dtype=torch.uint8, device="cuda")
            pad[4:] = a
            moved = m.clone()
            got2, _ = timage.unpack_ragged(pad[4:], moved, s)
            assert torch.equal(got2.cpu(), want_c)
