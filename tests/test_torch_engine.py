"""The port's InferenceEngine against the JAX package's on the same
decoded images and the same seeded weights, f32, on the CPU.

yuv420 wire: the JAX engine runs the Pallas preprocess kernel interpreted
(``resize="pallas"``), the port its kernel's plain version
(``resize="kernel"`` on a CPU device). rgb wire: both run the matmul
resize. Top-k indices must match and scores agree within 1e-4. On the
yuv420 wire both engines feed the stem space-to-depth cells straight from
the preprocess (the handshake).
"""

import numpy as np
import pytest
import torch

from tensorflow_web_deploy_tpu.parallel.mesh import build_mesh
from tensorflow_web_deploy_tpu.serving.engine import InferenceEngine as JaxEngine
from tensorflow_web_deploy_tpu.utils import config as jcfg
from tensorflow_web_deploy_tpu_torch.serving.engine import InferenceEngine
from tensorflow_web_deploy_tpu_torch.utils import config as tcfg

torch.set_num_threads(2)

MODEL = dict(name="inception_v3", source="native", zoo_width=0.25, zoo_classes=10,
             input_size=(75, 75), preprocess="inception", topk=3, dtype="float32")
MOBILENET = {**MODEL, "name": "mobilenet_v2", "input_size": (64, 64)}


def _images(seed):
    rs = np.random.RandomState(seed)
    out = []
    for h, w in [(80, 72), (50, 90), (96, 96), (33, 61)]:
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        img = np.stack([yy * 2, xx * 2, 200 - yy - xx], -1) + rs.normal(0, 20, (h, w, 3))
        out.append(np.clip(img, 0, 255).astype(np.uint8))
    return out


@pytest.mark.parametrize("wire,jax_resize,port_resize,model", [
    pytest.param("yuv420", "pallas", "kernel", MODEL, id="yuv420-pallas-kernel"),
    pytest.param("rgb", "matmul", "matmul", MODEL, id="rgb-matmul-matmul"),
    pytest.param("yuv420", "pallas", "kernel", MOBILENET, id="yuv420-pallas-kernel-mobilenet_v2"),
    pytest.param("rgb", "matmul", "matmul", MOBILENET, id="rgb-matmul-matmul-mobilenet_v2"),
])
def test_engine_topk_matches_jax(wire, jax_resize, port_resize, model):
    import jax

    common = dict(canvas_buckets=(96,), max_batch=4, wire_format=wire, warmup=False)
    jeng = JaxEngine(jcfg.ServerConfig(model=jcfg.ModelConfig(**model), resize=jax_resize,
                                       **common), mesh=build_mesh(jax.devices()[:1]))
    teng = InferenceEngine(tcfg.ServerConfig(model=tcfg.ModelConfig(**model),
                                             resize=port_resize, **common), device="cpu")
    assert not teng.fused_dw and teng.parity is None  # float32 serves unfused, ungated
    images = _images(0)
    jp = [jeng.prepare(img) for img in images]
    tp = [teng.prepare(img) for img in images]
    for (cj, hj), (ct, ht) in zip(jp, tp):
        assert hj == ht
        np.testing.assert_array_equal(cj, ct)
    canvases = np.stack([c for c, _ in tp])
    hws = np.array([hw for _, hw in tp], np.int32)
    j_scores, j_idx = jeng.run_batch(canvases, hws)
    t_scores, t_idx = teng.run_batch(canvases, hws)
    assert t_scores.shape == (4, 3) and t_idx.dtype == np.int32
    np.testing.assert_array_equal(t_idx, j_idx)
    np.testing.assert_allclose(t_scores, j_scores, atol=1e-4)
    # one image at a time lands in the smallest batch bucket, padded rows
    # included in the wire buffer: same answers
    s1, i1 = teng.run_batch(canvases[1:2], hws[1:2])
    np.testing.assert_array_equal(i1[0], t_idx[1])
    np.testing.assert_allclose(s1[0], t_scores[1], atol=1e-6)


def test_engine_buckets_wire_and_stats():
    cfg = tcfg.ServerConfig(model=tcfg.ModelConfig(**MODEL), canvas_buckets=(64, 96),
                            max_batch=6, wire_format="yuv420", resize="kernel", warmup=False)
    eng = InferenceEngine(cfg, device="cpu")
    assert eng.batch_buckets == (1, 2, 4, 6) and eng.max_batch == 6
    assert eng.canvas_shape(2, 64) == (2, 96, 64)
    assert eng.packed_shape(2, 64) == (2, 96 * 64 + 4)
    eng.warmup()
    st = eng.stats()
    assert st["batches"] == 8 and st["images"] == 2 * (1 + 2 + 4 + 6)
    assert st["kernel_launches"]["preprocess_i420"] >= 0
    # a batch above the top bucket goes in chunks
    scores, idx = eng.run_batch(np.zeros((9, 96, 64), np.uint8), np.full((9, 2), 64, np.int32))
    assert scores.shape == (9, 3) and np.isfinite(scores).all()
    assert eng.healthcheck()
    with pytest.raises(ValueError, match="decode"):
        eng.prepare_bytes(b"not an image")
    eng.close()


def test_config_validation_matches_reference():
    mc = tcfg.ModelConfig(**MODEL)
    with pytest.raises(ValueError, match="yuv420"):
        tcfg.ServerConfig(model=mc, wire_format="rgb", resize="kernel")
    with pytest.raises(ValueError, match="divisible by 4"):
        tcfg.ServerConfig(model=mc, wire_format="yuv420", canvas_buckets=(98,))
    with pytest.raises(ValueError, match="caffe"):
        tcfg.ServerConfig(model=tcfg.ModelConfig(**{**MODEL, "preprocess": "caffe"}),
                          wire_format="yuv420", resize="kernel")
    with pytest.raises(ValueError, match="resize"):
        tcfg.ServerConfig(model=mc, resize="pallas")
    with pytest.raises(ValueError, match="unsupported dtype 'int4'"):
        tcfg.ModelConfig(**{**MODEL, "dtype": "int4"})
    with pytest.raises(ValueError, match="fused_dw"):
        tcfg.ModelConfig(**{**MODEL, "fused_dw": "yes"})
    for dtype in ("f32", "BF16", "int8"):
        assert tcfg.normalize_dtype(dtype) == jcfg.normalize_dtype(dtype)
    for dtype, knob in [("int8", "auto"), ("bfloat16", "auto"), ("float32", "on"),
                        ("int8", "off")]:
        want = knob == "on" or (knob == "auto" and dtype == "int8")  # engine.py:429-434
        assert tcfg.ModelConfig(**{**MODEL, "dtype": dtype, "fused_dw": knob}).fuse_depthwise is want
    for name in ("native:inception_v3", "native:mobilenet_v2"):
        native, ref = tcfg.model_config(name), jcfg.model_config(name)
        assert (native.input_size, native.preprocess, native.dtype, native.topk,
                native.fused_dw) == (ref.input_size, ref.preprocess, ref.dtype, ref.topk,
                                     ref.fused_dw)
    with pytest.raises(ValueError, match="unknown native model"):
        tcfg.model_config("native:nope")


def test_enqueue_gate_keeps_every_enqueue_out_of_a_profiler_start_and_stop():
    """The profiler route's exclusive hold waits for the enqueues inside
    and keeps new ones out until it lets go; a steady stream of enqueues
    does not starve it. Many threads, a short switch interval."""
    import sys
    import threading
    import time

    from tensorflow_web_deploy_tpu_torch.serving.engine import _EnqueueGate

    gate = _EnqueueGate()
    inside, overlaps, holds = [0], [], []
    lock, stop = threading.Lock(), threading.Event()

    def enqueue():
        while not stop.is_set():
            with gate.shared():
                with lock:
                    inside[0] += 1
                time.sleep(0.0005)
                with lock:
                    inside[0] -= 1

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    threads = [threading.Thread(target=enqueue) for _ in range(16)]
    try:
        for t in threads:
            t.start()
        for _ in range(20):
            t0 = time.monotonic()
            with gate.exclusive():
                holds.append(time.monotonic() - t0)
                for _ in range(5):
                    with lock:
                        overlaps.append(inside[0])
                    time.sleep(0.0005)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=10)
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert set(overlaps) == {0} and len(holds) == 20
    assert max(holds) < 5.0  # writers go first: never starved
