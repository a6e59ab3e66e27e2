"""The port's InferenceEngine against the JAX package's on the same
decoded images and the same seeded weights, f32, on the CPU.

yuv420 wire: the JAX engine runs the Pallas preprocess kernel interpreted
(``resize="pallas"``), the port its kernel's plain version
(``resize="kernel"`` on a CPU device). rgb wire: both run the matmul
resize. Top-k indices must match and scores agree within 1e-4.
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


def _images(seed):
    rs = np.random.RandomState(seed)
    out = []
    for h, w in [(80, 72), (50, 90), (96, 96), (33, 61)]:
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        img = np.stack([yy * 2, xx * 2, 200 - yy - xx], -1) + rs.normal(0, 20, (h, w, 3))
        out.append(np.clip(img, 0, 255).astype(np.uint8))
    return out


@pytest.mark.parametrize("wire,jax_resize,port_resize", [
    ("yuv420", "pallas", "kernel"),
    ("rgb", "matmul", "matmul"),
])
def test_engine_topk_matches_jax(wire, jax_resize, port_resize):
    import jax

    common = dict(canvas_buckets=(96,), max_batch=4, wire_format=wire, warmup=False)
    jeng = JaxEngine(jcfg.ServerConfig(model=jcfg.ModelConfig(**MODEL), resize=jax_resize,
                                       **common), mesh=build_mesh(jax.devices()[:1]))
    teng = InferenceEngine(tcfg.ServerConfig(model=tcfg.ModelConfig(**MODEL),
                                             resize=port_resize, **common), device="cpu")
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
    with pytest.raises(ValueError, match="dtype"):
        tcfg.ModelConfig(**{**MODEL, "dtype": "int8"})
    native = tcfg.model_config("native:inception_v3")
    ref = jcfg.model_config("native:inception_v3")
    assert (native.input_size, native.preprocess, native.dtype, native.topk) == (
        ref.input_size, ref.preprocess, ref.dtype, ref.topk)
    with pytest.raises(ValueError, match="unknown native model"):
        tcfg.model_config("native:nope")
