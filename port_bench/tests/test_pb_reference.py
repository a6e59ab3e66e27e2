"""The plain reference against the program's engine at a tiny width on the
CPU, on the benchmark's own weights and photos (the test imports both; the
reference imports nothing of the program)."""

from __future__ import annotations

import ast

import numpy as np
import pytest
import torch
from conftest import BENCH
from yardstick import judge, photos, reference, weights

SPEC = {"conv_gain": 2 ** 0.5, "bn_scale": [0.8, 1.2], "bn_var": [0.8, 1.2], "bn_shift_std": 0.05}
TRAFFIC = {"generator": "smooth_edges", "sizes": [[320, 240], [384, 512]], "pool_per_size": 3,
           "jpeg_quality": 90}


def engine_answers(name, mode, export, pool, k):
    from tensorflow_web_deploy_tpu_torch.serving.engine import InferenceEngine
    from tensorflow_web_deploy_tpu_torch.utils.config import ModelConfig, ServerConfig

    size = reference.INPUT_SIZE[name]
    mc = ModelConfig(name=name, zoo_width=0.25, zoo_classes=10, input_size=(size, size),
                     preprocess=mode, topk=k, dtype="float32", ckpt_path=str(export))
    eng = InferenceEngine(ServerConfig(model=mc, canvas_buckets=(512,), max_batch=8,
                                       warmup=False, ragged=True), device="cpu")
    try:
        images = [reference.decode(p.jpeg) for p in pool]
        hws = np.asarray([im.shape[:2] for im in images], np.int32)
        scores, idx = eng.run_ragged(images, hws, 512)
    finally:
        eng.close()
    return idx.astype(np.int64), scores.astype(np.float64)


@pytest.mark.parametrize("name,mode,mult", [
    ("inception_v3", "inception", {"params/logits/kernel": 8.0}),
    ("resnet50", "caffe", {"params/stem/conv/kernel": 1 / 64, "/conv3/bn/scale": 0.25}),
])
def test_reference_matches_the_engine(tmp_path, name, mode, mult):
    torch.manual_seed(0)
    params = weights.make_weights(name, 2**31 + 3, {**SPEC, "multipliers": mult}, 0.25, 10)
    weights.write_export(str(tmp_path), params, 10)
    pool = photos.make_pool(TRAFFIC, 5)
    idx, scores = engine_answers(name, mode, tmp_path, pool, 5)
    ref = reference.probabilities(name, params, [p.jpeg for p in pool], width=0.25, classes=10,
                                  mode=mode)
    g = judge.gaps(np.arange(len(pool)), idx, scores, ref)
    assert g["answer_gap"] < 1e-4, g
    # not one-hot: the answers carry digits to compare
    assert 0.05 < ref.max(axis=1).min() and ref.max(axis=1).max() < 0.99
    # the control in emulated TF32 lies well away
    low = reference.probabilities(name, params, [p.jpeg for p in pool], width=0.25, classes=10,
                                  mode=mode, precision="tf32")
    cidx, cscores = judge.topk(low, 5)
    c = judge.gaps(np.arange(len(pool)), cidx, cscores.astype(np.float32).astype(np.float64), ref)
    assert c["answer_gap"] > 10 * g["answer_gap"], (c, g)


def test_same_seed_same_weights_and_photos():
    a = weights.make_weights("resnet50", 2**31 + 9, {**SPEC, "multipliers": {}}, 0.25, 10)
    b = weights.make_weights("resnet50", 2**31 + 9, {**SPEC, "multipliers": {}}, 0.25, 10)
    c = weights.make_weights("resnet50", 4, {**SPEC, "multipliers": {}}, 0.25, 10)
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert not np.array_equal(a["params/stem/conv/kernel"], c["params/stem/conv/kernel"])
    assert [p.jpeg for p in photos.make_pool(TRAFFIC, -7)] == [
        p.jpeg for p in photos.make_pool(TRAFFIC, -7)]


def test_resize_is_half_pixel_bilinear_clamped():
    img = np.arange(4 * 6 * 3, dtype=np.uint8).reshape(4, 6, 3)
    same = reference.resize(img, 4)[:, :4]
    assert same.shape == (4, 4, 3)
    up = reference.resize(np.array([[[0], [100]]], np.uint8).repeat(3, 2), 4)
    # x coordinates (i + 0.5) / 2 - 0.5 = -0.25, 0.25, 0.75, 1.25, clamped to [0, 1]
    np.testing.assert_allclose(up[0, :, 0], [0.0, 25.0, 75.0, 100.0])


def test_the_yardstick_imports_nothing_of_the_program():
    banned = {"tensorflow_web_deploy_tpu", "tensorflow_web_deploy_tpu_torch", "jax", "jaxlib",
              "flax", "tools", "chip_smoke", "bench"}
    files = [*(BENCH / "yardstick").glob("*.py"), *(BENCH / "metrics").glob("*.py"),
             BENCH / "run.py", BENCH / "control.py"]
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                tops = {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                tops = {node.module.split(".")[0]}
            else:
                continue
            assert not tops & banned, (f.name, tops)
