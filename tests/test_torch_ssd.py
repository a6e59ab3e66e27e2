"""The port's SSD-MobileNet detector (models/ssd_mobilenet.py) and its
detect path against the JAX package's, on the CPU: the anchors, seeded
init leaf by leaf, weight carry-over (raw outputs at an even and an odd
size), the engine's four arrays against the JAX engine's on the rgb,
ragged and yuv420 wires, the int8 gate's verdict, the heads' int8
quantization, ``/predict`` through both packages' Apps, the config, the
quantized-variant lookup and the cost walker. Small size: width 0.25, 6
classes, 64 px (96 px canvases), except where the gate's verdict needs
the reference's width or size.

**The anchor scene** is the bit-for-bit check: head kernels zero, both
``loc`` biases zero and distinct ``cls`` biases exactly representable in
bf16, the background lower. The raw outputs are then constants whatever
the backbone, every decoded box is its anchor, and ties between positions
of one anchor shape go to the lower index. :func:`scene_expectation`
computes the detections on the host in numpy (``chip_smoke.py`` holds the
card to the same expectation). The scene's biases are values on which
torch's and XLA's float32 sigmoid agree bit for bit (3 of the 640 bf16
values in [-6, 6) differ by one ulp), so the two engines' four arrays are
compared bit for bit. With seeded weights the two forwards differ by
float32 rounding, and the arrays are compared within 1e-5.
"""

import io
import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tensorflow_web_deploy_tpu.models import get as jax_get
from tensorflow_web_deploy_tpu.models.adapter import native_converted as jax_native
from tensorflow_web_deploy_tpu.ops import quant as jquant
from tensorflow_web_deploy_tpu.parallel.mesh import build_mesh
from tensorflow_web_deploy_tpu.serving import costmodel as jcost
from tensorflow_web_deploy_tpu.serving import http as jhttp
from tensorflow_web_deploy_tpu.serving.engine import InferenceEngine as JaxEngine
from tensorflow_web_deploy_tpu.serving.registry import ModelRegistry as JaxRegistry
from tensorflow_web_deploy_tpu.utils import config as jcfg
from tensorflow_web_deploy_tpu_torch.models import get as torch_get
from tensorflow_web_deploy_tpu_torch.models.adapter import (
    Detector,
    init_variables,
    native_converted,
)
from tensorflow_web_deploy_tpu_torch.models.ssd_mobilenet import SSDMobileNet
from tensorflow_web_deploy_tpu_torch.ops.image import pad_to_canvas
from tensorflow_web_deploy_tpu_torch.ops.quant import Int8Conv2d
from tensorflow_web_deploy_tpu_torch.serving import costmodel
from tensorflow_web_deploy_tpu_torch.serving.engine import InferenceEngine
from tensorflow_web_deploy_tpu_torch.serving.http import App, make_http_server, shutdown_gracefully
from tensorflow_web_deploy_tpu_torch.serving.registry import ModelRegistry
from tensorflow_web_deploy_tpu_torch.utils import config as tcfg
from tests.test_registry import MockEngine as JaxMockEngine
from tests.test_torch_registry import MockEngine

torch.set_num_threads(2)

WIDTH, CLASSES, SIZE, CANVAS = 0.25, 6, 64, 96
MODEL = dict(name="ssd_mobilenet", source="native", task="detect", zoo_width=WIDTH,
             zoo_classes=CLASSES, input_size=(SIZE, SIZE), preprocess="inception",
             dtype="float32")
N_ANCHOR = 3
# the engine's static NMS sizes at 64 px: 15 anchors, so K = 15, D = 6·15
K_CAND = 15
MAX_DET = CLASSES * K_CAND


def _flat(name="ssd_mobilenet", **kw):
    return {k: np.asarray(v) for k, v in jax_native(name, **kw).params.items()}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------------ the anchor scene


def _sigmoids_agree(values: np.ndarray) -> np.ndarray:
    t = torch.sigmoid(_t(values)).numpy()
    return t == np.asarray(jax.nn.sigmoid(jnp.asarray(values)))


def scene_biases(classes: int, seed: int = 0) -> np.ndarray:
    """[2 heads, N_ANCHOR·(classes+1)] distinct ``cls`` biases, exactly
    representable in bf16, in [-6, 6), background (class 0) lower than
    every class, on which both frameworks' sigmoids agree."""
    pool = np.arange(-6.0, 6.0, 1 / 64, dtype=np.float32)
    pool = pool[(torch.from_numpy(pool).to(torch.bfloat16).float().numpy() == pool)
                & _sigmoids_agree(pool)]
    rs = np.random.RandomState(seed)
    n_bg, n_cls = 2 * N_ANCHOR, 2 * N_ANCHOR * classes
    bg, rest = pool[:n_bg], rs.permutation(pool[n_bg:])[:n_cls]
    out = np.empty((2, N_ANCHOR, classes + 1), np.float32)
    out[..., 0] = bg.reshape(2, N_ANCHOR)
    out[..., 1:] = rest.reshape(2, N_ANCHOR, classes)
    return out.reshape(2, -1)


def scene_params(flat: dict, biases: np.ndarray) -> dict:
    """``flat`` (JAX layout) with the heads set to the anchor scene."""
    p = dict(flat)
    for h in (1, 2):
        for part in ("loc", "cls"):
            p[f"params/head{h}_{part}/kernel"] = np.zeros_like(p[f"params/head{h}_{part}/kernel"])
        p[f"params/head{h}_loc/bias"] = np.zeros_like(p[f"params/head{h}_loc/bias"])
        p[f"params/head{h}_cls/bias"] = biases[h - 1].astype(np.float32)
    return p


def scene_expectation(anchors: np.ndarray, biases: np.ndarray, n_pos: tuple[int, int],
                      score_of, k: int = 100, d: int = 100, iou: float = 0.6,
                      score_thr: float = 1e-8):
    """The detections of the anchor scene, on the host: raw box codes 0, so
    each box is its anchor (cy ∓ h/2, cx ∓ w/2 in float32); raw scores the
    ``cls`` bias of the anchor's shape, by position then shape within each
    head; per class the top ``k`` by score (stable), greedy NMS in float32
    as the reference's, then the top ``d`` of all classes (stable), zero
    past ``num``. ``score_of`` maps raw scores to sigmoid scores."""
    c1 = biases.shape[1] // N_ANCHOR
    raw = np.concatenate([np.tile(b.reshape(N_ANCHOR, c1), (n, 1))
                          for b, n in zip(biases, n_pos)])  # [A, C+1]
    cy, cx, h, w = (anchors[:, i] for i in range(4))
    two = np.float32(2)
    boxes = np.stack([cy - h / two, cx - w / two, cy + h / two, cx + w / two], 1)
    scores = score_of(raw)[:, 1:]
    a, c = scores.shape
    k, d = min(k, a), min(d, c * min(k, a))
    thr = np.float32(iou)
    cand_boxes = np.zeros((c, k, 4), np.float32)
    kept = np.zeros((c, k), np.float32)
    for cls in range(c):
        order = np.argsort(-scores[:, cls], kind="stable")[:k]
        cb, cs = boxes[order], scores[order, cls]
        chosen: list[int] = []
        for i in range(k):
            if not cs[i] > np.float32(score_thr):
                continue
            ok = True
            for j in chosen:
                area = [max(b[2] - b[0], np.float32(0)) * max(b[3] - b[1], np.float32(0))
                        for b in (cb[i], cb[j])]
                hh = max(min(cb[i][2], cb[j][2]) - max(cb[i][0], cb[j][0]), np.float32(0))
                ww = max(min(cb[i][3], cb[j][3]) - max(cb[i][1], cb[j][1]), np.float32(0))
                inter = hh * ww
                if inter > thr * ((area[0] + area[1]) - inter):
                    ok = False
                    break
            if ok:
                chosen.append(i)
                kept[cls, i] = cs[i]
        cand_boxes[cls] = cb
    flat_scores = kept.reshape(-1)
    top = np.argsort(-flat_scores, kind="stable")[:d]
    valid = flat_scores[top] > np.float32(score_thr)
    n = int(valid.sum())
    out_boxes = np.zeros((d, 4), np.float32)
    out_scores = np.zeros(d, np.float32)
    out_classes = np.zeros(d, np.int32)
    out_boxes[:n] = cand_boxes.reshape(-1, 4)[top[:n]]
    out_scores[:n] = flat_scores[top[:n]]
    out_classes[:n] = top[:n] // k
    return out_boxes, out_scores, out_classes, np.int32(n)


def _feature_positions(size: int) -> tuple[int, int]:
    f1 = size
    for _ in range(5):
        f1 = -(-f1 // 2)
    f2 = -(-f1 // 2)
    return f1 * f1, f2 * f2


# ---------------------------------------------------------------- the model


@pytest.mark.parametrize("size", [64, 96, 300])
def test_anchors_equal_the_reference(size):
    jm = jax_get("ssd_mobilenet").build(num_classes=CLASSES, width=WIDTH)
    want = jm.anchors_for(size)
    got = SSDMobileNet.anchors_for(size)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if size == 300:
        assert got.shape == (375, 4)  # 10² + 5² positions × 3 shapes


def test_seeded_init_equals_jax_leaf_by_leaf():
    _, flat = init_variables(torch_get("ssd_mobilenet"), num_classes=CLASSES, width=WIDTH,
                             seed=0)
    want = _flat(num_classes=CLASSES, width=WIDTH, seed=0)
    assert sorted(flat) == sorted(want)
    assert {k for k in flat if "/head" in k} == {
        f"params/head{h}_{p}/{leaf}" for h in (1, 2) for p in ("loc", "cls")
        for leaf in ("kernel", "bias")}
    for k in flat:
        np.testing.assert_array_equal(flat[k], want[k], err_msg=k)


def _perturbed(flat: dict, seed: int) -> dict:
    """Non-trivial BN statistics and head biases, so the fold, the pads and
    the heads' bias all count."""
    rs = np.random.RandomState(seed)
    p = dict(flat)
    for k in p:
        if k.endswith("/mean") or k.endswith("/bias"):
            p[k] = rs.normal(0, 0.2, p[k].shape).astype(np.float32)
        elif k.endswith("/var"):
            p[k] = rs.uniform(0.5, 2.0, p[k].shape).astype(np.float32)
    return p


@pytest.mark.parametrize("size", [64, 65])
def test_carried_parameters_give_the_flax_raw_outputs(size):
    """The reference's parameters loaded by name: raw boxes and scores
    within float32 rounding of the flax forward, at an even and an odd
    size (the stride-2 "SAME" pads differ), anchors equal."""
    jm = jax_native("ssd_mobilenet", num_classes=CLASSES, width=WIDTH, seed=0, input_size=size)
    params = _perturbed({k: np.asarray(v) for k, v in jm.params.items()}, 3)
    x = np.random.RandomState(size).uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
    want = [np.asarray(o) for o in jax.jit(jm.fn)(params, x)]
    model = native_converted("ssd_mobilenet", num_classes=CLASSES, width=WIDTH,
                             params_flat=params, input_size=size)
    assert isinstance(model, Detector) and model.output_names == jm.output_names
    with torch.no_grad():
        got = [o.numpy() for o in model(_t(x))]
    for g, w, name in zip(got, want, jm.output_names):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, atol=5e-5, rtol=1e-4, err_msg=name)
    np.testing.assert_array_equal(got[2], want[2])


def _rel(a, b) -> float:
    """max |a − b| over max |b|."""
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("width,size", [(1.0, 64), (0.25, 300)])
def test_bf16_raw_outputs_deviate_from_float32_as_the_reference_does(width, size):
    """Seeded weights, 4 images in [-1, 1]: the port's bf16 raw outputs lie
    from its float32 ones (max |Δ| over max |raw|) within a quarter more
    than the reference's bf16 from its float32, output for output. The
    reference's own deviation passes 1e-2 here, so ``chip_smoke.py`` holds
    the card's bf16 engine to ``SSD_BF16_RTOL`` (3e-2), not 1e-2."""
    jm = jax_native("ssd_mobilenet", width=width, seed=0, input_size=size)
    x = np.random.RandomState(0).uniform(-1, 1, (4, size, size, 3)).astype(np.float32)
    j32 = [np.asarray(o) for o in jax.jit(jm.fn)(jm.params, x)][:2]
    p16 = {k: v.astype(jnp.bfloat16) if np.asarray(v).dtype == np.float32 else v
           for k, v in jm.params.items()}
    j16 = [np.asarray(o).astype(np.float32) for o in jax.jit(
        lambda p, x: jm.fn(p, x.astype(jnp.bfloat16), float_dtype=jnp.bfloat16))(p16, x)][:2]
    model = native_converted("ssd_mobilenet", width=width, input_size=size)
    with torch.no_grad():
        t32 = [o.numpy() for o in model(_t(x))][:2]
        t16 = [o.float().numpy() for o in model.to(torch.bfloat16)(_t(x).to(torch.bfloat16))][:2]
    jrel = [_rel(a, b) for a, b in zip(j16, j32)]
    trel = [_rel(a, b) for a, b in zip(t16, t32)]
    assert max(jrel) > 1e-2, jrel
    for t, j in zip(trel, jrel):
        assert t <= 1.25 * j, (trel, jrel)
    assert max(trel) < 3e-2


def test_anchors_stay_float32_through_a_cast():
    model = native_converted("ssd_mobilenet", num_classes=CLASSES, width=WIDTH, input_size=SIZE)
    want = model.anchors.clone()
    model.to(torch.bfloat16)
    assert model.anchors.dtype == torch.float32 and torch.equal(model.anchors, want)
    assert model.backbone.head1_cls.weight.dtype == torch.bfloat16


def test_quantize_int8_covers_the_heads():
    """Every conv of the int8 tier is int8, the heads included (plain convs
    with a bias, no BN), and their ``q`` and scales are the reference's."""
    flat = _flat(num_classes=CLASSES, width=WIDTH, seed=0)
    model = native_converted("ssd_mobilenet", num_classes=CLASSES, width=WIDTH, int8=True,
                             input_size=SIZE)
    convs = [m for m in model.modules() if isinstance(m, torch.nn.Conv2d)]
    assert not convs  # no float conv is left
    qp = jquant.quantize_params(flat, jnp.float32)
    for h in (1, 2):
        for part in ("loc", "cls"):
            head = getattr(model.backbone, f"head{h}_{part}")
            key = f"params/head{h}_{part}/kernel"
            assert isinstance(head, Int8Conv2d) and head.q.dtype == torch.int8
            np.testing.assert_array_equal(head.q.numpy().transpose(2, 3, 1, 0), qp[key])
            np.testing.assert_array_equal(head.scale.numpy(), qp[key + jquant.QSCALE_SUFFIX])
            np.testing.assert_array_equal(head.bias.numpy(), flat[f"params/head{h}_{part}/bias"])


# --------------------------------------------------------------- the engine


def _images(seed, dims=((96, 96), (72, 48), (48, 64), (17, 23), (95, 33))):
    rs = np.random.RandomState(seed)
    out = []
    for h, w in dims:
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        img = np.stack([yy * 2, xx * 2, 200 - yy - xx], -1) + rs.normal(0, 20, (h, w, 3))
        out.append(np.clip(img, 0, 255).astype(np.uint8))
    return out


def _engines(wire: str, params: dict, dtype: str = "float32"):
    ragged = wire == "ragged"
    common = dict(canvas_buckets=(CANVAS,), max_batch=8, wire_format="rgb" if ragged else wire,
                  ragged=ragged, resize="matmul", warmup=False)
    model = {**MODEL, "dtype": dtype}
    jeng = JaxEngine(jcfg.ServerConfig(model=jcfg.ModelConfig(**model), **common),
                     mesh=build_mesh(jax.devices()[:1]))
    # the JAX engine takes no weights: its serve functions read each
    # replica's params, which are replaced here
    for rep in jeng._replicas:
        rep.params = jax.device_put(
            {k: v.astype(jnp.bfloat16) if dtype != "float32" and v.dtype == np.float32 else v
             for k, v in params.items()}, rep.replicated)
    teng = InferenceEngine(tcfg.ServerConfig(model=tcfg.ModelConfig(**model), **common),
                           device="cpu", params_flat=params)
    return jeng, teng


def _run_both(jeng, teng, wire: str, images):
    hws = np.array([im.shape[:2] for im in images], np.int32)
    if wire == "ragged":
        got = teng.run_ragged(images, hws, CANVAS)
        slab = jeng.acquire_ragged(len(images), CANVAS)
        for im in images:
            i, view = slab.alloc(im.size)
            view[:] = im.reshape(-1)
            slab.write_hw(i, im.shape[:2])
        want = jeng.fetch_outputs(jeng.dispatch_ragged(slab, len(images)))
    else:
        prepared = [teng.prepare(im) for im in images]
        canvases = np.stack([c for c, _ in prepared])
        got = teng.run_batch(canvases, hws)
        want = jeng.run_batch(canvases, hws)
    return got, want


@pytest.mark.parametrize("wire", ["rgb", "ragged", "yuv420"])
def test_engine_equals_jax_on_the_anchor_scene(wire):
    """The anchor scene through both engines (float32): the four arrays
    equal bit for bit, and equal to the host's expectation, image for
    image (the scene does not depend on the image)."""
    biases = scene_biases(CLASSES)
    params = scene_params(_flat(num_classes=CLASSES, width=WIDTH, seed=0), biases)
    jeng, teng = _engines(wire, params)
    try:
        want = ["unpack_ragged", "nms_fixed"] if wire == "ragged" else ["nms_fixed"]
        assert teng.kernels == want
        got, want = _run_both(jeng, teng, wire, _images(3))
    finally:
        teng.close()
        jeng.close()
    assert [g.dtype for g in got] == [np.float32, np.float32, np.int32, np.int32]
    assert got[0].shape == (5, MAX_DET, 4) and got[3].shape == (5,)
    for g, w, name in zip(got, want, ("boxes", "scores", "classes", "num")):
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)
    expect = scene_expectation(SSDMobileNet.anchors_for(SIZE), biases,
                               _feature_positions(SIZE),
                               lambda v: torch.sigmoid(_t(v)).numpy())
    for i in range(5):
        for g, e, name in zip(got, expect, ("boxes", "scores", "classes", "num")):
            np.testing.assert_array_equal(g[i], e, err_msg=f"{name}, image {i}")
    assert int(expect[3]) == MAX_DET  # every candidate kept: all scores ≥ sigmoid(-6)


@pytest.mark.parametrize("wire", ["rgb", "ragged", "yuv420"])
def test_engine_matches_jax_on_seeded_weights(wire):
    """Seeded weights (perturbed BN and head biases), float32: classes and
    counts equal, boxes and scores within 1e-5. On yuv420 the JAX engine
    feeds its stem space-to-depth cells straight from the resize (an exact
    rewrite, another rounding)."""
    params = _perturbed(_flat(num_classes=CLASSES, width=WIDTH, seed=0), 4)
    jeng, teng = _engines(wire, params)
    try:
        got, want = _run_both(jeng, teng, wire, _images(5))
    finally:
        teng.close()
        jeng.close()
    want = [np.asarray(w) for w in want]
    np.testing.assert_array_equal(got[3], want[3])
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[0], want[0], atol=1e-5, rtol=0)
    np.testing.assert_allclose(got[1], want[1], atol=1e-5, rtol=0)
    assert (got[3] > 0).all() and len({tuple(r) for r in got[1][:, :4]}) == 5


def test_engine_reports_the_task_and_packs_its_row():
    params = scene_params(_flat(num_classes=CLASSES, width=WIDTH, seed=0), scene_biases(CLASSES))
    eng = InferenceEngine(tcfg.ServerConfig(model=tcfg.ModelConfig(**MODEL),
                                            canvas_buckets=(CANVAS,), max_batch=2),
                          device="cpu", params_flat=params)
    try:
        eng.warmup()
        st = eng.stats()
        assert (st["task"], st["outputs"]) == ("detect", ["raw_boxes", "raw_scores", "anchors"])
        assert (eng.num_classes, eng.topk, eng.max_detections, eng.row_width) == (
            CLASSES, 5, MAX_DET, 6 * MAX_DET + 1)
        assert st["kernel_launches"]["nms_fixed"] == 0  # CPU: the plain version
        assert eng.healthcheck()
        econ = costmodel.economics_snapshot(eng, eng.model_cfg)
        assert econ["model_cost"]["flops_per_image"] > 0 and econ["rows_total"] > 0
        assert econ["mfu"] > 0
    finally:
        eng.close()


def _gate_cfg(mod, width, size):
    """The reference's int8 detector at ``width``, 90 classes, ``size`` px."""
    return mod.ServerConfig(model=mod.ModelConfig(name="ssd_mobilenet", source="native",
                                                  task="detect", zoo_width=width,
                                                  input_size=(size, size), dtype="int8"),
                            canvas_buckets=(size,), max_batch=4, warmup=False)


def _build_gate(make):
    try:
        eng = make()
    except RuntimeError as e:
        return "refused", str(e)
    eng.close()
    return "pass", eng.parity


@pytest.mark.parametrize("width,size,verdict", [(1.0, 64, "pass"), (0.25, 300, "refused")])
def test_int8_gate_verdict_equals_the_reference(width, size, verdict):
    """Same seeded weights, same probe (4 images in [-1, 1]): full width at
    64 px passes both gates; width 0.25 at the served 300 px fails both
    (score and box deltas past 0.06 and 0.25). The full width at 300 px is
    the card's check (``chip_smoke.py`` ``ssd``)."""
    jv, jp = _build_gate(lambda: JaxEngine(_gate_cfg(jcfg, width, size),
                                           mesh=build_mesh(jax.devices()[:1])))
    tv, tp = _build_gate(lambda: InferenceEngine(_gate_cfg(tcfg, width, size), device="cpu"))
    assert jv == tv == verdict, (jp, tp)
    if verdict == "refused":
        for text in (jp, tp):
            assert text.startswith("numerical-parity gate failed for ssd_mobilenet dtype=int8: ")
            assert "'pass': False" in text and "'task': 'detect'" in text
    else:
        assert (tp["tol_score"], tp["tol_box"], tp["probe_batch"], tp["task"]) == (
            jp["tol_score"], jp["tol_box"], jp["probe_batch"], jp["task"]) == (
            0.06, 0.25, 4, "detect")
        assert tp["max_score_delta"] <= 0.06 and tp["max_box_delta"] <= 0.25
        # the same probe and weights: the deltas are close, not equal (bf16
        # rounds at other places in the two frameworks)
        assert abs(tp["max_score_delta"] - jp["max_score_delta"]) < 0.03
        assert abs(tp["max_box_delta"] - jp["max_box_delta"]) < 0.1


# ------------------------------------------------------------- config, registry


def test_model_config_sets_task_and_labels_as_the_reference():
    want = jcfg.model_config("native:ssd_mobilenet")
    got = tcfg.model_config("native:ssd_mobilenet")
    assert (got.task, got.labels_path, got.input_size, got.preprocess) == (
        want.task, want.labels_path, tuple(want.input_size), want.preprocess)
    assert got.task == "detect" and got.labels_path.endswith("coco_labels.txt")
    assert tcfg.model_config("native:mobilenet_v2").task == "classify"
    with pytest.raises(ValueError, match="task must be"):
        tcfg.ModelConfig(name="ssd_mobilenet", task="segment")


def test_quant_variant_refuses_a_variant_of_another_task():
    """An int8 entry of the same name and input size but another task is
    no variant, in both packages' registries; one of the same task is."""
    cfg = tcfg.ServerConfig(model=tcfg.ModelConfig(name="ssd_mobilenet", task="detect"),
                            max_batch=4, canvas_buckets=(32,), ragged=True)
    treg = ModelRegistry(cfg, engine_factory=lambda mc: MockEngine(cfg))
    jc = jcfg.ServerConfig(model=jcfg.ModelConfig(name="ssd_mobilenet", source="native",
                                                  task="detect"), max_batch=8)
    jreg = JaxRegistry(jc, engine_factory=lambda mc: JaxMockEngine())
    try:
        for mod, reg in ((tcfg, treg), (jcfg, jreg)):
            base = dict(name="ssd_mobilenet", source="native")
            reg.load(mod.ModelConfig(**base, task="detect"), wait=True)
            reg.load(mod.ModelConfig(**base, task="classify", dtype="int8"), name="cls_int8",
                     wait=True)
            assert reg.quant_variant("ssd_mobilenet") is None
            reg.load(mod.ModelConfig(**base, task="detect", dtype="int8"), name="det_int8",
                     wait=True)
            assert reg.quant_variant("ssd_mobilenet").name == "det_int8"
    finally:
        treg.stop()
        jreg.stop()


# ------------------------------------------------------------------ the cost


def _conv_macs(conv, out_hw: int) -> int:
    return conv.weight.numel() * out_hw * out_hw


@pytest.mark.parametrize("width,classes,size", [(1.0, 90, 300), (WIDTH, CLASSES, SIZE)])
def test_cost_walker_matches_the_reference_and_the_module(width, classes, size):
    """The walker's counts equal the reference walker's, and its MACs are
    the module's convs counted from their weights (built on the meta
    device) at each feature map's size."""
    mc = tcfg.ModelConfig(name="ssd_mobilenet", task="detect", zoo_width=width,
                          zoo_classes=classes, input_size=(size, size))
    got = costmodel.model_cost(mc)
    want = jcost.model_cost(jcfg.ModelConfig(name="ssd_mobilenet", source="native",
                                             task="detect", zoo_width=width,
                                             zoo_classes=classes, input_size=(size, size)))
    for key in ("macs_per_image", "flops_per_image", "param_count", "act_bytes_per_image"):
        assert got[key] == want[key], key
    with torch.device("meta"):
        model = SSDMobileNet(num_classes=classes, width=width)
    h = -(-size // 2)
    macs = _conv_macs(model.stem.conv, h)
    for name in ("block0", "block1", "block2", "block3", "feat1", "feat2"):
        block = getattr(model, name)
        h_in, h = h, -(-h // block.dw.stride)
        if block.expand is not None:
            macs += _conv_macs(block.expand.conv, h_in)
        macs += _conv_macs(block.dw.dwconv, h) + _conv_macs(block.project.conv, h)
        if name == "feat1":
            h1 = h
    for i, hh in ((1, h1), (2, h)):
        for part in ("loc", "cls"):
            macs += _conv_macs(getattr(model, f"head{i}_{part}"), hh)
    assert macs == got["macs_per_image"]
    assert got["param_count"] == sum(p.numel() for p in model.parameters())


# ------------------------------------------------------------------- /predict


def _jpeg(img: np.ndarray) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", quality=92)
    return buf.getvalue()


def _post(port, data: bytes):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/predict", data=data, method="POST",
                                 headers={"Content-Type": "image/jpeg"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.fixture(scope="module")
def both_detect_apps():
    """The JAX App and the port's, each behind its own pool server over a
    one-model registry serving the anchor-scene detector (float32, ragged
    rgb wire, canvas 96, 64 px): (JAX port, port port)."""
    params = scene_params(_flat(num_classes=CLASSES, width=WIDTH, seed=0), scene_biases(CLASSES))
    common = dict(canvas_buckets=(CANVAS,), max_batch=4, wire_format="rgb", ragged=True,
                  warmup=False)
    jmc = jcfg.ModelConfig(**MODEL)
    jserver = jcfg.ServerConfig(model=jmc, **common)
    jreg = JaxRegistry(jserver, default_model="ssd_mobilenet")
    jeng = JaxEngine(jserver, mesh=build_mesh(jax.devices()[:1]))
    for rep in jeng._replicas:
        rep.params = jax.device_put(params, rep.replicated)
    jreg.adopt(jmc.serve_name, jeng, jreg.build_batcher(jeng, jmc.serve_name), jmc)
    tmc = tcfg.ModelConfig(**MODEL)
    tserver = tcfg.ServerConfig(model=tmc, **common)
    treg = ModelRegistry(tserver, default_model="ssd_mobilenet")
    teng = InferenceEngine(tserver, device="cpu", params_flat=params)
    treg.adopt(tmc.serve_name, teng, treg.build_batcher(teng), tmc)
    servers = (jhttp.make_http_server(jhttp.App.from_registry(jreg, jserver), "127.0.0.1", 0,
                                      pool_size=4),
               make_http_server(App(treg, tserver), "127.0.0.1", 0, pool_size=4))
    for srv in servers:
        threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield tuple(srv.server_address[1] for srv in servers)
    jhttp.shutdown_gracefully(servers[0], jreg, grace_s=3.0)
    shutdown_gracefully(servers[1], treg, grace_s=3.0)
    jeng.close()
    teng.close()


@pytest.mark.parametrize("dims", [(200, 120), (77, 51)], ids=["downscaled", "small"])
def test_predict_answers_as_the_jax_app(both_detect_apps, dims):
    """One upload whose original size is not its canvas (200×120 decodes
    DCT-downscaled into the 96 canvas; 77×51 lies in it with padding):
    both Apps answer 200 with the same keys and the same ``detections``,
    each box the engine's normalized box times the upload's own (h, w)."""
    img = _images(11, dims=(dims,))[0]
    answers = [_post(port, _jpeg(img)) for port in both_detect_apps]
    (js, jbody), (ts, tbody) = answers
    assert js == ts == 200, answers
    assert set(tbody) == set(jbody) == {"detections", "num_detections", "model",
                                        "model_version", "latency_ms", "trace_id"}
    assert tbody["detections"] == jbody["detections"]
    assert tbody["num_detections"] == jbody["num_detections"] == MAX_DET
    biases = scene_biases(CLASSES)
    boxes, scores, classes, n = scene_expectation(
        SSDMobileNet.anchors_for(SIZE), biases, _feature_positions(SIZE),
        lambda v: torch.sigmoid(_t(v)).numpy())
    h, w = dims
    first = tbody["detections"][0]
    y0, x0, y1, x1 = (float(v) for v in boxes[0])
    assert first["box"] == [y0 * h, x0 * w, y1 * h, x1 * w]
    assert (first["class"], first["score"]) == (int(classes[0]), float(scores[0]))
    assert first["label"] == f"class_{int(classes[0]):04d}"


def test_ragged_wire_equals_classic_wire_for_a_detector():
    """The ragged wire rebuilds the classic wire's canvases: a detector's
    arrays are the same either way (seeded weights, float32)."""
    params = _perturbed(_flat(num_classes=CLASSES, width=WIDTH, seed=0), 6)
    common = dict(canvas_buckets=(CANVAS,), max_batch=8, warmup=False)
    eng = InferenceEngine(tcfg.ServerConfig(model=tcfg.ModelConfig(**MODEL), wire_format="rgb",
                                            ragged=True, **common),
                          device="cpu", params_flat=params)
    try:
        images = _images(8)
        hws = np.array([im.shape[:2] for im in images], np.int32)
        ragged = eng.run_ragged(images, hws, CANVAS)
        classic = eng.run_batch(np.stack([pad_to_canvas(im, (CANVAS,))[0] for im in images]),
                                hws)
    finally:
        eng.close()
    for a, b in zip(ragged, classic):
        np.testing.assert_array_equal(a, b)


def test_server_config_json_route_serves_a_detector(tmp_path):
    """A ``.json`` ModelConfig with ``task: detect`` resolves."""
    path = tmp_path / "ssd.json"
    path.write_text(json.dumps({"name": "ssd_mobilenet", "task": "detect", "zoo_width": WIDTH,
                                "input_size": [SIZE, SIZE]}))
    mc = tcfg.model_config(f"{path},dtype=int8")
    assert (mc.task, mc.input_size, mc.dtype) == ("detect", (SIZE, SIZE), "int8")
