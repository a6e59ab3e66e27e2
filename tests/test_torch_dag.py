"""Pipeline DAGs of the port against the JAX package's: the spec grammar
(inline chains, JSON files, the argument list), the crop glue against the
reference's jitted glue and its host mirror, the two-stage executor on
real engines (SSD at width 0.25 on the anchor scene, MobileNetV2 at width
0.25, the reference's parameters carried into the port), the per-stage
cache across a classifier swap, the HTTP surface (``GET /pipelines``,
``/models → pipelines``, every status of ``POST /pipelines/<name>``), the
``/stats`` block and ``tpu_serve_pipeline_*`` families, and a classifier
hot swap under pipeline traffic with no stale composite.

Tolerances: the detections equal the reference's exactly (the anchor
scene in float32, bit for bit through both detectors). The port's glue is
its mirror's bit for bit, within 1 LSB of the reference's jitted glue, and
the reference's mirror's bit for bit wherever that mirror's sample
coordinates are not negative (the reference's mirror clamps its first tap
and then adds 1; ``ops/dag_glue.py``). A 1-LSB crop moves this random
MobileNetV2's probabilities by up to ~3e-3, so a composite's
classification is held to the reference's within ``CROP_PROB_TOL`` with
equal top-k indices, and to the JAX classifier run on the port's own
crops within ``PROB_TOL``.
"""

import dataclasses
import http.client
import io
import json
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tensorflow_web_deploy_tpu.ops import dag_glue as jglue
from tensorflow_web_deploy_tpu.parallel.mesh import build_mesh
from tensorflow_web_deploy_tpu.serving import dag as jdag
from tensorflow_web_deploy_tpu.serving import http as jhttp
from tensorflow_web_deploy_tpu.serving.engine import InferenceEngine as JaxEngine
from tensorflow_web_deploy_tpu.serving.registry import ModelRegistry as JaxRegistry
from tensorflow_web_deploy_tpu.utils import config as jcfg
from tensorflow_web_deploy_tpu_torch.ops import dag_glue
from tensorflow_web_deploy_tpu_torch.serving import dag as tdag
from tensorflow_web_deploy_tpu_torch.serving.engine import InferenceEngine
from tensorflow_web_deploy_tpu_torch.serving.http import App, make_http_server, shutdown_gracefully
from tensorflow_web_deploy_tpu_torch.serving.registry import ModelRegistry
from tensorflow_web_deploy_tpu_torch.utils import config as tcfg
from tensorflow_web_deploy_tpu_torch.utils.metrics import parse_prometheus_text
from tests.test_torch_ssd import _flat, scene_biases, scene_params

torch.set_num_threads(2)

CLASSES, CLS_CLASSES, WIDTH, SIZE, CANVAS = 6, 10, 0.25, 64, 96
SSD = dict(name="ssd_mobilenet", source="native", task="detect", zoo_width=WIDTH,
           zoo_classes=CLASSES, input_size=(SIZE, SIZE), preprocess="inception",
           dtype="float32")
MBV2 = dict(name="mobilenet_v2", source="native", zoo_width=WIDTH, zoo_classes=CLS_CLASSES,
            input_size=(SIZE, SIZE), preprocess="inception", dtype="float32")
PIPE = "pipe=ssd_mobilenet>mobilenet_v2"
# one canvas bucket; bodies past 50 KB answer 413
COMMON = dict(canvas_buckets=(CANVAS,), max_batch=8, wire_format="rgb", ragged=True,
              cache_bytes=1 << 20, max_body_mb=0.05, request_timeout_s=30.0,
              drain_grace_s=5.0, pipelines=(PIPE,))
PROB_TOL = 1e-4
CROP_PROB_TOL = 1e-2


def _det_params():
    return scene_params(_flat(num_classes=CLASSES, width=WIDTH, seed=0), scene_biases(CLASSES))


def _cls_params(seed: int = 0):
    return _flat("mobilenet_v2", num_classes=CLS_CLASSES, width=WIDTH, seed=seed)


def _jpeg(seed: int, h: int = 80, w: int = 70) -> bytes:
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([yy * 3, xx * 3, 220 - yy - xx], -1) + rs.normal(0, 25, (h, w, 3))
    buf = io.BytesIO()
    Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(buf, "JPEG", quality=90)
    return buf.getvalue()


class _Span:
    trace_id = "t-dag"

    def add(self, *a):
        pass

    def note(self, *a):
        pass


# ------------------------------------------------------------------ the spec

# each argument list: a string is an inline spec, a dict a JSON file of one
# pipeline document, a list a JSON file holding that list
SPEC_CASES = {
    "good_chain": ["p=det>cls"],
    "dtype_pin": ["p_1=det@int8 > cls@f32"],
    "bad_dtype": ["p=det@int7>cls"],
    "empty_stage": ["p=det>"],
    "missing_equals": ["no-equals-here"],
    "bad_name": ["bad name!=det>cls"],
    "empty_name": ["=det>cls"],
    "one_stage": ["p=det"],
    "file_chain": [{"name": "pf", "stages": [{"model": "cls", "dtype": "f32", "after": "det"},
                                             {"model": "det"}]}],
    "two_roots": [{"name": "pf", "stages": [{"model": "a"}, {"model": "b"}]}],
    "fan_out": [{"name": "pf", "stages": [{"model": "a"}, {"model": "b", "after": "a"},
                                          {"model": "c", "after": "a"}]}],
    "cycle": [{"name": "pf", "stages": [{"model": "a"}, {"model": "b", "after": "c"},
                                        {"model": "c", "after": "b"}]}],
    "unknown_after": [{"name": "pf", "stages": [{"model": "a"}, {"model": "b",
                                                                 "after": "ghost"}]}],
    "duplicate_model": [{"name": "pf", "stages": [{"model": "a"},
                                                  {"model": "a", "after": "a"}]}],
    "duplicate_name": ["pi=det>cls", {"name": "pi", "stages": [{"model": "det"},
                                                               {"model": "cls",
                                                                "after": "det"}]}],
    "not_an_array": [["not", "docs"]],
    "inline_and_file": ["pi=det>cls", {"name": "pf", "stages": [
        {"model": "det"}, {"model": "cls", "after": "det"}]}],
}


def _outcome(fn):
    try:
        got = fn()
    except Exception as e:  # the class and text are what is compared
        return ("error", type(e).__name__, str(e))
    return ("ok", [s.to_dict() for s in (got if isinstance(got, list) else [got])],
            [s.ref for s in (got if isinstance(got, list) else [got])])


@pytest.mark.parametrize("case", sorted(SPEC_CASES))
def test_spec_grammar_equals_the_reference(case, tmp_path):
    """Each argument list through both packages' ``parse_pipeline_args``,
    and each argument through ``parse_pipeline_spec`` or
    ``load_pipeline_file``: the same specs (``to_dict`` and ``ref``), or the
    same error class and text."""
    args = []
    for i, a in enumerate(SPEC_CASES[case]):
        if isinstance(a, str):
            args.append(a)
            continue
        path = tmp_path / f"p{i}.json"
        path.write_text(json.dumps(a if isinstance(a, list) and case == "not_an_array"
                                   else [a]))
        args.append(str(path))
    outcomes = []
    for mod in (jdag, tdag):
        one = [_outcome(lambda a=a: mod.parse_pipeline_spec(a) if "=" in a
                        else mod.load_pipeline_file(a)) for a in args]
        outcomes.append((_outcome(lambda: mod.parse_pipeline_args(args)), one))
    assert outcomes[0] == outcomes[1]
    if case in ("good_chain", "file_chain", "inline_and_file", "dtype_pin"):
        assert outcomes[1][0][0] == "ok"
    else:
        assert outcomes[1][0][0] == "error"
    if case == "dtype_pin":
        assert outcomes[1][0][2] == ["p_1=det@int8>cls@float32"]


def test_missing_pipeline_file_equals_the_reference(tmp_path):
    missing = str(tmp_path / "missing.json")
    got = [_outcome(lambda mod=mod: mod.load_pipeline_file(missing)) for mod in (jdag, tdag)]
    assert got[0] == got[1] and got[1][0] == "error" and "pipeline file" in got[1][2]


# ------------------------------------------------------------------ the glue


def _glue_case(name: str):
    """(canvas, hw, boxes, num, out_s, n_crops) for one case, seeded."""
    rs = np.random.RandomState(sum(map(ord, name)))
    s = 64
    canvas = (rs.rand(s, s, 3) * 255).astype(np.uint8)
    hw, num, out_s, n = (s, s), 3, 32, 8
    y0 = rs.rand(n).astype(np.float32) * 0.5
    x0 = rs.rand(n).astype(np.float32) * 0.5
    boxes = np.stack([y0, x0, y0 + 0.2 + rs.rand(n).astype(np.float32) * 0.3,
                      x0 + 0.2 + rs.rand(n).astype(np.float32) * 0.3], 1)
    if name == "holes":
        num = 2
    elif name == "subpixel":
        boxes[1] = [0.5, 0.5, 0.5001, 0.5001]
        boxes[2] = [0.2, 0.2, 0.2001, 0.9]
    elif name == "outside_unit":
        boxes[0] = [-0.3, -0.2, 0.5, 1.4]
        boxes[1] = [0.6, 0.7, 1.7, 1.2]
        boxes[2] = [1.2, 1.1, 1.5, 1.9]
    elif name == "upscale":
        out_s = 48
        boxes[:, 2:] = boxes[:, :2] + 0.08
        num = n
    elif name == "downscale":
        out_s, num = 16, n
        boxes[:] = [0.0, 0.05, 0.95, 1.0]
    elif name == "hw_smaller":
        hw = (57, 41)
    elif name == "num_float":
        num = 5.0
    elif name == "one_crop":
        n, num = 1, 1
        boxes = boxes[:3]
    return canvas, hw, boxes, num, out_s, n


GLUE_CASES = ("holes", "subpixel", "outside_unit", "upscale", "downscale", "hw_smaller",
              "num_float", "one_crop")


@pytest.mark.parametrize("case", GLUE_CASES)
def test_glue_equals_the_reference(case):
    """The port's device glue (torch, here on the CPU) is its host mirror
    bit for bit; within 1 LSB of the reference's jitted glue; and the
    reference's host mirror bit for bit at every output whose sample
    coordinates are not negative (where that mirror's first tap is clamped
    before it adds 1)."""
    canvas, hw, boxes, num, out_s, n = _glue_case(case)
    dev = dag_glue.crop_resize(
        torch.from_numpy(canvas), torch.tensor(hw, dtype=torch.int32), torch.from_numpy(boxes),
        torch.tensor(num), out_s=out_s, n_crops=n).numpy()
    host = dag_glue.crop_resize_host(canvas, hw, boxes, num, out_s=out_s, n_crops=n)
    jit = np.asarray(jglue.make_crop_fn(out_s, n)(
        canvas, jnp.asarray(hw, jnp.int32), jnp.asarray(boxes), jnp.asarray(num)))
    ref_host = jglue.crop_resize_host(canvas, hw, boxes, num, out_s=out_s, n_crops=n)
    assert dev.shape == (n, out_s, out_s, 3) and dev.dtype == np.uint8
    np.testing.assert_array_equal(dev, host)
    assert np.abs(dev.astype(np.int32) - jit).max() <= 1
    y0, x0, y1, x1 = dag_glue._box_geometry(boxes[:n], np.asarray(hw), num, n, xp=np)
    o = np.arange(out_s, dtype=np.float32)
    for i in range(n):
        sy, sx = out_s / (y1[i] - y0[i]), out_s / (x1[i] - x0[i])
        yy = (o + 0.5 - (-y0[i] * sy)) / sy - 0.5
        xx = (o + 0.5 - (-x0[i] * sx)) / sx - 0.5
        inside = (yy >= 0)[:, None] & (xx >= 0)[None, :]
        np.testing.assert_array_equal(dev[i][inside], ref_host[i][inside])
    if case == "holes":  # the hole rows are the full valid region, as box [0, 0, 1, 1]
        full = dag_glue.crop_resize_host(canvas, hw, np.array([[0, 0, 1, 1]], np.float32), 1,
                                         out_s=out_s, n_crops=1)[0]
        for i in range(num, n):
            np.testing.assert_array_equal(dev[i], full)


# -------------------------------------------------------- real engines, both


def _jax_app(cfg_kw: dict, det_params, cls_params):
    mcs = (jcfg.ModelConfig(**SSD), jcfg.ModelConfig(**MBV2))
    server = jcfg.ServerConfig(model=mcs[0], warmup=False, **cfg_kw)
    reg = JaxRegistry(server, default_model="ssd_mobilenet")
    for mc, params in zip(mcs, (det_params, cls_params)):
        eng = JaxEngine(jcfg.ServerConfig(model=mc, warmup=False, **cfg_kw),
                        mesh=build_mesh(jax.devices()[:1]))
        for rep in eng._replicas:
            rep.params = jax.device_put(params, rep.replicated)
        reg.adopt(mc.serve_name, eng, reg.build_batcher(eng, mc.serve_name), mc)
    return reg, jhttp.App.from_registry(reg, server)


def _port_app(cfg_kw: dict, det_params, cls_params_of):
    """The port's registry (engines built by a factory, so that a swap
    builds the classifier with ``cls_params_of(version)``) and App."""
    mcs = (tcfg.ModelConfig(**SSD), tcfg.ModelConfig(**MBV2))
    server = tcfg.ServerConfig(model=mcs[0], models=mcs, warmup=True, **cfg_kw)
    builds: dict = {}

    def factory(mc):
        v = builds[mc.serve_name] = builds.get(mc.serve_name, 0) + 1
        params = det_params if mc.task == "detect" else cls_params_of(v)
        return InferenceEngine(dataclasses.replace(server, model=mc), device="cpu",
                               params_flat=params)

    reg = ModelRegistry(server, default_model="ssd_mobilenet", engine_factory=factory)
    for mc in mcs:
        reg.load(mc, wait=True)
    return reg, App(reg, server)


def _serve(app):
    srv = make_http_server(app, "127.0.0.1", 0, pool_size=8) if isinstance(app, App) else \
        jhttp.make_http_server(app, "127.0.0.1", 0, pool_size=8)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


@pytest.fixture(scope="module")
def both():
    """The JAX package's and the port's App, each behind its own server, over
    the same two models and weights and the same pipeline:
    ``{"jax": (registry, app, port), "port": (...)}``."""
    det = _det_params()
    jreg, japp = _jax_app(COMMON, det, _cls_params(0))
    treg, tapp = _port_app(COMMON, det, lambda v: _cls_params(0))
    servers = (_serve(japp), _serve(tapp))
    yield {"jax": (jreg, japp, servers[0].server_address[1]),
           "port": (treg, tapp, servers[1].server_address[1])}
    jhttp.shutdown_gracefully(servers[0], jreg, grace_s=3.0)
    shutdown_gracefully(servers[1], treg, grace_s=3.0)
    treg.close_engines()


def _cls_rows(dets):
    return [[(p["index"], p["score"]) for p in d["classification"]["predictions"]]
            for d in dets]


def _assert_composites_agree(jp: dict, tp: dict):
    """Detections equal; each classification's top-k indices equal and its
    scores within ``CROP_PROB_TOL`` (the crops differ by ≤ 1 LSB)."""
    assert tp["num_detections"] == jp["num_detections"] >= 1
    strip = [{k: v for k, v in d.items() if k != "classification"}
             for d in jp["detections"]]
    assert [{k: v for k, v in d.items() if k != "classification"}
            for d in tp["detections"]] == strip
    for a, b in zip(_cls_rows(jp["detections"]), _cls_rows(tp["detections"])):
        assert [i for i, _ in a] == [i for i, _ in b]
        assert max(abs(x - y) for (_, x), (_, y) in zip(a, b)) <= CROP_PROB_TOL


def test_executor_equals_the_reference(both):
    """One image through both catalogs: detections equal; classifications
    agree (``CROP_PROB_TOL``) and equal the JAX classifier run on the
    port's own crops (``PROB_TOL``); the per-stage images, cache hits and
    D2H bytes equal; both port dispatches were replays of executables
    warmup captured (the ragged engines' classic pairs)."""
    (jreg, japp, _), (treg, tapp, _) = both["jax"], both["port"]
    data = _jpeg(1)
    graphs0 = {mv.name: mv.engine.stats()["graphs"] for mv in treg.serving_entries()}
    jp, jtag, jmeta = japp.pipelines.execute("pipe", data, 3, _Span())
    tp, ttag, tmeta = tapp.pipelines.execute("pipe", data, 3, _Span())
    assert tmeta == jmeta == {"stages": [
        {"model": "ssd_mobilenet", "version": 1, "dtype": "float32"},
        {"model": "mobilenet_v2", "version": 1, "dtype": "float32"}]}
    _assert_composites_agree(jp, tp)
    assert all(len(r) == 3 for r in _cls_rows(tp["detections"]))
    jst = japp.pipelines.pipeline_stats()["pipelines"]["pipe"]["stages"]
    tst = tapp.pipelines.pipeline_stats()["pipelines"]["pipe"]["stages"]
    for model in ("ssd_mobilenet", "mobilenet_v2"):
        for key in ("images", "cache_hits", "d2h_bytes"):
            assert tst[model][key] == jst[model][key], (model, key)
    assert tst["ssd_mobilenet"]["d2h_bytes"] == 6 * CLASSES * 15 * 4 + 4  # one row, not a bucket
    graphs = {mv.name: mv.engine.stats()["graphs"] for mv in treg.serving_entries()}
    for name in graphs:
        assert graphs[name]["replays"] == graphs0[name]["replays"] + 1
        assert graphs[name]["eager_batches"] == graphs0[name]["eager_batches"] == 0

    # stage by stage: the detector, the port's mirror, the JAX classifier
    det, cls = (treg.acquire(n) for n in ("ssd_mobilenet", "mobilenet_v2"))
    jcls = jreg.acquire("mobilenet_v2")
    try:
        canvas, hw, _ = det.engine.prepare_bytes(data)
        boxes, _, _, num = (o[0] for o in det.engine.run_batch(canvas[None], np.array([hw])))
        crops = dag_glue.crop_resize_host(canvas, hw, boxes, num, out_s=CANVAS, n_crops=8)
        scores, idx = jcls.engine.run_batch(crops, np.full((8, 2), CANVAS, np.int32))
    finally:
        for mv, reg in ((det, treg), (cls, treg), (jcls, jreg)):
            reg.release(mv)
    for i, row in enumerate(_cls_rows(tp["detections"])):
        assert [j for j, _ in row] == [int(v) for v in idx[i][:3]]
        np.testing.assert_allclose([s for _, s in row], scores[i][:3], atol=PROB_TOL)


def _request(port: int, method: str, path: str, body: bytes = b"", headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request(method, path, body=body or None,
                     headers={"Content-Type": "image/jpeg", **(headers or {})})
        resp = conn.getresponse()
        data = resp.read()
        return resp.status, {k.lower(): v for k, v in resp.getheaders()}, \
            (json.loads(data) if data else None)
    finally:
        conn.close()


def _strip(doc: dict) -> dict:
    return {k: v for k, v in doc.items() if k not in ("latency_ms", "trace_id")}


def test_stats_and_metrics_name_the_reference_families(both):
    """After the same traffic, ``/stats → pipelines`` has the reference's
    keys at every level (attribution included) and ``/metrics`` the same
    ``tpu_serve_pipeline_*`` families and label sets; the live config names
    the pipelines."""
    docs, fams = [], []
    for _, _, port in both.values():
        for seed in (4, 4, 5):
            _request(port, "POST", "/pipelines/pipe", _jpeg(seed))
        stats = _request(port, "GET", "/stats")[2]
        docs.append(stats)
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("GET", "/metrics")
        text = conn.getresponse().read().decode()
        conn.close()
        # the batcher's tpu_serve_pipeline_depth and _inflight_batches are
        # another subsystem's
        fams.append(sorted({(name, tuple(k for k, _ in labels))
                            for name, labels in parse_prometheus_text(text)["samples"]
                            if name.startswith("tpu_serve_pipeline_")
                            and not name.startswith(("tpu_serve_pipeline_depth",
                                                     "tpu_serve_pipeline_inflight"))}))
    (jdoc, tdoc) = (d["pipelines"] for d in docs)

    def keys(d):
        return {k: keys(v) for k, v in d.items()} if isinstance(d, dict) else None

    assert keys(tdoc) == keys(jdoc)
    assert tdoc["pipelines"]["pipe"]["stages"]["ssd_mobilenet"]["cache_hits"] >= 1
    assert fams[0] == fams[1] and len(fams[1]) == 9
    assert [d["config"]["pipelines"] for d in docs] == [["pipe"], ["pipe"]]


def test_http_surface_equals_the_reference(both):
    """``GET /pipelines`` and ``/models → pipelines`` equal; ``POST
    /pipelines/<name>`` gives the reference's status and body for a good
    image (its envelope's keys, ``ETag``), ``If-None-Match`` (304, empty),
    an unknown pipeline (404), a bad ``topk``, two images, an empty body
    and an undecodable one (400), a body over the cap (413), and a stage
    that stopped serving (503)."""
    ports = {k: v[2] for k, v in both.items()}
    for path in ("/pipelines",):
        docs = [_request(p, "GET", path)[2] for p in ports.values()]
        assert docs[0] == docs[1] and docs[1]["pipe"]["ok"]
    models = [_request(p, "GET", "/models")[2]["pipelines"] for p in ports.values()]
    assert models[0] == models[1] and models[1]["pipe"]["ref"] == PIPE

    img = _jpeg(2)
    two = b"".join(b"--zZ\r\nContent-Disposition: form-data; name=\"f\"; filename=\"%d.jpg\""
                   b"\r\n\r\n" % i + _jpeg(3 + i) + b"\r\n" for i in range(2)) + b"--zZ--\r\n"
    multi = {"Content-Type": "multipart/form-data; boundary=zZ"}
    answers = {}
    for side, port in ports.items():
        ok = _request(port, "POST", "/pipelines/pipe", img)
        etag = ok[1]["etag"]
        answers[side] = [
            ok,
            _request(port, "POST", "/pipelines/pipe", img, {"If-None-Match": etag}),
            _request(port, "POST", "/pipelines/ghost", img),
            _request(port, "POST", "/pipelines/pipe?topk=abc", img),
            _request(port, "POST", "/pipelines/pipe", two, multi),
            _request(port, "POST", "/pipelines/pipe", b""),
            _request(port, "POST", "/pipelines/pipe", b"not an image"),
            _request(port, "POST", "/pipelines/pipe", b"\xff" * 60_000),
        ]
    (jok, *jrest), (tok, *trest) = answers["jax"], answers["port"]
    assert jok[0] == tok[0] == 200
    assert set(tok[2]) == set(jok[2]) == {"detections", "num_detections", "pipeline", "stages",
                                          "latency_ms", "trace_id"}
    assert tok[2]["trace_id"] == tok[1]["x-trace-id"]
    _assert_composites_agree(jok[2], tok[2])
    assert _strip(tok[2])["stages"] == jok[2]["stages"]
    assert [(s, b) for s, _, b in jrest] == [(s, b) for s, _, b in trest]
    assert [s for s, _, _ in trest] == [304, 404, 400, 400, 400, 400, 413]
    assert trest[0][2] is None and trest[0][1]["etag"] == tok[1]["etag"]

    for side, (reg, _, port) in both.items():
        reg.unload("mobilenet_v2", wait=True)
    down = [_request(p, "POST", "/pipelines/pipe", _jpeg(9)) for p in ports.values()]
    assert [(s, b) for s, _, b in down] == [(503, down[0][2])] * 2
    assert down[1][2] == {"error": "stage 'mobilenet_v2': model 'mobilenet_v2' has no "
                                   "serving version"}


# --------------------------------------------------- swaps (the port alone)


@pytest.fixture()
def swap_server():
    """The port's App and server whose classifier version v carries the
    seed-v weights, so that an answer names the version that computed it."""
    reg, app = _port_app(COMMON, _det_params(), _cls_params)
    srv = _serve(app)
    yield reg, app, srv.server_address[1]
    shutdown_gracefully(srv, reg, grace_s=3.0)
    reg.close_engines()


def test_stage1_cache_hit_after_a_classifier_swap(swap_server):
    """The same image twice: the same composite and ETag, one detector
    batch. After a classifier swap: a stage-1 hit (no detector batch) into
    the new classifier, whose answer is its own (another ETag), never the
    cached composite."""
    reg, app, port = swap_server
    det = reg.acquire("ssd_mobilenet")
    reg.release(det)
    data = _jpeg(6)
    b0 = det.engine.stats()["batches"]
    (s1, h1, p1), (s2, h2, p2) = (_request(port, "POST", "/pipelines/pipe", data)
                                  for _ in range(2))
    assert s1 == s2 == 200 and h1["etag"] == h2["etag"] and _strip(p1) == _strip(p2)
    assert det.engine.stats()["batches"] == b0 + 1
    reg.swap("mobilenet_v2", wait=True)
    s3, h3, p3 = _request(port, "POST", "/pipelines/pipe", data)
    assert s3 == 200 and p3["stages"][1]["version"] == 2 and h3["etag"] != h1["etag"]
    assert det.engine.stats()["batches"] == b0 + 1
    assert _cls_rows(p3["detections"]) != _cls_rows(p1["detections"])
    assert [{k: v for k, v in d.items() if k != "classification"} for d in p3["detections"]] \
        == [{k: v for k, v in d.items() if k != "classification"} for d in p1["detections"]]
    stages = app.pipelines.pipeline_stats()["pipelines"]["pipe"]["stages"]
    assert stages["ssd_mobilenet"]["cache_hits"] == 2
    assert stages["mobilenet_v2"]["cache_hits"] == 1
    assert app.pipelines.pipeline_stats()["resolutions_total"] >= 2


def test_classifier_hot_swap_under_traffic_has_no_stale_composite(swap_server):
    """Four clients post two images in a loop while the classifier is
    swapped: every answer is a 200, each composite's classification is the
    one its claimed version gives for that image alone, both versions
    answer, and none answers v1 once v1 is unloaded."""
    reg, app, port = swap_server
    images = [_jpeg(7), _jpeg(8)]
    truth = {(1, i): _cls_rows(_request(port, "POST", "/pipelines/pipe", im)[2]["detections"])
             for i, im in enumerate(images)}
    stop = threading.Event()
    seen, failures = [], []

    def client(k):
        n = 0
        while not stop.is_set():
            i = (k + n) % 2
            n += 1
            t0 = time.monotonic()
            try:
                status, _, body = _request(port, "POST", "/pipelines/pipe", images[i])
            except Exception as e:  # a failure is the finding
                failures.append(repr(e))
                continue
            if status != 200:
                failures.append((status, body))
                continue
            seen.append((t0, i, body["stages"][1]["version"], _cls_rows(body["detections"])))
            time.sleep(0.01)  # traffic throughout, and CPU left for the new version's build

    threads = [threading.Thread(target=client, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    try:
        while len(seen) < 8:
            time.sleep(0.01)
        v2 = reg.swap("mobilenet_v2", wait=True)
        reg.wait_for(reg._models["mobilenet_v2"][1], ("UNLOADED",), timeout=30)
        t_unloaded = time.monotonic()
        n_after = len(seen)
        while len(seen) < n_after + 8:
            time.sleep(0.01)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=60)
    assert not failures, failures[:3]
    for i, im in enumerate(images):
        truth[(v2.version, i)] = _cls_rows(
            _request(port, "POST", "/pipelines/pipe", im)[2]["detections"])
    stale = [(v, i) for _, i, v, rows in seen if rows != truth[(v, i)]]
    assert not stale, stale[:5]
    assert {v for _, _, v, _ in seen} == {1, 2}
    assert not [v for t0, _, v, _ in seen if t0 > t_unloaded and v != 2]
