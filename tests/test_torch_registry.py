"""The port's model registry (``serving/registry.py``) and its admin
surface, on the CPU.

The counterpart of each case of ``tests/test_registry.py`` on mock engines
(the registry is engine-agnostic; the batchers are the port's real ones):
the lifecycle, failed builds and warmups never disturbing the serving
version, drains waiting for in-flight requests, loads off the request
path, version addressing, ``/models``, the admin routes and their errors,
per-model counters in ``/stats``, and a hot swap under closed-loop load
with zero failures. Then a two-model server (Inception-v3 in float32 and
MobileNetV2 in the int8 tier, seeded weights, tiny widths) in both
packages, the same JPEGs through each one's registry routes, the port's
``split_model_spec`` against the JAX one, and the CLI's two-model config.
"""

import http.client
import io
import json
import threading
import time
from dataclasses import replace

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from tensorflow_web_deploy_tpu.parallel.mesh import build_mesh
from tensorflow_web_deploy_tpu.serving import http as jhttp
from tensorflow_web_deploy_tpu.serving.engine import InferenceEngine as JaxEngine
from tensorflow_web_deploy_tpu.serving.registry import ModelRegistry as JaxRegistry
from tensorflow_web_deploy_tpu.utils import config as jcfg
from tensorflow_web_deploy_tpu_torch.ops import quant
from tensorflow_web_deploy_tpu_torch.server import start_server
from tensorflow_web_deploy_tpu_torch.serving import registry as reg
from tensorflow_web_deploy_tpu_torch.serving.engine import RaggedSlab
from tensorflow_web_deploy_tpu_torch.serving.http import (
    App,
    make_http_server,
    shutdown_gracefully,
)
from tensorflow_web_deploy_tpu_torch.serving.registry import (
    ModelNotServing,
    ModelRegistry,
    UnknownModel,
)
from tensorflow_web_deploy_tpu_torch.utils import config as tcfg

torch.set_num_threads(2)

BUCKET = 16  # the mock servers' one canvas side


def jpeg(h=12, w=10, seed=0) -> bytes:
    img = (np.random.RandomState(seed).rand(h, w, 3) * 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG")
    return buf.getvalue()


class MockEngine:
    """The port engine's ragged staging API over real slabs in host memory;
    every row answers ``self.score``, so an answer names the engine (the
    version) that served it. ``warm_gate`` holds warmup open; ``fail_at``
    raises in the build ("build") or the warmup ("warm")."""

    max_batch = 4
    batch_buckets = (1, 2, 4)
    ragged = True
    topk = 3
    num_classes = 5
    parity = None

    def __init__(self, cfg, score=0.5, warm_gate=None, fail_at=None):
        self.cfg = cfg
        self.score = score
        self.warm_gate = warm_gate
        self.fail_at = fail_at
        self.warmed = self.closed = False
        self.batches = 0
        if fail_at == "build":
            raise RuntimeError("synthetic build failure")

    def warmup(self):
        if self.warm_gate is not None:
            assert self.warm_gate.wait(timeout=30), "warm gate never opened"
        if self.fail_at == "warm":
            raise RuntimeError("synthetic warmup failure")
        self.warmed = True

    def close(self):
        self.closed = True

    def healthcheck(self):
        return not self.closed

    def count_decode(self, decoder):
        pass

    def stats(self):
        return {"batches": self.batches}

    def pick_batch_bucket(self, n):
        return next(b for b in self.batch_buckets if n <= b)

    def acquire_ragged(self, s):
        slab = RaggedSlab(s, self.max_batch, pinned=False)
        slab.arm(lambda _: None)
        return slab

    def release_staging(self, slab):
        slab.finish()

    def dispatch_ragged(self, slab, n):
        assert not self.closed, "dispatch on a closed engine"
        slab.truncate(n)
        slab.finish()
        self.batches += 1
        return n

    def fetch_outputs(self, n):
        scores = np.full((n, self.topk), self.score, np.float32)
        return scores, np.tile(np.arange(self.topk, dtype=np.int32), (n, 1))


def _mc(name):
    return tcfg.ModelConfig(name=name)


def _cfg(name="m1"):
    return tcfg.ServerConfig(model=_mc(name), max_batch=4, max_delay_ms=1.0,
                             canvas_buckets=(BUCKET,), ragged=True, request_timeout_s=10.0,
                             drain_grace_s=5.0)


def make_registry(cfg=None, engine_factory=None):
    """A registry over mock engines; the default batcher factory builds
    the port's real (started, warmed) Batchers."""
    cfg = cfg or _cfg()
    factory = engine_factory or (lambda mc: MockEngine(cfg))
    return ModelRegistry(cfg, engine_factory=factory, spec_resolver=_mc)


def _states(mv):
    return [s for s, _ in mv.history]


def _submit(mv):
    """One image through a version's batcher: its row."""
    tight = np.zeros((8, 8, 3), np.uint8)
    return mv.batcher.submit_ragged(tight, (8, 8), BUCKET).result(timeout=10)


# ------------------------------------------------------- lifecycle machine


def test_load_walks_loading_warming_serving():
    r = make_registry()
    mv = r.load("m1", wait=True)
    assert mv.state == reg.SERVING
    assert _states(mv) == [reg.LOADING, reg.WARMING, reg.SERVING]
    assert mv.engine.warmed  # on the batcher's launch threads
    assert r.acquire() is mv  # the default model's serving version
    r.release(mv)
    r.stop()


def test_unload_drains_then_unloads():
    r = make_registry()
    mv = r.load("m1", wait=True)
    engine = mv.engine
    out = r.unload("m1", wait=True)
    assert out is mv
    assert _states(mv) == [reg.LOADING, reg.WARMING, reg.SERVING, reg.DRAINING, reg.UNLOADED]
    assert engine.closed, "unload must close the engine"
    assert mv.batcher is None and mv.engine is None
    with pytest.raises(ModelNotServing):
        r.acquire("m1")
    r.stop()


def test_stopped_registry_rejects_admin_jobs():
    r = make_registry()
    mv = r.load("m1", wait=True)
    r.stop()
    with pytest.raises(RuntimeError, match="stopped"):
        r.load("m2")
    with pytest.raises(RuntimeError, match="stopped"):
        r.unload("m1")
    with pytest.raises(RuntimeError, match="stopped"):
        r.swap("m1")
    assert r._serving["m1"] is mv  # the refused unload left the map alone
    r.close_engines()
    assert mv.engine.closed


def test_illegal_transition_rejected():
    r = make_registry()
    mv = r.load("m1", wait=True)
    with pytest.raises(RuntimeError, match="illegal lifecycle transition"):
        r._set_state(mv, reg.WARMING)
    r.stop()


def test_drain_waits_for_inflight_requests():
    r = make_registry()
    mv = r.load("m1", wait=True)
    held = r.acquire()  # a request mid-flight
    t0 = time.monotonic()
    r.unload("m1")
    r.wait_for(mv, (reg.DRAINING,), timeout=10)
    time.sleep(0.15)
    assert mv.state == reg.DRAINING, "must hold DRAINING while a request is in flight"
    r.release(held)
    r.wait_for(mv, (reg.UNLOADED,), timeout=10)
    assert time.monotonic() - t0 < 5.0
    r.stop()


# ----------------------------------------------------- failure isolation


def test_failed_build_never_disturbs_serving_version():
    calls = []
    cfg = _cfg()

    def factory(mc):
        calls.append(mc.name)
        return MockEngine(cfg, score=0.7, fail_at="build" if len(calls) > 1 else None)

    r = make_registry(cfg, factory)
    v1 = r.load("m1", wait=True)
    v2 = r.swap("m1", wait=True)
    assert v2.state == reg.FAILED and "synthetic build failure" in v2.error
    assert _states(v2) == [reg.LOADING, reg.FAILED]
    assert v1.state == reg.SERVING
    assert r.acquire("m1") is v1
    r.release(v1)
    r.stop()


def test_failed_warmup_never_disturbs_serving_version():
    cfg = _cfg()
    engines = [MockEngine(cfg, score=0.7), MockEngine(cfg, fail_at="warm")]
    r = make_registry(cfg, lambda mc: engines.pop(0))
    v1 = r.load("m1", wait=True)
    v2 = r.swap("m1", wait=True)
    assert v2.state == reg.FAILED and v2.error.startswith("warmup:")
    assert _states(v2) == [reg.LOADING, reg.WARMING, reg.FAILED]
    assert v2.engine is None and v2.batcher is None  # disposed of
    assert r.acquire("m1") is v1
    r.release(v1)
    assert _submit(v1)[0][0] == np.float32(0.7)  # v1 still answers
    r.stop()


# ----------------------------------------------- concurrent load-while-serving


def test_load_runs_off_the_request_path():
    cfg = _cfg()
    gate = threading.Event()
    engines = [MockEngine(cfg, score=0.1), MockEngine(cfg, score=0.9, warm_gate=gate)]
    r = make_registry(cfg, lambda mc: engines.pop(0))
    v1 = r.load("m1", wait=True)
    v2 = r.swap("m1")  # the loader blocks in v2's warmup
    r.wait_for(v2, (reg.WARMING,), timeout=10)
    for _ in range(3):  # meanwhile traffic resolves and completes against v1
        with r.lease_model("m1") as mv:
            assert mv is v1
            assert _submit(mv)[0][0] == np.float32(0.1)
    assert v2.state == reg.WARMING
    gate.set()
    r.wait_for(v2, (reg.SERVING,), timeout=10)
    with r.lease_model("m1") as mv:
        assert mv is v2
    r.wait_for(v1, (reg.UNLOADED,), timeout=10)
    assert v1.engine is None
    r.stop()


def test_explicit_version_addressing():
    r = make_registry()
    v1 = r.load("m1", wait=True)
    v2 = r.load("m1", activate=False, wait=True)  # standby: warm, not default
    assert v2.state == reg.SERVING
    assert r.acquire("m1") is v1
    r.release(v1)
    assert r.acquire("m1@2") is v2
    r.release(v2)
    for bad in ("m1@99", "nope", "m1@banana"):
        with pytest.raises(UnknownModel):
            r.acquire(bad)
    r.stop()


# ------------------------------------------------------------ admin surface


@pytest.fixture()
def mock_server():
    gate = threading.Event()
    gate.set()  # open; a test clears it to hold a load in WARMING
    counter = {"n": 0}
    cfg = _cfg()

    def factory(mc):
        counter["n"] += 1  # scores encode the build order
        return MockEngine(cfg, score=round(0.1 * counter["n"], 3), warm_gate=gate)

    r = ModelRegistry(cfg, engine_factory=factory, spec_resolver=_mc)
    r.load("m1", wait=True)
    app = App(r, cfg)
    srv = make_http_server(app, "127.0.0.1", 0, pool_size=8)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield srv.server_address[1], r, gate
    shutdown_gracefully(srv, r, grace_s=3.0)


def _req(port, method, path, body=None, timeout=15):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        payload = json.dumps(body).encode() if isinstance(body, dict) else body
        conn.request(method, path, body=payload,
                     headers={"Content-Type": "application/json" if isinstance(body, dict)
                              else "image/jpeg"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read() or b"null")
    finally:
        conn.close()


def test_models_listing_and_predict_routing(mock_server):
    port, r, _ = mock_server
    status, doc = _req(port, "GET", "/models")
    assert status == 200 and doc["default"] == "m1"
    assert doc["models"]["m1"]["serving_version"] == 1
    v = doc["models"]["m1"]["versions"][0]
    assert v["state"] == "SERVING"
    assert [h["state"] for h in v["history"]] == ["LOADING", "WARMING", "SERVING"]
    status, resp = _req(port, "POST", "/predict", jpeg())
    assert status == 200 and resp["model"] == "m1" and resp["model_version"] == 1
    status, resp = _req(port, "POST", "/predict?model=m1%401", jpeg())
    assert status == 200 and resp["model_version"] == 1
    status, resp = _req(port, "POST", "/predict?model=nope", jpeg())
    assert status == 404 and "unknown model" in resp["error"]


def test_admin_load_second_model_and_route_to_it(mock_server):
    port, r, _ = mock_server
    status, resp = _req(port, "POST", "/models/load", {"model": "m2", "wait": True})
    assert status == 200 and resp == {"name": "m2", "version": 1, "state": "SERVING"}
    status, resp = _req(port, "POST", "/predict?model=m2", jpeg())
    assert status == 200 and resp["model"] == "m2"
    status, resp = _req(port, "POST", "/predict", jpeg())
    assert status == 200 and resp["model"] == "m1"  # the default is untouched
    status, resp = _req(port, "POST", "/models/unload", {"name": "m2", "wait": True})
    assert status == 200 and resp["state"] == "UNLOADED"
    assert _req(port, "POST", "/predict?model=m2", jpeg())[0] == 503


def test_admin_errors(mock_server):
    port, r, gate = mock_server
    assert _req(port, "POST", "/models/load", {})[0] == 400
    assert _req(port, "POST", "/models/load", b"not json")[0] == 400
    assert _req(port, "POST", "/models/unload", {"name": "ghost"})[0] == 404
    assert _req(port, "POST", "/models/swap", {"name": "ghost"})[0] == 404
    assert _req(port, "GET", "/models/load")[0] == 405
    assert _req(port, "POST", "/models/unload", {"name": "m1", "version": 99})[0] == 404
    # a state conflict: a version that is not SERVING
    gate.clear()
    status, resp = _req(port, "POST", "/models/load", {"model": "m1", "activate": False})
    assert status == 202 and resp["state"] == "LOADING"
    r.wait_for(r._models["m1"][2], ("WARMING",), timeout=10)
    assert _req(port, "POST", "/models/unload", {"name": "m1", "version": 2})[0] == 409
    # a wait that runs out answers 504; the load goes on
    assert _req(port, "POST", "/models/swap", {"name": "m1", "wait": True,
                                                "timeout_s": 0.2})[0] == 504
    gate.set()


def test_healthz_follows_the_default_model(mock_server):
    port, _, _ = mock_server
    assert _req(port, "GET", "/healthz") == (200, {"ok": True})
    assert _req(port, "POST", "/models/unload", {"name": "m1", "wait": True})[0] == 200
    assert _req(port, "GET", "/healthz") == (503, {"ok": False})
    assert _req(port, "POST", "/models/load", {"model": "m1", "wait": True})[0] == 200
    assert _req(port, "GET", "/healthz") == (200, {"ok": True})


def test_stats_carry_per_model_counters(mock_server):
    port, _, _ = mock_server
    assert _req(port, "POST", "/models/load", {"model": "m2", "wait": True})[0] == 200
    for spec in ("m1", "m2", "m2"):
        assert _req(port, "POST", f"/predict?model={spec}", jpeg())[0] == 200
    status, snap = _req(port, "GET", "/stats")
    assert status == 200 and snap["model"] == "m1"
    assert snap["batcher"]["images"] >= 1 and snap["engine"] == {"batches": 1}
    models = snap["models"]["models"]
    for name, images in (("m1", 1), ("m2", 2)):
        v = models[name]["versions"][0]
        assert models[name]["serving_version"] == 1
        assert v["batcher"]["images"] == images and v["engine"]["batches"] >= 1
    assert snap["http"]["requests_total"] >= 4


# --------------------------------------------- hot swap under load (acceptance)


def test_hot_swap_under_load_zero_failures(mock_server):
    """Closed-loop traffic on /predict while the model hot-swaps: zero
    failed requests, answers flip from v1's engine to v2's, and /models
    (polled throughout, and the final history) shows every state."""
    port, r, gate = mock_server
    stop = threading.Event()
    failures, scores_seen, seen_states = [], [], set()
    body = jpeg()

    def hammer():
        while not stop.is_set():
            try:
                status, resp = _req(port, "POST", "/predict", body, timeout=30)
            except Exception as e:  # a connection-level failure is a failure too
                failures.append(("exc", repr(e)))
                continue
            if status != 200:
                failures.append((status, resp))
            else:
                scores_seen.append(resp["predictions"][0]["score"])

    def watch_models():
        while not stop.is_set():
            try:
                _, doc = _req(port, "GET", "/models", timeout=10)
            except Exception:
                continue
            for v in doc["models"]["m1"]["versions"]:
                seen_states.add(v["state"])
            time.sleep(0.005)

    threads = [threading.Thread(target=hammer) for _ in range(4)]
    threads.append(threading.Thread(target=watch_models))
    for t in threads:
        t.start()
    try:
        time.sleep(0.3)
        gate.clear()  # the swap spends real time in WARMING
        v2 = r.swap("m1")
        r.wait_for(v2, ("WARMING",), timeout=10)
        time.sleep(0.3)
        gate.set()
        r.wait_for(v2, ("SERVING",), timeout=10)
        r.wait_for(r._models["m1"][1], ("UNLOADED",), timeout=10)
        time.sleep(0.3)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert not failures, f"requests failed during the hot swap: {failures[:5]}"
    assert {0.1, 0.2} <= {round(s, 3) for s in scores_seen}
    _, doc = _req(port, "GET", "/models")
    hist = [[h["state"] for h in v["history"]] for v in doc["models"]["m1"]["versions"]]
    assert hist == [["LOADING", "WARMING", "SERVING", "DRAINING", "UNLOADED"],
                    ["LOADING", "WARMING", "SERVING"]]
    assert {"SERVING", "WARMING", "UNLOADED"} <= seen_states


# ------------------------------------------ two models, both packages' servers

INCEPTION = dict(name="inception_v3", source="native", zoo_width=0.25, zoo_classes=10,
                 input_size=(75, 75), preprocess="inception", topk=3, dtype="float32")
MOBILENET_INT8 = dict(name="mobilenet_v2", source="native", zoo_width=0.25, zoo_classes=10,
                      input_size=(64, 64), preprocess="inception", topk=10, dtype="int8",
                      alias="mobilenet_v2_int8")
# the reference engine's int8 gate, as tests/test_torch_quant.py states it
INT8_PROB, INT8_TOPK = 0.15, 0.90


def _served(port, images, name):
    return [_req(port, "POST", f"/predict?model={name}", img, timeout=120) for img in images]


def _probs(answers, classes):
    out = np.zeros((len(answers), classes), np.float32)
    for row, (_, body) in zip(out, answers):
        for p in body["predictions"]:
            row[p["index"]] = p["score"]
    return out


def test_two_model_registry_servers_agree_with_jax():
    """The same seeded JPEGs through the JAX package's registry server and
    the port's, both serving Inception-v3 (float32) and MobileNetV2 (int8,
    as ``mobilenet_v2_int8``) on the ragged rgb wire from seeded weights,
    routed by ``?model=``: Inception's top-k indices identical and scores
    within 1e-4; MobileNetV2 int8 within the int8 gate's tolerance."""
    common = dict(canvas_buckets=(96,), max_batch=4, wire_format="rgb", ragged=True)
    jmcs = [jcfg.ModelConfig(**INCEPTION), jcfg.ModelConfig(**MOBILENET_INT8)]
    jserver_cfg = jcfg.ServerConfig(model=jmcs[0], warmup=False, **common)
    jreg = JaxRegistry(jserver_cfg, default_model="inception_v3")
    mesh = build_mesh(jax.devices()[:1])
    for mc in jmcs:
        eng = JaxEngine(replace(jserver_cfg, model=mc), mesh=mesh)
        jreg.adopt(mc.serve_name, eng, jreg.build_batcher(eng, mc.serve_name), mc)
    jsrv = jhttp.make_http_server(jhttp.App.from_registry(jreg, jserver_cfg), "127.0.0.1", 0,
                                  pool_size=4)
    threading.Thread(target=jsrv.serve_forever, daemon=True).start()
    tmcs = (tcfg.ModelConfig(**INCEPTION), tcfg.ModelConfig(**MOBILENET_INT8))
    tserver_cfg = tcfg.ServerConfig(model=tmcs[0], models=tmcs, host="127.0.0.1", port=0,
                                    **common)
    images = [jpeg(h, w, seed) for seed, (h, w) in enumerate([(80, 72), (50, 90), (96, 96),
                                                               (33, 61)])]
    try:
        with start_server(tserver_cfg, device="cpu") as tsrv:
            port = tsrv.port
            status, doc = _req(port, "GET", "/models")
            assert status == 200 and sorted(doc["models"]) == ["inception_v3",
                                                               "mobilenet_v2_int8"]
            got = {n: _served(port, images, n) for n in ("inception_v3", "mobilenet_v2_int8")}
        jport = jsrv.server_address[1]
        want = {n: _served(jport, images, n) for n in ("inception_v3", "mobilenet_v2_int8")}
    finally:
        jhttp.shutdown_gracefully(jsrv, jreg, grace_s=3.0)
        for mv in jreg.serving_entries():
            mv.engine.close()
    for name in got:
        assert [s for s, _ in got[name]] == [s for s, _ in want[name]] == [200] * len(images)
        assert all(b["model"] == name and b["model_version"] == 1 for _, b in got[name])
    for (_, g), (_, w) in zip(got["inception_v3"], want["inception_v3"]):
        assert [p["index"] for p in g["predictions"]] == [p["index"] for p in w["predictions"]]
        np.testing.assert_allclose([p["score"] for p in g["predictions"]],
                                   [p["score"] for p in w["predictions"]], atol=1e-4)
    g, w = _probs(got["mobilenet_v2_int8"], 10), _probs(want["mobilenet_v2_int8"], 10)
    assert np.isfinite(g).all() and quant.topk_agreement(w, g, 5, INT8_PROB) >= INT8_TOPK
    assert float(np.abs(g - w).max()) <= INT8_PROB


# ------------------------------------------------------------ split_model_spec

SPECS = [
    "native:mobilenet_v2",
    "native:mobilenet_v2,dtype=int8",
    "native:mobilenet_v2,dtype=int8,as=mobilenet_v2_int8",
    "native:inception_v3,as=incep,dtype=bf16",
    "native:inception_v3,dtype=F32",
    "cfg.json, as=x ,",
    "native:mobilenet_v2,dtype=fp8",
    "native:mobilenet_v2,as=",
    "native:mobilenet_v2,color=red",
    "native:mobilenet_v2,dtype",
]


@pytest.mark.parametrize("spec", SPECS)
def test_split_model_spec_matches_jax(spec):
    try:
        want = jcfg.split_model_spec(spec)
    except ValueError:
        with pytest.raises(ValueError):
            tcfg.split_model_spec(spec)
    else:
        assert tcfg.split_model_spec(spec) == want


@pytest.mark.parametrize("spec", ["native:mobilenet_v2,replicas=4",
                                  "native:mobilenet_v2,shard=batch,dtype=int8"])
def test_placement_suffixes_wait_for_item_9(spec):
    """Item 9 (placement) is ported: both packages take the suffixes alike."""
    assert jcfg.split_model_spec(spec)[1]["placement"]
    assert tcfg.split_model_spec(spec) == jcfg.split_model_spec(spec)


def test_model_config_takes_the_suffixes():
    mc = tcfg.model_config("native:mobilenet_v2,dtype=int8,as=mobilenet_v2_int8")
    want = jcfg.model_config("native:mobilenet_v2,dtype=int8,as=mobilenet_v2_int8")
    assert (mc.name, mc.dtype, mc.alias, mc.serve_name) == (
        want.name, want.dtype, want.alias, want.serve_name) == (
        "mobilenet_v2", "int8", "mobilenet_v2_int8", "mobilenet_v2_int8")


def test_cli_builds_a_two_model_config():
    from tensorflow_web_deploy_tpu_torch.server import config_from_args, parse_args

    cfg = config_from_args(parse_args([
        "--model", "native:inception_v3", "--model",
        "native:mobilenet_v2,dtype=int8,as=mobilenet_v2_int8", "--default-model",
        "mobilenet_v2_int8", "--http-workers", "4", "--keepalive-timeout-s", "2.5"]))
    assert [m.serve_name for m in cfg.serve_models] == ["inception_v3", "mobilenet_v2_int8"]
    assert [m.dtype for m in cfg.serve_models] == ["bfloat16", "int8"]
    assert cfg.default_name == cfg.model.serve_name == "mobilenet_v2_int8"
    assert (cfg.http_workers, cfg.keepalive_timeout_s) == (4, 2.5)
    one = config_from_args(parse_args(["--zoo-width", "0.25"]))
    assert one.serve_models == (one.model,) and one.model.zoo_width == 0.25
    assert one.default_name == "inception_v3"
    for argv, match in [
        (["--model", "native:inception_v3", "--model", "native:mobilenet_v2",
          "--zoo-width", "0.25"], "exactly one model"),
        (["--model", "native:inception_v3", "--default-model", "nope"], "not among"),
        (["--model", "native:mobilenet_v2", "--model", "native:mobilenet_v2,dtype=int8"],
         "duplicate model names"),
        (["--model", "native:mobilenet_v2,replicas=2,shard=batch"], "conflicting placement"),
    ]:
        with pytest.raises(ValueError, match=match):
            config_from_args(parse_args(argv))
