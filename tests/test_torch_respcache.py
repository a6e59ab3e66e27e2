"""The port's response cache (``serving/respcache.py``) and its place in
the App, on the CPU, held against the JAX package.

Digests and ETags are string-identical to the reference's on the same
seeded arrays and payloads, and the App's cache key for a seeded JPEG (or
PNG, through PIL) is the reference's digest of the reference decoder's
output on the ragged, yuv420 and rgb wires; the LRU, single flight, abort
and invalidation give the reference cache's answers and counters on one
scripted sequence (exact equality). Then the reference's HTTP cases on the
port's App over mock engines with the port's real batchers and slabs:
miss → hit → 304, 16 concurrent identical requests dispatching one row, a
hot swap under cache-hot load with zero stale answers, and a disabled
cache sending no ``X-Cache``. ``tests/test_torch_overload.py`` and
``tests/test_torch_chaos.py`` use this file's mock engine and App helpers.
"""

import io
import json
import threading
import time
from dataclasses import replace

import numpy as np
import pytest
import torch
from PIL import Image

from tensorflow_web_deploy_tpu import native as jnative
from tensorflow_web_deploy_tpu.ops import image as jimage
from tensorflow_web_deploy_tpu.serving import respcache as jrc
from tensorflow_web_deploy_tpu_torch.serving import respcache as trc
from tensorflow_web_deploy_tpu_torch.serving.engine import RaggedSlab, StagingSlab
from tensorflow_web_deploy_tpu_torch.serving.http import App, _etag_matches
from tensorflow_web_deploy_tpu_torch.serving.registry import ModelRegistry
from tests.test_torch_registry import BUCKET, MockEngine, _cfg, _mc, jpeg

torch.set_num_threads(2)


# ----------------------------------------------- mock engines and the App


class ServeEngine(MockEngine):
    """The registry tests' mock engine on the configured wire (ragged, or
    the classic wire's pinned-less ``StagingSlab`` rows), with the slabs it
    hands out counted back (``outstanding``) and every fetch held while
    ``fetch_gate`` is clear."""

    def __init__(self, cfg, score=0.5, warm_gate=None, fetch_gate=None):
        super().__init__(cfg, score=score, warm_gate=warm_gate)
        self.ragged = cfg.ragged
        self.fetch_gate = fetch_gate
        self.outstanding = 0
        self._lock = threading.Lock()

    def _armed(self, slab):
        with self._lock:
            self.outstanding += 1
        slab.arm(self._back)
        return slab

    def _back(self, _slab):
        with self._lock:
            self.outstanding -= 1

    def acquire_ragged(self, s):
        return self._armed(RaggedSlab(s, self.max_batch, pinned=False))

    def acquire_staging(self, s):
        shape = (s * 3 // 2, s) if self.cfg.wire_format == "yuv420" else (s, s, 3)
        return self._armed(StagingSlab(s, shape, self.max_batch, pinned=False))

    def dispatch_staged(self, slab, n):
        assert not self.closed, "dispatch on a closed engine"
        slab.finish()
        self.batches += 1
        return n

    def fetch_outputs(self, n):
        if self.fetch_gate is not None:
            assert self.fetch_gate.wait(timeout=30), "fetch gate never opened"
        return super().fetch_outputs(n)


def serve_cfg(wire="ragged", **kw):
    """The registry tests' config on one wire ("ragged", "rgb" or "yuv420")."""
    cfg = _cfg()
    if wire != "ragged":
        cfg = replace(cfg, ragged=False, wire_format=wire)
    return replace(cfg, **kw)


def make_app(cfg, factory=None, models=("m1",)):
    """An App over a registry of :class:`ServeEngine` models (scores 0.1, 0.2,
    … in build order), each SERVING; ``models`` are ModelConfigs or names."""
    count = {"n": 0}

    def default(mc):
        count["n"] += 1
        return ServeEngine(cfg, score=round(0.1 * count["n"], 3))

    reg = ModelRegistry(cfg, engine_factory=factory or default, spec_resolver=_mc)
    for m in models:
        reg.load(m, wait=True)
    return App(reg, cfg), reg


def close_app(reg):
    reg.stop(grace_s=5.0)
    reg.close_engines()


def post(app, body=b"", qs="", headers=None, ctype="image/jpeg"):
    """POST /predict straight through the WSGI app: (status code, headers,
    body bytes)."""
    captured = {}

    def start_response(status, hdrs):
        captured["status"], captured["headers"] = status, dict(hdrs)

    environ = {"REQUEST_METHOD": "POST", "PATH_INFO": "/predict", "QUERY_STRING": qs,
               "CONTENT_TYPE": ctype, "CONTENT_LENGTH": str(len(body)),
               "wsgi.input": io.BytesIO(body)}
    for k, v in (headers or {}).items():
        environ["HTTP_" + k.upper().replace("-", "_")] = v
    out = b"".join(app(environ, start_response))
    return int(captured["status"].split()[0]), captured["headers"], out


def drained(batcher, engine=None, timeout=10.0) -> dict:
    """Wait until the batcher holds nothing (no leased slot, no batch in
    flight) and, with ``engine``, every slab is back; its stats."""
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        st = batcher.stats()
        if (st["queued"] == 0 and st["inflight"] == 0
                and (engine is None or engine.outstanding == 0)):
            return st
        time.sleep(0.02)
    raise AssertionError(f"never drained: {batcher.stats()}")


def _png(h, w, seed):
    img = (np.random.RandomState(seed).rand(h, w, 3) * 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "PNG")
    return buf.getvalue()


def _payload(i=0):
    return {"predictions": [{"label": f"class_{i}", "index": i, "score": 0.5}]}


# --------------------------------------------------- digests and ETags


@pytest.mark.parametrize("shape,hw", [((16, 16, 3), (12, 9)), ((24, 16), (16, 13)),
                                      ((7, 5, 3), (7, 5))])
def test_digests_and_etags_are_the_references(shape, hw):
    rs = np.random.RandomState(sum(shape))
    arr = rs.randint(0, 256, shape).astype(np.uint8)
    for a in (arr, arr[:, ::2], arr.copy()):  # non-contiguous views digest as their copies
        assert trc.canvas_digest(a, hw) == jrc.canvas_digest(a, hw)
        assert trc.packed_digest(a, hw, 64) == jrc.packed_digest(a, hw, 64)
    flipped = arr.copy()
    flipped.flat[3] ^= 1
    assert trc.canvas_digest(flipped, hw) != trc.canvas_digest(arr, hw)
    assert trc.canvas_digest(arr, (hw[0], hw[1] + 1)) != trc.canvas_digest(arr, hw)
    assert trc.packed_digest(arr, hw, 64) != trc.packed_digest(arr, hw, 128)
    payload = {"predictions": [{"label": f"c{i}", "index": int(i), "score": float(s)}
                               for i, s in zip(rs.randint(0, 1000, 5), rs.rand(5))],
               "nested": {"b": [1, 2], "a": None}}
    reordered = json.loads(json.dumps(payload, sort_keys=True))
    for p in (payload, reordered):
        assert trc.payload_etag(p, "m", 3) == jrc.payload_etag(p, "m", 3)
        assert trc.stage_input_digest("d0", p) == jrc.stage_input_digest("d0", p)
    assert trc.payload_etag(payload, "m", 3) != trc.payload_etag(payload, "m", 4)
    assert trc.make_key("m", 2, "d", 5, "int8") == jrc.make_key("m", 2, "d", 5, "int8")
    assert trc.make_key("m", 2, "d", 5) == jrc.make_key("m", 2, "d", 5)


@pytest.mark.parametrize("wire", ["ragged", "yuv420", "rgb"])
def test_the_app_keys_an_upload_by_the_references_digest(wire):
    """The App's key for seeded uploads (JPEGs at even and odd sizes, one
    downscaled by libjpeg's DCT to fit the bucket, and a PNG through PIL)
    is the reference's key over the reference decoder's output."""
    uploads = [jpeg(12, 10, 1), jpeg(13, 11, 2), jpeg(40, 30, 3), _png(9, 14, 4)]
    buckets = (BUCKET,)
    want = []
    for data in uploads:
        if wire == "ragged":
            plan = jnative.plan_decode_packed(data, buckets)
            if plan is not None:
                s, need, _, _ = plan
                buf = np.zeros(need, np.uint8)
                hw = jnative.decode_packed_into(data, buf, s)
                digest = jrc.packed_digest(buf, hw, s)
            else:
                tight, hw, s = jimage.fit_to_bucket(jimage.decode_image(data), buckets)
                digest = jrc.packed_digest(tight, hw, s)
        else:
            plan = jnative.plan_decode(data, buckets, wire)
            if plan is not None:
                s, row_shape, _ = plan
                row = np.zeros(row_shape, np.uint8)
                hw = jnative.decode_into_row(data, row, s, wire)
                digest = jrc.canvas_digest(row, hw)
            else:
                canvas, hw = jimage.pad_to_canvas(jimage.decode_image(data), buckets)
                if wire == "yuv420":
                    canvas = jimage.rgb_to_yuv420_canvas(canvas)
                digest = jrc.canvas_digest(canvas, hw)
        want.append(jrc.make_key("m1", 1, digest, 3, "bfloat16"))
    app, reg = make_app(serve_cfg(wire, cache_bytes=1 << 20))
    keys = []
    begin = app.cache.begin
    app.cache.begin = lambda key, model: keys.append(key) or begin(key, model)
    try:
        for data in uploads:
            status, headers, _ = post(app, data)
            assert status == 200 and headers["X-Cache"] == "miss"
        assert keys == want
        assert [post(app, d)[1]["X-Cache"] for d in uploads] == ["hit"] * len(uploads)
        st = reg.default_entry().engine
        assert drained(reg.default_entry().batcher, st)["images"] == len(uploads)
    finally:
        close_app(reg)


# -------------------------------------------- the cache against the reference


def _script(mod, cache):
    """One scripted sequence over a cache of module ``mod``: LRU touches and
    evictions, an oversized payload, single flight (lead, wait, complete,
    hit), an abort, an invalidation with a flight in the air and a late
    completion. Returns every observable answer and the final stats."""
    out = []

    def fill(model, version, i):
        key = mod.make_key(model, version, f"digest{i}", 5)
        kind, flight = cache.begin(key, model)
        out.append(kind)
        if kind == "lead":
            out.append(cache.complete(flight, _payload(i)))
        return key

    keys = [fill("m", 1, i) for i in range(3)]
    out.append(cache.begin(keys[0], "m")[0])  # key 0 becomes the most recent
    fill("m", 1, 99)  # evicts key 1 on the small budget
    out.append(("after eviction", cache.begin(keys[1], "m")[0], cache.begin(keys[0], "m")[0]))
    big = mod.make_key("m", 1, "big", 5)
    _, flight = cache.begin(big, "m")
    cache.complete(flight, {"predictions": ["x" * 400]})
    out.append(cache.begin(big, "m")[0])
    key = mod.make_key("n", 1, "d0", 5)
    kind, flight = cache.begin(key, "n")
    kind2, flight2 = cache.begin(key, "n")
    out += [kind, kind2, flight2 is flight]
    etag = cache.complete(flight, _payload(7))
    out += [flight2.future.result(timeout=5) == (_payload(7), etag), cache.begin(key, "n")[0]]
    key = mod.make_key("n", 1, "d1", 5)
    _, flight = cache.begin(key, "n")
    _, waiter = cache.begin(key, "n")
    cache.abort(flight, RuntimeError("leader died"))
    out += [repr(waiter.future.exception(timeout=5)), cache.begin(key, "n")[0]]
    kept = fill("m", 2, 7)
    key = mod.make_key("m", 1, "in-flight", 5)
    _, flight = cache.begin(key, "m")
    _, waiter = cache.begin(key, "m")
    out.append(cache.invalidate("m", 1))
    out.append(type(waiter.future.exception(timeout=5)).__name__)
    cache.complete(flight, _payload())  # after its version retired: not stored
    out += [cache.begin(key, "m")[0], cache.begin(kept, "m")[0]]
    st = cache.stats()
    st.pop("bulk", None)  # the reference's bulk tier (ROADMAP Queue 1 item 14)
    for c in st["per_model"].values():
        for k in ("bulk_hits", "bulk_misses", "bulk_coalesced"):
            c.pop(k, None)
    return out, st


# one _payload entry's bytes in the LRU
ENTRY = len(json.dumps(_payload(0), separators=(",", ":")))


@pytest.mark.parametrize("budget", [0, 8, 3 * ENTRY + 2, 1 << 20])
def test_the_cache_answers_and_counts_as_the_references(budget):
    """Exact equality of every answer and counter on the same script, from a
    disabled cache and one smaller than any payload to one of room for three
    entries (evictions) and a roomy one."""
    got = _script(trc, trc.ResponseCache(budget))
    want = _script(jrc, jrc.ResponseCache(budget))
    assert got == want
    out, st = got
    assert st["enabled"] == (budget > 0)
    if budget == 3 * ENTRY + 2:
        assert st["evictions_total"] >= 1 and ("after eviction", "lead", "hit") in out
    assert "CacheRetired" in out


@pytest.mark.parametrize("inm,match", [(None, False), ("", False), ("*", True), (' * ', True),
                                       ('"abc"', True), ('W/"abc"', True), ('w/ "abc"', True),
                                       ('"x", "abc"', True), ('"abcd"', False), ("abc", True)])
def test_if_none_match_as_the_reference(inm, match):
    from tensorflow_web_deploy_tpu.serving.http import _etag_matches as jmatch

    assert _etag_matches(inm, "abc") == jmatch(inm, "abc") == match


# ------------------------------------------------------------ over HTTP


def test_miss_hit_304_and_the_stats_block():
    app, reg = make_app(serve_cfg(cache_bytes=1 << 20))
    try:
        a = jpeg(12, 10, 11)
        status, hdr, body = post(app, a)
        assert status == 200 and hdr["X-Cache"] == "miss"
        etag = hdr["ETag"]
        assert etag.startswith('"') and etag.endswith('"')
        status, hdr2, body2 = post(app, a)
        assert status == 200 and hdr2["X-Cache"] == "hit" and hdr2["ETag"] == etag
        # the same payload; the envelope's latency_ms and trace_id are per request
        envelope = ("latency_ms", "trace_id")
        miss, hit = json.loads(body), json.loads(body2)
        assert all(k in miss and k in hit for k in envelope)
        assert {k: v for k, v in hit.items() if k not in envelope} == \
            {k: v for k, v in miss.items() if k not in envelope}
        # the client's copy is current: 304, no body
        status, hdr3, body3 = post(app, a, headers={"If-None-Match": etag})
        assert status == 304 and body3 == b"" and hdr3["Content-Length"] == "0"
        assert hdr3["ETag"] == etag
        status, hdr4, _ = post(app, a, headers={"If-None-Match": '"deadbeef"'})
        assert status == 200 and hdr4["X-Cache"] == "hit"
        # topk rides the key: a fresh miss
        status, hdr5, _ = post(app, a, qs="topk=2")
        assert status == 200 and hdr5["X-Cache"] == "miss" and hdr5["ETag"] != etag
        # per-image accounting for a several-image request
        b = jpeg(11, 12, 12)
        boundary = "zZ"
        parts = b"".join(f"--{boundary}\r\nContent-Disposition: form-data; name=\"f\"; "
                         f"filename=\"{n}.jpg\"\r\n\r\n".encode() + d + b"\r\n"
                         for n, d in (("a", a), ("b", b)))
        status, hdr6, body6 = post(app, parts + f"--{boundary}--\r\n".encode(),
                                   ctype=f"multipart/form-data; boundary={boundary}")
        assert status == 200 and hdr6["X-Cache"] == "miss; hits=1/2" and "ETag" not in hdr6
        assert len(json.loads(body6)["results"]) == 2
        st = app._stats()["cache"]
        assert st["enabled"] and st["hits_total"] == 4 and st["misses_total"] == 3
        assert st["per_model"]["m1"]["entries"] == 3 and st["inflight"] == 0
        assert app._stats()["overload"]["pressure"]["level"] == 0
    finally:
        close_app(reg)


def test_16_concurrent_identical_requests_dispatch_one_row():
    gate = threading.Event()
    cfg = serve_cfg(cache_bytes=1 << 20)
    engines = []

    def factory(mc):
        engines.append(ServeEngine(cfg, fetch_gate=gate))
        return engines[-1]

    app, reg = make_app(cfg, factory)
    batcher = reg.default_entry().batcher
    data, results = jpeg(12, 10, 21), []
    threads = [threading.Thread(target=lambda: results.append(post(app, data)))
               for _ in range(16)]
    try:
        threads[0].start()
        end = time.monotonic() + 10
        while app.cache.stats()["inflight"] < 1:
            assert time.monotonic() < end, "the leader never took flight"
            time.sleep(0.005)
        for t in threads[1:]:
            t.start()
        end = time.monotonic() + 10
        while app.cache.stats()["coalesced_total"] < 15:
            assert time.monotonic() < end, f"no coalescing: {app.cache.stats()}"
            time.sleep(0.005)
    finally:
        gate.set()
        for t in threads:
            t.join(timeout=30)
    try:
        assert [s for s, _, _ in results] == [200] * 16
        assert len({json.loads(b)["predictions"][0]["score"] for _, _, b in results}) == 1
        kinds = sorted(h["X-Cache"] for _, h, _ in results)
        assert kinds == ["coalesced"] * 15 + ["miss"]
        st = drained(batcher, engines[0])
        assert st["images"] == 1  # one row dispatched; the coalesced slots were holes
        assert st["holes"] == 15  # each coalesced request released its slot as a hole
    finally:
        close_app(reg)


def test_hot_swap_under_cache_hot_load_has_zero_stale_answers():
    """Identical-image traffic while the model hot-swaps: every answer's
    score is its claimed version's (0.1 × version), no request started
    after v1 was UNLOADED answers v1, nothing fails, and v2 builds its own
    entries."""
    warm = threading.Event()
    warm.set()
    cfg = serve_cfg(cache_bytes=1 << 20)
    count = {"n": 0}

    def factory(mc):
        count["n"] += 1
        return ServeEngine(cfg, score=round(0.1 * count["n"], 3), warm_gate=warm)

    app, reg = make_app(cfg, factory)
    stop, failures, answers = threading.Event(), [], []
    data = jpeg(12, 10, 31)

    def hammer():
        while not stop.is_set():
            t0 = time.monotonic()
            status, _, body = post(app, data)
            if status != 200:
                failures.append((status, body))
            else:
                doc = json.loads(body)
                answers.append((t0, doc["model_version"], doc["predictions"][0]["score"]))

    threads = [threading.Thread(target=hammer) for _ in range(4)]
    for t in threads:
        t.start()
    try:
        time.sleep(0.3)
        assert app.cache.stats()["hits_total"] > 0, "the traffic must be cache-hot"
        warm.clear()
        v2 = reg.swap("m1")
        reg.wait_for(v2, ("WARMING",), timeout=10)
        time.sleep(0.2)  # v1 serves from its entries meanwhile
        warm.set()
        reg.wait_for(v2, ("SERVING",), timeout=10)
        reg.wait_for(reg._models["m1"][1], ("UNLOADED",), timeout=10)
        t_unloaded = time.monotonic()
        time.sleep(0.3)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30)
    try:
        assert not failures, failures[:5]
        assert not [(v, s) for _, v, s in answers if abs(s - 0.1 * v) > 1e-6]
        assert not [v for t0, v, _ in answers if t0 > t_unloaded and v != 2]
        assert {v for _, v, _ in answers} == {1, 2}
        st = app.cache.stats()
        assert st["invalidations_total"] >= 1 and st["per_model"]["m1"]["hits"] > 0
        assert any(v == 2 for t0, v, _ in answers if t0 > t_unloaded)
    finally:
        close_app(reg)


def test_a_disabled_cache_sends_no_x_cache_and_dedups_nothing():
    app, reg = make_app(serve_cfg(cache_bytes=0))
    try:
        data = jpeg(12, 10, 41)
        status, hdr, _ = post(app, data)
        assert status == 200 and "X-Cache" not in hdr
        status, hdr2, body2 = post(app, data, headers={"If-None-Match": hdr["ETag"]})
        assert status == 304 and body2 == b"" and hdr2["ETag"] == hdr["ETag"]
        assert post(app, data)[0] == 200
        st = app.cache.stats()
        assert not st["enabled"] and st["entries"] == 0 and st["hits_total"] == 0
        assert drained(reg.default_entry().batcher)["images"] == 3  # each computed
    finally:
        close_app(reg)


def test_the_default_server_caches_and_degrades_as_the_reference_cli(monkeypatch):
    """With no overload flags the CLI serves a 256 MiB cache, the 3-rung
    ladder and the default SLO classes, as the reference's ``server.py``;
    a tiny MobileNetV2 from it answers a repeat with ``X-Cache: hit`` and
    its ETag, and ``If-None-Match`` with 304. ``TWD_CHAOS`` is
    ``--chaos``'s default."""
    import urllib.error
    import urllib.request

    from tensorflow_web_deploy_tpu.utils import config as jcfg
    from tensorflow_web_deploy_tpu_torch.server import config_from_args, parse_args, start_server
    from tensorflow_web_deploy_tpu_torch.utils.config import ModelConfig, ServerConfig

    monkeypatch.delenv("TWD_CHAOS", raising=False)
    args = ["--model", "native:mobilenet_v2", "--dtype", "f32", "--zoo-width", "0.25",
            "--zoo-classes", "10", "--canvas-buckets", "64", "--max-batch", "2",
            "--host", "127.0.0.1", "--port", "0", "--no-warmup"]
    cfg = config_from_args(parse_args(args))
    ref = jcfg.ServerConfig(model=jcfg.ModelConfig(name="m", source="native"))
    assert cfg.cache_bytes == 256 << 20 and cfg.chaos is None
    assert (cfg.pressure_rungs, cfg.slo_classes, cfg.tenant_quota, cfg.tenant_burst_s) == (
        ref.pressure_rungs, ref.slo_classes, ref.tenant_quota, ref.tenant_burst_s)
    dataclass = ServerConfig(model=ModelConfig(name="m"))  # the dataclass's own defaults
    assert (dataclass.cache_bytes, dataclass.pressure_dwell_s, dataclass.tenant_max_tracked) == (
        ref.cache_bytes, ref.pressure_dwell_s, ref.tenant_max_tracked)
    monkeypatch.setenv("TWD_CHAOS", "decode_fail=0.5")
    assert config_from_args(parse_args(args)).chaos == "decode_fail=0.5"
    cfg.model.input_size = (64, 64)
    with start_server(cfg, device="cpu") as srv:
        assert len(srv.app.pressure.rungs) == 3 and srv.app.pressure.quant_level is None
        data, hdrs = jpeg(40, 50, 51), []
        for extra in ({}, {}, None):
            req = urllib.request.Request(srv.url + "/predict", data=data, method="POST",
                                         headers={"Content-Type": "image/jpeg"})
            if extra is None:
                req.add_header("If-None-Match", hdrs[0]["ETag"])
            try:
                with urllib.request.urlopen(req, timeout=60) as r:
                    hdrs.append({**dict(r.headers), "status": r.status, "body": r.read()})
            except urllib.error.HTTPError as e:
                hdrs.append({**dict(e.headers), "status": e.code, "body": e.read()})
    assert [h["status"] for h in hdrs] == [200, 200, 304]
    assert [h.get("X-Cache") for h in hdrs[:2]] == ["miss", "hit"]
    assert hdrs[0]["ETag"] == hdrs[1]["ETag"] == hdrs[2]["ETag"] and hdrs[2]["body"] == b""
    assert json.loads(hdrs[0]["body"])["predictions"] == json.loads(hdrs[1]["body"])[
        "predictions"]


def test_the_cache_under_32_threads_loses_no_count():
    """32 threads (more than the cores) with a 1 µs switch interval look up,
    lead, complete or abort and wait on 8 keys: every lookup is counted once
    as a hit, a miss or a coalesced wait, no flight is left in the air, and
    the byte count is the entries' sum."""
    import sys

    cache = trc.ResponseCache(4 * ENTRY + 2)
    errors, lookups = [], [0] * 32

    def work(t):
        rs = np.random.RandomState(t)
        try:
            for _ in range(300):
                key = trc.make_key("m", 1, f"d{rs.randint(8)}", 5)
                kind, obj = cache.begin(key, "m")
                lookups[t] += 1
                if kind == "lead":
                    if rs.rand() < 0.2:
                        cache.abort(obj, RuntimeError("leader died"))
                    else:
                        cache.complete(obj, _payload(int(key[2][1:])))
                elif kind == "wait":
                    obj.future.exception(timeout=10)  # resolved either way
        except BaseException as e:  # reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(t,)) for t in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and not errors
    st = cache.stats()
    assert st["hits_total"] + st["misses_total"] + st["coalesced_total"] == sum(lookups)
    assert st["inflight"] == 0 and st["entries"] <= 4
    assert st["bytes"] == st["per_model"]["m"]["bytes"] == st["entries"] * ENTRY
