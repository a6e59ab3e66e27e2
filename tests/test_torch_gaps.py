"""The device's gaps between batches on the CPU: ``split_gap`` (the five
causes tile a gap exactly, whatever the stamps), the engine's join of a
batch's device events with its predecessor fixed in enqueue order, the
counters a CPU engine keeps at 0 on every surface (``/stats``,
``/metrics``), the ``twd.`` ranges a profiler capture holds and that no
range is entered without one, the Chrome export's device tracks, the
decode's CPU time, and the benchmark's readers of all of it. The join on
the card is ``tests/test_torch_graphs.py``'s ``cuda`` test."""

import dataclasses
import importlib.util
import json
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from tensorflow_web_deploy_tpu_torch.serving import http as thttp
from tensorflow_web_deploy_tpu_torch.serving.batcher import Batcher
from tensorflow_web_deploy_tpu_torch.serving.engine import BatchHandle, InferenceEngine
from tensorflow_web_deploy_tpu_torch.serving.registry import ModelRegistry
from tensorflow_web_deploy_tpu_torch.utils import config as tcfg
from tensorflow_web_deploy_tpu_torch.utils import tracing
from tensorflow_web_deploy_tpu_torch.utils.metrics import parse_prometheus_text
from tensorflow_web_deploy_tpu_torch.utils.tracing import GAP_CAUSES, chrome_trace, split_gap
from tests.test_torch_registry import MockEngine, _cfg, _mc, jpeg

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
MODEL = dict(name="mobilenet_v2", source="native", zoo_width=0.25, zoo_classes=10,
             input_size=(32, 32), preprocess="inception", topk=3, dtype="float32")

# ------------------------------------------------------------- split_gap

# (g0, g1, sealable, seal, h2d start, h2d end) → the five parts
SPLITS = {
    "assembly-alone": ((100, 200, 300, 300, 300, 300), (100, 0, 0, 0, 0)),
    "depth-alone": ((100, 200, 50, 300, 300, 300), (0, 100, 0, 0, 0)),
    "launch-alone": ((100, 200, 10, 50, 300, 300), (0, 0, 100, 0, 0)),
    "h2d-alone": ((100, 200, 10, 20, 50, 300), (0, 0, 0, 100, 0)),
    "enqueue-alone": ((100, 200, 10, 20, 30, 40), (0, 0, 0, 0, 100)),
    "every-cause": ((100, 200, 110, 130, 160, 170), (10, 20, 30, 10, 30)),
    "sealable-missing": ((100, 200, None, 130, 160, 170), (30, 0, 30, 10, 30)),
    "host-stamps-missing": ((100, 200, None, None, 160, 170), (60, 0, 0, 10, 30)),
    "device-stamps-missing": ((100, 200, 110, 130, None, None), (10, 20, 70, 0, 0)),
    "every-stamp-missing": ((100, 200, None, None, None, None), (100, 0, 0, 0, 0)),
    "out-of-order": ((100, 200, 150, 120, 140, 130), (50, 0, 0, 0, 50)),
    "before-the-gap": ((100, 200, 0, 10, 20, 30), (0, 0, 0, 0, 100)),
    "after-the-gap": ((100, 200, 300, 400, 500, 600), (100, 0, 0, 0, 0)),
    "straddles-both-ends": ((100, 200, 50, 150, 160, 250), (0, 50, 10, 40, 0)),
    "empty-gap": ((100, 100, 110, 130, 160, 170), (0, 0, 0, 0, 0)),
    "negative-gap": ((200, 100, 110, 130, 160, 170), (0, 0, 0, 0, 0)),
    "nanoseconds": ((10**18, 10**18 + 7, 10**18 + 1, 10**18 + 2, 10**18 + 3, 10**18 + 5),
                    (1, 1, 1, 2, 2)),
}


@pytest.mark.parametrize("case", list(SPLITS))
def test_split_gap_tiles_the_gap(case):
    args, want = SPLITS[case]
    parts = split_gap(*args)
    assert parts == want
    assert len(parts) == len(GAP_CAUSES) and min(parts) >= 0
    assert sum(parts) == max(0, args[1] - args[0])


@pytest.mark.parametrize("seed", range(6))
def test_split_gap_sums_exactly_on_any_stamps(seed):
    """Random stamps in and around the gap, some missing: the parts are
    never negative and sum to the gap to the nanosecond; with every stamp
    present and in order, each part is its interval clipped to the gap."""
    rs = np.random.RandomState(seed)
    for _ in range(400):
        g0 = int(rs.randint(0, 10**12))
        g1 = g0 + int(rs.randint(0, 10**7))
        stamps = [int(g0 + rs.randint(-10**7, 2 * 10**7)) if rs.rand() > 0.2 else None
                  for _ in range(4)]
        parts = split_gap(g0, g1, *stamps)
        assert min(parts) >= 0 and sum(parts) == g1 - g0
        if None not in stamps and stamps == sorted(stamps):
            edges = [g0, *stamps, g1]
            clip = [min(max(t, g0), g1) for t in edges]
            assert parts == tuple(b - a for a, b in zip(clip, clip[1:]))


# ------------------------------------------------- the engine's join, faked


class FakeEvent:
    """A completed timing event at ``t`` seconds on the host's clock."""

    def __init__(self, t):
        self.t = t

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


def _cpu_engine(**kw):
    cfg = tcfg.ServerConfig(model=tcfg.ModelConfig(**MODEL), canvas_buckets=(64,), max_batch=4,
                            warmup=False, wire_format="rgb", ragged=True, **kw)
    return InferenceEngine(cfg, device="cpu")


def _batch(t_start, stamps):
    """A batch's five events on one compute stream: H2D at t_start + 1..2,
    its replay at + 4..8, its last operation's end at + 9 (ms)."""
    at = [t_start + d / 1e3 for d in (1, 2, 4, 8, 9)]
    return BatchHandle(None, (), 4, (tuple(FakeEvent(t) for t in at),), True, stamps=stamps)


def test_join_keeps_enqueue_order_when_fetches_finish_out_of_order():
    """Three batches enqueued A, B, C on one compute stream (each taking
    the previous one's last event, as ``_ship`` does under the replica's
    lock), fetched C, A, B: each gap runs from its enqueue predecessor's
    last operation, whatever finished fetching first, and the counters
    add up to the three gaps."""
    eng = _cpu_engine()
    try:
        seal = {"A": (0.0005, 0.0006), "B": (0.0080, 0.0100), "C": (0.0150, 0.0200)}
        starts = {"A": 0.0, "B": 0.010, "C": 0.025}
        handles, last = {}, None
        for name in "ABC":  # enqueue order
            h = _batch(starts[name], seal[name])
            h.prev_end, last = (last,), h.events[0][4]
            handles[name] = h
        anchor = (FakeEvent(0.0), 0)
        got = {name: eng.join_gaps(handles[name], anchor=anchor) for name in "CAB"}
        # A: the first on its stream, no gap; B from A's end (9 ms) to its
        # replay (14 ms); C from B's end (19 ms) to 29 ms
        ms = 1e-3
        assert got["A"]["gap"] == pytest.approx((4 * ms, 4 * ms))
        assert got["B"]["gap"] == pytest.approx((9 * ms, 14 * ms))
        assert got["C"]["gap"] == pytest.approx((19 * ms, 29 * ms))
        ns = 1_000_000
        for name, args in (("B", (9, 14, 8, 10, 11, 12)), ("C", (19, 29, 15, 20, 26, 27))):
            want = split_gap(*(a * ns for a in args))
            assert got[name]["idle"] == pytest.approx(dict(zip(GAP_CAUSES, (p / 1e9 for p in want))))
        assert list(got["B"]["idle"].values()) == pytest.approx([0, ms, ms, ms, 2 * ms])
        assert list(got["C"]["idle"].values()) == pytest.approx([0, ms, 6 * ms, ms, 2 * ms])
        assert all(g["h2d"][1] - g["h2d"][0] == pytest.approx(ms) for g in got.values())
        assert got["C"]["compute"] == pytest.approx((29 * ms, 34 * ms))
        gs = eng.gap_stats()
        assert gs["batches_timed"] == 3 and gs["h2d_s"] == pytest.approx(0.003)
        assert sum(gs["idle_s"].values()) == pytest.approx(0.005 + 0.010)
        assert gs["idle_s"] == pytest.approx({"assembly": 0.0, "depth": 0.002, "launch": 0.007,
                                              "h2d": 0.002, "enqueue": 0.004})
        assert gs["join_us_per_batch"] > 0
    finally:
        eng.close()


def test_join_sums_h2d_and_gaps_over_a_replicas_devices():
    """A replica over two devices (faked events; the second device's copy
    takes 2 ms, the first's 1): its H2D and idle seconds are each the mean
    over its devices, of the sums that the join adds up per device, on
    the replica's block, the engine's and ``gap_totals``."""
    from tensorflow_web_deploy_tpu_torch.serving import engine as teng

    eng = _cpu_engine()
    real = eng._replicas[0]
    eng._replicas[0] = teng._Replica(0, (torch.device("cpu"),) * 2)
    try:
        before = teng.gap_totals()
        anchor, last, ns = (FakeEvent(0.0), 0), (None, None), 1_000_000
        want_idle, h2d_ns = [0] * len(GAP_CAUSES), 0
        for i, stamps in enumerate(((0.0005, 0.0006), (0.0080, 0.0100), (0.0150, 0.0200))):
            t = 0.010 * i
            evs = tuple(tuple(FakeEvent(t + d / 1e3) for d in ds)
                        for ds in ((1, 2, 4, 8, 9), (1, 3, 4, 8, 9)))
            h = BatchHandle(None, (), 4, evs, True, stamps=stamps)
            h.prev_end, last = last, tuple(ev[4] for ev in evs)
            eng.join_gaps(h, anchor=anchor)
            for dev, (h0, h1) in enumerate(((1, 2), (1, 3))):
                h2d_ns += (h1 - h0) * ns
                if i:  # the previous batch ended at 9 ms on each device
                    parts = split_gap(round((t - 0.001) * 1e9), round((t + 0.004) * 1e9),
                                      round(stamps[0] * 1e9), round(stamps[1] * 1e9),
                                      round(t * 1e9) + h0 * ns, round(t * 1e9) + h1 * ns)
                    want_idle = [a + b for a, b in zip(want_idle, parts)]
        gs = eng.gap_stats()
        assert gs["h2d_s"] == pytest.approx(h2d_ns / 2 / 1e9) == pytest.approx(0.0045)
        assert gs["idle_s"] == pytest.approx({c: x / 2 / 1e9
                                              for c, x in zip(GAP_CAUSES, want_idle)})
        assert gs["replicas"][0]["h2d_s"] == gs["h2d_s"] and gs["batches_timed"] == 3
        after = teng.gap_totals()
        assert after["h2d_s"] - before["h2d_s"] == pytest.approx(0.0045, abs=2e-6)
        assert after["batches_timed"] - before["batches_timed"] == 3
        assert {c: after["idle_s"][c] - before["idle_s"][c] for c in GAP_CAUSES} == \
            pytest.approx(gs["idle_s"], abs=2e-6)
    finally:
        eng._replicas[0] = real
        eng.close()


def test_cpu_engine_gap_counters_are_present_and_stay_zero():
    """Batches through a started Batcher (stamps and all) on the CPU: the
    engine's block, the staging replicas and the batch records carry the
    counters, at 0, and no record has device intervals."""
    eng = _cpu_engine()
    batcher = Batcher(eng, max_batch=4, max_delay_ms=1.0).start()
    try:
        rs = np.random.RandomState(0)
        futs = [batcher.submit_ragged((rs.rand(h, w, 3) * 255).astype(np.uint8), (h, w), 64)
                for h, w in ((30, 40), (64, 20), (50, 50), (12, 60), (64, 64))]
        for f in futs:
            f.result(timeout=60)
    finally:
        batcher.stop()
    st = eng.stats()["device_idle"]
    assert st["causes"] == list(GAP_CAUSES)
    assert st["idle_s"] == dict.fromkeys(GAP_CAUSES, 0.0)
    assert (st["batches_timed"], st["h2d_s"], st["join_us_per_batch"], st["clock"]) == \
        (0, 0.0, None, {})
    assert st["replicas"] == [{"replica": 0, "idle_s": dict.fromkeys(GAP_CAUSES, 0.0),
                               "batches_timed": 0, "h2d_s": 0.0}]
    rep = eng.staging_stats()["replicas"][0]
    assert (rep["idle_s"], rep["batches_timed"], rep["h2d_s"]) == \
        (dict.fromkeys(GAP_CAUSES, 0.0), 0, 0.0)
    recs = batcher.batch_timeline()
    assert recs and all("device" not in r for r in recs)
    assert all(r["t_open"] <= r["t_sealable"] <= r["t_seal"] <= r["t_launch"] for r in recs)
    eng.close()


# ---------------------------------------------------- the batcher's stamp


class _Engine(MockEngine):
    """The registry's mock engine, taking the dispatch's stamps."""

    supports_span_tracing = True

    def __init__(self, cfg):
        super().__init__(cfg)
        self.stamps = []

    def dispatch_ragged(self, slab, n, spans=(), stamps=None):
        self.stamps.append(stamps)
        return super().dispatch_ragged(slab, n)


def test_sealable_stamp_marks_the_depth_cap():
    """With depth 1 and a slow fetch, a full second batch could seal long
    before the first one's fetch frees the cap: its ``t_sealable`` is its
    last commit, ``t_seal`` waits for the fetch. The first batch seals the
    moment it can."""
    eng = _Engine(_cfg())
    release = threading.Event()
    fetch = eng.fetch_outputs
    eng.fetch_outputs = lambda n: (release.wait(10), fetch(n))[1]
    b = Batcher(eng, max_batch=2, max_delay_ms=1.0, pipeline_depth=1).start()
    try:
        leases = [b.lease_ragged(12, eng.cfg.canvas_buckets[0]) for _ in range(4)]
        t_commit = []
        for lease in leases:
            lease.commit((2, 2))
            t_commit.append(time.monotonic())
        time.sleep(0.2)
        release.set()
        for lease in leases:
            lease.future.result(timeout=10)
    finally:
        release.set()
        b.stop()
    first, second = sorted(b.batch_timeline(), key=lambda r: r["seq"])
    assert first["t_seal"] - first["t_sealable"] < 0.1
    assert second["t_sealable"] <= t_commit[3] + 0.05
    assert second["t_seal"] - second["t_sealable"] > 0.15  # held at the cap
    assert [s[0] for s in eng.stamps] == [first["t_sealable"], second["t_sealable"]]
    assert [s[1] for s in eng.stamps] == [first["t_seal"], second["t_seal"]]


# ------------------------------------------------------- the profiler's view


@pytest.fixture
def served():
    """The port's App over the registry's mock engines, behind its pool
    server, with its real Batcher; yields its port."""
    cfg = dataclasses.replace(_cfg(), cache_bytes=0)
    reg = ModelRegistry(cfg, engine_factory=lambda mc: _Engine(cfg), spec_resolver=_mc)
    reg.load("m1", wait=True)
    srv = thttp.make_http_server(thttp.App(reg, cfg), "127.0.0.1", 0, pool_size=4)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield srv.server_address[1]
    thttp.shutdown_gracefully(srv, reg, grace_s=3.0)


def _post_photos(port, n, seed=0):
    import http.client

    for i in range(n):
        c = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        try:
            c.request("POST", "/predict", body=jpeg(40, 30, seed + i))
            r = c.getresponse()
            assert r.status == 200, r.read()
            r.read()
        finally:
            c.close()


def _get(port, path):
    import http.client

    c = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        c.request("GET", path)
        r = c.getresponse()
        return r.status, r.read()
    finally:
        c.close()


def test_no_range_without_a_capture_and_twd_ranges_in_one(served, tmp_path, monkeypatch):
    """Traffic with no capture running enters no profiler range; a
    capture through ``profile_capture`` holds the host stages' ``twd.``
    ranges of the HTTP worker, the sealer, the launch and the completion
    threads, inside its monotonic window, and clears the gate after."""
    real, calls = tracing._record_range, []

    def counting(name, *a, **kw):
        calls.append(name)
        return real(name, *a, **kw)

    monkeypatch.setattr(tracing, "_record_range", counting)
    _post_photos(served, 6)
    assert calls == [] and tracing.PROFILING is False
    doc = {}
    t = threading.Thread(target=lambda: doc.update(thttp.profile_capture(1500, str(tmp_path))))
    t.start()
    deadline = time.monotonic() + 10
    while not tracing.PROFILING:
        assert time.monotonic() < deadline, "the capture never started"
        time.sleep(0.005)
    _post_photos(served, 6, seed=10)
    t.join(timeout=60)
    assert tracing.PROFILING is False and doc["t_start"] < doc["t_stop"]
    assert doc["ranges_open_at_stop"] == 0 and not tracing._OPEN
    gaps = doc["device_idle"]  # every engine's counters at the start and the stop
    for at in ("start", "stop"):
        assert set(gaps[at]) == {"idle_s", "batches_timed", "h2d_s", "replicas"}
        assert set(gaps[at]["idle_s"]) == set(GAP_CAUSES)
    assert gaps["stop"]["batches_timed"] >= gaps["start"]["batches_timed"]
    with open(doc["trace_file"]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    want = {"twd.lease_wait", "twd.image_decode", "twd.staging_write", "twd.seal",
            "twd.launch", "twd.fetch"}
    assert want <= names, sorted(n for n in names if n and n.startswith("twd."))
    assert want <= set(calls)
    n = len(calls)
    _post_photos(served, 3, seed=20)
    assert len(calls) == n  # the gate closed with the capture


def test_open_ranges_drain_under_contention():
    """More threads than cores entering and leaving stage ranges under a
    profiler, with a short switch interval: none is lost from the open
    set, so a capture's drain ends with every range left."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU], experimental_config=(
        torch._C._profiler._ExperimentalConfig(profile_all_threads=True)))
    prof.start()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        tracing.PROFILING = True

        def work():
            for _ in range(300):
                with tracing.profiler_range("stress"):
                    pass

        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        tracing.PROFILING = False
        sys.setswitchinterval(interval)
        open_left = tracing.drain_ranges(5.0)
        prof.stop()
    assert open_left == 0 and not tracing._OPEN


def test_decode_cpu_ms_beside_its_wall(served):
    _post_photos(served, 4)
    status, body = _get(served, "/stats")
    decode = json.loads(body)["tracing"]["stages"]["image_decode"]
    assert status == 200 and decode["count"] == 4
    assert 0 < decode["cpu_ms"] <= decode["total_ms"] + 5.0


def test_real_cpu_engine_counters_on_stats_and_metrics(tmp_path):
    """A CPU engine behind the App: ``/stats → engine → device_idle`` and
    the staging replicas hold the counters at 0, and ``/metrics`` carries
    ``device_idle_seconds_total{replica,cause}`` and
    ``h2d_seconds_total{replica}``, 0."""
    mc = tcfg.ModelConfig(**MODEL)
    cfg = tcfg.ServerConfig(model=mc, canvas_buckets=(64,), max_batch=4, max_delay_ms=1.0,
                            wire_format="rgb", ragged=True, cache_bytes=0,
                            telemetry_interval_s=0.0)
    reg = ModelRegistry(cfg, engine_factory=lambda m: InferenceEngine(
        dataclasses.replace(cfg, model=m), device="cpu"), spec_resolver=lambda name: mc)
    reg.load(mc.name, wait=True)
    srv = thttp.make_http_server(thttp.App(reg, cfg), "127.0.0.1", 0, pool_size=2)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        port = srv.server_address[1]
        _post_photos(port, 3)
        stats = json.loads(_get(port, "/stats")[1])
        samples = parse_prometheus_text(_get(port, "/metrics")[1].decode())["samples"]
        trace = json.loads(_get(port, "/debug/trace?last_s=60")[1])
    finally:
        thttp.shutdown_gracefully(srv, reg, grace_s=3.0)
    di = stats["engine"]["device_idle"]
    assert di["idle_s"] == dict.fromkeys(GAP_CAUSES, 0.0) and di["batches_timed"] == 0
    assert stats["staging"]["replicas"][0]["idle_s"] == dict.fromkeys(GAP_CAUSES, 0.0)
    idle = {dict(lb)["cause"]: v for (n, lb), v in samples.items()
            if n == "tpu_serve_device_idle_seconds_total" and dict(lb)["replica"] == "0"}
    assert idle == dict.fromkeys(GAP_CAUSES, 0.0)
    assert samples[("tpu_serve_h2d_seconds_total", (("replica", "0"),))] == 0.0
    assert not [e for e in trace["traceEvents"] if "device idle" in str(e.get("tid"))]


# ------------------------------------------------------- the Chrome export


def test_chrome_trace_draws_the_device_and_each_gap_by_cause():
    idle = {"assembly": 0.002, "depth": 0.0, "launch": 0.001, "h2d": 0.0005, "enqueue": 0.0005}
    rec = {"seq": 7, "key": ("ragged", 512), "rows": 32, "bucket": 32, "replica": 0,
           "t_open": 10.0, "t_sealable": 10.001, "t_seal": 10.002, "t_launch": 10.003,
           "t_launched": 10.004, "t_done": 10.05,
           "device": {"h2d": (10.0035, 10.004), "compute": (10.006, 10.03),
                      "gap": (10.002, 10.006), "idle": idle}}
    doc = chrome_trace([{"name": "m@1", "timeline": [rec]}], [], now=10.1)
    by_tid = {}
    for e in doc["traceEvents"]:
        if e.get("ph") == "X":
            by_tid.setdefault(e["tid"], []).append(e)
    h2d, = by_tid["replica 0 h2d"]
    compute, = by_tid["replica 0 compute"]
    assert (h2d["name"], h2d["ts"], h2d["dur"]) == ("h2d b7", 10003500.0, 500.0)
    assert (compute["ts"], compute["dur"]) == (10006000.0, 24000.0)
    gap = sorted(by_tid["replica 0 device idle"], key=lambda e: e["ts"])
    assert [e["name"] for e in gap] == ["idle assembly", "idle launch", "idle h2d",
                                        "idle enqueue"]  # depth was 0: no slice
    assert gap[0]["ts"] == 10002000.0
    assert sum(e["dur"] for e in gap) == pytest.approx(4000.0)
    assert {"replica 0 transfer", "replica 0 execute"} <= set(by_tid)


# ------------------------------------------------------ the benchmark's readers


def _load(rel, name):
    if name in sys.modules:
        return sys.modules[name]
    if str(ROOT / "port_bench") not in sys.path:  # as run.py has it: ``yardstick`` imports
        sys.path.insert(0, str(ROOT / "port_bench"))
    spec = importlib.util.spec_from_file_location(name, ROOT / rel)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module  # a dataclass resolves its module's names
    spec.loader.exec_module(module)
    return module


def _ctx(stats0, stats1, window_s=50.0):
    cells = _load("port_bench/yardstick/cells.py", "port_bench_cells_for_gap_tests")
    return cells.Context(cell=None, window_s=window_s, photos_answered=0, latencies_ms=[],
                         stats0=stats0, stats1=stats1, prom0={}, prom1={}, trace=None,
                         flops_per_image=0.0, peak=None, valid_bytes_per_photo=0.0,
                         out_hw=(299, 299))


def _stats(idle, timed, h2d_s, replicas=1, cpu_ms=None, decodes=0):
    stages = {"image_decode": {"count": 1, "total_ms": 1.0,
                               **({"cpu_ms": cpu_ms} if cpu_ms is not None else {})}}
    return {"engine": {"decodes": {"native": decodes, "pil": 0},
                       "device_idle": {"idle_s": idle, "batches_timed": timed, "h2d_s": h2d_s,
                                       "replicas": [{}] * replicas}},
            "tracing": {"stages": stages}}


READERS = {  # name → value from the hand-made deltas below
    "idle_assembly": 100 * 5.0 / 2 / 50.0,
    "idle_depth": 100 * 1.0 / 2 / 50.0,
    "idle_launch": 100 * 0.5 / 2 / 50.0,
    "idle_h2d": 100 * 0.25 / 2 / 50.0,
    "idle_enqueue": 100 * 2.0 / 2 / 50.0,
    "h2d_ms": 1.5 * 1e3 / 2000,
    "decode_cpu_ms": 3000.0 / 1500,
}


@pytest.mark.parametrize("name", list(READERS))
def test_reader_reads_the_window_and_nothing_without_counters(name):
    read = _load(f"port_bench/metrics/{name}.py", f"port_bench_metric_{name}_test").read
    zero = dict.fromkeys(GAP_CAUSES, 1.0)
    gained = {"assembly": 6.0, "depth": 2.0, "launch": 1.5, "h2d": 1.25, "enqueue": 3.0}
    s0 = _stats(zero, 100, 0.5, replicas=2, cpu_ms=500.0, decodes=500)
    s1 = _stats(gained, 2100, 2.0, replicas=2, cpu_ms=3500.0, decodes=2000)
    assert read(_ctx(s0, s1)) == pytest.approx(READERS[name])
    # a program without the counters (the parent's): nothing, no raise
    bare0, bare1 = (json.loads(json.dumps(s)) for s in (s0, s1))
    for s in (bare0, bare1):
        del s["engine"]["device_idle"]
        s["tracing"]["stages"]["image_decode"].pop("cpu_ms")
    assert read(_ctx(bare0, bare1)) is None
    assert read(_ctx(s0, s0)) is None  # nothing timed, nothing decoded
