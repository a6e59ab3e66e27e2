"""The port's request spans (``utils/tracing.py``) held to the JAX
package's on the same inputs: trace-ID acceptance, the canvas-side and
window helpers, ``Span`` stamps, and the Chrome-trace export, JSON-equal
bar for bar; then the spans as the port's batcher and engine stamp them."""

import json
import re
import threading

import numpy as np
import pytest

from tensorflow_web_deploy_tpu.utils import tracing as jtr
from tensorflow_web_deploy_tpu_torch.serving.batcher import Batcher
from tensorflow_web_deploy_tpu_torch.utils import tracing as ttr
from tests.test_torch_registry import MockEngine, _cfg

ID_INPUTS = [None, "", "abc", "a" * 64, "a" * 65, "a b", "x;y", "ok-._9", "ü", "abc\n",
             "trace/1", "A.b-C_d"]


@pytest.mark.parametrize("inbound", ID_INPUTS)
def test_accept_trace_id_accepts_and_refuses_as_the_reference(inbound):
    got, want = ttr.accept_trace_id(inbound), jtr.accept_trace_id(inbound)
    assert (got == inbound) == (want == inbound)
    assert re.match(r"^[0-9a-f]{10}-[0-9a-f]{8}$", ttr.new_trace_id())


KEYS = [(512, 512, 3), (768, 512), ("ragged", 256), ("classic", 1024), (), None, (96,),
        ("x", "y")]


def test_canvas_side_and_effective_window_equal_the_reference():
    assert [ttr.canvas_side(k) for k in KEYS] == [jtr.canvas_side(k) for k in KEYS]
    grid = [(r, t) for r in (None, 0.0, 0.5, 30.0, 600.0, 1e5)
            for t in (None, 0.0, 0.2, 10.0, 5000.0)]
    assert [ttr.effective_window(r, t) for r, t in grid] == \
        [jtr.effective_window(r, t) for r, t in grid]


def test_span_stamps_equal_the_reference():
    spans = [ttr.Span("t-1", t0=100.0), jtr.Span("t-1", t0=100.0)]
    for s in spans:
        s.add("body_read", 0.002)
        s.add("body_read", 0.001)
        s.add("image_decode", -1.0)  # clamped at 0
        s.add_max("queue_wait", 0.004)
        s.add_max("queue_wait", 0.003)
        s.note("model", "m@1")
        s.note_default("model", "other")
        s.note_default("path", "/predict")
    a, b = (s.to_dict() for s in spans)
    assert a["stages_ms"] == b["stages_ms"] and a["meta"] == b["meta"]
    assert spans[0].stage_sum_s() == spans[1].stage_sum_s()
    total = spans[0].finish(200)
    assert spans[0].finish(500) == total and spans[0].status == 200  # idempotent


def _timeline(rng, n, seq0=1):
    recs = []
    for i in range(n):
        t_open = 1000.0 + float(rng.uniform(0, 20))
        stamps = np.cumsum(rng.uniform(0.0005, 0.01, 4)) + t_open
        cut = int(rng.randint(2, 6))  # in flight: the later stamps are None
        t = [t_open, *stamps.tolist()][:cut] + [None] * (5 - cut)
        recs.append({"seq": seq0 + i, "key": [("ragged", 512), (768, 512), (256, 256, 3)][i % 3],
                     "rows": int(rng.randint(1, 9)), "bucket": 8, "t_open": t[0],
                     "t_seal": t[1], "t_launch": t[2], "t_launched": t[3], "t_done": t[4],
                     **({"bulk": True} if i % 5 == 4 else {})})
    return recs


def test_chrome_trace_is_json_equal_to_the_reference():
    rng = np.random.RandomState(0)
    models = [{"name": "inception_v3@1", "timeline": _timeline(rng, 12)},
              {"name": "mobilenet_v2_int8@2", "timeline": _timeline(rng, 7, 100)}]
    requests = []
    for i in range(9):
        t0 = 1000.0 + float(rng.uniform(0, 20))
        requests.append((t0, t0 + float(rng.uniform(0.001, 0.05)), {
            "trace_id": f"r{i}", "status": 200 if i % 4 else 504,
            "stages_ms": {"image_decode": 1.25, "device_execute": 2.5},
            **({"meta": {"model": "inception_v3@1"}} if i % 2 else {}),
            **({"class": "bulk"} if i == 3 else {})}))
    instants = [{"t": 1005.0, "kind": "hot_swap_serving", "model": "m", "version": 2},
                {"t": 990.0, "kind": "chaos_injection"}, {"kind": "no time"}]
    for last_s in (None, 10.0, 1000.0):
        got = ttr.chrome_trace(models, requests, last_s=last_s, now=1021.0, instants=instants)
        want = jtr.chrome_trace(models, requests, last_s=last_s, now=1021.0, instants=instants)
        assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
        bars = [e for e in got["traceEvents"] if e["ph"] == "X"]
        assert bars and all(e["dur"] >= 0.1 for e in bars)


def test_batcher_stamps_every_stage_before_the_future_resolves():
    """Through the port's real batcher on a mock engine without span
    support: the lease, commit, launch and completion stamps, the bucket
    note, and a stage sum within the request's wall."""
    cfg = _cfg()
    batcher = Batcher(MockEngine(cfg), max_batch=4, max_delay_ms=1.0).start()
    try:
        spans = [ttr.Span() for _ in range(3)]
        leases = [batcher.lease_ragged(12, 64, span=s) for s in spans]
        for lease in leases:
            lease.commit((2, 2))
        rows = [lease.future.result(timeout=10) for lease in leases]
        assert len(rows) == 3
        for s in spans:
            s.finish(200)
            stages = s.stages_copy()
            assert set(stages) == {"lease_wait", "staging_write", "queue_wait",
                                   "device_dispatch", "device_execute"}
            assert s.meta["batch_bucket"] == 4
            assert s.stage_sum_s() <= s.total_s + 1e-9
        st = batcher.stats()
        assert st["rolling"]["batches_dispatched_total"] == 1
        assert st["padding"]["64x4"]["rows_real"] == 3
        assert st["padding"]["64x4"]["px_real"] == 12
    finally:
        batcher.stop()


def test_span_survives_concurrent_stamps():
    """Stamps from many threads against a finish in between: no lost
    update in the stage dict, no crash while a read-out copies it."""
    span = ttr.Span()
    n, per = 8, 500

    def stamp(i):
        for _ in range(per):
            span.add(f"s{i}", 0.001)
            span.add_max("shared", 0.001 * i)
            span.to_dict()

    threads = [threading.Thread(target=stamp, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    stages = span.stages_copy()
    assert all(abs(stages[f"s{i}"] - per * 0.001) < 1e-9 for i in range(n))
    assert stages["shared"] == pytest.approx(0.001 * (n - 1))
