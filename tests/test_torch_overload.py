"""The port's overload control (``serving/overload.py``, the batcher's
admission, the App's ladder) on the CPU, held against the JAX package.

The SLO-class and rung parsers, the ladder's level sequence on the 3- and
4-rung tables fed one seeded (fraction, time) sequence, and the token
buckets' decisions, ``Retry-After`` and counters under one clock (the
``~other`` cap included) equal the reference's exactly. Then the
reference's behavioral cases on the port's batcher and App over mock
engines: lease-time and seal-time deadline sheds with no slot or slab
leaked, a quota shed in the batcher, 429 and 504 with a ``reason`` and
``Retry-After``, a garbage deadline answered 400 before the body is read,
an SLO class admitted, the reject rung serving hits and shedding misses,
the int8 reroute answering from ``*_int8``, and the images-per-request cap.
"""

import io
import json
import threading
import time

import numpy as np
import pytest
import torch

from tensorflow_web_deploy_tpu.serving import overload as jov
from tensorflow_web_deploy_tpu_torch.serving import overload as tov
from tensorflow_web_deploy_tpu_torch.serving.batcher import Batcher
from tensorflow_web_deploy_tpu_torch.serving.overload import (
    AdmissionController,
    DeadlineExceeded,
    QuotaExceeded,
)
from tensorflow_web_deploy_tpu_torch.utils import config as tcfg
from tests.test_torch_registry import BUCKET, jpeg
from tests.test_torch_respcache import (
    ServeEngine,
    close_app,
    drained,
    make_app,
    post,
    serve_cfg,
)

torch.set_num_threads(2)


class Clock:
    """A monotonic clock the test moves."""

    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


# ------------------------------------------------- parsers and controllers


@pytest.mark.parametrize("spec", [None, "", "interactive=1000,batch=10000", "fast=50,oops=banana",
                                  "oops=banana,=,", "a=0,b=-5,c=2.5", " x = 7 , y=1e3 "])
def test_slo_classes_parse_as_the_reference(spec):
    assert tov.parse_slo_classes(spec) == jov.parse_slo_classes(spec)


@pytest.mark.parametrize("spec", [None, "", "0.5:0.3,0.9:0.7", "0.5:0.8", "nope", "0.7",
                                  "0.30:0.15,0.50:0.30,0.70:0.50,0.95:0.80", "0:-1,x:y,1:0.5"])
def test_rungs_parse_as_the_reference(spec):
    assert tov.PressureController.parse_rungs(spec) == jov.PressureController.parse_rungs(spec)


@pytest.mark.parametrize("rungs,dwell", [(tov.DEFAULT_RUNGS, 0.5),
                                         ("0.30:0.15,0.50:0.30,0.70:0.50,0.95:0.80", 0.1),
                                         ("0:-1,0:-1,0:-1", 0.0)])
def test_pressure_levels_as_the_reference(monkeypatch, rungs, dwell):
    """The same seeded (queue fraction, time) sequence walks both ladders
    through the same levels; the action tables, the reject and reroute
    rungs and the final stats agree."""
    clock = Clock()
    monkeypatch.setattr(time, "monotonic", clock)
    port = tov.PressureController.from_spec(rungs, dwell_s=dwell)
    ref = jov.PressureController.from_spec(rungs, dwell_s=dwell)
    rs = np.random.RandomState(len(rungs))
    seq = []
    for i in range(400):
        clock.t += float(rs.exponential(0.05))
        # bursts: a few hundred ms of a full queue, then recovery
        frac = float(np.clip(rs.normal(0.9 if (i // 60) % 2 else 0.2, 0.15), 0.0, 1.0))
        got, want = port.observe_pressure(frac), ref.observe_pressure(frac)
        assert got == want
        seq.append(got)
        if i % 97 == 0:
            port.count_reroute(2)
            ref.count_reroute(2)
    assert len(set(seq)) > 2  # the sequence climbs and recovers
    assert (port.actions, port.reject_level, port.quant_level) == (
        ref.actions, ref.reject_level, ref.quant_level)
    assert port.stats() == ref.stats()
    assert (port.quant_level is not None) == (len(port.rungs) >= 4)


@pytest.mark.parametrize("spec,max_tenants", [("alice=5,bob=2,*=1", 3), ("alice=2", 64),
                                              ("*=4,vip=0", 2), ("", 8)])
def test_quota_decisions_as_the_reference(monkeypatch, spec, max_tenants):
    """One seeded stream of charges from seven tenants (more than the cap,
    so some share ``~other``) under one clock: every decision,
    ``Retry-After``, peek and the final counters are the reference's."""
    clock = Clock()
    monkeypatch.setattr(time, "monotonic", clock)
    port = tov.AdmissionController.from_spec(spec, burst_s=1.0, max_tenants=max_tenants)
    ref = jov.AdmissionController.from_spec(spec, burst_s=1.0, max_tenants=max_tenants)
    rs = np.random.RandomState(7)
    tenants = ["alice", "bob", "vip", None, "t4", "t5", "t6"]
    sheds = 0
    for _ in range(600):
        clock.t += float(rs.exponential(0.08))
        tenant = tenants[rs.randint(len(tenants))]
        n = int(rs.randint(1, 3))
        ok = port.try_charge(tenant, n)
        assert ok == ref.try_charge(tenant, n)
        assert port.retry_after(tenant, n) == ref.retry_after(tenant, n)
        assert port.peek(tenant, 4) == ref.peek(tenant, 4)
        if ok:
            port.count_admit(tenant, "interactive")
            ref.count_admit(tenant, "interactive")
        else:
            sheds += 1
            port.count_shed(tenant, "batch", "quota")
            ref.count_shed(tenant, "batch", "quota")
    port.charge("alice", 9)
    ref.charge("alice", 9)
    assert port.stats() == ref.stats()
    if spec == "alice=5,bob=2,*=1":
        assert sheds and tov.OTHER_TENANT in port.stats()["tenants"]


# --------------------------------------------------------------- the batcher


def _tight():
    return np.zeros((8, 8, 3), np.uint8)


def _wedged_batcher(**kw):
    gate = threading.Event()
    eng = ServeEngine(serve_cfg(), fetch_gate=gate)
    b = Batcher(eng, max_batch=1, max_delay_ms=1, pipeline_depth=1, max_queue=8, **kw).start()
    return eng, gate, b


def test_a_lease_sheds_a_doomed_deadline_only_under_backlog():
    eng, gate, b = _wedged_batcher()
    futures = []
    try:
        # idle: a deadline is never shed on an estimate (no backlog)
        futures.append(b.submit_ragged(_tight(), (8, 8), BUCKET,
                                       deadline=time.monotonic() + 30.0))
        time.sleep(0.2)  # batch 1 in flight, held at its fetch
        assert b.stats()["deadline_sheds_total"] == 0
        futures.append(b.submit_ragged(_tight(), (8, 8), BUCKET))
        time.sleep(0.2)  # batch 2 sealed, held at depth 1: a backlog of 1
        assert b.queue_depth >= 1
        t0 = time.monotonic()
        with pytest.raises(DeadlineExceeded) as ei:
            b.submit_ragged(_tight(), (8, 8), BUCKET, deadline=time.monotonic() - 1.0)
        assert time.monotonic() - t0 < 0.1  # shed, not queued
        assert ei.value.retry_after_s > 0
        assert b.stats()["deadline_sheds_total"] == 1
    finally:
        gate.set()
        for f in futures:
            f.result(timeout=10)
    try:
        st = drained(b, eng)
        assert st["images"] == 2  # the shed request never reached the device
    finally:
        b.stop()


def test_a_row_dead_at_seal_becomes_a_hole_and_nothing_leaks():
    eng, gate, b = _wedged_batcher()
    try:
        live = b.submit_ragged(_tight(), (8, 8), BUCKET)
        time.sleep(0.2)  # in flight, held at its fetch
        dead = b.submit_ragged(_tight(), (8, 8), BUCKET, deadline=time.monotonic() + 0.25)
        time.sleep(0.45)  # its deadline passes while it waits at depth 1
        gate.set()
        with pytest.raises(DeadlineExceeded, match="waited for dispatch"):
            dead.result(timeout=10)
        assert live.result(timeout=10) is not None
        st = drained(b, eng)
        assert st["deadline_seal_sheds_total"] == 1 and st["holes"] >= 1
        assert st["images"] == 1 and st["queued"] == 0 and st["inflight"] == 0
        assert st["discarded"] == 1  # a builder of holes only never dispatches
    finally:
        gate.set()
        b.stop()


def test_a_dry_bucket_sheds_at_the_lease():
    adm = AdmissionController.from_spec("t=1", burst_s=1.0)
    eng = ServeEngine(serve_cfg())
    b = Batcher(eng, max_batch=4, max_delay_ms=1, admission=adm).start()
    try:
        assert b.submit_ragged(_tight(), (8, 8), BUCKET, tenant="t").result(timeout=10)
        with pytest.raises(QuotaExceeded) as ei:
            b.lease_ragged(8 * 8 * 3, BUCKET, tenant="t")
        assert ei.value.tenant == "t" and 0.1 <= ei.value.retry_after_s <= 1.0
        b.submit_ragged(_tight(), (8, 8), BUCKET, tenant="u").result(timeout=10)
        st = drained(b, eng)
        assert st["quota_sheds_total"] == 1 and st["images"] == 2
    finally:
        b.stop()


# ------------------------------------------------------------------ the App


def test_quota_answers_429_with_a_reason_and_retry_after():
    app, reg = make_app(serve_cfg(tenant_quota="alice=1", tenant_burst_s=1.0))
    try:
        assert post(app, jpeg(12, 10, 1), headers={"X-Tenant": "alice"})[0] == 200
        status, headers, body = post(app, jpeg(12, 10, 2), headers={"X-Tenant": "alice"})
        doc = json.loads(body)
        assert status == 429 and doc["reason"] == "quota" and doc["retry_after_s"] > 0
        assert int(headers["Retry-After"]) >= 1
        assert post(app, jpeg(12, 10, 3), headers={"X-Tenant": "bob"})[0] == 200
        adm = app._stats()["overload"]["admission"]
        assert (adm["tenants"]["alice"]["admitted"], adm["tenants"]["alice"]["shed"]) == (
            1, {"quota": 1})
        assert adm["tenants"]["bob"]["admitted"] == 1
        assert adm["shed_by_reason"] == {"quota": 1}
        assert reg.default_entry().batcher.stats()["quota_sheds_total"] == 1
    finally:
        close_app(reg)


@pytest.mark.parametrize("how", ["query", "header"])
def test_a_client_deadline_answers_504_at_the_deadline(how):
    gate = threading.Event()
    cfg = serve_cfg()
    app, reg = make_app(cfg, lambda mc: ServeEngine(cfg, fetch_gate=gate))
    try:
        qs, headers = ("deadline_ms=250", {}) if how == "query" else (
            "", {"X-Deadline-Ms": "250"})
        t0 = time.monotonic()
        status, hdrs, body = post(app, jpeg(12, 10, 4), qs=qs,
                                  headers={"X-Tenant": "carol", **headers})
        assert status == 504 and time.monotonic() - t0 < 5.0
        assert json.loads(body)["reason"] == "deadline" and int(hdrs["Retry-After"]) >= 1
        adm = app._stats()["overload"]["admission"]
        assert adm["tenants"]["carol"]["shed"] == {"deadline": 1}
    finally:
        gate.set()
        close_app(reg)


class _Unread(io.BytesIO):
    def read(self, *a):
        raise AssertionError("the body was read")


def test_a_garbage_deadline_is_400_before_the_body_and_a_class_admits():
    app, reg = make_app(serve_cfg())
    try:
        for qs in ("deadline_ms=banana", "model=nope&deadline_ms=banana"):
            got = {}
            environ = {"REQUEST_METHOD": "POST", "PATH_INFO": "/predict", "QUERY_STRING": qs,
                       "CONTENT_TYPE": "image/jpeg", "CONTENT_LENGTH": "100",
                       "wsgi.input": _Unread()}
            body = b"".join(app(environ, lambda s, h: got.update(status=s)))
            assert got["status"].startswith("400") and b"deadline_ms" in body
        # naming a class opts into its deadline; a generous one admits
        assert post(app, jpeg(12, 10, 5), qs="slo=batch")[0] == 200
        assert post(app, jpeg(12, 10, 6), headers={"X-SLO": "batch"})[0] == 200
        adm = app._stats()["overload"]["admission"]
        assert adm["classes"]["batch"]["admitted"] == 2
    finally:
        close_app(reg)


def test_the_reject_rung_serves_hits_and_sheds_misses():
    """enter=0 always climbs, exit=-1 never recovers, no dwell: each request
    steps one rung; at the last, a miss sheds 503 ``degraded`` while hits
    still answer."""
    app, reg = make_app(serve_cfg(cache_bytes=1 << 20, pressure_rungs="0:-1,0:-1,0:-1",
                                  pressure_dwell_s=0.0))
    try:
        a = jpeg(12, 10, 7)
        status, headers, body = post(app, a)  # level 1: a miss, clamped to top-1
        assert status == 200 and len(json.loads(body)["predictions"]) == 1
        assert post(app, a)[1]["X-Cache"] == "hit"  # level 2
        assert post(app, a)[1]["X-Cache"] == "hit"  # level 3 serves hits
        status, headers, body = post(app, jpeg(12, 10, 8))
        doc = json.loads(body)
        assert status == 503 and doc["reason"] == "degraded"
        assert int(headers["Retry-After"]) >= 1
        pr = app._stats()["overload"]["pressure"]
        assert pr["level"] == 3 and pr["action"] == "reject_miss"
        assert pr["transitions_total"] == 3
        st = drained(reg.default_entry().batcher, reg.default_entry().engine)
        assert st["images"] == 1  # the shed miss never ran
        assert app.cache.stats()["inflight"] == 0
    finally:
        close_app(reg)


def test_the_quant_rung_reroutes_to_the_int8_variant():
    """Four rungs, the fourth out of reach: the ladder climbs to
    ``quant_reroute`` and stays; a bf16 request then answers from the
    loaded int8 variant of the same network (scores name the engine),
    counted once per image; a request on the variant itself is served
    there, and no in-flight reference is left."""
    cfg = serve_cfg(pressure_rungs="0:0,0:0,0:0,2:2", pressure_dwell_s=0.0)
    int8 = tcfg.ModelConfig(name="m1", dtype="int8", alias="m1_int8")
    app, reg = make_app(cfg, models=("m1", int8))
    try:
        assert reg.quant_variant("m1").name == "m1_int8"
        assert reg.quant_variant("m1_int8") is None
        answers = [json.loads(post(app, jpeg(12, 10, 9 + i))[2]) for i in range(4)]
        assert [a["model"] for a in answers] == ["m1", "m1", "m1_int8", "m1_int8"]
        assert [a["predictions"][0]["score"] for a in answers] == pytest.approx(
            [0.1, 0.1, 0.2, 0.2])
        assert all(len(a["predictions"]) == 1 for a in answers)  # rung 1's clamp holds
        direct = json.loads(post(app, jpeg(12, 10, 20), qs="model=m1_int8")[2])
        assert direct["model"] == "m1_int8"
        pr = app._stats()["overload"]["pressure"]
        assert pr["level"] == 3 and pr["action"] == "quant_reroute"
        assert pr["quant_reroutes"] == 2
        assert all(mv.inflight == 0 for mv in reg.serving_entries())
    finally:
        close_app(reg)


def test_more_images_than_a_batch_answer_413():
    app, reg = make_app(serve_cfg())
    try:
        boundary = "qQ"
        parts = b"".join(f"--{boundary}\r\nContent-Disposition: form-data; name=\"f\"; "
                         f"filename=\"{i}.jpg\"\r\n\r\n".encode() + jpeg(12, 10, i) + b"\r\n"
                         for i in range(5))
        status, _, body = post(app, parts + f"--{boundary}--\r\n".encode(),
                               ctype=f"multipart/form-data; boundary={boundary}")
        assert status == 413 and b"at most 4 images" in body
    finally:
        close_app(reg)


def test_a_bucket_under_32_threads_admits_no_more_than_its_tokens():
    """32 threads (more than the cores) with a 1 µs switch interval charge one
    tenant's bucket: what it admits never exceeds its depth plus what its
    rate refilled meanwhile (a lost update would over-admit), and every
    charge is either admitted or shed."""
    import sys

    adm = AdmissionController.from_spec("t=200", burst_s=0.25)  # 50 tokens deep
    admitted, tries = [0] * 32, 500
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    t0 = time.monotonic()
    try:
        def work(i):
            for _ in range(tries):
                admitted[i] += adm.try_charge("t")

        threads = [threading.Thread(target=work, args=(i,)) for i in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
        elapsed = time.monotonic() - t0
    assert not any(t.is_alive() for t in threads)
    assert 50 <= sum(admitted) <= 50 + 200 * elapsed + 1
    assert sum(admitted) < 32 * tries
