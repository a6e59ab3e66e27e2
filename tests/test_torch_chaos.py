"""The port's fault injection (``serving/chaos.py``) on the CPU, held
against the JAX package.

The spec parser (attributes, ``describe()``, counters) and the seeded
draws of every fault kind equal the reference's exactly for the same spec
and seed, and so does the spike window under one clock. Then the
reference's drills on the port's batcher and App over mock engines:
injected decode failures answer 400 and leave no slot, slab or flight
behind; injected dispatch failures fail their futures, return their slabs
and free their depth slots; a straggling fetch delays but serves, or sheds
504 at a shorter client deadline; a spike holds requests but serves; and
under all faults at once every request answers 200, 400 or 500, the
outcomes sum to the requests offered and match the injector's counts.
"""

import json
import threading
import time

import numpy as np
import pytest
import torch

from tensorflow_web_deploy_tpu.serving import chaos as jchaos
from tensorflow_web_deploy_tpu_torch.serving import chaos as tchaos
from tensorflow_web_deploy_tpu_torch.serving.batcher import Batcher
from tensorflow_web_deploy_tpu_torch.serving.chaos import ChaosError, ChaosInjector
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

SPECS = ["decode_fail=0.25,dispatch_fail=0.5,slow_replica=1.0:40,spike=0.5:2,seed=7",
         "decode_fail=banana,dispatch_fail=1.0", "decode_fail=7", "slow_replica=0.3",
         "spike=3,spike_hold=25,seed=-4", "bogus=1,seed=12", "dispatch_fail=-1,seed=x"]


def _attrs(inj):
    return {k: getattr(inj, k) for k in (
        "decode_fail", "dispatch_fail", "slow_replica_p", "slow_replica_s", "spike_on_s",
        "spike_period_s", "spike_hold_s")}


@pytest.mark.parametrize("spec", [None, "", "   ", *SPECS])
def test_specs_parse_as_the_reference(spec):
    port, ref = ChaosInjector.from_spec(spec), jchaos.ChaosInjector.from_spec(spec)
    assert (port is None) == (ref is None)
    if port is not None:
        assert _attrs(port) == _attrs(ref)
        assert port.describe() == ref.describe()
        assert port.stats() == ref.stats()


@pytest.mark.parametrize("spec", ["decode_fail=0.5,dispatch_fail=0.3,slow_replica=0.4:20,seed=42",
                                  "decode_fail=0.1,dispatch_fail=0.05,slow_replica=0.2:20,seed=7",
                                  "decode_fail=1.0,slow_replica=0.0:5"])
def test_seeded_draws_are_the_references(spec):
    """One seeded interleaving of the three drawn faults: the same answers in
    the same order, and the same counters."""
    port, ref = ChaosInjector.from_spec(spec), jchaos.ChaosInjector.from_spec(spec)
    pick = np.random.RandomState(3).randint(0, 3, 300)
    calls = ("decode_fault", "dispatch_fault", "fetch_delay")
    got = [getattr(port, calls[k])() for k in pick]
    want = [getattr(ref, calls[k])() for k in pick]
    assert got == want and port.stats() == ref.stats()
    assert any(got) or "0.0" in spec


def test_the_spike_window_is_the_references(monkeypatch):
    t = [500.0]
    monkeypatch.setattr(time, "monotonic", lambda: t[0])
    port = ChaosInjector.from_spec("spike=0.2:1,spike_hold=25")
    ref = jchaos.ChaosInjector.from_spec("spike=0.2:1,spike_hold=25")
    got, want = [], []
    for dt in np.random.RandomState(5).exponential(0.07, 80):
        t[0] += float(dt)
        got.append(port.spike_delay())
        want.append(ref.spike_delay())
    assert got == want and 0.025 in got and 0.0 in got
    assert port.stats() == ref.stats()


# ------------------------------------------------------- decode failures


def test_decode_failures_answer_400_and_leave_nothing_behind():
    app, reg = make_app(serve_cfg(chaos="decode_fail=1.0", cache_bytes=1 << 20))
    mv = reg.default_entry()
    try:
        for i in range(6):
            status, _, body = post(app, jpeg(12, 10, i))
            assert status == 400 and b"injected decode failure" in body
        st = drained(mv.batcher, mv.engine)
        assert st["holes"] == 0 and st["images"] == 0  # failed before any lease
        assert app.cache.stats()["inflight"] == 0
        assert app._stats()["overload"]["chaos"]["decode_failures_injected"] == 6
    finally:
        close_app(reg)


def test_partial_decode_failures_sum_to_the_requests():
    app, reg = make_app(serve_cfg(chaos="decode_fail=0.5,seed=9"))
    mv = reg.default_entry()
    try:
        codes = [post(app, jpeg(12, 10, i))[0] for i in range(24)]
        n200, n400 = codes.count(200), codes.count(400)
        assert n200 + n400 == 24 and n200 and n400
        assert app._stats()["overload"]["chaos"]["decode_failures_injected"] == n400
        assert drained(mv.batcher, mv.engine)["images"] == n200
    finally:
        close_app(reg)


# ----------------------------------------------------- dispatch failures


@pytest.mark.parametrize("spec,max_batch", [("dispatch_fail=1.0", 2),
                                            ("dispatch_fail=0.5,seed=3", 1)])
def test_dispatch_failures_fail_futures_and_return_slabs(spec, max_batch):
    """Every future resolves (the injected error or a row), every slab comes
    back, the depth slots free, and the engine never saw a failed batch."""
    chaos = ChaosInjector.from_spec(spec)
    eng = ServeEngine(serve_cfg())
    b = Batcher(eng, max_batch=max_batch, max_delay_ms=1, pipeline_depth=2,
                chaos=chaos).start()
    try:
        futures = [b.submit_ragged(np.full((8, 8, 3), i, np.uint8), (8, 8), BUCKET)
                   for i in range(16)]
        ok = failed = 0
        for f in futures:
            try:
                f.result(timeout=10)
                ok += 1
            except ChaosError as e:
                assert "injected dispatch" in str(e)
                failed += 1
        assert ok + failed == 16
        st = drained(b, eng)
        assert eng.batches == st["batches"] == st["sealed"] - chaos.stats()[
            "dispatch_failures_injected"]
        assert st["images"] == ok
        if max_batch == 1:  # a row a batch: the failures are the injector's
            assert failed == chaos.stats()["dispatch_failures_injected"] and ok and failed
        else:
            assert ok == 0 and eng.batches == 0
    finally:
        b.stop()


# ----------------------------------------------------------- slow fetches


def test_a_slow_fetch_delays_but_serves():
    app, reg = make_app(serve_cfg(chaos="slow_replica=1.0:60"))
    mv = reg.default_entry()
    try:
        t0 = time.monotonic()
        status, _, body = post(app, jpeg(12, 10, 1))
        assert status == 200 and json.loads(body)["predictions"]
        assert time.monotonic() - t0 >= 0.05
        assert app._stats()["overload"]["chaos"]["slow_fetches_injected"] >= 1
        drained(mv.batcher, mv.engine)
    finally:
        close_app(reg)


def test_a_fetch_slower_than_the_deadline_sheds_504():
    app, reg = make_app(serve_cfg(chaos="slow_replica=1.0:800"))
    mv = reg.default_entry()
    try:
        t0 = time.monotonic()
        status, _, body = post(app, jpeg(12, 10, 2), qs="deadline_ms=150")
        assert status == 504 and json.loads(body)["reason"] == "deadline"
        assert time.monotonic() - t0 < 0.7  # at the deadline, not after the stall
        drained(mv.batcher, mv.engine)  # the straggling batch still completes
    finally:
        close_app(reg)


def test_a_spike_holds_requests_but_serves():
    app, reg = make_app(serve_cfg(chaos="spike=600:1200,spike_hold=40"))
    try:
        t0 = time.monotonic()
        assert post(app, jpeg(12, 10, 3))[0] == 200
        assert time.monotonic() - t0 >= 0.03
        assert app._stats()["overload"]["chaos"]["spike_holds_injected"] >= 1
    finally:
        close_app(reg)


# -------------------------------------------------------------- all at once


@pytest.mark.parametrize("concurrent", [False, True])
def test_every_fault_at_once_closes_the_ledger(concurrent):
    """Decode, dispatch and fetch faults together: every request answers
    200, 400 or 500 with no hang, the outcomes sum to the requests offered,
    the 400s are the injected decode failures and, one request at a time (a
    row per batch), the 500s the injected dispatch failures; the batcher,
    the slabs and the cache end empty."""
    app, reg = make_app(serve_cfg(
        chaos="decode_fail=0.2,dispatch_fail=0.15,slow_replica=0.3:20,seed=11",
        cache_bytes=1 << 20))
    mv = reg.default_entry()
    codes = {}

    def req(i):
        codes[i] = post(app, jpeg(12, 10, 100 + i))[0]

    try:
        if concurrent:
            threads = [threading.Thread(target=req, args=(i,)) for i in range(32)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=30)
            assert not any(t.is_alive() for t in threads), "a request hung"
        else:
            for i in range(32):
                req(i)
        n = {c: sum(v == c for v in codes.values()) for c in (200, 400, 500)}
        assert len(codes) == 32 and sum(n.values()) == 32, codes
        ch = app._stats()["overload"]["chaos"]
        assert ch["decode_failures_injected"] == n[400]
        if concurrent:
            assert (n[500] > 0) == (ch["dispatch_failures_injected"] > 0)
        else:
            assert ch["dispatch_failures_injected"] == n[500] > 0
            assert ch["slow_fetches_injected"] <= n[200]
        st = drained(mv.batcher, mv.engine)
        assert st["images"] == n[200]
        assert app.cache.stats()["inflight"] == 0
    finally:
        close_app(reg)
