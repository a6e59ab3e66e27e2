"""The port's ``utils/metrics.py`` held to the JAX package's on the same
seeded inputs: histograms and their quantiles exactly, the Prometheus text
string for string, the parser on both renders, the flight recorder and the
span aggregator with their clocks injected, the rolling window, and the
access log line for line."""

import json

import numpy as np
import pytest

from tensorflow_web_deploy_tpu.utils import metrics as jm
from tensorflow_web_deploy_tpu.utils import tracing as jtr
from tensorflow_web_deploy_tpu_torch.utils import metrics as tm
from tensorflow_web_deploy_tpu_torch.utils import tracing as ttr


class FakeTime:
    """A module's ``time`` with a settable monotonic clock."""

    def __init__(self, t: float = 5000.0):
        self.t = t

    def monotonic(self) -> float:
        return self.t

    def time(self) -> float:
        return 1.7e9 + self.t

    def perf_counter(self) -> float:
        return self.t


@pytest.fixture()
def clock(monkeypatch):
    fake = FakeTime()
    for mod in (jm, tm, jtr, ttr):
        monkeypatch.setattr(mod, "time", fake)
    return fake


def _values(seed: int, n: int = 500) -> np.ndarray:
    rng = np.random.RandomState(seed)
    return np.concatenate([rng.lognormal(-5.0, 1.5, n), [0.0, -1.0, 0.0001, 50.0, 80.0]])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_histogram_counts_and_quantiles_equal_exactly(seed):
    a, b = tm.Histogram(), jm.Histogram()
    for v in _values(seed):
        a.observe(float(v))
        b.observe(float(v))
    assert a.counts == b.counts and a.sum == b.sum and a.count == b.count
    assert a.snapshot() == b.snapshot()
    qs = [0.0, 0.01, 0.5, 0.9, 0.99, 0.999, 1.0]
    assert [a.quantile(q) for q in qs] == [b.quantile(q) for q in qs]
    assert tm.LATENCY_BUCKETS_S == jm.LATENCY_BUCKETS_S


def _render(mod) -> str:
    p = mod.PromText()
    h = mod.Histogram()
    for v in _values(3, 50):
        h.observe(float(v))
    p.scalar("uptime_seconds", 12.5, help_="Seconds.")
    p.scalar("requests_total", 7, mtype="counter", labels={"status": "2xx"}, help_="Reqs.")
    p.scalar("requests_total", 2, mtype="counter", labels={"status": "5xx"})
    p.histogram("request_duration_seconds", h.snapshot(), help_="E2E.")
    p.histogram("stage_duration_seconds", h.snapshot(), labels={"stage": "image_decode"})
    p.scalar("model_state", 1, labels={"model": 'we"ird\\na\nme', "version": 3,
                                       "state": "SERVING"})
    p.scalar("slo_alert_firing", True, labels={"class": "interactive"})
    p.scalar("slo_burn_rate", None, labels={"class": "x", "window": "1m"})
    p.scalar("device_peak_flops_per_chip", 989.4e12, labels={"dtype": "bfloat16"})
    p.scalar("inf_gauge", float("inf"))
    p.scalar("small", 1.5e-7)
    return p.render()


def _parsed(doc: dict) -> tuple:
    """A parse with its values as reprs: NaN (a None gauge) equals itself."""
    return doc["types"], sorted((k, repr(v)) for k, v in doc["samples"].items())


def test_prometheus_text_is_string_identical_and_parses_alike():
    got, want = _render(tm), _render(jm)
    assert got == want
    assert _parsed(tm.parse_prometheus_text(got)) == _parsed(jm.parse_prometheus_text(want))
    assert _parsed(tm.parse_prometheus_text(want)) == _parsed(jm.parse_prometheus_text(got))


@pytest.mark.parametrize("line", ['x{a="1" b="2"} 1', "not a sample line at all x", "x{a=1} 2",
                                  'x{a="1",junk} 3'])
def test_parser_refuses_what_the_reference_refuses(line):
    for mod in (tm, jm):
        with pytest.raises(ValueError):
            mod.parse_prometheus_text(line + "\n")


def _span_dicts(seed: int, n: int = 60) -> list[tuple]:
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        total = float(rng.lognormal(-4.0, 1.0))
        status = int(rng.choice([200, 200, 200, 304, 429, 503, 504]))
        d = {"trace_id": f"t{i}", "status": status, "total_ms": round(total * 1e3, 3),
             "stages_ms": {"image_decode": round(total * 300, 3)}, "class": "interactive"}
        out.append((d, total, status >= 400))
    return out


def test_flight_recorder_snapshots_equal(clock):
    a = tm.FlightRecorder(n=8, recent_n=16, max_bytes=70_000)
    b = jm.FlightRecorder(n=8, recent_n=16, max_bytes=70_000)
    for i, (d, total, err) in enumerate(_span_dicts(0)):
        clock.t += 0.5 if i % 10 else 400.0  # some entries age past max_age_s
        for rec in (a, b):
            rec.record(d, total, err, t0=clock.t - total, t_end=clock.t)
    clock.t += 1.0
    assert a.snapshot() == b.snapshot()
    assert a.retention_s() == b.retention_s()
    assert a.trace_records(10.0) == b.trace_records(10.0)


def test_observability_snapshots_and_stage_summaries_equal(clock, tmp_path):
    pa, pb = tmp_path / "port.log", tmp_path / "jax.log"
    a, b = tm.Observability(recorder_n=4), jm.Observability(recorder_n=4)
    a.set_access_log(tm.make_access_logger(str(pa)))
    b.set_access_log(jm.make_access_logger(str(pb)))
    rng = np.random.RandomState(1)
    for i in range(40):
        t0 = clock.t
        spans = [ttr.Span(f"id-{i}", t0=t0), jtr.Span(f"id-{i}", t0=t0)]
        stamps = rng.uniform(0, 0.01, 4)
        for s in spans:
            s.add("http_read", float(stamps[0]))
            s.add("image_decode", float(stamps[1]))
            s.add_max("device_execute", float(stamps[2]))
            if i % 3 == 0:
                s.note("class", "bulk")
        clock.t += float(stamps.sum())
        status = [200, 304, 400, 503][i % 4]
        assert a.finish(spans[0], status) == b.finish(spans[1], status)
        clock.t += 0.25
    sa, sb = a.snapshot(), b.snapshot()
    assert sa == sb
    assert sa["e2e"]["count"] == sum(sa["requests_by_status"].values()) == 40
    assert a.stage_summary() == b.stage_summary()
    assert a.flight.snapshot() == b.flight.snapshot()
    lines = pa.read_text().splitlines()
    assert lines == pb.read_text().splitlines() and len(lines) == 40
    assert [json.loads(ln)["trace_id"] for ln in lines] == [f"id-{i}" for i in range(40)]


def test_rolling_stats_percentiles_and_occupancy_equal(clock):
    a, b = tm.RollingStats(window=64), jm.RollingStats(window=64)
    rng = np.random.RandomState(2)
    for i in range(200):
        clock.t += float(rng.uniform(0, 0.2))
        lat, q, dev = (float(v) for v in rng.lognormal(-4, 1, 3))
        for r in (a, b):
            r.record(latency_s=lat, queue_s=q, device_s=dev, batch_size=int(i % 5 + 1))
            if i % 7 == 0:
                r.record_batch(int(i % 8 + 1), 8)
                r.record_lease_wait(q / 3)
            if i % 11 == 0:
                r.record_error(latency_s=lat * 2)
            if i % 13 == 0:
                r.record_error()
    assert a.snapshot() == b.snapshot()
    assert a.rate_hint() == b.rate_hint() and a.device_hint() == b.device_hint()
    # the port's one addition: a row without device time stays out of the EMA
    a.record(latency_s=0.1, queue_s=0.0, device_s=None, batch_size=1)
    assert a.device_hint() == b.device_hint()
