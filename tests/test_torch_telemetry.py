"""The port's telemetry history (``serving/telemetry.py``) held to the JAX
package's on the same inputs: ring rows, SLO objective parsing and
refusals, good counts, and the hub's series, burn rates, alert states and
events when both sample the same fake sources at the same times."""

import numpy as np
import pytest

from tensorflow_web_deploy_tpu.serving import telemetry as jt
from tensorflow_web_deploy_tpu.utils import metrics as jm
from tensorflow_web_deploy_tpu_torch.serving import telemetry as tt


def test_constants_equal_the_reference():
    assert tt.RESOLUTIONS == jt.RESOLUTIONS
    assert tt.DEFAULT_WINDOWS == jt.DEFAULT_WINDOWS
    assert (tt.DEFAULT_FAST_BURN, tt.DEFAULT_SLOW_BURN) == \
        (jt.DEFAULT_FAST_BURN, jt.DEFAULT_SLOW_BURN)


@pytest.mark.parametrize("seed", [0, 1])
def test_series_ring_rows_equal(seed):
    rng = np.random.RandomState(seed)
    a, b = tt.SeriesRing(), jt.SeriesRing()
    t = 10_000.0
    for _ in range(3000):
        t += float(rng.exponential(0.7))
        v = float(rng.normal(5.0, 2.0))
        a.observe(t, v)
        b.observe(t, v)
    for last_s in (5.0, 60.0, 299.0, 1800.0, 7200.0, 90_000.0):
        for res in (None, "1s", "10s", "60s"):
            la, lb = a.level_for(last_s, res), b.level_for(last_s, res)
            assert la.step == lb.step
            assert la.rows(t, last_s) == lb.rows(t, last_s)
    assert a.nbytes() == b.nbytes()
    for mod_ring in (a, b):
        with pytest.raises(ValueError):
            mod_ring.level_for(10.0, "5s")


SPECS = ["interactive=p99:1000ms:99.9", "interactive=p99:1000ms:99.9,batch=p99:10s:99",
         "a=p50:0.5s:90, b=p99.9:250ms:99.99", "", None, "nonsense", "x=p99:1000ms",
         "x=p99:0ms:99", "x=p99:10ms:100", "=p99:10ms:99", "x=p999:1s:99", "x=p99:1h:99",
         "ok=p95:20ms:95,bad=q1:1s:1"]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_slo_objectives_equal_outputs_and_refusals(spec):
    assert tt.parse_slo_objectives(spec) == jt.parse_slo_objectives(spec)


def test_good_count_equal():
    rng = np.random.RandomState(3)
    h = jm.Histogram()
    for v in rng.lognormal(-3, 1.5, 400):
        h.observe(float(v))
    snap = h.snapshot()
    for thr in (0.0, 0.00005, 0.0001, 0.003, 0.05, 0.1, 0.7, 1.0, 49.0, 50.0, 1e3):
        assert tt.good_count(snap, thr) == jt.good_count(snap, thr)


class _Sources:
    """Cumulative SLO counters that go bad in the middle, a gauge, a None,
    and a burst of per-key series past the series cap."""

    def __init__(self):
        self.total = self.good = 0.0
        self.i = 0

    def __call__(self) -> dict:
        self.i += 1
        self.total += 100
        self.good += 100 if not (40 <= self.i < 70) else 50  # half bad for 30 s
        out = {"slo.interactive.requests_total": self.total,
               "slo.interactive.good_total": self.good,
               "goodput_rps": float(self.i % 7), "skipped": None}
        if self.i == 5:
            out.update({f"queue_depth.m{k}": float(k) for k in range(140)})
        return out


def _hub(mod):
    # short burn windows, so that the alert both fires and clears in 150 s
    hub = mod.TelemetryHub(interval_s=1.0, objectives=mod.parse_slo_objectives(
        "interactive=p99:1000ms:99.9"), windows=(("10s", 10.0), ("20s", 20.0), ("40s", 40.0)),
        max_series=32)
    hub.add_source(_Sources())
    return hub


def _strip_t(events: list[dict]) -> list[dict]:
    return [{k: v for k, v in e.items() if k != "t"} for e in events]


def test_hub_sample_once_gives_equal_series_burns_alerts_and_events():
    import time

    a, b = _hub(tt), _hub(jt)
    base = time.monotonic() - 200.0
    states = []
    for i in range(150):
        now = base + i
        assert a.sample_once(now) == b.sample_once(now)
        states.append(a.alerts()["interactive"]["state"])
        assert a.alerts() == b.alerts()
    assert "firing" in states and states[-1] == "ok"  # fired, then cleared
    names = a.series_names()
    assert names == b.series_names() and len(names) == 32
    assert a.query(names[:5], last_s=300.0) | {"now": 0} == \
        b.query(names[:5], last_s=300.0) | {"now": 0}
    kinds = [e["kind"] for e in a.events()]
    assert kinds == ["slo_alert_fire", "slo_alert_clear"]
    assert _strip_t(a.events()) == _strip_t(b.events())
    sa, sb = a.stats(), b.stats()
    for k in ("series_count", "series_dropped", "memory_bytes", "samples_total", "slo",
              "events", "resolutions", "windows", "max_series"):
        assert sa[k] == sb[k], k
    with pytest.raises(KeyError):
        a.query("no.such.series")
    a.record_event("hot_swap_serving", model="m", version=2)
    assert a.events(kinds={"hot_swap_serving"})[0]["version"] == 2


def test_replica_sources_join_the_hub_per_replica():
    """A server whose default model serves ``replicas=4`` over four CPU
    entries: the hub's catalog holds ``replica.inflight.<i>`` and
    ``replica.busy_fraction.<i>`` for each replica (the series
    ``tools/loadgen.py --history`` reads for its busy column), the busy
    share in [0, 1]."""
    import time

    from tensorflow_web_deploy_tpu_torch.parallel.mesh import cpu_mesh
    from tensorflow_web_deploy_tpu_torch.server import start_server
    from tensorflow_web_deploy_tpu_torch.utils.config import ModelConfig, ServerConfig

    mc = ModelConfig(name="mobilenet_v2", zoo_width=0.25, zoo_classes=12, input_size=(64, 64),
                     topk=3, dtype="float32", placement="replicas=4")
    cfg = ServerConfig(model=mc, host="127.0.0.1", port=0, canvas_buckets=(96,), max_batch=4,
                       ragged=True, telemetry_interval_s=3600.0)
    srv = start_server(cfg, mesh=cpu_mesh(4))
    try:
        hub = srv.app.telemetry
        hub.sample_once()
        for r in range(4):  # busy time on every replica between two ticks
            srv.engine.run_batch(np.zeros((2, 96, 96, 3), np.uint8),
                                 np.full((2, 2), 96, np.int32), replica=r)
        time.sleep(0.05)
        hub.sample_once()
        names = set(hub.series_names())
        for i in range(4):
            assert {f"replica.inflight.{i}", f"replica.busy_fraction.{i}"} <= names
            row = hub.query([f"replica.busy_fraction.{i}"], last_s=60.0)
            point = row["series"][f"replica.busy_fraction.{i}"]["rows"][-1]
            assert 0.0 < point[3] <= 1.0
    finally:
        srv.close()
