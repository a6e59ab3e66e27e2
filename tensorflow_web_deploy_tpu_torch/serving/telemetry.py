"""In-process telemetry history (counterpart of the JAX package's
``serving/telemetry.py``).

- :class:`SeriesRing` — fixed-memory multi-resolution rings (1 s × 5 min →
  10 s × 1 h → 60 s × 24 h); every sample lands in every level, and each
  cell keeps min / mean / max / last, so a one-second spike survives into
  the 60 s level.
- :class:`TelemetryHub` — the sampler thread (started and stopped by the
  App), the query surface behind ``/debug/history``, SLO objectives
  (``interactive=p99:1000ms:99.9``) evaluated as multi-window burn rates
  (fast 1 m + 5 m pair, slow 30 m) with a fire / clear alert state, and a
  structured event ring (hot swaps, ladder transitions, chaos injections,
  parity gates, alerts) behind ``/debug/events`` and the instant events of
  ``/debug/trace``.

Locking: the hub's ring lock guards the rings, counters and alert state;
a second lock guards the event ring alone, so that registry listeners may
append events while they hold the registry's condition. The sampler holds
no hub lock while it calls its sources (each takes its own locks), and
request threads never wait on the sampler. Timestamps are
``time.monotonic()``.

The pipeline DAGs feed it too: each pipeline's request rate and windowed
e2e p99 (``pipeline.rps.<name>``, ``pipeline.e2e_p99_ms.<name>``), every
request's e2e as a ``pipeline.e2e`` point, and a ``pipeline_reresolved``
event when a swap of a stage model marks a pipeline for re-resolution. The
jobs tier has no source here, as in the reference.
"""

from __future__ import annotations

import logging
import re
import threading
import time
from array import array
from collections import deque

from . import aotcache

log = logging.getLogger("tpu_serve_torch.telemetry")


# ------------------------------------------------------- ring buffers

# (step_seconds, slots): 2100 cells a series at 6 values a cell, ~100 KiB
RESOLUTIONS: tuple[tuple[float, int], ...] = ((1.0, 300), (10.0, 360), (60.0, 1440))


class _Level:
    """One resolution level of one series: parallel fixed arrays indexed by
    ``bucket % slots``; a stored bucket id per cell finds stale cells on
    write and read, with no compaction pass and no allocation."""

    __slots__ = ("step", "slots", "mn", "mx", "sm", "last", "cnt", "bid")

    def __init__(self, step: float, slots: int):
        self.step = step
        self.slots = slots
        self.mn = array("d", [0.0]) * slots
        self.mx = array("d", [0.0]) * slots
        self.sm = array("d", [0.0]) * slots
        self.last = array("d", [0.0]) * slots
        self.cnt = array("d", [0.0]) * slots
        self.bid = array("q", [-1]) * slots

    def observe(self, t: float, v: float) -> None:
        b = int(t // self.step)
        i = b % self.slots
        if self.bid[i] != b:
            self.bid[i] = b
            self.mn[i] = self.mx[i] = self.sm[i] = self.last[i] = v
            self.cnt[i] = 1.0
            return
        if v < self.mn[i]:
            self.mn[i] = v
        if v > self.mx[i]:
            self.mx[i] = v
        self.sm[i] += v
        self.last[i] = v
        self.cnt[i] += 1.0

    def rows(self, now: float, last_s: float) -> list[list[float]]:
        """Valid cells covering [now - last_s, now], oldest first: [bucket
        start s, min, mean, max, last, count]."""
        b_hi = int(now // self.step)
        b_lo = max(0, int((now - last_s) // self.step))
        b_lo = max(b_lo, b_hi - self.slots + 1)
        out = []
        for b in range(b_lo, b_hi + 1):
            i = b % self.slots
            if self.bid[i] != b:
                continue
            c = self.cnt[i]
            out.append([round(b * self.step, 3), self.mn[i], self.sm[i] / c if c else 0.0,
                        self.mx[i], self.last[i], int(c)])
        return out

    def nbytes(self) -> int:
        return sum(a.buffer_info()[1] * a.itemsize
                   for a in (self.mn, self.mx, self.sm, self.last, self.cnt, self.bid))


class SeriesRing:
    """Every resolution level of one named series."""

    __slots__ = ("levels",)

    def __init__(self, resolutions: tuple[tuple[float, int], ...] = RESOLUTIONS):
        self.levels = [_Level(step, slots) for step, slots in resolutions]

    def observe(self, t: float, v: float) -> None:
        for lvl in self.levels:
            lvl.observe(t, v)

    def level_for(self, last_s: float, res: str | None = None) -> _Level:
        """An explicit resolution ("1s"/"10s"/"60s"), or the finest level
        whose span covers the window."""
        if res:
            want = float(res[:-1]) if res.endswith("s") else float(res)
            for lvl in self.levels:
                if lvl.step == want:
                    return lvl
            raise ValueError(f"unknown resolution {res!r}; have "
                             + "/".join(f"{int(v.step)}s" for v in self.levels))
        for lvl in self.levels:
            if last_s <= lvl.step * lvl.slots:
                return lvl
        return self.levels[-1]

    def nbytes(self) -> int:
        return sum(lvl.nbytes() for lvl in self.levels)


# ------------------------------------------------------ SLO objectives

_OBJECTIVE_RE = re.compile(r"^(p\d{1,2}(?:\.\d+)?)[:](\d+(?:\.\d+)?)(ms|s)[:](\d+(?:\.\d+)?)$")


def parse_slo_objectives(spec: str | None) -> dict[str, dict]:
    """``"interactive=p99:1000ms:99.9,batch=p99:10s:99"`` → ``{name:
    {metric, threshold_s, target_pct}}``. A malformed entry is logged and
    dropped, never raised: a typo'd knob means fewer objectives, not a
    failed boot."""
    out: dict[str, dict] = {}
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        name, sep, rest = part.partition("=")
        m = _OBJECTIVE_RE.match(rest.strip()) if sep else None
        if not m or not name.strip():
            log.warning("slo_objectives: ignoring malformed entry %r", part)
            continue
        thr = float(m.group(2)) * (1e-3 if m.group(3) == "ms" else 1.0)
        target = float(m.group(4))
        if not (0.0 < target < 100.0) or thr <= 0:
            log.warning("slo_objectives: ignoring out-of-range entry %r", part)
            continue
        out[name.strip()] = {"metric": m.group(1), "threshold_s": thr, "target_pct": target}
    return out


def good_count(hsnap: dict, threshold_s: float) -> float:
    """Requests at or under ``threshold_s`` from a cumulative histogram
    snapshot, interpolated within the threshold's bucket."""
    prev_le, prev_cum = 0.0, 0.0
    for le, cum in hsnap["buckets"]:
        if threshold_s <= le:
            if le <= prev_le:
                return float(cum)
            frac = (threshold_s - prev_le) / (le - prev_le)
            return prev_cum + (cum - prev_cum) * frac
        prev_le, prev_cum = le, float(cum)
    return float(hsnap["count"])


# The SRE workbook's multiwindow thresholds: burn 14.4 over the fast pair
# spends a 30-day budget in ~2 days (page), burn 6 over the slow window in
# ~5 days (ticket); both fast windows must agree.
DEFAULT_WINDOWS: tuple[tuple[str, float], ...] = (("1m", 60.0), ("5m", 300.0), ("30m", 1800.0))
DEFAULT_FAST_BURN = 14.4
DEFAULT_SLOW_BURN = 6.0


# ------------------------------------------------------------- the hub


class TelemetryHub:
    """Fixed-memory time series + background sampler + SLO burn alerting +
    structured event ring. Sources are callables returning ``{series:
    value}``, merged every ``interval_s``; :meth:`record_point` writes
    without the sampler."""

    def __init__(self, interval_s: float = 1.0, objectives: dict[str, dict] | None = None,
                 windows: tuple[tuple[str, float], ...] = DEFAULT_WINDOWS,
                 fast_burn: float = DEFAULT_FAST_BURN, slow_burn: float = DEFAULT_SLOW_BURN,
                 max_series: int = 128, events_cap: int = 512,
                 resolutions: tuple[tuple[float, int], ...] = RESOLUTIONS):
        self.interval_s = max(0.05, float(interval_s))
        self.objectives = dict(objectives or {})
        self.windows = tuple(windows)
        self.fast_burn = fast_burn
        self.slow_burn = slow_burn
        self.max_series = max(1, int(max_series))
        self.resolutions = tuple(resolutions)
        self._lock = threading.Lock()
        self._events_lock = threading.Lock()
        self._series: dict[str, SeriesRing] = {}
        self._sources: list = []
        self._events: deque = deque(maxlen=max(8, int(events_cap)))
        self._events_total = 0
        self._samples_total = 0
        self._overruns_total = 0
        self._series_dropped = 0
        self._source_errors = 0
        self._last_tick_ms = 0.0
        self._alerts: dict[str, dict] = {
            name: {"state": "ok", "since": None, "burn": {}, "fired_total": 0}
            for name in self.objectives
        }
        self._thread: threading.Thread | None = None
        self._stop_evt = threading.Event()

    def add_source(self, fn) -> None:
        """``fn() -> {series: value}``, called each tick outside hub locks."""
        with self._lock:
            self._sources.append(fn)

    # ---------------------------------------------------------- lifecycle

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop_evt.clear()
        self._thread = threading.Thread(target=self._run, name="telemetry-sampler",
                                        daemon=True)
        self._thread.start()

    def stop(self, grace_s: float = 5.0) -> None:
        t = self._thread
        if t is None:
            return
        self._stop_evt.set()
        t.join(timeout=grace_s)
        self._thread = None

    def _run(self) -> None:
        while not self._stop_evt.is_set():
            t0 = time.monotonic()
            try:
                self.sample_once(t0)
            except Exception:
                log.exception("telemetry tick failed")
            took = time.monotonic() - t0
            if took > self.interval_s:
                with self._lock:
                    self._overruns_total += 1
            # Event.wait: stop() interrupts the interval at once
            self._stop_evt.wait(max(0.0, self.interval_s - took))

    # ----------------------------------------------------------- sampling

    def sample_once(self, now: float | None = None) -> dict:
        """One tick: collect every source (no hub lock held), write the
        rings and evaluate burn rates (one short hold), then record alert
        transitions. Returns the merged sample."""
        if now is None:
            now = time.monotonic()
        with self._lock:
            sources = list(self._sources)
        values: dict[str, float] = {}
        for fn in sources:
            try:
                got = fn()
            except Exception:
                with self._lock:
                    self._source_errors += 1
                if self._source_errors <= 3:
                    log.exception("telemetry source failed")
                continue
            if got:
                values.update(got)
        with self._lock:
            for name, v in values.items():
                if v is None:
                    continue
                ring = self._series.get(name)
                if ring is None:
                    if len(self._series) >= self.max_series:
                        self._series_dropped += 1  # fixed memory beats completeness
                        continue
                    ring = self._series[name] = SeriesRing(self.resolutions)
                ring.observe(now, float(v))
            self._samples_total += 1
            transitions = self._evaluate_slo_locked(now)
            self._last_tick_ms = round((time.monotonic() - now) * 1e3, 3)
        for ev in transitions:
            self.record_event(**ev)
        return values

    def record_point(self, name: str, value: float, now: float | None = None) -> None:
        if now is None:
            now = time.monotonic()
        with self._lock:
            ring = self._series.get(name)
            if ring is None:
                if len(self._series) >= self.max_series:
                    self._series_dropped += 1
                    return
                ring = self._series[name] = SeriesRing(self.resolutions)
            ring.observe(now, float(value))

    # ---------------------------------------------------------- SLO burn

    def _window_delta_locked(self, name: str, window_s: float, now: float):
        """A cumulative counter's delta over [now - window_s, now]; None
        with fewer than two cells."""
        ring = self._series.get(name)
        if ring is None:
            return None
        rows = ring.level_for(window_s).rows(now, window_s)
        if len(rows) < 2:
            return None
        return rows[-1][4] - rows[0][4]

    def _evaluate_slo_locked(self, now: float) -> list[dict]:
        """Burn rate per (objective, window) and the fire / clear machine;
        returns the transition events to record outside the ring lock."""
        transitions: list[dict] = []
        for name, obj in self.objectives.items():
            budget = 1.0 - obj["target_pct"] / 100.0
            if budget <= 0:
                continue
            burns: dict[str, float | None] = {}
            for label, win_s in self.windows:
                d_total = self._window_delta_locked(f"slo.{name}.requests_total", win_s, now)
                d_good = self._window_delta_locked(f"slo.{name}.good_total", win_s, now)
                if not d_total or d_good is None or d_total <= 0:
                    burns[label] = None
                    continue
                bad_frac = max(0.0, min(1.0, 1.0 - d_good / d_total))
                burns[label] = round(bad_frac / budget, 3)
            al = self._alerts[name]
            al["burn"] = burns
            labels = [lb for lb, _ in self.windows]
            fast = [burns.get(lb) for lb in labels[:2]]
            slow = burns.get(labels[-1]) if len(labels) > 2 else None
            firing = (len(fast) == 2 and all(b is not None and b >= self.fast_burn
                                             for b in fast)) \
                or (slow is not None and slow >= self.slow_burn)
            if firing and al["state"] != "firing":
                al["state"], al["since"] = "firing", now
                al["fired_total"] += 1
                transitions.append({"kind": "slo_alert_fire", "objective": name,
                                    "burn": {k: v for k, v in burns.items() if v is not None}})
            elif not firing and al["state"] == "firing":
                al["state"], al["since"] = "ok", now
                transitions.append({"kind": "slo_alert_clear", "objective": name,
                                    "burn": {k: v for k, v in burns.items() if v is not None}})
        return transitions

    def alerts(self) -> dict:
        with self._lock:
            return {
                name: {"objective": self.objectives[name], "state": al["state"],
                       "since": al["since"], "burn": dict(al["burn"]),
                       "fired_total": al["fired_total"]}
                for name, al in self._alerts.items()
            }

    # ------------------------------------------------------------- events

    def record_event(self, kind: str, **fields) -> None:
        """Append one structured event; a bounded append under a leaf lock,
        safe from registry listeners."""
        ev = {"t": round(time.monotonic(), 3), "kind": str(kind)}
        ev.update(fields)
        with self._events_lock:
            self._events.append(ev)
            self._events_total += 1

    def events(self, last_s: float | None = None, kinds: set | None = None) -> list[dict]:
        now = time.monotonic()
        with self._events_lock:
            evs = list(self._events)
        cutoff = None if last_s is None else now - last_s
        return [dict(e) for e in evs
                if (cutoff is None or e["t"] >= cutoff) and (kinds is None or e["kind"] in kinds)]

    # -------------------------------------------------------------- query

    def series_names(self) -> list[str]:
        with self._lock:
            return sorted(self._series)

    def query(self, series, last_s: float = 300.0, res: str | None = None) -> dict:
        """Bounded history of one or more series over ``last_s``, at an
        explicit level step or the finest covering the window. Raises
        KeyError / ValueError on unknown names / resolutions (400)."""
        if isinstance(series, str):
            series = [series]
        last_s = max(1.0, min(float(last_s), 86400.0))
        now = time.monotonic()
        out: dict = {"now": round(now, 3), "window_s": last_s,
                     "columns": ["t", "min", "mean", "max", "last", "count"], "series": {}}
        with self._lock:
            for name in series:
                ring = self._series.get(name)
                if ring is None:
                    raise KeyError(name)
                lvl = ring.level_for(last_s, res)
                out["series"][name] = {"res_s": lvl.step, "rows": lvl.rows(now, last_s)}
        return out

    # -------------------------------------------------------------- stats

    def stats(self) -> dict:
        """The ``/stats → telemetry`` block."""
        with self._lock:
            d = {
                "enabled": True,
                "interval_s": self.interval_s,
                "series_count": len(self._series),
                "max_series": self.max_series,
                "series_dropped": self._series_dropped,
                "memory_bytes": sum(r.nbytes() for r in self._series.values()),
                "samples_total": self._samples_total,
                "overruns_total": self._overruns_total,
                "source_errors_total": self._source_errors,
                "last_tick_ms": self._last_tick_ms,
                "resolutions": [{"step_s": step, "slots": slots, "span_s": step * slots}
                                for step, slots in self.resolutions],
                "windows": {lb: s for lb, s in self.windows},
            }
        d["slo"] = self.alerts()
        with self._events_lock:
            d["events"] = {"held": len(self._events), "cap": self._events.maxlen,
                           "total": self._events_total}
        return d


# ----------------------------------------------------- default sources


def default_sources(app, hub: TelemetryHub):
    """The standard collector over the port's App: goodput and error rates,
    the SLO counters the burn evaluator reads back, the default model's
    latency percentiles, throughput and occupancy, per-model queue depth,
    parity-gate events, the default engine's per-replica in-flight batches
    and busy share, cache hit rate and bytes, each pipeline's request rate
    and e2e p99, build-cache seconds, the
    default model's econ gauges, the ladder's rung and its transitions,
    tenant admit and shed rates, chaos injections as events. Rates come
    from counter deltas between ticks; the closure keeps the last tick's."""
    prev: dict = {"t": None, "status": None, "shed": None, "admitted": None,
                  "pressure": None, "chaos": None, "parity_seen": set(), "aot": None,
                  "busy": {}}

    def collect() -> dict:
        now = time.monotonic()
        dt = (now - prev["t"]) if prev["t"] is not None else None
        prev["t"] = now
        out: dict[str, float] = {}

        obs = app.obs.snapshot()
        by = obs["requests_by_status"]
        ok = by.get("2xx", 0)
        err = sum(v for k, v in by.items() if k != "2xx")
        if dt and dt > 0 and prev["status"] is not None:
            p_ok, p_err = prev["status"]
            out["goodput_rps"] = max(0.0, (ok - p_ok) / dt)
            out["error_rps"] = max(0.0, (err - p_err) / dt)
        prev["status"] = (ok, err)
        for name, obj in hub.objectives.items():
            out[f"slo.{name}.requests_total"] = float(obs["e2e"]["count"])
            out[f"slo.{name}.good_total"] = good_count(obs["e2e"], obj["threshold_s"])

        batcher = app.batcher
        if batcher is not None:
            rs = batcher.rolling.snapshot()
            out["e2e_p50_ms"] = rs["latency_ms"]["p50"]
            out["e2e_p99_ms"] = rs["latency_ms"]["p99"]
            out["images_per_sec"] = rs["images_per_sec_10s"]
            if rs.get("batch_occupancy") is not None:
                out["batch_occupancy"] = rs["batch_occupancy"]

        for mv in app.registry.serving_entries():
            if mv.batcher is not None:
                out[f"queue_depth.{mv.name}"] = float(mv.batcher.queue_depth)
            key = (mv.name, mv.version)
            if key not in prev["parity_seen"]:
                prev["parity_seen"].add(key)
                parity = getattr(mv.engine, "parity", None)
                if parity:
                    hub.record_event("parity_gate", model=mv.name, version=mv.version,
                                     result=parity)

        # per replica of the default engine: batches in flight, and the busy
        # share (busy-seconds delta over the tick, capped at 1: an interval
        # sum can pass wall time)
        engine = app.engine
        if engine is not None and hasattr(engine, "staging_stats"):
            for r in engine.staging_stats()["replicas"]:
                i = r["replica"]
                out[f"replica.inflight.{i}"] = float(r["dispatches_inflight"])
                p_busy = prev["busy"].get(i)
                if dt and dt > 0 and p_busy is not None:
                    out[f"replica.busy_fraction.{i}"] = max(
                        0.0, min(1.0, (r["busy_s"] - p_busy) / dt))
                prev["busy"][i] = r["busy_s"]

        c = app.cache.stats()
        if c.get("hit_rate") is not None:
            out["cache.hit_rate"] = c["hit_rate"]
        out["cache.bytes"] = float(c.get("bytes", 0))

        # per pipeline: its request rate and windowed e2e p99 (each request's
        # e2e is also a "pipeline.e2e" point, written by the executor); the
        # App builds its catalog after the hub
        catalog = getattr(app, "pipelines", None)
        if catalog is not None:
            for pname, pstat in catalog.pipeline_stats()["pipelines"].items():
                key = f"pipeline.requests.{pname}"
                p_req = prev.get(key)
                if dt and dt > 0 and p_req is not None:
                    out[f"pipeline.rps.{pname}"] = max(
                        0.0, (pstat["requests_total"] - p_req) / dt)
                prev[key] = pstat["requests_total"]
                if pstat["e2e_p99_s"] is not None:
                    out[f"pipeline.e2e_p99_ms.{pname}"] = pstat["e2e_p99_s"] * 1e3

        # kernel build cache: per-tick nvcc and load seconds, so that a hot
        # swap's rewarm shows beside its swap event
        a = aotcache.stats()
        if prev["aot"] is not None:
            p_a = prev["aot"]
            out["compile.seconds"] = max(
                0.0, a["compile_seconds_total"] - p_a["compile_seconds_total"])
            out["deserialize.seconds"] = max(
                0.0, a["deserialize_seconds_total"] - p_a["deserialize_seconds_total"])
        prev["aot"] = a

        mv = app.registry.default_entry()
        if mv is not None and mv.engine is not None:
            try:
                econ = costmodel_snapshot(mv.engine, mv.model_cfg)
            except Exception:
                econ = None
            if econ:
                if econ.get("mfu") is not None:
                    out["econ.mfu"] = econ["mfu"]
                out["econ.padded_rows_fraction"] = econ.get("padded_rows_fraction", 0.0)
                rbf = _weighted_roofline(econ)
                if rbf is not None:
                    out["econ.roofline_bound_fraction"] = rbf

        ps = app.pressure.stats()
        out["pressure.level"] = float(ps["level"])
        if prev["pressure"] is not None and ps["level"] != prev["pressure"]:
            hub.record_event("pressure_transition", level=ps["level"], action=ps.get("action"),
                             prev_level=prev["pressure"])
        prev["pressure"] = ps["level"]
        ad = app.admission.stats()
        shed = ad.get("shed_by_reason", {})
        admitted = sum(t["admitted"] for t in ad.get("tenants", {}).values())
        shed_total = sum(shed.values())
        if dt and dt > 0 and prev["admitted"] is not None:
            out["tenant.admitted_rps"] = max(0.0, (admitted - prev["admitted"]) / dt)
            p_shed = prev["shed"] or {}
            out["shed_rps"] = max(0.0, (shed_total - sum(p_shed.values())) / dt)
            for reason, n in shed.items():
                out[f"shed_rps.{reason}"] = max(0.0, (n - p_shed.get(reason, 0)) / dt)
        prev["admitted"], prev["shed"] = admitted, dict(shed)

        if app.chaos is not None:
            cs = app.chaos.stats()
            counts = {k: v for k, v in cs.items()
                      if isinstance(v, int) and k.endswith("_injected")}
            total = sum(counts.values())
            out["chaos.injections_total"] = float(total)
            p = prev["chaos"]
            if p is not None and total > sum(p.values()):
                delta = {k: v - p.get(k, 0) for k, v in counts.items() if v > p.get(k, 0)}
                hub.record_event("chaos_injection", injected=delta)
            prev["chaos"] = counts
        return out

    return collect


def _weighted_roofline(econ: dict) -> float | None:
    """Device-time-weighted mean of the cells' roofline_bound_fraction."""
    num = den = 0.0
    for rep in econ.get("replicas", []):
        for cell in rep.get("buckets", []):
            rbf, ds = cell.get("roofline_bound_fraction"), cell.get("device_s", 0.0)
            if rbf is not None and ds > 0:
                num += rbf * ds
                den += ds
    return round(num / den, 5) if den > 0 else None


def costmodel_snapshot(engine, model_cfg):
    """Indirection so that tests can stub economics without an engine."""
    from . import costmodel

    return costmodel.economics_snapshot(engine, model_cfg)


def wire_registry_events(registry, hub: TelemetryHub) -> None:
    """Hot-swap lifecycle → events (the listeners run under the registry's
    condition; record_event takes only the event lock)."""
    registry.add_serving_listener(
        lambda name, version: hub.record_event("hot_swap_serving", model=name,
                                               version=version))
    registry.add_retire_listener(
        lambda name, version: hub.record_event("hot_swap_retired", model=name,
                                               version=version))


def build_hub(app, cfg) -> TelemetryHub | None:
    """The hub of a ServerConfig, wired to the App and its registry; None
    with ``telemetry_interval_s`` 0. The App starts the sampler."""
    interval = float(getattr(cfg, "telemetry_interval_s", 1.0) or 0.0)
    if interval <= 0:
        return None
    hub = TelemetryHub(interval_s=interval,
                       objectives=parse_slo_objectives(getattr(cfg, "slo_objectives", "") or ""))
    hub.add_source(default_sources(app, hub))
    wire_registry_events(app.registry, hub)
    return hub
