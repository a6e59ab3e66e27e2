"""Request-scoped span tracing (counterpart of the JAX package's
``utils/tracing.py``): one trace ID and a per-stage wall-time record
carried through the whole request path. Canonical stage names on the
served path: ``http_read``, ``body_read``, ``lease_wait`` (blocked
acquiring a batch slot), ``image_decode`` (header probe + libjpeg into the
leased row, or PIL), ``cache_lookup`` (digest + response-cache consult),
``cache_wait`` (coalesced onto another request's flight),
``staging_write`` (slot commit), ``queue_wait`` (commit → launch start),
``device_transfer`` (H2D enqueue on the copy stream),
``device_dispatch`` (serve-function enqueue or graph replay + async D2H
start), ``device_execute`` (launch end → outputs on the host),
``postprocess``, ``serialize``.

The HTTP front end creates a :class:`Span` when a request's bytes start
arriving; it travels through the WSGI environ (``environ["tpu_serve.span"]``)
and the batcher's slot leases, and each layer stamps the stages it owns.
The finished span is folded into :class:`~.metrics.Observability` and its
ID answers in ``X-Trace-Id``.

Stage durations are ``time.monotonic()`` deltas. A span is handed between
threads (HTTP worker → sealer → launch → completion → HTTP worker), and on
timeout paths the worker finishes it while batcher threads may still
stamp, so every stage mutation and read-out takes the span's lock.
``add_max`` merges the stages of a multi-image request whose images ride
concurrent batches as the slowest leg, so the stage sum still tiles the
request's wall time.
"""

from __future__ import annotations

import itertools
import re
import threading
import time

# Inbound X-Trace-Id values must be safe to echo into headers, JSON logs
# and /debug/slow; anything else gets a fresh server-side ID.
_TRACE_ID_RE = re.compile(r"^[A-Za-z0-9._\-]{1,64}$")

# A per-process prefix from the monotonic clock at import plus a counter:
# unique within the process by the counter, told apart across restarts by
# the prefix.
_PREFIX = f"{time.monotonic_ns() & 0xFFFFFFFFFF:010x}"
_counter = itertools.count(1)
_counter_lock = threading.Lock()


def new_trace_id() -> str:
    with _counter_lock:
        n = next(_counter)
    return f"{_PREFIX}-{n:08x}"


def accept_trace_id(inbound: str | None) -> str:
    """Propagate a well-formed inbound trace ID; mint one otherwise."""
    if inbound and _TRACE_ID_RE.match(inbound):
        return inbound
    return new_trace_id()


class Span:
    """One request's trace: named stage durations plus light metadata.
    Stamps that land after :meth:`finish` copied the stages are not
    reported; the request answered without them."""

    __slots__ = ("trace_id", "t0", "stages", "meta", "status", "finished_at", "_lock")

    def __init__(self, trace_id: str | None = None, t0: float | None = None):
        self.trace_id = trace_id or new_trace_id()
        self.t0 = time.monotonic() if t0 is None else t0
        self.stages: dict[str, float] = {}  # name → seconds, insertion order
        self.meta: dict = {}
        self.status: int | None = None
        self.finished_at: float | None = None  # monotonic, set by finish()
        self._lock = threading.Lock()

    def add(self, stage: str, dur_s: float) -> None:
        """Accumulate a serial stage (repeat stamps sum)."""
        with self._lock:
            self.stages[stage] = self.stages.get(stage, 0.0) + max(0.0, dur_s)

    def add_max(self, stage: str, dur_s: float) -> None:
        """Merge a concurrent stage (repeat stamps keep the slowest leg)."""
        with self._lock:
            self.stages[stage] = max(self.stages.get(stage, 0.0), dur_s)

    def note(self, key: str, value) -> None:
        with self._lock:
            self.meta[key] = value

    def note_default(self, key: str, value) -> None:
        with self._lock:
            self.meta.setdefault(key, value)

    def stages_copy(self) -> dict[str, float]:
        with self._lock:
            return dict(self.stages)

    def finish(self, status: int) -> float:
        """Seal the span; returns total seconds. Idempotent."""
        with self._lock:
            if self.finished_at is None:
                self.finished_at = time.monotonic()
                self.status = status
            return self.finished_at - self.t0

    @property
    def total_s(self) -> float:
        return ((self.finished_at if self.finished_at is not None
                 else time.monotonic()) - self.t0)

    def stage_sum_s(self) -> float:
        return sum(self.stages_copy().values())

    def to_dict(self) -> dict:
        with self._lock:
            stages = dict(self.stages)
            meta = dict(self.meta)
        return {
            "trace_id": self.trace_id,
            "status": self.status,
            "total_ms": round(self.total_s * 1e3, 3),
            "stages_ms": {k: round(v * 1e3, 3) for k, v in stages.items()},
            **({"meta": meta} if meta else {}),
        }


# ----------------------------------------------------- chrome trace export


def _us(t: float) -> float:
    """Monotonic seconds → trace microseconds (batch stamps and span times
    share the one clock)."""
    return round(t * 1e6, 1)


def canvas_side(key) -> int:
    """A slab or builder key back to its canvas side: yuv420 rows are
    (s·3/2, s), rgb rows (s, s, 3) — s is the last spatial axis in both —
    and the port's ragged and engine keys are (kind, s)."""
    try:
        return int(key[1] if len(key) == 2 else key[0])
    except Exception:
        return 0


def effective_window(requested_s: float | None, retention_s: float | None,
                     default_s: float = 60.0, max_s: float = 3600.0) -> float:
    """The trace-window clamp: the requested ``last_s``, the flight
    recorder's retention (None while its ring is empty: no clamp) and the
    export cap, in one place; the caller reports the result back."""
    win = default_s if requested_s is None else max(1.0, float(requested_s))
    win = min(win, max_s)
    if retention_s is not None:
        win = min(win, max(1.0, retention_s))
    return round(win, 3)


def chrome_trace(models: list[dict], requests: list[tuple], last_s: float | None = None,
                 now: float | None = None, instants: list[dict] | None = None) -> dict:
    """Batch timelines + finished request spans as Chrome-trace JSON (the
    ``chrome://tracing`` / Perfetto "JSON trace" dialect).

    ``models`` is ``[{"name": str, "timeline": batcher.batch_timeline()}]``:
    each model is one trace process with an ``assemble canvas=S`` track per
    canvas bucket (open → seal) and ``transfer`` / ``execute`` tracks
    (launch → launched → done). ``requests`` is ``[(t0, t_end,
    span_dict)]`` (``FlightRecorder.trace_records``), drawn as async events
    on a "requests" process; ``instants`` (telemetry events) are global
    instant events."""
    if now is None:
        now = time.monotonic()
    cutoff = None if last_s is None else now - last_s
    events: list[dict] = [{
        "ph": "M", "name": "process_name", "pid": 1, "tid": 0,
        "args": {"name": "requests"},
    }]
    for pid0, m in enumerate(models):
        pid = pid0 + 2
        events.append({
            "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
            "args": {"name": f"model {m.get('name') or 'default'}"},
        })
        for rec in m.get("timeline", ()):
            t_open, t_seal = rec.get("t_open"), rec.get("t_seal")
            t_launch, t_launched = rec.get("t_launch"), rec.get("t_launched")
            t_done = rec.get("t_done")
            end = t_done if t_done is not None else now
            if cutoff is not None and end < cutoff:
                continue
            bulk = bool(rec.get("bulk"))
            tag = "bulk " if bulk else ""
            s = canvas_side(rec.get("key") or ())
            r = rec.get("replica", 0)
            args = {
                "seq": rec.get("seq"), "rows": rec.get("rows"),
                "bucket": rec.get("bucket"), "replica": r,
                "class": "bulk" if bulk else "interactive",
            }
            legs = [
                (f"assemble canvas={s}", f"{tag}assemble b{rec.get('seq')}", t_open, t_seal),
                (f"replica {r} transfer", f"{tag}transfer b{rec.get('seq')}", t_launch,
                 t_launched),
                (f"replica {r} execute", f"{tag}execute b{rec.get('seq')}", t_launched, t_done),
            ]
            for tid, name, a, b in legs:
                if a is None:
                    continue
                b_eff = b if b is not None else now
                events.append({
                    "ph": "X", "cat": "batch", "name": name, "pid": pid, "tid": tid,
                    "ts": _us(a), "dur": max(0.1, _us(b_eff) - _us(a)),
                    "args": args if b is not None else {**args, "inflight": True},
                })
    for t0, t1, d in requests:
        if cutoff is not None and t1 < cutoff:
            continue
        meta = d.get("meta", {})
        name = d.get("class", "interactive") + " request"
        common = {"cat": "request", "id": d.get("trace_id"), "name": name, "pid": 1, "tid": 1}
        events.append({
            **common, "ph": "b", "ts": _us(t0),
            "args": {
                "trace_id": d.get("trace_id"), "status": d.get("status"),
                "stages_ms": d.get("stages_ms", {}),
                **({"model": meta["model"]} if "model" in meta else {}),
            },
        })
        events.append({**common, "ph": "e", "ts": _us(t1), "args": {}})
    for ev in instants or ():
        t = ev.get("t")
        if t is None or (cutoff is not None and t < cutoff):
            continue
        events.append({
            "ph": "i", "s": "g", "cat": "telemetry", "name": ev.get("kind", "event"),
            "pid": 1, "tid": 0, "ts": _us(t),
            "args": {k: v for k, v in ev.items() if k not in ("t", "kind")},
        })
    events.sort(key=lambda e: e.get("ts", 0))
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {"clock": "monotonic", "window_s": last_s,
                      "exported_at_mono": round(now, 6)},
    }
