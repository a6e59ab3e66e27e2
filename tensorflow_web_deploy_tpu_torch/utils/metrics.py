"""Serving observability (counterpart of the JAX package's
``utils/metrics.py``): rolling stats, per-stage histograms, the slow-request
flight recorder, the JSON access log and Prometheus text exposition.

- :class:`RollingStats` — the windowed p50/p99, throughput and occupancy
  behind ``/stats``; its O(1) :meth:`~RollingStats.rate_hint` and
  :meth:`~RollingStats.device_hint` are what deadline admission reads
  under the batcher's condition.
- :class:`Observability` — cumulative per-stage histograms over fixed
  log-spaced buckets, status counts, the flight recorder and the opt-in
  access log; ``/metrics``, ``/stats → tracing``, ``/debug/slow`` and
  ``/debug/trace`` read it.
- :class:`PromText` / :func:`parse_prometheus_text` — the text exposition
  (0.0.4) with the reference's ``tpu_serve_`` prefix, so the same scrape
  configs read both servers, and the parser the tests round-trip it with.

Every internal timestamp is ``time.monotonic()``; the access log's ``ts``
is the one wall-clock value, there so that external tools can join on it.
"""

from __future__ import annotations

import json
import logging
import math
import re
import threading
import time
from bisect import bisect_left
from collections import Counter, deque


class RollingStats:
    def __init__(self, window: int = 2048):
        self._lock = threading.Lock()
        # (t_done, latency_s, queue_s, device_s) per resolved row
        self._records: deque = deque(maxlen=window)
        # per-dispatch (real rows, bucket rows): occupancy is a per-batch
        # property, so it gets its own window
        self._batches: deque = deque(maxlen=window)
        self._batch_sizes: Counter = Counter()
        self._error_lats: deque = deque(maxlen=window)
        # slot-lease waits: nonzero p50 means the slot cap paces admission
        self._lease_waits: deque = deque(maxlen=window)
        self._errors = 0
        self._total = 0
        self._batches_total = 0
        self._started = time.monotonic()
        # per-row device time, an EMA; 0.0 until the first replayed batch
        self._device_ema = 0.0

    def record(self, *, latency_s: float, queue_s: float, device_s: float | None,
               batch_size: int) -> None:
        """One resolved row. ``device_s`` None keeps the row out of the
        device-time EMA and the device percentile (a batch that ran eagerly,
        which on the card pays one-time costs a replay does not)."""
        with self._lock:
            self._records.append((time.monotonic(), latency_s, queue_s, device_s))
            self._batch_sizes[batch_size] += 1
            self._total += 1
            if device_s is not None:
                self._device_ema = (device_s if self._device_ema == 0.0
                                    else 0.9 * self._device_ema + 0.1 * device_s)

    def record_batch(self, real_rows: int, bucket_rows: int) -> None:
        """One dispatched batch: rows that carried requests against the
        batch bucket it ran at."""
        with self._lock:
            self._batches.append((real_rows, max(1, bucket_rows)))
            self._batches_total += 1

    def record_lease_wait(self, wait_s: float) -> None:
        with self._lock:
            self._lease_waits.append(wait_s)

    def record_error(self, latency_s: float | None = None) -> None:
        with self._lock:
            self._errors += 1
            self._total += 1
            if latency_s is not None:
                self._error_lats.append(latency_s)

    def rate_hint(self) -> float:
        """Rows/s over the window's span, from its first and last records."""
        with self._lock:
            if len(self._records) < 2:
                return 0.0
            dt = self._records[-1][0] - self._records[0][0]
            n = len(self._records)
        return n / dt if dt > 0 else 0.0

    def device_hint(self) -> float:
        """Device seconds per row (the EMA); the third term of the expected
        wait."""
        with self._lock:
            return self._device_ema

    @staticmethod
    def _pct(sorted_vals: list[float], q: float) -> float:
        """Nearest rank: ``ceil(q·n) - 1`` (p50 of [1, 2, 3, 4] is 2)."""
        if not sorted_vals:
            return 0.0
        n = len(sorted_vals)
        i = min(n - 1, max(0, math.ceil(q * n) - 1))
        return sorted_vals[i]

    def snapshot(self) -> dict:
        with self._lock:
            recs = list(self._records)
            batches = list(self._batches)
            batch_hist = dict(sorted(self._batch_sizes.items()))
            err_lats = sorted(self._error_lats)
            lease_waits = sorted(self._lease_waits)
            errors, total = self._errors, self._total
            batches_total = self._batches_total
        now = time.monotonic()
        uptime = now - self._started
        lat = sorted(r[1] for r in recs)
        queue = sorted(r[2] for r in recs)
        device = sorted(r[3] for r in recs if r[3] is not None)
        recent = [r for r in recs if now - r[0] <= 10.0]
        window_s = max(min(uptime, 10.0), 1e-6)
        real = sum(b[0] for b in batches)
        bucket = sum(b[1] for b in batches)
        snap = {
            "uptime_s": round(uptime, 1),
            "requests_total": total,
            "errors_total": errors,
            "images_per_sec_10s": round(len(recent) / window_s, 2),
            "latency_ms": {
                "p50": round(1e3 * self._pct(lat, 0.50), 2),
                "p90": round(1e3 * self._pct(lat, 0.90), 2),
                "p99": round(1e3 * self._pct(lat, 0.99), 2),
            },
            "queue_wait_ms_p50": round(1e3 * self._pct(queue, 0.50), 2),
            "device_ms_p50": round(1e3 * self._pct(device, 0.50), 2),
            "lease_wait_ms_p50": round(1e3 * self._pct(lease_waits, 0.50), 3),
            "batch_size_histogram": batch_hist,
            "batch_occupancy": round(real / bucket, 3) if bucket else None,
            "batches_dispatched": len(batches),
            "batches_dispatched_total": batches_total,
        }
        if err_lats:
            snap["error_latency_ms"] = {
                "p50": round(1e3 * self._pct(err_lats, 0.50), 2),
                "p99": round(1e3 * self._pct(err_lats, 0.99), 2),
                "count": len(err_lats),
            }
        return snap


# --------------------------------------------------------------- histograms

# Fixed log-spaced latency buckets (seconds), 1-2.5-5 per decade from 100 µs
# to 50 s: cumulative counts whose scrape deltas compose across instances.
LATENCY_BUCKETS_S: tuple[float, ...] = (
    0.0001, 0.00025, 0.0005,
    0.001, 0.0025, 0.005,
    0.01, 0.025, 0.05,
    0.1, 0.25, 0.5,
    1.0, 2.5, 5.0,
    10.0, 25.0, 50.0,
)


class Histogram:
    """Prometheus-style cumulative histogram over fixed bounds. Not locked:
    :class:`Observability` serializes it under its own lock, so bucket
    counts agree with ``requests_total`` within one scrape."""

    __slots__ = ("bounds", "counts", "sum", "count")

    def __init__(self, bounds: tuple[float, ...] = LATENCY_BUCKETS_S):
        self.bounds = bounds
        self.counts = [0] * (len(bounds) + 1)  # per bucket; the last is overflow
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        v = max(0.0, v)
        self.counts[bisect_left(self.bounds, v)] += 1
        self.sum += v
        self.count += 1

    def quantile(self, q: float) -> float:
        """Bucket-interpolated quantile (PromQL's histogram_quantile); the
        overflow bucket clamps to the top bound."""
        if not self.count:
            return 0.0
        rank = max(1, math.ceil(q * self.count))
        cum = 0
        for i, c in enumerate(self.counts):
            cum += c
            if cum >= rank:
                if i >= len(self.bounds):
                    return self.bounds[-1]
                lo = self.bounds[i - 1] if i else 0.0
                hi = self.bounds[i]
                frac = (rank - (cum - c)) / c
                return lo + (hi - lo) * frac
        return self.bounds[-1]

    def snapshot(self) -> dict:
        """Cumulative buckets [(le_seconds, count ≤ le), ...] + sum + count."""
        cum, buckets = 0, []
        for b, c in zip(self.bounds, self.counts):
            cum += c
            buckets.append((b, cum))
        return {"buckets": buckets, "sum_s": self.sum, "count": self.count}


# ---------------------------------------------------------- flight recorder


class FlightRecorder:
    """The full span breakdown of the N slowest requests (aged out after
    ``max_age_s``), the N most recent erroring ones, and a recent-requests
    ring (``/debug/trace``'s request track) bounded by ``recent_n`` entries
    and ``max_bytes`` approximate bytes, whichever binds first. Dumped by
    ``GET /debug/slow`` with its limits."""

    def __init__(self, n: int = 32, max_age_s: float = 900.0, recent_n: int = 512,
                 max_bytes: int = 4 << 20):
        self.n = max(1, n)
        self.max_age_s = max_age_s
        self.recent_n = max(8, recent_n)
        self.max_bytes = max(64 << 10, int(max_bytes))
        self._lock = threading.Lock()
        self._slowest: list[tuple[float, float, dict]] = []  # (total_s, mono, span)
        self._errors: deque = deque(maxlen=self.n)  # (mono, span)
        self._recent: deque = deque()  # (t0, t_end, nbytes, span)
        self._recent_bytes = 0

    def _expire(self, now: float) -> None:
        cutoff = now - self.max_age_s
        self._slowest = [t for t in self._slowest if t[1] >= cutoff]

    def record(self, span_dict: dict, total_s: float, is_error: bool,
               t0: float | None = None, t_end: float | None = None) -> None:
        now = time.monotonic()
        nbytes = len(repr(span_dict))  # an estimate that scales with the record
        with self._lock:
            if is_error:
                self._errors.append((now, span_dict))
            self._expire(now)
            self._slowest.append((total_s, now, span_dict))
            if len(self._slowest) > self.n:
                self._slowest.sort(key=lambda t: t[0], reverse=True)
                del self._slowest[self.n:]
            if t0 is not None:
                self._recent.append((t0, t_end if t_end is not None else now, nbytes,
                                     span_dict))
                self._recent_bytes += nbytes
                while (len(self._recent) > self.recent_n
                       or self._recent_bytes > self.max_bytes):
                    self._recent_bytes -= self._recent.popleft()[2]

    def retention_s(self) -> float | None:
        """Age of the oldest recent entry; None while the ring is empty."""
        now = time.monotonic()
        with self._lock:
            if not self._recent:
                return None
            return max(0.0, now - self._recent[0][0])

    def trace_records(self, last_s: float | None = None) -> list[tuple]:
        """Recent finished requests as (t0, t_end, span_dict), newest last."""
        now = time.monotonic()
        cutoff = None if last_s is None else now - last_s
        with self._lock:
            return [(t0, t1, d) for (t0, t1, _nb, d) in self._recent
                    if cutoff is None or t1 >= cutoff]

    def snapshot(self) -> dict:
        now = time.monotonic()
        with self._lock:
            self._expire(now)
            slowest = sorted(self._slowest, key=lambda t: t[0], reverse=True)
            errors = list(self._errors)
            recent_bytes = self._recent_bytes
            recent_entries = len(self._recent)
        return {
            "capacity": self.n,
            "max_age_s": self.max_age_s,
            "limits": {
                "slowest_entries": self.n,
                "error_entries": self.n,
                "recent_entries": self.recent_n,
                "recent_bytes_cap": self.max_bytes,
                "recent_bytes": recent_bytes,
                "recent_held": recent_entries,
            },
            "slowest": [{**span, "age_s": round(now - mono, 1)}
                        for total, mono, span in slowest],
            "recent_errors": [{**span, "age_s": round(now - mono, 1)}
                              for mono, span in errors],
        }


# ------------------------------------------------------------- observability


class Observability:
    """Aggregates finished request spans: end-to-end and per-stage
    histograms, request counts by status class, the flight recorder and the
    opt-in access log. One per App. The histograms and the counts update
    under one lock, so a scrape's +Inf bucket equals ``requests_total``."""

    def __init__(self, recorder_n: int = 32, recorder_recent_n: int = 512,
                 recorder_bytes: int = 4 << 20):
        self._lock = threading.Lock()
        self.e2e = Histogram()
        self.stage_hists: dict[str, Histogram] = {}
        self.status_counts: Counter = Counter()  # "2xx"/"4xx"/"5xx"
        self.flight = FlightRecorder(recorder_n, recent_n=recorder_recent_n,
                                     max_bytes=recorder_bytes)
        self._access_fn = None
        self._access_warned = False
        self._started = time.monotonic()

    def set_access_log(self, fn) -> None:
        """``fn(record_dict)`` is called once per finished request."""
        self._access_fn = fn

    def finish(self, span, status: int) -> float:
        """Seal a span and fold it into every surface; called once per
        request, before the answer is written, so that a client that read
        its answer finds it counted by the next scrape."""
        total = span.finish(status)
        d = span.to_dict()
        d["class"] = d.get("meta", {}).get("class", "interactive")
        stages = span.stages_copy()  # batcher threads may still stamp it
        with self._lock:
            self.e2e.observe(total)
            for stage, dur in stages.items():
                h = self.stage_hists.get(stage)
                if h is None:
                    h = self.stage_hists[stage] = Histogram()
                h.observe(dur)
            self.status_counts[f"{status // 100}xx"] += 1
        self.flight.record(d, total, status >= 400, t0=span.t0, t_end=span.finished_at)
        if self._access_fn is not None:
            try:
                self._access_fn({"ts": round(time.time(), 3), **d})
            except Exception:
                # a full disk on the access log drops lines, never answers
                if not self._access_warned:
                    self._access_warned = True
                    logging.getLogger("tpu_serve_torch.metrics").warning(
                        "access log sink failed; suppressing further warnings", exc_info=True)
        return total

    def snapshot(self) -> dict:
        """Consistent copy of every counter and histogram (one lock hold)."""
        with self._lock:
            return {
                "uptime_s": time.monotonic() - self._started,
                "requests_by_status": dict(self.status_counts),
                "e2e": self.e2e.snapshot(),
                "stages": {k: h.snapshot() for k, h in self.stage_hists.items()},
            }

    def stage_summary(self) -> dict:
        """The ``/stats → tracing`` block: cumulative count and total_ms per
        stage (``tools/loadgen.py`` diffs two of them) plus p50/p99."""

        def summarize(h: Histogram) -> dict:
            return {
                "count": h.count,
                "total_ms": round(h.sum * 1e3, 3),
                "mean_ms": round(h.sum / h.count * 1e3, 3) if h.count else 0.0,
                "p50_ms": round(h.quantile(0.50) * 1e3, 3),
                "p99_ms": round(h.quantile(0.99) * 1e3, 3),
            }

        with self._lock:
            return {
                "requests_by_status": dict(self.status_counts),
                "e2e": summarize(self.e2e),
                "stages": {k: summarize(h) for k, h in self.stage_hists.items()},
            }


def make_access_logger(target: str):
    """The access-log sink: ``"-"`` logs one JSON line per request to the
    ``tpu_serve.access`` logger (stderr under the default basicConfig);
    anything else appends to that file, line-buffered. The file stays open
    for the process's life."""
    if target == "-":
        access_log = logging.getLogger("tpu_serve.access")

        def emit(d: dict) -> None:
            access_log.info(json.dumps(d, separators=(",", ":")))

        return emit

    fh = open(target, "a", buffering=1)
    lock = threading.Lock()

    def emit(d: dict) -> None:
        line = json.dumps(d, separators=(",", ":")) + "\n"
        with lock:  # one request per line under the worker pool
            fh.write(line)

    return emit


# ----------------------------------------------- Prometheus text exposition


def _fmt_value(v) -> str:
    if v is None:
        return "NaN"
    if isinstance(v, bool):
        return "1" if v else "0"
    f = float(v)
    if f == math.inf:
        return "+Inf"
    if f.is_integer() and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _fmt_labels(labels: dict | None) -> str:
    if not labels:
        return ""
    esc = str.maketrans({"\\": r"\\", '"': r"\"", "\n": r"\n"})
    inner = ",".join(f'{k}="{str(v).translate(esc)}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


class PromText:
    """Prometheus text-format (0.0.4) builder; ``# TYPE`` once per family
    even when its samples arrive interleaved."""

    def __init__(self, prefix: str = "tpu_serve_"):
        self.prefix = prefix
        self._lines: list[str] = []
        self._typed: set[str] = set()

    def _family(self, name: str, mtype: str, help_: str | None) -> None:
        if name not in self._typed:
            self._typed.add(name)
            if help_:
                self._lines.append(f"# HELP {name} {help_}")
            self._lines.append(f"# TYPE {name} {mtype}")

    def scalar(self, name: str, value, *, mtype: str = "gauge", labels: dict | None = None,
               help_: str | None = None) -> None:
        name = self.prefix + name
        self._family(name, mtype, help_)
        self._lines.append(f"{name}{_fmt_labels(labels)} {_fmt_value(value)}")

    def histogram(self, name: str, hsnap: dict, *, labels: dict | None = None,
                  help_: str | None = None) -> None:
        """``hsnap`` is :meth:`Histogram.snapshot`."""
        name = self.prefix + name
        self._family(name, "histogram", help_)
        base = dict(labels or {})
        for le, cum in hsnap["buckets"]:
            self._lines.append(f"{name}_bucket{_fmt_labels({**base, 'le': _fmt_value(le)})} {cum}")
        self._lines.append(f"{name}_bucket{_fmt_labels({**base, 'le': '+Inf'})} {hsnap['count']}")
        self._lines.append(f"{name}_sum{_fmt_labels(base)} {_fmt_value(hsnap['sum_s'])}")
        self._lines.append(f"{name}_count{_fmt_labels(base)} {hsnap['count']}")

    def render(self) -> str:
        return "\n".join(self._lines) + "\n"


_SAMPLE_RE = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?\s+(\S+)(?:\s+\d+)?$")
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:\\.|[^"\\])*)"')
# the whole label body must be well-formed pairs
_LABELS_FULL_RE = re.compile(
    r'^[a-zA-Z_][a-zA-Z0-9_]*="(?:\\.|[^"\\])*"'
    r'(?:,[a-zA-Z_][a-zA-Z0-9_]*="(?:\\.|[^"\\])*")*,?$'
)
_ESCAPES = {"n": "\n", '"': '"', "\\": "\\"}


def _unescape_label(s: str) -> str:
    """One left-to-right pass (an escaped backslash before ``n`` is not a
    newline)."""
    return re.sub(r"\\(.)", lambda m: _ESCAPES.get(m.group(1), m.group(0)), s)


def parse_prometheus_text(text: str) -> dict:
    """Minimal text-exposition parser: ``{"types": {family: type},
    "samples": {(name, ((k, v), ...)): value}}``. Raises ValueError on any
    line that is neither a comment, blank, nor a well-formed sample."""
    types: dict[str, str] = {}
    samples: dict[tuple, float] = {}
    for raw in text.splitlines():
        line = raw.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 4 and parts[1] == "TYPE":
                types[parts[2]] = parts[3].strip()
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            raise ValueError(f"unparseable exposition line: {raw!r}")
        name, labelstr, value = m.groups()
        labels = []
        if labelstr:
            if not _LABELS_FULL_RE.match(labelstr):
                raise ValueError(f"unparseable labels in line: {raw!r}")
            for lm in _LABEL_RE.finditer(labelstr):
                labels.append((lm.group(1), _unescape_label(lm.group(2))))
        samples[(name, tuple(sorted(labels)))] = float(value)
    return {"types": types, "samples": samples}
