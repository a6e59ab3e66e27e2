"""HTTP surface: a WSGI app over the model registry, served by a pooled
HTTP/1.1 keep-alive front end (counterpart of the JAX package's
``serving/http.py``).

- **Keep-alive worker pool.** A fixed pool of worker threads owns each
  connection for its life and serves any number of requests on it; the
  accept loop only enqueues. With more live connections than workers an
  idle kept-alive connection yields its worker to a queued one — only
  while every worker is busy (the reference yields whenever the queue is
  not empty, which also closes idle connections in the instant before a
  free worker takes a new one) — and overload sheds at accept (pending
  queue full → connection closed).
- **Read deadlines.** A request's headers and body must arrive within a
  total deadline (``request_timeout_s``; a trickled body answers 408), an
  idle connection closes after ``keepalive_timeout_s``. Chunked bodies are
  refused (411), an unread body is drained up to ``max_drain`` bytes so
  that the connection can be reused, Nagle is off.
- **Ordered drain.** :func:`shutdown_gracefully`: stop accepting → stop
  every model's batcher (each dispatches what it holds and resolves every
  future) → half-close the pool's connections and join the workers → close
  the socket.
- **Lease fast path.** For ``POST /predict`` each JPEG is probed from its
  header, given a leased batch slot, and decoded by libjpeg straight into
  that slot's pinned memory; anything else is decoded by PIL and copied
  in. An undecodable file answers 400 and releases the request's other
  slots (they ship as holes).
- **Response cache** (``serving/respcache.py``). The digest of what the
  device would read is looked up after the decode: a hit or a wait on
  another request's in-flight computation releases the slot as a hole,
  a miss leads the computation and publishes its answer. Single-image
  answers carry ``ETag`` and honor ``If-None-Match`` with 304; with the
  cache on, ``X-Cache`` says ``hit``, ``miss`` or ``coalesced``.
- **Overload control** (``serving/overload.py``). ``X-Tenant`` picks a
  token bucket (429), ``X-SLO``/``?slo=`` and ``X-Deadline-Ms``/
  ``?deadline_ms=`` a deadline (504 when the batcher's expected wait cannot
  meet it, at the lease or at the seal), a full backlog answers 503; every
  shed carries a JSON ``reason`` and ``Retry-After``. One ladder step per
  request on the resolved version's queue: top-k clamped to 1, then the
  smallest canvas bucket, then (four rungs) a reroute to the int8 variant
  of the same network, then cache misses shed with 503 ``degraded``.
- **Tracing and telemetry** (``utils/tracing.py``, ``utils/metrics.py``,
  ``serving/telemetry.py``, ``serving/costmodel.py``). Every request gets a
  :class:`~..utils.tracing.Span` when its bytes start arriving (a
  well-formed inbound ``X-Trace-Id`` is kept), stamped by each layer it
  crosses; the finished span feeds the per-stage histograms, the flight
  recorder and the opt-in access log before the answer is written, and its
  ID answers in ``X-Trace-Id`` on every response, sheds and 304s included.
  The telemetry hub's sampler starts with the App and stops first in
  :func:`shutdown_gracefully`.
- **Pipeline DAGs** (``serving/dag.py``, ``--pipeline``). ``App.pipelines``
  is the :class:`~.dag.PipelineCatalog` over the same registry and cache,
  built (and every spec validated, a bad one failing the boot) before the
  telemetry sampler starts; ``POST /pipelines/<name>`` runs one image
  through detect → crop → classify with the intermediates on the device.
- **Bulk jobs** (``serving/jobs.py``, ``--jobs-dir``). ``App.jobs`` is the
  :class:`~.jobs.JobManager` over the same registry and cache; its runner
  feeds the batchers' bulk class. :func:`shutdown_gracefully` stops it
  before the batchers drain, so a running job checkpoints at its chunk
  boundary and resumes on the next boot.

Routes:
    POST /predict       image (raw body or multipart/form-data) → JSON
                        top-k; ``?topk=N``; ``?model=name[@version]`` routes
                        to any SERVING model (the default one without it;
                        unknown → 404, not serving → 503, before the body is
                        read). One image answers ``{"predictions": [{"label",
                        "index", "score"}], "model", "model_version",
                        "latency_ms", "trace_id"}`` (the ETag covers the
                        payload, not that envelope); several file parts, or
                        ``?batch=1``, answer ``{"results": [...], ...}`` in
                        upload order (at most the batcher's ``max_batch``,
                        else 413). A body past ``max_body_mb`` × 10^6 bytes
                        answers 413 before it is read. Headers in:
                        ``If-None-Match``, ``X-Tenant``, ``X-SLO``,
                        ``X-Deadline-Ms``; out: ``ETag``, ``X-Cache``.
    GET  /healthz       one-image device round trip on the default model
    GET  /models        the registry: default model, every version's state,
                        transition history, placement and counters
    POST /models/load   admin: ``{"model": spec, "name"?, "activate"?,
                        "wait"?}``, built and warmed off the request path
    POST /models/swap   admin: ``{"name"?, "model"?, "wait"?}``, a new
                        version takes the traffic once warm, the old drains
    POST /models/unload admin: ``{"name", "version"?, "wait"?}``
    GET  /stats         the default model's rolling stats at the top level
                        and its ``batcher`` and ``engine``
                        counters (kernel launches, decodes, the decoder,
                        ``graphs`` with the process's device memory,
                        ``aot_cache``, ``warmup_s``), ``staging`` (the slab
                        pool and, per replica, dispatches, in flight, slab
                        bytes in flight, busy seconds), ``config``
                        (``devices``, ``placement``), ``models`` (each
                        version's batcher and engine counters under its
                        name), ``http`` (keep-alive counters), ``cache``,
                        ``overload`` (``admission``, ``pressure``,
                        ``chaos``), ``tracing`` (per-stage count, total,
                        p50/p99), ``economics`` (per serving version: MFU,
                        roofline per (canvas, batch) cell, padding),
                        ``telemetry``
    GET  /metrics       Prometheus text exposition (``tpu_serve_`` families:
                        requests and stage histograms, batcher, admission,
                        ladder, chaos, cache, build cache, registry, per
                        model and per replica, economics with ``model_mfu``
                        and the card's ``device_peak_*``, telemetry)
    GET  /debug/slow    the flight recorder: span breakdowns of the slowest
                        and the erroring requests, with its limits
    GET  /debug/history ``?series=a,b&last_s=N&res=1s|10s|60s``: telemetry
                        rings (without ``series``: their names)
    GET  /debug/events  ``?last_s=N&kind=a,b``: hot swaps, ladder moves,
                        chaos injections, parity gates, SLO alerts
    GET  /debug/trace   ``?last_s=N``: batch timelines + recent request spans
                        + events as Chrome-trace JSON
    POST /debug/trace   ``?ms=N&dir=D``: a ``torch.profiler`` capture of N ms
                        (at most 60,000) written to D as a Chrome trace; 409
                        while another capture runs
    GET  /pipelines     every pipeline's spec, ref and live stage resolution
    POST /pipelines/{name}  one image (raw body, or multipart with exactly one
                        file part) through the pipeline: ``{"detections":
                        [{"box", "class", "label", "score", "classification":
                        {"predictions": [...]}}], "num_detections",
                        "pipeline", "stages", "latency_ms", "trace_id"}``;
                        ``?topk=N`` clamps against the last stage; ``ETag``
                        (the last stage's cache identity) and
                        ``If-None-Match`` (304); 404 unknown, 503 a stage
                        not serving, 400 no or several images or an
                        undecodable one, 413 past the body cap
    POST /jobs          a bulk job (``--jobs-dir``): a multipart upload (the
                        file parts are the manifest) or a JSON body
                        ``{"dir", "glob"?, "recursive"?, "model"?, "topk"?}``
                        naming a server-side directory; ``?model=&topk=&
                        weight=`` and ``X-Tenant``. 202 and the job
                        document; 404 for an unknown model, 400 for a
                        version pin or a bad body, 503 while jobs are off
    GET  /jobs          every job (state, progress, versions)
    GET  /jobs/{id}     one job's document (404 if unknown)
    GET  /jobs/{id}/results  ``?offset=N&limit=M&wait_s=S``: its result lines
                        (application/x-ndjson) from N, with ``X-Job-State``,
                        ``X-Job-Next-Offset`` and ``X-Job-Complete``
    POST /jobs/{id}/cancel   stop at the next chunk boundary
    GET  /              the upload page

The admin routes are as open as the rest of the surface: deploy behind
the network boundary that guards the server.
"""

from __future__ import annotations

import json
import logging
import os
import queue
import select
import socket
import sys
import tempfile
import threading
import time
import urllib.parse
from concurrent.futures import TimeoutError as FutureTimeout
from http.server import BaseHTTPRequestHandler
from socketserver import TCPServer

from .. import native
from ..ops.image import decode_image, fit_to_bucket
from ..utils.metrics import Observability, PromText, make_access_logger
from ..utils.tracing import Span, accept_trace_id, chrome_trace, effective_window
from . import aotcache, costmodel
from .batcher import BacklogFull, LeaseExpired, ShuttingDown
from .dag import PipelineCatalog, PipelineUnavailable, parse_pipeline_args
from .engine import quiesced
from .jobs import JobManager, UnknownJob, clamp_topk, format_result_row
from .overload import (
    DEFAULT_TENANT,
    SHED_BACKLOG,
    SHED_DEADLINE,
    SHED_DEGRADED,
    SHED_QUOTA,
    DeadlineExceeded,
    Degraded,
    QuotaExceeded,
    build_pressure,
    parse_slo_classes,
)
from .registry import FAILED, ModelNotServing, ModelRegistry, UnknownModel
from .respcache import ResponseCache, canvas_digest, make_key, packed_digest, payload_etag
from .telemetry import build_hub

log = logging.getLogger("tpu_serve_torch.http")

# a classic-wire slot row ends in the image's big-endian (h, w) trailer
TRAILER_BYTES = 4


class _CoalesceRetry(Exception):
    """A request's coalesced flight aborted (its version retired, or its
    leader failed): the request re-resolves its model and retries once."""

_DEMO_PAGE = """<!doctype html>
<title>tpu-serve</title>
<style>
 body { font-family: system-ui, sans-serif; max-width: 40em; margin: 2em auto; }
 table { border-collapse: collapse; margin-top: 1em; }
 td, th { border: 1px solid #ccc; padding: .3em .8em; text-align: left; }
 #preview { max-width: 20em; max-height: 20em; display: block; margin-top: 1em; }
 #ms { color: #666; }
</style>
<h2>tensorflow_web_deploy_tpu — image inference</h2>
<form id=f>
  <input type=file id=file accept=image/*>
  <button>Predict</button> <span id=ms></span>
</form>
<img id=preview hidden>
<div id=out></div>
<p>POST an image to <code>/predict</code> (raw body or multipart); see
<a href=/stats>/stats</a>, <a href=/healthz>/healthz</a>.</p>
<script>
const f = document.getElementById('f');
f.addEventListener('submit', async (e) => {
  e.preventDefault();
  const file = document.getElementById('file').files[0];
  if (!file) return;
  const img = document.getElementById('preview');
  img.src = URL.createObjectURL(file); img.hidden = false;
  const t0 = performance.now();
  const resp = await fetch('/predict', {method: 'POST', body: file});
  const data = await resp.json();
  document.getElementById('ms').textContent =
      `${(performance.now() - t0).toFixed(0)} ms`;
  // Build result cells with textContent (never innerHTML): labels come
  // from a server-side file and must not be interpretable as markup.
  const preds = data.predictions || data.detections || [];
  const out = document.getElementById('out');
  out.textContent = '';
  if (preds.length) {
    const table = document.createElement('table');
    const hdr = table.insertRow();
    for (const h of ['label', 'score']) {
      const th = document.createElement('th');
      th.textContent = h;
      hdr.appendChild(th);
    }
    for (const p of preds) {
      const tr = table.insertRow();
      tr.insertCell().textContent = String(p.label ?? p.class);
      tr.insertCell().textContent = (p.score ?? 0).toFixed(4);
    }
    out.appendChild(table);
  } else {
    const pre = document.createElement('pre');
    pre.textContent = JSON.stringify(data, null, 2);
    out.appendChild(pre);
  }
});
</script>
"""


def _parse_multipart_files(body: bytes, content_type: str) -> list[tuple[str, bytes]]:
    """All file parts of a multipart/form-data body, in order, as
    ``(filename, payload)``; without any file part, the first plain form
    field. Exactly one CRLF framing each part is removed, never more:
    a payload may itself end in CR or LF bytes."""
    boundary = None
    for piece in content_type.split(";"):
        piece = piece.strip()
        if piece.startswith("boundary="):
            boundary = piece[len("boundary="):].strip('"')
    if not boundary:
        return []
    delim = b"--" + boundary.encode()
    files: list[tuple[str, bytes]] = []
    fallback = None
    for part in body.split(delim):
        if part.startswith(b"\r\n"):
            part = part[2:]
        if part.endswith(b"\r\n"):
            part = part[:-2]
        if not part or part.strip(b"\r\n- ") == b"":
            continue  # preamble / the final "--" terminator
        header_end = part.find(b"\r\n\r\n")
        if header_end < 0:
            continue
        headers = part[:header_end].decode("utf-8", "replace")
        payload = part[header_end + 4 :]
        hl = headers.lower()
        if "content-disposition" not in hl:
            continue
        at = hl.find("filename=")
        if at >= 0:
            fname = headers[at + len("filename="):].split(";")[0].split("\r\n")[0]
            files.append((fname.strip().strip('"'), payload))
        elif fallback is None:
            fallback = ("body", payload)
    if not files and fallback is not None:
        return [fallback]
    return files


def _qs_last(qs: dict[str, list[str]], key: str) -> str | None:
    """Last value wins for duplicate query keys."""
    vals = qs.get(key)
    return vals[-1] if vals else None


def _etag_matches(inm: str | None, etag: str) -> bool:
    """RFC 9110 ``If-None-Match``: ``*``, or any listed entity-tag equal to
    ``etag`` under the weak comparison (a ``W/`` prefix is ignored)."""
    if not inm:
        return False
    if inm.strip() == "*":
        return True
    for tok in inm.split(","):
        tok = tok.strip()
        if tok[:2] in ("W/", "w/"):
            tok = tok[2:].strip()
        if tok.strip('"') == etag:
            return True
    return False


# POST /debug/trace: the longest capture, and one capture at a time per process
MAX_TRACE_MS = 60_000
_PROFILE_LOCK = threading.Lock()

_STATUS = {200: "200 OK", 202: "202 Accepted", 304: "304 Not Modified", 400: "400 Bad Request",
           404: "404 Not Found", 405: "405 Method Not Allowed", 408: "408 Request Timeout",
           409: "409 Conflict", 413: "413 Content Too Large", 429: "429 Too Many Requests",
           500: "500 Internal Server Error", 503: "503 Service Unavailable",
           504: "504 Gateway Timeout"}


def _json(code: int, obj, headers: list | None = None) -> tuple:
    """A route's answer: (status line, body, content type, extra headers)."""
    return _STATUS[code], json.dumps(obj).encode(), "application/json", headers or []


def _error(code: int, message: str, headers: list | None = None) -> tuple:
    return _json(code, {"error": message}, headers)


class App:
    """WSGI application over a model registry. Every request resolves its
    model through the registry, so a hot swap changes what the next request
    runs against with no state here to update."""

    def __init__(self, registry: ModelRegistry, server_cfg):
        self.registry = registry
        self.cfg = server_cfg
        self.http_counters = None  # attached by make_http_server
        # the response cache (0 bytes: off, its block still in /stats); a
        # version's entries go the moment it enters DRAINING
        self.cache = ResponseCache(server_cfg.cache_bytes)
        registry.add_retire_listener(self.cache.invalidate)
        # the registry's admission and chaos, shared with every batcher; the
        # ladder and the SLO classes are the front end's
        self.admission = registry.admission
        self.chaos = registry.chaos
        self.pressure = build_pressure(server_cfg)
        self.slo_classes = parse_slo_classes(server_cfg.slo_classes)
        # span aggregation: every observability surface reads it
        self.obs = Observability(recorder_n=server_cfg.flight_recorder_n,
                                 recorder_recent_n=server_cfg.flight_recorder_recent_n,
                                 recorder_bytes=server_cfg.flight_recorder_bytes)
        if server_cfg.access_log:
            self.obs.set_access_log(make_access_logger(server_cfg.access_log))
        # the telemetry hub (None with telemetry_interval_s 0): its sampler
        # runs from here until shutdown_gracefully stops it
        self.telemetry = build_hub(self, server_cfg)
        # pipeline DAGs: every spec validated against the registry here, so
        # that a bad --pipeline fails the boot (before the sampler starts);
        # the catalog always exists, maybe empty
        self.pipelines = PipelineCatalog(registry, cache=self.cache, hub=self.telemetry,
                                         max_crops=server_cfg.pipeline_max_crops)
        self.pipelines.attach_listeners()
        for spec in parse_pipeline_args(server_cfg.pipelines):
            self.pipelines.register(spec)
        registry.attach_pipelines(self.pipelines)
        if self.telemetry is not None:
            self.telemetry.start()
        # bulk jobs (--jobs-dir): the manager resumes the jobs it finds on
        # disk at once, through the same registry and cache
        self.jobs: JobManager | None = None
        if server_cfg.jobs_dir:
            self.jobs = JobManager(registry, self.cache, server_cfg, obs=self.obs)

    # The default model's serving unit, resolved on every read so that a
    # hot swap of the default model retargets /healthz and /stats.
    @property
    def engine(self):
        mv = self.registry.default_entry()
        return mv.engine if mv is not None else None

    @property
    def batcher(self):
        mv = self.registry.default_entry()
        return mv.batcher if mv is not None else None

    def attach_http(self, srv) -> None:
        """Called by make_http_server: /stats shows the pool's counters."""
        self.http_counters = srv.counters

    # ------------------------------------------------------------------ wsgi

    def __call__(self, environ, start_response):
        path = environ.get("PATH_INFO", "/")
        method = environ.get("REQUEST_METHOD", "GET")
        # the pooled front end makes the span when the request's bytes start
        # arriving and finishes it before the answer goes out; a direct WSGI
        # caller gets one made and finished here
        span = environ.get("tpu_serve.span")
        own_span = span is None
        if own_span:
            span = Span(accept_trace_id(environ.get("HTTP_X_TRACE_ID")))
            environ["tpu_serve.span"] = span
        span.note_default("method", method)
        span.note_default("path", path)
        try:
            if path == "/predict" and method == "POST":
                res = self._predict(environ)
            elif path == "/healthz":
                res = self._healthz()
            elif path == "/models" and method == "GET":
                res = _json(200, self.registry.models_snapshot())
            elif path in ("/models/load", "/models/swap", "/models/unload"):
                res = self._admin_models(environ, method, path)
            elif path == "/stats":
                res = _json(200, self._stats())
            elif path == "/metrics":
                res = "200 OK", self._metrics().encode(), "text/plain; version=0.0.4", []
            elif path == "/debug/slow":
                res = _json(200, self.obs.flight.snapshot())
            elif path == "/debug/history":
                res = self._history(environ)
            elif path == "/debug/events":
                res = self._events(environ)
            elif path == "/debug/trace" and method == "POST":
                res = self._profile(environ)
            elif path == "/debug/trace":
                res = self._trace_export(environ)
            elif path == "/pipelines" and method == "GET":
                res = _json(200, self.pipelines.pipelines_snapshot())
            elif path.startswith("/pipelines/") and method == "POST":
                res = self._pipeline_predict(environ, path[len("/pipelines/"):])
            elif path == "/jobs" or path.startswith("/jobs/"):
                res = self._jobs_route(environ, method, path)
            elif path == "/":
                res = "200 OK", _DEMO_PAGE.encode(), "text/html", []
            else:
                res = _error(404, f"no route {path}")
        except socket.timeout:
            # the body read hit the request's read deadline: client weather
            log.warning("request read timed out: %s %s", method, path)
            res = _error(408, "request read timed out")
        except Exception as e:  # request-level failure isolation
            log.exception("request failed: %s %s", method, path)
            res = _error(500, f"{type(e).__name__}: {e}")
        status, body, ctype, headers = res
        if own_span:
            self.obs.finish(span, int(status.split(None, 1)[0]))
        start_response(status, [("Content-Type", ctype), ("Content-Length", str(len(body))),
                                ("X-Trace-Id", span.trace_id), *headers])
        return [body]

    def _healthz(self):
        """A one-image round trip on the default model's serving version,
        held for the call so that a swap cannot close its engine under it."""
        try:
            with self.registry.lease_model() as mv:
                ok = mv.engine.healthcheck()
        except (UnknownModel, ModelNotServing):
            ok = False
        return _json(200 if ok else 503, {"ok": ok})

    def _stats(self) -> dict:
        mv = self.registry.default_entry()
        batcher = mv.batcher if mv is not None else None
        bstats = batcher.stats() if batcher is not None else None
        # the reference's top level: the default model's rolling window
        snap = dict(bstats["rolling"]) if bstats is not None else {}
        snap["model"] = mv.name if mv is not None else None
        if batcher is not None:
            snap["queue_depth"] = batcher.queue_depth
            snap["batcher"] = bstats
        engine = mv.engine if mv is not None else None
        if engine is not None:
            snap["engine"] = engine.stats()
        if hasattr(engine, "staging_stats"):
            # the slab pool and the per-replica dispatch attribution
            snap["staging"] = engine.staging_stats()
        if engine is not None:
            # the reference's config keys for the default model's placement;
            # each version's rides "models" and GET /models
            snap["config"] = {
                "devices": len(getattr(engine, "mesh", ())) or None,
                "placement": (engine.placement_summary()
                              if hasattr(engine, "placement_summary") else None)}
        # the jobs knobs echoed, as the reference's config block does
        snap.setdefault("config", {}).update({
            "pipelines": self.pipelines.names(),
            "jobs_dir": self.cfg.jobs_dir,
            "jobs_batch": self.jobs.bulk_batch if self.jobs is not None else None,
            "jobs_max_inflight": self.jobs.max_inflight if self.jobs is not None else None})
        snap["models"] = self.registry.models_snapshot()
        snap["jobs"] = self.jobs.stats() if self.jobs is not None else {"enabled": False}
        if self.http_counters is not None:
            snap["http"] = self.http_counters.snapshot()
        snap["cache"] = self.cache.stats()
        snap["overload"] = {"admission": self.admission.stats(),
                            "pressure": self.pressure.stats()}
        if self.chaos is not None:
            snap["overload"]["chaos"] = self.chaos.stats()
        # per pipeline: requests, errors, e2e percentiles, per-stage seconds,
        # images, cache hits and D2H bytes, and the cost model's attribution
        ps = self.pipelines.pipeline_stats()
        for pstat in ps["pipelines"].values():
            try:
                pstat["attribution"] = costmodel.pipeline_attribution(pstat, self.registry)
            except Exception:  # attribution must never fail /stats
                log.exception("pipeline attribution failed")
        snap["pipelines"] = ps
        # per-stage span aggregates, cumulative (tools/loadgen.py diffs two)
        snap["tracing"] = self.obs.stage_summary()
        snap["economics"] = self._economics()
        snap["telemetry"] = (self.telemetry.stats() if self.telemetry is not None
                             else {"enabled": False})
        return snap

    def _economics(self) -> dict:
        """Per serving version: the cost model's roofline attribution over
        the engine's measured cells, and the batcher's padding block; a
        version with neither (a mock engine and no batcher) is absent."""
        out = {}
        for mv in self.registry.serving_entries():
            try:
                econ = costmodel.economics_snapshot(mv.engine, mv.model_cfg)
            except Exception:  # economics must never fail /stats
                log.exception("economics snapshot failed for %s", mv.ref)
                econ = None
            batcher = mv.batcher
            pad = (batcher.stats().get("padding") or None) if batcher is not None else None
            if econ is None and pad is None:
                continue
            entry = econ if econ is not None else {}
            if pad is not None:
                entry["padding"] = pad
            out[mv.ref] = entry
        return out

    # --------------------------------------------------------- observability

    def _metrics(self) -> str:
        """Every counter, gauge and histogram as Prometheus text under the
        reference's family names. The span families come from one
        Observability snapshot, so the +Inf count of
        ``request_duration_seconds`` equals ``requests_total`` summed over
        status classes."""
        p = PromText()
        mv0 = self.registry.default_entry()  # resolved once: a swap may drain it meanwhile
        batcher = mv0.batcher if mv0 is not None else None
        obs = self.obs.snapshot()
        p.scalar("uptime_seconds", obs["uptime_s"],
                 help_="Seconds since this app started (monotonic).")
        for klass in sorted(obs["requests_by_status"]):
            p.scalar("requests_total", obs["requests_by_status"][klass], mtype="counter",
                     labels={"status": klass}, help_="Finished HTTP requests by status class.")
        p.histogram("request_duration_seconds", obs["e2e"],
                    help_="End-to-end request latency (span total).")
        for stage in sorted(obs["stages"]):
            p.histogram("stage_duration_seconds", obs["stages"][stage], labels={"stage": stage},
                        help_="Per-stage request latency (span stages).")
        if batcher is not None:
            bs = batcher.stats()
            snap = bs["rolling"]
            p.scalar("inferences_total", snap["requests_total"], mtype="counter",
                     help_="Images through the batcher (incl. errors).")
            p.scalar("inference_errors_total", snap["errors_total"], mtype="counter",
                     help_="Failed batcher requests.")
            p.scalar("batches_dispatched_total", snap["batches_dispatched_total"],
                     mtype="counter", help_="Device batches dispatched.")
            if snap["batch_occupancy"] is not None:
                p.scalar("batch_occupancy", snap["batch_occupancy"],
                         help_="Real rows / bucket rows, rolling window.")
            p.scalar("queue_depth", batcher.queue_depth,
                     help_="Leased-but-undispatched batch slots (assembly backlog).")
            p.scalar("batch_delay_seconds", bs["current_delay_ms"] / 1e3,
                     help_="Live adaptive batch-assembly window.")
            p.scalar("builders_open", bs["open_builders"],
                     help_="Batch builders assembling (open + sealing).")
            p.scalar("batches_sealed_total", bs["sealed"] + bs["discarded"], mtype="counter",
                     help_="Batch builders sealed and dispatched or discarded.")
            p.scalar("lease_timeouts_total", bs["lease_timeouts"], mtype="counter",
                     help_="Slot leases force-expired (lessee died or exceeded the lease "
                     "timeout).")
            p.scalar("batch_holes_total", bs["holes"], mtype="counter",
                     help_="Batch slots dispatched as holes (released, failed, or expired "
                     "leases).")
            p.scalar("pipeline_depth", bs["pipeline_depth"],
                     help_="Configured batches in flight per canvas bucket "
                     "(sealed->launched->unfetched).")
            p.scalar("pipeline_inflight_batches", bs["inflight"],
                     help_="Batches currently in flight on the device pipeline (launched, "
                     "outputs not yet fetched).")
            p.scalar("backlog_rejections_total", bs["backlog_rejects"], mtype="counter",
                     help_="Requests fast-rejected with 503 because the batcher backlog hit "
                     "max_queue.")
            p.scalar("deadline_sheds_total", bs["deadline_sheds_total"], mtype="counter",
                     help_="Requests shed at admission because the expected wait exceeded "
                     "their deadline.")
            p.scalar("deadline_seal_sheds_total", bs["deadline_seal_sheds_total"],
                     mtype="counter", help_="Leases shed at batch seal: the deadline passed "
                     "while the slot waited for dispatch.")
            p.scalar("quota_sheds_total", bs["quota_sheds_total"], mtype="counter",
                     help_="Requests shed by per-tenant token-bucket quota (answered 429).")
        a = self.admission.stats()
        for tname, t in a["tenants"].items():
            p.scalar("tenant_admitted_total", t["admitted"], mtype="counter",
                     labels={"tenant": tname}, help_="Requests admitted, by tenant.")
            for reason in sorted(t["shed"]):
                p.scalar("tenant_shed_total", t["shed"][reason], mtype="counter",
                         labels={"tenant": tname, "reason": reason},
                         help_="Requests shed, by tenant and reason.")
        for cname, c in a["classes"].items():
            p.scalar("slo_class_admitted_total", c["admitted"], mtype="counter",
                     labels={"slo_class": cname}, help_="Requests admitted, by SLO class.")
            for reason in sorted(c["shed"]):
                p.scalar("slo_class_shed_total", c["shed"][reason], mtype="counter",
                         labels={"slo_class": cname, "reason": reason},
                         help_="Requests shed, by SLO class and reason.")
        pr = self.pressure.stats()
        p.scalar("pressure_level", pr["level"],
                 help_="Degradation-ladder rung (0 = normal service).")
        p.scalar("pressure_transitions_total", pr["transitions_total"], mtype="counter",
                 help_="Degradation-ladder rung transitions.")
        if self.chaos is not None:
            ch = self.chaos.stats()
            for k in ("decode_failures_injected", "dispatch_failures_injected",
                      "slow_fetches_injected", "spike_holds_injected"):
                p.scalar(f"chaos_{k}_total", ch[k], mtype="counter",
                         help_="Chaos-injector fault injections.")
        if self.http_counters is not None:
            h = self.http_counters.snapshot()
            p.scalar("http_connections_total", h["connections_total"], mtype="counter",
                     help_="TCP connections accepted.")
            p.scalar("http_requests_total", h["requests_total"], mtype="counter",
                     help_="HTTP requests served (all routes).")
            p.scalar("http_active_connections", h["active_connections"],
                     help_="Currently open connections.")
        engine = mv0.engine if mv0 is not None else None
        if hasattr(engine, "staging_stats"):
            st = engine.staging_stats()
            p.scalar("staging_slab_allocs_total", st["slab_allocs_total"], mtype="counter",
                     help_="Lifetime staging-slab allocations.")
            p.scalar("staging_slabs_pooled", st["slabs_pooled"],
                     help_="Idle staging slabs in the pool.")
            p.scalar("staging_pooled_bytes", st["slabs_pooled_bytes"],
                     help_="Host bytes held by idle staging slabs.")
        reg = self.registry.models_snapshot()
        for name, info in reg["models"].items():
            for v in info["versions"]:
                p.scalar("model_state", 1,
                         labels={"model": name, "version": v["version"], "state": v["state"]},
                         help_="Lifecycle state per model version (enum: the current state's "
                         "sample is 1).")
        p.scalar("model_swaps_total", reg["swaps_total"], mtype="counter",
                 help_="Hot-swap requests accepted by the registry.")
        p.scalar("model_loads_failed_total", reg["loads_failed_total"], mtype="counter",
                 help_="Model loads that FAILED (build or warmup).")
        peak_done: set = set()  # each dtype's peak pair once a scrape
        for mv in self.registry.serving_entries():
            mb = mv.batcher
            if mb is None:
                continue
            mbs = mb.stats()
            ms = mbs["rolling"]
            labels = {"model": mv.name, "version": mv.version}
            p.scalar("model_inferences_total", ms["requests_total"], mtype="counter",
                     labels=labels, help_="Images through this model's batcher (incl. errors).")
            p.scalar("model_inference_errors_total", ms["errors_total"], mtype="counter",
                     labels=labels, help_="Failed requests on this model's batcher.")
            p.scalar("model_latency_p50_seconds", ms["latency_ms"]["p50"] / 1e3, labels=labels,
                     help_="Rolling p50 latency through this model's batcher.")
            p.scalar("model_queue_depth", mb.queue_depth, labels=labels,
                     help_="This model's leased-but-undispatched slots.")
            p.scalar("model_backlog_rejections_total", mbs["backlog_rejects"],
                     mtype="counter", labels=labels,
                     help_="503 fast-rejects on this model's bounded queue.")
            p.scalar("model_pipeline_inflight_batches", mbs["inflight"], labels=labels,
                     help_="This model's batches in flight on the device pipeline.")
            p.scalar("model_inflight_requests", mv.inflight, labels=labels,
                     help_="HTTP requests currently holding this version.")
            # per replica of the placement: dispatches, slab bytes in flight
            # and busy seconds; rate(busy) over wall is each group's busy share
            est = getattr(mv.engine, "staging_stats", None)
            for rep in (est()["replicas"] if est is not None else []):
                rl = dict(labels, replica=rep["replica"])
                p.scalar("model_replica_dispatches_total", rep["dispatches_total"],
                         mtype="counter", labels=rl,
                         help_="Batches dispatched to this placement replica.")
                p.scalar("model_replica_dispatches_inflight", rep["dispatches_inflight"],
                         labels=rl, help_="Batches in flight on this placement replica "
                         "(dispatched, outputs not yet fetched).")
                p.scalar("model_replica_slab_bytes_inflight", rep["slab_bytes_inflight"],
                         labels=rl, help_="Staging-slab bytes owned by this replica's "
                         "in-flight batches (slab occupancy per replica).")
                p.scalar("model_replica_busy_seconds_total", rep["busy_s"], mtype="counter",
                         labels=rl, help_="Cumulative device seconds on this replica: CUDA "
                         "events around each batch's compute on its stream (an interval "
                         "sum; concurrent replicas' intervals overlap).")
            self._econ_metrics(p, mv, mbs, peak_done)
        c = self.cache.stats()
        p.scalar("cache_hits_total", c["hits_total"], mtype="counter",
                 help_="Requests served from the response cache.")
        p.scalar("cache_misses_total", c["misses_total"], mtype="counter",
                 help_="Cache lookups that led a fresh computation.")
        p.scalar("cache_coalesced_total", c["coalesced_total"], mtype="counter",
                 help_="Requests coalesced onto another request's in-flight computation "
                 "(single-flight dedup).")
        p.scalar("cache_evictions_total", c["evictions_total"], mtype="counter",
                 help_="Entries evicted by the LRU byte budget.")
        p.scalar("cache_invalidations_total", c["invalidations_total"], mtype="counter",
                 help_="Entries dropped by model retire (hot-swap/unload).")
        p.scalar("cache_bytes", c["bytes"],
                 help_="Bytes held by cached responses (budget: --cache-bytes; 0 = cache "
                 "disabled).")
        p.scalar("cache_entries", c["entries"], help_="Live cached responses.")
        p.scalar("cache_inflight", c["inflight"],
                 help_="Single-flight computations currently in flight.")
        ac = aotcache.stats()
        p.scalar("aot_cache_hits_total", ac["hits_total"], mtype="counter",
                 help_="Kernel libraries loaded from the build cache instead of built.")
        p.scalar("aot_cache_misses_total", ac["misses_total"], mtype="counter",
                 help_="Build-cache lookups that fell through to nvcc.")
        p.scalar("aot_cache_writes_total", ac["writes_total"], mtype="counter",
                 help_="Freshly built kernel libraries written to the build cache.")
        p.scalar("aot_cache_corrupt_total", ac["corrupt_total"], mtype="counter",
                 help_="Build-cache entries rejected as unusable; each fell back to nvcc.")
        p.scalar("aot_cache_bytes_total", ac["bytes_written_total"], mtype="counter",
                 help_="Bytes of kernel libraries written to the build cache.")
        for name, mc in c["per_model"].items():
            ml = {"model": name}
            p.scalar("model_cache_hits_total", mc["hits"], mtype="counter", labels=ml,
                     help_="Cache hits for this model.")
            p.scalar("model_cache_misses_total", mc["misses"], mtype="counter", labels=ml,
                     help_="Cache misses for this model.")
            p.scalar("model_cache_coalesced_total", mc["coalesced"], mtype="counter",
                     labels=ml, help_="Coalesced (single-flight) waits for this model.")
            p.scalar("model_cache_bytes", mc["bytes"], labels=ml,
                     help_="Bytes of this model's cached responses.")
        if self.jobs is not None:
            js = self.jobs.stats()
            for state in ("QUEUED", "RUNNING", "PAUSED", "DONE", "FAILED", "CANCELLED"):
                p.scalar("jobs", js["by_state"].get(state, 0), labels={"state": state},
                         help_="Bulk jobs by lifecycle state.")
            p.scalar("job_images_done_total", js["images_done_total"], mtype="counter",
                     help_="Images completed (spooled) across all jobs.")
            p.scalar("job_images_cached_total", js["images_cached_total"], mtype="counter",
                     help_="Job images served from (or coalesced onto) the response cache "
                     "instead of a bulk dispatch.")
            p.scalar("job_image_errors_total", js["image_errors_total"], mtype="counter",
                     help_="Job images that ended as error lines (undecodable, unreadable, "
                     "retries exhausted).")
            p.scalar("job_chunks_total", js["chunks_total"], mtype="counter",
                     help_="Completed-and-checkpointed job chunks.")
            p.scalar("job_cache_hits_total", c["bulk"]["hits_total"], mtype="counter",
                     help_="Bulk-tier response-cache hits (job lookups are counted apart "
                     "from the interactive tier).")
        self._pipeline_metrics(p)
        if self.telemetry is not None:
            self._telemetry_metrics(p)
        return p.render()

    def _pipeline_metrics(self, p: PromText) -> None:
        """The ``tpu_serve_pipeline_*`` families: the catalog's swap-driven
        re-resolutions, per pipeline its requests, errors and windowed e2e
        percentiles, per stage its seconds, images, cache hits and D2H
        bytes (a stage's span latency is ``stage_duration_seconds{stage=
        "pipeline.<model>"}``)."""
        ps = self.pipelines.pipeline_stats()
        p.scalar("pipeline_resolutions_total", ps["resolutions_total"], mtype="counter",
                 help_="Pipeline re-resolutions triggered by stage-model serving/retire "
                 "transitions.")
        for name in sorted(ps["pipelines"]):
            st = ps["pipelines"][name]
            pl = {"pipeline": name}
            p.scalar("pipeline_requests_total", st["requests_total"], mtype="counter",
                     labels=pl, help_="Pipeline executions (all outcomes).")
            p.scalar("pipeline_errors_total", st["errors_total"], mtype="counter", labels=pl,
                     help_="Pipeline executions that raised.")
            for q, key in (("p50", "e2e_p50_s"), ("p99", "e2e_p99_s")):
                if st[key] is not None:
                    p.scalar(f"pipeline_e2e_{q}_seconds", st[key], labels=pl,
                             help_="Windowed pipeline end-to-end latency (last 512 requests).")
            for stage in sorted(st["stages"]):
                sl = {"pipeline": name, "stage": stage}
                sc = st["stages"][stage]
                p.scalar("pipeline_stage_seconds_total", sc["seconds"], mtype="counter",
                         labels=sl, help_="Wall seconds attributed to this stage (dispatch "
                         "through result).")
                p.scalar("pipeline_stage_images_total", sc["images"], mtype="counter",
                         labels=sl, help_="Images (stage 1) or crops (later stages) through "
                         "this stage.")
                p.scalar("pipeline_stage_cache_hits_total", sc["cache_hits"], mtype="counter",
                         labels=sl, help_="Per-stage response-cache hits.")
                p.scalar("pipeline_stage_d2h_bytes_total", sc["d2h_bytes"], mtype="counter",
                         labels=sl, help_="Device-to-host bytes this stage actually converted "
                         "(payload rows, not padded buckets).")

    def _telemetry_metrics(self, p: PromText) -> None:
        ts = self.telemetry.stats()
        p.scalar("telemetry_memory_bytes", ts["memory_bytes"],
                 help_="Live bytes held by the telemetry history rings (fixed arrays; "
                 "bounded by series cap x resolutions).")
        p.scalar("telemetry_series", ts["series_count"],
                 help_="Named series currently held by the telemetry rings.")
        p.scalar("telemetry_samples_total", ts["samples_total"], mtype="counter",
                 help_="Completed telemetry sampler ticks.")
        p.scalar("telemetry_overruns_total", ts["overruns_total"], mtype="counter",
                 help_="Sampler ticks that took longer than the sample interval.")
        for name, al in sorted(ts["slo"].items()):
            for window, burn in sorted(al["burn"].items()):
                p.scalar("slo_burn_rate", burn, labels={"class": name, "window": window},
                         help_="SLO error-budget burn rate per objective and window (1.0 = "
                         "burning exactly the budget; the fast pair pages at 14.4, the slow "
                         "window at 6).")
            p.scalar("slo_alert_firing", al["state"] == "firing", labels={"class": name},
                     help_="1 while the objective's multi-window burn-rate alert is firing, "
                     "else 0.")

    def _econ_metrics(self, p: PromText, mv, bstats: dict, peak_done: set) -> None:
        """One serving version's economics: MFU, and per (canvas, batch
        bucket) cell its device seconds, rows, achieved FLOP/s, MFU,
        arithmetic intensity and roofline fraction; the batcher's padding
        counters; the card's peak per serving dtype, once a scrape."""
        if not hasattr(mv.engine, "econ_stats"):
            return
        try:
            econ = costmodel.economics_snapshot(mv.engine, mv.model_cfg)
        except Exception:  # economics must never fail a scrape
            log.exception("economics metrics failed for %s", mv.ref)
            return
        if not econ:
            return
        base = {"model": mv.name, "version": mv.version, "dtype": econ["dtype"]}
        if "mfu" in econ:
            p.scalar("model_mfu", econ["mfu"], labels=base,
                     help_="Whole-model FLOP utilization: useful FLOP/s over measured device "
                     "time, against the card's peak (spec table; CPU: calibrated once).")
        p.scalar("model_padded_rows_fraction", econ["padded_rows_fraction"], labels=base,
                 help_="Lifetime fraction of dispatched batch rows that carried no request.")
        for rep in econ["replicas"]:
            for cell in rep["buckets"]:
                cl = dict(base, replica=rep["replica"], canvas=cell["canvas"],
                          bucket=cell["batch_bucket"])
                p.scalar("model_econ_device_seconds_total", cell["device_s"], mtype="counter",
                         labels=cl, help_="Measured device seconds per (replica, canvas, "
                         "batch bucket) cell (CUDA events on the card).")
                p.scalar("model_econ_rows_total", cell["rows"], mtype="counter", labels=cl,
                         help_="Rows staged (requests + holes) per economics cell.")
                p.scalar("model_econ_rows_dispatched_total", cell["rows_dispatched"],
                         mtype="counter", labels=cl,
                         help_="Rows the bucket shape dispatched per economics cell.")
                if cell.get("achieved_flops") is None:
                    continue
                p.scalar("model_achieved_flops", cell["achieved_flops"], labels=cl,
                         help_="Useful FLOP/s achieved in this cell.")
                p.scalar("model_cell_mfu", cell["mfu"], labels=cl,
                         help_="This cell's useful FLOP/s over the card's peak.")
                p.scalar("model_arithmetic_intensity", cell["arithmetic_intensity"], labels=cl,
                         help_="Analytic FLOPs per memory byte at this (canvas, batch) point.")
                if cell.get("roofline_bound_fraction") is not None:
                    p.scalar("model_roofline_bound_fraction", cell["roofline_bound_fraction"],
                             labels=cl, help_="Achieved FLOP/s over the BINDING roofline "
                             "ceiling (compute peak or AI x bandwidth, whichever is lower).")
        for cell in (bstats.get("padding") or {}).values():
            cl = dict(base, canvas=cell["canvas"], bucket=cell["batch_bucket"])
            p.scalar("model_padding_rows_real_total", cell["rows_real"], mtype="counter",
                     labels=cl, help_="Dispatched rows that carried a committed request.")
            p.scalar("model_padding_rows_dispatched_total", cell["rows_dispatched"],
                     mtype="counter", labels=cl,
                     help_="Rows dispatched at the batch-bucket shape.")
            p.scalar("model_padding_px_real_total", cell["px_real"], mtype="counter",
                     labels=cl, help_="Real image pixels shipped.")
            p.scalar("model_padding_px_dispatched_total", cell["px_dispatched"],
                     mtype="counter", labels=cl, help_="Canvas pixels shipped (incl. padding).")
        peak = econ["peak"]
        dtype = base["dtype"]
        if ("peak", dtype) not in peak_done:
            peak_done.add(("peak", dtype))
            dl = {"dtype": dtype}
            p.scalar("device_peak_flops_per_chip", peak["flops_per_chip"], labels=dl,
                     help_="Peak FLOP/s the MFU gauges divide by at this serving dtype (card: "
                     "spec table, float32 on the CUDA cores, int8 at bf16's; CPU: "
                     "calibrated once per compute dtype).")
            p.scalar("device_peak_hbm_bytes_per_s_per_chip", peak["hbm_bytes_per_s_per_chip"],
                     labels=dl, help_="Peak memory bandwidth for the roofline ridge point.")

    def _history(self, environ):
        """GET /debug/history?series=a,b&last_s=N&res=1s|10s|60s: bounded
        rows from the telemetry rings; without ``series``, their names."""
        if self.telemetry is None:
            return _error(404, "telemetry disabled (--telemetry-interval 0)")
        qs = urllib.parse.parse_qs(environ.get("QUERY_STRING", ""), keep_blank_values=True)
        try:
            raw = _qs_last(qs, "last_s")
            last_s = float(raw) if raw is not None else 300.0
        except ValueError:
            return _error(400, "last_s must be a number")
        names_raw = _qs_last(qs, "series")
        if not names_raw:
            return _json(200, {"series": self.telemetry.series_names(),
                               "hint": "GET /debug/history?series=a,b&last_s=300&res=10s"})
        names = [n for n in names_raw.split(",") if n]
        if len(names) > 16:
            return _error(400, "at most 16 series per query")
        try:
            doc = self.telemetry.query(names, last_s=last_s, res=_qs_last(qs, "res") or None)
        except KeyError as e:
            return _json(400, {"error": f"unknown series {e.args[0]!r}",
                               "series": self.telemetry.series_names()})
        except ValueError as e:
            return _error(400, str(e))
        return _json(200, doc)

    def _events(self, environ):
        """GET /debug/events?last_s=N&kind=a,b: the event ring, newest last."""
        if self.telemetry is None:
            return _error(404, "telemetry disabled (--telemetry-interval 0)")
        qs = urllib.parse.parse_qs(environ.get("QUERY_STRING", ""), keep_blank_values=True)
        try:
            raw = _qs_last(qs, "last_s")
            last_s = float(raw) if raw is not None else None
        except ValueError:
            return _error(400, "last_s must be a number")
        kinds_raw = _qs_last(qs, "kind")
        kinds = {k for k in kinds_raw.split(",") if k} if kinds_raw else None
        return _json(200, {"now": round(time.monotonic(), 3), "clock": "monotonic",
                           "events": self.telemetry.events(last_s, kinds)})

    def _trace_export(self, environ):
        """GET /debug/trace?last_s=N: every serving version's batch
        timeline, the flight recorder's recent spans and the telemetry
        events as Chrome-trace JSON, over the effective window it reports."""
        qs = urllib.parse.parse_qs(environ.get("QUERY_STRING", ""), keep_blank_values=True)
        try:
            raw = _qs_last(qs, "last_s")
            requested_s = float(raw) if raw is not None else None
        except ValueError:
            return _error(400, "last_s must be a number")
        last_s = effective_window(requested_s, self.obs.flight.retention_s())
        models = [{"name": mv.ref, "timeline": mv.batcher.batch_timeline()}
                  for mv in self.registry.serving_entries() if mv.batcher is not None]
        events = self.telemetry.events(last_s) if self.telemetry is not None else None
        doc = chrome_trace(models, self.obs.flight.trace_records(last_s), last_s=last_s,
                           instants=events)
        doc["otherData"]["requested_window_s"] = requested_s
        doc["otherData"]["effective_window_s"] = last_s
        return _json(200, doc)

    def _profile(self, environ):
        """POST /debug/trace?ms=N&dir=D: ``torch.profiler`` (CPU, and CUDA
        activities on the card) for N ms (default 1,000, at most 60,000),
        exported as a Chrome trace into D (default ``tpu_serve_trace`` in
        the temporary directory). One capture at a time: a second answers
        409 while the first runs."""
        qs = urllib.parse.parse_qs(environ.get("QUERY_STRING", ""), keep_blank_values=True)
        try:
            raw = _qs_last(qs, "ms")
            ms = max(0, min(int(raw) if raw is not None else 1000, MAX_TRACE_MS))
        except ValueError:
            return _error(400, "ms must be an integer")
        out_dir = _qs_last(qs, "dir") or os.path.join(tempfile.gettempdir(), "tpu_serve_trace")
        if not _PROFILE_LOCK.acquire(blocking=False):
            return _error(409, "a profiler capture is already running")
        try:
            import torch
            from torch.profiler import ProfilerActivity, profile

            os.makedirs(out_dir, exist_ok=True)
            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            prof = profile(activities=activities)
            # no serving thread in a CUDA call while the profiler starts
            # and stops (engine.quiesced); batches run in between
            with quiesced():
                prof.start()
            try:
                time.sleep(ms / 1e3)
            finally:
                with quiesced():
                    prof.stop()
            path = os.path.join(out_dir, f"trace-{os.getpid()}-{time.monotonic_ns()}.json")
            prof.export_chrome_trace(path)
        finally:
            _PROFILE_LOCK.release()
        return _json(200, {"trace_dir": out_dir, "trace_file": path, "captured_ms": ms,
                           "activities": [a.name for a in activities]})

    def _admin_models(self, environ, method: str, path: str):
        """POST /models/{load,swap,unload}: a JSON body in, the affected
        version's (name, version, state) out. Loads and swaps run on the
        registry's loader thread; ``"wait": true`` holds the answer until
        the version reaches a terminal state (200), else 202."""
        if method != "POST":
            return _error(405, "POST required")
        body = self._read_body(environ)
        if body is None:
            return _error(413, "body too large")
        try:
            d = json.loads(body or b"{}")
            if not isinstance(d, dict):
                raise ValueError("body must be a JSON object")
        except ValueError as e:
            return _error(400, f"bad JSON body: {e}")
        wait = bool(d.get("wait", False))
        try:
            timeout = float(d.get("timeout_s", 600.0))
            if path == "/models/load":
                spec = d.get("model")
                if not spec:
                    return _error(400, "'model' (preset name, native:<zoo>, .pb/.json path) is required")
                mv = self.registry.load(spec, name=d.get("name"),
                                        activate=bool(d.get("activate", True)),
                                        wait=wait, timeout=timeout)
            elif path == "/models/swap":
                mv = self.registry.swap(d.get("name"), d.get("model"), wait=wait,
                                        timeout=timeout)
            else:  # /models/unload
                name = d.get("name")
                if not name:
                    return _error(400, "'name' is required")
                version = d.get("version")
                mv = self.registry.unload(name, int(version) if version is not None else None,
                                          wait=wait, timeout=timeout)
        except UnknownModel as e:
            return _error(404, str(e.args[0] if e.args else e))
        except ModelNotServing as e:
            # the model exists but is in the wrong state for this action
            return _error(409, str(e))
        except RuntimeError as e:
            # "registry is stopped": the process is draining
            return _error(503, str(e))
        except TimeoutError as e:
            return _error(504, str(e))
        except (TypeError, ValueError, OSError) as e:
            # OSError: a spec naming a missing or unreadable .json
            return _error(400, f"{type(e).__name__}: {e}")
        resp = {"name": mv.name, "version": mv.version, "state": mv.state}
        if mv.error:
            resp["error"] = mv.error
        code = 500 if mv.state == FAILED else 200 if wait else 202
        return _json(code, resp)

    # ------------------------------------------------------------------ jobs

    def _jobs_route(self, environ, method: str, path: str):
        """``/jobs``, ``/jobs/{id}``, ``/jobs/{id}/results`` and
        ``/jobs/{id}/cancel``; as open as the admin ``/models`` routes."""
        if self.jobs is None:
            return _error(503, "bulk jobs disabled; start the server with --jobs-dir")
        parts = [p for p in path.split("/") if p]  # ["jobs", id?, verb?]
        try:
            if len(parts) == 1:
                if method == "POST":
                    return self._jobs_submit(environ)
                if method == "GET":
                    return _json(200, {"jobs": self.jobs.list_jobs()})
                return _error(405, "GET or POST")
            job_id = parts[1]
            if len(parts) == 2 and method == "GET":
                return _json(200, self.jobs.get_job(job_id))
            if len(parts) == 3 and parts[2] == "results" and method == "GET":
                return self._jobs_results(environ, job_id)
            if len(parts) == 3 and parts[2] == "cancel" and method == "POST":
                return _json(200, self.jobs.cancel_job(job_id))
        except UnknownJob as e:
            return _error(404, str(e.args[0] if e.args else e))
        return _error(404, "not found")

    def _jobs_submit(self, environ):
        """``POST /jobs``: a multipart upload (its file parts are the
        manifest) or a JSON body naming a server-side directory; 202 and the
        job's document, the runner going on in the background."""
        qs = urllib.parse.parse_qs(environ.get("QUERY_STRING", ""), keep_blank_values=True)
        model = _qs_last(qs, "model")
        try:
            topk_raw = _qs_last(qs, "topk")
            topk = int(topk_raw) if topk_raw is not None else None
        except ValueError:
            return _error(400, "topk must be an integer")
        # the tenant's token bucket pays for the job's batches; the weight
        # orders the runner's queue (heavier first)
        tenant = (environ.get("HTTP_X_TENANT") or "").strip()[:64] or DEFAULT_TENANT
        try:
            weight = float(_qs_last(qs, "weight") or 1.0)
        except ValueError:
            return _error(400, "weight must be a number")
        body = self._read_body(environ)
        if body is None:
            return _error(413, f"body exceeds {self.cfg.max_body_mb} MB cap")
        ctype_in = environ.get("CONTENT_TYPE", "")
        try:
            if ctype_in.startswith("multipart/form-data"):
                files = _parse_multipart_files(body, ctype_in)
                if not files:
                    return _error(400, "no file parts in multipart body")
                job = self.jobs.submit_upload(files, model, topk, tenant=tenant, weight=weight)
            else:
                try:
                    d = json.loads(body or b"{}")
                    if not isinstance(d, dict):
                        raise ValueError("body must be a JSON object")
                except ValueError as e:
                    return _error(400, f"bad JSON body: {e}")
                src = d.get("dir")
                if not src:
                    return _error(400, "send a multipart upload or a JSON body with 'dir' "
                                  "(server-side path)")
                # the same gates as the query string's: a bad value answers
                # 400 here, never a 202 that FAILS at the first chunk
                try:
                    body_topk = d.get("topk", topk)
                    body_topk = int(body_topk) if body_topk is not None else None
                except (TypeError, ValueError):
                    return _error(400, "topk must be an integer")
                try:
                    body_weight = float(d.get("weight", weight))
                except (TypeError, ValueError):
                    return _error(400, "weight must be a number")
                job = self.jobs.submit_dir(
                    str(src), d.get("model", model), body_topk, glob=str(d.get("glob", "*")),
                    recursive=bool(d.get("recursive", False)),
                    tenant=str(d.get("tenant", tenant))[:64] or tenant, weight=body_weight)
        except UnknownModel as e:
            return _error(404, str(e.args[0] if e.args else e))
        except ValueError as e:
            return _error(400, str(e))
        doc = job.snapshot()
        doc["results_url"] = f"/jobs/{job.id}/results"
        return _json(202, doc)

    def _jobs_results(self, environ, job_id: str):
        """``GET /jobs/{id}/results``: JSON lines from ``offset``, the resume
        cursor and the live state in headers (re-poll with
        ``X-Job-Next-Offset`` until ``X-Job-Complete: 1``)."""
        qs = urllib.parse.parse_qs(environ.get("QUERY_STRING", ""), keep_blank_values=True)
        try:
            offset = int(_qs_last(qs, "offset") or 0)
            limit = min(int(_qs_last(qs, "limit") or 10_000), 100_000)
            wait_s = min(float(_qs_last(qs, "wait_s") or 0.0), 30.0)
        except ValueError:
            return _error(400, "offset/limit must be integers, wait_s a number")
        lines, next_offset, state, total_lines = self.jobs.read_results(
            job_id, offset=offset, limit=limit, wait_s=wait_s)
        body = b"\n".join(lines) + (b"\n" if lines else b"")
        done = state in ("DONE", "FAILED", "CANCELLED") and next_offset >= total_lines
        headers = [("X-Job-State", state), ("X-Job-Next-Offset", str(next_offset)),
                   ("X-Job-Result-Lines", str(total_lines)),
                   ("X-Job-Complete", "1" if done else "0")]
        return "200 OK", body, "application/x-ndjson", headers

    def _pipeline_predict(self, environ, name: str):
        """POST /pipelines/{name}: one image through a pipeline DAG as one
        request. The body forms of /predict, but exactly one image;
        ``?topk=`` clamps against the last stage's model. The ETag is the
        last stage's cache identity, so ``If-None-Match`` works across the
        composition as it does for one model."""
        t0 = time.monotonic()
        span = environ.get("tpu_serve.span") or Span()
        qs = urllib.parse.parse_qs(environ.get("QUERY_STRING", ""), keep_blank_values=True)
        try:
            topk_raw = _qs_last(qs, "topk")
            topk_req = int(topk_raw) if topk_raw is not None else None
        except ValueError:
            return _error(400, "topk must be an integer")
        body = self._read_body(environ)
        span.add("body_read", time.monotonic() - t0)
        if body is None:
            return _error(413, f"body exceeds {self.cfg.max_body_mb} MB cap")
        ctype = environ.get("CONTENT_TYPE", "")
        if ctype.startswith("multipart/form-data"):
            named = _parse_multipart_files(body, ctype)
            if len(named) != 1:
                return _error(400, f"pipelines take exactly one image per request, got "
                                   f"{len(named)}")
            data = named[0][1]
        else:
            data = body
        if not data:
            return _error(400, "empty request body")
        try:
            payload, etag, meta = self.pipelines.execute(
                name, data, topk_req, span, deadline_s=self.cfg.request_timeout_s)
        except KeyError:
            return _json(404, {"error": f"unknown pipeline '{name}'",
                               "pipelines": self.pipelines.names()})
        except PipelineUnavailable as e:
            return _error(503, str(e))
        except ValueError as e:
            return _error(400, str(e))
        headers = [("ETag", f'"{etag}"')]
        if _etag_matches(environ.get("HTTP_IF_NONE_MATCH"), etag):
            return _STATUS[304], b"", "application/json", headers
        resp = dict(payload)
        resp["pipeline"] = name
        resp["stages"] = meta["stages"]
        resp["latency_ms"] = round((time.monotonic() - t0) * 1e3, 3)
        resp["trace_id"] = span.trace_id
        return _json(200, resp, headers)

    def _read_body(self, environ) -> bytes | None:
        """The request body; None when it exceeds the cap. The declared
        Content-Length gates before anything is read, and the read itself is
        capped, so an under-declaring client cannot stream more."""
        cap = int(self.cfg.max_body_mb * 1e6)
        try:
            length = int(environ.get("CONTENT_LENGTH") or 0)
        except ValueError:
            length = -1
        if length < 0 or length > cap:
            # a garbage or negative length is refused: read(-1) would buffer
            # the whole stream
            return None
        body = environ["wsgi.input"].read(min(length, cap + 1)) if length else b""
        return None if len(body) > cap else body

    def _predict(self, environ):
        t0 = time.monotonic()
        # the fresh span serves direct callers only; theirs go unaggregated
        span = environ.get("tpu_serve.span") or Span()
        qs = urllib.parse.parse_qs(environ.get("QUERY_STRING", ""), keep_blank_values=True)
        # Tenant, SLO class and deadline come first: a malformed deadline
        # answers 400 before the body is read. The client's deadline counts
        # from receipt (its budget includes the upload); only a request that
        # names a class or a deadline is bounded by one.
        tenant = (environ.get("HTTP_X_TENANT") or "").strip()[:64] or DEFAULT_TENANT
        raw_slo = (_qs_last(qs, "slo") or environ.get("HTTP_X_SLO") or "").strip()
        slo_class = raw_slo or "interactive"
        raw_deadline = _qs_last(qs, "deadline_ms") or environ.get("HTTP_X_DEADLINE_MS")
        try:
            deadline_ms = float(raw_deadline) if raw_deadline else None
        except ValueError:
            return _error(400, "deadline_ms must be a number")
        explicit = deadline_ms is not None and deadline_ms > 0
        if not explicit:
            deadline_ms = 1e3 * self.slo_classes.get(slo_class,
                                                     self.slo_classes.get("interactive", 1.0))
        slo_deadline = t0 + deadline_ms / 1e3 if (explicit or raw_slo) else None
        spec = _qs_last(qs, "model")

        def resolve():
            try:
                return self.registry.acquire(spec), None
            except UnknownModel as e:
                return None, _error(404, str(e.args[0] if e.args else e))
            except ModelNotServing as e:
                return None, _error(503, str(e))

        # Resolve the model before the body is read, and hold an in-flight
        # reference: a swap started mid-request drains the old version only
        # after this reference drops.
        mv, err = resolve()
        if err is not None:
            return err
        try:
            topk_raw = _qs_last(qs, "topk")
            try:
                topk_req = int(topk_raw) if topk_raw is not None else None
            except ValueError:
                return _error(400, "topk must be an integer")
            body = self._read_body(environ)
            span.add("body_read", time.monotonic() - t0)
            if body is None:
                return _error(413, f"body exceeds {self.cfg.max_body_mb} MB cap")
            ctype = environ.get("CONTENT_TYPE", "")
            if ctype.startswith("multipart/form-data"):
                named = _parse_multipart_files(body, ctype)
                if not named:
                    return _error(400, "no file part in multipart body")
            else:
                named = [("body", body)]
            inm = environ.get("HTTP_IF_NONE_MATCH")
            if self.chaos is not None:  # a load spike, held against the client's deadline
                hold = self.chaos.spike_delay()
                if hold > 0.0:
                    time.sleep(hold)
            # one bound for both attempts, from after the body read; the
            # client's deadline tightens it
            deadline = time.monotonic() + self.cfg.request_timeout_s
            if slo_deadline is not None:
                deadline = min(deadline, slo_deadline)
            last_exc: BaseException | None = None
            for _attempt in (0, 1):
                if mv is None:  # the retry re-resolves: the new version after a swap
                    mv, err = resolve()
                    if err is not None:
                        return err
                try:
                    span.note("model", mv.ref)
                    res = self._predict_on(mv, named, qs, topk_req, inm, deadline, tenant,
                                           slo_class, slo_deadline, span, t0)
                    if res[0].startswith(("2", "304")):
                        self.admission.count_admit(tenant, slo_class)
                    return res
                except _CoalesceRetry as e:
                    last_exc = e.__cause__ or e
                finally:
                    self.registry.release(mv)
                    mv = None
            return _error(503, "coalesced computation aborted twice: "
                               f"{type(last_exc).__name__}: {last_exc}")
        finally:
            if mv is not None:  # an answer before the attempts
                self.registry.release(mv)

    def _predict_on(self, mv, named: list[tuple[str, bytes]], qs, topk_req: int | None, inm,
                    deadline: float, tenant: str, slo_class: str, slo_deadline: float | None,
                    span: Span, t0: float):
        """The /predict body against one resolved model version: one ladder
        step, stage every upload (a cached answer, a wait on another
        request's flight, or a leased slot of its own), then await the rows
        until ``deadline``. ``span`` gets ``cache_wait``, ``postprocess``
        and ``serialize``; a 200's ``latency_ms`` counts from ``t0``, the
        request's receipt."""
        batcher, engine = mv.batcher, mv.engine
        if batcher is None:
            return _error(503, f"{mv.ref} has no batcher")
        topk = clamp_topk(topk_req, engine)
        # the ladder, one observation per request on this version's queue
        level = self.pressure.observe_pressure(batcher.queue_depth / batcher.queue_cap)
        if level >= 1 and topk:
            topk = min(topk, 1)
        qlvl = self.pressure.quant_level
        if qlvl is not None and level >= qlvl:
            # the int8 variant of the same network answers before anything
            # is shed; it serves int8 itself, so this recurses once at most
            alt = self.registry.quant_variant(mv.name)
            if alt is not None:
                try:
                    with self.registry.lease_model(alt.name) as amv:
                        self.pressure.count_reroute(len(named))
                        span.note("quant_reroute", amv.name)
                        return self._predict_on(amv, named, qs, topk_req, inm, deadline,
                                                tenant, slo_class, slo_deadline, span, t0)
                except (UnknownModel, ModelNotServing):
                    pass  # the variant retired under us: serve here
        if len(named) > batcher.max_batch:  # one request's images in one assembly window
            return _error(413, f"at most {batcher.max_batch} images per request")
        span.note("images", len(named))
        cache = self.cache if self.cache.enabled else None
        slots, err = self._stage_leases(mv, named, topk, cache, level, tenant, slo_class,
                                        slo_deadline, span)
        if err is not None:
            return err
        payloads: list = [None] * len(slots)
        etags: list = [None] * len(slots)
        n_hit = n_wait = 0
        post_s = wait_s = 0.0
        try:
            # own rows first: a leader publishes its result (waking waiters
            # of other requests) before this request waits on a flight
            for i, slot in enumerate(slots):
                if slot[0] == "done":
                    n_hit += 1
                    payloads[i], etags[i] = slot[1], slot[2]
                elif slot[0] == "own":
                    _, lease, flight, orig = slot
                    row = lease.future.result(timeout=max(0.0, deadline - time.monotonic()))
                    t_p = time.monotonic()
                    payloads[i] = format_result_row(row, orig, topk, mv)
                    post_s += time.monotonic() - t_p
                    if flight is not None:
                        etags[i] = self.cache.complete(flight, payloads[i])
            for i, slot in enumerate(slots):
                if slot[0] != "wait":
                    continue
                n_wait += 1
                t_w = time.monotonic()
                try:
                    payloads[i], etags[i] = slot[1].future.result(
                        timeout=max(0.0, deadline - time.monotonic()))
                except FutureTimeout:
                    raise
                except BaseException as e:
                    # the flight aborted (its version retired, or its leader
                    # failed): _predict retries once as a miss
                    raise _CoalesceRetry(e) from e
                finally:
                    wait_s += time.monotonic() - t_w
        except FutureTimeout:
            self._abort_slots(slots, TimeoutError("inference timed out"))
            return self._shed_response(DeadlineExceeded("inference timed out"), tenant,
                                       slo_class)
        except DeadlineExceeded as e:  # shed at seal
            self._abort_slots(slots, e)
            return self._shed_response(e, tenant, slo_class)
        except (ShuttingDown, LeaseExpired) as e:
            self._abort_slots(slots, e)
            return _error(503, str(e))
        except _CoalesceRetry as e:
            self._abort_slots(slots, e.__cause__ or e)
            raise
        except BaseException as e:  # a failed batch: the led flights must not hang
            self._abort_slots(slots, e)
            raise
        if wait_s:
            span.add("cache_wait", wait_s)
        headers = []
        if cache is not None:
            token = "hit" if n_hit == len(slots) else "coalesced" if n_wait else "miss"
            if len(slots) > 1:
                token += f"; hits={n_hit}/{len(slots)}"
            headers.append(("X-Cache", token))
        t_post = time.monotonic()
        if len(payloads) == 1 and _qs_last(qs, "batch") != "1":
            etag = etags[0] or payload_etag(payloads[0], mv.name, mv.version)
            headers.append(("ETag", f'"{etag}"'))
            if _etag_matches(inm, etag):
                span.add("postprocess", post_s)
                return _STATUS[304], b"", "application/json", headers
            resp = dict(payloads[0])  # a cached payload is shared: never mutate it
        else:
            resp = {"results": payloads}
        t_ser = time.monotonic()
        span.add("postprocess", post_s + (t_ser - t_post))
        # the envelope, after the copy: the ETag covers the payload only, and
        # the trace ID in the body lets a client that logs answers join them
        # to the access log
        resp.update(model=mv.name, model_version=mv.version,
                    latency_ms=round(1e3 * (t_ser - t0), 2), trace_id=span.trace_id)
        out = _json(200, resp, headers)
        span.add("serialize", time.monotonic() - t_ser)
        return out

    _SHED_CODE = {SHED_BACKLOG: 503, SHED_QUOTA: 429, SHED_DEADLINE: 504, SHED_DEGRADED: 503}

    def _shed_response(self, e, tenant: str, slo_class: str):
        """Every shed answers alike: a JSON ``reason`` and ``retry_after_s``
        and a ``Retry-After`` header; counted per tenant and class."""
        if isinstance(e, BacklogFull):
            reason = SHED_BACKLOG
        elif isinstance(e, QuotaExceeded):
            reason = SHED_QUOTA
        elif isinstance(e, DeadlineExceeded):
            reason = SHED_DEADLINE
        else:
            reason = SHED_DEGRADED
        retry = float(getattr(e, "retry_after_s", 1.0) or 1.0)
        self.admission.count_shed(tenant, slo_class, reason)
        return _json(self._SHED_CODE[reason],
                     {"error": str(e), "reason": reason, "retry_after_s": round(retry, 1)},
                     [("Retry-After", str(max(1, int(round(retry)))))])

    def _abort_slots(self, slots: list, exc: BaseException) -> None:
        """Unwind a request: its own slots become holes (a dispatched row's
        result is dropped) and its led flights abort, so that their waiters
        fail over at once. Hits and waits hold nothing of this request's."""
        for slot in slots:
            if slot[0] != "own":
                continue
            _, lease, flight, _ = slot
            lease.future.cancel()
            lease.release()
            if flight is not None:
                self.cache.abort(flight, exc)

    def _stage_leases(self, mv, named: list[tuple[str, bytes]], topk: int, cache, level: int,
                      tenant: str, slo_class: str, slo_deadline: float | None, span: Span):
        """Stage every upload of a request (:meth:`_stage`); ``(slots, None)``
        or ``(None, error answer)``, the request's slots unwound. Rung 2
        stages into the smallest canvas bucket."""
        buckets = mv.engine.cfg.canvas_buckets
        if level >= 2 and len(buckets) > 1:
            buckets = buckets[:1]
        slots: list = []
        try:
            for name, data in named:
                try:
                    self._stage(mv, data, buckets, topk, cache, level, slo_deadline, tenant,
                                slots, span)
                except ValueError as e:
                    self._abort_slots(slots, e)
                    return None, _error(400, f"{name}: {e}")
        except ShuttingDown as e:
            self._abort_slots(slots, e)
            return None, _error(503, "server shutting down")
        except (BacklogFull, QuotaExceeded, DeadlineExceeded, Degraded) as e:
            self._abort_slots(slots, e)
            return None, self._shed_response(e, tenant, slo_class)
        except BaseException as e:
            self._abort_slots(slots, e)
            raise
        return slots, None

    def _stage(self, mv, data: bytes, buckets, topk: int, cache, level: int,
               slo_deadline: float | None, tenant: str, slots: list, span: Span) -> None:
        """Stage one upload and append its slot to ``slots``. A JPEG is
        planned from its header, its slot leased (admission sheds raise
        here) and libjpeg decodes it straight into the slot's pinned row;
        the digest of what the device would read is then looked up: a hit
        (``("done", payload, etag)``) or a wait on another request's flight
        (``("wait", flight)``) releases the slot as a hole, a miss commits
        it (``("own", lease, flight, orig)``; ``flight`` None without a
        cache; ``orig`` the upload's original (h, w), which a detector's
        boxes are scaled by)
        unless the ladder's last rung sheds it. Anything else, or a
        stream the C side rejects, is decoded by PIL and looked up before
        any slot is leased. Raises ValueError if the bytes are no decodable
        image. ``span`` gets ``image_decode`` (header probe and decode) and
        ``cache_lookup`` (digest and lookup); the lease stamps its wait."""
        if self.chaos is not None and self.chaos.decode_fault():
            raise ValueError("cannot decode image (chaos: injected decode failure)")
        engine, batcher = mv.engine, mv.batcher
        wire = engine.cfg.wire_format
        t_d = time.monotonic()
        if engine.ragged:
            plan = native.plan_decode_packed(data, buckets)
            decode_s = time.monotonic() - t_d
            if plan is not None:
                s, need, _, orig = plan
                lease = batcher.lease_ragged(need, s, slo_deadline, tenant, span)
                t_d = time.monotonic()
                hw = native.decode_packed_into(data, lease.row, s)
        else:
            plan = native.plan_decode(data, buckets, wire)
            decode_s = time.monotonic() - t_d
            if plan is not None:
                s, shape, orig = plan
                lease = batcher.lease(shape, slo_deadline, tenant, span)
                t_d = time.monotonic()
                hw = native.decode_into_row(data, lease.row, s, wire, trailer=True)
        if plan is not None:
            decode_s += time.monotonic() - t_d
            if hw is not None:
                span.add("image_decode", decode_s)
                engine.count_decode("native")
                t_c = time.monotonic()
                # the reference's digest bytes: the tight h·w·3 decoded
                # bytes, or the canvas without the row's 4-byte trailer
                digest = (packed_digest(lease.row[: hw[0] * hw[1] * 3], hw, s) if engine.ragged
                          else canvas_digest(lease.row[:-TRAILER_BYTES], hw)
                          ) if cache is not None else None
                self._settle(mv, digest, topk, cache, level, slots, span,
                             time.monotonic() - t_c, orig, lease, hw)
                return
            lease.release()  # the header parsed, the stream did not: PIL tries
        t_d = time.monotonic()
        try:  # PIL: UnidentifiedImageError is an OSError
            if engine.ragged:
                image = decode_image(data)
                canvas, hw, s = fit_to_bucket(image, buckets)
                orig = tuple(image.shape[:2])
            else:
                canvas, hw, orig = native.decode_pil(data, buckets, wire)
        except (OSError, ValueError) as e:
            span.add("image_decode", decode_s + time.monotonic() - t_d)
            raise ValueError(f"cannot decode image: {e}") from e
        t_c = time.monotonic()
        span.add("image_decode", decode_s + t_c - t_d)
        engine.count_decode("pil")
        if cache is None:
            digest = None
        elif engine.ragged:
            digest = packed_digest(canvas, hw, s)
        else:
            digest = canvas_digest(canvas, hw)

        def take():
            lease = (batcher.lease_ragged(canvas.nbytes, s, slo_deadline, tenant, span)
                     if engine.ragged
                     else batcher.lease(canvas.shape, slo_deadline, tenant, span))
            lease.commit(hw, canvas=canvas)
            return lease

        self._settle(mv, digest, topk, cache, level, slots, span, time.monotonic() - t_c,
                     orig, take=take)

    def _settle(self, mv, digest: str | None, topk: int, cache, level: int, slots: list,
                span: Span, digest_s: float, orig: tuple[int, int], lease=None, hw=None,
                take=None) -> None:
        """One decoded upload's lookup and slot. ``lease`` holds it decoded
        already, valid size ``hw`` (native); or ``take()`` leases a slot and
        copies it in, on a miss only (PIL). ``orig`` is the upload's
        original (h, w). The digest's ``digest_s`` and the lookup are the
        span's ``cache_lookup``."""
        flight = None
        try:
            if cache is not None:
                t_c = time.monotonic()
                kind, obj = cache.begin(make_key(mv.name, mv.version, digest, topk,
                                                 mv.model_cfg.dtype), mv.name)
                span.add("cache_lookup", digest_s + time.monotonic() - t_c)
                if kind != "lead":
                    if lease is not None:
                        lease.release()  # no device work: the slot ships as a hole
                    slots.append(("done", obj.payload, obj.etag) if kind == "hit"
                                 else ("wait", obj))
                    return
                flight = obj
            if level >= self.pressure.reject_level:
                raise Degraded("shedding cache-miss work under overload "
                               "(degradation reject rung)")
            if lease is None:
                lease = take()
            else:
                lease.commit(hw)
        except BaseException as e:
            if flight is not None:
                self.cache.abort(flight, e)
            if lease is not None:
                lease.release()
            raise
        slots.append(("own", lease, flight, orig))


# ---------------------------------------------------------------- front end


class HttpCounters:
    """Keep-alive counters for /stats: ``requests_per_connection`` near 1
    means clients pay a handshake per request."""

    def __init__(self):
        self._lock = threading.Lock()
        self._connections = 0
        self._requests = 0
        self._active = 0

    def connection_opened(self):
        with self._lock:
            self._connections += 1
            self._active += 1

    def connection_closed(self):
        with self._lock:
            self._active -= 1

    def request_served(self):
        with self._lock:
            self._requests += 1

    def snapshot(self) -> dict:
        with self._lock:
            conns, reqs, active = self._connections, self._requests, self._active
        return {
            "connections_total": conns,
            "requests_total": reqs,
            "active_connections": active,
            "requests_per_connection": round(reqs / conns, 2) if conns else None,
        }


class _BodyReader:
    """Bounded view of the connection's rfile: reads never run past the
    declared Content-Length (keep-alive framing depends on it), and the
    handler can drain what the app left unread."""

    def __init__(self, rfile, length: int):
        self._rfile = rfile
        self.remaining = max(0, length)

    def read(self, n: int = -1) -> bytes:
        if n is None or n < 0 or n > self.remaining:
            n = self.remaining
        if n <= 0:
            return b""
        data = self._rfile.read(n)
        self.remaining -= len(data)
        return data

    def drain(self):
        while self.remaining > 0:
            if not self.read(min(65536, self.remaining)):
                break  # the peer went away; the connection closes anyway


def _wait_readable(sock, timeout_s: float) -> bool:
    """poll(), not select(): select raises for any fd ≥ FD_SETSIZE."""
    if hasattr(select, "poll"):
        p = select.poll()
        p.register(sock, select.POLLIN)
        return bool(p.poll(max(0.0, timeout_s) * 1000))
    readable, _, _ = select.select([sock], [], [], max(0.0, timeout_s))
    return bool(readable)


class _DeadlineFile:
    """Buffered read side of the connection with a TOTAL deadline across
    reads. A client trickling a byte per interval resets a per-recv socket
    timeout for ever, and one stdlib ``readline`` spans any number of
    recvs, so the cap lives at the raw read: each read waits in ``poll``
    bounded by the armed deadline, and expiry raises ``socket.timeout``,
    which the base parser (headers) and the app (body, 408) handle by
    closing the connection."""

    def __init__(self, connection, base_timeout: float):
        self._conn = connection
        self._base = base_timeout
        self._buf = bytearray()
        self._eof = False
        self.deadline: float | None = None  # armed per request by the handler

    def _cap(self) -> float:
        if self.deadline is not None:
            return self.deadline
        return time.monotonic() + self._base

    def _fill(self, deadline: float) -> bool:
        """More bytes into the buffer: True on data, False on EOF,
        ``socket.timeout`` when the deadline comes first."""
        if self._eof:
            return False
        remaining = deadline - time.monotonic()
        if remaining <= 0 or not _wait_readable(self._conn, remaining):
            raise socket.timeout("request read deadline exceeded")
        chunk = self._conn.recv(65536)
        if not chunk:
            self._eof = True
            return False
        self._buf += chunk
        return True

    def readline(self, limit: int = -1) -> bytes:
        deadline = self._cap()
        while True:
            i = self._buf.find(b"\n")
            if i >= 0 and (limit < 0 or i < limit):
                n = i + 1
            elif limit >= 0 and len(self._buf) >= limit:
                n = limit  # stdlib semantics: an over-limit line comes back cut
            elif self._fill(deadline):
                continue
            else:
                n = len(self._buf)  # EOF: whatever arrived
            out = bytes(self._buf[:n])
            del self._buf[:n]
            return out

    def read(self, n: int = -1) -> bytes:
        deadline = self._cap()
        if n is None or n < 0:
            out = bytes(self._buf)  # read-to-EOF is never used mid-request
            self._buf.clear()
            return out
        while len(self._buf) < n:
            if not self._fill(deadline):
                break
        out = bytes(self._buf[:n])
        del self._buf[:n]
        return out

    def peek(self, n: int = 1) -> bytes:
        return bytes(self._buf[:n])  # never blocks: buffered bytes only

    def close(self):  # the handler owns the socket's lifetime
        pass


class KeepAliveWSGIHandler(BaseHTTPRequestHandler):
    """One worker-owned connection: any number of HTTP/1.1 requests, each a
    WSGI call on the server's app. With ``protocol_version = HTTP/1.1`` and
    a Content-Length on every answer, persistence is the default and a
    client's ``Connection: close`` is honoured by the base parser."""

    protocol_version = "HTTP/1.1"
    server_version = "tpu-serve"
    sys_version = ""  # never advertise the Python patch level
    # answers go out as two writes (headers, then body); with Nagle on, the
    # body stalls behind the client's delayed ACK
    disable_nagle_algorithm = True
    # unread request-body bytes worth consuming to keep a connection alive;
    # past this (a 413'd upload) closing is cheaper
    max_drain = 1 << 20

    def setup(self):
        self.timeout = self.server.keepalive_timeout_s  # idle keep-alive cap
        self._counted = False
        self._responded = False
        super().setup()
        self.rfile = _DeadlineFile(self.connection, self.timeout)
        self.server.track_connection(self.connection, opened=True)
        self.server.counters.connection_opened()
        self._counted = True

    def finish(self):
        try:
            super().finish()
        finally:
            if self._counted:
                self.server.track_connection(self.connection, opened=False)
                self.server.counters.connection_closed()

    def handle(self):
        """The keep-alive loop, fair under oversubscription: between
        requests the worker polls, and closes an idle connection as soon as
        accepted connections wait while every worker is busy. The first
        request gets a grace window before it may be yielded (its bytes may
        still be in flight); idle between requests has none."""
        self.close_connection = True
        if not self._await_next_request(grace_s=1.0):
            return
        self._handle_with_deadline()
        while not self.close_connection:
            if not self._await_next_request():
                break
            self._handle_with_deadline()

    def _handle_with_deadline(self):
        self.rfile.deadline = time.monotonic() + self.server.request_read_timeout_s
        self._responded = False
        # the trace starts once the request's bytes are arriving: header
        # reading is request work, keep-alive idling is not
        self._req_t0 = time.monotonic()
        try:
            self.handle_one_request()
        finally:
            self.rfile.deadline = None

    def send_response_only(self, code, message=None):
        # every answer goes through here (send_error's too), counted before
        # the body flushes: a client that read its answer finds it counted
        super().send_response_only(code, message)
        if not self._responded:
            self._responded = True
            self.server.counters.request_served()

    def _await_next_request(self, grace_s: float = 0.0) -> bool:
        if self.rfile.peek(1):
            return True  # a pipelined request already sits in the buffer
        now = time.monotonic()
        no_yield_before = now + grace_s
        deadline = now + self.server.keepalive_timeout_s
        while True:
            try:
                readable = _wait_readable(self.connection, 0.05)
            except (OSError, ValueError):
                return False  # the connection was torn down under us
            if readable:
                return True  # the next request line (or EOF, for the parser)
            now = time.monotonic()
            if self.server.draining:
                return False
            if now >= no_yield_before and self.server.queued_without_worker():
                return False  # yield the worker to a queued connection
            if now >= deadline:
                return False

    def do_GET(self):
        self._run_app()

    # the app routes on REQUEST_METHOD itself (405 where it must), so every
    # method passes through, HEAD included (load balancers probe with it)
    do_POST = do_HEAD = do_PUT = do_DELETE = do_OPTIONS = do_GET

    def _run_app(self):
        path, _, query = self.path.partition("?")
        if self.headers.get("Transfer-Encoding"):
            # a chunked body is not parsed here; without a trusted length the
            # next request's framing cannot be found: refuse and close
            self.close_connection = True
            body = b'{"error": "Transfer-Encoding not supported; send Content-Length"}\n'
            self.send_response(411, "Length Required")
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Connection", "close")
            self.end_headers()
            self.wfile.write(body)
            return
        cl_header = self.headers.get("Content-Length")
        try:
            declared = int(cl_header) if cl_header is not None else 0
        except ValueError:
            declared = -1
        if declared < 0:
            # garbage framing: the app 413s it, and the connection cannot be
            # reused without a trusted body length
            self.close_connection = True
        reader = _BodyReader(self.rfile, declared)
        # the span: a well-formed inbound X-Trace-Id or a fresh one; the
        # header read that just happened is its first stage
        span = Span(accept_trace_id(self.headers.get("X-Trace-Id")),
                    t0=getattr(self, "_req_t0", None))
        span.add("http_read", time.monotonic() - span.t0)
        environ = {
            "REQUEST_METHOD": self.command,
            "PATH_INFO": urllib.parse.unquote(path),
            "QUERY_STRING": query,
            "SERVER_PROTOCOL": self.protocol_version,
            "SERVER_NAME": self.server.server_name,
            "SERVER_PORT": str(self.server.server_port),
            "REMOTE_ADDR": self.client_address[0],
            "CONTENT_TYPE": self.headers.get("Content-Type", ""),
            "CONTENT_LENGTH": cl_header if cl_header is not None else "",
            "wsgi.version": (1, 0),
            "wsgi.url_scheme": "http",
            "wsgi.input": reader,
            "wsgi.errors": sys.stderr,
            "wsgi.multithread": True,
            "wsgi.multiprocess": False,
            "wsgi.run_once": False,
            "tpu_serve.span": span,
        }
        # PEP 3333 HTTP_* request headers; repeats comma-join
        for hk, hv in self.headers.items():
            key = "HTTP_" + hk.upper().replace("-", "_")
            if key in ("HTTP_CONTENT_TYPE", "HTTP_CONTENT_LENGTH"):
                continue  # already present under their CGI names
            environ[key] = f"{environ[key]},{hv}" if key in environ else hv

        captured = {}

        def start_response(status, headers, exc_info=None):
            captured["status"] = status
            captured["headers"] = headers

        body = b"".join(self.server.app(environ, start_response))
        status = captured.get("status", "500 Internal Server Error")
        code_s, _, reason = status.partition(" ")

        # keep-alive framing: the next request starts where this body ends,
        # so unread bytes are drained (small) or the connection closed
        if reader.remaining:
            if reader.remaining <= self.max_drain:
                try:
                    reader.drain()
                except OSError:
                    # a stalled uploader: still send the answer, then close
                    self.close_connection = True
            else:
                self.close_connection = True
        if self.server.draining:
            self.close_connection = True

        # the span folds into the app's aggregates before the answer goes
        # out: a client that read its answer finds it in the next scrape
        obs = getattr(self.server.app, "obs", None)
        if obs is not None:
            try:
                code_i = int(code_s)
            except ValueError:
                code_i = 500
            obs.finish(span, code_i)

        self.send_response(int(code_s), reason or None)
        have_length = have_trace = False
        for k, v in captured.get("headers", []):
            kl = k.lower()
            have_length |= kl == "content-length"
            have_trace |= kl == "x-trace-id"
            self.send_header(k, v)
        if not have_length:
            self.send_header("Content-Length", str(len(body)))
        if not have_trace:  # a WSGI app that knows nothing of spans
            self.send_header("X-Trace-Id", span.trace_id)
        if self.close_connection:
            self.send_header("Connection", "close")
        self.end_headers()
        if self.command != "HEAD":  # headers (length included) only
            self.wfile.write(body)

    def log_message(self, fmt, *args):
        log.debug("%s " + fmt, self.address_string(), *args)


class PoolWSGIServer(TCPServer):
    """HTTP/1.1 keep-alive front end on a bounded worker pool.

    ``serve_forever`` only accepts and enqueues; a fixed pool of workers
    owns each connection for its whole life. Closed-loop clients pay the
    handshake and the hand-off once per connection. With more live
    connections than workers, an idle kept-alive connection yields its
    worker to a queued one; overload sheds at accept (pending queue full →
    connection closed), a reset a load balancer retries.
    """

    allow_reuse_address = True
    # the kernel's accept backlog; the default (5) resets connections under
    # concurrent load
    request_queue_size = 128

    def __init__(self, addr, app, pool_size: int = 16, keepalive_timeout_s: float = 15.0,
                 request_read_timeout_s: float = 30.0):
        self.app = app
        self.pool_size = max(1, pool_size)
        self.keepalive_timeout_s = keepalive_timeout_s
        # total read budget for one request (headers + body), apart from the
        # idle timeout: a short idle timeout must not cap a large upload
        self.request_read_timeout_s = request_read_timeout_s
        self.counters = HttpCounters()
        self.draining = False
        self._conns_lock = threading.Lock()
        self._open_conns: set = set()
        self._pending: queue.Queue = queue.Queue(maxsize=self.pool_size * 4)
        # workers waiting for a connection: while one is, a queued connection
        # is about to be served and no idle keep-alive connection yields
        self._idle_lock = threading.Lock()
        self._idle_workers = 0
        super().__init__(addr, KeepAliveWSGIHandler)
        self._workers = [
            threading.Thread(target=self._worker, name=f"http-worker-{i}", daemon=True)
            for i in range(self.pool_size)
        ]
        for t in self._workers:
            t.start()

    def server_bind(self):
        super().server_bind()
        host, port = self.server_address[:2]
        self.server_name = socket.getfqdn(host)
        self.server_port = port

    def process_request(self, request, client_address):
        """Accept thread: hand the connection to the pool, never spawn."""
        try:
            self._pending.put_nowait((request, client_address))
        except queue.Full:
            self.shutdown_request(request)  # shed at the edge

    def handle_error(self, request, client_address):
        # peer resets and truncated requests are client weather
        log.debug("connection error from %s", client_address, exc_info=True)

    def queued_without_worker(self) -> bool:
        """Accepted connections wait and every worker is busy."""
        with self._idle_lock:
            return self._idle_workers == 0 and not self._pending.empty()

    def _worker(self):
        while True:
            with self._idle_lock:
                self._idle_workers += 1
            try:
                item = self._pending.get(timeout=0.25)
            except queue.Empty:
                if self.draining:
                    return
                continue
            finally:
                with self._idle_lock:
                    self._idle_workers -= 1
            if item is None:
                return
            request, client_address = item
            try:
                self.finish_request(request, client_address)
            except Exception:
                self.handle_error(request, client_address)
            finally:
                self.shutdown_request(request)

    def track_connection(self, conn, *, opened: bool):
        with self._conns_lock:
            (self._open_conns.add if opened else self._open_conns.discard)(conn)

    def close_pool(self, grace_s: float = 10.0):
        """Drain the pool: stop keep-alive looping, half-close the read side
        of every open connection (a worker waiting for the client's next
        request wakes at once; answers in flight still write), then join the
        workers within the grace."""
        self.draining = True
        with self._conns_lock:
            conns = list(self._open_conns)
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RD)
            except OSError:
                pass  # gone already
        for _ in self._workers:
            try:
                self._pending.put_nowait(None)
            except queue.Full:
                break  # busy workers poll the draining flag instead
        deadline = time.monotonic() + grace_s
        for t in self._workers:
            t.join(timeout=max(0.0, deadline - time.monotonic()))
        # connections accepted but never picked up would hang their clients
        while True:
            try:
                item = self._pending.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                self.shutdown_request(item[0])


def make_http_server(app, host: str, port: int, pool_size: int = 16,
                     keepalive_timeout_s: float = 15.0,
                     request_read_timeout_s: float = 30.0) -> PoolWSGIServer:
    srv = PoolWSGIServer((host, port), app, pool_size=pool_size,
                         keepalive_timeout_s=keepalive_timeout_s,
                         request_read_timeout_s=request_read_timeout_s)
    if hasattr(app, "attach_http"):
        app.attach_http(srv)
    return srv


def shutdown_gracefully(srv, batcher, grace_s: float = 10.0, jobs=None) -> None:
    """Ordered drain: stop accepting → stop the telemetry sampler →
    checkpoint the running bulk job → resolve every queued and in-flight
    request → let the pool's workers flush their answers and exit → close
    the listening socket.

    ``jobs`` is the app's :class:`~.jobs.JobManager` (``srv.app.jobs`` when
    omitted). It stops before the batchers: its runner finishes its chunk
    window against live batchers and writes the checkpoint the next boot
    resumes from.

    ``batcher`` is anything with the drain-on-``stop()`` contract: one
    :class:`~.batcher.Batcher` or a whole :class:`~.registry.ModelRegistry`
    (which stops every model's batcher). The order matters: workers block on
    batcher futures, so the batchers stop (dispatching everything queued and
    resolving every future) before the pool's join — joining first would
    deadlock, and closing the socket first would cut off the answers the
    batchers are about to complete. Workers are daemons, so a client that
    stops reading delays exit by at most ``grace_s``.
    """
    srv.shutdown()  # returns at once if serve_forever has unwound already
    # the sampler only reads the registry and batchers: stopped first, no
    # tick observes a half-stopped stack
    app = getattr(srv, "app", None)
    telemetry = getattr(app, "telemetry", None)
    if telemetry is not None:
        telemetry.stop()
    if jobs is None:
        jobs = getattr(app, "jobs", None)
    if jobs is not None:
        jobs.stop(grace_s)
    batcher.stop()
    srv.close_pool(grace_s)
    srv.server_close()
