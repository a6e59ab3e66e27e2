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

Routes:
    POST /predict       image (raw body or multipart/form-data) → JSON
                        top-k; ``?topk=N``; ``?model=name[@version]`` routes
                        to any SERVING model (the default one without it;
                        unknown → 404, not serving → 503, before the body is
                        read). One image answers ``{"predictions": [{"label",
                        "index", "score"}], "model", "model_version"}``;
                        several file parts, or ``?batch=1``, answer
                        ``{"results": [...], ...}`` in upload order (at most
                        the batcher's ``max_batch``, else 413). Headers in:
                        ``If-None-Match``, ``X-Tenant``, ``X-SLO``,
                        ``X-Deadline-Ms``; out: ``ETag``, ``X-Cache``.
    GET  /healthz       one-image device round trip on the default model
    GET  /models        the registry: default model, every version's state,
                        transition history and counters
    POST /models/load   admin: ``{"model": spec, "name"?, "activate"?,
                        "wait"?}``, built and warmed off the request path
    POST /models/swap   admin: ``{"name"?, "model"?, "wait"?}``, a new
                        version takes the traffic once warm, the old drains
    POST /models/unload admin: ``{"name", "version"?, "wait"?}``
    GET  /stats         the default model's ``batcher`` and ``engine``
                        counters (kernel launches, decodes, the decoder,
                        ``graphs`` with the process's device memory,
                        ``aot_cache``, ``warmup_s``), ``models`` (each
                        version's batcher and engine counters under its
                        name), ``http`` (keep-alive counters), ``cache``,
                        ``overload`` (``admission``, ``pressure``,
                        ``chaos``)
    GET  /              the upload page

The admin routes are as open as the rest of the surface: deploy behind
the network boundary that guards the server.
"""

from __future__ import annotations

import json
import logging
import queue
import select
import socket
import sys
import threading
import time
import urllib.parse
from concurrent.futures import TimeoutError as FutureTimeout
from http.server import BaseHTTPRequestHandler
from socketserver import TCPServer

from .. import native
from ..ops.image import decode_image, fit_to_bucket
from .batcher import BacklogFull, LeaseExpired, ShuttingDown
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

log = logging.getLogger("tpu_serve_torch.http")

# /predict and admin body cap: larger uploads get 413 before the body is read
MAX_BODY_MB = 32
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
        start_response(status, [("Content-Type", ctype), ("Content-Length", str(len(body))),
                                *headers])
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
        snap = {"model": mv.name if mv is not None else None}
        if mv is not None and mv.batcher is not None:
            snap["batcher"] = mv.batcher.stats()
        if mv is not None and mv.engine is not None:
            snap["engine"] = mv.engine.stats()
        snap["models"] = self.registry.models_snapshot()
        if self.http_counters is not None:
            snap["http"] = self.http_counters.snapshot()
        snap["cache"] = self.cache.stats()
        snap["overload"] = {"admission": self.admission.stats(),
                            "pressure": self.pressure.stats()}
        if self.chaos is not None:
            snap["overload"]["chaos"] = self.chaos.stats()
        return snap

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
                    return _error(400, "'model' (native:<zoo name> or a .json path) is required")
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

    def _read_body(self, environ) -> bytes | None:
        """The request body; None when it exceeds the cap. The declared
        Content-Length gates before anything is read, and the read itself is
        capped, so an under-declaring client cannot stream more."""
        cap = MAX_BODY_MB << 20
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
            if body is None:
                return _error(413, f"body exceeds {MAX_BODY_MB} MB cap")
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
                    res = self._predict_on(mv, named, qs, topk_req, inm, deadline, tenant,
                                           slo_class, slo_deadline)
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
                    deadline: float, tenant: str, slo_class: str, slo_deadline: float | None):
        """The /predict body against one resolved model version: one ladder
        step, stage every upload (a cached answer, a wait on another
        request's flight, or a leased slot of its own), then await the rows
        until ``deadline``."""
        batcher, engine = mv.batcher, mv.engine
        if batcher is None:
            return _error(503, f"{mv.ref} has no batcher")
        topk = engine.topk if topk_req is None else min(max(topk_req, 0), engine.topk)
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
                        return self._predict_on(amv, named, qs, topk_req, inm, deadline,
                                                tenant, slo_class, slo_deadline)
                except (UnknownModel, ModelNotServing):
                    pass  # the variant retired under us: serve here
        if len(named) > batcher.max_batch:  # one request's images in one assembly window
            return _error(413, f"at most {batcher.max_batch} images per request")
        cache = self.cache if self.cache.enabled else None
        slots, err = self._stage_leases(mv, named, topk, cache, level, tenant, slo_class,
                                        slo_deadline)
        if err is not None:
            return err
        payloads: list = [None] * len(slots)
        etags: list = [None] * len(slots)
        n_hit = n_wait = 0
        try:
            # own rows first: a leader publishes its result (waking waiters
            # of other requests) before this request waits on a flight
            for i, slot in enumerate(slots):
                if slot[0] == "done":
                    n_hit += 1
                    payloads[i], etags[i] = slot[1], slot[2]
                elif slot[0] == "own":
                    _, lease, flight = slot
                    row = lease.future.result(timeout=max(0.0, deadline - time.monotonic()))
                    payloads[i] = self._row(mv, row, topk)
                    if flight is not None:
                        etags[i] = self.cache.complete(flight, payloads[i])
            for i, slot in enumerate(slots):
                if slot[0] != "wait":
                    continue
                n_wait += 1
                try:
                    payloads[i], etags[i] = slot[1].future.result(
                        timeout=max(0.0, deadline - time.monotonic()))
                except FutureTimeout:
                    raise
                except BaseException as e:
                    # the flight aborted (its version retired, or its leader
                    # failed): _predict retries once as a miss
                    raise _CoalesceRetry(e) from e
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
        headers = []
        if cache is not None:
            token = "hit" if n_hit == len(slots) else "coalesced" if n_wait else "miss"
            if len(slots) > 1:
                token += f"; hits={n_hit}/{len(slots)}"
            headers.append(("X-Cache", token))
        if len(payloads) == 1 and _qs_last(qs, "batch") != "1":
            etag = etags[0] or payload_etag(payloads[0], mv.name, mv.version)
            headers.append(("ETag", f'"{etag}"'))
            if _etag_matches(inm, etag):
                return _STATUS[304], b"", "application/json", headers
            resp = dict(payloads[0])  # a cached payload is shared: never mutate it
        else:
            resp = {"results": payloads}
        resp.update(model=mv.name, model_version=mv.version)
        return _json(200, resp, headers)

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
            _, lease, flight = slot
            lease.future.cancel()
            lease.release()
            if flight is not None:
                self.cache.abort(flight, exc)

    @staticmethod
    def _row(mv, row, topk: int) -> dict:
        scores, idx = row
        labels = mv.labels
        return {"predictions": [
            {"label": labels[i] if i < len(labels) else f"class_{i}", "index": int(i),
             "score": float(s)}
            for s, i in zip(scores[:topk], idx[:topk])
        ]}

    def _stage_leases(self, mv, named: list[tuple[str, bytes]], topk: int, cache, level: int,
                      tenant: str, slo_class: str, slo_deadline: float | None):
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
                                slots)
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
               slo_deadline: float | None, tenant: str, slots: list) -> None:
        """Stage one upload and append its slot to ``slots``. A JPEG is
        planned from its header, its slot leased (admission sheds raise
        here) and libjpeg decodes it straight into the slot's pinned row;
        the digest of what the device would read is then looked up: a hit
        (``("done", payload, etag)``) or a wait on another request's flight
        (``("wait", flight)``) releases the slot as a hole, a miss commits
        it (``("own", lease, flight)``; ``flight`` None without a cache)
        unless the ladder's last rung sheds it. Anything else, or a
        stream the C side rejects, is decoded by PIL and looked up before
        any slot is leased. Raises ValueError if the bytes are no decodable
        image."""
        if self.chaos is not None and self.chaos.decode_fault():
            raise ValueError("cannot decode image (chaos: injected decode failure)")
        engine, batcher = mv.engine, mv.batcher
        wire = engine.cfg.wire_format
        if engine.ragged:
            plan = native.plan_decode_packed(data, buckets)
            if plan is not None:
                s, need, _, _ = plan
                lease = batcher.lease_ragged(need, s, slo_deadline, tenant)
                hw = native.decode_packed_into(data, lease.row, s)
        else:
            plan = native.plan_decode(data, buckets, wire)
            if plan is not None:
                s, shape, _ = plan
                lease = batcher.lease(shape, slo_deadline, tenant)
                hw = native.decode_into_row(data, lease.row, s, wire, trailer=True)
        if plan is not None:
            if hw is not None:
                engine.count_decode("native")
                # the reference's digest bytes: the tight h·w·3 decoded
                # bytes, or the canvas without the row's 4-byte trailer
                digest = (packed_digest(lease.row[: hw[0] * hw[1] * 3], hw, s) if engine.ragged
                          else canvas_digest(lease.row[:-TRAILER_BYTES], hw)
                          ) if cache is not None else None
                self._settle(mv, digest, topk, cache, level, slots, lease, hw)
                return
            lease.release()  # the header parsed, the stream did not: PIL tries
        try:  # PIL: UnidentifiedImageError is an OSError
            if engine.ragged:
                canvas, hw, s = fit_to_bucket(decode_image(data), buckets)
                digest = packed_digest(canvas, hw, s) if cache is not None else None
            else:
                canvas, hw, _ = native.decode_pil(data, buckets, wire)
                digest = canvas_digest(canvas, hw) if cache is not None else None
        except (OSError, ValueError) as e:
            raise ValueError(f"cannot decode image: {e}") from e
        engine.count_decode("pil")

        def take():
            lease = (batcher.lease_ragged(canvas.nbytes, s, slo_deadline, tenant)
                     if engine.ragged else batcher.lease(canvas.shape, slo_deadline, tenant))
            lease.commit(hw, canvas=canvas)
            return lease

        self._settle(mv, digest, topk, cache, level, slots, take=take)

    def _settle(self, mv, digest: str | None, topk: int, cache, level: int, slots: list,
                lease=None, hw=None, take=None) -> None:
        """One decoded upload's lookup and slot. ``lease`` holds it decoded
        already, valid size ``hw`` (native); or ``take()`` leases a slot and
        copies it in, on a miss only (PIL)."""
        flight = None
        try:
            if cache is not None:
                kind, obj = cache.begin(make_key(mv.name, mv.version, digest, topk,
                                                 mv.model_cfg.dtype), mv.name)
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
        slots.append(("own", lease, flight))


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

        self.send_response(int(code_s), reason or None)
        have_length = False
        for k, v in captured.get("headers", []):
            have_length |= k.lower() == "content-length"
            self.send_header(k, v)
        if not have_length:
            self.send_header("Content-Length", str(len(body)))
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


def shutdown_gracefully(srv, batcher, grace_s: float = 10.0) -> None:
    """Ordered drain: stop accepting → resolve every queued and in-flight
    request → let the pool's workers flush their answers and exit → close
    the listening socket.

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
    batcher.stop()
    srv.close_pool(grace_s)
    srv.server_close()
