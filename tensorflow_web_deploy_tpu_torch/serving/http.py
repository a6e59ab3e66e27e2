"""HTTP front end (a lean counterpart of the JAX package's
``serving/http.py``) on the standard library's ``ThreadingHTTPServer``.

Routes:

- ``POST /predict`` — a raw image body or a multipart upload; ``?topk=N``
  returns at most N predictions. One image answers
  ``{"predictions": [{"label", "index", "score"}], "model"}``; several
  file parts, or ``?batch=1``, answer ``{"results": [...], "model"}``.
  Each JPEG is probed from its header, given a leased batch slot, and
  decoded by libjpeg straight into that slot's pinned memory; anything
  else is decoded by PIL and copied in. The images of one request usually
  share one device batch. An undecodable file answers 400 and releases
  the request's other slots (they ship as holes); a full backlog answers
  503 with ``Retry-After``.
- ``GET /healthz`` — a one-image device round trip.
- ``GET /stats`` — batcher and engine counters: kernel launches, native
  and PIL decodes, the decoder's status (and why it is unavailable),
  ``engine.graphs`` (CUDA graphs captured, replays, eager batches, capture
  seconds, graph pool and static bytes), ``engine.aot_cache`` (the kernel
  build cache's counters, as the reference's ``/stats`` carries
  ``aot_cache``) and ``engine.warmup_s`` (warmup's phases).
"""

from __future__ import annotations

import json
import logging
from concurrent.futures import TimeoutError as FutureTimeout
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlsplit

from .. import native
from ..ops.image import decode_image, fit_to_bucket
from ..utils.labels import load_labels
from .batcher import BacklogFull, LeaseExpired, ShuttingDown

log = logging.getLogger("tpu_serve_torch.http")

# /predict body cap: larger uploads get 413 before the body is read
MAX_BODY_MB = 32
# how long a request waits for its batch before it answers 504
REQUEST_TIMEOUT_S = 30.0


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


def _error(status: int, message: str) -> tuple[int, dict]:
    return status, {"error": message}


class App:
    """Request handling over one engine and its batcher."""

    def __init__(self, engine, batcher, cfg):
        self.engine = engine
        self.batcher = batcher
        self.cfg = cfg
        self.labels = load_labels(cfg.model.labels_path, engine.num_classes)

    def _row(self, row, topk: int) -> dict:
        scores, idx = row
        return {
            "predictions": [
                {
                    "label": self.labels[i] if i < len(self.labels) else f"class_{i}",
                    "index": int(i),
                    "score": float(s),
                }
                for s, i in zip(scores[:topk], idx[:topk])
            ]
        }

    def predict(self, body: bytes, content_type: str, query: str
                ) -> tuple[int, dict] | tuple[int, dict, dict]:
        qs = parse_qs(query)
        topk = self.engine.topk
        if "topk" in qs:
            try:
                topk = min(max(int(qs["topk"][-1]), 0), topk)
            except ValueError:
                return _error(400, "topk must be an integer")
        if content_type.startswith("multipart/form-data"):
            named = _parse_multipart_files(body, content_type)
            if not named:
                return _error(400, "no file part in multipart body")
        else:
            named = [("body", body)]
        leases, staged = [], False
        try:
            for name, data in named:
                try:
                    self._stage(data, leases)
                except ValueError as e:
                    return _error(400, f"{name}: {e}")
            staged = True
        except BacklogFull as e:
            return _error(503, str(e)) + ({"Retry-After": str(max(1, round(e.retry_after_s)))},)
        except ShuttingDown:
            return _error(503, "server shutting down")
        finally:
            if not staged:  # every error: the request's slots become holes
                for lease in leases:
                    lease.release()
        try:
            rows = [lease.future.result(timeout=REQUEST_TIMEOUT_S) for lease in leases]
        except (ShuttingDown, LeaseExpired) as e:
            return _error(503, str(e))
        except FutureTimeout:
            return _error(504, "inference timed out")
        payloads = [self._row(r, topk) for r in rows]
        if len(payloads) == 1 and qs.get("batch", [""])[-1] != "1":
            resp = payloads[0]
        else:
            resp = {"results": payloads}
        resp["model"] = self.cfg.model.name
        return 200, resp

    def _stage(self, data: bytes, leases: list) -> None:
        """Put one upload into a leased, committed slot (appended to
        ``leases``). A JPEG is planned from its header, its slot leased, and
        libjpeg decodes it straight into the slot's pinned row; anything
        else, or a stream the C side rejects, is decoded by PIL and copied
        in. Raises ValueError if the bytes are no decodable image, and the
        batcher's BacklogFull or ShuttingDown."""
        eng, batcher = self.engine, self.batcher
        buckets, wire = self.cfg.canvas_buckets, self.cfg.wire_format
        if eng.ragged:
            plan = native.plan_decode_packed(data, buckets)
            if plan is not None:
                s, need, _, _ = plan
                lease = batcher.lease_ragged(need, s)
                leases.append(lease)
                hw = native.decode_packed_into(data, lease.row, s)
        else:
            plan = native.plan_decode(data, buckets, wire)
            if plan is not None:
                s, shape, _ = plan
                lease = batcher.lease(shape)
                leases.append(lease)
                hw = native.decode_into_row(data, lease.row, s, wire, trailer=True)
        if plan is not None:
            if hw is not None:
                lease.commit(hw)
                eng.count_decode("native")
                return
            leases.pop().release()  # the header parsed, the stream did not: PIL tries
        try:  # PIL: UnidentifiedImageError is an OSError
            if eng.ragged:
                canvas, hw, s = fit_to_bucket(decode_image(data), buckets)
            else:
                canvas, hw, _ = native.decode_pil(data, buckets, wire)
        except (OSError, ValueError) as e:
            raise ValueError(f"cannot decode image: {e}") from e
        lease = (batcher.lease_ragged(canvas.nbytes, s) if eng.ragged
                 else batcher.lease(canvas.shape))
        leases.append(lease)
        lease.commit(hw, canvas=canvas)
        eng.count_decode("pil")

    def healthz(self) -> tuple[int, dict]:
        ok = self.engine.healthcheck()
        return (200 if ok else 503), {"ok": ok}

    def stats(self) -> tuple[int, dict]:
        return 200, {"batcher": self.batcher.stats(), "engine": self.engine.stats()}


def make_handler(app: App) -> type[BaseHTTPRequestHandler]:
    max_body = MAX_BODY_MB << 20

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # route access lines to logging
            log.debug("%s " + fmt, self.address_string(), *args)

        def _send(self, status: int, payload: dict, headers: dict | None = None) -> None:
            body = json.dumps(payload).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for key, value in (headers or {}).items():
                self.send_header(key, value)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            path = urlsplit(self.path).path
            if path == "/healthz":
                self._send(*app.healthz())
            elif path == "/stats":
                self._send(*app.stats())
            else:
                self._send(*_error(404, f"no route {path}"))

        def do_POST(self):
            url = urlsplit(self.path)
            if url.path != "/predict":
                self._send(*_error(404, f"no route {url.path}"))
                return
            try:
                length = int(self.headers.get("Content-Length", ""))
            except ValueError:
                self.close_connection = True
                self._send(*_error(411, "Content-Length required"))
                return
            if length > max_body:
                self.close_connection = True  # the body is left unread
                self._send(*_error(413, f"body exceeds {MAX_BODY_MB} MB cap"))
                return
            body = self.rfile.read(length)
            try:
                self._send(*app.predict(body, self.headers.get("Content-Type", ""), url.query))
            except Exception as e:  # answer 500 and keep the server up
                log.exception("predict failed")
                self._send(*_error(500, f"{type(e).__name__}: {e}"))

    return Handler


class _Server(ThreadingHTTPServer):
    daemon_threads = True
    # the default backlog of 5 resets connections under a concurrent burst
    request_queue_size = 128


def make_http_server(app: App, host: str, port: int) -> ThreadingHTTPServer:
    return _Server((host, port), make_handler(app))
