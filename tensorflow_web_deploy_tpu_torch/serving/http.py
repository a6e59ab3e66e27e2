"""HTTP front end (a lean counterpart of the JAX package's
``serving/http.py``) on the standard library's ``ThreadingHTTPServer``.

Routes:

- ``POST /predict`` — a raw image body or a multipart upload; ``?topk=N``
  returns at most N predictions. One image answers
  ``{"predictions": [{"label", "index", "score"}], "model"}``; several
  file parts, or ``?batch=1``, answer ``{"results": [...], "model"}``.
  The images of one request are submitted together, so they usually
  share one device batch.
- ``GET /healthz`` — a one-image device round trip.
- ``GET /stats`` — batcher and engine counters: kernel launches, native
  and PIL decodes, the decoder's status (and why it is unavailable).
"""

from __future__ import annotations

import json
import logging
from concurrent.futures import TimeoutError as FutureTimeout
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlsplit

from ..utils.labels import load_labels
from .batcher import ShuttingDown

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

    def predict(self, body: bytes, content_type: str, query: str) -> tuple[int, dict]:
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
        # decode every file first (libjpeg for JPEGs, PIL for the rest), so
        # an undecodable one answers 400 before any image is queued
        prepared = []
        for name, data in named:
            try:
                if self.engine.ragged:
                    tight, hw, s, _orig = self.engine.prepare_ragged(data)
                    prepared.append((self.batcher.submit_ragged, (tight, hw, s)))
                else:
                    canvas, hw, _orig = self.engine.prepare_bytes(data)
                    prepared.append((self.batcher.submit, (canvas, hw)))
            except ValueError as e:
                return _error(400, f"{name}: {e}")
        try:
            futures = [submit(*args) for submit, args in prepared]
            rows = [f.result(timeout=REQUEST_TIMEOUT_S) for f in futures]
        except ShuttingDown:
            return _error(503, "server shutting down")
        except FutureTimeout:
            return _error(504, "inference timed out")
        payloads = [self._row(r, topk) for r in rows]
        if len(payloads) == 1 and qs.get("batch", [""])[-1] != "1":
            resp = payloads[0]
        else:
            resp = {"results": payloads}
        resp["model"] = self.cfg.model.name
        return 200, resp

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

        def _send(self, status: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
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
