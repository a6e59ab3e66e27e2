"""The port's HTTP/1.1 keep-alive front end (``serving/http.py``
``PoolWSGIServer``), its drain order and its SIGTERM path, on the CPU.

The counterpart of each case of ``tests/test_http_keepalive.py`` against
the port's ``make_http_server`` with a stub WSGI app (cases that repeat
each other are cases of one parametrised test); a table of malformed
requests that the JAX ``App`` behind its pool server and the port's behind
the port's must answer with the same status codes; ``Server.close()``
completing requests in flight; and ``python -m
tensorflow_web_deploy_tpu_torch.server`` in a process of its own: a
request in flight at SIGTERM answers 200 and the process exits 0, and a
second signal during the drain kills it.
"""

import dataclasses
import http.client
import json
import os
import queue
import re
import select
import signal
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from tensorflow_web_deploy_tpu.serving import http as jhttp
from tensorflow_web_deploy_tpu.serving.registry import ModelRegistry as JaxRegistry
from tensorflow_web_deploy_tpu_torch.server import start_server
from tensorflow_web_deploy_tpu_torch.serving import http as thttp
from tensorflow_web_deploy_tpu_torch.serving.http import (
    App,
    make_http_server,
    shutdown_gracefully,
)
from tensorflow_web_deploy_tpu_torch.serving.registry import ModelRegistry
from tensorflow_web_deploy_tpu_torch.utils.config import ModelConfig, ServerConfig
from tensorflow_web_deploy_tpu_torch.utils.metrics import parse_prometheus_text
from tests.test_registry import MockEngine as JaxMockEngine
from tests.test_registry import _cfg as jax_cfg
from tests.test_registry import _mc as jax_mc
from tests.test_torch_registry import MockEngine, _cfg, _mc, jpeg

ROOT = Path(__file__).resolve().parent.parent


class _DummyBatcher:
    def stop(self):
        pass


def _stub_app(environ, start_response):
    """Echo app that reads its declared body."""
    try:
        n = int(environ.get("CONTENT_LENGTH") or 0)
    except ValueError:
        n = 0
    body = environ["wsgi.input"].read(n) if n > 0 else b""
    out = json.dumps({"path": environ["PATH_INFO"], "q": environ["QUERY_STRING"],
                      "len": len(body)}).encode()
    start_response("200 OK", [("Content-Type", "application/json"),
                              ("Content-Length", str(len(out)))])
    return [out]


def _empty_app(environ, start_response):
    """Answers {} and never reads the body."""
    start_response("200 OK", [("Content-Type", "application/json"), ("Content-Length", "2")])
    return [b"{}"]


@pytest.fixture()
def stub_server():
    srv = make_http_server(_stub_app, "127.0.0.1", 0, pool_size=4, keepalive_timeout_s=5.0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield srv
    shutdown_gracefully(srv, _DummyBatcher(), grace_s=3.0)
    thread.join(timeout=5)


def test_two_sequential_requests_over_one_socket(stub_server):
    port = stub_server.server_address[1]
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
    conn.request("POST", "/a", body=b"xx", headers={"Content-Type": "image/jpeg"})
    r1 = conn.getresponse()
    assert r1.status == 200 and json.loads(r1.read())["len"] == 2
    assert not r1.will_close
    sock1 = conn.sock
    conn.request("GET", "/b")
    r2 = conn.getresponse()
    assert r2.status == 200 and json.loads(r2.read())["path"] == "/b"
    assert conn.sock is sock1  # no reconnect
    snap = stub_server.counters.snapshot()
    assert (snap["connections_total"], snap["requests_total"]) == (1, 2)
    assert snap["requests_per_connection"] == 2.0
    conn.close()


def test_connection_close_honored(stub_server):
    conn = http.client.HTTPConnection("127.0.0.1", stub_server.server_address[1], timeout=5)
    conn.request("GET", "/", headers={"Connection": "close"})
    r = conn.getresponse()
    assert r.status == 200 and r.will_close
    r.read()
    conn.close()


def test_unread_body_is_drained_for_next_request(stub_server):
    """An app that never reads wsgi.input must not poison the connection."""
    conn = http.client.HTTPConnection("127.0.0.1", stub_server.server_address[1], timeout=5)
    stub_server.app = _empty_app
    try:
        conn.request("POST", "/skip", body=b"A" * 4096,
                     headers={"Content-Type": "application/octet-stream"})
        r1 = conn.getresponse()
        assert r1.status == 200
        r1.read()
        conn.request("GET", "/after")
        r2 = conn.getresponse()
        assert r2.status == 200
        r2.read()
    finally:
        stub_server.app = _stub_app
        conn.close()


def _one_shot_clients(port, n):
    statuses, lock = [], threading.Lock()

    def one():
        c = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
        try:
            c.request("GET", "/x")
            with lock:
                statuses.append(c.getresponse().status)
        finally:
            c.close()

    threads = [threading.Thread(target=one) for _ in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    return statuses, n


def _persistent_clients(port, n, rounds=5):
    """Keep-alive clients with idle gaps: an idle connection yields its
    worker to a queued one, and the client reconnects."""
    from tools.loadgen import HttpClient, Recorder

    rec, statuses, lock = Recorder(), [], threading.Lock()

    def client_loop():
        cl = HttpClient(f"http://127.0.0.1:{port}/predict", timeout=10)
        try:
            for _ in range(rounds):
                status, _ = cl.post(b"img", "image/jpeg", rec)
                with lock:
                    statuses.append(status)
                time.sleep(0.05)  # idle gap: the worker may be yielded here
        except Exception as e:  # recorded for the assert
            with lock:
                statuses.append(repr(e))
        finally:
            cl.close()

    threads = [threading.Thread(target=client_loop) for _ in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=15)
    assert not any(t.is_alive() for t in threads)
    return statuses, n * rounds


@pytest.mark.parametrize("clients", [_one_shot_clients, _persistent_clients],
                         ids=["one-shot", "persistent"])
def test_more_connections_than_workers_all_served(stub_server, clients):
    """More connections than the pool's 4 workers: they queue and complete
    (one-shot), and persistent ones get their turn well inside the
    keep-alive timeout because idle connections yield their workers."""
    t0 = time.monotonic()
    statuses, want = clients(stub_server.server_address[1], 12)
    assert statuses == [200] * want
    assert time.monotonic() - t0 < 10
    assert stub_server.counters.snapshot()["requests_total"] == want


def _wait_idle_workers(srv, n: int, timeout_s: float = 5.0) -> None:
    """Until ``n`` of the pool's workers wait for a connection. A client has
    its answer before the worker that served it reads the client's close,
    so the last burst's workers may still be inside their connections."""
    deadline = time.monotonic() + timeout_s
    while srv._idle_workers < n:
        assert time.monotonic() < deadline, f"{srv._idle_workers} idle workers, want {n}"
        time.sleep(0.001)


def test_idle_connection_keeps_its_worker_while_others_are_free(stub_server):
    """New connections arriving while workers are free never close an idle
    keep-alive connection: it yields only when every worker is busy."""
    port = stub_server.server_address[1]
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
    conn.request("GET", "/first")
    conn.getresponse().read()
    sock = conn.sock
    for _ in range(60):  # bursts of 3 one-shot connections; 3 workers are free
        _wait_idle_workers(stub_server, 3)
        statuses, n = _one_shot_clients(port, 3)
        assert statuses == [200] * n
    conn.request("GET", "/after")
    r = conn.getresponse()
    assert r.status == 200 and json.loads(r.read())["path"] == "/after"
    assert conn.sock is sock
    assert stub_server.counters.snapshot()["connections_total"] == 181
    conn.close()


def test_a_worker_stays_idle_across_its_waits_timeouts(monkeypatch):
    """A worker polls the draining flag every 0.25 s of its wait for a
    connection; it stays idle throughout, so that an idle keep-alive
    connection never yields to a queued one while that worker is free."""
    seen: list[int] = []
    box: dict = {}

    class RecordingLock:
        """The idle count at every release of the pool's idle lock."""

        def __init__(self):
            self._inner = threading.Lock()

        def __enter__(self):
            self._inner.acquire()

        def __exit__(self, *exc):
            if "srv" in box:
                seen.append(box["srv"]._idle_workers)
            self._inner.release()

    plain = thttp.named_lock
    monkeypatch.setattr(thttp, "named_lock",
                        lambda name: RecordingLock() if name == "http.idle_lock" else plain(name))
    srv = make_http_server(_stub_app, "127.0.0.1", 0, pool_size=1)
    box["srv"] = srv
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        _wait_idle_workers(srv, 1)
        deadline = time.monotonic() + 0.8  # three timed-out waits
        while time.monotonic() < deadline:
            assert not srv.queued_without_worker()
            time.sleep(0.01)
        assert srv._idle_workers == 1
        assert seen and min(seen) == 1, seen
    finally:
        shutdown_gracefully(srv, _DummyBatcher(), grace_s=3.0)


def test_trickling_request_hits_total_read_deadline():
    """A client trickling header bytes resets any per-recv timeout for ever;
    the total read deadline still cuts it off."""
    srv = make_http_server(_stub_app, "127.0.0.1", 0, pool_size=2, keepalive_timeout_s=5.0,
                           request_read_timeout_s=1.0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        with socket.create_connection(("127.0.0.1", srv.server_address[1]), timeout=10) as s:
            s.sendall(b"GET /x HTTP/1.1\r\nHost: x\r\n")  # the header never ends
            t0 = time.monotonic()
            closed_after = None
            for _ in range(12):
                readable, _, _ = select.select([s], [], [], 0.3)
                if readable and s.recv(4096) == b"":
                    closed_after = time.monotonic() - t0
                    break
                try:
                    s.sendall(b"X")  # one header byte per interval
                except OSError:
                    closed_after = time.monotonic() - t0
                    break
            assert closed_after is not None, "the server never closed the trickler"
            assert closed_after < 3.0
    finally:
        shutdown_gracefully(srv, _DummyBatcher(), grace_s=3.0)


def test_request_headers_reach_wsgi_environ(stub_server):
    seen = {}

    def header_app(environ, start_response):
        seen.update({k: v for k, v in environ.items() if k.startswith("HTTP_")})
        return _empty_app(environ, start_response)

    stub_server.app = header_app
    try:
        with socket.create_connection(("127.0.0.1", stub_server.server_address[1]),
                                      timeout=5) as s:
            s.sendall(b"GET /h HTTP/1.1\r\nHost: x\r\nAuthorization: Bearer t\r\n"
                      b"X-Multi: a\r\nX-Multi: b\r\nConnection: close\r\n\r\n")
            while s.recv(4096):
                pass
    finally:
        stub_server.app = _stub_app
    assert seen["HTTP_AUTHORIZATION"] == "Bearer t"
    assert seen["HTTP_X_MULTI"] == "a,b"
    assert seen["HTTP_HOST"] == "x"


def test_head_request_served_and_connection_survives(stub_server):
    conn = http.client.HTTPConnection("127.0.0.1", stub_server.server_address[1], timeout=5)
    conn.request("HEAD", "/healthz")
    r = conn.getresponse()
    assert r.status == 200 and r.read() == b""
    conn.request("GET", "/after-head")
    r2 = conn.getresponse()
    assert r2.status == 200 and json.loads(r2.read())["path"] == "/after-head"
    conn.close()


@pytest.mark.parametrize("request_bytes,status", [
    (b"POST /p HTTP/1.1\r\nHost: x\r\nTransfer-Encoding: chunked\r\n\r\n"
     b"4\r\nabcd\r\n0\r\n\r\n", "411"),
    (b"POST /p HTTP/1.1\r\nHost: x\r\nContent-Length: abc\r\n\r\n", "200"),
], ids=["chunked", "garbage-length"])
def test_unframeable_request_answered_and_closed(stub_server, request_bytes, status):
    """A chunked body (411) or a garbage Content-Length leaves the body's
    framing unknowable: the answer carries Connection: close."""
    with socket.create_connection(("127.0.0.1", stub_server.server_address[1]), timeout=5) as s:
        s.sendall(request_bytes)
        data = s.recv(65536).decode("latin-1")
    assert data.startswith(f"HTTP/1.1 {status}")
    assert "connection: close" in data.lower()


def test_graceful_shutdown_completes_inflight_and_stops_workers():
    release = threading.Event()

    def slow_app(environ, start_response):
        release.wait(timeout=5)
        out = b'{"done": true}'
        start_response("200 OK", [("Content-Type", "application/json"),
                                  ("Content-Length", str(len(out)))])
        return [out]

    srv = make_http_server(slow_app, "127.0.0.1", 0, pool_size=2, keepalive_timeout_s=5.0)
    port = srv.server_address[1]
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    got = {}

    def client():
        c = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
        c.request("GET", "/slow")
        got["resp"] = json.loads(c.getresponse().read())
        c.close()

    t = threading.Thread(target=client)
    t.start()
    time.sleep(0.2)  # the request reaches slow_app

    def unblock():
        time.sleep(0.2)  # shutdown_gracefully starts draining first
        release.set()

    threading.Thread(target=unblock).start()
    shutdown_gracefully(srv, _DummyBatcher(), grace_s=5.0)
    t.join(timeout=5)
    assert got.get("resp") == {"done": True}
    assert not any(w.is_alive() for w in srv._workers)
    with pytest.raises(OSError):
        socket.create_connection(("127.0.0.1", port), timeout=1).close()


def test_loadgen_client_reuses_and_reconnects(stub_server):
    from tools.loadgen import HttpClient, Recorder

    url = f"http://127.0.0.1:{stub_server.server_address[1]}/predict"
    rec = Recorder()
    cl = HttpClient(url, timeout=5)
    for _ in range(5):
        assert cl.post(b"img", "image/jpeg", rec)[0] == 200
    assert rec.connections == 1
    cl.conn.sock.close()  # a server-side close: the next post reconnects once
    assert cl.post(b"img", "image/jpeg", rec)[0] == 200
    assert rec.connections == 2
    cl.close()
    rec2 = Recorder()
    cl2 = HttpClient(url, timeout=5, keepalive=False)
    for _ in range(3):
        assert cl2.post(b"img", "image/jpeg", rec2)[0] == 200
    assert rec2.connections == 3
    cl2.close()


# ------------------------------------- malformed requests: the port and the JAX App


def _raw(port, data: bytes, trickle: bytes = b"") -> str:
    """Send raw bytes (then ``trickle`` a byte at a time, slowly) and return
    the answer's status code."""
    with socket.create_connection(("127.0.0.1", port), timeout=10) as s:
        s.sendall(data)
        for b in trickle:
            time.sleep(0.15)
            try:
                s.sendall(bytes([b]))
            except OSError:
                break
        out = b""
        while b"\r\n" not in out:
            chunk = s.recv(4096)
            if not chunk:
                break
            out += chunk
    return out.split(b" ", 2)[1].decode() if out else "closed"


def _http(method, path, body=b"", ctype="application/json", length=None):
    length = str(len(body)) if length is None else length
    return (f"{method} {path} HTTP/1.1\r\nHost: x\r\nContent-Type: {ctype}\r\n"
            f"Content-Length: {length}\r\n\r\n").encode() + body


MALFORMED = {
    "unknown-model": (_http("POST", "/predict?model=nope", b"img", "image/jpeg"), b""),
    "bad-json": (_http("POST", "/models/load", b"not json"), b""),
    "unload-without-name": (_http("POST", "/models/unload", b"{}"), b""),
    "get-on-admin-route": (_http("GET", "/models/swap"), b""),
    "chunked": (b"POST /predict HTTP/1.1\r\nHost: x\r\nTransfer-Encoding: chunked\r\n\r\n"
                b"3\r\nimg\r\n0\r\n\r\n", b""),
    "garbage-length": (_http("POST", "/predict", length="abc"), b""),
    # the body never arrives in full: the read deadline answers
    "trickled-body": (_http("POST", "/predict", b"", "image/jpeg", length="100"),
                      b"abcdefghij"),
}
WANT = {"unknown-model": "404", "bad-json": "400", "unload-without-name": "400",
        "get-on-admin-route": "405", "chunked": "411", "garbage-length": "413",
        "trickled-body": "408"}


@pytest.fixture(scope="module")
def both_servers():
    """The JAX App behind its pool server and the port's behind the port's,
    each over a one-model registry of mock engines, both with a 1 s read
    deadline and a 1 MiB response cache."""
    jcfg = dataclasses.replace(jax_cfg(), cache_bytes=1 << 20)
    jreg = JaxRegistry(jcfg, engine_factory=lambda mc: JaxMockEngine(),
                       spec_resolver=jax_mc)
    jreg.load("m1", wait=True)
    jsrv = jhttp.make_http_server(jhttp.App.from_registry(jreg, jcfg), "127.0.0.1", 0,
                                  pool_size=4, request_read_timeout_s=1.0)
    cfg = dataclasses.replace(_cfg(), cache_bytes=1 << 20)
    treg = ModelRegistry(cfg, engine_factory=lambda mc: MockEngine(cfg), spec_resolver=_mc)
    treg.load("m1", wait=True)
    tsrv = make_http_server(App(treg, cfg), "127.0.0.1", 0, pool_size=4,
                            request_read_timeout_s=1.0)
    for srv in (jsrv, tsrv):
        threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield jsrv, tsrv
    jhttp.shutdown_gracefully(jsrv, jreg, grace_s=3.0)
    shutdown_gracefully(tsrv, treg, grace_s=3.0)


@pytest.fixture(scope="module")
def both_apps(both_servers):
    """The two servers' ports: (JAX, port)."""
    return tuple(srv.server_address[1] for srv in both_servers)


@pytest.mark.parametrize("case", list(MALFORMED))
def test_malformed_requests_answer_as_the_jax_app(both_apps, case):
    jport, tport = both_apps
    data, trickle = MALFORMED[case]
    assert _raw(tport, data, trickle) == _raw(jport, data, trickle) == WANT[case]


# ------------------------------------------ repairs: the body cap and the envelope


def test_body_cap_is_the_references_32_000_000_bytes(both_apps):
    """A declared Content-Length of 32,000,001 (past the reference's
    int(32.0 * 1e6), within the 32 MiB the port capped at before) gets the
    same 413 and body from both Apps, before the body is read."""
    answers = []
    for port in both_apps:
        with socket.create_connection(("127.0.0.1", port), timeout=10) as s:
            s.sendall(_http("POST", "/predict", b"", "image/jpeg", length="32000001"))
            out = b""
            while b"\r\n\r\n" not in out or not out.rstrip().endswith(b"}"):
                chunk = s.recv(4096)
                if not chunk:
                    break
                out += chunk
        head, _, body = out.partition(b"\r\n\r\n")
        answers.append((head.split(b" ", 2)[1], json.loads(body)))
    assert answers[0] == answers[1] == (b"413", {"error": "body exceeds 32.0 MB cap"})


def test_a_200_carries_latency_ms_and_trace_id_outside_the_etag(both_apps):
    """On a miss, a hit and a 2-image answer both Apps' bodies have the same
    keys, ``latency_ms`` among them; ``trace_id`` is the X-Trace-Id header;
    the ETag of the hit is the miss's (it covers the payload, not the
    envelope)."""
    img = jpeg(24, 18, 7)
    parts = b"".join(b"--zZ\r\nContent-Disposition: form-data; name=\"f\"; filename=\"%d.jpg\""
                     b"\r\n\r\n" % i + jpeg(24, 18, 8 + i) + b"\r\n" for i in range(2))
    multi = parts + b"--zZ--\r\n"
    keys = []
    for port in both_apps:
        answers = [_get(port, "POST", "/predict", img) for _ in range(2)]
        answers.append(_get(port, "POST", "/predict", multi,
                            {"Content-Type": "multipart/form-data; boundary=zZ"}))
        (_, miss, _), (_, hit, _) = answers[:2]
        assert (miss["X-Cache"], hit["X-Cache"]) == ("miss", "hit")
        assert miss["ETag"] == hit["ETag"]
        docs = []
        for status, hdr, body in answers:
            doc = json.loads(body)
            assert status == 200 and doc["trace_id"] == hdr["X-Trace-Id"]
            assert isinstance(doc["latency_ms"], float) and doc["latency_ms"] >= 0
            docs.append(doc)
        assert len(docs[2]["results"]) == 2
        keys.append([sorted(d) for d in docs])
    assert keys[0] == keys[1]


# ------------------------------------------------- tracing, metrics and telemetry


def _get(port, method, path, body=b"", headers=None):
    """(status, headers, body) of one request on a fresh connection."""
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    c.request(method, path, body=body, headers={"Content-Type": "image/jpeg",
                                                **(headers or {})})
    r = c.getresponse()
    out = r.status, dict(r.getheaders()), r.read()
    c.close()
    return out


def _traffic(port):
    """The same requests to either server: two JPEGs, a 404, a 400."""
    for seed in (0, 1):
        assert _get(port, "POST", "/predict", jpeg(20, 30, seed))[0] == 200
    assert _get(port, "POST", "/predict?model=nope", b"img")[0] == 404
    assert _get(port, "POST", "/predict?deadline_ms=banana", b"img")[0] == 400


_ID_RE = re.compile(r"^[0-9a-f]{10}-[0-9a-f]{8}$")


@pytest.mark.parametrize("path,method", [("/healthz", "GET"), ("/predict?model=nope", "POST"),
                                         ("/predict?deadline_ms=x", "POST"), ("/stats", "GET")])
def test_trace_id_is_echoed_and_unsafe_ids_replaced(both_apps, path, method):
    for port in both_apps:
        _, hdr, _ = _get(port, method, path, b"img", {"X-Trace-Id": "client.trace-1"})
        assert hdr["X-Trace-Id"] == "client.trace-1"
        _, hdr, _ = _get(port, method, path, b"img", {"X-Trace-Id": "bad id; drop"})
        assert _ID_RE.match(hdr["X-Trace-Id"])
        _, hdr, _ = _get(port, method, path, b"img")
        assert _ID_RE.match(hdr["X-Trace-Id"])


def _families(port) -> tuple[dict, dict]:
    """(family → type, sample name → label keys) of one /metrics scrape."""
    status, hdr, body = _get(port, "GET", "/metrics")
    assert status == 200 and hdr["Content-Type"].startswith("text/plain; version=0.0.4")
    doc = parse_prometheus_text(body.decode())
    labels: dict = {}
    for name, lbls in doc["samples"]:
        labels.setdefault(name, set()).add(tuple(sorted(k for k, _ in lbls)))
    return doc["types"], labels


# the reference's families of modules the port has not ported yet
UNPORTED = ("tpu_serve_pipeline_", "tpu_serve_job")


def test_metrics_families_and_label_keys_are_the_references(both_apps):
    jport, tport = both_apps
    _traffic(jport)
    _traffic(tport)
    jtypes, jlabels = _families(jport)
    ttypes, tlabels = _families(tport)
    missing = {f for f in jtypes if not f.startswith(UNPORTED)} - set(ttypes)
    assert not missing
    assert all(ttypes[f] == jtypes[f] for f in set(jtypes) & set(ttypes))
    for name in set(jlabels) & set(tlabels):
        assert tlabels[name] == jlabels[name], name
    # every family the port exports is named in the reference's front end
    src = (ROOT / "tensorflow_web_deploy_tpu" / "serving" / "http.py").read_text()
    named = set(re.findall(r'p\.(?:scalar|histogram)\(\s*f?"([a-z0-9_{}]+)"', src))
    named |= {f"chaos_{k}_total" for k in ("decode_failures_injected",
                                           "dispatch_failures_injected",
                                           "slow_fetches_injected", "spike_holds_injected")}
    assert {f[len("tpu_serve_"):] for f in ttypes} <= named


def test_metrics_histogram_count_equals_requests_total(both_apps):
    _, tport = both_apps
    _traffic(tport)
    status, _, body = _get(tport, "GET", "/metrics")
    s = parse_prometheus_text(body.decode())["samples"]
    total = sum(v for (n, _), v in s.items() if n == "tpu_serve_requests_total")
    inf = s[("tpu_serve_request_duration_seconds_bucket", (("le", "+Inf"),))]
    assert total == inf == s[("tpu_serve_request_duration_seconds_count", ())] > 0
    stages = {dict(lb)["stage"] for (n, lb), _ in s.items()
              if n == "tpu_serve_stage_duration_seconds_count"}
    assert {"http_read", "body_read", "lease_wait", "image_decode", "staging_write",
            "queue_wait", "device_dispatch", "device_execute", "postprocess",
            "serialize"} <= stages


def _keys(obj, depth=2):
    """A JSON document's key structure, ``depth`` levels down."""
    if not isinstance(obj, dict) or depth == 0:
        return type(obj).__name__
    return {k: _keys(v, depth - 1) for k, v in obj.items()}


def test_debug_routes_and_stats_blocks_have_the_references_shapes(both_servers):
    jsrv, tsrv = both_servers
    docs = []
    for srv in both_servers:
        port = srv.server_address[1]
        _traffic(port)
        srv.app.telemetry.sample_once()
        srv.app.telemetry.sample_once()
        doc = {}
        for path in ("/debug/slow", "/debug/history", "/debug/history?series=goodput_rps",
                     "/debug/events", "/debug/trace?last_s=60", "/stats"):
            status, _, body = _get(port, "GET", path)
            assert status == 200, path
            doc[path] = json.loads(body)
        assert _get(port, "GET", "/debug/history?series=nope")[0] == 400
        assert _get(port, "GET", "/debug/history?last_s=x")[0] == 400
        docs.append(doc)
    j, t = docs
    slow_j, slow_t = j.pop("/debug/slow"), t.pop("/debug/slow")
    assert _keys(slow_t) == _keys(slow_j)
    assert _keys(slow_t["slowest"][0], 1) == _keys(slow_j["slowest"][0], 1)
    hist_t = t["/debug/history?series=goodput_rps"]
    assert _keys(hist_t, 1) == _keys(j["/debug/history?series=goodput_rps"], 1)
    assert hist_t["series"]["goodput_rps"]["rows"]
    assert _keys(t["/debug/history"], 1) == _keys(j["/debug/history"], 1)
    assert _keys(t["/debug/events"], 1) == _keys(j["/debug/events"], 1)
    trace_t, trace_j = t["/debug/trace?last_s=60"], j["/debug/trace?last_s=60"]
    assert _keys(trace_t) == _keys(trace_j)
    assert {e["ph"] for e in trace_t["traceEvents"]} >= {"M", "X", "b", "e"}
    st_t, st_j = t["/stats"], j["/stats"]
    # what tools/loadgen.py reads: the tracing block and the batch histogram
    assert _keys(st_t["tracing"], 1) == _keys(st_j["tracing"], 1)
    assert _keys(st_t["tracing"]["e2e"]) == _keys(st_j["tracing"]["e2e"])
    # the port's image_decode also carries its threads' CPU ms
    decode_t = dict(st_t["tracing"]["stages"]["image_decode"])
    assert decode_t.pop("cpu_ms") >= 0
    assert _keys(decode_t) == _keys(st_j["tracing"]["stages"]["http_read"])
    assert "batch_size_histogram" in st_t and isinstance(st_t["economics"], dict)
    assert _keys(st_t["telemetry"], 1) == _keys(st_j["telemetry"], 1)
    assert st_t["economics"]["m1@1"]["padding"]  # the mock engine keeps no cells


def test_access_log_has_one_line_per_request(tmp_path):
    cfg = dataclasses.replace(_cfg(), access_log=str(tmp_path / "access.log"),
                              telemetry_interval_s=0.0)
    reg = ModelRegistry(cfg, engine_factory=lambda mc: MockEngine(cfg), spec_resolver=_mc)
    reg.load("m1", wait=True)
    srv = make_http_server(App(reg, cfg), "127.0.0.1", 0, pool_size=2)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        port = srv.server_address[1]
        ids = [_get(port, "POST", "/predict", jpeg(20, 20, i))[1]["X-Trace-Id"]
               for i in range(3)]
        ids.append(_get(port, "GET", "/healthz")[1]["X-Trace-Id"])
        ids.append(_get(port, "POST", "/predict?model=nope", b"x")[1]["X-Trace-Id"])
        assert srv.app.telemetry is None
        assert _get(port, "GET", "/debug/history")[0] == 404
        assert _get(port, "GET", "/debug/events")[0] == 404
    finally:
        shutdown_gracefully(srv, reg, grace_s=3.0)
    lines = [json.loads(ln) for ln in (tmp_path / "access.log").read_text().splitlines()]
    assert [d["trace_id"] for d in lines[:5]] == ids
    assert [d["status"] for d in lines[:5]] == [200, 200, 200, 200, 404]
    assert all("stages_ms" in d and "ts" in d for d in lines)
    assert lines[0]["meta"]["batch_bucket"] in MockEngine.batch_buckets


def test_profiler_capture_writes_a_trace_and_refuses_a_second(both_apps, tmp_path):
    _, port = both_apps
    out = {}

    def first():
        out["first"] = _get(port, "POST", f"/debug/trace?ms=1500&dir={tmp_path}")

    t = threading.Thread(target=first)
    t.start()
    deadline = time.monotonic() + 10
    while not thttp._PROFILE_LOCK.locked() and time.monotonic() < deadline:
        time.sleep(0.01)  # the first capture has begun
    second = _get(port, "POST", f"/debug/trace?ms=10&dir={tmp_path}")
    t.join(timeout=60)
    assert not t.is_alive()
    assert second[0] == 409
    status, _, body = out["first"]
    assert status == 200
    doc = json.loads(body)
    assert doc["captured_ms"] == 1500 and doc["activities"][0] == "CPU"
    with open(doc["trace_file"]) as f:
        assert "traceEvents" in json.load(f)
    assert _get(port, "POST", "/debug/trace?ms=abc")[0] == 400


# ------------------------------------------------- the real stack: drain and SIGTERM

TINY = dict(name="mobilenet_v2", zoo_width=0.25, zoo_classes=10, input_size=(64, 64),
            dtype="float32")


def test_server_close_completes_requests_in_flight():
    """Requests held in an open batch (a 20 s window) when ``close()``
    starts answer 200 long before the window ends: the drain seals and
    dispatches them. Then the workers are gone and the port is closed."""
    cfg = ServerConfig(model=ModelConfig(**TINY), host="127.0.0.1", port=0,
                       canvas_buckets=(64,), max_batch=4, max_delay_ms=20000,
                       adaptive_delay=False, ragged=True)
    srv = start_server(cfg, device="cpu")
    results = []

    def client(seed):
        c = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=30)
        c.request("POST", "/predict", body=jpeg(40, 50, seed),
                  headers={"Content-Type": "image/jpeg"})
        r = c.getresponse()
        results.append((r.status, json.loads(r.read())))
        c.close()

    threads = [threading.Thread(target=client, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    time.sleep(0.5)  # the three sit in the open batch
    assert srv.batcher.stats()["queued"] == 3
    t0 = time.monotonic()
    srv.close(grace_s=5.0)
    for t in threads:
        t.join(timeout=10)
    assert time.monotonic() - t0 < 10  # sealed by the drain, not the window
    assert [s for s, _ in results] == [200] * 3
    assert all(len(b["predictions"]) == 5 for _, b in results)
    assert not any(w.is_alive() for w in srv.httpd._workers)
    assert srv.registry.default_entry().engine.model is None  # closed
    with pytest.raises(OSError):
        socket.create_connection(("127.0.0.1", srv.port), timeout=1).close()


def _boot_cli(extra=()):
    """``python -m tensorflow_web_deploy_tpu_torch.server`` on the CPU with a
    tiny MobileNetV2 and a 1.5 s batch window; (process, port, log lines)."""
    cmd = [sys.executable, "-m", "tensorflow_web_deploy_tpu_torch.server", "--device", "cpu",
           "--model", "native:mobilenet_v2", "--dtype", "f32", "--zoo-width", "0.25",
           "--zoo-classes", "10", "--canvas-buckets", "64", "--max-batch", "2",
           "--host", "127.0.0.1", "--port", "0", "--max-delay-ms", "1500",
           "--no-adaptive-delay", *extra]
    env = dict(os.environ, OMP_NUM_THREADS="2")
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, env=env)
    lines: queue.Queue = queue.Queue()
    threading.Thread(target=lambda: [lines.put(ln) for ln in proc.stdout], daemon=True).start()
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline:
        try:
            ln = lines.get(timeout=1)
        except queue.Empty:
            if proc.poll() is not None:
                break
            continue
        m = re.search(r"listening on http://127\.0\.0\.1:(\d+)", ln)
        if m:
            return proc, int(m.group(1)), lines
    proc.kill()
    proc.wait(10)
    raise AssertionError("the server did not boot")


def test_sigterm_drains_in_flight_requests_and_exits_zero():
    proc, port, _ = _boot_cli()
    try:
        got = {}

        def client():
            c = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
            c.request("POST", "/predict", body=jpeg(40, 50, 1),
                      headers={"Content-Type": "image/jpeg"})
            r = c.getresponse()
            got["answer"] = (r.status, json.loads(r.read()))
            c.close()

        t = threading.Thread(target=client)
        t.start()
        time.sleep(0.5)  # in the open batch, 1 s before its window ends
        proc.send_signal(signal.SIGTERM)
        t.join(timeout=30)
        assert got["answer"][0] == 200 and len(got["answer"][1]["predictions"]) == 5
        assert proc.wait(timeout=20) == 0
        with pytest.raises(OSError):
            socket.create_connection(("127.0.0.1", port), timeout=1).close()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)


def test_second_sigterm_kills_during_the_drain():
    """A connection whose answers go unread holds its worker in a write, so
    the drain waits out its 10 s grace; a second SIGTERM then takes the
    default action and kills the process."""
    proc, port, _ = _boot_cli()
    s = socket.create_connection(("127.0.0.1", port), timeout=30)
    try:
        page = b"GET / HTTP/1.1\r\nHost: x\r\n\r\n"
        threading.Thread(target=lambda: s.sendall(page * 20000), daemon=True).start()
        time.sleep(1.0)  # the worker blocks writing upload pages nobody reads
        proc.send_signal(signal.SIGTERM)
        time.sleep(1.0)
        assert proc.poll() is None, "the drain ended before the grace"
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=5) == -signal.SIGTERM
    finally:
        s.close()
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)
