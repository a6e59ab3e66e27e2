"""The window's arithmetic: the rate over all the window's work and time,
the tail over every call, on a recorded list with a stall in it."""

from __future__ import annotations

import math
import threading
import time

import pytest

from yardstick import photos
from yardstick.loadgen import Call, Window, closed_loop, percentile


def recorded_window_with_a_stall() -> Window:
    """10 s; 100 calls of 32 photos, 0.1 s each, then a stall: 4 calls sent
    at 9.6 s that answer 3 s later, past the close; one call failed."""
    w = Window(t0=0.0, t1=10.0)
    for i in range(95):
        w.calls.append(Call(client=i % 16, body=0, t_send=i * 0.1, t_done=i * 0.1 + 0.1,
                            status=200))
    w.calls.append(Call(client=0, body=0, t_send=9.5, status=None, error="timeout"))
    for i in range(4):
        w.calls.append(Call(client=i, body=0, t_send=9.6, t_done=12.6, status=200))
    return w


def test_rate_counts_photos_answered_by_the_close_over_the_whole_window():
    w = recorded_window_with_a_stall()
    assert w.seconds == 10.0
    # 95 calls answered by 10 s (the last at 9.5 s); the stalled 4 end later
    assert w.photos_answered([32]) == 95 * 32
    assert w.photos_answered([32]) / w.seconds == 304.0


def test_tail_takes_every_call_and_a_failure_misses():
    w = recorded_window_with_a_stall()
    lat = w.latencies_ms()
    assert len(lat) == 100
    assert lat[-1] == math.inf  # the failed call
    assert sorted(lat[-5:-1]) == pytest.approx([3000.0] * 4)  # the stalled calls count, though late
    # rank round(0.95 * 99) = 94 of 0..99: the 95 quick calls hold ranks 0..94
    assert percentile(lat, 95) == pytest.approx(100.0)
    assert percentile(lat, 96) == pytest.approx(3000.0)
    assert percentile(lat, 100) == math.inf
    assert percentile([], 95) is None


def test_percentile_is_tools_loadgen_nearest_rank():
    xs = [float(i) for i in range(1, 21)]
    assert percentile(xs, 50) == 11.0  # round(0.5 * 19) = 10 (banker's: 9.5 → 10)
    assert percentile(xs, 95) == 19.0
    assert percentile(xs, 0) == 1.0


def test_calls_hold_every_size_alike_and_the_seed_orders_them():
    tf = {"sizes": [[320, 240], [240, 320], [512, 384], [384, 512]], "pool_per_size": 6,
          "photos_per_call": 8, "calls": 5}
    a, b = photos.make_calls(tf, 2**31 + 11), photos.make_calls(tf, 7)
    assert a == photos.make_calls(tf, 2**31 + 11) and a != b
    for call in a + b:
        assert len(set(call)) == 8
        assert sorted(i // 6 for i in call) == [0, 0, 1, 1, 2, 2, 3, 3]


def test_one_photo_a_call_takes_the_sizes_in_turn():
    tf = {"sizes": [[320, 240], [240, 320], [512, 384]], "pool_per_size": 4,
          "photos_per_call": 1, "calls": 9}
    calls = photos.make_calls(tf, 2**31 + 5)
    assert [c[0] // 4 for c in calls] == [0, 1, 2] * 3
    assert photos.body([b"\xff\xd8x\xff\xd9"]) == (b"\xff\xd8x\xff\xd9", "image/jpeg")


def test_multipart_body_carries_every_photo():
    jpegs = [b"\xff\xd8one\xff\xd9", b"\xff\xd8--loadgenboundary0\xff\xd9"]
    body, ctype = photos.multipart(jpegs)
    boundary = ctype.split("boundary=")[1]
    assert boundary == "loadgenboundary1"  # the first is inside a photo
    assert body.count(f"--{boundary}\r\n".encode()) == 2 and body.endswith(
        f"--{boundary}--\r\n".encode())
    assert all(j in body for j in jpegs)


class _Server:
    """A local HTTP/1.1 server for the closed loop: answers ``{}``, drops
    the connection without an answer on a body of ``drop``, and while
    ``warm`` closes each connection silently after its answer (a server
    that yields an idle keep-alive socket)."""

    def __init__(self):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        self.warm, self.seen, lock = True, [], threading.Lock()
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def do_POST(self):
                body = self.rfile.read(int(self.headers["Content-Length"]))
                with lock:
                    outer.seen.append(body)
                if body == b"drop":
                    self.close_connection = True
                    return
                self.send_response(200)
                self.send_header("Content-Length", "2")
                self.end_headers()
                self.wfile.write(b"{}")
                self.close_connection = outer.warm

            def log_message(self, *args):
                pass

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.httpd.daemon_threads = True
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()

    @property
    def port(self):
        return self.httpd.server_address[1]

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def test_clients_reopen_an_idle_close_and_fail_a_dropped_call():
    srv = _Server()

    def before_window():
        time.sleep(0.3)  # the idle connections' closes have arrived
        srv.warm = False

    bodies = [(b, "application/octet-stream") for b in (b"a", b"drop", b"c", b"d")]
    try:
        w = closed_loop("127.0.0.1", srv.port, "/", bodies, clients=2, seconds=1.0,
                        warmup_calls=1, timeout=10.0, before_window=before_window)
    finally:
        srv.close()
    assert {c.client for c in w.calls} == {0, 1}
    assert all(w.t0 <= c.t_send < w.t1 for c in w.calls)
    kept = [c for c in w.calls if c.body in (0, 2)]
    dropped = [c for c in w.calls if c.body == 1]
    # client 0's first call found its connection closed while idle: reopened, not failed
    assert kept and all(c.ok and c.answer == b"{}" for c in kept)
    assert dropped and all(not c.ok and c.error for c in dropped)
    assert all(c.ok for c in w.calls if c.body == 3)
    # the warmup's dropped call was sent twice, each of the window's once
    assert srv.seen.count(b"drop") == 2 + len(dropped)
