"""The closed loop that drives the window, and its arithmetic.

A copy of the parts of ``tools/loadgen.py`` the benchmark measures with:
one persistent HTTP/1.1 connection a client (``HttpClient``), a closed loop
of clients (``closed_loop``) and the percentile (``percentile``), so that
a later change to the program's tool cannot move the yardstick. What
differs: each client is a process of its own (``yardstick/client.py``),
so that neither the server's interpreter nor the harness's holds it back;
the bodies are made before the window; every call records its send time,
its last byte and its status; a call of the window is sent once, and a
connection fault fails it; the window's rate counts the photos answered
200 by the window's end; the tail is taken over every call sent in the
window, a call that failed counting as missing any limit.
"""

from __future__ import annotations

import http.client
import math
import pickle
import select
import struct
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

CLIENT = Path(__file__).resolve().parent / "client.py"


def percentile(sorted_ms: list[float], q: float) -> float | None:
    """q-th percentile of an ascending list (the nearest rank, rounded, as
    ``tools/loadgen.py``); None when empty."""
    if not sorted_ms:
        return None
    i = min(len(sorted_ms) - 1, int(round(q / 100 * (len(sorted_ms) - 1))))
    return sorted_ms[i]


@dataclass
class Call:
    client: int
    body: int  # index into the bodies
    t_send: float
    t_done: float = math.inf
    status: int | None = None
    answer: bytes = b""
    error: str | None = None

    @property
    def ok(self) -> bool:
        return self.status == 200


@dataclass
class Window:
    t0: float
    t1: float
    calls: list[Call] = field(default_factory=list)

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    def photos_answered(self, photos_per_call: list[int]) -> int:
        """Photos in calls answered 200 by the window's end."""
        return sum(photos_per_call[c.body] for c in self.calls if c.ok and c.t_done <= self.t1)

    def latencies_ms(self) -> list[float]:
        """Every call's latency, ascending; a failed call is +inf."""
        return sorted((c.t_done - c.t_send) * 1e3 if c.ok else math.inf for c in self.calls)


class HttpClient:
    """One persistent HTTP/1.1 connection. Before a request reuses it, a
    connection the server has closed while it sat idle (the program yields
    idle keep-alive sockets to queued ones) is found readable, as
    ``urllib3`` finds a dropped one, and reopened: nothing of the request
    has been sent yet. A connection fault after that fails the request;
    with ``retry`` (set-up and warmup only) it is sent once more on a new
    connection. HTTP errors are answers, never retried."""

    def __init__(self, host: str, port: int, timeout: float):
        self.host, self.port, self.timeout = host, port, timeout
        self.conn: http.client.HTTPConnection | None = None

    def close(self):
        if self.conn is not None:
            self.conn.close()
            self.conn = None

    def request(self, method: str, path: str, body: bytes | None = None,
                headers: dict | None = None, retry: bool = True) -> tuple[int, bytes]:
        for attempt in (0, 1):
            if self.conn is not None and self.conn.sock is not None and select.select(
                    [self.conn.sock], [], [], 0)[0]:
                self.close()  # closed by the server while idle (or stray bytes)
            if self.conn is None:
                self.conn = http.client.HTTPConnection(self.host, self.port, timeout=self.timeout)
            try:
                self.conn.request(method, path, body=body, headers=headers or {})
                resp = self.conn.getresponse()
                data = resp.read()
            except TimeoutError:
                self.close()
                raise
            except (http.client.HTTPException, ConnectionError, OSError):
                self.close()
                if attempt or not retry:
                    raise
                continue
            if resp.will_close:
                self.close()
            return resp.status, data
        raise AssertionError("unreachable")


def read_frame(f) -> bytes:
    """One length-prefixed frame (the clients' pipes)."""
    (n,) = struct.unpack("<Q", f.read(8))
    return f.read(n)


def write_frame(f, data: bytes) -> None:
    f.write(struct.pack("<Q", len(data)) + data)
    f.flush()


def closed_loop(host: str, port: int, path: str, bodies: list[tuple[bytes, str]],
                clients: int, seconds: float, warmup_calls: int, timeout: float = 120.0,
                before_window=None) -> Window:
    """``clients`` processes (``yardstick/client.py``), one call in flight
    each. Client ``i`` sends bodies ``i, i + clients, ...`` cyclically:
    first ``warmup_calls`` (not recorded), then, once every client is warm,
    calls until ``seconds`` after the common start. Calls in flight at the
    close are waited for. ``before_window()`` runs once every client is
    warm, just before the window opens. Every process is waited for."""
    window = Window(0.0, 0.0)
    period = len(bodies) // math.gcd(len(bodies), clients)
    procs = [subprocess.Popen([sys.executable, str(CLIENT)], stdin=subprocess.PIPE,
                              stdout=subprocess.PIPE) for _ in range(clients)]
    try:
        for i, proc in enumerate(procs):
            mine = [(n, *bodies[n]) for n in ((i + m * clients) % len(bodies)
                                              for m in range(period))]
            write_frame(proc.stdin, pickle.dumps({
                "host": host, "port": port, "path": path, "timeout": timeout, "client": i,
                "warmup_calls": warmup_calls, "bodies": mine}))
        for proc in procs:
            if proc.stdout.readline() != b"ready\n":
                raise RuntimeError(f"a client exited before the window ({proc.wait()})")
        if before_window is not None:
            before_window()
        window.t0 = time.perf_counter()
        window.t1 = window.t0 + seconds
        for proc in procs:
            proc.stdin.write(f"{window.t1!r}\n".encode())
            proc.stdin.close()
        for proc in procs:
            window.calls.extend(Call(*fields) for fields in pickle.loads(read_frame(proc.stdout)))
            proc.wait(timeout)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
            proc.stdout.close()
            if not proc.stdin.closed:
                proc.stdin.close()
    return window
