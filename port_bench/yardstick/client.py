"""One client of the closed loop, in a process of its own.

    python3 port_bench/yardstick/client.py

Started by :func:`yardstick.loadgen.closed_loop`, which writes to its
stdin a length-prefixed pickle (host, port, path, timeout, client number,
warmup calls, and its bodies as ``[(body index, bytes, content type)]``),
and later one line: the window's end on ``time.perf_counter``'s clock
(CLOCK_MONOTONIC, shared by every process of the machine). The client
sends its warmup calls on one persistent connection, writes ``ready``,
waits for that line, then sends its bodies in turn, one call in flight,
until the window's end; then it writes its calls to stdout as a
length-prefixed pickle of :class:`yardstick.loadgen.Call` fields.
"""

from __future__ import annotations

import pickle
import sys
import time
from dataclasses import astuple
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from yardstick.loadgen import Call, HttpClient, read_frame, write_frame  # noqa: E402


def send(client: HttpClient, path: str, n: int, body: bytes, ctype: str, i: int,
         retry: bool) -> Call:
    call = Call(i, n, time.perf_counter())
    try:
        call.status, call.answer = client.request("POST", path, body, {"Content-Type": ctype},
                                                  retry=retry)
        call.t_done = time.perf_counter()
    except Exception as e:  # a call that never answers is a failed call
        call.error = f"{type(e).__name__}: {e}"
    return call


def main() -> int:
    stdin, stdout = sys.stdin.buffer, sys.stdout.buffer
    spec = pickle.loads(read_frame(stdin))
    bodies, i, path = spec["bodies"], spec["client"], spec["path"]
    client = HttpClient(spec["host"], spec["port"], spec["timeout"])
    calls, k = [], 0
    try:
        for _ in range(spec["warmup_calls"]):  # a warmup call may reconnect and resend
            send(client, path, *bodies[k % len(bodies)], i, retry=True)
            k += 1
        stdout.write(b"ready\n")
        stdout.flush()
        t1 = float(stdin.readline())
        while time.perf_counter() < t1:  # a window's call is sent once
            calls.append(send(client, path, *bodies[k % len(bodies)], i, retry=False))
            k += 1
    finally:
        client.close()
    write_frame(stdout, pickle.dumps([astuple(c) for c in calls]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
