"""The system under test in a child process: the program's HTTP server,
started from the checkout on a free port, waited for, read over HTTP and
stopped.

The server's build caches stay at fixed paths inside the checkout: its
kernel libraries and decoder in the program's ``.build/`` (its
``--aot-cache-dir`` default), and the directories PyTorch's extension
builder and Triton would use under ``port_bench/.cache/``. Its log goes
to a file in the run's temporary directory.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

from .loadgen import HttpClient

ROOT = Path(__file__).resolve().parents[2]
PACKAGE = "tensorflow_web_deploy_tpu_torch"
CACHE = ROOT / "port_bench" / ".cache"


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def server_command(args: list[str]) -> list[str]:
    """The program's server with ``args``."""
    return [sys.executable, "-m", f"{PACKAGE}.server", *args]


class ServerProcess:
    def __init__(self, args: list[str], log_path: Path):
        if not (ROOT / PACKAGE / "server.py").is_file():
            raise FileNotFoundError(f"the program ({PACKAGE}) is not in this checkout")
        self.port = free_port()
        self.log_path = log_path
        env = dict(os.environ, PYTHONPATH=str(ROOT),
                   TORCH_EXTENSIONS_DIR=str(CACHE / "torch_extensions"),
                   TRITON_CACHE_DIR=str(CACHE / "triton"))
        self._log = open(log_path, "wb")
        self.proc = subprocess.Popen(
            server_command([*args, "--host", "127.0.0.1", "--port", str(self.port)]),
            cwd=ROOT, env=env, stdout=self._log, stderr=subprocess.STDOUT)
        self.client = HttpClient("127.0.0.1", self.port, timeout=60.0)

    def wait_ready(self, timeout_s: float) -> None:
        """Until the port answers ``GET /healthz`` with 200 (the server binds
        its port after every model is built and warmed)."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if self.proc.poll() is not None:
                raise RuntimeError(
                    f"the server exited with {self.proc.returncode}\n{self.log_tail()}")
            try:
                with socket.create_connection(("127.0.0.1", self.port), timeout=1.0):
                    pass
            except OSError:
                time.sleep(0.2)
                continue
            status, _ = self.client.request("GET", "/healthz")
            if status == 200:
                return
            raise RuntimeError(f"/healthz answered {status}\n{self.log_tail()}")
        raise TimeoutError(f"the server was not ready in {timeout_s} s\n{self.log_tail()}")

    def get_json(self, path: str) -> dict:
        status, body = self.client.request("GET", path)
        if status != 200:
            raise RuntimeError(f"GET {path} answered {status}")
        return json.loads(body)

    def get_text(self, path: str) -> str:
        status, body = self.client.request("GET", path)
        if status != 200:
            raise RuntimeError(f"GET {path} answered {status}")
        return body.decode()

    def log_tail(self, n: int = 4000) -> str:
        self._log.flush()
        return self.log_path.read_bytes()[-n:].decode(errors="replace")

    def stop(self, grace_s: float = 30.0) -> int:
        """SIGTERM (the server drains and exits), then SIGKILL after
        ``grace_s``; waits until the process has ended."""
        self.client.close()
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
            try:
                self.proc.wait(grace_s)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        self._log.close()
        return self.proc.returncode
