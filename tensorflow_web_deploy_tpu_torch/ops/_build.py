"""Builds the port's hand-written CUDA kernels (counterpart of the JAX
package's ``native/build.py``).

Each ``csrc/<name>.cu`` becomes its own shared library with a plain C
interface, compiled by ``nvcc`` for ``sm_90a`` at first use and loaded
with ``ctypes``. The library's file name carries a hash of its source and
the flags, so an edited ``.cu`` rebuilds and a stale library is never
loaded. Builds land in ``tensorflow_web_deploy_tpu_torch/.build/`` (listed
in ``.gitignore``). A missing ``nvcc`` or a failed build raises. Two
sources build in parallel when two threads load them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / ".build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    # every multiply and add rounds on its own, as the reference's float32
    # ops do (see the note in each kernel's source)
    "-fmad=false",
)

_lock = threading.Lock()  # guards _locks
_locks: dict[str, threading.Lock] = {}  # one per source: its build and load
_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")
    return path


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def _build(name: str) -> None:
    """Compile ``csrc/<name>.cu`` into a temporary file and rename it into
    place, so a failed or interrupted build never leaves a library behind."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for csrc/{name}.cu (exit {proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, library_path(name))
    finally:
        Path(tmp).unlink(missing_ok=True)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        lib = _loaded.get(name)
        if lib is None:
            if not library_path(name).exists():
                _build(name)
            lib = _loaded[name] = ctypes.CDLL(str(library_path(name)))
        return lib
