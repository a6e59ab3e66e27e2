"""Builds the port's hand-written CUDA kernels through the kernel build
cache (``serving/aotcache.py``; counterpart of the JAX package's
``native/build.py`` and of its AOT executable cache).

Each ``csrc/<name>.cu`` becomes its own shared library with a plain C
interface, compiled by ``nvcc`` for ``sm_90a`` and loaded with ``ctypes``.
:func:`load` looks the library up in the cache under :func:`kernel_key`
(the source's SHA-256, the flags, nvcc's release, the arch, the card's
compute capability, torch and its CUDA): a verified hit is loaded without
running nvcc; a miss or a corrupt entry is built into a temporary
directory, stored atomically and loaded. The default cache is
``tensorflow_web_deploy_tpu_torch/.build/`` (listed in ``.gitignore``);
``cache=None`` disables it, and the build then stays in a temporary
directory of this process. A missing ``nvcc`` or a failed build raises.
Two sources build in parallel when two threads load them; a library is
loaded once per process.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

from ..serving import aotcache

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = aotcache.DEFAULT_DIR
ARCH = "sm_90a"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    # every multiply and add rounds on its own, as the reference's float32
    # ops do (see the note in each kernel's source)
    "-fmad=false",
)

# the default cache, the sentinel for "no argument" (None disables)
DEFAULT = object()

_lock = threading.Lock()  # guards _locks
_locks: dict[str, threading.Lock] = {}  # one per source: its build and load
_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(path).exists():
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")
    return path


@functools.lru_cache(maxsize=None)
def nvcc_release() -> str:
    """nvcc's release line, e.g. ``Cuda compilation tools, release 12.8, V12.8.93``."""
    out = subprocess.run([_nvcc(), "--version"], capture_output=True, text=True, check=True)
    lines = [ln.strip() for ln in out.stdout.splitlines() if "release" in ln]
    return lines[0] if lines else out.stdout.strip()


def kernel_key(name: str) -> dict:
    """The cache key of ``csrc/<name>.cu``'s library on this machine."""
    import torch

    src = CSRC / f"{name}.cu"
    return {
        "format": aotcache.FORMAT_VERSION,
        "kind": "kernel",
        "source": f"csrc/{name}.cu",
        "source_sha256": hashlib.sha256(src.read_bytes()).hexdigest(),
        "nvcc_flags": list(NVCC_FLAGS),
        "nvcc": nvcc_release(),
        "arch": ARCH,
        "capability": list(torch.cuda.get_device_capability()),
        "torch": torch.__version__,
        "torch_cuda": torch.version.cuda,
    }


def library_path(name: str) -> Path:
    """Where the default cache keeps ``csrc/<name>.cu``'s library."""
    return aotcache.AotCache(BUILD_DIR).library_path(kernel_key(name))


def _compile(name: str, out: Path) -> None:
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu (exit {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")


def _load_or_build(name: str, cache: aotcache.AotCache | None) -> ctypes.CDLL:
    key = kernel_key(name)
    if cache is not None:
        lib = cache.load(key)
        if lib is not None:
            return lib
    with tempfile.TemporaryDirectory(prefix=f"twd-{name}-") as tmp:
        built = Path(tmp) / f"lib{name}.so"
        t0 = time.perf_counter()
        _compile(name, built)
        aotcache.record_compile_seconds(time.perf_counter() - t0)
        if cache is not None and cache.store(key, built):
            return ctypes.CDLL(str(cache.library_path(key)))
        # loaded before its directory goes: the mapping outlives the file
        return ctypes.CDLL(str(built))


def load(name: str, cache=DEFAULT) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``: from this process's memo,
    else through ``cache`` (an ``AotCache``; the default directory unless
    given; None: no cache)."""
    with _lock:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        lib = _loaded.get(name)
        if lib is None:
            if cache is DEFAULT:
                cache = aotcache.AotCache(BUILD_DIR)
            lib = _loaded[name] = _load_or_build(name, cache)
        return lib
