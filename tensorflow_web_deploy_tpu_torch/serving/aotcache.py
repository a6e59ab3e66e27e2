"""Self-verifying on-disk cache of the port's built kernel libraries
(counterpart of the JAX package's ``serving/aotcache.py``).

The JAX package caches serialized XLA executables so that a warm boot
deserializes instead of compiling. The port's counterpart of "compile" is
an ``nvcc`` build of one ``csrc/<name>.cu`` into a shared library, and of
"deserialize" a verified ``dlopen`` of the library built before
(``ops/_build.py``). The serve function itself becomes a CUDA graph per
(canvas, batch) bucket at warmup (``serving/engine.py``); a graph cannot
outlive its process, so only the libraries are cached on disk.

The discipline is the reference's — the cache may only ever be a speedup:

- **Keys cover everything that invalidates a library**: the source's
  SHA-256, the nvcc flags and release, the target arch, the card's compute
  capability and torch's version and CUDA (``ops/_build.kernel_key``). A
  stale or foreign entry can never be found: its digest differs.
- **Entries verify themselves.** Each is ``<digest>.so`` plus
  ``<digest>.json``, the JSON holding the full key, the library's SHA-256
  and its byte count. A missing JSON is a miss; a key mismatch, a checksum
  or size mismatch, or a library ``ctypes`` cannot load counts as corrupt.
  :meth:`AotCache.load` never raises: it returns None and the caller
  rebuilds, never answers with a plain version.
- **Writes are atomic**: each file goes to a temporary file in the same
  directory and is moved into place with ``os.replace``, the JSON last, so
  a reader sees a whole entry or none. A failed store is logged and
  returns False.

Counters are process-wide under one lock, with the reference's names;
``compile_seconds_total`` counts every build, cache or not.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import logging
import os
import tempfile
import time
from pathlib import Path

from ..utils.locks import named_lock


log = logging.getLogger("tpu_serve_torch.aotcache")

# Bump to invalidate every existing entry (layout or loader semantics
# change). Part of every key.
FORMAT_VERSION = 1
# where the libraries go unless a config names another directory; listed
# in .gitignore, so a checkout builds its own
DEFAULT_DIR = Path(__file__).resolve().parent.parent / ".build"

_LIB, _META = ".so", ".json"

_lock = named_lock("aotcache.lock")
_counters = {
    "hits_total": 0,
    "misses_total": 0,
    "writes_total": 0,
    "corrupt_total": 0,
    "bytes_written_total": 0,
    "compile_seconds_total": 0.0,
    "deserialize_seconds_total": 0.0,
}


def _bump(name: str, n=1) -> None:
    with _lock:
        _counters[name] += n


def record_compile_seconds(s: float) -> None:
    """One build's wall seconds (counted whether or not a cache is on)."""
    _bump("compile_seconds_total", float(s))


def record_deserialize_seconds(s: float) -> None:
    """One entry's verify + ``dlopen`` wall seconds."""
    _bump("deserialize_seconds_total", float(s))


def stats(cache: AotCache | None = None) -> dict:
    """Process-wide counter snapshot, plus the given cache's identity
    (the ``/stats`` → ``engine.aot_cache`` block)."""
    with _lock:
        out = dict(_counters)
    out["compile_seconds_total"] = round(out["compile_seconds_total"], 3)
    out["deserialize_seconds_total"] = round(out["deserialize_seconds_total"], 3)
    out["enabled"] = cache is not None
    out["dir"] = cache.dir if cache is not None else None
    return out


def key_digest(key: dict) -> str:
    """Stable content address of a JSON-plain key dict: SHA-256 over its
    canonical JSON (sorted keys, no whitespace), first 32 hex digits — the
    reference's digest, bit for bit."""
    blob = json.dumps(key, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()[:32]


def _write_atomic(path: Path, data: bytes) -> None:
    fd, tmp = tempfile.mkstemp(dir=path.parent, prefix=".tmp-", suffix=path.suffix)
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
    except BaseException:
        Path(tmp).unlink(missing_ok=True)
        raise


class AotCache:
    """One directory of content-addressed kernel libraries."""

    def __init__(self, directory: str | os.PathLike):
        self.dir = str(directory)
        os.makedirs(self.dir, exist_ok=True)

    @staticmethod
    def from_config(cfg) -> AotCache | None:
        """The cache ``cfg.aot_cache_dir`` names: :data:`DEFAULT_DIR` when
        it is None, disabled (None) for ``"0"`` or empty, as in the
        reference. A directory that cannot be made disables the cache with
        a warning: every build then goes to a temporary directory."""
        d = getattr(cfg, "aot_cache_dir", None)
        if d is None:
            d = DEFAULT_DIR
        elif not str(d) or str(d) == "0":
            return None
        try:
            return AotCache(d)
        except OSError as e:
            log.warning("aot cache disabled: cannot create %r (%s)", str(d), e)
            return None

    def library_path(self, key: dict) -> Path:
        return Path(self.dir) / (key_digest(key) + _LIB)

    def _meta_path(self, key: dict) -> Path:
        return Path(self.dir) / (key_digest(key) + _META)

    def load(self, key: dict) -> ctypes.CDLL | None:
        """The verified, loaded library stored under ``key``, or None: a
        miss when its JSON is absent, corrupt on any integrity failure (key,
        checksum, size, ``dlopen``). Never raises."""
        try:
            meta_raw = self._meta_path(key).read_bytes()
        except FileNotFoundError:
            _bump("misses_total")
            return None
        except OSError as e:
            log.warning("aot cache read failed for %s (%s); rebuilding", key.get("source"), e)
            _bump("corrupt_total")
            return None
        t0 = time.perf_counter()
        path = self.library_path(key)
        try:
            meta = json.loads(meta_raw)
            # the stored key is authoritative: a collision or a renamed file is not ours
            if meta.get("key") != json.loads(json.dumps(key)):
                raise ValueError("key mismatch")
            body = path.read_bytes()
            if len(body) != meta["bytes"] or hashlib.sha256(body).hexdigest() != meta["sha256"]:
                raise ValueError("checksum mismatch")
            lib = ctypes.CDLL(str(path))
        except Exception as e:
            log.warning("aot cache entry %s unusable (%s); rebuilding", path.name, e)
            _bump("corrupt_total")
            return None
        record_deserialize_seconds(time.perf_counter() - t0)
        _bump("hits_total")
        return lib

    def store(self, key: dict, built: str | os.PathLike) -> bool:
        """Copy the library at ``built`` in under ``key``: the library, then
        its JSON, each by atomic rename. False (logged, nothing counted) on
        any failure: a cache that cannot write simply never hits."""
        try:
            body = Path(built).read_bytes()
            meta = json.dumps({"key": key, "sha256": hashlib.sha256(body).hexdigest(),
                               "bytes": len(body)}, sort_keys=True).encode()
            _write_atomic(self.library_path(key), body)
            _write_atomic(self._meta_path(key), meta)
        except Exception as e:
            log.warning("aot cache store failed for %s (%s)", key.get("source"), e)
            return False
        _bump("writes_total")
        _bump("bytes_written_total", len(body) + len(meta))
        return True

    def entry_count(self) -> int:
        """Entries on disk (tests only: ``/stats`` reports the counters)."""
        try:
            return sum(1 for n in os.listdir(self.dir)
                       if n.endswith(_META) and not n.startswith(".tmp-"))
        except OSError:
            return 0
