"""Content-addressed response cache with single-flight dedup (counterpart
of the JAX package's ``serving/respcache.py``).

Heavy-tailed traffic repeats a few hot images; this module lets a repeat
skip the device:

- **Content-addressed keys.** An entry is keyed by ``(model, version,
  digest, topk, dtype)`` (:func:`make_key`). The digest covers the pixels
  the device would see, not the upload's compressed bytes: the classic
  wire's decoded canvas plus its valid (h, w) (:func:`canvas_digest`), or
  the ragged wire's tight decoded bytes plus (h, w) and the canvas bucket
  (:func:`packed_digest`). The App computes it after the native decode into
  the leased slot. Digests and ETags are string-identical to the
  reference's on the same bytes (blake2b-128 / blake2b-96 over the same
  canonical JSON), which the CPU tests hold.
- **Byte-budgeted LRU.** Entries carry the size of their canonical
  payload; past ``max_bytes`` the least recently hit go. ``max_bytes == 0``
  disables the cache (``--cache-bytes 0``).
- **Single-flight dedup.** The first miss for a key leads and computes
  through the batcher; concurrent requests for the same key coalesce onto
  its :class:`Flight` and share its result. Waiters block on the flight's
  future outside the cache's lock.
- **Version-gated invalidation.** The key carries the version, so a request
  that resolved version N sees only version-N entries. The registry's
  retire listener calls :meth:`ResponseCache.invalidate` under its lock
  (order: ``registry.cond`` → ``cache.lock``) when a version enters
  DRAINING: its entries go, and its flights abort with
  :class:`CacheRetired`, so coalesced waiters retry on the new version.

**Bulk tier.** A job's lookups (``begin(..., bulk=True)``) share the entry
and flight maps with interactive traffic, so a re-run of a corpus dedups
and a job's misses warm the interactive tier, but they count apart
(``bulk_*`` per model, the ``bulk`` block of :meth:`ResponseCache.stats`):
a corpus sweep never moves the interactive hit rate.

One lock guards the entry map, the flight map and every counter; only
dict operations run under it.
"""

from __future__ import annotations

import hashlib
import json
from collections import OrderedDict
from concurrent.futures import Future

import numpy as np

from ..utils.locks import named_lock


class CacheRetired(RuntimeError):
    """The flight a waiter coalesced onto was aborted because its model
    version retired (hot swap or unload). The HTTP layer retries the
    request once against the new serving version."""


def canvas_digest(canvas, hw) -> str:
    """Digest of one classic-wire image: its decoded canvas bytes (the wire
    format the device reads) plus the valid (h, w), which tells an image
    whose edges are black from zero padding. The decoder fills the whole
    canvas, so the digest does not depend on what the slot held before."""
    arr = np.asarray(canvas)
    if not arr.flags["C_CONTIGUOUS"]:
        arr = np.ascontiguousarray(arr)
    h = hashlib.blake2b(digest_size=16)
    h.update(arr.data)
    h.update(b"%d,%d" % (int(hw[0]), int(hw[1])))
    return h.hexdigest()


def packed_digest(tight, hw, bucket_s: int) -> str:
    """Digest of one ragged-wire image: its tight decoded bytes (h·w·3) plus
    (h, w) and the canvas bucket it unpacks onto. The device's unpack is a
    function of exactly these, so two images share a digest iff their
    canvases would be identical. A server runs one wire, so the two digest
    spaces never share a cache."""
    arr = np.asarray(tight)
    if not arr.flags["C_CONTIGUOUS"]:
        arr = np.ascontiguousarray(arr)
    h = hashlib.blake2b(digest_size=16)
    h.update(arr.data)
    h.update(b"%d,%d,%d" % (int(hw[0]), int(hw[1]), int(bucket_s)))
    return h.hexdigest()


def stage_input_digest(upstream_digest: str, upstream_payload: dict) -> str:
    """Digest of a later pipeline stage's input: the request's digest with
    the upstream stage's canonical answer. Any change in what the upstream
    stage answered re-keys the downstream stage; the upstream version rides
    in the upstream stage's own key, not here."""
    h = hashlib.blake2b(digest_size=16)
    h.update(upstream_digest.encode())
    h.update(b"|")
    h.update(_canonical_payload(upstream_payload))
    return h.hexdigest()


def _canonical_payload(payload: dict) -> bytes:
    """The one serialization of a payload: the ETag hashes it and the LRU
    counts its bytes."""
    return json.dumps(payload, sort_keys=True, separators=(",", ":"), default=str).encode()


def _etag_of(body: bytes, model: str, version) -> str:
    h = hashlib.blake2b(digest_size=12)
    h.update(body)
    h.update(f"|{model}@{version}".encode())
    return h.hexdigest()


def payload_etag(payload: dict, model: str, version) -> str:
    """The HTTP ETag: a digest of the per-image payload and the serving
    identity, never of the envelope (whose per-request fields would defeat
    ``If-None-Match``)."""
    return _etag_of(_canonical_payload(payload), model, version)


def make_key(model: str, version, digest: str, topk: int, dtype: str = "bfloat16") -> tuple:
    """The cache key. ``(model, version)`` lead so that invalidation and
    per-model counters match on a prefix; ``dtype`` keeps a float32 answer
    from serving an int8 tier under the same name."""
    return (model, version, digest, int(topk), dtype)


class Flight:
    """One in-flight computation of a key. The leader ends it with
    :meth:`ResponseCache.complete` or :meth:`ResponseCache.abort`; waiters
    block on ``future``, which resolves to ``(payload, etag)``."""

    __slots__ = ("key", "model", "future")

    def __init__(self, key: tuple, model: str):
        self.key = key
        self.model = model
        self.future: Future = Future()


class _Entry:
    __slots__ = ("key", "payload", "etag", "nbytes")

    def __init__(self, key: tuple, payload: dict, etag: str, nbytes: int):
        self.key = key
        self.payload = payload
        self.etag = etag
        self.nbytes = nbytes


class ResponseCache:
    """Byte-budgeted LRU of per-image payloads and the single-flight table;
    one per App, every model's entries sharing the budget."""

    def __init__(self, max_bytes: int):
        self.max_bytes = max(0, int(max_bytes))
        self._lock = named_lock("cache.lock")
        self._entries: OrderedDict[tuple, _Entry] = OrderedDict()
        self._inflight: dict[tuple, Flight] = {}
        # (model, version) pairs retired by the registry: a leader finishing
        # after its version drained must not insert an entry nothing can
        # look up again
        self._retired: set[tuple] = set()
        self.bytes = 0
        self._hits = self._misses = self._coalesced = 0
        self._bulk_hits = self._bulk_misses = self._bulk_coalesced = 0
        self._evictions = self._invalidations = self._inserts = 0
        self._per_model: dict[str, dict] = {}

    @property
    def enabled(self) -> bool:
        return self.max_bytes > 0

    def _model_counters(self, model: str) -> dict:
        m = self._per_model.get(model)
        if m is None:
            # hits/misses/coalesced: the interactive tier; bulk_*: jobs;
            # entries and bytes are shared (one entry map serves both)
            m = self._per_model[model] = {"hits": 0, "misses": 0, "coalesced": 0,
                                          "bulk_hits": 0, "bulk_misses": 0,
                                          "bulk_coalesced": 0, "entries": 0, "bytes": 0}
        return m

    def begin(self, key: tuple, model: str, bulk: bool = False):
        """One lookup: ``("hit", entry)``; ``("wait", flight)``, to block on
        ``flight.future`` outside any lock; or ``("lead", flight)``, which the
        caller must end with :meth:`complete` or :meth:`abort` (a leaked
        flight would hang every later waiter to its timeout). ``bulk`` marks
        a job's lookup: the same maps, the bulk counters."""
        prefix = "bulk_" if bulk else ""
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                self._entries.move_to_end(key)
                if bulk:
                    self._bulk_hits += 1
                else:
                    self._hits += 1
                self._model_counters(model)[prefix + "hits"] += 1
                return "hit", entry
            flight = self._inflight.get(key)
            if flight is not None:
                if bulk:
                    self._bulk_coalesced += 1
                else:
                    self._coalesced += 1
                self._model_counters(model)[prefix + "coalesced"] += 1
                return "wait", flight
            if bulk:
                self._bulk_misses += 1
            else:
                self._misses += 1
            self._model_counters(model)[prefix + "misses"] += 1
            flight = self._inflight[key] = Flight(key, model)
            return "lead", flight

    def complete(self, flight: Flight, payload: dict) -> str:
        """The leader's result: insert it, resolve every waiter, return the
        ETag."""
        key = flight.key
        body = _canonical_payload(payload)
        etag = _etag_of(body, key[0], key[1])
        nbytes = len(body)
        with self._lock:
            if self._inflight.get(key) is flight:
                del self._inflight[key]
            if (self.enabled and key[:2] not in self._retired and nbytes <= self.max_bytes
                    and key not in self._entries):
                self._entries[key] = _Entry(key, payload, etag, nbytes)
                self.bytes += nbytes
                self._inserts += 1
                m = self._model_counters(key[0])
                m["entries"] += 1
                m["bytes"] += nbytes
                while self.bytes > self.max_bytes and self._entries:
                    _, victim = self._entries.popitem(last=False)
                    self.bytes -= victim.nbytes
                    self._evictions += 1
                    vm = self._model_counters(victim.key[0])
                    vm["entries"] -= 1
                    vm["bytes"] -= victim.nbytes
        # outside the lock: a woken waiter may re-enter the cache at once
        try:
            flight.future.set_result((payload, etag))
        except Exception:
            pass  # aborted by an invalidation racing the completion
        return etag

    def abort(self, flight: Flight, exc: BaseException) -> None:
        """The leader failed: every waiter fails with its exception."""
        with self._lock:
            if self._inflight.get(flight.key) is flight:
                del self._inflight[flight.key]
        try:
            flight.future.set_exception(exc)
        except Exception:
            pass  # resolved already

    def invalidate(self, model: str, version) -> int:
        """Drop every entry of ``(model, version)`` and abort its flights with
        :class:`CacheRetired`; returns the entries dropped. The registry's
        retire listener, under the registry's lock; nothing here blocks."""
        prefix = (model, version)
        with self._lock:
            self._retired.add(prefix)
            doomed = [k for k in self._entries if k[:2] == prefix]
            m = self._model_counters(model)
            for k in doomed:
                victim = self._entries.pop(k)
                self.bytes -= victim.nbytes
                m["entries"] -= 1
                m["bytes"] -= victim.nbytes
            self._invalidations += len(doomed)
            aborted = [self._inflight.pop(k) for k in [k for k in self._inflight
                                                       if k[:2] == prefix]]
        for flight in aborted:
            try:
                flight.future.set_exception(CacheRetired(
                    f"{model}@{version} retired while this key was in flight"))
            except Exception:
                pass
        return len(doomed)

    def stats(self) -> dict:
        """The ``/stats`` cache block: totals are cumulative, ``bytes``,
        ``entries`` and ``inflight`` live."""
        with self._lock:
            lookups = self._hits + self._misses + self._coalesced
            return {
                "enabled": self.enabled,
                "max_bytes": self.max_bytes,
                "bytes": self.bytes,
                "entries": len(self._entries),
                "inflight": len(self._inflight),
                "hits_total": self._hits,
                "misses_total": self._misses,
                "coalesced_total": self._coalesced,
                "evictions_total": self._evictions,
                "invalidations_total": self._invalidations,
                "inserts_total": self._inserts,
                "hit_rate": round(self._hits / lookups, 4) if lookups else None,
                # jobs' lookups, apart from the interactive rate above
                "bulk": {
                    "hits_total": self._bulk_hits,
                    "misses_total": self._bulk_misses,
                    "coalesced_total": self._bulk_coalesced,
                },
                "per_model": {name: dict(c) for name, c in sorted(self._per_model.items())},
            }
