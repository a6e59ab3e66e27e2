"""Dynamic batcher (a lean counterpart of the JAX package's
``serving/batcher.py``).

Requests are grouped by canvas bucket: each bucket keeps one open batch,
which seals when it holds ``max_batch`` images or ``max_delay_ms`` after
its first image arrived, whichever comes first. One dispatch thread runs
each sealed batch on the engine and resolves the requests' futures with
their (scores, indices) rows.

Ragged images (tight, from :meth:`submit_ragged`) queue under the key
``("ragged", s)``; their sealed batch is copied into one pinned arena, one
memcpy per image, and shipped by ``engine.run_ragged``.
"""

from __future__ import annotations

import logging
import threading
import time
from concurrent.futures import Future

import numpy as np

log = logging.getLogger("tpu_serve_torch.batcher")


class ShuttingDown(RuntimeError):
    pass


class Batcher:
    def __init__(self, engine, max_batch: int | None = None, max_delay_ms: float = 2.0):
        self.engine = engine
        self.max_batch = min(max_batch or engine.max_batch, engine.max_batch)
        self.max_delay_s = max_delay_ms / 1e3
        self._cond = threading.Condition()
        # canvas side, or ("ragged", side) → (time the open batch started,
        # [(canvas or tight image, hw, future)])
        self._open: dict[int | tuple[str, int], tuple[float, list]] = {}
        self._stopping = False
        self._thread: threading.Thread | None = None
        self.batches = 0
        self.images = 0

    def start(self, warmup: bool = False) -> "Batcher":
        """Start the dispatch thread. With ``warmup``, the engine's warmup
        runs on that thread before it takes batches, and this returns once
        it is done (re-raising its failure): first-use costs are paid per
        thread on CUDA — a warmup on another thread left the dispatch
        thread's first batches 10-25x slower (PERF.md)."""
        ready: Future = Future()
        self._thread = threading.Thread(target=self._run, args=(warmup, ready),
                                        name="batcher", daemon=True)
        self._thread.start()
        ready.result()
        return self

    def submit(self, canvas: np.ndarray, hw: tuple[int, int]) -> Future:
        """Queue one prepared wire canvas; the future resolves to its row."""
        return self._enqueue(canvas.shape[-1], canvas, hw)

    def submit_ragged(self, tight: np.ndarray, hw: tuple[int, int], s: int) -> Future:
        """Queue one tight image (uint8 [h, w, 3]) of canvas side ``s`` for the
        ragged wire; the future resolves to its row."""
        return self._enqueue(("ragged", s), tight, hw)

    def _enqueue(self, key, item: np.ndarray, hw: tuple[int, int]) -> Future:
        fut: Future = Future()
        with self._cond:
            if self._stopping:
                raise ShuttingDown("batcher is stopping")
            started, items = self._open.setdefault(key, (time.monotonic(), []))
            items.append((item, hw, fut))
            self._cond.notify()
        return fut

    def _take_locked(self):
        """Wait for a batch that is due: (its key, its items); None once
        stopping and drained."""
        while True:
            now = time.monotonic()
            wake = None
            for key, (started, items) in self._open.items():
                due = started + self.max_delay_s
                if len(items) >= self.max_batch or now >= due or self._stopping:
                    batch, rest = items[: self.max_batch], items[self.max_batch :]
                    if rest:
                        self._open[key] = (now, rest)
                    else:
                        del self._open[key]
                    return key, batch
                wake = due if wake is None else min(wake, due)
            if self._stopping:
                return None
            self._cond.wait(None if wake is None else max(0.0, wake - now))

    def _run(self, warmup: bool, ready: Future) -> None:
        try:
            if warmup:
                self.engine.warmup()
        except BaseException as e:
            ready.set_exception(e)
            return
        ready.set_result(None)
        while True:
            with self._cond:
                taken = self._take_locked()
            if taken is None:
                return
            self._dispatch(*taken)

    def _dispatch(self, key, batch: list) -> None:
        futures = [f for _, _, f in batch]
        try:
            hws = np.array([hw for _, hw, _ in batch], np.int32)
            if isinstance(key, tuple):
                scores, idx = self.engine.run_ragged([t for t, _, _ in batch], hws, key[1])
            else:
                scores, idx = self.engine.run_batch(np.stack([c for c, _, _ in batch]), hws)
        except Exception as e:  # the dispatch thread must outlive a bad batch
            log.exception("batch of %d failed", len(batch))
            for f in futures:
                f.set_exception(e)
            return
        with self._cond:
            self.batches += 1
            self.images += len(batch)
        for i, f in enumerate(futures):
            f.set_result((scores[i], idx[i]))

    def stop(self, timeout: float = 30.0) -> None:
        """Dispatch what is queued, then end the dispatch thread."""
        with self._cond:
            self._stopping = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout)

    def stats(self) -> dict:
        with self._cond:
            return {
                "batches": self.batches,
                "images": self.images,
                "queued": sum(len(items) for _, items in self._open.values()),
                "max_batch": self.max_batch,
                "max_delay_ms": self.max_delay_s * 1e3,
            }
