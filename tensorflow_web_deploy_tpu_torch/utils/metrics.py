"""Rolling serving statistics (the part of the JAX package's
``utils/metrics.py::RollingStats`` that deadline admission reads).

The batcher records every resolved row here; its ``Retry-After`` and
deadline admission read the O(1) :meth:`RollingStats.rate_hint` and
:meth:`RollingStats.device_hint` under its condition, so neither may sort
the window. Percentiles, histograms and ``/metrics`` wait for ROADMAP
Queue 1 item 8.
"""

from __future__ import annotations

import threading
import time
from collections import deque


class RollingStats:
    def __init__(self, window: int = 2048):
        self._lock = threading.Lock()
        # (t_done, latency_s, queue_s, device_s) per resolved row
        self._records: deque = deque(maxlen=window)
        self._errors = 0
        self._total = 0
        # per-row device time, an EMA; 0.0 until the first replayed batch
        self._device_ema = 0.0

    def record(self, *, latency_s: float, queue_s: float, device_s: float | None,
               batch_size: int) -> None:
        """One resolved row. ``device_s`` None keeps the row out of the
        device-time EMA (a batch that ran eagerly, which on the card pays
        one-time costs a replay does not)."""
        with self._lock:
            self._records.append((time.monotonic(), latency_s, queue_s, device_s))
            self._total += 1
            if device_s is not None:
                self._device_ema = (device_s if self._device_ema == 0.0
                                    else 0.9 * self._device_ema + 0.1 * device_s)

    def record_error(self) -> None:
        with self._lock:
            self._errors += 1
            self._total += 1

    def rate_hint(self) -> float:
        """Rows/s over the window's span, from its first and last records."""
        with self._lock:
            if len(self._records) < 2:
                return 0.0
            dt = self._records[-1][0] - self._records[0][0]
            n = len(self._records)
        return n / dt if dt > 0 else 0.0

    def device_hint(self) -> float:
        """Device seconds per row (the EMA); the third term of the expected
        wait."""
        with self._lock:
            return self._device_ema

    def snapshot(self) -> dict:
        with self._lock:
            return {"total": self._total, "errors": self._errors,
                    "device_ema_ms": self._device_ema * 1e3}
