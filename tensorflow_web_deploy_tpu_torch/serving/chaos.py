"""Deterministic fault injection for fault drills (counterpart of the JAX
package's ``serving/chaos.py``).

An injector parsed from ``--chaos`` / ``TWD_CHAOS`` rides the registry and
is consulted at four seams:

- ``decode_fail=P``     the App treats an upload as undecodable (400) with
                        probability P;
- ``dispatch_fail=P``   the batcher's launch raises :class:`ChaosError`
                        before the engine's dispatch (the failed-batch path:
                        futures fail, the slab goes back, the depth slot
                        frees);
- ``slow_replica=P:MS[:R]`` the completion thread sleeps MS ms before a
                        fetch (a straggling device group, which holds the
                        batch's depth slot longer); with ``R``, only before
                        the fetches of batches routed to replica R — the
                        port's one addition to the reference's spec, which
                        delays any batch;
- ``spike=ON:PERIOD``   for the first ON seconds of every PERIOD, each
                        request is held ``spike_hold`` ms (5 by default)
                        before staging;
- ``seed=N``            the seed of the one ``random.Random`` every draw
                        comes from (1234 by default), so a drill repeats.

The lock is a leaf: only draws and counters run under it, every sleep is
the caller's, outside it.
"""

from __future__ import annotations

import logging
import random
import threading
import time

log = logging.getLogger("tpu_serve_torch.chaos")


class ChaosError(RuntimeError):
    """An injected fault; the serving stack treats it as any dispatch error."""


class ChaosInjector:
    """One parsed ``--chaos`` spec: probabilities, the seeded generator and
    the injected-fault counters."""

    def __init__(self, decode_fail: float = 0.0, dispatch_fail: float = 0.0,
                 slow_replica_p: float = 0.0, slow_replica_ms: float = 0.0,
                 slow_replica_target: int | None = None, spike_on_s: float = 0.0,
                 spike_period_s: float = 0.0, spike_hold_ms: float = 5.0, seed: int = 1234):
        self.decode_fail = max(0.0, min(1.0, decode_fail))
        self.dispatch_fail = max(0.0, min(1.0, dispatch_fail))
        self.slow_replica_p = max(0.0, min(1.0, slow_replica_p))
        self.slow_replica_s = max(0.0, slow_replica_ms) / 1e3
        self.slow_replica_target = slow_replica_target
        self.spike_on_s = max(0.0, spike_on_s)
        self.spike_period_s = max(0.0, spike_period_s)
        self.spike_hold_s = max(0.0, spike_hold_ms) / 1e3
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._t0 = time.monotonic()
        self._decode_failures = 0
        self._dispatch_failures = 0
        self._slow_fetches = 0
        self._spike_holds = 0

    @classmethod
    def from_spec(cls, spec: str | None) -> ChaosInjector | None:
        """Parse ``"decode_fail=0.1,slow_replica=0.2:50,seed=7"``; None or
        blank gives no injector. Malformed entries are dropped with a
        warning."""
        if not spec or not spec.strip():
            return None
        kw: dict = {}
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            key, _, val = part.partition("=")
            key = key.strip()
            try:
                if key == "decode_fail":
                    kw["decode_fail"] = float(val)
                elif key == "dispatch_fail":
                    kw["dispatch_fail"] = float(val)
                elif key == "slow_replica":
                    p, _, rest = val.partition(":")
                    ms, _, target = rest.partition(":")
                    kw["slow_replica_p"] = float(p)
                    kw["slow_replica_ms"] = float(ms or 50.0)
                    if target:
                        kw["slow_replica_target"] = int(target)
                elif key == "spike":
                    on, _, period = val.partition(":")
                    kw["spike_on_s"] = float(on)
                    kw["spike_period_s"] = float(period or (2 * float(on)))
                elif key == "spike_hold":
                    kw["spike_hold_ms"] = float(val)
                elif key == "seed":
                    kw["seed"] = int(val)
                else:
                    log.warning("chaos: unknown key %r ignored", key)
            except ValueError:
                log.warning("chaos: malformed entry %r ignored", part)
        inj = cls(**kw)
        log.warning("chaos injector ACTIVE: %s", inj.describe())
        return inj

    def describe(self) -> str:
        parts = []
        if self.decode_fail:
            parts.append(f"decode_fail={self.decode_fail}")
        if self.dispatch_fail:
            parts.append(f"dispatch_fail={self.dispatch_fail}")
        if self.slow_replica_p:
            parts.append(f"slow_replica={self.slow_replica_p}:{self.slow_replica_s * 1e3:.0f}ms"
                         + ("" if self.slow_replica_target is None
                            else f":replica{self.slow_replica_target}"))
        if self.spike_period_s:
            parts.append(f"spike={self.spike_on_s}:{self.spike_period_s}")
        return ",".join(parts) or "(no faults)"

    def _hit(self, p: float) -> bool:
        if p <= 0.0:
            return False
        with self._lock:
            return self._rng.random() < p

    def decode_fault(self) -> bool:
        """True: treat this upload as undecodable."""
        if self._hit(self.decode_fail):
            with self._lock:
                self._decode_failures += 1
            return True
        return False

    def dispatch_fault(self) -> bool:
        """True: the launch raises :class:`ChaosError` instead of dispatching."""
        if self._hit(self.dispatch_fail):
            with self._lock:
                self._dispatch_failures += 1
            return True
        return False

    def fetch_delay(self, replica: int = 0) -> float:
        """Seconds the completion thread sleeps before fetching a batch of
        ``replica`` (0.0: none); a batch of a replica the spec does not
        target draws nothing."""
        if self.slow_replica_target is not None and replica != self.slow_replica_target:
            return 0.0
        if self._hit(self.slow_replica_p):
            with self._lock:
                self._slow_fetches += 1
            return self.slow_replica_s
        return 0.0

    def spike_delay(self) -> float:
        """Seconds to hold a request (0.0 outside the spike window)."""
        if self.spike_period_s <= 0.0 or self.spike_hold_s <= 0.0:
            return 0.0
        if (time.monotonic() - self._t0) % self.spike_period_s < self.spike_on_s:
            with self._lock:
                self._spike_holds += 1
            return self.spike_hold_s
        return 0.0

    def stats(self) -> dict:
        with self._lock:
            return {
                "spec": self.describe(),
                "decode_failures_injected": self._decode_failures,
                "dispatch_failures_injected": self._dispatch_failures,
                "slow_fetches_injected": self._slow_fetches,
                "spike_holds_injected": self._spike_holds,
            }
