"""Overload control: SLO classes and deadlines, per-tenant token-bucket
admission, and the degradation ladder (counterpart of the JAX package's
``serving/overload.py``).

- :func:`parse_slo_classes` — ``interactive=1000,batch=10000``: a request
  names a class (``?slo=`` / ``X-SLO``) for its default deadline, or sets
  one (``X-Deadline-Ms`` / ``?deadline_ms=``). The batcher spends it: at
  lease time it compares the deadline with the expected wait (backlog ÷
  ``rate_hint`` + the live window + the device-time EMA) and sheds a doomed
  request before any decode or device time, then re-checks at seal so that
  a batch never ships a row already dead.
- :class:`AdmissionController` — per-tenant token buckets (``X-Tenant``):
  a request charges one token per image at lease time and sheds with 429
  when the bucket is dry. Past ``max_tenants`` tracked buckets, unknown
  tenants share the ``~other`` bucket. ``peek``/``charge`` are the bulk
  class's side: the batcher's bulk gate peeks the job tenant's bucket and
  charges a batch's rows at its dispatch.
- :class:`PressureController` — the degradation ladder on the batcher's
  queue fraction: clamp topk → smallest canvas bucket → (with four rungs)
  reroute to a loaded int8 variant → reject cache-miss work, each rung an
  ``enter:exit`` pair (hysteresis) with a minimum dwell between moves.

Both controllers' locks are leaves under ``batcher.cond`` (the lease path
charges a quota under the batcher's condition); only dict and float
arithmetic runs under them. Deadlines use ``time.monotonic()``.
"""

from __future__ import annotations

import logging
import time

from ..utils.locks import named_lock


log = logging.getLogger("tpu_serve_torch.overload")

# the machine-readable ``reason`` of every shed answer
SHED_BACKLOG = "backlog"
SHED_DEADLINE = "deadline"
SHED_QUOTA = "quota"
SHED_DEGRADED = "degraded"

# the tenant of a request without X-Tenant, and the shared bucket past the
# tracked-tenant cap
DEFAULT_TENANT = "default"
OTHER_TENANT = "~other"

DEFAULT_SLO_SPEC = "interactive=1000,batch=10000"


class DeadlineExceeded(RuntimeError):
    """Shed because the deadline cannot be met: at lease time the expected
    wait exceeds it, at seal time it passed while the row waited. HTTP:
    504 with ``reason: deadline``."""

    def __init__(self, msg: str, expected_wait_s: float = 0.0, retry_after_s: float = 1.0):
        super().__init__(msg)
        self.expected_wait_s = expected_wait_s
        self.retry_after_s = retry_after_s


class QuotaExceeded(RuntimeError):
    """Shed because the tenant's token bucket is dry. HTTP: 429 with
    ``Retry-After``, the time until a token refills."""

    def __init__(self, msg: str, tenant: str = DEFAULT_TENANT, retry_after_s: float = 1.0):
        super().__init__(msg)
        self.tenant = tenant
        self.retry_after_s = retry_after_s


class Degraded(RuntimeError):
    """Shed by the ladder's last rung (cache-miss work under extreme
    pressure). HTTP: 503 with ``reason: degraded``."""

    def __init__(self, msg: str, retry_after_s: float = 1.0):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


def parse_slo_classes(spec: str | None) -> dict[str, float]:
    """``"interactive=1000,batch=10000"`` → {name: deadline seconds}.
    Malformed entries are dropped; nothing left falls back to the defaults
    rather than failing the boot."""
    out: dict[str, float] = {}
    for part in (spec or DEFAULT_SLO_SPEC).split(","):
        part = part.strip()
        if not part:
            continue
        name, _, val = part.partition("=")
        try:
            ms = float(val)
        except ValueError:
            log.warning("slo_classes: ignoring malformed entry %r", part)
            continue
        if ms > 0:
            out[name.strip()] = ms / 1e3
    return out or {"interactive": 1.0, "batch": 10.0}


class _Bucket:
    """One tenant's token bucket and counters, under the controller's lock."""

    __slots__ = ("rate", "burst", "tokens", "refilled_at", "admitted", "shed")

    def __init__(self, rate: float, burst: float, now: float):
        self.rate = rate  # images/s; <= 0 is unlimited
        self.burst = burst  # depth in images
        self.tokens = burst
        self.refilled_at = now
        self.admitted = 0
        self.shed: dict[str, int] = {}


class AdmissionController:
    """Per-tenant token buckets and the per-tenant and per-class admit and
    shed counters. Spec ``"alice=50,bob=25,*=100"``: images/s per tenant,
    ``*`` for unlisted ones (0 or absent: unlimited). A bucket holds
    ``rate × burst_s`` tokens (at least 1)."""

    def __init__(self, quotas: dict[str, float] | None = None, default_rate: float = 0.0,
                 burst_s: float = 1.0, max_tenants: int = 64):
        self._lock = named_lock("overload.admission_lock")
        self._quotas = dict(quotas or {})
        self._default_rate = float(default_rate)
        self._burst_s = max(0.05, float(burst_s))
        self._max_tenants = max(1, int(max_tenants))
        self._tenants: dict[str, _Bucket] = {}
        self._class_admitted: dict[str, int] = {}
        self._class_shed: dict[str, dict[str, int]] = {}
        self._shed_total: dict[str, int] = {}

    @classmethod
    def from_spec(cls, spec: str | None, burst_s: float = 1.0,
                  max_tenants: int = 64) -> AdmissionController:
        quotas: dict[str, float] = {}
        default_rate = 0.0
        for part in (spec or "").split(","):
            part = part.strip()
            if not part:
                continue
            name, _, val = part.partition("=")
            try:
                rate = float(val)
            except ValueError:
                log.warning("tenant_quota: ignoring malformed entry %r", part)
                continue
            if name.strip() == "*":
                default_rate = rate
            else:
                quotas[name.strip()] = rate
        return cls(quotas, default_rate=default_rate, burst_s=burst_s, max_tenants=max_tenants)

    def _bucket_locked(self, tenant: str, now: float) -> _Bucket:
        """A tenant's bucket, refilled to ``now``."""
        b = self._tenants.get(tenant)
        if b is None:
            if (len(self._tenants) >= self._max_tenants and tenant not in self._quotas
                    and tenant != OTHER_TENANT):
                return self._bucket_locked(OTHER_TENANT, now)
            rate = self._quotas.get(tenant, self._default_rate)
            burst = max(1.0, rate * self._burst_s) if rate > 0 else 0.0
            b = self._tenants[tenant] = _Bucket(rate, burst, now)
        if b.rate > 0:
            b.tokens = min(b.burst, b.tokens + (now - b.refilled_at) * b.rate)
        b.refilled_at = now
        return b

    def try_charge(self, tenant: str | None, n: int = 1) -> bool:
        """Charge ``n`` tokens now; False sheds (the caller raises
        :class:`QuotaExceeded`). Unlimited tenants always pass."""
        now = time.monotonic()
        with self._lock:
            b = self._bucket_locked(tenant or DEFAULT_TENANT, now)
            if b.rate <= 0:
                return True
            if b.tokens >= n:
                b.tokens -= n
                return True
            return False

    def peek(self, tenant: str | None, n: int = 1) -> bool:
        """Would ``n`` tokens (at most a bucket's depth) be there? No charge."""
        now = time.monotonic()
        with self._lock:
            b = self._bucket_locked(tenant or DEFAULT_TENANT, now)
            return b.rate <= 0 or b.tokens >= min(n, b.burst)

    def charge(self, tenant: str | None, n: int = 1) -> None:
        """Consume ``n`` tokens; the balance may go negative (a debt the
        refill repays)."""
        now = time.monotonic()
        with self._lock:
            b = self._bucket_locked(tenant or DEFAULT_TENANT, now)
            if b.rate > 0:
                b.tokens -= n

    def retry_after(self, tenant: str | None, n: int = 1) -> float:
        """Seconds until ``n`` tokens refill, clamped to [0.1, 30]."""
        now = time.monotonic()
        with self._lock:
            b = self._bucket_locked(tenant or DEFAULT_TENANT, now)
            if b.rate <= 0:
                return 0.1
            need = max(0.0, min(n, b.burst) - b.tokens)
            return min(30.0, max(0.1, need / b.rate))

    def count_admit(self, tenant: str | None, slo_class: str | None) -> None:
        now = time.monotonic()
        with self._lock:
            self._bucket_locked(tenant or DEFAULT_TENANT, now).admitted += 1
            if slo_class:
                self._class_admitted[slo_class] = self._class_admitted.get(slo_class, 0) + 1

    def count_shed(self, tenant: str | None, slo_class: str | None, reason: str) -> None:
        now = time.monotonic()
        with self._lock:
            b = self._bucket_locked(tenant or DEFAULT_TENANT, now)
            b.shed[reason] = b.shed.get(reason, 0) + 1
            self._shed_total[reason] = self._shed_total.get(reason, 0) + 1
            if slo_class:
                d = self._class_shed.setdefault(slo_class, {})
                d[reason] = d.get(reason, 0) + 1

    def stats(self) -> dict:
        """The ``/stats`` block ``overload.admission``."""
        with self._lock:
            return {
                "default_rate": self._default_rate,
                "burst_s": self._burst_s,
                "max_tenants": self._max_tenants,
                "tenants": {t: {"rate": b.rate, "tokens": round(b.tokens, 2),
                                "admitted": b.admitted, "shed": dict(b.shed)}
                            for t, b in sorted(self._tenants.items())},
                "classes": {c: {"admitted": self._class_admitted.get(c, 0),
                                "shed": dict(self._class_shed.get(c, {}))}
                            for c in sorted(set(self._class_admitted) | set(self._class_shed))},
                "shed_by_reason": dict(self._shed_total),
            }


# Rung actions in escalation order (level 0 is normal service). Four or more
# rungs add the int8 reroute before any work is shed; three keep the
# reference's original ladder.
RUNG_ACTIONS = {1: "clamp_topk", 2: "small_canvas", 3: "reject_miss"}
RUNG_ACTIONS_QUANT = {1: "clamp_topk", 2: "small_canvas", 3: "quant_reroute", 4: "reject_miss"}
DEFAULT_RUNGS = "0.60:0.40,0.80:0.60,0.95:0.75"


def rung_actions(n_rungs: int) -> dict[int, str]:
    """The action table of a ladder of ``n_rungs`` threshold pairs."""
    return RUNG_ACTIONS_QUANT if n_rungs >= 4 else RUNG_ACTIONS


class PressureController:
    """Walks the ladder on the queue fraction, one rung per dwell up or
    down; :meth:`observe_pressure` runs once per request (float comparisons
    under a leaf lock)."""

    def __init__(self, rungs: list[tuple[float, float]] | None = None, dwell_s: float = 0.5):
        self._lock = named_lock("overload.pressure_lock")
        self.rungs = rungs or self.parse_rungs(DEFAULT_RUNGS)
        self.dwell_s = max(0.0, float(dwell_s))
        self.actions = rung_actions(len(self.rungs))
        self._level = 0
        self._changed_at = time.monotonic()
        self._transitions_total = 0
        self._time_at_level: dict[int, float] = {}
        self._entered_total: dict[int, int] = {}
        self._reroutes_total = 0

    @staticmethod
    def parse_rungs(spec: str | None) -> list[tuple[float, float]]:
        """``"0.60:0.40,0.80:0.60,0.95:0.75"`` → [(enter, exit), ...]; an exit
        above its enter is clamped to it, malformed entries are dropped, and
        nothing left falls back to the defaults."""
        out: list[tuple[float, float]] = []
        for part in (spec or "").split(","):
            part = part.strip()
            if not part:
                continue
            enter, _, exit_ = part.partition(":")
            try:
                e, x = float(enter), float(exit_ or enter)
            except ValueError:
                log.warning("pressure_rungs: ignoring malformed %r", part)
                continue
            out.append((e, min(x, e)))
        return out or [(0.60, 0.40), (0.80, 0.60), (0.95, 0.75)]

    @classmethod
    def from_spec(cls, spec: str | None, dwell_s: float = 0.5) -> PressureController:
        return cls(cls.parse_rungs(spec or DEFAULT_RUNGS), dwell_s=dwell_s)

    @property
    def level(self) -> int:
        with self._lock:
            return self._level

    @property
    def reject_level(self) -> int:
        """The level that sheds cache-miss work: the last rung."""
        for lvl, action in sorted(self.actions.items(), reverse=True):
            if action == "reject_miss":
                return lvl
        return len(self.rungs)

    @property
    def quant_level(self) -> int | None:
        """The int8 reroute's level, None on a three-rung ladder."""
        for lvl, action in self.actions.items():
            if action == "quant_reroute":
                return lvl
        return None

    def count_reroute(self, n: int = 1) -> None:
        """Count ``n`` images the reroute rung sent to the int8 variant."""
        with self._lock:
            self._reroutes_total += n

    def observe_pressure(self, frac: float, now: float | None = None) -> int:
        """One step on the queue fraction ``frac``: the level to serve this
        request at. A move waits out the dwell and goes one rung."""
        if now is None:
            now = time.monotonic()
        with self._lock:
            lvl = self._level
            if now - self._changed_at < self.dwell_s:
                return lvl
            nxt = lvl
            if lvl < len(self.rungs) and frac >= self.rungs[lvl][0]:
                nxt = lvl + 1
            elif lvl > 0 and frac < self.rungs[lvl - 1][1]:
                nxt = lvl - 1
            if nxt != lvl:
                self._time_at_level[lvl] = self._time_at_level.get(lvl, 0.0) + (
                    now - self._changed_at)
                self._level = nxt
                self._changed_at = now
                self._transitions_total += 1
                if nxt > lvl:
                    self._entered_total[nxt] = self._entered_total.get(nxt, 0) + 1
                log.warning("degradation ladder: level %d -> %d (queue frac %.2f, action=%s)",
                            lvl, nxt, frac, self.actions.get(nxt, "normal"))
            return self._level

    def stats(self) -> dict:
        now = time.monotonic()
        with self._lock:
            at = dict(self._time_at_level)
            at[self._level] = at.get(self._level, 0.0) + (now - self._changed_at)
            return {
                "level": self._level,
                "action": self.actions.get(self._level, "normal"),
                "rungs": [{"enter": e, "exit": x} for e, x in self.rungs],
                "dwell_s": self.dwell_s,
                "quant_reroutes": self._reroutes_total,
                "transitions_total": self._transitions_total,
                "entered_total": {str(k): v for k, v in sorted(self._entered_total.items())},
                "seconds_at_level": {str(k): round(v, 3) for k, v in sorted(at.items())},
            }


def build_admission(cfg) -> AdmissionController:
    """The shared admission controller of a ServerConfig."""
    return AdmissionController.from_spec(cfg.tenant_quota, burst_s=cfg.tenant_burst_s,
                                         max_tenants=cfg.tenant_max_tracked)


def build_pressure(cfg) -> PressureController:
    return PressureController.from_spec(cfg.pressure_rungs, dwell_s=cfg.pressure_dwell_s)
