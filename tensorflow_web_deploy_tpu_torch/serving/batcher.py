"""Slot-leased dynamic batcher with a pipelined dispatch path (a lean
counterpart of the JAX package's ``serving/batcher.py``).

**Slot leases.** A request thread asks for a slot in the open batch
builder of its canvas bucket: :meth:`Batcher.lease` for a classic-wire
row (canvas bytes + trailer in an ``engine.StagingSlab``), or
:meth:`Batcher.lease_ragged` for ``need`` bytes of a ragged arena
(``engine.RaggedSlab``). The lease's ``row`` is a view of the slab's
pinned memory, and the native decoder writes the upload straight into it:
the image's one host copy, made on the request thread with the interpreter
lock released. ``commit(hw)`` marks the slot ready; ``commit(hw,
canvas=…)`` copies a decoded array in (the PIL fallback, :meth:`submit`);
``release()`` abandons it. A sealed batch ships released and expired
slots as holes (hw 1×1 on the classic wire, ``valid = 0`` in the ragged
meta table); a builder of holes only is discarded without a dispatch.
A ragged arena that cannot fit the next image seals, and a fresh one opens.

**Pipelined dispatch.** Each stage has its own thread(s), and batches flow
through them:

    request threads   decode/commit into builder N+1's slab (parallel)
    sealer            only seals: picks a due builder, hands it off
    launch pool       H2D on the engine's copy stream + serve enqueue +
                      the output's async D2H
    device            runs batch N while N+1 copies and N+2 assembles
    completion pool   waits for the outputs, resolves the futures

``pipeline_depth`` bounds the batches sealed but not yet fetched per canvas
bucket; the sealer waits at the cap, so batches grow while the device is
the bottleneck. ``max_delay_ms`` caps the assembly window, which adapts to
the backlog (:meth:`_update_delay`, starting at 0). With ``max_queue == 0``
leasing blocks at ``max_batch × max(2, pipeline_depth)`` outstanding slots;
with ``max_queue > 0`` a backlog at that many images raises
:class:`BacklogFull` (HTTP: 503 + Retry-After). Every batch's open, seal,
launch start and end, and fetch are stamped into a ring
(:meth:`batch_timeline`).

Slot bookkeeping lives under one condition variable; decoding and copying
into a row happen outside it, since each slot has exactly one lessee. A
force-expired lessee may still be writing into its row while its batch
runs: the row ships as a hole, its future has failed, and the slab returns
to the engine's pool only once that thread resolves its lease.

**Overload admission.** A lease sheds in the reference's order, before
any decode or device time: the backlog at ``max_queue`` (:class:`BacklogFull`),
the tenant's token bucket (``admission``, :class:`~.overload.QuotaExceeded`),
then the request's deadline against the expected wait (backlog ÷ the
drain rate + the live window + the device-time EMA of
:class:`~..utils.metrics.RollingStats`), checked only with a backlog, so
an idle server never sheds on an estimate of nothing
(:class:`~.overload.DeadlineExceeded`). At seal a committed row whose
deadline passed becomes a hole and its future fails. ``chaos`` injects
dispatch failures in the launch and straggling fetches in the completion
threads.

Left out of the reference: the bulk traffic class, spans, replica routing.
"""

from __future__ import annotations

import logging
import math
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future

import numpy as np

from ..utils.metrics import RollingStats
from .chaos import ChaosError
from .overload import DEFAULT_TENANT, DeadlineExceeded, QuotaExceeded

log = logging.getLogger("tpu_serve_torch.batcher")

# slot states: PENDING, the lessee is decoding; READY, committed; HOLE,
# released or expired
_PENDING, _READY, _HOLE = 0, 1, 2
# launch and completion threads: the reference's max(2, min(16, replicas))
# for one replica
POOL_THREADS = 2


class ShuttingDown(RuntimeError):
    """The batcher is draining for shutdown (HTTP: 503)."""


class BacklogFull(RuntimeError):
    """The backlog is at ``max_queue`` images (HTTP: 503 + Retry-After)."""

    def __init__(self, msg: str, retry_after_s: float = 1.0):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


class LeaseExpired(RuntimeError):
    """A leased slot was neither committed nor released within the lease
    timeout; its batch went without it."""


class SlotLease:
    """One reserved slot of an assembling batch. ``row`` is a writable view
    of the slot's pinned memory: decode into it, then :meth:`commit`.
    Exactly one of commit and release must be called; the slot's (scores,
    indices) row arrives on ``future``."""

    __slots__ = ("_batcher", "builder", "index", "future", "state", "leased_at", "row",
                 "slab_held", "deadline", "tenant")

    def __init__(self, batcher: Batcher, builder: _Builder, index: int, row: np.ndarray,
                 deadline: float | None = None, tenant: str | None = None):
        self._batcher = batcher
        self.builder = builder
        self.index = index
        self.future: Future = Future()
        self.state = _PENDING
        self.leased_at = time.monotonic()
        self.row = row
        self.slab_held = True
        # the monotonic deadline the sealer re-checks (None: no SLO)
        self.deadline = deadline
        self.tenant = tenant

    def commit(self, hw: tuple[int, int], canvas: np.ndarray | None = None) -> Future:
        """The slot holds an image of valid size ``hw``: decoded into
        ``row`` already, or ``canvas`` copied in now."""
        return self._batcher._commit(self, hw, canvas)

    def release(self) -> None:
        """Abandon the slot: it ships as a hole (its result, if its batch
        already left, is dropped)."""
        self._batcher._release_lease(self)


class _Builder:
    """One assembling batch of one canvas bucket: its slab, its leases and
    its sealing deadline."""

    __slots__ = ("key", "slab", "capacity", "leases", "opened_at", "deadline", "accepting",
                 "dispatched", "n_pending", "n_ready")

    def __init__(self, key, slab, capacity: int, deadline: float):
        self.key = key
        self.slab = slab
        self.capacity = capacity
        self.leases: list[SlotLease] = []
        self.opened_at = time.monotonic()
        self.deadline = deadline
        self.accepting = True
        self.dispatched = False
        self.n_pending = 0
        self.n_ready = 0


class Batcher:
    def __init__(self, engine, max_batch: int | None = None, max_delay_ms: float = 2.0,
                 pipeline_depth: int = 4, adaptive_delay: bool = True, max_queue: int = 0,
                 lease_timeout_s: float = 10.0, admission=None, chaos=None):
        self.engine = engine
        # the registry's shared tenant quotas and fault injector (None: off)
        self.admission = admission
        self.chaos = chaos
        # never more than the engine's top batch bucket
        self.max_batch = min(max_batch or engine.max_batch, engine.max_batch)
        self.max_delay_s = max_delay_ms / 1e3
        self.adaptive_delay = adaptive_delay
        # the live window in [0, max_delay_s]: an idle server dispatches at once
        self._delay_s = 0.0 if adaptive_delay else self.max_delay_s
        self.lease_timeout_s = lease_timeout_s
        self.pipeline_depth = max(1, pipeline_depth)
        self.max_queue = max(0, int(max_queue))
        self._cond = threading.Condition()
        self._open: dict[tuple, _Builder] = {}  # accepting builders by key
        self._closing: list[_Builder] = []  # sealed to new leases, not dispatched
        self._pending_slots = 0  # leased, not yet handed off
        self._max_pending = self.max_batch * max(2, self.pipeline_depth)
        if self.max_queue:  # the bound must be reachable, or BacklogFull never fires
            self._max_pending = max(self._max_pending, self.max_queue)
        self._inflight_by_key: dict[tuple, int] = {}
        self._inflight_total = self._inflight_peak = 0
        # depth is gated at the seal decision, so these never block a stop
        self._launch_q: queue.Queue = queue.Queue()
        self._done_q: queue.Queue = queue.Queue()
        self._running = False
        self._started = False
        self._sealer = threading.Thread(target=self._seal_loop, name="batch-sealer",
                                        daemon=True)
        self._launchers = [threading.Thread(target=self._launch_loop, args=(i,),
                                            name=f"batch-launch-{i}", daemon=True)
                           for i in range(POOL_THREADS)]
        self._completions = [threading.Thread(target=self._fetch_loop,
                                              name=f"batch-complete-{i}", daemon=True)
                             for i in range(POOL_THREADS)]
        self._warm: list[Future] = [Future() for _ in self._launchers]
        self._warmup = False
        self.batches = self.images = 0
        self._sealed = self._discarded = 0
        self._holes = self._lease_timeouts = self._rejects = 0
        self._host_copies = 0
        self._deadline_sheds = self._deadline_seal_sheds = self._quota_sheds = 0
        # resolved rows: the drain rate and device time admission reads
        self.rolling = RollingStats()
        self._batch_seq = 0
        self._timeline: deque = deque(maxlen=512)

    # ------------------------------------------------------------ lifecycle

    def start(self, warmup: bool = False) -> Batcher:
        """Start the sealer and the pools. With ``warmup``, every launch
        thread runs the engine's warmup before it takes batches, and this
        returns once all are done (re-raising a failure): first-use costs
        are paid per thread on CUDA — a warmup on another thread left the
        dispatch thread's first batches 10-25x slower (PERF.md)."""
        self._warmup = warmup
        self._running = self._started = True
        for t in (self._sealer, *self._launchers, *self._completions):
            t.start()
        try:
            for f in self._warm:
                f.result()
        except BaseException:
            self.stop()
            raise
        return self

    def stop(self, timeout: float = 30.0) -> None:
        """Drain: seal every open builder (waiting for decodes in flight up
        to a short grace), launch and fetch every sealed batch, resolve
        every future; then end the threads."""
        with self._cond:
            self._running = False
            self._cond.notify_all()
        if not self._started:
            return
        self._sealer.join(timeout)
        for _ in self._launchers:
            self._launch_q.put(None)
        for t in self._launchers:
            t.join(timeout)
        for _ in self._completions:
            self._done_q.put(None)
        for t in self._completions:
            t.join(timeout)
        # a wedged stage left work queued: fail it rather than strand callers
        for q in (self._launch_q, self._done_q):
            while True:
                try:
                    item = q.get_nowait()
                except queue.Empty:
                    break
                if item is not None:
                    self._fail(item[1] if q is self._launch_q else item[0],
                               ShuttingDown("server shutting down"))

    # -------------------------------------------------------------- leasing

    def _retry_after_locked(self) -> float:
        """Backlog over the recent drain rate, clamped to [1, 30] s."""
        rate = self.rolling.rate_hint()
        if rate <= 0:
            return 1.0
        return min(30.0, max(1.0, math.ceil(self._pending_slots / rate)))

    def _expected_wait_locked(self) -> float:
        """How long a slot leased now waits for its answer: backlog ÷ the
        drain rate (0 before there is a rate) + the live window + device
        time per row."""
        rate = self.rolling.rate_hint()
        backlog_s = self._pending_slots / rate if rate > 0 else 0.0
        return backlog_s + self._delay_s + self.rolling.device_hint()

    def _admit_locked(self, t0: float, deadline: float | None, tenant: str | None) -> None:
        """Shed in the order backlog → quota → deadline, then block at the
        outstanding-slot cap."""
        if self.max_queue and self._running and self._pending_slots >= self.max_queue:
            self._rejects += 1
            raise BacklogFull(f"batcher backlog {self._pending_slots} images ≥ max_queue "
                              f"{self.max_queue}", retry_after_s=self._retry_after_locked())
        if self.admission is not None and self._running and not self.admission.try_charge(
                tenant):
            self._quota_sheds += 1
            raise QuotaExceeded(f"tenant {tenant or DEFAULT_TENANT!r} quota exhausted",
                                tenant=tenant or DEFAULT_TENANT,
                                retry_after_s=self.admission.retry_after(tenant))
        # with no backlog the estimate is all device EMA: never shed on it
        if deadline is not None and self._running and self._pending_slots > 0:
            wait = self._expected_wait_locked()
            if t0 + wait > deadline:
                self._deadline_sheds += 1
                raise DeadlineExceeded(
                    f"deadline in {max(0.0, deadline - t0) * 1e3:.0f} ms but expected wait "
                    f"is {wait * 1e3:.0f} ms", expected_wait_s=wait,
                    retry_after_s=self._retry_after_locked())
        while self._running and self._pending_slots >= self._max_pending:
            self._cond.wait(timeout=0.25)
        if not self._running:
            raise ShuttingDown("server shutting down")

    def _new_builder_locked(self, key, slab) -> _Builder:
        b = _Builder(key, slab, min(self.max_batch, slab.capacity),
                     time.monotonic() + self._update_delay())
        self._open[key] = b
        return b

    def _add_lease_locked(self, b: _Builder, index: int, row: np.ndarray,
                          deadline: float | None, tenant: str | None) -> SlotLease:
        lease = SlotLease(self, b, index, row, deadline, tenant)
        b.leases.append(lease)
        b.n_pending += 1
        self._pending_slots += 1
        b.slab.add_lease()
        if len(b.leases) >= b.capacity:
            self._close_builder_locked(b)
        self._cond.notify_all()  # the sealer: a new deadline or a full builder
        return lease

    def lease(self, row_shape: tuple[int, ...], deadline: float | None = None,
              tenant: str | None = None) -> SlotLease:
        """A slot for one classic-wire canvas of ``row_shape`` (the engine's
        ``canvas_shape(1, s)[1:]``) in the open builder of its canvas side.
        ``deadline`` (monotonic) and ``tenant`` go through admission. Raises
        :class:`BacklogFull`, :class:`~.overload.QuotaExceeded`,
        :class:`~.overload.DeadlineExceeded` or :class:`ShuttingDown`; blocks
        at the outstanding-slot cap."""
        key = tuple(int(d) for d in row_shape)
        t0 = time.monotonic()
        with self._cond:
            self._admit_locked(t0, deadline, tenant)
            b = self._open.get(key)
            if b is None:
                # the canvas side: (s, s, 3) on rgb, (3s/2, s) on yuv420
                b = self._new_builder_locked(key, self.engine.acquire_staging(key[1]))
            i = len(b.leases)
            return self._add_lease_locked(b, i, b.slab.row(i), deadline, tenant)

    def lease_ragged(self, need_bytes: int, s: int, deadline: float | None = None,
                     tenant: str | None = None) -> SlotLease:
        """``need_bytes`` (one image's h·w·3) of the open ragged arena of
        canvas side ``s``; an arena that cannot fit them seals, and a fresh
        one opens. Admission as :meth:`lease`."""
        key = ("ragged", int(s))
        if need_bytes > s * s * 3:
            raise ValueError(f"ragged lease of {need_bytes} B exceeds one {s}px canvas row")
        t0 = time.monotonic()
        with self._cond:
            self._admit_locked(t0, deadline, tenant)
            b = self._open.get(key)
            if b is None:
                b = self._new_builder_locked(key, self.engine.acquire_ragged(s))
            got = b.slab.alloc(need_bytes)
            if got is None:  # as packed as it gets: seal, start the next arena
                self._close_builder_locked(b)
                b = self._new_builder_locked(key, self.engine.acquire_ragged(s))
                got = b.slab.alloc(need_bytes)
            return self._add_lease_locked(b, *got, deadline, tenant)

    def submit(self, canvas: np.ndarray, hw: tuple[int, int], deadline: float | None = None,
               tenant: str | None = None) -> Future:
        """Queue one decoded wire canvas (one copy into its slot); the
        future resolves to its row. Admission sheds raise as from
        :meth:`lease`."""
        try:
            lease = self.lease(canvas.shape, deadline, tenant)
        except ShuttingDown as e:
            f: Future = Future()
            f.set_exception(e)
            return f
        return lease.commit(hw, canvas=canvas)

    def submit_ragged(self, tight: np.ndarray, hw: tuple[int, int], s: int,
                      deadline: float | None = None, tenant: str | None = None) -> Future:
        """Queue one tight image (uint8 [h, w, 3]) of canvas side ``s`` for
        the ragged wire; the future resolves to its row."""
        try:
            lease = self.lease_ragged(tight.nbytes, s, deadline, tenant)
        except ShuttingDown as e:
            f: Future = Future()
            f.set_exception(e)
            return f
        return lease.commit(hw, canvas=tight)

    def _close_builder_locked(self, b: _Builder) -> None:
        if b.accepting:
            b.accepting = False
            if self._open.get(b.key) is b:
                del self._open[b.key]
            self._closing.append(b)

    def _commit(self, lease: SlotLease, hw, canvas) -> Future:
        b = lease.builder
        # the slot is this lessee's alone until the state flips below
        try:
            if canvas is not None:
                if b.slab.is_ragged:
                    lease.row[:] = np.ascontiguousarray(canvas, dtype=np.uint8).reshape(-1)
                else:
                    b.slab.canvases[lease.index] = canvas
            b.slab.write_hw(lease.index, hw)
        except BaseException:  # a canvas that does not fit its slot
            self._release_lease(lease)
            raise
        with self._cond:
            if lease.state == _PENDING:
                lease.state = _READY
                b.n_pending -= 1
                b.n_ready += 1
                # decoded into the slot: one copy; decoded elsewhere: two
                self._host_copies += 1 if canvas is None else 2
                self._cond.notify_all()
            self._drop_slab_locked(lease)  # expired meanwhile: the batch left without it
        return lease.future

    def _drop_slab_locked(self, lease: SlotLease) -> None:
        if lease.slab_held:
            lease.slab_held = False
            lease.builder.slab.drop_lease()

    def _release_lease(self, lease: SlotLease) -> None:
        b = lease.builder
        with self._cond:
            self._drop_slab_locked(lease)
            if lease.state == _PENDING:
                b.n_pending -= 1
            elif lease.state == _READY and not b.dispatched:
                b.n_ready -= 1  # a sibling upload failed: no device work for it
            else:
                return  # a hole already, or its batch left: the result is dropped
            lease.state = _HOLE
            self._pending_slots -= 1
            self._holes += 1
            if not lease.future.done():
                lease.future.set_exception(RuntimeError("slot lease released"))
            self._cond.notify_all()

    # -------------------------------------------------------------- sealing

    def _update_delay(self) -> float:
        """One controller step: move the live window toward a target set by
        the outstanding slots (none → 0, a batch's worth → the cap)."""
        if not self.adaptive_delay:
            return self.max_delay_s
        target = self.max_delay_s * min(1.0, self._pending_slots / max(1, self.max_batch - 1))
        self._delay_s += 0.25 * (target - self._delay_s)
        self._delay_s = min(self.max_delay_s, max(0.0, self._delay_s))
        return self._delay_s

    def _expire_locked(self, b: _Builder, now: float, timeout: float) -> None:
        expired = False
        for lease in b.leases:
            if lease.state == _PENDING and now - lease.leased_at > timeout:
                lease.state = _HOLE
                b.n_pending -= 1
                self._pending_slots -= 1
                self._lease_timeouts += 1
                self._holes += 1
                expired = True
                lease.future.set_exception(LeaseExpired(
                    f"slot lease expired after {timeout:.1f}s"))
                # the slab stays held: its lessee may still be writing the row
        if expired:
            self._cond.notify_all()  # freed cap slots wake lease() waiters now

    def _shed_dead_rows_locked(self, b: _Builder, now: float) -> None:
        """Committed rows whose deadline passed while they waited become
        holes before the batch takes a depth slot; each future fails with
        :class:`~.overload.DeadlineExceeded` (HTTP: 504 at once, not after
        device time nobody reads)."""
        shed = False
        for lease in b.leases:
            if lease.state == _READY and lease.deadline is not None and now > lease.deadline:
                lease.state = _HOLE
                b.n_ready -= 1
                self._pending_slots -= 1
                self._holes += 1
                self._deadline_seal_sheds += 1
                shed = True
                try:
                    lease.future.set_exception(DeadlineExceeded(
                        "deadline passed while the request waited for dispatch",
                        retry_after_s=self._retry_after_locked()))
                except Exception:
                    pass  # the caller gave up on it already
        if shed:
            self._cond.notify_all()  # freed cap slots wake lease() waiters now

    def _pick_action_locked(self, now: float):
        """("dispatch" | "discard", builder) for one sealer wakeup, or None
        to wait. A dispatch has taken its pipeline-depth slot."""
        draining = not self._running
        grace = min(self.lease_timeout_s, 2.0) if draining else self.lease_timeout_s
        for b in list(self._open.values()):
            self._expire_locked(b, now, grace)
            if draining or len(b.leases) >= b.capacity or (
                    now >= b.deadline and not b.n_pending
                    and self._inflight_by_key.get(b.key, 0) < self.pipeline_depth):
                self._close_builder_locked(b)
        for b in self._closing:
            self._expire_locked(b, now, grace)
        for b in self._closing:
            if b.n_pending:
                continue  # a lessee is still decoding; bounded by expiry
            self._shed_dead_rows_locked(b, now)
            if b.n_ready == 0:
                self._closing.remove(b)
                b.dispatched = True
                return "discard", b
            if draining or self._inflight_by_key.get(b.key, 0) < self.pipeline_depth:
                self._closing.remove(b)
                b.dispatched = True
                self._inflight_by_key[b.key] = self._inflight_by_key.get(b.key, 0) + 1
                self._inflight_total += 1
                self._inflight_peak = max(self._inflight_peak, self._inflight_total)
                return "dispatch", b
        return None

    def _next_wake_locked(self, now: float) -> float | None:
        wake = [b.deadline for b in self._open.values() if b.deadline > now]
        grace = self.lease_timeout_s if self._running else min(self.lease_timeout_s, 2.0)
        wake += [lease.leased_at + grace for b in (*self._open.values(), *self._closing)
                 for lease in b.leases if lease.state == _PENDING]
        return max(0.0005, min(wake) - now) if wake else None

    def _seal_loop(self) -> None:
        while True:
            with self._cond:
                while True:
                    now = time.monotonic()
                    action = self._pick_action_locked(now)
                    if action is not None:
                        break
                    if not self._running and not self._open and not self._closing:
                        return  # drained
                    self._cond.wait(timeout=self._next_wake_locked(now))
            kind, b = action
            if kind == "dispatch":
                self._hand_off(b)
            else:
                self.engine.release_staging(b.slab)
                with self._cond:
                    self._discarded += 1

    def _hand_off(self, b: _Builder) -> None:
        """Seal one builder and queue it for the launch pool; the sealer does
        no device work, and the slot cap frees here."""
        ready = [lease for lease in b.leases if lease.state == _READY]
        with self._cond:
            self._pending_slots -= len(ready)
            self._sealed += 1
            self._batch_seq += 1
            rec = {"seq": self._batch_seq, "key": b.key, "rows": len(ready), "bucket": None,
                   "t_open": b.opened_at, "t_seal": time.monotonic(), "t_launch": None,
                   "t_launched": None, "t_done": None}
            self._timeline.append(rec)
            self._cond.notify_all()  # lease() waiters and the next seal decision
        self._launch_q.put((b, ready, rec))

    def _batch_done(self, key) -> None:
        """A batch left the pipeline (fetched or failed): free its depth slot."""
        with self._cond:
            n = self._inflight_by_key.get(key, 0) - 1
            if n > 0:
                self._inflight_by_key[key] = n
            else:
                self._inflight_by_key.pop(key, None)
            self._inflight_total -= 1
            self._cond.notify_all()

    # ------------------------------------------------------------- dispatch

    def _launch_loop(self, i: int) -> None:
        try:
            if self._warmup:
                self.engine.warmup()
        except BaseException as e:
            self._warm[i].set_exception(e)
            return
        self._warm[i].set_result(None)
        while True:
            item = self._launch_q.get()
            if item is None:
                return
            self._launch(*item)

    def _launch(self, b: _Builder, ready: list[SlotLease], rec: dict) -> None:
        """Ship one sealed builder (launch-pool thread): mark its holes, then
        the engine's dispatch (H2D, serve enqueue, async D2H)."""
        rec["t_launch"] = time.monotonic()
        try:
            if self.chaos is not None and self.chaos.dispatch_fault():
                # inside the try: the organic failed-dispatch path below
                raise ChaosError("chaos: injected dispatch failure")
            n = max(lease.index for lease in ready) + 1
            for lease in b.leases:
                if lease.state == _HOLE and lease.index < n:
                    b.slab.hole(lease.index)
            dispatch = self.engine.dispatch_ragged if b.slab.is_ragged \
                else self.engine.dispatch_staged
            handle = dispatch(b.slab, n)
        except Exception as e:  # the batch fails, its requests fail, the server lives
            log.exception("dispatch of a batch of %d failed", len(ready))
            self._fail(ready, e)
            rec["t_launched"] = rec["t_done"] = time.monotonic()
            self.engine.release_staging(b.slab)
            self._batch_done(b.key)
            return
        rec["t_launched"] = time.monotonic()
        rec["bucket"] = self.engine.pick_batch_bucket(n)
        # a batch that ran eagerly pays one-time costs: keep its time out of
        # the device EMA that deadline admission reads
        rec["replay"] = getattr(handle, "replay", True)
        self._done_q.put((ready, handle, rec))

    def _fetch_loop(self) -> None:
        while True:
            item = self._done_q.get()
            if item is None:
                return
            ready, handle, rec = item
            if self.chaos is not None:
                delay = self.chaos.fetch_delay()  # a straggling device holds its depth slot
                if delay > 0:
                    time.sleep(delay)
            try:
                scores, idx = self.engine.fetch_outputs(handle)
            except Exception as e:
                log.exception("fetch of a batch of %d failed", len(ready))
                self._fail(ready, e)
                rec["t_done"] = time.monotonic()
                self._batch_done(rec["key"])
                continue
            rec["t_done"] = now = time.monotonic()
            t_launch = rec["t_launch"]
            device_s = now - t_launch if rec["replay"] else None
            for lease in ready:
                try:
                    lease.future.set_result((scores[lease.index], idx[lease.index]))
                except Exception:
                    pass  # cancelled by a caller that gave up
                self.rolling.record(latency_s=now - lease.leased_at,
                                    queue_s=t_launch - lease.leased_at, device_s=device_s,
                                    batch_size=len(ready))
            with self._cond:
                self.batches += 1
                self.images += len(ready)
            self._batch_done(rec["key"])

    def _fail(self, leases: list[SlotLease], e: Exception) -> None:
        for lease in leases:
            try:
                lease.future.set_exception(e)
            except Exception:
                pass  # resolved or cancelled already
            self.rolling.record_error()

    # ------------------------------------------------------------ telemetry

    @property
    def queue_depth(self) -> int:
        """Leased slots not yet handed off: the backlog the ladder reads."""
        return self._pending_slots

    @property
    def queue_cap(self) -> int:
        """The backlog the ladder's queue fraction is taken against:
        ``max_queue``, else the outstanding-slot cap."""
        return self.max_queue or self._max_pending

    def batch_timeline(self) -> list[dict]:
        """The recent batches' lifecycle on the monotonic clock: builder
        ``t_open`` → ``t_seal`` (assembly) → ``t_launch`` → ``t_launched``
        (H2D + serve enqueue) → ``t_done`` (outputs on the host); None for
        a stage not reached yet."""
        with self._cond:
            return [dict(r) for r in self._timeline]

    def stats(self) -> dict:
        with self._cond:
            return {
                "batches": self.batches,
                "images": self.images,
                "queued": self._pending_slots,
                "max_batch": self.max_batch,
                "max_delay_ms": self.max_delay_s * 1e3,
                "current_delay_ms": self._delay_s * 1e3,
                "adaptive_delay": self.adaptive_delay,
                "pipeline_depth": self.pipeline_depth,
                "inflight": self._inflight_total,
                "inflight_peak": self._inflight_peak,
                "sealed": self._sealed,
                "discarded": self._discarded,
                "holes": self._holes,
                "lease_timeouts": self._lease_timeouts,
                "max_queue": self.max_queue,
                "backlog_rejects": self._rejects,
                "quota_sheds_total": self._quota_sheds,
                "deadline_sheds_total": self._deadline_sheds,
                "deadline_seal_sheds_total": self._deadline_seal_sheds,
                "host_copies": self._host_copies,
                "rolling": self.rolling.snapshot(),
            }
