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

``pipeline_depth`` bounds the batches sealed but not yet fetched per
(canvas bucket, replica); the sealer waits at the cap, so batches grow
while the device is the bottleneck. ``max_delay_ms`` caps the assembly
window, which adapts to the backlog (:meth:`_update_delay`, starting at 0). With ``max_queue == 0``
leasing blocks at ``max_batch × max(2, pipeline_depth)`` outstanding slots;
with ``max_queue > 0`` a backlog at that many images raises
:class:`BacklogFull` (HTTP: 503 + Retry-After). Every batch's open, seal,
launch start and end, and fetch are stamped into a ring
(:meth:`batch_timeline`), with ``t_sealable``: when the batch could first
have sealed had the depth cap (or, for a bulk batch, the gate) not held
it — its rows settled (none still decoding) and its builder full, closed
or past its window. The engine gets that stamp and ``t_seal`` with the
dispatch; once a batch's answers are out and its depth slot is free, the
completion thread has the engine split the device's gap before the batch
at them (``engine.join_gaps``, ``utils/tracing.py::split_gap``) and adds
the joined device intervals to the record (``device``).

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

**Spans.** A lease carries its request's :class:`~..utils.tracing.Span`:
the lease stamps ``lease_wait``, the commit ``staging_write``, the launch
``queue_wait`` (merged with ``add_max``: a request's images may ride
concurrent batches) and notes ``batch_bucket``, the engine stamps
``device_transfer`` and ``device_dispatch``, and the completion thread
stamps ``device_execute`` before it resolves the future. Every dispatch
feeds :meth:`~..utils.metrics.RollingStats.record_batch` and the padding
counters per (canvas, batch bucket) behind ``model_padding_*``.

**Replica routing.** An engine whose placement has several replicas
(``supports_replica_routing``: ``num_replicas``, ``replica_loads``,
``dispatch_*(replica=)``) gets each sealed batch routed at the dispatch
decision to one replica with depth left for its bucket, the least loaded
by the engine's in-flight count, round-robin order breaking ties; the
batch records it (``_Builder.replica``, the timeline's ``replica``). N
replicas sustain N × ``pipeline_depth`` batches in flight per bucket, and
the launch and completion pools grow to one thread per replica (2 to 16).

**Bulk traffic class** (``serving/jobs.py``). ``lease(..., bulk=True)``,
``lease_ragged(..., bulk=True)`` and ``submit(..., bulk=True)`` stage into
builders of their own, keyed by (row shape, bulk), that fill up to
``bulk_max_batch`` rows: min(``jobs_batch``, the engine's top batch
bucket), the throughput shape the interactive path never reaches. A
sealed bulk batch takes the device only through the gate
(:meth:`_bulk_gate_open_locked`): bulk's own in-flight cap
(``bulk_inflight``, ``--jobs-max-inflight``) has room, the job tenant's
token bucket can pay for its rows (``admission.peek``; ``charge`` at
dispatch), and no interactive batch is sealed and waiting or in flight on
any replica's stream, so an interactive batch sealed during a bulk replay
waits at most for that replay. A batch gated for ``bulk_starvation_s``
goes through once (the valve), then the clock re-arms, so sustained
interactive load slows a job down but never stops it. While the gate is
closed a past-deadline bulk builder keeps accepting leases: bulk batches
grow exactly while interactive load holds the device. Bulk leases block
at their own cap and never shed: they count in neither ``max_queue``, the
interactive slot cap nor the adaptive window. A drain lifts the gate. A
bulk batch goes to the least loaded replica
(:meth:`_pick_bulk_replica_locked`); the gate, not the per-bucket depth,
bounds it.
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

from ..utils.locks import named_condition
from ..utils.metrics import RollingStats
from ..utils.tracing import canvas_side, profiler_range
from .chaos import ChaosError
from .overload import DEFAULT_TENANT, DeadlineExceeded, QuotaExceeded

log = logging.getLogger("tpu_serve_torch.batcher")

# slot states: PENDING, the lessee is decoding; READY, committed; HOLE,
# released or expired
_PENDING, _READY, _HOLE = 0, 1, 2
# how often a bulk batch held by its tenant's quota re-reads the gate
_QUOTA_RECHECK_S = 0.05
# the bulk assembly window, a backstop only: a full chunk seals at capacity
# and the job runner seals a manifest's tail itself (flush_bulk)
_BULK_DELAY_S = 1.0


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
    Exactly one of commit and release must be called; the slot's row of
    the engine's output arrays (``fetch_outputs``) arrives on ``future``
    as a tuple."""

    __slots__ = ("_batcher", "builder", "index", "future", "state", "leased_at", "row",
                 "slab_held", "deadline", "tenant", "span", "hw", "committed_at")

    def __init__(self, batcher: Batcher, builder: _Builder, index: int, row: np.ndarray,
                 deadline: float | None = None, tenant: str | None = None, span=None):
        self._batcher = batcher
        self.builder = builder
        self.index = index
        self.future: Future = Future()
        self.state = _PENDING
        self.leased_at = time.monotonic()
        self.committed_at: float | None = None
        self.hw: tuple[int, int] | None = None
        self.span = span  # the request's trace span, or None
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
                 "dispatched", "n_pending", "n_ready", "replica", "bulk", "tenant",
                 "settled_at", "sealable_at")

    def __init__(self, key, slab, capacity: int, deadline: float, bulk: bool = False):
        self.key = key
        # the bulk traffic class, and the job tenant its dispatch charges
        self.bulk = bulk
        self.tenant: str | None = None
        self.slab = slab
        self.capacity = capacity
        self.leases: list[SlotLease] = []
        self.opened_at = time.monotonic()
        self.deadline = deadline
        self.accepting = True
        self.dispatched = False
        self.n_pending = 0
        self.n_ready = 0
        # the dispatch replica, set when the batch takes its depth slot
        self.replica = 0
        # monotonic: its leases last all settled (none decoding); it could
        # first seal had the depth cap not held it
        self.settled_at: float | None = None
        self.sealable_at: float | None = None


class Batcher:
    # callers may lease a slot and decode into it (jobs' staging reads this)
    supports_lease = True

    def __init__(self, engine, max_batch: int | None = None, max_delay_ms: float = 2.0,
                 pipeline_depth: int = 4, adaptive_delay: bool = True, max_queue: int = 0,
                 lease_timeout_s: float = 10.0, admission=None, chaos=None,
                 bulk_max_batch: int | None = None, bulk_inflight: int = 2,
                 bulk_starvation_s: float = 2.0):
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
        self._cond = named_condition("batcher.cond")
        self._open: dict[tuple, _Builder] = {}  # accepting builders by key
        self._closing: list[_Builder] = []  # sealed to new leases, not dispatched
        self._pending_slots = 0  # leased, not yet handed off
        self._max_pending = self.max_batch * max(2, self.pipeline_depth)
        if self.max_queue:  # the bound must be reachable, or BacklogFull never fires
            self._max_pending = max(self._max_pending, self.max_queue)
        # the bulk class: its batch target is capped at the engine's top batch
        # bucket, not the interactive max_batch
        top = (getattr(engine, "batch_buckets", None) or (engine.max_batch,))[-1]
        self.bulk_max_batch = max(1, min(256 if bulk_max_batch is None else bulk_max_batch,
                                         top))
        self.bulk_inflight_cap = max(1, int(bulk_inflight))
        self.bulk_delay_s = _BULK_DELAY_S
        self.bulk_starvation_s = max(0.05, float(bulk_starvation_s))
        self._bulk_gated_since: float | None = None
        # a quota-held bulk batch re-reads the gate at this time: nothing
        # else need wake the sealer while the tenant's bucket refills
        self._bulk_quota_recheck: float | None = None
        self._bulk_pending = self._bulk_inflight = 0  # leased slots; batches in flight
        self._bulk_sealed = self._bulk_images = 0
        self._bulk_gate_holds = self._bulk_starvation = self._bulk_quota_holds = 0
        # replica routing: engines without the API keep one stream
        self._route = getattr(engine, "supports_replica_routing", False)
        self._n_replicas = max(1, getattr(engine, "num_replicas", 1)) if self._route else 1
        self._rr = 0  # round-robin cursor over replicas
        # batches sealed, not yet fetched, per ((canvas bucket key, bulk), replica)
        self._inflight_by_key: dict[tuple, int] = {}
        self._inflight_total = self._inflight_peak = 0
        # depth is gated at the seal decision, so these never block a stop
        self._launch_q: queue.Queue = queue.Queue()
        self._done_q: queue.Queue = queue.Queue()
        self._running = False
        self._started = False
        self._sealer = threading.Thread(target=self._seal_loop, name="batch-sealer",
                                        daemon=True)
        # every replica may have a copy in flight and a fetch waiting at once
        threads = max(2, min(16, self._n_replicas))
        self._launchers = [threading.Thread(target=self._launch_loop, args=(i,),
                                            name=f"batch-launch-{i}", daemon=True)
                           for i in range(threads)]
        self._completions = [threading.Thread(target=self._fetch_loop,
                                              name=f"batch-complete-{i}", daemon=True)
                             for i in range(threads)]
        self._warm: list[Future] = [Future() for _ in self._launchers]
        self._warmup = False
        self.batches = self.images = 0
        self._sealed = self._discarded = 0
        self._holes = self._lease_timeouts = self._rejects = 0
        self._host_copies = 0
        self._deadline_sheds = self._deadline_seal_sheds = self._quota_sheds = 0
        # resolved rows: the drain rate and device time admission reads
        self.rolling = RollingStats()
        # the engine's reading of the device's gap before each fetched batch
        self._join_gaps = getattr(engine, "join_gaps", None)
        self._batch_seq = 0
        self._timeline: deque = deque(maxlen=512)
        # (canvas side, batch bucket) → [batches, real rows, bucket rows,
        # real pixels, pixels shipped]
        self._padding: dict[tuple[int, int], list] = {}

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

    def _admit_locked(self, t0: float, deadline: float | None, tenant: str | None,
                      bulk: bool = False) -> None:
        """Shed in the order backlog → quota → deadline, then block at the
        outstanding-slot cap. A bulk lease never sheds: it blocks at a
        staged batch per allowed in-flight batch plus one assembling."""
        if bulk:
            cap = self.bulk_max_batch * (self.bulk_inflight_cap + 1)
            while self._running and self._bulk_pending >= cap:
                self._cond.wait(timeout=0.25)
            if not self._running:
                raise ShuttingDown("server shutting down")
            return
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

    def _new_builder_locked(self, key, slab, bulk: bool = False) -> _Builder:
        cap = self.bulk_max_batch if bulk else self.max_batch
        delay = self.bulk_delay_s if bulk else self._update_delay()
        b = _Builder(key, slab, min(cap, slab.capacity), time.monotonic() + delay, bulk)
        self._open[(key, bulk)] = b
        return b

    def _add_lease_locked(self, b: _Builder, index: int, row: np.ndarray,
                          deadline: float | None, tenant: str | None, span) -> SlotLease:
        lease = SlotLease(self, b, index, row, deadline, tenant, span)
        b.leases.append(lease)
        b.n_pending += 1
        if b.bulk:
            self._bulk_pending += 1
            if b.tenant is None:
                b.tenant = tenant
        else:
            self._pending_slots += 1
        b.slab.add_lease()
        if len(b.leases) >= b.capacity:
            self._close_builder_locked(b)
        self._cond.notify_all()  # the sealer: a new deadline or a full builder
        return lease

    def lease(self, row_shape: tuple[int, ...], deadline: float | None = None,
              tenant: str | None = None, span=None, bulk: bool = False) -> SlotLease:
        """A slot for one classic-wire canvas of ``row_shape`` (the engine's
        ``canvas_shape(1, s)[1:]``) in the open builder of its canvas side.
        ``deadline`` (monotonic) and ``tenant`` go through admission; the
        time to a slot is ``span``'s ``lease_wait``. Raises
        :class:`BacklogFull`, :class:`~.overload.QuotaExceeded`,
        :class:`~.overload.DeadlineExceeded` or :class:`ShuttingDown`; blocks
        at the outstanding-slot cap. ``bulk`` stages into the bulk class:
        its own builders, its own blocking cap, no shedding; its ``tenant``
        is charged at the gate's dispatch."""
        key = tuple(int(d) for d in row_shape)
        t0 = time.monotonic()
        with profiler_range("lease_wait"), self._cond:
            self._admit_locked(t0, deadline, tenant, bulk)
            b = self._open.get((key, bulk))
            if b is None:
                # the canvas side: (s, s, 3) on rgb, (3s/2, s) on yuv420
                b = self._new_builder_locked(key, self.engine.acquire_staging(key[1]), bulk)
            i = len(b.leases)
            lease = self._add_lease_locked(b, i, b.slab.row(i), deadline, tenant, span)
        self._stamp_lease_wait(span, t0)
        return lease

    def lease_ragged(self, need_bytes: int, s: int, deadline: float | None = None,
                     tenant: str | None = None, span=None, bulk: bool = False) -> SlotLease:
        """``need_bytes`` (one image's h·w·3) of the open ragged arena of
        canvas side ``s``; an arena that cannot fit them seals, and a fresh
        one opens. Admission, ``span`` and ``bulk`` as :meth:`lease`."""
        key = ("ragged", int(s))
        if need_bytes > s * s * 3:
            raise ValueError(f"ragged lease of {need_bytes} B exceeds one {s}px canvas row")
        t0 = time.monotonic()
        with profiler_range("lease_wait"), self._cond:
            self._admit_locked(t0, deadline, tenant, bulk)
            b = self._open.get((key, bulk))
            if b is None:
                b = self._new_builder_locked(key, self.engine.acquire_ragged(s), bulk)
            got = b.slab.alloc(need_bytes)
            if got is None:  # as packed as it gets: seal, start the next arena
                self._close_builder_locked(b)
                b = self._new_builder_locked(key, self.engine.acquire_ragged(s), bulk)
                got = b.slab.alloc(need_bytes)
            lease = self._add_lease_locked(b, *got, deadline, tenant, span)
        self._stamp_lease_wait(span, t0)
        return lease

    def _stamp_lease_wait(self, span, t0: float) -> None:
        waited = time.monotonic() - t0
        if span is not None:
            span.add("lease_wait", waited)
        self.rolling.record_lease_wait(waited)

    def submit(self, canvas: np.ndarray, hw: tuple[int, int], deadline: float | None = None,
               tenant: str | None = None, bulk: bool = False) -> Future:
        """Queue one decoded wire canvas (one copy into its slot); the
        future resolves to its row. Admission sheds raise as from
        :meth:`lease`; ``bulk`` rides the bulk class (blocks, never sheds)."""
        try:
            lease = self.lease(canvas.shape, deadline, tenant, bulk=bulk)
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
            if self._open.get((b.key, b.bulk)) is b:
                del self._open[(b.key, b.bulk)]
            self._closing.append(b)
            if not b.n_pending:
                self._settled_locked(b, time.monotonic())

    @staticmethod
    def _settled_locked(b: _Builder, now: float) -> None:
        """``b`` has no lease decoding any more (or just closed without
        one): the first such moment at which it is closed or past its
        window is when it could seal, whatever the depth cap says."""
        b.settled_at = now
        if b.sealable_at is None and (not b.accepting or now >= b.deadline):
            b.sealable_at = now

    def _dec_pending_locked(self, b: _Builder, n: int = 1) -> None:
        if b.bulk:
            self._bulk_pending -= n
        else:
            self._pending_slots -= n

    def flush_bulk(self) -> None:
        """Seal every open bulk builder now: the job runner calls it once a
        chunk is staged, so the manifest's partial tail does not wait out
        the bulk window (a full chunk sealed at capacity already)."""
        with self._cond:
            for b in [b for b in self._open.values() if b.bulk]:
                self._close_builder_locked(b)
            self._cond.notify_all()

    def _commit(self, lease: SlotLease, hw, canvas) -> Future:
        b = lease.builder
        t0 = time.monotonic()
        # the slot is this lessee's alone until the state flips below
        try:
            with profiler_range("staging_write"):
                if canvas is not None:
                    if b.slab.is_ragged:
                        lease.row[:] = np.ascontiguousarray(canvas, dtype=np.uint8).reshape(-1)
                    else:
                        b.slab.canvases[lease.index] = canvas
                b.slab.write_hw(lease.index, hw)
        except BaseException:  # a canvas that does not fit its slot
            self._release_lease(lease)
            raise
        if lease.span is not None:
            lease.span.add("staging_write", time.monotonic() - t0)
        with self._cond:
            if lease.state == _PENDING:
                lease.state = _READY
                lease.hw = (int(hw[0]), int(hw[1]))
                lease.committed_at = time.monotonic()
                b.n_pending -= 1
                b.n_ready += 1
                if not b.n_pending:
                    self._settled_locked(b, lease.committed_at)
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
                if not b.n_pending:
                    self._settled_locked(b, time.monotonic())
            elif lease.state == _READY and not b.dispatched:
                b.n_ready -= 1  # a sibling upload failed: no device work for it
            else:
                return  # a hole already, or its batch left: the result is dropped
            lease.state = _HOLE
            self._dec_pending_locked(b)
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
                if not b.n_pending:
                    self._settled_locked(b, now)
                self._dec_pending_locked(b)
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
                self._dec_pending_locked(b)
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

    def _pick_replica_locked(self, mkey) -> int | None:
        """The replica of one sealed interactive batch of ``mkey`` (canvas
        bucket key, bulk flag): among the replicas with depth left for the
        bucket, the least loaded by the engine's in-flight count, the
        round-robin cursor's order breaking ties; None when every replica is
        at depth."""
        n = self._n_replicas
        cands = [r for r in range(n)
                 if self._inflight_by_key.get((mkey, r), 0) < self.pipeline_depth]
        if n == 1 or not cands:
            return cands[0] if cands else None
        loads = self.engine.replica_loads()
        start = self._rr
        return min(cands, key=lambda r: (loads[r], (r - start) % n))

    def _pick_bulk_replica_locked(self) -> int:
        """The replica of one bulk batch: the gate bounds bulk globally, so
        this only spreads it to the least loaded replica (its compute
        stream), the round-robin cursor breaking ties."""
        n = self._n_replicas
        if n == 1:
            return 0
        loads = self.engine.replica_loads()
        start = self._rr
        return min(range(n), key=lambda r: (loads[r], (r - start) % n))

    def _bulk_gate_open_locked(self, now: float, consume: bool = True,
                               tenant: str | None = None, rows: int = 0) -> bool:
        """May a sealed bulk batch take the device now? In this order: bulk's
        in-flight cap has room (else closed, no clock); the tenant's token
        bucket can pay for ``rows`` (``admission.peek``; else closed, no
        clock: quota is the tenant's own doing, so it never earns the
        valve, and it re-reads the gate every ``_QUOTA_RECHECK_S``, since on
        an idle server nothing else wakes the sealer while the bucket
        refills); no interactive batch is sealed and waiting or in flight on
        any replica (else closed, and the starvation clock runs: a batch
        gated for ``bulk_starvation_s`` goes through once and the clock
        re-arms). Every fetch notifies the condition, so a closed gate is
        re-read the moment interactive pressure drops. ``consume=False`` is
        the builder-close decision's peek: it does not spend the valve, so
        the dispatch decision of the same pass does."""
        if self._bulk_inflight >= self.bulk_inflight_cap:
            return False
        if self.admission is not None and not self.admission.peek(tenant, max(1, rows)):
            if consume:
                self._bulk_quota_holds += 1
            self._bulk_quota_recheck = now + _QUOTA_RECHECK_S
            return False
        self._bulk_quota_recheck = None
        if (any(not c.bulk for c in self._closing)
                or self._inflight_total - self._bulk_inflight > 0):
            if self._bulk_gated_since is None:
                self._bulk_gated_since = now
            elif now - self._bulk_gated_since >= self.bulk_starvation_s:
                if consume:
                    self._bulk_starvation += 1
                    self._bulk_gated_since = None  # one through; re-arm
                return True
            return False
        self._bulk_gated_since = None
        return True

    def _depth_free_locked(self, mkey) -> bool:
        return any(self._inflight_by_key.get((mkey, r), 0) < self.pipeline_depth
                   for r in range(self._n_replicas))

    def _pick_action_locked(self, now: float):
        """("dispatch" | "discard", builder) for one sealer wakeup, or None
        to wait. A dispatch has taken its pipeline-depth slot on the replica
        it was routed to."""
        draining = not self._running
        grace = min(self.lease_timeout_s, 2.0) if draining else self.lease_timeout_s
        for b in list(self._open.values()):
            self._expire_locked(b, now, grace)
            if b.sealable_at is None and not b.n_pending and now >= b.deadline:
                # settled before its window closed: sealable at the close
                b.sealable_at = max(b.deadline, b.settled_at or b.opened_at)
            # a past-deadline bulk builder closes against the gate's peek:
            # while interactive load holds the device it keeps growing
            if draining or len(b.leases) >= b.capacity or (
                    now >= b.deadline and not b.n_pending and (
                        self._bulk_gate_open_locked(now, consume=False, tenant=b.tenant,
                                                    rows=b.n_ready)
                        if b.bulk else self._depth_free_locked((b.key, False)))):
                self._close_builder_locked(b)
        for b in self._closing:
            self._expire_locked(b, now, grace)
        # interactive builders first: bulk never jumps a sealed interactive batch
        for b in sorted(self._closing, key=lambda x: x.bulk):
            if b.n_pending:
                continue  # a lessee is still decoding; bounded by expiry
            if not b.bulk:
                self._shed_dead_rows_locked(b, now)
            if b.n_ready == 0:
                self._closing.remove(b)
                b.dispatched = True
                if b.bulk and not any(c.bulk for c in self._closing):
                    # the last gated bulk batch turned into holes (a cancel):
                    # stop the clock, or a later job inherits an open valve
                    self._bulk_gated_since = None
                return "discard", b
            if b.bulk:
                if not draining and not self._bulk_gate_open_locked(
                        now, tenant=b.tenant, rows=b.n_ready):
                    self._bulk_gate_holds += 1
                    continue  # a fetch or the valve's deadline re-reads it
                replica = self._pick_bulk_replica_locked()
            else:
                replica = self._pick_replica_locked((b.key, False))
                if draining and replica is None:
                    # a drain goes on with every replica at depth: past the gate
                    replica = self._rr % self._n_replicas
            if replica is not None:
                self._closing.remove(b)
                b.dispatched = True
                b.replica = replica
                self._rr = (replica + 1) % self._n_replicas
                slot = ((b.key, b.bulk), replica)
                self._inflight_by_key[slot] = self._inflight_by_key.get(slot, 0) + 1
                self._inflight_total += 1
                self._inflight_peak = max(self._inflight_peak, self._inflight_total)
                if b.bulk:
                    self._bulk_inflight += 1
                    if self.admission is not None:
                        # the gate peeked; the dispatch pays for the rows
                        self.admission.charge(b.tenant, b.n_ready)
                return "dispatch", b
        return None

    def _next_wake_locked(self, now: float) -> float | None:
        wake = [b.deadline for b in self._open.values() if b.deadline > now]
        grace = self.lease_timeout_s if self._running else min(self.lease_timeout_s, 2.0)
        wake += [lease.leased_at + grace for b in (*self._open.values(), *self._closing)
                 for lease in b.leases if lease.state == _PENDING]
        # a gated bulk batch (or a past-deadline bulk builder, whose close
        # peeks the same gate) wakes at the valve's deadline even when no
        # fetch notifies first
        if self._bulk_gated_since is not None and (
                any(b.bulk for b in self._closing)
                or any(b.bulk and b.deadline <= now for b in self._open.values())):
            wake.append(self._bulk_gated_since + self.bulk_starvation_s)
        if self._bulk_quota_recheck is not None and (
                any(b.bulk for b in self._closing)
                or any(b.bulk and b.deadline <= now for b in self._open.values())):
            wake.append(self._bulk_quota_recheck)
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
        with profiler_range("seal"), self._cond:
            self._dec_pending_locked(b, len(ready))
            self._sealed += 1
            if b.bulk:
                self._bulk_sealed += 1
                self._bulk_images += len(ready)
            self._batch_seq += 1
            t_seal = time.monotonic()
            rec = {"seq": self._batch_seq, "key": b.key, "replica": b.replica, "bulk": b.bulk,
                   "rows": len(ready), "bucket": None, "t_open": b.opened_at,
                   "t_sealable": min(t_seal, b.sealable_at or t_seal), "t_seal": t_seal,
                   "t_launch": None, "t_launched": None, "t_done": None}
            self._timeline.append(rec)
            self._cond.notify_all()  # lease() waiters and the next seal decision
        self._launch_q.put((b, ready, rec))

    def _batch_done(self, mkey, replica: int = 0) -> None:
        """A batch left the pipeline (fetched or failed): free its depth slot
        on its replica and wake the sealer, which re-reads the bulk gate."""
        with self._cond:
            slot = (mkey, replica)
            n = self._inflight_by_key.get(slot, 0) - 1
            if n > 0:
                self._inflight_by_key[slot] = n
            else:
                self._inflight_by_key.pop(slot, None)
            self._inflight_total -= 1
            if mkey[1]:
                self._bulk_inflight -= 1
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
            with profiler_range("launch"):
                self._launch(*item)

    def _launch(self, b: _Builder, ready: list[SlotLease], rec: dict) -> None:
        """Ship one sealed builder (launch-pool thread): mark its holes, then
        the engine's dispatch (H2D, serve enqueue, async D2H)."""
        rec["t_launch"] = t0 = time.monotonic()
        spans = []
        for lease in ready:
            if lease.span is not None:
                # add_max: a request's images may ride concurrent batches
                lease.span.add_max("queue_wait", t0 - (lease.committed_at or t0))
                spans.append(lease.span)
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
            # a routed engine gets the sealer's replica
            kw = {"replica": b.replica} if self._route else {}
            if getattr(self.engine, "supports_span_tracing", False):
                # the engine stamps device_transfer and device_dispatch, and
                # splits the device's gap before the batch at its stamps
                handle = dispatch(b.slab, n, spans=spans,
                                  stamps=(rec["t_sealable"], rec["t_seal"]), **kw)
            else:
                handle = dispatch(b.slab, n, **kw)
                t_disp = time.monotonic()
                for span in spans:
                    span.add_max("device_dispatch", t_disp - t0)
        except Exception as e:  # the batch fails, its requests fail, the server lives
            log.exception("dispatch of a batch of %d failed", len(ready))
            self._fail(ready, e)
            rec["t_launched"] = rec["t_done"] = time.monotonic()
            self.engine.release_staging(b.slab)
            self._batch_done((b.key, b.bulk), b.replica)
            return
        rec["t_launched"] = time.monotonic()
        rec["bucket"] = bucket = self.engine.pick_batch_bucket(n)
        for span in spans:
            span.note("batch_bucket", bucket)
        self.rolling.record_batch(len(ready), bucket)
        self._record_padding(b.key, bucket, ready,
                             getattr(handle, "rows_dispatched", bucket))
        # a batch that ran eagerly pays one-time costs: keep its time out of
        # the device EMA that deadline admission reads
        rec["replay"] = getattr(handle, "replay", True)
        self._done_q.put((ready, handle, rec))

    def _record_padding(self, key, bucket: int, ready: list[SlotLease],
                        rows_shipped: int) -> None:
        """One dispatched batch into the padding counters of its (canvas,
        batch bucket): rows that carried requests against the bucket, and
        real image pixels against the pixels shipped (on the ragged wire the
        shipped arena prefix, ``rows_shipped`` canvases)."""
        s = canvas_side(key)
        px_real = sum(lease.hw[0] * lease.hw[1] for lease in ready if lease.hw)
        with self._cond:
            cell = self._padding.get((s, bucket))
            if cell is None:
                cell = self._padding[(s, bucket)] = [0, 0, 0, 0, 0]
            cell[0] += 1
            cell[1] += len(ready)
            cell[2] += bucket
            cell[3] += px_real
            cell[4] += rows_shipped * s * s

    def _fetch_loop(self) -> None:
        while True:
            item = self._done_q.get()
            if item is None:
                return
            ready, handle, rec = item
            if self.chaos is not None:
                # a straggling replica holds its batch's depth slot longer
                delay = self.chaos.fetch_delay(rec["replica"])
                if delay > 0:
                    time.sleep(delay)
            try:
                with profiler_range("fetch"):
                    outs = self.engine.fetch_outputs(handle)
            except Exception as e:
                log.exception("fetch of a batch of %d failed", len(ready))
                self._fail(ready, e)
                rec["t_done"] = time.monotonic()
                self._batch_done((rec["key"], rec["bulk"]), rec["replica"])
                continue
            rec["t_done"] = now = time.monotonic()
            t_launch = rec["t_launch"]
            device_s = now - t_launch if rec["replay"] else None
            for lease in ready:
                if lease.span is not None:
                    # before the future resolves: then the worker owns the span
                    lease.span.add_max("device_execute", now - rec["t_launched"])
                try:
                    # the row's arrays, whatever the task: (scores, indices)
                    # for classify, (boxes, scores, classes, num) for detect
                    lease.future.set_result(tuple(o[lease.index] for o in outs))
                except Exception:
                    pass  # cancelled by a caller that gave up
                self.rolling.record(latency_s=now - lease.leased_at,
                                    queue_s=t_launch - lease.leased_at, device_s=device_s,
                                    batch_size=len(ready))
            with self._cond:
                self.batches += 1
                self.images += len(ready)
            self._batch_done((rec["key"], rec["bulk"]), rec["replica"])
            if self._join_gaps is not None:
                # off the request path: the answers are out, the slot free
                try:
                    joined = self._join_gaps(handle)
                except Exception:  # a reading lost, never the thread
                    log.exception("reading the device's gap before a batch failed")
                else:
                    if joined is not None:
                        rec["device"] = joined

    def _fail(self, leases: list[SlotLease], e: Exception) -> None:
        now = time.monotonic()
        for lease in leases:
            try:
                lease.future.set_exception(e)
            except Exception:
                pass  # resolved or cancelled already
            self.rolling.record_error(latency_s=now - (lease.committed_at or lease.leased_at))

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
        ``t_open`` → ``t_sealable`` (could seal but for the depth cap) →
        ``t_seal`` (assembly) → ``t_launch`` → ``t_launched`` (H2D + serve
        enqueue) → ``t_done`` (outputs on the host); None for a stage not
        reached yet; the ``replica`` each went to; and, once fetched from
        the card, ``device``: its H2D and compute intervals and the gap
        before it on the same clock, split by cause (the engine's)."""
        with self._cond:
            return [dict(r) for r in self._timeline]

    def stats(self) -> dict:
        with self._cond:
            by_replica: dict[int, int] = {}
            for (_key, r), cnt in self._inflight_by_key.items():
                by_replica[r] = by_replica.get(r, 0) + cnt
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
                "replicas": self._n_replicas,
                # batches in flight per replica (all buckets); the engine's
                # staging_stats() has the device side
                "inflight_by_replica": {str(r): by_replica.get(r, 0)
                                        for r in range(self._n_replicas)}
                if self._n_replicas > 1 else {},
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
                "open_builders": len(self._open) + len(self._closing),
                # padding waste per (canvas, batch bucket): the batcher's
                # half of /stats → economics
                "padding": {
                    f"{s}x{bk}": {
                        "canvas": s,
                        "batch_bucket": bk,
                        "batches": c[0],
                        "rows_real": c[1],
                        "rows_dispatched": c[2],
                        "padded_rows_fraction": round(1.0 - c[1] / c[2], 4) if c[2] else 0.0,
                        "px_real": c[3],
                        "px_dispatched": c[4],
                        "padded_px_fraction": round(1.0 - c[3] / c[4], 4) if c[4] else 0.0,
                    }
                    for (s, bk), c in sorted(self._padding.items())
                },
                "rolling": self.rolling.snapshot(),
                # the bulk class, beside the interactive numbers it must not touch
                "bulk": {
                    "max_batch": self.bulk_max_batch,
                    "inflight_cap": self.bulk_inflight_cap,
                    "leased_slots": self._bulk_pending,
                    "inflight_batches": self._bulk_inflight,
                    "batches_sealed_total": self._bulk_sealed,
                    "images_sealed_total": self._bulk_images,
                    "gate_holds_total": self._bulk_gate_holds,
                    # admitted by the valve (interactive load never went idle)
                    "starvation_dispatches_total": self._bulk_starvation,
                    # held on the job tenant's token bucket (never the valve's)
                    "quota_holds_total": self._bulk_quota_holds,
                },
            }
