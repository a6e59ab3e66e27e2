"""Inference engine over a placement's devices (counterpart of the JAX
package's ``serving/engine.py``).

One batch is one uint8 wire buffer — each image's canvas bytes followed by
a 4-byte big-endian (h, w) trailer — in a pinned :class:`StagingSlab`,
copied to the device with one non-blocking transfer. On the device the
serve function runs preprocess (into the serving dtype) → forward →
softmax → top-k, and only k (score, index) pairs per image come back, in
one packed float32 array. A detector (``task="detect"``) runs the
reference's detect branch instead: box decode against the anchors,
sigmoid scores and static-shape multi-class NMS (``ops/detection.py``, the
NMS on the hand-written kernel ``csrc/nms_fixed.cu``), and each image's
row packs D boxes, D scores, D classes and the count. On the yuv420 wire
with the preprocess kernel, that stage is one launch: the kernel reads
each row's trailer itself and stores the serving dtype. Batches are padded to a batch bucket; padding
rows carry hw = 1×1 and are sliced off on the host.

On the ragged wire (rgb only) a batch is one pinned :class:`RaggedSlab`
instead: each image's tight rows back to back, then the int32 meta table,
shipped in one non-blocking copy; the device rebuilds the canvases
(``ops/image.py::unpack_ragged``, one kernel that reads the table on the
device) and the same serve path follows.

**Placement** (``serving/placement.py``, the reference's ``_Replica``).
The engine builds one :class:`_Replica` per device group of its
placement: ``shard`` (the default) is one replica over the whole mesh,
``replicas=N`` N replicas over disjoint groups. Each replica owns, per
device of its group, a copy of the weights, its executables, its static
inputs, its own memory and graph pools and, on CUDA, its own compute and
copy streams; it owns one enqueue lock, its economics cells, its busy
seconds and its in-flight counters. A batch goes to one replica (the
caller's ``replica=``, else :meth:`InferenceEngine.route_replica`); a
group of several devices splits the batch's rows evenly over them, as the
reference's ``P(('data', 'model'))`` does over a replica's submesh, and
gathers the k (score, index) pairs in row order. Batch buckets are
multiples of the group's size. The card has one device, so there a
placement is one replica of one device.

**Streams.** Each device of a replica enqueues its work on a compute
stream of its own, taken from a process-wide pool (:class:`_StreamPool`)
at build and given back at :meth:`InferenceEngine.close`, so two engines
(two models, or the old and new version during a hot swap) run their
device work side by side, and the CUDA events around a batch's replay
bracket that batch alone. A cuBLAS call captured into a graph keeps the
workspace of the (thread's handle, stream) it was captured on: each
graph is captured on the stream it replays on, so graphs that may replay
at once never share a workspace, graphs of one pool replay one at a time
on their replica's stream, and the pool's fixed set of streams bounds the
workspaces across hot swaps.

**Executables** (the counterpart of the reference's precompiled
executable per (canvas bucket, batch bucket)). Warmup captures the serve
function of every (wire kind, canvas side, rows per device) as one CUDA
graph (:class:`Executable`), largest first, into the device's graph
memory pool. Each canvas side has one static device input at the top
bucket's capacity (the packed wire, or the arena and the meta table), and
a smaller bucket's graph reads a prefix view of it. A batch then costs, on
the compute stream, a device-to-device copy of its freshly copied wire
into the static input, one graph replay (unpack or preprocess kernel →
forward → softmax → top-k) and the static output's copy back. A shape
warmup never captured runs the same function eagerly (the reference's lazy
jit; counted as ``eager_batches``). On the CPU the executables run the
same function on the static inputs without a capture. The kernels' build
cache (``serving/aotcache.py``, ``--aot-cache-dir``) is the counterpart of
the reference's AOT executable cache: a warm boot loads the kernel
libraries instead of running nvcc.
JPEGs are decoded by the native libjpeg decoder (``native/``), PIL takes
the rest.

Slabs are leased row by row (``serving/batcher.py``): the decoder writes
each upload straight into its slab, the image's one host copy. Dispatch
and fetch are separate calls, so several batches can be in flight: the
host→device copy goes on the replica's copy stream, and its compute
stream waits for that copy's event, so batch N+1's transfer overlaps batch
N's compute. A slab returns to its pool once its copy is enqueued (or it
is released undispatched) and its last lessee has resolved; it is handed
out again only after that copy's events. The pool keeps at most
``staging_slabs`` idle slabs per (kind, canvas side) and
``staging_pool_bytes`` over all of them, dropping the least recently used
shape's slabs first (the reference's budget).

The int8 tier keeps its kernels int8 on the device and dequantizes them
inside every forward, computing in bf16 (``ops/quant.py``); before it
serves, the golden parity gate holds it against the unfused float32 model
on the same parameters, and a failing gate raises.

**Models.** A zoo model (``source="native"``) is built from ``models/``
with its BN folded into the convs; a frozen graph (``source="pb"``, the
reference's presets and ``.pb`` paths) is parsed once at build and
converted (``graphdef/``) into the compute dtype, its const-only
subgraphs folded, and served through the same batcher, executables and
heads: a classifier's answer is the graph's own softmax output, a
detector's the outputs named ``raw_boxes``, ``raw_scores`` and
``anchors``. Depthwise fusion is for zoo models only.

**Device economics** (:meth:`InferenceEngine.econ_stats`, read by
``serving/costmodel.py``): per replica, batches, rows and device seconds
per (canvas, batch bucket), and ``busy_s`` over all. On the card a
batch's device seconds are the interval between two CUDA events on its
replica's compute stream around its graph replay (or eager serve
function), read after its fetch (the longest of its group's devices); the
reference counts the host's dispatch → fetch wall, which with several
batches in flight includes the wait behind the others. On the CPU they are
the serve call's host wall. Intervals of concurrent streams overlap, so
the device's idle share comes from the union of every engine's intervals
(:meth:`InferenceEngine.device_timeline` with a common base event).
Request spans passed to the dispatch get ``device_transfer`` (the H2D
enqueue), ``device_dispatch`` (the replay and the D2H enqueue) and the
``replica`` note.
"""

from __future__ import annotations

import contextlib
import copy
import gc
import logging
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from .. import native
from ..graphdef import load_pb
from ..models.adapter import converted_graph, native_converted
from ..ops import _build, launches, quant
from ..ops.detection import decode_boxes, multiclass_nms, nms_fixed
from ..ops.fused_dw import fused_dw
from ..ops.image import (
    check_ragged_rows,
    decode_image,
    fit_to_bucket,
    make_preprocess_fn,
    pad_to_canvas,
    rgb_to_yuv420_canvas,
    unpack_ragged,
)
from ..ops.preprocess_i420 import decode_trailer, preprocess_i420, preprocess_i420_wire
from ..parallel.mesh import build_mesh, mesh_for
from ..utils.config import ServerConfig
from . import aotcache
from .placement import parse_placement

log = logging.getLogger("tpu_serve_torch.engine")

_HOLE_TRAILER = (0, 1, 0, 1)  # hw = (1, 1): the resize reads one pixel
# one CUDA graph capture at a time in the process (torch's rule)
_CAPTURE_LOCK = threading.Lock()
# batches whose copy and compute events an engine keeps for device_timeline()
TIMELINE_N = 4096


def _cuda_index(device: torch.device) -> int:
    return torch.cuda.current_device() if device.index is None else device.index


class _StreamPool:
    """The process's CUDA streams for replicas, per device: a replica takes
    two distinct streams per device (compute and copy) at build and gives
    them back at close, and the next engine reuses them. cuBLAS keeps a
    workspace per (thread's handle, stream) for the life of the process,
    so a stream made per engine would leave one behind at every hot swap;
    with the pool their number is bounded by the most replicas alive at
    once. ``torch.cuda.Stream()`` hands out torch's own pooled streams
    round robin, so one it returns that the pool already knows is skipped:
    no two replicas ever share a stream."""

    def __init__(self):
        self._lock = threading.Lock()
        self._free: dict[int, list] = {}
        self._known: set[int] = set()

    def acquire(self, device: torch.device) -> torch.cuda.Stream:
        index = _cuda_index(device)
        with self._lock:
            free = self._free.setdefault(index, [])
            if free:
                return free.pop()
            for _ in range(128):
                stream = torch.cuda.Stream(index)
                if stream.cuda_stream not in self._known:
                    self._known.add(stream.cuda_stream)
                    return stream
        raise RuntimeError(f"no unused CUDA stream left on cuda:{index}")

    def release(self, stream: torch.cuda.Stream) -> None:
        with self._lock:
            self._free.setdefault(stream.device.index, []).append(stream)


_STREAMS = _StreamPool()


class _EnqueueGate:
    """Shared by every engine's device enqueue and fetch wait, exclusive for
    a profiler's start and stop (:func:`quiesced`). On the H100 with torch
    2.11, ``torch.profiler``'s stop (a device synchronize, then Kineto and
    CUPTI tearing down) hung the process while two launch threads were
    inside ``cudaGraphLaunch`` and ``cudaEventRecord`` on their own streams
    (PERF.md §6); with the gate no serving thread is in a CUDA call
    then. Writers go first, so a steady stream of batches cannot starve a
    profiler."""

    def __init__(self):
        self._cond = threading.Condition()
        self._shared = 0
        self._writer = False
        self._writers_waiting = 0

    @contextlib.contextmanager
    def shared(self):
        with self._cond:
            while self._writer or self._writers_waiting:
                self._cond.wait()
            self._shared += 1
        try:
            yield
        finally:
            with self._cond:
                self._shared -= 1
                if not self._shared:
                    self._cond.notify_all()

    @contextlib.contextmanager
    def exclusive(self):
        with self._cond:
            self._writers_waiting += 1
            while self._writer or self._shared:
                self._cond.wait()
            self._writers_waiting -= 1
            self._writer = True
        try:
            yield
        finally:
            with self._cond:
                self._writer = False
                self._cond.notify_all()


_GATE = _EnqueueGate()


def quiesced():
    """Hold every engine's device enqueue and fetch wait off for the block
    (the profiler route's start and stop)."""
    return _GATE.exclusive()


def _align16(x: int) -> int:
    return -(-x // 16) * 16


class _Leased:
    """The pool-return half of a slab's cycle, shared by both slabs. A slab
    is out of its pool from :meth:`arm` (acquire) until both (a) its batch's
    host→device copy is enqueued, or it was released undispatched
    (:meth:`finish`), and (b) every lessee has dropped its lease: a
    force-expired lessee may still be decoding into its row. ``copied``
    holds the copy's events (one per device of the replica that shipped
    it); the pool waits for them before the slab is reused."""

    def _init_lease(self) -> None:
        self._lease_lock = threading.Lock()
        self._leases = 0
        self._finished = True
        self._idle_cb = None
        self.copied: tuple[torch.cuda.Event, ...] = ()

    def arm(self, idle_cb) -> None:
        """Start one lease/dispatch cycle; ``idle_cb(slab)`` fires once."""
        with self._lease_lock:
            self._leases, self._finished, self._idle_cb = 0, False, idle_cb

    def add_lease(self) -> None:
        with self._lease_lock:
            self._leases += 1

    def drop_lease(self) -> None:
        self._maybe_idle(dec=True)

    def finish(self) -> None:
        """The slab's batch no longer needs its host bytes (its copy is
        enqueued and ``copied`` recorded), or it was never dispatched."""
        self._maybe_idle(done=True)

    def _maybe_idle(self, dec: bool = False, done: bool = False) -> None:
        cb = None
        with self._lease_lock:
            self._leases -= dec
            self._finished |= done
            if self._finished and self._leases <= 0 and self._idle_cb is not None:
                cb, self._idle_cb = self._idle_cb, None
        if cb is not None:  # outside the lock: the callback takes the pool's
            cb(self)


class StagingSlab(_Leased):
    """Pinned host wire buffer of one canvas side for the classic wire, at
    the top batch bucket's capacity (a batch's final size is unknown while
    its rows are leased): ``capacity`` rows of canvas bytes, each followed
    by its 4-byte big-endian (h, w) trailer. :meth:`row` is the view a
    decoder writes one image and its trailer into; a row never committed
    keeps the hole trailer (hw 1×1). Dispatch ships the prefix of the
    batch bucket that covers the real rows."""

    is_ragged = False

    def __init__(self, s: int, row_shape: tuple[int, ...], capacity: int, pinned: bool):
        self.s, self.capacity = s, capacity
        self.key = ("classic", s)
        self.nbytes = int(np.prod(row_shape, dtype=np.int64))
        self.buf = torch.zeros((capacity, self.nbytes + 4), dtype=torch.uint8,
                               pin_memory=pinned)
        self.host = self.buf.numpy()
        self.canvases = self.host[:, : self.nbytes].reshape(capacity, *row_shape)
        self.trailer = self.host[:, self.nbytes :]
        self.trailer[:] = _HOLE_TRAILER
        self.total_bytes = self.buf.nbytes
        self._init_lease()

    def arm(self, idle_cb) -> None:
        super().arm(idle_cb)
        self.trailer[:] = _HOLE_TRAILER  # last batch's trailers must not leak into holes

    def row(self, i: int) -> np.ndarray:
        """Slot ``i``'s flat pinned row: canvas bytes, then the trailer."""
        return self.host[i]

    def write_hw(self, i: int, hw: tuple[int, int]) -> None:
        self.trailer[i] = np.array(hw, ">u2").view(np.uint8)

    def hole(self, i: int) -> None:
        self.trailer[i] = _HOLE_TRAILER

    def write_rows(self, canvases: np.ndarray, hws: np.ndarray) -> None:
        """A stacked batch into the first rows."""
        n = canvases.shape[0]
        self.canvases[:n] = canvases
        self.trailer[:n] = np.asarray(hws).astype(">u2").view(np.uint8).reshape(n, 4)


class RaggedSlab(_Leased):
    """Pinned host arena of one canvas side for the ragged wire: a bump
    cursor over ``capacity`` canvases' worth of bytes, where each image
    takes exactly h·w·3 bytes at any byte offset, and an int32 meta table of
    ``(byte_offset, h, w, valid)`` per slot. A slot allocated but never
    committed (:meth:`write_hw`) stays a hole (``valid = 0``). :meth:`stage`
    places the meta table after the shipped prefix, so one copy carries
    both."""

    is_ragged = True

    def __init__(self, s: int, capacity: int, pinned: bool):
        self.s = s
        self.capacity = capacity
        self.key = ("ragged", s)
        self.row_bytes = s * s * 3
        # the arena, ≤ 15 bytes of alignment, the meta table at its largest
        self.buf = torch.zeros(capacity * self.row_bytes + 16 + 16 * capacity,
                               dtype=torch.uint8, pin_memory=pinned)
        self.host = self.buf.numpy()
        self.meta = np.zeros((capacity, 4), np.int32)
        self.used = self.slots = 0
        self.total_bytes = self.buf.nbytes
        self._init_lease()

    def arm(self, idle_cb) -> None:
        super().arm(idle_cb)
        self.reset()

    def reset(self) -> None:
        """Empty the arena; stale offsets must never alias a new batch's holes."""
        self.used = self.slots = 0
        self.meta[:] = 0

    def alloc(self, need: int) -> tuple[int, np.ndarray] | None:
        """Bump-allocate ``need`` bytes for one image: (slot, writable flat
        view), or None when the slots or the bytes are used up."""
        if self.slots >= self.capacity or self.used + need > self.capacity * self.row_bytes:
            return None
        i, off = self.slots, self.used
        self.slots, self.used = i + 1, off + need
        self.meta[i, 0] = off
        return i, self.host[off : off + need]

    def write_hw(self, i: int, hw: tuple[int, int]) -> None:
        """Commit slot ``i``: its decoded (h, w), and valid."""
        self.meta[i, 1:] = (hw[0], hw[1], 1)

    def hole(self, i: int) -> None:
        self.meta[i, 1:] = 0

    def truncate(self, n: int) -> None:
        """Drop the slots from ``n`` on (trailing holes) and their bytes."""
        if n < self.slots:
            self.slots, self.used = n, int(self.meta[n, 0])
            self.meta[n:] = 0

    def rows_shipped(self, bucket: int) -> int:
        """Canvas rows' worth of arena bytes one batch ships: the used bytes
        rounded up to q = max(1, bucket/8) rows (the reference's
        quantisation; at most 8 wire sizes per batch bucket)."""
        q = max(1, bucket // 8)
        rows = -(-self.used // self.row_bytes)
        return min(bucket, max(q, -(-rows // q) * q))

    def stage(self, bucket: int) -> tuple[int, int]:
        """Write the first ``bucket`` meta rows after the shipped prefix, at
        a 16-byte boundary; returns (bytes to ship, the meta's offset)."""
        meta_off = -(-self.rows_shipped(bucket) * self.row_bytes // 16) * 16
        nbytes = meta_off + 16 * bucket
        self.host[meta_off:nbytes] = self.meta[:bucket].view(np.uint8).reshape(-1)
        return nbytes, meta_off


@dataclass
class BatchHandle:
    out: torch.Tensor  # float32 [bucket, row width] on the host
    done: tuple  # CUDA: one event per device of the replica, after its D2H
    n: int
    # CUDA: per device of the replica, the timing events of the copy (copy
    # stream) and of the serve function (compute stream): H2D start, H2D
    # end, compute start, end
    events: tuple = ()
    # ran through its (canvas, batch) bucket's executable: on the card a
    # graph replay, not an eager run that pays one-time costs
    replay: bool = False
    # economics: (canvas side, batch bucket), rows the wire carried
    # (ragged: the shipped arena prefix in canvas rows), exact used rows
    # (ragged arena bytes / canvas bytes; n on the classic wire), and the
    # serve call's host seconds (the CPU's device time)
    cell: tuple[int, int] = (0, 0)
    rows_dispatched: int = 0
    rows_tight: float = 0.0
    host_compute_s: float = 0.0
    t_put: float = 0.0  # monotonic, the H2D enqueued
    replica: int = 0
    slab_bytes: int = 0  # the slab's bytes, in flight on its replica until the fetch


@dataclass
class Executable:
    """The serve function of one (wire kind, canvas side, rows per device)
    on one device's static input views (``fn``). On the card, ``graph`` is
    its CUDA graph and ``out`` the graph's static output; ``launches``
    holds the hand-written kernels' launches its capture recorded, which
    every replay adds to their counters. On the CPU there is no graph:
    calling it runs ``fn``."""

    key: tuple[str, int, int]
    fn: Callable[[], torch.Tensor]
    graph: torch.cuda.CUDAGraph | None = None
    out: torch.Tensor | None = None
    launches: dict = field(default_factory=dict)
    capture_s: float = 0.0

    def __call__(self) -> torch.Tensor:
        if self.graph is None:
            return self.fn()
        self.graph.replay()
        launches.add(self.launches)
        return self.out


class _Shard:
    """One device of a replica's group: its copy of the weights, its static
    inputs and executables, its own memory pool (the weights and static
    inputs, freed at close whatever engines came after) and graph pool
    and, on CUDA, its compute and copy streams from the process's pool."""

    def __init__(self, device: torch.device):
        self.device = device
        cuda = device.type == "cuda"
        self.model = None
        # (kind, canvas side, rows) → Executable, filled once by warmup
        # (under the engine's warmup lock), read lock-free after
        self.exes: dict[tuple[str, int, int], Executable] = {}
        self.static: dict[tuple[str, int], torch.Tensor] = {}  # (kind, side) → input
        self.mem_pool = torch.cuda.MemPool() if cuda else None
        self.graph_pool = torch.cuda.graph_pool_handle() if cuda else None
        self.compute = _STREAMS.acquire(device) if cuda else None
        self.copy = _STREAMS.acquire(device) if cuda else None

    def own_pool(self):
        """Routes this thread's device allocations to the shard's own pool
        (nothing on the CPU)."""
        if self.mem_pool is None:
            return contextlib.nullcontext()
        return torch.cuda.use_mem_pool(self.mem_pool, _cuda_index(self.device))

    def release_streams(self) -> None:
        for stream in (self.compute, self.copy):
            if stream is not None:
                _STREAMS.release(stream)
        self.compute = self.copy = None


class _Replica:
    """One independent dispatch stream of an engine's placement: a device
    group with a :class:`_Shard` per device, one enqueue lock (its launch
    threads share its streams, static inputs and graph pools), and its own
    in-flight, busy and economics accounting (under the engine's lock)."""

    def __init__(self, index: int, devices: tuple[torch.device, ...]):
        self.index = index
        self.devices = devices
        self.shards = [_Shard(d) for d in devices]
        self.lock = threading.Lock()
        self.dispatches_total = 0
        self.dispatches_inflight = 0
        self.slab_bytes_inflight = 0
        # summed device seconds of its fetched batches (an interval sum)
        self.busy_s = 0.0
        # (canvas side, batch bucket) → [batches, rows, rows dispatched,
        # device s, tight rows]
        self.econ: dict[tuple[int, int], list] = {}


class InferenceEngine:
    """Serves batches of decoded images over a placement's replicas.

    ``mesh`` (a tuple of devices, ``parallel/mesh.py``) is where the
    engine may place the model; without one, ``device`` names it (one
    device; ``"cuda"`` or None: every visible CUDA device). The model
    config's ``placement`` splits the mesh into replicas; a spec the mesh
    cannot honor raises ValueError before any weight is built.

    A float32 or int8 engine turns TF32 off in cuDNN and cuBLAS at build
    (float32 means float32; for int8, the parity gate's reference). Those
    flags are process-wide: they hold for every model in the process."""

    # Gate tolerances per serving dtype, the reference's _PARITY_TOL:
    # ``prob`` bounds the max probability delta and is the top-k agreement
    # margin; ``topk`` is the least agreeing fraction. A detector is gated
    # on its sigmoid scores (``score``) and raw box codes (``box``), L∞.
    PARITY_TOL = {
        "int8": {"prob": 0.15, "topk": 0.90, "score": 0.06, "box": 0.25},
        "bfloat16": {"prob": 0.08, "topk": 0.90, "score": 0.05, "box": 0.15},
    }
    # the batcher passes request spans to the dispatch calls
    supports_span_tracing = True
    # dispatch calls take replica=, and the engine has num_replicas,
    # replica_loads and route_replica: the batcher routes across replicas
    supports_replica_routing = True

    def __init__(self, cfg: ServerConfig, device: str | torch.device | None = None,
                 seed: int = 0, params_flat: dict[str, np.ndarray] | None = None, mesh=None):
        self.cfg = cfg
        self.model_cfg = cfg.model
        self.mesh = build_mesh(mesh) if mesh is not None else mesh_for(device)
        self.placement = parse_placement(self.model_cfg.placement, self.mesh)
        self.num_replicas = self.placement.replicas
        # rows split evenly over a replica's group: buckets are multiples of it
        self.batch_multiple = len(self.placement.meshes[0])
        self.device = self.mesh[0]
        # the reference's gating: tight packing exists for the rgb wire only
        self.ragged = cfg.ragged and cfg.wire_format == "rgb"
        if cfg.ragged and not self.ragged:
            log.warning("ragged packing requires wire_format='rgb' (got %r); serving the "
                        "classic host-padded wire", cfg.wire_format)
        self.quantized = self.model_cfg.dtype == "int8"
        self.task = self.model_cfg.task
        self.source = self.model_cfg.source
        if self.model_cfg.fused_dw == "on" and self.source != "native":
            log.warning("fused_dw='on' ignored for source='pb' (%s): fusion rebuilds the zoo "
                        "module, which a frozen graph does not have", self.model_cfg.name)
        if self.model_cfg.dtype in ("float32", "int8"):
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        # int8 computes in bf16
        self.dtype = torch.float32 if self.model_cfg.dtype == "float32" else torch.bfloat16
        self.fused_dw = self.model_cfg.fuse_depthwise
        # yuv420 + kernel: the kernel takes the wire buffer itself
        # (preprocess_packed); the other paths decode the trailers first
        self._wire_kernel = cfg.wire_format == "yuv420" and cfg.resize == "kernel"
        self._pinned = self.device.type == "cuda"
        # Warmup's first phase, the one-time costs, runs here: the int8
        # parity gate below already launches the kernels. The kernel
        # libraries this engine's path runs are built or loaded through the
        # build cache, and the native decoder is built (a build fault raises
        # here, not per request).
        self.aot_cache = aotcache.AotCache.from_config(cfg)
        self.kernels = [name for name, used in (("unpack_ragged", self.ragged),
                                                ("preprocess_i420", self._wire_kernel),
                                                ("fused_dw", self.fused_dw),
                                                ("nms_fixed", self.task == "detect")) if used]
        t0 = time.perf_counter()
        if self._pinned:
            for name in self.kernels:
                _build.load(name, self.aot_cache)
        self.decoder = native.status()
        self.warmup_s = {"one_time": time.perf_counter() - t0, "executables": None,
                         "execution": []}
        self._seed, self._params_flat = seed, params_flat
        # Guards the staging pool, the counters and the replicas'
        # accounting only; never a wait on an event.
        self._lock = threading.Lock()
        self._replicas: list[_Replica] = []
        self._device_events: deque = deque(maxlen=TIMELINE_N)
        # (kind, canvas side) → idle slabs: at most staging_slabs each and
        # staging_pool_bytes over all, the least recently used shape's
        # dropped first; pinned memory is scarce (one rgb slab at a 2048
        # canvas and batch 32 is 403 MB), so slabs are allocated at first use
        self._pool: dict[tuple[str, int], list] = {}
        self._pool_nbytes = 0
        self._last_use: dict[tuple[str, int], float] = {}
        self._staging_cap = max(2, cfg.staging_slabs)
        self._staging_budget = int(cfg.staging_pool_bytes)
        self.slabs_allocated = 0
        self._rr = 0  # round-robin cursor of route_replica
        self.batches = 0
        self.images = 0
        self.h2d_bytes = 0
        self.decodes = {"native": 0, "pil": 0}
        self._warmup_lock = threading.Lock()
        self._warmed = False
        self.replays = 0
        self.eager_batches = 0
        self.pool_bytes = 0
        self.parity: dict | None = None
        # seconds to parse the frozen graph and to convert it (None: a zoo model)
        self.load_s: dict[str, float | None] = {"parse": None, "convert": None}
        self._graph = None
        try:
            self._replicas = [_Replica(i, m) for i, m in enumerate(self.placement.meshes)]
            if self.source == "pb":
                t0 = time.perf_counter()
                self._graph = load_pb(self.model_cfg.pb_path)
                self.load_s["parse"] = time.perf_counter() - t0
            self._place_weights()
            if self.source == "pb":
                log.info("loaded %s (pb): %d nodes, %d per call, %d folded, outputs=%s "
                         "(parse %.3fs, convert %.3fs)", self.model_cfg.pb_path,
                         len(self._graph.nodes), len(self.model.graph.call_nodes),
                         len(self.model.graph.folded_nodes), self.model.output_names,
                         self.load_s["parse"], self.load_s["convert"])
            self._size_outputs()
            if self.quantized:
                self.parity = self.parity_check()
                if not self.parity["pass"]:
                    raise RuntimeError(
                        f"numerical-parity gate failed for {self.model_cfg.name} "
                        f"dtype={self.model_cfg.dtype}: {self.parity}")
        except BaseException:
            self.close()  # the streams go back to the pool
            raise
        h, w = self.model_cfg.input_size
        self._preprocess = None if self._wire_kernel else make_preprocess_fn(
            h, w, self.model_cfg.preprocess, wire=cfg.wire_format, resize=cfg.resize,
            out_dtype=self.dtype,
        )
        self.batch_buckets = self._default_batch_buckets(cfg.max_batch, self.batch_multiple)
        self.max_batch = self.batch_buckets[-1]

    def _shards(self) -> list[_Shard]:
        return [sh for rep in self._replicas for sh in rep.shards]

    @property
    def model(self):
        """Replica 0's model on its first device (None once closed)."""
        return self._replicas[0].shards[0].model if self._replicas else None

    def _place_weights(self) -> None:
        """One model built on the host, a real copy of it per device of
        every replica, each in its device's own memory pool."""
        t0 = time.perf_counter()
        base = self._build_model(self.fused_dw, self.quantized, self.dtype)
        if self.source == "pb":
            self.load_s["convert"] = time.perf_counter() - t0
        # a converted graph is built in the compute dtype (its float64
        # constants stay float64, as in the reference)
        dtype = None if self.source == "pb" else self.dtype
        shards = self._shards()
        for i, sh in enumerate(shards):
            m = base if i == len(shards) - 1 else copy.deepcopy(base)
            with sh.own_pool():
                sh.model = m.to(device=sh.device, dtype=dtype,
                                memory_format=torch.channels_last)
            if sh.compute is not None:  # the weights, made on this thread's stream, first
                sh.compute.wait_stream(torch.cuda.current_stream(sh.device))

    def _build_model(self, fused_dw: bool, int8: bool, dtype: torch.dtype = torch.float32):
        """The model on the CPU: a zoo model in float32 (the caller casts),
        a frozen graph converted in ``dtype``."""
        if self.source == "pb":
            return converted_graph(self.model_cfg, self._graph, dtype=dtype, int8=int8)
        return native_converted(
            self.model_cfg.name,
            num_classes=self.model_cfg.zoo_classes,
            width=self.model_cfg.zoo_width,
            seed=self._seed,
            params_flat=self._params_flat,
            fused_dw=fused_dw,
            int8=int8,
            # the serving preprocess resizes to input_size, so the
            # detector's anchor grid is derived from the same value
            input_size=self.model_cfg.input_size[0],
        )

    def _size_outputs(self) -> None:
        """The task's class count, top-k and packed row width. Classify: k
        scores then k class indices. Detect: the reference's static NMS
        sizes (100 candidates a class, 100 detections, clamped to what the
        anchors and classes supply), a row of D boxes (4 each), D scores,
        D classes and the count. A converted graph's class and anchor
        counts are its outputs' shapes (one forward at build)."""
        if self.source == "pb":
            h, w = self.model_cfg.input_size
            x = torch.zeros((1, h, w, 3), dtype=self.dtype, device=self.device)
            with torch.inference_mode():
                out = self.model(x)
            if self.task == "detect":
                num_classes, anchors = out[1].shape[-1] - 1, out[2].shape[0]
            else:
                num_classes = out.shape[-1]
        elif self.task == "detect":
            num_classes = self.model.backbone.num_classes
            anchors = self.model.anchors.shape[0]
        else:
            num_classes = self.model.backbone.logits.out_features
        self.num_classes = num_classes
        if self.task == "detect":
            self.topk = self.model_cfg.topk
            k = min(100, anchors)
            self.max_detections = min(100, self.num_classes * k)
            self.row_width = 6 * self.max_detections + 1
        else:
            self.topk = min(self.model_cfg.topk, self.num_classes)
            self.row_width = 2 * self.topk

    def parity_check(self, batch: int = 4, seed: int = 0) -> dict:
        """Golden numerical-parity gate: this engine's model, as it serves
        (int8 dequantized on the fly, fused depthwise, compute dtype),
        against the unfused float32 model on the same parameters, on a
        seeded probe batch of NHWC images in [-1, 1]. Classify gates
        margin-aware top-k agreement and the max probability delta; detect
        gates the L∞ deltas of the sigmoid scores and of the raw box codes.
        Runs at build for int8; callable on any engine."""
        tol = self.PARITY_TOL.get(self.model_cfg.dtype, self.PARITY_TOL["bfloat16"])
        h, w = self.model_cfg.input_size
        x = np.random.RandomState(seed).uniform(-1.0, 1.0, (batch, h, w, 3)).astype(np.float32)
        x = torch.from_numpy(x).to(self.device)
        ref = self._build_model(fused_dw=False, int8=False).to(
            self.device, memory_format=torch.channels_last)
        with torch.inference_mode():
            got = self.model(x.to(self.dtype))
            want = ref(x)
        if self.task == "detect":
            (gb, gs, _), (wb, ws, _) = ([o.float().cpu().numpy() for o in outs]
                                        for outs in (got, want))
            sig = lambda v: 1.0 / (1.0 + np.exp(-v))  # noqa: E731
            score_d = float(np.max(np.abs(sig(gs) - sig(ws))))
            box_d = float(np.max(np.abs(gb - wb)))
            return {
                "dtype": self.model_cfg.dtype, "fused_dw": self.fused_dw, "task": self.task,
                "probe_batch": batch, "max_score_delta": score_d, "max_box_delta": box_d,
                "tol_score": tol["score"], "tol_box": tol["box"],
                "pass": score_d <= tol["score"] and box_d <= tol["box"],
            }
        got, want = got.float().cpu().numpy(), want.cpu().numpy()
        k = self.topk
        prob_d = float(np.max(np.abs(got - want)))
        agree = quant.topk_agreement(want, got, k, tol["prob"])
        return {
            "dtype": self.model_cfg.dtype, "fused_dw": self.fused_dw, "task": self.task,
            "probe_batch": batch, "max_prob_delta": prob_d, "topk_agreement": agree, "topk": k,
            "tol_prob": tol["prob"], "tol_topk": tol["topk"],
            "pass": prob_d <= tol["prob"] and agree >= tol["topk"],
        }

    # ---------------------------------------------------------------- shapes

    @staticmethod
    def _default_batch_buckets(max_batch: int, multiple: int = 1) -> tuple[int, ...]:
        """``multiple``, doubled while below ``max_batch`` rounded up to a
        multiple, then that top: every bucket splits evenly over a replica's
        devices (the reference's ladder)."""
        m = max(1, multiple)
        top = max(m, -(-max_batch // m) * m)
        buckets, b = [], m
        while b < top:
            buckets.append(b)
            b *= 2
        buckets.append(top)
        return tuple(buckets)

    def pick_batch_bucket(self, n: int) -> int:
        for b in self.batch_buckets:
            if n <= b:
                return b
        return self.batch_buckets[-1]

    def canvas_shape(self, batch: int, s: int) -> tuple[int, ...]:
        """Host-staged canvas batch shape for one (batch, canvas bucket)."""
        if self.cfg.wire_format == "yuv420":
            return (batch, s * 3 // 2, s)
        return (batch, s, s, 3)

    def packed_shape(self, batch: int, s: int) -> tuple[int, int]:
        """Wire shape of one packed batch: canvas bytes + the 4-byte
        big-endian (h, w) trailer per image."""
        shape = self.canvas_shape(batch, s)
        return (batch, int(np.prod(shape[1:], dtype=np.int64)) + 4)

    # ----------------------------------------------------------------- serve

    def preprocess_packed(self, buf: torch.Tensor) -> torch.Tensor:
        """Preprocess stage of one batch: packed uint8 [B, bytes + 4] →
        [B, out_h, out_w, 3] in the serving dtype. On the yuv420 wire with
        the kernel, one launch that reads the trailers itself."""
        nbytes = buf.shape[1] - 4
        if self.cfg.wire_format == "yuv420":
            s = int(round((nbytes * 2 / 3) ** 0.5))
            if self._wire_kernel:
                h, w = self.model_cfg.input_size
                return preprocess_i420_wire(buf, s, h, w, self.model_cfg.preprocess, self.dtype)
            canvases = buf[:, :nbytes].unflatten(1, (s * 3 // 2, s))
        else:
            s = int(round((nbytes / 3) ** 0.5))
            canvases = buf[:, :nbytes].unflatten(1, (s, s, 3))
        return self._preprocess(canvases, decode_trailer(buf))

    def _head(self, model, x: torch.Tensor) -> torch.Tensor:
        """The forward and the task's postprocess: [B, out_h, out_w, 3] →
        float32 [B, row width]. Classify: softmax → top-k, k scores then k
        class indices per image. Detect: the reference's branch — raw
        outputs to float32, boxes decoded against the anchors, sigmoid
        scores without the background class, static-shape NMS; D boxes,
        D scores, D classes and the count per image (class ids and counts
        are exact in float32). Nothing here reads the device on the host,
        so a CUDA graph captures it."""
        if self.task == "detect":
            raw_boxes, raw_scores, anchors = model(x)
            boxes = decode_boxes(raw_boxes.float(), anchors.float())
            scores = torch.sigmoid(raw_scores.float())[..., 1:]
            b, s, c, n = multiclass_nms(boxes, scores, max_detections=self.max_detections)
            return torch.cat([b.flatten(1), s, c.float(), n.float()[:, None]], dim=1)
        # softmax runs in the serving dtype; top-k reads it in float32
        probs = model(x).float()
        scores, idx = torch.topk(probs, self.topk, dim=-1)
        return torch.cat([scores, idx.float()], dim=1)

    def _serve_packed(self, model, buf: torch.Tensor) -> torch.Tensor:
        """Device side of one batch: packed uint8 [B, bytes + 4] → float32
        [B, row width]."""
        return self._head(model, self.preprocess_packed(buf))

    def _serve_ragged(self, model, arena: torch.Tensor, meta: torch.Tensor,
                      s: int) -> torch.Tensor:
        """Device side of one ragged batch: the arena and the int32 [rows,
        4] meta table → unpack → preprocess → :meth:`_head`."""
        canvases, hws = unpack_ragged(arena, meta, s)
        return self._head(model, self._preprocess(canvases, hws))

    # ----------------------------------------------------------- executables

    def _static_input(self, sh: _Shard, kind: str, s: int) -> torch.Tensor:
        """A device's static input of one canvas side, at the top bucket's
        rows per device: packed wire rows (hole trailers until written), or
        the whole batch's arena (16-byte aligned; a device's rows point
        into all of it) followed by the meta table."""
        key = (kind, s)
        if key not in sh.static:
            rows = self.max_batch // self.batch_multiple
            with sh.own_pool():
                if kind == "ragged":
                    buf = torch.zeros(_align16(self.max_batch * s * s * 3) + 16 * rows,
                                      dtype=torch.uint8, device=sh.device)
                else:
                    buf = torch.zeros(self.packed_shape(rows, s), dtype=torch.uint8,
                                      device=sh.device)
                    buf[:, -4:] = torch.tensor(_HOLE_TRAILER, dtype=torch.uint8,
                                               device=sh.device)
            sh.static[key] = buf
        return sh.static[key]

    def _ragged_views(self, sh: _Shard, s: int) -> tuple[torch.Tensor, torch.Tensor]:
        """The ragged static input's arena and meta table [rows, 4]."""
        buf = self._static_input(sh, "ragged", s)
        arena = _align16(self.max_batch * s * s * 3)
        return buf[:arena], buf[arena:].view(torch.int32).view(-1, 4)

    def _static_fn(self, sh: _Shard, kind: str, s: int, p: int) -> Callable[[], torch.Tensor]:
        """The serve function of ``p`` rows on one device over prefix views
        of its side's static input."""
        if kind == "ragged":
            arena, meta = self._ragged_views(sh, s)
            return lambda: self._serve_ragged(sh.model, arena, meta[:p], s)
        rows = self._static_input(sh, kind, s)[:p]
        return lambda: self._serve_packed(sh.model, rows)

    def _stage_static(self, sh: _Shard, key: tuple[str, int, int], dev: torch.Tensor,
                      meta_off: int | None, lo: int = 0) -> None:
        """Copy one device's freshly copied wire into its static input, on
        the current (compute) stream: the wire rows, or the shipped arena
        prefix and meta rows ``lo`` … ``lo + p`` of the batch. Bytes past
        the prefix keep an earlier batch's values; the unpack reads only
        the spans the meta table names."""
        kind, s, p = key
        if kind == "ragged":
            arena, meta = self._ragged_views(sh, s)
            arena[:meta_off].copy_(dev[:meta_off])
            meta[:p].view(torch.uint8).view(-1).copy_(
                dev[meta_off + 16 * lo:meta_off + 16 * (lo + p)])
        else:
            self._static_input(sh, kind, s)[:p].copy_(dev)

    def _capture(self, kind: str, s: int, p: int, sh: _Shard) -> Executable:
        """The executable of one (kind, side, rows) on one device. On the
        card, under ``_CAPTURE_LOCK`` and on the device's compute stream,
        where the graph will replay: one eager run (cuDNN/cuBLAS plans,
        this thread's cuBLAS workspace for that stream, made outside any
        graph pool; the kernels' one-time attributes), then the capture
        into the device's graph pool. A capture that fails raises."""
        key = (kind, s, p)
        fn = self._static_fn(sh, kind, s, p)
        if sh.device.type != "cuda":
            return Executable(key, fn)
        t0 = time.perf_counter()
        stream = sh.compute
        # thread_local: during a hot swap this capture runs while the old
        # version's launch and completion threads replay graphs, sync events
        # and allocate (a batch of a shape never captured runs eagerly);
        # their CUDA calls must not fail the capture, nor the capture theirs.
        # close() returns freed segments only under _CAPTURE_LOCK, never
        # during a capture.
        with torch.inference_mode(), _CAPTURE_LOCK:
            stream.wait_stream(torch.cuda.current_stream(sh.device))  # the static inputs
            with torch.cuda.stream(stream):
                fn()
            graph = torch.cuda.CUDAGraph()
            with launches.recording() as record, torch.cuda.graph(
                    graph, pool=sh.graph_pool, stream=stream,
                    capture_error_mode="thread_local"):
                out = fn()
        return Executable(key, fn, graph, out, record, time.perf_counter() - t0)

    @staticmethod
    def _graph_pool_bytes(sh: _Shard) -> int:
        """Device bytes a device's graph memory pool holds."""
        pool = tuple(sh.graph_pool)
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == pool)

    # -------------------------------------------------------------- staging

    def _acquire(self, key: tuple[str, int], make):
        with self._lock:
            self._last_use[key] = time.monotonic()
            free = self._pool.get(key)
            slab = free.pop() if free else None
            if slab is not None:
                self._pool_nbytes -= slab.total_bytes
            else:
                self.slabs_allocated += 1
        if slab is None:
            slab = make()
        for ev in slab.copied:  # its last copies to the device
            ev.synchronize()
        slab.arm(self._return)
        return slab

    def _return(self, slab) -> None:
        """Pool an idle slab: at most ``staging_slabs`` per shape, then the
        byte budget, dropping the least recently used shapes' slabs first
        (slabs no shape in traffic uses give their memory back)."""
        with self._lock:
            self._last_use[slab.key] = time.monotonic()
            free = self._pool.setdefault(slab.key, [])
            if len(free) >= self._staging_cap:
                return  # dropped: bounded pinned memory under bursts
            free.append(slab)
            self._pool_nbytes += slab.total_bytes
            while self._pool_nbytes > self._staging_budget:
                victim = min((k for k, v in self._pool.items() if v),
                             key=lambda k: self._last_use.get(k, 0.0), default=None)
                if victim is None:
                    break
                self._pool_nbytes -= self._pool[victim].pop().total_bytes

    def acquire_staging(self, s: int) -> StagingSlab:
        """An empty classic-wire slab of canvas side ``s`` at the top batch
        bucket's capacity, out of the pool (allocated when none is free);
        it goes back through :meth:`dispatch_staged` or
        :meth:`release_staging`."""
        return self._acquire(("classic", s), lambda: StagingSlab(
            s, self.canvas_shape(1, s)[1:], self.max_batch, self._pinned))

    def acquire_ragged(self, s: int) -> RaggedSlab:
        """An empty ragged slab of canvas side ``s``, as :meth:`acquire_staging`."""
        return self._acquire(("ragged", s),
                             lambda: RaggedSlab(s, self.max_batch, self._pinned))

    def release_staging(self, slab: StagingSlab | RaggedSlab) -> None:
        """Give back a slab that was not dispatched (or whose dispatch
        failed); it reaches the pool once its last lessee resolves."""
        slab.finish()

    def staging_stats(self) -> dict:
        """The reference's staging block: the slab pool, and per replica its
        dispatches (total and in flight), slab bytes in flight and busy
        seconds, with the placement."""
        with self._lock:
            out = {"slab_allocs_total": self.slabs_allocated,
                   "slabs_pooled": sum(len(v) for v in self._pool.values()),
                   "slabs_pooled_bytes": self._pool_nbytes}
            reps = [{"replica": rep.index, "devices": len(rep.devices),
                     "dispatches_total": rep.dispatches_total,
                     "dispatches_inflight": rep.dispatches_inflight,
                     "slab_bytes_inflight": rep.slab_bytes_inflight,
                     "busy_s": round(rep.busy_s, 3)}
                    for rep in self._replicas]
        out["dispatches_total"] = sum(r["dispatches_total"] for r in reps)
        out["dispatches_inflight"] = sum(r["dispatches_inflight"] for r in reps)
        out["placement"] = self.placement.summary()
        out["replicas"] = reps
        return out

    # -------------------------------------------------------------- routing

    def route_replica(self) -> int:
        """The replica of one batch: the least in flight, round-robin order
        breaking ties, so equal load walks the replicas in turn and a slow
        one sheds work to the others."""
        if self.num_replicas == 1:
            return 0
        with self._lock:
            loads = [rep.dispatches_inflight for rep in self._replicas]
            n, start = self.num_replicas, self._rr
            best = min(range(n), key=lambda i: (loads[i], (i - start) % n))
            self._rr = (best + 1) % n
            return best

    def replica_loads(self) -> list[int]:
        """Batches in flight per replica: the batcher's routing input."""
        with self._lock:
            return [rep.dispatches_inflight for rep in self._replicas]

    def placement_summary(self) -> dict:
        """JSON-ready placement for /models and /stats."""
        return self.placement.summary()

    def _take_replica(self, replica: int | None, slab) -> _Replica:
        """The dispatch's replica, counted in flight before any device work
        so that concurrent routers see its load."""
        r = self.route_replica() if replica is None else int(replica)
        if not 0 <= r < self.num_replicas:
            raise ValueError(f"replica {r} out of range ({self.num_replicas} replicas)")
        rep = self._replicas[r]
        with self._lock:
            rep.dispatches_total += 1
            rep.dispatches_inflight += 1
            rep.slab_bytes_inflight += slab.total_bytes
        return rep

    def _drop_inflight(self, rep: _Replica, nbytes: int) -> None:
        """A dispatch left its replica (fetched, or failed before it went);
        ``dispatches_total`` stays: it is exported as a counter."""
        with self._lock:
            rep.dispatches_inflight -= 1
            rep.slab_bytes_inflight -= nbytes

    # ------------------------------------------------------------- dispatch

    def _ship(self, rep: _Replica, buf: torch.Tensor, slab, n: int, bucket: int,
              rows_dispatched: int, rows_tight: float,
              meta_off: int | None = None) -> BatchHandle:
        """One batch on one replica: per device of its group, its rows of
        ``buf`` (a prefix of the slab's pinned buffer; on the ragged wire
        all of it, since each device's meta rows point into the whole arena)
        in one non-blocking copy into a fresh buffer on the device's copy
        stream; on its compute stream, waiting for that copy, its executable
        (a copy into the static input, one graph replay) or, for a shape
        warmup never captured, the same serve function run eagerly on the
        fresh buffer; then its output rows' copy back. ``meta_off``: where a
        ragged wire's meta table starts; ``rows_dispatched`` and
        ``rows_tight`` go to the batch's economics cell. Returns without
        waiting for the device."""
        d = len(rep.shards)
        per = bucket // d
        key = (slab.key[0], slab.s, per)
        replay = all(key in sh.exes for sh in rep.shards)
        cuda = self._pinned
        with torch.inference_mode(), _GATE.shared():
            parts = [buf if meta_off is not None else buf[j * per:(j + 1) * per]
                     for j in range(d)]
            devs, events = [], []
            for sh, part in zip(rep.shards, parts):
                if not cuda:
                    devs.append(part.to(sh.device))
                    continue
                ev = tuple(torch.cuda.Event(enable_timing=True) for _ in range(4))
                with torch.cuda.stream(sh.copy):
                    ev[0].record()
                    devs.append(part.to(sh.device, non_blocking=True))
                    ev[1].record()
                events.append(ev)
            slab.copied = tuple(ev[1] for ev in events)
            t_put = time.monotonic()
            host_out = torch.empty((bucket, self.row_width), dtype=torch.float32,
                                   pin_memory=cuda)
            outs, done = [], []
            # One enqueue at a time on the replica: its launch threads share
            # its streams, static inputs and graph pools, and an eager
            # enqueue is host-bound Python. The other thread's copy is
            # already queued meanwhile; other replicas and engines enqueue
            # on streams of their own, so nothing of theirs falls between
            # this batch's compute events.
            with rep.lock:
                t_compute = time.perf_counter()
                for j, (sh, dev) in enumerate(zip(rep.shards, devs)):
                    with torch.cuda.stream(sh.compute) if cuda else contextlib.nullcontext():
                        if cuda:
                            sh.compute.wait_event(events[j][1])
                            dev.record_stream(sh.compute)
                        if replay:
                            self._stage_static(sh, key, dev, meta_off, j * per)
                        if cuda:
                            events[j][2].record()
                        if replay:
                            out = sh.exes[key]()
                        elif meta_off is not None:
                            meta = dev[meta_off:].view(torch.int32).view(-1, 4)
                            out = self._serve_ragged(sh.model, dev[:meta_off],
                                                     meta[j * per:(j + 1) * per], slab.s)
                        else:
                            out = self._serve_packed(sh.model, dev)
                        if cuda:
                            events[j][3].record()
                            host_out[j * per:(j + 1) * per].copy_(out, non_blocking=True)
                            done.append(torch.cuda.Event())
                            done[-1].record()
                        else:
                            outs.append(out)
                host_compute_s = time.perf_counter() - t_compute
        if not cuda:
            host_out = outs[0] if d == 1 else torch.cat(outs)
        handle = BatchHandle(host_out, tuple(done), n, tuple(events), replay, (slab.s, bucket),
                             rows_dispatched, rows_tight, host_compute_s, t_put, rep.index,
                             slab.total_bytes)
        with self._lock:
            self.batches += 1
            self.images += n
            self.h2d_bytes += sum(part.numel() for part in parts)
            if replay:
                self.replays += 1
            else:
                self.eager_batches += 1
            for sh, ev in zip(rep.shards, events):
                self._device_events.append((slab.key, rep.index, str(sh.device), ev))
        return handle

    def _dispatch(self, slab, n: int, bucket: int, spans, replica: int | None, t0: float,
                  *ship_args) -> BatchHandle:
        """Route, ship and account one batch; its slab goes back to the
        pool once its copy is enqueued and its lessees are done."""
        rep = self._take_replica(replica, slab)
        try:
            handle = self._ship(rep, *ship_args)
        except BaseException:
            self._drop_inflight(rep, slab.total_bytes)
            raise
        slab.finish()
        t_disp = time.monotonic()
        for span in spans:
            span.add_max("device_transfer", handle.t_put - t0)
            span.add_max("device_dispatch", t_disp - handle.t_put)
            span.note("replica", rep.index)
        return handle

    def dispatch_staged(self, slab: StagingSlab, n: int, spans=(),
                        replica: int | None = None) -> BatchHandle:
        """Ship the first ``n`` rows of a filled slab (holes included) at the
        batch bucket that covers them to ``replica`` (None: routed here by
        :meth:`route_replica`), and enqueue the serve function; returns
        without waiting for the device. ``spans`` get ``device_transfer``,
        ``device_dispatch`` and the ``replica`` note."""
        t0 = time.monotonic()
        bucket = self.pick_batch_bucket(n)
        if n > bucket:
            raise ValueError(f"batch of {n} exceeds the top batch bucket {bucket}")
        slab.trailer[n:bucket] = _HOLE_TRAILER
        return self._dispatch(slab, n, bucket, spans, replica, t0, slab.buf[:bucket], slab, n,
                              bucket, bucket, float(n))

    def dispatch_ragged(self, slab: RaggedSlab, n: int, spans=(),
                        replica: int | None = None) -> BatchHandle:
        """Ship a filled ragged slab's first ``n`` slots (holes included;
        slots past ``n`` are dropped) and enqueue unpack → serve, as
        :meth:`dispatch_staged`. The arena's used prefix and the meta table
        go in one non-blocking copy. A committed row that does not fit the
        canvas or the shipped arena raises ValueError here, on the host: the
        device unpack reads the table without checking it."""
        t0 = time.monotonic()
        bucket = self.pick_batch_bucket(n)
        if n > bucket:
            raise ValueError(f"batch of {n} exceeds the top batch bucket {bucket}")
        slab.truncate(n)
        nbytes, meta_off = slab.stage(bucket)
        check_ragged_rows(slab.meta[:n], slab.s, meta_off)
        return self._dispatch(slab, n, bucket, spans, replica, t0, slab.buf[:nbytes], slab, n,
                              bucket, slab.rows_shipped(bucket), slab.used / slab.row_bytes,
                              meta_off)

    def dispatch_batch(self, canvases: np.ndarray, hws: np.ndarray,
                       replica: int | None = None) -> BatchHandle:
        """A stacked batch (n ≤ the top batch bucket) copied into a slab
        and dispatched."""
        wire_side = 2 if self.cfg.wire_format == "yuv420" else 1
        slab = self.acquire_staging(canvases.shape[wire_side])
        try:
            slab.write_rows(canvases, hws)
            return self.dispatch_staged(slab, canvases.shape[0], replica=replica)
        except BaseException:
            self.release_staging(slab)
            raise

    def device_timeline(self, base: torch.cuda.Event | None = None) -> list[dict]:
        """The recent batches' copy and compute intervals on the device, per
        device of their replica, in dispatch order (CUDA events; waits for
        them): the slab's ``key`` (kind, canvas side), the ``replica`` and
        ``device``, ``h2d`` on the copy stream and ``compute`` on the compute
        stream (from the copy's end, or the stream reaching the batch, to
        the end of its serve function's enqueued work). In ms from ``base``
        (an event recorded earlier on the same device; so the intervals of
        several engines share one clock), else from the first listed copy's
        start."""
        with self._lock:
            rows = list(self._device_events)
        if not rows:
            return []
        for *_, ev in rows:
            ev[3].synchronize()
        at = (base or rows[0][3][0]).elapsed_time
        return [{"key": key, "replica": r, "device": dev, "h2d": (at(a), at(b)),
                 "compute": (at(c), at(d))} for key, r, dev, (a, b, c, d) in rows]

    def fetch_outputs(self, handle: BatchHandle) -> tuple[np.ndarray, ...]:
        """Wait for a dispatched batch; returns the task's arrays for the
        real rows: classify (scores float32 [n, k], indices int32 [n, k]),
        detect the reference's (boxes float32 [n, D, 4], scores float32
        [n, D], classes int32 [n, D], num int32 [n]). Its device seconds go
        to its replica's economics cell; the replica counts it out of
        flight either way."""
        device_s = None
        try:
            with _GATE.shared():
                for ev in handle.done:
                    ev.synchronize()
            if handle.events:
                device_s = max(ev[2].elapsed_time(ev[3]) for ev in handle.events) / 1e3
            else:
                device_s = handle.host_compute_s
        finally:
            self._account(handle, device_s)
        packed = handle.out.numpy()[: handle.n]
        if self.task == "detect":
            d = self.max_detections
            return (packed[:, :4 * d].reshape(-1, d, 4).copy(),
                    packed[:, 4 * d:5 * d].copy(),
                    packed[:, 5 * d:6 * d].astype(np.int32),
                    packed[:, 6 * d].astype(np.int32))
        k = self.topk
        return packed[:, :k].copy(), packed[:, k:].astype(np.int32)

    def _account(self, handle: BatchHandle, device_s: float | None) -> None:
        """Fold one fetched batch into its replica: out of flight, and (when
        its device seconds were read) into its economics cell and busy
        seconds. On the card the seconds are the compute-stream events'
        interval (the ``done`` events follow them on those streams, so they
        have completed and ``elapsed_time`` does not block), on the CPU the
        serve call's wall."""
        rep = self._replicas[handle.replica]
        with self._lock:
            rep.dispatches_inflight -= 1
            rep.slab_bytes_inflight -= handle.slab_bytes
            if device_s is None:
                return
            cell = rep.econ.get(handle.cell)
            if cell is None:
                cell = rep.econ[handle.cell] = [0, 0, 0, 0.0, 0.0]
            cell[0] += 1
            cell[1] += handle.n
            cell[2] += handle.rows_dispatched
            cell[3] += device_s
            cell[4] += handle.rows_tight
            rep.busy_s += device_s

    def econ_stats(self) -> list[dict]:
        """The reference's per-replica economics counters: per replica, a
        row per (canvas, batch bucket) cell a fetched batch has exercised
        (``rows_tight`` meaningful on the ragged wire)."""
        with self._lock:
            return [{
                "replica": rep.index,
                "devices": len(rep.devices),
                "buckets": [
                    {"canvas": ck, "batch_bucket": bk, "batches": c[0], "rows": c[1],
                     "rows_dispatched": c[2], "device_s": round(c[3], 4),
                     "rows_tight": round(c[4], 3)}
                    for (ck, bk), c in sorted(rep.econ.items())
                ],
            } for rep in self._replicas]

    def run_batch(self, canvases: np.ndarray, hws: np.ndarray,
                  replica: int | None = None) -> tuple[np.ndarray, ...]:
        """Dispatch + fetch (tests, warmup); batches above the top bucket go
        in chunks, all dispatched before the first fetch (each routed on
        its own unless ``replica`` pins them)."""
        top = self.batch_buckets[-1]
        handles = [
            self.dispatch_batch(canvases[i : i + top], hws[i : i + top], replica)
            for i in range(0, canvases.shape[0], top)
        ]
        parts = [self.fetch_outputs(h) for h in handles]
        return tuple(np.concatenate(p) for p in zip(*parts))

    def run_ragged(self, images: list[np.ndarray], hws: np.ndarray, s: int,
                   replica: int | None = None) -> tuple[np.ndarray, ...]:
        """Tight images (uint8 [h, w, 3] each, valid sizes ``hws``) of canvas
        side ``s`` through the ragged wire (tests, warmup): one memcpy each
        into a slab, batches above the top bucket in chunks, all dispatched
        before the first fetch."""
        top = self.batch_buckets[-1]
        handles = []
        for i in range(0, len(images), top):
            slab = self.acquire_ragged(s)
            try:
                for img, hw in zip(images[i : i + top], hws[i : i + top]):
                    slot, span = slab.alloc(img.nbytes)
                    span[:] = img.reshape(-1)
                    slab.write_hw(slot, hw)
                handles.append(self.dispatch_ragged(slab, slab.slots, replica=replica))
            except BaseException:
                self.release_staging(slab)
                raise
        parts = [self.fetch_outputs(h) for h in handles]
        return tuple(np.concatenate(p) for p in zip(*parts))

    def _run_blank(self, b: int, s: int,
                   replica: int | None = None) -> tuple[np.ndarray, ...]:
        """``b`` black full-canvas images through the wire this engine serves."""
        hws = np.full((b, 2), s, np.int32)
        if self.ragged:
            return self.run_ragged([np.zeros((s, s, 3), np.uint8)] * b, hws, s, replica)
        return self.run_batch(np.zeros(self.canvas_shape(b, s), np.uint8), hws, replica)

    def warmup(self) -> None:
        """Ready every (canvas, batch) bucket pair of every replica before
        traffic, in the reference's three timed phases, each logged on its
        own line:

        1. one-time costs — the kernel libraries through the build cache and
           the native decoder; paid at engine build (the int8 parity gate
           launches the kernels), logged here;
        2. executables — for every pair, largest first, and every device of
           every replica, an eager warm run and the CUDA graph's capture (on
           the CPU: the static-buffer executable), once per engine under a
           lock;
        3. execution — one batch per pair and replica through dispatch and
           fetch, on the calling thread, a graph replay each.

        Every launch thread of the batcher calls this before it takes a
        batch: the first captures, the others find the executables made and
        run phase 3 alone (per-thread first use, measured in its line)."""
        with self._warmup_lock:
            if not self._warmed:
                # the economics peak: a table lookup on the card, a one-time
                # calibration on the CPU that no /metrics scrape should pay
                t0 = time.perf_counter()
                from . import costmodel

                peak = costmodel.backend_peak(self.model_cfg.dtype, self.device,
                                              len(self.mesh))
                log.info("warmup: one-time costs %.2fs at build (kernels %s through the "
                         "build cache, %s decoder), econ peak %s %.2fs",
                         self.warmup_s["one_time"], self.kernels if self._pinned else [],
                         "native" if self.decoder["available"] else "PIL", peak["source"],
                         time.perf_counter() - t0)
                t0 = time.perf_counter()
                pairs = sorted(((s, b) for s in self.cfg.canvas_buckets
                                for b in self.batch_buckets), reverse=True)
                kind = "ragged" if self.ragged else "classic"
                for sh in self._shards():
                    for s, b in pairs:
                        p = b // self.batch_multiple
                        sh.exes[(kind, s, p)] = self._capture(kind, s, p, sh)
                if self._pinned:
                    for dev in self.mesh:
                        torch.cuda.synchronize(dev)
                    self.pool_bytes = sum(map(self._graph_pool_bytes, self._shards()))
                self.warmup_s["executables"] = time.perf_counter() - t0
                log.info("warmup: executables %.2fs (%d pairs × %d devices, %s; graph pools "
                         "%d bytes, static %d bytes)", self.warmup_s["executables"],
                         len(pairs), len(self._shards()),
                         "CUDA graphs" if self._pinned else "no capture", self.pool_bytes,
                         self._static_bytes())
                self._warmed = True
            t0 = time.perf_counter()
            for rep in self._replicas:
                for s in self.cfg.canvas_buckets:
                    for b in self.batch_buckets:
                        self._run_blank(b, s, rep.index)
            dt = time.perf_counter() - t0
            self.warmup_s["execution"].append(dt)
            log.info("warmup: execution pass %.2fs (%d batches, thread %s)", dt,
                     self.num_replicas * len(self.cfg.canvas_buckets) * len(self.batch_buckets),
                     threading.current_thread().name)

    def _static_bytes(self) -> int:
        """Bytes of the static inputs and the graphs' static outputs."""
        return sum(t.nbytes for sh in self._shards() for t in sh.static.values()) + sum(
            e.out.nbytes for sh in self._shards() for e in list(sh.exes.values())
            if e.out is not None)

    def healthcheck(self) -> bool:
        """One-image device round trip."""
        outs = self._run_blank(1, self.cfg.canvas_buckets[0])
        return all(bool(np.all(np.isfinite(o))) for o in outs)

    def stats(self) -> dict:
        shards = self._shards()
        with self._lock:
            # Counted under the lock and not held past it: close() clears
            # the executables under the same lock, and a graph that a
            # concurrent reader (``GET /models`` on a draining version)
            # still held would keep close() from giving its pool back.
            exes = [e for sh in shards for e in list(sh.exes.values())]
            batches, images, h2d, decodes = (self.batches, self.images, self.h2d_bytes,
                                             dict(self.decodes))
            busy_s = sum(rep.busy_s for rep in self._replicas)
            slabs = {"allocated": self.slabs_allocated,
                     "pooled": sum(len(v) for v in self._pool.values()),
                     "pooled_bytes": self._pool_nbytes}
            graphs = {"captured": sum(e.graph is not None for e in exes),
                      "executables": len(exes), "replays": self.replays,
                      "eager_batches": self.eager_batches,
                      "capture_s": sum(e.capture_s for e in exes),
                      "pool_bytes": self.pool_bytes, "static_bytes": self._static_bytes()}
            del exes
        # the process's device memory, every engine in it: what a retired
        # version gave back shows here
        graphs["memory_allocated"] = (torch.cuda.memory_allocated(self.device) if self._pinned
                                      else None)
        graphs["memory_reserved"] = (torch.cuda.memory_reserved(self.device) if self._pinned
                                     else None)
        return {
            "model": self.model_cfg.name,
            "source": self.source,
            "load_s": dict(self.load_s),
            "task": self.task,
            "outputs": list(self.model.output_names) if self.model is not None else None,
            "device": str(self.device),
            "dtype": self.model_cfg.dtype,
            "fused_dw": self.fused_dw,
            "parity": self.parity,
            "wire_format": self.cfg.wire_format,
            "ragged": self.ragged,
            "resize": self.cfg.resize,
            "decoder": self.decoder,
            "decodes": decodes,
            "h2d_bytes": h2d,
            "slabs": slabs,
            "batch_buckets": list(self.batch_buckets),
            "canvas_buckets": list(self.cfg.canvas_buckets),
            "batches": batches,
            "images": images,
            "busy_s": round(busy_s, 6),
            "kernel_launches": {"preprocess_i420": preprocess_i420.launches,
                                "fused_dw": fused_dw.launches,
                                "unpack_ragged": unpack_ragged.launches,
                                "nms_fixed": nms_fixed.launches},
            "graphs": graphs,
            "aot_cache": {**aotcache.stats(self.aot_cache), "libraries": self.kernels},
            "warmup_s": {**self.warmup_s, "execution": list(self.warmup_s["execution"])},
        }

    def close(self) -> None:
        """Drop every CUDA graph, static input, weight and staging buffer of
        every replica, then give the freed segments back to the device: the
        caching allocator keeps them reserved otherwise, the graph pools'
        included. The segments are returned under ``_CAPTURE_LOCK``, never
        during another engine's capture; ``pool_bytes`` then holds what the
        pools still have (0 unless a live tensor pins a segment). The
        streams go back to the process's pool once the devices are idle.
        The engine must not be used afterwards."""
        shards = self._shards()
        with self._lock:
            self._pool.clear()
            self._pool_nbytes = 0
            self._device_events.clear()
            self._preprocess = None
            for sh in shards:
                sh.exes.clear()
                sh.static.clear()
                sh.model = None
                sh.mem_pool = None  # its segments are freeable once its tensors are gone
        if self._pinned:
            # On the H100 a retired version's graph pool stayed in use until
            # Python's cycle collector next ran (seen after a profiler
            # capture and a hot swap: its 386 MB came back after
            # gc.collect()), so collect before giving the segments back.
            gc.collect()
            with _CAPTURE_LOCK:
                for dev in self.mesh:
                    torch.cuda.synchronize(dev)
                torch.cuda.empty_cache()
                self.pool_bytes = sum(map(self._graph_pool_bytes, shards))
            for sh in shards:
                sh.release_streams()
            if self.pool_bytes:
                log.warning("closed engine's graph pools still hold %d bytes", self.pool_bytes)

    # ------------------------------------------------------------------ host

    def prepare(self, image: np.ndarray) -> tuple[np.ndarray, tuple[int, int]]:
        """Decoded RGB image → (wire canvas, valid (h, w))."""
        canvas, hw = pad_to_canvas(image, self.cfg.canvas_buckets)
        if self.cfg.wire_format == "yuv420":
            canvas = rgb_to_yuv420_canvas(canvas)
        return canvas, hw

    def count_decode(self, decoder: str) -> None:
        """One upload decoded by ``"native"`` libjpeg or ``"pil"``."""
        with self._lock:
            self.decodes[decoder] += 1

    def prepare_bytes(self, data: bytes) -> tuple[np.ndarray, tuple[int, int], tuple[int, int]]:
        """Image bytes → (wire canvas, valid (h, w), original (h, w)) for the
        classic wire: libjpeg straight into the canvas (RGB, or I420 on the
        yuv420 wire) for a JPEG, PIL for the rest (``native.decode_to_canvas``).
        Raises ValueError if the bytes are not a decodable image."""
        buckets, wire = self.cfg.canvas_buckets, self.cfg.wire_format
        got = native.decode_native(data, buckets, wire)
        if got is not None:
            self.count_decode("native")
            return got
        try:
            got = native.decode_pil(data, buckets, wire)
        except (OSError, ValueError) as e:  # PIL: UnidentifiedImageError is an OSError
            raise ValueError(f"cannot decode image: {e}") from e
        self.count_decode("pil")
        return got

    def prepare_ragged(self, data: bytes
                       ) -> tuple[np.ndarray, tuple[int, int], int, tuple[int, int]]:
        """Image bytes → (tight uint8 [h, w, 3], valid (h, w), canvas side,
        original (h, w)) for the ragged wire. A JPEG is planned from its
        header and decoded by libjpeg as tight rows (DCT-downscaled when
        oversized); anything else, or a stream the C side rejects, goes
        through PIL and ``fit_to_bucket``. Raises ValueError if the bytes are
        not a decodable image."""
        buckets = self.cfg.canvas_buckets
        plan = native.plan_decode_packed(data, buckets)
        if plan is not None:
            s, need, _, orig = plan
            tight = np.empty(need, np.uint8)
            hw = native.decode_packed_into(data, tight, s)
            if hw is not None:
                self.count_decode("native")
                return tight.reshape(hw[0], hw[1], 3), hw, s, orig
        try:
            image = decode_image(data)
        except (OSError, ValueError) as e:
            raise ValueError(f"cannot decode image: {e}") from e
        tight, hw, s = fit_to_bucket(image, buckets)
        self.count_decode("pil")
        return tight, hw, s, tuple(image.shape[:2])
