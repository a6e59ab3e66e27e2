"""Inference engine for one device (counterpart of the JAX package's
``serving/engine.py``).

One batch is one uint8 wire buffer — each image's canvas bytes followed by
a 4-byte big-endian (h, w) trailer — in a pinned :class:`StagingSlab`,
copied to the device with one non-blocking transfer. On the device the
serve function runs preprocess (into the serving dtype) → forward →
softmax → top-k, and only k (score, index) pairs per image come back, in
one packed float32 array. On the yuv420 wire with the preprocess kernel,
that stage is one launch: the kernel reads each row's trailer itself and
stores the serving dtype. Batches are padded to a batch bucket; padding
rows carry hw = 1×1 and are sliced off on the host.

On the ragged wire (rgb only) a batch is one pinned :class:`RaggedSlab`
instead: each image's tight rows back to back, then the int32 meta table,
shipped in one non-blocking copy; the device rebuilds the canvases
(``ops/image.py::unpack_ragged``, one kernel that reads the table on the
device) and the same serve path follows.

**Executables** (the counterpart of the reference's precompiled
executable per (canvas bucket, batch bucket)). Warmup captures the serve
function of every (wire kind, canvas side, batch bucket) as one CUDA graph
(:class:`Executable`), largest first, into one graph memory pool per
engine. Each canvas side has one static device input at the top batch
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
host→device copy goes on a copy stream of its own, and the compute stream
waits for that copy's event, so batch N+1's transfer overlaps batch N's
compute. A slab returns to its pool once its copy is enqueued (or it is
released undispatched) and its last lessee has resolved; it is handed out
again only after that copy's event.

The int8 tier keeps its kernels int8 on the device and dequantizes them
inside every forward, computing in bf16 (``ops/quant.py``); before it
serves, the golden parity gate holds it against the unfused float32 model
on the same parameters, and a failing gate raises.

**Device economics** (:meth:`InferenceEngine.econ_stats`, read by
``serving/costmodel.py``): batches, rows and device seconds per (canvas,
batch bucket), and ``busy_s`` over all. On the card a batch's device
seconds are the interval between two CUDA events on the compute stream
around its graph replay (or eager serve function), read after its fetch;
the reference counts the host's dispatch → fetch wall, which with several
batches in flight includes the wait behind the others. On the CPU they are
the serve call's host wall. Request spans passed to the dispatch get
``device_transfer`` (the H2D enqueue) and ``device_dispatch`` (the replay
and the D2H enqueue).
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from .. import native
from ..models.adapter import native_converted
from ..ops import _build, launches, quant
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
from ..utils.config import ServerConfig
from ..utils.device import resolve_device
from . import aotcache

log = logging.getLogger("tpu_serve_torch.engine")

_HOLE_TRAILER = (0, 1, 0, 1)  # hw = (1, 1): the resize reads one pixel
# one CUDA graph capture at a time in the process (torch's rule); it also
# guards _capture_streams
_CAPTURE_LOCK = threading.Lock()
# One timed compute enqueue at a time in the process: every engine enqueues
# on its thread's current stream, the device's default stream, so another
# engine's work enqueued between a batch's two compute events would count
# as this batch's device time.
_COMPUTE_LOCK = threading.Lock()
# device index → the one stream every capture, and the eager run before it,
# runs on. cuBLAS keeps a workspace per (thread's handle, stream) for the
# life of the process: made by the eager run, it lies outside every graph
# pool, and one stream bounds their number by the threads' handles. (A
# workspace first made inside a capture would pin its graph pool's segment
# after the engine closed.)
_capture_streams: dict = {}


def _align16(x: int) -> int:
    return -(-x // 16) * 16


class _Leased:
    """The pool-return half of a slab's cycle, shared by both slabs. A slab
    is out of its pool from :meth:`arm` (acquire) until both (a) its batch's
    host→device copy is enqueued, or it was released undispatched
    (:meth:`finish`), and (b) every lessee has dropped its lease: a
    force-expired lessee may still be decoding into its row. ``copied`` is
    the copy's event; the pool waits for it before the slab is reused."""

    def _init_lease(self) -> None:
        self._lease_lock = threading.Lock()
        self._leases = 0
        self._finished = True
        self._idle_cb = None
        self.copied: torch.cuda.Event | None = None

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
    out: torch.Tensor  # float32 [bucket, 2k] on the host
    done: torch.cuda.Event | None
    n: int
    # CUDA: timing events of the copy (copy stream) and of the serve
    # function (compute stream): H2D start, H2D end, compute start, end
    events: tuple[torch.cuda.Event, ...] = ()
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


@dataclass
class Executable:
    """The serve function of one (wire kind, canvas side, batch bucket) on
    its static input views (``fn``). On the card, ``graph`` is its CUDA
    graph and ``out`` the graph's static output; ``launches`` holds the
    hand-written kernels' launches its capture recorded, which every replay
    adds to their counters. On the CPU there is no graph: calling it runs
    ``fn``."""

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


class InferenceEngine:
    """Serves batches of decoded images on one device (``"cuda"`` unless
    the caller passes ``device="cpu"``).

    A float32 or int8 engine turns TF32 off in cuDNN and cuBLAS at build
    (float32 means float32; for int8, the parity gate's reference). Those
    flags are process-wide: they hold for every model in the process."""

    # Gate tolerances per serving dtype, the reference's _PARITY_TOL:
    # ``prob`` bounds the max probability delta and is the top-k agreement
    # margin; ``topk`` is the least agreeing fraction.
    PARITY_TOL = {
        "int8": {"prob": 0.15, "topk": 0.90},
        "bfloat16": {"prob": 0.08, "topk": 0.90},
    }
    # the batcher passes request spans to the dispatch calls
    supports_span_tracing = True

    def __init__(self, cfg: ServerConfig, device: str | torch.device | None = None,
                 seed: int = 0, params_flat: dict[str, np.ndarray] | None = None):
        self.cfg = cfg
        self.model_cfg = cfg.model
        self.device = resolve_device(device)
        # the reference's gating: tight packing exists for the rgb wire only
        self.ragged = cfg.ragged and cfg.wire_format == "rgb"
        if cfg.ragged and not self.ragged:
            log.warning("ragged packing requires wire_format='rgb' (got %r); serving the "
                        "classic host-padded wire", cfg.wire_format)
        self.quantized = self.model_cfg.dtype == "int8"
        if self.model_cfg.dtype in ("float32", "int8"):
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        # int8 computes in bf16
        self.dtype = torch.float32 if self.model_cfg.dtype == "float32" else torch.bfloat16
        self.fused_dw = self.model_cfg.fuse_depthwise
        # yuv420 + kernel: the kernel takes the wire buffer itself
        # (preprocess_packed); the other paths decode the trailers first
        self._wire_kernel = cfg.wire_format == "yuv420" and cfg.resize == "kernel"
        # Warmup's first phase, the one-time costs, runs here: the int8
        # parity gate below already launches the kernels. The kernel
        # libraries this engine's path runs are built or loaded through the
        # build cache, and the native decoder is built (a build fault raises
        # here, not per request).
        self.aot_cache = aotcache.AotCache.from_config(cfg)
        self.kernels = [name for name, used in (("unpack_ragged", self.ragged),
                                                ("preprocess_i420", self._wire_kernel),
                                                ("fused_dw", self.fused_dw)) if used]
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            for name in self.kernels:
                _build.load(name, self.aot_cache)
        self.decoder = native.status()
        self.warmup_s = {"one_time": time.perf_counter() - t0, "executables": None,
                         "execution": []}
        self._seed, self._params_flat = seed, params_flat
        # The engine's own memory pool for what it keeps until close(): the
        # weights and the static inputs. In the process's shared pool they
        # would share segments with other engines' tensors (a version built
        # later fills the free blocks an unloaded one left), and an unload
        # could not give those segments back.
        self._mem_pool = torch.cuda.MemPool() if self.device.type == "cuda" else None
        with self._own_pool():
            self.model = self._build_model(self.fused_dw, self.quantized).to(
                self.device, self.dtype, memory_format=torch.channels_last)
        self.num_classes = self.model.backbone.logits.out_features
        self.topk = min(self.model_cfg.topk, self.num_classes)
        self.parity: dict | None = None
        if self.quantized:
            self.parity = self.parity_check()
            if not self.parity["pass"]:
                self.model = None
                raise RuntimeError(
                    f"numerical-parity gate failed for {self.model_cfg.name} "
                    f"dtype={self.model_cfg.dtype}: {self.parity}")
        h, w = self.model_cfg.input_size
        self._preprocess = None if self._wire_kernel else make_preprocess_fn(
            h, w, self.model_cfg.preprocess, wire=cfg.wire_format, resize=cfg.resize,
            out_dtype=self.dtype,
        )
        self.batch_buckets = self._default_batch_buckets(cfg.max_batch)
        self.max_batch = self.batch_buckets[-1]
        self._pinned = self.device.type == "cuda"
        # (kind, canvas side) → free slabs, at most pipeline_depth + 1 each:
        # pinned memory is scarce (one rgb slab at a 2048 canvas and batch
        # 32 is 403 MB), so slabs are allocated at first use
        self._pool: dict[tuple[str, int], list] = {}
        self._pool_cap = cfg.pipeline_depth + 1
        self.slabs_allocated = 0
        # the host→device copies' own stream: batch N+1's copy runs beside
        # batch N's compute on the current stream
        self._copy_stream = torch.cuda.Stream(self.device) if self._pinned else None
        self._device_events: deque = deque(maxlen=256)  # BatchHandle.events
        # Guards the pool and the counters only; never a wait on an event.
        self._lock = threading.Lock()
        self._enqueue_lock = threading.Lock()  # one serve-function enqueue at a time
        self.batches = 0
        self.images = 0
        self.h2d_bytes = 0
        self.decodes = {"native": 0, "pil": 0}
        # the executables: (kind, canvas side, batch bucket) → Executable,
        # filled once by warmup (under _warmup_lock), read lock-free after
        self._exes: dict[tuple[str, int, int], Executable] = {}
        self._static: dict[tuple[str, int], torch.Tensor] = {}  # (kind, side) → input
        self._graph_pool = torch.cuda.graph_pool_handle() if self._pinned else None
        self._warmup_lock = threading.Lock()
        self._warmed = False
        self.replays = 0
        self.eager_batches = 0
        self.pool_bytes = 0
        # (canvas side, batch bucket) → [batches, rows, rows dispatched,
        # device s, tight rows]; busy_s sums the device seconds
        self._econ: dict[tuple[int, int], list] = {}
        self.busy_s = 0.0

    def _own_pool(self):
        """Routes this thread's device allocations to the engine's own pool
        (nothing on the CPU)."""
        if self._mem_pool is None:
            return contextlib.nullcontext()
        index = self.device.index
        return torch.cuda.use_mem_pool(
            self._mem_pool, torch.cuda.current_device() if index is None else index)

    def _build_model(self, fused_dw: bool, int8: bool):
        return native_converted(
            self.model_cfg.name,
            num_classes=self.model_cfg.zoo_classes,
            width=self.model_cfg.zoo_width,
            seed=self._seed,
            params_flat=self._params_flat,
            fused_dw=fused_dw,
            int8=int8,
        )

    def parity_check(self, batch: int = 4, seed: int = 0) -> dict:
        """Golden numerical-parity gate: this engine's model, as it serves
        (int8 dequantized on the fly, fused depthwise, compute dtype),
        against the unfused float32 model on the same parameters, on a
        seeded probe batch of NHWC images in [-1, 1]. Gates margin-aware
        top-k agreement and the max probability delta. Runs at build for
        int8; callable on any engine."""
        tol = self.PARITY_TOL.get(self.model_cfg.dtype, self.PARITY_TOL["bfloat16"])
        h, w = self.model_cfg.input_size
        x = np.random.RandomState(seed).uniform(-1.0, 1.0, (batch, h, w, 3)).astype(np.float32)
        x = torch.from_numpy(x).to(self.device)
        ref = self._build_model(fused_dw=False, int8=False).to(
            self.device, memory_format=torch.channels_last)
        with torch.inference_mode():
            got = self.model(x.to(self.dtype)).float().cpu().numpy()
            want = ref(x).cpu().numpy()
        k = self.topk
        prob_d = float(np.max(np.abs(got - want)))
        agree = quant.topk_agreement(want, got, k, tol["prob"])
        return {
            "dtype": self.model_cfg.dtype, "fused_dw": self.fused_dw, "probe_batch": batch,
            "max_prob_delta": prob_d, "topk_agreement": agree, "topk": k,
            "tol_prob": tol["prob"], "tol_topk": tol["topk"],
            "pass": prob_d <= tol["prob"] and agree >= tol["topk"],
        }

    # ---------------------------------------------------------------- shapes

    @staticmethod
    def _default_batch_buckets(max_batch: int) -> tuple[int, ...]:
        """Powers of two below ``max_batch``, then ``max_batch`` itself."""
        top = max(1, max_batch)
        buckets, b = [], 1
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

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        """Forward → softmax → top-k: [B, out_h, out_w, 3] → float32 [B, 2k]
        holding k scores then k class indices per image."""
        # softmax runs in the serving dtype; top-k reads it in float32
        probs = self.model(x).float()
        scores, idx = torch.topk(probs, self.topk, dim=-1)
        return torch.cat([scores, idx.float()], dim=1)

    def _serve_packed(self, buf: torch.Tensor) -> torch.Tensor:
        """Device side of one batch: packed uint8 [B, bytes + 4] → float32 [B, 2k]."""
        return self._head(self.preprocess_packed(buf))

    def _serve_ragged(self, arena: torch.Tensor, meta: torch.Tensor, s: int) -> torch.Tensor:
        """Device side of one ragged batch: the arena and the int32 [bucket,
        4] meta table → unpack → preprocess → :meth:`_head`."""
        canvases, hws = unpack_ragged(arena, meta, s)
        return self._head(self._preprocess(canvases, hws))

    # ----------------------------------------------------------- executables

    def _static_input(self, kind: str, s: int) -> torch.Tensor:
        """The static device input of one canvas side, at the top batch
        bucket's capacity: packed wire rows (hole trailers until written),
        or the arena (16-byte aligned) followed by the meta table."""
        key = (kind, s)
        if key not in self._static:
            cap = self.max_batch
            with self._own_pool():
                if kind == "ragged":
                    buf = torch.zeros(_align16(cap * s * s * 3) + 16 * cap,
                                      dtype=torch.uint8, device=self.device)
                else:
                    buf = torch.zeros(self.packed_shape(cap, s), dtype=torch.uint8,
                                      device=self.device)
                    buf[:, -4:] = torch.tensor(_HOLE_TRAILER, dtype=torch.uint8,
                                               device=self.device)
            self._static[key] = buf
        return self._static[key]

    def _ragged_views(self, s: int) -> tuple[torch.Tensor, torch.Tensor]:
        """The ragged static input's arena and meta table [capacity, 4]."""
        buf = self._static_input("ragged", s)
        arena = _align16(self.max_batch * s * s * 3)
        return buf[:arena], buf[arena:].view(torch.int32).view(-1, 4)

    def _static_fn(self, kind: str, s: int, b: int) -> Callable[[], torch.Tensor]:
        """The serve function of bucket ``b`` over prefix views of the side's
        static input."""
        if kind == "ragged":
            arena, meta = self._ragged_views(s)
            return lambda: self._serve_ragged(arena, meta[:b], s)
        rows = self._static_input(kind, s)[:b]
        return lambda: self._serve_packed(rows)

    def _stage_static(self, key: tuple[str, int, int], dev: torch.Tensor,
                      meta_off: int | None) -> None:
        """Copy one batch's freshly copied wire into its static input, on the
        current (compute) stream: the wire rows, or the shipped arena prefix
        and the meta table. Bytes past the prefix keep an earlier batch's
        values; the unpack reads only the spans the meta table names."""
        kind, s, b = key
        if kind == "ragged":
            arena, meta = self._ragged_views(s)
            arena[:meta_off].copy_(dev[:meta_off])
            meta[:b].view(torch.uint8).view(-1).copy_(dev[meta_off:])
        else:
            self._static_input(kind, s)[:b].copy_(dev)

    def _capture(self, kind: str, s: int, b: int) -> Executable:
        """The executable of one (kind, side, bucket). On the card, under
        ``_CAPTURE_LOCK`` and on the process's capture stream: one eager run
        (cuDNN/cuBLAS plans, this thread's cuBLAS workspace for the stream,
        the kernels' one-time attributes), then the capture into the
        engine's graph pool. A capture that fails raises."""
        key = (kind, s, b)
        fn = self._static_fn(kind, s, b)
        if self.device.type != "cuda":
            return Executable(key, fn)
        t0 = time.perf_counter()
        compute = torch.cuda.current_stream(self.device)
        # thread_local: during a hot swap this capture runs while the old
        # version's launch and completion threads replay graphs, sync events
        # and allocate (a batch of a shape never captured runs eagerly);
        # their CUDA calls must not fail the capture, nor the capture theirs.
        # close() returns freed segments only under _CAPTURE_LOCK, never
        # during a capture.
        with torch.inference_mode(), _CAPTURE_LOCK:
            stream = _capture_streams.get(self.device.index)
            if stream is None:
                stream = _capture_streams[self.device.index] = torch.cuda.Stream(self.device)
            stream.wait_stream(compute)
            with torch.cuda.stream(stream):
                fn()
            graph = torch.cuda.CUDAGraph()
            with launches.recording() as record, torch.cuda.graph(
                    graph, pool=self._graph_pool, stream=stream,
                    capture_error_mode="thread_local"):
                out = fn()
            compute.wait_stream(stream)
        return Executable(key, fn, graph, out, record, time.perf_counter() - t0)

    def _graph_pool_bytes(self) -> int:
        """Device bytes the engine's graph memory pool holds."""
        pool = tuple(self._graph_pool)
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == pool)

    # -------------------------------------------------------------- staging

    def _acquire(self, key: tuple[str, int], make):
        with self._lock:
            free = self._pool.get(key)
            slab = free.pop() if free else None
            if slab is None:
                self.slabs_allocated += 1
        if slab is None:
            slab = make()
        if slab.copied is not None:  # its last copy to the device
            slab.copied.synchronize()
        slab.arm(self._return)
        return slab

    def _return(self, slab) -> None:
        with self._lock:
            free = self._pool.setdefault(slab.key, [])
            if len(free) < self._pool_cap:  # else dropped: bounded pinned memory
                free.append(slab)

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

    def _ship(self, buf: torch.Tensor, slab, n: int, bucket: int, rows_dispatched: int,
              rows_tight: float, meta_off: int | None = None) -> BatchHandle:
        """One batch: ``buf`` (a prefix of the slab's pinned buffer) to the
        device in one non-blocking copy into a fresh buffer on the copy
        stream; on the compute stream, waiting for that copy, its executable
        (a copy into the static input, one graph replay) or, for a shape
        warmup never captured, the same serve function run eagerly on the
        fresh buffer; then the output's copy back. ``meta_off``: where a
        ragged wire's meta table starts; ``rows_dispatched`` and
        ``rows_tight`` go to the batch's economics cell. Returns without
        waiting for the device."""
        key = (slab.key[0], slab.s, bucket)
        exe = self._exes.get(key)
        with torch.inference_mode():
            if self._copy_stream is None:
                dev, events = buf.to(self.device), ()
            else:
                compute = torch.cuda.current_stream(self.device)
                events = tuple(torch.cuda.Event(enable_timing=True) for _ in range(4))
                with torch.cuda.stream(self._copy_stream):
                    events[0].record()
                    dev = buf.to(self.device, non_blocking=True)
                    events[1].record()
                slab.copied = events[1]
            t_put = time.monotonic()
            # One enqueue at a time: the two launch threads share the compute
            # stream, the static inputs and the graph pool, and an eager
            # enqueue is host-bound Python (PERF.md). The other thread's copy
            # is already queued meanwhile.
            with self._enqueue_lock:
                if events:
                    compute.wait_event(events[1])
                    dev.record_stream(compute)
                if exe is not None:
                    self._stage_static(key, dev, meta_off)
                # the CPU has no shared stream: its engines compute side by side
                with _COMPUTE_LOCK if events else contextlib.nullcontext():
                    if events:
                        events[2].record()
                    t_compute = time.perf_counter()
                    if exe is not None:
                        out = exe()
                    elif meta_off is not None:
                        out = self._serve_ragged(dev[:meta_off],
                                                 dev[meta_off:].view(torch.int32).view(-1, 4),
                                                 slab.s)
                    else:
                        out = self._serve_packed(dev)
                    if events:
                        events[3].record()
                    host_compute_s = time.perf_counter() - t_compute
                handle = self._fetchable(out, n)
        handle.events = events
        handle.replay = exe is not None
        handle.cell = (slab.s, bucket)
        handle.rows_dispatched, handle.rows_tight = rows_dispatched, rows_tight
        handle.host_compute_s, handle.t_put = host_compute_s, t_put
        with self._lock:
            self.batches += 1
            self.images += n
            self.h2d_bytes += buf.numel()
            if exe is not None:
                self.replays += 1
            else:
                self.eager_batches += 1
            if events:
                self._device_events.append((slab.key, events))
        return handle

    def dispatch_staged(self, slab: StagingSlab, n: int, spans=()) -> BatchHandle:
        """Ship the first ``n`` rows of a filled slab (holes included) at the
        batch bucket that covers them, and enqueue the serve function;
        returns without waiting for the device. The slab goes back to its
        pool once the copy is enqueued and its lessees are done. ``spans``
        get ``device_transfer`` and ``device_dispatch``."""
        t0 = time.monotonic()
        bucket = self.pick_batch_bucket(n)
        if n > bucket:
            raise ValueError(f"batch of {n} exceeds the top batch bucket {bucket}")
        slab.trailer[n:bucket] = _HOLE_TRAILER
        handle = self._ship(slab.buf[:bucket], slab, n, bucket, bucket, float(n))
        slab.finish()
        self._stamp_dispatch(spans, t0, handle.t_put)
        return handle

    @staticmethod
    def _stamp_dispatch(spans, t0: float, t_put: float) -> None:
        t_disp = time.monotonic()
        for span in spans:
            span.add_max("device_transfer", t_put - t0)
            span.add_max("device_dispatch", t_disp - t_put)

    def dispatch_ragged(self, slab: RaggedSlab, n: int, spans=()) -> BatchHandle:
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
        handle = self._ship(slab.buf[:nbytes], slab, n, bucket, slab.rows_shipped(bucket),
                            slab.used / slab.row_bytes, meta_off)
        slab.finish()
        self._stamp_dispatch(spans, t0, handle.t_put)
        return handle

    def dispatch_batch(self, canvases: np.ndarray, hws: np.ndarray) -> BatchHandle:
        """A stacked batch (n ≤ the top batch bucket) copied into a slab
        and dispatched."""
        wire_side = 2 if self.cfg.wire_format == "yuv420" else 1
        slab = self.acquire_staging(canvases.shape[wire_side])
        try:
            slab.write_rows(canvases, hws)
            return self.dispatch_staged(slab, canvases.shape[0])
        except BaseException:
            self.release_staging(slab)
            raise

    def _fetchable(self, out: torch.Tensor, n: int) -> BatchHandle:
        """Start the output's non-blocking copy into pinned host memory."""
        if self.device.type != "cuda":
            return BatchHandle(out, None, n)
        host_out = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        host_out.copy_(out, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return BatchHandle(host_out, done, n)

    def device_timeline(self) -> list[dict]:
        """The recent batches' copy and compute intervals on the device, in
        ms from the first listed copy's start (CUDA events; waits for
        them), in dispatch order: the slab's ``key`` (kind, canvas side),
        ``h2d`` on the copy stream, ``compute`` on the compute stream (from
        the copy's end, or the stream reaching the batch, to the end of its
        serve function's enqueued work)."""
        with self._lock:
            rows = list(self._device_events)
        if not rows:
            return []
        for ev in rows[-1][1]:
            ev.synchronize()
        at = rows[0][1][0].elapsed_time
        return [{"key": key, "h2d": (at(a), at(b)), "compute": (at(c), at(d))}
                for key, (a, b, c, d) in rows]

    def fetch_outputs(self, handle: BatchHandle) -> tuple[np.ndarray, np.ndarray]:
        """Wait for a dispatched batch; returns (scores float32 [n, k],
        indices int32 [n, k]) for the real rows. Its device seconds go to
        its economics cell."""
        if handle.done is not None:
            handle.done.synchronize()
        self._account(handle)
        packed = handle.out.numpy()[: handle.n]
        k = self.topk
        return packed[:, :k].copy(), packed[:, k:].astype(np.int32)

    def _account(self, handle: BatchHandle) -> None:
        """Fold one fetched batch into its economics cell and ``busy_s``:
        on the card the compute-stream events' interval (the ``done`` event
        follows them on that stream, so both have completed and
        ``elapsed_time`` does not block), on the CPU the serve call's wall."""
        if handle.events:
            device_s = handle.events[2].elapsed_time(handle.events[3]) / 1e3
        else:
            device_s = handle.host_compute_s
        with self._lock:
            cell = self._econ.get(handle.cell)
            if cell is None:
                cell = self._econ[handle.cell] = [0, 0, 0, 0.0, 0.0]
            cell[0] += 1
            cell[1] += handle.n
            cell[2] += handle.rows_dispatched
            cell[3] += device_s
            cell[4] += handle.rows_tight
            self.busy_s += device_s

    def econ_stats(self) -> list[dict]:
        """The reference's per-replica economics counters for one replica
        of one device: a row per (canvas, batch bucket) cell a fetched
        batch has exercised (``rows_tight`` meaningful on the ragged wire)."""
        with self._lock:
            return [{
                "replica": 0,
                "devices": 1,
                "buckets": [
                    {"canvas": ck, "batch_bucket": bk, "batches": c[0], "rows": c[1],
                     "rows_dispatched": c[2], "device_s": round(c[3], 4),
                     "rows_tight": round(c[4], 3)}
                    for (ck, bk), c in sorted(self._econ.items())
                ],
            }]

    def run_batch(self, canvases: np.ndarray, hws: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Dispatch + fetch (tests, warmup); batches above the top bucket go
        in chunks, all dispatched before the first fetch."""
        top = self.batch_buckets[-1]
        handles = [
            self.dispatch_batch(canvases[i : i + top], hws[i : i + top])
            for i in range(0, canvases.shape[0], top)
        ]
        parts = [self.fetch_outputs(h) for h in handles]
        return tuple(np.concatenate(p) for p in zip(*parts))

    def run_ragged(self, images: list[np.ndarray], hws: np.ndarray,
                   s: int) -> tuple[np.ndarray, np.ndarray]:
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
                handles.append(self.dispatch_ragged(slab, slab.slots))
            except BaseException:
                self.release_staging(slab)
                raise
        parts = [self.fetch_outputs(h) for h in handles]
        return tuple(np.concatenate(p) for p in zip(*parts))

    def _run_blank(self, b: int, s: int) -> tuple[np.ndarray, np.ndarray]:
        """``b`` black full-canvas images through the wire this engine serves."""
        hws = np.full((b, 2), s, np.int32)
        if self.ragged:
            return self.run_ragged([np.zeros((s, s, 3), np.uint8)] * b, hws, s)
        return self.run_batch(np.zeros(self.canvas_shape(b, s), np.uint8), hws)

    def warmup(self) -> None:
        """Ready every (canvas, batch) bucket pair before traffic, in the
        reference's three timed phases, each logged on its own line:

        1. one-time costs — the kernel libraries through the build cache and
           the native decoder; paid at engine build (the int8 parity gate
           launches the kernels), logged here;
        2. executables — for every pair, largest first, an eager warm run
           and the CUDA graph's capture (on the CPU: the static-buffer
           executable), once per engine under a lock;
        3. execution — one batch per pair through dispatch and fetch, on the
           calling thread, a graph replay each.

        Every launch thread of the batcher calls this before it takes a
        batch: the first captures, the others find the executables made and
        run phase 3 alone (per-thread first use, measured in its line)."""
        with self._warmup_lock:
            if not self._warmed:
                # the economics peak: a table lookup on the card, a one-time
                # calibration on the CPU that no /metrics scrape should pay
                t0 = time.perf_counter()
                from . import costmodel

                peak = costmodel.backend_peak(self.model_cfg.dtype, self.device)
                log.info("warmup: one-time costs %.2fs at build (kernels %s through the "
                         "build cache, %s decoder), econ peak %s %.2fs",
                         self.warmup_s["one_time"],
                         self.kernels if self.device.type == "cuda" else [],
                         "native" if self.decoder["available"] else "PIL", peak["source"],
                         time.perf_counter() - t0)
                t0 = time.perf_counter()
                pairs = sorted(((s, b) for s in self.cfg.canvas_buckets
                                for b in self.batch_buckets), reverse=True)
                kind = "ragged" if self.ragged else "classic"
                for s, b in pairs:
                    self._exes[(kind, s, b)] = self._capture(kind, s, b)
                if self._graph_pool is not None:
                    torch.cuda.synchronize(self.device)
                    self.pool_bytes = self._graph_pool_bytes()
                self.warmup_s["executables"] = time.perf_counter() - t0
                log.info("warmup: executables %.2fs (%d pairs, %s; graph pool %d bytes, "
                         "static %d bytes)", self.warmup_s["executables"], len(pairs),
                         "CUDA graphs" if self._graph_pool is not None else "no capture",
                         self.pool_bytes, self._static_bytes())
                self._warmed = True
            t0 = time.perf_counter()
            for s in self.cfg.canvas_buckets:
                for b in self.batch_buckets:
                    self._run_blank(b, s)
            dt = time.perf_counter() - t0
            self.warmup_s["execution"].append(dt)
            log.info("warmup: execution pass %.2fs (%d batches, thread %s)", dt,
                     len(self.cfg.canvas_buckets) * len(self.batch_buckets),
                     threading.current_thread().name)

    def _static_bytes(self) -> int:
        """Bytes of the static inputs and the graphs' static outputs."""
        outs = sum(e.out.nbytes for e in self._exes.values() if e.out is not None)
        return sum(t.nbytes for t in self._static.values()) + outs

    def healthcheck(self) -> bool:
        """One-image device round trip."""
        scores, _ = self._run_blank(1, self.cfg.canvas_buckets[0])
        return bool(np.all(np.isfinite(scores)))

    def stats(self) -> dict:
        with self._lock:
            batches, images, h2d, decodes = (self.batches, self.images, self.h2d_bytes,
                                             dict(self.decodes))
            busy_s = self.busy_s
            slabs = {"allocated": self.slabs_allocated,
                     "pooled": sum(len(v) for v in self._pool.values()),
                     "pooled_bytes": sum(slab.buf.nbytes for v in self._pool.values()
                                         for slab in v)}
            graphs = {"captured": sum(e.graph is not None for e in self._exes.values()),
                      "executables": len(self._exes), "replays": self.replays,
                      "eager_batches": self.eager_batches,
                      "capture_s": sum(e.capture_s for e in self._exes.values()),
                      "pool_bytes": self.pool_bytes, "static_bytes": self._static_bytes()}
        # the process's device memory, every engine in it: what a retired
        # version gave back shows here
        cuda = self.device.type == "cuda"
        graphs["memory_allocated"] = torch.cuda.memory_allocated(self.device) if cuda else None
        graphs["memory_reserved"] = torch.cuda.memory_reserved(self.device) if cuda else None
        return {
            "model": self.model_cfg.name,
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
                                "unpack_ragged": unpack_ragged.launches},
            "graphs": graphs,
            "aot_cache": {**aotcache.stats(self.aot_cache), "libraries": self.kernels},
            "warmup_s": {**self.warmup_s, "execution": list(self.warmup_s["execution"])},
        }

    def close(self) -> None:
        """Drop every CUDA graph, static input, weight and staging buffer,
        then give the freed segments back to the device: the caching
        allocator keeps them reserved otherwise, the graph pool's included.
        The segments are returned under ``_CAPTURE_LOCK``, never during
        another engine's capture; ``pool_bytes`` then holds what the pool
        still has (0 unless a live tensor pins a segment). The engine must
        not be used afterwards."""
        with self._lock:
            self._pool.clear()
            self._exes.clear()
            self._static.clear()
            self._device_events.clear()
            self.model = None
            self._preprocess = None
            self._mem_pool = None  # its segments are freeable once its tensors are gone
        if self.device.type == "cuda":
            with _CAPTURE_LOCK:
                torch.cuda.synchronize(self.device)
                torch.cuda.empty_cache()
                if self._graph_pool is not None:
                    self.pool_bytes = self._graph_pool_bytes()
            if self.pool_bytes:
                log.warning("closed engine's graph pool still holds %d bytes", self.pool_bytes)

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
