"""Inference engine for one device (counterpart of the JAX package's
``serving/engine.py``).

One batch is one uint8 wire buffer — each image's canvas bytes followed by
a 4-byte big-endian (h, w) trailer — staged in pinned host memory and
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
(``ops/image.py::unpack_ragged``) and the same serve path follows.
JPEGs are decoded by the native libjpeg decoder (``native/``), PIL takes
the rest.

The int8 tier keeps its kernels int8 on the device and dequantizes them
inside every forward, computing in bf16 (``ops/quant.py``); before it
serves, the golden parity gate holds it against the unfused float32 model
on the same parameters, and a failing gate raises.
"""

from __future__ import annotations

import logging
import threading
from dataclasses import dataclass

import numpy as np
import torch

from .. import native
from ..models.adapter import native_converted
from ..ops import quant
from ..ops.fused_dw import fused_dw
from ..ops.image import (
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

log = logging.getLogger("tpu_serve_torch.engine")

_HOLE_TRAILER = (0, 1, 0, 1)  # hw = (1, 1): the resize reads one pixel


@dataclass
class _Staging:
    buf: torch.Tensor  # uint8 [bucket, canvas bytes + 4], pinned on CUDA
    copied: torch.cuda.Event | None = None  # the last H2D out of buf


class RaggedSlab:
    """Pinned host arena of one canvas side for the ragged wire: a bump
    cursor over ``capacity`` canvases' worth of bytes, where each image
    takes exactly h·w·3 bytes at any byte offset, and an int32 meta table of
    ``(byte_offset, h, w, valid)`` per slot. A slot allocated but never
    committed (:meth:`write_hw`) stays a hole. :meth:`stage` places the
    meta table after the shipped prefix, so one copy carries both."""

    def __init__(self, s: int, capacity: int, pinned: bool):
        self.s = s
        self.capacity = capacity
        self.row_bytes = s * s * 3
        # the arena, ≤ 15 bytes of alignment, the meta table at its largest
        self.buf = torch.zeros(capacity * self.row_bytes + 16 + 16 * capacity,
                               dtype=torch.uint8, pin_memory=pinned)
        self.host = self.buf.numpy()
        self.meta = np.zeros((capacity, 4), np.int32)
        self.used = self.slots = 0
        self.copied: torch.cuda.Event | None = None  # the last H2D out of buf

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


class InferenceEngine:
    """Serves batches of decoded images on one device (``"cuda"`` unless
    the caller passes ``device="cpu"``)."""

    # Gate tolerances per serving dtype, the reference's _PARITY_TOL:
    # ``prob`` bounds the max probability delta and is the top-k agreement
    # margin; ``topk`` is the least agreeing fraction.
    PARITY_TOL = {
        "int8": {"prob": 0.15, "topk": 0.90},
        "bfloat16": {"prob": 0.08, "topk": 0.90},
    }

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
        # builds the native decoder (a build fault raises here, not per request)
        self.decoder = native.status()
        self.quantized = self.model_cfg.dtype == "int8"
        # int8 computes in bf16
        self.dtype = torch.float32 if self.model_cfg.dtype == "float32" else torch.bfloat16
        self.fused_dw = self.model_cfg.fuse_depthwise
        self._seed, self._params_flat = seed, params_flat
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
        # yuv420 + kernel: the kernel takes the wire buffer itself
        # (preprocess_packed); the other paths decode the trailers first
        self._wire_kernel = cfg.wire_format == "yuv420" and cfg.resize == "kernel"
        h, w = self.model_cfg.input_size
        self._preprocess = None if self._wire_kernel else make_preprocess_fn(
            h, w, self.model_cfg.preprocess, wire=cfg.wire_format, resize=cfg.resize,
            out_dtype=self.dtype,
        )
        self.batch_buckets = self._default_batch_buckets(cfg.max_batch)
        self.max_batch = self.batch_buckets[-1]
        self._pinned = self.device.type == "cuda"
        self._staging: dict[tuple[int, int], _Staging] = {}
        # canvas side → free ragged slabs; a slab is out of the pool from
        # acquire_ragged to its dispatch (or release_ragged)
        self._ragged_pool: dict[int, list[RaggedSlab]] = {}
        # Guards the staging buffers, the pool and the counters: a buffer is
        # rewritten only after its previous host→device copy has completed.
        self._lock = threading.Lock()
        self.batches = 0
        self.images = 0
        self.h2d_bytes = 0
        self.decodes = {"native": 0, "pil": 0}

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

    def _serve_ragged(self, dev: torch.Tensor, meta_off: int, meta_host: np.ndarray,
                      s: int) -> torch.Tensor:
        """Device side of one ragged batch: the shipped arena prefix and meta
        table → unpack → preprocess → :meth:`_head`."""
        meta = dev[meta_off:].view(torch.int32).view(-1, 4)
        canvases, hws = unpack_ragged(dev[:meta_off], meta, s, meta_host=meta_host)
        return self._head(self._preprocess(canvases, hws))

    def _staging_for(self, s: int, bucket: int) -> _Staging:
        key = (s, bucket)
        st = self._staging.get(key)
        if st is None:
            buf = torch.zeros(self.packed_shape(bucket, s), dtype=torch.uint8,
                              pin_memory=self._pinned)
            st = self._staging[key] = _Staging(buf)
        return st

    def dispatch_batch(self, canvases: np.ndarray, hws: np.ndarray) -> BatchHandle:
        """Stage a stacked batch (n ≤ the top batch bucket), ship it in one
        transfer and enqueue the serve function; returns without waiting
        for the device."""
        n = canvases.shape[0]
        s = canvases.shape[-1] if self.cfg.wire_format == "yuv420" else canvases.shape[1]
        bucket = self.pick_batch_bucket(n)
        if n > bucket:
            raise ValueError(f"batch of {n} exceeds the top batch bucket {bucket}")
        trailer = np.asarray(hws).astype(">u2").view(np.uint8).reshape(n, 4)
        with self._lock, torch.inference_mode():
            st = self._staging_for(s, bucket)
            if st.copied is not None:
                st.copied.synchronize()
            host = st.buf.numpy()
            nbytes = host.shape[1] - 4
            host[:n, :nbytes] = canvases.reshape(n, nbytes)
            host[:n, nbytes:] = trailer
            host[n:, nbytes:] = _HOLE_TRAILER
            dev = st.buf.to(self.device, non_blocking=True)
            st.copied = self._record()
            handle = self._fetchable(self._serve_packed(dev), n)
            self.batches += 1
            self.images += n
            self.h2d_bytes += st.buf.numel()
        return handle

    def _record(self) -> torch.cuda.Event | None:
        """An event after the work enqueued so far (None on the CPU)."""
        if self.device.type != "cuda":
            return None
        ev = torch.cuda.Event()
        ev.record()
        return ev

    def _fetchable(self, out: torch.Tensor, n: int) -> BatchHandle:
        """Start the output's non-blocking copy into pinned host memory."""
        if self.device.type != "cuda":
            return BatchHandle(out, None, n)
        host_out = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        host_out.copy_(out, non_blocking=True)
        return BatchHandle(host_out, self._record(), n)

    # ----------------------------------------------------------- ragged wire

    def acquire_ragged(self, s: int) -> RaggedSlab:
        """An empty ragged slab of canvas side ``s`` for one batch, out of the
        pool: its previous copy to the device has completed."""
        with self._lock:
            free = self._ragged_pool.get(s)
            slab = free.pop() if free else None
        if slab is None:
            slab = RaggedSlab(s, self.max_batch, self._pinned)
        if slab.copied is not None:
            slab.copied.synchronize()
        slab.reset()
        return slab

    def release_ragged(self, slab: RaggedSlab) -> None:
        """Return a slab that was never dispatched."""
        with self._lock:
            self._ragged_pool.setdefault(slab.s, []).append(slab)

    def dispatch_ragged(self, slab: RaggedSlab, n: int) -> BatchHandle:
        """Ship a filled ragged slab (``n`` slots, holes included) and enqueue
        unpack → serve; returns without waiting for the device. The arena's
        used prefix and the meta table go in one non-blocking copy, and the
        slab returns to the pool, to be reused after that copy completes."""
        bucket = self.pick_batch_bucket(n)
        if n > bucket:
            raise ValueError(f"batch of {n} exceeds the top batch bucket {bucket}")
        if slab.slots > n:
            raise ValueError(f"ragged slab holds {slab.slots} slots, more than its batch of {n}")
        nbytes, meta_off = slab.stage(bucket)
        with self._lock, torch.inference_mode():
            dev = slab.buf[:nbytes].to(self.device, non_blocking=True)
            slab.copied = self._record()
            handle = self._fetchable(
                self._serve_ragged(dev, meta_off, slab.meta[:bucket], slab.s), n)
            self.batches += 1
            self.images += n
            self.h2d_bytes += nbytes
            self._ragged_pool.setdefault(slab.s, []).append(slab)
        return handle

    def run_ragged(self, images: list[np.ndarray], hws: np.ndarray,
                   s: int) -> tuple[np.ndarray, np.ndarray]:
        """Tight images (uint8 [h, w, 3] each, valid sizes ``hws``) of canvas
        side ``s`` through the ragged wire: one memcpy each into a slab,
        batches above the top bucket in chunks, all dispatched before the
        first fetch."""
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
                self.release_ragged(slab)
                raise
        parts = [self.fetch_outputs(h) for h in handles]
        return tuple(np.concatenate(p) for p in zip(*parts))

    def fetch_outputs(self, handle: BatchHandle) -> tuple[np.ndarray, np.ndarray]:
        """Wait for a dispatched batch; returns (scores float32 [n, k],
        indices int32 [n, k]) for the real rows."""
        if handle.done is not None:
            handle.done.synchronize()
        packed = handle.out.numpy()[: handle.n]
        k = self.topk
        return packed[:, :k].copy(), packed[:, k:].astype(np.int32)

    def run_batch(self, canvases: np.ndarray, hws: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Dispatch + fetch; batches above the top bucket go in chunks, all
        dispatched before the first fetch."""
        top = self.batch_buckets[-1]
        handles = [
            self.dispatch_batch(canvases[i : i + top], hws[i : i + top])
            for i in range(0, canvases.shape[0], top)
        ]
        parts = [self.fetch_outputs(h) for h in handles]
        return tuple(np.concatenate(p) for p in zip(*parts))

    def _run_blank(self, b: int, s: int) -> tuple[np.ndarray, np.ndarray]:
        """``b`` black full-canvas images through the wire this engine serves."""
        hws = np.full((b, 2), s, np.int32)
        if self.ragged:
            return self.run_ragged([np.zeros((s, s, 3), np.uint8)] * b, hws, s)
        return self.run_batch(np.zeros(self.canvas_shape(b, s), np.uint8), hws)

    def warmup(self) -> None:
        """Run one batch at every (canvas, batch) bucket pair, so that no
        request pays a first-use cost (cuDNN plans, allocator growth, pinned
        slabs, the kernel build)."""
        for s in self.cfg.canvas_buckets:
            for b in self.batch_buckets:
                self._run_blank(b, s)
            log.info("warmup canvas=%d: batches %s", s, list(self.batch_buckets))

    def healthcheck(self) -> bool:
        """One-image device round trip."""
        scores, _ = self._run_blank(1, self.cfg.canvas_buckets[0])
        return bool(np.all(np.isfinite(scores)))

    def stats(self) -> dict:
        with self._lock:
            batches, images, h2d, decodes = (self.batches, self.images, self.h2d_bytes,
                                             dict(self.decodes))
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
            "batch_buckets": list(self.batch_buckets),
            "canvas_buckets": list(self.cfg.canvas_buckets),
            "batches": batches,
            "images": images,
            "kernel_launches": {"preprocess_i420": preprocess_i420.launches,
                                "fused_dw": fused_dw.launches},
        }

    def close(self) -> None:
        """Drop the device weights and the staging buffers; the engine must
        not be used afterwards."""
        with self._lock:
            self._staging.clear()
            self._ragged_pool.clear()
            self.model = None

    # ------------------------------------------------------------------ host

    def prepare(self, image: np.ndarray) -> tuple[np.ndarray, tuple[int, int]]:
        """Decoded RGB image → (wire canvas, valid (h, w))."""
        canvas, hw = pad_to_canvas(image, self.cfg.canvas_buckets)
        if self.cfg.wire_format == "yuv420":
            canvas = rgb_to_yuv420_canvas(canvas)
        return canvas, hw

    def _count(self, decoder: str) -> None:
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
            self._count("native")
            return got
        try:
            got = native.decode_pil(data, buckets, wire)
        except (OSError, ValueError) as e:  # PIL: UnidentifiedImageError is an OSError
            raise ValueError(f"cannot decode image: {e}") from e
        self._count("pil")
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
                self._count("native")
                return tight.reshape(hw[0], hw[1], 3), hw, s, orig
        try:
            image = decode_image(data)
        except (OSError, ValueError) as e:
            raise ValueError(f"cannot decode image: {e}") from e
        tight, hw, s = fit_to_bucket(image, buckets)
        self._count("pil")
        return tight, hw, s, tuple(image.shape[:2])
