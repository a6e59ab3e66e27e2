"""Inference engine for one device (counterpart of the JAX package's
``serving/engine.py``).

One batch is one uint8 wire buffer — each image's canvas bytes followed by
a 4-byte big-endian (h, w) trailer — staged in pinned host memory and
copied to the device with one non-blocking transfer. On the device the
serve function runs preprocess → cast to the serving dtype → forward →
softmax → top-k, and only k (score, index) pairs per image come back, in
one packed float32 array. Batches are padded to a batch bucket; padding
rows carry hw = 1×1 and are sliced off on the host.
"""

from __future__ import annotations

import logging
import threading
from dataclasses import dataclass

import numpy as np
import torch

from ..models.adapter import native_converted
from ..ops.image import decode_image, make_preprocess_fn, pad_to_canvas, rgb_to_yuv420_canvas
from ..ops.preprocess_i420 import preprocess_i420
from ..utils.config import ServerConfig
from ..utils.device import resolve_device

log = logging.getLogger("tpu_serve_torch.engine")

_HOLE_TRAILER = (0, 1, 0, 1)  # hw = (1, 1): the resize reads one pixel


@dataclass
class _Staging:
    buf: torch.Tensor  # uint8 [bucket, canvas bytes + 4], pinned on CUDA
    copied: torch.cuda.Event | None = None  # the last H2D out of buf


@dataclass
class BatchHandle:
    out: torch.Tensor  # float32 [bucket, 2k] on the host
    done: torch.cuda.Event | None
    n: int


class InferenceEngine:
    """Serves batches of decoded images on one device (``"cuda"`` unless
    the caller passes ``device="cpu"``)."""

    def __init__(self, cfg: ServerConfig, device: str | torch.device | None = None,
                 seed: int = 0, params_flat: dict[str, np.ndarray] | None = None):
        self.cfg = cfg
        self.model_cfg = cfg.model
        self.device = resolve_device(device)
        self.dtype = torch.float32 if self.model_cfg.dtype == "float32" else torch.bfloat16
        model = native_converted(
            self.model_cfg.name,
            num_classes=self.model_cfg.zoo_classes,
            width=self.model_cfg.zoo_width,
            seed=seed,
            params_flat=params_flat,
        )
        self.model = model.to(self.device, self.dtype, memory_format=torch.channels_last)
        self.num_classes = self.model.backbone.logits.out_features
        self.topk = min(self.model_cfg.topk, self.num_classes)
        h, w = self.model_cfg.input_size
        self._preprocess = make_preprocess_fn(
            h, w, self.model_cfg.preprocess, wire=cfg.wire_format, resize=cfg.resize
        )
        self.batch_buckets = self._default_batch_buckets(cfg.max_batch)
        self.max_batch = self.batch_buckets[-1]
        self._pinned = self.device.type == "cuda"
        self._staging: dict[tuple[int, int], _Staging] = {}
        # Guards the staging buffers and the counters: a buffer is rewritten
        # only after its previous host→device copy has completed.
        self._lock = threading.Lock()
        self.batches = 0
        self.images = 0

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

    def _serve_packed(self, buf: torch.Tensor) -> torch.Tensor:
        """Device side of one batch: packed uint8 [B, bytes + 4] → float32
        [B, 2k] holding k scores then k class indices per image."""
        b, nbytes = buf.shape[0], buf.shape[1] - 4
        if self.cfg.wire_format == "yuv420":
            s = int(round((nbytes * 2 / 3) ** 0.5))
            canvases = buf[:, :nbytes].unflatten(1, (s * 3 // 2, s))
        else:
            s = int(round((nbytes / 3) ** 0.5))
            canvases = buf[:, :nbytes].unflatten(1, (s, s, 3))
        hwb = buf[:, nbytes:].to(torch.int32)
        hws = torch.stack([hwb[:, 0] * 256 + hwb[:, 1], hwb[:, 2] * 256 + hwb[:, 3]], dim=1)
        x = self._preprocess(canvases, hws).to(self.dtype)
        # softmax runs in the serving dtype; top-k reads it in float32
        probs = self.model(x).float()
        scores, idx = torch.topk(probs, self.topk, dim=-1)
        return torch.cat([scores, idx.float()], dim=1)

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
            done = None
            if self.device.type == "cuda":
                st.copied = torch.cuda.Event()
                st.copied.record()
            out = self._serve_packed(dev)
            if self.device.type == "cuda":
                host_out = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
                host_out.copy_(out, non_blocking=True)
                done = torch.cuda.Event()
                done.record()
            else:
                host_out = out
            self.batches += 1
            self.images += n
        return BatchHandle(host_out, done, n)

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

    def warmup(self) -> None:
        """Run one batch at every (canvas, batch) bucket pair, so that no
        request pays a first-use cost (cuDNN plans, allocator growth,
        the kernel build)."""
        for s in self.cfg.canvas_buckets:
            for b in self.batch_buckets:
                self.run_batch(np.zeros(self.canvas_shape(b, s), np.uint8),
                               np.full((b, 2), s, np.int32))
            log.info("warmup canvas=%d: batches %s", s, list(self.batch_buckets))

    def healthcheck(self) -> bool:
        """One-image device round trip."""
        s = self.cfg.canvas_buckets[0]
        scores, _ = self.run_batch(np.zeros(self.canvas_shape(1, s), np.uint8),
                                   np.full((1, 2), s, np.int32))
        return bool(np.all(np.isfinite(scores)))

    def stats(self) -> dict:
        with self._lock:
            batches, images = self.batches, self.images
        return {
            "model": self.model_cfg.name,
            "device": str(self.device),
            "dtype": self.model_cfg.dtype,
            "wire_format": self.cfg.wire_format,
            "resize": self.cfg.resize,
            "batch_buckets": list(self.batch_buckets),
            "canvas_buckets": list(self.cfg.canvas_buckets),
            "batches": batches,
            "images": images,
            "kernel_launches": {"preprocess_i420": preprocess_i420.launches},
        }

    def close(self) -> None:
        """Drop the device weights and the staging buffers; the engine must
        not be used afterwards."""
        with self._lock:
            self._staging.clear()
            self.model = None

    # ------------------------------------------------------------------ host

    def prepare(self, image: np.ndarray) -> tuple[np.ndarray, tuple[int, int]]:
        """Decoded RGB image → (wire canvas, valid (h, w))."""
        canvas, hw = pad_to_canvas(image, self.cfg.canvas_buckets)
        if self.cfg.wire_format == "yuv420":
            canvas = rgb_to_yuv420_canvas(canvas)
        return canvas, hw

    def prepare_bytes(self, data: bytes) -> tuple[np.ndarray, tuple[int, int], tuple[int, int]]:
        """Image bytes → (wire canvas, valid (h, w), original (h, w)).
        Raises ValueError if the bytes are not a decodable image."""
        try:
            image = decode_image(data)
        except (OSError, ValueError) as e:  # PIL: UnidentifiedImageError is an OSError
            raise ValueError(f"cannot decode image: {e}") from e
        canvas, hw = self.prepare(image)
        return canvas, hw, tuple(image.shape[:2])
