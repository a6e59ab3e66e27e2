"""Device economics (counterpart of the JAX package's
``serving/costmodel.py``): analytic FLOPs and memory bytes per (model,
canvas bucket, batch bucket), the card's peak, and the roofline
attribution behind ``/stats → economics`` and the ``model_mfu`` /
``model_roofline_bound_fraction`` gauges of ``/metrics``.

1. **Analytic layer walk** (:func:`model_cost`): each zoo architecture's
   conv / depthwise / dense layers re-walked from the same tables the
   models are built from, in pure Python, so that the counts are the
   reference's to the integer (Inception-v3: 5.71 G MACs; MobileNetV2:
   300.8 M MACs, 3.504 M parameters). FLOPs = 2 × MACs.
2. **Traffic model**: per image, activations written and read once each,
   parameters read once per batch, the uint8 input. Arithmetic intensity =
   FLOPs / bytes; the ridge is ``peak_flops / peak_bw``.
3. **The card's peak** (:func:`backend_peak`): on CUDA, a spec-sheet table
   keyed by the longest prefix of ``torch.cuda.get_device_name()``
   (:func:`cuda_peak`). The float32 row is the CUDA cores' rate: the
   engine turns TF32 off for float32 (and int8) engines, so a float32 conv
   does not run on the tensor cores — 66.9 against 989.4 TFLOP/s on an
   H100 SXM, not the TPU's half. int8 dequantizes to bf16 and takes the
   bf16 row (:func:`compute_dtype`). An unknown card reports
   ``cuda-unknown:<name>`` and no MFU. On the CPU the peak is calibrated
   once per compute dtype (a torch matmul, a streaming add).

The measured half comes from the engine's :meth:`econ_stats`: rows and
device seconds per (canvas, batch bucket). On the card the port's device
seconds are the batch's own compute interval between two CUDA events on
the compute stream, not the host's dispatch → fetch wall (which, with
several batches in flight, counts the wait behind the others).
"""

from __future__ import annotations

import math
import threading
import time

# Dense TFLOP/s (bf16 on the tensor cores; float32 on the CUDA cores, TF32
# off) and memory GB/s per card, keyed by the prefix of
# torch.cuda.get_device_name() (public spec sheets; the longest prefix wins).
CUDA_PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bfloat16": 989.4, "float32": 66.9, "hbm_gbps": 3350.0},
    "NVIDIA H100 PCIe": {"bfloat16": 756.5, "float32": 51.2, "hbm_gbps": 2000.0},
}


def compute_dtype(dtype: str) -> str:
    """Serving dtype → the dtype the arithmetic runs in: int8 dequantizes
    to bf16 on the fly, so it shares bf16's peak."""
    return "float32" if dtype == "float32" else "bfloat16"


def _table_lookup(table: dict, device_kind: str):
    best = None
    for prefix, peak in table.items():
        if device_kind.startswith(prefix) and (best is None or len(prefix) > len(best[0])):
            best = (prefix, peak)
    return best[1] if best else None


def cuda_peak(device_name: str, dtype: str = "bfloat16") -> dict:
    """The table's peak for one card and serving dtype: ``{"flops_per_chip",
    "bytes_per_s_per_chip", "source"}``; zeros and ``cuda-unknown:<name>``
    for a card the table lacks."""
    cdtype = compute_dtype(dtype)
    row = _table_lookup(CUDA_PEAKS, device_name)
    if row is None:
        return {"flops_per_chip": 0.0, "bytes_per_s_per_chip": 0.0,
                "source": f"cuda-unknown:{device_name}"}
    return {"flops_per_chip": row[cdtype] * 1e12,
            "bytes_per_s_per_chip": row["hbm_gbps"] * 1e9,
            "source": f"cuda-table:{device_name}:{cdtype}"}


# ------------------------------------------------------------ layer tape


class _Tape:
    """Shape-flow accumulator for one forward pass at batch 1: the live
    activation shape (h, w, c), MACs, parameter scalars (kernels, BN scale
    and bias, dense bias) and activation elements written."""

    __slots__ = ("h", "w", "c", "macs", "params", "act_elems")

    def __init__(self, h: int, w: int, c: int = 3):
        self.h, self.w, self.c = h, w, c
        self.macs = 0
        self.params = 0
        self.act_elems = 0

    @staticmethod
    def _dim(d: int, k: int, s: int, padding: str) -> int:
        if padding == "SAME":
            return -(-d // s)
        return (d - k) // s + 1

    def _out_hw(self, kernel, strides, padding):
        return (self._dim(self.h, kernel[0], strides[0], padding),
                self._dim(self.w, kernel[1], strides[1], padding))

    def conv(self, features: int, kernel=(1, 1), strides=(1, 1), padding: str = "SAME",
             bn: bool = True, bias: bool = False):
        oh, ow = self._out_hw(kernel, strides, padding)
        self.macs += oh * ow * features * kernel[0] * kernel[1] * self.c
        self.params += kernel[0] * kernel[1] * self.c * features
        if bn:
            self.params += 2 * features
        if bias:
            self.params += features
        self.h, self.w, self.c = oh, ow, features
        self.act_elems += oh * ow * features

    def dwconv(self, kernel=(3, 3), strides=(1, 1), padding: str = "SAME", bn: bool = True):
        oh, ow = self._out_hw(kernel, strides, padding)
        self.macs += oh * ow * self.c * kernel[0] * kernel[1]
        self.params += kernel[0] * kernel[1] * self.c
        if bn:
            self.params += 2 * self.c
        self.h, self.w = oh, ow
        self.act_elems += oh * ow * self.c

    def pool(self, kernel=(3, 3), strides=(2, 2), padding: str = "VALID"):
        self.h, self.w = self._out_hw(kernel, strides, padding)
        self.act_elems += self.h * self.w * self.c

    def gap(self):
        self.h = self.w = 1
        self.act_elems += self.c

    def dense(self, features: int):
        self.macs += self.c * features
        self.params += self.c * features + features
        self.c = features
        self.act_elems += features

    def branch(self) -> _Tape:
        return _Tape(self.h, self.w, self.c)

    def _absorb(self, other: _Tape):
        self.macs += other.macs
        self.params += other.params
        self.act_elems += other.act_elems

    def concat(self, *branches: _Tape):
        assert all((b.h, b.w) == (branches[0].h, branches[0].w) for b in branches), \
            "concat branches must agree spatially"
        for b in branches:
            self._absorb(b)
        self.h, self.w = branches[0].h, branches[0].w
        self.c = sum(b.c for b in branches)

    def add(self, other: _Tape):
        assert (self.h, self.w, self.c) == (other.h, other.w, other.c)
        self._absorb(other)


# ---------------------------------------------------------- arch walkers


def _inverted_residual(t: _Tape, features: int, stride: int, expansion: int = 6):
    if expansion != 1:
        t.conv(t.c * expansion, (1, 1))
    t.dwconv((3, 3), (stride, stride))
    t.conv(features, (1, 1))


def _walk_mobilenet_v2(t: _Tape, width: float, num_classes: int):
    from ..models.common import scale_ch
    from ..models.mobilenet_v2 import _BLOCKS

    w = lambda c: scale_ch(c, width)  # noqa: E731
    t.conv(w(32), (3, 3), (2, 2))
    for exp, c, n, s in _BLOCKS:
        for j in range(n):
            _inverted_residual(t, w(c), s if j == 0 else 1, exp)
    last = max(1280, scale_ch(1280, width)) if width > 1.0 else 1280
    t.conv(last, (1, 1))
    t.gap()
    t.dense(num_classes)


def _walk_resnet50(t: _Tape, width: float, num_classes: int):
    from ..models.common import scale_ch
    from ..models.resnet50 import _STAGES

    w = lambda c: scale_ch(c, width)  # noqa: E731
    t.conv(w(64), (7, 7), (2, 2))
    t.pool((3, 3), (2, 2), "SAME")
    for c, n, s in _STAGES:
        for j in range(n):
            feats, stride = w(c), (s if j == 0 else 1)
            out_ch = feats * 4
            shortcut = t.branch()
            if t.c != out_ch or stride != 1:
                shortcut.conv(out_ch, (1, 1), (stride, stride))
            t.conv(feats, (1, 1))
            t.conv(feats, (3, 3), (stride, stride))
            t.conv(out_ch, (1, 1))
            t.add(shortcut)
    t.gap()
    t.dense(num_classes)


def _walk_inception_v3(t: _Tape, width: float, num_classes: int):
    from ..models.common import scale_ch

    w = lambda c: scale_ch(c, width)  # noqa: E731
    t.conv(w(32), (3, 3), (2, 2), "VALID")
    t.conv(w(32), (3, 3), padding="VALID")
    t.conv(w(64), (3, 3))
    t.pool((3, 3), (2, 2), "VALID")
    t.conv(w(80), (1, 1), padding="VALID")
    t.conv(w(192), (3, 3), padding="VALID")
    t.pool((3, 3), (2, 2), "VALID")

    def inception_a(pool_features):
        b1, b5, b3, bp = t.branch(), t.branch(), t.branch(), t.branch()
        b1.conv(w(64), (1, 1))
        b5.conv(w(48), (1, 1)); b5.conv(w(64), (5, 5))  # noqa: E702
        b3.conv(w(64), (1, 1)); b3.conv(w(96), (3, 3)); b3.conv(w(96), (3, 3))  # noqa: E702
        bp.pool((3, 3), (1, 1), "SAME"); bp.conv(w(pool_features), (1, 1))  # noqa: E702
        t.concat(b1, b5, b3, bp)

    def reduction_a():
        b3, bd, bp = t.branch(), t.branch(), t.branch()
        b3.conv(w(384), (3, 3), (2, 2), "VALID")
        bd.conv(w(64), (1, 1)); bd.conv(w(96), (3, 3))  # noqa: E702
        bd.conv(w(96), (3, 3), (2, 2), "VALID")
        bp.pool((3, 3), (2, 2), "VALID")
        t.concat(b3, bd, bp)

    def inception_b(c7_base):
        c7 = w(c7_base)
        b1, b7, bd, bp = t.branch(), t.branch(), t.branch(), t.branch()
        b1.conv(w(192), (1, 1))
        b7.conv(c7, (1, 1)); b7.conv(c7, (1, 7)); b7.conv(w(192), (7, 1))  # noqa: E702
        bd.conv(c7, (1, 1)); bd.conv(c7, (7, 1)); bd.conv(c7, (1, 7))  # noqa: E702
        bd.conv(c7, (7, 1)); bd.conv(w(192), (1, 7))  # noqa: E702
        bp.pool((3, 3), (1, 1), "SAME"); bp.conv(w(192), (1, 1))  # noqa: E702
        t.concat(b1, b7, bd, bp)

    def reduction_b():
        b3, b7, bp = t.branch(), t.branch(), t.branch()
        b3.conv(w(192), (1, 1)); b3.conv(w(320), (3, 3), (2, 2), "VALID")  # noqa: E702
        b7.conv(w(192), (1, 1)); b7.conv(w(192), (1, 7))  # noqa: E702
        b7.conv(w(192), (7, 1)); b7.conv(w(192), (3, 3), (2, 2), "VALID")  # noqa: E702
        bp.pool((3, 3), (2, 2), "VALID")
        t.concat(b3, b7, bp)

    def inception_c():
        b1, b3, bd, bp = t.branch(), t.branch(), t.branch(), t.branch()
        b1.conv(w(320), (1, 1))
        b3.conv(w(384), (1, 1))
        b3a, b3b = b3.branch(), b3.branch()
        b3a.conv(w(384), (1, 3)); b3b.conv(w(384), (3, 1))  # noqa: E702
        b3.concat(b3a, b3b)
        bd.conv(w(448), (1, 1)); bd.conv(w(384), (3, 3))  # noqa: E702
        bda, bdb = bd.branch(), bd.branch()
        bda.conv(w(384), (1, 3)); bdb.conv(w(384), (3, 1))  # noqa: E702
        bd.concat(bda, bdb)
        bp.pool((3, 3), (1, 1), "SAME"); bp.conv(w(192), (1, 1))  # noqa: E702
        t.concat(b1, b3, bd, bp)

    inception_a(32); inception_a(64); inception_a(64)  # noqa: E702
    reduction_a()
    inception_b(128); inception_b(160); inception_b(160); inception_b(192)  # noqa: E702
    reduction_b()
    inception_c(); inception_c()  # noqa: E702
    t.gap()
    t.dense(num_classes)


def _walk_ssd_mobilenet(t: _Tape, width: float, num_classes: int):
    from ..models.common import scale_ch
    from ..models.ssd_mobilenet import ASPECT_RATIOS

    w = lambda c: scale_ch(c, width)  # noqa: E731
    n_anchor = len(ASPECT_RATIOS)
    t.conv(w(16), (3, 3), (2, 2))
    for c, s in [(24, 2), (32, 2), (64, 2), (64, 1)]:
        _inverted_residual(t, w(c), s)
    _inverted_residual(t, w(128), 2)  # feat1, stride 32
    f1 = t.branch()
    _inverted_residual(t, w(256), 2)  # feat2, stride 64
    # heads (plain convs with bias, no BN) on both feature maps
    for feat in (f1, t):
        loc, cls = feat.branch(), feat.branch()
        loc.conv(n_anchor * 4, (3, 3), bn=False, bias=True)
        cls.conv(n_anchor * (num_classes + 1), (3, 3), bn=False, bias=True)
        t._absorb(loc)
        t._absorb(cls)


_WALKERS = {
    "mobilenet_v2": _walk_mobilenet_v2,
    "resnet50": _walk_resnet50,
    "inception_v3": _walk_inception_v3,
    "ssd_mobilenet": _walk_ssd_mobilenet,
}


# -------------------------------------------------------------- model cost

_cost_cache: dict[tuple, dict | None] = {}
_cost_lock = threading.Lock()


def model_cost(model_cfg) -> dict | None:
    """Analytic per-image cost of one model config, or None when the
    architecture has no walker: ``{"flops_per_image", "macs_per_image",
    "param_count", "param_bytes", "act_bytes_per_image", "dtype",
    "dtype_bytes"}``. Activations move at the compute width (float32 4 B,
    bf16 and int8 2 B), parameters at the storage width (int8 1 B)."""
    name = model_cfg.name
    walker = _WALKERS.get(name)
    if walker is None:
        return None
    width = float(getattr(model_cfg, "zoo_width", 1.0) or 1.0)
    from .. import models as zoo

    try:
        default_classes = zoo.get(name).num_classes
    except KeyError:
        default_classes = 1000
    classes = int(getattr(model_cfg, "zoo_classes", None) or default_classes)
    h, w = model_cfg.input_size
    dtype = getattr(model_cfg, "dtype", "bfloat16") or "bfloat16"
    dtype_bytes = 4 if dtype == "float32" else 2
    param_dtype_bytes = 1 if dtype == "int8" else dtype_bytes
    key = (name, width, classes, h, w, dtype)
    with _cost_lock:
        if key in _cost_cache:
            return _cost_cache[key]
    t = _Tape(int(h), int(w), 3)
    walker(t, width, classes)
    cost = {
        "macs_per_image": t.macs,
        "flops_per_image": 2 * t.macs,
        "param_count": t.params,
        "param_bytes": t.params * param_dtype_bytes,
        "act_bytes_per_image": 2 * t.act_elems * dtype_bytes,
        "dtype": dtype,
        "dtype_bytes": dtype_bytes,
    }
    with _cost_lock:
        _cost_cache[key] = cost
    return cost


def preprocess_flops(canvas_s: int, input_hw, wire: str = "rgb") -> int:
    """FLOPs of the separable matmul resize from one canvas bucket to the
    model input (the upper bound of the gather and kernel resizes; the
    ragged unpack is data movement)."""
    h, w = int(input_hw[0]), int(input_hw[1])
    s = int(canvas_s)
    c = 3
    macs = h * s * s * c + h * w * s * c
    return 2 * macs


def bytes_per_image(cost: dict, canvas_s: int, batch: int, wire: str = "rgb") -> int:
    """Memory traffic for one image at ``batch``: activations (touched
    twice), parameters over the batch, the uint8 input (the ragged wire:
    the arena read plus the canvas written and read, 2 × canvas)."""
    canvas_px = canvas_s * canvas_s
    if wire == "yuv420":
        in_bytes = (canvas_px * 3) // 2
    elif wire == "ragged":
        in_bytes = 2 * canvas_px * 3
    else:
        in_bytes = canvas_px * 3
    return int(cost["act_bytes_per_image"] + cost["param_bytes"] / max(1, batch) + in_bytes)


# ------------------------------------------------------------ backend peak

_peak_cache: dict[tuple, dict] = {}


def _calibrate_cpu(dtype: str = "bfloat16") -> dict:
    """One-shot achievable peak of the host: a torch matmul at the compute
    dtype (FLOP/s) and a streaming add (bytes/s). Runs outside the cost
    lock; a concurrent duplicate costs a fraction of a second once."""
    import torch

    t_cal = time.perf_counter()
    n = 768
    mm_dtype = torch.float32 if dtype == "float32" else torch.bfloat16
    gen = torch.Generator().manual_seed(0)
    a = torch.rand(n, n, generator=gen).to(mm_dtype)
    with torch.inference_mode():
        a @ a
        reps = 4
        t0 = time.perf_counter()
        for _ in range(reps):
            a @ a
        flops = 2 * n**3 * reps / max(1e-9, time.perf_counter() - t0)
        m = 1 << 24  # 16 M float32 = 64 MB a stream
        v = torch.zeros(m)
        v + 1.0
        t0 = time.perf_counter()
        for _ in range(reps):
            v + 1.0
        bw = 2 * 4 * m * reps / max(1e-9, time.perf_counter() - t0)  # read + write
    return {"flops_per_chip": flops, "bytes_per_s_per_chip": bw, "source": "cpu-calibrated",
            "calibration_s": round(time.perf_counter() - t_cal, 3)}


def backend_peak(dtype: str = "bfloat16", device=None, n_dev: int = 1) -> dict:
    """Peak FLOP/s and memory bytes/s of one ``device`` (``"cuda"`` unless
    given) at one serving dtype, with its ``source``: the card's table row
    (:func:`cuda_peak`), or the host calibrated once per compute dtype and
    divided by the ``n_dev`` CPU entries of the mesh, which share the
    host's cores (so MFU summed over replicas stays ≤ 1, the reference's
    rule)."""
    import torch

    device = torch.device(device if device is not None else "cuda")
    cdtype = compute_dtype(dtype)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    n_dev = 1 if device.type == "cuda" else max(1, int(n_dev))
    cache_key = (device.type, name, cdtype, n_dev)
    with _cost_lock:
        cached = _peak_cache.get(cache_key)
    if cached is not None:
        return cached
    if device.type == "cuda":
        peak = cuda_peak(name, cdtype)
    else:
        host = _calibrate_cpu(cdtype)
        peak = {"flops_per_chip": host["flops_per_chip"] / n_dev,
                "bytes_per_s_per_chip": host["bytes_per_s_per_chip"] / n_dev,
                "source": f"{host['source']}:{cdtype}:/{n_dev}dev",
                "calibration_s": host["calibration_s"]}
    with _cost_lock:
        _peak_cache[cache_key] = peak
    return peak


# ------------------------------------------------------------- economics


def bucket_economics(cost: dict | None, canvas_s: int, batch_bucket: int, rows: int,
                     rows_dispatched: int, device_s: float, peak: dict, devices: int,
                     input_hw, wire: str = "rgb", rows_tight: float = 0.0) -> dict:
    """Roofline attribution of one (canvas bucket, batch bucket) cell:
    achieved FLOP/s over the measured device seconds, MFU against the peak,
    arithmetic intensity, the binding ceiling and the fraction of it
    reached, and the padded-rows fraction (on the ragged wire from the
    tight rows: wire padding)."""
    if wire == "ragged" and rows_dispatched:
        pad_rows = 1.0 - min(rows_tight, rows_dispatched) / rows_dispatched
    elif rows_dispatched:
        pad_rows = 1.0 - rows / rows_dispatched
    else:
        pad_rows = 0.0
    out = {
        "canvas": int(canvas_s),
        "batch_bucket": int(batch_bucket),
        "rows": int(rows),
        "rows_dispatched": int(rows_dispatched),
        "device_s": round(device_s, 4),
        "padded_rows_fraction": round(pad_rows, 4),
    }
    if wire == "ragged":
        out["rows_tight"] = round(rows_tight, 3)
    if cost is None or device_s <= 0 or rows <= 0:
        return out
    flops_img = cost["flops_per_image"] + preprocess_flops(canvas_s, input_hw, wire)
    bpi = bytes_per_image(cost, canvas_s, batch_bucket, wire)
    ai = flops_img / max(1, bpi)
    peak_flops = peak["flops_per_chip"] * max(1, devices)
    peak_bw = peak["bytes_per_s_per_chip"] * max(1, devices)
    achieved = rows * flops_img / device_s
    dispatched_rate = rows_dispatched * flops_img / device_s
    attainable = min(peak_flops, ai * peak_bw) if peak_bw else peak_flops
    ridge = (peak_flops / peak_bw) if peak_bw else math.inf
    out.update(
        flops_per_image=int(flops_img),
        hbm_bytes_per_image=int(bpi),
        achieved_flops=int(achieved),
        mfu=round(achieved / peak_flops, 5) if peak_flops else None,
        mfu_dispatched=round(dispatched_rate / peak_flops, 5) if peak_flops else None,
        arithmetic_intensity=round(ai, 2),
        ridge_intensity=round(ridge, 2) if ridge != math.inf else None,
        bound="compute" if ai >= ridge else "bandwidth",
        roofline_bound_fraction=round(achieved / attainable, 5) if attainable else None,
    )
    return out


def economics_snapshot(engine, model_cfg) -> dict | None:
    """The ``/stats → economics`` block of one model version: per
    (canvas, batch bucket) roofline attribution from the engine's measured
    counters, the model's cost card and the peak; None for an engine
    without econ counters (mocks)."""
    econ_stats = getattr(engine, "econ_stats", None)
    if econ_stats is None:
        return None
    cost = model_cost(model_cfg)
    peak = backend_peak(getattr(model_cfg, "dtype", "bfloat16") or "bfloat16",
                        getattr(engine, "device", None), len(getattr(engine, "mesh", ())) or 1)
    wire = getattr(engine.cfg, "wire_format", "rgb")
    if getattr(engine, "ragged", False):
        wire = "ragged"
    input_hw = model_cfg.input_size
    replicas = []
    agg_rows = agg_disp = 0
    agg_tight = 0.0
    agg_device_s = 0.0
    agg_useful_flops = 0.0
    for rep in econ_stats():
        cells = [
            bucket_economics(cost, c["canvas"], c["batch_bucket"], c["rows"],
                             c["rows_dispatched"], c["device_s"], peak, rep["devices"],
                             input_hw, wire, rows_tight=c.get("rows_tight", 0.0))
            for c in rep["buckets"]
        ]
        for cell in cells:
            agg_rows += cell["rows"]
            agg_disp += cell["rows_dispatched"]
            agg_tight += cell.get("rows_tight", 0.0)
            agg_device_s += cell["device_s"]
            if cell.get("achieved_flops"):
                agg_useful_flops += cell["achieved_flops"] * cell["device_s"]
        replicas.append({"replica": rep["replica"], "devices": rep["devices"],
                         "buckets": cells})
    out = {
        "peak": {
            "flops_per_chip": int(peak["flops_per_chip"]),
            "hbm_bytes_per_s_per_chip": int(peak["bytes_per_s_per_chip"]),
            "source": peak["source"],
        },
        "model_cost": ({
            "flops_per_image": cost["flops_per_image"],
            "macs_per_image": cost["macs_per_image"],
            "param_count": cost["param_count"],
            "param_bytes": cost["param_bytes"],
            "act_bytes_per_image": cost["act_bytes_per_image"],
            "dtype": cost["dtype"],
        } if cost else None),
        "dtype": getattr(model_cfg, "dtype", "bfloat16") or "bfloat16",
        "wire": wire,
        "replicas": replicas,
        "rows_total": agg_rows,
        "rows_dispatched_total": agg_disp,
        "device_s_total": round(agg_device_s, 4),
        "padded_rows_fraction": round(
            (1.0 - min(agg_tight, agg_disp) / agg_disp) if wire == "ragged"
            else (1.0 - agg_rows / agg_disp), 4) if agg_disp else 0.0,
    }
    if wire == "ragged":
        out["rows_tight_total"] = round(agg_tight, 3)
    n_chips = sum(r["devices"] for r in replicas) or 1
    if cost and agg_device_s > 0 and peak["flops_per_chip"]:
        mean_rate = agg_useful_flops / agg_device_s
        out["mfu"] = round(mean_rate / (peak["flops_per_chip"] * n_chips), 5)
    return out
