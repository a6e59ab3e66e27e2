"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds every hand-written kernel from the sources in this checkout, holds
each against its plain PyTorch version on the card, then drives the main
path — Inception-v3 at full width behind ``POST /predict`` on the yuv420
wire with the preprocess kernel, bf16 — and checks bf16 against a float32
reference on the same images. Each phase prints one JSON line; the line
before the last holds the card's name and power limit, and the last line
is ``{"ok": true, "device": {...}}``. Any failure exits non-zero without
that line. Without a CUDA device it exits with code 2.
"""

from __future__ import annotations

import io
import json
import math
import os
import statistics
import subprocess
import sys
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

MEM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_FLOPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
OUT = 299  # Inception-v3 input side
SEED = 0
# bf16 gate of the reference engine (its _PARITY_TOL["bfloat16"]): top-k
# agreement and max probability delta against float32
BF16_TOPK_AGREEMENT = 0.90
BF16_PROB_DELTA = 0.08
# served top-1 vs the same bf16 computation outside the server
SERVED_TOL = 1e-2
# kernel vs plain float32: same taps and order; the plain version's matmul
# may fuse a multiply-add, so allow a few ulps of the largest value
KERNEL_TOL = {"inception": 1e-5, "zero_one": 1e-5, "raw": 1e-3}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, repeats: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn()`` over ``repeats`` launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def timed(fn) -> float:
    """Host wall time of ``fn()`` in ms."""
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def graph_time_ms(fn, inner: int = 20, replays: int = 10) -> float:
    """Device time of one ``fn()``: ``inner`` calls captured in one CUDA
    graph, replayed ``replays`` times between CUDA events. Host overhead
    of the Python wrapper is left out (``cuda_time_ms`` includes it)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (inner * replays)


def bound_ms(hws: np.ndarray, s: int, out_h: int, out_w: int) -> tuple[float, str]:
    """Least time for one preprocess call on this batch: the canvas bytes
    its taps need (tap rows × tap columns of Y, and of U and V at half
    resolution), the hws table and the float32 output, over the memory
    rate; or ~55 float32 operations per output pixel over the float32
    rate, whichever is larger."""

    def taps(out_size, valid):
        i = np.arange(out_size, dtype=np.float32)
        in_f = np.float32(valid)
        c = (i + np.float32(0.5)) * (in_f / np.float32(out_size)) - np.float32(0.5)
        c = np.clip(c, 0, in_f - 1)
        lo = np.floor(c)
        hi = np.minimum(np.minimum(lo + 1, in_f - 1), s - 1)
        return np.unique(np.concatenate([lo, hi]).astype(np.int64))

    read = hws.size * 4
    for h, w in hws:
        rows, cols = taps(out_h, h), taps(out_w, w)
        read += rows.size * cols.size + 2 * np.unique(rows // 2).size * np.unique(cols // 2).size
    written = len(hws) * out_h * out_w * 3 * 4
    t_bytes = (read + written) / MEM_BYTES_PER_S * 1e3
    t_ops = len(hws) * out_h * out_w * 55 / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def wire_batch(b: int, s: int, gen: torch.Generator) -> torch.Tensor:
    """Random I420 canvases as the engine hands them to the kernel: views
    into one packed wire buffer whose rows end in a 4-byte trailer."""
    nbytes = s * s * 3 // 2
    buf = torch.randint(0, 256, (b, nbytes + 4), generator=gen, dtype=torch.uint8,
                        device="cuda")
    return buf[:, :nbytes].unflatten(1, (s * 3 // 2, s))


def phase_kernel(gen: torch.Generator) -> float:
    """Kernel vs plain version at every batch/canvas/mode; returns the
    largest error."""
    import torch.nn.functional as F

    from tensorflow_web_deploy_tpu_torch.ops.preprocess_i420 import (
        preprocess_i420,
        preprocess_i420_plain,
    )

    rs = np.random.RandomState(SEED)
    worst = 0.0
    for b in (1, 8, 32):
        for s in (256, 512):
            packed = wire_batch(b, s, gen)
            hws_np = rs.randint(1, s + 1, (b, 2)).astype(np.int32)
            hws_np[0] = (s, s)
            if b > 1:
                hws_np[1] = (1, 1)  # a hole row, as padding rows are
            hws = torch.from_numpy(hws_np).cuda()
            for mode in ("inception", "zero_one", "raw"):
                got = preprocess_i420(packed, hws, OUT, OUT, mode)
                ref = preprocess_i420_plain(packed, hws, OUT, OUT, mode)
                torch.cuda.synchronize()
                err = float((got - ref).abs().max())
                if not err <= KERNEL_TOL[mode]:
                    raise AssertionError(
                        f"kernel vs plain at B={b} S={s} {mode}: max abs err {err} "
                        f"> {KERNEL_TOL[mode]}")
                worst = max(worst, err)
                row = {"phase": "kernel", "kernel": "preprocess_i420", "batch": b,
                       "canvas": s, "mode": mode, "max_abs_err": err,
                       "tol": KERNEL_TOL[mode]}
                if mode == "inception":
                    x = torch.rand((b, 3, s, s), generator=gen, device="cuda") * 255
                    row.update(
                        ms=graph_time_ms(lambda: preprocess_i420(packed, hws, OUT, OUT, mode)),
                        call_ms=cuda_time_ms(
                            lambda: preprocess_i420(packed, hws, OUT, OUT, mode)),
                        plain_ms=graph_time_ms(
                            lambda: preprocess_i420_plain(packed, hws, OUT, OUT, mode)),
                        # yardstick only: bilinear resize of a float32 RGB
                        # canvas, not the same function
                        interpolate_ms=graph_time_ms(lambda: F.interpolate(
                            x, (OUT, OUT), mode="bilinear", align_corners=False)),
                    )
                    row["bound_ms"], row["bound_by"] = bound_ms(hws_np, s, OUT, OUT)
                    row["bound_us_at_3.35TBps"] = row["bound_ms"] * 1e3
                emit(row)
    return worst


def make_jpegs(n: int, seed: int) -> list[bytes]:
    """Seeded JPEGs of mixed sizes: smooth colour gradients plus noise,
    sized so that both canvas buckets (256, 512) receive images."""
    from PIL import Image

    rs = np.random.RandomState(seed)
    sizes = [(200, 150), (256, 256), (480, 360), (512, 300), (120, 400), (300, 300),
             (240, 180), (400, 512)]
    out = []
    for i in range(n):
        h, w = sizes[i % len(sizes)]
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        f = rs.uniform(0.5, 3.0, 3)
        img = np.stack([127 + 120 * np.sin(f[0] * yy / h * math.pi + i),
                        127 + 120 * np.cos(f[1] * xx / w * math.pi),
                        127 + 120 * np.sin(f[2] * (xx + yy) / (h + w) * math.pi)], -1)
        img = np.clip(img + rs.normal(0, 12, img.shape), 0, 255).astype(np.uint8)
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, "JPEG", quality=90)
        out.append(buf.getvalue())
    return out


def topk_agreement(ref: np.ndarray, got: np.ndarray, k: int, tol: float) -> float:
    """Margin-aware top-k agreement (the reference engine's bf16 gate): a
    pick counts when the reference scores it within ``tol`` of its own
    k-th best."""
    agree = 0
    for r_row, q_row in zip(ref, got):
        q_top = np.argsort(-q_row)[:k]
        agree += int(np.sum(r_row[q_top] >= np.sort(r_row)[-k] - tol))
    return agree / float(ref.shape[0] * k)


def post(url: str, data: bytes) -> tuple[int, dict, float]:
    t0 = time.perf_counter()
    req = urllib.request.Request(url, data=data, method="POST",
                                 headers={"Content-Type": "image/jpeg"})
    with urllib.request.urlopen(req, timeout=120) as r:
        body = json.loads(r.read())
        return r.status, body, time.perf_counter() - t0


def burst(srv, jpegs: list[bytes]) -> tuple[list, dict]:
    """POST every image at once and stamp each stage on the host clock: the
    client's send and receive, the server's accept (``process_request``,
    which starts the request's thread), the whole ``do_POST`` (body read and
    answer written included), the handler (``App.predict``), decode + pad +
    pack (``prepare_bytes``), ``Batcher.submit`` and each device batch
    (``run_batch``). Each stage's ``sum`` is wall time and ``cpu_sum`` the
    CPU time of its own thread: where wall far exceeds CPU, the thread was
    waiting (for the interpreter lock, a core or the device). Returns the
    answers and a summary in ms from the burst's start."""
    marks: dict[str, list[tuple[float, float, float]]] = {}
    lock = threading.Lock()
    handler_cls = srv.httpd.RequestHandlerClass
    hooks = [(srv.httpd, "process_request", "accept"), (handler_cls, "do_POST", "do_post"),
             (srv.app, "predict", "handler"), (srv.engine, "prepare_bytes", "prepare"),
             (srv.batcher, "submit", "submit"), (srv.engine, "run_batch", "run_batch")]
    originals = [getattr(obj, attr) for obj, attr, _ in hooks]

    def stamped(fn, stage):
        def inner(*args, **kwargs):
            t, cpu = time.perf_counter(), time.thread_time()
            try:
                return fn(*args, **kwargs)
            finally:
                span = (t, time.perf_counter(), time.thread_time() - cpu)
                with lock:
                    marks.setdefault(stage, []).append(span)
        return inner

    for obj, attr, stage in hooks:
        setattr(obj, attr, stamped(getattr(obj, attr), stage))
    try:
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=len(jpegs)) as pool:
            results = list(pool.map(
                lambda d: (time.perf_counter(), post(srv.url + "/predict", d)), jpegs))
        wall = time.perf_counter() - t0
    finally:
        for (obj, attr, _), orig in zip(hooks, originals):
            if isinstance(obj, type):
                setattr(obj, attr, orig)
            else:
                delattr(obj, attr)  # back to the class's method
    ms = lambda t: (t - t0) * 1e3  # noqa: E731

    def summary(spans):
        dur = [(b - a) * 1e3 for a, b, _ in spans]
        return {"n": len(spans), "first_start": ms(min(a for a, _, _ in spans)),
                "last_start": ms(max(a for a, _, _ in spans)),
                "last_end": ms(max(b for _, b, _ in spans)), "sum": sum(dur),
                "cpu_sum": sum(c for _, _, c in spans) * 1e3,
                "p50": float(np.percentile(dur, 50)), "max": max(dur)}

    sends = [s for s, _ in results]
    lat = [r[2] * 1e3 for _, r in results]
    timeline = {"wall_ms": wall * 1e3, "cpus": os.cpu_count(),
                "client_send": {"first": ms(min(sends)), "last": ms(max(sends))},
                "client_latency_ms": {q: float(np.percentile(lat, p)) for q, p in
                                      (("p50", 50), ("p99", 99), ("max", 100))}}
    timeline.update({stage: summary(spans) for stage, spans in marks.items()})
    timeline["batches_ms"] = [(ms(a), ms(b)) for a, b, _ in sorted(marks.get("run_batch", []))]
    return [r for _, r in results], timeline


def phase_main_path(jpegs: list[bytes]) -> dict:
    from tensorflow_web_deploy_tpu_torch.ops.preprocess_i420 import preprocess_i420
    from tensorflow_web_deploy_tpu_torch.server import start_server
    from tensorflow_web_deploy_tpu_torch.utils.config import ServerConfig, model_config

    cfg = ServerConfig(model=model_config("native:inception_v3"), host="127.0.0.1", port=0,
                       canvas_buckets=(256, 512), max_batch=8, wire_format="yuv420",
                       resize="kernel")
    t0 = time.perf_counter()
    srv = start_server(cfg, device="cuda", seed=SEED)
    boot_s = time.perf_counter() - t0
    try:
        # the in-process client's first request builds urllib's opener
        # (an SSL context) in every thread that races into it; take that
        # one-time client cost out of the burst
        urllib.request.urlopen(srv.url + "/healthz", timeout=120).read()
        batches0 = srv.engine.stats()["batches"]
        preprocess_i420.launches = 0
        results, timeline = burst(srv, jpegs)
        launches = preprocess_i420.launches
        batches = srv.engine.stats()["batches"] - batches0
        wall = timeline["wall_ms"] / 1e3
        k = srv.engine.topk
        for status, body, _ in results:
            preds = body.get("predictions", [])
            if status != 200 or len(preds) != k:
                raise AssertionError(f"bad answer: {status} {body}")
            if not all(math.isfinite(p["score"]) and 0 <= p["index"] < 1000 for p in preds):
                raise AssertionError(f"bad predictions: {preds}")
        if launches < batches or batches == 0:
            raise AssertionError(
                f"preprocess kernel launched {launches} times for {batches} batches")
        emit({"phase": "burst_timeline", "burst": 1, **timeline})
        # a second, identical burst: what of the first was one-time cost
        second = burst(srv, jpegs)[1]
        emit({"phase": "burst_timeline", "burst": 2, **second})
        # the same requests one at a time: latency without queueing
        serial = np.array([post(srv.url + "/predict", d)[2] for d in jpegs]) * 1e3
        lat = np.array([r[2] for r in results]) * 1e3
        row = {"phase": "main_path", "model": "native:inception_v3", "width": 1.0,
               "dtype": cfg.model.dtype, "wire": "yuv420", "resize": "kernel",
               "requests": len(jpegs), "batches": batches, "kernel_launches": launches,
               "boot_s": boot_s, "img_per_s": len(jpegs) / wall,
               "p50_ms": float(np.percentile(lat, 50)), "p99_ms": float(np.percentile(lat, 99)),
               "burst2_img_per_s": len(jpegs) / second["wall_ms"] * 1e3,
               "burst2_p50_ms": second["client_latency_ms"]["p50"],
               "burst2_p99_ms": second["client_latency_ms"]["p99"],
               "serial_p50_ms": float(np.percentile(serial, 50)),
               "serial_p99_ms": float(np.percentile(serial, 99))}
        emit(row)
        row["served"] = [(r[1]["predictions"][0]["index"], r[1]["predictions"][0]["score"])
                         for r in results]
        return row
    finally:
        srv.close()


def phase_parity(jpegs: list[bytes], served: list[tuple[int, float]]) -> dict:
    """bf16 kernel path vs a float32 reference (plain preprocess, TF32 off)
    on the main path's images, and the served answers vs the bf16 path."""
    from tensorflow_web_deploy_tpu_torch.models.adapter import native_converted
    from tensorflow_web_deploy_tpu_torch.ops.image import NORMALIZERS, resize_yuv_planes
    from tensorflow_web_deploy_tpu_torch.ops.preprocess_i420 import preprocess_i420
    from tensorflow_web_deploy_tpu_torch.serving.engine import InferenceEngine
    from tensorflow_web_deploy_tpu_torch.utils.config import ServerConfig, model_config

    cfg = ServerConfig(model=model_config("native:inception_v3"), canvas_buckets=(256, 512),
                       max_batch=8, wire_format="yuv420", resize="kernel", warmup=False)
    eng = InferenceEngine(cfg, device="cuda", seed=SEED)
    ref_model = native_converted("inception_v3", seed=SEED).to(
        "cuda", memory_format=torch.channels_last)
    probs_bf16, probs_f32, top1 = [], [], []
    with torch.inference_mode():
        for data in jpegs:
            canvas, hw, _ = eng.prepare_bytes(data)
            packed = torch.from_numpy(canvas[None]).cuda()
            hws = torch.tensor([hw], dtype=torch.int32, device="cuda")
            x = preprocess_i420(packed, hws, OUT, OUT, "inception")
            p = eng.model(x.to(torch.bfloat16)).float()
            xr = NORMALIZERS["inception"](resize_yuv_planes(packed, hws, OUT, OUT))
            probs_bf16.append(p.cpu().numpy()[0])
            probs_f32.append(ref_model(xr).cpu().numpy()[0])
    pb, pf = np.stack(probs_bf16), np.stack(probs_f32)
    if not (np.isfinite(pb).all() and pb.shape == (len(jpegs), 1000)):
        raise AssertionError("bf16 probabilities are not finite [n, 1000]")
    k = eng.topk
    agree = topk_agreement(pf, pb, k, BF16_PROB_DELTA)
    delta = float(np.abs(pb - pf).max())
    # The server batched these images with others; another batch size may
    # take another cuDNN algorithm, so the served top-1 must be a top-1 of
    # the bf16 path up to bf16 rounding, not bit-identical to it.
    idx = np.array([i for i, _ in served])
    score = np.array([sc for _, sc in served])
    own = pb[np.arange(len(idx)), idx]
    served_ok = bool(np.all(own >= pb.max(1) - SERVED_TOL) and np.all(np.abs(own - score) <= SERVED_TOL))
    row = {"phase": "parity", "images": len(jpegs), "topk": k, "topk_agreement": agree,
           "max_prob_delta": delta, "tol_topk": BF16_TOPK_AGREEMENT,
           "tol_prob": BF16_PROB_DELTA, "served_top1_matches_bf16": float(np.mean(idx == pb.argmax(1))),
           "served_ok": served_ok,
           "f32_top1_matches_bf16": float(np.mean(pb.argmax(1) == pf.argmax(1))),
           "tf32": [torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32]}
    emit(row)
    eng.close()
    if agree < BF16_TOPK_AGREEMENT or delta > BF16_PROB_DELTA:
        raise AssertionError(f"bf16 gate failed: {row}")
    if not served_ok:
        raise AssertionError(f"served answers differ from the bf16 path: {row}")
    return row


def phase_breakdown(jpegs: list[bytes], batch: int = 8) -> dict:
    """Device time per stage of one batch of 8 main-path images in the
    512 canvas: preprocess kernel, forward (bf16), top-k; and the kernel's
    row for the kernels line, measured on these real inputs."""
    from tensorflow_web_deploy_tpu_torch.ops.preprocess_i420 import (
        preprocess_i420,
        preprocess_i420_plain,
    )
    from tensorflow_web_deploy_tpu_torch.serving.engine import InferenceEngine
    from tensorflow_web_deploy_tpu_torch.utils.config import ServerConfig, model_config

    cfg = ServerConfig(model=model_config("native:inception_v3"), canvas_buckets=(256, 512),
                       max_batch=8, wire_format="yuv420", resize="kernel", warmup=False)
    eng = InferenceEngine(cfg, device="cuda", seed=SEED)
    t0 = time.perf_counter()
    prepared = [eng.prepare_bytes(d) for d in jpegs]
    prepare_ms = (time.perf_counter() - t0) / len(jpegs) * 1e3
    big = [(c, hw) for c, hw, _ in prepared if c.shape[-1] == 512][:batch]
    if len(big) < batch:
        raise AssertionError(f"only {len(big)} images in the 512 canvas")
    packed = torch.from_numpy(np.stack([c for c, _ in big])).cuda()
    hws_np = np.array([hw for _, hw in big], np.int32)
    hws = torch.from_numpy(hws_np).cuda()
    with torch.inference_mode():
        x = preprocess_i420(packed, hws, OUT, OUT, "inception")
        xb = x.to(torch.bfloat16)
        probs = eng.model(xb).float()
        err = float((x - preprocess_i420_plain(packed, hws, OUT, OUT, "inception")).abs().max())
        row = {"phase": "breakdown", "batch": len(big), "canvas": 512,
               "kernel_ms": graph_time_ms(lambda: preprocess_i420(packed, hws, OUT, OUT)),
               "kernel_call_ms": cuda_time_ms(lambda: preprocess_i420(packed, hws, OUT, OUT)),
               "plain_ms": graph_time_ms(
                   lambda: preprocess_i420_plain(packed, hws, OUT, OUT)),
               "forward_bf16_ms": cuda_time_ms(lambda: eng.model(xb), repeats=10),
               "topk_ms": graph_time_ms(lambda: torch.topk(probs, 5, dim=-1)),
               "max_abs_err": err,
               # host side: decode + pad + I420 pack per image, and one
               # whole engine batch (stage, H2D, serve, D2H) with its wait
               "host_prepare_ms_per_image": prepare_ms,
               "run_batch_ms": statistics.median(
                   timed(lambda: eng.run_batch(np.stack([c for c, _ in big]), hws_np))
                   for _ in range(10))}
    row["bound_ms"], row["bound_by"] = bound_ms(hws_np, 512, OUT, OUT)
    eng.close()
    emit(row)
    return row


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from tensorflow_web_deploy_tpu_torch.ops import _build

    # float32 means float32 in every reference below
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = nvidia_smi()
    emit({"phase": "device", "nvidia_smi": smi, "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    t0 = time.perf_counter()
    _build.load("preprocess_i420")
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": _build.library_path("preprocess_i420").name})

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    kern_err = phase_kernel(gen)
    jpegs = make_jpegs(24, SEED)
    main_path = phase_main_path(jpegs)
    phase_parity(jpegs, main_path["served"])
    bd = phase_breakdown(jpegs)
    emit({"kernels": [{
        "name": "preprocess_i420",
        "route": "cuda",
        "source": "tensorflow_web_deploy_tpu_torch/csrc/preprocess_i420.cu",
        "replaces": "tensorflow_web_deploy_tpu/ops/pallas_preprocess.py:108",
        "launches": main_path["kernel_launches"],
        "max_abs_err": max(kern_err, bd["max_abs_err"]),
        "ms": bd["kernel_ms"],
        "plain_ms": bd["plain_ms"],
        "bound_ms": bd["bound_ms"],
        "bound_by": bd["bound_by"],
        "library_ms": None,
    }]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
