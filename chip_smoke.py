"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds every hand-written kernel from the sources in this checkout (one
nvcc per source, all started together), holds each against its plain
PyTorch version on the card at the shapes the main paths give it, then
builds the native libjpeg decoder, and drives four main paths at full
width behind ``POST /predict``, every JPEG decoded by libjpeg. Two on the
yuv420 wire with the preprocess kernel:

- Inception-v3 in bf16, checked against a float32 reference;
- MobileNetV2 in the int8 tier, all 17 depthwise cells (13 stride 1, 4
  stride 2) on the fused depthwise kernel, gated at build by the engine's
  parity check and checked against the unfused float32 model on the same
  images.

And two on the ragged rgb wire, the server's defaults: each batch ships
its images tight in one pinned arena and the device rebuilds the canvases:

- Inception-v3 in bf16 with the matmul resize (the server with no flags);
- MobileNetV2 in the int8 tier with the gather resize, the fused
  depthwise kernel in all 17 cells.

Before them, ``native_decode`` times the decoder against the PIL chain it
replaced, ``ragged_unpack`` holds the device unpack bit for bit against the
host's padded canvases (holes included) and times it, and after them
``ragged_vs_classic`` holds each ragged engine's answers against its own
classic rgb wire on the same images, and ``default_server`` boots the
server with no model or wire flags in a process of its own, sends it three
JPEGs and stops it.

The preprocess kernel is checked through both of its entries (the
``[B, 2]`` table and the wire buffer whose trailers it reads itself) in
float32 and bf16, and both main paths feed their models its bf16 output
directly: one launch for the whole preprocess stage, which the
``preprocess_stage`` lines show with the profiler.

Each phase prints one JSON line; the line before the last holds the card's
name and power limit, and the last line is ``{"ok": true, "device":
{...}}``. Any failure exits non-zero without that line. Without a CUDA
device it exits with code 2.

    python3 chip_smoke.py --sweep-fused-dw
    python3 chip_smoke.py --sweep-preprocess

instead build the kernels, print nvcc's register report for one kernel,
check it against its plain version at every shape, and time it under
every launch shape that fits, beside the launch rule's choice; they print
no ``ok`` line.
"""

from __future__ import annotations

import io
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from dataclasses import replace

import numpy as np
import torch

MEM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_FLOPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
OUT = 299  # Inception-v3 input side
SEED = 0
KERNELS = ("preprocess_i420", "fused_dw")
# served top-1 vs the same bf16 computation outside the server
SERVED_TOL = 1e-2
# kernel vs plain float32: same taps and order; the plain version's matmul
# may fuse a multiply-add, so allow a few ulps of the largest value
KERNEL_TOL = {"inception": 1e-5, "zero_one": 1e-5, "raw": 1e-3}
# preprocess kernel checks: batches and canvas sides
PP_BATCHES = (1, 8, 32)
PP_SIDES = (256, 512, 1024, 2048)
# fused depthwise kernel vs plain: the same float32 operations in the same
# order and one rounding, so every cell must be bit-identical
DW_BATCHES = (1, 8, 32)
# full-width MobileNetV2 has 17 depthwise cells, 13 of them stride 1; all
# 17 are fused: the fused kernel's launches per batch on its main path
DW_CELLS = 17
DW_STRIDE1_CELLS = 13
# canvas buckets of every main path
BUCKETS = (256, 512)
# the ragged wire's main paths: (model, dtype, resize); rgb wire, ragged on
RAGGED_PATHS = (("inception_v3", "bfloat16", "matmul"), ("mobilenet_v2", "int8", "gather"))
# ragged vs classic on one engine: the bf16 parity gate's probability bound
RAGGED_PROB_TOL = 0.08


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


def host_us(fn, calls: int = 200) -> float:
    """Host time of one ``fn()`` in µs: ``calls`` calls enqueued back to back
    on the host clock. A call that enqueues less device time than it takes
    on the host never waits for the device, so this is the wrapper's cost."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    spent = time.perf_counter() - t0
    torch.cuda.synchronize()
    return spent / calls * 1e6


def bound_ms(hws: np.ndarray, s: int, out_h: int, out_w: int, elt: int,
             meta_bytes: int) -> tuple[float, str]:
    """Least time for one preprocess call on this batch: the canvas bytes
    its taps need (tap rows × tap columns of Y, and of U and V at half
    resolution), ``meta_bytes`` per image for the valid size (8 from a
    table, 4 from a trailer) and the output at ``elt`` bytes an element,
    over the memory rate; or ~55 float32 operations per output pixel over
    the float32 rate, whichever is larger."""
    from tensorflow_web_deploy_tpu_torch.ops.preprocess_i420 import axis_taps

    read = len(hws) * meta_bytes
    for h, w in hws:
        (rlo, rhi, _), (clo, chi, _) = axis_taps(out_h, h, s), axis_taps(out_w, w, s)
        rows, cols = np.unique(np.concatenate([rlo, rhi])), np.unique(np.concatenate([clo, chi]))
        read += rows.size * cols.size + 2 * np.unique(rows // 2).size * np.unique(cols // 2).size
    written = len(hws) * out_h * out_w * 3 * elt
    t_bytes = (read + written) / MEM_BYTES_PER_S * 1e3
    t_ops = len(hws) * out_h * out_w * 55 / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def wire_buffer(canvases, hws: np.ndarray) -> torch.Tensor:
    """The engine's wire buffer on the card: each row an I420 canvas, then
    its valid (h, w) as big-endian u16 (serving/engine.py::dispatch_batch).
    ``canvases`` [B, 3S/2, S] uint8, numpy or on the card."""
    b = len(hws)
    canvases = torch.as_tensor(canvases, device="cuda").reshape(b, -1)
    trailer = np.asarray(hws).astype(">u2").view(np.uint8).reshape(b, 4)
    return torch.cat([canvases, torch.from_numpy(trailer).cuda()], dim=1)


def bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Distance in bf16 ulps between two bf16 tensors (±0 equal)."""
    def order(x):
        bits = x.view(torch.int16).to(torch.int32)
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)
    return (order(a) - order(b)).abs()


def bf16_vs_plain(got: torch.Tensor, ref: torch.Tensor, mode: str) -> dict:
    """The kernel's bf16 output against the plain float32 result: elements
    that differ from it rounded to bf16, their largest distance in bf16
    ulps (overall, and where |ref| ≥ 2^-8: near zero inception's x/127.5 - 1
    cancels and float32 results an ulp apart span many of bf16's finer
    ulps), and the largest error against the float32 value, which must stay
    within the float32 tolerance plus bf16's rounding (2^-8 relative)."""
    ulps = bf16_ulps(got, ref.to(torch.bfloat16))
    away = ref.abs() >= 2 ** -8
    err = (got.float() - ref).abs()
    if not bool((err <= KERNEL_TOL[mode] + 2 ** -8 * ref.abs()).all()):
        raise AssertionError(f"bf16 kernel vs plain ({mode}): max abs err {float(err.max())}")
    return {"bf16_differ": int((ulps > 0).sum()), "bf16_max_ulps": int(ulps.max()),
            "bf16_max_ulps_away_from_zero": int(ulps[away].max()) if away.any() else 0,
            "bf16_max_abs_err": float(err.max())}


def wire_batch(b: int, s: int, hws: np.ndarray, gen: torch.Generator) -> torch.Tensor:
    """Random I420 canvases in a wire buffer as the engine ships them, each
    row ending in its (h, w) trailer. Rows are 1.5·S² + 4 bytes, so image
    k starts at 4k mod 16: every alignment class occurs from B = 4 on."""
    nbytes = s * s * 3 // 2
    return wire_buffer(torch.randint(0, 256, (b, nbytes), generator=gen, dtype=torch.uint8,
                                     device="cuda"), hws)


def preprocess_before(buf: torch.Tensor, s: int, out: int) -> torch.Tensor:
    """The preprocess stage as the engine ran it before the kernel read the
    wire and stored bf16: trailer decode (ATen), the kernel through the
    table entry in float32, a cast. A timed yardstick only."""
    from tensorflow_web_deploy_tpu_torch.ops.preprocess_i420 import (
        decode_trailer,
        preprocess_i420,
        wire_canvases,
    )

    return preprocess_i420(wire_canvases(buf, s), decode_trailer(buf), out, out).to(
        torch.bfloat16)


def phase_kernel(gen: torch.Generator) -> float:
    """Kernel vs plain version at every batch/canvas/mode, through both
    entries on views into one wire buffer, in float32 and bf16; the two
    entries must agree bit for bit. At inception mode each (batch, canvas)
    is timed: both entries, the stage as it ran before, the plain version,
    the wrapper's host time. Returns the largest float32 error."""
    import torch.nn.functional as F

    from tensorflow_web_deploy_tpu_torch.ops.preprocess_i420 import (
        preprocess_i420,
        preprocess_i420_plain,
        preprocess_i420_wire,
        wire_canvases,
    )

    rs = np.random.RandomState(SEED)
    worst = 0.0
    bf16 = torch.bfloat16
    for b in PP_BATCHES:
        for s in PP_SIDES:
            hws_np = rs.randint(1, s + 1, (b, 2)).astype(np.int32)
            hws_np[0] = (s, s)
            if b > 1:
                hws_np[1] = (1, 1)  # a hole row, as padding rows are
            buf = wire_batch(b, s, hws_np, gen)
            packed, hws = wire_canvases(buf, s), torch.from_numpy(hws_np).cuda()
            for mode in ("inception", "zero_one", "raw"):
                ref = preprocess_i420_plain(packed, hws, OUT, OUT, mode)
                row = {"phase": "kernel", "kernel": "preprocess_i420", "batch": b,
                       "canvas": s, "mode": mode, "tol": KERNEL_TOL[mode]}
                for dtype in (torch.float32, bf16):
                    got = preprocess_i420(packed, hws, OUT, OUT, mode, dtype)
                    wire = preprocess_i420_wire(buf, s, OUT, OUT, mode, dtype)
                    torch.cuda.synchronize()
                    if not torch.equal(got, wire):
                        raise AssertionError(f"wire vs table entry at B={b} S={s} {mode} {dtype}")
                    if dtype == bf16:
                        row.update(bf16_vs_plain(got, ref, mode))
                        continue
                    err = float((got - ref).abs().max())
                    if not err <= KERNEL_TOL[mode]:
                        raise AssertionError(
                            f"kernel vs plain at B={b} S={s} {mode}: max abs err {err} "
                            f"> {KERNEL_TOL[mode]}")
                    worst = max(worst, err)
                    row["max_abs_err"] = err
                if mode == "inception":
                    x = torch.rand((b, 3, s, s), generator=gen, device="cuda") * 255
                    row.update(
                        ms=graph_time_ms(lambda: preprocess_i420_wire(buf, s, OUT, OUT, mode, bf16)),
                        ms_f32=graph_time_ms(lambda: preprocess_i420(packed, hws, OUT, OUT, mode)),
                        before_ms=graph_time_ms(lambda: preprocess_before(buf, s, OUT)),
                        call_ms=cuda_time_ms(
                            lambda: preprocess_i420_wire(buf, s, OUT, OUT, mode, bf16)),
                        host_us=host_us(lambda: preprocess_i420_wire(buf, s, OUT, OUT, mode, bf16)),
                        plain_ms=graph_time_ms(
                            lambda: preprocess_i420_plain(packed, hws, OUT, OUT, mode, bf16),
                            inner=3, replays=3),
                        # yardstick only: bilinear resize of a float32 RGB
                        # canvas, not the same function
                        interpolate_ms=graph_time_ms(lambda: F.interpolate(
                            x, (OUT, OUT), mode="bilinear", align_corners=False)),
                    )
                    row["bound_ms"], row["bound_by"] = bound_ms(hws_np, s, OUT, OUT, 2, 4)
                    row["bound_ms_f32"] = bound_ms(hws_np, s, OUT, OUT, 4, 8)[0]
                    row["share_of_bound"] = row["bound_ms"] / row["ms"]
                    del x
                emit(row)
            del buf, packed, ref
    # trailers the engine never sends: both entries clamp them to [1, S]
    s, odd = 512, np.array([[0, 0], [512 + 9, 3], [70, 65535], [300, 200]], np.int32)
    buf = wire_batch(len(odd), s, odd, gen)
    clamped = torch.from_numpy(np.clip(odd, 1, s)).cuda()
    got = preprocess_i420_wire(buf, s, OUT, OUT)
    table = preprocess_i420(wire_canvases(buf, s), torch.from_numpy(odd).cuda(), OUT, OUT)
    ref = preprocess_i420_plain(wire_canvases(buf, s), clamped, OUT, OUT)
    err = float((got - ref).abs().max())
    if not torch.equal(got, table) or err > KERNEL_TOL["inception"]:
        raise AssertionError(f"out-of-range trailers: wire vs table vs clamped plain, err {err}")
    emit({"phase": "kernel_clamp", "trailers": odd.tolist(), "max_abs_err": err})
    return worst


def dw_bound_ms(b: int, c: int, h: int, w: int, oh: int, ow: int, elt: int, kk: int,
                relu6: bool) -> tuple[float, str]:
    """Least time for one fused depthwise call: the input and output
    activations (``elt`` bytes each), the float32 taps and bias over the
    memory rate; or kk multiplies + kk adds, the bias add and the clamp per
    output element over the float32 rate, whichever is larger."""
    t_bytes = (b * c * (h * w + oh * ow) * elt + (kk + 1) * c * 4) / MEM_BYTES_PER_S * 1e3
    t_ops = b * c * oh * ow * (2 * kk + 1 + 2 * relu6) / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def dw_layer_shapes() -> list[dict]:
    """Every depthwise cell of full-width MobileNetV2 at 224×224: its block,
    input [C, H, W], stride and the reference's "SAME" pads, recorded by
    forward hooks on one image."""
    from tensorflow_web_deploy_tpu_torch.models.adapter import native_converted
    from tensorflow_web_deploy_tpu_torch.models.common import DepthwiseConvBN
    from tensorflow_web_deploy_tpu_torch.ops.depthwise import resolve_pads

    model = native_converted("mobilenet_v2", seed=SEED).cuda()
    shapes, hooks = [], []

    def record(mod, args, name):
        _, c, h, w = args[0].shape
        pads = resolve_pads(mod.padding, (h, w), mod.kernel, (mod.stride,) * 2)
        shapes.append({"block": name.split(".")[1], "c": c, "h": h, "w": w,
                       "stride": mod.stride, "pads": pads})

    for name, m in model.named_modules():
        if isinstance(m, DepthwiseConvBN):
            hooks.append(m.register_forward_pre_hook(
                lambda mod, args, name=name: record(mod, args, name)))
    with torch.inference_mode():
        model(torch.zeros((1, 224, 224, 3), device="cuda"))
    for h in hooks:
        h.remove()
    if len(shapes) != DW_CELLS or sum(s["stride"] == 1 for s in shapes) != DW_STRIDE1_CELLS:
        raise AssertionError(f"MobileNetV2 depthwise cells: {shapes}")
    return shapes


def dw_odd(layer: dict) -> dict:
    """A stride-2 layer with H and W made odd: the reference pads it (1, 1)
    where the even map pads (0, 1)."""
    from tensorflow_web_deploy_tpu_torch.ops.depthwise import same_pads

    h, w = layer["h"] + 1, layer["w"] + 1
    return {**layer, "block": layer["block"] + "_odd", "h": h, "w": w,
            "pads": (same_pads(h, 3, 2), same_pads(w, 3, 2))}


def dw_inputs(gen: torch.Generator, layer: dict, b: int, dtype) -> tuple:
    x = (torch.randn((b, layer["c"], layer["h"], layer["w"]), generator=gen, device="cuda")
         * 3).to(dtype).contiguous(memory_format=torch.channels_last)
    taps = torch.randn((9, layer["c"]), generator=gen, device="cuda")
    bias = torch.randn((1, layer["c"]), generator=gen, device="cuda")
    return x, taps, bias


def dw_check(gen: torch.Generator, layers: list[dict]) -> dict:
    """Kernel vs plain version at every layer × B∈{1, 8, 32} × {float32,
    bf16} × relu6 on/off: each cell must be bit-identical (the same float32
    operations in the same order, one rounding)."""
    from tensorflow_web_deploy_tpu_torch.ops.fused_dw import fused_dw, fused_dw_plain

    worst, cells = 0.0, 0
    for layer in layers:
        for b in DW_BATCHES:
            for dtype in (torch.float32, torch.bfloat16):
                x, taps, bias = dw_inputs(gen, layer, b, dtype)
                for relu6 in (True, False):
                    args = (x, taps, bias, 3, 3, layer["pads"], relu6, layer["stride"])
                    got, ref = fused_dw(*args), fused_dw_plain(*args)
                    torch.cuda.synchronize()
                    if not got.is_contiguous(memory_format=torch.channels_last):
                        raise AssertionError("fused_dw output is not channels_last")
                    err = float((got.float() - ref.float()).abs().max())
                    worst = max(worst, err)
                    cells += 1
                    if not torch.equal(got, ref):
                        raise AssertionError(
                            f"fused_dw vs plain at {layer} B={b} {dtype} relu6={relu6}: "
                            f"max abs err {err}")
    return {"max_abs_err": worst, "compared": cells}


def f32_chain(x, taps, bias, pads, stride):
    """The stride-2 fused cell as the port served it before the kernel took
    stride 2: cast in, pad, grouped conv + bias in float32 (cuDNN), clamp,
    cast out. A timed yardstick only."""
    import torch.nn.functional as F

    (pt, pb), (pl, pr) = pads
    c = x.shape[1]
    y = F.conv2d(F.pad(x.float(), (pl, pr, pt, pb)), taps.t().reshape(c, 1, 3, 3), bias[0],
                 stride=stride, groups=c)
    return y.clamp(0.0, 6.0).to(x.dtype)


def phase_fused_dw_kernel(gen: torch.Generator, shapes: list[dict]) -> dict:
    """Kernel vs plain version at all 17 depthwise shapes of the main path
    (13 stride 1, 4 stride 2) and the 4 stride-2 shapes made odd, × B∈{1,
    8, 32} × {float32, bf16} × relu6 on/off, bit for bit; then at B=8 in
    bf16 with relu6 (the main path's cells) the kernel's, the plain
    version's and the yardsticks' device times beside the bound, per layer
    with its launch shape, and for the stacks of the 13 stride-1 layers and
    of all 17 in one CUDA graph each."""
    import torch.nn.functional as F

    from tensorflow_web_deploy_tpu_torch.ops.fused_dw import fused_dw, fused_dw_plain, kernel_shape

    odd = [dw_odd(s) for s in shapes if s["stride"] == 2]
    checked = dw_check(gen, shapes + odd)
    emit({"phase": "fused_dw_check", "layers": len(shapes), "odd_layers": len(odd),
          "batches": list(DW_BATCHES), **checked, "bit_identical": True})
    timed_inputs = []
    for layer in shapes:
        x, taps, bias = dw_inputs(gen, layer, 8, torch.bfloat16)
        c = layer["c"]
        # the yardstick's bf16 weight [C, 1, 3, 3] and bias
        wt = taps.t().reshape(c, 1, 3, 3).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        timed_inputs.append((layer, x, taps, bias, wt, bias[0].to(torch.bfloat16)))

    def kernel(layer, x, taps, bias, *_):
        return fused_dw(x, taps, bias, 3, 3, layer["pads"], True, layer["stride"])

    def plain(layer, x, taps, bias, *_):
        return fused_dw_plain(x, taps, bias, 3, 3, layer["pads"], True, layer["stride"])

    def cudnn(layer, x, taps, bias, wt, bt):
        # yardstick only: conv + bias without the clamp, not this function;
        # at stride 2 on the reference's pads
        if layer["stride"] == 1:
            return F.conv2d(x, wt, bt, padding=1, groups=x.shape[1])
        (pt, pb), (pl, pr) = layer["pads"]
        return F.conv2d(F.pad(x, (pl, pr, pt, pb)), wt, bt, stride=2, groups=x.shape[1])

    rows = []
    for args in timed_inputs:
        layer, x = args[0], args[1]
        c, h, w, s = layer["c"], layer["h"], layer["w"], layer["stride"]
        oh, ow = -(-h // s), -(-w // s)
        shape = kernel_shape(x, 3, 3, layer["pads"], s)
        row = {"phase": "fused_dw_layer", **layer, "batch": 8, "dtype": "bfloat16",
               "launch": shape._asdict(), "tile": shape.tile(), "blocks": shape.blocks(8, c, oh, ow),
               "threads_per_block": shape.threads, "smem_bytes": shape.smem(s, 2),
               "ms": graph_time_ms(lambda: kernel(*args)),
               "call_ms": cuda_time_ms(lambda: kernel(*args)),
               "plain_ms": graph_time_ms(lambda: plain(*args)),
               "cudnn_ms": graph_time_ms(lambda: cudnn(*args))}
        if s == 2:
            row["f32_chain_ms"] = graph_time_ms(
                lambda: f32_chain(x, args[2], args[3], layer["pads"], 2))
        row["bound_ms"], row["bound_by"] = dw_bound_ms(8, c, h, w, oh, ow, 2, 9, True)
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        emit(row)
        rows.append(row)

    def stack(fn, subset):
        return lambda: [fn(*args) for args in subset]

    out = {}
    for name, subset, sub_rows in (
            ("stride1", [a for a in timed_inputs if a[0]["stride"] == 1],
             [r for r in rows if r["stride"] == 1]),
            ("all", timed_inputs, rows)):
        st = {"phase": "fused_dw_stack", "stack": name, "layers": len(sub_rows), "batch": 8,
              "dtype": "bfloat16", "ms": graph_time_ms(stack(kernel, subset)),
              "plain_ms": graph_time_ms(stack(plain, subset)),
              "cudnn_ms": graph_time_ms(stack(cudnn, subset)),
              "bound_ms": sum(r["bound_ms"] for r in sub_rows),
              "bound_by": ("bytes" if all(r["bound_by"] == "bytes" for r in sub_rows)
                           else "operations"),
              "sum_of_layer_ms": sum(r["ms"] for r in sub_rows),
              "elements_per_image": sum(r["c"] * r["h"] * r["w"] for r in sub_rows)}
        st["share_of_bound"] = st["bound_ms"] / st["ms"]
        st["vs_cudnn"] = st["ms"] / st["cudnn_ms"]
        emit(st)
        out[name] = st
    # the floor under a small layer: the kernel on one 8-channel pixel, and
    # the smallest ATen kernel, each one launch per CUDA graph node
    one = dw_inputs(gen, {"c": 8, "h": 1, "w": 1}, 1, torch.bfloat16)
    tiny = torch.zeros(8, device="cuda")
    emit({"phase": "fused_dw_floor",
          "ms": graph_time_ms(lambda: fused_dw(*one, 3, 3, ((1, 1), (1, 1)))),
          "aten_fill_ms": graph_time_ms(lambda: tiny.fill_(1.0))})
    slower = [r["block"] for r in rows if r["ms"] >= r["cudnn_ms"]]
    slower += [r["block"] for r in rows if r["stride"] == 2 and r["ms"] >= r["f32_chain_ms"]]
    emit({"phase": "fused_dw_vs_yardsticks", "slower_than_a_yardstick": slower,
          "stride1_stack_vs_cudnn": out["stride1"]["vs_cudnn"]})
    return {**out["all"], **checked, "stride1": out["stride1"]}


def sweep_fused_dw(gen: torch.Generator, shapes: list[dict]) -> None:
    """Device time of the kernel at every layer (B=8, bf16, relu6) under
    each launch shape that fits the kernel's limits, beside the launch
    rule's own; each launch held bit for bit against the plain version."""
    from tensorflow_web_deploy_tpu_torch.ops import fused_dw as fd

    for layer in shapes:
        x, taps, bias = dw_inputs(gen, layer, 8, torch.bfloat16)
        c, s, pads = layer["c"], layer["stride"], layer["pads"]
        oh, ow = -(-layer["h"] // s), -(-layer["w"] // s)
        ref = fd.fused_dw_plain(x, taps, bias, 3, 3, pads, True, s)
        rule = fd.kernel_shape(x, 3, 3, pads, s)
        results = []
        for groups in [d for d in range(1, fd.MAX_GROUPS + 1) if (c // 8) % d == 0]:
            for run in sorted({1, 2, 3, 4, 7, 8, 14} & set(range(1, ow + 1))):
                for nx in sorted({-(-ow // run), -(-ow // (2 * run))}):
                    for th in (1, 2, 3, 4, 7, 8, 14, 16):
                        shape = fd.LaunchShape(groups, nx, th, run)
                        if (shape.threads > fd.MAX_THREADS or th > oh or nx * run > ow + run
                                or shape.smem(s, 2) > 232448):
                            continue
                        got = fd._launch(x, taps, bias, pads, True, s, shape)
                        if not torch.equal(got, ref):
                            raise AssertionError(f"{layer} {shape}: differs from plain")
                        ms = graph_time_ms(lambda: fd._launch(x, taps, bias, pads, True, s, shape),
                                           inner=10, replays=5)
                        results.append((ms, shape))
        results.sort(key=lambda r: r[0])
        rule_ms = graph_time_ms(lambda: fd._launch(x, taps, bias, pads, True, s, rule))
        emit({"phase": "fused_dw_sweep", "block": layer["block"], "c": c, "h": layer["h"],
              "stride": s, "tried": len(results), "rule": rule._asdict(), "rule_ms": rule_ms,
              "best": [{"ms": ms, **sh._asdict(), "blocks": sh.blocks(8, c, oh, ow)}
                       for ms, sh in results[:6]],
              "all": [[*sh, ms] for ms, sh in results]})


def ptxas_report(name: str) -> str:
    """nvcc -Xptxas -v on csrc/<name>.cu: registers, shared memory and
    spills of each kernel instantiation."""
    import tempfile

    from tensorflow_web_deploy_tpu_torch.ops import _build

    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
                               os.path.join(tmp, "lib.so"), str(_build.CSRC / f"{name}.cu")],
                              capture_output=True, text=True, timeout=300)
    return proc.stdout + proc.stderr


def sweep_preprocess(gen: torch.Generator) -> None:
    """Device time of the preprocess kernel (wire entry, bf16, inception)
    at B∈{1, 8, 32} × S∈{512, 2048} × out∈{299, 224} on valid sizes drawn
    from [S/2, S], under every launch shape that fits (rows per band ×
    threads), beside the launch rule's, and the rule's in each normalize
    mode; each launch must equal the rule's bit for bit."""
    from tensorflow_web_deploy_tpu_torch.ops import preprocess_i420 as pp

    rs = np.random.RandomState(SEED)
    bf16 = torch.bfloat16
    for b in PP_BATCHES:
        for s in (512, 2048):
            hws_np = rs.randint(s // 2, s + 1, (b, 2)).astype(np.int32)
            buf = wire_batch(b, s, hws_np, gen)
            for out in (OUT, 224):
                def launch(shape, mode="inception"):
                    return pp._launch(buf, buf.stride(0), None, b, s, out, out, mode, bf16,
                                      shape)

                rule = pp._rule(b, s, out, out, 2, 0)
                want = launch(rule)
                results = []
                for rows in (1, 2, 4, 8, 16, 32):
                    for threads in (64, 128, 256, 512):
                        shape = pp.LaunchShape(rows, threads)
                        if shape.smem(s, out, 2) > pp.MAX_SMEM:
                            continue
                        if not torch.equal(launch(shape), want):
                            raise AssertionError(f"B={b} S={s} out={out} {shape}: differs")
                        results.append((graph_time_ms(lambda: launch(shape), inner=10,
                                                      replays=5), shape))
                results.sort(key=lambda r: r[0])
                emit({"phase": "preprocess_sweep", "batch": b, "canvas": s, "out": out,
                      "tried": len(results), "rule": rule._asdict(),
                      "rule_ms": graph_time_ms(lambda: launch(rule)),
                      "rule_ms_by_mode": {m: graph_time_ms(lambda: launch(rule, m))
                                          for m in pp.MODES},
                      "rule_smem": rule.smem(s, out, 2), "rule_blocks": rule.blocks(b, out),
                      "bound_ms": bound_ms(hws_np, s, out, out, 2, 4)[0],
                      "best": [{"ms": ms, **sh._asdict(), "blocks": sh.blocks(b, out)}
                               for ms, sh in results[:6]],
                      "all": [[*sh, ms] for ms, sh in results]})
            del buf


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
    waiting (for the interpreter lock, a core or the device). The prepares'
    overlap says how many decoded at once (at most, and on average over
    their span). Returns the answers and a summary in ms from the burst's
    start."""
    marks: dict[str, list[tuple[float, float, float]]] = {}
    lock = threading.Lock()
    handler_cls = srv.httpd.RequestHandlerClass
    hooks = [(srv.httpd, "process_request", "accept"), (handler_cls, "do_POST", "do_post"),
             (srv.app, "predict", "handler"), (srv.engine, "prepare_bytes", "prepare"),
             (srv.engine, "prepare_ragged", "prepare"), (srv.batcher, "submit", "submit"),
             (srv.batcher, "submit_ragged", "submit"), (srv.engine, "run_batch", "run_batch"),
             (srv.engine, "run_ragged", "run_batch")]
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
    timeline["prepare_overlap"] = overlap(marks.get("prepare", []))
    return [r for _, r in results], timeline


def overlap(spans: list[tuple[float, float, float]]) -> dict:
    """How many of ``spans`` ran at once: at most, and on average over the
    time from the first start to the last end."""
    if not spans:
        return {"max": 0, "mean": 0.0}
    edges = sorted([(a, 1) for a, _, _ in spans] + [(b, -1) for _, b, _ in spans])
    live = peak = 0
    for _, step in edges:
        live += step
        peak = max(peak, live)
    span = max(b for _, b, _ in spans) - min(a for a, _, _ in spans)
    return {"max": peak, "mean": sum(b - a for a, b, _ in spans) / span if span > 0 else 1.0}


def _config(name: str, dtype: str, wire: str = "yuv420", resize: str = "kernel",
            ragged: bool = False, **kw):
    from tensorflow_web_deploy_tpu_torch.utils.config import ServerConfig, model_config

    return ServerConfig(model=replace(model_config(f"native:{name}"), dtype=dtype),
                        canvas_buckets=BUCKETS, max_batch=8, wire_format=wire, resize=resize,
                        ragged=ragged, **kw)


def phase_main_path(jpegs: list[bytes], name: str, dtype: str, fused_cells: int,
                    second_burst: bool, serial: bool = True, **wire) -> dict:
    """One main path behind HTTP: boot, a burst of every image at once with
    the kernels' counts set to 0 just before it and read just after, then
    (``second_burst``) the same burst again, and (``serial``) the images one
    at a time. ``wire`` picks the wire (``_config``'s ``wire``, ``resize``,
    ``ragged``). The served model must hold ``fused_cells`` fused
    depthwise cells (of either stride), each launching the fused kernel
    once per batch; the preprocess kernel launches once per batch with
    ``resize="kernel"`` and never otherwise."""
    from tensorflow_web_deploy_tpu_torch.models.common import DepthwiseConvBN
    from tensorflow_web_deploy_tpu_torch.ops.fused_dw import fused_dw
    from tensorflow_web_deploy_tpu_torch.ops.preprocess_i420 import preprocess_i420
    from tensorflow_web_deploy_tpu_torch.server import start_server

    cfg = _config(name, dtype, host="127.0.0.1", port=0, **wire)
    t0 = time.perf_counter()
    srv = start_server(cfg, device="cuda", seed=SEED)
    boot_s = time.perf_counter() - t0
    try:
        eng = srv.engine
        if eng.parity is not None and not eng.parity["pass"]:
            raise AssertionError(f"parity gate failed: {eng.parity}")
        if eng.ragged != cfg.ragged:
            raise AssertionError(f"{name}: engine ragged={eng.ragged}, asked {cfg.ragged}")
        served_cells = sum(1 for m in eng.model.modules()
                           if isinstance(m, DepthwiseConvBN) and m.fused)
        if served_cells != fused_cells:
            raise AssertionError(f"{name}: {served_cells} fused depthwise cells, "
                                 f"want {fused_cells}")
        # the in-process client's first request builds urllib's opener
        # (an SSL context) in every thread that races into it; take that
        # one-time client cost out of the burst
        urllib.request.urlopen(srv.url + "/healthz", timeout=120).read()
        before = eng.stats()
        preprocess_i420.launches = fused_dw.launches = 0
        results, timeline = burst(srv, jpegs)
        launches = {"preprocess_i420": preprocess_i420.launches, "fused_dw": fused_dw.launches}
        after = eng.stats()
        batches = after["batches"] - before["batches"]
        wall = timeline["wall_ms"] / 1e3
        k = eng.topk
        for status, body, _ in results:
            preds = body.get("predictions", [])
            if status != 200 or len(preds) != k:
                raise AssertionError(f"bad answer: {status} {body}")
            if not all(math.isfinite(p["score"]) and 0 <= p["index"] < 1000 for p in preds):
                raise AssertionError(f"bad predictions: {preds}")
        want = {"preprocess_i420": batches if cfg.resize == "kernel" else 0,
                "fused_dw": fused_cells * batches}
        if batches == 0 or launches != want:
            raise AssertionError(f"{name}: kernel launches {launches} for {batches} batches "
                                 f"({fused_cells} fused depthwise cells): want {want}")
        decodes = {d: after["decodes"][d] - before["decodes"][d] for d in after["decodes"]}
        want_decodes = ({"native": len(jpegs), "pil": 0} if after["decoder"]["available"]
                        else {"native": 0, "pil": len(jpegs)})
        if decodes != want_decodes:
            raise AssertionError(f"{name}: decodes {decodes}, want {want_decodes}")
        path = f"native:{name}" + (":ragged" if eng.ragged else "")
        emit({"phase": "burst_timeline", "model": name, "path": path, "burst": 1, **timeline})
        row = {"phase": "main_path", "model": f"native:{name}", "path": path, "width": 1.0,
               "dtype": cfg.model.dtype, "fused_dw": eng.fused_dw, "parity": eng.parity,
               "wire": cfg.wire_format, "ragged": eng.ragged, "resize": cfg.resize,
               "decoder": "native" if after["decoder"]["available"] else "PIL",
               "decoder_reason": after["decoder"]["reason"], "decodes": decodes,
               "requests": len(jpegs), "batches": batches, "kernel_launches": launches,
               "fused_dw_cells": fused_cells, "boot_s": boot_s,
               "h2d_bytes_per_image": (after["h2d_bytes"] - before["h2d_bytes"]) / len(jpegs),
               "img_per_s": len(jpegs) / wall,
               "p50_ms": timeline["client_latency_ms"]["p50"],
               "p99_ms": timeline["client_latency_ms"]["p99"],
               "prepare_overlap": timeline["prepare_overlap"]}
        if second_burst:
            # a second, identical burst: what of the first was one-time cost
            second = burst(srv, jpegs)[1]
            emit({"phase": "burst_timeline", "model": name, "path": path, "burst": 2, **second})
            row.update(burst2_img_per_s=len(jpegs) / second["wall_ms"] * 1e3,
                       burst2_p50_ms=second["client_latency_ms"]["p50"],
                       burst2_p99_ms=second["client_latency_ms"]["p99"])
        if serial:  # the same requests one at a time: latency without queueing
            lat = np.array([post(srv.url + "/predict", d)[2] for d in jpegs]) * 1e3
            row.update(serial_p50_ms=float(np.percentile(lat, 50)),
                       serial_p99_ms=float(np.percentile(lat, 99)))
        emit(row)
        row["served"] = [(r[1]["predictions"][0]["index"], r[1]["predictions"][0]["score"])
                         for r in results]
        return row
    finally:
        srv.close()


def phase_parity(jpegs: list[bytes], served: list[tuple[int, float]], name: str,
                 dtype: str) -> dict:
    """The served dtype's kernel path vs the unfused float32 model (plain
    preprocess, TF32 off) on the main path's images, at the engine's gate
    tolerances for that dtype; and the served answers vs the same path."""
    from tensorflow_web_deploy_tpu_torch.models.adapter import native_converted
    from tensorflow_web_deploy_tpu_torch.ops.image import NORMALIZERS, resize_yuv_planes
    from tensorflow_web_deploy_tpu_torch.ops.preprocess_i420 import preprocess_i420
    from tensorflow_web_deploy_tpu_torch.ops.quant import topk_agreement
    from tensorflow_web_deploy_tpu_torch.serving.engine import InferenceEngine

    eng = InferenceEngine(_config(name, dtype, warmup=False), device="cuda", seed=SEED)
    tol = eng.PARITY_TOL[eng.model_cfg.dtype]
    out = eng.model_cfg.input_size[0]
    ref_model = native_converted(name, seed=SEED).to("cuda", memory_format=torch.channels_last)
    probs, probs_f32 = [], []
    with torch.inference_mode():
        for data in jpegs:
            canvas, hw, _ = eng.prepare_bytes(data)
            packed = torch.from_numpy(canvas[None]).cuda()
            hws = torch.tensor([hw], dtype=torch.int32, device="cuda")
            x = preprocess_i420(packed, hws, out, out, "inception", eng.dtype)
            p = eng.model(x).float()
            xr = NORMALIZERS["inception"](resize_yuv_planes(packed, hws, out, out))
            probs.append(p.cpu().numpy()[0])
            probs_f32.append(ref_model(xr).cpu().numpy()[0])
    pq, pf = np.stack(probs), np.stack(probs_f32)
    if not (np.isfinite(pq).all() and pq.shape == (len(jpegs), 1000)):
        raise AssertionError(f"{dtype} probabilities are not finite [n, 1000]")
    k = eng.topk
    agree = topk_agreement(pf, pq, k, tol["prob"])
    delta = float(np.abs(pq - pf).max())
    # The server batched these images with others; another batch size may
    # take another cuDNN algorithm, so the served top-1 must be a top-1 of
    # the same path up to bf16 rounding, not bit-identical to it.
    idx = np.array([i for i, _ in served])
    score = np.array([sc for _, sc in served])
    own = pq[np.arange(len(idx)), idx]
    served_ok = bool(np.all(own >= pq.max(1) - SERVED_TOL)
                     and np.all(np.abs(own - score) <= SERVED_TOL))
    row = {"phase": "parity", "model": name, "dtype": dtype, "fused_dw": eng.fused_dw,
           "gate": eng.parity, "images": len(jpegs), "topk": k, "topk_agreement": agree,
           "max_prob_delta": delta, "tol_topk": tol["topk"], "tol_prob": tol["prob"],
           "served_top1_matches": float(np.mean(idx == pq.argmax(1))),
           "served_ok": served_ok,
           "f32_top1_matches": float(np.mean(pq.argmax(1) == pf.argmax(1))),
           "tf32": [torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32]}
    emit(row)
    eng.close()
    if agree < tol["topk"] or delta > tol["prob"]:
        raise AssertionError(f"{dtype} gate failed: {row}")
    if not served_ok:
        raise AssertionError(f"served answers differ from the {dtype} path: {row}")
    return row


def batch_of_8(eng, jpegs: list[bytes]) -> tuple[torch.Tensor, np.ndarray, float]:
    """The first 8 main-path images that land in the 512 canvas: their wire
    buffer on the card, their valid sizes on the host, and the host prepare
    time (decode + pad + I420 pack) per image in ms."""
    t0 = time.perf_counter()
    prepared = [eng.prepare_bytes(d) for d in jpegs]
    prepare_ms = (time.perf_counter() - t0) / len(jpegs) * 1e3
    big = [(c, hw) for c, hw, _ in prepared if c.shape[-1] == 512][:8]
    if len(big) < 8:
        raise AssertionError(f"only {len(big)} images in the 512 canvas")
    hws_np = np.array([hw for _, hw in big], np.int32)
    return wire_buffer(np.stack([c for c, _ in big]), hws_np), hws_np, prepare_ms


def preprocess_stage(eng, buf: torch.Tensor, out: int) -> dict:
    """The engine's preprocess stage on one wire buffer in the 512 canvas:
    its bf16 output against the plain version, the kernel's device time
    (bf16 from the wire; float32 from the table), the stage as it ran
    before (trailer decode + float32 kernel + cast) and its two removed
    parts alone, the plain version, the wrapper's host time, the bound, and
    the kernels each form of the stage launches: the engine's must launch
    the preprocess kernel once a call (its counter) and nothing else (the
    profiler)."""
    from tensorflow_web_deploy_tpu_torch.ops.preprocess_i420 import (
        decode_trailer,
        preprocess_i420,
        preprocess_i420_plain,
        preprocess_i420_wire,
        wire_canvases,
    )

    s, bf16 = 512, torch.bfloat16
    packed, hws = wire_canvases(buf, s), decode_trailer(buf)
    x = eng.preprocess_packed(buf)
    if x.dtype != eng.dtype or tuple(x.shape) != (buf.shape[0], out, out, 3):
        raise AssertionError(f"preprocess stage gave {x.dtype} {tuple(x.shape)}")
    ref = preprocess_i420_plain(packed, hws, out, out)
    x32 = preprocess_i420(packed, hws, out, out)
    row = {"phase": "preprocess_stage", "batch": buf.shape[0], "canvas": s, "out": out,
           "max_abs_err": float((x32 - ref).abs().max()), **bf16_vs_plain(x, ref, "inception"),
           "ms": graph_time_ms(lambda: preprocess_i420_wire(buf, s, out, out, "inception", bf16)),
           "ms_f32": graph_time_ms(lambda: preprocess_i420(packed, hws, out, out)),
           "before_ms": graph_time_ms(lambda: preprocess_before(buf, s, out)),
           "decode_ms": graph_time_ms(lambda: decode_trailer(buf)),
           "cast_ms": graph_time_ms(lambda: x32.to(bf16)),
           "plain_ms": graph_time_ms(lambda: preprocess_i420_plain(
               packed, decode_trailer(buf), out, out, "inception", bf16)),
           "call_ms": cuda_time_ms(lambda: eng.preprocess_packed(buf)),
           "host_us": host_us(lambda: preprocess_i420_wire(buf, s, out, out, "inception", bf16)),
           "engine_host_us": host_us(lambda: eng.preprocess_packed(buf)),
           "before_host_us": host_us(lambda: preprocess_before(buf, s, out))}
    hws_np = hws.cpu().numpy()
    row["bound_ms"], row["bound_by"] = bound_ms(hws_np, s, out, out, 2, 4)
    row["bound_ms_f32"] = bound_ms(hws_np, s, out, out, 4, 8)[0]
    row["share_of_bound"] = row["bound_ms"] / row["ms"]
    # one stage call = one launch of the kernel (its counter) and no other
    # kernel (every kernel the profiler recorded in the stage's windows)
    launches = preprocess_i420.launches
    stage = profiled_calls(lambda: eng.preprocess_packed(buf))
    launches_per_call = (preprocess_i420.launches - launches) / stage["fn_calls"]
    before = profiled_calls(lambda: preprocess_before(buf, s, out))
    row.update(stage_launches_per_call=launches_per_call,
               stage_kernels_recorded=stage["kernels"] / stage["calls"], stage_top=stage["top"],
               before_kernels_recorded=before["kernels"] / before["calls"],
               before_top=before["top"], profile_attempts=[stage["attempts"], before["attempts"]])
    if (launches_per_call != 1 or len(stage["top"]) != 1
            or "preprocess_i420" not in stage["top"][0]["name"]):
        raise AssertionError(f"the preprocess stage launched {launches_per_call} preprocess "
                             f"kernels a call and {stage}")
    emit(row)
    return row


def phase_breakdown(jpegs: list[bytes]) -> dict:
    """Device time per stage of one batch of 8 main-path images in the
    512 canvas: the preprocess stage (one kernel, bf16 out), forward (bf16)
    on its output, top-k; and the kernel's row for the kernels line,
    measured on these real inputs."""
    from tensorflow_web_deploy_tpu_torch.serving.engine import InferenceEngine

    eng = InferenceEngine(_config("inception_v3", "bfloat16", warmup=False), device="cuda",
                          seed=SEED)
    buf, hws_np, prepare_ms = batch_of_8(eng, jpegs)
    host = buf[:, :-4].reshape(8, 768, 512).cpu().numpy()
    with torch.inference_mode():
        stage = preprocess_stage(eng, buf, OUT)
        x = eng.preprocess_packed(buf)
        probs = eng.model(x).float()
        row = {"phase": "breakdown", "batch": 8, "canvas": 512,
               "preprocess_ms": stage["ms"],
               "forward_bf16_ms": cuda_time_ms(lambda: eng.model(x), repeats=10),
               "topk_ms": graph_time_ms(lambda: torch.topk(probs, 5, dim=-1)),
               # host side: decode + pad + I420 pack per image, and one
               # whole engine batch (stage, H2D, serve, D2H) with its wait
               "host_prepare_ms_per_image": prepare_ms,
               "run_batch_ms": statistics.median(
                   timed(lambda: eng.run_batch(host, hws_np)) for _ in range(10))}
    eng.close()
    emit(row)
    return stage


def device_profile(fn, top: int = 10) -> dict:
    """Kernels of one ``fn()`` under ``torch.profiler``: their count, the
    summed device time, and the ``top`` names by device time (µs)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.count, e.self_device_time_total) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[2])
    return {"kernels": sum(r[1] for r in rows), "device_us": sum(r[2] for r in rows),
            "top": [{"name": k[:90], "count": n, "us": t} for k, n, t in rows[:top]]}


def profiled_calls(fn, calls: int = 5, attempts: int = 3) -> dict:
    """``device_profile`` of ``calls`` calls of ``fn()`` in one window, and
    how many times ``fn`` ran in all (``fn_calls``, warm-up included). The
    profiler drops device events now and then in a window this short, a
    few or all of them: an empty profile is taken again, up to ``attempts``
    times, and then fails; the kernel counts it returns are lower bounds."""
    ran = 0

    def counted():
        nonlocal ran
        ran += 1
        fn()

    for attempt in range(1, attempts + 1):
        prof = device_profile(lambda: [counted() for _ in range(calls)])
        if prof["kernels"]:
            return {**prof, "calls": calls, "attempts": attempt, "fn_calls": ran}
    raise AssertionError(f"the profiler recorded no device events in {attempts} windows")


def grouped_convs(fn) -> list[tuple[str, int]]:
    """(input dtype, groups) of every grouped convolution that ``fn()``
    dispatches: the depthwise convs that did not go through the fused
    kernel."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Recorder(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.convs = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            # under inference_mode F.conv2d arrives as aten.conv2d, else as
            # aten.convolution; groups is the last argument of either
            at = {torch.ops.aten.conv2d: 6, torch.ops.aten.convolution: 8}.get(
                func.overloadpacket)
            if at is not None:
                groups = kwargs.get("groups", args[at] if len(args) > at else 1)
                if groups > 1:
                    self.convs.append((str(args[0].dtype), int(groups)))
            return func(*args, **kwargs)

    with Recorder() as rec:
        fn()
    return rec.convs


def phase_mobilenet_forward(jpegs: list[bytes]) -> dict:
    """Full-width MobileNetV2 at batch 8 on real main-path images (512
    canvas, preprocess kernel at 224): the forward's time in bf16 unfused,
    bf16 fused and int8 fused (CUDA events around one call, one forward
    replayed in a CUDA graph, and a profiler's kernel count and summed
    device time), the grouped convolutions each forward still dispatches
    (none when fused: all 17 depthwise cells launch the fused kernel), and
    one whole int8 engine batch on the host clock. The forwards read the
    engine's preprocess stage's bf16 output at 224 out, whose
    ``preprocess_stage`` row this returns."""
    from tensorflow_web_deploy_tpu_torch.models.adapter import native_converted
    from tensorflow_web_deploy_tpu_torch.models.common import DepthwiseConvBN
    from tensorflow_web_deploy_tpu_torch.ops.fused_dw import fused_dw
    from tensorflow_web_deploy_tpu_torch.ops.quant import dequantize_taps
    from tensorflow_web_deploy_tpu_torch.serving.engine import InferenceEngine

    eng = InferenceEngine(_config("mobilenet_v2", "int8", warmup=False), device="cuda",
                          seed=SEED)
    buf, hws_np, _ = batch_of_8(eng, jpegs)
    row = {"phase": "mobilenet_forward", "batch": 8, "canvas": 512, "out": 224}
    with torch.inference_mode():
        stage = preprocess_stage(eng, buf, 224)
        xb = eng.preprocess_packed(buf)
        for label, fused, int8 in (("bf16_unfused", False, False), ("bf16_fused", True, False),
                                   ("int8_fused", True, True)):
            model = native_converted("mobilenet_v2", seed=SEED, fused_dw=fused, int8=int8).to(
                "cuda", torch.bfloat16, memory_format=torch.channels_last)
            if int8:  # the fused cells' one-op dequant rounds as dequantize does
                row["dequantize_taps_max_abs_err"] = max(
                    float((dequantize_taps(m.dwconv.q, m.dwconv.scale) - m.dwconv.weight.float()
                           .reshape(m.dwconv.q.shape[0], -1).t()).abs().max())
                    for m in model.modules() if isinstance(m, DepthwiseConvBN))
                if row["dequantize_taps_max_abs_err"] != 0.0:
                    raise AssertionError(f"dequantize_taps differs from dequantize: {row}")
            launches = fused_dw.launches
            convs = grouped_convs(lambda: model(xb))
            row[f"forward_{label}_fused_dw_launches"] = fused_dw.launches - launches
            row[f"forward_{label}_grouped_convs"] = len(convs)
            want = (0, DW_CELLS) if fused else (DW_CELLS, 0)
            if (len(convs), fused_dw.launches - launches) != want:
                raise AssertionError(f"{label}: grouped convs {convs} and "
                                     f"{fused_dw.launches - launches} fused_dw launches, "
                                     f"want {want}")
            row[f"forward_{label}_ms"] = cuda_time_ms(lambda: model(xb), repeats=10)
            row[f"forward_{label}_graph_ms"] = graph_time_ms(lambda: model(xb), inner=3,
                                                             replays=5)
            prof = device_profile(lambda: model(xb))
            emit({"phase": "forward_profile", "model": "mobilenet_v2", "forward": label,
                  "batch": 8, **prof})
            row[f"forward_{label}_kernels"] = prof["kernels"]
            row[f"forward_{label}_device_us"] = prof["device_us"]
        host = buf[:, :-4].reshape(8, 768, 512).cpu().numpy()
        row["run_batch_int8_ms"] = statistics.median(
            timed(lambda: eng.run_batch(host, hws_np)) for _ in range(10))
    eng.close()
    emit(row)
    return stage


def per_image_ms(fn, items: list, passes: int = 3) -> float:
    """Median over ``passes`` of one thread's host time per ``fn(item)``, in ms."""
    times = []
    for _ in range(passes):
        t0 = time.perf_counter()
        for it in items:
            fn(it)
        times.append((time.perf_counter() - t0) / len(items) * 1e3)
    return statistics.median(times)


def decode_tight(data: bytes) -> tuple[np.ndarray, tuple[int, int], int]:
    """One upload as the ragged wire takes it: tight RGB rows by libjpeg
    (planned from the header), or PIL + ``fit_to_bucket`` where the native
    decoder is unavailable. Returns (flat uint8, (h, w), canvas side)."""
    from tensorflow_web_deploy_tpu_torch import native
    from tensorflow_web_deploy_tpu_torch.ops.image import decode_image, fit_to_bucket

    plan = native.plan_decode_packed(data, BUCKETS)
    if plan is not None:
        s, need, _, _ = plan
        out = np.empty(need, np.uint8)
        hw = native.decode_packed_into(data, out, s)
        if hw is not None:
            return out, hw, s
    tight, hw, s = fit_to_bucket(decode_image(data), BUCKETS)
    return tight.reshape(-1), hw, s


def phase_native_decode(jpegs: list[bytes]) -> dict:
    """The native decoder: whether it built (and why not), its libjpeg, one
    thread's ms per image over the main paths' JPEGs into each wire (RGB
    canvas, I420 canvas, tight rows) against the PIL chain they replace
    (decode + pad + the numpy I420 packer; decode + pad; decode +
    ``fit_to_bucket``), the same over 8 threads at once, and the largest
    difference of its RGB from PIL's (a report: two libjpeg builds may
    round their IDCT differently)."""
    from tensorflow_web_deploy_tpu_torch import native
    from tensorflow_web_deploy_tpu_torch.ops.image import (
        decode_image,
        fit_to_bucket,
        pad_to_canvas,
        rgb_to_yuv420_canvas,
    )

    st = native.status()
    row = {"phase": "native_decode", "built": st["available"], "library": st["library"],
           "libjpeg_version": st["libjpeg_version"], "reason": st["reason"],
           "images": len(jpegs), "buckets": list(BUCKETS),
           "pil_i420_ms": per_image_ms(
               lambda d: rgb_to_yuv420_canvas(pad_to_canvas(decode_image(d), BUCKETS)[0]), jpegs),
           "pil_rgb_ms": per_image_ms(lambda d: pad_to_canvas(decode_image(d), BUCKETS), jpegs),
           "pil_tight_ms": per_image_ms(lambda d: fit_to_bucket(decode_image(d), BUCKETS),
                                        jpegs)}
    with ThreadPoolExecutor(8) as pool:
        t0 = time.perf_counter()
        list(pool.map(lambda d: pad_to_canvas(decode_image(d), BUCKETS), jpegs * 4))
        row["pil_rgb_ms_8_threads"] = (time.perf_counter() - t0) / (4 * len(jpegs)) * 1e3
    if st["available"]:
        row.update(
            native_rgb_ms=per_image_ms(lambda d: native.decode_native(d, BUCKETS, "rgb"), jpegs),
            native_i420_ms=per_image_ms(lambda d: native.decode_native(d, BUCKETS, "yuv420"),
                                        jpegs),
            native_tight_ms=per_image_ms(decode_tight, jpegs))
        with ThreadPoolExecutor(8) as pool:
            t0 = time.perf_counter()
            list(pool.map(decode_tight, jpegs * 4))
            row["native_tight_ms_8_threads"] = (time.perf_counter() - t0) / (4 * len(jpegs)) * 1e3
        diffs = []
        for d in jpegs:
            tight, (h, w), _ = decode_tight(d)
            diffs.append(np.abs(tight.reshape(h, w, 3).astype(np.int16)
                                - decode_image(d).astype(np.int16)))
        row["max_abs_diff_vs_pil"] = int(max(x.max() for x in diffs))
        row["differing_fraction_vs_pil"] = float(sum((x > 0).sum() for x in diffs)
                                                 / sum(x.size for x in diffs))
    emit(row)
    return row


def ragged_slab(jpegs: list[bytes], s: int, holes: tuple[int, ...] = ()):
    """A pinned ragged slab of ``len(jpegs)`` slots, each image decoded
    tight straight into its arena span (``decode_tight`` where PIL must
    decode); slots in ``holes`` are decoded but never committed. Returns
    the slab and the host's padded canvases and valid sizes of the same
    pixels (``pad_to_canvas``; holes: a zero canvas, hw (1, 1))."""
    from tensorflow_web_deploy_tpu_torch import native
    from tensorflow_web_deploy_tpu_torch.ops.image import pad_to_canvas
    from tensorflow_web_deploy_tpu_torch.serving.engine import RaggedSlab

    slab = RaggedSlab(s, len(jpegs), pinned=True)
    canvases = np.zeros((len(jpegs), s, s, 3), np.uint8)
    hws = np.ones((len(jpegs), 2), np.int32)
    for i, data in enumerate(jpegs):
        plan = native.plan_decode_packed(data, BUCKETS)
        if plan is not None:  # libjpeg straight into the arena span
            slot, span = slab.alloc(plan[1])
            hw = native.decode_packed_into(data, span, s)
            if hw is None:
                raise AssertionError(f"libjpeg rejected main-path JPEG {i}")
        else:
            tight, hw, _ = decode_tight(data)
            slot, span = slab.alloc(tight.size)
            span[:] = tight
        if i not in holes:
            slab.write_hw(slot, hw)
            canvases[i], hws[i] = pad_to_canvas(span.reshape(hw[0], hw[1], 3), (s,))
    return slab, canvases, hws


def phase_ragged_unpack(jpegs: list[bytes]) -> dict:
    """The device unpack on 8 main-path images of the 512 canvas, decoded
    tight into a pinned arena and shipped with the meta table in one copy:
    the canvases and valid sizes must equal the host's ``pad_to_canvas``
    bit for bit, with every slot filled and with two holes; its device time
    per batch (CUDA graph), its kernels per call (profiler, a lower bound:
    the zero fill, K copies, ATen's kernels for the valid sizes),
    the wrapper's host time, its bound; the copy's time against the classic
    rgb wire's; and the wire bytes per image, ragged against the classic
    rgb and yuv420 canvases, with the padded share of each."""
    from tensorflow_web_deploy_tpu_torch.ops.image import unpack_ragged

    s, k = 512, 8
    big = [d for d in jpegs if decode_tight(d)[2] == s][:k]
    if len(big) < k:
        raise AssertionError(f"only {len(big)} images in the {s} canvas")
    row = {"phase": "ragged_unpack", "batch": k, "canvas": s}
    for label, holes in (("full", ()), ("holes", (2, 5))):
        slab, want, want_hw = ragged_slab(big, s, holes)
        nbytes, meta_off = slab.stage(k)
        dev = slab.buf[:nbytes].to("cuda", non_blocking=True)
        meta = dev[meta_off:].view(torch.int32).view(k, 4)
        got, got_hw = unpack_ragged(dev[:meta_off], meta, s, meta_host=slab.meta)
        if not (np.array_equal(got.cpu().numpy(), want)
                and np.array_equal(got_hw.cpu().numpy(), want_hw)):
            raise AssertionError(f"ragged unpack ({label}) differs from pad_to_canvas")
        row[f"bit_identical_{label}"] = True
    # the full batch: times, kernels, bytes
    slab, _, hws = ragged_slab(big, s)
    nbytes, meta_off = slab.stage(k)
    dev = slab.buf[:nbytes].to("cuda")
    arena, meta = dev[:meta_off], dev[meta_off:].view(torch.int32).view(k, 4)
    unpack = lambda: unpack_ragged(arena, meta, s, meta_host=slab.meta)  # noqa: E731
    prof = profiled_calls(unpack)
    pixel = int(sum(h * w * 3 for h, w in hws))
    classic = torch.zeros((k, s * s * 3 + 4), dtype=torch.uint8, pin_memory=True)
    row.update(
        ms=graph_time_ms(unpack), host_us=host_us(unpack),
        kernels_per_call=prof["kernels"] / prof["calls"], copies_per_call=k,
        profile_top=prof["top"],
        # least time: read each image's bytes once, write every canvas once
        bound_ms=(pixel + k * s * s * 3) / MEM_BYTES_PER_S * 1e3, bound_by="bytes",
        h2d_ms=cuda_time_ms(lambda: slab.buf[:nbytes].to("cuda", non_blocking=True)),
        h2d_classic_rgb_ms=cuda_time_ms(lambda: classic.to("cuda", non_blocking=True)),
        rows_shipped=slab.rows_shipped(k), pixel_bytes_per_image=pixel / k,
        wire_bytes_per_image={"ragged": nbytes / k, "classic_rgb": s * s * 3 + 4,
                              "classic_yuv420": s * s * 3 // 2 + 4},
        padded_fraction={"ragged": 1 - pixel / nbytes,
                         "classic_rgb": 1 - pixel / (k * (s * s * 3 + 4))})
    emit(row)
    return row


def phase_ragged_vs_classic(jpegs: list[bytes], served: dict) -> list[dict]:
    """For each ragged main path, on one engine: the same 8 images of the
    512 canvas through the ragged wire (``run_ragged``) and through the
    classic rgb wire (``run_batch`` on the host's padded canvases), one
    batch each: the same top-1 everywhere and the largest top-k score
    difference within the bf16 gate's 0.08. Then the path's served top-1
    (its burst) against the engine's ragged answers for all its images,
    batched by canvas (another batch may take another cuDNN algorithm, so
    within ``SERVED_TOL``)."""
    from tensorflow_web_deploy_tpu_torch.ops.image import pad_to_canvas
    from tensorflow_web_deploy_tpu_torch.serving.engine import InferenceEngine

    rows = []
    for name, dtype, resize in RAGGED_PATHS:
        eng = InferenceEngine(_config(name, dtype, wire="rgb", resize=resize, ragged=True,
                                      warmup=False), device="cuda", seed=SEED)
        prepared = [eng.prepare_ragged(d) for d in jpegs]
        big = [(t, hw) for t, hw, s, _ in prepared if s == 512][:8]
        hws = np.array([hw for _, hw in big], np.int32)
        scores_r, idx_r = eng.run_ragged([t for t, _ in big], hws, 512)
        canvases = np.stack([pad_to_canvas(t, (512,))[0] for t, _ in big])
        scores_c, idx_c = eng.run_batch(canvases, hws)
        # every image of the burst, through the ragged wire, by canvas
        answers = {}
        for side in BUCKETS:
            ids = [i for i, p in enumerate(prepared) if p[2] == side]
            got = eng.run_ragged([prepared[i][0] for i in ids],
                                 np.array([prepared[i][1] for i in ids], np.int32), side)
            answers.update({i: (got[0][j], got[1][j]) for j, i in enumerate(ids)})
        served_ok = True
        for i, (idx, score) in enumerate(served[name]):
            sc, ix = answers[i]
            own = sc[ix == idx]
            served_ok &= bool(own.size and own[0] >= sc[0] - SERVED_TOL
                              and abs(own[0] - score) <= SERVED_TOL)
        row = {"phase": "ragged_vs_classic", "model": name, "dtype": dtype, "resize": resize,
               "images": len(big), "same_top1": bool(np.array_equal(idx_r[:, 0], idx_c[:, 0])),
               "same_topk": bool(np.array_equal(idx_r, idx_c)),
               "max_prob_delta": float(np.abs(scores_r - scores_c).max()),
               "tol_prob": RAGGED_PROB_TOL, "served_images": len(served[name]),
               "served_ok": served_ok}
        eng.close()
        emit(row)
        if not (row["same_top1"] and row["max_prob_delta"] <= RAGGED_PROB_TOL and served_ok):
            raise AssertionError(f"ragged vs classic: {row}")
        rows.append(row)
    return rows


def phase_default_server(jpegs: list[bytes]) -> dict:
    """The server as a user starts it, ``python -m
    tensorflow_web_deploy_tpu_torch.server`` with no model or wire flags
    (only a free port): it must boot on the card and serve Inception-v3 on
    the ragged rgb wire with the matmul resize and the decoder the machine
    allows, at its default buckets (canvas up to 2048, batch up to 32). Two
    main-path JPEGs and one over the top canvas bucket go in; then it is
    stopped with SIGINT and must exit."""
    import signal
    import socket
    from PIL import Image

    from tensorflow_web_deploy_tpu_torch import native

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    url = f"http://127.0.0.1:{port}"
    big = io.BytesIO()
    Image.fromarray(np.full((300, 2500, 3), 90, np.uint8)).save(big, "JPEG")
    t0 = time.perf_counter()
    log = tempfile.TemporaryFile("w+")
    proc = subprocess.Popen([sys.executable, "-m", "tensorflow_web_deploy_tpu_torch.server",
                             "--port", str(port)], stdout=log, stderr=subprocess.STDOUT, text=True,
                            cwd=os.path.dirname(os.path.abspath(__file__)))
    try:
        while True:
            if proc.poll() is not None:
                log.seek(0)
                raise AssertionError(f"the server exited {proc.returncode}: {log.read()[-2000:]}")
            if time.perf_counter() - t0 > 300:
                raise AssertionError("the server did not answer /healthz in 300 s")
            try:
                urllib.request.urlopen(url + "/healthz", timeout=5).read()
                break
            except OSError:
                time.sleep(0.5)
        boot_s = time.perf_counter() - t0
        answers = [post(url + "/predict", d) for d in (jpegs[2], jpegs[7], big.getvalue())]
        with urllib.request.urlopen(url + "/stats", timeout=60) as r:
            eng = json.loads(r.read())["engine"]
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        log.close()
    st = native.status()
    row = {"phase": "default_server", "boot_s": boot_s, "exit_code": proc.returncode,
           "statuses": [a[0] for a in answers],
           "predictions": [len(a[1].get("predictions", [])) for a in answers],
           **{k: eng[k] for k in ("model", "device", "dtype", "wire_format", "ragged", "resize",
                                  "decodes", "batches", "canvas_buckets", "batch_buckets")},
           "decoder_available": eng["decoder"]["available"], "decoder_reason": eng["decoder"]["reason"]}
    emit(row)
    want = {"model": "inception_v3", "device": "cuda", "dtype": "bfloat16", "wire_format": "rgb",
            "ragged": True, "resize": "matmul", "decoder_available": st["available"],
            "statuses": [200] * 3, "predictions": [5] * 3, "exit_code": 0}
    bad = {k: row[k] for k, v in want.items() if row[k] != v}
    if bad or sum(eng["decodes"].values()) != 3:
        raise AssertionError(f"the default server: {bad or eng['decodes']}, want {want}")
    return row


def main(argv: list[str]) -> int:
    sweeps = ("--sweep-fused-dw", "--sweep-preprocess")
    if not (argv == [] or (len(argv) == 1 and argv[0] in sweeps)):
        print(f"usage: python3 chip_smoke.py [{' | '.join(sweeps)}], not {argv}",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from tensorflow_web_deploy_tpu_torch import native
    from tensorflow_web_deploy_tpu_torch.ops import _build

    # float32 means float32 in every reference below
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = nvidia_smi()
    emit({"phase": "device", "nvidia_smi": smi, "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS) + 1) as pool:  # one compiler per source, together
        decoder = pool.submit(native.status)
        list(pool.map(_build.load, KERNELS))
        decoder = decoder.result()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": [_build.library_path(k).name for k in KERNELS], "native_decoder": decoder})

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    if argv == ["--sweep-fused-dw"]:
        emit({"phase": "ptxas", "fused_dw": ptxas_report("fused_dw").splitlines()})
        shapes = dw_layer_shapes()
        emit({"phase": "fused_dw_check", **dw_check(
            gen, shapes + [dw_odd(s) for s in shapes if s["stride"] == 2])})
        sweep_fused_dw(gen, shapes)
        return 0
    if argv == ["--sweep-preprocess"]:
        emit({"phase": "ptxas",
              "preprocess_i420": ptxas_report("preprocess_i420").splitlines()})
        emit({"phase": "kernel_check", "max_abs_err": phase_kernel(gen)})
        sweep_preprocess(gen)
        return 0
    kern_err = phase_kernel(gen)
    dw = phase_fused_dw_kernel(gen, dw_layer_shapes())
    jpegs = make_jpegs(24, SEED)
    phase_native_decode(jpegs)
    phase_ragged_unpack(jpegs)
    inception = phase_main_path(jpegs, "inception_v3", "bfloat16", fused_cells=0,
                                second_burst=True)
    phase_parity(jpegs, inception["served"], "inception_v3", "bfloat16")
    stage299 = phase_breakdown(jpegs)
    mobilenet = phase_main_path(jpegs, "mobilenet_v2", "int8", fused_cells=DW_CELLS,
                                second_burst=False)
    phase_parity(jpegs, mobilenet["served"], "mobilenet_v2", "int8")
    stage224 = phase_mobilenet_forward(jpegs)
    ragged = [phase_main_path(jpegs, name, dtype, fused_cells=DW_CELLS if dtype == "int8" else 0,
                              second_burst=True, wire="rgb", resize=resize, ragged=True)
              for name, dtype, resize in RAGGED_PATHS]
    phase_ragged_vs_classic(jpegs, {p["model"].split(":")[1]: p["served"] for p in ragged})
    phase_default_server(jpegs)
    by_path = {p["path"]: p["kernel_launches"] for p in (inception, mobilenet, *ragged)}
    emit({"kernels": [{
        "name": "preprocess_i420",
        "route": "cuda",
        "source": "tensorflow_web_deploy_tpu_torch/csrc/preprocess_i420.cu",
        "replaces": "tensorflow_web_deploy_tpu/ops/pallas_preprocess.py:109",
        "launches": sum(n["preprocess_i420"] for n in by_path.values()),
        "launches_by_path": {m: n["preprocess_i420"] for m, n in by_path.items()},
        # float32 through both entries at every cell, and the main paths'
        # stages; their bf16 outputs are in the kernel and preprocess_stage
        # lines
        "max_abs_err": max(kern_err, stage299["max_abs_err"], stage224["max_abs_err"]),
        # batch of 8 main-path images, 512 canvas, 299 out, bf16 from the
        # wire as the Inception path runs it; and at 224 out (MobileNetV2)
        "ms": stage299["ms"],
        "plain_ms": stage299["plain_ms"],
        "bound_ms": stage299["bound_ms"],
        "bound_by": stage299["bound_by"],
        "library_ms": None,
        "ms_224": stage224["ms"],
        "plain_ms_224": stage224["plain_ms"],
        "bound_ms_224": stage224["bound_ms"],
        "host_us": stage299["host_us"],
    }, {
        "name": "fused_dw",
        "route": "cuda",
        "source": "tensorflow_web_deploy_tpu_torch/csrc/fused_dw.cu",
        "replaces": "tensorflow_web_deploy_tpu/ops/pallas_depthwise.py:57",
        "launches": sum(n["fused_dw"] for n in by_path.values()),
        "launches_by_path": {m: n["fused_dw"] for m, n in by_path.items()},
        "max_abs_err": dw["max_abs_err"],
        "ms": dw["ms"],
        "plain_ms": dw["plain_ms"],
        "bound_ms": dw["bound_ms"],
        "bound_by": dw["bound_by"],
        # F.conv2d(groups=C) + bias in bf16 over the same 17 layers (at
        # stride 2 after F.pad by the reference's pads): the closest one
        # call; it leaves out the relu6 clamp
        "library_ms": dw["cudnn_ms"],
    }]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
