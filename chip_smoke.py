"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds every hand-written kernel from the sources in this checkout (one
nvcc per source, all started together, through the kernel build cache in
the checkout's ``.build/``) and the native libjpeg decoder (the system's
libjpeg, or else the one Pillow bundles, against the headers in
``native/include``), holds each kernel against its plain PyTorch version
on the card at the shapes the main paths give it, and drives four main
paths at full width behind ``POST /predict``. Each goes through the
slot-leased, pipelined batcher: every JPEG is decoded by libjpeg straight
into its leased slot of a pinned slab (one host copy), and up to
``pipeline_depth`` batches per canvas bucket are in flight, each batch's
H2D on the engine's copy stream. Every batch of a main path must be one
replay of the CUDA graph its server captured at boot for the batch's
(canvas, batch) bucket. Two on the yuv420 wire with the preprocess
kernel:

- Inception-v3 in bf16, checked against a float32 reference;
- MobileNetV2 in the int8 tier, all 17 depthwise cells (13 stride 1, 4
  stride 2) on the fused depthwise kernel, gated at build by the engine's
  parity check and checked against the unfused float32 model on the same
  images.

And two on the ragged rgb wire, the server's defaults: each batch ships
its images tight in one pinned arena:

- Inception-v3 in bf16 with the matmul resize (the server with no flags):
  the whole preprocess stage is one launch of the ragged preprocess
  kernel, which reads the arena and stores bf16;
- MobileNetV2 in the int8 tier with the gather resize: the unpack kernel
  rebuilds the canvases, and the fused depthwise kernel runs in all 17
  cells.

Before them, ``native_decode`` requires the decoder built, holds its RGB
against PIL's decode of the same bytes (byte for byte at full size) and
times it against the PIL chain it replaced, on one thread and on 8, and
``ragged_unpack`` holds the unpack kernel bit for bit against the host's
padded canvases and its plain version (holes included) and times it,
``ragged_preprocess`` holds the ragged preprocess kernel against its plain
version (float32 within 1e-4, bf16 within 1 ulp; every slot filled and two
holes; batch 8 and 32 at Inception-v3's, ResNet-50's and SSD's sizes and
modes) and times it against the stage it replaced, and ``graphs`` holds each main path's graph replays bit for bit against its
eager runs (a full batch, then a shorter one with holes) and times a
dispatch both ways. Each main path reports its decodes, host copies per
image, its graph replays and a ``pipeline`` block (batches in flight,
assembly of batch N+1 beside batch N on the host clock, H2D beside compute
in CUDA events). After them ``ragged_vs_classic`` holds each ragged
engine's answers against its own classic rgb wire on the same images,
``pipeline_depth`` runs the default server path at depth 1 and 4 on the
same burst, ``backlog`` posts 48 images at once to a server with
``max_queue=8`` (only 200 and 503 with ``Retry-After``), and
``default_server`` boots the server with no model or wire flags in a
process of its own twice on one fresh kernel build cache (the second boot
must build nothing), sends it three JPEGs and stops it. ``normalize``
counts the elements of the plain preprocess that the exact division
changed. ``registry`` serves Inception-v3 (bf16) and MobileNetV2 (int8)
side by side in one process behind the keep-alive front end, drives both
by ``?model=`` from 8 keep-alive connections (the kernels' counts read
over that load and attributed to the engines by their batches), swaps
Inception three times under that load (no answer but 200, no nvcc, the
device memory back after each retired version) and unloads MobileNetV2;
``sigterm`` starts the server through its entry point and sends SIGTERM
with requests in flight (each answers 200, the process exits 0).
``overload`` serves MobileNetV2 bf16 and its int8 tier in one process with
the response cache and overload control on: a pass of hits that runs
nothing on the card, 16 identical requests coalesced onto one row, a 304
for a current ETag, a tenant over its quota answered 429, a hot swap that
drops the old version's entries, a flood of 256 distinct images with a 100
ms deadline (statuses, sheds and ladder levels reported), a drill that
holds the queue at 0.75 so that the ladder reroutes to the int8 tier (the
fused depthwise kernel's launches counted on it), and a chaos drill on a
second server whose answers match the faults injected. Every earlier phase
that counts device work or compares top-k runs with the cache off and a
ladder that cannot climb (``PINNED``); ``default_server`` runs the CLI's
defaults and checks its ``X-Cache`` and 304. ``observability`` serves
``registry``'s two models with tracing, the access log and a 0.2 s
telemetry sampler on, drives them with ``tools/loadgen.py`` from a process
of its own, holds ``/metrics`` to its invariants, reads the MFU and
roofline fraction of every (canvas, batch) cell against the card's peak
and the device's idle share from CUDA events, checks the exported
timeline, a ``torch.profiler`` capture, the telemetry history, a hot swap
in the event ring and the access log, and reports the hub's and the log's
overhead; its idle share is the union of both engines' compute intervals
(each engine enqueues on a compute stream of its own). ``placement`` checks
the placement parser on the card's mesh (its accepted specs, its refusals
with the reference's texts, a server given ``,replicas=2`` failing that
load), serves ``registry``'s pair again with each engine on its own stream
under ``tools/loadgen.py``, holds both models' top-k on the 24 JPEGs bit for
bit before and after the load, reports the union and summed busy shares,
the idle share and the share of the window in which both engines computed
at once, and unloads the int8 model with its memory margin held to the
range ``registry`` measured before (``UNLOAD_MARGIN_MB``). ``resnet50``
serves ResNet-50 in bf16 at full width with batch buckets up to 32 on the
ragged rgb wire: a burst and the same JPEGs one at a time, batch-32 slabs
back to back on the captured graph (img/s, ms per replay, MFU), the
unpack and ragged preprocess kernels against their plain versions on
those slabs, a 96-image HTTP
burst, its logits against a float32 engine's and the float32 engine's
against the CPU's, and its int8 tier's load, which the gate refuses as
the reference's does.
``ssd`` serves the detector SSD-MobileNet in bf16 at full width and 300
px the same way: the 24 JPEGs one at a time and at once (every answer
the reference's ``detections``/``num_detections``), batch-32 slabs back
to back, the NMS kernel against its plain fixpoint bit for bit on a
served batch's candidates (at K = 33, 65, 99, 100 and 256 too, each
timed) and on adversarial rows, an anchor scene whose
detections must equal the host's expectation exactly, its raw outputs
against float32 and the CPU, the fused depthwise and preprocess kernels
at its own shapes, and its int8 tier, refused at 300 px and served at 64.
``converter`` writes full-width ``inception_v3.pb``, ``mobilenet_v2.pb``,
``resnet50.pb`` and ``ssd_mobilenet.pb`` into ``artifacts/`` with the
port's TF-free tool (the zoo's seeded
weights) and serves the preset ``inception_v3`` through the frozen-graph
converter as CUDA graph replays, beside ``native:inception_v3`` on the same
weights, in bf16 and float32: the .pb path's answers against native's, its
preprocess kernel launches on the yuv420 wire and ragged preprocess
launches on the ragged wire, and for both paths the load seconds, kernels per replay,
device ms per batch-8 and batch-32 replay, batch-32 img/s and MFU; then
``mobilenet_v2.pb`` in bf16 and int8 (the gate's verdict, no leaf
quantized); then ``resnet50.pb`` (224 px, on the ragged wire: one ragged
preprocess launch a batch) and ``ssd_mobilenet.pb`` (300 px, the anchor scene's
weights, on the yuv420 wire: one preprocess and one ``nms_fixed`` launch a
batch) the same way beside ``native:resnet50`` and
``native:ssd_mobilenet``, their logits and raw outputs against native
float32's, and the CLI serving ``--model ssd_mobilenet``. ``jobs`` serves Inception-v3 bf16 on the yuv420 wire with
``max_batch`` 256 and ``--jobs-dir``: a ``POST /jobs`` over 1,024 distinct
JPEGs in batches of 256 (one preprocess launch and one graph replay a bulk
batch, every image once, the first 24 against ``/predict``), the
preprocess kernel at B = 256 against its plain version, interactive
p50/p99 without and with a job from ``tools/loadgen.py --job``, a hot swap
mid-job, SIGTERM mid-job and a reboot that resumes from the checkpoint,
and a job answered wholly from the cache. ``dag`` serves ``--pipeline
analyze=ssd_mobilenet>mobilenet_v2@int8`` (SSD-MobileNet bf16 at 300 px on
the anchor scene, then MobileNetV2 int8 on 8 crops made on the card):
``POST /pipelines/analyze`` one at a time and from 8 workers (composites
equal, both stages graph replays, 1 ``nms_fixed`` and 17 ``fused_dw``
launches a request), the composites against the stage-by-stage calls
(detector ``run_batch`` → ``crop_resize_host`` → classifier ``run_batch``),
D2H bytes against ``/predict``, e2e p50/p99 and img/s, the glue's µs, a
classifier hot swap under traffic, and the CLI with ``--pipeline``.
``train`` trains MobileNetV2 at full width (224 px, batch 32, 10
synthetic classes, float32) through ``tools/train.py`` for 20 steps and
resumes the same command to 40 (its loss must fall under 0.8× the first
logged), times a step (CUDA events, img/s, peak memory, kernels a step from
the profiler, the depthwise kernel gradient's share), trains ResNet-50 and
Inception-v3 3 steps each, holds one float64 SGD step on the card against
the CPU, and serves the export with ``--ckpt`` (bf16, fused depthwise
cells, yuv420 + the preprocess kernel) to the photographs, and in float32
to them and to JPEGs of the tool's blobs: every top-k entry labelled from
the export and scored within the tier's tolerance (``SERVED_TOL`` in
float32; in bf16 the engine's bf16 gate, or twice the plain bf16 model's
gap where that is larger) of the float32 model built from the export,
top-1 equal to it past that margin, the preprocess and fused
depthwise kernels launched on every batch's replay and no other kernel.
``distributed`` trains across ranks through the port's bootstrap
(``TPU_SERVE_COORDINATOR`` on the loopback): ``tools/train.py`` at world
size 1 over NCCL on the card (MobileNetV2 as in ``train``, 10 steps),
between two plain runs of the same seed whose largest loss gap sets its
tolerance, its step timed in turns against the plain one with the NCCL
all-reduce's device µs from the profiler; the tool on 4 gloo ranks of the
CPU (data 2 × model 2, batch 8, 3 steps, a checkpoint); that checkpoint
restored on the card at world size 1, bit for bit, resumed 3 steps, and
its export served with ``--ckpt`` in float32 (1 ``preprocess_i420`` and
17 ``fused_dw`` launches a batch, every batch a replay).
``witness`` runs ``chip_smoke.py --phase witness`` as a child with
``TWD_DEBUG_LOCKS=1``, so that every lock of the port, module-level ones
included, is the lock-order witness's: one in-process server (Inception-v3
bf16 on yuv420 through the preprocess kernel; MobileNetV2 int8 with its
fused depthwise cells and SSD-MobileNet on the ragged rgb wire; the cache,
the ladder, ``--jobs-dir`` and the pipeline on) takes distinct JPEGs from 8
clients (img/s with the witness on), a hot swap under traffic, a bulk job
to DONE, pipeline requests, a tenant's burst that sheds, a ``POST
/debug/trace`` and a graceful shutdown; the witness must count no
violation, and it prints its edges, acquisitions by name, the declared
names never taken and the dispatch guard's peak holders, beside both TPU
kernels' launches (each > 0). ``profile`` runs the port's
``tools/profile_serve.py`` on Inception-v3 bf16 batch 8 (yuv420) and
ResNet-50 bf16 batch 32 (ragged), canvas 512: every kernel of the replay
by name and kind, the summed device µs within 10% of the replay's CUDA-event
ms, the preprocess kernel under its own name; then boots the server with
``--profile`` and takes a capture on its listener's port while it serves.

The preprocess kernel is checked through both of its entries (the
``[B, 2]`` table and the wire buffer whose trailers it reads itself) in
float32 and bf16, and both main paths feed their models its bf16 output
directly: one launch for the whole preprocess stage, which the
``preprocess_stage`` lines show with the profiler. On the yuv420 wire that
output is the stem's space-to-depth cells (the handshake, ``/stats →
engine.s2d``): ``s2d_stem`` holds the kernel's cell store bit for bit
against ``pack_s2d`` of its NHWC store and against its plain version
within the NHWC store's tolerances (batch 8 and 32, 299/224/300 out), and
times the four presets' stems three ways (the plain stride-2 conv, fold +
stride-1 conv, the stride-1 conv on cells) beside their bounds, after
holding both rewrites to the plain conv in float32.

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

    python3 chip_smoke.py --sweep-overload

runs ``overload``'s flood on fresh servers under other pipeline depths,
assembly windows and image sizes and records the queue fraction every
ladder observation saw (no ``ok`` line).

    python3 chip_smoke.py --sweep-dag

runs ``dag``'s server under closed-loop pipeline requests from 1, 2, 4
and 8 workers and prints, per worker count, img/s, p50/p99 and the host
ms a request spent in each executor call (no ``ok`` line).

    python3 chip_smoke.py --sweep-nms OTHER.cu

builds ``OTHER.cu``, another version of ``csrc/nms_fixed.cu`` with the
same C entry (an earlier commit's: ``git show <commit>:<path>``), and on
the ``ssd`` phase's candidates at every ``NMS_CASES`` shape holds both
kernels' keep masks to the plain fixpoint and times them in the order
other, this, this, other (no ``ok`` line).

    python3 chip_smoke.py --phase ragged_preprocess
    python3 chip_smoke.py --phase s2d_stem
    python3 chip_smoke.py --phase resnet50
    python3 chip_smoke.py --phase ssd
    python3 chip_smoke.py --phase converter
    python3 chip_smoke.py --phase jobs
    python3 chip_smoke.py --phase dag
    python3 chip_smoke.py --phase train
    python3 chip_smoke.py --phase distributed
    python3 chip_smoke.py --phase witness
    python3 chip_smoke.py --phase profile

build the kernels and run the ``ragged_preprocess``, ``s2d_stem``,
``resnet50``, ``ssd``, ``converter``, ``jobs``, ``dag``, ``train``,
``distributed``, ``witness`` or ``profile`` phase alone on the 24 JPEGs
(no ``kernels`` or ``ok`` line).

    python3 chip_smoke.py --phase replays

times the replay and counts the kernels of four main-path graphs
(Inception-v3 bf16 and MobileNetV2 int8 at batch 8 on the yuv420 wire,
ResNet-50 and SSD-MobileNet bf16 at batch 32 on the ragged wire) through
engine calls that earlier commits have too: copied into a ``git archive``
of another commit, the script times that commit's package, so two trees
compare in one call (no ``ok`` line).
"""

from __future__ import annotations

import copy
import http.client
import io
import json
import math
import os
import signal
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from dataclasses import replace

import numpy as np
import torch

MEM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_FLOPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
OUT = 299  # Inception-v3 input side
SEED = 0
KERNELS = ("preprocess_i420", "fused_dw", "unpack_ragged", "preprocess_ragged", "nms_fixed")
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
# the four main paths: (model, dtype, _config's wire arguments)
MAIN_PATHS = (("inception_v3", "bfloat16", {}), ("mobilenet_v2", "int8", {}),
              *((name, dtype, {"wire": "rgb", "resize": resize, "ragged": True})
                for name, dtype, resize in RAGGED_PATHS))
# the default server's buckets: canvas 256..2048 × batch 1..32
DEFAULT_PAIRS = 4 * 6
# Every phase that counts device work or compares top-k serves with the
# response cache off and a degradation ladder that cannot climb (a queue
# fraction never reaches 2): a repeat would be answered from the cache, and
# a burst could clamp top-k to 1 or move images to a smaller canvas.
# ``default_server`` runs the CLI's defaults; ``overload`` sets its own.
NO_LADDER = "2:2,2:2,2:2"
PINNED = {"cache_bytes": 0, "pressure_rungs": NO_LADDER}
PINNED_ARGS = ["--cache-bytes", "0", "--pressure-rungs", NO_LADDER]


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


def kernel_wrappers() -> dict:
    """Every hand-written kernel's wrapper, by name (``KERNELS``' order)."""
    from tensorflow_web_deploy_tpu_torch.ops.detection import nms_fixed
    from tensorflow_web_deploy_tpu_torch.ops.fused_dw import fused_dw
    from tensorflow_web_deploy_tpu_torch.ops.image import unpack_ragged
    from tensorflow_web_deploy_tpu_torch.ops.preprocess_i420 import preprocess_i420
    from tensorflow_web_deploy_tpu_torch.ops.preprocess_ragged import preprocess_ragged

    return {"preprocess_i420": preprocess_i420, "fused_dw": fused_dw,
            "unpack_ragged": unpack_ragged, "preprocess_ragged": preprocess_ragged,
            "nms_fixed": nms_fixed}


def zero_launches() -> None:
    """Set every kernel's launch count to 0."""
    for w in kernel_wrappers().values():
        w.launches = 0


def read_launches() -> dict:
    """Every kernel's launch count, by name."""
    return {name: w.launches for name, w in kernel_wrappers().items()}


def launches_want(**counts: int) -> dict:
    """The launch counts a run must read: ``counts`` by kernel, 0 for the
    other kernels."""
    return {name: counts.get(name, 0) for name in KERNELS}


def bound_ms(hws: np.ndarray, s: int, out_h: int, out_w: int, elt: int,
             meta_bytes: int, s2d: bool = False) -> tuple[float, str]:
    """Least time for one preprocess call on this batch: the canvas bytes
    its taps need (tap rows × tap columns of Y, and of U and V at half
    resolution), ``meta_bytes`` per image for the valid size (8 from a
    table, 4 from a trailer) and the output at ``elt`` bytes an element
    (``s2d``: the cells, an odd extent's zero phases included), over the
    memory rate; or ~55 float32 operations per output pixel over the
    float32 rate, whichever is larger."""
    from tensorflow_web_deploy_tpu_torch.ops.preprocess_i420 import axis_taps

    read = len(hws) * meta_bytes
    for h, w in hws:
        (rlo, rhi, _), (clo, chi, _) = axis_taps(out_h, h, s), axis_taps(out_w, w, s)
        rows, cols = np.unique(np.concatenate([rlo, rhi])), np.unique(np.concatenate([clo, chi]))
        read += rows.size * cols.size + 2 * np.unique(rows // 2).size * np.unique(cols // 2).size
    out_elems = ((out_h + 1) // 2 * ((out_w + 1) // 2) * 12 if s2d else out_h * out_w * 3)
    written = len(hws) * out_elems * elt
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


# The zoo's four stems: (preset, input side, kernel, padding, output channels)
STEMS = (("inception_v3", 299, 3, "VALID", 32), ("mobilenet_v2", 224, 3, "SAME", 32),
         ("ssd_mobilenet", 300, 3, "SAME", 16), ("resnet50", 224, 7, "SAME", 64))
STEM_BATCHES = (8, 32)
# the stem's two routes in float32 (TF32 off), max |Δ| over max |plain|:
# the reference's tests/test_stem.py holds its rewrite to lax's conv at 1e-5
STEM_F32_RTOL = 1e-5
CELL_CASES = ((299, "inception"), (224, "inception"), (300, "inception"), (299, "zero_one"),
              (224, "raw"))


def stem_bound_ms(b: int, in_elems: int, out_elems: int, flops: int, peak: dict
                  ) -> tuple[float, str]:
    """Least time for one stem conv in bf16: its input and output bytes (2
    an element) over the memory rate, or the logical conv's FLOPs over the
    card's bf16 peak (``costmodel.cuda_peak``), whichever is larger."""
    t_bytes = b * (in_elems + out_elems) * 2 / MEM_BYTES_PER_S * 1e3
    t_ops = b * flops / peak["flops_per_chip"] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_s2d_stem(gen: torch.Generator) -> dict:
    """The space-to-depth stem (ops/stem.py) and its handshake with the
    yuv420 preprocess, on the card.

    - The cell store: ``preprocess_i420`` with ``s2d`` at batch 8 and 32,
      canvas 512 (full rows, holes, random sizes) and the ``CELL_CASES``
      (out, mode), in float32 and bf16, through both entries: equal bit for
      bit to ``pack_s2d`` of the NHWC store and the entries to each other;
      against its plain version (``pack_s2d`` of ``preprocess_i420_plain``)
      within the NHWC store's tolerances. bf16 at inception mode timed as
      cells and as NHWC, each beside its bound.
    - The stems: per preset (``STEMS``) and batch, bf16, channels_last, the
      device µs of the plain stride-2 conv (F.pad + stride 2; the tests'
      plain version), the rgb wires' route (fold + stride-1 conv on the
      rearranged kernel) and the handshake's (the stride-1 conv on cells
      alone), each beside its bound; in float32 (TF32 off) the routes
      against the plain conv within ``STEM_F32_RTOL``; in bf16 each
      image's result from the two rewrites at batch 1 equal to the
      batch's call, bit for bit (the plain conv's reported)."""
    import torch.nn.functional as F

    from tensorflow_web_deploy_tpu_torch.ops import stem
    from tensorflow_web_deploy_tpu_torch.ops.preprocess_i420 import (
        preprocess_i420,
        preprocess_i420_plain,
        preprocess_i420_wire,
        wire_canvases,
    )
    from tensorflow_web_deploy_tpu_torch.serving import costmodel

    t0 = time.perf_counter()
    rs = np.random.RandomState(SEED + 21)
    s, bf16 = 512, torch.bfloat16
    cell_rows = []
    for b in STEM_BATCHES:
        hws_np = rs.randint(1, s + 1, (b, 2)).astype(np.int32)
        hws_np[0], hws_np[1] = (s, s), (1, 1)  # a full row and a hole
        buf = wire_batch(b, s, hws_np, gen)
        packed, hws = wire_canvases(buf, s), torch.from_numpy(hws_np).cuda()
        for out, mode in CELL_CASES:
            row = {"batch": b, "out": out, "mode": mode}
            ref = preprocess_i420_plain(packed, hws, out, out, mode, s2d=True)
            for dtype in (torch.float32, bf16):
                got = preprocess_i420(packed, hws, out, out, mode, dtype, s2d=True)
                wire = preprocess_i420_wire(buf, s, out, out, mode, dtype, s2d=True)
                nhwc = preprocess_i420_wire(buf, s, out, out, mode, dtype)
                torch.cuda.synchronize()
                tag = "f32" if dtype == torch.float32 else "bf16"
                row[f"{tag}_equals_packed_nhwc"] = bool(torch.equal(wire, stem.pack_s2d(nhwc)))
                row[f"{tag}_entries_equal"] = bool(torch.equal(got, wire))
                row[f"{tag}_equals_plain"] = bool(torch.equal(got.float(), ref if dtype ==
                                                              torch.float32 else ref.to(dtype)
                                                              .float()))
                if dtype == torch.float32:
                    row["max_abs_err"] = float((got - ref).abs().max())
                    if not row["max_abs_err"] <= KERNEL_TOL[mode]:
                        raise AssertionError(f"cell store vs plain: {row}")
                else:
                    row.update(bf16_vs_plain(got, ref, mode))
                if not (row[f"{tag}_equals_packed_nhwc"] and row[f"{tag}_entries_equal"]):
                    raise AssertionError(f"cell store is not pack_s2d of the NHWC store: {row}")
            if mode == "inception":
                row.update(
                    us=1e3 * graph_time_ms(lambda: preprocess_i420_wire(
                        buf, s, out, out, mode, bf16, True)),
                    nhwc_us=1e3 * graph_time_ms(lambda: preprocess_i420_wire(
                        buf, s, out, out, mode, bf16)),
                    bound_us=1e3 * bound_ms(hws_np, s, out, out, 2, 4, True)[0],
                    nhwc_bound_us=1e3 * bound_ms(hws_np, s, out, out, 2, 4)[0])
            cell_rows.append(row)
            emit({"phase": "s2d_cell_store", **row})
        del buf, packed, ref
    peak = costmodel.cuda_peak(torch.cuda.get_device_name(0), "bfloat16")
    stems = []
    for name, size, k, padding, cout in STEMS:
        w32 = torch.randn((cout, 3, k, k), generator=gen, device="cuda") * 0.1
        pads = stem.stride2_pads((size, size), (k, k), padding)
        oh = (size + sum(pads[0]) - k) // 2 + 1
        ch = (size + 1) // 2
        flops = 2 * oh * oh * cout * 3 * k * k
        for b in STEM_BATCHES:
            x32 = torch.rand((b, 3, size, size), generator=gen, device="cuda").to(
                memory_format=torch.channels_last) * 2 - 1
            row = {"model": name, "batch": b, "size": size, "kernel": k, "padding": padding,
                   "cout": cout, "out": oh, "cells": ch, "flops": b * flops}
            # float32: the two routes against the plain stride-2 conv
            plain32 = stem.conv2d_padded(x32, w32, (2, 2), pads)
            cells32 = stem.pack_s2d(x32.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
            for label, y in (("fold", stem.conv2d_stride2_s2d(x32, w32, padding)),
                             ("cells", stem.conv2d_s2d_input(cells32, w32, padding))):
                row[f"f32_{label}_rel"] = float((y - plain32).abs().max()
                                                / plain32.abs().max())
            if max(row["f32_fold_rel"], row["f32_cells_rel"]) > STEM_F32_RTOL:
                raise AssertionError(f"stem routes disagree in float32: {row}")
            x, w = x32.to(bf16), w32.to(bf16)
            cells = stem.pack_s2d(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
            k_fold, k_cells = stem.s2d_kernel(w), stem.s2d_input_kernel(w, padding)
            with torch.inference_mode():
                # an image's result must not depend on its batch: each route
                # per image at batch 1 against the batch's call, bit for bit
                routes = {"plain": lambda t: stem.conv2d_padded(t, w, (2, 2), pads),
                          "fold": lambda t: stem.conv2d_stride2_s2d(t, w, padding,
                                                                    rearranged=k_fold),
                          "cells": lambda t: stem.conv2d_s2d_input(
                              stem.pack_s2d(t.permute(0, 2, 3, 1)).permute(0, 3, 1, 2), w,
                              padding, rearranged=k_cells)}
                for label, fn in routes.items():
                    row[f"{label}_batch_invariant"] = bool(torch.equal(
                        fn(x), torch.cat([fn(x[i:i + 1]) for i in range(b)])))
                if not (row["fold_batch_invariant"] and row["cells_batch_invariant"]):
                    raise AssertionError(f"stem routes depend on the batch: {row}")
                row.update(
                    plain_us=1e3 * graph_time_ms(lambda: stem.conv2d_padded(x, w, (2, 2), pads)),
                    fold_us=1e3 * graph_time_ms(lambda: stem.conv2d_stride2_s2d(
                        x, w, padding, rearranged=k_fold)),
                    fold_only_us=1e3 * graph_time_ms(
                        lambda: stem.pack_s2d(x.permute(0, 2, 3, 1))),
                    cells_us=1e3 * graph_time_ms(lambda: stem.conv2d_s2d_input(
                        cells, w, padding, rearranged=k_cells)),
                    # a yardstick only: cuDNN's stride-2 conv with its own
                    # symmetric padding, no F.pad (not lax's pads at SAME)
                    library_us=1e3 * graph_time_ms(lambda: F.conv2d(
                        x, w, None, 2, 0 if padding == "VALID" else k // 2)))
            out_elems = cout * oh * oh
            t, row["bound_by"] = stem_bound_ms(b, 3 * size * size, out_elems, flops, peak)
            row["bound_us"] = 1e3 * t  # plain and fold: the image in, the output out
            row["cells_bound_us"] = 1e3 * stem_bound_ms(b, 12 * ch * ch, out_elems, flops,
                                                        peak)[0]
            stems.append(row)
            emit({"phase": "s2d_stem_conv", **row})
            del x32, x, cells, cells32, plain32
    result = {"phase": "s2d_stem", "nvidia_smi": nvidia_smi(),
              "cell_store_bit_identical_to_packed_nhwc": all(
                  r["f32_equals_packed_nhwc"] and r["bf16_equals_packed_nhwc"] for r in cell_rows),
              "cell_store_equals_plain": {f"{r['batch']}x{r['out']}x{r['mode']}":
                                          [r["f32_equals_plain"], r["bf16_equals_plain"]]
                                          for r in cell_rows},
              "cell_store_max_abs_err": max(r["max_abs_err"] for r in cell_rows),
              "seconds": time.perf_counter() - t0}
    emit(result)
    return {**result, "cells": cell_rows, "stems": stems}


REPLAY_PATHS = (("inception_v3", "bfloat16", "yuv420", 8), ("mobilenet_v2", "int8", "yuv420", 8),
                ("resnet50", "bfloat16", "ragged", 32), ("ssd_mobilenet", "bfloat16", "ragged", 32))


def replay_answers(eng, jpegs: list[bytes]) -> list[dict]:
    """Each image's answer from ``eng`` (one engine batch call): a
    classifier's top-2 (index, score), a detector's detection count and
    first (class, score)."""
    if eng.ragged:
        prep = [eng.prepare_ragged(d) for d in jpegs]
        out = eng.run_ragged([t for t, *_ in prep], np.array([p[1] for p in prep], np.int32),
                             512)
    else:
        prep = [eng.prepare_bytes(d) for d in jpegs]
        out = eng.run_batch(np.stack([c for c, *_ in prep]),
                            np.array([p[1] for p in prep], np.int32))
    if eng.task == "detect":
        return [{"num": int(n), "class": int(c[0]), "score": float(sc[0])}
                for _, sc, c, n in zip(*out)]
    return [{"index": [int(i) for i in idx[:2]], "score": [float(v) for v in sc[:2]]}
            for sc, idx in zip(*out)]


def answers_against(got: list[dict], ref: list[dict]) -> dict:
    """The margin-aware top-1 agreement of ``got`` with ``ref`` (a run of
    the same engine on another tree): an image agrees when its top-1 is
    ref's, or when ref's top-2 margin lies within bf16's rounding of its
    top-1 (2^-7 relative, both serving dtypes compute in bf16); those are
    listed, not counted as misses. A detector agrees on its count and
    first class where ref's first score stands 2^-7 clear."""
    rows, ties, miss = len(ref), [], []
    for i, (g, r) in enumerate(zip(got, ref)):
        if "index" in r:
            same = g["index"][0] == r["index"][0]
            tie = r["score"][0] - r["score"][1] <= 2 ** -7 * r["score"][0]
        else:
            same = (g["num"], g["class"]) == (r["num"], r["class"])
            tie = abs(g["score"] - r["score"]) <= 2 ** -7 * r["score"]
        if not same:
            (ties if tie else miss).append({"image": i, "got": g, "ref": r})
    return {"images": rows, "agree": rows - len(ties) - len(miss), "within_rounding": ties,
            "misses": miss}


def phase_replays(save: str | None = None, against: str | None = None) -> list[dict]:
    """Replay ms and kernels per replay of four main-path graphs, each from
    an engine's own warmup capture (canvas 512): Inception-v3 bf16 and
    MobileNetV2 int8 at batch 8 on the yuv420 wire (preprocess kernel),
    ResNet-50 and SSD-MobileNet bf16 at batch 32 on the ragged rgb wire
    (matmul resize); then each engine's answers to the 24 JPEGs, written to
    ``save`` and held to those in ``against`` (:func:`answers_against`:
    a miss fails the phase). Uses only the engine's API that earlier
    commits have too, so that this script, copied into a checkout of
    another commit, times that commit's package: ``python3 <that
    checkout>/chip_smoke_ab.py --phase replays`` (``package`` names the one
    measured)."""
    import tensorflow_web_deploy_tpu_torch as pkg
    from tensorflow_web_deploy_tpu_torch.serving.engine import InferenceEngine

    jpegs = make_jpegs(24, SEED)
    ref = json.load(open(against)) if against else None
    rows, answers = [], {}
    for name, dtype, wire, batch in REPLAY_PATHS:
        kw = (dict(wire="rgb", resize="matmul", ragged=True) if wire == "ragged"
              else dict(wire="yuv420", resize="kernel"))
        eng = InferenceEngine(_config(name, dtype, canvas_buckets=(512,), max_batch=batch,
                                      **kw), device="cuda", seed=SEED)
        try:
            eng.warmup()
            shard = eng._replicas[0].shards[0]
            key = next(k for k in shard.exes if k[1] == 512 and k[2] == batch)
            exe = shard.exes[key]
            with eng._replicas[0].lock, torch.cuda.stream(shard.compute):
                ms = [cuda_time_ms(exe) for _ in range(3)]
                prof = profiled_calls(exe, calls=2)
            del exe
            path = f"{name}:{dtype}:{wire}"
            answers[path] = replay_answers(eng, jpegs)
            row = {"phase": "replays", "package": os.path.dirname(pkg.__file__), "model": name,
                   "dtype": dtype, "wire": wire, "batch": batch,
                   "s2d": eng.stats().get("s2d"), "replay_ms": ms,
                   "kernels_per_replay": prof["kernels"] / prof["calls"],
                   "profile_top": prof["top"][:5]}
            if ref is not None:
                row["answers_against"] = answers_against(answers[path], ref[path])
            rows.append(row)
            emit(row)
        finally:
            eng.close()
    if save:
        with open(save, "w") as f:
            json.dump(answers, f)
    bad = [r for r in rows if r.get("answers_against", {}).get("misses")]
    if bad:
        raise AssertionError(f"answers differ from {against}: {bad}")
    return rows


def dw_bound_ms(b: int, c: int, h: int, w: int, oh: int, ow: int, elt: int, kk: int,
                relu6: bool) -> tuple[float, str]:
    """Least time for one fused depthwise call: the input and output
    activations (``elt`` bytes each), the float32 taps and bias over the
    memory rate; or kk multiplies + kk adds, the bias add and the clamp per
    output element over the float32 rate, whichever is larger."""
    t_bytes = (b * c * (h * w + oh * ow) * elt + (kk + 1) * c * 4) / MEM_BYTES_PER_S * 1e3
    t_ops = b * c * oh * ow * (2 * kk + 1 + 2 * relu6) / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def dw_layer_shapes(name: str = "mobilenet_v2", size: int = 224) -> list[dict]:
    """Every depthwise cell of a full-width zoo model at ``size`` px
    (MobileNetV2 at 224 unless given): its block, input [C, H, W], stride
    and the reference's "SAME" pads, recorded by forward hooks on one
    image. MobileNetV2 must have its 17 cells, 13 of them stride 1."""
    from tensorflow_web_deploy_tpu_torch.models.adapter import native_converted
    from tensorflow_web_deploy_tpu_torch.models.common import DepthwiseConvBN
    from tensorflow_web_deploy_tpu_torch.ops.depthwise import resolve_pads

    model = native_converted(name, seed=SEED).cuda()
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
        model(torch.zeros((1, size, size, 3), device="cuda"))
    for h in hooks:
        h.remove()
    if name == "mobilenet_v2" and (len(shapes) != DW_CELLS or sum(
            s["stride"] == 1 for s in shapes) != DW_STRIDE1_CELLS):
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


def dw_check(gen: torch.Generator, layers: list[dict], batches=DW_BATCHES) -> dict:
    """Kernel vs plain version at every layer × B in ``batches`` (1, 8, 32
    unless given) × {float32, bf16} × relu6 on/off: each cell must be
    bit-identical (the same float32 operations in the same order, one
    rounding)."""
    from tensorflow_web_deploy_tpu_torch.ops.fused_dw import fused_dw, fused_dw_plain

    worst, cells = 0.0, 0
    for layer in layers:
        for b in batches:
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
    """nvcc -Xptxas -v on csrc/<name>.cu (or on the source file ``name``
    where it ends in .cu): registers, shared memory and spills of each
    kernel instantiation."""
    import tempfile

    from tensorflow_web_deploy_tpu_torch.ops import _build

    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
                               os.path.join(tmp, "lib.so"),
                               name if name.endswith(".cu") else str(_build.CSRC / f"{name}.cu")],
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

                rule = pp._rule(b, s, out, out, 2, 0, False)
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


def jpeg_bytes(img: np.ndarray) -> bytes:
    """An HWC uint8 image as JPEG bytes, quality 90."""
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", quality=90)
    return buf.getvalue()


def make_jpegs(n: int, seed: int) -> list[bytes]:
    """Seeded JPEGs of mixed sizes: smooth colour gradients plus noise,
    sized so that both canvas buckets (256, 512) receive images."""
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
        out.append(jpeg_bytes(np.clip(img + rs.normal(0, 12, img.shape), 0, 255)
                              .astype(np.uint8)))
    return out


def post(url: str, data: bytes) -> tuple[int, dict, float]:
    t0 = time.perf_counter()
    req = urllib.request.Request(url, data=data, method="POST",
                                 headers={"Content-Type": "image/jpeg"})
    with urllib.request.urlopen(req, timeout=120) as r:
        body = json.loads(r.read())
        return r.status, body, time.perf_counter() - t0


def post_full(url: str, data: bytes, headers: dict | None = None
              ) -> tuple[int, dict, bytes]:
    """POST one image with ``headers``; (status, headers in lower case, the
    raw body) whatever the status."""
    req = urllib.request.Request(url, data=data, method="POST",
                                 headers={"Content-Type": "image/jpeg", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, {k.lower(): v for k, v in r.headers.items()}, r.read()
    except urllib.error.HTTPError as e:
        return e.code, {k.lower(): v for k, v in e.headers.items()}, e.read()


def burst(srv, jpegs: list[bytes]) -> tuple[list, dict]:
    """POST every image at once and stamp each stage on the host clock: the
    client's send and receive, the server's accept (``process_request``,
    which hands the connection to the worker pool), the whole ``do_POST``
    (body read and answer written included), the handler
    (``App._predict``), one upload's lease + decode into its slot + commit
    (``App._stage``), the lease alone
    (``lease``/``lease_ragged``, which may wait at the slot cap), each
    batch's launch (the engine's dispatch: H2D + serve enqueue) and fetch
    (the wait for its outputs). Each stage's ``sum`` is wall time and
    ``cpu_sum`` the CPU time of its own thread: where wall far exceeds CPU,
    the thread was waiting (for the interpreter lock, a core or the
    device). The stagings' overlap says how many decoded at once (at most,
    and on average over their span); ``batches_ms`` is each batch's
    launch → done from the batcher's timeline. Returns the answers and a
    summary in ms from the burst's start."""
    marks: dict[str, list[tuple[float, float, float]]] = {}
    lock = threading.Lock()
    handler_cls = srv.httpd.RequestHandlerClass
    hooks = [(srv.httpd, "process_request", "accept"), (handler_cls, "do_POST", "do_post"),
             (srv.app, "_predict", "handler"), (srv.app, "_stage", "prepare"),
             (srv.batcher, "lease", "lease"), (srv.batcher, "lease_ragged", "lease"),
             (srv.engine, "dispatch_staged", "launch"), (srv.engine, "dispatch_ragged", "launch"),
             (srv.engine, "fetch_outputs", "fetch")]
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
        t0, t0_mono = time.perf_counter(), time.monotonic()
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
    timeline = {"wall_ms": wall * 1e3, "cpus": os.cpu_count(), "t0_monotonic": t0_mono,
                "client_send": {"first": ms(min(sends)), "last": ms(max(sends))},
                "client_latency_ms": {q: float(np.percentile(lat, p)) for q, p in
                                      (("p50", 50), ("p99", 99), ("max", 100))}}
    timeline.update({stage: summary(spans) for stage, spans in marks.items()})
    recs = [r for r in srv.batcher.batch_timeline() if r["t_seal"] >= t0_mono]
    timeline["batches_ms"] = [((r["t_launch"] - t0_mono) * 1e3, (r["t_done"] - t0_mono) * 1e3)
                              for r in recs if r["t_done"] is not None]
    timeline["prepare_overlap"] = overlap(marks.get("prepare", []))
    return [r for _, r in results], timeline


def _ov(a: tuple[float, float], b: tuple[float, float]) -> float:
    """Length of the overlap of two intervals."""
    return max(0.0, min(a[1], b[1]) - max(a[0], b[0]))


def pipeline(srv, t0_monotonic: float, batches: int) -> dict:
    """How the burst's batches overlapped: from the batcher's
    ``batch_timeline()``, the most batches in flight (launch → done) at
    once, overall and within one canvas bucket, and the seconds by which
    batch N+1's assembly (open → launch) overlapped batch N's launch →
    done (consecutive batches of one bucket); from the engine's
    ``device_timeline()`` (CUDA events), the ms by which batch N+1's H2D on
    the copy stream overlapped batch N's compute (consecutive dispatches,
    and consecutive ones of one bucket), and both totals."""
    def by_key(rows):
        groups: dict = {}
        for r in rows:
            groups.setdefault(r["key"], []).append(r)
        return groups.values()

    recs = sorted((r for r in srv.batcher.batch_timeline()
                   if r["t_seal"] >= t0_monotonic and r["t_done"] is not None),
                  key=lambda r: r["seq"])
    flight = lambda rs: overlap([(r["t_launch"], r["t_done"], 0) for r in rs])["max"]  # noqa: E731
    dev = srv.engine.device_timeline()[-batches:]
    h2d = lambda rs: sum(_ov(b["h2d"], a["compute"]) for a, b in zip(rs, rs[1:]))  # noqa: E731
    return {
        "batches": len(recs),
        "max_in_flight": flight(recs),
        "max_in_flight_per_bucket": max((flight(rs) for rs in by_key(recs)), default=0),
        "assembly_overlap_s": sum(_ov((b["t_open"], b["t_launch"]), (a["t_launch"], a["t_done"]))
                                  for rs in by_key(recs) for a, b in zip(rs, rs[1:])),
        "h2d_compute_overlap_ms": h2d(dev),
        "h2d_compute_overlap_ms_per_bucket": sum(h2d(rs) for rs in by_key(dev)),
        "h2d_ms": sum(d["h2d"][1] - d["h2d"][0] for d in dev),
        "compute_ms": sum(d["compute"][1] - d["compute"][0] for d in dev),
    }


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
                        **{"canvas_buckets": BUCKETS, "max_batch": 8, "wire_format": wire,
                           "resize": resize, "ragged": ragged, **PINNED, **kw})


def phase_main_path(jpegs: list[bytes], name: str, dtype: str, fused_cells: int,
                    second_burst: bool, serial: bool = True, **wire) -> dict:
    """One main path behind HTTP: boot, a burst of every image at once with
    the kernels' counts set to 0 just before it and read just after, then
    (``second_burst``) the same burst again, and (``serial``) the images one
    at a time. ``wire`` picks the wire (``_config``'s ``wire``, ``resize``,
    ``ragged``). The served model must hold ``fused_cells`` fused
    depthwise cells (of either stride), each launching the fused kernel
    once per batch; the preprocess kernel launches once per batch with
    ``resize="kernel"`` and never otherwise, on the ragged wire the ragged
    preprocess kernel once per batch with the matmul resize and the unpack
    kernel once per batch with the gather resize, and never otherwise.
    Every batch of the burst
    must be a replay of a CUDA graph captured at boot (``graphs.replays``
    equal to the batches, no eager batch); a replay counts the launches its
    capture recorded."""
    from tensorflow_web_deploy_tpu_torch.models.common import DepthwiseConvBN
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
        # the stem handshake: every zoo main path on the yuv420 wire takes cells
        if eng.stats()["s2d"] is not (cfg.wire_format == "yuv420"):
            raise AssertionError(f"{name}: /stats s2d {eng.stats()['s2d']} on {cfg.wire_format}")
        served_cells = sum(1 for m in eng.model.modules()
                           if isinstance(m, DepthwiseConvBN) and m.fused)
        if served_cells != fused_cells:
            raise AssertionError(f"{name}: {served_cells} fused depthwise cells, "
                                 f"want {fused_cells}")
        # the in-process client's first request builds urllib's opener
        # (an SSL context) in every thread that races into it; take that
        # one-time client cost out of the burst
        urllib.request.urlopen(srv.url + "/healthz", timeout=120).read()
        before, copies = eng.stats(), srv.batcher.stats()["host_copies"]
        zero_launches()
        results, timeline = burst(srv, jpegs)
        launches = read_launches()
        after = eng.stats()
        copies = (srv.batcher.stats()["host_copies"] - copies) / len(jpegs)
        batches = after["batches"] - before["batches"]
        wall = timeline["wall_ms"] / 1e3
        k = eng.topk
        for status, body, _ in results:
            preds = body.get("predictions", [])
            if status != 200 or len(preds) != k:
                raise AssertionError(f"bad answer: {status} {body}")
            if not all(math.isfinite(p["score"]) and 0 <= p["index"] < 1000 for p in preds):
                raise AssertionError(f"bad predictions: {preds}")
        want = launches_want(
            preprocess_i420=batches if cfg.resize == "kernel" else 0,
            fused_dw=fused_cells * batches,
            unpack_ragged=batches if eng.ragged and cfg.resize == "gather" else 0,
            preprocess_ragged=batches if eng.ragged and cfg.resize == "matmul" else 0)
        if batches == 0 or launches != want:
            raise AssertionError(f"{name}: kernel launches {launches} for {batches} batches "
                                 f"({fused_cells} fused depthwise cells): want {want}")
        graphs = {k: after["graphs"][k] - before["graphs"][k]
                  for k in ("replays", "eager_batches")}
        if graphs != {"replays": batches, "eager_batches": 0} or \
                after["graphs"]["captured"] != len(BUCKETS) * len(eng.batch_buckets):
            raise AssertionError(f"{name}: {graphs} over {batches} batches, "
                                 f"{after['graphs']['captured']} graphs captured")
        decodes = {d: after["decodes"][d] - before["decodes"][d] for d in after["decodes"]}
        if decodes != {"native": len(jpegs), "pil": 0}:
            raise AssertionError(f"{name}: decodes {decodes}, want all {len(jpegs)} native")
        # each JPEG decoded by libjpeg straight into its leased slot of a
        # pinned slab: one host copy
        pinned = all(slab.buf.is_pinned() for slabs in eng._pool.values() for slab in slabs)
        if copies != 1.0 or not pinned or not eng._pool:
            raise AssertionError(f"{name}: {copies} host copies per image, slabs pinned {pinned}")
        flow = pipeline(srv, timeline["t0_monotonic"], batches)
        path = f"native:{name}" + (":ragged" if eng.ragged else "")
        emit({"phase": "burst_timeline", "model": name, "path": path, "burst": 1, **timeline})
        row = {"phase": "main_path", "model": f"native:{name}", "path": path, "width": 1.0,
               "dtype": cfg.model.dtype, "fused_dw": eng.fused_dw, "parity": eng.parity,
               "wire": cfg.wire_format, "ragged": eng.ragged, "resize": cfg.resize,
               "s2d": after["s2d"],
               "decoder": "native" if after["decoder"]["available"] else "PIL",
               "decoder_reason": after["decoder"]["reason"], "decodes": decodes,
               "requests": len(jpegs), "batches": batches, "kernel_launches": launches,
               "fused_dw_cells": fused_cells, "boot_s": boot_s, "warmup_s": after["warmup_s"],
               "graphs": {**after["graphs"], **{f"burst_{k}": v for k, v in graphs.items()}},
               "host_copies_per_image": copies, "slabs_pinned": pinned,
               "pipeline_depth": cfg.pipeline_depth, "pipeline": flow,
               "h2d_bytes_per_image": (after["h2d_bytes"] - before["h2d_bytes"]) / len(jpegs),
               "img_per_s": len(jpegs) / wall,
               "p50_ms": timeline["client_latency_ms"]["p50"],
               "p99_ms": timeline["client_latency_ms"]["p99"],
               "prepare_overlap": timeline["prepare_overlap"]}
        if second_burst:
            # a second, identical burst: what of the first was one-time cost
            second = burst(srv, jpegs)[1]
            emit({"phase": "burst_timeline", "model": name, "path": path, "burst": 2, **second})
            row.update(burst2_batches=eng.stats()["batches"] - after["batches"],
                       burst2_img_per_s=len(jpegs) / second["wall_ms"] * 1e3,
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
            x = preprocess_i420(packed, hws, out, out, "inception", eng.dtype, eng.s2d)
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
    its bf16 output (the stem's cells on a handshake engine, ``s2d``)
    against the plain version, the kernel's device time (bf16 from the
    wire, in the engine's layout and, beside it, the NHWC store; float32
    from the table), the stage as it ran before (trailer decode + float32
    NHWC kernel + cast) and its two removed parts alone, the plain
    version, the wrapper's host time, the bound, and the kernels each form
    of the stage launches: the engine's must launch the preprocess kernel
    once a call (its counter) and nothing else (the profiler)."""
    from tensorflow_web_deploy_tpu_torch.ops.preprocess_i420 import (
        decode_trailer,
        out_shape,
        preprocess_i420,
        preprocess_i420_plain,
        preprocess_i420_wire,
        wire_canvases,
    )

    s, bf16, cells = 512, torch.bfloat16, eng.s2d
    packed, hws = wire_canvases(buf, s), decode_trailer(buf)
    x = eng.preprocess_packed(buf)
    if x.dtype != eng.dtype or tuple(x.shape) != out_shape(buf.shape[0], out, out, cells):
        raise AssertionError(f"preprocess stage gave {x.dtype} {tuple(x.shape)}")
    ref = preprocess_i420_plain(packed, hws, out, out, s2d=cells)
    x32 = preprocess_i420(packed, hws, out, out, s2d=cells)
    row = {"phase": "preprocess_stage", "batch": buf.shape[0], "canvas": s, "out": out,
           "s2d": cells,
           "max_abs_err": float((x32 - ref).abs().max()), **bf16_vs_plain(x, ref, "inception"),
           "ms": graph_time_ms(lambda: preprocess_i420_wire(buf, s, out, out, "inception", bf16,
                                                            cells)),
           "ms_nhwc": graph_time_ms(lambda: preprocess_i420_wire(buf, s, out, out, "inception",
                                                                 bf16)),
           "ms_f32": graph_time_ms(lambda: preprocess_i420(packed, hws, out, out, s2d=cells)),
           "before_ms": graph_time_ms(lambda: preprocess_before(buf, s, out)),
           "decode_ms": graph_time_ms(lambda: decode_trailer(buf)),
           "cast_ms": graph_time_ms(lambda: x32.to(bf16)),
           "plain_ms": graph_time_ms(lambda: preprocess_i420_plain(
               packed, decode_trailer(buf), out, out, "inception", bf16, cells)),
           "call_ms": cuda_time_ms(lambda: eng.preprocess_packed(buf)),
           "host_us": host_us(lambda: preprocess_i420_wire(buf, s, out, out, "inception", bf16,
                                                           cells)),
           "engine_host_us": host_us(lambda: eng.preprocess_packed(buf)),
           "before_host_us": host_us(lambda: preprocess_before(buf, s, out))}
    hws_np = hws.cpu().numpy()
    row["bound_ms"], row["bound_by"] = bound_ms(hws_np, s, out, out, 2, 4, cells)
    row["bound_ms_nhwc"] = bound_ms(hws_np, s, out, out, 2, 4)[0]
    row["bound_ms_f32"] = bound_ms(hws_np, s, out, out, 4, 8, cells)[0]
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


def phase_normalize(buf: torch.Tensor) -> dict:
    """The plain normalize on the card divides exactly (a 0-dim divisor on
    the device), where the formula before it (``x / 127.5 - 1.0`` and
    ``x / 255.0`` with Python scalars) multiplied by a reciprocal: on every
    float32 a uint8 gives, and on ``preprocess_i420_plain``'s resize of one
    batch of 8 main-path images (512 canvas, 299 out), the elements that
    changed against that formula; the new values must equal numpy's
    float32 division bit for bit."""
    from tensorflow_web_deploy_tpu_torch.ops.image import NORMALIZERS, resize_yuv_planes
    from tensorflow_web_deploy_tpu_torch.ops.preprocess_i420 import decode_trailer, wire_canvases

    before = {"inception": lambda x: x / 127.5 - 1.0, "zero_one": lambda x: x / 255.0}
    exact = {"inception": lambda x: x / np.float32(127.5) - np.float32(1.0),
             "zero_one": lambda x: x / np.float32(255.0)}
    inputs = {"uint8_values": torch.arange(256, dtype=torch.float32, device="cuda"),
              "resized_batch": resize_yuv_planes(wire_canvases(buf, 512), decode_trailer(buf),
                                                 OUT, OUT)}
    row = {"phase": "normalize"}
    for label, x in inputs.items():
        for mode in ("inception", "zero_one"):
            got = NORMALIZERS[mode](x)
            want = torch.from_numpy(exact[mode](x.cpu().numpy())).cuda()
            if not torch.equal(got, want):
                raise AssertionError(f"normalize {mode} on the card is not exact division")
            row[f"{label}_{mode}"] = {"elements": x.numel(),
                                      "changed": int((got != before[mode](x)).sum())}
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
    phase_normalize(buf)
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
            model = native_converted("mobilenet_v2", seed=SEED, fused_dw=fused, int8=int8,
                                     input_format="s2d" if eng.s2d else "nhwc").to(
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
    """One JPEG as the ragged wire takes it: tight RGB rows by libjpeg,
    planned from the header. Returns (flat uint8, (h, w), canvas side)."""
    from tensorflow_web_deploy_tpu_torch import native

    s, need, _, _ = native.plan_decode_packed(data, BUCKETS)
    out = np.empty(need, np.uint8)
    hw = native.decode_packed_into(data, out, s)
    if hw is None:
        raise AssertionError("libjpeg rejected a main-path JPEG")
    return out, hw, s


def phase_native_decode(jpegs: list[bytes]) -> dict:
    """The native decoder, which must be built: which libjpeg it links (the
    system's, or the one Pillow bundles) and that file's version; one
    thread's ms per image over the main paths' JPEGs into each wire (RGB
    canvas, I420 canvas, tight rows) against the PIL chain each replaces
    (decode + pad + the numpy I420 packer; decode + pad; decode +
    ``fit_to_bucket``), and tight rows on 8 threads at once, native and
    PIL. Its RGB must equal PIL's decode of the same bytes byte for byte at
    full size (the same libjpeg where it links Pillow's); an image the DCT
    downscaled is reported by its largest difference."""
    from PIL import Image

    from tensorflow_web_deploy_tpu_torch import native
    from tensorflow_web_deploy_tpu_torch.ops.image import (
        decode_image,
        fit_to_bucket,
        pad_to_canvas,
        rgb_to_yuv420_canvas,
    )

    st = native.status()
    row = {"phase": "native_decode", "built": st["available"], "library": st["library"],
           "lib_version": st["lib_version"], "libjpeg_version": st["libjpeg_version"],
           "reason": st["reason"], "images": len(jpegs), "buckets": list(BUCKETS)}
    if not st["available"]:
        emit(row)
        raise AssertionError(f"the native decoder did not build: {st['reason']}")
    pil_tight = lambda d: fit_to_bucket(decode_image(d), BUCKETS)  # noqa: E731

    def threads8(fn):
        with ThreadPoolExecutor(8) as pool:
            t0 = time.perf_counter()
            list(pool.map(fn, jpegs * 4))
            return (time.perf_counter() - t0) / (4 * len(jpegs)) * 1e3

    row.update(
        pil_i420_ms=per_image_ms(
            lambda d: rgb_to_yuv420_canvas(pad_to_canvas(decode_image(d), BUCKETS)[0]), jpegs),
        pil_rgb_ms=per_image_ms(lambda d: pad_to_canvas(decode_image(d), BUCKETS), jpegs),
        pil_tight_ms=per_image_ms(pil_tight, jpegs),
        native_rgb_ms=per_image_ms(lambda d: native.decode_native(d, BUCKETS, "rgb"), jpegs),
        native_i420_ms=per_image_ms(lambda d: native.decode_native(d, BUCKETS, "yuv420"), jpegs),
        native_tight_ms=per_image_ms(decode_tight, jpegs),
        pil_tight_ms_8_threads=threads8(pil_tight),
        native_tight_ms_8_threads=threads8(decode_tight))
    identical, scaled = 0, []
    for d in jpegs:
        tight, (h, w), _ = decode_tight(d)
        got = tight.reshape(h, w, 3).astype(np.int16)
        im = Image.open(io.BytesIO(d))
        full = im.size == (w, h)
        if not full:
            im.draft("RGB", (w, h))  # libjpeg's DCT scaling, as decode.c asks for it
        ref = np.asarray(im.convert("RGB")).astype(np.int16)
        diff = int(np.abs(got - ref).max()) if ref.shape == got.shape else None
        if full:
            identical += diff == 0
        else:
            scaled.append(diff)
    row.update(identical_vs_pil=identical, full_size=len(jpegs) - len(scaled),
               downscaled_max_abs_diff=scaled)
    emit(row)
    if identical != len(jpegs) - len(scaled):
        raise AssertionError(f"decode.c differs from PIL on {len(jpegs) - len(scaled) - identical}"
                             " full-size JPEGs")
    return row


def ragged_slab(jpegs: list[bytes], s: int, holes: tuple[int, ...] = ()):
    """A pinned ragged slab of ``len(jpegs)`` slots, each image decoded
    tight straight into its arena span; slots in ``holes`` are decoded but
    never committed. Returns
    the slab and the host's padded canvases and valid sizes of the same
    pixels (``pad_to_canvas``; holes: a zero canvas, hw (1, 1))."""
    from tensorflow_web_deploy_tpu_torch import native
    from tensorflow_web_deploy_tpu_torch.ops.image import pad_to_canvas
    from tensorflow_web_deploy_tpu_torch.serving.engine import RaggedSlab

    slab = RaggedSlab(s, len(jpegs), pinned=True)
    canvases = np.zeros((len(jpegs), s, s, 3), np.uint8)
    hws = np.ones((len(jpegs), 2), np.int32)
    for i, data in enumerate(jpegs):
        slot, span = slab.alloc(native.plan_decode_packed(data, BUCKETS)[1])
        hw = native.decode_packed_into(data, span, s)  # libjpeg straight into the arena
        if hw is None:
            raise AssertionError(f"libjpeg rejected main-path JPEG {i}")
        if i not in holes:
            slab.write_hw(slot, hw)
            canvases[i], hws[i] = pad_to_canvas(span.reshape(hw[0], hw[1], 3), (s,))
    return slab, canvases, hws


def phase_ragged_unpack(jpegs: list[bytes]) -> dict:
    """The unpack kernel on 8 main-path images of the 512 canvas, decoded
    tight into a pinned arena and shipped with the meta table in one copy:
    the canvases and valid sizes must equal the host's ``pad_to_canvas``
    bit for bit, with every slot filled and with two holes, and equal the
    plain version (the reference's masked gather); its device time per
    batch (CUDA graph) against its bound and the plain version's, its
    kernels per call (profiler) and launches per call (its counter), the
    wrapper's host time; the copy's time against the classic rgb wire's;
    and the wire bytes per image, ragged against the classic rgb and yuv420
    canvases, with the padded share of each."""
    from tensorflow_web_deploy_tpu_torch.ops.image import unpack_ragged, unpack_ragged_plain

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
        got, got_hw = unpack_ragged(dev[:meta_off], meta, s)
        plain, plain_hw = unpack_ragged_plain(dev[:meta_off], meta, s)
        if not (np.array_equal(got.cpu().numpy(), want)
                and np.array_equal(got_hw.cpu().numpy(), want_hw)):
            raise AssertionError(f"ragged unpack ({label}) differs from pad_to_canvas")
        if not (torch.equal(got, plain) and torch.equal(got_hw, plain_hw)):
            raise AssertionError(f"ragged unpack kernel ({label}) differs from its plain version")
        row[f"bit_identical_{label}"] = True
    # the full batch: times, kernels, bytes
    slab, _, hws = ragged_slab(big, s)
    nbytes, meta_off = slab.stage(k)
    dev = slab.buf[:nbytes].to("cuda")
    arena, meta = dev[:meta_off], dev[meta_off:].view(torch.int32).view(k, 4)
    unpack = lambda: unpack_ragged(arena, meta, s)  # noqa: E731
    launches = unpack_ragged.launches
    prof = profiled_calls(unpack)
    launches_per_call = (unpack_ragged.launches - launches) / prof["fn_calls"]
    if launches_per_call != 1 or len(prof["top"]) != 1 or prof["kernels"] > prof["calls"]:
        raise AssertionError(f"the unpack launched {launches_per_call} kernels a call: {prof}")
    pixel = int(sum(h * w * 3 for h, w in hws))
    classic = torch.zeros((k, s * s * 3 + 4), dtype=torch.uint8, pin_memory=True)
    row.update(
        ms=graph_time_ms(unpack), host_us=host_us(unpack),
        # events around calls: the plain version checks the table on the host
        plain_ms=cuda_time_ms(lambda: unpack_ragged_plain(arena, meta, s), repeats=5),
        launches_per_call=launches_per_call,
        kernels_per_call=prof["kernels"] / prof["calls"], profile_top=prof["top"],
        # least time: read each image's bytes and the meta table once, write
        # every canvas and the valid sizes once
        bound_ms=(pixel + 16 * k + k * s * s * 3 + 8 * k) / MEM_BYTES_PER_S * 1e3,
        bound_by="bytes",
        h2d_ms=cuda_time_ms(lambda: slab.buf[:nbytes].to("cuda", non_blocking=True)),
        h2d_classic_rgb_ms=cuda_time_ms(lambda: classic.to("cuda", non_blocking=True)),
        rows_shipped=slab.rows_shipped(k), pixel_bytes_per_image=pixel / k,
        wire_bytes_per_image={"ragged": nbytes / k, "classic_rgb": s * s * 3 + 4,
                              "classic_yuv420": s * s * 3 // 2 + 4},
        padded_fraction={"ragged": 1 - pixel / nbytes,
                         "classic_rgb": 1 - pixel / (k * (s * s * 3 + 4))})
    row["share_of_bound"] = row["bound_ms"] / row["ms"]
    emit(row)
    return row


# the ragged preprocess kernel's cases: (out side, normalize mode) of
# Inception-v3, ResNet-50 and SSD-MobileNet, at the main paths' batch of 8
# and the batch-32 throughput mode
RAGGED_PP_CASES = ((299, "inception"), (224, "caffe"), (300, "inception"))
RAGGED_PP_BATCHES = (8, 32)
# the kernel against its plain version: float32 within 1e-4 after the
# normalize, bf16 within 1 bf16 ulp at every element
RAGGED_PP_TOL = 1e-4
RAGGED_PP_ULPS = 1


def ragged_pp_bound_ms(meta: np.ndarray, s: int, out: int, elt: int) -> float:
    """Least time for one ragged preprocess call on this batch: the valid
    bytes of each image's distinct tap rows and the meta table read once,
    the output written once at ``elt`` bytes an element, over the memory
    rate (a hole reads nothing)."""
    from tensorflow_web_deploy_tpu_torch.ops.preprocess_i420 import axis_taps

    read = 16 * len(meta)
    for _, h, w, valid in np.asarray(meta).tolist():
        if valid > 0:
            lo, hi, _ = axis_taps(out, h, s)
            read += np.unique(np.concatenate([lo, hi])).size * w * 3
    return (read + len(meta) * out * out * 3 * elt) / MEM_BYTES_PER_S * 1e3


def phase_ragged_preprocess(jpegs: list[bytes]) -> dict:
    """The ragged rgb preprocess kernel (``csrc/preprocess_ragged.cu``) on
    the main-path images of the 512 canvas, decoded tight into a pinned
    arena and shipped with the meta table in one copy, at batch 8 and 32
    (the images cycled), with every slot filled and with two holes: at 299
    out inception, 224 caffe and 300 inception, in float32 (within
    ``RAGGED_PP_TOL`` of ``preprocess_ragged_plain`` on the card) and bf16
    (within ``RAGGED_PP_ULPS`` bf16 ulps). On the full batch in bf16: its
    device time in a CUDA graph against its bound; the stage it replaces
    (``unpack_ragged``, then the matmul resize, normalize and cast, as the
    engine ran it) in a CUDA graph and its kernels (profiler); the plain
    version (events: it reads the table on the host); the wrapper's host
    time; its kernels (profiler) and launches (its counter) a call."""
    from tensorflow_web_deploy_tpu_torch.ops.image import make_preprocess_fn, unpack_ragged
    from tensorflow_web_deploy_tpu_torch.ops.preprocess_ragged import (
        preprocess_ragged,
        preprocess_ragged_plain,
    )

    s, bf16 = 512, torch.bfloat16
    big = [d for d in jpegs if decode_tight(d)[2] == s]
    if len(big) < 8:
        raise AssertionError(f"only {len(big)} images in the {s} canvas")
    result = {"phase": "ragged_preprocess", "nvidia_smi": nvidia_smi(), "canvas": s,
              "images": len(big), "tol": RAGGED_PP_TOL, "ulps": RAGGED_PP_ULPS, "cases": []}
    for k in RAGGED_PP_BATCHES:
        imgs = [big[i % len(big)] for i in range(k)]
        shipped = {}
        for label, holes in (("full", ()), ("holes", (2, 5))):
            slab, _, _ = ragged_slab(imgs, s, holes)
            nbytes, meta_off = slab.stage(k)
            dev = slab.buf[:nbytes].to("cuda")
            shipped[label] = (dev[:meta_off], dev[meta_off:].view(torch.int32).view(k, 4))
        for out, mode in RAGGED_PP_CASES:
            row = {"phase": "ragged_preprocess", "batch": k, "canvas": s, "out": out,
                   "mode": mode}
            for label, (arena, meta) in shipped.items():
                for dtype in (torch.float32, bf16):
                    got = preprocess_ragged(arena, meta, s, out, out, mode, dtype)
                    ref = preprocess_ragged_plain(arena, meta, s, out, out, mode, dtype)
                    torch.cuda.synchronize()
                    if got.dtype != dtype or got.shape != (k, out, out, 3):
                        raise AssertionError(f"ragged preprocess gave {got.dtype} {got.shape}")
                    if dtype == bf16:
                        ulps = int(bf16_ulps(got, ref).max())
                        row[f"bf16_max_ulps_{label}"] = ulps
                        ok = ulps <= RAGGED_PP_ULPS
                    else:
                        err = float((got - ref).abs().max())
                        row[f"max_abs_err_{label}"] = err
                        ok = err <= RAGGED_PP_TOL
                    row[f"bit_identical_{label}_{str(dtype)[6:]}"] = bool(torch.equal(got, ref))
                    if not ok:
                        raise AssertionError(f"ragged preprocess kernel vs plain at B={k} "
                                             f"{out} {mode} {dtype} ({label}): {row}")
            arena, meta = shipped["full"]
            kernel = lambda: preprocess_ragged(arena, meta, s, out, out, mode, bf16)  # noqa: E731
            stage_fn = make_preprocess_fn(out, out, mode, out_dtype=bf16)
            stage = lambda: stage_fn(*unpack_ragged(arena, meta, s))  # noqa: E731
            launches = preprocess_ragged.launches
            prof = profiled_calls(kernel)
            launches_per_call = (preprocess_ragged.launches - launches) / prof["fn_calls"]
            before = profiled_calls(stage)
            if launches_per_call != 1 or len(prof["top"]) != 1 or \
                    "preprocess_ragged" not in prof["top"][0]["name"]:
                raise AssertionError(f"the ragged preprocess launched {launches_per_call} "
                                     f"kernels a call: {prof}")
            row.update(
                ms=graph_time_ms(kernel), stage_ms=graph_time_ms(stage),
                plain_ms=cuda_time_ms(lambda: preprocess_ragged_plain(
                    arena, meta, s, out, out, mode, bf16), repeats=5),
                host_us=host_us(kernel), stage_host_us=host_us(stage),
                launches_per_call=launches_per_call,
                kernels_per_call=prof["kernels"] / prof["calls"],
                stage_kernels_per_call=before["kernels"] / before["calls"],
                stage_top=before["top"][:4],
                bound_ms=ragged_pp_bound_ms(meta.cpu().numpy(), s, out, 2), bound_by="bytes",
                library_ms=None)
            row["share_of_bound"] = row["bound_ms"] / row["ms"]
            emit(row)
            result["cases"].append(row)
    result["max_abs_err"] = max(r[f"max_abs_err_{lb}"] for r in result["cases"]
                                for lb in ("full", "holes"))
    result["bf16_max_ulps"] = max(r[f"bf16_max_ulps_{lb}"] for r in result["cases"]
                                  for lb in ("full", "holes"))
    return result


def fill_slab(eng, prepared: list, holes: tuple[int, ...] = ()):
    """One 512-canvas slab of the engine's wire holding ``prepared`` (the
    engine's ``prepare_ragged`` or ``prepare_bytes`` results), slots in
    ``holes`` left uncommitted."""
    if eng.ragged:
        slab = eng.acquire_ragged(512)
        for i, (tight, hw, *_) in enumerate(prepared):
            slot, span = slab.alloc(tight.nbytes)
            span[:] = tight.reshape(-1)
            if i not in holes:
                slab.write_hw(slot, hw)
        return slab
    slab = eng.acquire_staging(512)
    for i, (canvas, hw, *_) in enumerate(prepared):
        slab.canvases[i] = canvas
        if i not in holes:
            slab.write_hw(i, hw)
    return slab


def dispatch(eng, slab, n: int):
    return (eng.dispatch_ragged if eng.ragged else eng.dispatch_staged)(slab, n)


def dispatch_costs(eng, prepared: list, calls: int = 20) -> dict:
    """Host µs of one dispatch (H2D enqueue, static copy, serve enqueue, D2H
    enqueue; the slab filled beforehand, the outputs fetched after each
    call) and the compute stream's ms per batch from the engine's CUDA
    events, medians over ``calls`` batches."""
    host = []
    for _ in range(calls):
        slab = fill_slab(eng, prepared)
        t0 = time.perf_counter()
        handle = dispatch(eng, slab, len(prepared))
        host.append((time.perf_counter() - t0) * 1e6)
        eng.fetch_outputs(handle)
    dev = eng.device_timeline()[-calls:]
    return {"host_us": statistics.median(host), "host_us_min": min(host),
            "compute_ms": statistics.median(d["compute"][1] - d["compute"][0] for d in dev)}


def phase_graphs(jpegs: list[bytes]) -> list[dict]:
    """Each main path's engine on a batch of 8 main-path images in the 512
    canvas: eagerly before warmup, then as replays of the graphs warmup
    captures (8 pairs: canvas 256 and 512 × batch 1, 2, 4, 8). The full
    batch and then 5 slots with holes at 1 and 3 (the static input keeps
    the full batch's bytes past its prefix) must come out bit-identical to
    eager; host µs per dispatch and compute-stream ms per batch, eager
    against replay; one replay's device time (CUDA events around replays),
    the static copy's device time, kernels per graph (profiler, a lower
    bound) and the hand-written kernels' launches its capture recorded;
    capture seconds, the graph pool and the static bytes."""
    from tensorflow_web_deploy_tpu_torch.serving.engine import InferenceEngine

    rows = []
    for name, dtype, wire in MAIN_PATHS:
        eng = InferenceEngine(_config(name, dtype, warmup=False, **wire), device="cuda",
                              seed=SEED)
        if eng.ragged:
            prepared = [p for p in map(eng.prepare_ragged, jpegs) if p[2] == 512][:8]
        else:
            prepared = [p for p in map(eng.prepare_bytes, jpegs) if p[0].shape[-1] == 512][:8]
        if len(prepared) < 8:
            raise AssertionError(f"only {len(prepared)} images in the 512 canvas")
        batches = ((prepared, ()), (prepared[:5], (1, 3)))

        def run_all():
            return [eng.fetch_outputs(dispatch(eng, fill_slab(eng, p, holes), len(p)))
                    for p, holes in batches]

        with torch.inference_mode():
            eager = run_all()
            eager_costs = dispatch_costs(eng, prepared)
            eng.warmup()
            replayed = run_all()
            replay_costs = dispatch_costs(eng, prepared)
            same = all(np.array_equal(a, b) for e, r in zip(eager, replayed)
                       for a, b in zip(e, r))
            kind = "ragged" if eng.ragged else "classic"
            key = (kind, 512, 8)
            shard = eng._replicas[0].shards[0]  # the card: one replica of one device
            exe = shard.exes[key]
            slab = fill_slab(eng, prepared)
            if eng.ragged:
                nbytes, meta_off = slab.stage(8)
                dev = slab.buf[:nbytes].to("cuda")
            else:
                dev, meta_off = slab.buf[:8].to("cuda"), None
            eng.release_staging(slab)
            try:
                prof = profiled_calls(exe, calls=2)
            except AssertionError:  # the profiler saw no graph kernels: not measured
                prof = {"kernels": None, "calls": 2, "top": []}
            st = eng.stats()
            row = {"phase": "graphs", "model": name, "dtype": dtype,
                   "wire": eng.cfg.wire_format, "ragged": eng.ragged, "resize": eng.cfg.resize,
                   "batch": 8, "canvas": 512, "bit_identical_full_and_holes": same,
                   "eager": eager_costs, "replay": replay_costs,
                   "replay_ms": cuda_time_ms(exe), "static_copy_ms": graph_time_ms(
                       lambda: eng._stage_static(shard, key, dev, meta_off)),
                   "static_copy_bytes": dev.numel(),
                   "kernels_per_graph": prof["kernels"] and prof["kernels"] / prof["calls"],
                   "profile_top": prof["top"][:5],
                   "recorded_launches": {f.__name__: n for f, n in exe.launches.items()},
                   "capture_s_8x512": exe.capture_s, "warmup_s": st["warmup_s"],
                   "graphs": st["graphs"]}
        del exe  # its graph and output would keep the graph pool alive past close()
        eng.close()
        emit(row)
        if not same:
            raise AssertionError(f"{name} {dtype}: replay differs from eager")
        if st["graphs"]["captured"] != len(BUCKETS) * len(eng.batch_buckets) \
                or st["graphs"]["pool_bytes"] <= 0:
            raise AssertionError(f"{name} {dtype}: graphs {st['graphs']}")
        rows.append(row)
    return rows


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
        matches = served_ok(eng, jpegs, dict(enumerate(served[name])))
        row = {"phase": "ragged_vs_classic", "model": name, "dtype": dtype, "resize": resize,
               "images": len(big), "same_top1": bool(np.array_equal(idx_r[:, 0], idx_c[:, 0])),
               "same_topk": bool(np.array_equal(idx_r, idx_c)),
               "max_prob_delta": float(np.abs(scores_r - scores_c).max()),
               "tol_prob": RAGGED_PROB_TOL, "served_images": len(served[name]),
               "served_ok": matches}
        eng.close()
        emit(row)
        if not (row["same_top1"] and row["max_prob_delta"] <= RAGGED_PROB_TOL and matches):
            raise AssertionError(f"ragged vs classic: {row}")
        rows.append(row)
    return rows


def served_ok(eng, jpegs: list[bytes], served: dict[int, tuple[int, float]]) -> bool:
    """The served top-1 (index, score) of each image ``i`` in ``served``
    against the engine's own answers on the ragged wire, batched by canvas:
    a top-1 of the engine's answer and its score, within ``SERVED_TOL``
    (another batch may take another cuDNN algorithm)."""
    prepared = {i: eng.prepare_ragged(jpegs[i]) for i in served}
    answers = {}
    for side in BUCKETS:
        ids = [i for i, p in prepared.items() if p[2] == side]
        if ids:
            got = eng.run_ragged([prepared[i][0] for i in ids],
                                 np.array([prepared[i][1] for i in ids], np.int32), side)
            answers.update({i: (got[0][j], got[1][j]) for j, i in enumerate(ids)})
    ok = True
    for i, (idx, score) in served.items():
        sc, ix = answers[i]
        own = sc[ix == idx]
        ok &= bool(own.size and own[0] >= sc[0] - SERVED_TOL and abs(own[0] - score) <= SERVED_TOL)
    return ok


def phase_pipeline_depth(jpegs: list[bytes]) -> dict:
    """The default server path (Inception-v3 bf16, ragged rgb wire, matmul
    resize) at ``pipeline_depth`` 1 and 4, and at 4 with the window pinned
    at its 2 ms cap (``--no-adaptive-delay``), each booted on its own, on
    the same burst of every image twice: img/s, p50, p99 and the burst's
    pipeline block. Depth 1 runs lockstep within a canvas bucket: one batch
    of it in flight, no H2D beside its previous batch's compute; depth 4
    keeps two or more of a bucket in flight, the next assembling or
    copying beside the current one's compute. A record, not a claim."""
    from tensorflow_web_deploy_tpu_torch.server import start_server

    row = {"phase": "pipeline_depth", "model": "native:inception_v3", "dtype": "bfloat16",
           "wire": "rgb", "ragged": True, "resize": "matmul", "requests": len(jpegs)}
    for label, depth, adaptive in (("depth1", 1, True), ("depth4", 4, True),
                                   ("depth4_fixed_window", 4, False)):
        cfg = _config("inception_v3", "bfloat16", wire="rgb", resize="matmul", ragged=True,
                      host="127.0.0.1", port=0, pipeline_depth=depth, adaptive_delay=adaptive)
        with start_server(cfg, device="cuda", seed=SEED) as srv:
            urllib.request.urlopen(srv.url + "/healthz", timeout=120).read()
            for n in (1, 2):
                batches = srv.engine.stats()["batches"]
                results, timeline = burst(srv, jpegs)
                if any(r[0] != 200 for r in results):
                    raise AssertionError(f"{label}: {[r[0] for r in results]}")
                row[f"{label}_burst{n}"] = {
                    "img_per_s": len(jpegs) / timeline["wall_ms"] * 1e3,
                    "p50_ms": timeline["client_latency_ms"]["p50"],
                    "p99_ms": timeline["client_latency_ms"]["p99"],
                    "pipeline": pipeline(srv, timeline["t0_monotonic"],
                                         srv.engine.stats()["batches"] - batches)}
    emit(row)
    for n in (1, 2):
        flow = row[f"depth1_burst{n}"]["pipeline"]
        if flow["max_in_flight_per_bucket"] != 1 or flow["h2d_compute_overlap_ms_per_bucket"] > 0:
            raise AssertionError(f"depth 1 is not lockstep: {flow}")
        flow = row[f"depth4_burst{n}"]["pipeline"]
        if flow["max_in_flight_per_bucket"] < 2 or not (
                flow["assembly_overlap_s"] > 0 or flow["h2d_compute_overlap_ms_per_bucket"] > 0):
            raise AssertionError(f"depth 4 kept no two batches of a bucket in flight: {flow}")
    return row


def post_any(url: str, data: bytes) -> tuple[int, dict, dict]:
    """POST one image; (status, body, headers) whatever the status."""
    req = urllib.request.Request(url, data=data, method="POST",
                                 headers={"Content-Type": "image/jpeg"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def phase_backlog(jpegs: list[bytes]) -> dict:
    """The default server path with ``--max-queue 8`` and every image posted
    at once: only 200 and 503 answers, each 503 with ``Retry-After``, no
    other 5xx, and each 200 the engine's own answer within ``SERVED_TOL``."""
    from tensorflow_web_deploy_tpu_torch.server import start_server

    cfg = _config("inception_v3", "bfloat16", wire="rgb", resize="matmul", ragged=True,
                  host="127.0.0.1", port=0, max_queue=8)
    with start_server(cfg, device="cuda", seed=SEED) as srv:
        urllib.request.urlopen(srv.url + "/healthz", timeout=120).read()
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=len(jpegs)) as pool:
            results = list(pool.map(lambda d: post_any(srv.url + "/predict", d), jpegs))
        wall = time.perf_counter() - t0
        stats = srv.batcher.stats()
        served = {i: (b["predictions"][0]["index"], b["predictions"][0]["score"])
                  for i, (st, b, _) in enumerate(results) if st == 200}
        ok = served_ok(srv.engine, jpegs, served)
    statuses = [st for st, _, _ in results]
    retry = [h.get("Retry-After") for st, _, h in results if st == 503]
    row = {"phase": "backlog", "max_queue": 8, "requests": len(jpegs), "wall_ms": wall * 1e3,
           "ok_200": statuses.count(200), "rejected_503": statuses.count(503),
           "other": sorted(set(statuses) - {200, 503}), "retry_after": sorted(set(retry)),
           "backlog_rejects": stats["backlog_rejects"], "served_ok": ok}
    emit(row)
    if row["other"] or None in retry or not ok or row["rejected_503"] != stats["backlog_rejects"]:
        raise AssertionError(f"backlog: {row}")
    return row


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def boot_default_server(jpegs: list[bytes], big: bytes, cache_dir: str) -> dict:
    """``python -m tensorflow_web_deploy_tpu_torch.server`` with no model or
    wire flags, only a free port and ``--aot-cache-dir``, in a process of its
    own: its boot seconds (to the first ``/healthz``), three answers, its
    ``/stats`` engine block and its exit code on SIGINT."""
    port = free_port()
    url = f"http://127.0.0.1:{port}"
    t0 = time.perf_counter()
    log = tempfile.TemporaryFile("w+")
    proc = subprocess.Popen([sys.executable, "-m", "tensorflow_web_deploy_tpu_torch.server",
                             "--port", str(port), "--aot-cache-dir", cache_dir],
                            stdout=log, stderr=subprocess.STDOUT, text=True,
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
        answers = [post(url + "/predict", d) for d in (jpegs[2], jpegs[7], big)]
        with urllib.request.urlopen(url + "/stats", timeout=60) as r:
            eng = json.loads(r.read())["engine"]
        # the CLI's response cache: a repeat is a hit with the same ETag, and
        # the ETag as If-None-Match answers 304 with no body
        repeat = post_full(url + "/predict", jpegs[2])
        etag = repeat[1].get("etag")
        unchanged = post_full(url + "/predict", jpegs[2], {"If-None-Match": etag or ""})
        x_cache = {"repeat": [repeat[0], repeat[1].get("x-cache")],
                   "if_none_match": [unchanged[0], len(unchanged[2])],
                   "same_etag": bool(etag) and unchanged[1].get("etag") == etag}
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        log.seek(0)
        warmup_log = [ln.split(": ", 1)[-1] for ln in log.read().splitlines()
                      if "warmup:" in ln]
        log.close()
    return {"boot_s": boot_s, "exit_code": proc.returncode, "eng": eng, "answers": answers,
            "warmup_log": warmup_log, "x_cache": x_cache}


def phase_default_server(jpegs: list[bytes]) -> dict:
    """The server as a user starts it, with no model or wire flags: it must
    boot on the card and serve Inception-v3 on the ragged rgb wire with the
    matmul resize and the decoder the machine allows, at its default
    buckets (canvas up to 2048, batch up to 32: 24 pairs, each captured as
    a CUDA graph at boot). Booted twice on one fresh kernel build cache
    directory: the first boot builds its kernel libraries with nvcc and
    stores them, the second must load every one from the cache and run no
    nvcc (``hits_total`` = its libraries, ``compile_seconds_total`` 0). Each
    boot gets two main-path JPEGs and one over the top canvas bucket, every
    batch a graph replay, and must exit on SIGINT. The CLI's 256 MiB response
    cache is on: after its ``/stats``, a repeat of the first JPEG must answer
    ``X-Cache: hit`` with the same ETag, and that ETag as ``If-None-Match`` a
    304 with no body. Reports each boot's seconds, its warmup phases, the
    graph pool and the static bytes."""
    from PIL import Image

    from tensorflow_web_deploy_tpu_torch import native

    big = io.BytesIO()
    Image.fromarray(np.full((300, 2500, 3), 90, np.uint8)).save(big, "JPEG")
    st = native.status()
    row = {"phase": "default_server"}
    with tempfile.TemporaryDirectory(prefix="twd-aot-") as cache_dir:
        for boot in ("cold", "warm"):
            got = boot_default_server(jpegs, big.getvalue(), cache_dir)
            eng, answers = got["eng"], got["answers"]
            b = {"boot_s": got["boot_s"], "exit_code": got["exit_code"],
                 "warmup_s": eng["warmup_s"], "warmup_log": got["warmup_log"],
                 "statuses": [a[0] for a in answers],
                 "predictions": [len(a[1].get("predictions", [])) for a in answers],
                 "aot_cache": eng["aot_cache"], "graphs": eng["graphs"],
                 **{k: eng[k] for k in ("model", "device", "dtype", "wire_format", "ragged",
                                        "resize", "decodes", "batches", "canvas_buckets",
                                        "batch_buckets")},
                 "decoder_available": eng["decoder"]["available"],
                 "decoder_reason": eng["decoder"]["reason"], "x_cache": got["x_cache"]}
            row[boot] = b
            # the CLI's default mesh: every visible card, the first of them
            want = {"model": "inception_v3", "device": "cuda:0", "dtype": "bfloat16",
                    "wire_format": "rgb", "ragged": True, "resize": "matmul",
                    "decoder_available": st["available"], "statuses": [200] * 3,
                    "predictions": [5] * 3, "exit_code": 0,
                    "x_cache": {"repeat": [200, "hit"], "if_none_match": [304, 0],
                                "same_etag": True}}
            bad = {k: b[k] for k, v in want.items() if b[k] != v}
            graphs, cache = b["graphs"], b["aot_cache"]
            libs = len(cache["libraries"])
            if graphs["captured"] != DEFAULT_PAIRS or graphs["eager_batches"] != 0 \
                    or graphs["replays"] != b["batches"]:
                bad["graphs"] = graphs
            if cache["dir"] != cache_dir or not libs or (boot == "warm" and (
                    cache["hits_total"] != libs or cache["misses_total"] != 0
                    or cache["corrupt_total"] != 0 or cache["compile_seconds_total"] != 0)) \
                    or (boot == "cold" and cache["writes_total"] != libs):
                bad["aot_cache"] = cache
            if bad or sum(eng["decodes"].values()) != 3:
                emit(row)
                raise AssertionError(f"the default server ({boot} boot): "
                                     f"{bad or eng['decodes']}, want {want}")
    emit(row)
    return row


# ------------------------------------------------- the registry and the drain

# the two models the registry phase serves side by side, at full width
REGISTRY_MODELS = ("native:inception_v3", "native:mobilenet_v2,dtype=int8,as=mobilenet_v2_int8")
SWAP_MODEL, INT8_MODEL = "inception_v3", "mobilenet_v2_int8"
# one canvas bucket bounds the boot (fewer captures), not any model's width
REGISTRY_BUCKETS = (512,)
SWAPS = 3
# memory_reserved after each retired version is UNLOADED: within this of the
# value after the first
RESERVED_SLACK = 256 << 20
# closed-loop clients: keep-alive connections
LOAD_CONNS = 8
# the SIGTERM phase: keep-alive connections × requests each, the least in
# flight at the signal, and the server's drain grace (server.py's
# Server.close) plus the slack its exit gets
SIGTERM_CONNS, SIGTERM_REQUESTS, SIGTERM_IN_FLIGHT = 8, 25, 8
DRAIN_GRACE_S = 10.0


class KeepAlive:
    """One HTTP/1.1 keep-alive connection to a local server, reopened when
    the server closes it; ``connects`` counts its TCP connects. A request
    that finds its reused connection closed before any answer (the server
    closed it while idle, so never read the request) is sent once more on a
    new connection, as keep-alive clients do; any other failure raises."""

    def __init__(self, port: int, timeout: float = 120.0):
        self.port, self.timeout = port, timeout
        self.conn: http.client.HTTPConnection | None = None
        self.connects = 0

    def request(self, method: str, path: str, body=b"", ctype: str = "image/jpeg"
                ) -> tuple[int, dict]:
        if isinstance(body, dict):
            body, ctype = json.dumps(body).encode(), "application/json"
        status, _, data = self.exchange(method, path, body, {"Content-Type": ctype})
        return status, json.loads(data or b"null")

    def exchange(self, method: str, path: str, body=b"", headers: dict | None = None
                 ) -> tuple[int, dict, bytes]:
        """One request with ``headers``: (status, headers in lower case,
        the raw body)."""
        headers = {"Content-Type": "image/jpeg", **(headers or {})}
        for retry in (False, True):
            reused = self.conn is not None
            if not reused:
                self.conn = http.client.HTTPConnection("127.0.0.1", self.port,
                                                       timeout=self.timeout)
                self.conn.connect()
                self.connects += 1
            try:
                self.conn.request(method, path, body=body, headers=headers)
                r = self.conn.getresponse()
                data = r.read()
            except (BrokenPipeError, ConnectionResetError, http.client.RemoteDisconnected):
                self.close()
                if reused and not retry:
                    continue
                raise
            except BaseException:
                self.close()
                raise
            if r.will_close:
                self.close()
            return r.status, {k.lower(): v for k, v in r.getheaders()}, data

    def close(self) -> None:
        if self.conn is not None:
            self.conn.close()
            self.conn = None


class ClosedLoop:
    """``conns`` client threads, one keep-alive connection each, each
    posting ``/predict?model=<name>`` over ``targets`` ((serve name, JPEG)
    pairs, each thread from its own offset) until :meth:`finish` or
    ``per_conn`` requests. Every request is a record (connection, target,
    send and answer times on the host clock, status, the answering
    version, its top-k and scores), appended before it is sent: one with
    no answer time is in flight. A thread ends at its first non-200 answer
    or failure (status ``"exc"``)."""

    def __init__(self, port: int, conns: int, targets: list[tuple[str, bytes]],
                 per_conn: int | None = None):
        self.targets, self.per_conn = targets, per_conn
        self.records: list[dict] = []
        self.lock = threading.Lock()
        self._stop = threading.Event()
        self.clients = [KeepAlive(port) for _ in range(conns)]
        self.threads = [threading.Thread(target=self._run, args=(i,), daemon=True)
                        for i in range(conns)]

    def start(self) -> ClosedLoop:
        for t in self.threads:
            t.start()
        return self

    def _run(self, i: int) -> None:
        k = 0
        while not self._stop.is_set() and (self.per_conn is None or k < self.per_conn):
            j = (i * 7 + k) % len(self.targets)
            name, data = self.targets[j]
            rec = {"conn": i, "model": name, "target": j, "t0": time.perf_counter(),
                   "t1": None, "status": None}
            with self.lock:
                self.records.append(rec)
            k += 1
            try:
                status, body = self.clients[i].request("POST", f"/predict?model={name}", data)
            except (OSError, http.client.HTTPException) as e:
                with self.lock:
                    rec.update(t1=time.perf_counter(), status="exc", error=repr(e))
                return
            preds = body.get("predictions", []) if status == 200 else []
            with self.lock:
                rec.update(t1=time.perf_counter(), status=status,
                           version=body.get("model_version"),
                           topk=[p["index"] for p in preds], scores=[p["score"] for p in preds])
            if status != 200:
                return

    def in_flight(self) -> list[dict]:
        with self.lock:
            return [r for r in self.records if r["t1"] is None]

    def answered(self) -> int:
        with self.lock:
            return sum(r["t1"] is not None for r in self.records)

    def connects(self) -> int:
        return sum(c.connects for c in self.clients)

    def finish(self, timeout: float = 300.0) -> list[dict]:
        """Stop sending (unless ``per_conn`` bounds the loop), wait for every
        thread, close the connections; returns the records."""
        if self.per_conn is None:
            self._stop.set()
        deadline = time.monotonic() + timeout
        for t in self.threads:
            t.join(max(0.0, deadline - time.monotonic()))
        if any(t.is_alive() for t in self.threads):
            raise AssertionError(f"client threads still running after {timeout} s")
        for c in self.clients:
            c.close()
        return self.records


def latency_ms(records: list[dict]) -> dict:
    lat = [(r["t1"] - r["t0"]) * 1e3 for r in records if r["status"] == 200]
    if not lat:
        return {"n": 0}
    return {"n": len(lat), "p50": float(np.percentile(lat, 50)),
            "p99": float(np.percentile(lat, 99))}


def serial_topk(client: KeepAlive, name: str, jpegs: list[bytes]) -> list[tuple]:
    """Each image once through ``?model=name``: (version, top-k, scores)."""
    out = []
    for data in jpegs:
        status, body = client.request("POST", f"/predict?model={name}", data)
        if status != 200:
            raise AssertionError(f"{name}: {status} {body}")
        preds = body["predictions"]
        out.append((body["model_version"], [p["index"] for p in preds],
                    [p["score"] for p in preds]))
    return out


def version_doc(client: KeepAlive, name: str, version: int) -> dict:
    """One version's entry of ``GET /models``."""
    status, doc = client.request("GET", "/models")
    if status != 200:
        raise AssertionError(f"/models: {status}")
    return next(v for v in doc["models"][name]["versions"] if v["version"] == version)


def transition_s(doc: dict, a: str, b: str) -> float:
    """Seconds from state ``a`` to state ``b`` in a version's history."""
    t = {h["state"]: h["t_s"] for h in doc["history"]}
    return t[b] - t[a]


class EagerProbe(threading.Thread):
    """Holds an in-flight reference on a serving version (so it cannot
    drain) and runs batches of a shape its engine never captured — the
    classic wire at canvas 512 on a ragged engine, so every one runs
    eagerly and allocates from the caching allocator — until stopped,
    each held against the first on the registry's clock. Started before a
    swap, it runs beside the new version's captures."""

    def __init__(self, reg, ref: str, jpegs: list[bytes]):
        super().__init__(daemon=True)
        from tensorflow_web_deploy_tpu_torch.ops.image import decode_image

        self.reg, self.mv = reg, reg.acquire(ref)
        eng = self.mv.engine
        prepared = [eng.prepare(decode_image(d)) for d in jpegs[:8]]
        self.canvases = np.stack([c for c, _ in prepared])
        self.hws = np.array([hw for _, hw in prepared], np.int32)
        self.stop_event = threading.Event()
        self.runs: list[tuple[float, float]] = []  # registry-clock intervals
        self.max_diff = 0.0
        self.same_topk = True
        self.error: BaseException | None = None

    def run(self) -> None:
        eng = self.mv.engine
        try:
            want_s, want_i = eng.run_batch(self.canvases, self.hws)
            while not self.stop_event.is_set():
                t = time.monotonic() - self.reg._t0
                got_s, got_i = eng.run_batch(self.canvases, self.hws)
                self.runs.append((t, time.monotonic() - self.reg._t0))
                self.same_topk &= bool(np.array_equal(got_i, want_i))
                self.max_diff = max(self.max_diff, float(np.abs(got_s - want_s).max()))
        except BaseException as e:  # reported by the phase
            self.error = e
        finally:
            self.reg.release(self.mv)

    def finish(self) -> dict:
        self.stop_event.set()
        self.join(120)
        return {"runs": len(self.runs), "same_topk": self.same_topk,
                "max_abs_diff": self.max_diff,
                "error": None if self.error is None else repr(self.error)}


def phase_registry(jpegs: list[bytes]) -> dict:
    """Two models in one server process at full width on the default rgb
    ragged wire: Inception-v3 (bf16) and MobileNetV2 in the int8 tier served
    as ``mobilenet_v2_int8``, canvas bucket 512 only (the boot's captures
    cut, not a width).

    - Steady load: a closed loop of 8 keep-alive connections over both
      models with the kernels' counts set to 0 just before it and read just
      after; with both models taking traffic, each count is attributed to
      the engines by their batches: one ragged preprocess per batch of
      either, 17 fused depthwise launches per MobileNetV2 batch, no other
      kernel.
      Every batch a graph replay.
    - Three hot swaps of Inception-v3 under the same load (``POST
      /models/swap`` with ``wait``): every answer 200, each answer from a
      version that existed while it ran and, once a swap has answered, from
      the new one; the rebuilt version's top-k on the 24 images identical
      to v1's (same seed; v1 was built before the int8 engine turned TF32
      off, the later ones after); during the first swap the old version
      also runs batches of a shape it never captured, eagerly
      (:class:`EagerProbe`), beside the new version's captures, each equal
      to its first; no nvcc for a swap (the kernel build
      cache's misses and compile seconds do not move); the retired
      version's graph pool holds nothing after its close, and the process's
      ``memory_reserved`` after each retired version is UNLOADED is within
      256 MiB of its value after the first.
    - ``POST /models/unload`` of MobileNetV2 int8: ``memory_allocated``
      falls by at least its engine's static bytes (its static inputs and
      graph outputs) and ``memory_reserved`` by at least those plus its
      graph pool's bytes, both from its ``/stats``, and its pool holds
      nothing after its close. (The pool's blocks are
      free within the pool between replays, so ``memory_allocated`` does not
      count them; ``memory_reserved`` does.)
    """
    from tensorflow_web_deploy_tpu_torch.server import start_server
    from tensorflow_web_deploy_tpu_torch.serving import aotcache
    from tensorflow_web_deploy_tpu_torch.utils.config import ServerConfig, model_config

    mcs = tuple(model_config(spec) for spec in REGISTRY_MODELS)
    cfg = ServerConfig(model=mcs[0], models=mcs, host="127.0.0.1", port=0,
                       canvas_buckets=REGISTRY_BUCKETS, ragged=True, **PINNED)
    names = [m.serve_name for m in mcs]
    targets = [(n, d) for d in jpegs for n in names]
    row = {"phase": "registry", "nvidia_smi": nvidia_smi(), "models": list(REGISTRY_MODELS),
           "canvas_buckets": list(REGISTRY_BUCKETS), "max_batch": cfg.max_batch,
           "connections": LOAD_CONNS}
    t0 = time.perf_counter()
    srv = start_server(cfg, device="cuda", seed=SEED)
    row["boot_s"] = time.perf_counter() - t0
    bad: dict = {}
    try:
        reg = srv.registry
        admin = KeepAlive(srv.port)
        serving = {mv.name: mv for mv in reg.serving_entries()}
        v1 = serial_topk(admin, SWAP_MODEL, jpegs)
        graphs_per_version = {f"{n}@1": serving[n].engine.stats()["graphs"]["captured"]
                              for n in names}

        # steady load, with the launch counts attributed by batches
        before = {n: serving[n].engine.stats() for n in names}
        zero_launches()
        steady = ClosedLoop(srv.port, LOAD_CONNS, targets, per_conn=len(targets) // 4)
        t0 = time.perf_counter()
        steady_recs = steady.start().finish()
        steady_wall = time.perf_counter() - t0
        launches = read_launches()
        after = {n: serving[n].engine.stats() for n in names}
        batches = {n: after[n]["batches"] - before[n]["batches"] for n in names}
        replays = {n: after[n]["graphs"]["replays"] - before[n]["graphs"]["replays"]
                   for n in names}
        want = launches_want(fused_dw=DW_CELLS * batches[INT8_MODEL],
                             preprocess_ragged=sum(batches.values()))
        if launches != want or replays != batches or 0 in batches.values():
            bad["launches"] = {"got": launches, "want": want, "batches": batches,
                               "replays": replays}
        row.update(kernel_launches=launches, batches=batches, steady_requests=len(steady_recs),
                   steady_img_per_s=len(steady_recs) / steady_wall,
                   latency_before_ms=latency_ms(steady_recs))

        # three hot swaps of Inception-v3 under load
        load = ClosedLoop(srv.port, LOAD_CONNS, targets).start()
        swaps = []
        try:
            while load.answered() < 2 * LOAD_CONNS:
                time.sleep(0.01)
            for i in range(SWAPS):
                old = next(mv for mv in reg.serving_entries() if mv.name == SWAP_MODEL)
                old_engine = old.engine
                probe = EagerProbe(reg, old.ref, jpegs) if i == 0 else None
                eager0 = old.engine.stats()["graphs"]["eager_batches"]
                cache0 = aotcache.stats()
                t_start = time.perf_counter()
                if probe is not None:
                    probe.start()
                status, body = admin.request("POST", "/models/swap",
                                             {"name": SWAP_MODEL, "wait": True})
                t_answer = time.perf_counter()
                if probe is not None:
                    eager = probe.finish()
                    eager["eager_batches"] = (old.engine.stats()["graphs"]["eager_batches"]
                                              - eager0)
                    warm = version_doc(admin, SWAP_MODEL, body["version"])
                    hist = {h["state"]: h["t_s"] for h in warm["history"]}
                    eager["runs_while_new_version_warmed"] = sum(
                        a < hist["SERVING"] and b > hist["WARMING"] for a, b in probe.runs)
                    row["eager_during_capture"] = eager
                    if eager["error"] or not eager["same_topk"] or \
                            eager["max_abs_diff"] > SERVED_TOL or \
                            not eager["runs_while_new_version_warmed"]:
                        bad["eager_during_capture"] = eager
                if status != 200 or body["state"] != "SERVING":
                    raise AssertionError(f"swap: {status} {body}")
                reg.wait_for(old, ("UNLOADED",), timeout=120)
                t_unloaded = time.perf_counter()
                torch.cuda.synchronize()
                cache1 = aotcache.stats()
                new, gone = (version_doc(admin, SWAP_MODEL, v)
                             for v in (body["version"], old.version))
                swaps.append({
                    "version": body["version"], "t_start": t_start, "t_answer": t_answer,
                    "t_unloaded": t_unloaded, "swap_s": transition_s(new, "LOADING", "SERVING"),
                    "drain_s": transition_s(gone, "DRAINING", "UNLOADED"),
                    "answer_s": t_answer - t_start,
                    "graphs_captured": new["engine"]["graphs"]["captured"],
                    "memory_reserved": torch.cuda.memory_reserved(),
                    "pool_bytes_left": old_engine.pool_bytes,
                    "memory_allocated": torch.cuda.memory_allocated(),
                    "cache_delta": {k: cache1[k] - cache0[k] for k in (
                        "hits_total", "misses_total", "corrupt_total", "compile_seconds_total")},
                    "old_history": [h["state"] for h in gone["history"]]})
            n = load.answered()
            while load.answered() < n + 2 * LOAD_CONNS:
                time.sleep(0.01)
        finally:
            load_recs = load.finish()
        statuses = sorted({str(r["status"]) for r in load_recs + steady_recs})
        if statuses != ["200"]:
            bad["statuses"] = [r for r in load_recs + steady_recs if r["status"] != 200][:5]
        # an answer comes from a version that existed while the request ran,
        # and after a swap answered, from the new one (or a later one)
        for r in load_recs:
            if r["model"] != SWAP_MODEL:
                if r["version"] != 1:
                    bad.setdefault("int8_versions", []).append(r["version"])
                continue
            for sw in swaps:
                if (r["t0"] > sw["t_answer"] and r["version"] < sw["version"]) or \
                        (r["t1"] < sw["t_start"] and r["version"] >= sw["version"]):
                    bad.setdefault("versions", []).append((r["version"], sw["version"]))
        swap_windows = [r for r in load_recs if any(
            r["t1"] > sw["t_start"] and r["t0"] < sw["t_unloaded"] for sw in swaps)]
        vlast = serial_topk(admin, SWAP_MODEL, jpegs)
        same_topk = all(a[1] == b[1] for a, b in zip(v1, vlast))
        score_delta = max(abs(x - y) for a, b in zip(v1, vlast) for x, y in zip(a[2], b[2]))
        if not same_topk or vlast[0][0] != swaps[-1]["version"]:
            bad["topk"] = {"v1": [a[1] for a in v1][:3], "last": [b[1] for b in vlast][:3]}
        for sw in swaps:
            d = sw["cache_delta"]
            if d["misses_total"] or d["corrupt_total"] or d["compile_seconds_total"]:
                bad["nvcc_on_swap"] = d
            if sw["old_history"][-2:] != ["DRAINING", "UNLOADED"]:
                bad["history"] = sw["old_history"]
            if sw["pool_bytes_left"]:
                bad["pool_bytes_left"] = sw["pool_bytes_left"]
        reserved = [sw["memory_reserved"] for sw in swaps]
        if max(abs(r - reserved[0]) for r in reserved) > RESERVED_SLACK:
            bad["memory_reserved"] = reserved
        graphs_per_version.update({f"{SWAP_MODEL}@{sw['version']}": sw["graphs_captured"]
                                   for sw in swaps})
        if set(graphs_per_version.values()) != {len(REGISTRY_BUCKETS) *
                                                len(srv.engine.batch_buckets)}:
            bad["graphs_per_version"] = graphs_per_version
        row.update(requests_during_swaps=len(load_recs), latency_during_swaps_ms=latency_ms(
                   swap_windows), latency_all_swap_load_ms=latency_ms(load_recs),
                   connects=load.connects(), statuses=statuses,
                   swaps=[{k: v for k, v in sw.items() if not k.startswith("t_")}
                          for sw in swaps],
                   graphs_per_version=graphs_per_version, v1_vs_last_same_topk=same_topk,
                   v1_vs_last_max_score_delta=score_delta)

        # unload MobileNetV2 int8: its device memory comes back
        status, stats = admin.request("GET", "/stats")
        g = next(v for v in stats["models"]["models"][INT8_MODEL]["versions"]
                 if v["state"] == "SERVING")["engine"]["graphs"]
        int8_engine = serving[INT8_MODEL].engine
        torch.cuda.synchronize()
        a0, r0 = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
        status, body = admin.request("POST", "/models/unload", {"name": INT8_MODEL, "wait": True})
        a1, r1 = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
        pool_left = int8_engine.pool_bytes  # after close(): what its pool still holds
        after_status, _ = admin.request("POST", f"/predict?model={INT8_MODEL}", jpegs[0])
        unload = {"status": status, "state": body.get("state"), "pool_bytes": g["pool_bytes"],
                  "static_bytes": g["static_bytes"], "allocated_before": a0,
                  "allocated_after": a1, "reserved_before": r0, "reserved_after": r1,
                  "allocated_freed": a0 - a1, "reserved_freed": r0 - r1,
                  "predict_after": after_status, "pool_bytes_left": pool_left}
        row["unload"] = unload
        if (status, body.get("state"), after_status, pool_left) != (200, "UNLOADED", 503, 0) or \
                a0 - a1 < g["static_bytes"] or r0 - r1 < g["static_bytes"] + g["pool_bytes"]:
            bad["unload"] = unload
        admin.close()
    finally:
        srv.close()
    emit(row)
    if bad:
        raise AssertionError(f"registry: {bad}")
    return row


def phase_sigterm(jpegs: list[bytes]) -> dict:
    """``python -m tensorflow_web_deploy_tpu_torch.server`` serving
    MobileNetV2 int8 (canvas 512) through its real entry point: 8 keep-alive
    connections × 25 requests; SIGTERM while at least 8 are in flight (HTTP/1.1
    without pipelining carries one request at a time on a connection, so 8
    in flight take 8 connections). The connections connected once each
    before the signal; every request in flight at the signal answers 200;
    the process exits 0 within the drain grace + 10 s; a new connection is
    refused afterwards."""
    port = free_port()
    log = tempfile.TemporaryFile("w+")
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "tensorflow_web_deploy_tpu_torch.server",
                             "--model", "native:mobilenet_v2,dtype=int8", "--host", "127.0.0.1",
                             "--port", str(port), "--canvas-buckets", "512", *PINNED_ARGS],
                            stdout=log, stderr=subprocess.STDOUT, text=True,
                            cwd=os.path.dirname(os.path.abspath(__file__)))
    row = {"phase": "sigterm", "nvidia_smi": nvidia_smi(), "connections": SIGTERM_CONNS,
           "requests_per_connection": SIGTERM_REQUESTS}
    try:
        while True:
            if proc.poll() is not None:
                raise AssertionError(f"the server exited {proc.returncode}")
            if time.perf_counter() - t0 > 300:
                raise AssertionError("the server did not answer /healthz in 300 s")
            try:
                urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=5).read()
                break
            except OSError:
                time.sleep(0.5)
        row["boot_s"] = time.perf_counter() - t0
        loop = ClosedLoop(port, SIGTERM_CONNS, [("mobilenet_v2", d) for d in jpegs],
                          per_conn=SIGTERM_REQUESTS).start()
        deadline = time.perf_counter() + 120
        while True:
            with loop.lock:
                done = [sum(r["conn"] == i and r["t1"] is not None for r in loop.records)
                        for i in range(SIGTERM_CONNS)]
                flight = [r for r in loop.records if r["t1"] is None]
                if min(done) >= 5 and len(flight) >= SIGTERM_IN_FLIGHT:
                    connects = loop.connects()
                    t_signal = time.perf_counter()
                    proc.send_signal(signal.SIGTERM)
                    break
            if time.perf_counter() > deadline:
                raise AssertionError(f"never {SIGTERM_IN_FLIGHT} in flight: {done}")
            time.sleep(0.001)
        try:
            code = proc.wait(DRAIN_GRACE_S + 10)
        except subprocess.TimeoutExpired:
            code = None
        drain_s = time.perf_counter() - t_signal
        recs = loop.finish(60)
        try:
            socket.create_connection(("127.0.0.1", port), timeout=2).close()
            refused = False
        except ConnectionRefusedError:
            refused = True
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.seek(0)
        tail = log.read().splitlines()[-6:]
        log.close()
    answered = [r for r in flight if r["status"] == 200]
    row.update(exit_code=code, drain_s=drain_s, connects_before_signal=connects,
               in_flight_at_signal=len(flight), in_flight_answered_200=len(answered),
               answered_before_signal=sum(r["t1"] is not None and r["t1"] < t_signal
                                          for r in recs),
               after_signal=dict(Counter(str(r["status"]) for r in recs if r["t0"] > t_signal)),
               new_connection_refused=refused, latency_ms=latency_ms(
                   [r for r in recs if r["t1"] is not None and r["t1"] < t_signal]),
               server_log_tail=tail)
    emit(row)
    if connects != SIGTERM_CONNS or len(flight) < SIGTERM_IN_FLIGHT or \
            len(answered) != len(flight) or code != 0 or not refused:
        raise AssertionError(f"sigterm: {row}")
    return row


# ------------------------------------------------ the cache and overload control

# one process, one registry: MobileNetV2 bf16 and its int8 tier, both at full
# width on the ragged rgb wire with the gather resize, canvas 512 only (6
# graphs a version, as in ``registry``)
OVERLOAD_MODELS = ("native:mobilenet_v2", "native:mobilenet_v2,dtype=int8,as=mobilenet_v2_int8")
BF16_MODEL = "mobilenet_v2"
# four rungs put the int8 reroute (level 3) before the shedding of misses (4);
# 48 HTTP workers so that 32 connections are served at once
OVERLOAD = {"cache_bytes": 64 << 20, "max_queue": 32,
            "pressure_rungs": "0.30:0.15,0.50:0.30,0.70:0.50,0.95:0.80",
            "pressure_dwell_s": 0.1, "tenant_quota": "metered=50", "http_workers": 48}
CACHE_CONNS, COALESCED, QUOTA_CONNS, QUOTA_S = 4, 16, 8, 1.5
FLOOD_IMAGES, FLOOD_CONNS, FLOOD_DEADLINE_MS = 256, 32, 100
# the reroute drill: slots of the bf16 model's open batch held leased (as by
# uploads still decoding), so that its queue fraction sits at 24/32 = 0.75,
# past the reroute rung's 0.70; a probe request every 1.2 dwells
HELD_SLOTS, PROBES = 24, 10
CHAOS_SPEC = "decode_fail=0.1,dispatch_fail=0.05,slow_replica=0.2:20,seed=7"
CHAOS_REQUESTS = 96


def fan_out(port: int, items: list[bytes], conns: int, path: str,
            headers: dict | None = None, timeout: float = 120.0) -> list[dict]:
    """POST ``items`` over ``conns`` keep-alive connections, connection i
    taking items i, i + conns, … back to back; one record per item, in
    order: status, headers, the JSON answer (None for an empty body) and
    the client's ms."""
    out: list = [None] * len(items)

    def run(i: int) -> None:
        client = KeepAlive(port, timeout=timeout)
        try:
            for j in range(i, len(items), conns):
                t = time.perf_counter()
                status, hdrs, data = client.exchange("POST", path, items[j], headers)
                out[j] = {"status": status, "headers": hdrs, "ms": (time.perf_counter() - t) * 1e3,
                          "doc": json.loads(data) if data else None}
        finally:
            client.close()

    threads = [threading.Thread(target=run, args=(i,), daemon=True) for i in range(conns)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout + 30)
    if any(t.is_alive() for t in threads) or None in out:
        raise AssertionError(f"a client hung or failed: {sum(r is None for r in out)} unanswered")
    return out


def topk_of(rec: dict) -> list[int]:
    return [p["index"] for p in rec["doc"]["predictions"]]


def phase_overload(jpegs: list[bytes]) -> dict:
    """The response cache and overload control on one registry serving
    MobileNetV2 bf16 (``mobilenet_v2``) and its int8 tier
    (``mobilenet_v2_int8``, the 17 depthwise cells on the fused kernel), with
    a 64 MiB cache, ``max_queue`` 32, the four-rung ladder (dwell 0.1 s) and
    a 50 img/s quota for tenant ``metered``:

    - cache: the 24 JPEGs twice over 4 connections; the second pass all
      ``X-Cache: hit`` with the first pass's payloads, and no unpack or
      fused launch, no batch of either engine meanwhile; the first answer's
      ETag as ``If-None-Match`` answers 304 with no body;
    - coalescing: 16 concurrent POSTs of one new JPEG (``?topk=1``, the key
      every ladder level below the reroute gives) dispatch one row, and the
      others answer ``coalesced`` or ``hit``;
    - quota: 8 connections as ``metered`` for 1.5 s get 429s, each with
      ``reason: quota`` and ``Retry-After``, while 2 of the default tenant
      get only 200s;
    - swap: a hot swap of ``mobilenet_v2`` drops its entries, and the next
      repeat is a miss from version 2;
    - flood: 256 distinct JPEGs from 32 connections, each posting its 8
      back to back with ``X-Deadline-Ms: 100``: only 200, 503 and 504, each
      non-200 with a ``reason`` and ``Retry-After``; the statuses, the
      lease-time and seal-time deadline sheds, the levels entered and the
      reroutes are reported; probes one dwell apart then walk the ladder
      back to level 0, which must hold;
    - reroute: 24 of the bf16 model's 32 queue slots held leased (as by
      uploads still decoding) while 10 requests arrive 1.2 dwells apart:
      the ladder climbs to the reroute rung and requests on
      ``mobilenet_v2`` answer from ``mobilenet_v2_int8`` (every probe 200);
      with the kernels' counts set to 0 just before the flood and read just
      after the drill, ``fused_dw`` launched 17 times per int8 batch, the
      unpack kernel once per batch of either engine, every batch a replay;
      the ladder walks back to level 0;
    - chaos: a second server of the int8 tier alone with
      ``--chaos decode_fail=0.1,dispatch_fail=0.05,slow_replica=0.2:20,seed=7``
      takes 96 requests one at a time (a row per batch): only 200, 400 and
      500, the 400s the injected decode failures, the 500s the injected
      dispatch failures, ``/healthz`` answers after, and each 200's top-k is
      the first server's for the same image (one at a time there too)."""
    from tensorflow_web_deploy_tpu_torch.server import start_server
    from tensorflow_web_deploy_tpu_torch.utils.config import ServerConfig, model_config

    mcs = tuple(model_config(spec) for spec in OVERLOAD_MODELS)
    cfg = ServerConfig(model=mcs[0], models=mcs, host="127.0.0.1", port=0,
                       canvas_buckets=REGISTRY_BUCKETS, ragged=True, resize="gather",
                       **OVERLOAD)
    row = {"phase": "overload", "nvidia_smi": nvidia_smi(), "models": list(OVERLOAD_MODELS),
           "canvas_buckets": list(REGISTRY_BUCKETS), "max_batch": cfg.max_batch,
           "resize": cfg.resize, **OVERLOAD}
    flood_jpegs = make_jpegs(FLOOD_IMAGES, SEED + 2)
    probe_jpegs = make_jpegs(PROBES, SEED + 4)
    fresh = make_jpegs(1, SEED + 3)[0]
    bad: dict = {}
    t_phase = t0 = time.perf_counter()
    srv = start_server(cfg, device="cuda", seed=SEED)
    row["boot_s"] = time.perf_counter() - t0
    try:
        reg, app, port = srv.registry, srv.app, srv.port
        predict = f"/predict?model={BF16_MODEL}"

        def serving():
            return {mv.name: mv for mv in reg.serving_entries()}

        def counts():
            return read_launches()

        def reset():
            zero_launches()

        # cache: a pass of misses, then one of hits that runs nothing
        first = fan_out(port, jpegs, CACHE_CONNS, predict)
        eng0 = {n: mv.engine.stats() for n, mv in serving().items()}
        ladder0 = app.pressure.stats()["transitions_total"]
        reset()
        second = fan_out(port, jpegs, CACHE_CONNS, predict)
        launches, eng1 = counts(), {n: mv.engine.stats() for n, mv in serving().items()}
        cache = {
            "first": dict(Counter(f"{r['status']} {r['headers'].get('x-cache')}" for r in first)),
            "second": dict(Counter(f"{r['status']} {r['headers'].get('x-cache')}"
                                   for r in second)),
            "same_payloads": all(a["doc"]["predictions"] == b["doc"]["predictions"]
                                 and a["headers"]["etag"] == b["headers"]["etag"]
                                 for a, b in zip(first, second)),
            "launches_during_hits": launches,
            "batches_during_hits": {n: eng1[n]["batches"] - eng0[n]["batches"] for n in eng1},
            "miss_ms": latency_of(first), "hit_ms": latency_of(second),
            "ladder_moved": app.pressure.stats()["transitions_total"] != ladder0}
        etag = first[0]["headers"]["etag"]
        client = KeepAlive(port)
        status, hdrs, data = client.exchange("POST", predict, jpegs[0], {"If-None-Match": etag})
        cache["if_none_match"] = {"status": status, "body_bytes": len(data),
                                  "etag": hdrs.get("etag") == etag}
        row["cache"] = cache
        if (cache["first"] != {"200 miss": len(jpegs)} or cache["second"] != {
                "200 hit": len(jpegs)} or not cache["same_payloads"]
                or any(launches.values()) or any(cache["batches_during_hits"].values())
                or cache["if_none_match"] != {"status": 304, "body_bytes": 0, "etag": True}
                or cache["ladder_moved"]):
            bad["cache"] = cache

        # coalescing: one new JPEG, 16 at once
        batcher = serving()[BF16_MODEL].batcher
        images0 = batcher.stats()["images"]
        gate = threading.Barrier(COALESCED)
        answers: list = [None] * COALESCED

        def one(i: int) -> None:
            c = KeepAlive(port)
            try:
                gate.wait(30)
                answers[i] = c.exchange("POST", predict + "&topk=1", fresh)
            finally:
                c.close()

        threads = [threading.Thread(target=one, args=(i,), daemon=True)
                   for i in range(COALESCED)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        kinds = Counter(f"{a[0]} {a[1].get('x-cache')}" if a else "none" for a in answers)
        rows = batcher.stats()["images"] - images0
        row["coalescing"] = {"requests": COALESCED, "answers": dict(kinds),
                             "rows_dispatched": rows,
                             "coalesced_share": kinds["200 coalesced"] / COALESCED}
        if rows != 1 or kinds["200 miss"] != 1 or \
                kinds["200 miss"] + kinds["200 coalesced"] + kinds["200 hit"] != COALESCED:
            bad["coalescing"] = row["coalescing"]

        # quota: tenant metered over its 50 img/s beside the default tenant
        stop = time.monotonic() + QUOTA_S
        quota: dict = {"metered": Counter(), "default": Counter(), "bad_429": 0}
        lock = threading.Lock()

        def tenant_loop(i: int, tenant: str | None) -> None:
            c, k = KeepAlive(port), i
            try:
                while time.monotonic() < stop:
                    status, hdrs, data = c.exchange(
                        "POST", predict, jpegs[k % len(jpegs)],
                        {"X-Tenant": tenant} if tenant else None)
                    k += 1
                    with lock:
                        quota[tenant or "default"][status] += 1
                        if status == 429 and (json.loads(data).get("reason") != "quota"
                                              or "retry-after" not in hdrs):
                            quota["bad_429"] += 1
            finally:
                c.close()

        threads = [threading.Thread(target=tenant_loop, args=(i, "metered"), daemon=True)
                   for i in range(QUOTA_CONNS)]
        threads += [threading.Thread(target=tenant_loop, args=(i, None), daemon=True)
                    for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        row["quota"] = {"seconds": QUOTA_S, "metered": dict(quota["metered"]),
                        "default": dict(quota["default"]), "bad_429": quota["bad_429"],
                        "admission": app.admission.stats()["tenants"].get("metered")}
        if not quota["metered"][429] or set(quota["metered"]) - {200, 429} or \
                set(quota["default"]) != {200} or quota["bad_429"]:
            bad["quota"] = row["quota"]

        # swap: version 2 of mobilenet_v2 starts with none of version 1's entries
        inval0 = app.cache.stats()["invalidations_total"]
        t0 = time.perf_counter()
        status, body = client.request("POST", "/models/swap", {"name": BF16_MODEL, "wait": True})
        swap_s = time.perf_counter() - t0
        per_model = app.cache.stats()["per_model"][BF16_MODEL]
        again = client.exchange("POST", predict, jpegs[0])
        row["swap"] = {"status": status, "state": body.get("state"), "version": body.get(
            "version"), "seconds": swap_s,
            "invalidated": app.cache.stats()["invalidations_total"] - inval0,
            "entries_after": per_model["entries"], "repeat": [
                again[0], again[1].get("x-cache"), json.loads(again[2]).get("model_version")]}
        if (status, body.get("state"), body.get("version")) != (200, "SERVING", 2) or \
                row["swap"]["invalidated"] < len(jpegs) or per_model["entries"] or \
                row["swap"]["repeat"] != [200, "miss", 2]:
            bad["swap"] = row["swap"]

        # flood: 256 distinct JPEGs, a 100 ms deadline each; then the reroute
        # drill; the kernels' counts span both
        mvs = serving()
        b0 = {n: mv.batcher.stats() for n, mv in mvs.items()}
        e0 = {n: mv.engine.stats() for n, mv in mvs.items()}
        p0 = app.pressure.stats()
        reset()
        t0 = time.perf_counter()
        flood = fan_out(port, flood_jpegs, FLOOD_CONNS, predict,
                        {"X-Deadline-Ms": str(FLOOD_DEADLINE_MS)})
        wall = time.perf_counter() - t0
        b1 = {n: mv.batcher.stats() for n, mv in mvs.items()}
        p1 = app.pressure.stats()
        by = Counter()
        unexplained = 0
        for r in flood:
            if r["status"] == 200:
                by[f"200 {r['doc']['model']}"] += 1
            else:
                reason = (r["doc"] or {}).get("reason")
                by[f"{r['status']} {reason}"] += 1
                unexplained += reason is None or "retry-after" not in r["headers"]
        probes = walk_down(app, client, predict, jpegs)
        row["flood"] = {
            "requests": FLOOD_IMAGES, "connections": FLOOD_CONNS,
            "deadline_ms": FLOOD_DEADLINE_MS, "wall_ms": wall * 1e3, "answers": dict(by),
            "unexplained_non_200": unexplained, "latency_200_ms": latency_of(
                [r for r in flood if r["status"] == 200]),
            "latency_shed_ms": latency_of([r for r in flood if r["status"] != 200]),
            "sheds": {n: {k: b1[n][k] - b0[n][k] for k in (
                "deadline_sheds_total", "deadline_seal_sheds_total", "backlog_rejects",
                "quota_sheds_total")} for n in mvs},
            "levels_entered": {k: v - p0["entered_total"].get(k, 0)
                               for k, v in p1["entered_total"].items()},
            "level_after": p1["level"], "quant_reroutes": p1["quant_reroutes"] - p0[
                "quant_reroutes"], "probes_to_level_0": probes,
            "level_after_probes": app.pressure.level}
        if set(r["status"] for r in flood) - {200, 503, 504} or unexplained or \
                app.pressure.level != 0:
            bad["flood"] = row["flood"]

        # reroute drill: the bf16 model's queue held at 0.75, a request every
        # 1.2 dwells; the ladder climbs a rung per dwell and, at the reroute
        # rung, sends requests to the int8 tier
        bf16 = mvs[BF16_MODEL].batcher
        p2 = app.pressure.stats()
        held = [bf16.lease_ragged(8 * 8 * 3, REGISTRY_BUCKETS[0]) for _ in range(HELD_SLOTS)]
        drill: list = [None] * PROBES

        def probe(i: int) -> None:
            c = KeepAlive(port)
            try:
                t = time.perf_counter()
                status, hdrs, data = c.exchange("POST", predict, probe_jpegs[i])
                drill[i] = {"status": status, "ms": (time.perf_counter() - t) * 1e3,
                            "doc": json.loads(data), "level": app.pressure.level}
            finally:
                c.close()

        threads = []
        try:
            for i in range(PROBES):
                threads.append(threading.Thread(target=probe, args=(i,), daemon=True))
                threads[-1].start()
                time.sleep(OVERLOAD["pressure_dwell_s"] * 1.2)
        finally:
            for lease in held:  # they ship as holes
                lease.release()
        for t in threads:
            t.join(120)
        p3 = app.pressure.stats()
        launches = counts()
        e1 = {n: mv.engine.stats() for n, mv in mvs.items()}
        batches = {n: e1[n]["batches"] - e0[n]["batches"] for n in mvs}
        replays = {n: e1[n]["graphs"]["replays"] - e0[n]["graphs"]["replays"] for n in mvs}
        want = launches_want(fused_dw=DW_CELLS * batches[INT8_MODEL],
                             unpack_ragged=sum(batches.values()))
        probes = walk_down(app, client, predict, jpegs)
        row["reroute"] = {
            "held_slots": HELD_SLOTS, "probes": PROBES,
            "answers": dict(Counter(f"{r['status']} {r['doc'].get('model')}" if r else "none"
                                    for r in drill)),
            "levels_entered": {k: v - p2["entered_total"].get(k, 0)
                               for k, v in p3["entered_total"].items()},
            "quant_reroutes": p3["quant_reroutes"] - p2["quant_reroutes"],
            "int8_ms": latency_of([r for r in drill if r and r["doc"].get("model") ==
                                   INT8_MODEL]),
            "probes_to_level_0": probes, "level_after_probes": app.pressure.level}
        row["kernel_launches"] = launches
        row["batches"], row["replays"] = batches, replays
        if not row["reroute"]["quant_reroutes"] or None in drill or \
                any(r["status"] != 200 for r in drill) or \
                not any(r["doc"]["model"] == INT8_MODEL for r in drill) or \
                launches != want or replays != batches or not batches[INT8_MODEL] or \
                app.pressure.level != 0:
            bad["reroute"] = {**row["reroute"], "launches": launches, "want_launches": want,
                              "batches": batches, "replays": replays}

        # the int8 tier's answers one at a time, for the chaos server's
        int8_first = fan_out(port, jpegs, 1, f"/predict?model={INT8_MODEL}")
        client.close()
    finally:
        srv.close()

    # chaos: the int8 tier alone, faults injected, one request at a time
    ccfg = ServerConfig(model=mcs[1], models=mcs[1:], host="127.0.0.1", port=0,
                        canvas_buckets=REGISTRY_BUCKETS, ragged=True, resize="gather",
                        chaos=CHAOS_SPEC, **PINNED)
    srv = start_server(ccfg, device="cuda", seed=SEED)
    try:
        items = [jpegs[i % len(jpegs)] for i in range(CHAOS_REQUESTS)]
        t0 = time.perf_counter()
        drill = fan_out(srv.port, items, 1, "/predict", timeout=30)
        drill_s = time.perf_counter() - t0
        injected = srv.app.chaos.stats()
        with urllib.request.urlopen(srv.url + "/healthz", timeout=60) as r:
            health = (r.status, json.loads(r.read()))
        codes = Counter(r["status"] for r in drill)
        same = [topk_of(r) == topk_of(int8_first[i % len(jpegs)])
                for i, r in enumerate(drill) if r["status"] == 200]
        delta = max((abs(p["score"] - q["score"]) for i, r in enumerate(drill)
                     if r["status"] == 200 for p, q in zip(
                         r["doc"]["predictions"], int8_first[i % len(jpegs)]["doc"][
                             "predictions"])), default=0.0)
        row["chaos"] = {"spec": CHAOS_SPEC, "requests": CHAOS_REQUESTS, "seconds": drill_s,
                        "answers": {str(k): v for k, v in sorted(codes.items())},
                        "injected": injected, "healthz": list(health),
                        "same_topk": all(same), "max_score_delta": delta}
        if set(codes) - {200, 400, 500} or sum(codes.values()) != CHAOS_REQUESTS or \
                codes[400] != injected["decode_failures_injected"] or \
                codes[500] != injected["dispatch_failures_injected"] or \
                health != (200, {"ok": True}) or not same or not all(same):
            bad["chaos"] = row["chaos"]
    finally:
        srv.close()
    row["seconds"] = time.perf_counter() - t_phase
    emit(row)
    if bad:
        raise AssertionError(f"overload: {bad}")
    return row

# observability: the load generator's seconds and workers (closed loop,
# from a process of its own), the sampler's interval, one SLO objective,
# the profiler capture, and the symbols a profile is searched for
OBS_LOAD_S = 6.0
OBS_WORKERS = 8
OBS_INTERVAL_S = 0.2
OBS_SLO = "interactive=p99:1000ms:99"
PROFILE_MS = 300
KERNEL_SYMBOLS = {"preprocess_i420": ("preprocess_i420_kernel",),
                  "fused_dw": ("fused_dw_kernel",),
                  "unpack_ragged": ("unpack_words", "unpack_bytes"),
                  "preprocess_ragged": ("preprocess_ragged_kernel",)}
# every stage a /predict on this path stamps (the cache's two are off here)
PATH_STAGES = ("http_read", "body_read", "lease_wait", "image_decode", "staging_write",
               "queue_wait", "device_transfer", "device_dispatch", "device_execute",
               "postprocess", "serialize")
# MFU sanity ranges from PERF.md §5's replay times (batch of 8, 512 canvas)
# and the reference's MAC counts; printed beside the reading, not gated
MFU_EXPECT = {"inception_v3": (0.03, 0.06), "mobilenet_v2_int8": (0.003, 0.01)}


def run_loadgen(port: int, img_dir: str, names: list[str]) -> dict:
    """``tools/loadgen.py`` in a process of its own: closed loop, 8
    workers, ``OBS_LOAD_S`` seconds without warmup, both models by
    ``?model=``, the telemetry history polled. Its exit code, its JSON
    summary (the last line of its output) and its tables (its errors)."""
    cmd = [sys.executable, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools",
                                        "loadgen.py"),
           "--url", f"http://127.0.0.1:{port}/predict", "--images", img_dir,
           "--workers", str(OBS_WORKERS), "--duration", str(OBS_LOAD_S), "--warmup", "0",
           "--model-mix", ",".join(names), "--history", "--timeout", "60"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=OBS_LOAD_S + 120)
    lines = proc.stdout.strip().splitlines()
    summary = json.loads(lines[-1]) if proc.returncode == 0 and lines else {}
    return {"rc": proc.returncode, "wall_s": time.perf_counter() - t0, "summary": summary,
            "tables": proc.stderr.splitlines()[-80:]}


def device_marker() -> float:
    """The host's monotonic clock read once the device is idle: the common
    base of every engine's ``device_timeline(base)`` (on that clock)."""
    torch.cuda.synchronize()
    return time.monotonic()


def merged_ms(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, lo, hi = 0.0, None, None
    for a, b in sorted(intervals):
        if hi is None or a > hi:
            total += 0.0 if hi is None else hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    return total + (0.0 if hi is None else hi - lo)


def busy_union(engines: dict, base: float, batches: dict, window_s: float) -> dict:
    """The compute intervals of each engine's last ``batches[name]``
    batches (those of a window that began at ``base``; every engine on its
    own stream, one clock): the share of the window that their union, their
    sum and the overlap of two engines' busy time take, and the idle share
    (1 - union). ``missing_intervals`` counts batches the engines' event
    rings no longer hold."""
    iv, missing = {}, 0
    for n, eng in engines.items():
        rows = eng.device_timeline(base)[-batches[n]:] if batches[n] else []
        missing += batches[n] - len(rows) + sum(r["compute"][0] < 0 for r in rows)
        iv[n] = [r["compute"] for r in rows]
    every = [x for v in iv.values() for x in v]
    union = merged_ms(every)
    per = {n: merged_ms(v) for n, v in iv.items()}
    total = sum(b - a for a, b in every)
    w = window_s * 1e3
    return {"busy_ms_union": union, "busy_ms_sum": total, "busy_ms": per,
            "overlap_ms": sum(per.values()) - union,
            "busy_share_union": union / w, "busy_share_sum": total / w,
            "overlap_share": (sum(per.values()) - union) / w, "idle_share": 1.0 - union / w,
            "span_ms": (max(b for _, b in every) - min(a for a, _ in every)) if every else 0.0,
            "missing_intervals": missing}


def read_jsonl(path: str) -> list[dict]:
    with open(path) as f:
        return [json.loads(ln) for ln in f]


def kernels_in_trace(path: str) -> dict:
    """Which hand-written kernels a ``torch.profiler`` Chrome trace names,
    the device kernels it holds, and whether graph launches appear."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    return {"device_kernels": len(kernels),
            "graph_launches": sum(e.get("name") == "cudaGraphLaunch" for e in events),
            "found": {k: any(sym in n for n in kernels for sym in syms)
                      for k, syms in KERNEL_SYMBOLS.items()},
            "top": Counter(n[:80] for n in kernels).most_common(8)}


def phase_observability(jpegs: list[bytes], graphs: list[dict]) -> dict:
    """The tracing, metrics, cost model and telemetry of the served path:
    one server (``start_server``) with Inception-v3 bf16 and MobileNetV2
    int8 as ``mobilenet_v2_int8`` on the reference server's defaults
    (ragged rgb wire, matmul resize), canvas 512 only (the ``registry``
    cut), the cache off and a ladder that cannot climb (every answer is
    device work), a 0.2 s telemetry interval, an access log and one SLO
    objective.

    - Load from a process of its own: ``tools/loadgen.py``, 8 workers, both
      models; its exit code, stage attribution and history, and its
      roofline table over the port's ``/stats``. The kernels' counts are
      set to 0 just before it and read just after, and attributed to the
      engines by their batches.
    - ``/metrics``: the +Inf count of ``request_duration_seconds`` equals
      ``requests_total`` over status classes; ``inferences_total`` equals
      the default model's ``model_inferences_total`` (the reference's
      meaning: the unlabeled aggregate is the default model's); every
      stage of the path in ``stage_duration_seconds``.
    - Spans: each ``/debug/slow`` entry's stage sum is within its total;
      the median share of a request's wall that its stages tile.
    - MFU: the card's peak and its source; per model and (canvas, batch)
      cell the MFU (every one in (0, 1]), roofline fraction, device
      seconds and rows; device ms per batch from the CUDA events beside
      ``graphs``' replay ms.
    - Device idle share: busy seconds (the events) over the load window.
    - ``GET /debug/trace`` after a burst: its execute bars number the
      batches the burst dispatched. ``POST /debug/trace?ms=300`` during
      traffic writes a trace (a second capture meanwhile answers 409):
      which kernel names it holds.
    - Telemetry: ``goodput_rps`` history has points; a hot swap of
      ``mobilenet_v2_int8`` shows in ``/debug/events``; the access log has
      one line per request, each with its trace ID.
    - Overhead, reported: loadgen img/s and p99 with the hub and the access
      log on, off (the App's hub stopped and its log unset, the state
      ``--telemetry-interval 0`` without ``--access-log`` boots into), on
      again, on the same server."""
    import shutil

    from tensorflow_web_deploy_tpu_torch.server import start_server
    from tensorflow_web_deploy_tpu_torch.serving import http as thttp
    from tensorflow_web_deploy_tpu_torch.tools.profile_serve import format_econ_table
    from tensorflow_web_deploy_tpu_torch.utils.config import ServerConfig, model_config
    from tensorflow_web_deploy_tpu_torch.utils.metrics import (
        make_access_logger,
        parse_prometheus_text,
    )

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="observability-")
    img_dir = os.path.join(tmp, "images")
    os.makedirs(img_dir)
    for i, data in enumerate(jpegs):
        with open(os.path.join(img_dir, f"{i:02d}.jpg"), "wb") as f:
            f.write(data)
    access = os.path.join(tmp, "access.log")
    mcs = tuple(model_config(spec) for spec in REGISTRY_MODELS)
    cfg = ServerConfig(model=mcs[0], models=mcs, host="127.0.0.1", port=0,
                       canvas_buckets=REGISTRY_BUCKETS, ragged=True,
                       telemetry_interval_s=OBS_INTERVAL_S, access_log=access,
                       slo_objectives=OBS_SLO, **PINNED)
    names = [m.serve_name for m in mcs]
    targets = [(n, d) for d in jpegs for n in names]
    row = {"phase": "observability", "nvidia_smi": nvidia_smi(), "models": list(REGISTRY_MODELS),
           "canvas_buckets": list(REGISTRY_BUCKETS), "telemetry_interval_s": OBS_INTERVAL_S,
           "slo_objectives": OBS_SLO}
    bad: dict = {}
    srv = start_server(cfg, device="cuda", seed=SEED)
    try:
        app = srv.app
        engines = {mv.name: mv.engine for mv in srv.registry.serving_entries()}
        admin = KeepAlive(srv.port)

        def counters() -> tuple[dict, dict]:
            st = {n: e.stats() for n, e in engines.items()}
            return {n: s["busy_s"] for n, s in st.items()}, {n: s["batches"] for n, s in st.items()}

        # load from a process of its own, the kernels' counts over it
        busy0, batches0 = counters()
        base = device_marker()
        zero_launches()
        lg = run_loadgen(srv.port, img_dir, names)
        launches = read_launches()
        busy1, batches1 = counters()
        nb = {n: batches1[n] - batches0[n] for n in names}
        want = launches_want(fused_dw=DW_CELLS * nb[INT8_MODEL],
                             preprocess_ragged=sum(nb.values()))
        if launches != want or 0 in nb.values():
            bad["launches"] = {"got": launches, "want": want, "batches": nb}
        sm = lg["summary"]
        row["kernel_launches"] = launches
        row["batches"] = nb
        row["loadgen"] = {"rc": lg["rc"], "wall_s": lg["wall_s"],
                          **{k: sm.get(k) for k in ("mode", "duration_s", "completed", "errors",
                                                    "images_per_sec", "latency_ms", "per_model",
                                                    "server_stages", "stage_utilization",
                                                    "device_busy_fraction",
                                                    "server_timeline")}}
        row["loadgen_tables"] = lg["tables"]
        if lg["rc"] != 0 or sm.get("errors") or not sm.get("server_stages") \
                or not sm.get("server_timeline"):
            bad["loadgen"] = row["loadgen"]
        _, stats = admin.request("GET", "/stats")
        row["roofline_table"] = format_econ_table(stats["economics"]).splitlines()

        # device idle share over the load generator's window: the union of
        # both engines' compute intervals (their streams run side by side)
        window = sm.get("duration_s") or OBS_LOAD_S
        busy = {n: busy1[n] - busy0[n] for n in names}
        row["device_time"] = {"window_s": window, "busy_s": busy,
                              "busy_share": {n: b / window for n, b in busy.items()},
                              **busy_union(engines, base, nb, window)}
        if row["device_time"]["missing_intervals"]:
            bad["device_time"] = row["device_time"]

        # /metrics, parsed with the port's parser
        status, _, body = admin.exchange("GET", "/metrics")
        samples = parse_prometheus_text(body.decode())["samples"]

        def family(name: str) -> dict:
            return {lb: v for (n, lb), v in samples.items() if n == name}

        requests = sum(family("tpu_serve_requests_total").values())
        inf = samples[("tpu_serve_request_duration_seconds_bucket", (("le", "+Inf"),))]
        per_model = {dict(lb)["model"]: v
                     for lb, v in family("tpu_serve_model_inferences_total").items()}
        stages = {dict(lb)["stage"] for lb in family("tpu_serve_stage_duration_seconds_count")}
        metrics = {"requests_total": requests, "duration_inf_count": inf,
                   "inferences_total": samples[("tpu_serve_inferences_total", ())],
                   "model_inferences_total": per_model,
                   "model_inferences_sum": sum(per_model.values()),
                   "missing_stages": sorted(set(PATH_STAGES) - stages),
                   "families": len({n for n, _ in samples})}
        row["metrics"] = metrics
        if status != 200 or requests != inf or \
                metrics["inferences_total"] != per_model.get(mcs[0].serve_name) or \
                metrics["missing_stages"]:
            bad["metrics"] = metrics

        # MFU against the card's peak, per model and cell
        peaks = {dict(lb)["dtype"]: v
                 for lb, v in family("tpu_serve_device_peak_flops_per_chip").items()}
        mfu_rows = {}
        for n in names:
            econ = stats["economics"][f"{n}@1"]
            cells_raw = {(c["canvas"], c["batch_bucket"]): c
                         for c in engines[n].econ_stats()[0]["buckets"]}
            cells = []
            for c in econ["replicas"][0]["buckets"]:
                raw = cells_raw[(c["canvas"], c["batch_bucket"])]
                cells.append({k: c.get(k) for k in (
                    "canvas", "batch_bucket", "rows", "rows_dispatched", "device_s", "mfu",
                    "roofline_bound_fraction", "bound", "arithmetic_intensity")}
                    | {"batches": raw["batches"],
                       "device_ms_per_batch": 1e3 * raw["device_s"] / raw["batches"]})
            dtype = econ["dtype"]
            replay = next((g["replay_ms"] for g in graphs
                           if g["model"] == mcs[names.index(n)].name and g["dtype"] == dtype
                           and g["ragged"]), None)
            lo, hi = MFU_EXPECT[n]
            mfu_rows[n] = {"dtype": dtype, "peak_flops_per_chip": peaks.get(dtype),
                           "peak_source": econ["peak"]["source"], "mfu": econ.get("mfu"),
                           "mfu_expected": [lo, hi],
                           "mfu_in_expected": econ.get("mfu") is not None
                           and lo <= econ["mfu"] <= hi,
                           "model_cost": econ["model_cost"], "cells": cells,
                           "graphs_replay_ms_batch8_512": replay}
            every = [econ.get("mfu")] + [c["mfu"] for c in cells if c["rows"]]
            if not all(m is not None and 0.0 < m <= 1.0 for m in every):
                bad.setdefault("mfu", {})[n] = every
        row["mfu"] = mfu_rows

        # spans: the flight recorder and the access log
        _, slow = admin.request("GET", "/debug/slow")
        over = [e for e in slow["slowest"]
                if sum(e["stages_ms"].values()) > e["total_ms"] + 0.01]
        lines = read_jsonl(access)
        tiles = [sum(d["stages_ms"].values()) / d["total_ms"] for d in lines
                 if d.get("meta", {}).get("path") == "/predict" and d["status"] == 200
                 and d["total_ms"] > 0]
        row["spans"] = {"slowest": len(slow["slowest"]), "stage_sum_over_total": len(over),
                        "tile_share_median": statistics.median(tiles) if tiles else None,
                        "tile_share_p10": float(np.percentile(tiles, 10)) if tiles else None,
                        "slowest_example": slow["slowest"][0] if slow["slowest"] else None}
        if over or not tiles:
            bad["spans"] = over[:3]

        # the exported timeline after a burst: its execute bars
        time.sleep(1.5)  # the trace window below reaches back to no earlier batch
        _, n_before = counters()
        t_burst = time.monotonic()
        ClosedLoop(srv.port, LOAD_CONNS, targets, per_conn=4).start().finish()
        _, n_after = counters()
        burst_batches = sum(n_after[n] - n_before[n] for n in names)
        status, _, body = admin.exchange(
            "GET", f"/debug/trace?last_s={time.monotonic() - t_burst + 0.05:.3f}")
        doc = json.loads(body)
        bars = sum(1 for e in doc["traceEvents"]
                   if e["ph"] == "X" and e["name"].split(" ")[-2] == "execute")
        row["trace_export"] = {"status": status, "events": len(doc["traceEvents"]),
                               "execute_bars": bars, "burst_batches": burst_batches,
                               "window_s": doc["otherData"]["effective_window_s"]}
        if status != 200 or bars != burst_batches:
            bad["trace_export"] = row["trace_export"]

        # torch.profiler during traffic; a second capture meanwhile is refused
        prof_dir = os.path.join(tmp, "profile")
        load = ClosedLoop(srv.port, LOAD_CONNS, targets).start()
        got: dict = {}
        try:
            while load.answered() < 2 * LOAD_CONNS:
                time.sleep(0.01)
            first = threading.Thread(target=lambda: got.update(first=post_full(
                f"{srv.url}/debug/trace?ms={PROFILE_MS}&dir={prof_dir}", b"")))
            first.start()
            deadline = time.monotonic() + 30
            while not thttp._PROFILE_LOCK.locked() and time.monotonic() < deadline:
                time.sleep(0.005)
            second = post_full(f"{srv.url}/debug/trace?ms=10&dir={prof_dir}", b"")[0]
            first.join(120)
        finally:
            load.finish()
        status, _, body = got.get("first", (None, None, b"{}"))
        prof = json.loads(body)
        row["profile"] = {"status": status, "second_capture": second,
                          "captured_ms": prof.get("captured_ms"),
                          "activities": prof.get("activities"),
                          "trace_bytes": os.path.getsize(prof["trace_file"])
                          if status == 200 else None,
                          **(kernels_in_trace(prof["trace_file"]) if status == 200 else {})}
        if status != 200 or second != 409:
            bad["profile"] = row["profile"]

        # telemetry: history, a hot swap in the events, the access log
        _, hist = admin.request("GET", "/debug/history?series=goodput_rps&last_s=120")
        points = hist["series"]["goodput_rps"]["rows"]
        status, swap = admin.request("POST", "/models/swap", {"name": INT8_MODEL, "wait": True})
        _, evs = admin.request("GET", "/debug/events?kind=hot_swap_serving,hot_swap_retired")
        swap_events = [(e["kind"], e["model"], e["version"]) for e in evs["events"]]
        _, tstats = admin.request("GET", "/stats")
        n_req = app.obs.snapshot()["e2e"]["count"]
        lines = read_jsonl(access)
        ids = [d.get("trace_id") for d in lines]
        row["telemetry"] = {"goodput_points": len(points),
                            "goodput_max": max((r[3] for r in points), default=None),
                            "swap": {"status": status, **swap}, "events": swap_events,
                            "event_kinds": sorted({e["kind"] for e in app.telemetry.events()}),
                            "slo": tstats["telemetry"]["slo"],
                            "samples_total": tstats["telemetry"]["samples_total"],
                            "memory_bytes": tstats["telemetry"]["memory_bytes"],
                            "access_log_lines": len(lines), "requests_counted": n_req,
                            "access_log_unique_ids": len(set(ids)),
                            "loadgen_sample_id_logged": sm.get("sample_trace_id") in set(ids)}
        if not points or status != 200 or \
                ("hot_swap_serving", INT8_MODEL, 2) not in swap_events or \
                ("hot_swap_retired", INT8_MODEL, 1) not in swap_events or \
                len(lines) != n_req or len(set(ids)) != n_req or None in ids:
            bad["telemetry"] = row["telemetry"]

        # overhead: the hub and the access log on, off, on again
        hub = app.telemetry
        runs = {"on_1": lg}
        hub.stop()
        app.telemetry = None
        app.obs.set_access_log(None)
        runs["off"] = run_loadgen(srv.port, img_dir, names)
        app.obs.set_access_log(make_access_logger(access))
        app.telemetry = hub
        hub.start()
        runs["on_2"] = run_loadgen(srv.port, img_dir, names)
        row["overhead"] = {k: {"rc": r["rc"], "images_per_sec": r["summary"].get("images_per_sec"),
                               "p50_ms": (r["summary"].get("latency_ms") or {}).get("p50"),
                               "p99_ms": (r["summary"].get("latency_ms") or {}).get("p99"),
                               "errors": r["summary"].get("errors")}
                           for k, r in runs.items()}
        if any(r["rc"] != 0 or r["summary"].get("errors") for r in runs.values()):
            bad["overhead"] = row["overhead"]
        admin.close()
    finally:
        srv.close()
        shutil.rmtree(tmp, ignore_errors=True)
    row["seconds"] = time.perf_counter() - t_phase
    emit(row)
    if bad:
        raise AssertionError(f"observability: {bad}")
    return row


# the reference's refusals (its serving/placement.py), word for word; {n} is
# the mesh's size
PLACEMENT_REFUSALS = {
    "replicas=2": "placement replicas=2 exceeds the {n}-device mesh",
    "replicas=0": "placement needs replicas >= 1, got 0",
    "replicas=x": "placement replicas='x' is not an integer",
    "shard=model": "unknown shard axis in placement 'shard=model' (only shard=batch)",
    "banana": "unknown placement 'banana' (want replicas=N or shard=batch)",
}
# `registry`'s unload margin (reserved freed past the static inputs and the
# graph pool, MB) over its runs on the H100 before engines had streams of
# their own (PERF.md §6), measured with the allocator's cached blocks in it;
# `placement` releases those first, so its margin is the engine's own pool
# past its static inputs (the weights) and must not pass the range's top
UNLOAD_MARGIN_MB = (52.4, 71.3)


def phase_placement(jpegs: list[bytes]) -> dict:
    """Placement on the card's mesh, and two engines on streams of their own.

    - Parser: on ``build_mesh()`` (every visible card), no spec,
      ``shard=batch`` and ``replicas=1`` give ``shard`` with one replica;
      ``replicas=2``, ``replicas=0``, ``replicas=x``, ``shard=model`` and
      ``banana`` raise ValueError with the reference's texts; a server given
      ``--model native:inception_v3,replicas=2`` fails that load, naming the
      mesh.
    - ``registry``'s pair (Inception-v3 bf16, MobileNetV2 int8 as
      ``mobilenet_v2_int8``) in one process on the ragged rgb wire, canvas
      512, cache off and a ladder that cannot climb (``PINNED``): each engine
      on a compute stream of its own. The top-k of the 24 JPEGs from each,
      one request at a time, before and after ``tools/loadgen.py`` (as
      ``observability`` runs it) must be bit for bit the same: no two
      concurrent replays shared a cuBLAS workspace or a graph pool.
    - Over the load: img/s, p50, p99; the union busy share and the idle
      share, the summed busy share and the share of the window in which both
      engines' compute overlaps (CUDA events, one base); ``fused_dw`` = 17 ×
      int8 batches and ``preprocess_ragged`` = batches.
    - Unload MobileNetV2 int8 under the running server: ``memory_allocated``
      and ``memory_reserved`` before and after, with every stream's cached
      free blocks released first. The segments freed must be all of its
      graph pool and nothing outside its graph and own pools, and the margin
      (reserved freed past its static bytes and graph pool: its weights'
      segments) at most the top of ``UNLOAD_MARGIN_MB``, 71.3 MB. ``margin_with_cache_mb``
      is the same measure with the cached blocks in it, as ``registry``
      takes it.
    """
    import shutil

    from tensorflow_web_deploy_tpu_torch.parallel.mesh import build_mesh
    from tensorflow_web_deploy_tpu_torch.server import config_from_args, parse_args, start_server
    from tensorflow_web_deploy_tpu_torch.serving.placement import parse_placement
    from tensorflow_web_deploy_tpu_torch.utils.config import ServerConfig, model_config

    t_phase = time.perf_counter()
    row = {"phase": "placement", "nvidia_smi": nvidia_smi(), "models": list(REGISTRY_MODELS),
           "canvas_buckets": list(REGISTRY_BUCKETS)}
    bad: dict = {}

    # the parser on the card's mesh
    mesh = build_mesh()
    n = len(mesh)
    accepted = {str(spec): parse_placement(spec, mesh).summary()
                for spec in (None, "shard=batch", "replicas=1")}
    refused = {}
    for spec in PLACEMENT_REFUSALS:
        try:
            refused[spec] = parse_placement(spec, mesh).summary()
        except ValueError as e:
            refused[spec] = str(e)
    want = {k: v.format(n=n) for k, v in PLACEMENT_REFUSALS.items()}
    cfg = replace(config_from_args(parse_args(["--model", "native:inception_v3,replicas=2"])),
                  host="127.0.0.1", port=0)
    try:
        start_server(cfg).close()
        boot = "served"
    except ValueError as e:
        boot = str(e)
    row["parser"] = {"mesh": [str(d) for d in mesh], "accepted": accepted, "refused": refused,
                     "server_replicas_2": boot}
    if any((a["strategy"], a["replicas"]) != ("shard", 1) for a in accepted.values()) or \
            refused != want or f"exceeds the {n}-device mesh" not in boot:
        bad["parser"] = row["parser"]

    # two engines, two streams
    tmp = tempfile.mkdtemp(prefix="placement-")
    img_dir = os.path.join(tmp, "images")
    os.makedirs(img_dir)
    for i, data in enumerate(jpegs):
        with open(os.path.join(img_dir, f"{i:02d}.jpg"), "wb") as f:
            f.write(data)
    mcs = tuple(model_config(spec) for spec in REGISTRY_MODELS)
    cfg = ServerConfig(model=mcs[0], models=mcs, host="127.0.0.1", port=0,
                       canvas_buckets=REGISTRY_BUCKETS, ragged=True, **PINNED)
    names = [m.serve_name for m in mcs]
    srv = start_server(cfg, device="cuda", seed=SEED)
    try:
        admin = KeepAlive(srv.port)
        serving = {mv.name: mv for mv in srv.registry.serving_entries()}
        engines = {nm: serving[nm].engine for nm in names}
        streams = {nm: [sh.compute.cuda_stream for rep in e._replicas for sh in rep.shards]
                   for nm, e in engines.items()}
        flat = [x for v in streams.values() for x in v]
        row["streams"] = {"compute": streams,
                          "default": torch.cuda.default_stream().cuda_stream,
                          "placement": {nm: e.placement_summary() for nm, e in engines.items()}}
        if len(set(flat)) != len(flat) or row["streams"]["default"] in flat:
            bad["streams"] = row["streams"]
        before = {nm: serial_topk(admin, nm, jpegs) for nm in names}

        batches0 = {nm: e.stats()["batches"] for nm, e in engines.items()}
        base = device_marker()
        zero_launches()
        lg = run_loadgen(srv.port, img_dir, names)
        launches = read_launches()
        nb = {nm: e.stats()["batches"] - batches0[nm] for nm, e in engines.items()}
        want_launches = launches_want(fused_dw=DW_CELLS * nb[INT8_MODEL],
                                      preprocess_ragged=sum(nb.values()))
        row["kernel_launches"] = launches
        row["batches"] = nb
        if launches != want_launches or 0 in nb.values():
            bad["launches"] = {"got": launches, "want": want_launches, "batches": nb}
        sm = lg["summary"]
        row["loadgen"] = {"rc": lg["rc"], "wall_s": lg["wall_s"],
                          **{k: sm.get(k) for k in ("duration_s", "completed", "errors",
                                                    "images_per_sec", "latency_ms",
                                                    "per_model", "device_busy_fraction")}}
        if lg["rc"] != 0 or sm.get("errors") or not sm.get("completed"):
            bad["loadgen"] = row["loadgen"] | {"tables": lg["tables"][-20:]}
        window = sm.get("duration_s") or OBS_LOAD_S
        row["device_time"] = {"window_s": window, **busy_union(engines, base, nb, window)}
        if row["device_time"]["missing_intervals"]:
            bad["device_time"] = row["device_time"]

        after = {nm: serial_topk(admin, nm, jpegs) for nm in names}
        same = {nm: before[nm] == after[nm] for nm in names}
        row["bit_identical_after_load"] = same
        if not all(same.values()):
            bad["bit_identical"] = {nm: [(a, b) for a, b in zip(before[nm], after[nm])
                                         if a != b][:2] for nm in names}

        # unload MobileNetV2 int8 under the running server; the cached free
        # blocks of every stream go back first (empty_cache), so what the
        # unload frees is what the engine held: its graph pool and its own pool
        _, stats = admin.request("GET", "/stats")
        g = next(v for v in stats["models"]["models"][INT8_MODEL]["versions"]
                 if v["state"] == "SERVING")["engine"]["graphs"]
        shard = engines[INT8_MODEL]._replicas[0].shards[0]
        pools = {"graph": tuple(shard.graph_pool), "own": tuple(shard.mem_pool.id)}
        del shard
        torch.cuda.synchronize()
        a0, r_cached = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
        torch.cuda.empty_cache()
        r0 = torch.cuda.memory_reserved()
        seg0 = {sg["address"]: sg for sg in torch.cuda.memory_snapshot()}
        status, body = admin.request("POST", "/models/unload", {"name": INT8_MODEL, "wait": True})
        a1, r1 = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
        seg1 = {sg["address"] for sg in torch.cuda.memory_snapshot()}
        freed = {"graph": 0, "own": 0, "other": 0}
        for addr, sg in seg0.items():
            if addr not in seg1:
                pool = tuple(sg.get("segment_pool_id", ()))
                freed[next((k for k, v in pools.items() if v == pool), "other")] += \
                    sg["total_size"]
        margin_mb = (r0 - r1 - g["static_bytes"] - g["pool_bytes"]) / 1e6
        row["unload"] = {"status": status, "state": body.get("state"),
                         "allocated_before": a0, "allocated_after": a1,
                         "reserved_before": r0, "reserved_after": r1,
                         "reserved_cached_before": r_cached, "freed_by_pool": freed,
                         "static_bytes": g["static_bytes"], "pool_bytes": g["pool_bytes"],
                         "margin_mb": margin_mb,
                         "margin_with_cache_mb": (r_cached - r1 - g["static_bytes"]
                                                  - g["pool_bytes"]) / 1e6,
                         "margin_range_mb": UNLOAD_MARGIN_MB}
        # all of the graph pool and nothing outside the engine's two pools
        # (a cuBLAS workspace freed with it would show as "other" on its
        # stream), and a margin no larger than the range's top
        if (status, body.get("state")) != (200, "UNLOADED") or \
                freed["graph"] != g["pool_bytes"] or freed["other"] or \
                freed["own"] < g["static_bytes"] or \
                not 0.0 <= margin_mb <= UNLOAD_MARGIN_MB[1]:
            bad["unload"] = row["unload"]
        admin.close()
    finally:
        srv.close()
        shutil.rmtree(tmp, ignore_errors=True)
    row["seconds"] = time.perf_counter() - t_phase
    emit(row)
    if bad:
        raise AssertionError(f"placement: {bad}")
    return row


RESNET_BUCKETS = (512,)
RESNET_MAX_BATCH = 32
# the HTTP-level burst, each image on its own connection and worker, so that
# the adaptive window can fill batches of 32
RESNET_BURST = 96
THROUGHPUT_S = 3.0
THROUGHPUT_DEPTH = 4  # batches in flight, the batcher's default pipeline depth
RESNET_INT8 = "native:resnet50,dtype=int8,as=resnet50_int8"
GATE_FAILED = "numerical-parity gate failed"
# Logits, max |Δ| over max |reference| (:func:`logit_rel`). The card's
# float32 forward against the CPU's (the forward the tests hold to the JAX
# package): the same math in another summation order. bf16 against float32
# on the card: bf16 rounding. A wrong max-pool or stem pad moves float32
# logits by 1e-3 to 1e-2 (tests/test_torch_resnet50.py::
# test_logit_gates_see_what_they_are_meant_to_see), so the float32 check is
# the one that sees a wrong forward.
F32_LOGIT_RTOL = 1e-4
BF16_LOGIT_RTOL = 1e-2


def defined_topk(preds: list[dict]) -> list[tuple[int, float]]:
    """The entries of an answer's top-k scored at least ``SERVED_TOL``: the
    part whose order the bf16 softmax defines. The seeded ResNet-50's
    softmax is near one-hot (its logits are in the thousands), so the
    classes below tie at 0.0, where the order is the top-k kernel's."""
    return [(p["index"], p["score"]) for p in preds if p["score"] >= SERVED_TOL]


def answers_agree(a: list[dict], b: list[dict]) -> bool:
    """Two answers for one image: the same defined top-k, in order, scores
    within ``SERVED_TOL`` (another batch bucket may take another cuDNN
    algorithm, so bf16 scores may move by rounding)."""
    da, db = defined_topk(a), defined_topk(b)
    return [i for i, _ in da] == [i for i, _ in db] and \
        all(abs(x - y) <= SERVED_TOL for (_, x), (_, y) in zip(da, db))


def model_probs(eng, canvases: torch.Tensor, hws: torch.Tensor) -> np.ndarray:
    """The engine's preprocess and model, eagerly, on padded canvases:
    softmax probabilities [n, classes] in float32."""
    with torch.inference_mode():
        return eng.model(eng._preprocess(canvases, hws)).float().cpu().numpy()


def throughput(eng, items: list, seconds: float, depth: int) -> dict:
    """Full slabs of ``items`` (``prepare_ragged`` results, one batch)
    dispatched back to back on ``eng`` for ``seconds``, ``depth`` batches in
    flight, each filled on the host as the batcher fills a slab: img/s on
    the host clock, and from the engine's CUDA events each batch's compute
    ms (the static copy and the replay) and the device's idle share of the
    run. Every batch must be a graph replay."""
    from collections import deque

    for _ in range(depth):  # the slab pool and the stream at steady state
        eng.fetch_outputs(dispatch(eng, fill_slab(eng, items), len(items)))
    g0 = eng.stats()["graphs"]
    inflight: deque = deque()
    n = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        inflight.append(dispatch(eng, fill_slab(eng, items), len(items)))
        n += 1
        if len(inflight) >= depth:
            eng.fetch_outputs(inflight.popleft())
    while inflight:
        eng.fetch_outputs(inflight.popleft())
    wall = time.perf_counter() - t0
    g1 = eng.stats()["graphs"]
    dev = eng.device_timeline()[-n:]
    compute = [d["compute"][1] - d["compute"][0] for d in dev]
    span = dev[-1]["compute"][1] - dev[0]["h2d"][0]
    return {"batches": n, "batch": len(items), "wall_s": wall, "img_per_s": n * len(items) / wall,
            "compute_ms_p50": statistics.median(compute), "compute_ms_min": min(compute),
            "compute_ms_sum": sum(compute),
            "idle_share": 1.0 - merged_ms([d["compute"] for d in dev]) / span,
            "replays": g1["replays"] - g0["replays"],
            "eager_batches": g1["eager_batches"] - g0["eager_batches"]}


def slab_unpack_check(eng, items: list, n: int, holes: tuple[int, ...] = ()) -> dict:
    """The ragged kernels on a slab of ``eng``'s pool holding the first
    ``n`` of ``items`` (``prepare_ragged`` results; slots in ``holes`` left
    uncommitted), shipped as ``dispatch_ragged`` ships it at its batch
    bucket: the unpack kernel's canvases and valid sizes must equal its
    plain version and the host's ``pad_to_canvas`` bit for bit (a hole, or
    a slot past ``n``: a zero canvas, hw (1, 1)), and the ragged preprocess
    kernel's output at the engine's size, mode and dtype must equal its
    plain version bit for bit."""
    from tensorflow_web_deploy_tpu_torch.ops.image import (
        pad_to_canvas,
        unpack_ragged,
        unpack_ragged_plain,
    )
    from tensorflow_web_deploy_tpu_torch.ops.preprocess_ragged import (
        preprocess_ragged,
        preprocess_ragged_plain,
    )

    s, bucket = 512, eng.pick_batch_bucket(n)
    want = np.zeros((bucket, s, s, 3), np.uint8)
    want_hw = np.ones((bucket, 2), np.int32)
    for i, (tight, *_) in enumerate(items[:n]):
        if i not in holes:
            want[i], want_hw[i] = pad_to_canvas(tight, (s,))
    slab = fill_slab(eng, items[:n], holes)
    try:
        slab.truncate(n)
        nbytes, meta_off = slab.stage(bucket)
        dev = slab.buf[:nbytes].to("cuda")
    finally:
        eng.release_staging(slab)
    meta = dev[meta_off:].view(torch.int32).view(bucket, 4)
    got, got_hw = unpack_ragged(dev[:meta_off], meta, s)
    plain, plain_hw = unpack_ragged_plain(dev[:meta_off], meta, s)
    args = (dev[:meta_off], meta, s, *eng.model_cfg.input_size, eng.model_cfg.preprocess,
            eng.dtype)
    return {"rows": n, "bucket": bucket, "holes": list(holes),
            "kernel_is_plain": bool(torch.equal(got, plain) and torch.equal(got_hw, plain_hw)),
            "kernel_is_host": bool(np.array_equal(got.cpu().numpy(), want)
                                   and np.array_equal(got_hw.cpu().numpy(), want_hw)),
            "preprocess_is_plain": bool(torch.equal(preprocess_ragged(*args),
                                                    preprocess_ragged_plain(*args)))}


def logit_rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a − b| over max |b|: logits [n, classes] against a reference."""
    return float((a.float() - b.float()).abs().max() / b.float().abs().max())


def phase_resnet50(jpegs: list[bytes]) -> dict:
    """ResNet-50 (BASELINE config 3, batch-32 throughput mode) served alone.

    - Serve: one server with ``native:resnet50`` in bf16 at full width, the
      ragged rgb wire, the matmul resize (the preprocess kernel refuses
      caffe), canvas 512, ``max_batch`` 32: 6 graphs captured at boot
      (batch 1, 2, 4, 8, 16, 32), each graph pool's bytes printed. A burst
      of the 24 JPEGs with the kernels' counts set to 0 just before it and
      read just after: every batch a replay, ``preprocess_ragged`` once per
      batch, no other kernel. The same JPEGs
      one at a time must answer as the burst did (:func:`answers_agree`).
    - Throughput: full batch-32 slabs of the 24 JPEGs (cycled) dispatched
      back to back on the captured graph (:func:`throughput`): img/s,
      compute ms per batch (CUDA events), one replay's device time, MFU and
      roofline fraction from the cost model against the card's peak, and
      the bound, 32 × 8.18 GFLOP at 989.4 TFLOP/s (0.265 ms). Then the
      unpack kernel against its plain version, bit for bit, on the
      engine's batch-32 slabs (:func:`slab_unpack_check`).
    - HTTP: a burst of 96 images at once with the adaptive window: the
      batch sizes it sealed, img/s, p50 and p99; launches again = batches.
    - float32: the 24 JPEGs through a float32 ResNet-50 engine (TF32 off):
      its logits within ``F32_LOGIT_RTOL`` of the CPU's float32 forward
      on the same inputs, the bf16 engine's within ``BF16_LOGIT_RTOL`` of
      its, top-1 agreement 1.0; the max probability delta.
    - int8: ``POST /models/load`` of ``native:resnet50,dtype=int8,as=
      resnet50_int8`` into the server: the gate's verdict on the card and
      its numbers, and the bf16 version still answering 200. At 64 px both
      packages refuse it on the CPU. At the served 224 px the reference
      refuses it (max_prob_delta 0.5: two classes of one probe image round
      to one bf16 logit), and since the port computes the stem as the
      reference does (space-to-depth), the card's gate refuses it too:
      the phase requires that refusal (ROADMAP Queue 3, fault 7).
    """
    import ast
    import re

    from tensorflow_web_deploy_tpu_torch.models.adapter import native_converted
    from tensorflow_web_deploy_tpu_torch.ops.image import pad_to_canvas
    from tensorflow_web_deploy_tpu_torch.server import start_server
    from tensorflow_web_deploy_tpu_torch.serving import costmodel
    from tensorflow_web_deploy_tpu_torch.serving.engine import InferenceEngine

    t_phase = time.perf_counter()
    common = dict(wire="rgb", resize="matmul", ragged=True, canvas_buckets=RESNET_BUCKETS,
                  max_batch=RESNET_MAX_BATCH)
    cfg = _config("resnet50", "bfloat16", http_workers=RESNET_BURST, host="127.0.0.1", port=0,
                  **common)
    row = {"phase": "resnet50", "nvidia_smi": nvidia_smi(), "model": "native:resnet50",
           "width": 1.0, "dtype": "bfloat16", "wire": "rgb", "ragged": True, "resize": "matmul",
           "canvas_buckets": list(RESNET_BUCKETS), "max_batch": RESNET_MAX_BATCH}
    bad: dict = {}

    def counts() -> dict:
        return read_launches()

    t0 = time.perf_counter()
    srv = start_server(cfg, device="cuda", seed=SEED)
    row["boot_s"] = time.perf_counter() - t0
    admin = KeepAlive(srv.port)
    try:
        eng = srv.engine
        shard = eng._replicas[0].shards[0]  # the card: one replica of one device
        st = eng.stats()
        # the replica's graphs share one graph pool: its bytes are theirs
        row.update(batch_buckets=list(eng.batch_buckets), warmup_s=st["warmup_s"],
                   graphs=st["graphs"], graph_pool={
                       "graphs": [f"{k[0]}:{k[1]}x{k[2]}" for k in sorted(shard.exes)],
                       "bytes": st["graphs"]["pool_bytes"],
                       "static_bytes": st["graphs"]["static_bytes"]},
                   memory_allocated=torch.cuda.memory_allocated(),
                   memory_reserved=torch.cuda.memory_reserved())
        if eng.batch_buckets != (1, 2, 4, 8, 16, 32) or \
                st["graphs"]["captured"] != len(RESNET_BUCKETS) * len(eng.batch_buckets) or \
                st["graphs"]["pool_bytes"] <= 0:
            bad["graphs"] = {"buckets": eng.batch_buckets, "graphs": st["graphs"]}
        urllib.request.urlopen(srv.url + "/healthz", timeout=120).read()

        # the main path: a burst of the 24 JPEGs
        before = eng.stats()
        zero_launches()
        results, timeline = burst(srv, jpegs)
        launches = counts()
        after = eng.stats()
        batches = after["batches"] - before["batches"]
        graphs = {k: after["graphs"][k] - before["graphs"][k]
                  for k in ("replays", "eager_batches")}
        row["kernel_launches"] = launches
        row["serve"] = {"requests": len(jpegs), "batches": batches, "graphs": graphs,
                        "statuses": dict(Counter(r[0] for r in results)),
                        "img_per_s": len(jpegs) / timeline["wall_ms"] * 1e3,
                        "p50_ms": timeline["client_latency_ms"]["p50"],
                        "p99_ms": timeline["client_latency_ms"]["p99"],
                        "decodes": {d: after["decodes"][d] - before["decodes"][d]
                                    for d in after["decodes"]}}
        want = launches_want(preprocess_ragged=batches)
        if launches != want or batches == 0 or \
                graphs != {"replays": batches, "eager_batches": 0} or \
                row["serve"]["statuses"] != {200: len(jpegs)}:
            bad["serve"] = {**row["serve"], "launches": launches, "want": want}
        served = [r[1].get("predictions", []) for r in results]
        if not all(len(p) == eng.topk and all(math.isfinite(q["score"]) and
                                               0 <= q["index"] < 1000 for q in p)
                   for p in served):
            bad["answers"] = served[:2]
        serial = [post(srv.url + "/predict", d) for d in jpegs]
        serial_preds = [r[1]["predictions"] for r in serial]
        agree = [answers_agree(a, b) for a, b in zip(served, serial_preds)]
        lat = np.array([r[2] for r in serial]) * 1e3
        row["serial_vs_burst"] = {
            "images": len(jpegs), "agree": sum(agree),
            "topk_identical": sum(a == b for a, b in zip(served, serial_preds)),
            "defined_entries": [len(defined_topk(p)) for p in served],
            "serial_p50_ms": float(np.percentile(lat, 50)),
            "serial_p99_ms": float(np.percentile(lat, 99))}
        if not all(agree):
            bad["serial_vs_burst"] = [(a, b) for a, b, ok in zip(served, serial_preds, agree)
                                      if not ok][:2]

        # throughput mode: full batch-32 slabs on the captured graph
        prepared = [eng.prepare_ragged(d) for d in jpegs]
        items = [prepared[i % len(prepared)] for i in range(RESNET_MAX_BATCH)]
        tp = throughput(eng, items, THROUGHPUT_S, THROUGHPUT_DEPTH)
        exe = shard.exes[("ragged", 512, RESNET_MAX_BATCH)]
        with eng._replicas[0].lock, torch.cuda.stream(shard.compute):
            tp["replay_ms"] = cuda_time_ms(exe)
        del exe  # its graph and output would keep the graph pool alive past close()
        cost = costmodel.model_cost(eng.model_cfg)
        peak = costmodel.backend_peak("bfloat16")
        rows = tp["batches"] * RESNET_MAX_BATCH
        tight = sum(t.nbytes for t, *_ in items) / (512 * 512 * 3) * tp["batches"]
        econ = costmodel.bucket_economics(cost, 512, RESNET_MAX_BATCH, rows, rows,
                                          tp["compute_ms_sum"] / 1e3, peak, 1,
                                          eng.model_cfg.input_size, "ragged", rows_tight=tight)
        flops = RESNET_MAX_BATCH * cost["flops_per_image"]
        nbytes = RESNET_MAX_BATCH * costmodel.bytes_per_image(cost, 512, RESNET_MAX_BATCH,
                                                              "ragged")
        tp.update(flops_per_replay=flops, bytes_per_replay=nbytes,
                  flops_bound_ms=flops / peak["flops_per_chip"] * 1e3,
                  bytes_bound_ms=nbytes / peak["bytes_per_s_per_chip"] * 1e3,
                  peak=peak, mfu=econ.get("mfu"),
                  roofline_bound_fraction=econ.get("roofline_bound_fraction"),
                  bound=econ.get("bound"), arithmetic_intensity=econ.get("arithmetic_intensity"),
                  model_mfu_replay=flops / (tp["replay_ms"] / 1e3) / peak["flops_per_chip"])
        tp["bound_ms"] = max(tp["flops_bound_ms"], tp["bytes_bound_ms"])
        row["throughput"] = tp
        if tp["replays"] != tp["batches"] or tp["eager_batches"] or \
                not 0 < (tp["mfu"] or 0) <= 1:
            bad["throughput"] = tp

        # the unpack and ragged preprocess kernels at this path's shapes:
        # batch-32 slabs of the 512 canvas, full, with a hole, and 31 rows in
        # the 32 bucket (the HTTP burst's batches)
        row["unpack_32"] = [slab_unpack_check(eng, items, n, holes)
                            for n, holes in ((32, ()), (32, (7,)), (31, ()))]
        if not all(c["kernel_is_plain"] and c["kernel_is_host"] and c["preprocess_is_plain"]
                   for c in row["unpack_32"]):
            bad["unpack_32"] = row["unpack_32"]

        # HTTP: 96 images at once
        big = [jpegs[i % len(jpegs)] for i in range(RESNET_BURST)]
        b0 = eng.stats()
        zero_launches()
        res96, tl96 = burst(srv, big)
        l96 = counts()
        b1 = eng.stats()
        recs = [r for r in srv.batcher.batch_timeline() if r["t_seal"] >= tl96["t0_monotonic"]]
        n96 = b1["batches"] - b0["batches"]
        row["http_burst"] = {
            "requests": RESNET_BURST, "statuses": dict(Counter(r[0] for r in res96)),
            "batch_sizes": [r["rows"] for r in recs], "buckets": [r["bucket"] for r in recs],
            "batches": n96, "kernel_launches": l96,
            "replays": b1["graphs"]["replays"] - b0["graphs"]["replays"],
            "img_per_s": RESNET_BURST / tl96["wall_ms"] * 1e3,
            "p50_ms": tl96["client_latency_ms"]["p50"], "p99_ms": tl96["client_latency_ms"]["p99"],
            "batches_ms": tl96["batches_ms"]}
        if row["http_burst"]["statuses"] != {200: RESNET_BURST} or \
                l96 != launches_want(preprocess_ragged=n96) or \
                row["http_burst"]["replays"] != n96:
            bad["http_burst"] = row["http_burst"]

        # bf16 against float32 on the same canvases: logits, and the
        # float32 forward against the CPU's on the same inputs
        canvases = torch.from_numpy(np.stack([pad_to_canvas(t, RESNET_BUCKETS)[0]
                                              for t, *_ in prepared])).cuda()
        hws = torch.tensor([hw for _, hw, *_ in prepared], dtype=torch.int32).cuda()
        p16 = model_probs(eng, canvases, hws)
        f32 = InferenceEngine(_config("resnet50", "float32", warmup=False, **common),
                              device="cuda", seed=SEED)
        try:
            p32 = model_probs(f32, canvases, hws)
            with torch.inference_mode():
                x32 = f32._preprocess(canvases, hws)
                l32 = f32.model.backbone(x32.permute(0, 3, 1, 2))
                l16 = eng.model.backbone(eng._preprocess(canvases, hws).permute(0, 3, 1, 2))
                cpu = native_converted("resnet50", seed=SEED).backbone
                lcpu = cpu(x32.cpu().permute(0, 3, 1, 2))
        finally:
            f32.close()
        top1 = np.array([p[0]["index"] for p in served])
        row["float32"] = {
            "images": len(jpegs), "top1_agreement": float(np.mean(p16.argmax(1) == p32.argmax(1))),
            "logit_top1_agreement": float((l16.argmax(1) == l32.argmax(1)).float().mean()),
            "max_prob_delta": float(np.abs(p16 - p32).max()),
            "bf16_logit_rel": logit_rel(l16, l32), "bf16_logit_rtol": BF16_LOGIT_RTOL,
            "f32_vs_cpu_logit_rel": logit_rel(l32.cpu(), lcpu), "f32_logit_rtol": F32_LOGIT_RTOL,
            "max_abs_logit_f32": float(l32.abs().max()),
            "served_top1_is_bf16_top1": float(np.mean(top1 == p16.argmax(1))),
            "max_prob_f32": [float(np.min(p32.max(1))), float(np.max(p32.max(1)))],
            "tf32": [torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32]}
        f = row["float32"]
        if not (np.isfinite(p16).all() and np.isfinite(p32).all()
                and p16.shape == p32.shape == (len(jpegs), 1000)
                and bool(torch.isfinite(l16).all()) and bool(torch.isfinite(l32).all())
                and f["top1_agreement"] == f["logit_top1_agreement"] == 1.0
                and f["bf16_logit_rel"] <= BF16_LOGIT_RTOL
                and f["f32_vs_cpu_logit_rel"] <= F32_LOGIT_RTOL):
            bad["float32"] = f

        # the int8 tier at full width: the gate decides
        t0 = time.perf_counter()
        status, doc = admin.request("POST", "/models/load",
                                    {"model": RESNET_INT8, "wait": True, "timeout_s": 300})
        err = doc.get("error") or ""
        found = re.search(r"\{.*\}", err)
        gate = ast.literal_eval(found.group(0)) if found else None
        if (status, doc.get("state")) == (500, "FAILED") and GATE_FAILED in err:
            verdict = "refused"
        elif (status, doc.get("state")) == (200, "SERVING"):
            verdict = "passed"
            _, models = admin.request("GET", "/models")
            gate = next(v for v in models["models"]["resnet50_int8"]["versions"]
                        if v["state"] == "SERVING").get("parity")
        else:
            verdict = "other"
        again, body = admin.request("POST", "/predict?model=resnet50", jpegs[0])
        row["int8"] = {"spec": RESNET_INT8, "status": status, "state": doc.get("state"),
                       "verdict": verdict, "gate": gate, "load_s": time.perf_counter() - t0,
                       "error": err[:160], "bf16_after": again,
                       "bf16_after_matches": again == 200 and answers_agree(
                           body["predictions"], serial_preds[0])}
        if verdict != "refused" or gate is None or gate.get("pass") is not False or \
                not row["int8"]["bf16_after_matches"]:
            bad["int8"] = row["int8"]
    finally:
        admin.close()
        srv.close()
    row["seconds"] = time.perf_counter() - t_phase
    emit(row)
    if bad:
        raise AssertionError(f"resnet50: {bad}")
    return row


def make_photos(n: int, seed: int, side: int = 1024) -> list[bytes]:
    """``n`` distinct seeded 4:3 JPEGs ``side`` px wide (quality 90): smooth
    colour fields (each channel a sine along y, x or x + y) plus noise cut
    from one seeded field at a per-image offset; encoded on 8 threads."""
    from PIL import Image

    h, w = side * 3 // 4, side
    rs = np.random.RandomState(seed)
    noise = rs.normal(0, 12, (2 * h, 2 * w, 3)).astype(np.float32)
    params = rs.uniform(0.5, 3.0, (n, 3))
    offsets = rs.randint(0, h, (n, 2))
    y, x, xy = np.arange(h)[:, None], np.arange(w)[None, :], np.arange(h + w)

    def one(i: int) -> bytes:
        f = params[i]
        r = 127 + 120 * np.sin(f[0] * y / h * math.pi + i)
        g = 127 + 120 * np.cos(f[1] * x / w * math.pi)
        b = (127 + 120 * np.sin(f[2] * xy / (h + w) * math.pi))[y + x]
        img = np.stack(np.broadcast_arrays(r, g, b), -1)
        oy, ox = offsets[i]
        img = np.clip(img + noise[oy:oy + h, ox:ox + w], 0, 255).astype(np.uint8)
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, "JPEG", quality=90)
        return buf.getvalue()

    with ThreadPoolExecutor(8) as pool:
        return list(pool.map(one, range(n)))


def sweep_nms(other: str) -> None:
    """``csrc/nms_fixed.cu`` against another version of that source with
    the same C entry (``other``: an earlier commit's, say), on the ``ssd``
    phase's candidates (SSD-MobileNet bf16, seed 0, the 24 JPEGs cycled to
    a batch of 32, 90 classes) at every ``NMS_CASES`` shape: both keep
    masks against the plain fixpoint bit for bit, and each kernel's µs in a
    CUDA graph, timed in the order other, this, this, other. Prints
    nvcc's register report for both sources first."""
    import ctypes

    from tensorflow_web_deploy_tpu_torch.ops import _build
    from tensorflow_web_deploy_tpu_torch.ops.detection import nms_fixed_plain
    from tensorflow_web_deploy_tpu_torch.serving.engine import InferenceEngine

    emit({"phase": "ptxas", "nms_fixed": ptxas_report("nms_fixed").splitlines(),
          "other": ptxas_report(other).splitlines()})
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "libother.so")
        proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", path, other],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {other}:\n{proc.stdout}{proc.stderr}")
        libs = {"this": _build.load("nms_fixed"), "other": ctypes.CDLL(path)}

    def entry(lib):
        fn = lib.twd_nms_fixed
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                               ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int

        def run(cb: torch.Tensor, cs: torch.Tensor) -> torch.Tensor:
            keep = torch.empty(cs.shape, dtype=torch.uint8, device=cs.device)
            err = fn(cb.data_ptr(), cs.data_ptr(), keep.data_ptr(), cb.shape[0], cb.shape[1],
                     NMS_IOU, NMS_SCORE, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"nms_fixed launch failed: CUDA error {err}")
            return keep.view(torch.bool)
        return run

    runs = {name: entry(lib) for name, lib in libs.items()}
    cfg = _config("ssd_mobilenet", "bfloat16", warmup=False, wire="rgb", resize="matmul",
                  ragged=True, canvas_buckets=SSD_BUCKETS, max_batch=SSD_MAX_BATCH)
    eng = InferenceEngine(cfg, device="cuda", seed=SEED)
    try:
        prepared = [eng.prepare_ragged(data) for data in make_jpegs(24, SEED)]
        items = [prepared[i % len(prepared)] for i in range(SSD_MAX_BATCH)]
        *_, boxes, scores = ssd_candidates(eng, items)
        smi = nvidia_smi()
        for images, k in NMS_CASES:
            cb, cs = nms_rows(boxes[:images], scores[:images], k)
            with torch.inference_mode():
                plain = nms_fixed_plain(cb, cs, NMS_IOU, NMS_SCORE)
                equal = {name: bool(torch.equal(run(cb, cs), plain))
                         for name, run in runs.items()}
            us: dict = {"other": [], "this": []}
            for name in ("other", "this", "this", "other"):
                us[name].append(graph_time_ms(lambda: runs[name](cb, cs)) * 1e3)
            row = {"phase": "sweep_nms", "nvidia_smi": smi, "other": other, "images": images,
                   "k": k, "rows": cb.shape[0], "kept": int(plain.sum()),
                   "candidates": int((cs > NMS_SCORE).sum()), "equal": equal, "us": us}
            emit(row)
            if not all(equal.values()):
                raise AssertionError(f"a keep mask differs from the plain fixpoint: {row}")
    finally:
        eng.close()


def sweep_overload() -> None:
    """The flood of ``overload`` (256 distinct JPEGs, 32 connections,
    ``X-Deadline-Ms: 100``) on a fresh overload server per (pipeline depth,
    assembly window cap, images): the seeded JPEGs of the main paths (≤ 512
    px) or 1024-px photos (decoded at half scale). Each server takes the
    flood twice, 2 s apart, with fresh images. Every ladder observation's
    queue fraction and level are recorded; one line per flood: answers,
    levels seen, the highest, reroutes, deadline sheds at the lease and at
    the seal, and the fraction's quantiles and tail shares."""
    from tensorflow_web_deploy_tpu_torch.server import start_server
    from tensorflow_web_deploy_tpu_torch.utils.config import ServerConfig, model_config

    mcs = tuple(model_config(spec) for spec in OVERLOAD_MODELS)
    images = {"jpegs": [make_jpegs(FLOOD_IMAGES, SEED + 10 + k) for k in range(2)],
              "photos": [make_photos(FLOOD_IMAGES, SEED + 20 + k) for k in range(2)]}
    for depth, window in ((4, 2.0), (1, 20.0)):
        for kind, sets in images.items():
            cfg = ServerConfig(model=mcs[0], models=mcs, host="127.0.0.1", port=0,
                               canvas_buckets=REGISTRY_BUCKETS, ragged=True, resize="gather",
                               pipeline_depth=depth, max_delay_ms=window, **OVERLOAD)
            with start_server(cfg, device="cuda", seed=SEED) as srv:
                app, seen = srv.app, []
                observe = app.pressure.observe_pressure

                def recording(frac, now=None, _observe=observe):
                    level = _observe(frac, now)
                    seen.append((frac, level))
                    return level

                app.pressure.observe_pressure = recording
                for k, jpegs in enumerate(sets):
                    if k:
                        time.sleep(2.0)
                    seen.clear()
                    b0 = serving_batchers(srv)
                    r0 = app.pressure.stats()["quant_reroutes"]
                    t0 = time.perf_counter()
                    flood = fan_out(srv.port, jpegs, FLOOD_CONNS, f"/predict?model={BF16_MODEL}",
                                    {"X-Deadline-Ms": str(FLOOD_DEADLINE_MS)})
                    wall = time.perf_counter() - t0
                    b1 = serving_batchers(srv)
                    fr = np.array([f for f, _ in seen])
                    levels = Counter(lv for _, lv in seen)
                    emit({"phase": "overload_sweep", "pipeline_depth": depth,
                          "max_delay_ms": window, "images": kind, "flood": k,
                          "wall_ms": wall * 1e3, "answers": dict(Counter(
                              f"{r['status']} {r['doc'].get('model') or r['doc'].get('reason')}"
                              for r in flood)),
                          "levels_seen": {str(lv): n for lv, n in sorted(levels.items())},
                          "max_level": max(levels),
                          "quant_reroutes": app.pressure.stats()["quant_reroutes"] - r0,
                          "sheds": {n: [b1[n][key] - b0[n][key] for key in (
                              "deadline_sheds_total", "deadline_seal_sheds_total",
                              "backlog_rejects")] for n in b1},
                          "observations": len(fr),
                          "frac_p10_p50_p90": [float(np.percentile(fr, q)) for q in (10, 50, 90)],
                          "frac_at_least": {str(x): float((fr >= x).mean())
                                            for x in (0.30, 0.50, 0.70, 0.95)},
                          "nvidia_smi": nvidia_smi()})


def serving_batchers(srv) -> dict:
    return {mv.name: mv.batcher.stats() for mv in srv.registry.serving_entries()}


def walk_down(app, client: KeepAlive, path: str, jpegs: list[bytes]) -> int:
    """Requests one dwell apart until the ladder is back at level 0 (each
    request is one step); how many it took, at most 20."""
    n = 0
    while app.pressure.level and n < 20:
        time.sleep(OVERLOAD["pressure_dwell_s"] * 1.2)
        client.exchange("POST", path, jpegs[n % len(jpegs)])
        n += 1
    return n


def latency_of(records: list[dict]) -> dict:
    lat = [r["ms"] for r in records]
    if not lat:
        return {"n": 0}
    return {"n": len(lat), "p50": float(np.percentile(lat, 50)),
            "p99": float(np.percentile(lat, 99))}


SSD_BUCKETS = (512,)
SSD_MAX_BATCH = 32
SSD_SIZE = 300
SSD_INT8 = "native:ssd_mobilenet,dtype=int8,as=ssd_mobilenet_int8"
# the int8 tier at 64 px: the reference's gate serves it at full width
SSD_INT8_SMALL = 64
# the reference's int8 gate for full-width SSD at 300 px, seeded weights,
# its own probe, on a CPU: refused (tolerances 0.06 and 0.25)
SSD_REF_GATE = {"max_score_delta": 0.10363, "max_box_delta": 0.37287}
SSD_THROUGHPUT_S = 2.0
SSD_ANSWER_KEYS = {"detections", "num_detections", "model", "model_version", "latency_ms",
                   "trace_id"}
# the served NMS: the reference's defaults
NMS_IOU, NMS_SCORE, NMS_K = 0.6, 1e-8, 100
# float32 operations per candidate pair of the NMS test (2 min, 2 max, 2
# subtractions, 2 clamps, the intersection's product, the union's add and
# subtraction, the threshold's product, the comparison)
NMS_PAIR_OPS = 13
# the NMS kernel on the served candidates at other shapes, (images,
# candidates a row), each bit for bit against the plain fixpoint: the batch
# of 32 either side of a 32-candidate word and at the kernel's largest, and
# one image's 90 rows of 100 (the `dag` path's batch-1 launch)
NMS_CASES = ((32, 33), (32, 65), (32, 99), (32, 100), (32, 256), (1, 100))
# the previous kernel's µs a served batch of 32 (PERF.md: the runs of PRs
# 14-19 on an NVIDIA H100 80GB HBM3 at 700 W), printed beside this run's
NMS_BEFORE_US = (58.43, 61.47)
# SSD-MobileNet's six depthwise cells at 300 px: (channels, input side,
# stride); block1 and feat1 take odd inputs (75, 19), which pad (1, 1)
SSD_DW = [(96, 150, 2), (144, 75, 2), (192, 38, 2), (384, 19, 1), (384, 19, 2), (768, 10, 2)]
SSD_DW_BATCHES = (1, 32)
# SSD's raw outputs in bf16 against float32 (max |Δ| over max |raw|): the
# reference's own bf16 forward lies 1.15–1.56e-2 from its float32 forward
# on the CPU (width 1.0 at 64 px, 0.25 at 300, 0.5 at 160), above the 1e-2
# that ResNet-50's logits keep; tests/test_torch_ssd.py holds the port's
# deviation to within a quarter of the reference's on the same inputs
SSD_BF16_RTOL = 3e-2
# a box coordinate of one answer against another's, in pixels over the
# image's side: bf16 rounding moves raw box codes a little between batch
# buckets (another cuDNN algorithm)
BOX_TOL = 1e-2


def ssd_answers_agree(a: dict, b: dict, score_tol: float = SERVED_TOL,
                      box_tol: float = BOX_TOL) -> dict:
    """Two answers for one image: the same count, and the same classes and
    labels in order; scores within ``score_tol`` and each box coordinate
    within ``box_tol`` of the image's side (the largest coordinate of
    ``a``'s boxes; by default the served tolerances: another batch bucket
    may take another cuDNN algorithm, so bf16 raw outputs may move by
    rounding). Returns the verdict and the largest differences."""
    da, db = a["detections"], b["detections"]
    side = max([abs(v) for d in da for v in d["box"]] + [1.0])
    same = (a["num_detections"] == b["num_detections"] and len(da) == len(db)
            and [(d["class"], d["label"]) for d in da] == [(d["class"], d["label"]) for d in db])
    score = max([abs(x["score"] - y["score"]) for x, y in zip(da, db)] + [0.0])
    box = max([abs(u - v) for x, y in zip(da, db) for u, v in zip(x["box"], y["box"])] + [0.0])
    return {"ok": same and score <= score_tol and box <= box_tol * side,
            "max_score_diff": score, "max_box_diff_over_side": box / side}


def ssd_answer_ok(body: dict, classes: int) -> bool:
    """The reference's detect answer: its keys, ``num_detections`` entries,
    each with a finite box, a class in range with its label, a score in
    (0, 1], scores non-increasing."""
    dets = body.get("detections", [])
    scores = [d["score"] for d in dets]
    return (set(body) == SSD_ANSWER_KEYS and body["num_detections"] == len(dets) <= NMS_K
            and all(len(d["box"]) == 4 and all(math.isfinite(v) for v in d["box"])
                    and 0 <= d["class"] < classes and d["label"] == f"class_{d['class']:04d}"
                    and 0 < d["score"] <= 1 for d in dets)
            and all(x >= y for x, y in zip(scores, scores[1:])))


def scene_biases(classes: int, n_anchor: int, seed: int = 0) -> np.ndarray:
    """The anchor scene's ``cls`` biases, [2 heads, n_anchor·(classes+1)]:
    distinct values exactly representable in bf16, in [-6, 6), background
    (class 0) lower than every class (tests/test_torch_ssd.py draws its
    own the same way)."""
    pool = np.arange(-6.0, 6.0, 1 / 64, dtype=np.float32)
    pool = pool[torch.from_numpy(pool).to(torch.bfloat16).float().numpy() == pool]
    rs = np.random.RandomState(seed)
    n_bg, n_cls = 2 * n_anchor, 2 * n_anchor * classes
    bg, rest = pool[:n_bg], rs.permutation(pool[n_bg:])[:n_cls]
    out = np.empty((2, n_anchor, classes + 1), np.float32)
    out[..., 0] = bg.reshape(2, n_anchor)
    out[..., 1:] = rest.reshape(2, n_anchor, classes)
    return out.reshape(2, -1)


def scene_params(flat: dict, biases: np.ndarray) -> dict:
    """``flat`` (the JAX layout) with the heads set to the anchor scene:
    kernels zero, ``loc`` biases zero, ``cls`` biases ``biases``."""
    p = dict(flat)
    for h in (1, 2):
        for part in ("loc", "cls"):
            p[f"params/head{h}_{part}/kernel"] = np.zeros_like(p[f"params/head{h}_{part}/kernel"])
        p[f"params/head{h}_loc/bias"] = np.zeros_like(p[f"params/head{h}_loc/bias"])
        p[f"params/head{h}_cls/bias"] = biases[h - 1].astype(np.float32)
    return p


def scene_expectation(anchors: np.ndarray, biases: np.ndarray, n_pos: tuple[int, int],
                      n_anchor: int, score_of, k: int = NMS_K, d: int = 100,
                      iou: float = NMS_IOU, score_thr: float = NMS_SCORE):
    """The anchor scene's detections, on the host (the same expectation as
    tests/test_torch_ssd.py's): raw box codes 0, so each box is its anchor
    (cy ∓ h/2, cx ∓ w/2 in float32); raw scores the ``cls`` bias of the
    anchor's shape, by position then shape within each head; per class the
    top ``k`` by score (stable), greedy NMS in float32 as the reference's,
    then the top ``d`` of all classes (stable), zero past ``num``.
    ``score_of`` maps raw scores to sigmoid scores."""
    c1 = biases.shape[1] // n_anchor
    raw = np.concatenate([np.tile(b.reshape(n_anchor, c1), (n, 1))
                          for b, n in zip(biases, n_pos)])  # [A, C+1]
    cy, cx, h, w = (anchors[:, i] for i in range(4))
    two = np.float32(2)
    boxes = np.stack([cy - h / two, cx - w / two, cy + h / two, cx + w / two], 1)
    scores = score_of(raw)[:, 1:]
    a, c = scores.shape
    k, d = min(k, a), min(d, c * min(k, a))
    thr = np.float32(iou)
    cand_boxes = np.zeros((c, k, 4), np.float32)
    kept = np.zeros((c, k), np.float32)
    for cls in range(c):
        order = np.argsort(-scores[:, cls], kind="stable")[:k]
        cb, cs = boxes[order], scores[order, cls]
        chosen: list[int] = []
        for i in range(k):
            if not cs[i] > np.float32(score_thr):
                continue
            ok = True
            for j in chosen:
                area = [max(b[2] - b[0], np.float32(0)) * max(b[3] - b[1], np.float32(0))
                        for b in (cb[i], cb[j])]
                hh = max(min(cb[i][2], cb[j][2]) - max(cb[i][0], cb[j][0]), np.float32(0))
                ww = max(min(cb[i][3], cb[j][3]) - max(cb[i][1], cb[j][1]), np.float32(0))
                inter = hh * ww
                if inter > thr * ((area[0] + area[1]) - inter):
                    ok = False
                    break
            if ok:
                chosen.append(i)
                kept[cls, i] = cs[i]
        cand_boxes[cls] = cb
    flat_scores = kept.reshape(-1)
    top = np.argsort(-flat_scores, kind="stable")[:d]
    valid = flat_scores[top] > np.float32(score_thr)
    n = int(valid.sum())
    out_boxes = np.zeros((d, 4), np.float32)
    out_scores = np.zeros(d, np.float32)
    out_classes = np.zeros(d, np.int32)
    out_boxes[:n] = cand_boxes.reshape(-1, 4)[top[:n]]
    out_scores[:n] = flat_scores[top[:n]]
    out_classes[:n] = top[:n] // k
    return out_boxes, out_scores, out_classes, np.int32(n)


def nms_adversarial_rows(seed: int) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """Rows for the NMS kernel beyond the served ones, each group [rows, K]
    on the card in priority order (a stable descending sort): clustered
    centers (deep suppression chains), scores quantized to eighths (ties),
    a zero-area box in every fifth row, K from 1 to the kernel's 256 (K <
    100 included), and a group with inf and NaN coordinates and NaN scores
    (the plain version's max and min propagate NaN)."""
    rs = np.random.RandomState(seed)
    groups = []
    for k in (1, 2, 7, 31, 32, 33, 63, 64, 65, 99, 100, 128, 200, 256):
        n = 40
        centers = rs.rand(n, max(1, k // 6), 2)
        pick = centers[np.arange(n)[:, None], rs.randint(0, centers.shape[1], (n, k))]
        size = 0.05 + rs.rand(n, k, 2) * 0.15
        y0 = pick[..., 0] + rs.randn(n, k) * 0.03
        x0 = pick[..., 1] + rs.randn(n, k) * 0.03
        boxes = np.stack([y0, x0, y0 + size[..., 0], x0 + size[..., 1]], -1).astype(np.float32)
        boxes[::5, 0, 2] = boxes[::5, 0, 0]
        scores = (rs.randint(0, 8, (n, k)) / 8.0).astype(np.float32)
        scores[1::2] += rs.rand(n // 2, k).astype(np.float32)
        if k == 100:
            boxes[:4, 3, 1] = np.inf
            boxes[4:8, 5, 2] = np.nan
            boxes[8:12, 7] = [-np.inf, -np.inf, np.inf, np.inf]
            scores[12:16, 9] = np.nan
        groups.append((boxes, scores))
    out = []
    for boxes, scores in groups:
        b, s = torch.from_numpy(boxes).cuda(), torch.from_numpy(scores).cuda()
        s, order = torch.sort(s, dim=-1, descending=True, stable=True)
        out.append((torch.gather(b, 1, order[..., None].expand(-1, -1, 4)).contiguous(),
                    s.contiguous()))
    return out


def ssd_raw(eng, canvases: torch.Tensor, hws: torch.Tensor) -> tuple:
    """The engine's preprocess and model, eagerly, on padded canvases:
    (raw_boxes, raw_scores, anchors)."""
    with torch.inference_mode():
        return eng.model(eng._preprocess(canvases, hws))


def ssd_candidates(eng, items: list) -> tuple:
    """A batch of prepared images through the engine's preprocess and model:
    (canvases, hws) on the card, the raw outputs (:func:`ssd_raw`), and the
    detector's decoded boxes [B, A, 4] and class scores [B, A, 90] in
    float32, what the served NMS selects its candidates from."""
    from tensorflow_web_deploy_tpu_torch.ops.detection import decode_boxes
    from tensorflow_web_deploy_tpu_torch.ops.image import pad_to_canvas

    canvases = torch.from_numpy(np.stack([pad_to_canvas(t, SSD_BUCKETS)[0]
                                          for t, *_ in items])).cuda()
    hws = torch.tensor([hw for _, hw, *_ in items], dtype=torch.int32).cuda()
    raw = ssd_raw(eng, canvases, hws)
    with torch.inference_mode():
        boxes = decode_boxes(raw[0].float(), raw[2].float())
        scores = torch.sigmoid(raw[1].float())[..., 1:]
    return canvases, hws, raw, boxes, scores


def nms_rows(boxes: torch.Tensor, scores: torch.Tensor, k: int) -> tuple:
    """The served selection's NMS input: every (image, class)'s top ``k``
    candidates as contiguous rows, boxes [rows, k, 4] and scores [rows, k]."""
    from tensorflow_web_deploy_tpu_torch.ops.detection import select_candidates

    with torch.inference_mode():
        cand, cand_s = select_candidates(boxes, scores, k)
        return cand.reshape(-1, k, 4).contiguous(), cand_s.reshape(-1, k).contiguous()


def ssd_rel(got: tuple, ref: tuple) -> dict:
    """max |Δ| over max |reference| of the raw box codes and the raw
    scores, each against its reference."""
    return {"raw_boxes": logit_rel(got[0], ref[0]), "raw_scores": logit_rel(got[1], ref[1])}


def phase_ssd(jpegs: list[bytes]) -> dict:
    """SSD-MobileNet (BASELINE config 4, the multi-output graph) served
    alone, the zoo's detector: full width, 300 px, seeded weights, bf16.

    - Serve: ``native:ssd_mobilenet`` behind ``POST /predict`` on the
      ragged rgb wire, the matmul resize, canvas 512, batch buckets 1–32 (6
      graphs captured at boot). The 24 JPEGs one at a time, then at once
      with the kernels' counts set to 0 just before the burst and read just
      after: every batch a replay, ``preprocess_ragged`` and ``nms_fixed``
      once a batch, no other kernel. Every answer 200
      with the reference's keys; the burst's detections agree with the
      serial ones for the same image (:func:`ssd_answers_agree`).
    - Throughput: full batch-32 slabs back to back on the captured graph
      (img/s, compute ms, one replay's device time, MFU), the unpack and
      ragged preprocess kernels against their plain versions on those slabs.
    - NMS: the kernel's keep mask against ``nms_fixed_plain`` bit for bit
      on a served batch's candidates (32 images × 90 classes × 100) and on
      adversarial rows (:func:`nms_adversarial_rows`); ``multiclass_nms``
      through the kernel and through the plain NMS on the same raw outputs,
      all four arrays equal; the kernel's µs in a graph against its bound
      and the plain version's.
    - The anchor scene (head kernels zero, ``loc`` biases zero, distinct
      bf16 ``cls`` biases, background lower): a bf16 engine's arrays for
      every image equal :func:`scene_expectation` bit for bit, through its
      graph replays.
    - The forward: a float32 engine's raw outputs within ``F32_LOGIT_RTOL``
      of the CPU's float32 forward, the bf16 engine's within
      ``SSD_BF16_RTOL`` of the float32 engine's.
    - The other kernels at this path's shapes: ``fused_dw`` at SSD's six
      depthwise shapes × B ∈ {1, 32} × {float32, bf16} bit for bit, and a
      bf16 engine with ``fused_dw="on"`` (6 launches a forward) held to
      the float32 engine as the unfused one is and to the unfused one
      within twice that; ``preprocess_i420`` at 300 out from the yuv420
      wire: an engine with ``resize="kernel"`` serves a batch (one launch)
      and the kernel equals its plain version on that batch's wire.
    - int8: ``native:ssd_mobilenet,dtype=int8`` at 300 px ends in FAILED at
      load (the reference's gate refuses it too, ``SSD_REF_GATE``), the
      same at 64 px serves and launches ``fused_dw``. Both verdicts are
      required.
    """
    import ast
    import re

    from tensorflow_web_deploy_tpu_torch.models import get as zoo_get
    from tensorflow_web_deploy_tpu_torch.models.adapter import init_variables, native_converted
    from tensorflow_web_deploy_tpu_torch.models.ssd_mobilenet import ASPECT_RATIOS, SSDMobileNet
    from tensorflow_web_deploy_tpu_torch.ops.detection import (
        multiclass_nms,
        nms_fixed,
        nms_fixed_plain,
    )
    from tensorflow_web_deploy_tpu_torch.ops.preprocess_i420 import (
        decode_trailer,
        preprocess_i420_plain,
        preprocess_i420_wire,
        wire_canvases,
    )
    from tensorflow_web_deploy_tpu_torch.server import start_server
    from tensorflow_web_deploy_tpu_torch.serving import costmodel
    from tensorflow_web_deploy_tpu_torch.serving.engine import InferenceEngine, quiesced

    t_phase = time.perf_counter()
    wrappers = kernel_wrappers()

    def counts() -> dict:
        return {name: w.launches for name, w in wrappers.items()}

    def zero() -> None:
        for w in wrappers.values():
            w.launches = 0

    common = dict(wire="rgb", resize="matmul", ragged=True, canvas_buckets=SSD_BUCKETS,
                  max_batch=SSD_MAX_BATCH)
    cfg = _config("ssd_mobilenet", "bfloat16", http_workers=len(jpegs), host="127.0.0.1",
                  port=0, **common)
    row = {"phase": "ssd", "nvidia_smi": nvidia_smi(), "model": "native:ssd_mobilenet",
           "width": 1.0, "input": SSD_SIZE, "dtype": "bfloat16", "wire": "rgb", "ragged": True,
           "resize": "matmul", "canvas_buckets": list(SSD_BUCKETS), "max_batch": SSD_MAX_BATCH}
    bad: dict = {}
    n_anchor = len(ASPECT_RATIOS)
    t0 = time.perf_counter()
    srv = start_server(cfg, device="cuda", seed=SEED)
    row["boot_s"] = time.perf_counter() - t0
    admin = KeepAlive(srv.port)
    engines: list = []
    try:
        eng = srv.engine
        classes, d = eng.num_classes, eng.max_detections
        shard = eng._replicas[0].shards[0]
        st = eng.stats()
        row.update(batch_buckets=list(eng.batch_buckets), warmup_s=st["warmup_s"],
                   graphs=st["graphs"], kernels_built=eng.kernels, task=st["task"],
                   outputs=st["outputs"], row_width=eng.row_width,
                   anchors=int(eng.model.anchors.shape[0]))
        if (eng.batch_buckets != (1, 2, 4, 8, 16, 32) or st["graphs"]["captured"] != 6
                or eng.kernels != ["preprocess_ragged", "nms_fixed"] or st["task"] != "detect"
                or (classes, d, eng.row_width, row["anchors"]) != (90, 100, 601, 375)):
            bad["engine"] = {k: row[k] for k in ("batch_buckets", "graphs", "kernels_built",
                                                  "task", "row_width", "anchors")}

        # one at a time, then the main path: all 24 at once
        serial = [post(srv.url + "/predict", data) for data in jpegs]
        before = eng.stats()
        zero()
        results, timeline = burst(srv, jpegs)
        launches = counts()
        after = eng.stats()
        batches = after["batches"] - before["batches"]
        graphs = {k: after["graphs"][k] - before["graphs"][k]
                  for k in ("replays", "eager_batches")}
        row["kernel_launches"] = launches
        row["serve"] = {"requests": len(jpegs), "batches": batches, "graphs": graphs,
                        "statuses": dict(Counter(r[0] for r in results)),
                        "img_per_s": len(jpegs) / timeline["wall_ms"] * 1e3,
                        "p50_ms": timeline["client_latency_ms"]["p50"],
                        "p99_ms": timeline["client_latency_ms"]["p99"],
                        "serial_p50_ms": float(np.percentile([r[2] for r in serial], 50)) * 1e3}
        want = launches_want(preprocess_ragged=batches, nms_fixed=batches)
        if launches != want or batches == 0 or \
                graphs != {"replays": batches, "eager_batches": 0} or \
                row["serve"]["statuses"] != {200: len(jpegs)}:
            bad["serve"] = {**row["serve"], "launches": launches, "want": want}
        bodies = [r[1] for r in results]
        serial_bodies = [r[1] for r in serial]
        agree = [ssd_answers_agree(a, b)["ok"] for a, b in zip(bodies, serial_bodies)]
        row["serial_vs_burst"] = {
            "images": len(jpegs), "agree": sum(agree),
            "identical": sum(a["detections"] == b["detections"]
                             for a, b in zip(bodies, serial_bodies)),
            "num_detections": [b["num_detections"] for b in bodies],
            "score_range": [min((x["score"] for b in bodies for x in b["detections"]),
                                default=None),
                            max((x["score"] for b in bodies for x in b["detections"]),
                                default=None)]}
        if not all(agree) or not all(ssd_answer_ok(b, classes) for b in bodies + serial_bodies):
            bad["answers"] = [(a, b) for a, b, ok in zip(bodies, serial_bodies, agree)
                              if not ok][:1] or bodies[:1]

        # throughput mode: full batch-32 slabs on the captured graph
        prepared = [eng.prepare_ragged(data) for data in jpegs]
        items = [prepared[i % len(prepared)] for i in range(SSD_MAX_BATCH)]
        tp = throughput(eng, items, SSD_THROUGHPUT_S, THROUGHPUT_DEPTH)
        exe = shard.exes[("ragged", 512, SSD_MAX_BATCH)]
        with eng._replicas[0].lock, torch.cuda.stream(shard.compute):
            tp["replay_ms"] = cuda_time_ms(exe)
        # where a replay's device time goes, by kernel (the profiler starts
        # and stops with every engine's enqueue held off)
        with quiesced(), eng._replicas[0].lock, torch.cuda.stream(shard.compute):
            prof = profiled_calls(exe, calls=3)
        tp["profile"] = {"kernels_per_replay": prof["kernels"] / prof["calls"],
                         "device_us_per_replay": prof["device_us"] / prof["calls"],
                         "top": prof["top"]}
        del exe  # its graph and output would keep the graph pool alive past close()
        cost = costmodel.model_cost(eng.model_cfg)
        peak = costmodel.backend_peak("bfloat16")
        rows = tp["batches"] * SSD_MAX_BATCH
        tight = sum(t.nbytes for t, *_ in items) / (512 * 512 * 3) * tp["batches"]
        econ = costmodel.bucket_economics(cost, 512, SSD_MAX_BATCH, rows, rows,
                                          tp["compute_ms_sum"] / 1e3, peak, 1,
                                          eng.model_cfg.input_size, "ragged", rows_tight=tight)
        flops = SSD_MAX_BATCH * cost["flops_per_image"]
        nbytes = SSD_MAX_BATCH * costmodel.bytes_per_image(cost, 512, SSD_MAX_BATCH, "ragged")
        tp.update(flops_per_replay=flops, bytes_per_replay=nbytes,
                  flops_bound_ms=flops / peak["flops_per_chip"] * 1e3,
                  bytes_bound_ms=nbytes / peak["bytes_per_s_per_chip"] * 1e3,
                  mfu=econ.get("mfu"), roofline_bound_fraction=econ.get("roofline_bound_fraction"),
                  bound=econ.get("bound"))
        tp["bound_ms"] = max(tp["flops_bound_ms"], tp["bytes_bound_ms"])
        row["throughput"] = tp
        if tp["replays"] != tp["batches"] or tp["eager_batches"] or \
                not 0 < (tp["mfu"] or 0) <= 1:
            bad["throughput"] = tp
        row["unpack_32"] = [slab_unpack_check(eng, items, 32), slab_unpack_check(eng, items, 24)]
        if not all(c["kernel_is_plain"] and c["kernel_is_host"] and c["preprocess_is_plain"]
                   for c in row["unpack_32"]):
            bad["unpack_32"] = row["unpack_32"]

        # the NMS kernel on a served batch's candidates and on adversarial rows
        canvases, hws, raw16, boxes, scores = ssd_candidates(eng, items)
        cb, cs = nms_rows(boxes, scores, NMS_K)
        with torch.inference_mode():
            keep = nms_fixed(cb, cs, NMS_IOU, NMS_SCORE)
            keep_plain = nms_fixed_plain(cb, cs, NMS_IOU, NMS_SCORE)
            adv = [(nms_fixed(b, s, 0.5, 0.05), nms_fixed_plain(b, s, 0.5, 0.05), s > 0.05)
                   for b, s in nms_adversarial_rows(SEED)]
            mc_kernel = multiclass_nms(boxes, scores)
            mc_plain = multiclass_nms(boxes, scores, nms=nms_fixed_plain)
        torch.cuda.synchronize()
        n_rows = cb.shape[0]
        nms = {"rows": n_rows, "k": NMS_K, "kept": int(keep.sum()),
               "candidates": int((cs > NMS_SCORE).sum()),
               "suppressed": int((cs > NMS_SCORE).sum() - keep.sum()),
               "served_equal": bool(torch.equal(keep, keep_plain)),
               "adversarial_rows": sum(int(k.shape[0]) for k, *_ in adv),
               "adversarial_ks": [int(k.shape[1]) for k, *_ in adv],
               "adversarial_suppressed": sum(int(c.sum() - k.sum()) for k, _, c in adv),
               "adversarial_equal": all(torch.equal(k, p) for k, p, _ in adv),
               "multiclass_equal": all(torch.equal(a, b) for a, b in zip(mc_kernel, mc_plain)),
               "num_detections": [int(v) for v in mc_kernel[3][:4]]}
        nms["ms"] = graph_time_ms(lambda: nms_fixed(cb, cs, NMS_IOU, NMS_SCORE))
        nms["plain_ms"] = cuda_time_ms(lambda: nms_fixed_plain(cb, cs, NMS_IOU, NMS_SCORE),
                                       repeats=5, warmup=1)
        nms["host_us"] = host_us(lambda: nms_fixed(cb, cs, NMS_IOU, NMS_SCORE))
        # least time: each candidate's box and score read once, its keep
        # byte written once; or every pair's test at the float32 rate
        t_bytes = n_rows * NMS_K * (16 + 4 + 1) / MEM_BYTES_PER_S * 1e3
        t_ops = n_rows * NMS_K * (NMS_K - 1) // 2 * NMS_PAIR_OPS / F32_FLOPS_PER_S * 1e3
        nms["bound_ms"], nms["bound_by"] = (t_bytes, "bytes") if t_bytes >= t_ops else \
            (t_ops, "operations")
        nms["share_of_bound"] = nms["bound_ms"] / nms["ms"]
        nms["us"], nms["before_us"] = nms["ms"] * 1e3, NMS_BEFORE_US
        # the served candidates again at other shapes
        nms["by_k"] = []
        for images, kk in NMS_CASES:
            cbk, csk = nms_rows(boxes[:images], scores[:images], kk)
            with torch.inference_mode():
                keep_k = nms_fixed(cbk, csk, NMS_IOU, NMS_SCORE)
                plain_k = nms_fixed_plain(cbk, csk, NMS_IOU, NMS_SCORE)
            nms["by_k"].append({
                "images": images, "k": kk, "rows": cbk.shape[0], "kept": int(keep_k.sum()),
                "candidates": int((csk > NMS_SCORE).sum()),
                "equal": bool(torch.equal(keep_k, plain_k)),
                "us": graph_time_ms(lambda: nms_fixed(cbk, csk, NMS_IOU, NMS_SCORE)) * 1e3})
        row["nms"] = nms
        if not (nms["served_equal"] and nms["adversarial_equal"] and nms["multiclass_equal"]
                and nms["candidates"] > 0 and all(r["equal"] for r in nms["by_k"])):
            bad["nms"] = nms

        # the forward at a stated tolerance: float32 against the CPU, bf16
        # against float32, and the fused depthwise cells against both
        f32 = InferenceEngine(_config("ssd_mobilenet", "float32", warmup=False, **common),
                              device="cuda", seed=SEED)
        engines.append(f32)
        raw32 = ssd_raw(f32, canvases, hws)
        with torch.inference_mode():
            cpu = native_converted("ssd_mobilenet", seed=SEED)
            raw_cpu = cpu(f32._preprocess(canvases, hws).cpu())
        cfg_fused = _config("ssd_mobilenet", "bfloat16", warmup=False, **common)
        cfg_fused = replace(cfg_fused, model=replace(cfg_fused.model, fused_dw="on"))
        fused = InferenceEngine(cfg_fused, device="cuda", seed=SEED)
        engines.append(fused)
        zero()
        raw_fused = ssd_raw(fused, canvases, hws)
        torch.cuda.synchronize()
        fused_launches = counts()["fused_dw"]
        row["forward"] = {
            "images": SSD_MAX_BATCH, "f32_vs_cpu": ssd_rel([t.cpu() for t in raw32], raw_cpu),
            "f32_rtol": F32_LOGIT_RTOL, "bf16_vs_f32": ssd_rel(raw16, raw32),
            "bf16_rtol": SSD_BF16_RTOL, "fused_vs_f32": ssd_rel(raw_fused, raw32),
            "fused_vs_bf16": ssd_rel(raw_fused, raw16), "fused_launches": fused_launches,
            "max_abs_raw_f32": [float(raw32[0].abs().max()), float(raw32[1].abs().max())],
            "anchors_equal": bool(torch.equal(raw32[2].cpu(), raw_cpu[2])),
            "tf32": [torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32]}
        fw = row["forward"]
        if not (all(torch.isfinite(t.float()).all() for t in (*raw16[:2], *raw32[:2]))
                and max(fw["f32_vs_cpu"].values()) <= F32_LOGIT_RTOL
                and max(fw["bf16_vs_f32"].values()) <= SSD_BF16_RTOL
                and max(fw["fused_vs_f32"].values()) <= SSD_BF16_RTOL
                and max(fw["fused_vs_bf16"].values()) <= 2 * SSD_BF16_RTOL
                and fused_launches == len(SSD_DW) and fw["anchors_equal"]):
            bad["forward"] = fw
        for e in engines:
            e.close()
        engines.clear()

        # fused_dw at SSD's own depthwise shapes, bit for bit
        shapes = dw_layer_shapes("ssd_mobilenet", SSD_SIZE)
        row["fused_dw_check"] = {"shapes": [(s["c"], s["h"], s["stride"], s["pads"])
                                            for s in shapes],
                                 **dw_check(torch.Generator(device="cuda").manual_seed(SEED),
                                            shapes, SSD_DW_BATCHES)}
        if [(s["c"], s["h"], s["stride"]) for s in shapes] != SSD_DW:
            bad["fused_dw_shapes"] = row["fused_dw_check"]["shapes"]

        # the preprocess kernel at 300 out from the yuv420 wire: an engine
        # serves a batch, and the kernel equals its plain version there
        yuv = InferenceEngine(_config("ssd_mobilenet", "bfloat16", wire="yuv420", resize="kernel",
                                      canvas_buckets=SSD_BUCKETS, max_batch=SSD_MAX_BATCH,
                                      warmup=False), device="cuda", seed=SEED)
        engines.append(yuv)
        staged = [yuv.prepare_bytes(data) for data in jpegs]
        yc = np.stack([c for c, *_ in staged])
        yhw = np.array([hw for _, hw, _ in staged], np.int32)
        zero()
        yout = yuv.run_batch(yc, yhw)
        ylaunch = counts()
        buf = wire_buffer(yc, yhw)
        with torch.inference_mode():
            x32 = preprocess_i420_wire(buf, 512, SSD_SIZE, SSD_SIZE, "inception", torch.float32)
            x16 = preprocess_i420_wire(buf, 512, SSD_SIZE, SSD_SIZE, "inception", torch.bfloat16)
            ref = preprocess_i420_plain(wire_canvases(buf, 512), decode_trailer(buf), SSD_SIZE,
                                        SSD_SIZE)
        row["preprocess_300"] = {
            "batch": len(jpegs), "launches": ylaunch, "max_abs_err": float((x32 - ref).abs().max()),
            **bf16_vs_plain(x16, ref, "inception"),
            "num_detections": [int(v) for v in yout[3][:4]]}
        if (ylaunch != launches_want(preprocess_i420=1, nms_fixed=1)
                or row["preprocess_300"]["max_abs_err"] > KERNEL_TOL["inception"]
                or not all(np.isfinite(o).all() for o in yout)):
            bad["preprocess_300"] = row["preprocess_300"]
        yuv.close()
        engines.clear()

        # the anchor scene, exact end to end through the graph replays
        _, flat = init_variables(zoo_get("ssd_mobilenet"), seed=SEED)
        biases = scene_biases(classes, n_anchor)
        scene = InferenceEngine(_config("ssd_mobilenet", "bfloat16", **common), device="cuda",
                                params_flat=scene_params(flat, biases))
        engines.append(scene)
        scene.warmup()
        g0 = scene.stats()["graphs"]["replays"]
        got = scene.run_ragged([t for t, *_ in prepared], np.array([hw for _, hw, *_ in prepared]),
                               512)
        replays = scene.stats()["graphs"]["replays"] - g0
        f1 = -(-SSD_SIZE // 32)
        expect = scene_expectation(
            SSDMobileNet.anchors_for(SSD_SIZE), biases, (f1 * f1, (-(-f1 // 2)) ** 2), n_anchor,
            lambda v: torch.sigmoid(torch.from_numpy(v).cuda()).cpu().numpy())
        exact = [all(np.array_equal(g[i], e) for g, e in zip(got, expect))
                 for i in range(len(prepared))]
        row["anchor_scene"] = {"images": len(prepared), "exact": sum(exact), "replays": replays,
                               "num_detections": int(expect[3]),
                               "classes_first": [int(c) for c in expect[2][:5]],
                               "scores_first": [float(s) for s in expect[1][:5]]}
        if not all(exact) or replays != 1:
            bad["anchor_scene"] = row["anchor_scene"]
        scene.close()
        engines.clear()

        # the int8 tier: refused at 300 px, served at 64 px
        t0 = time.perf_counter()
        status, doc = admin.request("POST", "/models/load",
                                    {"model": SSD_INT8, "wait": True, "timeout_s": 300})
        err = doc.get("error") or ""
        found = re.search(r"\{.*\}", err)
        gate = ast.literal_eval(found.group(0)) if found else None
        row["int8_300"] = {"spec": SSD_INT8, "status": status, "state": doc.get("state"),
                           "gate": gate, "reference_gate_cpu": SSD_REF_GATE,
                           "load_s": time.perf_counter() - t0}
        if (status, doc.get("state")) != (500, "FAILED") or GATE_FAILED not in err or \
                gate is None or gate.get("pass") is not False:
            bad["int8_300"] = row["int8_300"]
        answers: list = []
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "ssd64.json")
            with open(path, "w") as f:
                json.dump({"name": "ssd_mobilenet", "source": "native", "task": "detect",
                           "input_size": [SSD_INT8_SMALL, SSD_INT8_SMALL]}, f)
            spec = f"{path},dtype=int8,as=ssd_mobilenet_int8_64"
            t0 = time.perf_counter()
            status, doc = admin.request("POST", "/models/load",
                                        {"model": spec, "wait": True, "timeout_s": 300})
        row["int8_64"] = {"status": status, "state": doc.get("state"),
                          "load_s": time.perf_counter() - t0}
        if (status, doc.get("state")) == (200, "SERVING"):
            _, models = admin.request("GET", "/models")
            row["int8_64"]["gate"] = next(
                v for v in models["models"]["ssd_mobilenet_int8_64"]["versions"]
                if v["state"] == "SERVING").get("parity")
            zero()
            answers = [admin.request("POST", "/predict?model=ssd_mobilenet_int8_64", data)
                       for data in jpegs[:4]]
            row["int8_64"].update(launches=counts(),
                                  statuses=[a for a, _ in answers],
                                  num_detections=[b.get("num_detections") for _, b in answers])
        lc = row["int8_64"].get("launches", {})
        if (status, doc.get("state")) != (200, "SERVING") or \
                row["int8_64"].get("statuses") != [200] * 4 or \
                lc.get("fused_dw") != len(SSD_DW) * lc.get("nms_fixed", -1) or \
                not lc.get("nms_fixed") or \
                not all(ssd_answer_ok(b, classes) for _, b in answers):
            bad["int8_64"] = row["int8_64"]
        again, body = admin.request("POST", "/predict?model=ssd_mobilenet", jpegs[0])
        row["bf16_after"] = again
        if again != 200 or not ssd_answer_ok(body, classes):
            bad["bf16_after"] = (again, body)
    finally:
        for e in engines:
            e.close()
        admin.close()
        srv.close()
    row["seconds"] = time.perf_counter() - t_phase
    emit(row)
    if bad:
        raise AssertionError(f"ssd: {bad}")
    return row


# --------------------------------------------------------------------------
# converter: frozen graphs written without TensorFlow, served beside native
# --------------------------------------------------------------------------

CONVERTER_BUCKETS = (512,)
CONVERTER_MAX_BATCH = 32
CONVERTER_THROUGHPUT_S = 2.0
# the yuv420 server: the preset (the .pb) in bf16 and float32 beside the
# zoo model on the same weights (seed 0) in both dtypes
CONVERTER_MODELS = ("inception_v3", "native:inception_v3,as=native_inception_v3",
                    "inception_v3,dtype=f32,as=inception_v3_f32",
                    "native:inception_v3,dtype=f32,as=native_inception_v3_f32")
# the ragged rgb server: the preset, and MobileNetV2's graph in bf16
# (depthwise on cuDNN) and in the int8 tier
CONVERTER_RAGGED_MODELS = ("inception_v3", "mobilenet_v2",
                           "mobilenet_v2,dtype=int8,as=mobilenet_v2_int8")
# the ResNet-50 server (caffe: the ragged rgb wire, which the preprocess
# kernel refuses): the preset in bf16 and float32 beside the zoo model on
# the same weights (seed 0) in both dtypes
CONVERTER_RESNET_MODELS = ("resnet50", "native:resnet50,as=native_resnet50",
                           "resnet50,dtype=f32,as=resnet50_f32",
                           "native:resnet50,dtype=f32,as=native_resnet50_f32")
# the SSD-MobileNet server (yuv420, the preprocess kernel): the same on the
# anchor scene's weights, which the preset's graph is written with
CONVERTER_SSD_MODELS = ("ssd_mobilenet", "native:ssd_mobilenet,as=native_ssd_mobilenet",
                        "ssd_mobilenet,dtype=f32,as=ssd_mobilenet_f32",
                        "native:ssd_mobilenet,dtype=f32,as=native_ssd_mobilenet_f32")
# the graph's logits (ResNet-50) and raw outputs (SSD) in bf16 may lie at
# most this many times as far from native float32's as native bf16's do:
# the Keras pattern rounds each conv's output to bf16 three times (the
# conv, the BN's Mul and AddV2; ResNet-50's zero BiasAdd is exact) where
# native rounds it once (1.24–1.34 × on the CPU: SSD, width 0.35, 96 px)
PB_BF16_DEVIATION_RATIO = 2.0
# Scores of the .pb path against native on the same weights and images.
# float32 computes the same function in another order (each BN after its
# conv, where native folds it into the conv's weight and bias; cuDNN with
# TF32 off): within 1e-4. bf16 rounds the two orders differently: within
# the served tolerance, 1e-2.
PB_F32_TOL = 1e-4
PB_BF16_TOL = SERVED_TOL


def answers_match(a: list[dict], b: list[dict], tol: float) -> dict:
    """Two answers' top-k for one image: the top-1 class must be equal; a
    lower rank must name the same class wherever ``a``'s scores on both
    sides of it differ from it by more than ``tol`` (the last rank has no
    lower neighbour in the answer and is compared on scores only); every
    class in both answers within ``tol``. Returns the verdict and the
    largest score difference over the classes in both."""
    ia, ib = [p["index"] for p in a], [p["index"] for p in b]
    sa = [p["score"] for p in a]
    defined = [j for j in range(1, len(sa) - 1)
               if sa[j - 1] - sa[j] > tol and sa[j] - sa[j + 1] > tol]
    score_b = {p["index"]: p["score"] for p in b}
    diffs = [abs(p["score"] - score_b[p["index"]]) for p in a if p["index"] in score_b]
    diff = max(diffs) if diffs else math.inf
    ok = ia[0] == ib[0] and all(ia[j] == ib[j] for j in defined) and diff <= tol
    return {"ok": ok, "max_score_diff": diff, "defined_ranks": len(defined) + 1}


def converter_server(cfg, det_params: dict):
    """``start_server``'s stack (registry, App, HTTP pool) with each native
    detector built on ``det_params`` (``start_server`` builds every engine
    on seed ``SEED``): the handles ``burst`` reads, and ``close``."""
    from types import SimpleNamespace

    from tensorflow_web_deploy_tpu_torch.serving.engine import InferenceEngine
    from tensorflow_web_deploy_tpu_torch.serving.http import App, make_http_server, \
        shutdown_gracefully
    from tensorflow_web_deploy_tpu_torch.serving.registry import ModelRegistry

    def build(mc):
        return InferenceEngine(replace(cfg, model=mc), device="cuda", seed=SEED,
                               params_flat=det_params if mc.source == "native" else None)

    reg = ModelRegistry(cfg, default_model=cfg.default_name, engine_factory=build)
    try:
        for mc in cfg.serve_models:
            eng = build(mc)
            reg.adopt(mc.serve_name, eng, reg.build_batcher(eng), mc)
        app = App(reg, cfg)
        httpd = make_http_server(app, cfg.host, 0, pool_size=cfg.http_workers)
    except BaseException:
        reg.stop()
        reg.close_engines()
        raise
    thread = threading.Thread(target=httpd.serve_forever, name="http", daemon=True)
    thread.start()

    def close():
        shutdown_gracefully(httpd, reg, 10.0)
        thread.join(10.0)
        reg.close_engines()

    port = httpd.server_address[1]
    return SimpleNamespace(registry=reg, app=app, httpd=httpd, engine=app.engine,
                           batcher=app.batcher, port=port, url=f"http://127.0.0.1:{port}",
                           close=close)


def phase_converter(jpegs: list[bytes]) -> dict:
    """Frozen graphs served through the converter (ROADMAP Queue 1 items 13
    and 17).

    - Artifacts: ``tools/make_artifacts.py`` writes full-width
      ``inception_v3.pb`` (299 px, 1000 classes), ``mobilenet_v2.pb`` and
      ``resnet50.pb`` (224 px) into the checkout's ``artifacts/`` without
      TensorFlow, with the zoo's seeded weights (seed 0), and
      ``ssd_mobilenet.pb`` (300 px, 90 classes) with the anchor scene's
      (``scene_params``: every image has detections): the presets then
      name them. A file already there must be those bytes.
    - yuv420 server (preprocess kernel, canvas 512, batch buckets 1–32):
      the preset ``inception_v3`` in bf16 (the default model) and float32
      beside ``native:inception_v3`` in both, on the same weights. A burst
      of the 24 JPEGs on the .pb path with the kernels' counts set to 0
      just before it and read just after: every batch a replay, the
      preprocess kernel once a batch. Then every JPEG to each model: the
      .pb path's answers against native's (:func:`answers_match`, bf16 at
      ``PB_BF16_TOL``, float32 at ``PB_F32_TOL``).
    - Per path (.pb and native, bf16): parse and convert seconds, kernels
      per replay of the batch-8 graph (``torch.profiler``, a lower bound),
      device ms per batch-8 and batch-32 replay, full batch-32 slabs back
      to back (img/s, compute ms, idle share) and MFU from the cost model.
    - Ragged rgb server: the preset on the ragged wire (the ragged
      preprocess kernel once a batch, no other launch), and ``mobilenet_v2.pb`` in bf16
      (its 17 depthwise convs on cuDNN, no fused launch) and with
      ``,dtype=int8``: the gate's verdict and the leaves it quantized
      (none: the Keras-named constants match no kernel leaf name, as in the
      reference).
    - ResNet-50 (BASELINE config 3): the preset ``resnet50`` in bf16 and
      float32 beside ``native:resnet50`` on the ragged rgb wire (caffe: the
      preprocess kernel refuses it), the same burst (one ragged preprocess
      launch a batch, no other launch), answers and path numbers; its logits
      against native float32's on 8 preprocessed images (another
      conversion with the logits as output): float32 within
      ``F32_LOGIT_RTOL``, bf16 at most ``PB_BF16_DEVIATION_RATIO`` × as far
      as native bf16's (the seeded softmax is one-hot: a top-1 check).
    - SSD-MobileNet (BASELINE config 4): the preset ``ssd_mobilenet`` in
      bf16 and float32 beside ``native:ssd_mobilenet`` on the anchor
      scene's weights on the yuv420 wire: the burst (one preprocess and one
      ``nms_fixed`` launch a batch), every answer a 200 with detections,
      the .pb path's detections against native's (:func:`ssd_answers_agree`,
      float32 at ``PB_F32_TOL``, bf16 at ``SSD_BF16_RTOL``) and the path
      numbers; then the raw outputs of the seeded graph (lively heads)
      against native float32's, as ResNet-50's logits.
    - The CLI: ``python -m tensorflow_web_deploy_tpu_torch.server --model
      ssd_mobilenet``: ``GET /models`` shows it SERVING, one ``POST
      /predict`` answers 200 with detections.
    """
    from tensorflow_web_deploy_tpu_torch.graphdef import convert_graphdef, load_pb, parse_graphdef
    from tensorflow_web_deploy_tpu_torch.models import get as zoo_get
    from tensorflow_web_deploy_tpu_torch.models.adapter import init_variables, native_converted
    from tensorflow_web_deploy_tpu_torch.models.ssd_mobilenet import ASPECT_RATIOS
    from tensorflow_web_deploy_tpu_torch.server import start_server
    from tensorflow_web_deploy_tpu_torch.serving import costmodel
    from tensorflow_web_deploy_tpu_torch.tools import make_artifacts
    from tensorflow_web_deploy_tpu_torch.utils.config import ServerConfig, _ARTIFACTS, \
        model_config

    t_phase = time.perf_counter()
    row = {"phase": "converter", "nvidia_smi": nvidia_smi(),
           "models": [*CONVERTER_MODELS, *CONVERTER_RAGGED_MODELS, *CONVERTER_RESNET_MODELS,
                      *CONVERTER_SSD_MODELS],
           "canvas_buckets": list(CONVERTER_BUCKETS), "max_batch": CONVERTER_MAX_BATCH}
    bad: dict = {}
    wrappers = kernel_wrappers()

    def counts() -> dict:
        return {name: w.launches for name, w in wrappers.items()}

    def zero() -> None:
        for w in wrappers.values():
            w.launches = 0

    # the artifacts, written without TensorFlow
    t0 = time.perf_counter()
    seeded = ["inception_v3", "mobilenet_v2", "resnet50"]
    make_artifacts.ensure_artifacts(seeded, _ARTIFACTS)
    _, ssd_flat = init_variables(zoo_get("ssd_mobilenet"), seed=SEED)
    scene = scene_params(ssd_flat, scene_biases(90, len(ASPECT_RATIOS)))
    row["artifacts"] = {}
    for name in [*seeded, "ssd_mobilenet"]:
        data, flat = make_artifacts.make_graph(
            name, seed=SEED, params=scene if name == "ssd_mobilenet" else None)
        path = _ARTIFACTS / f"{name}.pb"
        if not path.exists():
            tmp = path.with_suffix(".pb.tmp")
            tmp.write_bytes(data)
            tmp.replace(path)
        if path.read_bytes() != data:
            raise AssertionError(f"{path} is not the seeded graph the tool writes; move it away")
        row["artifacts"][name] = {"bytes": len(data)}
        if name == "resnet50":
            resnet_flat = flat
    row["artifacts"]["write_s"] = time.perf_counter() - t0

    def server(specs, det_params=None, **kw):
        mcs = [model_config(s) for s in specs]
        cfg = ServerConfig(model=mcs[0], models=tuple(mcs), default_model=mcs[0].serve_name,
                           canvas_buckets=CONVERTER_BUCKETS, host="127.0.0.1", port=0,
                           http_workers=len(jpegs), **{**PINNED, **kw})
        t = time.perf_counter()
        srv = (start_server(cfg, device="cuda", seed=SEED) if det_params is None
               else converter_server(cfg, det_params))
        engines = {mv.name: mv.engine for mv in srv.registry.serving_entries()}
        urllib.request.urlopen(srv.url + "/healthz", timeout=120).read()
        return srv, engines, time.perf_counter() - t

    def serve_burst(srv, path: str, want: dict) -> list:
        """The default model's burst with the counts read around it; the
        answers' bodies."""
        eng = srv.engine
        before = eng.stats()
        zero()
        results, timeline = burst(srv, jpegs)
        launches = counts()
        after = eng.stats()
        batches = after["batches"] - before["batches"]
        graphs = {k: after["graphs"][k] - before["graphs"][k]
                  for k in ("replays", "eager_batches")}
        want = {k: want.get(k, 0) * batches for k in wrappers}
        got = {"requests": len(jpegs), "batches": batches, "graphs": graphs,
               "kernel_launches": launches, "statuses": dict(Counter(r[0] for r in results)),
               "img_per_s": len(jpegs) / timeline["wall_ms"] * 1e3,
               "p50_ms": timeline["client_latency_ms"]["p50"],
               "p99_ms": timeline["client_latency_ms"]["p99"]}
        row[path] = got
        if batches == 0 or launches != want or got["statuses"] != {200: len(jpegs)} or \
                graphs != {"replays": batches, "eager_batches": 0}:
            bad[path] = {**got, "want": want}
        return [r[1] for r in results]

    def answers(srv, name: str) -> list:
        client = KeepAlive(srv.port)
        try:
            out = []
            for d in jpegs:
                status, body = client.request("POST", f"/predict?model={name}", d)
                if status != 200:
                    raise AssertionError(f"{name}: {status} {body}")
                out.append(body)
            return out
        finally:
            client.close()

    def compare(a: list, b: list, tol: float) -> dict:
        a, b = [x["predictions"] for x in a], [x["predictions"] for x in b]
        m = [answers_match(x, y, tol) for x, y in zip(a, b)]
        return {"images": len(m), "agree": sum(r["ok"] for r in m), "tol": tol,
                "top1_equal": sum(x[0]["index"] == y[0]["index"] for x, y in zip(a, b)),
                "max_score_diff": max(r["max_score_diff"] for r in m),
                "defined_ranks": [r["defined_ranks"] for r in m]}

    def compare_detections(a: list, b: list, tol: float) -> dict:
        m = [ssd_answers_agree(x, y, tol, tol) for x, y in zip(a, b)]
        return {"images": len(m), "agree": sum(r["ok"] for r in m), "tol": tol,
                "num_detections": sorted({x["num_detections"] for x in a}),
                "max_score_diff": max(r["max_score_diff"] for r in m),
                "max_box_diff_over_side": max(r["max_box_diff_over_side"] for r in m)}

    def path_numbers(eng) -> dict:
        """Load seconds, kernels per replay, device ms per replay and
        batch-32 throughput of one engine."""
        shard = eng._replicas[0].shards[0]  # the card: one replica of one device
        st = eng.stats()
        out = {"source": eng.source, "dtype": eng.model_cfg.dtype, "load_s": st["load_s"],
               "warmup_s": st["warmup_s"], "graphs": st["graphs"]["captured"],
               "pool_bytes": st["graphs"]["pool_bytes"]}
        if eng.source == "pb":
            g = eng.model.graph
            out.update(call_nodes=len(g.call_nodes), folded_nodes=len(g.folded_nodes),
                       call_ops=dict(Counter(op for _, op in g.call_nodes)),
                       buffers=len(g.buffer_origin))
        for p in (8, CONVERTER_MAX_BATCH):
            key = next(k for k in shard.exes if k[1] == 512 and k[2] == p)
            exe = shard.exes[key]
            with eng._replicas[0].lock, torch.cuda.stream(shard.compute):
                out[f"replay_ms_{p}"] = cuda_time_ms(exe)
                if p == 8:
                    prof = profiled_calls(exe, calls=2)
                    out["kernels_per_replay_8"] = prof["kernels"] / prof["calls"]
                    out["profile_top_8"] = prof["top"][:6]
            del exe  # its graph and output would keep the graph pool alive past close()
        prepared = [(eng.prepare_ragged if eng.ragged else eng.prepare_bytes)(d) for d in jpegs]
        items = [prepared[i % len(prepared)] for i in range(CONVERTER_MAX_BATCH)]
        tp = throughput(eng, items, CONVERTER_THROUGHPUT_S, THROUGHPUT_DEPTH)
        cost = costmodel.model_cost(eng.model_cfg)
        peak = costmodel.backend_peak(eng.model_cfg.dtype)
        rows = tp["batches"] * CONVERTER_MAX_BATCH
        tight = (sum(t.nbytes for t, *_ in items) / (512 * 512 * 3) * tp["batches"]
                 if eng.ragged else 0.0)
        econ = costmodel.bucket_economics(cost, 512, CONVERTER_MAX_BATCH, rows, rows,
                                          tp["compute_ms_sum"] / 1e3, peak, 1,
                                          eng.model_cfg.input_size,
                                          "ragged" if eng.ragged else "yuv420", rows_tight=tight)
        tp.update(mfu=econ.get("mfu"), flops_per_image=cost["flops_per_image"],
                  model_mfu_replay=CONVERTER_MAX_BATCH * cost["flops_per_image"]
                  / (out[f"replay_ms_{CONVERTER_MAX_BATCH}"] / 1e3) / peak["flops_per_chip"])
        out["throughput"] = tp
        if tp["replays"] != tp["batches"] or tp["eager_batches"] or \
                not 0 < (tp["mfu"] or 0) <= 1:
            bad[f"throughput_{eng.model_cfg.serve_name}"] = tp
        return out

    def outputs_vs_native(name: str, graph, outputs: list[str], flat, native_out) -> dict:
        """The graph's ``outputs`` (converted anew) against the zoo model's
        (``native_out`` picks them) on the same 8 images, in [-1, 1] as the
        preprocess gives them: max |Δ| over max |native float32| of each,
        float32 and bf16, beside native bf16's."""
        size = zoo_get(name).input_size
        x = (torch.rand(8, size, size, 3, generator=torch.Generator().manual_seed(SEED))
             * 2 - 1).cuda()
        runs = {}
        for dtype in (torch.float32, torch.bfloat16):
            pb = convert_graphdef(graph, outputs=outputs, dtype=dtype).cuda()
            native = native_converted(name, params_flat=flat, input_size=size).to("cuda", dtype)
            with torch.inference_mode():
                runs[("pb", dtype)] = [o.float() for o in pb(x.to(dtype))]
                runs[("native", dtype)] = [o.float() for o in native_out(native, x.to(dtype))]
            del pb, native
        ref = runs[("native", torch.float32)]
        rel = {f"{src}_{str(dt).split('.')[1]}": [logit_rel(a, b) for a, b in zip(out, ref)]
               for (src, dt), out in runs.items() if (src, dt) != ("native", torch.float32)}
        ok = all(r <= F32_LOGIT_RTOL for r in rel["pb_float32"]) and all(
            0 < p <= PB_BF16_DEVIATION_RATIO * n for p, n in zip(rel["pb_bfloat16"],
                                                                  rel["native_bfloat16"]))
        return {"outputs": outputs, "rel": rel, "f32_rtol": F32_LOGIT_RTOL,
                "bf16_ratio": PB_BF16_DEVIATION_RATIO, "ok": ok}

    # the yuv420 wire, preprocess kernel: .pb and native, bf16 and float32
    srv, engines, row["yuv420_boot_s"] = server(CONVERTER_MODELS, wire_format="yuv420",
                                                resize="kernel", max_batch=CONVERTER_MAX_BATCH)
    try:
        # every engine on the yuv420 wire takes the stem handshake: the .pb
        # through its S2DStem variant, native through input_format="s2d"
        row["s2d"] = {name: e.stats()["s2d"] for name, e in engines.items()}
        if not all(row["s2d"].values()):
            bad["s2d"] = row["s2d"]
        burst_pb = serve_burst(srv, "pb_yuv420_burst", {"preprocess_i420": 1})
        served = {name: answers(srv, name) for name in engines}
        row["bf16"] = compare(served["inception_v3"], served["native_inception_v3"],
                              PB_BF16_TOL)
        row["float32"] = compare(served["inception_v3_f32"],
                                 served["native_inception_v3_f32"], PB_F32_TOL)
        row["burst_vs_serial"] = compare(burst_pb, served["inception_v3"], PB_BF16_TOL)
        for key in ("bf16", "float32", "burst_vs_serial"):
            if row[key]["agree"] != len(jpegs):
                bad[key] = row[key]
        if not all(len(p) == 5 and all(math.isfinite(q["score"]) and 0 <= q["index"] < 1000
                                       for q in p) for ans in served.values()
                   for p in (b["predictions"] for b in ans)):
            bad["answers"] = {k: v[:1] for k, v in served.items()}
        row["paths"] = {name: path_numbers(engines[name])
                        for name in ("inception_v3", "native_inception_v3")}
        row["tf32"] = [torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32]
    finally:
        srv.close()

    # the ragged rgb wire: the unpack kernel; MobileNetV2's graph, bf16 and int8
    srv, engines, row["ragged_boot_s"] = server(CONVERTER_RAGGED_MODELS, wire_format="rgb",
                                                resize="matmul", ragged=True, max_batch=8)
    try:
        serve_burst(srv, "pb_ragged_burst", {"preprocess_ragged": 1})
        zero()
        mobilenet = {name: answers(srv, name) for name in ("mobilenet_v2", "mobilenet_v2_int8")}
        launches = counts()
        q = engines["mobilenet_v2_int8"]
        row["mobilenet_v2"] = {
            "kernel_launches": launches, "fused_dw": [engines[n].fused_dw for n in mobilenet],
            "call_ops": dict(Counter(op for _, op in engines["mobilenet_v2"].model.graph
                                     .call_nodes)),
            "int8_gate": q.parity, "int8_quantized_leaves": len(q.model.graph.int8_params),
            "int8_vs_bf16": compare(mobilenet["mobilenet_v2_int8"], mobilenet["mobilenet_v2"],
                                    PB_BF16_TOL)}
        if launches["fused_dw"] or launches["preprocess_ragged"] == 0 or \
                q.parity is None or not q.parity["pass"] or \
                row["mobilenet_v2"]["int8_quantized_leaves"] != 0:
            bad["mobilenet_v2"] = row["mobilenet_v2"]
    finally:
        srv.close()

    # ResNet-50: the ragged rgb wire (caffe), .pb beside native, bf16 and float32
    srv, engines, boot_s = server(CONVERTER_RESNET_MODELS, wire_format="rgb", resize="matmul",
                                  ragged=True, max_batch=CONVERTER_MAX_BATCH)
    res = row["resnet50"] = {"boot_s": boot_s}
    try:
        burst_pb = serve_burst(srv, "resnet50_burst", {"preprocess_ragged": 1})
        served = {name: answers(srv, name) for name in engines}
        res["bf16"] = compare(served["resnet50"], served["native_resnet50"], PB_BF16_TOL)
        res["float32"] = compare(served["resnet50_f32"], served["native_resnet50_f32"],
                                 PB_F32_TOL)
        res["burst_vs_serial"] = compare(burst_pb, served["resnet50"], PB_BF16_TOL)
        for key in ("bf16", "float32", "burst_vs_serial"):
            if res[key]["agree"] != len(jpegs):
                bad[f"resnet50_{key}"] = res[key]
        res["paths"] = {name: path_numbers(engines[name])
                        for name in ("resnet50", "native_resnet50")}
    finally:
        srv.close()
    res["logits"] = outputs_vs_native(
        "resnet50", load_pb(str(_ARTIFACTS / "resnet50.pb")), ["resnet50/predictions/BiasAdd"],
        resnet_flat, lambda m, x: [m.backbone(x.permute(0, 3, 1, 2))])
    if not res["logits"]["ok"]:
        bad["resnet50_logits"] = res["logits"]

    # SSD-MobileNet: the yuv420 wire, the preprocess kernel and the NMS
    # kernel; .pb beside native on the anchor scene, bf16 and float32
    srv, engines, boot_s = server(CONVERTER_SSD_MODELS, det_params=scene, wire_format="yuv420",
                                  resize="kernel", max_batch=CONVERTER_MAX_BATCH)
    ssd = row["ssd_mobilenet"] = {"boot_s": boot_s}
    try:
        ssd["s2d"] = {name: e.stats()["s2d"] for name, e in engines.items()}
        if not all(ssd["s2d"].values()):
            bad["ssd_s2d"] = ssd["s2d"]
        burst_pb = serve_burst(srv, "ssd_burst", {"preprocess_i420": 1, "nms_fixed": 1})
        served = {name: answers(srv, name) for name in engines}
        ssd["bf16"] = compare_detections(served["ssd_mobilenet"],
                                         served["native_ssd_mobilenet"], SSD_BF16_RTOL)
        ssd["float32"] = compare_detections(served["ssd_mobilenet_f32"],
                                            served["native_ssd_mobilenet_f32"], PB_F32_TOL)
        ssd["burst_vs_serial"] = compare_detections(burst_pb, served["ssd_mobilenet"],
                                                    PB_F32_TOL)
        for key in ("bf16", "float32", "burst_vs_serial"):
            if ssd[key]["agree"] != len(jpegs):
                bad[f"ssd_{key}"] = ssd[key]
        if not all(b["num_detections"] >= 1 and all(
                math.isfinite(v) for d in b["detections"] for v in (*d["box"], d["score"]))
                for ans in (burst_pb, *served.values()) for b in ans):
            bad["ssd_answers"] = {k: v[:1] for k, v in served.items()}
        ssd["paths"] = {name: path_numbers(engines[name])
                        for name in ("ssd_mobilenet", "native_ssd_mobilenet")}
        # the graph's constant output, a buffer: float32 [N, 4] in float32
        # serving, bf16 in bf16 serving (the reference's cast of every
        # float32 constant); the decode reads it in float32
        ssd["anchors"] = {}
        for name in ("ssd_mobilenet", "ssd_mobilenet_f32"):
            g = engines[name].model.graph
            kind, key = g._outputs[g.output_names.index("anchors")]
            ssd["anchors"][name] = {"kind": kind, "shape": list(getattr(g, key).shape),
                                    "dtype": str(getattr(g, key).dtype)}
    finally:
        srv.close()
    # the seeded graph (lively heads, where the scene's are zero)
    data, _ = make_artifacts.make_graph("ssd_mobilenet", seed=SEED)
    ssd["raw"] = outputs_vs_native(
        "ssd_mobilenet", parse_graphdef(data), ["raw_boxes", "raw_scores"], ssd_flat,
        lambda m, x: list(m(x)[:2]))
    if not ssd["raw"]["ok"]:
        bad["ssd_raw"] = ssd["raw"]

    # the CLI: the preset, as a user serves it
    with tempfile.TemporaryFile("w+") as log:
        proc, port, boot_s = job_server_proc(["--model", "ssd_mobilenet"], log)
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/models", timeout=60) as r:
                doc = json.loads(r.read())["models"].get("ssd_mobilenet", {})
            status, body, _ = post(f"http://127.0.0.1:{port}/predict", jpegs[0])
        finally:
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=120)
        states = [v["state"] for v in doc.get("versions", [])]
        row["cli"] = {"boot_s": boot_s, "states": states, "status": status,
                      "num_detections": body.get("num_detections"), "exit": rc}
        if states != ["SERVING"] or status != 200 or not body.get("num_detections") or rc != 0:
            log.seek(0)
            row["cli"]["log_tail"] = log.read()[-2000:]
            bad["cli"] = row["cli"]

    bursts = ("pb_yuv420_burst", "pb_ragged_burst", "resnet50_burst", "ssd_burst")
    row["kernel_launches"] = {k: sum(row[p]["kernel_launches"][k] for p in bursts)
                              for k in wrappers}
    row["seconds"] = time.perf_counter() - t_phase
    emit(row)
    if bad:
        raise AssertionError(f"converter: {bad}")
    return row


# --------------------------------------------------------------------------
# Bulk jobs: POST /jobs through the batcher's bulk class (ROADMAP Queue 1
# item 14). Inception-v3 bf16 on the yuv420 wire with the preprocess kernel,
# canvas 512 only (every corpus image fits it), batch buckets 1–256: every
# bulk batch is one replay of the batch-256 graph and one kernel launch.

JOBS_IMAGES = 1024  # distinct seeded JPEGs, four bulk batches of 256
JOBS_BATCH = 256
JOBS_INFLIGHT = 2
JOBS_BUCKETS = (512,)
JOBS_PARITY_IMAGES = 24
JOBS_LOAD_S = 4.0  # loadgen's interactive baseline before the job
# the isolation job lists the corpus this many times (hard links), so that
# the interactive p99 with the job rests on a few thousand requests
JOBS_ISO_REPEAT = 4
JOBS_WORKERS = 8
# the SIGTERM job's tenant: 256 images/s with a 1 s bucket, one bulk batch a
# second, so that the signal lands with the job part done
JOBS_SLOW_TENANT = "slow"
JOBS_QUOTA = f"{JOBS_SLOW_TENANT}=256"
JOBS_TERMINAL = ("DONE", "FAILED", "CANCELLED")


def jobs_request(port: int, method: str, path: str, doc=None, headers: dict | None = None,
                 timeout: float = 120.0) -> tuple[int, dict | list | None, dict]:
    """One JSON request to a local server: (status, the parsed body or None,
    headers in lower case)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        body = json.dumps(doc).encode() if doc is not None else None
        conn.request(method, path, body=body,
                     headers={"Content-Type": "application/json", **(headers or {})})
        r = conn.getresponse()
        data = r.read()
        hdrs = {k.lower(): v for k, v in r.getheaders()}
        if hdrs.get("content-type") == "application/x-ndjson":
            return r.status, [json.loads(ln) for ln in data.splitlines() if ln], hdrs
        return r.status, json.loads(data) if data else None, hdrs
    finally:
        conn.close()


def wait_job(port: int, jid: str, until, timeout: float) -> dict:
    """Poll ``GET /jobs/{id}`` every 10 ms until ``until(doc)``; the doc."""
    deadline = time.perf_counter() + timeout
    while True:
        status, doc, _ = jobs_request(port, "GET", f"/jobs/{jid}")
        if status != 200:
            raise AssertionError(f"GET /jobs/{jid}: {status} {doc}")
        if until(doc):
            return doc
        if time.perf_counter() > deadline:
            raise AssertionError(f"job {jid} never got there in {timeout} s: {doc}")
        time.sleep(0.01)


def job_rows(port: int, jid: str) -> list[dict]:
    """Every result line of a finished job, through the offset cursor."""
    rows, offset = [], 0
    while True:
        status, got, hdrs = jobs_request(port, "GET",
                                         f"/jobs/{jid}/results?offset={offset}&limit=500")
        if status != 200:
            raise AssertionError(f"results of {jid}: {status} {got}")
        rows += got
        offset = int(hdrs["x-job-next-offset"])
        if hdrs["x-job-complete"] == "1":
            return rows


def once_each(rows: list[dict], n: int) -> dict:
    """Zero lost and zero duplicated: every index 0..n-1 exactly once, in order."""
    idx = [r["i"] for r in rows]
    counts = Counter(idx)
    return {"lines": len(idx), "lost": sum(1 for i in range(n) if i not in counts),
            "duplicated": sum(c - 1 for c in counts.values() if c > 1),
            "in_order": idx == sorted(idx), "errors": sum("error" in r for r in rows)}


def job_server_proc(args: list[str], log) -> tuple[subprocess.Popen, int, float]:
    """``python -m tensorflow_web_deploy_tpu_torch.server`` with ``args`` on a
    free port, waited for until ``/healthz`` answers: (process, port, boot s)."""
    port = free_port()
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "tensorflow_web_deploy_tpu_torch.server",
                             "--host", "127.0.0.1", "--port", str(port), *args],
                            stdout=log, stderr=subprocess.STDOUT, text=True,
                            cwd=os.path.dirname(os.path.abspath(__file__)))
    while True:
        if proc.poll() is not None:
            raise AssertionError(f"the jobs server exited {proc.returncode}")
        if time.perf_counter() - t0 > 300:
            proc.kill()
            raise AssertionError("the jobs server did not answer /healthz in 300 s")
        try:
            urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=5).read()
            return proc, port, time.perf_counter() - t0
        except OSError:
            time.sleep(0.5)


def preprocess_256(gen: torch.Generator) -> dict:
    """``preprocess_i420`` on a wire batch of 256 at the jobs' canvas (512,
    299 out) against its plain version, in float32 and bf16: 256 × 512² ×
    1.5 bytes of canvases read, 68,659,968 output elements, past every
    earlier batch."""
    from tensorflow_web_deploy_tpu_torch.ops.preprocess_i420 import (
        preprocess_i420_plain,
        preprocess_i420_wire,
        wire_canvases,
    )

    b, s = JOBS_BATCH, JOBS_BUCKETS[0]
    rs = np.random.RandomState(SEED + 3)
    hws_np = rs.randint(1, s + 1, (b, 2)).astype(np.int32)
    hws_np[0], hws_np[1], hws_np[-1] = (s, s), (1, 1), (s, s)  # full, hole, full last row
    buf = wire_batch(b, s, hws_np, gen)
    packed, hws = wire_canvases(buf, s), torch.from_numpy(hws_np).cuda()
    ref = preprocess_i420_plain(packed, hws, OUT, OUT)
    got = preprocess_i420_wire(buf, s, OUT, OUT)
    torch.cuda.synchronize()
    row = {"batch": b, "canvas": s, "out": OUT, "tol": KERNEL_TOL["inception"],
           "max_abs_err": float((got - ref).abs().max())}
    row.update(bf16_vs_plain(preprocess_i420_wire(buf, s, OUT, OUT, "inception",
                                                  torch.bfloat16), ref, "inception"))
    bf16 = torch.bfloat16
    row.update(
        ms=graph_time_ms(lambda: preprocess_i420_wire(buf, s, OUT, OUT, "inception", bf16),
                         inner=5, replays=5),
        ms_f32=graph_time_ms(lambda: preprocess_i420_wire(buf, s, OUT, OUT), inner=5,
                             replays=5),
        plain_ms=cuda_time_ms(lambda: preprocess_i420_plain(packed, hws, OUT, OUT, "inception",
                                                            bf16), repeats=3, warmup=1))
    row["bound_ms"], row["bound_by"] = bound_ms(hws_np, s, OUT, OUT, 2, 4)
    row["bound_ms_f32"] = bound_ms(hws_np, s, OUT, OUT, 4, 4)[0]
    del buf, packed, ref, got
    if not row["max_abs_err"] <= row["tol"]:
        raise AssertionError(f"preprocess_i420 at B=256 vs plain: {row}")
    return row


def phase_jobs(jpegs: list[bytes]) -> dict:
    """Bulk jobs (``POST /jobs``) at full width on the card: Inception-v3 in
    bf16 on the yuv420 wire with the preprocess kernel, ``max_batch`` 256
    (batch buckets 1–256, one graph each at canvas 512), ``--jobs-batch
    256``, ``--jobs-max-inflight 2``, over ``JOBS_IMAGES`` distinct seeded
    JPEGs in a server-side directory.

    - Job 1, the cache off, in-process (``start_server``): ``DONE`` with
      every index once; the kernels' counts set to 0 just before it and
      read just after: one preprocess launch and one graph replay a bulk
      batch, every batch sealed at 256; the first 24 images' answers
      against ``POST /predict`` of the same JPEGs (``answers_match`` at the
      bf16 gate's probability tolerance); job img/s, the batch-256 replay's
      device ms and the bulk batches' share of the job's window, the bulk
      gate's holds and valve dispatches.
    - ``preprocess_i420`` at B = 256 against its plain version.
    - Isolation: ``tools/loadgen.py --job DIR --job-server-dir`` in a
      process of its own (8 closed-loop workers) over the corpus listed
      ``JOBS_ISO_REPEAT`` times: interactive p50/p99 without and with the
      job, every answer 200, and the reference's
      bound (p99 with the job ≤ p99 without + one bulk batch's device ms)
      reported beside the batch's ms; then the same with one bulk batch in
      flight.
    - A hot swap mid-job: the runner is held before its second chunk until
      the swap's DRAINING flip has paused the job (so the swap lands
      mid-job whatever the load takes); the job goes PAUSED → RUNNING on
      v2, lists both versions and ends with every index once.
    - SIGTERM mid-job on the server's entry point (``python -m``, a tenant
      quota of one bulk batch a second for the job), exit 0 with the job's
      checkpoint ``RUNNING``; a reboot on the same ``--jobs-dir`` resumes
      it to ``DONE`` with every index once. On that server (cache on, the
      CLI's default) a job over the corpus, then a second: every image of
      the second a bulk cache hit, no bulk batch, the interactive hits
      unmoved, no preprocess launch."""
    import shutil

    from tensorflow_web_deploy_tpu_torch.server import start_server
    from tensorflow_web_deploy_tpu_torch.utils.config import ServerConfig, model_config

    t_phase = time.perf_counter()
    row = {"phase": "jobs", "nvidia_smi": nvidia_smi(), "images": JOBS_IMAGES,
           "jobs_batch": JOBS_BATCH, "jobs_max_inflight": JOBS_INFLIGHT,
           "canvas_buckets": list(JOBS_BUCKETS)}
    bad: dict = {}
    n_batches = JOBS_IMAGES // JOBS_BATCH

    def counts() -> dict:
        return read_launches()

    def zero() -> None:
        zero_launches()

    tmp = tempfile.mkdtemp(prefix="jobs-")
    try:
        t0 = time.perf_counter()
        corpus = os.path.join(tmp, "corpus")
        interactive = os.path.join(tmp, "interactive")
        jobs_dir = os.path.join(tmp, "jobs")
        os.makedirs(corpus)
        os.makedirs(interactive)
        images = make_jpegs(JOBS_IMAGES, SEED + 2)
        for i, data in enumerate(images):
            with open(os.path.join(corpus, f"{i:05d}.jpg"), "wb") as f:
                f.write(data)
        for i, data in enumerate(jpegs):
            with open(os.path.join(interactive, f"{i:02d}.jpg"), "wb") as f:
                f.write(data)
        iso_corpus = os.path.join(tmp, "isolation")
        os.makedirs(iso_corpus)
        for r in range(JOBS_ISO_REPEAT):
            for i in range(JOBS_IMAGES):
                os.link(os.path.join(corpus, f"{i:05d}.jpg"),
                        os.path.join(iso_corpus, f"{r}-{i:05d}.jpg"))
        row["corpus"] = {"distinct": len(set(images)), "bytes": sum(map(len, images)),
                         "make_s": time.perf_counter() - t0}
        if len(set(images)) != JOBS_IMAGES:
            raise AssertionError(f"jobs: the corpus is not {JOBS_IMAGES} distinct images")

        cfg = ServerConfig(model=model_config("native:inception_v3"), host="127.0.0.1", port=0,
                           wire_format="yuv420", resize="kernel", max_batch=JOBS_BATCH,
                           canvas_buckets=JOBS_BUCKETS, jobs_dir=jobs_dir,
                           jobs_batch=JOBS_BATCH, jobs_max_inflight=JOBS_INFLIGHT,
                           http_workers=32, **PINNED)
        t0 = time.perf_counter()
        srv = start_server(cfg, device="cuda", seed=SEED)
        row["boot_s"] = time.perf_counter() - t0
        try:
            eng, port = srv.engine, srv.port
            shard = eng._replicas[0].shards[0]  # the card: one replica of one device
            st = eng.stats()
            row["graphs"] = {"batch_buckets": list(eng.batch_buckets),
                             "capture_s": {f"{k[1]}x{k[2]}": exe.capture_s
                                           for k, exe in sorted(shard.exes.items(),
                                                                key=lambda kv: kv[0][2])},
                             "pool_bytes": st["graphs"]["pool_bytes"],
                             "static_bytes": st["graphs"]["static_bytes"]}
            batcher = srv.batcher
            if batcher.bulk_max_batch != JOBS_BATCH:
                bad["bulk_max_batch"] = batcher.bulk_max_batch

            # job 1: the cache off, the counts around it
            b0, before = batcher.stats()["bulk"], eng.stats()
            zero()
            t0 = time.perf_counter()
            status, doc, _ = jobs_request(port, "POST", "/jobs", {"dir": corpus})
            if status != 202:
                raise AssertionError(f"POST /jobs: {status} {doc}")
            jid = doc["id"]
            doc = wait_job(port, jid, lambda d: d["state"] in JOBS_TERMINAL, 300)
            wall_s = time.perf_counter() - t0
            launches = counts()
            b1, after = batcher.stats()["bulk"], eng.stats()
            rows = job_rows(port, jid)
            batches = after["batches"] - before["batches"]
            replays = {k: after["graphs"][k] - before["graphs"][k]
                       for k in ("replays", "eager_batches")}
            key = next(k for k in shard.exes if k[1] == JOBS_BUCKETS[0] and k[2] == JOBS_BATCH)
            exe = shard.exes[key]
            with eng._replicas[0].lock, torch.cuda.stream(shard.compute):
                replay_ms = cuda_time_ms(exe)
            del exe
            run_s = doc["run_s"]
            job1 = {
                "state": doc["state"], "completed": doc["completed"], "errors": doc["errors"],
                "run_s": run_s, "wall_s": wall_s, "img_per_s": JOBS_IMAGES / run_s,
                "chunks": doc["chunks_done"], "results": once_each(rows, JOBS_IMAGES),
                "batches": batches, "graphs": replays, "kernel_launches": launches,
                "bulk_batches_sealed": b1["batches_sealed_total"] - b0["batches_sealed_total"],
                "bulk_images_sealed": b1["images_sealed_total"] - b0["images_sealed_total"],
                "gate_holds_total": b1["gate_holds_total"],
                "starvation_dispatches_total": b1["starvation_dispatches_total"],
                "replay_ms_256": replay_ms,
                "bulk_device_share": batches * replay_ms / 1e3 / run_s}
            row["job"] = job1
            want = launches_want(preprocess_i420=n_batches)
            if doc["state"] != "DONE" or doc["completed"] != JOBS_IMAGES or \
                    job1["results"] != {"lines": JOBS_IMAGES, "lost": 0, "duplicated": 0,
                                        "in_order": True, "errors": 0} or \
                    batches != n_batches or launches != want or \
                    replays != {"replays": n_batches, "eager_batches": 0} or \
                    (job1["bulk_batches_sealed"], job1["bulk_images_sealed"]) != (
                        n_batches, JOBS_IMAGES):
                bad["job"] = job1
            row["kernel_launches"] = launches

            # the first 24 images' answers against the request path's
            tol = eng.PARITY_TOL["bfloat16"]["prob"]
            client = KeepAlive(port)
            try:
                served = []
                for data in images[:JOBS_PARITY_IMAGES]:
                    status, body = client.request("POST", "/predict", data)
                    if status != 200:
                        raise AssertionError(f"/predict: {status} {body}")
                    served.append(body["predictions"])
            finally:
                client.close()
            m = [answers_match(r["predictions"], s, tol)
                 for r, s in zip(rows[:JOBS_PARITY_IMAGES], served)]
            row["vs_predict"] = {"images": len(m), "agree": sum(r["ok"] for r in m), "tol": tol,
                                 "top1_equal": sum(r["predictions"][0]["index"] == s[0]["index"]
                                                   for r, s in zip(rows, served)),
                                 "max_score_diff": max(r["max_score_diff"] for r in m)}
            if row["vs_predict"]["agree"] != JOBS_PARITY_IMAGES:
                bad["vs_predict"] = row["vs_predict"]

            row["preprocess_256"] = preprocess_256(
                torch.Generator(device="cuda").manual_seed(SEED + 3))

            # isolation: loadgen's baseline, then the job under the same load;
            # again with one bulk batch in flight (the batcher's cap and the
            # runner's window set on the live server, as --jobs-max-inflight 1
            # sets them at boot)
            def isolation() -> dict:
                b0 = batcher.stats()["bulk"]
                cmd = [sys.executable, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                                    "tools", "loadgen.py"),
                       "--url", f"http://127.0.0.1:{port}/predict", "--images", interactive,
                       "--workers", str(JOBS_WORKERS), "--duration", str(JOBS_LOAD_S),
                       "--warmup", "0", "--timeout", "60", "--job", iso_corpus,
                       "--job-server-dir", "--job-max-wait", "240"]
                t0 = time.perf_counter()
                proc = subprocess.run(cmd, capture_output=True, text=True, timeout=400)
                lines = proc.stdout.strip().splitlines()
                summary = json.loads(lines[-1]) if lines else {}
                base = summary.get("interactive_baseline", {})
                during = summary.get("interactive_with_job", {})
                p99_idle = (base.get("latency_ms") or {}).get("p99")
                p99_job = (during.get("latency_ms") or {}).get("p99")
                b1 = batcher.stats()["bulk"]
                iso = {"jobs_max_inflight": batcher.bulk_inflight_cap, "rc": proc.returncode,
                       "wall_s": time.perf_counter() - t0, "job": summary.get("job"),
                       "baseline": base, "with_job": during,
                       "interactive_p99_degradation": summary.get("interactive_p99_degradation"),
                       "bulk_batch_ms": replay_ms,
                       "bound_ms": None if p99_idle is None else p99_idle + replay_ms,
                       "bulk": {k: b1[k] - b0[k] for k in (
                           "batches_sealed_total", "gate_holds_total",
                           "starvation_dispatches_total")}}
                iso["bound_holds"] = (p99_idle is not None and p99_job is not None
                                      and p99_job <= p99_idle + replay_ms)
                if proc.returncode != 0 or base.get("errors") != 0 or \
                        during.get("errors") != 0 or not base.get("requests") or \
                        not during.get("requests") or (summary.get("job") or {}).get(
                            "completed") != JOBS_ISO_REPEAT * JOBS_IMAGES:
                    bad[f"isolation_{batcher.bulk_inflight_cap}"] = {
                        **iso, "stderr": proc.stderr.splitlines()[-20:]}
                return iso

            jm = srv.app.jobs
            row["isolation"] = isolation()
            batcher.bulk_inflight_cap = jm.max_inflight = 1
            try:
                row["isolation_inflight_1"] = isolation()
            finally:
                batcher.bulk_inflight_cap = jm.max_inflight = JOBS_INFLIGHT

            # a hot swap mid-job: the runner waits before its second chunk
            # until the swap's DRAINING flip paused the job
            armed = threading.Event()
            seen: dict = {}
            stage = jm._stage_chunk

            def held_stage(job, start):
                if start > 0 and armed.is_set():
                    armed.clear()
                    end = time.monotonic() + 300
                    while job.state != "PAUSED" and time.monotonic() < end:
                        time.sleep(0.01)
                    seen["paused_before_chunk_2"] = job.state == "PAUSED"
                return stage(job, start)

            jm._stage_chunk = held_stage
            swap_out: dict = {}
            try:
                armed.set()
                status, doc, _ = jobs_request(port, "POST", "/jobs", {"dir": corpus})
                if status != 202:
                    raise AssertionError(f"POST /jobs: {status} {doc}")
                jid = doc["id"]
                t0 = time.perf_counter()

                def swap():
                    swap_out["status"], swap_out["doc"], _ = jobs_request(
                        port, "POST", "/models/swap",
                        {"name": "inception_v3", "wait": True, "timeout_s": 300}, timeout=400)
                    swap_out["s"] = time.perf_counter() - t0

                swapper = threading.Thread(target=swap, daemon=True)
                swapper.start()
                doc = wait_job(port, jid, lambda d: d["state"] in JOBS_TERMINAL, 400)
                swapper.join(400)
            finally:
                del jm._stage_chunk  # back to the class's method
            states = [h["state"] for h in doc["history"]]
            paused = states.index("PAUSED") if "PAUSED" in states else None
            hot = {"state": doc["state"], "history": states, "versions": doc["versions"],
                   "results": once_each(job_rows(port, jid), JOBS_IMAGES),
                   "swap_status": swap_out.get("status"), "swap_s": swap_out.get("s"), **seen}
            row["hot_swap"] = hot
            if doc["state"] != "DONE" or paused is None or \
                    "RUNNING" not in states[paused:] or not seen.get("paused_before_chunk_2") or \
                    doc["versions"] != ["inception_v3@1", "inception_v3@2"] or \
                    hot["results"]["lost"] or hot["results"]["duplicated"] or \
                    hot["results"]["lines"] != JOBS_IMAGES or swap_out.get("status") != 200:
                bad["hot_swap"] = hot
        finally:
            srv.close()

        # SIGTERM mid-job on the entry point, then a reboot on the same dir
        args = ["--model", "native:inception_v3", "--wire-format", "yuv420", "--resize",
                "kernel", "--max-batch", str(JOBS_BATCH), "--canvas-buckets",
                ",".join(map(str, JOBS_BUCKETS)), "--jobs-dir", jobs_dir, "--jobs-batch",
                str(JOBS_BATCH), "--jobs-max-inflight", str(JOBS_INFLIGHT), "--tenant-quota",
                JOBS_QUOTA, "--pressure-rungs", NO_LADDER]
        log = tempfile.TemporaryFile("w+")
        procs = []
        try:
            proc, port, boot_s = job_server_proc(args, log)
            procs.append(proc)
            status, doc, _ = jobs_request(port, "POST", "/jobs", {"dir": corpus},
                                          headers={"X-Tenant": JOBS_SLOW_TENANT})
            if status != 202:
                raise AssertionError(f"POST /jobs: {status} {doc}")
            jid = doc["id"]
            doc = wait_job(port, jid, lambda d: d["completed"] >= JOBS_BATCH
                           or d["state"] in JOBS_TERMINAL, 300)
            at_signal = doc["completed"]
            t0 = time.perf_counter()
            proc.send_signal(signal.SIGTERM)
            try:
                code = proc.wait(60)
            except subprocess.TimeoutExpired:
                code = None
            stop_s = time.perf_counter() - t0
            with open(os.path.join(jobs_dir, jid, "checkpoint.json")) as f:
                cp = json.load(f)
            proc, port, reboot_s = job_server_proc(args, log)
            procs.append(proc)
            doc = wait_job(port, jid, lambda d: d["state"] in JOBS_TERMINAL, 300)
            term = {"boot_s": boot_s, "completed_at_signal": at_signal, "exit_code": code,
                    "stop_s": stop_s, "checkpoint": {k: cp[k] for k in
                                                     ("state", "completed", "chunks_done")},
                    "reboot_s": reboot_s, "state": doc["state"], "resumed": doc["resumed"],
                    "results": once_each(job_rows(port, jid), JOBS_IMAGES)}
            row["sigterm"] = term
            if code != 0 or cp["state"] != "RUNNING" or \
                    not JOBS_BATCH <= cp["completed"] < JOBS_IMAGES or \
                    doc["state"] != "DONE" or not doc["resumed"] or \
                    term["results"]["lost"] or term["results"]["duplicated"] or \
                    term["results"]["lines"] != JOBS_IMAGES:
                bad["sigterm"] = term

            # the cache on: a job over the corpus fills it, a second is all hits
            def run(tag: str) -> dict:
                status, doc, _ = jobs_request(port, "POST", "/jobs", {"dir": corpus})
                if status != 202:
                    raise AssertionError(f"POST /jobs ({tag}): {status} {doc}")
                return wait_job(port, doc["id"], lambda d: d["state"] in JOBS_TERMINAL, 300)

            run("fill")
            _, s0, _ = jobs_request(port, "GET", "/stats")
            second = run("second")
            _, s1, _ = jobs_request(port, "GET", "/stats")
            c0, c1 = s0["cache"], s1["cache"]
            cached = {
                "state": second["state"], "cached": second["cached"],
                "bulk_hits": c1["bulk"]["hits_total"] - c0["bulk"]["hits_total"],
                "bulk_misses": c1["bulk"]["misses_total"] - c0["bulk"]["misses_total"],
                "interactive_hits": c1["hits_total"] - c0["hits_total"],
                "bulk_batches": (s1["batcher"]["bulk"]["batches_sealed_total"]
                                 - s0["batcher"]["bulk"]["batches_sealed_total"]),
                "preprocess_launches": (s1["engine"]["kernel_launches"]["preprocess_i420"]
                                        - s0["engine"]["kernel_launches"]["preprocess_i420"])}
            row["cache"] = cached
            if cached != {"state": "DONE", "cached": JOBS_IMAGES, "bulk_hits": JOBS_IMAGES,
                          "bulk_misses": 0, "interactive_hits": 0, "bulk_batches": 0,
                          "preprocess_launches": 0}:
                bad["cache"] = cached
            proc.send_signal(signal.SIGTERM)
            row["exit_code"] = proc.wait(60)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            log.seek(0)
            tail = log.read().splitlines()[-8:]
            log.close()
        if bad:
            row["server_log_tail"] = tail
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    row["seconds"] = time.perf_counter() - t_phase
    emit(row)
    if bad:
        raise AssertionError(f"jobs: {bad}")
    return row


# --------------------------------------------------------------------------
# dag: detect → crop → classify in one POST /pipelines/<name>
# --------------------------------------------------------------------------

DAG_MODELS = ("native:ssd_mobilenet", "native:mobilenet_v2,dtype=int8")
DAG_PIPELINE = "analyze=ssd_mobilenet>mobilenet_v2@int8"
DAG_PATH = "/pipelines/analyze"
DAG_BUCKETS = (512,)
DAG_MAX_BATCH = 32
DAG_MAX_CROPS = 8
DAG_WORKERS = 8
DAG_LOAD_S = 3.0  # the timed closed loop
DAG_SWAP_CONNS = 4


def dets_of(body: dict) -> list:
    """A composite's detections without their classifications."""
    return [{k: v for k, v in d.items() if k != "classification"} for d in body["detections"]]


def dag_config():
    """The dag phase's ServerConfig and the detector's anchor-scene weights."""
    from tensorflow_web_deploy_tpu_torch.models import get as zoo_get
    from tensorflow_web_deploy_tpu_torch.models.adapter import init_variables
    from tensorflow_web_deploy_tpu_torch.models.ssd_mobilenet import ASPECT_RATIOS
    from tensorflow_web_deploy_tpu_torch.utils.config import ServerConfig, model_config

    mcs = tuple(model_config(m) for m in DAG_MODELS)
    cfg = ServerConfig(model=mcs[0], models=mcs, default_model="ssd_mobilenet",
                       canvas_buckets=DAG_BUCKETS, max_batch=DAG_MAX_BATCH, wire_format="rgb",
                       resize="matmul", ragged=True, pipelines=(DAG_PIPELINE,),
                       pipeline_max_crops=DAG_MAX_CROPS, http_workers=2 * DAG_WORKERS,
                       host="127.0.0.1", port=0, **PINNED)
    _, flat = init_variables(zoo_get("ssd_mobilenet"), seed=SEED)
    return cfg, scene_params(flat, scene_biases(90, len(ASPECT_RATIOS)))


def dag_registry(cfg, det_params: dict):
    """The registry of the dag phase: the detector built on ``det_params``
    (the anchor scene), the classifier on seed ``SEED``; a swap builds the
    classifier's version v on seed ``SEED + v - 1``, so that an answer
    names the version that computed it."""
    from tensorflow_web_deploy_tpu_torch.serving.engine import InferenceEngine
    from tensorflow_web_deploy_tpu_torch.serving.registry import ModelRegistry

    builds: dict = {}

    def build(mc):
        v = builds[mc.serve_name] = builds.get(mc.serve_name, 0) + 1
        return InferenceEngine(replace(cfg, model=mc), device="cuda", seed=SEED + v - 1,
                               params_flat=det_params if mc.task == "detect" else None)

    reg = ModelRegistry(cfg, default_model="ssd_mobilenet", engine_factory=build)
    try:
        for mc in cfg.serve_models:
            eng = build(mc)
            reg.adopt(mc.serve_name, eng, reg.build_batcher(eng), mc)
    except BaseException:
        reg.stop()
        reg.close_engines()
        raise
    return reg


def phase_dag(jpegs: list[bytes]) -> dict:
    """Pipeline DAGs (``POST /pipelines/<name>``) on the card:
    ``native:ssd_mobilenet`` (bf16, full width, 300 px, 90 classes) then
    ``native:mobilenet_v2`` in the int8 tier (full width, 224 px), as
    ``--pipeline analyze=ssd_mobilenet>mobilenet_v2@int8`` serves them:
    the detector's boxes stay on the card, the glue crops 8 of them out of
    the canvas the detector was shipped (``ops/dag_glue.py``) and the
    classifier takes that batch as it is.

    - The served path, in-process: ragged rgb wire, canvas 512, batch
      buckets 1–32, the cache off, the detector on the anchor scene (every
      image has 100 detections). Each engine must have captured its
      ragged graphs and its classic pipeline graph at boot. The 24 JPEGs
      one at a time, then at once from 8 workers with the kernels' counts
      set to 0 just before and read just after: every answer 200 with
      ``num_detections`` ≥ 1, each concurrent composite equal to the serial
      one for its image (a graph's static output read after another
      request's replay would crop another image's boxes), every dispatch
      of both stages a replay, per request 1 ``nms_fixed``, 17
      ``fused_dw`` and 0 ``preprocess_i420`` and ``unpack_ragged``
      launches.
    - Stage by stage on the card, through the port's own calls: the
      detector's ``run_batch`` (its detections equal the composite's), the
      glue on the card against ``crop_resize_host`` (within 1 LSB), the
      classifier's ``run_batch`` on the host crops (top-1 equal, scores
      within ``SERVED_TOL``).
    - D2H bytes per request (printed, not gated): the pipeline's, per
      stage and per engine, against ``POST /predict`` of the same work (the
      image on the detector, its 8 crops on the classifier).
    - Timing: ``DAG_WORKERS`` closed-loop clients for ``DAG_LOAD_S``: e2e
      p50/p99 ms and img/s; the glue's µs a request (CUDA events around
      one call on the stream, and inside a graph).
    - Hot swap of the classifier under traffic from ``DAG_SWAP_CONNS``
      clients: no error, no composite other than its claimed version's
      serial one, both versions answer, none answers v1 after its unload.
    - The CLI: ``python -m tensorflow_web_deploy_tpu_torch.server`` with
      the two ``--model``s and the ``--pipeline`` on seeded weights: ``GET
      /pipelines`` shows it resolved and one ``POST`` answers 200.
    """
    from PIL import Image

    from tensorflow_web_deploy_tpu_torch.ops import dag_glue
    from tensorflow_web_deploy_tpu_torch.serving.http import App, make_http_server, \
        shutdown_gracefully

    t_phase = time.perf_counter()
    wrappers = kernel_wrappers()

    def counts() -> dict:
        return {name: w.launches for name, w in wrappers.items()}

    def zero() -> None:
        for w in wrappers.values():
            w.launches = 0

    cfg, det_params = dag_config()
    row = {"phase": "dag", "nvidia_smi": nvidia_smi(), "models": list(DAG_MODELS),
           "pipeline": DAG_PIPELINE, "wire": "rgb", "ragged": True, "resize": "matmul",
           "canvas_buckets": list(DAG_BUCKETS), "max_batch": DAG_MAX_BATCH,
           "max_crops": DAG_MAX_CROPS}
    bad: dict = {}
    t0 = time.perf_counter()
    reg = dag_registry(cfg, det_params)
    app = httpd = None
    try:
        app = App(reg, cfg)
        httpd = make_http_server(app, cfg.host, 0, pool_size=cfg.http_workers)
        threading.Thread(target=httpd.serve_forever, name="http", daemon=True).start()
        port = httpd.server_address[1]
        row["boot_s"] = time.perf_counter() - t0
        det_mv, cls_mv = (reg.acquire(n) for n in ("ssd_mobilenet", "mobilenet_v2"))
        reg.release(det_mv)
        reg.release(cls_mv)
        det, cls = det_mv.engine, cls_mv.engine
        n_crops = cls.pick_batch_bucket(DAG_MAX_CROPS)
        out_s = min(cls.cfg.canvas_buckets)
        row["engines"] = {name: {"graphs": e.stats()["graphs"]["captured"],
                                 "dag_pairs": e.dag_pairs(), "kernels": e.kernels,
                                 "dtype": e.model_cfg.dtype}
                          for name, e in (("ssd_mobilenet", det), ("mobilenet_v2", cls))}
        row["crop_batch"] = {"n_crops": n_crops, "side": out_s}
        graphs_want = len(det.batch_buckets) * len(DAG_BUCKETS) + 1
        if (det.dag_pairs() != [(512, 1)] or cls.dag_pairs() != [(512, n_crops)]
                or any(v["graphs"] != graphs_want for v in row["engines"].values())):
            bad["engines"] = row["engines"]

        def replays() -> dict:
            return {n: (e.stats()["graphs"]["replays"], e.stats()["graphs"]["eager_batches"])
                    for n, e in (("ssd_mobilenet", det), ("mobilenet_v2", cls))}

        # serial, then all at once with the counts read around the burst
        d2h0 = (det.d2h_bytes_total, cls.d2h_bytes_total)
        busy0 = (det.stats()["busy_s"], cls.stats()["busy_s"])
        client = KeepAlive(port)
        r0 = replays()
        serial, serial_ms = [], []
        for data in jpegs:
            t = time.perf_counter()
            serial.append(client.request("POST", DAG_PATH, data))
            serial_ms.append((time.perf_counter() - t) * 1e3)
        r1 = replays()
        # each stage's device ms a request: its replays' CUDA-event intervals
        device_ms = {name: (e.stats()["busy_s"] - b) / len(jpegs) * 1e3
                     for (name, e), b in zip((("ssd_mobilenet", det), ("mobilenet_v2", cls)),
                                             busy0)}
        d2h_dag = ((det.d2h_bytes_total - d2h0[0]) / len(jpegs),
                   (cls.d2h_bytes_total - d2h0[1]) / len(jpegs))
        zero()
        t0 = time.perf_counter()
        recs = fan_out(port, jpegs, DAG_WORKERS, DAG_PATH)
        burst_s = time.perf_counter() - t0
        launches = counts()
        r2 = replays()
        n = len(jpegs)
        ok_serial = [s == 200 and b.get("num_detections", 0) >= 1 for s, b in serial]
        ok_burst = [r["status"] == 200 and r["doc"].get("num_detections", 0) >= 1 for r in recs]
        equal = [r["status"] == 200 and r["doc"]["detections"] == b["detections"]
                 for r, (_, b) in zip(recs, serial)]
        row["served"] = {
            "requests": n, "serial_ok": sum(ok_serial), "burst_ok": sum(ok_burst),
            "burst_equal_serial": sum(equal),
            "num_detections": sorted({b.get("num_detections") for _, b in serial}),
            "stages": serial[0][1].get("stages"),
            "serial_ms": {"p50": statistics.median(serial_ms), "max": max(serial_ms)},
            "device_ms_per_request": device_ms,
            "replays_serial": {k: [r1[k][0] - r0[k][0], r1[k][1] - r0[k][1]] for k in r0},
            "replays_burst": {k: [r2[k][0] - r1[k][0], r2[k][1] - r1[k][1]] for k in r1},
            "launches": launches, "burst_s": burst_s,
            "first": {"detections": serial[0][1].get("num_detections"),
                      "first_detection": (serial[0][1].get("detections") or [None])[0]},
        }
        if not all(ok_serial) or not all(ok_burst) or not all(equal):
            bad["served"] = {k: row["served"][k] for k in ("serial_ok", "burst_ok",
                                                           "burst_equal_serial")}
        if any(v != [n, 0] for v in (*row["served"]["replays_serial"].values(),
                                     *row["served"]["replays_burst"].values())):
            bad["replays"] = {k: row["served"][k] for k in ("replays_serial", "replays_burst")}
        if launches != launches_want(fused_dw=DW_CELLS * n, nms_fixed=n):
            bad["launches"] = launches

        # stage by stage through the port's own calls
        glue_lsb, top1, score_d, det_equal = 0, 0, 0.0, 0
        labels = det_mv.labels
        probe_crops = []  # the first 8 images' crops, for the /predict comparison
        for data, (_, body) in zip(jpegs, serial):
            canvas, hw, orig = det.prepare_bytes(data)
            boxes, scores, classes, num = (o[0] for o in det.run_batch(canvas[None],
                                                                        np.array([hw])))
            kept = min(int(num), DAG_MAX_CROPS)
            h, w = orig
            # the detector's label map: generated names, or artifacts/' file
            # once an earlier phase has written it
            ref = [{"box": [float(b[0]) * h, float(b[1]) * w, float(b[2]) * h,
                            float(b[3]) * w],
                    "class": int(c), "score": float(s),
                    "label": labels[int(c)] if int(c) < len(labels) else f"class_{int(c)}"}
                   for b, c, s in zip(boxes[:kept], classes[:kept], scores[:kept])]
            det_equal += ref == dets_of(body)
            host = dag_glue.crop_resize_host(canvas, hw, boxes, num, out_s=out_s,
                                             n_crops=n_crops)
            with torch.inference_mode():
                dev = dag_glue.crop_resize(
                    torch.from_numpy(canvas).cuda(), torch.tensor(hw, device="cuda"),
                    torch.from_numpy(boxes).cuda(), torch.tensor(num, device="cuda"),
                    out_s=out_s, n_crops=n_crops).cpu().numpy()
            glue_lsb = max(glue_lsb, int(np.abs(dev.astype(np.int32) - host).max()))
            if len(probe_crops) < 8:
                probe_crops.append(host[:DAG_MAX_CROPS])
            cs, ci = cls.run_batch(host, np.full((n_crops, 2), out_s, np.int32))
            for i, d in enumerate(body["detections"]):
                preds = d["classification"]["predictions"]
                top1 += preds[0]["index"] == int(ci[i][0])
                score_d = max(score_d, max(abs(p["score"] - float(s))
                                           for p, s in zip(preds, cs[i])))
        kept_total = sum(b["num_detections"] for _, b in serial)
        row["stage_by_stage"] = {"images": n, "detections_equal": det_equal,
                                 "glue_max_lsb": glue_lsb, "crops": kept_total,
                                 "top1_equal": top1, "max_score_delta": score_d,
                                 "tolerance": SERVED_TOL}
        if det_equal != n or glue_lsb > 1 or top1 != kept_total or score_d > SERVED_TOL:
            bad["stage_by_stage"] = row["stage_by_stage"]

        # D2H per request: the pipeline's, against /predict on each model
        stats = app.pipelines.pipeline_stats()["pipelines"]["analyze"]
        d0 = (det.d2h_bytes_total, cls.d2h_bytes_total)
        for data, crops in zip(jpegs, probe_crops):
            client.request("POST", "/predict?model=ssd_mobilenet", data)
            parts = []
            for i, crop in enumerate(crops):
                buf = io.BytesIO()
                Image.fromarray(crop).save(buf, "JPEG", quality=90)
                parts.append(b"--dagB\r\nContent-Disposition: form-data; name=\"f\"; "
                             b"filename=\"%d.jpg\"\r\n\r\n" % i + buf.getvalue() + b"\r\n")
            client.exchange("POST", "/predict?model=mobilenet_v2", b"".join(parts)
                            + b"--dagB--\r\n",
                            {"Content-Type": "multipart/form-data; boundary=dagB"})
        row["d2h_bytes_per_request"] = {
            "pipeline_stage1": stats["stages"]["ssd_mobilenet"]["d2h_bytes"] / stats[
                "requests_total"],
            "pipeline_stage2": stats["stages"]["mobilenet_v2"]["d2h_bytes"] / stats[
                "requests_total"],
            "pipeline_engines": {"ssd_mobilenet": d2h_dag[0], "mobilenet_v2": d2h_dag[1]},
            "predict": {"ssd_mobilenet": (det.d2h_bytes_total - d0[0]) / len(probe_crops),
                        "mobilenet_v2": (cls.d2h_bytes_total - d0[1]) / len(probe_crops)},
        }

        # timing: a closed loop of DAG_WORKERS clients
        stop_at = time.perf_counter() + DAG_LOAD_S
        lat: list = []
        errors: list = []

        def loop(k: int) -> None:
            c = KeepAlive(port)
            try:
                i = k
                while time.perf_counter() < stop_at:
                    t = time.perf_counter()
                    status, _ = c.request("POST", DAG_PATH, jpegs[i % len(jpegs)])
                    if status == 200:
                        lat.append((time.perf_counter() - t) * 1e3)
                    else:
                        errors.append(status)
                    i += DAG_WORKERS
            finally:
                c.close()

        t0 = time.perf_counter()
        threads = [threading.Thread(target=loop, args=(k,)) for k in range(DAG_WORKERS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        wall = time.perf_counter() - t0
        lat.sort()
        row["timing"] = {"workers": DAG_WORKERS, "seconds": wall, "completed": len(lat),
                         "errors": errors[:5], "img_per_s": len(lat) / wall,
                         "p50_ms": lat[len(lat) // 2] if lat else None,
                         "p99_ms": lat[min(len(lat) - 1, int(0.99 * len(lat)))] if lat else None,
                         "nvidia_smi": row["nvidia_smi"]}
        if errors or not lat:
            bad["timing"] = row["timing"]

        # hot swap of the classifier under traffic
        truth = {(1, i): body["detections"] for i, (_, body) in enumerate(serial)}
        stop = threading.Event()
        seen: list = []
        failures: list = []

        def swap_client(k: int) -> None:
            c = KeepAlive(port)
            try:
                i = k
                while not stop.is_set():
                    t = time.monotonic()
                    status, body = c.request("POST", DAG_PATH, jpegs[i % len(jpegs)])
                    if status != 200:
                        failures.append((status, body))
                    else:
                        seen.append((t, i % len(jpegs), body["stages"][1]["version"],
                                     body["detections"]))
                    i += DAG_SWAP_CONNS
            except Exception as e:  # noqa: BLE001 — counted as a failure
                failures.append(repr(e))
            finally:
                c.close()

        threads = [threading.Thread(target=swap_client, args=(k,))
                   for k in range(DAG_SWAP_CONNS)]
        for t in threads:
            t.start()
        t0 = time.perf_counter()
        try:
            while len(seen) < 16 and time.perf_counter() - t0 < 60:
                time.sleep(0.01)
            v2 = reg.swap("mobilenet_v2", wait=True, timeout=300)
            reg.wait_for(reg._models["mobilenet_v2"][1], ("UNLOADED",), timeout=120)
            t_unloaded = time.monotonic()
            after = len(seen)
            while len(seen) < after + 16 and time.perf_counter() - t0 < 120:
                time.sleep(0.01)
        finally:
            stop.set()
            for t in threads:
                t.join(60)
        swap_s = time.perf_counter() - t0
        for i, data in enumerate(jpegs):
            status, body = client.request("POST", DAG_PATH, data)
            truth[(v2.version, i)] = body["detections"] if status == 200 else None
        stale = [(v, i) for _, i, v, d in seen if truth.get((v, i)) != d]
        late = [v for t, _, v, _ in seen if t > t_unloaded and v != v2.version]
        v2_differs = sum(truth[(1, i)] != truth[(v2.version, i)] for i in range(n))
        row["hot_swap"] = {"answers": len(seen), "errors": len(failures),
                           "failures": failures[:3], "stale": len(stale),
                           "versions": sorted({v for _, _, v, _ in seen}),
                           "old_after_unload": len(late), "seconds": swap_s,
                           "images_whose_answer_changed": v2_differs}
        if failures or stale or late or row["hot_swap"]["versions"] != [1, v2.version] \
                or not v2_differs:
            bad["hot_swap"] = row["hot_swap"]
        client.close()

        # the glue of one request (image 0's detections): on the stream
        # between CUDA events, the host's enqueue, and inside a graph (last:
        # a capture that fails leaves nothing after it on this process)
        canvas, hw, _ = det.prepare_bytes(jpegs[0])
        boxes, _, _, num = (torch.from_numpy(np.ascontiguousarray(o[0])).cuda()
                            for o in det.run_batch(canvas[None], np.array([hw])))
        args = (torch.from_numpy(canvas).cuda(), torch.tensor(hw, device="cuda"), boxes, num)

        def glue():
            return dag_glue.crop_resize(*args, out_s=out_s, n_crops=n_crops)

        with torch.inference_mode():
            glue_us = cuda_time_ms(glue) * 1e3
            glue_host_us = host_us(glue)
            try:
                glue_graph_us = graph_time_ms(glue) * 1e3
            except RuntimeError as e:  # the eager times above stand; the reason is printed
                glue_graph_us = f"not captured: {e}"
        row["timing"].update(glue_us=glue_us, glue_host_us=glue_host_us,
                             glue_graph_us=glue_graph_us,
                             glue_share_of_serial_p50=glue_us / 1e3 / row["served"]["serial_ms"][
                                 "p50"],
                             # the crops written once and the canvas read once
                             # over the memory rate
                             glue_bound_us=(n_crops * out_s * out_s * 3 + canvas.nbytes)
                             / MEM_BYTES_PER_S * 1e6,
                             glue_share_of_p50=(glue_us / 1e3 / row["timing"]["p50_ms"]
                                                if row["timing"]["p50_ms"] else None))
    finally:
        if httpd is not None:
            shutdown_gracefully(httpd, reg, grace_s=10.0)
        else:
            reg.stop()
        reg.close_engines()

    # the CLI: the two models and the pipeline on seeded weights
    with tempfile.TemporaryFile("w+") as log:
        proc, cli_port, boot_s = job_server_proc(
            ["--model", DAG_MODELS[0], "--model", DAG_MODELS[1], "--pipeline", DAG_PIPELINE],
            log)
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{cli_port}/pipelines",
                                        timeout=60) as r:
                pipes = json.loads(r.read())
            status, _, data = post_full(f"http://127.0.0.1:{cli_port}{DAG_PATH}", jpegs[0])
            body = json.loads(data) if data else {}
        finally:
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=120)
        doc = pipes.get("analyze", {})
        row["cli"] = {"boot_s": boot_s, "ok": doc.get("ok"), "ref": doc.get("ref"),
                      "resolved": doc.get("resolved"), "status": status,
                      "num_detections": body.get("num_detections"), "exit": rc}
        if not doc.get("ok") or status != 200 or rc != 0:
            log.seek(0)
            row["cli"]["log_tail"] = log.read()[-2000:]
            bad["cli"] = row["cli"]
    row["kernel_launches"] = row["served"]["launches"]
    row["seconds"] = time.perf_counter() - t_phase
    emit(row)
    if bad:
        raise AssertionError(f"dag: {bad}")
    return row


def sweep_dag() -> None:
    """The dag phase's server under ``DAG_LOAD_S`` of closed-loop pipeline
    requests from 1, 2, 4 and 8 workers (then 1 again): img/s, p50/p99, and
    the host ms a request spent in each call of the executor (the engine's
    dispatches and device reads, the glue, ``Tensor.cpu``), each timed by a
    wrapper on the calling thread (waits for the interpreter lock
    included). One line per worker count; no ``ok`` line."""
    from tensorflow_web_deploy_tpu_torch.serving import dag as dag_mod
    from tensorflow_web_deploy_tpu_torch.serving.engine import InferenceEngine
    from tensorflow_web_deploy_tpu_torch.serving.http import App, make_http_server, \
        shutdown_gracefully

    spent: Counter = Counter()
    lock = threading.Lock()

    def timed_call(owner, name: str) -> None:
        fn = getattr(owner, name)

        def call(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                with lock:
                    spent[name] += time.perf_counter() - t

        setattr(owner, name, call)

    for name in ("prepare_bytes", "dispatch_batch", "device_outputs", "device_canvases",
                 "dispatch_device", "release_dispatch", "fetch_outputs"):
        timed_call(InferenceEngine, name)
    timed_call(dag_mod.dag_glue, "crop_resize")
    timed_call(torch.Tensor, "cpu")
    timed_call(dag_mod.PipelineCatalog, "execute")
    cfg, det_params = dag_config()
    reg = dag_registry(cfg, det_params)
    httpd = make_http_server(App(reg, cfg), "127.0.0.1", 0, pool_size=cfg.http_workers)
    threading.Thread(target=httpd.serve_forever, name="http", daemon=True).start()
    port = httpd.server_address[1]
    jpegs = make_jpegs(24, SEED)
    try:
        client = KeepAlive(port)
        for data in jpegs:  # first use of every path
            client.request("POST", DAG_PATH, data)
        client.close()
        for workers in (1, 2, 4, 8, 1):
            with lock:
                spent.clear()
            lat: list = []
            statuses: Counter = Counter()
            stop_at = time.perf_counter() + DAG_LOAD_S

            def loop(k: int, workers=workers, lat=lat, statuses=statuses) -> None:
                c = KeepAlive(port)
                try:
                    i = k
                    while time.perf_counter() < stop_at:
                        t = time.perf_counter()
                        status, _ = c.request("POST", DAG_PATH, jpegs[i % len(jpegs)])
                        statuses[status] += 1
                        lat.append((time.perf_counter() - t) * 1e3)
                        i += workers
                finally:
                    c.close()

            t0 = time.perf_counter()
            threads = [threading.Thread(target=loop, args=(k,)) for k in range(workers)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(60)
            wall = time.perf_counter() - t0
            lat.sort()
            n = len(lat)
            with lock:
                host_ms = {k: v / n * 1e3 for k, v in sorted(spent.items())}
            emit({"phase": "sweep_dag", "nvidia_smi": nvidia_smi(), "workers": workers,
                  "requests": n, "statuses": dict(statuses), "img_per_s": n / wall,
                  "p50_ms": lat[n // 2], "p99_ms": lat[min(n - 1, int(0.99 * n))],
                  "host_ms_per_request": host_ms})
    finally:
        shutdown_gracefully(httpd, reg, grace_s=10.0)
        reg.close_engines()


TRAIN_CLASSES = 10
TRAIN_BATCH = 32
TRAIN_SIZE = 224
TRAIN_STEPS = (20, 40)  # the tool's first run, then the same command resumed to 40
TRAIN_SAVE_EVERY = 10
TRAIN_LOG_EVERY = 1  # the reference test compares the first step's loss with the last
TRAIN_LR = 1e-3  # the tool's default
TRAIN_LOSS_DROP = 0.8  # the reference's test_loss_decreases_single_device
TRAIN_TIMED_STEPS = 10
TRAIN_BLOBS = 8  # JPEGs of the tool's synthetic blobs posted to the float32 --ckpt server
# The bf16 --ckpt server's scores lie within the engine's bf16 gate of the
# float32 model's, or at most this many times as far from them as the plain
# model's in bf16 (the export cast, cuDNN's depthwise, no hand kernel) on
# the same planes: how far bf16 moves a probability grows with the logits
# (54-58 at most on the photographs), and each run trains another export
# (training on the card is not deterministic)
SERVED_BF16_DEVIATION_RATIO = 2.0
# the other classifiers: (name, px), batch 32, a few steps each
TRAIN_OTHERS = (("resnet50", 224), ("inception_v3", 299))
TRAIN_OTHER_STEPS = 3
# the card against the CPU in float64: one SGD step, then eval logits on
# held-out inputs, at the reference's test_sharded_and_single_device_agree
# tolerances
F64_BATCH = 4
F64_LR = 3e-3
F64_LOSS_RTOL = 1e-9
F64_LOGIT_RTOL, F64_LOGIT_ATOL = 1e-4, 1e-6
TRAIN_LINE = r"step (\d+)/(\d+) loss=([0-9.]+) acc=([0-9.]+) \(([0-9.]+) img/s\)"


def run_tool(argv: list[str]) -> tuple[str, list[dict]]:
    """``tools/train.py``'s ``main`` in this process: its printed lines and
    the logged steps."""
    import contextlib
    import re

    from tensorflow_web_deploy_tpu_torch.tools import train as train_tool

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = train_tool.main(argv)
    text = out.getvalue()
    if rc != 0:
        raise AssertionError(f"tools/train.py {argv} returned {rc}: {text}")
    logged = [{"step": int(a), "of": int(b), "loss": float(c), "acc": float(d),
               "img_per_s": float(e)} for a, b, c, d, e in re.findall(TRAIN_LINE, text)]
    return text, logged


def train_steps(name: str, size: int, steps: int, seed: int = SEED,
                mesh=None) -> tuple[dict, tuple]:
    """A fresh full-width zoo classifier trained ``steps`` steps on the card
    (float32, TF32 off, AdamW at the tool's rate) on the tool's synthetic
    batches, already on the device: each step's ms (CUDA events), its loss,
    and the peak ``memory_allocated`` over the steps; and (step function,
    state, first batch) to run more. With ``mesh`` (one rank, all rows)
    the step is the mesh's."""
    from tensorflow_web_deploy_tpu_torch.models import get as zoo_get
    from tensorflow_web_deploy_tpu_torch.models.adapter import init_variables
    from tensorflow_web_deploy_tpu_torch.tools.train import SyntheticData
    from tensorflow_web_deploy_tpu_torch.train import adamw, create_train_state, make_train_step

    module, _ = init_variables(zoo_get(name), num_classes=TRAIN_CLASSES, seed=seed)
    state = create_train_state(module, None, adamw(TRAIN_LR), device="cuda", mesh=mesh)
    step = make_train_step(module, mesh=mesh)
    data = SyntheticData(TRAIN_CLASSES, size, TRAIN_BATCH, seed)
    batches = [tuple(torch.as_tensor(a, device="cuda") for a in data.batch_at(i))
               for i in range(steps)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms, losses = [], []
    for x, y in batches:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        state, m = step(state, x, y)
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
        losses.append(float(m["loss"]))
    row = {"model": name, "size": size, "batch": TRAIN_BATCH, "steps": steps, "step_ms": ms,
           "losses": losses, "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
           "params": sum(p.numel() for p in module.parameters())}
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{name}: loss not finite: {losses}")
    return row, (step, state, batches[0])


def dk_share(step_ms: float) -> dict:
    """The depthwise kernel gradient's 9-tap reduction
    (``depthwise_kernel_grad``) at the 17 MobileNetV2 layer shapes at batch
    32, float32, each timed alone (CUDA events): its summed ms against one
    train step's, and each layer's ms beside its bound (the padded input
    and the output gradient read once, 9·C floats written, or 2·9
    operations an output element at the float32 rate)."""
    from tensorflow_web_deploy_tpu_torch.ops.depthwise import depthwise_kernel_grad

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    layers, total, bound = [], 0.0, 0.0
    for layer in dw_layer_shapes():
        (pt, pb), (pl, pr) = layer["pads"]
        s = layer["stride"]
        c, hp, wp = layer["c"], layer["h"] + pt + pb, layer["w"] + pl + pr
        oh, ow = (hp - 3) // s + 1, (wp - 3) // s + 1
        xp = torch.randn((TRAIN_BATCH, c, hp, wp), generator=gen, device="cuda")
        g = torch.randn((TRAIN_BATCH, c, oh, ow), generator=gen, device="cuda")
        ms = cuda_time_ms(lambda xp=xp, g=g, s=s: depthwise_kernel_grad(xp, g, (3, 3), (s, s)))
        t_bytes = (xp.numel() + g.numel() + 9 * c) * 4 / MEM_BYTES_PER_S * 1e3
        t_ops = 2 * 9 * g.numel() / F32_FLOPS_PER_S * 1e3
        layers.append({"block": layer["block"], "c": c, "h": layer["h"], "stride": s, "ms": ms,
                       "bound_ms": max(t_bytes, t_ops)})
        total += ms
        bound += max(t_bytes, t_ops)
    return {"dk_ms": total, "dk_bound_ms": bound, "step_ms": step_ms,
            "share_of_step": total / step_ms, "layers": layers}


def serve_export(export: str, dtype: str, posted: list[bytes], labels: list[str],
                 trained, seeded, counts, zero) -> dict:
    """The CLI's config with ``--ckpt export`` in ``dtype`` (``--fused-dw
    on``, yuv420 + kernel) answering ``posted`` at once, held against the
    float32 eval-mode model built from the export (``trained``) on the same
    resized planes: every answer 200; every top-k entry labelled from the
    export's ``labels.txt`` and scored within the tolerance of that model's
    probability; the top-1 equal to its top-1 on every image whose float32
    margin exceeds the tolerance; the scores away from the seeded init's;
    1 ``preprocess_i420`` and 17 ``fused_dw`` launches a batch, every batch
    a replay, and no other kernel (the four counts zeroed just before the
    burst and read just after). The tolerance is ``SERVED_TOL`` in float32.
    In bf16 it is the engine's bf16 gate against float32 (``PARITY_TOL``,
    the reference's), or ``SERVED_BF16_DEVIATION_RATIO`` × the largest gap
    of the plain model in bf16 (the export cast, on the same planes) over
    the same entries where that is larger: one bf16 step of a logit moves a
    mid-range probability by p(1 − p) × |logit| × 2^-8, so the gate alone
    fails an export whose logits train large. The row's ``failed`` names
    the checks that did not hold."""
    from tensorflow_web_deploy_tpu_torch.ops.image import NORMALIZERS, resize_yuv_planes
    from tensorflow_web_deploy_tpu_torch.server import config_from_args, parse_args, start_server
    from tensorflow_web_deploy_tpu_torch.serving.engine import InferenceEngine

    argv = ["--model", "native:mobilenet_v2", "--ckpt", export, "--zoo-classes",
            str(TRAIN_CLASSES), "--dtype", dtype, "--fused-dw", "on", "--wire-format",
            "yuv420", "--resize", "kernel", "--canvas-buckets", ",".join(map(str, BUCKETS)),
            "--max-batch", "8", "--host", "127.0.0.1", "--port", "0", *PINNED_ARGS]
    cfg = config_from_args(parse_args(argv))
    tol = SERVED_TOL if dtype == "f32" else InferenceEngine.PARITY_TOL["bfloat16"]["prob"]
    t0 = time.perf_counter()
    srv = start_server(cfg, device="cuda", seed=SEED)
    boot_s = time.perf_counter() - t0
    try:
        eng = srv.engine
        urllib.request.urlopen(srv.url + "/healthz", timeout=120).read()
        before = eng.stats()
        zero()
        results, timeline = burst(srv, posted)
        launches = counts()
        after = eng.stats()
        out_px = eng.model_cfg.input_size[0]
        # the float32 export, the seeded init and, in bf16, the export cast
        models = {"f32": (trained, torch.float32), "seeded": (seeded, torch.float32)}
        if dtype != "f32":
            models["bf16"] = (copy.deepcopy(trained).to(torch.bfloat16), torch.bfloat16)
        logits = {name: [] for name in models}
        with torch.inference_mode():
            for data in posted:
                canvas, hw, _ = eng.prepare_bytes(data)
                packed = torch.from_numpy(canvas[None]).cuda()
                hws = torch.tensor([hw], dtype=torch.int32, device="cuda")
                xr = NORMALIZERS["inception"](resize_yuv_planes(packed, hws, out_px, out_px))
                for name, (model, dt) in models.items():
                    logits[name].append(model(xr.permute(0, 3, 1, 2).to(dt)).float()[0])
    finally:
        srv.close()
    logits = {name: torch.stack(rows) for name, rows in logits.items()}
    probs = {name: torch.softmax(z, -1).cpu().numpy() for name, z in logits.items()}
    pf, ps = probs["f32"], probs["seeded"]
    batches = after["batches"] - before["batches"]
    replays = after["graphs"]["replays"] - before["graphs"]["replays"]
    # every entry of every answer's top-k: (image, index, score, label)
    entries = [(i, p["index"], p["score"], p["label"])
               for i, (_, body, _) in enumerate(results) for p in body["predictions"]]
    top1 = [body["predictions"][0]["index"] for _, body, _ in results]
    top2 = np.sort(pf, 1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > tol
    top1_equal = [idx == int(pf[i].argmax()) for i, idx in enumerate(top1)]
    score_gap = max(abs(sc - pf[i, idx]) for i, idx, sc, _ in entries)
    plain = None
    score_tol = tol
    if dtype != "f32":
        p16 = probs["bf16"]
        plain = {"max_score_gap_to_float32": float(max(abs(p16[i, idx] - pf[i, idx])
                                                       for i, idx, _, _ in entries)),
                 "logit_rel": logit_rel(logits["bf16"], logits["f32"])}
        score_tol = max(tol, SERVED_BF16_DEVIATION_RATIO * plain["max_score_gap_to_float32"])
    seed_gap = max(abs(results[i][1]["predictions"][0]["score"] - ps[i, idx])
                   for i, idx in enumerate(top1))
    want = launches_want(preprocess_i420=batches, fused_dw=DW_CELLS * batches)
    checks = {
        "status": all(status == 200 for status, _, _ in results),
        "labels": all(lab == labels[idx] for _, idx, _, lab in entries),
        "top1": bool(clear.any()) and all(t for t, c in zip(top1_equal, clear) if c),
        "scores": score_gap <= score_tol,
        "not_seeded": seed_gap > SERVED_TOL,
        "launches": batches > 0 and launches == want and replays == batches,
    }
    return {"phase": "train_serve", "nvidia_smi": nvidia_smi(), "model": "native:mobilenet_v2",
            "ckpt": after["ckpt"], "dtype": eng.model_cfg.dtype, "fused_dw": eng.fused_dw,
            "wire": cfg.wire_format, "resize": cfg.resize, "boot_s": boot_s,
            "requests": len(posted), "statuses": dict(Counter(r[0] for r in results)),
            "batches": batches, "replays": replays, "kernel_launches": launches, "want": want,
            "top1": top1, "top1_labels": sorted({labels[i] for i in top1}),
            "labels_checked": len({lab for _, _, _, lab in entries}),
            "entries_checked": len(entries), "clear_margin_images": int(clear.sum()),
            "top1_equal_clear": int(sum(t for t, c in zip(top1_equal, clear) if c)),
            "top1_equal_all": int(sum(top1_equal)),
            "max_score_gap_to_float32": float(score_gap), "tolerance": score_tol,
            "gate": tol, "bf16_plain": plain, "bf16_ratio": SERVED_BF16_DEVIATION_RATIO,
            "max_abs_logit_f32": float(logits["f32"].abs().max()),
            "max_score_gap_to_seeded": float(seed_gap),
            "img_per_s": len(posted) / timeline["wall_ms"] * 1e3,
            "p50_ms": timeline["client_latency_ms"]["p50"],
            "p99_ms": timeline["client_latency_ms"]["p99"],
            "failed": [name for name, ok in checks.items() if not ok]}


def phase_train(jpegs: list[bytes]) -> dict:
    """Training on the card, then serving what it trained.

    MobileNetV2 at full width, 224 px, batch 32, 10 synthetic classes,
    float32 with TF32 off, through ``tools/train.py``'s ``main``: 20 steps
    saving every 10, then the same command to 40, which must resume from
    step 20; the last logged loss must be under 0.8× the first. Beside the
    tool: a fresh MobileNetV2's step ms (CUDA events), img/s, peak
    ``memory_allocated`` and kernels a step (``torch.profiler``), and the
    depthwise kernel gradient's share of the step (``dk_share``); ResNet-50
    (224) and Inception-v3 (299) 3 steps each at batch 32 (finite losses,
    step ms, peak memory); one float64 SGD step of MobileNetV2 at 224 px,
    batch 4, on the card and on the CPU (loss and held-out eval logits at
    the reference's sharded-vs-single tolerances). Last, the export served
    by the CLI's config with ``--ckpt`` (``serve_export``): in bf16 to the
    24 JPEGs, and in float32 to them and to 8 JPEGs of the tool's blobs,
    whose top-1 classes the row keeps. The kernels' launches are the two
    servers' counted bursts together."""
    import shutil

    from tensorflow_web_deploy_tpu_torch.models import get as zoo_get
    from tensorflow_web_deploy_tpu_torch.models.adapter import from_jax_params, \
        init_variables, read_serving_export
    from tensorflow_web_deploy_tpu_torch.tools.train import SyntheticData
    from tensorflow_web_deploy_tpu_torch.train import create_train_state, make_train_step, sgd
    from tensorflow_web_deploy_tpu_torch.train.checkpoint import Checkpointer

    wrappers = kernel_wrappers()

    def counts() -> dict:
        return {name: w.launches for name, w in wrappers.items()}

    def zero() -> None:
        for w in wrappers.values():
            w.launches = 0

    t_phase = time.perf_counter()
    smi = nvidia_smi()
    run = tempfile.mkdtemp(prefix="train_")
    try:
        # 1. the tool: 20 steps, then resumed to 40
        tool = ["--model", "mobilenet_v2", "--width", "1.0", "--classes", str(TRAIN_CLASSES),
                "--input-size", str(TRAIN_SIZE), "--batch", str(TRAIN_BATCH),
                "--lr", str(TRAIN_LR), "--ckpt-dir", run, "--save-every", str(TRAIN_SAVE_EVERY),
                "--log-every", str(TRAIN_LOG_EVERY), "--device", "cuda"]
        runs = []
        for steps in TRAIN_STEPS:
            t0 = time.perf_counter()
            text, logged = run_tool(tool + ["--steps", str(steps)])
            runs.append({"steps": steps, "seconds": time.perf_counter() - t0,
                         "resumed": "resumed from step" in text, "logged": logged,
                         "lines": text.splitlines()})
        if runs[0]["resumed"] or f"resumed from step {TRAIN_STEPS[0]}" not in runs[1]["lines"]:
            raise AssertionError(f"the second run did not resume from step {TRAIN_STEPS[0]}: "
                                 f"{runs[1]['lines']}")
        losses = [r["loss"] for run_ in runs for r in run_["logged"]]
        if len(losses) != TRAIN_STEPS[1] // TRAIN_LOG_EVERY or \
                not losses[-1] < TRAIN_LOSS_DROP * losses[0]:
            raise AssertionError(f"MobileNetV2's loss did not fall under {TRAIN_LOSS_DROP}× its "
                                 f"first: {losses}")
        # the tool's batch alone on the host: the reference's synthetic blobs
        data = SyntheticData(TRAIN_CLASSES, TRAIN_SIZE, TRAIN_BATCH, SEED)
        host_batch_ms = statistics.median(timed(lambda i=i: data.batch_at(i)) for i in range(3))
        kept = Checkpointer(run, create=False).steps()
        export = os.path.join(run, "export")
        labels = open(os.path.join(export, "labels.txt")).read().split()
        if kept != [20, 30, 40] or labels != [f"class_{i}" for i in range(TRAIN_CLASSES)]:
            raise AssertionError(f"checkpoints {kept}, export labels {labels}")
        emit({"phase": "train_tool", "nvidia_smi": smi, "model": "mobilenet_v2", "width": 1.0,
              "size": TRAIN_SIZE, "batch": TRAIN_BATCH, "classes": TRAIN_CLASSES,
              "dtype": "float32", "tf32": [torch.backends.cudnn.allow_tf32,
                                           torch.backends.cuda.matmul.allow_tf32],
              "runs": [{k: v for k, v in r.items() if k != "lines"} for r in runs],
              "checkpoints": kept, "first_loss": losses[0], "last_loss": losses[-1],
              "host_batch_ms": host_batch_ms,
              "log": runs[1]["lines"]})

        # 2. a fresh MobileNetV2's step on the card: ms, img/s, memory, kernels
        mnet, (step, state, (x0, y0)) = train_steps("mobilenet_v2", TRAIN_SIZE,
                                                     TRAIN_TIMED_STEPS)
        prof = profiled_calls(lambda: step(state, x0, y0), calls=1)
        step_ms = statistics.median(mnet["step_ms"][2:])  # past cuDNN's first calls
        dk = dk_share(step_ms)
        emit({"phase": "train_step", "nvidia_smi": smi, "model": "mobilenet_v2",
              "size": TRAIN_SIZE, "batch": TRAIN_BATCH, "dtype": "float32",
              "step_ms": mnet["step_ms"], "step_ms_median": step_ms,
              "img_per_s": TRAIN_BATCH / step_ms * 1e3,
              "peak_allocated_bytes": mnet["peak_allocated_bytes"],
              "kernels_per_step": prof["kernels"], "profile_device_us": prof["device_us"],
              "profile_top": prof["top"], "dk": dk})
        del step, state, x0, y0

        # 3. ResNet-50 and Inception-v3, a few steps each
        others = []
        for name, size in TRAIN_OTHERS:
            others.append(train_steps(name, size, TRAIN_OTHER_STEPS)[0])
            torch.cuda.empty_cache()
        emit({"phase": "train_others", "nvidia_smi": smi, "dtype": "float32", "rows": others})

        # 4. the card against the CPU in float64
        spec = zoo_get("mobilenet_v2")
        _, flat = init_variables(spec, num_classes=TRAIN_CLASSES, seed=SEED)
        rs = np.random.RandomState(SEED)
        x = rs.rand(F64_BATCH, TRAIN_SIZE, TRAIN_SIZE, 3)
        y = rs.randint(0, TRAIN_CLASSES, F64_BATCH)
        x_eval = rs.rand(F64_BATCH, TRAIN_SIZE, TRAIN_SIZE, 3)
        f64 = {}
        for dev in ("cuda", "cpu"):
            module = spec.build(num_classes=TRAIN_CLASSES).double()
            state = create_train_state(module, flat, sgd(F64_LR), device=dev)
            t0 = time.perf_counter()
            state, m = make_train_step(module)(state, x, y)
            loss = float(m["loss"])
            seconds = time.perf_counter() - t0
            with torch.no_grad():
                logits = module.eval()(torch.as_tensor(x_eval, device=dev).permute(0, 3, 1, 2))
            f64[dev] = (loss, logits.cpu().numpy(), seconds)
        (lc, gc, sc), (lh, gh, sh) = f64["cuda"], f64["cpu"]
        loss_rel = abs(lc - lh) / abs(lh)
        logit_excess = float(np.max(np.abs(gc - gh) - (F64_LOGIT_ATOL + F64_LOGIT_RTOL
                                                        * np.abs(gh))))
        row64 = {"phase": "train_f64", "nvidia_smi": smi, "model": "mobilenet_v2",
                 "size": TRAIN_SIZE, "batch": F64_BATCH, "optimizer": f"sgd {F64_LR}",
                 "loss_cuda": lc, "loss_cpu": lh, "loss_rel": loss_rel,
                 "logits_max_abs": float(np.abs(gc - gh).max()),
                 "logits_max_rel": float((np.abs(gc - gh) / np.abs(gh)).max()),
                 "step_s_cuda": sc, "step_s_cpu": sh}
        emit(row64)
        if not loss_rel <= F64_LOSS_RTOL or logit_excess > 0:
            raise AssertionError(f"float64 step: the card and the CPU disagree: {row64}")

        # 5. serve the export with --ckpt: bf16 on the photographs (float32
        # margins near 1), float32 on them and on JPEGs of the tool's blobs
        # from a batch past the 40 trained, of several classes
        blobs = SyntheticData(TRAIN_CLASSES, TRAIN_SIZE, TRAIN_BLOBS, SEED)
        xb, yb = blobs.batch_at(TRAIN_STEPS[1])
        blob_jpegs = [jpeg_bytes(np.clip((b + 1.0) * 127.5, 0, 255).astype(np.uint8))
                      for b in xb]
        trained = spec.build(num_classes=TRAIN_CLASSES).cuda()
        trained.load_state_dict(from_jax_params(read_serving_export(export)))
        seeded = init_variables(spec, num_classes=TRAIN_CLASSES, seed=SEED)[0].cuda()
        launches = dict.fromkeys(wrappers, 0)
        for dtype, posted in (("bf16", jpegs), ("f32", jpegs + blob_jpegs)):
            row = serve_export(export, dtype, posted, labels, trained, seeded, counts, zero)
            if dtype == "f32":
                row["blob_classes"] = [int(c) for c in yb]
                row["blob_top1"] = row["top1"][len(jpegs):]
            emit(row)
            launches = {k: v + row["kernel_launches"][k] for k, v in launches.items()}
            if row["failed"]:
                raise AssertionError(f"--ckpt server ({dtype}): {row['failed']}: {row}")
    finally:
        shutil.rmtree(run, ignore_errors=True)
    phase_s = time.perf_counter() - t_phase
    emit({"phase": "train", "nvidia_smi": smi, "seconds": phase_s})
    return {"kernel_launches": launches, "seconds": phase_s}


DIST_STEPS = 10  # (a): the tool at world size 1 over NCCL, and twice without a mesh
DIST_TOL_FACTOR = 4  # (a): the tolerance is this × the two plain runs' largest loss gap …
DIST_LOG_ROUNDING = 1e-4  # … plus the log's rounding (the tool prints 4 decimals)
DIST_CPU_RANKS = 4  # (b): data 2 × model 2 on gloo, the CPU by the caller's choice
DIST_CPU_MODEL_AXIS = 2
DIST_CPU_BATCH = 8
DIST_CPU_STEPS = 3
DIST_RESUME_STEPS = 6  # (c): 3 more steps on the card, resumed from (b)'s checkpoint
DIST_CHILD_TIMEOUT_S = 300


class rank_env:
    """The port's bootstrap environment for this process as rank ``rank``
    of ``world`` (``TPU_SERVE_COORDINATOR`` on a free port of the
    loopback), put back as it was on exit."""

    def __init__(self, world: int = 1, rank: int = 0):
        self.vars = {"TPU_SERVE_COORDINATOR": f"127.0.0.1:{free_port()}",
                     "TPU_SERVE_PROCESS_ID": str(rank), "TPU_SERVE_NUM_PROCESSES": str(world),
                     "NCCL_SOCKET_IFNAME": "lo"}  # the ranks share one host

    def __enter__(self):
        self.saved = {k: os.environ.get(k) for k in self.vars}
        os.environ.update(self.vars)
        return self

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def nccl_profile(fn, steps: int = 3) -> dict:
    """``steps`` calls of ``fn()`` (train steps on a mesh) under
    ``torch.profiler``: the NCCL kernels' device µs a step by name, and
    the ``nccl:*`` collectives the host issued a step and their host µs (a
    rank of one may launch no kernel for its all-reduce)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    device = {e.key[:90]: e.self_device_time_total / steps for e in events
              if e.device_type == DeviceType.CUDA and "nccl" in e.key.lower()
              and e.self_device_time_total > 0}
    host = {e.key: {"calls": e.count / steps, "host_us": e.cpu_time_total / steps}
            for e in events if e.device_type == DeviceType.CPU and e.key.startswith("nccl:")}
    return {"device_us_per_step": sum(device.values()), "kernels_us_per_step": device,
            "collectives_per_step": host, "steps_profiled": steps}


def run_ranks(argv: list[str], n: int, env: dict, timeout: float) -> list[tuple[int, str, str]]:
    """``python -m <argv>`` as ``n`` processes joined through
    ``TPU_SERVE_COORDINATOR`` on a free port (``env`` added to each): (exit
    code, stdout, stderr) of each. Every child still running at the end,
    or past ``timeout``, is killed."""
    here = os.path.dirname(os.path.abspath(__file__))
    port = free_port()
    procs = []
    try:
        for i in range(n):
            child = dict(os.environ, **env, TPU_SERVE_COORDINATOR=f"127.0.0.1:{port}",
                         TPU_SERVE_PROCESS_ID=str(i), TPU_SERVE_NUM_PROCESSES=str(n),
                         PYTHONPATH=here)
            procs.append(subprocess.Popen([sys.executable, "-m", *argv], env=child, cwd=here,
                                          stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                          text=True))
        deadline = time.monotonic() + timeout
        results = []
        for p in procs:
            out, err = p.communicate(timeout=max(deadline - time.monotonic(), 1.0))
            results.append((p.returncode, out, err))
        return results
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)


def phase_distributed(jpegs: list[bytes]) -> dict:
    """Multi-device training through the port's bootstrap, on the card and
    on the CPU.

    (a) ``tools/train.py`` through the env contract at world size 1 on the
    card (NCCL, ``--model-axis 1``; MobileNetV2 at full width, 224 px,
    batch 32, float32 with TF32 off, 10 steps), between two runs without
    it on the same seed: its step lines in the plain runs' format, its
    losses within ``DIST_TOL_FACTOR`` × the plain runs' largest gap plus the
    log's rounding (the card does not train deterministically). Beside it
    the mesh's step against the plain one in turns (plain, meshed, meshed,
    plain; ms by CUDA events, img/s, peak ``memory_allocated``) and the
    NCCL all-reduce's device µs a step from the profiler, with its bucket's
    bytes. (b) The tool on 4 gloo ranks of
    the CPU, data 2 × model 2, global batch 8, 3 steps, with a checkpoint.
    (c) That checkpoint restored onto the card at world size 1 (2 × 2 →
    1 × 1): every parameter, batch stat and AdamW moment bit for bit the
    file's; the tool resumed there for 3 more steps with its export, served
    with ``--ckpt`` in float32 (``serve_export``: every answer 200 and
    within ``SERVED_TOL`` of the float32 model built from the export, 1
    ``preprocess_i420`` and 17 ``fused_dw`` launches a batch, every batch a
    replay, no other kernel)."""
    import re
    import shutil

    from tensorflow_web_deploy_tpu_torch.models import get as zoo_get
    from tensorflow_web_deploy_tpu_torch.models.adapter import from_jax_params, \
        init_variables, read_serving_export
    from tensorflow_web_deploy_tpu_torch.parallel import distributed, train_mesh
    from tensorflow_web_deploy_tpu_torch.train import adamw, create_train_state, make_train_step
    from tensorflow_web_deploy_tpu_torch.train.checkpoint import STATE_FILE, Checkpointer

    wrappers = kernel_wrappers()

    def counts() -> dict:
        return {name: w.launches for name, w in wrappers.items()}

    def zero() -> None:
        for w in wrappers.values():
            w.launches = 0

    t_phase = time.perf_counter()
    smi = nvidia_smi()
    run = tempfile.mkdtemp(prefix="dist_")
    try:
        # (a) the tool at world size 1 over NCCL, between two plain runs
        tool = ["--model", "mobilenet_v2", "--width", "1.0", "--classes", str(TRAIN_CLASSES),
                "--input-size", str(TRAIN_SIZE), "--batch", str(TRAIN_BATCH),
                "--lr", str(TRAIN_LR), "--steps", str(DIST_STEPS), "--log-every", "1",
                "--device", "cuda"]
        plain_a = run_tool(tool)
        with rank_env():
            meshed = run_tool(tool)
        plain_b = run_tool(tool)
        la, lb, ld = ([r["loss"] for r in logged] for _, logged in (plain_a, plain_b, meshed))
        gap_plain = max(abs(a - b) for a, b in zip(la, lb))
        tol = DIST_TOL_FACTOR * gap_plain + DIST_LOG_ROUNDING
        gap = max(max(abs(d - a), abs(d - b)) for d, a, b in zip(ld, la, lb))
        step_lines = [[ln for ln in text.splitlines() if re.fullmatch(TRAIN_LINE, ln)]
                      for text, _ in (plain_a, meshed)]
        same_lines = (len(step_lines[0]) == len(step_lines[1]) == DIST_STEPS
                      and [r["step"] for r in plain_a[1]] == [r["step"] for r in meshed[1]])
        header = meshed[0].splitlines()[0]
        with rank_env():
            distributed.maybe_initialize("cuda")
            try:
                mesh = train_mesh(1, "cuda")
                backend = torch.distributed.get_backend()
                rows = {"plain": [], "meshed": []}
                for kind in ("plain", "meshed", "meshed", "plain"):  # in turns, one card
                    row, (step, state, (x0, y0)) = train_steps(
                        "mobilenet_v2", TRAIN_SIZE, DIST_STEPS,
                        mesh=mesh if kind == "meshed" else None)
                    rows[kind].append(row)
                    if kind == "meshed" and len(rows[kind]) == 1:
                        nccl = nccl_profile(lambda: step(state, x0, y0))
                        bucket_bytes = step.bucket_bytes
                    del step, state
                    torch.cuda.empty_cache()
            finally:
                distributed.shutdown()
        ms_d, ms_p = ([statistics.median(r["step_ms"][2:]) for r in rows[k]]
                      for k in ("meshed", "plain"))
        row_a = {"phase": "distributed_nccl", "nvidia_smi": smi, "model": "mobilenet_v2",
                 "size": TRAIN_SIZE, "batch": TRAIN_BATCH, "dtype": "float32",
                 "steps": DIST_STEPS, "backend": backend, "world": 1, "header": header,
                 "losses_meshed": ld, "losses_plain": [la, lb],
                 "acc_meshed": [r["acc"] for r in meshed[1]],
                 "acc_plain": [[r["acc"] for r in plain_a[1]], [r["acc"] for r in plain_b[1]]],
                 "plain_gap": gap_plain, "tolerance": tol, "meshed_gap": gap,
                 "same_lines": same_lines,
                 # median step ms (CUDA events) of each run, in the order plain,
                 # meshed, meshed, plain
                 "step_ms_meshed": ms_d, "step_ms_plain": ms_p,
                 "img_per_s_meshed": [TRAIN_BATCH / ms * 1e3 for ms in ms_d],
                 "img_per_s_plain": [TRAIN_BATCH / ms * 1e3 for ms in ms_p],
                 "peak_allocated_meshed": [r["peak_allocated_bytes"] for r in rows["meshed"]],
                 "peak_allocated_plain": [r["peak_allocated_bytes"] for r in rows["plain"]],
                 "bucket_bytes": bucket_bytes, "nccl": nccl,
                 "tool_img_per_s_meshed": [r["img_per_s"] for r in meshed[1]]}
        emit(row_a)
        if not (same_lines and gap <= tol and backend == "nccl"
                and header.startswith("mesh {'data': 1, 'model': 1} over 1 ranks (nccl, cuda)")):
            raise AssertionError(f"the tool at world size 1 over NCCL: {row_a}")
        torch.cuda.empty_cache()

        # (b) 4 gloo ranks on the CPU, data 2 × model 2, with a checkpoint
        ck = os.path.join(run, "ck")
        argv = ["tensorflow_web_deploy_tpu_torch.tools.train", "--model", "mobilenet_v2",
                "--width", "1.0", "--classes", str(TRAIN_CLASSES), "--input-size",
                str(TRAIN_SIZE), "--batch", str(DIST_CPU_BATCH), "--lr", str(TRAIN_LR),
                "--log-every", "1", "--ckpt-dir", ck]
        threads = str(max((os.cpu_count() or DIST_CPU_RANKS) // DIST_CPU_RANKS, 1))
        t0 = time.perf_counter()
        ranks = run_ranks(argv + ["--steps", str(DIST_CPU_STEPS), "--save-every",
                                  str(DIST_CPU_STEPS), "--model-axis", str(DIST_CPU_MODEL_AXIS),
                                  "--device", "cpu", "--no-export"], DIST_CPU_RANKS,
                          {"OMP_NUM_THREADS": threads, "CUDA_VISIBLE_DEVICES": ""},
                          DIST_CHILD_TIMEOUT_S)
        cpu_s = time.perf_counter() - t0
        logged = [{"step": int(a), "loss": float(c), "acc": float(d), "img_per_s": float(e)}
                  for a, _, c, d, e in re.findall(TRAIN_LINE, ranks[0][1])]
        kept = Checkpointer(ck, create=False).steps()
        row_b = {"phase": "distributed_cpu", "device": "cpu", "backend": "gloo",
                 "ranks": DIST_CPU_RANKS, "mesh": {"data": DIST_CPU_RANKS // DIST_CPU_MODEL_AXIS,
                                                   "model": DIST_CPU_MODEL_AXIS},
                 "threads_per_rank": int(threads), "model": "mobilenet_v2", "width": 1.0,
                 "size": TRAIN_SIZE, "batch": DIST_CPU_BATCH, "steps": DIST_CPU_STEPS,
                 "exit_codes": [rc for rc, _, _ in ranks], "seconds": cpu_s,
                 "log": ranks[0][1].splitlines(), "logged": logged, "checkpoints": kept,
                 "other_ranks_printed": [bool(out.strip()) for _, out, _ in ranks[1:]]}
        emit(row_b)
        if any(rc for rc, _, _ in ranks) or kept != [DIST_CPU_STEPS] \
                or len(logged) != DIST_CPU_STEPS \
                or not all(math.isfinite(r["loss"]) for r in logged):
            raise AssertionError(f"4 gloo ranks: {row_b}; stderr of rank 0: "
                                 f"{ranks[0][2][-2000:]}")

        # (c) that checkpoint onto the card at world size 1, then resumed and served
        saved = torch.load(os.path.join(ck, str(DIST_CPU_STEPS), STATE_FILE), weights_only=True)
        spec = zoo_get("mobilenet_v2")
        with rank_env():
            distributed.maybe_initialize("cuda")
            try:
                mesh = train_mesh(1, "cuda")
                module, _ = init_variables(spec, num_classes=TRAIN_CLASSES, seed=SEED + 1)
                state = create_train_state(module, None, adamw(TRAIN_LR), mesh=mesh)
                make_train_step(module, mesh=mesh)(  # the moments exist once it has stepped
                    state, np.zeros((2, TRAIN_SIZE, TRAIN_SIZE, 3), np.float32), [0, 1])
                state = Checkpointer(ck, create=False).restore(state, mesh)
                opt = state["opt_state"]
                live = [p for group in opt.param_groups for p in group["params"]]
                names = list(state["params"])
                unequal = [k for k, v in saved["params"].items()
                           if not torch.equal(state["params"][k].detach().cpu(), v)]
                unequal += [k for k, v in saved["batch_stats"].items()
                            if not torch.equal(state["batch_stats"][k].cpu(), v)]
                unequal += [f"{names[i]}:{k}" for i, entry in saved["opt_state"]["state"].items()
                            for k in ("exp_avg", "exp_avg_sq")
                            if not torch.equal(opt.state[live[i]][k].cpu(), entry[k])]
                leaves = (len(saved["params"]) + len(saved["batch_stats"])
                          + 2 * len(saved["opt_state"]["state"]))
                restored_step = int(state["step"])
                del state, opt, live, module
            finally:
                distributed.shutdown()
        torch.cuda.empty_cache()
        with rank_env():
            text, resumed = run_tool(tool[:tool.index("--steps")] + [
                "--steps", str(DIST_RESUME_STEPS), "--log-every", "1", "--device", "cuda",
                "--batch", str(DIST_CPU_BATCH), "--ckpt-dir", ck, "--save-every",
                str(DIST_CPU_STEPS)])
        export = os.path.join(ck, "export")
        labels = open(os.path.join(export, "labels.txt")).read().split()
        row_c = {"phase": "distributed_resume", "nvidia_smi": smi, "from": "2x2 gloo (cpu)",
                 "to": "1x1 nccl (cuda)", "leaves_checked": leaves, "unequal": unequal,
                 "restored_step": restored_step, "log": text.splitlines(),
                 "checkpoints": Checkpointer(ck, create=False).steps()}
        emit(row_c)
        if unequal or restored_step != DIST_CPU_STEPS or \
                f"resumed from step {DIST_CPU_STEPS}" not in text or \
                [r["step"] for r in resumed] != list(range(DIST_CPU_STEPS + 1,
                                                           DIST_RESUME_STEPS + 1)):
            raise AssertionError(f"2 × 2 → 1 × 1 on the card: {row_c}")
        trained = spec.build(num_classes=TRAIN_CLASSES).cuda()
        trained.load_state_dict(from_jax_params(read_serving_export(export)))
        seeded = init_variables(spec, num_classes=TRAIN_CLASSES, seed=SEED)[0].cuda()
        row = serve_export(export, "f32", jpegs, labels, trained, seeded, counts, zero)
        row["phase"] = "distributed_serve"
        emit(row)
        if row["failed"]:
            raise AssertionError(f"--ckpt server of the resumed export: {row['failed']}: {row}")
        launches = row["kernel_launches"]
    finally:
        shutil.rmtree(run, ignore_errors=True)
    phase_s = time.perf_counter() - t_phase
    emit({"phase": "distributed", "nvidia_smi": smi, "seconds": phase_s})
    return {"kernel_launches": launches, "seconds": phase_s}


WITNESS_BUCKETS = (512,)
WITNESS_MAX_BATCH = 8
WITNESS_CLIENTS = 8
WITNESS_TIMED_IMAGES = 256  # distinct JPEGs a model in the timed window (cache misses)
WITNESS_CACHE_BYTES = 256 << 20  # the CLI's default
WITNESS_JOB_IMAGES = 32
WITNESS_PIPELINE_REQUESTS = 4
WITNESS_QUOTA = "shed=4"  # the shed tenant's images a second (a burst of 1 s)
WITNESS_BURST = 32
WITNESS_CHILD_TIMEOUT_S = 600
# Inception-v3 on the yuv420 wire through the preprocess kernel (its cell
# store); MobileNetV2 int8 (fused depthwise cells) and the SSD detector on
# the ragged rgb wire, the pipeline's wire
WITNESS_WIRES = {"inception_v3": {"wire_format": "yuv420", "resize": "kernel", "ragged": False}}


def witness_drive(jpegs: list[bytes]) -> dict:
    """The served stack under the lock-order witness (run in a process that
    started with ``TWD_DEBUG_LOCKS=1``, so that module-level locks are
    witnessed too). One in-process server: Inception-v3 bf16 on yuv420
    (``preprocess_i420``), MobileNetV2 int8 with its fused depthwise cells
    and SSD-MobileNet bf16 (the anchor scene) on the ragged rgb wire, the
    response cache and the ladder on, ``--jobs-dir`` and the pipeline
    ``analyze=ssd_mobilenet>mobilenet_v2@int8``; canvas 512, batch buckets
    1–8. With the kernels' counts set to 0 just before:

    - ``WITNESS_TIMED_IMAGES`` distinct JPEGs (every one a cache miss) to
      each classifier from ``WITNESS_CLIENTS`` keep-alive connections: img/s
      with the witness on, a plain figure;
    - a hot swap of Inception-v3 under closed-loop traffic to both
      classifiers (every answer 200);
    - a bulk job of ``WITNESS_JOB_IMAGES`` JPEGs on Inception-v3 to DONE;
    - ``WITNESS_PIPELINE_REQUESTS`` pipeline requests;
    - a burst of ``WITNESS_BURST`` requests from a tenant with a quota of
      ``WITNESS_QUOTA``: 200s and 429s only, some of each;
    - one ``POST /debug/trace``;
    - a graceful shutdown.

    Then the witness: its violations (must be none), the observed edges,
    acquisitions by name, the declared names never acquired and the
    dispatch guard's most concurrent holders; and both TPU kernels' launch
    counts (each > 0)."""
    from tensorflow_web_deploy_tpu_torch.models import get as zoo_get
    from tensorflow_web_deploy_tpu_torch.models.adapter import init_variables
    from tensorflow_web_deploy_tpu_torch.models.ssd_mobilenet import ASPECT_RATIOS
    from tensorflow_web_deploy_tpu_torch.serving.engine import InferenceEngine
    from tensorflow_web_deploy_tpu_torch.serving.http import App, make_http_server, \
        shutdown_gracefully
    from tensorflow_web_deploy_tpu_torch.serving.registry import ModelRegistry
    from tensorflow_web_deploy_tpu_torch.utils import locks
    from tensorflow_web_deploy_tpu_torch.utils.config import ServerConfig, model_config

    w = locks.witness_active()
    if w is None:
        raise AssertionError("the witness drive needs TWD_DEBUG_LOCKS=1 at process start")
    tmp = tempfile.mkdtemp(prefix="twd-witness-")
    mcs = (model_config("native:inception_v3"), model_config("native:mobilenet_v2,dtype=int8"),
           model_config("native:ssd_mobilenet"))
    cfg = ServerConfig(model=mcs[0], models=mcs, default_model="inception_v3",
                       canvas_buckets=WITNESS_BUCKETS, max_batch=WITNESS_MAX_BATCH,
                       wire_format="rgb", resize="matmul", ragged=True,
                       pipelines=(DAG_PIPELINE,), pipeline_max_crops=DAG_MAX_CROPS,
                       http_workers=2 * WITNESS_CLIENTS, host="127.0.0.1", port=0,
                       jobs_dir=os.path.join(tmp, "jobs"), jobs_batch=WITNESS_MAX_BATCH,
                       tenant_quota=WITNESS_QUOTA, cache_bytes=WITNESS_CACHE_BYTES)
    _, flat = init_variables(zoo_get("ssd_mobilenet"), seed=SEED)
    det_params = scene_params(flat, scene_biases(90, len(ASPECT_RATIOS)))
    builds: dict = {}

    def build(mc):
        v = builds[mc.serve_name] = builds.get(mc.serve_name, 0) + 1
        return InferenceEngine(replace(cfg, model=mc, **WITNESS_WIRES.get(mc.serve_name, {})),
                               device="cuda", seed=SEED + v - 1,
                               params_flat=det_params if mc.task == "detect" else None)

    row = {"phase": "witness", "nvidia_smi": nvidia_smi(), "models": [m.serve_name for m in mcs],
           "dtypes": [m.dtype for m in mcs], "wires": {m.serve_name: WITNESS_WIRES.get(
               m.serve_name, {"wire_format": "rgb", "ragged": True})["wire_format"] for m in mcs},
           "pipeline": DAG_PIPELINE, "canvas_buckets": list(WITNESS_BUCKETS),
           "max_batch": WITNESS_MAX_BATCH, "cache_bytes": cfg.cache_bytes,
           "pressure_rungs": cfg.pressure_rungs, "tenant_quota": WITNESS_QUOTA}
    bad: dict = {}
    t0 = time.perf_counter()
    reg = ModelRegistry(cfg, default_model="inception_v3", engine_factory=build)
    httpd = None
    try:
        for mc in mcs:
            eng = build(mc)
            reg.adopt(mc.serve_name, eng, reg.build_batcher(eng), mc)
        app = App(reg, cfg)
        httpd = make_http_server(app, cfg.host, 0, pool_size=cfg.http_workers)
        threading.Thread(target=httpd.serve_forever, name="http", daemon=True).start()
        port = httpd.server_address[1]
        row["boot_s"] = time.perf_counter() - t0
        timed = make_jpegs(WITNESS_TIMED_IMAGES, SEED + 5)
        zero_launches()
        row["load"] = {}
        for name in ("inception_v3", "mobilenet_v2"):
            t0 = time.perf_counter()
            recs = fan_out(port, timed, WITNESS_CLIENTS, f"/predict?model={name}")
            load_s = time.perf_counter() - t0
            ms = sorted(r["ms"] for r in recs if r["status"] == 200)
            row["load"][name] = {
                "clients": WITNESS_CLIENTS, "images": len(recs), "seconds": load_s,
                "answered_200": len(ms), "img_s": len(ms) / load_s,
                "p50_ms": ms[len(ms) // 2] if ms else None,
                "p99_ms": float(np.percentile(ms, 99)) if ms else None,
                "x_cache": dict(Counter(r["headers"].get("x-cache") for r in recs))}
            if len(ms) != len(recs):
                bad[f"load_{name}"] = Counter(r["status"] for r in recs)
        # a hot swap of Inception-v3 under closed-loop traffic
        targets = [(name, d) for d in jpegs for name in ("inception_v3", "mobilenet_v2")]
        loop = ClosedLoop(port, WITNESS_CLIENTS, targets).start()
        t1 = time.perf_counter()
        status, doc = KeepAlive(port).request("POST", "/models/swap",
                                              {"name": "inception_v3", "wait": True})
        swap_s = time.perf_counter() - t1
        time.sleep(0.5)
        records = loop.finish()
        row["swap"] = {"status": status, "version": (doc or {}).get("version"), "seconds": swap_s,
                       "requests": len(records),
                       "answered_200": sum(r["status"] == 200 for r in records),
                       "versions": sorted({r.get("version") for r in records
                                           if r["model"] == "inception_v3" and r.get("version")})}
        if status != 200 or row["swap"]["answered_200"] != len(records):
            bad["swap"] = row["swap"]
        # a bulk job to DONE
        corpus = os.path.join(tmp, "corpus")
        os.makedirs(corpus)
        for i, data in enumerate(make_jpegs(WITNESS_JOB_IMAGES, SEED + 3)):
            with open(os.path.join(corpus, f"{i:03d}.jpg"), "wb") as f:
                f.write(data)
        status, doc, _ = jobs_request(port, "POST", "/jobs", {"dir": corpus})
        if status != 202:
            raise AssertionError(f"POST /jobs: {status} {doc}")
        job = wait_job(port, doc["id"], lambda d: d["state"] in JOBS_TERMINAL, 120)
        row["job"] = {k: job.get(k) for k in ("state", "total", "completed", "versions")}
        if job["state"] != "DONE" or job["completed"] != WITNESS_JOB_IMAGES:
            bad["job"] = row["job"]
        # pipeline requests
        client = KeepAlive(port)
        dag = [client.request("POST", DAG_PATH, d) for d in jpegs[:WITNESS_PIPELINE_REQUESTS]]
        client.close()
        row["pipeline"] = {"requests": len(dag), "ok": sum(s == 200 for s, _ in dag),
                           "num_detections": [b.get("num_detections") for _, b in dag]}
        if row["pipeline"]["ok"] != len(dag):
            bad["pipeline"] = row["pipeline"]
        # a burst that sheds: the quota'd tenant, all at once
        burst = fan_out(port, (jpegs * 2)[:WITNESS_BURST], WITNESS_CLIENTS, "/predict",
                        headers={"X-Tenant": "shed"})
        statuses = Counter(r["status"] for r in burst)
        row["shed_burst"] = {"requests": WITNESS_BURST, "statuses": dict(statuses),
                             "reasons": dict(Counter((r["doc"] or {}).get("reason")
                                                     for r in burst if r["status"] != 200))}
        if set(statuses) != {200, 429}:
            bad["shed_burst"] = row["shed_burst"]
        # a profiler capture
        status, doc, _ = jobs_request(port, "POST",
                                      f"/debug/trace?ms=300&dir={os.path.join(tmp, 'trace')}")
        row["trace"] = {"status": status, "activities": (doc or {}).get("activities")}
        if status != 200:
            bad["trace"] = row["trace"]
        row["kernel_launches"] = read_launches()
    finally:
        t1 = time.perf_counter()
        if httpd is not None:
            shutdown_gracefully(httpd, reg, grace_s=10.0)
        else:
            reg.stop()
        reg.close_engines()
        row["shutdown_s"] = time.perf_counter() - t1
    ranks = locks.load_lock_ranks()
    row["witness"] = {
        "violations": list(w.violations),
        "edges": sorted(list(e) for e in w.edges),
        "acquire_counts": dict(sorted(w.acquire_counts.items())),
        "never_acquired": sorted(set(ranks) - set(w.acquire_counts)),
        "dispatch_guard_peak_concurrency": w.peak_concurrency.get("engine.replica_dispatch_lock"),
        "peak_concurrency": dict(sorted(w.peak_concurrency.items())),
    }
    if w.violations:
        bad["violations"] = w.violations
    launches = row["kernel_launches"]
    if not (launches["preprocess_i420"] > 0 and launches["fused_dw"] > 0):
        bad["kernel_launches"] = launches
    row["ok"] = not bad
    emit(row)
    if bad:
        raise AssertionError(f"witness drive failed: {bad}")
    return row


def phase_witness() -> dict:
    """:func:`witness_drive` in a child process started with
    ``TWD_DEBUG_LOCKS=1`` (``chip_smoke.py --phase witness`` again, which
    finds the witness on): its line, read back and printed here."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--phase", "witness"],
                          env={**os.environ, "TWD_DEBUG_LOCKS": "1"}, stdout=subprocess.PIPE,
                          text=True, timeout=WITNESS_CHILD_TIMEOUT_S,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    rows = [json.loads(ln) for ln in proc.stdout.splitlines() if ln.startswith("{")]
    row = next((r for r in rows if r.get("phase") == "witness"), None)
    if proc.returncode != 0 or row is None or not row.get("ok"):
        print(proc.stdout[-4000:], flush=True)
        raise AssertionError(f"the witness child exited {proc.returncode}")
    row["child_s"] = time.perf_counter() - t0
    emit(row)
    return row


PROFILE_CASES = (("native:inception_v3", 8, "yuv420", "preprocess_i420"),
                 ("native:resnet50", 32, "rgb", "preprocess_ragged"))
PROFILE_CANVAS = 512
PROFILE_K = 16  # replays timed, and replays profiled
PROFILE_SUM_TOL = 0.10  # the table's summed device µs against the replay's


def phase_profile(jpegs: list[bytes]) -> dict:
    """The port's profiler entry points on the card.

    - ``tools/profile_serve.py`` (its :func:`profile_serve`, what the tool's
      ``main`` prints) on Inception-v3 bf16, batch 8, canvas 512, yuv420
      and ResNet-50 bf16, batch 32, canvas 512, ragged rgb: each table's
      summed device µs a batch within ``PROFILE_SUM_TOL`` of the same
      graph's replay ms (CUDA events) in this call, and the preprocess
      kernel under its own name; every kernel's row and the sums by kind
      are printed.
    - ``python -m tensorflow_web_deploy_tpu_torch.server --profile``
      (Inception-v3 bf16, yuv420, canvas 512, batch buckets 1–8): a capture
      on the listener's port while 16 JPEGs are served names the preprocess
      kernel, and the server exits 0 on SIGTERM."""
    from tensorflow_web_deploy_tpu_torch.serving.http import PROFILE_PORT
    from tensorflow_web_deploy_tpu_torch.tools import profile_serve as tool

    row = {"phase": "profile", "nvidia_smi": nvidia_smi(), "scan_batches": PROFILE_K,
           "canvas": PROFILE_CANVAS, "cases": []}
    bad: dict = {}
    zero_launches()
    for model, batch, wire, kernel in PROFILE_CASES:
        doc = tool.profile_serve(model, batch, PROFILE_CANVAS, wire, None, PROFILE_K)
        syms = KERNEL_SYMBOLS[kernel]
        own = [r for r in doc["rows"] if any(s in r["name"] for s in syms)]
        gap = (doc["replay_ms"] - doc["busy_ms"]) / doc["replay_ms"]
        case = {"model": model, "dtype": doc["dtype"], "batch": batch, "wire": wire,
                "ragged": doc["ragged"], "resize": doc["resize"], "wall_ms": doc["wall_ms"],
                "replay_ms": doc["replay_ms"], "busy_ms": doc["busy_ms"], "busy_gap": gap,
                "profiler_attempts": doc["profiler_attempts"],
                "kernels_per_batch": sum(r["count"] for r in doc["rows"]),
                "kernel": kernel, "kernel_rows": own, "by_kind": doc["by_kind"],
                "rows": [{**r, "name": r["name"][:160]} for r in doc["rows"]]}
        row["cases"].append(case)
        if abs(gap) > PROFILE_SUM_TOL or not own:
            bad[f"{model}:{batch}"] = {"busy_gap": gap, "kernel_rows": len(own)}
    row["kernel_launches"] = read_launches()
    with tempfile.TemporaryDirectory() as tmp, open(os.path.join(tmp, "server.log"), "w") as log:
        proc, port, boot_s = job_server_proc(
            ["--profile", "--model", "native:inception_v3", "--wire-format", "yuv420",
             "--resize", "kernel", "--canvas-buckets", "512", "--max-batch", "8",
             "--cache-bytes", "0"], log)
        try:
            got: dict = {}
            capture = threading.Thread(target=lambda: got.update(r=jobs_request(
                PROFILE_PORT, "POST", f"/debug/trace?ms=600&dir={tmp}/trace")), daemon=True)
            capture.start()
            time.sleep(0.1)
            served = fan_out(port, jpegs[:16], 4, "/predict")
            capture.join(120)
            status, doc, _ = got["r"]
            trace = kernels_in_trace(doc["trace_file"]) if status == 200 else {}
        finally:
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(120)
    row["cli"] = {"boot_s": boot_s, "listener_port": PROFILE_PORT, "status": status,
                  "activities": (doc or {}).get("activities"),
                  "served_200": sum(r["status"] == 200 for r in served),
                  "device_kernels": trace.get("device_kernels"),
                  "graph_launches": trace.get("graph_launches"),
                  "found": trace.get("found"), "exit_code": rc}
    if (status != 200 or not trace.get("found", {}).get("preprocess_i420") or rc != 0
            or row["cli"]["served_200"] != 16):
        bad["cli"] = row["cli"]
    row["ok"] = not bad
    emit(row)
    if bad:
        raise AssertionError(f"profile phase failed: {bad}")
    return row


def main(argv: list[str]) -> int:
    sweeps = ("--sweep-fused-dw", "--sweep-preprocess", "--sweep-overload", "--sweep-dag")
    replay_opts = dict(zip(argv[2::2], argv[3::2])) if argv[:2] == ["--phase", "replays"] else {}
    if replay_opts and (len(argv) % 2 or not set(replay_opts) <= {"--save", "--against"}):
        replay_opts = {"bad": None}
    if not (argv == [] or (len(argv) == 1 and argv[0] in sweeps)
            or (replay_opts and "bad" not in replay_opts)
            or (len(argv) == 2 and argv[0] == "--sweep-nms" and argv[1].endswith(".cu"))
            or argv in (["--phase", "ragged_preprocess"], ["--phase", "resnet50"],
                        ["--phase", "ssd"], ["--phase", "s2d_stem"], ["--phase", "replays"],
                        ["--phase", "converter"], ["--phase", "jobs"], ["--phase", "dag"],
                        ["--phase", "train"], ["--phase", "distributed"], ["--phase", "witness"],
                        ["--phase", "profile"])):
        print(f"usage: python3 chip_smoke.py [{' | '.join(sweeps)} | --sweep-nms OTHER.cu | "
              "--phase ragged_preprocess | --phase resnet50 | --phase s2d_stem | "
              "--phase replays [--save FILE] [--against FILE] | "
              "--phase ssd | --phase converter | --phase jobs | --phase dag | --phase train | "
              "--phase distributed | --phase witness | --phase profile], "
              f"not {argv}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from tensorflow_web_deploy_tpu_torch import native
    from tensorflow_web_deploy_tpu_torch.ops import _build
    from tensorflow_web_deploy_tpu_torch.serving import aotcache

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
    # through the kernel build cache in the checkout's .build/: a fresh
    # checkout misses and builds every library
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": {k: _build.library_path(k).name for k in KERNELS},
          "aot_cache": aotcache.stats(aotcache.AotCache(_build.BUILD_DIR)),
          "nvcc": _build.nvcc_release(), "native_decoder": decoder})

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
    if argv == ["--sweep-overload"]:
        sweep_overload()
        return 0
    if argv == ["--sweep-dag"]:
        sweep_dag()
        return 0
    if argv[:1] == ["--sweep-nms"]:
        sweep_nms(argv[1])
        return 0
    if argv == ["--phase", "ragged_preprocess"]:  # the phase alone, after the build
        phase_ragged_preprocess(make_jpegs(24, SEED))
        return 0
    if argv == ["--phase", "resnet50"]:
        phase_resnet50(make_jpegs(24, SEED))
        return 0
    if argv == ["--phase", "s2d_stem"]:
        phase_s2d_stem(gen)
        return 0
    if argv[:2] == ["--phase", "replays"]:
        phase_replays(replay_opts.get("--save"), replay_opts.get("--against"))
        return 0
    if argv == ["--phase", "ssd"]:
        phase_ssd(make_jpegs(24, SEED))
        return 0
    if argv == ["--phase", "converter"]:
        phase_converter(make_jpegs(24, SEED))
        return 0
    if argv == ["--phase", "jobs"]:
        phase_jobs(make_jpegs(24, SEED))
        return 0
    if argv == ["--phase", "dag"]:
        phase_dag(make_jpegs(24, SEED))
        return 0
    if argv == ["--phase", "train"]:
        phase_train(make_jpegs(24, SEED))
        return 0
    if argv == ["--phase", "distributed"]:
        phase_distributed(make_jpegs(24, SEED))
        return 0
    if argv == ["--phase", "witness"]:
        from tensorflow_web_deploy_tpu_torch.utils import locks

        # the child (TWD_DEBUG_LOCKS=1) drives; run alone, it starts one
        if locks.witness_active() is not None:
            witness_drive(make_jpegs(24, SEED))
        else:
            phase_witness()
        return 0
    if argv == ["--phase", "profile"]:
        phase_profile(make_jpegs(24, SEED))
        return 0
    kern_err = phase_kernel(gen)
    s2d = phase_s2d_stem(gen)
    dw = phase_fused_dw_kernel(gen, dw_layer_shapes())
    jpegs = make_jpegs(24, SEED)
    phase_native_decode(jpegs)
    unpack = phase_ragged_unpack(jpegs)
    ragged_pp = phase_ragged_preprocess(jpegs)
    graphs = phase_graphs(jpegs)
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
    phase_pipeline_depth(jpegs)
    phase_backlog(make_jpegs(48, SEED + 1))
    phase_default_server(jpegs)
    registry = phase_registry(jpegs)
    phase_sigterm(jpegs)
    overload = phase_overload(jpegs)
    observability = phase_observability(jpegs, graphs)
    placement = phase_placement(jpegs)
    resnet = phase_resnet50(jpegs)
    ssd = phase_ssd(jpegs)
    converter = phase_converter(jpegs)
    jobs = phase_jobs(jpegs)
    dag = phase_dag(jpegs)
    train = phase_train(jpegs)
    distributed = phase_distributed(jpegs)
    witness = phase_witness()
    profile = phase_profile(jpegs)
    by_path = {p["path"]: p["kernel_launches"] for p in (inception, mobilenet, *ragged)}
    by_path["registry"] = registry["kernel_launches"]
    by_path["overload"] = overload["kernel_launches"]
    by_path["observability"] = observability["kernel_launches"]
    by_path["placement"] = placement["kernel_launches"]
    by_path["resnet50"] = resnet["kernel_launches"]
    by_path["ssd"] = ssd["kernel_launches"]
    by_path["converter"] = converter["kernel_launches"]
    by_path["jobs"] = jobs["kernel_launches"]
    by_path["dag"] = dag["kernel_launches"]
    by_path["train"] = train["kernel_launches"]
    by_path["distributed"] = distributed["kernel_launches"]
    by_path["witness"] = witness["kernel_launches"]
    by_path["profile"] = profile["kernel_launches"]
    by_kernel = {name: {m: n.get(name, 0) for m, n in by_path.items()} for name in KERNELS}
    pp8 = next(r for r in ragged_pp["cases"] if (r["batch"], r["out"]) == (8, OUT))
    emit({"kernels": [{
        "name": "preprocess_i420",
        "route": "cuda",
        "source": "tensorflow_web_deploy_tpu_torch/csrc/preprocess_i420.cu",
        "replaces": "tensorflow_web_deploy_tpu/ops/pallas_preprocess.py:109",
        "launches": sum(by_kernel["preprocess_i420"].values()),
        "launches_by_path": by_kernel["preprocess_i420"],
        # float32 through both entries at every cell, and the main paths'
        # stages; their bf16 outputs are in the kernel and preprocess_stage
        # lines
        "max_abs_err": max(kern_err, stage299["max_abs_err"], stage224["max_abs_err"],
                           jobs["preprocess_256"]["max_abs_err"], s2d["cell_store_max_abs_err"]),
        # batch of 8 main-path images, 512 canvas, 299 out, bf16 from the
        # wire as the Inception path runs it; and at 224 out (MobileNetV2)
        "ms": stage299["ms"],
        "plain_ms": stage299["plain_ms"],
        "bound_ms": stage299["bound_ms"],
        "bound_by": stage299["bound_by"],
        "library_ms": None,
        # the main paths' stage stores the stem's cells (the handshake);
        # the NHWC store on the same batch, and the cell store bit for bit
        # against pack_s2d of it
        "s2d": stage299["s2d"],
        "ms_nhwc": stage299["ms_nhwc"],
        "bound_ms_nhwc": stage299["bound_ms_nhwc"],
        "cell_store_bit_identical_to_packed_nhwc": s2d["cell_store_bit_identical_to_packed_nhwc"],
        "cell_store_max_abs_err": s2d["cell_store_max_abs_err"],
        "ms_224": stage224["ms"],
        "plain_ms_224": stage224["plain_ms"],
        "bound_ms_224": stage224["bound_ms"],
        # the jobs path's bulk batch: 256 images, 512 canvas, 299 out, bf16
        "ms_256": jobs["preprocess_256"]["ms"],
        "plain_ms_256": jobs["preprocess_256"]["plain_ms"],
        "bound_ms_256": jobs["preprocess_256"]["bound_ms"],
        "max_abs_err_256": jobs["preprocess_256"]["max_abs_err"],
        "host_us": stage299["host_us"],
    }, {
        "name": "fused_dw",
        "route": "cuda",
        "source": "tensorflow_web_deploy_tpu_torch/csrc/fused_dw.cu",
        "replaces": "tensorflow_web_deploy_tpu/ops/pallas_depthwise.py:57",
        "launches": sum(by_kernel["fused_dw"].values()),
        "launches_by_path": by_kernel["fused_dw"],
        "max_abs_err": dw["max_abs_err"],
        "ms": dw["ms"],
        "plain_ms": dw["plain_ms"],
        "bound_ms": dw["bound_ms"],
        "bound_by": dw["bound_by"],
        # F.conv2d(groups=C) + bias in bf16 over the same 17 layers (at
        # stride 2 after F.pad by the reference's pads): the closest one
        # call; it leaves out the relu6 clamp
        "library_ms": dw["cudnn_ms"],
    }, {
        "name": "unpack_ragged",
        "route": "cuda",
        "source": "tensorflow_web_deploy_tpu_torch/csrc/unpack_ragged.cu",
        "replaces": "tensorflow_web_deploy_tpu/ops/image.py:107 (XLA work, a masked gather "
                    "with static shapes; not a Pallas kernel)",
        "launches": sum(by_kernel["unpack_ragged"].values()),
        "launches_by_path": by_kernel["unpack_ragged"],
        # bit-identical to its plain version and to pad_to_canvas
        "max_abs_err": 0.0,
        # batch of 8 main-path images, 512 canvas, full
        "ms": unpack["ms"],
        "plain_ms": unpack["plain_ms"],
        "bound_ms": unpack["bound_ms"],
        "bound_by": unpack["bound_by"],
        # no one PyTorch call rebuilds padded canvases from a ragged arena
        "library_ms": None,
        "host_us": unpack["host_us"],
    }, {
        "name": "preprocess_ragged",
        "route": "cuda",
        "source": "tensorflow_web_deploy_tpu_torch/csrc/preprocess_ragged.cu",
        "replaces": "tensorflow_web_deploy_tpu/ops/image.py:107 unpack_ragged, :251 "
                    "_bilinear_matrix, :267 resize_from_valid_mm and :446 make_preprocess_fn's "
                    "normalize (XLA work; not Pallas kernels)",
        "launches": sum(by_kernel["preprocess_ragged"].values()),
        "launches_by_path": by_kernel["preprocess_ragged"],
        # float32 against its plain version, every case, holes included;
        # bf16 within this many bf16 ulps
        "max_abs_err": ragged_pp["max_abs_err"],
        "bf16_max_ulps": ragged_pp["bf16_max_ulps"],
        # batch of 8 main-path images, 512 canvas, 299 out, bf16 (Inception-v3)
        "ms": pp8["ms"],
        "plain_ms": pp8["plain_ms"],
        "bound_ms": pp8["bound_ms"],
        "bound_by": pp8["bound_by"],
        # no one PyTorch call resizes from a ragged arena
        "library_ms": None,
        "host_us": pp8["host_us"],
        # the stage it replaced (unpack, matmul resize, normalize, cast)
        "stage_ms": pp8["stage_ms"],
        "stage_kernels": pp8["stage_kernels_per_call"],
        # batch 32: SSD's 300 inception and ResNet-50's 224 caffe
        "cases": [{k: r[k] for k in ("batch", "out", "mode", "ms", "stage_ms",
                                     "stage_kernels_per_call", "bound_ms", "plain_ms")}
                  for r in ragged_pp["cases"]],
    }, {
        "name": "nms_fixed",
        "route": "cuda",
        "source": "tensorflow_web_deploy_tpu_torch/csrc/nms_fixed.cu",
        "replaces": "tensorflow_web_deploy_tpu/ops/detection.py:71 (XLA work, a fixpoint "
                    "under lax.while_loop; not a Pallas kernel)",
        "launches": sum(by_kernel["nms_fixed"].values()),
        "launches_by_path": by_kernel["nms_fixed"],
        # the keep mask, bit for bit against the plain fixpoint
        "max_abs_err": 0.0,
        # a served batch of 32: 32 images × 90 classes × 100 candidates
        "ms": ssd["nms"]["ms"],
        "plain_ms": ssd["nms"]["plain_ms"],
        "bound_ms": ssd["nms"]["bound_ms"],
        "bound_by": ssd["nms"]["bound_by"],
        # no one PyTorch call computes a batched greedy NMS
        "library_ms": None,
        "host_us": ssd["nms"]["host_us"],
        # this run's µs at the other shapes: rows × candidates a row
        "us_by_rows_k": {f"{r['rows']}x{r['k']}": r["us"] for r in ssd["nms"]["by_k"]},
    }]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
