"""Kernel-level profile of the serving hot path (the port's counterpart of
the JAX package's ``tools/profile_serve.py``).

Builds an ``InferenceEngine`` for one model, canvas bucket and batch, lets
its warmup capture the CUDA graph of that (canvas, batch) bucket, runs one
batch of seeded images through it (so the graph's static input holds real
images), then replays the graph ``--scan-batches`` times back to back and
``--scan-batches`` times more under ``torch.profiler`` with CUDA activity.
It prints wall ms a batch (host clock), the replay's ms a batch (CUDA
events) and device-busy ms a batch (the kernels' summed device time), then
the kernels ranked by device µs a batch, with their launches a batch and
their kind (conv/gemm, activation, cat, pool, cast, the preprocess, ...).

    python -m tensorflow_web_deploy_tpu_torch.tools.profile_serve \\
        --model native:inception_v3 --batch 8 --canvas 512 --wire yuv420
    python -m tensorflow_web_deploy_tpu_torch.tools.profile_serve \\
        --model native:resnet50 --batch 32 --canvas 512        # ragged rgb
    python -m tensorflow_web_deploy_tpu_torch.tools.profile_serve --server http://host:8500

``--wire rgb`` is the server's default ragged rgb wire; ``--wire yuv420``
the classic yuv420 wire, whose preprocess is the hand-written
``preprocess_i420`` kernel unless ``--resize`` says otherwise. ``--server``
builds no engine: it reads a live server's request-span aggregates
(``/stats → tracing``) and its economics block and prints the stage table,
with no profiler attached and no traffic interrupted. ``--device cpu`` runs
the engine on the CPU, where there is no graph: the table then ranks CPU
ops by self time, and says so.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import tempfile
import time
import urllib.parse
import urllib.request

import numpy as np

# (kind, pattern on the kernel or op name), first match wins
KINDS = (
    ("preprocess", re.compile(r"preprocess_i420|preprocess_ragged|unpack_words|unpack_bytes")),
    ("depthwise", re.compile(r"fused_dw")),
    ("nms", re.compile(r"nms_fixed")),
    ("avg_pool", re.compile(r"avg_pool|avgpool", re.I)),
    ("max_pool", re.compile(r"max_pool|maxpool", re.I)),
    ("cat", re.compile(r"CatArray|aten::cat\b|\bcat_", re.I)),
    ("softmax", re.compile(r"softmax", re.I)),
    ("topk", re.compile(r"topk|sort|radix|bitonic", re.I)),
    # cuDNN's convs, and the cuBLAS GEMMs (nvjet) it lowers 1 × 1 convs to
    ("conv/gemm", re.compile(r"conv|xmma|implicit_gemm|fprop|cudnn|cutlass|gemm|nvjet|"
                             r"aten::linear|aten::addmm|aten::mm\b", re.I)),
    ("activation", re.compile(r"clamp|threshold|relu|hardtanh|sigmoid", re.I)),
    ("bias/add", re.compile(r"Add|add_|aten::add|CUDAFunctor_add|mul|Mul", re.I)),
    ("cast/copy", re.compile(r"copy|cast|to_copy|direct_copy", re.I)),
)


def kind_of(name: str) -> str:
    """The kind of a kernel (or CPU op) by its name, ``other`` when no
    pattern of :data:`KINDS` matches."""
    for kind, pat in KINDS:
        if pat.search(name):
            return kind
    return "other"


def make_engine(model: str, batch: int, canvas: int, wire: str, resize: str | None,
                device: str):
    """A warmed engine serving ``model`` on one canvas bucket with batch
    buckets up to ``batch`` (its graph of (canvas, batch) captured)."""
    from ..serving.engine import InferenceEngine
    from ..utils.config import ServerConfig, model_config

    if resize is None:
        resize = "kernel" if wire == "yuv420" else "matmul"
    mc = model_config(model)
    cfg = ServerConfig(model=mc, models=(mc,), canvas_buckets=(canvas,), max_batch=batch,
                       wire_format=wire, resize=resize, ragged=wire == "rgb", cache_bytes=0)
    eng = InferenceEngine(cfg, device=device)
    try:
        eng.warmup()
    except BaseException:
        eng.close()
        raise
    return eng


def load_batch(eng, batch: int, canvas: int, seed: int = 0) -> None:
    """One batch of ``batch`` seeded images (each side in [canvas/2,
    canvas]) through the engine, as a replay of its graph: the graph's
    static input then holds these images."""
    rng = np.random.RandomState(seed)
    hws = rng.randint(canvas // 2, canvas + 1, size=(batch, 2)).astype(np.int32)
    images = [rng.randint(0, 256, (h, w, 3), dtype=np.uint8) for h, w in hws]
    if eng.ragged:
        eng.run_ragged(images, hws, canvas)
    else:
        prepared = [eng.prepare(im) for im in images]
        eng.run_batch(np.stack([c for c, _ in prepared]),
                      np.array([hw for _, hw in prepared], np.int32))


def capture(eng, batch: int, canvas: int, k: int, trace_dir: str | None = None,
            attempts: int = 3) -> dict:
    """Replays of the engine's (canvas, batch) executable: ``k`` timed ones
    (wall ms a batch on the host clock, and on the card the replay's ms a
    batch from CUDA events), then ``k`` under ``torch.profiler``. The
    profiler drops a short window's device events now and then: a window
    with none is taken again, up to ``attempts`` times. Returns the timings
    and the profiler's ``key_averages()``; the Chrome trace goes into
    ``trace_dir`` when one is given."""
    import contextlib

    import torch
    from torch.profiler import ProfilerActivity, profile

    rep = eng._replicas[0]
    shard = rep.shards[0]
    kind = "ragged" if eng.ragged else "classic"
    exe = shard.exes[(kind, canvas, batch // eng.batch_multiple)]
    cuda = shard.device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    with rep.lock, torch.cuda.stream(shard.compute) if cuda else contextlib.nullcontext():
        exe()
        sync()
        t0 = time.perf_counter()
        if cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
        for _ in range(k):
            exe()
        if cuda:
            end.record()
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3 / k
        replay_ms = start.elapsed_time(end) / k if cuda else None
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        for attempt in range(1, attempts + 1):
            with profile(activities=activities) as prof:
                for _ in range(k):
                    exe()
                sync()
            events = prof.key_averages()
            if not cuda or any(e.self_device_time_total > 0 for e in events):
                break
        else:
            raise RuntimeError(f"the profiler recorded no device events in {attempts} windows")
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
    return {"wall_ms": wall_ms, "replay_ms": replay_ms, "events": events, "device": cuda,
            "attempts": attempt}


def op_table(events, k: int, device: bool, top: int | None = None) -> tuple[float, list[dict]]:
    """(busy ms a batch, rows): on the card the kernels (CUDA self time),
    on the CPU the ops (CPU self time), ranked by µs a batch, each with its
    launches (calls) a batch and its kind."""
    from torch.autograd import DeviceType

    rows = []
    for e in events:
        if device:
            if e.device_type != DeviceType.CUDA or e.self_device_time_total <= 0:
                continue
            us = e.self_device_time_total
        else:
            if e.self_cpu_time_total <= 0:
                continue
            us = e.self_cpu_time_total
        rows.append({"name": e.key, "kind": kind_of(e.key), "us": us / k, "count": e.count / k})
    rows.sort(key=lambda r: -r["us"])
    busy_ms = sum(r["us"] for r in rows) / 1e3
    return busy_ms, rows[:top] if top else rows


def by_kind(rows: list[dict]) -> dict[str, dict]:
    """µs and launches a batch summed by kind, largest first."""
    out: dict[str, dict] = {}
    for r in rows:
        d = out.setdefault(r["kind"], {"us": 0.0, "count": 0.0})
        d["us"] += r["us"]
        d["count"] += r["count"]
    return dict(sorted(out.items(), key=lambda kv: -kv[1]["us"]))


def profile_serve(model: str, batch: int, canvas: int, wire: str, resize: str | None, k: int,
                  device: str = "cuda", trace_dir: str | None = None) -> dict:
    """The whole profile of one configuration: timings, busy ms a batch,
    every kernel's row (ranked) and the rows by kind."""
    eng = make_engine(model, batch, canvas, wire, resize, device)
    try:
        load_batch(eng, batch, canvas)
        cap = capture(eng, batch, canvas, k, trace_dir)
        busy_ms, rows = op_table(cap["events"], k, cap["device"])
        return {"model": model, "dtype": eng.model_cfg.dtype, "batch": batch, "canvas": canvas,
                "wire": wire, "ragged": eng.ragged, "resize": eng.cfg.resize, "scan_batches": k,
                "device": str(eng.device), "on_device": cap["device"],
                "wall_ms": cap["wall_ms"], "replay_ms": cap["replay_ms"], "busy_ms": busy_ms,
                "profiler_attempts": cap["attempts"], "rows": rows, "by_kind": by_kind(rows)}
    finally:
        eng.close()


def format_profile(doc: dict, top: int) -> str:
    lines = [f"# {doc['model']} ({doc['dtype']}) batch={doc['batch']} canvas={doc['canvas']} "
             f"wire={doc['wire']}{' ragged' if doc['ragged'] else ''} resize={doc['resize']} "
             f"scan_k={doc['scan_batches']} device={doc['device']}"]
    replay = (f"   replay: {doc['replay_ms']:.3f} ms/batch (CUDA events)"
              if doc["replay_ms"] is not None else "")
    what = "device busy" if doc["on_device"] else "CPU busy (self time of CPU ops)"
    lines.append(f"wall: {doc['wall_ms']:.3f} ms/batch{replay}   {what}: "
                 f"{doc['busy_ms']:.3f} ms/batch")
    if not doc["on_device"]:
        lines.append("(CPU ops: no CUDA device on this run, so no kernel table; "
                     "run on the card for device kernels)")
    lines.append(f"{'us/batch':>10}  {'per batch':>9}  {'kind':<11} name")
    for r in doc["rows"][:top]:
        lines.append(f"{r['us']:10.2f}  {r['count']:9.2f}  {r['kind']:<11} {r['name'][:100]}")
    lines.append("\nby kind:")
    for kind, d in doc["by_kind"].items():
        lines.append(f"{d['us']:10.2f}  {d['count']:9.2f}  {kind}")
    return "\n".join(lines)


# ---------------------------------------------- a live server's stage table
# The port's own copies of the JAX package's tools/loadgen.py formatters.


def fetch_stats(url: str, timeout: float = 5.0) -> dict | None:
    """GET the server's full ``/stats`` document (host derived from the
    target URL), or None when the server is unreachable or isn't ours."""
    u = urllib.parse.urlsplit(url)
    stats_url = f"http://{u.hostname or '127.0.0.1'}:{u.port or 80}/stats"
    try:
        with urllib.request.urlopen(stats_url, timeout=timeout) as r:
            return json.load(r)
    except Exception:
        return None


def stage_attribution(before: dict | None, after: dict | None) -> dict:
    """Diff two ``/stats`` tracing snapshots into per-stage count /
    total_ms / mean_ms over the window between them (``before=None``:
    everything since the server started). The end-to-end aggregate rides
    along under ``_e2e``."""
    if not after:
        return {}
    out = {}
    b_stages = (before or {}).get("stages", {})
    for name, s in after.get("stages", {}).items():
        prev = b_stages.get(name, {})
        c = s.get("count", 0) - prev.get("count", 0)
        t = s.get("total_ms", 0.0) - prev.get("total_ms", 0.0)
        if c > 0:
            out[name] = {"count": c, "total_ms": round(t, 3), "mean_ms": round(t / c, 3)}
    eb = (before or {}).get("e2e", {})
    ea = after.get("e2e", {})
    ec = ea.get("count", 0) - eb.get("count", 0)
    et = ea.get("total_ms", 0.0) - eb.get("total_ms", 0.0)
    if ec > 0:
        out["_e2e"] = {"count": ec, "total_ms": round(et, 3), "mean_ms": round(et / ec, 3)}
    return out


def format_stage_table(attr: dict, wall_s: float | None = None) -> str:
    """Where server-side request time went, by stage, with each stage's
    share of end-to-end time (and, with ``wall_s``, its utilization)."""
    if not attr:
        return "(no server-side stage data)"
    e2e = attr.get("_e2e")
    hdr = f"{'stage':<16} {'count':>8} {'mean_ms':>9} {'total_ms':>11}"
    hdr += "  share" if e2e else ""
    hdr += "   util" if wall_s else ""
    lines = [hdr]
    stages = sorted(((k, v) for k, v in attr.items() if k != "_e2e"),
                    key=lambda kv: -kv[1]["total_ms"])
    for name, s in stages:
        row = f"{name:<16} {s['count']:>8} {s['mean_ms']:>9.2f} {s['total_ms']:>11.1f}"
        if e2e and e2e["total_ms"] > 0:
            row += f"  {100.0 * s['total_ms'] / e2e['total_ms']:5.1f}%"
        if wall_s:
            row += f"  {100.0 * s['total_ms'] / 1e3 / wall_s:5.1f}%"
        lines.append(row)
    if e2e:
        lines.append(f"{'(end-to-end)':<16} {e2e['count']:>8} {e2e['mean_ms']:>9.2f} "
                     f"{e2e['total_ms']:>11.1f}")
    return "\n".join(lines)


def format_econ_table(econ: dict | None) -> str:
    """The roofline table of ``/stats → economics``: per (model, replica,
    canvas, batch bucket) cell, MFU, arithmetic intensity, the binding
    roofline side and the fraction of it reached, and padding waste."""
    if not econ:
        return "(no economics block — engine without econ counters?)"
    lines = []
    for ref, e in econ.items():
        head = [ref]
        mc = e.get("model_cost")
        if mc:
            head.append(f"{mc['flops_per_image'] / 1e9:.2f} GFLOP/img")
            head.append(f"{mc['param_bytes'] / 1e6:.1f} MB params")
        peak = e.get("peak")
        if peak:
            head.append(f"peak {peak['flops_per_chip'] / 1e12:.3f} TFLOP/s/chip "
                        f"({peak['source']})")
        if e.get("mfu") is not None:
            head.append(f"MFU {e['mfu']:.2%}")
        if e.get("padded_rows_fraction") is not None:
            head.append(f"padded rows {e['padded_rows_fraction']:.1%}")
        lines.append("  ".join(head))
        pad_by = {(p["canvas"], p["batch_bucket"]): p for p in (e.get("padding") or {}).values()}
        cells = [(rep, c) for rep in e.get("replicas", []) for c in rep.get("buckets", [])]
        if cells:
            lines.append(f"  {'repl':>4} {'canvas':>6} {'batch':>5} {'mfu':>7} "
                         f"{'AI':>7} {'bound':>9} {'of-roof':>7} {'padrow':>6} "
                         f"{'padpx':>6} {'dev_s':>8}")
        for rep, c in cells:
            p = pad_by.get((c["canvas"], c["batch_bucket"]), {})
            mfu = c.get("mfu")
            ai = c.get("arithmetic_intensity")
            bf = c.get("roofline_bound_fraction")
            padpx = p.get("padded_px_fraction")
            mfu_s = "-" if mfu is None else f"{mfu:.2%}"
            ai_s = "-" if ai is None else f"{ai:.1f}"
            bf_s = "-" if bf is None else f"{bf:.1%}"
            padpx_s = "-" if padpx is None else f"{padpx:.1%}"
            lines.append(f"  {rep['replica']:>4} {c['canvas']:>6} "
                         f"{c['batch_bucket']:>5} {mfu_s:>7} {ai_s:>7} "
                         f"{c.get('bound', '-'):>9} {bf_s:>7} "
                         f"{c['padded_rows_fraction']:>6.1%} {padpx_s:>6} "
                         f"{c['device_s']:>8.2f}")
    return "\n".join(lines)


def server_stage_table(base_url: str) -> int:
    """Print a live server's stage attribution and its economics table,
    both from ``/stats``."""
    stats = fetch_stats(base_url.rstrip("/") + "/predict")
    if stats is None:
        print(f"could not fetch /stats from {base_url}", file=sys.stderr)
        return 1
    tracing = stats.get("tracing")
    attr = stage_attribution(None, tracing)
    print(f"# {base_url} — request-span stage attribution (since server start)")
    print(format_stage_table(attr))
    by_status = (tracing or {}).get("requests_by_status", {})
    if by_status:
        print("requests by status: " + ", ".join(f"{k}={v}" for k, v in sorted(by_status.items())))
    print("\n# device economics (live /stats 'economics' block)")
    print(format_econ_table(stats.get("economics")))
    return 0


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--server", default=None, metavar="URL",
                   help="read a live server's /stats span aggregates and print its "
                        "stage-attribution table (no local engine)")
    p.add_argument("--model", default="native:inception_v3")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--canvas", type=int, default=512)
    p.add_argument("--wire", default="yuv420", choices=["rgb", "yuv420"],
                   help="rgb: the ragged rgb wire; yuv420: the classic yuv420 wire")
    p.add_argument("--resize", default=None, choices=["matmul", "gather", "kernel"],
                   help="default: kernel on yuv420 (preprocess_i420), matmul on rgb "
                        "(preprocess_ragged)")
    p.add_argument("--scan-batches", type=int, default=16,
                   help="replays timed, and replays profiled")
    p.add_argument("--top", type=int, default=25)
    p.add_argument("--trace-dir", default=None, help="keep the Chrome trace here")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    if args.server:
        return server_stage_table(args.server)
    trace_dir = args.trace_dir or tempfile.mkdtemp(prefix="serve_trace_")
    doc = profile_serve(args.model, args.batch, args.canvas, args.wire, args.resize,
                        args.scan_batches, args.device, trace_dir)
    print(format_profile(doc, args.top))
    print(f"\ntrace kept at: {trace_dir}" if args.trace_dir else
          f"\n(trace in {trace_dir}; pass --trace-dir to keep it elsewhere)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
