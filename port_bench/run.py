#!/usr/bin/env python3
"""One run of one cell of the benchmark of the PyTorch/CUDA port.

    python3 port_bench/run.py --workload inception_v3-f32.batch32-c16 \\
        --seed 12345 --seconds 30 --trace 0

From the root of a checkout: makes the weights and the photos from
``--seed``, starts the program's server (``tensorflow_web_deploy_tpu_torch``)
in a child process with the cell's configuration and those weights, waits
until it serves, warms every client's connection, then drives the window
from client processes of its own (a closed loop of calls made before the
window) for ``--seconds``. After the window it reads the server's
``/stats`` and ``/metrics``, stops the server, runs the plain reference
over every photo, compares every answer, and prints one JSON line: the
cell's end-to-end metrics (``--trace 0``) or its per-layer metrics, read
from a ``torch.profiler`` capture of a steady slice of the window in the
server's process (``--trace 1``; a capture whose trace names another
process than this run's server is not read). Earlier stdout lines give the
parts of the set-up; an earlier stderr line gives each span stage's mean
over the window; the last stderr lines give each number compared beside
its limit.

Exits non-zero without a result when no CUDA card is visible (or fewer
than the cell asks for), when the program is not in the checkout, or when
JAX, flax or the JAX package was imported into this process.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import shutil  # noqa: E402
import signal  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import threading  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))

from yardstick import cells, costs, judge, loadgen, photos, weights  # noqa: E402
from yardstick.server import ServerProcess  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "tensorflow_web_deploy_tpu"}
PROFILE_PORT = 9999  # the program's --profile listener
BOOT_TIMEOUT_S = 1100.0  # the first run in a checkout builds the kernels
# The capture: where in the window it starts, and how long it lasts. The
# first capture in a process stalls serving for seconds (the profiler's
# one-time start), so a traced run makes a short one during set-up.
TRACE_AT, TRACE_MAX_MS, TRACE_WARM_MS = 0.4, 1500, 50


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    :data:`FORBIDDEN`, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)


def look_for_cards(chips: int) -> dict:
    """The ``device`` block; exits non-zero when fewer cards are visible.
    Creates no CUDA context."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"needs {chips} CUDA card(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        raise SystemExit(2)
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips}


def power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


def stages_in_window(stats0: dict, stats1: dict) -> dict:
    """Each span stage's mean ms a request over the window (from the
    server's stage totals), for the record of where a run's host time
    went."""
    st0, st1 = stats0["tracing"]["stages"], stats1["tracing"]["stages"]
    return {k: (v["total_ms"] - st0.get(k, {}).get("total_ms", 0.0)) / n
            for k, v in st1.items() if (n := v["count"] - st0.get(k, {}).get("count", 0)) > 0}


def capture(seconds: float, out_dir: Path, ms: int, result: dict) -> None:
    """POST /debug/trace to the server's profiler listener after
    ``seconds``; the answer (the trace's path) into ``result``."""
    time.sleep(seconds)
    client = loadgen.HttpClient("127.0.0.1", PROFILE_PORT, timeout=120.0)
    try:
        status, body = client.request("POST", f"/debug/trace?ms={ms}&dir={out_dir}",
                                      retry=False)
        result.update(json.loads(body) if status == 200 else {"error": status})
    except OSError as e:
        result["error"] = str(e)
    finally:
        client.close()


def run(cell: cells.Cell, seed: int, seconds: float, trace: bool, device: dict | None) -> dict:
    """One run of ``cell``; returns the result line's object. Without
    ``device``, looks for the cards while the server boots."""
    cfg, tf = cell.config, cell.traffic
    tmp = Path(tempfile.mkdtemp(prefix="port_bench-"))
    parts, server = {}, None
    try:
        t = time.perf_counter()
        parts["process_start_s"] = t - T_START
        params = weights.make_weights(cfg["arch"], seed, cfg["weights"], cfg["width"],
                                      cfg["classes"])
        weights.write_export(str(tmp / "export"), params, cfg["classes"])
        parts["weights_s"] = time.perf_counter() - t
        t_boot = time.perf_counter()
        args = [*cfg["server_args"], "--ckpt", str(tmp / "export")]
        server = ServerProcess(args + (["--profile"] if trace else []), tmp / "server.log")
        if device is None:
            device = look_for_cards(cell.chips)
        t = time.perf_counter()
        pool = photos.make_pool(tf, seed)
        call_photos = photos.make_calls(tf, seed)
        bodies = [photos.body([pool[i].jpeg for i in c]) for c in call_photos]
        parts["photos_s"] = time.perf_counter() - t
        server.wait_ready(BOOT_TIMEOUT_S)
        parts["server_boot_s"] = time.perf_counter() - t_boot
        boot_stats = server.get_json("/stats")
        parts["server_warmup_s"] = boot_stats["engine"]["warmup_s"]
        parts["server_load_s"] = boot_stats["engine"]["load_s"]
        if trace:
            t = time.perf_counter()
            capture(0.0, tmp / "trace-warm", TRACE_WARM_MS, {})
            parts["profiler_warm_s"] = time.perf_counter() - t

        snap = {}
        shot = {}

        def before_window():
            snap["stats0"] = server.get_json("/stats")
            snap["prom0"] = cells.parse_prometheus(server.get_text("/metrics"))
            if trace:
                ms = int(min(TRACE_MAX_MS, 0.3 * seconds * 1e3))
                snap["capture"] = threading.Thread(
                    target=capture, args=(TRACE_AT * seconds, tmp / "trace", ms, shot), daemon=True)
                snap["capture"].start()

        t = time.perf_counter()
        window = loadgen.closed_loop("127.0.0.1", server.port, tf["path"], bodies,
                                     tf["clients"], seconds, tf["warmup_calls"],
                                     before_window=before_window)
        parts["warmup_calls_s"] = window.t0 - t
        setup_s = window.t0 - T_START
        if trace:  # the capture ends (and its trace is written) before the reads
            snap["capture"].join(120.0)
        stats1 = server.get_json("/stats")
        server_pid = server.proc.pid
        prom1 = cells.parse_prometheus(server.get_text("/metrics"))
        device = {**device, "memory_peak_bytes":
                  int(stats1["engine"]["graphs"]["memory_reserved"] or 0)}
        server.stop()
        server = None
        print(json.dumps({"setup_parts": parts, "setup_s": setup_s, "card": power_limit()}),
              flush=True)
        log(json.dumps({"stages_ms": stages_in_window(snap["stats0"], stats1)}))

        # the window's answers against the plain reference
        from yardstick import reference

        k = cfg["topk"]
        ids, idx, scores, malformed = judge.served_answers(window.calls, call_photos, k)
        t = time.perf_counter()
        ref = reference.probabilities(cfg["arch"], params, [p.jpeg for p in pool],
                                      width=cfg["width"], classes=cfg["classes"],
                                      mode=cfg["preprocess"], device=cfg["device"])
        numbers = judge.gaps(ids, idx, scores, ref)
        failed = sum(not c.ok for c in window.calls)
        numbers.update(failed_calls=failed, malformed=malformed)
        table = judge.checks(numbers, {"failed_calls": 0, "malformed": 0, **cfg["correct"]})
        log(json.dumps({"reference_s": time.perf_counter() - t, "answers": int(len(ids)),
                        "score_gap": numbers["score_gap"], "rank_gap": numbers["rank_gap"],
                        "first_error": next((c.error or c.status for c in window.calls
                                             if not c.ok), None)}))

        per_call = [len(c) for c in call_photos]
        answered = window.photos_answered(per_call)
        breakdown = None
        if not trace:
            p95 = loadgen.percentile(window.latencies_ms(), 95)
            values = {"img_per_s": answered / window.seconds,
                      "p95_ms": p95 if p95 is not None and math.isfinite(p95) else None,
                      "setup_s": setup_s}
            metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                       for m in cell.end_to_end}
        else:
            from yardstick import trace as traces

            tr = traces.read_trace(shot["trace_file"]) if "trace_file" in shot else None
            if tr is not None and tr.host_pids != {server_pid}:
                # another process's profiler listener took the capture
                log(f"the trace is of process(es) {sorted(tr.host_pids)}, not of this run's "
                    f"server ({server_pid}): not read")
                tr = None
            sent = [i for c in window.calls if c.ok and c.t_done <= window.t1
                    for i in call_photos[c.body]]
            ctx = cells.Context(
                cell=cell, window_s=window.seconds, photos_answered=answered,
                latencies_ms=window.latencies_ms(),
                stats0=snap["stats0"], stats1=stats1, prom0=snap["prom0"], prom1=prom1,
                trace=tr, flops_per_image=costs.flops_per_image(cfg["arch"], cfg["width"],
                                                                cfg["classes"]),
                peak=costs.PEAKS.get(device["kind"]),
                valid_bytes_per_photo=(sum(pool[i].h * pool[i].w * 3 for i in sent) / len(sent)
                                       if sent else 0.0),
                out_hw=(cfg["input_size"], cfg["input_size"]))
            metrics = {}
            for m in cell.per_layer:
                v = cell.readers[m["name"]](ctx)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
            if tr is None:
                log(f"no trace: {shot}")
            else:
                if tr.busy_us > 0:
                    device["busy_s"] = tr.busy_us / 1e6
                    device["window_s"] = tr.window_us / 1e6
                breakdown = {"device_ops": traces.top(tr.ops_us),
                             "idle_gaps": traces.top(tr.gaps_us)}
        result = {"correct": judge.passed(table), "attempted": len(window.calls),
                  "failed": failed, "metrics": metrics, "device": device}
        if breakdown is not None:
            result["breakdown"] = breakdown
        result["checks"] = table  # last: each number compared beside its limit
        return result
    finally:
        if server is not None:
            log(server.log_tail())
            server.stop()
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None, device: dict | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    # the driver ends a run with SIGTERM: stop the server on the way out
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    cell = cells.load_cell(args.workload)
    result = run(cell, args.seed, args.seconds, bool(args.trace), device)
    found = forbidden_modules()
    if found:
        log(f"the process imported {', '.join(found)}: no result")
        return 3
    for name, c in result["checks"].items():
        log(f"{name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
