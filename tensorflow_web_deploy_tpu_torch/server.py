"""HTTP inference server on a mesh of CUDA devices (one card by default on the H100).

    python -m tensorflow_web_deploy_tpu_torch.server --model native:inception_v3 \\
        [--model inception_v3 | --model path/to/frozen.pb | --model config.json]
        [--model native:mobilenet_v2,dtype=int8,as=mobilenet_v2_int8 ...] [--default-model NAME]
        [--model native:mobilenet_v2,replicas=N | ,shard=batch] [--model native:resnet50]
        [--model native:ssd_mobilenet]    # detection: {"detections": [...], "num_detections": n}
        [--no-ragged] [--resize matmul|gather] [--wire-format yuv420 --resize kernel]
        [--dtype bf16|f32|int8] [--fused-dw auto|on|off] [--device cuda|cpu]
        [--pipeline-depth 4] [--max-queue 0] [--no-adaptive-delay] [--lease-timeout-s 10]
        [--http-workers 16] [--keepalive-timeout-s 15] [--aot-cache-dir DIR]
        [--cache-bytes 268435456] [--slo-classes interactive=1000,batch=10000]
        [--tenant-quota alice=50,*=100] [--tenant-burst-s 1]
        [--pressure-rungs 0.60:0.40,0.80:0.60,0.95:0.75] [--chaos SPEC]
        [--access-log PATH|-] [--flight-recorder-n 32] [--telemetry-interval 1]
        [--slo-objectives interactive=p99:1000ms:99.9]
    curl -X POST --data-binary @cat.jpg http://localhost:8500/predict?model=mobilenet_v2_int8
    curl -X POST -d '{"name": "inception_v3", "wait": true}' http://localhost:8500/models/swap
    curl http://localhost:8500/metrics       # also /debug/slow, /debug/history, /debug/events
    curl http://localhost:8500/debug/trace > trace.json   # chrome://tracing or Perfetto
    curl -X POST 'http://localhost:8500/debug/trace?ms=300&dir=/tmp/prof'   # torch.profiler
    kill -TERM <pid>    # drains every model and exits 0

Counterpart of the JAX package's root ``server.py``, with the flags this
port reads. ``--model`` takes the reference's presets (frozen graphs in
``artifacts/``: ``python -m tensorflow_web_deploy_tpu_torch.tools.
make_artifacts`` writes Inception-v3's and MobileNetV2's without
TensorFlow), a frozen ``.pb``, a ``.json`` config or ``native:<zoo name>``;
the default stays ``native:inception_v3``, which needs no file. Every
``--model`` becomes an entry of the model registry,
built and warmed at boot (a model that cannot load fails the boot);
``POST /models/{load,swap,unload}`` change them at run time. The mesh is
every visible CUDA device (``--device cuda``, the default) or the one
device named; a model's ``,replicas=N`` splits it into N groups, each with
a copy of the weights and streams of its own, and ``,shard=batch`` (the
default) serves on all of it as one group. One card is a 1-device mesh,
where ``replicas=N`` with N ≥ 2 fails the load. SIGTERM takes
the same drain path as Ctrl-C. :func:`start_server` runs the same stack
in-process (tests and ``chip_smoke.py`` use it).
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import signal
import sys
import threading

from .serving.engine import InferenceEngine
from .serving.http import App, make_http_server, shutdown_gracefully
from .serving.registry import ModelRegistry
from .utils.config import ServerConfig, model_config, normalize_dtype

log = logging.getLogger("tpu_serve_torch.server")


class Server:
    """A running registry (an engine and a batcher per model) behind the
    HTTP front end; ``close()`` drains and stops all.

    Every model of ``cfg.serve_models`` is built and warmed here, in order,
    and adopted as SERVING; the first that fails closes the ones built and
    raises. ``engine``, ``batcher`` and ``app`` are the default model's
    live handles."""

    def __init__(self, cfg: ServerConfig, device=None, seed: int = 0, mesh=None):
        self.cfg = cfg
        self.registry = ModelRegistry(cfg, default_model=cfg.default_name, device=device,
                                      seed=seed, mesh=mesh)
        try:
            for mc in cfg.serve_models:
                engine = InferenceEngine(dataclasses.replace(cfg, model=mc), device=device,
                                         seed=seed, mesh=mesh)
                try:
                    batcher = self.registry.build_batcher(engine)
                except BaseException:
                    engine.close()
                    raise
                self.registry.adopt(mc.serve_name, engine, batcher, mc)
            self.app = App(self.registry, cfg)
            self.httpd = make_http_server(
                self.app, cfg.host, cfg.port, pool_size=cfg.http_workers,
                keepalive_timeout_s=cfg.keepalive_timeout_s,
                request_read_timeout_s=cfg.request_timeout_s)
        except BaseException:
            self.registry.stop()
            self.registry.close_engines()
            raise
        self.port = self.httpd.server_address[1]
        self._thread = threading.Thread(target=self.httpd.serve_forever, name="http",
                                        daemon=True)
        self._thread.start()

    @property
    def engine(self):
        return self.app.engine

    @property
    def batcher(self):
        return self.app.batcher

    @property
    def url(self) -> str:
        host = "127.0.0.1" if self.cfg.host in ("0.0.0.0", "") else self.cfg.host
        return f"http://{host}:{self.port}"

    def wait(self) -> None:
        """Block until the HTTP server stops."""
        self._thread.join()

    def close(self, grace_s: float = 10.0) -> None:
        """The reference's drain order: stop accepting, stop the registry
        (every batcher dispatches what it holds and resolves every future),
        half-close the pool's connections and join its workers, close the
        socket, then close every engine."""
        shutdown_gracefully(self.httpd, self.registry, grace_s)
        self._thread.join(grace_s)
        self.registry.close_engines()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def start_server(cfg: ServerConfig, device=None, seed: int = 0, mesh=None) -> Server:
    return Server(cfg, device=device, seed=seed, mesh=mesh)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", action="append", default=None,
                   help="preset name, native:<zoo name> (TF-free zoo models), .pb path, "
                        "or .json model config (presets: inception_v3, mobilenet_v2, "
                        "resnet50, ssd_mobilenet — frozen graphs under artifacts/, written "
                        "by python -m tensorflow_web_deploy_tpu_torch.tools.make_artifacts). "
                        "Repeatable: each --model becomes a registry entry served at "
                        "/predict?model=<name>. Optional suffixes: ,replicas=N|,shard=batch "
                        "(placement over the mesh), ,dtype=… and ,as=<serve name> "
                        "(default: native:inception_v3)")
    p.add_argument("--default-model", default=None,
                   help="serve name that /predict without ?model= resolves to "
                        "(default: the first --model)")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8500)
    p.add_argument("--max-batch", type=int, default=32)
    p.add_argument("--max-delay-ms", type=float, default=2.0,
                   help="cap on the batch-assembly window; the live window adapts to the "
                        "backlog unless --no-adaptive-delay")
    p.add_argument("--no-adaptive-delay", action="store_true",
                   help="pin the batch window at --max-delay-ms")
    p.add_argument("--lease-timeout-s", type=float, default=10.0,
                   help="a leased batch slot whose decode never commits becomes a hole "
                        "after this long")
    p.add_argument("--pipeline-depth", type=int, default=4,
                   help="batches in flight per canvas bucket (sealed → launched → "
                        "unfetched); >= 2 overlaps decode of batch N+1 with execute of N")
    p.add_argument("--max-queue", type=int, default=0,
                   help="backlog in images at which a request is answered 503 with "
                        "Retry-After at once (0: leasing blocks at the slot cap instead)")
    p.add_argument("--http-workers", type=int, default=16,
                   help="HTTP worker pool size (each owns one keep-alive connection at a "
                        "time)")
    p.add_argument("--keepalive-timeout-s", type=float, default=15.0,
                   help="how long an idle keep-alive connection may hold a worker")
    p.add_argument("--canvas-buckets", default=None,
                   help="comma-separated canvas sides, e.g. 256,512")
    p.add_argument("--wire-format", choices=["rgb", "yuv420"], default="rgb")
    p.add_argument("--ragged", action=argparse.BooleanOptionalAction, default=True,
                   help="ragged wire (default on): ship tight decoded pixels in one byte "
                        "arena per batch and rebuild the canvases on the device (rgb wire "
                        "only; --wire-format yuv420 serves the classic wire). --no-ragged "
                        "ships host-padded canvases")
    p.add_argument("--resize", choices=["matmul", "gather", "kernel"], default="matmul",
                   help="on-device resize: matmul (default), gather (the taps read by "
                        "index), or kernel, the fused I420 CUDA preprocess (yuv420 wire "
                        "only)")
    p.add_argument("--dtype", default=None,
                   help="bf16 (default), f32, or int8 (int8 kernels, bf16 compute), for "
                        "every --model")
    p.add_argument("--fused-dw", choices=["auto", "on", "off"], default=None,
                   help="fused depthwise cells; auto (default) fuses the int8 tier")
    p.add_argument("--device", default="cuda",
                   help="cuda (default: a mesh of every visible card), cuda:N, or cpu")
    p.add_argument("--seed", type=int, default=0, help="seed of the weights")
    p.add_argument("--labels", default=None, help="label file, one label per line")
    p.add_argument("--zoo-width", type=float, default=None)
    p.add_argument("--zoo-classes", type=int, default=None)
    p.add_argument("--topk", type=int, default=None)
    p.add_argument("--aot-cache-dir", default=None, metavar="DIR",
                   help="kernel build cache: warmup loads the verified kernel libraries "
                        "built before from this directory instead of running nvcc "
                        "(default: the package's .build/); '0' or empty disables")
    p.add_argument("--cache-bytes", type=int, default=256 << 20,
                   help="byte budget of the content-addressed response cache (decoded-pixel "
                        "digest keys, single-flight dedup of concurrent identical requests, "
                        "entries dropped when their version retires); 0 disables")
    p.add_argument("--slo-classes", default="interactive=1000,batch=10000",
                   metavar="NAME=MS,...",
                   help="SLO class -> default deadline in ms; a request picks a class with "
                        "?slo= or X-SLO and may tighten it with X-Deadline-Ms / ?deadline_ms=")
    p.add_argument("--tenant-quota", default="", metavar="TENANT=RATE,...",
                   help="per-tenant admission quotas in images/s keyed by X-Tenant ('*' sets "
                        "the default for unlisted tenants; empty/0 = unlimited); 429 past it")
    p.add_argument("--tenant-burst-s", type=float, default=1.0,
                   help="token-bucket depth in seconds of quota")
    p.add_argument("--pressure-rungs", default="0.60:0.40,0.80:0.60,0.95:0.75",
                   metavar="ENTER:EXIT,...",
                   help="degradation-ladder thresholds as queue fractions. 3 rungs (the "
                        "default): 1 clamps topk, 2 takes the smallest canvas bucket, 3 sheds "
                        "cache-miss work. 4 rungs: rung 3 instead reroutes to a loaded int8 "
                        "variant of the same model (,dtype=int8,as=…) and rung 4 sheds")
    p.add_argument("--chaos", default=os.environ.get("TWD_CHAOS") or None, metavar="SPEC",
                   help="fault-injection spec for drills, e.g. 'decode_fail=0.05,"
                        "dispatch_fail=0.02,slow_replica=0.1:50,seed=7' (default: $TWD_CHAOS)")
    p.add_argument("--access-log", default=None, metavar="PATH",
                   help="structured JSON access log, one line per request (trace id, "
                        "per-stage timings, status); '-' for stderr")
    p.add_argument("--flight-recorder-n", type=int, default=32,
                   help="span breakdowns kept for the N slowest and N most recent erroring "
                        "requests (GET /debug/slow)")
    p.add_argument("--telemetry-interval", type=float, default=1.0, metavar="S",
                   help="in-process telemetry sampler interval (seconds): history rings "
                        "behind /debug/history + /debug/events and the SLO burn-rate "
                        "evaluator; 0 disables the subsystem")
    p.add_argument("--slo-objectives", default="", metavar="NAME=pXX:MS:PCT,...",
                   help="SLO objectives as burn-rate alerts, e.g. 'interactive=p99:1000ms:99.9' "
                        "- evaluated over 1m/5m fast + 30m slow windows, exposed as "
                        "tpu_serve_slo_burn_rate gauges and alert state")
    p.add_argument("--no-warmup", action="store_true",
                   help="capture no CUDA graphs: every batch runs eagerly")
    p.add_argument("--log-level", default="INFO")
    return p.parse_args(argv)


def config_from_args(args: argparse.Namespace) -> ServerConfig:
    """The ServerConfig of the CLI: one ModelConfig per ``--model`` (the
    default one as ``model``). ``--labels``/``--zoo-width``/``--zoo-classes``
    apply to exactly one model; with several, a .json config per model
    carries them."""
    specs = args.model or ["native:inception_v3"]
    single = {"labels_path": args.labels, "zoo_width": args.zoo_width,
              "zoo_classes": args.zoo_classes}
    if len(specs) > 1 and any(v is not None for v in single.values()):
        raise ValueError("--labels/--zoo-width/--zoo-classes apply to exactly one model; with "
                         "repeated --model flags use .json model configs to carry per-model "
                         "settings")
    every = {"topk": args.topk, "fused_dw": args.fused_dw,
             "dtype": normalize_dtype(args.dtype) if args.dtype else None}
    overrides = {k: v for k, v in {**single, **every}.items() if v is not None}
    mcs = [dataclasses.replace(model_config(spec), **overrides) for spec in specs]
    default = args.default_model or mcs[0].serve_name
    kw = {}
    if args.canvas_buckets:
        kw["canvas_buckets"] = tuple(int(s) for s in args.canvas_buckets.split(","))
    return ServerConfig(
        model=next((m for m in mcs if m.serve_name == default), mcs[0]), models=tuple(mcs),
        default_model=default, host=args.host, port=args.port, max_batch=args.max_batch,
        max_delay_ms=args.max_delay_ms, adaptive_delay=not args.no_adaptive_delay,
        pipeline_depth=args.pipeline_depth, max_queue=args.max_queue,
        lease_timeout_s=args.lease_timeout_s, http_workers=args.http_workers,
        keepalive_timeout_s=args.keepalive_timeout_s, wire_format=args.wire_format,
        resize=args.resize, ragged=args.ragged, warmup=not args.no_warmup,
        aot_cache_dir=args.aot_cache_dir, cache_bytes=args.cache_bytes,
        slo_classes=args.slo_classes, tenant_quota=args.tenant_quota,
        tenant_burst_s=args.tenant_burst_s, pressure_rungs=args.pressure_rungs,
        chaos=args.chaos, access_log=args.access_log, flight_recorder_n=args.flight_recorder_n,
        telemetry_interval_s=args.telemetry_interval, slo_objectives=args.slo_objectives, **kw,
    )


def main(argv=None) -> int:
    args = parse_args(argv)
    logging.basicConfig(level=args.log_level,
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    cfg = config_from_args(args)
    srv = start_server(cfg, device=args.device, seed=args.seed)
    eng = srv.engine
    for mv in srv.registry.serving_entries():
        log.info("placement %s: %s", mv.ref, mv.engine.placement_summary())
    log.info("listening on %s (%s; default %s, %d-device mesh from %s, %s wire%s, %s decode)",
             srv.url, ", ".join(m.serve_name for m in cfg.serve_models), cfg.default_name,
             len(eng.mesh), eng.device, cfg.wire_format, ", ragged" if eng.ragged else "",
             "native" if eng.decoder["available"] else "PIL")

    # Orchestrators stop containers with SIGTERM: the same drain path as
    # Ctrl-C. Single-shot: a second signal takes the default action (an
    # immediate kill) instead of interrupting the drain.
    def _sigterm(signum, frame):
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _sigterm)
    try:
        srv.wait()
    except KeyboardInterrupt:
        log.info("draining")
    finally:
        srv.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
