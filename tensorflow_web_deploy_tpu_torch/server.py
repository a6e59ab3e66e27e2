"""HTTP inference server on one CUDA device.

    python -m tensorflow_web_deploy_tpu_torch.server --model native:inception_v3 \\
        [--no-ragged] [--resize matmul|gather] [--wire-format yuv420 --resize kernel]
        [--dtype bf16|f32|int8] [--fused-dw auto|on|off] [--device cuda|cpu]
        [--pipeline-depth 4] [--max-queue 0] [--no-adaptive-delay] [--lease-timeout-s 10]
        [--aot-cache-dir DIR]
    curl -X POST --data-binary @cat.jpg http://localhost:8500/predict

Counterpart of the JAX package's root ``server.py``, with the flags this
port reads. :func:`start_server` runs the same stack in-process (tests and
``chip_smoke.py`` use it).
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import threading

from .serving.batcher import Batcher
from .serving.engine import InferenceEngine
from .serving.http import App, make_http_server
from .utils.config import ServerConfig, model_config

log = logging.getLogger("tpu_serve_torch.server")


class Server:
    """A running engine + batcher + HTTP server; ``close()`` stops all."""

    def __init__(self, cfg: ServerConfig, device=None, seed: int = 0):
        self.cfg = cfg
        self.engine = InferenceEngine(cfg, device=device, seed=seed)
        try:
            self.batcher = Batcher(
                self.engine, cfg.max_batch, cfg.max_delay_ms,
                pipeline_depth=cfg.pipeline_depth, adaptive_delay=cfg.adaptive_delay,
                max_queue=cfg.max_queue, lease_timeout_s=cfg.lease_timeout_s,
            ).start(warmup=cfg.warmup)
            self.app = App(self.engine, self.batcher, cfg)
            self.httpd = make_http_server(self.app, cfg.host, cfg.port)
        except BaseException:
            self.engine.close()
            raise
        self.port = self.httpd.server_address[1]
        self._thread = threading.Thread(target=self.httpd.serve_forever, name="http",
                                        daemon=True)
        self._thread.start()

    @property
    def url(self) -> str:
        host = "127.0.0.1" if self.cfg.host in ("0.0.0.0", "") else self.cfg.host
        return f"http://{host}:{self.port}"

    def wait(self) -> None:
        """Block until the HTTP server stops."""
        self._thread.join()

    def close(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self._thread.join(10)
        self.batcher.stop()
        self.engine.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def start_server(cfg: ServerConfig, device=None, seed: int = 0) -> Server:
    return Server(cfg, device=device, seed=seed)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", default="native:inception_v3",
                   help="native:<zoo name> or a .json ModelConfig")
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
                   help="bf16 (default), f32, or int8 (int8 kernels, bf16 compute)")
    p.add_argument("--fused-dw", choices=["auto", "on", "off"], default=None,
                   help="fused depthwise cells; auto (default) fuses the int8 tier")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--seed", type=int, default=0, help="seed of the weights")
    p.add_argument("--labels", default=None, help="label file, one label per line")
    p.add_argument("--zoo-width", type=float, default=None)
    p.add_argument("--zoo-classes", type=int, default=None)
    p.add_argument("--topk", type=int, default=None)
    p.add_argument("--aot-cache-dir", default=None, metavar="DIR",
                   help="kernel build cache: warmup loads the verified kernel libraries "
                        "built before from this directory instead of running nvcc "
                        "(default: the package's .build/); '0' or empty disables")
    p.add_argument("--no-warmup", action="store_true",
                   help="capture no CUDA graphs: every batch runs eagerly")
    p.add_argument("--log-level", default="INFO")
    return p.parse_args(argv)


def config_from_args(args: argparse.Namespace) -> ServerConfig:
    mc = model_config(args.model)
    overrides = {
        "dtype": args.dtype, "labels_path": args.labels, "zoo_width": args.zoo_width,
        "zoo_classes": args.zoo_classes, "topk": args.topk, "fused_dw": args.fused_dw,
    }
    mc = dataclasses.replace(mc, **{k: v for k, v in overrides.items() if v is not None})
    kw = {}
    if args.canvas_buckets:
        kw["canvas_buckets"] = tuple(int(s) for s in args.canvas_buckets.split(","))
    return ServerConfig(
        model=mc, host=args.host, port=args.port, max_batch=args.max_batch,
        max_delay_ms=args.max_delay_ms, adaptive_delay=not args.no_adaptive_delay,
        pipeline_depth=args.pipeline_depth, max_queue=args.max_queue,
        lease_timeout_s=args.lease_timeout_s, wire_format=args.wire_format, resize=args.resize,
        ragged=args.ragged, warmup=not args.no_warmup, aot_cache_dir=args.aot_cache_dir, **kw,
    )


def main(argv=None) -> None:
    args = parse_args(argv)
    logging.basicConfig(level=args.log_level,
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    cfg = config_from_args(args)
    srv = start_server(cfg, device=args.device, seed=args.seed)
    log.info("listening on %s (%s, %s, %s wire%s, %s decode)", srv.url, cfg.model.name,
             srv.engine.device, cfg.wire_format, ", ragged" if srv.engine.ragged else "",
             "native" if srv.engine.decoder["available"] else "PIL")
    try:
        srv.wait()
    except KeyboardInterrupt:
        pass
    finally:
        srv.close()


if __name__ == "__main__":
    main()
