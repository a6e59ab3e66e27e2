"""Model and server configuration (counterpart of the JAX package's
``utils/config.py``), reduced to the fields this port reads.

A model is a zoo model (``source="native"``, the default) or a frozen
graph (``source="pb"``, ``pb_path``); a config that gives a ``pb_path``
and no ``source`` is a frozen graph. A ``.json`` file without ``source``
means ``"pb"``, as in the reference, so one without ``pb_path`` either is
refused. ``--model`` resolves the reference's
four presets (frozen graphs under ``artifacts/``, written without
TensorFlow by ``tools/make_artifacts.py``), ``native:<zoo name>``, a bare
``.pb`` path or a ``.json`` config (:func:`model_config`).

``resize="kernel"`` is the port's name for the JAX ``resize="pallas"``:
the fused I420 preprocess runs on the hand-written CUDA kernel
(``ops/preprocess_i420.py``). The validation rules are the reference's.
``--model`` specs take the reference's ``,replicas=N``/``,shard=batch``,
``,dtype=`` and ``,as=`` suffixes (:func:`split_model_spec`).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

# Accepted --dtype / ModelConfig.dtype spellings → canonical form.
_DTYPE_ALIASES = {
    "f32": "float32", "float32": "float32",
    "bf16": "bfloat16", "bfloat16": "bfloat16",
    "int8": "int8",
}

_ARTIFACTS = Path(__file__).resolve().parent.parent.parent / "artifacts"


def normalize_dtype(dtype: str) -> str:
    """Canonicalize a serving dtype; raise ValueError on anything else."""
    try:
        return _DTYPE_ALIASES[str(dtype).strip().lower()]
    except KeyError:
        raise ValueError(
            f"unsupported dtype {dtype!r} (supported: f32/float32, bf16/bfloat16, int8)"
        ) from None


@dataclasses.dataclass
class ModelConfig:
    """One model to serve: a zoo model or a frozen graph."""

    name: str
    pb_path: str | None = None
    # "native" serves the zoo (models/), "pb" converts the frozen GraphDef
    # at pb_path (graphdef/); None resolves to "pb" when pb_path is given,
    # else "native"
    source: str | None = None
    # width multiplier + class count (tiny variants for tests; 1.0/None =
    # the real architecture)
    zoo_width: float = 1.0
    zoo_classes: int | None = None
    # serving export from tools/train.py (a directory holding the params
    # and batch stats, train/checkpoint.py) — serve fine-tuned weights
    # instead of the seeded init
    ckpt_path: str | None = None
    # "classify" (softmax top-k per image) or "detect" (decoded boxes
    # through static-shape NMS: boxes, scores, classes, num)
    task: str = "classify"
    labels_path: str | None = None
    input_name: str | None = None  # default: the graph's sole placeholder
    # the model's outputs by name (None: the zoo model's own, or a graph's
    # inferred sinks; a detector gives raw_boxes, raw_scores, anchors)
    output_names: list[str] | None = None
    input_size: tuple[int, int] = (299, 299)
    # normalization applied on the device: "inception" ([-1, 1]),
    # "zero_one" (/255), "caffe" (BGR, mean-subtracted), "raw"
    preprocess: str = "inception"
    topk: int = 5
    # "float32" (the reference), "bfloat16" (weights and activations cast,
    # the default as in the JAX package) or "int8" (per-output-channel
    # int8 kernels dequantized on every call, computing in bf16; gated at
    # build by the engine's parity check against float32)
    dtype: str = "bfloat16"
    # Fused depthwise cells (ops/depthwise.py): "auto" fuses the int8 tier
    # only, "on"/"off" force it
    fused_dw: str = "auto"
    # Registry serve name (GET /models, /predict?model=...): ``name`` unless
    # set, via --model ...,as=<serve name>, so that two dtype variants of one
    # architecture can serve side by side
    alias: str | None = None
    # Per-model pipeline overrides (None: the server-wide values): batches
    # in flight per canvas bucket, and the backlog in images at which a
    # lease fails fast with 503; the registry reads them when it builds the
    # model's batcher
    pipeline_depth: int | None = None
    max_queue: int | None = None
    # Device placement (serving/placement.py): None shards each batch over
    # the whole mesh, "replicas=N" splits the mesh into N groups, each with
    # a full copy of the weights and its own dispatch streams, "shard=batch"
    # spells the default. On the CLI a --model suffix: native:mobilenet_v2,replicas=4
    placement: str | None = None

    def __post_init__(self):
        if self.source is None:
            self.source = "pb" if self.pb_path else "native"
        if self.source not in ("native", "pb"):
            raise ValueError(
                f"model '{self.name}': source must be 'native' or 'pb', got {self.source!r}")
        if self.source == "pb" and not self.pb_path:
            raise ValueError(
                f"model '{self.name}': source='pb' requires pb_path "
                "(or use source='native' for the flax zoo)"
            )
        try:
            self.dtype = normalize_dtype(self.dtype)
        except ValueError as e:
            raise ValueError(f"model '{self.name}': {e}") from None
        if self.fused_dw not in ("auto", "on", "off"):
            raise ValueError(
                f"model '{self.name}': fused_dw must be 'auto', 'on' or 'off', "
                f"got {self.fused_dw!r}"
            )
        if self.task not in ("classify", "detect"):
            raise ValueError(
                f"model '{self.name}': task must be 'classify' or 'detect', got {self.task!r}"
            )
        self.input_size = tuple(self.input_size)

    @property
    def serve_name(self) -> str:
        """The registry/HTTP-facing name (``alias`` wins over ``name``)."""
        return self.alias or self.name

    @property
    def fuse_depthwise(self) -> bool:
        """The resolved ``fused_dw`` knob: "auto" fuses the int8 tier of a
        zoo model; a frozen graph has no depthwise cells to fuse."""
        return self.source == "native" and (
            self.fused_dw == "on" or (self.fused_dw == "auto" and self.dtype == "int8"))


@dataclasses.dataclass
class ServerConfig:
    model: ModelConfig
    host: str = "0.0.0.0"
    port: int = 8500
    # dynamic batcher: a canvas bucket's open batch seals at max_batch
    # images or when its assembly window ends; max_delay_ms caps the
    # window, which adapts to the backlog unless adaptive_delay is off
    max_batch: int = 32
    max_delay_ms: float = 2.0
    adaptive_delay: bool = True
    # batches in flight per canvas bucket (sealed → launched → unfetched)
    pipeline_depth: int = 4
    # backlog in images at which a lease fails fast with 503 + Retry-After;
    # 0: leasing blocks at the outstanding-slot cap instead
    max_queue: int = 0
    # a leased slot not committed within this many seconds becomes a hole
    lease_timeout_s: float = 10.0
    # how long a request waits for its batch (503/504 past it), and the
    # HTTP front end's total read deadline for one request (408 past it)
    request_timeout_s: float = 30.0
    # Model-registry drain window: after a hot swap (or unload) the retired
    # version waits this long for its in-flight requests before its batcher
    # is stopped anyway
    drain_grace_s: float = 30.0
    # HTTP front end: a bounded pool of workers speaking HTTP/1.1 keep-alive;
    # keepalive_timeout_s is how long an idle connection may hold a worker
    http_workers: int = 16
    keepalive_timeout_s: float = 15.0
    # Pinned staging slabs the engine keeps idle per (wire kind, canvas side),
    # and the byte budget of every idle slab together: past it the slabs of
    # the least recently used shapes are dropped first (slabs in flight are
    # never counted)
    staging_slabs: int = 6
    staging_pool_bytes: int = 256 << 20
    # /predict and admin body cap in MB of 10^6 bytes: a larger upload gets
    # 413 before its body is read
    max_body_mb: float = 32.0
    # Every model the server boots (empty: ``model`` alone), and the serve
    # name that requests without ``?model=`` resolve to (None: ``model``'s)
    models: tuple[ModelConfig, ...] = ()
    default_model: str | None = None
    # canvas size buckets for host-padded decoded images; the device
    # resizes from each image's valid region
    canvas_buckets: tuple[int, ...] = (256, 512, 1024, 2048)
    # Host→device canvas encoding: "rgb" (uint8 HWC) or "yuv420" (packed
    # I420, 1.5 B/px).
    wire_format: str = "rgb"
    # On-device resize: "matmul" (separable bilinear as torch.matmul),
    # "gather" (the same taps read by index) or "kernel" (the fused I420
    # CUDA kernel; yuv420 wire only).
    resize: str = "matmul"
    # Ragged wire: each image ships tight (h·w·3 bytes, no canvas padding)
    # in one flat byte arena per batch, and the device rebuilds the canvases
    # before the resize. rgb wire only: the engine serves yuv420 on the
    # classic wire and logs a warning. Off here as in the reference's
    # dataclass; the server's CLI turns it on by default.
    ragged: bool = False
    warmup: bool = True
    # The kernel build cache (serving/aotcache.py): None keeps the kernel
    # libraries in tensorflow_web_deploy_tpu_torch/.build/; "0" or empty
    # disables it, as in the reference (each process builds with nvcc into
    # a temporary directory); any other value names the directory.
    aot_cache_dir: str | None = None
    # Response cache (serving/respcache.py): byte budget of the
    # content-addressed LRU with single-flight dedup; 0 (the dataclass
    # default, as in the reference) disables it. The CLI's default is 256 MiB.
    cache_bytes: int = 0
    # Overload control (serving/overload.py): SLO class → default deadline
    # in ms (a request names its class with ?slo= or X-SLO and may tighten
    # it with X-Deadline-Ms / ?deadline_ms=)
    slo_classes: str = "interactive=1000,batch=10000"
    # per-tenant token buckets in images/s keyed by X-Tenant ("*": unlisted
    # tenants; empty or 0: unlimited), their depth in seconds of quota, and
    # the tracked-tenant cap past which unknown tenants share "~other"
    tenant_quota: str = ""
    tenant_burst_s: float = 1.0
    tenant_max_tracked: int = 64
    # the degradation ladder: enter:exit queue fractions per rung (three:
    # clamp topk, smallest canvas, shed cache misses; four put the int8
    # reroute before the shedding) and the least seconds between moves
    pressure_rungs: str = "0.60:0.40,0.80:0.60,0.95:0.75"
    pressure_dwell_s: float = 0.5
    # fault-injection spec for drills (serving/chaos.py); None: off
    chaos: str | None = None
    # Observability (utils/metrics.py): the flight recorder keeps the span
    # breakdown of the N slowest and N most recent erroring requests
    # (GET /debug/slow), and a recent-requests ring for GET /debug/trace of
    # at most this many spans and approximate bytes, whichever binds first
    flight_recorder_n: int = 32
    flight_recorder_recent_n: int = 512
    flight_recorder_bytes: int = 4 << 20
    # JSON access log, one line per request: None off, "-" the
    # tpu_serve.access logger, else a file to append to
    access_log: str | None = None
    # Telemetry history (serving/telemetry.py): the sampler's interval in
    # seconds (0 turns the subsystem off), and SLO objectives
    # "name=pXX:THRESHOLD:TARGET_PCT,..." evaluated as multi-window burn rates
    telemetry_interval_s: float = 1.0
    slo_objectives: str = ""
    # Pipeline DAGs (serving/dag.py, POST /pipelines/<name>): each an inline
    # chain "name=detector@int8>classifier" or the path of a JSON pipeline
    # file; a spec that cannot run (grammar, cycle, arity, a stage model or
    # dtype that does not resolve) fails the boot
    pipelines: tuple[str, ...] = ()
    # stage-1 detections a request's crop batch takes (the batch runs at the
    # classifier's batch bucket covering it); also the stage-1 cache key's
    # top-k slot
    pipeline_max_crops: int = 8
    # Bulk offline jobs (serving/jobs.py, POST /jobs): the directory where
    # manifests, spooled uploads, results and checkpoints persist across
    # restarts; None turns /jobs off (the CLI's --jobs-dir)
    jobs_dir: str | None = None
    # the bulk batch target, clamped to the engine's top batch bucket (so
    # 256 needs max_batch 256)
    jobs_batch: int = 256
    # bulk batches in flight at once: how much device time a job may hold
    # while interactive traffic shares the card (the batcher's bulk gate)
    jobs_max_inflight: int = 2
    # a ready bulk batch gated this long by interactive load is admitted
    # once, then the clock re-arms: jobs slow down under load, never stop
    jobs_starvation_s: float = 2.0
    # the largest manifest a job may have (a larger one is refused with 400)
    jobs_max_items: int = 100_000
    # decode threads that stage a chunk (0: min(4, CPU count))
    jobs_decode_threads: int = 0

    def __post_init__(self):
        # pick_bucket relies on ascending order
        self.canvas_buckets = tuple(sorted(set(self.canvas_buckets)))
        self.models = tuple(self.models)
        self.pipelines = tuple(self.pipelines)
        names = [m.serve_name for m in self.serve_models]
        dup = sorted({n for n in names if names.count(n) > 1})
        if dup:
            raise ValueError(f"duplicate model names {dup}")
        if self.default_name not in names:
            raise ValueError(
                f"default model {self.default_name!r} is not among the models {names}")
        if self.wire_format not in ("rgb", "yuv420"):
            raise ValueError(f"wire_format must be 'rgb' or 'yuv420', got {self.wire_format!r}")
        if self.resize not in ("matmul", "gather", "kernel"):
            raise ValueError(
                f"resize must be 'matmul', 'gather' or 'kernel', got {self.resize!r}")
        if self.resize == "kernel":
            if self.wire_format != "yuv420":
                raise ValueError("resize='kernel' requires wire_format='yuv420'")
            for m in self.serve_models:
                if m.preprocess not in ("inception", "zero_one", "raw"):
                    raise ValueError(
                        "resize='kernel' supports preprocess inception/zero_one/raw, "
                        f"not {m.preprocess!r}"
                    )
        if self.wire_format == "yuv420":
            bad = [s for s in self.canvas_buckets if s % 4]
            if bad:
                raise ValueError(
                    f"yuv420 wire format needs canvas buckets divisible by 4; got {bad}"
                )

    @property
    def serve_models(self) -> tuple[ModelConfig, ...]:
        return self.models or (self.model,)

    @property
    def default_name(self) -> str:
        return self.default_model or self.model.serve_name


def _preset(name: str, **kw) -> ModelConfig:
    kw.setdefault("pb_path", str(_ARTIFACTS / f"{name}.pb"))
    kw.setdefault("labels_path", str(_ARTIFACTS / "imagenet_labels.txt"))
    return ModelConfig(name=name, source="pb", **kw)


# The reference's presets: the tracked configs' frozen graphs.
PRESETS: dict[str, ModelConfig] = {
    "inception_v3": _preset("inception_v3", input_size=(299, 299), preprocess="inception"),
    "mobilenet_v2": _preset("mobilenet_v2", input_size=(224, 224), preprocess="inception"),
    "resnet50": _preset("resnet50", input_size=(224, 224), preprocess="caffe"),
    "ssd_mobilenet": _preset(
        "ssd_mobilenet",
        task="detect",
        input_size=(300, 300),
        preprocess="inception",
        labels_path=str(_ARTIFACTS / "coco_labels.txt"),
        # freezing wraps the named outputs in anonymous Identity nodes, so
        # the detect branch asks for them by name
        output_names=["raw_boxes", "raw_scores", "anchors"],
    ),
}


def split_model_spec(spec: str) -> tuple[str, dict[str, str]]:
    """Split ``--model``'s option suffixes off a model spec:
    ``"mobilenet_v2,replicas=8"`` → ``("mobilenet_v2", {"placement":
    "replicas=8"})``; ``"native:mobilenet_v2,dtype=int8,as=mobilenet_v2_int8"``
    → the base plus ``{"dtype": "int8", "alias": "mobilenet_v2_int8"}``.
    Raises ValueError on an unknown suffix key, two placements or a bad
    dtype — a typo must not silently serve the defaults."""
    base, _, rest = spec.partition(",")
    opts: dict[str, str] = {}
    if not rest:
        return base, opts
    for t in [t.strip() for t in rest.split(",") if t.strip()]:
        key, _, val = t.partition("=")
        if key in ("replicas", "shard"):
            if "placement" in opts:
                raise ValueError(
                    f"conflicting placement options in {spec!r}: "
                    f"{opts['placement']!r} and {t!r}"
                )
            opts["placement"] = t
        elif key == "dtype":
            opts["dtype"] = normalize_dtype(val)
        elif key == "as":
            if not val:
                raise ValueError(f"empty serve name in {t!r} in {spec!r}")
            opts["alias"] = val
        else:
            raise ValueError(
                f"unknown --model option {t!r} in {spec!r} "
                "(supported: replicas=N, shard=batch, dtype=int8|bf16|f32, "
                "as=<serve name>)"
            )
    return base, opts


def model_config(name_or_path: str) -> ModelConfig:
    """Resolve a preset name, ``native:<zoo name>``, a JSON config path, or a
    bare .pb path — each optionally carrying option suffixes
    (``name,replicas=N`` / ``name,dtype=int8`` / ``name,as=<serve name>``)."""
    name_or_path, opts = split_model_spec(name_or_path)
    if opts:
        mc = model_config(name_or_path)
        mc.placement = opts.get("placement", mc.placement)
        mc.dtype = opts.get("dtype", mc.dtype)
        mc.alias = opts.get("alias", mc.alias)
        return mc
    if name_or_path.startswith("native:"):
        from ..models import get as zoo_get, names as zoo_names

        try:
            spec = zoo_get(name_or_path[len("native:"):])
        except KeyError:
            raise ValueError(
                f"unknown native model '{name_or_path}' — have "
                + ", ".join(f"native:{n}" for n in zoo_names())
            ) from None
        return ModelConfig(
            name=spec.name,
            source="native",
            task=spec.task,
            input_size=(spec.input_size, spec.input_size),
            preprocess=spec.preprocess,
            labels_path=str(
                _ARTIFACTS / ("coco_labels.txt" if spec.task == "detect" else "imagenet_labels.txt")
            ),
        )
    if name_or_path in PRESETS:
        return dataclasses.replace(PRESETS[name_or_path])
    p = Path(name_or_path)
    if p.suffix == ".json":
        data = json.loads(p.read_text())
        data["input_size"] = tuple(data.get("input_size", (299, 299)))
        # a file names its source, as in the reference, where it defaults
        # to "pb": without source or pb_path the file is refused
        data.setdefault("source", "pb")
        return ModelConfig(**data)
    if p.suffix == ".pb":
        return ModelConfig(name=p.stem, pb_path=str(p))
    raise ValueError(
        f"unknown model '{name_or_path}' — expected one of {sorted(PRESETS)}, "
        "native:<zoo name>, a .json config, or a .pb path"
    )
