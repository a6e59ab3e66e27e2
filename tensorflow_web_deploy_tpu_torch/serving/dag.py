"""Pipeline DAGs: a composition of models served as one request whose
intermediates stay on the device (counterpart of the JAX package's
``serving/dag.py``).

A detect → crop → classify composition would otherwise cost the client two
round trips with a host crop and re-encode between them. Here:

- **Spec.** ``--pipeline name=detector@int8>classifier@f32`` (or the path
  of a JSON file, :func:`load_pipeline_file`) parses into a
  :class:`PipelineSpec`, a chain of :class:`StageSpec`. Grammar errors,
  cycles and arity mismatches (fan-in, fan-out) are refused at parse; the
  stages' models, dtypes, tasks and wires against the registry at boot
  (:meth:`PipelineCatalog.register`), and again after every hot swap of a
  stage model (the registry's serving and retire listeners mark the
  pipeline dirty; it re-resolves on its next read).
- **Execution** (:meth:`PipelineCatalog.execute`). The detector runs one
  image on the classic wire with its outputs kept on the device
  (``InferenceEngine.dispatch_batch(keep_on_device=True)``); the glue
  (``ops/dag_glue.py``) crops and resizes its boxes out of the canvas the
  detector was shipped, on the device; the classifier dispatches that crop
  batch as it is (``dispatch_device``). Only image 0's detector rows (a few
  KB) and the classifier's top-k cross to the host; the detector's padded
  bucket never does (``release_dispatch``).
- **Caching** is per stage: stage 1 keys on the image digest as
  ``/predict`` does, stage 2 on :func:`~.respcache.stage_input_digest`
  (the image's digest and stage 1's answer) and its own serving version,
  so a classifier swap re-keys stage 2 only and a cached detection feeds
  the new classifier: never a stale composite.

Three hazards of the port's CUDA-graph engine, and what it does about each
(``serving/engine.py``): (a) a graph's static output is overwritten by the
next replay of its executable, so the detector's rows are copied on the
device inside the replica's enqueue window, and that copy is what the glue
reads; (b) the crops are made on the request thread's stream and read on
the classifier's compute stream, so that stream waits for an event
recorded after them and ``record_stream`` keeps the allocator off them
until the replay has read them; (c) the stage engines serve the ragged
wire, while a pipeline dispatches on the classic wire, so warmup also
captures the classic executables a pipeline uses (``dag_pairs``).

The catalog's lock guards its status and stats dicts only, never a wait.
The registry's listeners take it under the registry's lock; catalog reads
that need the registry gather what they need before taking it, never the
reverse.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from collections import deque

import numpy as np
import torch

from ..ops import dag_glue
from ..utils.config import normalize_dtype
from .jobs import clamp_topk, format_result_row
from .registry import ModelNotServing, UnknownModel
from .respcache import CacheRetired, canvas_digest, make_key, payload_etag, stage_input_digest

log = logging.getLogger("tpu_serve_torch.dag")

# Stage-1 detections one crop batch takes: eight covers the per-image keeps
# at the default NMS thresholds while the crop batch stays a small bucket.
DEFAULT_MAX_CROPS = 8

# The task chains the executor can glue: detect → classify, whose glue (boxes
# → crops) exists. The parser takes any chain, so a spec for another chain
# fails validation with a task-chain error, not a syntax error.
_SUPPORTED_CHAINS = {("detect", "classify")}


class PipelineSpecError(ValueError):
    """A pipeline spec that can never run: bad grammar, a cycle, an arity
    mismatch, an unknown stage model or dtype. Raised at parse or at boot
    validation: the server refuses to start on one."""


class PipelineUnavailable(RuntimeError):
    """The pipeline exists but cannot run now (a stage model is draining or
    failed, or serves another dtype than the spec pins). HTTP 503."""


class StageSpec:
    """One node of the chain: a model name and an optional pinned serving
    dtype (None: whatever tier serves)."""

    __slots__ = ("model", "dtype")

    def __init__(self, model: str, dtype: str | None = None):
        model = model.strip()
        if not model:
            raise PipelineSpecError("pipeline stage has an empty model name")
        if dtype is not None:
            try:
                dtype = normalize_dtype(dtype)
            except ValueError as e:
                raise PipelineSpecError(f"stage '{model}': {e}") from None
        self.model = model
        self.dtype = dtype

    @property
    def ref(self) -> str:
        return self.model if self.dtype is None else f"{self.model}@{self.dtype}"

    def to_dict(self) -> dict:
        return {"model": self.model, "dtype": self.dtype}


class PipelineSpec:
    """A validated chain of stages under one name."""

    __slots__ = ("name", "stages")

    def __init__(self, name: str, stages: list[StageSpec]):
        name = name.strip()
        if not name or not name.replace("-", "").replace("_", "").isalnum():
            raise PipelineSpecError(f"pipeline name {name!r} must be non-empty [a-zA-Z0-9_-]")
        if len(stages) < 2:
            raise PipelineSpecError(
                f"pipeline '{name}': a pipeline needs at least 2 stages "
                "(one model is just /predict)")
        self.name = name
        self.stages = list(stages)

    @property
    def ref(self) -> str:
        return f"{self.name}=" + ">".join(s.ref for s in self.stages)

    def to_dict(self) -> dict:
        return {"name": self.name, "stages": [s.to_dict() for s in self.stages]}


def parse_pipeline_spec(text: str) -> PipelineSpec:
    """``name=detect@int8>classify@f32`` → :class:`PipelineSpec`. The ``>``
    chain gives every stage exactly one upstream; ``@dtype`` pins a stage's
    serving tier."""
    text = text.strip()
    name, sep, chain = text.partition("=")
    if not sep:
        raise PipelineSpecError(
            f"pipeline spec {text!r}: expected name=stage>stage "
            "(e.g. detect_pipeline=detector@int8>classifier)")
    stages = []
    for tok in chain.split(">"):
        tok = tok.strip()
        if not tok:
            raise PipelineSpecError(f"pipeline '{name}': empty stage in chain {chain!r}")
        model, dsep, dtype = tok.partition("@")
        stages.append(StageSpec(model, dtype if dsep else None))
    return PipelineSpec(name, stages)


def load_pipeline_file(path: str) -> list[PipelineSpec]:
    """A JSON file: ``[{"name": ..., "stages": [{"model": ..., "dtype": ...,
    "after": <model or null>}, ...]}, ...]``. ``after`` names the upstream
    stage (absent or null: the root). The graph is linearized here; two
    roots or a stage with two children is an arity mismatch (the glue takes
    exactly one upstream's boxes), a back edge a cycle (stages unreachable
    from the root)."""
    try:
        with open(path) as f:
            docs = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise PipelineSpecError(f"pipeline file {path!r}: {e}") from None
    if not isinstance(docs, list):
        raise PipelineSpecError(f"pipeline file {path!r}: top level must be a JSON array")
    specs = []
    for doc in docs:
        name = doc.get("name", "")
        raw = doc.get("stages", [])
        if not isinstance(raw, list) or not raw:
            raise PipelineSpecError(f"pipeline '{name}': 'stages' must be a non-empty array")
        by_parent: dict[str | None, list[dict]] = {}
        models = set()
        for st in raw:
            model = str(st.get("model", "")).strip()
            if model in models:
                raise PipelineSpecError(f"pipeline '{name}': duplicate stage model '{model}'")
            models.add(model)
            after = st.get("after")
            after = str(after).strip() if after is not None else None
            by_parent.setdefault(after, []).append(st)
        roots = by_parent.get(None, [])
        if len(roots) != 1:
            raise PipelineSpecError(
                f"pipeline '{name}': arity mismatch — need exactly 1 root "
                f"stage (no 'after'), got {len(roots)}")
        for parent, children in by_parent.items():
            if parent is not None and parent not in models:
                raise PipelineSpecError(f"pipeline '{name}': stage after unknown '{parent}'")
            if len(children) > 1:
                raise PipelineSpecError(
                    f"pipeline '{name}': arity mismatch — stage "
                    f"'{parent}' fans out to {len(children)} stages; the "
                    "chain executor takes exactly one downstream")
        # root to leaf; a back edge leaves stages the walk never reaches
        chain = [roots[0]]
        while True:
            nxt = by_parent.get(str(chain[-1].get("model", "")).strip())
            if not nxt:
                break
            chain.append(nxt[0])
        if len(chain) != len(raw):
            raise PipelineSpecError(
                f"pipeline '{name}': cycle — {len(raw) - len(chain)} "
                "stage(s) unreachable from the root")
        specs.append(PipelineSpec(
            name, [StageSpec(str(st.get("model", "")), st.get("dtype")) for st in chain]))
    return specs


def parse_pipeline_args(args) -> list[PipelineSpec]:
    """Each ``--pipeline`` value is an inline spec (it holds ``=``) or the
    path of a JSON file. One namespace: a name twice is a boot error."""
    specs: list[PipelineSpec] = []
    for a in args or ():
        if "=" in a:
            specs.append(parse_pipeline_spec(a))
        else:
            specs.extend(load_pipeline_file(a))
    seen = set()
    for s in specs:
        if s.name in seen:
            raise PipelineSpecError(f"duplicate pipeline name '{s.name}'")
        seen.add(s.name)
    return specs


def _fresh_cell() -> dict:
    return {"seconds": 0.0, "images": 0, "cache_hits": 0, "d2h_bytes": 0}


class PipelineCatalog:
    """The server's pipelines: validation, re-resolution after swaps,
    per-pipeline stats, and the executor. The registry's listeners only mark
    pipelines dirty; the re-resolution, which calls back into the registry,
    runs on the next read, outside the catalog's lock."""

    def __init__(self, registry, cache=None, hub=None, max_crops: int = DEFAULT_MAX_CROPS):
        self.registry = registry
        self.cache = cache
        self.hub = hub
        self.max_crops = max(1, int(max_crops))
        self._lock = threading.Lock()
        self._specs: dict[str, PipelineSpec] = {}
        # name → {"ok", "error", "stages": [resolved dicts]}: the last resolution
        self._status: dict[str, dict] = {}
        self._dirty: set[str] = set()
        self._stats: dict[str, dict] = {}
        self._resolutions = 0

    # ------------------------------------------------------------ registration

    def register(self, spec: PipelineSpec) -> None:
        """Register and validate at once (the boot path: a spec whose stages
        do not resolve refuses the server)."""
        with self._lock:
            if spec.name in self._specs:
                raise PipelineSpecError(f"duplicate pipeline name '{spec.name}'")
            self._specs[spec.name] = spec
            self._stats[spec.name] = self._fresh_stats(spec)
            self._dirty.add(spec.name)
        status = self._resolve(spec.name)
        if not status["ok"]:
            raise PipelineSpecError(f"pipeline '{spec.name}': {status['error']}")

    def attach_listeners(self) -> None:
        """Any serving or retire transition of a stage model marks its
        pipelines dirty (called under the registry's lock: dict work only)."""
        self.registry.add_serving_listener(self._on_model_event)
        self.registry.add_retire_listener(self._on_model_event)

    def _on_model_event(self, name: str, version) -> None:
        hit = []
        with self._lock:
            for pname, spec in self._specs.items():
                if any(st.model == name for st in spec.stages):
                    self._dirty.add(pname)
                    self._resolutions += 1
                    hit.append(pname)
        if self.hub is not None:
            for pname in hit:
                self.hub.record_event("pipeline_reresolved", pipeline=pname, model=name,
                                      version=version)

    @staticmethod
    def _fresh_stats(spec: PipelineSpec) -> dict:
        return {"requests": 0, "errors": 0, "e2e": deque(maxlen=512),
                "stages": {st.model: _fresh_cell() for st in spec.stages}}

    # -------------------------------------------------------------- resolution

    def _resolve(self, name: str) -> dict:
        """(Re)validate one pipeline against the live registry: a registry
        acquire and release per stage, then one locked status write."""
        with self._lock:
            spec = self._specs.get(name)
        if spec is None:
            raise KeyError(name)
        error = None
        resolved = []
        tasks = []
        for st in spec.stages:
            try:
                mv = self.registry.acquire(st.model)
            except (UnknownModel, ModelNotServing) as e:
                error = f"stage '{st.model}': {e}"
                break
            try:
                cfg = mv.model_cfg
                dtype = getattr(cfg, "dtype", "bfloat16")
                task = getattr(cfg, "task", "classify")
                wire = getattr(mv.engine.cfg, "wire_format", "rgb") \
                    if mv.engine is not None else "rgb"
                if st.dtype is not None and dtype != st.dtype:
                    error = (f"stage '{st.model}': spec pins dtype {st.dtype}, serving "
                             f"version {mv.version} is {dtype}")
                    break
                if wire != "rgb":
                    error = (f"stage '{st.model}': wire_format {wire!r} — "
                             "the DAG glue builds rgb canvases")
                    break
                tasks.append(task)
                resolved.append({"model": mv.name, "version": mv.version, "dtype": dtype,
                                 "task": task})
            finally:
                self.registry.release(mv)
        if error is None and tuple(tasks) not in _SUPPORTED_CHAINS:
            error = f"unsupported task chain {'>'.join(tasks)} (v1 glue runs detect>classify)"
        status = {"ok": error is None, "error": error,
                  "stages": resolved if error is None else []}
        with self._lock:
            self._status[name] = status
            self._dirty.discard(name)
        return status

    def ensure_resolved(self, name: str) -> dict:
        """The current status, re-resolved first if a swap dirtied it.
        KeyError for an unknown pipeline (HTTP 404)."""
        with self._lock:
            if name not in self._specs:
                raise KeyError(name)
            dirty = name in self._dirty or name not in self._status
            status = self._status.get(name)
        if dirty:
            status = self._resolve(name)
        return status

    # --------------------------------------------------------------- introspect

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._specs)

    def pipelines_snapshot(self) -> dict:
        """GET /pipelines: every spec and its live resolution."""
        out = {}
        for name in self.names():
            try:
                status = self.ensure_resolved(name)
            except KeyError:
                continue
            with self._lock:
                spec = self._specs[name]
                doc = spec.to_dict()
            doc["ref"] = spec.ref
            doc["ok"] = status["ok"]
            doc["error"] = status["error"]
            doc["resolved"] = status["stages"]
            out[name] = doc
        return out

    def pipeline_stats(self) -> dict:
        """The /stats "pipelines" block and the /metrics source: per
        pipeline its counters, e2e percentiles over the last 512 requests
        and per stage its seconds, images, cache hits and D2H bytes."""
        with self._lock:
            out: dict = {"resolutions_total": self._resolutions, "pipelines": {}}
            for name, st in self._stats.items():
                e2e = sorted(st["e2e"])

                def pct(q, e2e=e2e):
                    if not e2e:
                        return None
                    return round(e2e[min(len(e2e) - 1, int(q * len(e2e)))], 6)

                out["pipelines"][name] = {
                    "requests_total": st["requests"],
                    "errors_total": st["errors"],
                    "e2e_p50_s": pct(0.50),
                    "e2e_p99_s": pct(0.99),
                    "stages": {m: dict(d) for m, d in st["stages"].items()},
                }
        return out

    # ----------------------------------------------------------------- executor

    def _stage_account(self, name: str, model: str, *, seconds=0.0, images=0, cache_hits=0,
                       d2h_bytes=0) -> None:
        with self._lock:
            st = self._stats.get(name)
            if st is None:
                return
            cell = st["stages"].setdefault(model, _fresh_cell())
            cell["seconds"] += seconds
            cell["images"] += images
            cell["cache_hits"] += cache_hits
            cell["d2h_bytes"] += d2h_bytes

    def execute(self, name: str, data: bytes, topk: int | None, span,
                deadline_s: float = 60.0) -> tuple[dict, str, dict]:
        """One image through the pipeline: ``(payload, etag, stages_meta)``,
        the composed answer, the stage-2 cache identity, and the live
        per-stage versions for the envelope (never cached, so a cached
        composite cannot echo a retired version). Raises KeyError (unknown
        pipeline), PipelineUnavailable (a stage cannot serve), ValueError
        (undecodable image)."""
        t_start = time.monotonic()
        status = self.ensure_resolved(name)
        if not status["ok"]:
            raise PipelineUnavailable(status["error"])
        with self._lock:
            spec = self._specs[name]
        det_st, cls_st = spec.stages[0], spec.stages[1]
        ok = False
        try:
            payload, etag, meta = self._execute_chain(name, det_st, cls_st, data, topk, span,
                                                      deadline_s)
            ok = True
            return payload, etag, meta
        finally:
            e2e = time.monotonic() - t_start
            with self._lock:
                st = self._stats.get(name)
                if st is not None:
                    st["requests"] += 1
                    if ok:
                        st["e2e"].append(e2e)
                    else:
                        st["errors"] += 1
            if ok and self.hub is not None:
                self.hub.record_point("pipeline.e2e", e2e)

    def _acquire_stage(self, st: StageSpec):
        try:
            mv = self.registry.acquire(st.model)
        except (UnknownModel, ModelNotServing) as e:
            raise PipelineUnavailable(f"stage '{st.model}': {e}") from e
        dtype = getattr(mv.model_cfg, "dtype", "bfloat16")
        if st.dtype is not None and dtype != st.dtype:
            self.registry.release(mv)
            raise PipelineUnavailable(
                f"stage '{st.model}': serving dtype {dtype} != pinned {st.dtype}")
        return mv, dtype

    def _execute_chain(self, name, det_st, cls_st, data, topk, span, deadline_s):
        mv_det, det_dtype = self._acquire_stage(det_st)
        try:
            mv_cls, cls_dtype = self._acquire_stage(cls_st)
            try:
                return self._run_two_stage(name, mv_det, det_dtype, mv_cls, cls_dtype, data,
                                           topk, span, deadline_s)
            finally:
                self.registry.release(mv_cls)
        finally:
            self.registry.release(mv_det)

    # The reference's order: detector dispatch → device boxes → glue →
    # classifier dispatch → D2H of image 0's detector rows (beside the
    # classifier's device time) → detector release (no bucket fetch) →
    # stage-2 key → classifier fetch → compose.
    def _run_two_stage(self, name, mv_det, det_dtype, mv_cls, cls_dtype, data, topk, span,
                       deadline_s):
        det_eng, cls_eng = mv_det.engine, mv_cls.engine
        topk = clamp_topk(topk, cls_eng)
        t0 = time.monotonic()
        try:
            canvas, hw, orig = det_eng.prepare_bytes(data)
        except Exception:
            raise ValueError("could not decode image") from None
        span.add("image_decode", time.monotonic() - t0)
        digest = canvas_digest(canvas, hw)
        span.note("pipeline", name)
        # the crop batch: the classifier's smallest canvas bucket (the crops
        # are made here, no reason to pay a bigger one) at its batch bucket
        # covering max_crops
        out_s = min(cls_eng.cfg.canvas_buckets)
        n_crops = cls_eng.pick_batch_bucket(self.max_crops)

        t1 = time.monotonic()
        key1 = make_key(mv_det.name, mv_det.version, digest, self.max_crops, det_dtype)
        stage1, handle2 = self._stage1(name, mv_det, key1, canvas, hw, det_eng, cls_eng, out_s,
                                       n_crops, deadline_s)
        t2 = time.monotonic()
        span.add(f"pipeline.{mv_det.name}", t2 - t1)
        self._stage_account(name, mv_det.name, seconds=t2 - t1, images=1)

        key2 = make_key(mv_cls.name, mv_cls.version, stage_input_digest(digest, stage1), topk,
                        cls_dtype)
        payload, etag = self._stage2(name, mv_cls, key2, stage1, canvas, hw, orig, topk,
                                     cls_eng, out_s, n_crops, handle2, deadline_s)
        t3 = time.monotonic()
        span.add(f"pipeline.{mv_cls.name}", t3 - t2)
        self._stage_account(name, mv_cls.name, seconds=t3 - t2, images=stage1["num"])
        meta = {"stages": [
            {"model": mv_det.name, "version": mv_det.version, "dtype": det_dtype},
            {"model": mv_cls.name, "version": mv_cls.version, "dtype": cls_dtype},
        ]}
        return payload, etag, meta

    def _stage1(self, name, mv_det, key1, canvas, hw, det_eng, cls_eng, out_s, n_crops,
                deadline_s):
        """Stage 1 from the cache or the device; on the device path the
        classifier's crop batch is dispatched before the detector's rows
        reach the host. Returns ``(stage1_payload, handle2)``, handle2 the
        classifier's dispatch (None after a stage-1 hit: stage 2 decides
        whether it needs the device)."""
        flight = None
        if self.cache is not None:
            kind, obj = self.cache.begin(key1, mv_det.name)
            if kind == "hit":
                self._stage_account(name, mv_det.name, cache_hits=1)
                return obj.payload, None
            if kind == "wait":
                try:
                    payload, _etag = obj.future.result(timeout=deadline_s)
                    return payload, None
                except CacheRetired:
                    pass  # computed fresh and uncached, against the version resolved
            elif kind == "lead":
                flight = obj
        handle2 = None
        try:
            handle1 = det_eng.dispatch_batch(np.asarray(canvas)[None],
                                             np.asarray([hw], np.int32), keep_on_device=True)
            try:
                with torch.inference_mode():
                    boxes_d, scores_d, classes_d, num_d = (
                        o[0] for o in det_eng.device_outputs(handle1))
                    canvases_d, hws_d = det_eng.device_canvases(handle1)
                    # the glue before any host copy, then the classifier, so
                    # that its device time covers the row copies below
                    crops = dag_glue.crop_resize(canvases_d[0], hws_d[0], boxes_d, num_d,
                                                 out_s=out_s, n_crops=n_crops)
                handle2 = cls_eng.dispatch_device(crops, np.full((n_crops, 2), out_s, np.int32))
                # image 0's rows only: the padded bucket stays on the device
                boxes, scores, classes, num = (t.cpu().numpy() for t in
                                               (boxes_d, scores_d, classes_d, num_d))
                d2h = boxes.nbytes + scores.nbytes + classes.nbytes + num.nbytes
                det_eng.note_d2h(d2h)
                self._stage_account(name, mv_det.name, d2h_bytes=d2h)
            finally:
                det_eng.release_dispatch(handle1)
            kept = min(int(num), self.max_crops)
            det_labels = mv_det.labels
            cls_ids = [int(classes[i]) for i in range(kept)]
            stage1 = {
                "boxes": [[float(v) for v in boxes[i]] for i in range(kept)],
                "scores": [float(scores[i]) for i in range(kept)],
                "classes": cls_ids,
                # labels resolve here, with the detector's label map at hand
                "labels": [det_labels[c] if c < len(det_labels) else f"class_{c}"
                           for c in cls_ids],
                "num": kept,
            }
        except BaseException as e:
            if handle2 is not None:
                cls_eng.release_dispatch(handle2)
            if flight is not None:
                self.cache.abort(flight, e)
            raise
        if flight is not None:
            self.cache.complete(flight, stage1)
        return stage1, handle2

    def _stage2(self, name, mv_cls, key2, stage1, canvas, hw, orig, topk, cls_eng, out_s,
                n_crops, handle2, deadline_s):
        """Stage 2 and the composed payload. ``handle2``: the dispatch the
        stage-1 device path made (None after a stage-1 hit)."""
        flight = None
        if self.cache is not None:
            kind, obj = self.cache.begin(key2, mv_cls.name)
            if kind == "hit":
                if handle2 is not None:
                    # speculation lost (stage 1 missed, the composite is
                    # cached): close the dispatch without using its rows
                    cls_eng.release_dispatch(handle2)
                self._stage_account(name, mv_cls.name, cache_hits=1)
                return obj.payload, obj.etag
            if kind == "wait":
                if handle2 is not None:
                    cls_eng.release_dispatch(handle2)
                try:
                    return obj.future.result(timeout=deadline_s)
                except CacheRetired:
                    handle2 = None  # recomputed below, uncached
            elif kind == "lead":
                flight = obj
        try:
            if handle2 is None:
                # after a stage-1 hit: the crops again from the cached boxes
                # (JSON keeps the floats exactly, so the glue reads the boxes
                # the device made, and the classifier the same crops)
                boxes = np.zeros((n_crops, 4), np.float32)
                kept = stage1["num"]
                if kept:
                    boxes[:kept] = np.asarray(stage1["boxes"], np.float32)[:n_crops]
                dev = cls_eng.device
                with torch.inference_mode():
                    crops = dag_glue.crop_resize(
                        torch.from_numpy(np.ascontiguousarray(canvas)).to(dev),
                        torch.tensor(hw, dtype=torch.int32, device=dev),
                        torch.from_numpy(boxes).to(dev),
                        torch.tensor(kept, dtype=torch.int32, device=dev),
                        out_s=out_s, n_crops=n_crops)
                handle2 = cls_eng.dispatch_device(crops, np.full((n_crops, 2), out_s, np.int32))
            outs = cls_eng.fetch_outputs(handle2)
            kept = stage1["num"]
            self._stage_account(name, mv_cls.name,
                                d2h_bytes=sum(int(o[:max(kept, 1)].nbytes) for o in outs))
            dets = []
            h, w = orig
            for i in range(kept):
                y0, x0, y1, x1 = stage1["boxes"][i]
                dets.append({
                    "box": [y0 * h, x0 * w, y1 * h, x1 * w],
                    "class": stage1["classes"][i],
                    "label": stage1["labels"][i],
                    "score": stage1["scores"][i],
                    "classification": format_result_row(
                        tuple(o[i] for o in outs), (out_s, out_s), topk, mv_cls),
                })
            payload = {"detections": dets, "num_detections": kept}
        except BaseException as e:
            if flight is not None:
                self.cache.abort(flight, e)
            raise
        if flight is not None:
            etag = self.cache.complete(flight, payload)
        else:
            etag = payload_etag(payload, mv_cls.name, mv_cls.version)
        return payload, etag
