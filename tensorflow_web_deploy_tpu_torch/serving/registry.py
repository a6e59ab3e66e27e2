"""Model lifecycle registry: named, versioned engines behind one server
(counterpart of the JAX package's ``serving/registry.py``).

One :class:`ModelRegistry` owns any number of named, versioned serving
units and moves each through the reference's state machine

    LOADING ──▶ WARMING ──▶ SERVING ──▶ DRAINING ──▶ UNLOADED
       │           │
       └───────────┴──▶ FAILED

with its three invariants:

- **Loads never run on the request path.** A single background loader
  thread builds and warms new engines; requests keep flowing through the
  versions already serving.
- **Hot swap is atomic and warm-gated.** A new version takes traffic only
  after its warmup succeeded: the serving map's pointer flips under the
  registry's lock, so every request resolves the old version or the new
  one, never neither. The old version then DRAINs: no new request can
  acquire it, the requests holding it finish (a per-version count), its
  batcher dispatches everything queued, and only then is it UNLOADED and
  its engine closed (its CUDA graphs, static inputs and weights dropped and
  the freed segments returned to the device).
- **A failed load never disturbs the serving version.** A build or warmup
  failure parks the new version in FAILED (the error is in ``GET
  /models``) and the serving map is untouched.

Every version owns its own :class:`~.batcher.Batcher`, so one model's
queue never starves another's.

**One deliberate difference from the reference.** The reference warms on
the loader thread (``engine.warmup()``, then it builds the batcher). On
CUDA, first-use costs are paid per thread: a warmup on another thread left
the dispatch threads' first batches 10–25× slower (PERF.md). So the port's
WARMING state covers starting the version's batcher with ``warmup=True``
(:meth:`~.batcher.Batcher.start`): every launch thread runs the engine's
warmup (the first captures the CUDA graphs) before it takes a batch. A
warmup failure there parks the version in FAILED, stops its batcher,
disposes of its engine and leaves the serving version untouched.

The registry owns one :class:`~.overload.AdmissionController` (quotas are
per tenant, not per model) and one :class:`~.chaos.ChaosInjector` and
hands both to every batcher it builds or adopts; the response cache
listens for retired versions, and :meth:`ModelRegistry.quant_variant`
finds the int8 tier the degradation ladder reroutes to.

Each version keeps the placement of its model config (``,replicas=N``):
its engine builds a replica per device group of the registry's mesh, a
swap that re-specs from the serving version keeps it, and ``GET /models``
shows it per version.

:meth:`ModelRegistry.build_batcher` passes the bulk class's knobs
(``jobs_batch``, ``jobs_max_inflight``, ``jobs_starvation_s``) to every
batcher; the job manager's retire listener fires inside the DRAINING flip,
under the registry's lock, and pauses the jobs on that model. The App
attaches its pipeline catalog (``serving/dag.py``,
:meth:`ModelRegistry.attach_pipelines`): ``GET /models`` shows each
pipeline's spec and live stage resolution beside the models, and the
catalog's own serving and retire listeners re-resolve a pipeline after a
swap of one of its stage models.

The registry is engine-agnostic through its factory seams: the tests
drive the whole lifecycle with mock engines.
"""

from __future__ import annotations

import dataclasses
import logging
import queue
import threading
import time
from contextlib import contextmanager

from ..utils.config import model_config
from ..utils.labels import load_labels
from ..utils.locks import named_condition
from . import aotcache
from .chaos import ChaosInjector
from .overload import build_admission

log = logging.getLogger("tpu_serve_torch.registry")

# Lifecycle states: strings, so they serialize into /models and log lines.
LOADING = "LOADING"
WARMING = "WARMING"
SERVING = "SERVING"
DRAINING = "DRAINING"
UNLOADED = "UNLOADED"
FAILED = "FAILED"

# Legal transitions, enforced at every _set_state: a move backwards (or an
# UNLOADED engine resurrected) crashes the loader's job loudly instead of
# corrupting the serving map.
_TRANSITIONS = {
    LOADING: (WARMING, FAILED),
    WARMING: (SERVING, FAILED),
    SERVING: (DRAINING,),
    DRAINING: (UNLOADED,),
    UNLOADED: (),
    FAILED: (),
}


class UnknownModel(KeyError):
    """No model (or no such version) under that name: HTTP 404."""


class ModelNotServing(RuntimeError):
    """The model exists but has no version in SERVING (loading, failed or
    unloaded): HTTP 503 on /predict, 409 on the admin routes."""


class ModelVersion:
    """One named, versioned serving unit: engine + batcher + labels + state.

    State moves go through the owning registry (one condition variable
    guards the serving map, every version's state and the in-flight
    counts). ``history`` records every transition with a registry-relative
    time; ``GET /models`` shows it.
    """

    __slots__ = ("name", "version", "model_cfg", "state", "error", "engine",
                 "batcher", "labels", "history", "inflight", "created_at")

    def __init__(self, name: str, version: int, model_cfg, t_rel: float):
        self.name = name
        self.version = version
        self.model_cfg = model_cfg
        self.state = LOADING
        self.error: str | None = None
        self.engine = None
        self.batcher = None
        self.labels: list[str] = []
        self.history: list[tuple[str, float]] = [(LOADING, t_rel)]
        self.inflight = 0  # requests resolved to this version, not yet done
        self.created_at = time.monotonic()

    @property
    def ref(self) -> str:
        return f"{self.name}@{self.version}"

    def snapshot(self) -> dict:
        d = {
            "version": self.version,
            "state": self.state,
            "dtype": self.model_cfg.dtype,
            "source": self.model_cfg.source,
            "task": self.model_cfg.task,
            "age_s": round(time.monotonic() - self.created_at, 1),
            "inflight": self.inflight,
            # list() first: the loader appends transitions concurrently
            "history": [{"state": s, "t_s": round(t, 3)} for s, t in list(self.history)],
        }
        if self.error:
            d["error"] = self.error
        # local refs: a drain nulls them concurrently
        engine, batcher = self.engine, self.batcher
        if engine is not None and hasattr(engine, "placement_summary"):
            # where this version lives: strategy, replicas, device ids
            d["placement"] = engine.placement_summary()
        if engine is not None and engine.parity is not None:
            d["parity"] = engine.parity
        # the version's batcher and engine counters
        if batcher is not None:
            d["batcher"] = batcher.stats()
        if engine is not None:
            d["engine"] = engine.stats()
        return d


def _parse_ref(spec: str) -> tuple[str, int | None]:
    """``"name"`` or ``"name@version"`` → (name, version or None)."""
    name, sep, ver = spec.partition("@")
    if not sep:
        return name, None
    try:
        return name, int(ver)
    except ValueError:
        raise UnknownModel(f"malformed model ref {spec!r} (want name or name@version)") from None


class ModelRegistry:
    """Owns every model version and the one background loader thread.

    Factory seams (both optional; the defaults build the real stack):

    - ``engine_factory(model_cfg)`` → engine. Default: an
      :class:`~.engine.InferenceEngine` for ``dataclasses.replace(cfg,
      model=model_cfg)`` on ``mesh`` (else ``device``) with weights from
      ``seed``.
    - ``spec_resolver(str)`` → ModelConfig for admin-API load bodies.
      Default: :func:`~..utils.config.model_config`.
    """

    def __init__(self, server_cfg, *, default_model: str | None = None,
                 engine_factory=None, spec_resolver=None, device=None, seed: int = 0,
                 mesh=None):
        self.cfg = server_cfg
        self.default_model = default_model
        self.device = device
        self.mesh = mesh
        self.seed = seed
        self._engine_factory = engine_factory or self._build_engine
        self._spec_resolver = spec_resolver or model_config
        self._cond = named_condition("registry.cond")
        # shared by every batcher of the registry and the App
        self.admission = build_admission(server_cfg)
        self.chaos = ChaosInjector.from_spec(server_cfg.chaos)
        self._models: dict[str, dict[int, ModelVersion]] = {}
        self._serving: dict[str, ModelVersion] = {}
        self._next_version: dict[str, int] = {}
        self._t0 = time.monotonic()
        self._running = True
        self._jobs: queue.Queue = queue.Queue()
        self._loader: threading.Thread | None = None
        self._swaps_total = 0
        self._loads_failed_total = 0
        # Called with (name, version) under the registry's lock the moment a
        # version enters DRAINING (retire) or SERVING (serving). Listeners
        # flip flags only; they must not block.
        self._retire_listeners: list = []
        self._serving_listeners: list = []
        # the App's pipeline catalog (serving/dag.py), read by models_snapshot
        self._pipelines = None

    # ------------------------------------------------------------- factories

    def _build_engine(self, model_cfg):
        from .engine import InferenceEngine

        cfg = dataclasses.replace(self.cfg, model=model_cfg)
        return InferenceEngine(cfg, device=self.device, seed=self.seed, mesh=self.mesh)

    def build_batcher(self, engine):
        """A started batcher for ``engine`` with the server's knobs, warmed
        on its launch threads when the config asks for warmup; boot-time
        models use it before :meth:`adopt`, loads in WARMING."""
        from .batcher import Batcher

        cfg = self.cfg
        # the model's own pipeline_depth/max_queue override the server's (a
        # latency-critical model can run depth 1 with a short queue beside a
        # deep throughput model); engines without a config inherit them
        mc = getattr(getattr(engine, "cfg", None), "model", None)
        depth = getattr(mc, "pipeline_depth", None)
        max_queue = getattr(mc, "max_queue", None)
        return Batcher(
            engine, engine.max_batch, cfg.max_delay_ms,
            pipeline_depth=cfg.pipeline_depth if depth is None else depth,
            adaptive_delay=cfg.adaptive_delay,
            max_queue=cfg.max_queue if max_queue is None else max_queue,
            lease_timeout_s=cfg.lease_timeout_s, admission=self.admission, chaos=self.chaos,
            # the bulk class: the throughput batch target and the in-flight
            # cap that bounds the device time a job holds on this model
            bulk_max_batch=cfg.jobs_batch, bulk_inflight=cfg.jobs_max_inflight,
            bulk_starvation_s=cfg.jobs_starvation_s,
        ).start(warmup=cfg.warmup)

    def _resolve_spec(self, spec):
        """Admin-API model spec (string) → ModelConfig; a ModelConfig passes
        through. Raises ValueError on an unresolvable spec (HTTP 400)."""
        return self._spec_resolver(spec) if isinstance(spec, str) else spec

    # ----------------------------------------------------------- registration

    def adopt(self, name: str, engine, batcher, model_cfg) -> ModelVersion:
        """Register a built, warm engine as SERVING at once (server boot:
        boot builds its engines inline and fails fast; only runtime loads
        ride the loader thread). A batcher built elsewhere gets the
        registry's admission and chaos unless it has its own."""
        if batcher.admission is None:
            batcher.admission = self.admission
        if batcher.chaos is None:
            batcher.chaos = self.chaos
        labels = load_labels(model_cfg.labels_path, engine.num_classes)
        with self._cond:
            mv = self._new_version_locked(name, model_cfg)
            mv.engine = engine
            mv.batcher = batcher
            mv.labels = labels
            self._set_state_locked(mv, WARMING)
            self._set_state_locked(mv, SERVING)
            self._notify_locked(self._serving_listeners, mv)
            old = self._serving.get(name)
            self._serving[name] = mv
            if self.default_model is None:
                self.default_model = name
        if old is not None:
            self._submit_job(("drain", old))
        log.info("adopted %s (engine=%s)", mv.ref, type(engine).__name__)
        return mv

    def _new_version_locked(self, name: str, model_cfg) -> ModelVersion:
        v = self._next_version.get(name, 0) + 1
        self._next_version[name] = v
        mv = ModelVersion(name, v, model_cfg, time.monotonic() - self._t0)
        self._models.setdefault(name, {})[v] = mv
        return mv

    # ------------------------------------------------------------ state moves

    def _set_state_locked(self, mv: ModelVersion, state: str, error: str | None = None):
        if state not in _TRANSITIONS[mv.state]:
            raise RuntimeError(f"illegal lifecycle transition {mv.ref}: {mv.state} -> {state}")
        mv.state = state
        if error is not None:
            mv.error = error
        mv.history.append((state, time.monotonic() - self._t0))
        self._cond.notify_all()

    def _set_state(self, mv: ModelVersion, state: str, error: str | None = None):
        with self._cond:
            self._set_state_locked(mv, state, error)

    def add_retire_listener(self, cb) -> None:
        """Register ``cb(name, version)`` to run when a version enters
        DRAINING (no new request can resolve it from then on)."""
        with self._cond:
            self._retire_listeners.append(cb)

    def add_serving_listener(self, cb) -> None:
        """Register ``cb(name, version)`` to run when a version enters
        SERVING (requests can resolve it from then on)."""
        with self._cond:
            self._serving_listeners.append(cb)

    @staticmethod
    def _notify_locked(listeners: list, mv: ModelVersion) -> None:
        for cb in listeners:
            try:
                cb(mv.name, mv.version)
            except Exception:
                log.exception("registry listener failed for %s", mv.ref)

    def _fail_locked(self, mv: ModelVersion, error: str):
        # through the same transition guard; the serving map is not touched
        self._set_state_locked(mv, FAILED, error)
        self._loads_failed_total += 1

    # -------------------------------------------------------------- load/swap

    def load(self, spec, *, name: str | None = None, activate: bool = True,
             wait: bool = False, timeout: float = 600.0) -> ModelVersion:
        """Register a new version and hand it to the loader thread. ``spec``
        is a ModelConfig or a string ``--model`` accepts; ``name`` defaults
        to its serve name. Returns the version at once (LOADING); with
        ``wait`` blocks until it is SERVING or FAILED."""
        model_cfg = self._resolve_spec(spec)
        name = name or model_cfg.serve_name
        with self._cond:
            if not self._running:
                raise RuntimeError("registry is stopped")
            mv = self._new_version_locked(name, model_cfg)
        self._submit_job(("load", mv, activate))
        log.info("load queued: %s (activate=%s)", mv.ref, activate)
        if wait:
            self.wait_for(mv, (SERVING, FAILED, UNLOADED), timeout=timeout)
        return mv

    def swap(self, name: str | None = None, spec=None, *, wait: bool = False,
             timeout: float = 600.0) -> ModelVersion:
        """Load a new version of an existing model and shift its traffic to
        it once warm (the old version drains, then unloads). Without
        ``spec`` the new version rebuilds from the serving version's config."""
        name = name or self.default_model
        with self._cond:
            if name not in self._models:
                raise UnknownModel(f"unknown model '{name}'")
            if spec is None:
                cur = self._serving.get(name)
                if cur is None:
                    raise ModelNotServing(f"model '{name}' has no serving version to re-spec from")
                spec = cur.model_cfg
        mv = self.load(spec, name=name, activate=True)
        with self._cond:
            # counted once accepted, before any wait: a wait that times out
            # answers 504, but the swap still completes on the loader
            self._swaps_total += 1
        if wait:
            self.wait_for(mv, (SERVING, FAILED, UNLOADED), timeout=timeout)
        return mv

    def unload(self, name: str, version: int | None = None, *, wait: bool = False,
               timeout: float = 60.0) -> ModelVersion:
        """Take a version out of service: DRAIN (requests holding it finish,
        queued batches dispatch), then UNLOAD (its engine closed)."""
        with self._cond:
            if not self._running:
                # checked before the serving map's pop: a later raise would
                # leave the version out of the map with no drain behind it
                raise RuntimeError("registry is stopped")
            versions = self._models.get(name)
            if not versions:
                raise UnknownModel(f"unknown model '{name}'")
            if version is None:
                mv = self._serving.get(name)
                if mv is None:
                    raise ModelNotServing(f"model '{name}' is not serving")
            else:
                mv = versions.get(version)
                if mv is None:
                    raise UnknownModel(f"unknown version {name}@{version}")
            if mv.state != SERVING:
                raise ModelNotServing(f"{mv.ref} is {mv.state}, not SERVING")
            if self._serving.get(name) is mv:
                del self._serving[name]
        self._submit_job(("drain", mv))
        if wait:
            self.wait_for(mv, (UNLOADED,), timeout=timeout)
        return mv

    def wait_for(self, mv: ModelVersion, states, timeout: float = 600.0) -> str:
        deadline = time.monotonic() + timeout
        with self._cond:
            while mv.state not in states:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(f"{mv.ref} still {mv.state} after {timeout:.0f}s "
                                       f"(wanted {'/'.join(states)})")
                self._cond.wait(remaining)
            return mv.state

    # ----------------------------------------------------------- loader thread

    def _submit_job(self, job):
        with self._cond:
            if not self._running:
                # after stop() the loader is gone: a job queued now would be
                # dropped, and a loader restarted would race the shutdown
                raise RuntimeError("registry is stopped")
            if self._loader is None or not self._loader.is_alive():
                self._loader = threading.Thread(target=self._load_loop, name="model-loader",
                                                daemon=True)
                self._loader.start()
        self._jobs.put(job)

    def _load_loop(self):
        while True:
            job = self._jobs.get()
            if job is None:
                return
            try:
                if job[0] == "load":
                    self._process_load(job[1], job[2])
                else:
                    self._process_drain(job[1])
            except Exception:
                # one poisoned job must not kill the loader for every later one
                log.exception("registry job %s failed", job[0])

    def _process_load(self, mv: ModelVersion, activate: bool):
        t0 = time.monotonic()
        cache_before = aotcache.stats()
        try:
            engine = self._engine_factory(mv.model_cfg)
        except Exception as e:
            log.exception("engine build failed for %s", mv.ref)
            with self._cond:
                self._fail_locked(mv, f"build: {type(e).__name__}: {e}"[:500])
            return
        mv.engine = engine
        self._set_state(mv, WARMING)
        t_warm = time.perf_counter()
        try:
            # the batcher's launch threads warm up before it takes a batch
            batcher = self.build_batcher(engine)
        except Exception as e:
            log.exception("warmup failed for %s", mv.ref)
            self._dispose_engine(engine)
            mv.engine = None
            with self._cond:
                self._fail_locked(mv, f"warmup: {type(e).__name__}: {e}"[:500])
            return
        cache_after = aotcache.stats()
        # a load of a config already seen in this process (or on this cache)
        # should build nothing: the kernel build cache's delta for the load
        log.info("warmed %s in %.2fs (kernel build cache: %d loaded, %d built, nvcc %.2fs)",
                 mv.ref, time.perf_counter() - t_warm,
                 cache_after["hits_total"] - cache_before["hits_total"],
                 cache_after["misses_total"] + cache_after["corrupt_total"]
                 - cache_before["misses_total"] - cache_before["corrupt_total"],
                 cache_after["compile_seconds_total"] - cache_before["compile_seconds_total"])
        mv.batcher = batcher
        mv.labels = load_labels(mv.model_cfg.labels_path, engine.num_classes)
        with self._cond:
            old = self._serving.get(mv.name) if activate else None
            # the atomic hot swap: state flip and the serving map's pointer
            # under one lock hold; a request racing it resolved the old
            # version (which drains only once its count is zero) or the new
            self._set_state_locked(mv, SERVING)
            self._notify_locked(self._serving_listeners, mv)
            if activate:
                self._serving[mv.name] = mv
                if self.default_model is None:
                    self.default_model = mv.name
        log.info("%s SERVING after %.1fs%s", mv.ref, time.monotonic() - t0,
                 f" (replacing v{old.version})" if old else "")
        if old is not None and old is not mv:
            self._process_drain(old)

    def _process_drain(self, mv: ModelVersion):
        """DRAIN → UNLOAD one version. It is out of the serving map by now,
        so its in-flight count can only fall."""
        with self._cond:
            if mv.state != SERVING:
                return  # drained already (a double unload)
            self._set_state_locked(mv, DRAINING)
            self._notify_locked(self._retire_listeners, mv)
            deadline = time.monotonic() + self.cfg.drain_grace_s
            while mv.inflight > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    log.warning("%s drain grace expired with %d in-flight requests; their "
                                "futures resolve from the batcher's stop", mv.ref, mv.inflight)
                    break
                self._cond.wait(remaining)
        # outside the lock: the batcher's stop dispatches every queued batch
        # and resolves every future, which takes device time
        if mv.batcher is not None:
            try:
                mv.batcher.stop()
            except Exception:
                log.exception("batcher stop failed for %s", mv.ref)
        if mv.engine is not None:
            self._dispose_engine(mv.engine)
        self._set_state(mv, UNLOADED)
        mv.engine = None
        mv.batcher = None
        log.info("%s UNLOADED", mv.ref)

    @staticmethod
    def _dispose_engine(engine):
        try:
            engine.close()
        except Exception:
            log.exception("engine close failed")

    # ------------------------------------------------------------- resolution

    def acquire(self, spec: str | None = None) -> ModelVersion:
        """Resolve ``name`` / ``name@version`` / None (the default model) to
        a SERVING version and take an in-flight reference on it; callers
        must :meth:`release` it (or use :meth:`lease_model`). The reference
        keeps a version from draining while a request holds it."""
        with self._cond:
            if spec:
                name, version = _parse_ref(spec)
            else:
                name, version = self.default_model, None
            if name is None or name not in self._models:
                raise UnknownModel(f"unknown model '{name}'")
            if version is None:
                mv = self._serving.get(name)
                if mv is None:
                    raise ModelNotServing(f"model '{name}' has no serving version")
            else:
                mv = self._models[name].get(version)
                if mv is None:
                    raise UnknownModel(f"unknown version {name}@{version}")
                if mv.state != SERVING:
                    raise ModelNotServing(f"{mv.ref} is {mv.state}")
            mv.inflight += 1
            return mv

    def release(self, mv: ModelVersion):
        with self._cond:
            mv.inflight -= 1
            self._cond.notify_all()

    @contextmanager
    def lease_model(self, spec: str | None = None):
        mv = self.acquire(spec)
        try:
            yield mv
        finally:
            self.release(mv)

    def quant_variant(self, name: str) -> ModelVersion | None:
        """A SERVING int8 variant of model ``name``: another serving entry
        whose config quantizes the same network (same ``name``, ``task``
        and ``input_size``) at int8. None when ``name`` serves int8 itself
        or nothing matches. Takes no in-flight reference: the caller
        acquires the variant by name."""
        with self._cond:
            cur = self._serving.get(name)
            if cur is None or cur.model_cfg.dtype == "int8":
                return None
            cfg = cur.model_cfg
            for vname, mv in self._serving.items():
                vc = mv.model_cfg
                if (vname != name and vc.dtype == "int8" and vc.name == cfg.name
                        and vc.task == cfg.task and vc.input_size == cfg.input_size):
                    return mv
            return None

    def default_entry(self) -> ModelVersion | None:
        """The default model's serving version (for /healthz and the
        default blocks of /stats); while none serves, its newest version."""
        with self._cond:
            name = self.default_model
            if name is None:
                return None
            mv = self._serving.get(name)
            if mv is None:
                versions = self._models.get(name)
                if versions:
                    mv = versions[max(versions)]
            return mv

    # -------------------------------------------------------------- snapshots

    def models_snapshot(self) -> dict:
        """The ``GET /models`` document: the default model, and per model
        its serving version and every version's state, history, error and
        counters. Only the map copies happen under the lock."""
        with self._cond:
            names = {n: dict(vs) for n, vs in self._models.items()}
            serving = dict(self._serving)
            out = {
                "default": self.default_model,
                "swaps_total": self._swaps_total,
                "loads_failed_total": self._loads_failed_total,
                "models": {},
            }
        for name in sorted(names):
            cur = serving.get(name)
            out["models"][name] = {
                "serving_version": cur.version if cur else None,
                "versions": [names[name][v].snapshot() for v in sorted(names[name])],
            }
        # read after the registry's lock is dropped: a dirty pipeline
        # re-resolves through acquire() and release()
        pipelines = self._pipelines
        if pipelines is not None:
            out["pipelines"] = pipelines.pipelines_snapshot()
        return out

    def attach_pipelines(self, catalog) -> None:
        """The pipeline catalog whose specs and resolutions ``GET /models``
        shows (the catalog registers its own listeners)."""
        self._pipelines = catalog

    def serving_entries(self) -> list[ModelVersion]:
        """Every serving version."""
        with self._cond:
            return list(self._serving.values())

    # ------------------------------------------------------------------- stop

    def stop(self, grace_s: float = 10.0):
        """Shutdown: stop the loader, then every live batcher (each
        dispatches its queued work and resolves every future). The engines
        stay open until :meth:`close_engines`."""
        with self._cond:
            self._running = False
            loader = self._loader
        if loader is not None and loader.is_alive():
            self._jobs.put(None)
            loader.join(timeout=grace_s)
        for mv in self._live(lambda mv: mv.batcher is not None):
            try:
                mv.batcher.stop()
            except Exception:
                log.exception("batcher stop failed for %s", mv.ref)

    def close_engines(self):
        """Close every engine still held (after :meth:`stop`)."""
        for mv in self._live(lambda mv: mv.engine is not None):
            self._dispose_engine(mv.engine)

    def _live(self, keep) -> list[ModelVersion]:
        with self._cond:
            return [mv for vs in self._models.values() for mv in vs.values() if keep(mv)]
