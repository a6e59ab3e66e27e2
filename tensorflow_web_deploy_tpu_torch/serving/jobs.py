"""Bulk offline inference jobs: checkpointed manifests served through the
batcher's lower-priority bulk class (counterpart of the JAX package's
``serving/jobs.py``).

- **Jobs are manifests, not requests.** ``POST /jobs`` registers a manifest
  of images (multipart uploads spooled under ``--jobs-dir``, or a
  server-side directory glob) and answers 202 at once. One background
  runner thread drives each manifest through the registry, the batcher and
  the slabs that interactive traffic uses, as the batcher's bulk class:
  builders of up to ``--jobs-batch`` rows (256 by default; clamped to the
  engine's top batch bucket) that take the device only while no
  interactive batch waits or runs, at most ``--jobs-max-inflight`` at once
  (``serving/batcher.py``'s bulk gate).
- **Checkpointed progress.** A chunk (``jobs_batch`` images) is the unit of
  progress. Its result lines are appended to ``results.jsonl`` and fsynced
  **before** ``checkpoint.json`` records the new line and byte counts, so a
  crash between the two leaves only lines past the checkpoint, which
  recovery truncates. A restart re-registers every job under the directory;
  a job that was not terminal resumes from its checkpoint with zero lost
  and zero duplicated images. ``manifest.json``, ``checkpoint.json`` and
  ``results.jsonl`` have the reference's format key for key, so a jobs
  directory means the same thing to both packages.
- **Result streaming.** ``read_results(offset, limit, wait_s)`` returns the
  checkpoint-covered lines from ``offset`` on (one seek through a line
  index), and with ``wait_s`` long-polls until more land or the job ends.
- **Lifecycle**::

      QUEUED ──▶ RUNNING ──▶ DONE
                   │  ▲  └──▶ FAILED / CANCELLED
                   ▼  │
                  PAUSED ───▶ CANCELLED

  A hot swap pauses a job instead of failing it: the registry's retire
  listener fires inside the DRAINING flip (under the registry's lock; order
  registry → jobs) and pauses the running jobs of that model; the runner
  re-resolves the model at its next chunk onto the new SERVING version
  (both land in ``versions``). Items whose batch died under the drain retry
  one by one against the new version (:meth:`JobManager._retry_item`).
- **Cache.** Every image consults the response cache before it takes a slot
  (``begin(..., bulk=True)``: the bulk counters), so a re-run dedups and a
  job's misses warm the interactive tier. A led flight is always completed
  or aborted: any raise after ``begin`` answered "lead" releases the lease,
  then aborts the flight, each step guarded.
- **Tracing.** Each chunk has a :class:`~..utils.tracing.Span` noted
  ``class: "bulk"`` (stages ``job_decode``, ``job_cache_lookup``,
  ``job_await``, ``job_spool``), and every result row carries its
  ``trace_id``.

One condition guards job state, counters and the queue; file IO, decode,
cache waits, batcher futures and registry calls run outside it, and the
registry's listeners only flip flags under it.
"""

from __future__ import annotations

import json
import logging
import os
import re
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from ..utils.locks import named_condition
from ..utils.tracing import Span
from .batcher import ShuttingDown
from .registry import ModelNotServing, UnknownModel
from .respcache import canvas_digest, make_key, packed_digest

log = logging.getLogger("tpu_serve_torch.jobs")

# lifecycle states: strings, so they serialize into /jobs, /metrics labels
# and checkpoint files as they are
QUEUED = "QUEUED"
RUNNING = "RUNNING"
PAUSED = "PAUSED"
DONE = "DONE"
FAILED = "FAILED"
CANCELLED = "CANCELLED"
TERMINAL = (DONE, FAILED, CANCELLED)

# legal transitions, checked at every move: resuming a CANCELLED job or
# finishing one twice raises in the runner instead of corrupting the
# checkpoint
_TRANSITIONS = {
    QUEUED: (RUNNING, CANCELLED, FAILED),
    RUNNING: (PAUSED, DONE, FAILED, CANCELLED),
    PAUSED: (RUNNING, CANCELLED, FAILED),
    DONE: (),
    FAILED: (),
    CANCELLED: (),
}

_SAFE_NAME = re.compile(r"[^A-Za-z0-9._-]+")
_IMAGE_SUFFIXES = (".jpg", ".jpeg", ".png", ".bmp", ".gif", ".webp")
# the canvas bytes of a classic-wire row end in its 4-byte (h, w) trailer
_TRAILER_BYTES = 4


class UnknownJob(KeyError):
    """No job under that id (HTTP: 404)."""


# ------------------------------------------------------------- formatting
# One image's row of the engine's outputs → its JSON payload, shared by the
# request path (http.App) and the job runner.


def clamp_topk(topk: int | None, engine) -> int:
    """THE topk clamp, shared by ``/predict`` and every job staging, format
    and retry site: the value feeds the cache key, so one definition keeps
    the interactive and bulk key spaces identical. None means the engine's
    k (the model's top-k, at most its classes); both bounds are enforced,
    since a negative topk would slice labels from the wrong end."""
    if topk is None:
        return engine.topk
    return min(max(topk, 0), engine.topk)


def format_result_row(row, orig_hw, topk: int, mv, trace_id=None) -> dict:
    """The task's payload for one image (the task and label map belong to
    the resolved model version ``mv``). Classify: ``row`` is (scores [K],
    indices [K]) and the first ``topk`` become ``predictions``. Detect:
    :func:`format_detections` against the upload's original (h, w).
    ``trace_id`` stamps the trace that computed the payload into it."""
    labels = mv.labels
    if mv.model_cfg.task == "detect":
        out = format_detections(row, orig_hw, labels)
    else:
        scores, idx = (np.asarray(r) for r in row)
        out = {
            "predictions": [
                {
                    "label": labels[i] if i < len(labels) else f"class_{i}",
                    "index": int(i),
                    "score": float(s),
                }
                for s, i in zip(scores[:topk], idx[:topk])
            ]
        }
    if trace_id is not None:
        out["trace_id"] = trace_id
    return out


def format_detections(row, image_hw, labels) -> dict:
    """(boxes [D, 4] normalized (ymin, xmin, ymax, xmax), scores [D],
    classes [D], num) → the first ``num`` detections with each box scaled
    by the image's (h, w)."""
    boxes, scores, classes, num = (np.asarray(r) for r in row)
    n = int(num)
    h, w = image_hw
    dets = []
    for i in range(n):
        y0, x0, y1, x1 = (float(v) for v in boxes[i])
        cls = int(classes[i])
        dets.append(
            {
                "box": [y0 * h, x0 * w, y1 * h, x1 * w],
                "class": cls,
                "label": labels[cls] if cls < len(labels) else f"class_{cls}",
                "score": float(scores[i]),
            }
        )
    return {"detections": dets, "num_detections": n}


# -------------------------------------------------------------------- job


class Job:
    """One manifest and its live progress. State moves go through the
    manager (one condition guards every job); ``history`` records each
    transition with a manager-relative time."""

    __slots__ = ("id", "seq", "dir", "model", "topk", "items", "total",
                 "state", "error", "completed", "cached", "errors",
                 "result_lines", "result_bytes", "chunks_done", "versions",
                 "history", "cancel", "resumed", "created_at", "started_at",
                 "finished_at", "source", "line_index", "tenant", "weight")

    def __init__(self, job_id: str, seq: int, job_dir: Path, model: str,
                 topk: int | None, items: list[dict], source: str,
                 t_rel: float, tenant: str = "default", weight: float = 1.0):
        self.id = job_id
        self.seq = seq
        self.dir = job_dir
        self.model = model
        self.topk = topk
        self.items = items  # [{"name": display name, "path": file}] in order
        self.total = len(items)
        self.state = QUEUED
        self.error: str | None = None
        self.completed = 0  # images spooled (durable with the checkpoint)
        self.cached = 0  # served from, or coalesced onto, the cache
        self.errors = 0  # per-image error lines (the job still finishes)
        self.result_lines = 0
        self.result_bytes = 0
        # the byte offset of each checkpoint-covered result line, extended
        # with result_lines under the manager's condition: a poll is one seek
        self.line_index: list[int] = []
        self.chunks_done = 0
        self.versions: list[str] = []  # every model@version that served work
        self.history: list[tuple[str, float]] = [(QUEUED, t_rel)]
        self.cancel = False
        self.resumed = False
        self.created_at = time.monotonic()
        self.started_at: float | None = None
        self.finished_at: float | None = None
        self.source = source  # "upload" | "dir"
        # the tenant whose token bucket the job's batches charge, and the
        # job-vs-job weight (the runner takes the heaviest QUEUED job first,
        # FIFO among equals)
        self.tenant = tenant or "default"
        self.weight = float(weight)

    @property
    def results_path(self) -> Path:
        return self.dir / "results.jsonl"

    def snapshot(self) -> dict:
        now = time.monotonic()
        end = self.finished_at if self.finished_at is not None else now
        return {
            "id": self.id,
            "state": self.state,
            "model": self.model,
            "topk": self.topk,
            "source": self.source,
            "tenant": self.tenant,
            "weight": self.weight,
            "total": self.total,
            "completed": self.completed,
            "cached": self.cached,
            "errors": self.errors,
            "result_lines": self.result_lines,
            "chunks_done": self.chunks_done,
            "versions": list(self.versions),
            "resumed": self.resumed,
            "age_s": round(now - self.created_at, 1),
            "run_s": (round(end - self.started_at, 2)
                      if self.started_at is not None else None),
            "history": [{"state": s, "t_s": round(t, 3)} for s, t in list(self.history)],
            **({"error": self.error} if self.error else {}),
        }


class _Chunk:
    """One staged slice of a manifest: the version it resolved, its top-k,
    one slot per image, and the chunk's span."""

    __slots__ = ("start", "end", "mv", "topk", "slots", "span")

    def __init__(self, start, end, mv, topk, slots, span):
        self.start = start
        self.end = end
        self.mv = mv
        self.topk = topk
        self.slots = slots
        self.span = span


# ------------------------------------------------------------ the manager


class JobManager:
    """Every job, their files under ``jobs_dir`` and the one runner thread
    (jobs run one at a time: they share the same gated device budget).
    Everything on the device goes through ``registry.acquire`` and the
    version's batcher, so mock engines drive the whole lifecycle."""

    def __init__(self, registry, cache, server_cfg, obs=None):
        self.registry = registry
        self.cache = cache
        self.obs = obs
        self.cfg = server_cfg
        self.dir = Path(server_cfg.jobs_dir or "jobs")
        self.dir.mkdir(parents=True, exist_ok=True)
        self.bulk_batch = max(1, int(server_cfg.jobs_batch))
        self.max_inflight = max(1, int(server_cfg.jobs_max_inflight))
        self.max_items = int(server_cfg.jobs_max_items)
        # a chunk's await bound: generous (throughput traffic); past it its
        # stragglers retry one by one, then become error lines
        self.await_timeout_s = max(60.0, server_cfg.request_timeout_s * 4)
        # staging threads: decode into the slab is the chunk's CPU cost; 4
        # stage 256 images in ~10 ms without crowding the HTTP workers
        self.decode_threads = max(1, int(server_cfg.jobs_decode_threads
                                         or min(4, os.cpu_count() or 4)))
        self._decode_pool: ThreadPoolExecutor | None = None
        self._cond = named_condition("jobs.cond")
        self._jobs: dict[str, Job] = {}
        self._order: list[str] = []  # submission order (queue and listing)
        self._seq = 0
        self._running = True
        self._runner: threading.Thread | None = None
        self._t0 = time.monotonic()
        self._images_total = self._cached_total = 0
        self._errors_total = self._chunks_total = 0
        # a hot swap pauses and re-versions running jobs; a new SERVING
        # version wakes the paused ones
        registry.add_retire_listener(self._on_retire)
        registry.add_serving_listener(self._on_serving)
        self._recover()

    # -------------------------------------------------------------- submit

    def submit_upload(self, files: list[tuple[str, bytes]], model: str | None,
                      topk: int | None, tenant: str = "default",
                      weight: float = 1.0) -> Job:
        """Register an uploaded manifest: every part is spooled to the job's
        ``input/`` first (the job must outlive the request body)."""
        if not files:
            raise ValueError("job upload carries no file parts")
        if len(files) > self.max_items:
            # refused, not truncated: a truncated job would report DONE
            raise ValueError(
                f"manifest of {len(files)} items exceeds the "
                f"jobs_max_items cap ({self.max_items}); split the job")
        model = self._check_model(model)
        job_id, job_dir, seq = self._new_job_dir()
        input_dir = job_dir / "input"
        input_dir.mkdir(parents=True, exist_ok=True)
        items = []
        for i, (name, data) in enumerate(files):
            safe = _SAFE_NAME.sub("_", name or "img")[-80:] or "img"
            p = input_dir / f"{i:06d}_{safe}"
            p.write_bytes(data)
            items.append({"name": name or safe, "path": str(p)})
        return self._register(job_id, seq, job_dir, model, topk, items, "upload",
                              tenant=tenant, weight=weight)

    def submit_dir(self, src: str, model: str | None, topk: int | None,
                   glob: str = "*", recursive: bool = False,
                   tenant: str = "default", weight: float = 1.0) -> Job:
        """Register a server-side directory (nothing is copied: the manifest
        records paths). The same trust as the admin ``/models`` routes."""
        model = self._check_model(model)
        root = Path(src)
        if not root.is_dir():
            raise ValueError(f"not a directory: {src}")
        it = root.rglob(glob) if recursive else root.glob(glob)
        paths = sorted(p for p in it
                       if p.is_file() and p.suffix.lower() in _IMAGE_SUFFIXES)
        if len(paths) > self.max_items:
            raise ValueError(
                f"{len(paths)} images under {src} exceed the "
                f"jobs_max_items cap ({self.max_items}); narrow the glob "
                f"or split the job")
        if not paths:
            raise ValueError(
                f"no images matching {glob!r} under {src} "
                f"(extensions: {', '.join(_IMAGE_SUFFIXES)})")
        job_id, job_dir, seq = self._new_job_dir()
        items = [{"name": str(p.relative_to(root)), "path": str(p)} for p in paths]
        return self._register(job_id, seq, job_dir, model, topk, items, "dir",
                              tenant=tenant, weight=weight)

    def _check_model(self, model: str | None) -> str:
        """The model NAME, checked at submit (unknown: 404 now, not a FAILED
        job later). A version pin is refused: a job outlives versions."""
        model = model or self.registry.default_model
        if not model:
            raise UnknownModel("no model given and no default model")
        if "@" in model:
            raise ValueError(
                f"jobs take a model NAME, not a pinned version ({model!r}): "
                "a job survives hot-swaps by re-versioning its remaining work")
        try:
            self.registry.release(self.registry.acquire(model))
        except ModelNotServing:
            pass  # known, between versions: the job waits, PAUSED
        return model

    def _new_job_dir(self) -> tuple[str, Path, int]:
        with self._cond:
            self._seq += 1
            seq = self._seq
        # a random suffix keeps ids unique across restarts without a clock
        job_id = f"j{seq:05d}-{os.urandom(3).hex()}"
        d = self.dir / job_id
        d.mkdir(parents=True, exist_ok=True)
        return job_id, d, seq

    def _register(self, job_id, seq, job_dir, model, topk, items, source,
                  tenant: str = "default", weight: float = 1.0) -> Job:
        job = Job(job_id, seq, job_dir, model, topk, items, source,
                  time.monotonic() - self._t0, tenant=tenant, weight=weight)
        self._write_json(job_dir / "manifest.json", {
            "id": job_id, "seq": seq, "model": model, "topk": topk,
            "source": source, "items": items, "tenant": job.tenant,
            "weight": job.weight,
        })
        self._persist_checkpoint(job)
        with self._cond:
            self._jobs[job_id] = job
            self._order.append(job_id)
            self._ensure_runner_locked()
            self._cond.notify_all()
        log.info("job %s registered: %d images, model=%s, source=%s",
                 job_id, job.total, model, source)
        return job

    # --------------------------------------------------------- persistence

    @staticmethod
    def _write_json(path: Path, doc: dict):
        tmp = path.with_name(path.name + ".tmp")
        tmp.write_text(json.dumps(doc, indent=1))
        os.replace(tmp, path)

    def _persist_checkpoint(self, job: Job):
        """The durable progress record. PAUSED (a running job waiting for a
        version) persists as RUNNING."""
        with self._cond:
            doc = {
                "state": RUNNING if job.state == PAUSED else job.state,
                "completed": job.completed,
                "cached": job.cached,
                "errors": job.errors,
                "result_lines": job.result_lines,
                "result_bytes": job.result_bytes,
                "chunks_done": job.chunks_done,
                "versions": list(job.versions),
                "error": job.error,
            }
        self._write_json(job.dir / "checkpoint.json", doc)

    def _recover(self):
        """Re-register every job under ``jobs_dir``: terminal ones for
        listing and streaming; the rest (persisted QUEUED or RUNNING: a
        crash or SIGTERM) truncate their results to the checkpoint and
        re-queue from it."""
        found = []
        for d in self.dir.iterdir() if self.dir.is_dir() else ():
            mf = d / "manifest.json"
            if not mf.is_file():
                continue
            try:
                man = json.loads(mf.read_text())
            except (ValueError, OSError):
                log.exception("unreadable job manifest %s (skipped)", d)
                continue
            # a torn checkpoint replays the job from scratch; it never
            # skips a job whose manifest and results are whole
            cp = {}
            cpf = d / "checkpoint.json"
            try:
                if cpf.is_file():
                    cp = json.loads(cpf.read_text())
            except (ValueError, OSError):
                log.warning("corrupt checkpoint in %s: job %s replays from scratch",
                            d, man.get("id"))
            try:
                found.append((int(man.get("seq", 0)), d, man, cp))
            except (TypeError, ValueError):
                log.exception("unreadable job dir %s (skipped)", d)
        for seq, d, man, cp in sorted(found, key=lambda f: (f[0], str(f[1]))):
            try:
                weight = float(man.get("weight", 1.0))
            except (TypeError, ValueError):
                weight = 1.0
            job = Job(man["id"], seq, d, man.get("model"), man.get("topk"),
                      list(man.get("items", [])), man.get("source", "dir"),
                      time.monotonic() - self._t0,
                      tenant=str(man.get("tenant") or "default"), weight=weight)
            state = cp.get("state", QUEUED)
            job.completed = int(cp.get("completed", 0))
            job.cached = int(cp.get("cached", 0))
            job.errors = int(cp.get("errors", 0))
            job.result_lines = int(cp.get("result_lines", 0))
            job.result_bytes = int(cp.get("result_bytes", 0))
            job.chunks_done = int(cp.get("chunks_done", 0))
            job.versions = list(cp.get("versions", []))
            job.error = cp.get("error")
            if state in TERMINAL:
                job.state = state
                job.items = []  # listing and streaming never need the manifest
                job.history.append((state, time.monotonic() - self._t0))
            else:
                # lines past the checkpoint go: the replayed chunk then
                # cannot duplicate them
                self._truncate_results(job)
                job.resumed = True
                log.info("job %s resumes from checkpoint: %d/%d images",
                         job.id, job.completed, job.total)
            self._build_line_index(job)
            with self._cond:
                self._jobs[job.id] = job
                self._order.append(job.id)
                self._seq = max(self._seq, seq)
                if job.state not in TERMINAL:
                    self._ensure_runner_locked()
                self._cond.notify_all()

    def _build_line_index(self, job: Job):
        """One scan of a restored job's results rebuilds its line index
        (new lines extend it as they spool); runs before any reader."""
        job.line_index = []
        if job.result_lines == 0 or not job.results_path.exists():
            return
        off = 0
        with open(job.results_path, "rb") as f:
            for line in f:
                if len(job.line_index) >= job.result_lines:
                    break
                job.line_index.append(off)
                off += len(line)

    def _truncate_results(self, job: Job):
        p = job.results_path
        if not p.exists():
            job.result_lines = job.result_bytes = 0
            job.completed = job.cached = job.errors = job.chunks_done = 0
            return
        size = p.stat().st_size
        if size > job.result_bytes:
            with open(p, "ab") as f:
                f.truncate(job.result_bytes)
        elif size < job.result_bytes:
            # the file is shorter than the checkpoint says (lost writes):
            # trust the file and replay from its line count
            lines = p.read_bytes().splitlines()
            job.result_bytes = size
            job.result_lines = len(lines)
            job.completed = min(job.completed, job.result_lines)

    # ------------------------------------------------------------- queries

    def _job(self, job_id: str) -> Job:
        with self._cond:
            job = self._jobs.get(job_id)
        if job is None:
            raise UnknownJob(f"unknown job '{job_id}'")
        return job

    def get_job(self, job_id: str) -> dict:
        return self._job(job_id).snapshot()

    def list_jobs(self) -> list[dict]:
        with self._cond:
            order = list(self._order)
            jobs = dict(self._jobs)
        return [jobs[i].snapshot() for i in order if i in jobs]

    def read_results(self, job_id: str, offset: int = 0, limit: int = 10_000,
                     wait_s: float = 0.0):
        """Result lines from ``offset`` on (at most ``limit``, at least 1),
        as bytes. With ``wait_s`` and nothing new yet, blocks until lines
        land or the job ends (the long poll). Returns ``(lines,
        next_offset, state, total_lines)``; only checkpoint-covered lines
        are served, never bytes a recovery could truncate."""
        job = self._job(job_id)
        offset = max(0, int(offset))
        limit = max(1, int(limit))
        deadline = time.monotonic() + max(0.0, wait_s)
        with self._cond:
            while job.result_lines <= offset and job.state not in TERMINAL:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cond.wait(timeout=min(0.5, remaining))
            state = job.state
            have = job.result_lines
        lines: list[bytes] = []
        if have > offset:
            want = min(limit, have - offset)
            with open(job.results_path, "rb") as f:
                # index entries below ``have`` never change once published;
                # a results file shorter than its index is scanned instead
                if offset < len(job.line_index):
                    f.seek(job.line_index[offset])
                    body = f
                else:
                    body = (ln for i, ln in enumerate(f) if i >= offset)
                for line in body:
                    if len(lines) >= want:
                        break
                    lines.append(line.rstrip(b"\n"))
        return lines, offset + len(lines), state, have

    def stats(self) -> dict:
        """The ``/stats`` jobs block (and the /metrics families' source)."""
        with self._cond:
            by_state: dict[str, int] = {}
            for job in self._jobs.values():
                by_state[job.state] = by_state.get(job.state, 0) + 1
            recent = [self._jobs[i] for i in self._order[-20:] if i in self._jobs]
            return {
                "enabled": True,
                "dir": str(self.dir),
                "bulk_batch": self.bulk_batch,
                "max_inflight": self.max_inflight,
                "by_state": by_state,
                "active": by_state.get(RUNNING, 0) + by_state.get(PAUSED, 0),
                "images_done_total": self._images_total,
                "images_cached_total": self._cached_total,
                "image_errors_total": self._errors_total,
                "chunks_total": self._chunks_total,
                # twdlint: disable=lock-order(j is a Job, whose snapshot() takes no lock; the analyzer's name-based resolution cannot type comprehension vars and matches the other snapshot() impls)
                "jobs": [j.snapshot() for j in recent],
            }

    # -------------------------------------------------------------- cancel

    def cancel_job(self, job_id: str) -> dict:
        """QUEUED cancels at once; RUNNING/PAUSED set the flag and the
        runner ends the job at its next chunk boundary (spooled chunks stay
        streamable)."""
        job = self._job(job_id)
        persist = False
        with self._cond:
            if job.state == QUEUED:
                self._set_state_locked(job, CANCELLED)
                persist = True
            elif job.state not in TERMINAL:
                job.cancel = True
                self._cond.notify_all()
        if persist:
            self._persist_checkpoint(job)
        return job.snapshot()

    # ----------------------------------------------------------- lifecycle

    def _set_state_locked(self, job: Job, state: str, error: str | None = None):
        if state not in _TRANSITIONS[job.state]:
            raise RuntimeError(f"illegal job transition {job.id}: {job.state} -> {state}")
        job.state = state
        if error is not None:
            job.error = error
        if state == RUNNING and job.started_at is None:
            job.started_at = time.monotonic()
        if state in TERMINAL:
            job.finished_at = time.monotonic()
            job.items = []  # manifest.json keeps it; memory need not
        job.history.append((state, time.monotonic() - self._t0))
        self._cond.notify_all()

    def _finalize(self, job: Job, state: str, error: str | None = None):
        with self._cond:
            if job.state in TERMINAL:
                return
            if job.state == PAUSED and state == DONE:
                # a drain paused the job while its last chunk finished on the
                # old version: resume, then finish, to keep the machine legal
                self._set_state_locked(job, RUNNING)
            self._set_state_locked(job, state, error)
        self._persist_checkpoint(job)
        log.info("job %s %s (%d/%d images, %d cached, %d errors)", job.id, state,
                 job.completed, job.total, job.cached, job.errors)

    def _on_retire(self, name, version):
        # under the registry's lock, at the DRAINING flip: flags only
        with self._cond:
            for job in self._jobs.values():
                if job.state == RUNNING and job.model == name:
                    self._set_state_locked(job, PAUSED)
            self._cond.notify_all()

    def _on_serving(self, name, version):
        with self._cond:
            self._cond.notify_all()  # paused jobs re-acquire

    # --------------------------------------------------------------- runner

    def _ensure_runner_locked(self):
        if self._runner is None or not self._runner.is_alive():
            self._runner = threading.Thread(target=self._run_loop, name="job-runner",
                                            daemon=True)
            self._runner.start()

    def _next_job(self) -> Job | None:
        with self._cond:
            while True:
                if not self._running:
                    return None
                # the heaviest QUEUED job first; the _order scan keeps FIFO
                # among equal weights
                best = None
                for jid in self._order:
                    job = self._jobs.get(jid)
                    if job is None or job.state != QUEUED:
                        continue
                    if job.cancel:
                        self._set_state_locked(job, CANCELLED)
                        continue
                    if best is None or job.weight > best.weight:
                        best = job
                if best is not None:
                    self._set_state_locked(best, RUNNING)
                    return best
                self._cond.wait(timeout=0.5)

    def _run_loop(self):
        while True:
            job = self._next_job()
            if job is None:
                return
            self._persist_checkpoint(job)  # the durable RUNNING marker
            try:
                self._run_job(job)
            except Exception as e:
                # one poisoned manifest must not stop the jobs behind it
                log.exception("job %s failed", job.id)
                try:
                    self._finalize(job, FAILED, f"{type(e).__name__}: {e}"[:500])
                except Exception:
                    log.exception("job %s could not finalize", job.id)

    def _should_stop(self, job: Job) -> bool:
        with self._cond:
            return not self._running or job.cancel

    def _run_job(self, job: Job):
        """Stage up to ``max_inflight`` chunks ahead (decode of chunk N+1
        overlaps the device's chunk N), finish them in order, checkpoint
        each. Stop and cancel break at chunk boundaries: staged chunks are
        aborted unspooled and replay on resume."""
        window: deque[_Chunk] = deque()
        next_idx = job.completed
        interrupted = False
        while True:
            if self._should_stop(job):
                interrupted = True
                break
            if next_idx < job.total and len(window) < self.max_inflight:
                ch = self._stage_chunk(job, next_idx)
                if ch is None:
                    interrupted = True
                    break
                window.append(ch)
                next_idx = ch.end
            elif window:
                if not self._finish_chunk(job, window.popleft()):
                    interrupted = True
                    break
            else:
                break
        for ch in window:
            self._abort_chunk(ch, RuntimeError("job interrupted"))
        if not interrupted:
            self._finalize(job, DONE)
            return
        with self._cond:
            cancelled = job.cancel
        if cancelled:
            self._finalize(job, CANCELLED)
        else:
            # the manager is stopping: the job stays RUNNING on disk with its
            # last chunk's checkpoint, and the restart resumes it
            self._persist_checkpoint(job)
            log.info("job %s checkpointed at %d/%d for shutdown", job.id,
                     job.completed, job.total)

    # -------------------------------------------------------------- staging

    def _acquire_serving(self, job: Job):
        """The job's model at a SERVING version, the job PAUSED while there
        is none (a swap's window). None on cancel or stop; the job FAILS if
        the model's name is gone from the registry."""
        while True:
            with self._cond:
                if not self._running or job.cancel:
                    return None
            try:
                mv = self.registry.acquire(job.model)
            except ModelNotServing:
                with self._cond:
                    if not self._running or job.cancel:
                        return None
                    if job.state == RUNNING:
                        self._set_state_locked(job, PAUSED)
                        log.info("job %s paused: model '%s' has no serving version",
                                 job.id, job.model)
                    self._cond.wait(timeout=0.25)
                continue
            except UnknownModel as e:
                self._finalize(job, FAILED, str(e))
                return None
            except RuntimeError:
                return None  # the registry stopped: the shutdown path
            resumed = abort = False
            with self._cond:
                if not self._running or job.cancel:
                    abort = True
                else:
                    if job.state == PAUSED:
                        self._set_state_locked(job, RUNNING)
                        resumed = True
                    if mv.ref not in job.versions:
                        job.versions.append(mv.ref)
            if abort:
                self.registry.release(mv)
                return None
            if resumed:
                log.info("job %s resumed on %s", job.id, mv.ref)
            return mv

    def _stage_chunk(self, job: Job, start: int) -> _Chunk | None:
        """Decode, consult the cache and lease bulk slots for one chunk.
        None on cancel or stop, its partial staging unwound."""
        while True:
            mv = self._acquire_serving(job)
            if mv is None:
                return None
            batcher = mv.batcher
            if batcher is not None:
                break
            # resolved mid-teardown: give it back and resolve again
            self.registry.release(mv)
            if self._should_stop(job):
                return None
            time.sleep(0.05)
        end = min(job.total, start + self.bulk_batch)
        topk = clamp_topk(job.topk, mv.engine)
        if self._decode_pool is None and self.decode_threads > 1:
            self._decode_pool = ThreadPoolExecutor(max_workers=self.decode_threads,
                                                   thread_name_prefix="job-decode")
        slots: list[tuple] = []
        decode_s = cache_s = 0.0
        try:
            if self._decode_pool is not None and end - start > 1:
                # slots[i] is item start + i; cancel lands at the boundary
                futs = [self._decode_pool.submit(self._stage_item, mv, batcher, job.items[i],
                                                 topk, job.tenant)
                        for i in range(start, end)]
                for fi, f in enumerate(futs):
                    try:
                        slot, d_s, c_s = f.result()
                    except Exception:
                        # the siblings still staging take leases and lead
                        # flights: collect them so the unwind below ends them
                        for g in futs[fi + 1:]:
                            try:
                                slots.append(g.result()[0])
                            except Exception:
                                pass
                        raise
                    decode_s += d_s
                    cache_s += c_s
                    slots.append(slot)
            else:
                for i in range(start, end):
                    if self._should_stop(job):
                        self._abort_slots(slots, RuntimeError("job interrupted"))
                        self.registry.release(mv)
                        return None
                    slot, d_s, c_s = self._stage_item(mv, batcher, job.items[i], topk,
                                                      job.tenant)
                    decode_s += d_s
                    cache_s += c_s
                    slots.append(slot)
        except Exception as e:
            self._abort_slots(slots, e)
            self.registry.release(mv)
            raise
        # a full chunk sealed at capacity; the manifest's tail must not wait
        # out the bulk window
        if hasattr(batcher, "flush_bulk"):
            batcher.flush_bulk()
        # the span is made only once staging committed: every span made
        # reaches obs.finish
        span = Span()
        span.note("job", job.id)
        span.note("chunk_start", start)
        span.note("class", "bulk")  # never mixed into interactive figures
        span.add("job_decode", decode_s)
        if cache_s:
            span.add("job_cache_lookup", cache_s)
        return _Chunk(start, end, mv, topk, slots, span)

    def _stage_item(self, mv, batcher, item: dict, topk: int, tenant: str = "default"):
        """One manifest item → one slot (a staging thread's body). A read
        error becomes an error line; a batcher shutting down under it (a
        drain racing the staging) defers the item to the retry path."""
        try:
            data = Path(item["path"]).read_bytes()
        except OSError as e:
            return ("err", f"read failed: {e}"), 0.0, 0.0
        try:
            return self._stage_one(mv, batcher, data, topk, tenant=tenant)
        except ShuttingDown:
            return ("retry",), 0.0, 0.0

    def _stage_one(self, mv, batcher, data: bytes, topk: int, tenant: str = "default"):
        """One image → one slot and its (decode, cache) seconds:
        ``("done", payload)`` from the cache, ``("wait", flight)`` coalesced
        onto another computation, ``("own", future, orig, flight, lease)``
        through a bulk slot, or ``("err", message)``. The request path's
        staging (``http.App._stage``) with ``bulk=True``: libjpeg decodes
        into the leased pinned row (ragged or classic), PIL takes the rest;
        a batcher without leases gets ``engine.prepare_bytes`` and
        ``submit``."""
        cache = self.cache if self.cache is not None and self.cache.enabled else None
        decode_s = 0.0
        chaos = getattr(self.registry, "chaos", None)
        if chaos is not None and chaos.decode_fault():
            # an injected decode failure is this image's error line
            return ("err", "could not decode image (chaos: injected decode failure)"), 0.0, 0.0
        engine = mv.engine
        if getattr(batcher, "supports_lease", False):
            from .. import native
            from ..ops.image import decode_image, fit_to_bucket

            buckets = engine.cfg.canvas_buckets
            wire = engine.cfg.wire_format
            ragged = getattr(engine, "ragged", False)
            t0 = time.monotonic()
            plan = (native.plan_decode_packed(data, buckets) if ragged
                    else native.plan_decode(data, buckets, wire))
            decode_s += time.monotonic() - t0
            if plan is not None:
                if ragged:
                    s, need, _dhw, orig = plan
                    lease = batcher.lease_ragged(need, s, tenant=tenant, bulk=True)
                else:
                    s, shape, orig = plan
                    lease = batcher.lease(shape, tenant=tenant, bulk=True)
                t0 = time.monotonic()
                try:
                    hw = (native.decode_packed_into(data, lease.row, s) if ragged
                          else native.decode_into_row(data, lease.row, s, wire, trailer=True))
                except BaseException:
                    lease.release()
                    raise
                decode_s += time.monotonic() - t0
                if hw is not None:
                    t0 = time.monotonic()
                    digest = None
                    if cache is not None:
                        # the request path's digest bytes: the tight h·w·3
                        # decode, or the canvas without the row's trailer
                        digest = (packed_digest(lease.row[: hw[0] * hw[1] * 3], hw, s)
                                  if ragged else canvas_digest(lease.row[:-_TRAILER_BYTES], hw))
                    slot, cache_s = self._settle(mv, cache, digest, topk, orig, t0,
                                                 lease=lease, hw=hw)
                    return slot, decode_s, cache_s
                lease.release()  # the header parsed, the stream did not: PIL tries
            t0 = time.monotonic()
            try:  # PIL: UnidentifiedImageError is an OSError
                if ragged:
                    image = decode_image(data)
                    canvas, hw, s = fit_to_bucket(image, buckets)
                    orig = tuple(image.shape[:2])
                else:
                    canvas, hw, orig = native.decode_pil(data, buckets, wire)
            except (OSError, ValueError):
                return ("err", "could not decode image"), decode_s + time.monotonic() - t0, 0.0
            t1 = time.monotonic()
            decode_s += t1 - t0
            digest = None
            if cache is not None:
                digest = packed_digest(canvas, hw, s) if ragged else canvas_digest(canvas, hw)

            def take():
                lease = (batcher.lease_ragged(canvas.nbytes, s, tenant=tenant, bulk=True)
                         if ragged else batcher.lease(canvas.shape, tenant=tenant, bulk=True))
                lease.commit(hw, canvas=canvas)  # a failed copy releases the slot
                return lease

            slot, cache_s = self._settle(mv, cache, digest, topk, orig, t1, take=take)
            return slot, decode_s, cache_s
        t0 = time.monotonic()
        try:
            canvas, hw, orig = engine.prepare_bytes(data)
        except Exception:
            return ("err", "could not decode image"), time.monotonic() - t0, 0.0
        t1 = time.monotonic()
        decode_s += t1 - t0
        digest = canvas_digest(canvas, hw) if cache is not None else None

        def submit():
            return None, batcher.submit(canvas, hw, bulk=True)

        slot, cache_s = self._settle(mv, cache, digest, topk, orig, t1, submit=submit)
        return slot, decode_s, cache_s

    def _settle(self, mv, cache, digest: str | None, topk: int, orig, t0: float,
                lease=None, hw=None, take=None, submit=None):
        """One decoded image's cache lookup and slot: ``lease`` holds it
        decoded already, valid size ``hw``; else ``take()`` leases a slot
        and copies it in, or ``submit()`` queues it, on a miss only. Returns
        the slot and the lookup's seconds since ``t0``. Past a "lead" answer
        any raise releases the lease, then aborts the flight, each step
        guarded: a leaked flight would wedge every waiter coalesced onto it."""
        flight = None
        cache_s = 0.0
        try:
            if cache is not None:
                kind, obj = cache.begin(make_key(mv.name, mv.version, digest, topk,
                                                 mv.model_cfg.dtype), mv.name, bulk=True)
                cache_s = time.monotonic() - t0
                if kind != "lead":
                    if lease is not None:
                        lease.release()  # no device work: the slot ships as a hole
                    return (("done", obj.payload) if kind == "hit" else ("wait", obj)), cache_s
                flight = obj
            future = None
            if lease is not None:
                future = lease.commit(hw)
            elif take is not None:
                lease = take()
                future = lease.future
            else:
                lease, future = submit()
        except BaseException as e:
            try:
                if lease is not None:
                    lease.release()
            finally:
                if flight is not None:
                    cache.abort(flight, e)
            raise
        return ("own", future, orig, flight, lease), cache_s

    def _abort_slots(self, slots, exc: BaseException):
        """Unwind staged, unfinished slots: cancel own futures, release own
        leases (their batches ship them as holes), abort led flights so that
        coalesced waiters fail over instead of hanging."""
        for slot in slots:
            if slot[0] != "own":
                continue
            _, future, _orig, flight, lease = slot
            try:
                future.cancel()
            except Exception:
                pass
            if lease is not None:
                try:
                    lease.release()
                except Exception:
                    pass
            if flight is not None and self.cache is not None:
                self.cache.abort(flight, exc)

    def _abort_chunk(self, ch: _Chunk, exc: BaseException):
        self._abort_slots(ch.slots, exc)
        self.registry.release(ch.mv)

    # ------------------------------------------------------------ finishing

    def _finish_chunk(self, job: Job, ch: _Chunk) -> bool:
        """Await a staged chunk, retry the items whose batch died under a
        swap or a stop against the serving version, append and fsync its
        result lines, then checkpoint. False when the chunk could not
        complete (stopping or cancelled): then nothing of it is spooled."""
        mv, topk = ch.mv, ch.topk
        n = len(ch.slots)
        payloads: list = [None] * n
        cached = [False] * n
        errs: list = [None] * n
        retry: list[int] = []
        deadline = time.monotonic() + self.await_timeout_s
        t_await0 = time.monotonic()
        try:
            # own slots first: a leader publishes (waking every waiter,
            # other requests' too) before this chunk blocks on a foreign flight
            for i, slot in enumerate(ch.slots):
                kind = slot[0]
                if kind == "err":
                    errs[i] = slot[1]
                elif kind == "retry":
                    retry.append(i)  # the staging lost its batcher to a drain
                elif kind == "done":
                    payloads[i], cached[i] = slot[1], True
                elif kind == "own":
                    _, future, orig, flight, _lease = slot
                    try:
                        row = future.result(timeout=max(0.0, deadline - time.monotonic()))
                    except BaseException as e:  # noqa: BLE001 — retried below
                        if flight is not None and self.cache is not None:
                            self.cache.abort(flight, e)
                        retry.append(i)
                        continue
                    payload = format_result_row(row, orig, topk, mv, trace_id=ch.span.trace_id)
                    if flight is not None:
                        self.cache.complete(flight, payload)
                    payloads[i] = payload
            for i, slot in enumerate(ch.slots):
                if slot[0] != "wait":
                    continue
                try:
                    payload, _etag = slot[1].future.result(
                        timeout=max(0.0, deadline - time.monotonic()))
                except BaseException:  # noqa: BLE001 — the flight retired or failed
                    retry.append(i)
                    continue
                payloads[i], cached[i] = payload, True
        finally:
            self.registry.release(mv)
        # stragglers (a drained version, a stopped batcher, an expired lease,
        # the chunk's timeout): each recomputes on the serving version; only
        # a repeated failure becomes an error line
        for i in sorted(retry):
            out = self._retry_item(job, job.items[ch.start + i])
            if out is None:
                return False  # stopping or cancelled: the chunk stays unspooled
            payloads[i], cached[i], errs[i] = out
        ch.span.add("job_await", time.monotonic() - t_await0)
        t_spool = time.monotonic()
        lines = []
        n_err = 0
        for i in range(n):
            item = job.items[ch.start + i]
            rec = {"i": ch.start + i, "name": item["name"]}
            if errs[i] is not None and payloads[i] is None:
                rec["error"] = str(errs[i])
                rec["trace_id"] = ch.span.trace_id
                n_err += 1
            else:
                rec.update(payloads[i])
                if cached[i]:
                    rec["cached"] = True
                # a payload an interactive leader computed has no trace id:
                # the chunk's trace joins this row
                rec.setdefault("trace_id", ch.span.trace_id)
            lines.append(json.dumps(rec))
        encoded = [ln.encode() + b"\n" for ln in lines]
        blob = b"".join(encoded)
        offs = []
        off = job.result_bytes  # the runner's own field
        for piece in encoded:
            offs.append(off)
            off += len(piece)
        # append and fsync BEFORE the checkpoint moves
        with open(job.results_path, "ab") as f:
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        n_cached = sum(cached)
        with self._cond:
            job.line_index.extend(offs)  # with result_lines, under one hold
            job.completed += n
            job.cached += n_cached
            job.errors += n_err
            job.result_lines += n
            job.result_bytes += len(blob)
            job.chunks_done += 1
            self._images_total += n
            self._cached_total += n_cached
            self._errors_total += n_err
            self._chunks_total += 1
            self._cond.notify_all()  # long pollers
        self._persist_checkpoint(job)
        ch.span.add("job_spool", time.monotonic() - t_spool)
        ch.span.note("rows", n)
        ch.span.note("cached", n_cached)
        if self.obs is not None:
            self.obs.finish(ch.span, 200)
        return True

    def _retry_item(self, job: Job, item: dict):
        """Recompute one straggler on its own: ``(payload, cached, error)``,
        or None when stopping or cancelled."""
        last: BaseException | None = None
        for _attempt in range(3):
            mv = self._acquire_serving(job)
            if mv is None:
                return None
            batcher = mv.batcher
            if batcher is None:
                self.registry.release(mv)
                time.sleep(0.05)
                continue
            topk = clamp_topk(job.topk, mv.engine)
            try:
                data = Path(item["path"]).read_bytes()
            except OSError as e:
                self.registry.release(mv)
                return None, False, f"read failed: {e}"
            slot = None
            try:
                slot, _d, _c = self._stage_one(mv, batcher, data, topk, tenant=job.tenant)
                if hasattr(batcher, "flush_bulk"):
                    batcher.flush_bulk()
                kind = slot[0]
                if kind == "err":
                    return None, False, slot[1]
                if kind == "done":
                    return slot[1], True, None
                if kind == "wait":
                    payload, _etag = slot[1].future.result(timeout=self.await_timeout_s)
                    return payload, True, None
                _, future, orig, flight, _lease = slot
                row = future.result(timeout=self.await_timeout_s)
                # outside any chunk span: the spool stamps the chunk's trace
                payload = format_result_row(row, orig, topk, mv)
                if flight is not None:
                    self.cache.complete(flight, payload)
                return payload, False, None
            except Exception as e:  # noqa: BLE001 — every attempt is bounded
                last = e
                if slot is not None:
                    self._abort_slots([slot], e)
            finally:
                self.registry.release(mv)
        return None, False, f"retries exhausted: {type(last).__name__}: {last}"

    # ----------------------------------------------------------------- stop

    def stop(self, grace_s: float = 10.0):
        """Shutdown: the runner finishes and checkpoints its chunk window,
        aborts what lies past it, and exits (a restart resumes from the
        checkpoint). Call before the registry stops: in-flight bulk futures
        need live batchers to resolve."""
        with self._cond:
            self._running = False
            self._cond.notify_all()
            runner = self._runner
        if runner is not None and runner.is_alive():
            runner.join(timeout=grace_s)
            if runner.is_alive():
                log.warning("job runner still busy after %.1fs grace; progress is bounded "
                            "by the last durable chunk checkpoint", grace_s)
        pool = self._decode_pool
        if pool is not None and (runner is None or not runner.is_alive()):
            pool.shutdown(wait=False, cancel_futures=True)
