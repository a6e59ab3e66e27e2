"""The port's bulk jobs (``serving/jobs.py``), the batcher's bulk class and
the ``/jobs`` routes, on the CPU, held against the JAX package.

The counterpart of each case of ``tests/test_jobs.py`` on mock engines over
the port's real batchers, slabs, registry and App (real JPEGs, decoded by
the port's libjpeg into leased rows, on the ragged, rgb and yuv420 wires):
the lifecycle and its history, ordered results, an oversized manifest,
offset resume and the long poll, cancel mid-run, resume after a simulated
restart, a torn results tail, a hot swap mid-job with zero lost and zero
duplicated images, cache dedup with bulk accounting and the interactive
pre-warm, the HTTP routes, a graceful-shutdown checkpoint, a failed stage
aborting its led flight, the bulk gate's strict priority and batch growth,
the starvation valve and its clock, quota before the valve, blocking
backpressure, and trace ids that join the chunk spans. Then the two
packages side by side: one corpus through both ``JobManager``s on a real
Inception-v3 (width 0.25, 75 px, float32, the JAX engine's weights carried
by ``from_jax_params``), a jobs directory the reference wrote and then
stopped, recovered by the port, and fault 9 (a ``.json`` config without
``source`` or ``pb_path``) in both packages' ``model_config``.
"""

import http.client
import io
import json
import threading
import time
from dataclasses import replace
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from tensorflow_web_deploy_tpu.parallel.mesh import build_mesh
from tensorflow_web_deploy_tpu.serving import jobs as jjobs
from tensorflow_web_deploy_tpu.serving.engine import InferenceEngine as JaxEngine
from tensorflow_web_deploy_tpu.serving.registry import ModelRegistry as JaxRegistry
from tensorflow_web_deploy_tpu.serving.respcache import ResponseCache as JaxCache
from tensorflow_web_deploy_tpu.utils import config as jcfg
from tensorflow_web_deploy_tpu_torch.server import config_from_args, parse_args
from tensorflow_web_deploy_tpu_torch.serving.batcher import Batcher, ShuttingDown
from tensorflow_web_deploy_tpu_torch.serving.engine import InferenceEngine
from tensorflow_web_deploy_tpu_torch.serving.http import (
    App,
    make_http_server,
    shutdown_gracefully,
)
from tensorflow_web_deploy_tpu_torch.serving.jobs import (
    CANCELLED,
    DONE,
    PAUSED,
    QUEUED,
    RUNNING,
    JobManager,
)
from tensorflow_web_deploy_tpu_torch.serving.overload import AdmissionController
from tensorflow_web_deploy_tpu_torch.serving.registry import ModelRegistry
from tensorflow_web_deploy_tpu_torch.serving.respcache import ResponseCache
from tensorflow_web_deploy_tpu_torch.utils import config as tcfg
from tensorflow_web_deploy_tpu_torch.utils.metrics import Observability, parse_prometheus_text
from tests.test_torch_registry import _mc, jpeg
from tests.test_torch_respcache import ServeEngine, _png, post, serve_cfg

torch.set_num_threads(2)

WIRES = ("ragged", "rgb", "yuv420")


class JobEngine(ServeEngine):
    """The cache tests' mock engine (answers ``self.score``, which names the
    version) with a counting fetch gate: each permit of ``fetch_sem`` lets
    one batch's fetch through, and a bulk chunk of ``jobs_batch`` ≤
    ``max_batch`` images is one batch, so permits step a job chunk by
    chunk. ``prepare_bytes`` serves batchers without leases."""

    def __init__(self, cfg, score=0.5, fetch_gate=None, fetch_sem=None):
        super().__init__(cfg, score=score, fetch_gate=fetch_gate)
        self.fetch_sem = fetch_sem
        self.images = 0

    def dispatch_staged(self, slab, n):
        self.images += n
        return super().dispatch_staged(slab, n)

    def dispatch_ragged(self, slab, n):
        self.images += n
        return super().dispatch_ragged(slab, n)

    def fetch_outputs(self, n):
        if self.fetch_sem is not None:
            assert self.fetch_sem.acquire(timeout=30), "no fetch permit"
        return super().fetch_outputs(n)

    def prepare_bytes(self, data):
        img = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        canvas = np.zeros((16, 16, 3), np.uint8)
        h, w = img.shape[:2]
        canvas[:h, :w] = img[:16, :16]
        return canvas, (min(h, 16), min(w, 16)), (h, w)


class WideEngine(JobEngine):
    """Batch buckets up to 8, so that a bulk builder can outgrow the
    interactive ``max_batch`` of 2."""

    max_batch = 8
    batch_buckets = (1, 2, 4, 8)


def _cfg(tmp_path, wire="ragged", cache_bytes=0, jobs_batch=4, **kw):
    return serve_cfg(wire, jobs_dir=str(tmp_path / "jobs"), jobs_batch=jobs_batch,
                     jobs_max_inflight=1, cache_bytes=cache_bytes, drain_grace_s=3.0, **kw)


def _corpus(tmp_path, n, seeds=None, name="corpus"):
    """``n`` distinct seeded JPEGs (``seeds[i]`` repeats content) in a directory."""
    d = tmp_path / name
    d.mkdir(exist_ok=True)
    for i in range(n):
        (d / f"{i:03d}.jpg").write_bytes(jpeg(12, 10, seed=i if seeds is None else seeds[i]))
    return str(d)


def _registry(cfg, fetch_gate=None, fetch_sem=None, engine_cls=JobEngine):
    engines = []

    def factory(mc):
        e = engine_cls(cfg, score=round(0.1 * (len(engines) + 1), 3), fetch_gate=fetch_gate,
                       fetch_sem=fetch_sem)
        engines.append(e)
        return e

    r = ModelRegistry(cfg, engine_factory=factory, spec_resolver=_mc)
    r.load("m1", wait=True)
    return r, engines


def _stop(reg):
    reg.stop(grace_s=5.0)
    reg.close_engines()


def _wait_state(jm, job_id, states, timeout=20.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        doc = jm.get_job(job_id)
        if doc["state"] in states:
            return doc
        time.sleep(0.01)
    raise AssertionError(f"job never reached {states}: {jm.get_job(job_id)}")


def _wait_completed(jm, job_id, n, timeout=10.0):
    deadline = time.monotonic() + timeout
    while jm.get_job(job_id)["completed"] < n:
        assert time.monotonic() < deadline, jm.get_job(job_id)
        time.sleep(0.01)


def _indices(jm, job_id):
    lines, _off, _st, _tot = jm.read_results(job_id, 0, 100_000)
    return [json.loads(ln)["i"] for ln in lines]


def _release(sem, n):
    for _ in range(n):
        sem.release()


# --------------------------------------------------------------- lifecycle


@pytest.mark.parametrize("wire", WIRES)
def test_lifecycle_done_with_history_and_ordered_results(tmp_path, wire):
    cfg = _cfg(tmp_path, wire)
    reg, engines = _registry(cfg)
    jm = JobManager(reg, ResponseCache(0), cfg)
    try:
        job = jm.submit_dir(_corpus(tmp_path, 10), "m1", None)
        assert job.total == 10
        doc = _wait_state(jm, job.id, (DONE,))
        assert doc["completed"] == 10 and doc["errors"] == 0
        assert doc["chunks_done"] == 3  # 4 + 4 + 2 at jobs_batch 4
        assert doc["versions"] == ["m1@1"]
        assert [h["state"] for h in doc["history"]] == [QUEUED, RUNNING, DONE]
        assert _indices(jm, job.id) == list(range(10)), "results spool in manifest order"
        rows = [json.loads(ln) for ln in jm.read_results(job.id, 0, 100)[0]]
        assert all(r["predictions"][0]["score"] == pytest.approx(0.1) for r in rows)
        cp = json.loads((Path(cfg.jobs_dir) / job.id / "checkpoint.json").read_text())
        assert cp["state"] == DONE and cp["completed"] == 10
        assert engines[0].images == 10  # every image computed exactly once
        bulk = reg.acquire("m1").batcher.stats()["bulk"]
        assert bulk["images_sealed_total"] == 10 and bulk["batches_sealed_total"] == 3
    finally:
        jm.stop(grace_s=5)
        _stop(reg)


def test_oversize_manifest_refused_not_truncated(tmp_path):
    """Past ``jobs_max_items`` a submit is refused (400), never truncated."""
    cfg = _cfg(tmp_path, jobs_max_items=5)
    reg, _ = _registry(cfg)
    jm = JobManager(reg, ResponseCache(0), cfg)
    try:
        src = _corpus(tmp_path, 8)
        with pytest.raises(ValueError, match="jobs_max_items"):
            jm.submit_dir(src, "m1", None)
        with pytest.raises(ValueError, match="jobs_max_items"):
            jm.submit_upload([(f"i{i}.jpg", jpeg(seed=i)) for i in range(6)], "m1", None)
        job = jm.submit_dir(src, "m1", None, glob="00[0-4].jpg")  # at the cap
        assert job.total == 5
        _wait_state(jm, job.id, (DONE,))
    finally:
        jm.stop(grace_s=5)
        _stop(reg)


def test_results_offset_resume_and_longpoll(tmp_path):
    cfg = _cfg(tmp_path)
    reg, _ = _registry(cfg)
    jm = JobManager(reg, ResponseCache(0), cfg)
    try:
        job = jm.submit_dir(_corpus(tmp_path, 9), "m1", None)
        _wait_state(jm, job.id, (DONE,))
        l1, off1, _, total = jm.read_results(job.id, 0, 4)
        assert len(l1) == 4 and off1 == 4 and total == 9
        l2, off2, state, _ = jm.read_results(job.id, off1, 100)
        assert len(l2) == 5 and off2 == 9 and state == DONE
        assert [json.loads(ln)["i"] for ln in l1 + l2] == list(range(9))
        t0 = time.monotonic()  # a long poll past a terminal job's end returns at once
        l3, off3, state, _ = jm.read_results(job.id, 9, 100, wait_s=5.0)
        assert l3 == [] and off3 == 9 and state == DONE
        assert time.monotonic() - t0 < 2.0
        assert len(jm.read_results(job.id, 0, 0)[0]) == 1  # limit clamps to 1
    finally:
        jm.stop(grace_s=5)
        _stop(reg)


def test_longpoll_wakes_when_a_chunk_lands(tmp_path):
    sem = threading.Semaphore(0)
    cfg = _cfg(tmp_path)
    reg, _ = _registry(cfg, fetch_sem=sem)
    jm = JobManager(reg, ResponseCache(0), cfg)
    try:
        job = jm.submit_dir(_corpus(tmp_path, 8), "m1", None)
        threading.Timer(0.2, sem.release).start()
        lines, off, state, _ = jm.read_results(job.id, 0, 100, wait_s=10.0)
        assert [json.loads(ln)["i"] for ln in lines] == [0, 1, 2, 3] and off == 4
        assert state == RUNNING
    finally:
        _release(sem, 16)
        jm.stop(grace_s=5)
        _stop(reg)


def test_cancel_mid_run_keeps_completed_chunks(tmp_path):
    sem = threading.Semaphore(0)
    cfg = _cfg(tmp_path)
    reg, _ = _registry(cfg, fetch_sem=sem)
    jm = JobManager(reg, ResponseCache(0), cfg)
    try:
        job = jm.submit_dir(_corpus(tmp_path, 12), "m1", None)
        sem.release()  # chunk 1's fetch only; chunk 2 waits at the device
        _wait_completed(jm, job.id, 4)
        jm.cancel_job(job.id)
        _release(sem, 8)
        doc = _wait_state(jm, job.id, (CANCELLED,))
        assert 0 < doc["completed"] < 12, "completed chunks survive a cancel"
        assert _indices(jm, job.id) == list(range(doc["result_lines"]))
        assert jm.cancel_job(job.id)["state"] == CANCELLED  # terminal: a no-op
    finally:
        _release(sem, 16)
        jm.stop(grace_s=5)
        _stop(reg)


# ------------------------------------------------------- checkpoint/resume


def test_checkpoint_resume_after_simulated_restart(tmp_path):
    """Stop the manager with the device stalled (SIGTERM under load), then a
    fresh manager over the same ``jobs_dir``: the job resumes from its
    chunk checkpoint, zero lost, zero duplicated."""
    sem = threading.Semaphore(0)
    cfg = _cfg(tmp_path)
    reg, _ = _registry(cfg, fetch_sem=sem)
    jm = JobManager(reg, ResponseCache(0), cfg)
    job = jm.submit_dir(_corpus(tmp_path, 14), "m1", None)
    sem.release()
    _wait_completed(jm, job.id, 4)
    jm.stop(grace_s=0.2)  # the runner is blocked on the stalled chunk
    _release(sem, 8)
    if jm._runner is not None:
        jm._runner.join(timeout=20)
        assert not jm._runner.is_alive()
    persisted = json.loads((Path(cfg.jobs_dir) / job.id / "checkpoint.json").read_text())
    assert persisted["state"] == RUNNING, "an interrupted job persists RUNNING"
    assert 4 <= persisted["completed"] < 14
    _release(sem, 32)
    jm2 = JobManager(reg, ResponseCache(0), cfg)  # the restart
    try:
        assert jm2.get_job(job.id)["resumed"] is True
        doc = _wait_state(jm2, job.id, (DONE,))
        assert doc["completed"] == 14
        assert _indices(jm2, job.id) == list(range(14)), "zero lost, zero duplicated, in order"
    finally:
        jm2.stop(grace_s=5)
        _stop(reg)


def test_recovery_truncates_results_past_checkpoint(tmp_path):
    """A crash between the append and the checkpoint leaves lines past it;
    recovery truncates them, so the replayed chunk cannot duplicate."""
    cfg = _cfg(tmp_path)
    reg, _ = _registry(cfg)
    jm = JobManager(reg, ResponseCache(0), cfg)
    job = jm.submit_dir(_corpus(tmp_path, 8), "m1", None)
    _wait_state(jm, job.id, (DONE,))
    jm.stop(grace_s=5)
    jdir = Path(cfg.jobs_dir) / job.id
    cp = json.loads((jdir / "checkpoint.json").read_text())
    lines = (jdir / "results.jsonl").read_bytes().splitlines(keepends=True)
    cp.update(state=RUNNING, completed=4, result_lines=4,
              result_bytes=sum(len(ln) for ln in lines[:4]), chunks_done=1)
    (jdir / "checkpoint.json").write_text(json.dumps(cp))
    with open(jdir / "results.jsonl", "ab") as f:
        f.write(b'{"i": 999, "torn": true}\n')
    jm2 = JobManager(reg, ResponseCache(0), cfg)
    try:
        doc = _wait_state(jm2, job.id, (DONE,))
        assert doc["completed"] == 8
        assert _indices(jm2, job.id) == list(range(8)), "the torn tail must not survive"
    finally:
        jm2.stop(grace_s=5)
        _stop(reg)


# ------------------------------------------------------- hot swap under a job


def test_hot_swap_under_job_pauses_reversions_zero_lost(tmp_path):
    sem = threading.Semaphore(0)
    cfg = replace(_cfg(tmp_path, jobs_max_items=100), drain_grace_s=15.0)
    reg, engines = _registry(cfg, fetch_sem=sem)
    jm = JobManager(reg, ResponseCache(0), cfg)
    try:
        job = jm.submit_dir(_corpus(tmp_path, 20), "m1", None)
        sem.release()  # chunk 1 lands; chunk 2 waits at v1's fetch
        _wait_completed(jm, job.id, 4)
        # v2 warms and serves, then v1 drains: the retire listener fires at
        # the DRAINING flip and pauses the job with its chunk on v1
        swapper = threading.Thread(target=lambda: reg.swap("m1", wait=True, timeout=60),
                                   daemon=True)
        swapper.start()
        assert _wait_state(jm, job.id, (PAUSED,), timeout=10)["state"] == PAUSED
        _release(sem, 64)
        swapper.join(timeout=60)
        reg.wait_for(reg._models["m1"][1], ("UNLOADED",), timeout=30)
        doc = _wait_state(jm, job.id, (DONE,))
        states = [h["state"] for h in doc["history"]]
        assert PAUSED in states and states[-1] == DONE, states
        assert doc["versions"] == ["m1@1", "m1@2"], "the rest re-versions onto v2"
        idx = _indices(jm, job.id)
        assert sorted(idx) == list(range(20)) and len(set(idx)) == 20, "zero lost, zero dup"
        rows = [json.loads(ln) for ln in jm.read_results(job.id, 0, 100)[0]]
        assert {round(r["predictions"][0]["score"], 3) for r in rows} == {0.1, 0.2}
        assert engines[0].images > 0 and engines[1].images > 0
    finally:
        _release(sem, 64)
        jm.stop(grace_s=5)
        _stop(reg)


# -------------------------------------------------------------- cache dedup


@pytest.mark.parametrize("wire", WIRES)
def test_cache_dedup_accounting_and_interactive_prewarm(tmp_path, wire):
    """12 items of 3 contents: 9 dedup through the cache on the bulk
    counters, the interactive ones stay at 0, and the job's entries answer
    an interactive ``POST /predict`` of the same JPEG as a hit."""
    cfg = _cfg(tmp_path, wire, cache_bytes=1 << 20)
    reg, engines = _registry(cfg)
    app = App(reg, cfg)
    try:
        job = app.jobs.submit_dir(_corpus(tmp_path, 12, seeds=[i % 3 for i in range(12)]),
                                  "m1", None)
        doc = _wait_state(app.jobs, job.id, (DONE,))
        assert doc["completed"] == 12 and doc["errors"] == 0
        assert doc["cached"] == 9, "9 of 12 images repeat and dedup (hit or coalesce)"
        s = app.cache.stats()
        assert s["bulk"]["misses_total"] == 3
        assert s["bulk"]["hits_total"] + s["bulk"]["coalesced_total"] == 9
        assert s["hits_total"] == s["misses_total"] == s["coalesced_total"] == 0
        pm = s["per_model"]["m1"]
        assert (pm["bulk_misses"], pm["hits"], pm["misses"]) == (3, 0, 0)
        status, headers, _ = post(app, jpeg(12, 10, seed=0))
        assert status == 200 and headers["X-Cache"] == "hit", "the job pre-warms /predict"
        assert app.cache.stats()["hits_total"] == 1
        assert reg.acquire("m1").batcher.stats()["bulk"]["images_sealed_total"] == 3
    finally:
        app.jobs.stop(grace_s=5)
        app.telemetry.stop()
        _stop(reg)


# ------------------------------------------------------------- HTTP surface


@pytest.fixture()
def jobs_server(tmp_path):
    cfg = _cfg(tmp_path, cache_bytes=1 << 20)
    reg, engines = _registry(cfg)
    app = App(reg, cfg)
    srv = make_http_server(app, "127.0.0.1", 0, pool_size=6)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield srv.server_address[1], reg, app, engines, tmp_path
    shutdown_gracefully(srv, reg, grace_s=3.0)
    reg.close_engines()


def _req(port, method, path, body=None, ctype="application/json", timeout=20):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path, body=body,
                     headers={"Content-Type": ctype} if body is not None else {})
        resp = conn.getresponse()
        data = resp.read()
        return resp.status, data, {k.lower(): v for k, v in resp.getheaders()}
    finally:
        conn.close()


def _multipart(images):
    boundary = "jobtestboundary"
    parts = b"".join(
        (f'--{boundary}\r\nContent-Disposition: form-data; name="f{i}"; '
         f'filename="im{i}.jpg"\r\n\r\n').encode() + img + b"\r\n"
        for i, img in enumerate(images))
    return parts + f"--{boundary}--\r\n".encode(), f"multipart/form-data; boundary={boundary}"


def _poll_terminal(port, jid, timeout=20.0):
    deadline = time.monotonic() + timeout
    while True:
        status, data, _ = _req(port, "GET", f"/jobs/{jid}")
        assert status == 200
        doc = json.loads(data)
        if doc["state"] in (DONE, "FAILED", CANCELLED):
            return doc
        assert time.monotonic() < deadline, doc
        time.sleep(0.02)


def test_http_submit_poll_results_stats_metrics(jobs_server):
    port, reg, app, engines, _ = jobs_server
    body, ctype = _multipart([jpeg(12, 10, seed=i) for i in range(10)])
    status, data, _ = _req(port, "POST", "/jobs?topk=2", body, ctype)
    assert status == 202, data
    doc = json.loads(data)
    jid = doc["id"]
    assert doc["state"] in (QUEUED, RUNNING) and doc["total"] == 10
    assert doc["results_url"] == f"/jobs/{jid}/results"
    doc = _poll_terminal(port, jid)
    assert doc["state"] == DONE and doc["completed"] == 10
    status, data, hdrs = _req(port, "GET", f"/jobs/{jid}/results?offset=6")
    assert status == 200 and hdrs["content-type"] == "application/x-ndjson"
    lines = data.decode().strip().split("\n")
    assert [json.loads(ln)["i"] for ln in lines] == [6, 7, 8, 9]
    assert hdrs["x-job-next-offset"] == "10" and hdrs["x-job-result-lines"] == "10"
    assert hdrs["x-job-state"] == DONE and hdrs["x-job-complete"] == "1"
    assert len(json.loads(lines[0])["predictions"]) == 2  # topk honoured
    status, data, hdrs = _req(port, "GET", f"/jobs/{jid}/results?offset=2&limit=3")
    assert len(data.decode().strip().split("\n")) == 3 and hdrs["x-job-complete"] == "0"
    status, data, _ = _req(port, "GET", "/jobs")
    assert status == 200 and any(j["id"] == jid for j in json.loads(data)["jobs"])
    snap = json.loads(_req(port, "GET", "/stats")[1])
    assert snap["jobs"]["enabled"] and snap["jobs"]["images_done_total"] == 10
    assert (snap["config"]["jobs_batch"], snap["config"]["jobs_max_inflight"]) == (4, 1)
    assert snap["config"]["jobs_dir"] == app.cfg.jobs_dir
    assert snap["batcher"]["bulk"]["images_sealed_total"] == 10
    samples = parse_prometheus_text(_req(port, "GET", "/metrics")[1].decode())["samples"]
    assert samples[("tpu_serve_job_images_done_total", ())] == 10
    assert samples[("tpu_serve_jobs", (("state", "DONE"),))] == 1
    assert samples[("tpu_serve_jobs", (("state", "PAUSED"),))] == 0
    assert samples[("tpu_serve_job_chunks_total", ())] == 3
    assert samples[("tpu_serve_job_cache_hits_total", ())] == 0


def test_http_submit_server_dir_and_cancel_route(jobs_server):
    port, _, _, _, tmp_path = jobs_server
    body = json.dumps({"dir": _corpus(tmp_path, 6), "glob": "*.jpg"}).encode()
    status, data, _ = _req(port, "POST", "/jobs", body)
    assert status == 202, data
    jid = json.loads(data)["id"]
    assert _req(port, "POST", f"/jobs/{jid}/cancel", b"")[0] == 200
    assert _poll_terminal(port, jid)["state"] in (DONE, CANCELLED)  # a race; nothing hangs


def test_http_validation_and_disabled(jobs_server, tmp_path):
    port = jobs_server[0]
    body, ctype = _multipart([jpeg()])
    status, data, _ = _req(port, "POST", "/jobs?model=nosuch", body, ctype)
    assert status == 404, data  # at submit, not a FAILED job later
    status, data, _ = _req(port, "POST", "/jobs?model=m1%401", body, ctype)
    assert status == 400 and b"pinned" in data
    assert _req(port, "POST", "/jobs", json.dumps({"dir": "/nonexistent-xyz"}).encode())[0] \
        == 400
    assert _req(port, "POST", "/jobs", b"{}")[0] == 400
    assert _req(port, "POST", "/jobs", b"[1]")[0] == 400
    status, data, _ = _req(port, "POST", "/jobs",
                           json.dumps({"dir": str(tmp_path), "topk": "lots"}).encode())
    assert status == 400 and b"topk" in data
    assert _req(port, "POST", "/jobs?topk=x", body, ctype)[0] == 400
    assert _req(port, "POST", "/jobs?weight=x", body, ctype)[0] == 400
    assert _req(port, "GET", "/jobs/j99999-abcdef")[0] == 404
    assert _req(port, "GET", "/jobs/j99999-abcdef/results")[0] == 404
    assert _req(port, "DELETE", "/jobs")[0] == 405
    # without --jobs-dir: 503 with the hint
    cfg2 = serve_cfg("ragged")
    reg2, _ = _registry(cfg2)
    srv2 = make_http_server(App(reg2, cfg2), "127.0.0.1", 0, pool_size=2)
    threading.Thread(target=srv2.serve_forever, daemon=True).start()
    try:
        status, data, _ = _req(srv2.server_address[1], "POST", "/jobs", body, ctype)
        assert status == 503 and b"--jobs-dir" in data
        snap = json.loads(_req(srv2.server_address[1], "GET", "/stats")[1])
        assert snap["jobs"] == {"enabled": False} and snap["config"]["jobs_batch"] is None
    finally:
        shutdown_gracefully(srv2, reg2, grace_s=3.0)
        reg2.close_engines()


def test_cli_takes_the_jobs_flags(tmp_path):
    args = parse_args(["--device", "cpu", "--jobs-dir", str(tmp_path), "--jobs-batch", "64",
                       "--jobs-max-inflight", "3", "--max-batch", "256"])
    cfg = config_from_args(args)
    assert (cfg.jobs_dir, cfg.jobs_batch, cfg.jobs_max_inflight, cfg.max_batch) == (
        str(tmp_path), 64, 3, 256)
    cfg = config_from_args(parse_args(["--device", "cpu"]))
    assert (cfg.jobs_dir, cfg.jobs_batch, cfg.jobs_max_inflight) == (None, 256, 2)
    ref = jcfg.ServerConfig(model=jcfg.ModelConfig(name="x", source="native"))
    assert (cfg.jobs_starvation_s, cfg.jobs_max_items) == (ref.jobs_starvation_s,
                                                          ref.jobs_max_items)


# ------------------------------------------------------- graceful shutdown


def test_graceful_shutdown_checkpoints_running_job(tmp_path):
    """``shutdown_gracefully`` stops the app's job manager before the
    batchers: the runner checkpoints at its chunk boundary and a restart
    resumes with zero lost and zero duplicated images."""
    sem = threading.Semaphore(0)
    cfg = _cfg(tmp_path)
    reg, _ = _registry(cfg, fetch_sem=sem)
    app = App(reg, cfg)
    srv = make_http_server(app, "127.0.0.1", 0, pool_size=4)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    port = srv.server_address[1]
    status, data, _ = _req(port, "POST", "/jobs",
                           json.dumps({"dir": _corpus(tmp_path, 12)}).encode())
    assert status == 202
    jid = json.loads(data)["id"]
    sem.release()
    _wait_completed(app.jobs, jid, 4)
    threading.Timer(0.3, _release, (sem, 64)).start()  # the chunk in flight resolves
    shutdown_gracefully(srv, reg, grace_s=10.0)
    reg.close_engines()
    if app.jobs._runner is not None:
        app.jobs._runner.join(timeout=20)
    cp = json.loads((Path(cfg.jobs_dir) / jid / "checkpoint.json").read_text())
    assert cp["state"] in (RUNNING, DONE)
    assert cp["completed"] >= 4 and cp["completed"] == cp["result_lines"]
    reg2, _ = _registry(cfg)
    jm2 = JobManager(reg2, ResponseCache(0), cfg)
    try:
        assert _wait_state(jm2, jid, (DONE,))["completed"] == 12
        assert _indices(jm2, jid) == list(range(12))
    finally:
        jm2.stop(grace_s=5)
        _stop(reg2)


# ----------------------------------------------------- led flights and staging


class _DownBatcher:
    """A batcher mid-drain: every way of taking a slot raises, after the
    lease (``commit``) or before it (``lease``/``submit``)."""

    def __init__(self, supports_lease, fail_at):
        self.supports_lease = supports_lease
        self.fail_at = fail_at
        self.released = 0

    def _lease(self, *a, **kw):
        if self.fail_at == "lease":
            raise ShuttingDown("draining under hot swap")
        lease = SimpleNamespace(row=np.zeros(16 * 16 * 3 + 4, np.uint8))

        def commit(hw, canvas=None):
            raise ShuttingDown("draining under hot swap")

        def release():
            self.released += 1

        lease.commit, lease.release = commit, release
        return lease

    lease = lease_ragged = _lease

    def submit(self, canvas, hw, bulk=False):
        raise ShuttingDown("draining under hot swap")


@pytest.mark.parametrize("case", ["jpeg-commit", "png-lease", "no-lease-submit"])
def test_failed_stage_aborts_led_flight(tmp_path, case):
    """A batcher raising after the cache flight was led (a drain or SIGTERM
    race) must end it: the lease released, then the flight aborted; a
    leaked flight would wedge every request coalesced onto the key."""
    cfg = _cfg(tmp_path, "rgb", cache_bytes=1 << 20)
    cache = ResponseCache(1 << 20)
    reg, engines = _registry(cfg)
    jm = JobManager(reg, cache, cfg)
    try:
        data = _png(12, 10, 3) if case == "png-lease" else jpeg(12, 10, seed=3)
        batcher = _DownBatcher(case != "no-lease-submit",
                               "commit" if case == "jpeg-commit" else "lease")
        mv = SimpleNamespace(name="m1", version=1, model_cfg=_mc("m1"), engine=engines[0],
                             labels=["a", "b"])
        with pytest.raises(ShuttingDown):
            jm._stage_one(mv, batcher, data, 3)
        st = cache.stats()
        assert st["inflight"] == 0 and st["bulk"]["misses_total"] == 1, st
        assert batcher.released == (1 if case == "jpeg-commit" else 0)
        # through _stage_item the same raise defers the item to the retry path
        (tmp_path / "x.jpg").write_bytes(data)
        assert jm._stage_item(mv, batcher, {"path": str(tmp_path / "x.jpg")}, 3)[0] \
            == ("retry",)
    finally:
        jm.stop(grace_s=3)
        _stop(reg)


def test_undecodable_and_missing_items_become_error_lines(tmp_path):
    cfg = _cfg(tmp_path)
    reg, _ = _registry(cfg)
    jm = JobManager(reg, ResponseCache(0), cfg)
    try:
        job = jm.submit_upload([("a.jpg", jpeg(seed=1)), ("b.jpg", b"not an image"),
                                ("c.jpg", jpeg(seed=2))], "m1", None)
        doc = _wait_state(jm, job.id, (DONE,))
        assert (doc["completed"], doc["errors"]) == (3, 1)
        rows = [json.loads(ln) for ln in jm.read_results(job.id, 0, 10)[0]]
        assert [("error" in r) for r in rows] == [False, True, False]
        assert rows[1]["error"] == "could not decode image" and rows[1]["name"] == "b.jpg"
        assert jm.stats()["image_errors_total"] == 1
    finally:
        jm.stop(grace_s=5)
        _stop(reg)


# ------------------------------------------------------ the bulk gate


def _batcher(gate, **kw):
    eng = WideEngine(serve_cfg("rgb"), fetch_gate=gate)
    return Batcher(eng, max_batch=2, max_delay_ms=1.0, **kw).start(), eng


CANVAS = np.zeros((16, 16, 3), np.uint8)


def _until(pred, timeout=5.0, what=""):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, what
        time.sleep(0.005)


def test_bulk_gate_strict_priority_and_batch_size():
    """A sealed bulk batch waits while an interactive batch is in flight, and
    the bulk batch grows meanwhile: one batch of 8 once the gate opens."""
    gate = threading.Event()
    b, eng = _batcher(gate, pipeline_depth=1, bulk_max_batch=8, bulk_inflight=1,
                      bulk_starvation_s=30.0)
    try:
        assert b.bulk_max_batch == 8 and b.max_batch == 2
        it_fut = b.submit(CANVAS, (16, 16))
        _until(lambda: b.stats()["inflight"] == 1)
        bulk_futs = [b.submit(CANVAS, (16, 16), bulk=True) for _ in range(8)]
        _until(lambda: b.stats()["bulk"]["gate_holds_total"] > 0, 3, "no gate hold")
        assert b.stats()["bulk"]["inflight_batches"] == 0, "bulk waits for the interactive batch"
        assert b.stats()["queued"] == 0 and b.queue_depth == 0  # bulk is not the backlog
        assert not it_fut.done()
        gate.set()
        it_fut.result(timeout=10)
        for f in bulk_futs:
            f.result(timeout=10)
        bs = b.stats()["bulk"]
        assert (bs["batches_sealed_total"], bs["images_sealed_total"]) == (1, 8)
        recs = b.batch_timeline()
        assert [(r["bulk"], r["rows"]) for r in recs] == [(False, 1), (True, 8)]
    finally:
        gate.set()
        b.stop()


def test_interactive_batch_sealed_during_a_bulk_batch_goes_first():
    """With a bulk batch in flight, an interactive batch that seals runs
    before the next bulk batch (the gate reads interactive waiters)."""
    gate = threading.Event()
    b, eng = _batcher(gate, pipeline_depth=2, bulk_max_batch=2, bulk_inflight=1,
                      bulk_starvation_s=30.0)
    try:
        first = [b.submit(CANVAS, (16, 16), bulk=True) for _ in range(2)]
        _until(lambda: b.stats()["bulk"]["inflight_batches"] == 1)
        second = [b.submit(CANVAS, (16, 16), bulk=True) for _ in range(2)]
        it_fut = b.submit(CANVAS, (16, 16))
        _until(lambda: b.stats()["inflight"] == 2)  # the interactive batch took the device
        assert b.stats()["bulk"]["inflight_batches"] == 1
        gate.set()
        for f in first + second + [it_fut]:
            f.result(timeout=10)
        order = [r["bulk"] for r in sorted(b.batch_timeline(), key=lambda r: r["seq"])]
        assert order == [True, False, True]
    finally:
        gate.set()
        b.stop()


def test_bulk_starvation_valve_admits_under_sustained_load():
    """An interactive batch pinned in flight keeps the gate shut; the valve
    admits one bulk batch within about ``bulk_starvation_s``."""
    gate = threading.Event()
    b, eng = _batcher(gate, pipeline_depth=2, bulk_max_batch=8, bulk_inflight=1,
                      bulk_starvation_s=0.3)
    try:
        it_fut = b.submit(CANVAS, (16, 16))
        _until(lambda: b.stats()["inflight"] == 1)
        t0 = time.monotonic()
        bulk_futs = [b.submit(CANVAS, (16, 16), bulk=True) for _ in range(8)]
        _until(lambda: b.stats()["bulk"]["inflight_batches"] == 1, 5, "the valve never fired")
        assert time.monotonic() - t0 >= 0.25
        assert b.stats()["bulk"]["starvation_dispatches_total"] == 1
        gate.set()
        it_fut.result(timeout=10)
        for f in bulk_futs:
            f.result(timeout=10)
    finally:
        gate.set()
        b.stop()


def test_bulk_valve_clock_resets_after_discarded_batch():
    """A gated bulk batch whose leases all turn into holes is discarded, and
    the starvation clock stops with it: the next job's first batch does not
    inherit an open valve."""
    gate = threading.Event()
    b, eng = _batcher(gate, pipeline_depth=1, bulk_max_batch=2, bulk_inflight=1,
                      bulk_starvation_s=1.5)
    try:
        it_fut = b.submit(CANVAS, (16, 16))
        _until(lambda: b.stats()["inflight"] == 1)
        leases = [b.lease((16, 16, 3), bulk=True) for _ in range(2)]
        for lease in leases:
            lease.commit((16, 16), canvas=CANVAS)
        _until(lambda: b.stats()["bulk"]["gate_holds_total"] > 0, 3, "no gate hold")
        for lease in leases:
            lease.release()
        _until(lambda: b.stats()["discarded"] == 1, 3, "never discarded")
        futs = [b.submit(CANVAS, (16, 16), bulk=True) for _ in range(2)]
        t_probe = time.monotonic() + 0.5  # well under bulk_starvation_s
        while time.monotonic() < t_probe:
            bs = b.stats()["bulk"]
            assert bs["starvation_dispatches_total"] == 0, "valve fired on a stale clock"
            assert bs["inflight_batches"] == 0
            time.sleep(0.02)
        gate.set()
        it_fut.result(timeout=10)
        for f in futs:
            f.result(timeout=10)
    finally:
        gate.set()
        b.stop()


def test_bulk_quota_gates_before_starvation_valve():
    """A tenant in token debt: its bulk batch neither dispatches nor earns
    valve credit (quota is checked first), even with interactive load on
    the device; the charge lands at the dispatch."""
    adm = AdmissionController.from_spec("job=10", burst_s=1.0)
    adm.charge("job", 100)  # ~9 s of debt
    gate = threading.Event()
    b, eng = _batcher(gate, pipeline_depth=2, bulk_max_batch=2, bulk_starvation_s=0.1,
                      admission=adm)
    futures = []
    try:
        it_fut = b.submit(CANVAS, (16, 16))
        _until(lambda: b.stats()["inflight"] == 1)
        futures = [b.submit(CANVAS, (16, 16), bulk=True, tenant="job") for _ in range(2)]
        time.sleep(0.5)  # five valve windows
        st = b.stats()["bulk"]
        assert st["inflight_batches"] == 0 and st["batches_sealed_total"] == 0
        assert st["quota_holds_total"] >= 1 and st["starvation_dispatches_total"] == 0
        assert eng.images == 1
        gate.set()
        it_fut.result(timeout=10)
    finally:
        gate.set()
        b.stop()  # a drain lifts the gate
    for f in futures:
        f.result(timeout=10)
    assert eng.images == 3


def test_a_quota_held_bulk_batch_dispatches_on_an_idle_server():
    """A bulk batch held on its tenant's empty bucket is re-read as the bucket
    refills, with nothing else to wake the sealer (no interactive traffic,
    nothing in flight)."""
    adm = AdmissionController.from_spec("job=20", burst_s=1.0)
    adm.charge("job", 20)  # empty: 2 tokens take 0.1 s
    b, eng = _batcher(None, bulk_max_batch=2)
    b.admission = adm
    try:
        t0 = time.monotonic()
        futs = [b.submit(CANVAS, (16, 16), bulk=True, tenant="job") for _ in range(2)]
        for f in futs:
            f.result(timeout=5)
        assert time.monotonic() - t0 < 2.0
        st = b.stats()["bulk"]
        assert st["quota_holds_total"] >= 1 and st["batches_sealed_total"] == 1
    finally:
        b.stop()


def test_bulk_dispatch_charges_the_job_tenant():
    adm = AdmissionController.from_spec("job=1000", burst_s=1.0)
    b, eng = _batcher(None, bulk_max_batch=4)
    b.admission = adm
    try:
        futs = [b.submit(CANVAS, (16, 16), bulk=True, tenant="job") for _ in range(4)]
        for f in futs:
            f.result(timeout=10)
        assert 990 <= adm._tenants["job"].tokens < 1000  # 4 images charged at dispatch
    finally:
        b.stop()


def test_bulk_backpressure_blocks_without_rejecting():
    """Bulk leases block at their own cap on a bounded-queue batcher, never
    raise ``BacklogFull``, and interactive leases are still admitted."""
    gate = threading.Event()
    b, eng = _batcher(gate, pipeline_depth=1, max_queue=4, bulk_max_batch=4, bulk_inflight=1)
    try:
        submitted, done = [], threading.Event()

        def flood():
            for _ in range(20):
                submitted.append(b.submit(CANVAS, (16, 16), bulk=True))
            done.set()

        threading.Thread(target=flood, daemon=True).start()
        time.sleep(0.3)
        assert not done.is_set(), "the bulk flood must block at its cap"
        assert b.stats()["bulk"]["leased_slots"] <= 4 * 2
        it_fut = b.submit(CANVAS, (16, 16))  # interactive is untouched
        gate.set()
        it_fut.result(timeout=10)
        assert done.wait(timeout=15), "the flood drains once work flows"
        for f in submitted:
            f.result(timeout=15)
        assert b.stats()["backlog_rejects"] == 0
    finally:
        gate.set()
        b.stop()


def test_flush_bulk_seals_a_partial_builder_at_once():
    b, eng = _batcher(None, bulk_max_batch=8)
    b.bulk_delay_s = 60.0  # only the flush can seal the builder
    try:
        futs = [b.submit(CANVAS, (16, 16), bulk=True) for _ in range(3)]
        time.sleep(0.1)
        assert b.stats()["bulk"]["batches_sealed_total"] == 0  # the wide window holds it
        b.flush_bulk()
        for f in futs:
            f.result(timeout=10)
        assert b.stats()["bulk"]["images_sealed_total"] == 3
    finally:
        b.stop()


# --------------------------------------------------------------- tracing


def test_result_rows_carry_trace_ids_joining_chunk_spans(tmp_path):
    cfg = _cfg(tmp_path)
    reg, _ = _registry(cfg)
    obs = Observability()
    jm = JobManager(reg, ResponseCache(0), cfg, obs=obs)
    try:
        job = jm.submit_dir(_corpus(tmp_path, 6), "m1", None)
        _wait_state(jm, job.id, (DONE,))
        rows = [json.loads(ln) for ln in
                (Path(cfg.jobs_dir) / job.id / "results.jsonl").read_text().splitlines()]
        assert len(rows) == 6 and all(r.get("trace_id") for r in rows)
        bulk_spans = [d for _t0, _t1, d in obs.flight.trace_records(None)
                      if d.get("class") == "bulk"]
        assert bulk_spans, "chunk spans reach the recorder as bulk"
        assert {r["trace_id"] for r in rows} <= {d["trace_id"] for d in bulk_spans}
        assert len({r["trace_id"] for r in rows}) == 2  # 6 images at jobs_batch 4
        stages = set().union(*(d["stages_ms"] for d in bulk_spans))
        assert {"job_decode", "job_await", "job_spool"} <= stages
    finally:
        jm.stop(grace_s=5)
        _stop(reg)


# ------------------------------------------------------ both packages


INCEPTION = dict(name="inception_v3", source="native", zoo_width=0.25, zoo_classes=10,
                 input_size=(75, 75), preprocess="inception", topk=3, dtype="float32")


def _jax_jobs(tmp_path, engine=None):
    cfg = jcfg.ServerConfig(model=jcfg.ModelConfig(**INCEPTION), canvas_buckets=(96,),
                            max_batch=4, wire_format="rgb", ragged=True, warmup=False,
                            jobs_dir=str(tmp_path / "jjobs"), jobs_batch=4,
                            jobs_max_inflight=1)
    reg = JaxRegistry(cfg, default_model="inception_v3")
    eng = engine or JaxEngine(cfg, mesh=build_mesh(jax.devices()[:1]))
    reg.adopt("inception_v3", eng, reg.build_batcher(eng, "inception_v3"), cfg.model)
    return reg, eng, jjobs.JobManager(reg, JaxCache(0), cfg)


def _port_jobs(tmp_path, params):
    cfg = tcfg.ServerConfig(model=tcfg.ModelConfig(**INCEPTION), canvas_buckets=(96,),
                            max_batch=4, wire_format="rgb", ragged=True, warmup=False,
                            jobs_dir=str(tmp_path / "tjobs"), jobs_batch=4,
                            jobs_max_inflight=1)
    reg = ModelRegistry(cfg, default_model="inception_v3", device="cpu")
    eng = InferenceEngine(cfg, device="cpu", params_flat=params)
    reg.adopt("inception_v3", eng, reg.build_batcher(eng), cfg.model)
    return reg, JobManager(reg, ResponseCache(0), cfg)


def _results(path: Path) -> list[dict]:
    return [json.loads(ln) for ln in path.read_text().splitlines()]


def test_both_packages_jobs_give_the_same_results(tmp_path):
    """One corpus of seeded JPEGs (sizes across the 96 canvas, one PNG) through
    the reference's JobManager and the port's on the same Inception-v3
    weights: the same lines index for index (labels and indices equal,
    scores within 1e-4), and the same keys in manifest and checkpoint."""
    d = tmp_path / "corpus"
    d.mkdir()
    sizes = [(80, 72), (50, 90), (96, 96), (33, 61), (120, 40), (64, 64), (17, 95)]
    for i, (h, w) in enumerate(sizes):
        (d / f"{i:02d}.jpg").write_bytes(jpeg(h, w, seed=40 + i))
    (d / "07.png").write_bytes(_png(70, 52, 9))
    jreg, jeng, jjm = _jax_jobs(tmp_path)
    params = {k: np.asarray(v) for k, v in jeng.model.params.items()}
    treg, tjm = _port_jobs(tmp_path, params)
    try:
        jjob = jjm.submit_dir(str(d), None, None)
        tjob = tjm.submit_dir(str(d), None, None)
        _wait_state(jjm, jjob.id, (DONE,), timeout=120)
        _wait_state(tjm, tjob.id, (DONE,), timeout=120)
        want = _results(jjob.results_path)
        got = _results(tjob.results_path)
    finally:
        jjm.stop(grace_s=5)
        tjm.stop(grace_s=5)
        jreg.stop()
        _stop(treg)
        jeng.close()
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        assert (g["i"], g["name"]) == (w["i"], w["name"]) and "error" not in g
        assert [p["label"] for p in g["predictions"]] == [p["label"] for p in w["predictions"]]
        assert [p["index"] for p in g["predictions"]] == [p["index"] for p in w["predictions"]]
        np.testing.assert_allclose([p["score"] for p in g["predictions"]],
                                   [p["score"] for p in w["predictions"]], atol=1e-4)
        assert set(g) == set(w)
    for name in ("manifest.json", "checkpoint.json"):
        jdoc = json.loads((jjob.dir / name).read_text())
        tdoc = json.loads((tjob.dir / name).read_text())
        assert set(jdoc) == set(tdoc), name
    jcp = json.loads((jjob.dir / "checkpoint.json").read_text())
    tcp = json.loads((tjob.dir / "checkpoint.json").read_text())
    assert {k: tcp[k] for k in ("state", "completed", "result_lines", "chunks_done")} == \
        {k: jcp[k] for k in ("state", "completed", "result_lines", "chunks_done")}


class _RefGatedEngine:
    """A reference-side mock engine (the reference's own test's shape):
    classic rgb slabs through ``submit``, each fetch one permit."""

    batch_buckets = (4,)
    max_batch = 4

    class mesh:  # noqa: N801 — the attribute the reference's batcher reads
        devices = np.zeros(1)

    def __init__(self, sem):
        self.sem = sem

    def close(self):
        pass

    def healthcheck(self):
        return True

    def prepare_bytes(self, data):
        img = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        return np.zeros((16, 16, 3), np.uint8), (16, 16), img.shape[:2]

    def dispatch_batch(self, canvases, hws):
        return len(canvases)

    def fetch_outputs(self, n):
        assert self.sem.acquire(timeout=30), "no fetch permit"
        return (np.full((n, 3), 0.25, np.float32),
                np.tile(np.arange(3, dtype=np.int32), (n, 1)))


def test_port_recovers_a_jobs_dir_the_reference_interrupted(tmp_path):
    """The reference's JobManager writes a job and is stopped with a chunk on
    the device; the port's, over the same directory, resumes it from the
    reference's checkpoint: zero lost, zero duplicated, the reference's
    lines kept byte for byte."""
    sem = threading.Semaphore(0)
    jobs_dir = tmp_path / "jobs"
    jc = jcfg.ServerConfig(model=jcfg.ModelConfig(name="m1", source="native"), max_batch=4,
                           max_delay_ms=1.0, jobs_dir=str(jobs_dir), jobs_batch=4,
                           jobs_max_inflight=1, drain_grace_s=3.0)
    jreg = JaxRegistry(jc, engine_factory=lambda mc: _RefGatedEngine(sem),
                       spec_resolver=lambda s: jcfg.ModelConfig(name="m1", source="native"))
    jreg.load("m1", wait=True)
    jjm = jjobs.JobManager(jreg, JaxCache(0), jc)
    job = jjm.submit_dir(_corpus(tmp_path, 14), "m1", None)
    sem.release()
    _wait_completed(jjm, job.id, 4)
    jjm.stop(grace_s=0.2)
    _release(sem, 8)
    if jjm._runner is not None:
        jjm._runner.join(timeout=20)
        assert not jjm._runner.is_alive()
    jreg.stop()
    jdir = jobs_dir / job.id
    cp = json.loads((jdir / "checkpoint.json").read_text())
    assert cp["state"] == RUNNING and 4 <= cp["completed"] < 14
    before = (jdir / "results.jsonl").read_bytes()[: cp["result_bytes"]]
    cfg = _cfg(tmp_path, "rgb")
    reg, _ = _registry(cfg)
    jm = JobManager(reg, ResponseCache(0), cfg)
    try:
        doc = jm.get_job(job.id)
        assert doc["resumed"] and doc["completed"] == cp["completed"]
        doc = _wait_state(jm, job.id, (DONE,))
        assert doc["completed"] == 14 and doc["errors"] == 0
        assert _indices(jm, job.id) == list(range(14)), "zero lost, zero duplicated"
        assert (jdir / "results.jsonl").read_bytes().startswith(before)
        cp2 = json.loads((jdir / "checkpoint.json").read_text())
        assert set(cp2) == set(cp) and cp2["state"] == DONE
        assert set(json.loads((jdir / "manifest.json").read_text())) == {
            "id", "seq", "model", "topk", "source", "items", "tenant", "weight"}
    finally:
        jm.stop(grace_s=5)
        _stop(reg)


# ------------------------------------------------------ fault 9


def test_json_config_without_source_is_refused_as_the_reference(tmp_path):
    """A ``.json`` file with neither ``source`` nor ``pb_path`` means
    ``source="pb"`` in both packages, and both refuse it with one text."""
    path = tmp_path / "inception_v3.json"
    path.write_text(json.dumps({"name": "inception_v3"}))
    errors = []
    for mod in (jcfg, tcfg):
        with pytest.raises(ValueError) as e:
            mod.model_config(str(path))
        errors.append(str(e.value))
    assert errors[0] == errors[1] == (
        "model 'inception_v3': source='pb' requires pb_path "
        "(or use source='native' for the flax zoo)")


def test_json_config_with_source_native_loads_the_same_zoo_config(tmp_path):
    path = tmp_path / "inception_v3.json"
    path.write_text(json.dumps({"name": "inception_v3", "source": "native", "zoo_width": 0.25,
                                "zoo_classes": 10, "input_size": [75, 75], "topk": 3}))
    got, want = tcfg.model_config(str(path)), jcfg.model_config(str(path))
    keys = ("name", "source", "pb_path", "zoo_width", "zoo_classes", "input_size",
            "preprocess", "topk", "dtype", "task")
    assert {k: getattr(got, k) for k in keys} == {k: getattr(want, k) for k in keys}
    assert got.source == "native"
