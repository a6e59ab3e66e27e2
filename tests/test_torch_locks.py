"""The port's lock-order witness (``utils/locks.py``), its rank table
(``utils/lockorder.toml``) and the static half over the port's tree, on the
CPU.

- The same scripted acquisitions through the reference's
  ``forced_witness`` and the port's give the same violations, edges,
  counts and peaks; the factories give plain primitives with the switch
  off; with ``TWD_DEBUG_LOCKS=1`` a table that cannot be read fails the
  import.
- The table: unique ranks, every declared name created in the port and
  every created name declared, the reference's relative order kept for
  every name the two tables share; ``tools.twdlint`` with the table over
  the port's tree finds nothing.
- The reference's lock drills on the port's components under the port's
  witness, with the module-level locks (made at import, before any
  witness) rebound to witnessed ones: the cache lock under a lease, the
  jobs condition across a hot swap's drain → pause → resume, the dispatch
  guard (load-bearing and per replica), ragged lease → pack → seal, the
  pipeline catalog's lock across a swap, the build cache's lock under a
  kernel's build lock, and a profiler capture's lock over the enqueue
  gate. Each ends with zero violations.
"""

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import threading
import time
import tomllib
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch

from tensorflow_web_deploy_tpu.utils import locks as ref_locks
from tensorflow_web_deploy_tpu_torch import native
from tensorflow_web_deploy_tpu_torch.ops import _build, launches
from tensorflow_web_deploy_tpu_torch.parallel.mesh import cpu_mesh
from tensorflow_web_deploy_tpu_torch.serving import aotcache, costmodel, engine
from tensorflow_web_deploy_tpu_torch.serving import http as thttp
from tensorflow_web_deploy_tpu_torch.serving.batcher import Batcher
from tensorflow_web_deploy_tpu_torch.serving.engine import InferenceEngine
from tensorflow_web_deploy_tpu_torch.serving.jobs import DONE, PAUSED, JobManager
from tensorflow_web_deploy_tpu_torch.serving.registry import ModelRegistry
from tensorflow_web_deploy_tpu_torch.serving.respcache import ResponseCache, canvas_digest, \
    make_key
from tensorflow_web_deploy_tpu_torch.utils import config as tcfg
from tensorflow_web_deploy_tpu_torch.utils import locks, tracing

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "tensorflow_web_deploy_tpu_torch"
TABLE = PKG / "utils" / "lockorder.toml"
REF_TABLE = ROOT / "tools" / "twdlint" / "lockorder.toml"


# ------------------------------------------------------------ witness parity


def _inversion(lk):
    lo, hi = lk.named_lock("lo"), lk.named_lock("hi")
    with lo:
        with hi:
            pass
    with contextlib.suppress(lk.LockOrderViolation):
        with hi:
            with lo:
                pass


def _undeclared(lk):
    ghost = lk.named_lock("ghost")
    with contextlib.suppress(lk.LockOrderViolation):
        ghost.acquire()
        ghost.release()


def _wait(lk):
    c, low = lk.named_condition("c"), lk.named_lock("l")
    with c:
        c.wait(timeout=0.01)  # the release and reacquire balance
        with low:
            pass
    with c:
        pass
    entered = threading.Event()

    def waiter():
        with c:
            entered.set()
            c.wait(timeout=5)

    t = threading.Thread(target=waiter, name="waiter", daemon=True)
    t.start()
    assert entered.wait(5)
    with c:  # the waiter dropped the condition for its wait
        c.notify_all()
    t.join(timeout=5)
    assert not t.is_alive()


def _wait_for(lk):
    c = lk.named_condition("c")
    with c:
        c.wait_for(lambda: True)
        with lk.named_lock("l"):
            pass
    with c:
        pass


def _wait_without_acquire(lk):
    c = lk.named_condition("c")
    with pytest.raises(RuntimeError):
        c.wait(timeout=0.01)
    with c:
        pass


def _nonstrict(lk):
    lo, hi = lk.named_lock("lo"), lk.named_lock("hi")
    with hi:
        with lo:
            pass


def _wait_holding_a_higher_lock(lk):
    c, hi = lk.named_condition("c"), lk.named_lock("l")
    with c:
        with hi:
            c.wait(timeout=0.01)  # reacquiring c under l inverts


def _try_acquire_held(lk):
    low = lk.named_lock("l")
    with low:
        assert low.acquire(blocking=False) is False


WITNESS_CASES = {
    "inversion": (_inversion, {"lo": 1, "hi": 2}, True),
    "undeclared": (_undeclared, {"known": 1}, True),
    "condition_wait": (_wait, {"c": 1, "l": 2}, True),
    "wait_for": (_wait_for, {"c": 1, "l": 2}, True),
    "wait_without_acquire": (_wait_without_acquire, {"c": 1}, True),
    "nonstrict": (_nonstrict, {"lo": 1, "hi": 2}, False),
    "wait_holding_a_higher_lock": (_wait_holding_a_higher_lock, {"c": 1, "l": 2}, False),
    "try_acquire_held": (_try_acquire_held, {"l": 1}, False),
}


def _observed(lk, case) -> dict:
    script, ranks, strict = WITNESS_CASES[case]
    with lk.forced_witness(ranks, strict=strict) as w:
        script(lk)
    return {"violations": list(w.violations), "edges": set(w.edges),
            "acquire_counts": dict(w.acquire_counts),
            "peak_concurrency": dict(w.peak_concurrency)}


@pytest.mark.parametrize("case", list(WITNESS_CASES))
def test_witness_equals_the_reference(case):
    got, want = _observed(locks, case), _observed(ref_locks, case)
    assert got == want
    if case in ("inversion", "undeclared", "nonstrict", "wait_holding_a_higher_lock",
                "try_acquire_held"):
        assert got["violations"]
    else:
        assert got["violations"] == []


def test_factories_are_plain_primitives_when_disabled(monkeypatch):
    monkeypatch.setattr(locks, "_ENABLED", False)
    assert locks.witness_active() is None
    assert type(locks.named_lock("batcher.cond")) is type(threading.Lock())
    assert type(locks.named_condition("registry.cond")) is threading.Condition
    with locks.forced_witness({"x": 1}) as w:
        assert locks.witness_active() is w
        assert isinstance(locks.named_lock("x"), locks._WitnessLock)
    assert locks.witness_active() is None
    assert type(locks.named_lock("x")) is type(threading.Lock())


def _import_locks(tmp_path, table: str | None, env_switch: str | None):
    """Import a copy of ``utils/locks.py`` beside ``table`` in a fresh
    process: (return code, output)."""
    (tmp_path / "locks.py").write_text((PKG / "utils" / "locks.py").read_text())
    if table is not None:
        (tmp_path / "lockorder.toml").write_text(table)
    env = {k: v for k, v in os.environ.items() if k != "TWD_DEBUG_LOCKS"}
    if env_switch is not None:
        env["TWD_DEBUG_LOCKS"] = env_switch
    code = ("import sys; sys.path.insert(0, sys.argv[1]); import locks; "
            "print(type(locks.named_lock('x')).__name__, locks.witness_active() is not None)")
    p = subprocess.run([sys.executable, "-c", code, str(tmp_path)], capture_output=True,
                       text=True, env=env, timeout=60)
    return p.returncode, p.stdout + p.stderr


@pytest.mark.parametrize("table,switch,ok,out", [
    (TABLE.read_text(), "1", True, "_WitnessLock True"),
    (TABLE.read_text(), None, True, "lock False"),
    (TABLE.read_text(), "0", True, "lock False"),
    (None, None, True, "lock False"),
    (None, "1", False, "FileNotFoundError"),
    ('[[locks]]\nname = "a"\nrank = 1\n[[locks]]\nname = "b"\nrank = 1\n', "1", False,
     "share rank 1"),
    ('[[locks]]\nname = "a"\nrank = 1\n[[locks]]\nname = "a"\nrank = 2\n', "1", False,
     "duplicate lock name"),
    ("[[locks]\n", "1", False, "TOMLDecodeError"),
], ids=["on", "unset", "zero", "no-table-off", "no-table-on", "shared-rank", "duplicate",
        "malformed"])
def test_the_switch_and_a_table_that_cannot_be_read(tmp_path, table, switch, ok, out):
    """With the switch on, the witness starts at import or the import fails:
    a process asked to watch its locks never serves unwatched."""
    rc, text = _import_locks(tmp_path, table, switch)
    assert (rc == 0) == ok, text
    assert out in text


# ------------------------------------------------------------------- the table


def _created_names() -> dict[str, list[str]]:
    """Name → the port files that create a lock or condition under it."""
    pat = re.compile(r'named_(?:lock|condition)\("([^"]+)"\)')
    found: dict[str, list[str]] = {}
    for path in PKG.rglob("*.py"):
        if path.name == "locks.py" and path.parent.name == "utils":
            continue
        for name in pat.findall(path.read_text()):
            found.setdefault(name, []).append(str(path.relative_to(ROOT)))
    return found


def test_every_lock_is_declared_and_every_declared_lock_exists():
    ranks = locks.load_lock_ranks()
    assert len(set(ranks.values())) == len(ranks)
    created = _created_names()
    assert set(created) == set(ranks), (set(created) ^ set(ranks))
    raw = [str(p.relative_to(ROOT)) for p in PKG.rglob("*.py")
           if re.search(r"threading\.(Lock|RLock|Condition|Semaphore)\(", p.read_text())
           and p.name != "locks.py"]
    assert raw == [], "a lock made without named_lock/named_condition"
    with open(TABLE, "rb") as f:
        table = tomllib.load(f)
    for entry in table["locks"]:
        assert entry["file"] in created[entry["name"]], entry


def test_shared_names_keep_the_references_order():
    ours, ref = locks.load_lock_ranks(), locks.load_lock_ranks(REF_TABLE)
    shared = sorted(set(ours) & set(ref))
    assert {"registry.cond", "jobs.cond", "batcher.cond", "slab.lease_lock", "cache.lock",
            "span.lock", "obs.lock", "stats.lock", "flight.lock", "trace.id_lock",
            "http.counters_lock", "http.conns_lock", "econ.lock", "telemetry.lock",
            "telemetry.events_lock", "overload.admission_lock", "overload.pressure_lock",
            "chaos.lock", "aotcache.lock", "dag.lock", "native.build_lock",
            "engine.replica_dispatch_lock", "accesslog.lock"} <= set(shared)
    for a in shared:
        for b in shared:
            assert (ours[a] < ours[b]) == (ref[a] < ref[b]), (a, b)


def test_twdlint_with_the_ports_table_finds_nothing():
    from tools.twdlint import run_lint

    t0 = time.monotonic()
    findings = run_lint(ROOT, config_path=TABLE)
    assert [f.render() for f in findings] == []
    assert time.monotonic() - t0 < 15


# ---------------------------------------------------------------- the drills


MODULE_LOCKS = (  # made at import, before any witness: rebound in the drills
    (engine, "_CAPTURE_LOCK", "engine.capture_lock"),
    (aotcache, "_lock", "aotcache.lock"),
    (_build, "_lock", "ops.build_lock"),
    (launches, "_lock", "ops.launch_counter"),
    (tracing, "_counter_lock", "trace.id_lock"),
    (costmodel, "_cost_lock", "econ.lock"),
    (native, "_lock", "native.build_lock"),
    (thttp, "_PROFILE_LOCK", "http.profile_lock"),
    (engine._STREAMS, "_lock", "engine.stream_pool"),
)


@pytest.fixture
def witnessed(monkeypatch):
    """The port's witness with the shipped ranks, every module-level lock
    rebound to a witnessed one (the enqueue gate's condition too)."""
    with locks.forced_witness(locks.load_lock_ranks()) as w:
        for obj, attr, name in MODULE_LOCKS:
            monkeypatch.setattr(obj, attr, locks.named_lock(name))
        monkeypatch.setattr(engine._GATE, "_cond", locks.named_condition("engine.enqueue_gate"))
        yield w
    assert w.violations == []


MODEL = dict(name="mobilenet_v2", source="native", zoo_width=0.25, zoo_classes=8,
             input_size=(32, 32), preprocess="inception", topk=3, dtype="float32")


def _engine(**kw) -> InferenceEngine:
    mesh = kw.pop("mesh", None)
    cfg = tcfg.ServerConfig(model=tcfg.ModelConfig(**{**MODEL, **kw.pop("model", {})}),
                            canvas_buckets=(64,), max_batch=4, warmup=False, cache_bytes=0,
                            **kw)
    return InferenceEngine(cfg, device="cpu" if mesh is None else None, mesh=mesh)


def test_cache_lock_under_a_lease(witnessed):
    """The request path's order: batcher.cond for the lease, released; then
    cache.lock (lookup, fill); then batcher.cond again (commit, release);
    and the registry's invalidate-on-retire, registry.cond → cache.lock."""
    from tests.test_torch_registry import _mc
    from tests.test_torch_respcache import ServeEngine, serve_cfg

    w = witnessed
    cfg = serve_cfg("rgb")
    cache = ResponseCache(1 << 20)
    b = Batcher(ServeEngine(cfg), max_batch=4, max_delay_ms=1.0).start()
    try:
        canvas = np.zeros((16, 16, 3), np.uint8)
        key = make_key("m", 1, canvas_digest(canvas, (8, 8)), 3)
        kind, flight = cache.begin(key, "m")
        assert kind == "lead"
        lease = b.lease((16, 16, 3))
        lease.commit((8, 8), canvas=canvas).result(timeout=10)
        cache.complete(flight, {"predictions": []})
        lease2 = b.lease((16, 16, 3))
        assert cache.begin(key, "m")[0] == "hit"
        lease2.release()
    finally:
        b.stop()
    reg = ModelRegistry(cfg, engine_factory=lambda mc: ServeEngine(cfg), spec_resolver=_mc)
    reg.add_retire_listener(cache.invalidate)
    reg.load("m1", wait=True)
    reg.unload("m1", wait=True)
    reg.stop()
    reg.close_engines()
    assert ("registry.cond", "cache.lock") in w.edges
    assert w.acquire_counts["cache.lock"] >= 3
    assert w.violations == []


def test_jobs_cond_drain_pause_resume_across_a_swap(witnessed, tmp_path):
    """A hot swap's DRAINING flip pauses a running job inside registry.cond
    (registry.cond → jobs.cond), the successor's SERVING flip wakes it, and
    the rest of the job re-versions onto v2."""
    from tests.test_torch_jobs import _cfg, _corpus, _registry, _release, _stop, \
        _wait_completed, _wait_state

    w = witnessed
    sem = threading.Semaphore(0)
    cfg = replace(_cfg(tmp_path, jobs_max_items=100), drain_grace_s=15.0)
    reg, _ = _registry(cfg, fetch_sem=sem)
    jm = JobManager(reg, ResponseCache(0), cfg)
    try:
        job = jm.submit_dir(_corpus(tmp_path, 12), "m1", None)
        sem.release()
        _wait_completed(jm, job.id, 4)
        swapper = threading.Thread(target=lambda: reg.swap("m1", wait=True, timeout=60),
                                   daemon=True)
        swapper.start()
        assert _wait_state(jm, job.id, (PAUSED,), timeout=10)["state"] == PAUSED
        _release(sem, 64)
        swapper.join(timeout=60)
        doc = _wait_state(jm, job.id, (DONE,))
        assert doc["versions"] == ["m1@1", "m1@2"]
    finally:
        _release(sem, 64)
        jm.stop(grace_s=5)
        _stop(reg)
    assert ("registry.cond", "jobs.cond") in w.edges
    assert w.acquire_counts["jobs.cond"] > 0
    assert w.violations == []


def _concurrent_runs(eng, replicas, hold_s=0.25):
    """Each thread runs one batch on its replica; the eager serve under the
    replica's enqueue is held ``hold_s``. Returns each serve's interval."""
    intervals, errors = [], []
    serve = eng._serve_packed

    def slow(model, dev):
        t0 = time.monotonic()
        time.sleep(hold_s)
        out = serve(model, dev)
        intervals.append((t0, time.monotonic()))
        return out

    eng._serve_packed = slow
    barrier = threading.Barrier(len(replicas))
    canvases = np.zeros((2, 64, 64, 3), np.uint8)
    hws = np.full((2, 2), 64, np.int32)

    def run(r):
        barrier.wait(timeout=10)
        try:
            eng.run_batch(canvases, hws, r)
        except Exception as e:  # surfaced by the assert below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(r,)) for r in replicas]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert errors == []
    return intervals


def _overlap(intervals) -> bool:
    (a0, a1), (b0, b1) = sorted(intervals)
    return b0 < a1


def test_dispatch_guard_is_load_bearing(witnessed):
    """Two threads enqueue into one replica: its dispatch guard is taken
    twice and never by both at once, and their enqueues do not overlap;
    with the guard a no-op they do."""
    w = witnessed
    eng = _engine(ragged=False)
    try:
        assert not _overlap(_concurrent_runs(eng, (0, 0)))
        assert w.acquire_counts["engine.replica_dispatch_lock"] == 2
        assert w.peak_concurrency["engine.replica_dispatch_lock"] == 1
        eng._replicas[0].lock = contextlib.nullcontext()
        assert _overlap(_concurrent_runs(eng, (0, 0)))
        assert w.acquire_counts["engine.replica_dispatch_lock"] == 2
    finally:
        eng.close()
    assert w.violations == []


def test_dispatch_guard_is_per_replica(witnessed):
    """Two replicas of one engine: each thread takes its replica's guard,
    both guards are held at once (two instances of one name), and the two
    enqueues overlap."""
    w = witnessed
    eng = _engine(ragged=False, model={"placement": "replicas=2"}, mesh=cpu_mesh(2))
    try:
        assert eng.num_replicas == 2
        assert _overlap(_concurrent_runs(eng, (0, 1)))
        assert w.acquire_counts["engine.replica_dispatch_lock"] == 2
        assert w.peak_concurrency["engine.replica_dispatch_lock"] == 2
    finally:
        eng.close()
    assert w.violations == []


def test_ragged_lease_pack_seal(witnessed):
    """The ragged staging path of a real engine: lease (batcher.cond →
    the arena from the staging pool, the lease count), the caller's pack
    (no lock), seal and dispatch (the accounting, the replica's guard),
    fetch."""
    w = witnessed
    eng = _engine(ragged=True, wire_format="rgb")
    b = Batcher(eng, max_batch=4, max_delay_ms=2.0).start()
    rng = np.random.RandomState(20260804)
    try:
        futs = []
        for _ in range(6):
            im = rng.randint(0, 256, (rng.randint(8, 64), rng.randint(8, 64), 3), dtype=np.uint8)
            lease = b.lease_ragged(im.size, 64)
            lease.row[:] = im.reshape(-1)
            futs.append(lease.commit(im.shape[:2]))
        for f in futs:
            f.result(timeout=60)
    finally:
        b.stop()
        eng.close()
    assert ("batcher.cond", "slab.lease_lock") in w.edges
    assert ("batcher.cond", "engine.accounting_lock") in w.edges
    assert w.acquire_counts["engine.replica_dispatch_lock"] >= 2
    assert w.violations == []


def test_dag_lock_across_a_classifier_swap(witnessed):
    """The pipeline catalog's lock: the registry's serving and retire
    listeners mark the pipeline dirty under registry.cond (→ dag.lock), and
    a request after the swap resolves it again."""
    from tests.test_torch_dag import COMMON, _cls_params, _det_params, _jpeg, _port_app

    w = witnessed
    reg, app = _port_app(COMMON, _det_params(), _cls_params)
    try:
        reg.swap("mobilenet_v2", wait=True, timeout=120)
        status, body = _wsgi(app, "POST", "/pipelines/" + COMMON["pipelines"][0].split("=")[0],
                             _jpeg(1))
        assert status == 200, body
        assert _wsgi(app, "GET", "/pipelines")[0] == 200
    finally:
        reg.stop(grace_s=5.0)
        reg.close_engines()
    assert ("registry.cond", "dag.lock") in w.edges
    assert w.acquire_counts["dag.lock"] >= 2
    assert w.violations == []


def _wsgi(app, method: str, path: str, body: bytes = b""):
    captured = {}

    def start_response(status, headers):
        captured["status"] = status

    environ = {"REQUEST_METHOD": method, "PATH_INFO": path, "QUERY_STRING": "",
               "CONTENT_TYPE": "image/jpeg", "CONTENT_LENGTH": str(len(body)),
               "wsgi.input": io.BytesIO(body)}
    out = b"".join(app(environ, start_response))
    return int(captured["status"].split()[0]), json.loads(out or b"{}")


def test_aotcache_lock_under_a_kernels_build_lock(witnessed, tmp_path, monkeypatch):
    """A kernel's build at first use and its load from the build cache:
    ops.build_lock, then the kernel's build lock with aotcache.lock under
    it (a miss, a write), then a hit in a fresh process's memo."""
    from tests.test_torch_aotcache import SO, _key

    w = witnessed
    builds = []

    def compile_(name, out):
        builds.append(name)
        out.write_bytes(Path(SO).read_bytes())

    monkeypatch.setattr(_build, "_compile", compile_)
    monkeypatch.setattr(_build, "kernel_key", _key)
    monkeypatch.setattr(_build, "_locks", {})
    monkeypatch.setattr(_build, "_loaded", {})
    cache = aotcache.AotCache(tmp_path)
    assert _build.load("k_witness", cache) is not None
    monkeypatch.setattr(_build, "_loaded", {})
    assert _build.load("k_witness", cache) is not None
    assert builds == ["k_witness"]
    aotcache.stats(cache)
    assert ("ops.kernel_build_lock", "aotcache.lock") in w.edges
    assert w.acquire_counts["aotcache.lock"] >= 3
    assert w.peak_concurrency["ops.kernel_build_lock"] == 1
    assert w.violations == []


def test_profile_lock_over_the_enqueue_gate(witnessed, tmp_path):
    """A profiler capture holds http.profile_lock across its start and stop,
    each of which takes the enqueue gate exclusively (→ its condition); a
    second capture meanwhile is refused without blocking."""
    w = witnessed
    done = {}
    t = threading.Thread(target=lambda: done.update(doc=thttp.profile_capture(
        400, str(tmp_path))), daemon=True)
    t.start()
    deadline = time.monotonic() + 10
    while not thttp._PROFILE_LOCK.locked():
        assert time.monotonic() < deadline
        time.sleep(0.005)
    assert thttp.profile_capture(10, str(tmp_path)) is None
    t.join(timeout=30)
    assert os.path.exists(done["doc"]["trace_file"])
    assert ("http.profile_lock", "engine.enqueue_gate") in w.edges
    assert w.violations == []
