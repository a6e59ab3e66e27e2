"""Placement in the port (``parallel/mesh.py``, ``serving/placement.py``,
the engine's replicas, the batcher's routing) against the reference's
(``tests/test_placement.py``), on the CPU.

A port mesh is a list of CPU entries (``cpu:0`` … ``cpu:7``), the
counterpart of the reference's 8-device virtual CPU mesh: every replica
holds a real copy of the weights, and routing, depth per (bucket,
replica), row splits over a group, drain and hot swap run for real. The
model is the reference fixture's: MobileNetV2 at width 0.25, 12 classes,
64 px, canvas 96, batch 4, float32.

Tolerance against the JAX engine: the same top-k indices and scores within
1e-4, the bar of ``tests/test_torch_engine.py``'s engine parity (float32 on
both sides; the sums differ in order only).
"""

from __future__ import annotations

import dataclasses
import http.client
import json
import threading
import time

import jax
import numpy as np
import pytest
import torch

from tensorflow_web_deploy_tpu.parallel.mesh import build_mesh as jax_mesh
from tensorflow_web_deploy_tpu.serving.engine import InferenceEngine as JaxEngine
from tensorflow_web_deploy_tpu.serving.placement import parse_placement as jax_parse
from tensorflow_web_deploy_tpu.utils import config as jcfg
from tensorflow_web_deploy_tpu_torch.parallel.mesh import build_mesh, cpu_mesh, mesh_for
from tensorflow_web_deploy_tpu_torch.server import start_server
from tensorflow_web_deploy_tpu_torch.serving.batcher import Batcher
from tensorflow_web_deploy_tpu_torch.serving.engine import InferenceEngine
from tensorflow_web_deploy_tpu_torch.serving.placement import Placement, parse_placement
from tensorflow_web_deploy_tpu_torch.utils import config as tcfg
from tensorflow_web_deploy_tpu_torch.utils.metrics import parse_prometheus_text
from tests.test_torch_registry import jpeg

torch.set_num_threads(2)

MODEL = dict(name="mobilenet_v2", source="native", zoo_width=0.25, zoo_classes=12,
             input_size=(64, 64), preprocess="inception", topk=3, dtype="float32")
CANVAS = 96
SCORE_TOL = 1e-4  # tests/test_torch_engine.py's engine parity bar


def _port_engine(placement: str | None, mesh, **kw) -> InferenceEngine:
    cfg = tcfg.ServerConfig(model=tcfg.ModelConfig(**MODEL, placement=placement),
                            canvas_buckets=(CANVAS,), max_batch=4, warmup=False, **kw)
    return InferenceEngine(cfg, mesh=mesh)


def _batch(seed: int, n: int = 3):
    rs = np.random.RandomState(seed)
    canvases = (rs.rand(n, CANVAS, CANVAS, 3) * 255).astype(np.uint8)
    hws = np.array([(CANVAS, CANVAS), (50, 70), (81, 33)][:n], np.int32)
    return canvases, hws


# ------------------------------------------------------------ spec parsing


SPLIT_SPECS = ["inception_v3", "inception_v3,replicas=8", "native:mobilenet_v2,shard=batch",
               "native:mobilenet_v2,dtype=int8,as=mv2_int8", "m,dtype=BF16",
               "inception_v3,banana=2", "m,replicas=2,shard=batch", "m,dtype=int4",
               "m,shard=batch,replicas=4", "native:mobilenet_v2,replicas=4,dtype=int8,as=x"]


@pytest.mark.parametrize("spec", SPLIT_SPECS)
def test_split_model_spec_is_the_references(spec):
    try:
        want = jcfg.split_model_spec(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tcfg.split_model_spec(spec)
        assert str(got.value) == str(e)
    else:
        assert tcfg.split_model_spec(spec) == want


def test_model_config_carries_placement():
    for spec in ("native:inception_v3,replicas=8", "native:mobilenet_v2,shard=batch,dtype=int8",
                 "native:inception_v3"):
        port, ref = tcfg.model_config(spec), jcfg.model_config(spec)
        assert (port.name, port.placement, port.dtype) == (ref.name, ref.placement, ref.dtype)
    assert tcfg.model_config("native:inception_v3").placement is None


PLACEMENT_SPECS = [None, "", "shard=batch", "replicas=1", "replicas=2", "replicas=4",
                   "replicas=8", "replicas=3", "replicas=9", "replicas=x", "replicas=0",
                   "replicas=-2", "shard=model", "banana"]


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("spec", PLACEMENT_SPECS)
def test_parse_placement_is_the_references(spec, n):
    ref_mesh = jax_mesh(jax.devices()[:n])
    try:
        want = jax_parse(spec, ref_mesh)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            parse_placement(spec, cpu_mesh(n))
        assert str(got.value) == str(e)
        return
    got = parse_placement(spec, cpu_mesh(n))
    assert isinstance(got, Placement)
    assert (got.strategy, got.replicas, got.spec) == (want.strategy, want.replicas, want.spec)
    assert got.summary() == want.summary()
    assert [[d.index for d in m] for m in got.meshes] == \
        [[d.id for d in m.devices.flatten()] for m in want.meshes]


def test_meshes():
    assert cpu_mesh(3) == tuple(torch.device("cpu", i) for i in range(3))
    assert mesh_for("cpu") == (torch.device("cpu"),)
    with pytest.raises(ValueError, match="repeated"):
        build_mesh(["cpu:1", "cpu:1"])
    with pytest.raises(ValueError, match="at least one"):
        build_mesh([])


def test_a_placement_the_mesh_cannot_honor_fails_before_any_weight():
    with pytest.raises(ValueError, match="exceeds the 1-device mesh"):
        _port_engine("replicas=2", cpu_mesh(1))
    with pytest.raises(ValueError, match="do not split evenly"):
        _port_engine("replicas=3", cpu_mesh(4))


# ------------------------------------------------- a replicated engine on 4


@pytest.fixture(scope="module")
def engines():
    """(port, JAX) engines, ``replicas=4`` over 4 devices each, on the same
    weights (the JAX engine's, carried across by ``from_jax_params``)."""
    jeng = JaxEngine(jcfg.ServerConfig(model=jcfg.ModelConfig(**MODEL, placement="replicas=4"),
                                       canvas_buckets=(CANVAS,), batch_buckets=(1, 2, 4),
                                       max_batch=4, warmup=False),
                     mesh=jax_mesh(jax.devices()[:4]))
    params = {k: np.asarray(v) for k, v in jeng.model.params.items()}
    cfg = tcfg.ServerConfig(model=tcfg.ModelConfig(**MODEL, placement="replicas=4"),
                            canvas_buckets=(CANVAS,), max_batch=4, warmup=False)
    teng = InferenceEngine(cfg, mesh=cpu_mesh(4), params_flat=params)
    yield teng, jeng
    teng.close()


def test_replicated_engine_shape_and_real_copies(engines):
    eng, _ = engines
    assert eng.num_replicas == 4 and eng.placement.strategy == "replicate"
    assert eng.batch_multiple == 1 and eng.batch_buckets == (1, 2, 4)
    weights = [rep.shards[0].model.backbone.logits.weight for rep in eng._replicas]
    assert len({w.data_ptr() for w in weights}) == 4  # a copy each, not one shared
    assert all(torch.equal(w, weights[0]) for w in weights)


def test_identity_across_replicas_and_parity_with_jax(engines):
    """One batch pinned to each replica in turn: bit-identical answers in
    the port, and the JAX engine's within the engine parity bar."""
    teng, jeng = engines
    canvases, hws = _batch(0)
    outs = [teng.run_batch(canvases, hws, replica=r) for r in range(4)]
    for scores, idx in outs[1:]:
        np.testing.assert_array_equal(scores, outs[0][0])
        np.testing.assert_array_equal(idx, outs[0][1])
    for r in range(4):
        j_scores, j_idx = jeng.run_batch(canvases, hws, replica=r)
        np.testing.assert_array_equal(outs[0][1], j_idx)
        np.testing.assert_allclose(outs[0][0], j_scores, atol=SCORE_TOL)


# the port's replica block also carries the device's gap counters
GAP_KEYS = {"idle_s", "batches_timed", "h2d_s"}


def test_staging_stats_replica_block_is_the_references(engines):
    """After the same pinned dispatches, the same staging block: per replica
    its index, devices and dispatches (in flight: none), and the pool; the
    port's gap counters besides, 0 on the CPU."""
    teng, jeng = engines
    before = {e: e.staging_stats() for e in engines}
    canvases, hws = _batch(1)
    for r in (0, 1, 1, 3):
        teng.run_batch(canvases, hws, replica=r)
        jeng.run_batch(canvases, hws, replica=r)
    got, want = teng.staging_stats(), jeng.staging_stats()
    assert got.keys() == want.keys()
    assert got["placement"] == want["placement"]

    def block(st, b):
        return [{k: v for k, v in rep.items() if k not in GAP_KEYS | {"busy_s"}} | {
                    "delta": rep["dispatches_total"] - b["replicas"][i]["dispatches_total"]}
                for i, rep in enumerate(st["replicas"])]

    assert block(got, before[teng]) == block(want, before[jeng])
    assert [rep.keys() - GAP_KEYS for rep in got["replicas"]] == \
        [rep.keys() for rep in want["replicas"]]
    assert all(rep["batches_timed"] == 0 and rep["h2d_s"] == 0
               and not any(rep["idle_s"].values()) for rep in got["replicas"])
    assert [d["delta"] for d in block(got, before[teng])] == [1, 2, 0, 1]
    assert got["dispatches_inflight"] == 0 and all(r["busy_s"] > 0 for r in got["replicas"][:2])
    assert (got["slabs_pooled"], got["slabs_pooled_bytes"]) == (want["slabs_pooled"],
                                                                want["slabs_pooled_bytes"])


def test_the_batcher_disperses_batches_over_every_replica(engines):
    eng, _ = engines
    batcher = Batcher(eng, max_batch=4, max_delay_ms=1.0).start()
    canvas = _batch(2, 1)[0][0]
    before = [r["dispatches_total"] for r in eng.staging_stats()["replicas"]]
    rows = []
    try:
        for _ in range(8):  # sequential waves: at least 8 sealed batches
            futs = [batcher.submit(canvas, (CANVAS, CANVAS)) for _ in range(4)]
            rows.extend(f.result(timeout=120) for f in futs)
    finally:
        batcher.stop()
    assert len(rows) == 32
    for scores, idx in rows[1:]:  # whichever replica served it
        np.testing.assert_array_equal(scores, rows[0][0])
        np.testing.assert_array_equal(idx, rows[0][1])
    per = [r["dispatches_total"] - b
           for r, b in zip(eng.staging_stats()["replicas"], before)]
    assert sum(per) >= 8 and all(n >= 1 for n in per), per
    st = batcher.stats()
    assert st["replicas"] == 4 and set(st["inflight_by_replica"]) == {"0", "1", "2", "3"}
    assert len({r["replica"] for r in batcher.batch_timeline()}) >= 2
    assert len(batcher._launchers) == len(batcher._completions) == 4


# ---------------------------------------------- groups of two: rows split


@pytest.mark.parametrize("ragged", [False, True])
def test_groups_of_two_split_each_batchs_rows(ragged):
    """``replicas=4`` over 8 entries: batch multiple 2, buckets (2, 4), and
    a batch's rows split evenly over its group's two devices (each device's
    model sees its half), gathered in row order: the answers of one device
    serving the whole batch."""
    eng = _port_engine("replicas=4", cpu_mesh(8), ragged=ragged)
    one = _port_engine(None, cpu_mesh(1), ragged=ragged)
    try:
        assert (eng.batch_multiple, eng.batch_buckets) == (2, (2, 4))
        assert eng.placement.summary()["devices"] == [[0, 1], [2, 3], [4, 5], [6, 7]]
        seen = []
        for rep in eng._replicas:
            for j, sh in enumerate(rep.shards):
                sh.model.register_forward_hook(
                    lambda m, args, out, r=rep.index, j=j: seen.append((r, j, args[0].shape[0])))
        canvases, hws = _batch(3)
        images = [c[:h, :w].copy() for c, (h, w) in zip(canvases, hws)]

        def run(e, r=None):
            if ragged:
                return e.run_ragged(images, hws, CANVAS, replica=r)
            return e.run_batch(canvases, hws, replica=r)

        want = run(one)
        for r in range(4):
            seen.clear()
            scores, idx = run(eng, r)
            assert seen == [(r, 0, 2), (r, 1, 2)]  # bucket 4 → 2 rows per device
            np.testing.assert_array_equal(idx, want[1])
            np.testing.assert_allclose(scores, want[0], atol=1e-6)
        eng.warmup()  # the executables take a device's rows too
        seen.clear()
        scores, idx = run(eng, 2)
        assert seen == [(2, 0, 2), (2, 1, 2)] and eng.stats()["graphs"]["replays"] >= 1
        np.testing.assert_array_equal(idx, want[1])
        econ = eng.econ_stats()
        assert [r["devices"] for r in econ] == [2] * 4
    finally:
        eng.close()
        one.close()


# ------------------------------------------------------------ staging budget


def _staging_pair(slabs: int, budget: int):
    common = dict(canvas_buckets=(32, 48, 64), max_batch=4, warmup=False,
                  staging_slabs=slabs, staging_pool_bytes=budget)
    jeng = JaxEngine(jcfg.ServerConfig(model=jcfg.ModelConfig(**MODEL), batch_buckets=(4,),
                                       **common), mesh=jax_mesh(jax.devices()[:1]))
    teng = InferenceEngine(tcfg.ServerConfig(model=tcfg.ModelConfig(**MODEL), **common),
                           device="cpu")
    return teng, jeng


def _pooled(eng) -> dict:
    """Shape → idle slabs, by canvas side, for either engine."""
    out = {}
    for key, slabs in eng._pool.items() if hasattr(eng, "_pool") else \
            eng._staging_pool.items():
        side = key[1] if isinstance(key[0], str) else key[0][0]
        if slabs:
            out[side] = len(slabs)
    return out


# (canvas sides acquired together, then released together) per step
SEQUENCES = {
    "cap": [(32, 32, 32)],
    "lru": [(32, 32, 32), (64,), (48,)],
    "touch": [(32, 32), (64,), (32,), (48,), (64, 64, 64)],
}


@pytest.mark.parametrize("slabs,budget", [(2, 80_000), (6, 256 << 20), (3, 60_000)])
@pytest.mark.parametrize("seq", list(SEQUENCES))
def test_staging_budget_and_lru_are_the_references(seq, slabs, budget):
    """The same acquire/release steps through both engines' pools: at most
    ``staging_slabs`` idle per shape, the least recently used shape dropped
    first past ``staging_pool_bytes``, the same counts and bytes after each
    step."""
    teng, jeng = _staging_pair(slabs, budget)
    try:
        for sides in SEQUENCES[seq]:
            held = [(teng.acquire_staging(s), jeng.acquire_staging(4, (s, s, 3)))
                    for s in sides]
            assert [t.total_bytes for t, _ in held] == [j.total_bytes for _, j in held]
            for t, j in held:
                teng.release_staging(t)
                jeng.release_staging(j)
            got, want = teng.staging_stats(), jeng.staging_stats()
            assert (got["slabs_pooled"], got["slabs_pooled_bytes"], got["slab_allocs_total"]) \
                == (want["slabs_pooled"], want["slabs_pooled_bytes"], want["slab_allocs_total"])
            assert _pooled(teng) == _pooled(jeng)
            assert max(_pooled(teng).values()) <= slabs
            assert got["slabs_pooled_bytes"] <= budget
    finally:
        teng.close()


# --------------------------------------------- a server: attribution, swap


def _req(port, method, path, body=None, timeout=60):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        payload = json.dumps(body).encode() if isinstance(body, dict) else body
        conn.request(method, path, body=payload)
        resp = conn.getresponse()
        raw = resp.read()
        return resp.status, (raw.decode() if path == "/metrics" else json.loads(raw or b"null"))
    finally:
        conn.close()


def _server(**kw):
    mc = tcfg.ModelConfig(**MODEL, placement="replicas=4")
    cfg = tcfg.ServerConfig(model=mc, host="127.0.0.1", port=0, canvas_buckets=(CANVAS,),
                            max_batch=4, ragged=True, telemetry_interval_s=0.0,
                            request_timeout_s=30.0, drain_grace_s=10.0, **kw)
    return start_server(cfg, mesh=cpu_mesh(4))


def test_stats_metrics_and_models_attribute_per_replica():
    srv = _server()
    try:
        for i in range(12):
            assert _req(srv.port, "POST", "/predict", jpeg(40, 30, i))[0] == 200
        _, st = _req(srv.port, "GET", "/stats")
        assert st["config"]["placement"]["strategy"] == "replicate"
        assert st["config"]["devices"] == 4
        reps = st["staging"]["replicas"]
        assert [r["replica"] for r in reps] == [0, 1, 2, 3]
        assert sum(r["dispatches_total"] for r in reps) >= 12 + 4 * 3  # warmup's too
        assert all(r["dispatches_total"] > 0 for r in reps)
        assert st["batcher"]["replicas"] == 4
        assert [r["replica"] for r in st["economics"]["mobilenet_v2@1"]["replicas"]] == \
            [0, 1, 2, 3]
        _, models = _req(srv.port, "GET", "/models")
        v = models["models"]["mobilenet_v2"]["versions"][0]
        assert v["placement"]["spec"] == "replicas=4"
        assert v["placement"]["devices"] == [[0], [1], [2], [3]]
        _, text = _req(srv.port, "GET", "/metrics")
        samples = parse_prometheus_text(text)["samples"]
        for fam in ("model_replica_dispatches_total", "model_replica_dispatches_inflight",
                    "model_replica_slab_bytes_inflight", "model_replica_busy_seconds_total"):
            got = {dict(lb)["replica"]: val for (n, lb), val in samples.items()
                   if n == f"tpu_serve_{fam}"}
            assert sorted(got) == ["0", "1", "2", "3"], fam
            assert all(set(dict(lb)) == {"model", "version", "replica"}
                       for (n, lb) in samples if n == f"tpu_serve_{fam}")
        dispatched = {dict(lb)["replica"]: v for (n, lb), v in samples.items()
                      if n == "tpu_serve_model_replica_dispatches_total"}
        assert dispatched == {str(r["replica"]): r["dispatches_total"] for r in reps}
    finally:
        srv.close()


def test_hot_swap_under_four_replicas_loses_nothing_and_drains():
    """Closed-loop traffic while the model hot swaps: no failed request,
    both versions answer, each version's replicas all took batches, the
    new version keeps the placement, and the old one drains, unloads and
    closes every replica."""
    srv = _server()
    reg = srv.registry
    old = reg.default_entry()
    old_engine = old.engine
    stop = threading.Event()
    failures, versions = [], []

    def hammer(seed):
        i = 0
        while not stop.is_set():
            i += 1
            try:
                status, doc = _req(srv.port, "POST", "/predict", jpeg(40, 30, seed * 1000 + i))
            except Exception as e:
                failures.append(repr(e))
                continue
            if status != 200:
                failures.append((status, doc))
            else:
                versions.append(doc["model_version"])

    threads = [threading.Thread(target=hammer, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    try:
        time.sleep(0.5)
        status, doc = _req(srv.port, "POST", "/models/swap",
                           {"name": "mobilenet_v2", "wait": True}, timeout=120)
        assert status == 200 and doc["state"] == "SERVING"
        reg.wait_for(old, ("UNLOADED",), timeout=60)
        time.sleep(0.5)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=60)
    try:
        assert not any(t.is_alive() for t in threads)
        assert not failures, failures[:5]
        assert {1, 2} <= set(versions)
        new = reg.default_entry()
        assert new.version == 2 and new.engine.placement.spec == "replicas=4"
        assert all(r["dispatches_total"] > 0 for r in new.engine.staging_stats()["replicas"])
        assert [s for s, _ in old.history][-2:] == ["DRAINING", "UNLOADED"]
        st = old_engine.staging_stats()
        assert all(r["dispatches_total"] > 0 and r["dispatches_inflight"] == 0
                   for r in st["replicas"])
        assert old_engine.model is None  # closed: every replica's weights dropped
        assert all(sh.model is None for rep in old_engine._replicas for sh in rep.shards)
    finally:
        srv.close()


def test_placement_reaches_the_server_from_the_cli():
    from tensorflow_web_deploy_tpu_torch.server import config_from_args, parse_args

    cfg = config_from_args(parse_args(["--model", "native:mobilenet_v2,replicas=2",
                                       "--zoo-width", "0.25", "--zoo-classes", "12",
                                       "--canvas-buckets", "96", "--max-batch", "4",
                                       "--no-warmup", "--telemetry-interval", "0"]))
    assert cfg.model.placement == "replicas=2"
    cfg = dataclasses.replace(cfg, port=0, host="127.0.0.1")
    with pytest.raises(ValueError, match="exceeds the 1-device mesh"):
        start_server(cfg, device="cpu")
    srv = start_server(cfg, mesh=cpu_mesh(2))
    try:
        assert srv.engine.placement.summary()["replicas"] == 2
    finally:
        srv.close()
