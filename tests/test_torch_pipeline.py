"""The port's pipelined dispatch on the CPU: ``pipeline_depth`` 1 runs
batches in lockstep and depth 2 keeps two in flight (a slow fake engine
read through ``batch_timeline()``), ``stop()`` drains, a full backlog
answers 503 with ``Retry-After`` over HTTP, and the slice end to end: 12
seeded JPEGs posted at once to a narrow MobileNetV2 server on the ragged
wire at depth 2 give the JAX engine's answers on the same parameters
(identical top-k, max probability delta ≤ 1e-4, float32 on both sides).
"""

import io
import json
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from tensorflow_web_deploy_tpu.parallel.mesh import build_mesh
from tensorflow_web_deploy_tpu.serving.engine import InferenceEngine as JaxEngine
from tensorflow_web_deploy_tpu.utils import config as jcfg
from tensorflow_web_deploy_tpu_torch import native
from tensorflow_web_deploy_tpu_torch.server import start_server
from tensorflow_web_deploy_tpu_torch.serving.batcher import Batcher, LeaseExpired
from tensorflow_web_deploy_tpu_torch.utils import config as tcfg
from test_torch_batcher import PortEngine

torch.set_num_threads(2)

MODEL = dict(name="mobilenet_v2", source="native", zoo_width=0.25, zoo_classes=10,
             input_size=(64, 64), preprocess="inception", topk=3, dtype="float32")
CANVASES = (64, 128)
# served probabilities vs the JAX engine's, float32 on both sides
PROB_TOL = 1e-4


def _overlap(a, b):
    return max(0.0, min(a[1], b[1]) - max(a[0], b[0]))


def _run_depth(depth):
    eng = PortEngine(delay_s=0.3)  # each fetch waits 300 ms: a busy device
    b = Batcher(eng, max_batch=2, max_delay_ms=60_000, adaptive_delay=False,
                pipeline_depth=depth).start()
    try:
        futures = [b.submit(np.full((8, 8, 3), i, np.uint8), (8, 8)) for i in range(6)]
        assert [int(f.result(timeout=10)[0][0]) for f in futures] == list(range(6))
        return b.batch_timeline(), b.stats()
    finally:
        b.stop()


def test_depth_one_is_lockstep_and_depth_two_overlaps():
    timeline, stats = _run_depth(1)
    assert len(timeline) == 3 and stats["inflight_peak"] == 1
    for prev, nxt in zip(timeline, timeline[1:]):
        assert nxt["t_launch"] >= prev["t_done"]  # one batch on the device at a time
        assert _overlap((prev["t_launch"], prev["t_done"]),
                        (nxt["t_launch"], nxt["t_done"])) == 0
    timeline, stats = _run_depth(2)
    assert len(timeline) == 3 and stats["inflight_peak"] == 2
    first, second = timeline[:2]
    # the second batch was assembled and launched while the first ran
    assert second["t_launch"] < first["t_done"]
    assert _overlap((second["t_open"], second["t_launched"]),
                    (first["t_launch"], first["t_done"])) > 0.0
    assert _overlap((first["t_launch"], first["t_done"]),
                    (second["t_launch"], second["t_done"])) > 0.1


def test_stop_drains_every_open_builder():
    eng = PortEngine()
    b = Batcher(eng, max_batch=4, max_delay_ms=60_000, adaptive_delay=False,
                lease_timeout_s=0.3).start()
    futures = [b.submit(np.full((8, 8, 3), i, np.uint8), (8, 8)) for i in range(3)]
    futures += [b.submit_ragged(np.full((4, 4, 3), 7, np.uint8), (4, 4), 16)]
    stuck = b.lease((8, 8, 3))  # never committed: expires within the drain's grace
    b.stop()
    assert [int(f.result(timeout=1)[0][0]) for f in futures] == [0, 1, 2, 7]
    with pytest.raises(LeaseExpired):
        stuck.future.result(timeout=1)
    assert sorted(n for _, n, _ in eng.dispatched) == [1, 3]  # a trailing hole is not shipped
    assert all(not t.is_alive() for t in (b._sealer, *b._launchers, *b._completions))


def _jpeg(h, w, seed):
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([yy * 1.5, xx * 1.5, 200 - yy - xx], -1) + rs.normal(0, 25, (h, w, 3))
    buf = io.BytesIO()
    Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(buf, "JPEG", quality=90)
    return buf.getvalue()


def _post(url, data):
    req = urllib.request.Request(url, data=data, method="POST",
                                 headers={"Content-Type": "image/jpeg"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def _server(**kw):
    cfg = tcfg.ServerConfig(model=tcfg.ModelConfig(**MODEL), host="127.0.0.1", port=0,
                            canvas_buckets=CANVASES, max_batch=4, ragged=True, **kw)
    return start_server(cfg, device="cpu")


def test_full_backlog_answers_503_with_retry_after():
    with _server(max_queue=2, warmup=False) as srv:
        held = [srv.batcher.lease_ragged(3, 64) for _ in range(2)]  # decodes in flight
        status, body, headers = _post(srv.url + "/predict", _jpeg(40, 50, 0))
        assert status == 503 and "max_queue" in body["error"]
        assert int(headers["Retry-After"]) >= 1
        for lease in held:
            lease.release()
        status, body, _ = _post(srv.url + "/predict", _jpeg(40, 50, 0))
        assert status == 200 and len(body["predictions"]) == 3
        assert srv.batcher.stats()["backlog_rejects"] == 1


def test_the_slice_end_to_end_matches_the_jax_engine():
    if not native.available():
        pytest.skip(f"no native decoder: {native.status()['reason']}")
    dims = [(50, 60), (120, 90), (64, 64), (100, 40), (33, 128), (90, 110)]
    jpegs = [_jpeg(*dims[i % len(dims)], seed=i) for i in range(12)]
    with _server(pipeline_depth=2) as srv:
        with ThreadPoolExecutor(12) as pool:
            served = list(pool.map(lambda d: _post(srv.url + "/predict", d), jpegs))
        stats = srv.engine.stats()
        batcher = srv.batcher.stats()
    assert all(status == 200 for status, _, _ in served)
    assert stats["decodes"] == {"native": 12, "pil": 0}
    assert batcher["host_copies"] == 12  # libjpeg straight into the pinned arenas
    assert stats["kernel_launches"] == {"preprocess_i420": 0, "fused_dw": 0,
                                         "unpack_ragged": 0, "preprocess_ragged": 0,
                                         "nms_fixed": 0}  # CPU: plain
    # the JAX engine on the same seeded parameters, fed the same decoded bytes
    # (the two packages' decoders agree byte for byte, test_torch_native.py)
    jeng = JaxEngine(jcfg.ServerConfig(model=jcfg.ModelConfig(**MODEL), canvas_buckets=CANVASES,
                                       max_batch=8, batch_buckets=(8,), ragged=True,
                                       warmup=False), mesh=build_mesh(jax.devices()[:1]))
    plans = [native.plan_decode_packed(d, CANVASES) for d in jpegs]
    want = {}
    for s in CANVASES:
        ids = [i for i, p in enumerate(plans) if p[0] == s]
        slab = jeng.acquire_ragged(len(ids), s)
        for i in ids:
            slot, view = slab.alloc(plans[i][1])
            slab.write_hw(slot, native.decode_packed_into(jpegs[i], view, s))
        scores, idx = jeng.fetch_outputs(jeng.dispatch_ragged(slab, len(ids)))
        want.update({i: (scores[j], idx[j]) for j, i in enumerate(ids)})
    jeng.close()
    assert sorted(want) == list(range(12)) and {p[0] for p in plans} == set(CANVASES)
    for i, (_, body, _) in enumerate(served):
        got_idx = [p["index"] for p in body["predictions"]]
        got_score = np.array([p["score"] for p in body["predictions"]], np.float32)
        assert got_idx == want[i][1].tolist()
        assert np.abs(got_score - want[i][0]).max() <= PROB_TOL
