"""The port's HTTP server (serving/http.py, serving/batcher.py, server.py)
booted on the CPU on an ephemeral port with a tiny Inception-v3."""

import http.client
import io
import json
import threading
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from PIL import Image

from tensorflow_web_deploy_tpu_torch.server import config_from_args, parse_args, start_server
from tensorflow_web_deploy_tpu_torch.serving.batcher import Batcher
from tensorflow_web_deploy_tpu_torch.serving.http import _parse_multipart_files
from tensorflow_web_deploy_tpu_torch.utils.config import ModelConfig, ServerConfig

torch.set_num_threads(2)


def _jpeg(h, w, seed):
    img = (np.random.RandomState(seed).rand(h, w, 3) * 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG")
    return buf.getvalue()


@pytest.fixture(scope="module")
def server():
    cfg = ServerConfig(
        model=ModelConfig(name="inception_v3", zoo_width=0.25, zoo_classes=10,
                          input_size=(75, 75), dtype="float32", topk=3),
        host="127.0.0.1", port=0, canvas_buckets=(64, 128), max_batch=4,
        wire_format="yuv420", resize="kernel",
    )
    srv = start_server(cfg, device="cpu")
    yield srv
    srv.close()


def _post(url, data, ctype="image/jpeg"):
    req = urllib.request.Request(url, data=data, method="POST", headers={"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _multipart(files):
    boundary = "xYzBoundary"
    parts = []
    for name, data in files:
        parts.append(
            f"--{boundary}\r\nContent-Disposition: form-data; name=\"file\"; "
            f"filename=\"{name}\"\r\nContent-Type: image/jpeg\r\n\r\n".encode() + data + b"\r\n")
    body = b"".join(parts) + f"--{boundary}--\r\n".encode()
    return body, f"multipart/form-data; boundary={boundary}"


def _check_preds(preds, k):
    assert len(preds) == k
    for p in preds:
        assert set(p) == {"label", "index", "score"}
        assert 0 <= p["index"] < 10 and 0.0 <= p["score"] <= 1.0
        assert p["label"] == f"class_{p['index']:04d}"
    scores = [p["score"] for p in preds]
    assert scores == sorted(scores, reverse=True)


def test_raw_body_and_topk(server):
    status, body = _post(server.url + "/predict", _jpeg(90, 70, 0))
    assert status == 200 and body["model"] == "inception_v3"
    _check_preds(body["predictions"], 3)
    status, body2 = _post(server.url + "/predict?topk=2", _jpeg(90, 70, 0))
    assert status == 200
    _check_preds(body2["predictions"], 2)
    assert body2["predictions"] == body["predictions"][:2]


def test_multipart_and_batch_flag(server):
    files = [("a.jpg", _jpeg(40, 50, 1)), ("b.jpg", _jpeg(120, 100, 2))]
    data, ctype = _multipart(files)
    status, body = _post(server.url + "/predict", data, ctype)
    assert status == 200 and len(body["results"]) == 2
    for r in body["results"]:
        _check_preds(r["predictions"], 3)
    data, ctype = _multipart(files[:1])
    status, body = _post(server.url + "/predict?batch=1", data, ctype)
    assert status == 200 and len(body["results"]) == 1
    # same image, same answer whichever way it arrived
    status, single = _post(server.url + "/predict", files[0][1])
    assert single["predictions"] == body["results"][0]["predictions"]


def test_concurrent_requests_share_batches(server):
    before = json.loads(urllib.request.urlopen(server.url + "/stats").read())["batcher"]
    with ThreadPoolExecutor(8) as pool:
        results = list(pool.map(lambda i: _post(server.url + "/predict", _jpeg(60, 60, i)),
                                 range(8)))
    assert all(s == 200 for s, _ in results)
    stats = json.loads(urllib.request.urlopen(server.url + "/stats").read())
    done = stats["batcher"]["batches"] - before["batches"]
    assert stats["batcher"]["images"] - before["images"] == 8
    assert 2 <= done <= 8  # max_batch 4
    # CPU: the plain versions run
    assert stats["engine"]["kernel_launches"] == {"preprocess_i420": 0, "fused_dw": 0,
                                         "unpack_ragged": 0, "nms_fixed": 0}
    assert stats["engine"]["resize"] == "kernel"


def test_healthz_and_errors(server):
    with urllib.request.urlopen(server.url + "/healthz") as r:
        assert r.status == 200 and json.loads(r.read()) == {"ok": True}
    status, body = _post(server.url + "/predict", b"definitely not an image")
    assert status == 400 and "decode" in body["error"]
    status, body = _post(server.url + "/predict?topk=x", _jpeg(20, 20, 3))
    assert status == 400
    status, body = _post(server.url + "/predict", b"--x--\r\n", "multipart/form-data; boundary=x")
    assert status == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(server.url + "/nope")
    assert e.value.code == 404


def test_oversized_body_gets_413_unread(server):
    conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=60)
    try:
        conn.putrequest("POST", "/predict")
        conn.putheader("Content-Length", str(int(server.cfg.max_body_mb * 1e6) + 1))
        conn.endheaders()  # no body is sent: the answer must not wait for it
        r = conn.getresponse()
        assert r.status == 413 and "cap" in json.loads(r.read())["error"]
    finally:
        conn.close()


def test_warmup_runs_on_the_dispatch_thread():
    """First-use costs are paid per thread on CUDA, so every launch thread
    (each dispatches batches) runs the warmup before it takes one."""
    class Engine:
        max_batch = 4

        def __init__(self):
            self.threads = []
            self.lock = threading.Lock()

        def warmup(self):
            with self.lock:
                self.threads.append(threading.current_thread().name)

    eng = Engine()
    b = Batcher(eng).start(warmup=True)
    b.stop()
    launchers = sorted(t.name for t in b._launchers)
    assert len(launchers) >= 2 and sorted(eng.threads) == launchers

    class Broken(Engine):
        def warmup(self):
            raise RuntimeError("warmup failed")

    with pytest.raises(RuntimeError, match="warmup failed"):
        Batcher(Broken()).start(warmup=True)


def test_multipart_parser_keeps_payload_bytes():
    payload = b"\x00\r\nimage bytes ending in CRLF\r\n"
    data, ctype = _multipart([("x.bin", payload)])
    assert _parse_multipart_files(data, ctype) == [("x.bin", payload)]
    # header case does not matter
    data2 = data.replace(b"filename=", b"FILENAME=")
    assert _parse_multipart_files(data2, ctype) == [("x.bin", payload)]


def test_loadgen_reads_the_ports_stats(server):
    """``tools/loadgen.py``'s stage attribution and roofline table on the
    port's /stats around real requests, the engine's own span stages in
    /debug/slow, and the economics gauges in /metrics."""
    from tools.loadgen import fetch_stats, format_econ_table, format_stage_table, \
        stage_attribution

    from tensorflow_web_deploy_tpu_torch.utils.metrics import parse_prometheus_text

    before = fetch_stats(server.url + "/predict")
    for seed in range(4):
        assert _post(server.url + "/predict", _jpeg(60, 90, seed))[0] == 200
    after = fetch_stats(server.url + "/predict")
    attr = stage_attribution(before["tracing"], after["tracing"])
    assert {"image_decode", "device_transfer", "device_dispatch", "device_execute",
            "postprocess", "_e2e"} <= set(attr)
    assert "device_execute" in format_stage_table(attr, wall_s=1.0)
    [ref] = [r for r in after["economics"] if r.startswith("inception_v3@")]
    econ = after["economics"][ref]
    assert econ["wire"] == "yuv420" and econ["rows_total"] >= 4 and econ["mfu"] > 0
    assert econ["model_cost"]["macs_per_image"] > 0
    table = format_econ_table(after["economics"])
    assert ref in table and "MFU" in table and ("bandwidth" in table or "compute" in table)
    with urllib.request.urlopen(server.url + "/debug/slow", timeout=30) as r:
        slow = json.loads(r.read())
    # one image a request: a multipart request's images ride batches that
    # overlap its later decodes, so its stages may sum past its wall
    predicts = [e for e in slow["slowest"]
                if e["meta"]["path"] == "/predict" and e["meta"].get("images") == 1]
    assert predicts and all(sum(e["stages_ms"].values()) <= e["total_ms"] + 1e-3
                            for e in predicts)
    with urllib.request.urlopen(server.url + "/metrics", timeout=30) as r:
        samples = parse_prometheus_text(r.read().decode())["samples"]
    names = {n for n, _ in samples}
    assert {"tpu_serve_model_mfu", "tpu_serve_model_cell_mfu",
            "tpu_serve_model_roofline_bound_fraction", "tpu_serve_device_peak_flops_per_chip",
            "tpu_serve_model_replica_busy_seconds_total"} <= names
    assert samples[("tpu_serve_inferences_total", ())] == sum(
        v for (n, _), v in samples.items() if n == "tpu_serve_model_inferences_total")


def test_cli_observability_flags():
    cfg = config_from_args(parse_args(["--access-log", "-", "--flight-recorder-n", "8",
                                       "--telemetry-interval", "0", "--slo-objectives",
                                       "interactive=p99:500ms:99"]))
    assert (cfg.access_log, cfg.flight_recorder_n, cfg.telemetry_interval_s,
            cfg.slo_objectives) == ("-", 8, 0.0, "interactive=p99:500ms:99")
    dflt = config_from_args(parse_args([]))
    assert (dflt.access_log, dflt.flight_recorder_n, dflt.flight_recorder_recent_n,
            dflt.flight_recorder_bytes, dflt.telemetry_interval_s, dflt.slo_objectives) == \
        (None, 32, 512, 4 << 20, 1.0, "")


def test_cli_flags_build_the_config():
    args = parse_args(["--model", "native:inception_v3", "--wire-format", "yuv420",
                       "--resize", "kernel", "--dtype", "f32", "--canvas-buckets", "512,256",
                       "--device", "cpu", "--max-batch", "8"])
    cfg = config_from_args(args)
    assert cfg.model.dtype == "float32" and cfg.canvas_buckets == (256, 512)
    assert (cfg.wire_format, cfg.resize, cfg.max_batch) == ("yuv420", "kernel", 8)
    assert args.device == "cpu"
    with pytest.raises(ValueError, match="yuv420"):
        config_from_args(parse_args(["--resize", "kernel"]))


def test_int8_mobilenet_server_passes_its_gate_and_serves():
    args = parse_args(["--model", "native:mobilenet_v2", "--dtype", "int8", "--zoo-width", "0.25",
                       "--zoo-classes", "10", "--wire-format", "yuv420", "--resize", "kernel",
                       "--canvas-buckets", "64", "--max-batch", "4", "--host", "127.0.0.1",
                       "--port", "0", "--no-warmup"])
    cfg = config_from_args(args)
    assert (cfg.model.dtype, cfg.model.fused_dw, cfg.model.input_size) == ("int8", "auto",
                                                                          (224, 224))
    off = config_from_args(parse_args(["--model", "native:mobilenet_v2", "--fused-dw", "off"]))
    assert off.model.fused_dw == "off"
    cfg.model.input_size = (64, 64)
    with start_server(cfg, device="cpu") as srv:
        status, body = _post(srv.url + "/predict", _jpeg(50, 60, 5))
        assert status == 200 and len(body["predictions"]) == 5
        with urllib.request.urlopen(srv.url + "/stats") as r:
            engine = json.loads(r.read())["engine"]
    assert engine["dtype"] == "int8" and engine["fused_dw"] is True
    assert engine["parity"]["pass"] and engine["parity"]["tol_prob"] == 0.15
    assert engine["kernel_launches"]["fused_dw"] == 0  # CPU: the plain version ran


@pytest.mark.cuda
def test_float32_engine_from_start_server_turns_tf32_off():
    """An engine built through ``start_server`` (not the CLI) at float32
    computes in float32: TF32 is off in cuDNN and cuBLAS, and its forward
    equals the one with TF32 off, bit for bit, where TF32 on differs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    cfg = ServerConfig(
        model=ModelConfig(name="inception_v3", zoo_classes=10, input_size=(299, 299),
                          dtype="float32"),
        host="127.0.0.1", port=0, canvas_buckets=(256,), max_batch=4, warmup=False)
    x = torch.from_numpy(np.random.RandomState(0).uniform(-1, 1, (4, 299, 299, 3))
                         .astype(np.float32)).cuda()
    try:
        with start_server(cfg, device="cuda") as srv, torch.inference_mode():
            flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
            served = srv.engine.model(x)
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
            off = srv.engine.model(x)
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
            tf32 = srv.engine.model(x)
    finally:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    assert flags == (False, False)
    assert torch.equal(served, off)
    assert not torch.equal(served, tf32)  # TF32 would have moved the answer
