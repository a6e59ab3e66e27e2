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
from tensorflow_web_deploy_tpu_torch.serving.http import MAX_BODY_MB, _parse_multipart_files
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
    assert stats["engine"]["kernel_launches"] == {"preprocess_i420": 0}  # CPU: plain version
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
        conn.putheader("Content-Length", str((MAX_BODY_MB << 20) + 1))
        conn.endheaders()  # no body is sent: the answer must not wait for it
        r = conn.getresponse()
        assert r.status == 413 and "cap" in json.loads(r.read())["error"]
    finally:
        conn.close()


def test_warmup_runs_on_the_dispatch_thread():
    class Engine:
        max_batch = 4

        def warmup(self):
            self.thread = threading.current_thread().name

    eng = Engine()
    Batcher(eng).start(warmup=True).stop()
    assert eng.thread == "batcher"

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
