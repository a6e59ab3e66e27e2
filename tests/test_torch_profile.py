"""The port's profiler entry points on the CPU: ``server.py --profile`` (a
listener of its own that takes ``POST /debug/trace``'s capture, one a
process) and ``tools/profile_serve.py`` (the op table on a tiny config;
its ``--server`` stage table against the reference tool's on one stub
``/stats``)."""

import contextlib
import http.client
import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

import tools.profile_serve as ref_tool
from tensorflow_web_deploy_tpu_torch.server import config_from_args, parse_args
from tensorflow_web_deploy_tpu_torch.serving import http as thttp
from tensorflow_web_deploy_tpu_torch.tools import profile_serve as tool


def test_profile_flag_parses():
    assert parse_args([]).profile is False
    args = parse_args(["--profile", "--port", "8600"])
    assert args.profile is True and config_from_args(args).port == 8600
    assert thttp.PROFILE_PORT == 9999


def _post(port: int, path: str, timeout: float = 30.0) -> tuple[int, dict]:
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        c.request("POST", path)
        r = c.getresponse()
        return r.status, json.loads(r.read())
    finally:
        c.close()


@pytest.fixture
def listener():
    srv = thttp.start_profile_listener("127.0.0.1", 0)
    yield srv.server_address[1]
    srv.shutdown()
    srv.server_close()


def test_the_listener_captures_and_refuses_a_second_capture_at_once(listener, tmp_path):
    """A capture on the listener while a second one asks: the second is
    refused at once with /debug/trace's 409, and so is the serving port's
    own route, which shares the one capture of the process."""
    first = {}
    t = threading.Thread(target=lambda: first.update(
        r=_post(listener, f"/debug/trace?ms=600&dir={tmp_path}")), daemon=True)
    t.start()
    deadline = time.monotonic() + 10
    while not thttp._PROFILE_LOCK.locked():
        assert time.monotonic() < deadline, "the capture never started"
        time.sleep(0.005)
    t0 = time.monotonic()
    status, body = _post(listener, f"/debug/trace?ms=10&dir={tmp_path}")
    assert (status, body) == (409, {"error": "a profiler capture is already running"})
    assert time.monotonic() - t0 < 0.5, "the refusal waited for the capture"
    route = thttp.profile_route({"QUERY_STRING": "ms=10"})
    assert route[0].startswith("409") and json.loads(route[1]) == body
    t.join(timeout=30)
    status, doc = first["r"]
    assert status == 200 and doc["captured_ms"] == 600 and doc["activities"] == ["CPU"]
    with open(doc["trace_file"]) as f:
        assert json.load(f)["traceEvents"]
    assert _post(listener, f"/debug/trace?ms=1&dir={tmp_path}")[0] == 200  # free again


@pytest.mark.parametrize("path,status", [("/debug/trace?ms=banana", 400), ("/predict", 404)])
def test_the_listener_refuses_what_it_does_not_serve(listener, path, status):
    assert _post(listener, path)[0] == status


MODEL = ('{"name": "mobilenet_v2", "source": "native", "zoo_width": 0.25, '
         '"zoo_classes": 8, "input_size": [32, 32], "preprocess": "inception", '
         '"dtype": "float32", "topk": 3}')


@pytest.mark.parametrize("wire", ["rgb", "yuv420"])
def test_profile_serve_prints_an_op_table_on_the_cpu(tmp_path, capsys, wire):
    cfg = tmp_path / "m.json"
    cfg.write_text(MODEL)
    assert tool.main(["--model", str(cfg), "--device", "cpu", "--batch", "2", "--canvas", "64",
                      "--wire", wire, "--scan-batches", "2", "--top", "5",
                      "--trace-dir", str(tmp_path / "t")]) == 0
    out = capsys.readouterr().out
    head, times = out.splitlines()[:2]
    assert head.startswith(f"# {cfg} (float32) batch=2 canvas=64 wire={wire}")
    assert times.startswith("wall: ") and "CPU busy" in times
    assert "(CPU ops: no CUDA device on this run" in out
    rows = out.split("us/batch  per batch  kind        name\n")[1].split("\n\nby kind:")[0]
    assert len(rows.splitlines()) == 5
    assert (tmp_path / "t" / "trace.json").exists()


def test_profile_serve_rows_sum_to_busy(tmp_path):
    cfg = tmp_path / "m.json"
    cfg.write_text(MODEL)
    doc = tool.profile_serve(str(cfg), 2, 64, "rgb", None, 2, device="cpu")
    assert doc["rows"] and not doc["on_device"] and doc["replay_ms"] is None
    assert sum(r["us"] for r in doc["rows"]) / 1e3 == pytest.approx(doc["busy_ms"])
    assert sum(d["us"] for d in doc["by_kind"].values()) / 1e3 == pytest.approx(doc["busy_ms"])
    assert doc["resize"] == "matmul" and doc["ragged"]


@pytest.mark.parametrize("name,kind", [
    ("void preprocess_i420_kernel<__nv_bfloat16, true>(...)", "preprocess"),
    ("void preprocess_ragged_kernel<float>(...)", "preprocess"),
    ("void fused_dw_kernel<2>(...)", "depthwise"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc", "conv/gemm"),
    ("nvjet_tst_64x80_64x11_4x2_h_bz_TNT", "conv/gemm"),
    ("void at::native::(anonymous namespace)::avg_pool2d_out_cuda_frame_nhwc<c10::BFloat16>",
     "avg_pool"),
    ("void at::native::(anonymous namespace)::CatArrayBatchedCopy<...>", "cat"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::clamp_min_scalar_kernel",
     "activation"),
    ("void (anonymous namespace)::softmax_warp_forward<float, float, float, 10, false>",
     "softmax"),
    ("void at::native::sbtopk::gatherTopK<float, unsigned int, 2, false>", "topk"),
    ("void at::native::unrolled_elementwise_kernel<at::native::direct_copy_kernel_cuda", "cast/copy"),
    ("cudaGraphLaunch", "other"),
])
def test_kernel_kinds(name, kind):
    assert tool.kind_of(name) == kind


STATS = {
    "tracing": {
        "stages": {"image_decode": {"count": 12, "total_ms": 30.5},
                   "queue_wait": {"count": 12, "total_ms": 12.25},
                   "device_execute": {"count": 12, "total_ms": 48.0},
                   "http_read": {"count": 0, "total_ms": 0.0}},
        "e2e": {"count": 12, "total_ms": 120.0},
        "requests_by_status": {"2xx": 12, "4xx": 1},
    },
    "economics": {
        "inception_v3@1": {
            "model_cost": {"flops_per_image": 11.4e9, "param_bytes": 47.6e6},
            "peak": {"flops_per_chip": 989e12, "source": "table:NVIDIA H100"},
            "mfu": 0.0123, "padded_rows_fraction": 0.25,
            "padding": {"512x8": {"canvas": 512, "batch_bucket": 8, "padded_px_fraction": 0.7}},
            "replicas": [{"replica": 0, "buckets": [
                {"canvas": 512, "batch_bucket": 8, "mfu": 0.0123, "arithmetic_intensity": 210.5,
                 "roofline_bound_fraction": 0.4, "bound": "compute",
                 "padded_rows_fraction": 0.25, "device_s": 1.5},
                {"canvas": 512, "batch_bucket": 1, "mfu": None, "arithmetic_intensity": None,
                 "roofline_bound_fraction": None, "padded_rows_fraction": 0.0,
                 "device_s": 0.0}]}],
        },
    },
}


@pytest.fixture
def stub_stats():
    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            body = json.dumps(STATS).encode()
            self.send_response(200 if self.path == "/stats" else 404)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):
            pass

    srv = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()


def _printed(fn, *args) -> tuple[object, str]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(*args)
    return rc, buf.getvalue()


def test_server_mode_prints_the_references_table(stub_stats):
    rc, ours = _printed(tool.main, ["--server", stub_stats])
    rc_ref, ref = _printed(ref_tool.server_stage_table, stub_stats)
    assert (rc, rc_ref) == (0, 0)
    assert ours == ref
    assert "device_execute" in ours and "(end-to-end)" in ours and "MFU 1.23%" in ours
