"""The profiler trace's reading: busy time as the union of device
operations, idle gaps named by the launch that ended them."""

from __future__ import annotations

import json

import pytest
from yardstick import trace


def write(tmp_path, events):
    p = tmp_path / "trace.json"
    p.write_text(json.dumps({"traceEvents": events}))
    return p


def x(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_busy_union_gaps_and_kernels(tmp_path):
    t = trace.read_trace(write(tmp_path, [
        x("cpu_op", "serve", 0.0, 100.0),                       # the window: 0..100 µs
        x("cuda_runtime", "cudaGraphLaunch", 5.0, 2.0, corr=1),
        x("kernel", "conv_a", 10.0, 20.0, corr=1),               # busy 10..30
        x("kernel", "conv_b", 25.0, 10.0, corr=1),               # overlaps: busy to 35
        x("cuda_runtime", "cudaMemcpyAsync", 45.0, 1.0, corr=2),  # issued inside the gap
        x("gpu_memcpy", "Memcpy HtoD", 50.0, 5.0, corr=2),       # busy 50..55
        x("kernel", "preprocess_ragged_kernel", 60.0, 10.0, corr=1),  # launched at 5: waiting
    ]))
    assert t.window_us == 100.0
    assert t.busy_us == pytest.approx(25.0 + 5.0 + 10.0)
    assert t.gaps_us == pytest.approx({
        "host_issuing_cudaGraphLaunch": 10.0,          # 0..10, launched at 5 ≥ 0
        "host_issuing_cudaMemcpyAsync": 15.0,          # 35..50, issued at 45
        "device_waiting_after_cudaGraphLaunch": 5.0,   # 55..60, issued at 5 < 55
        "after_last_device_op": 30.0})
    assert t.ops_us["conv_a"] == 20.0
    assert t.kernel_durations_us("preprocess_ragged") == [10.0]
    assert trace.top(t.gaps_us, 1) == [["after_last_device_op", 30.0 / 1e6]]


def test_a_trace_without_device_operations(tmp_path):
    t = trace.read_trace(write(tmp_path, [x("cpu_op", "serve", 0.0, 50.0)]))
    assert t.busy_us == 0 and t.window_us == 50.0
    assert t.gaps_us == {"after_last_device_op": 50.0}


def test_the_trace_names_its_host_process(tmp_path):
    meta = [{"ph": "M", "name": "process_labels", "pid": 4242, "args": {"labels": "CPU"}},
            {"ph": "M", "name": "process_labels", "pid": 0, "args": {"labels": "GPU 0"}},
            {"ph": "M", "name": "process_name", "pid": 4242, "args": {"name": "python"}}]
    t = trace.read_trace(write(tmp_path, [*meta, x("cpu_op", "serve", 0.0, 50.0)]))
    assert t.host_pids == {4242}
    assert trace.read_trace(write(tmp_path, [x("cpu_op", "serve", 0.0, 5.0)])).host_pids == set()
