"""Whole runs of the tiny fixture cell with its server on the CPU: the last
line's keys, the look for a card, the import check by whole top-level
names, and ``correct`` coming out false with the timed path broken
underneath."""

from __future__ import annotations

import io
import json
import sys
from contextlib import redirect_stdout

import pytest
import run
from conftest import add_cell
from yardstick import cells, judge, server

CPU = {"platform": "cpu", "kind": "cpu", "count": 1}

# A server whose engine alters its answers where they are produced (the
# device side's output rows), patched in before the program's main runs.
FAULTY_SERVER = '''
import runpy, sys
import torch
from tensorflow_web_deploy_tpu_torch.serving import engine

FAULT = {fault!r}
head = engine.InferenceEngine._head


def faulty_head(self, model, x):
    out = head(self, model, x)
    k = self.topk
    if FAULT == "answer":  # the first row's top class moved to the next class
        out = out.clone()
        out[0, k] = torch.remainder(out[0, k] + 1, 10)
    elif FAULT == "half_batch":  # the second half of the rows answered as the first
        b = out.shape[0]
        out = torch.cat([out[: b - b // 2], out[: b // 2]])
    return out


engine.InferenceEngine._head = faulty_head
sys.argv = ["server", *sys.argv[1:]]
runpy.run_module("tensorflow_web_deploy_tpu_torch.server", run_name="__main__")
'''


# the tiny server answers a batch in about a second on a busy CPU: a window
# of several calls a client
WINDOW_S = 6.0


def tiny_run(root, trace=False, seed=2**31 + 1, **mix):
    cell = cells.load_cell(add_cell(root, **mix), root=root, bench=root / "port_bench")
    return run.run(cell, seed, WINDOW_S, trace, dict(CPU))


def test_last_line_keys_and_a_sound_run(bench_copy, monkeypatch):
    name = add_cell(bench_copy)
    monkeypatch.setattr(cells, "ROOT", bench_copy)
    monkeypatch.setattr(cells, "BENCH", bench_copy / "port_bench")
    real_load = cells.load_cell
    monkeypatch.setattr(cells, "load_cell", lambda n: real_load(
        n, root=bench_copy, bench=bench_copy / "port_bench"))
    out = io.StringIO()
    with redirect_stdout(out):
        rc = run.main(["--workload", name, "--seed", str(2**31 + 7), "--seconds", str(WINDOW_S),
                       "--trace", "0"], device=dict(CPU))
    assert rc == 0
    lines = out.getvalue().strip().splitlines()
    assert "setup_parts" in json.loads(lines[-2])
    result = json.loads(lines[-1])
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    assert set(result["metrics"]) == {"img_per_s", "setup_s"}
    assert all(m["value"] > 0 for m in result["metrics"].values())
    assert result["metrics"]["img_per_s"]["unit"] == "img/s"
    assert set(result["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(result["checks"]) == {"failed_calls", "malformed", "answer_gap"}
    assert all(set(c) == {"value", "limit"} for c in result["checks"].values())


def test_traced_run_reads_the_layers(bench_copy):
    result = tiny_run(bench_copy, trace=True)
    assert result["correct"] is True
    m = result["metrics"]
    # the program's spans and counters are read; the device metrics have
    # nothing to read off the card and are left out
    assert {"decode_ms", "batch_rows", "queue_wait_ms", "p95_ms.host", "calls_per_s"} <= set(m)
    assert not {"mfu", "device_ms_per_img", "device_idle", "preprocess_ragged_roofline"} & set(m)
    assert 1 <= m["batch_rows"]["value"] <= 8
    assert list(result)[-2:] == ["breakdown", "checks"]
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


def test_a_trace_of_another_process_is_not_read(bench_copy, monkeypatch):
    """A capture taken by another process's profiler listener (the port is
    fixed) gives no device metrics and no breakdown."""
    from yardstick import trace as traces

    real = traces.read_trace

    def of_another_process(path):
        t = real(path)
        t.host_pids = {1}
        return t

    monkeypatch.setattr(traces, "read_trace", of_another_process)
    result = tiny_run(bench_copy, trace=True)
    assert result["correct"] is True
    assert "breakdown" not in result and "busy_s" not in result["device"]
    assert {"decode_ms", "batch_rows"} <= set(result["metrics"])


def test_a_single_photo_mix_is_data(bench_copy):
    """One photo a call (a raw JPEG body, answered with ``predictions``) is a
    traffic file, not code."""
    result = tiny_run(bench_copy, photos_per_call=1, clients=4, calls=16,
                      path="/predict?slo=batch")
    assert result["correct"] is True and result["failed"] == 0
    assert result["checks"]["malformed"]["value"] == 0
    assert result["metrics"]["img_per_s"]["value"] > 0


@pytest.mark.parametrize("fault", ["answer", "half_batch"])
def test_a_broken_path_is_not_correct(bench_copy, tmp_path, monkeypatch, fault):
    script = tmp_path / "faulty_server.py"
    script.write_text(FAULTY_SERVER.format(fault=fault))
    monkeypatch.setattr(server, "server_command", lambda args: [sys.executable, str(script), *args])
    result = tiny_run(bench_copy)
    assert result["failed"] == 0
    assert result["correct"] is False
    assert result["checks"]["answer_gap"]["value"] > result["checks"]["answer_gap"]["limit"]


def test_without_a_card_no_result(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(SystemExit) as e:
        run.look_for_cards(1)
    assert e.value.code != 0
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("loaded,found", [
    (["tensorflow_web_deploy_tpu_torch", "tensorflow_web_deploy_tpu_torch.serving"], []),
    (["tensorflow_web_deploy_tpu.ops.image"], ["tensorflow_web_deploy_tpu"]),
    (["jax.numpy", "jaxtyping", "flaxen"], ["jax"]),
    (["jaxlib", "flax.linen"], ["flax", "jaxlib"]),
])
def test_import_check_compares_whole_top_level_names(monkeypatch, loaded, found):
    for name in loaded:
        monkeypatch.setitem(sys.modules, name, object())
    assert run.forbidden_modules() == found


@pytest.mark.cuda
def test_a_short_run_on_the_card_is_correct(card):
    out = io.StringIO()
    with redirect_stdout(out):
        rc = run.main(["--workload", "inception_v3-f32.batch32-c16", "--seed", "5",
                       "--seconds", "5", "--trace", "0"])
    assert rc == 0 and json.loads(out.getvalue().splitlines()[-1])["correct"] is True


@pytest.mark.cuda
def test_the_control_fails_on_the_card(card):
    import control

    cell = cells.load_cell("inception_v3-f32.batch32-c16")
    for seed in (1, 2, 3):
        table = control.control_checks(cell, seed, "cuda")
        assert judge.passed(table) is False, (seed, table)


def test_the_control_fails_at_test_size(bench_copy):
    import control

    cell = cells.load_cell(add_cell(bench_copy), root=bench_copy, bench=bench_copy / "port_bench")
    for seed in (1, 2, 3):
        table = control.control_checks(cell, seed, "cpu")
        # the harness's own comparison judges it, and only the gap fails
        assert judge.passed(table) is False, (seed, table)
        assert table["answer_gap"]["value"] > table["answer_gap"]["limit"]
