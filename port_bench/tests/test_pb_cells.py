"""Cells are found by name, and a cell, a mix or a metric is added as files
and a ``workloads`` entry."""

from __future__ import annotations

import json
import re

import pytest
from conftest import BENCH, ROOT, add_cell
from yardstick import cells

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_loads_by_name(workload):
    cell = cells.load_cell(workload)
    assert {m["name"] for m in cell.end_to_end} == {"img_per_s", "setup_s"}
    assert set(cell.readers) == {m["name"] for m in cell.per_layer}
    assert all(callable(r) for r in cell.readers.values())
    for key in ("arch", "width", "classes", "preprocess", "dtype", "topk", "device",
                "server_args", "weights", "correct"):
        assert key in cell.config, key
    assert cell.config["dtype"] == "float32" and "dtype=f32" in " ".join(cell.config["server_args"])
    assert cell.traffic["photos_per_call"] % len(cell.traffic["sizes"]) == 0


def test_spec_names_units_and_layers():
    names = [m["name"] for group in ("end_to_end", "per_layer") for m in SPEC[group]]
    names += [c["name"] for c in SPEC["configs"]] + [w["name"] for w in SPEC["workloads"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for c in SPEC["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("port_bench/")


def test_unknown_workload_is_refused():
    with pytest.raises(KeyError):
        cells.load_cell("no_such.cell")


def test_a_cell_added_as_files_and_an_entry(bench_copy):
    name = add_cell(bench_copy)
    cell = cells.load_cell(name, root=bench_copy, bench=bench_copy / "port_bench")
    assert cell.config["width"] == 0.25 and cell.traffic["clients"] == 2
    # the new metric is read in its own cell, with every metric of the
    # end-to-end metrics the cell reports
    assert "calls_per_s" in cell.readers
    assert {m["name"] for m in cell.per_layer} >= {"decode_ms", "mfu", "calls_per_s"}
    # and in no other cell
    other = cells.load_cell(SPEC["workloads"][0]["name"], root=bench_copy,
                            bench=bench_copy / "port_bench")
    assert "calls_per_s" not in other.readers


def test_prometheus_histogram_quantile():
    text = "\n".join([
        '# TYPE tpu_serve_stage_duration_seconds histogram',
        'tpu_serve_stage_duration_seconds_bucket{stage="queue_wait",le="0.1"} 10',
        'tpu_serve_stage_duration_seconds_bucket{stage="queue_wait",le="0.25"} 90',
        'tpu_serve_stage_duration_seconds_bucket{stage="queue_wait",le="0.5"} 100',
        'tpu_serve_stage_duration_seconds_bucket{stage="queue_wait",le="+Inf"} 100',
    ])
    before = text.replace(" 10\n", " 0\n").replace(" 90\n", " 0\n").replace(" 100", " 0")
    ctx = cells.Context(cell=None, window_s=1.0, photos_answered=0, latencies_ms=[], stats0={},
                        stats1={},
                        prom0=cells.parse_prometheus(before), prom1=cells.parse_prometheus(text),
                        trace=None, flops_per_image=0.0, peak=None, valid_bytes_per_photo=0.0,
                        out_hw=(1, 1))
    # rank 95 of 100 lies in (0.25, 0.5], half way through its 10
    assert ctx.stage_quantile("queue_wait", 0.95) == pytest.approx(0.375)
    assert ctx.stage_quantile("queue_wait", 0.5) == pytest.approx(0.1 + 0.15 * 40 / 80)
    assert ctx.stage_quantile("image_decode", 0.95) is None
