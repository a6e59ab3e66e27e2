"""Tests of the benchmark's harness (``python -m pytest port_bench/tests``).

They run on the CPU: the harness's own arithmetic, its cells found by
name, the plain reference against the program at a tiny width, and whole
runs of a tiny fixture cell whose server runs on the CPU. Tests marked
``cuda`` need the card and skip without one (decided in the ``card``
fixture, never at import).
"""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))

# the tiny fixture cell: Inception-v3 at width 0.25 and 10 classes, served
# on the CPU, 2 clients of 8-photo calls
TINY_SERVER_ARGS = ["--model", "native:inception_v3,dtype=f32", "--topk", "5", "--device", "cpu",
                    "--zoo-width", "0.25", "--zoo-classes", "10", "--canvas-buckets", "512",
                    "--max-batch", "8", "--http-workers", "4", "--cache-bytes", "0",
                    "--pressure-rungs", "2:2,2:2,2:2", "--log-level", "WARNING"]


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def add_cell(root: Path, name: str = "tiny", traffic: str = "tiny2", **mix) -> str:
    """Add the tiny cell to a copy of the benchmark under ``root`` as files
    and one ``workloads`` entry: a configuration, a traffic mix (``mix``
    overrides its fields) and a new per-layer metric with its reader.
    Returns the cell's name."""
    bench = root / "port_bench"
    cfg = json.loads((BENCH / "configs" / "inception_v3-f32.json").read_text())
    cfg.update(width=0.25, classes=10, device="cpu", server_args=TINY_SERVER_ARGS,
               reduced=["width", "classes"])
    (bench / "configs" / f"{name}.json").write_text(json.dumps(cfg, indent=1))
    tf = json.loads((BENCH / "traffic" / "batch32-c16.json").read_text())
    tf.update({"clients": 2, "photos_per_call": 8, "pool_per_size": 2, "calls": 4,
               "warmup_calls": 1, **mix})
    (bench / "traffic" / f"{traffic}.json").write_text(json.dumps(tf, indent=1))
    (bench / "metrics" / "calls_per_s.py").write_text(
        "def read(ctx):\n    return ctx.stage_delta('image_decode')[0] / ctx.window_s\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": name, "source": "test",
                            "file": f"port_bench/configs/{name}.json",
                            "reduced": ["width", "classes"], "why": "a tiny cell on the CPU"})
    cell = f"{name}.{traffic}"
    spec["workloads"].append({"name": cell, "config": name, "traffic": traffic, "chips": 1,
                              "why": "a tiny cell on the CPU"})
    spec["per_layer"].append({"name": "calls_per_s", "unit": "1/s", "better": "higher",
                              "source": "program_span", "layer": "front end and decode",
                              "moves": "img_per_s", "workloads": [cell]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return cell


@pytest.fixture
def bench_copy(tmp_path) -> Path:
    """A copy of ``BENCHMARK.json`` and the benchmark's data files."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    for sub in ("configs", "traffic", "metrics"):
        shutil.copytree(BENCH / sub, tmp_path / "port_bench" / sub)
    return tmp_path
