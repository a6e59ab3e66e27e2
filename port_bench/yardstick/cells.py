"""Cells found by name: ``BENCHMARK.json``'s entry, the configuration's
file, the traffic mix's file (``port_bench/traffic/<mix>.json``) and one
reader a per-layer metric (``port_bench/metrics/<metric>.py``, whose
``read(ctx)`` returns a number or None).

A later cell is a ``workloads`` entry plus files: nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass, field
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "port_bench"


@dataclass
class Cell:
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list[dict]
    per_layer: list[dict]
    readers: dict = field(default_factory=dict)  # per-layer metric name → read(ctx)


def _applies(metric: dict, cell: str, reported: set[str] | None = None) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return reported is None or metric["moves"] in reported


def load_reader(path: Path):
    name = "port_bench_metric_" + re.sub(r"\W", "_", path.stem)
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def load_cell(name: str, root: Path = ROOT, bench: Path = BENCH) -> Cell:
    spec = json.loads((root / "BENCHMARK.json").read_text())
    try:
        w = next(w for w in spec["workloads"] if w["name"] == name)
    except StopIteration:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json") from None
    conf = next(c for c in spec["configs"] if c["name"] == w["config"])
    e2e = [m for m in spec["end_to_end"] if _applies(m, name)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"] if _applies(m, name, reported)]
    traffic = json.loads((bench / "traffic" / f"{w['traffic']}.json").read_text())
    if traffic["loop"] != "closed":
        raise ValueError(f"traffic {w['traffic']!r}: only a closed loop is generated")
    cell = Cell(name=name, config_name=w["config"], traffic_name=w["traffic"], chips=w["chips"],
                config=json.loads((root / conf["file"]).read_text()),
                traffic=traffic,
                end_to_end=e2e, per_layer=per_layer)
    for m in per_layer:
        cell.readers[m["name"]] = load_reader(bench / "metrics" / f"{m['name']}.py")
    return cell


# ------------------------------------------------------ what readers read

_SAMPLE = re.compile(r'^(\w+)\{(.*)\}\s+(\S+)$')
_LABEL = re.compile(r'(\w+)="((?:\\.|[^"\\])*)"')


def parse_prometheus(text: str) -> dict:
    """Labelled samples: {(name, ((label, value), ...)): float}."""
    out = {}
    for line in text.splitlines():
        m = _SAMPLE.match(line)
        if m:
            labels = tuple(sorted(_LABEL.findall(m.group(2))))
            out[(m.group(1), labels)] = float(m.group(3))
    return out


@dataclass
class Context:
    """What a per-layer reader may read: the server's ``/stats`` and
    ``/metrics`` before and after the window, the window itself (its
    seconds, the photos answered by its close, every call's latency), the
    profiler's trace (None without one), and the benchmark's own counts."""

    cell: Cell
    window_s: float
    photos_answered: int
    latencies_ms: list[float]  # every call sent in the window, ascending; a failure is inf
    stats0: dict
    stats1: dict
    prom0: dict
    prom1: dict
    trace: object | None
    flops_per_image: float
    peak: dict | None  # costs.PEAKS row of the card, None for another
    valid_bytes_per_photo: float  # mean h·w·3 of the photos answered
    out_hw: tuple[int, int]

    def engine_delta(self, key: str) -> float:
        return self.stats1["engine"][key] - self.stats0["engine"][key]

    def decodes_delta(self) -> int:
        d0, d1 = self.stats0["engine"]["decodes"], self.stats1["engine"]["decodes"]
        return sum(d1.values()) - sum(d0.values())

    def stage_delta(self, stage: str) -> tuple[int, float]:
        """(requests, total ms) the span stage gained in the window."""
        s0 = self.stats0["tracing"]["stages"].get(stage, {"count": 0, "total_ms": 0.0})
        s1 = self.stats1["tracing"]["stages"].get(stage, {"count": 0, "total_ms": 0.0})
        return s1["count"] - s0["count"], s1["total_ms"] - s0["total_ms"]

    def stage_quantile(self, stage: str, q: float) -> float | None:
        """The q-quantile (seconds) of a stage's histogram deltas over the
        window, interpolated in its bucket (PromQL's histogram_quantile)."""
        name = "tpu_serve_stage_duration_seconds_bucket"
        rows = []
        for (n, labels), v in self.prom1.items():
            d = dict(labels)
            if n == name and d.get("stage") == stage:
                le = float("inf") if d["le"] == "+Inf" else float(d["le"])
                rows.append((le, v - self.prom0.get((n, labels), 0.0)))
        rows.sort()
        if not rows or rows[-1][1] <= 0:
            return None
        rank, lo, prev = q * rows[-1][1], 0.0, 0.0
        for le, cum in rows:
            if cum >= rank:
                if le == float("inf"):
                    return lo
                return lo + (le - lo) * (rank - prev) / (cum - prev) if cum > prev else le
            lo, prev = le, cum
        return lo

    def econ_delta(self) -> dict:
        """rows, rows_dispatched and device_s over every (canvas, batch)
        cell of the default model's economics."""
        def total(stats):
            acc = {"rows": 0, "rows_dispatched": 0, "device_s": 0.0}
            for entry in stats["economics"].values():
                for rep in entry.get("replicas", []):
                    for c in rep["buckets"]:
                        for k in acc:
                            acc[k] += c[k]
            return acc
        a, b = total(self.stats0), total(self.stats1)
        return {k: b[k] - a[k] for k in a}
