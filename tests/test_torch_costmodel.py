"""The port's cost model (``serving/costmodel.py``) held to the JAX
package's: analytic counts integer-equal for the four zoo architectures at
the zoo's widths and the tests' tiny ones, the traffic and roofline
arithmetic equal for a fixed peak, the card's peak table, and the engine's
measured cells on the CPU joined into an economics block."""

import dataclasses
import math

import numpy as np
import pytest

from tensorflow_web_deploy_tpu.serving import costmodel as jc
from tensorflow_web_deploy_tpu_torch.serving import costmodel as tc
from tensorflow_web_deploy_tpu_torch.serving.engine import InferenceEngine
from tensorflow_web_deploy_tpu_torch.utils.config import ModelConfig, ServerConfig


@dataclasses.dataclass
class Cfg:
    name: str
    input_size: tuple
    zoo_width: float = 1.0
    zoo_classes: int | None = None
    dtype: str = "bfloat16"


ARCHS = {"inception_v3": (299, 299), "mobilenet_v2": (224, 224), "resnet50": (224, 224),
         "ssd_mobilenet": (300, 300)}
SIZES = [(1.0, None, None), (0.25, 10, (75, 75)), (0.5, 10, (64, 64)), (0.35, 7, (65, 65))]


@pytest.mark.parametrize("name", list(ARCHS))
@pytest.mark.parametrize("dtype", ["bfloat16", "int8", "float32"])
def test_model_cost_is_integer_equal_to_the_reference(name, dtype):
    for width, classes, hw in SIZES:
        cfg = Cfg(name, hw or ARCHS[name], width, classes, dtype)
        got, want = tc.model_cost(cfg), jc.model_cost(cfg)
        assert got == want
        assert all(type(got[k]) is int for k in ("macs_per_image", "flops_per_image",
                                                 "param_count", "param_bytes"))
    assert tc.model_cost(Cfg("not_a_zoo_model", (224, 224))) is None


def test_published_counts():
    inc = tc.model_cost(Cfg("inception_v3", (299, 299)))
    mob = tc.model_cost(Cfg("mobilenet_v2", (224, 224)))
    assert round(inc["macs_per_image"] / 1e9, 2) == 5.71
    assert mob["macs_per_image"] == 300_774_272  # "300 M mult-adds"
    assert mob["param_count"] == 3_504_872


PEAKS = [
    {"flops_per_chip": 989.4e12, "bytes_per_s_per_chip": 3.35e12, "source": "fixed"},
    {"flops_per_chip": 1e11, "bytes_per_s_per_chip": 0.0, "source": "no bandwidth"},
    {"flops_per_chip": 0.0, "bytes_per_s_per_chip": 0.0, "source": "unknown"},
]


@pytest.mark.parametrize("wire", ["rgb", "yuv420", "ragged"])
def test_traffic_and_bucket_economics_equal_the_reference(wire):
    rng = np.random.RandomState(0)
    for name, hw in ARCHS.items():
        for dtype in ("bfloat16", "int8", "float32"):
            cost = jc.model_cost(Cfg(name, hw, dtype=dtype))
            for s in (256, 512, 1024, 2048):
                assert tc.preprocess_flops(s, hw, wire) == jc.preprocess_flops(s, hw, wire)
                for b in (1, 8, 32):
                    assert tc.bytes_per_image(cost, s, b, wire) == \
                        jc.bytes_per_image(cost, s, b, wire)
                    rows = int(rng.randint(0, b + 1))
                    disp = b if wire != "ragged" else int(rng.randint(1, b + 1))
                    tight = float(rng.uniform(0, disp))
                    dev = float(rng.choice([0.0, rng.uniform(1e-4, 0.1)]))
                    for peak in PEAKS:
                        for c in (cost, None):
                            args = (c, s, b, rows, disp, dev, peak, 1, hw, wire)
                            assert tc.bucket_economics(*args, rows_tight=tight) == \
                                jc.bucket_economics(*args, rows_tight=tight)


def test_h100_peak_table():
    sxm_bf16 = tc.cuda_peak("NVIDIA H100 80GB HBM3", "bfloat16")
    assert sxm_bf16 == {"flops_per_chip": 989.4e12, "bytes_per_s_per_chip": 3350e9,
                        "source": "cuda-table:NVIDIA H100 80GB HBM3:bfloat16"}
    assert tc.cuda_peak("NVIDIA H100 80GB HBM3", "int8")["flops_per_chip"] == 989.4e12
    f32 = tc.cuda_peak("NVIDIA H100 80GB HBM3", "float32")
    assert f32["flops_per_chip"] == pytest.approx(66.9e12)
    assert f32["flops_per_chip"] != sxm_bf16["flops_per_chip"] / 2  # TF32 off: CUDA cores
    pcie = tc.cuda_peak("NVIDIA H100 PCIe", "bfloat16")
    assert pcie["flops_per_chip"] == pytest.approx(756.5e12)
    assert pcie["bytes_per_s_per_chip"] == pytest.approx(2000e9)
    assert tc.cuda_peak("NVIDIA H100 PCIe", "float32")["flops_per_chip"] == pytest.approx(51.2e12)
    unknown = tc.cuda_peak("NVIDIA Z9000", "bfloat16")
    assert unknown["source"] == "cuda-unknown:NVIDIA Z9000"
    cost = tc.model_cost(Cfg("mobilenet_v2", (224, 224)))
    cell = tc.bucket_economics(cost, 512, 8, 8, 8, 0.001, unknown, 1, (224, 224), "ragged", 4.0)
    assert cell["mfu"] is None and cell["roofline_bound_fraction"] is None


class _FakeEngine:
    """The econ surface of an engine: cells, a wire and a device."""

    def __init__(self, wire="rgb", ragged=True):
        self.cfg = type("C", (), {"wire_format": wire})()
        self.ragged = ragged
        self.device = "cpu"

    def econ_stats(self):
        return [{"replica": 0, "devices": 1, "buckets": [
            {"canvas": 256, "batch_bucket": 4, "batches": 3, "rows": 9, "rows_dispatched": 8,
             "device_s": 0.0125, "rows_tight": 5.25},
            {"canvas": 512, "batch_bucket": 8, "batches": 1, "rows": 8, "rows_dispatched": 8,
             "device_s": 0.003, "rows_tight": 7.5},
            {"canvas": 512, "batch_bucket": 1, "batches": 1, "rows": 0, "rows_dispatched": 1,
             "device_s": 0.0, "rows_tight": 0.0}]}]


@pytest.mark.parametrize("wire,ragged", [("rgb", True), ("rgb", False), ("yuv420", False)])
def test_economics_snapshot_equals_the_reference(monkeypatch, wire, ragged):
    peak = PEAKS[0]
    monkeypatch.setattr(tc, "backend_peak", lambda dtype, device=None, n_dev=1: peak)
    monkeypatch.setattr(jc, "backend_peak", lambda dtype: peak)
    for name, hw in ARCHS.items():
        for dtype in ("bfloat16", "int8"):
            cfg = Cfg(name, hw, dtype=dtype)
            eng = _FakeEngine(wire, ragged)
            got, want = tc.economics_snapshot(eng, cfg), jc.economics_snapshot(eng, cfg)
            assert got == want and 0 < got["mfu"] < 1
    assert tc.economics_snapshot(object(), Cfg("mobilenet_v2", (224, 224))) is None


def test_cpu_peak_is_calibrated_once_per_compute_dtype():
    a = tc.backend_peak("bfloat16", "cpu")
    assert a["source"] == "cpu-calibrated:bfloat16:/1dev"
    assert a["flops_per_chip"] > 0 and a["bytes_per_s_per_chip"] > 0
    assert tc.backend_peak("int8", "cpu") is a  # int8 computes in bf16
    assert tc.backend_peak("float32", "cpu")["source"] == "cpu-calibrated:float32:/1dev"


def test_engine_cells_become_an_economics_block():
    """A tiny MobileNetV2 on the CPU: every fetched batch lands in its
    (canvas, batch bucket) cell, ``busy_s`` sums the cells, and the block
    carries an MFU against the calibrated peak."""
    mc = ModelConfig(name="mobilenet_v2", zoo_width=0.25, zoo_classes=10, input_size=(64, 64),
                     dtype="float32")
    eng = InferenceEngine(ServerConfig(model=mc, canvas_buckets=(64,), max_batch=4,
                                       ragged=True), device="cpu")
    rng = np.random.RandomState(0)
    images = [(rng.rand(h, w, 3) * 255).astype(np.uint8) for h, w in ((40, 64), (64, 30),
                                                                       (12, 12))]
    eng.run_ragged(images, np.array([im.shape[:2] for im in images]), 64)
    eng.run_ragged(images[:1], np.array([images[0].shape[:2]]), 64)
    [rep] = eng.econ_stats()
    cells = {(c["canvas"], c["batch_bucket"]): c for c in rep["buckets"]}
    assert set(cells) == {(64, 4), (64, 1)}
    assert cells[(64, 4)]["rows"] == 3 and cells[(64, 1)]["rows"] == 1
    assert cells[(64, 4)]["rows_tight"] == pytest.approx(
        sum(im.size for im in images) / (64 * 64 * 3), abs=1e-3)
    assert eng.stats()["busy_s"] == pytest.approx(sum(c["device_s"] for c in cells.values()),
                                                  abs=1e-3)
    econ = tc.economics_snapshot(eng, mc)
    assert econ["wire"] == "ragged" and econ["rows_total"] == 4
    assert econ["peak"]["source"] == "cpu-calibrated:float32:/1dev"
    assert math.isfinite(econ["mfu"]) and econ["mfu"] > 0
    eng.close()
