"""The benchmark's counts of the work, from the shapes, against the
program's cost model (the test imports both; the yardstick does not)."""

from __future__ import annotations

import pytest
from yardstick import arch, costs

from tensorflow_web_deploy_tpu_torch.models import adapter, get
from tensorflow_web_deploy_tpu_torch.serving import costmodel
from tensorflow_web_deploy_tpu_torch.utils.config import model_config


@pytest.mark.parametrize("name,flops", [("inception_v3", 11_426_432_192),
                                        ("resnet50", 8_178_368_512)])
def test_flops_of_both_models(name, flops):
    assert costs.flops_per_image(name) == flops
    mc = model_config(f"native:{name}")
    assert costmodel.model_cost(mc)["flops_per_image"] == flops


@pytest.mark.parametrize("name", ["inception_v3", "resnet50"])
@pytest.mark.parametrize("width,classes", [(1.0, 1000), (0.25, 10)])
def test_shapes_are_the_programs_export_layout(name, width, classes):
    """Every leaf the export holds is one the program's ``--ckpt`` reads,
    with its shape, and the FLOPs agree at any width."""
    module = get(name).build(num_classes=classes, width=width)
    program = {k: tuple(v.shape) for k, v in adapter.to_jax_params(module).items()}
    assert arch.walk_shapes(name, width, classes).params == program
    mc = model_config(f"native:{name}")
    mc.zoo_width, mc.zoo_classes = width, classes
    flops = costmodel.model_cost(mc)["flops_per_image"]
    assert costs.flops_per_image(name, width, classes) == flops


def test_preprocess_ragged_bytes_from_the_shapes():
    # a batch of 32 rows (30 photos and 2 holes) at 299 out in float32:
    # the valid bytes once, 16 bytes a meta row, 32 × 299² × 3 × 4 written
    hws = [(240, 320)] * 10 + [(384, 512)] * 20
    valid = sum(h * w * 3 for h, w in hws)
    n = costs.preprocess_ragged_bytes(valid, 32, 299, 299)
    assert n == valid + 32 * 16 + 32 * 299 * 299 * 3 * 4
    assert costs.preprocess_ragged_bytes(valid, 32, 224, 224, out_elt=2) == (
        valid + 32 * 16 + 32 * 224 * 224 * 3 * 2)
    # the least time at the H100's 3.35 TB/s
    least_us = n / costs.PEAKS["NVIDIA H100 80GB HBM3"]["hbm_bytes_per_s"] * 1e6
    assert least_us == pytest.approx(n / 3.35e6)


def test_peaks_are_the_cost_models():
    row = costmodel.CUDA_PEAKS["NVIDIA H100 80GB HBM3"]
    mine = costs.PEAKS["NVIDIA H100 80GB HBM3"]
    assert mine["float32"] == pytest.approx(row["float32"] * 1e12)
    assert mine["bfloat16"] == pytest.approx(row["bfloat16"] * 1e12)
    assert mine["hbm_bytes_per_s"] == pytest.approx(row["hbm_gbps"] * 1e9)
