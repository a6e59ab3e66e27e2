"""The benchmark's own count of the work: the models' FLOPs from their
shapes, the bytes of the ragged preprocess kernel, and the card's peaks.

The FLOP count is the analytic one of the program's cost model
(``tensorflow_web_deploy_tpu_torch/serving/costmodel.py::model_cost``:
2 × the multiply-adds of every conv and of the dense head), taken here from
the plain reference's own shape walk, so that a later change to the
program cannot move the yardstick. The peak table is the cost model's
``CUDA_PEAKS`` rows (NVIDIA's H100 data sheets, dense rates; float32 on the
CUDA cores, TF32 off).
"""

from __future__ import annotations

from .arch import walk_shapes

# dense peak FLOP/s by serving dtype, and HBM bytes/s, per card, keyed by
# torch.cuda.get_device_name()
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"float32": 66.9e12, "bfloat16": 989.4e12, "hbm_bytes_per_s": 3.35e12},
}

META_ROW_BYTES = 16  # one int32 (offset, h, w, valid) row of the meta table


def flops_per_image(arch: str, width: float = 1.0, classes: int = 1000) -> int:
    """2 × the multiply-adds of the convs and the dense head for one image.
    A stem served through the space-to-depth rewrite counts as the one
    stride-2 conv it computes."""
    return 2 * walk_shapes(arch, width, classes).macs


def preprocess_ragged_bytes(valid_bytes: int, rows: int, out_h: int, out_w: int,
                            out_elt: int = 4) -> int:
    """The least bytes one call of the ragged preprocess must move: every
    input byte read once (the images' valid h·w·3 bytes in the arena, and a
    meta row per batch row) and every output element written once
    ([rows, out_h, out_w, 3] at ``out_elt`` bytes), whatever an
    implementation reads again."""
    return valid_bytes + rows * META_ROW_BYTES + rows * out_h * out_w * 3 * out_elt
