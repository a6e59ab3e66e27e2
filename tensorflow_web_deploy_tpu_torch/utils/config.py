"""Model and server configuration (counterpart of the JAX package's
``utils/config.py``), reduced to the fields this port reads.

``resize="kernel"`` is the port's name for the JAX ``resize="pallas"``:
the fused I420 preprocess runs on the hand-written CUDA kernel
(``ops/preprocess_i420.py``). The validation rules are the reference's.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

# Accepted --dtype / ModelConfig.dtype spellings → canonical form.
_DTYPE_ALIASES = {
    "f32": "float32", "float32": "float32",
    "bf16": "bfloat16", "bfloat16": "bfloat16",
    "int8": "int8",
}

_ARTIFACTS = Path(__file__).resolve().parent.parent.parent / "artifacts"


def normalize_dtype(dtype: str) -> str:
    """Canonicalize a serving dtype; raise ValueError on anything else."""
    try:
        return _DTYPE_ALIASES[str(dtype).strip().lower()]
    except KeyError:
        raise ValueError(
            f"unsupported dtype {dtype!r} (supported: f32/float32, bf16/bfloat16, int8)"
        ) from None


@dataclasses.dataclass
class ModelConfig:
    """One native zoo model to serve."""

    name: str
    source: str = "native"
    # width multiplier + class count (tiny variants for tests; 1.0/None =
    # the real architecture)
    zoo_width: float = 1.0
    zoo_classes: int | None = None
    labels_path: str | None = None
    input_size: tuple[int, int] = (299, 299)
    # normalization applied on the device: "inception" ([-1, 1]),
    # "zero_one" (/255), "caffe" (BGR, mean-subtracted), "raw"
    preprocess: str = "inception"
    topk: int = 5
    # "float32" (the reference), "bfloat16" (weights and activations cast,
    # the default as in the JAX package) or "int8" (per-output-channel
    # int8 kernels dequantized on every call, computing in bf16; gated at
    # build by the engine's parity check against float32)
    dtype: str = "bfloat16"
    # Fused depthwise cells (ops/depthwise.py): "auto" fuses the int8 tier
    # only, "on"/"off" force it
    fused_dw: str = "auto"

    def __post_init__(self):
        if self.source != "native":
            raise ValueError(
                f"model '{self.name}': only source='native' is ported "
                "(the frozen-graph converter waits, ROADMAP.md Queue 1)"
            )
        try:
            self.dtype = normalize_dtype(self.dtype)
        except ValueError as e:
            raise ValueError(f"model '{self.name}': {e}") from None
        if self.fused_dw not in ("auto", "on", "off"):
            raise ValueError(
                f"model '{self.name}': fused_dw must be 'auto', 'on' or 'off', "
                f"got {self.fused_dw!r}"
            )
        self.input_size = tuple(self.input_size)

    @property
    def fuse_depthwise(self) -> bool:
        """The resolved ``fused_dw`` knob: "auto" fuses the int8 tier."""
        return self.fused_dw == "on" or (self.fused_dw == "auto" and self.dtype == "int8")


@dataclasses.dataclass
class ServerConfig:
    model: ModelConfig
    host: str = "0.0.0.0"
    port: int = 8500
    # dynamic batcher: a canvas bucket's open batch seals at max_batch
    # images or max_delay_ms after its first image, whichever comes first
    max_batch: int = 32
    max_delay_ms: float = 2.0
    # canvas size buckets for host-padded decoded images; the device
    # resizes from each image's valid region
    canvas_buckets: tuple[int, ...] = (256, 512, 1024, 2048)
    # Host→device canvas encoding: "rgb" (uint8 HWC) or "yuv420" (packed
    # I420, 1.5 B/px).
    wire_format: str = "rgb"
    # On-device resize: "matmul" (separable bilinear as torch.matmul),
    # "gather" (the same taps read by index) or "kernel" (the fused I420
    # CUDA kernel; yuv420 wire only).
    resize: str = "matmul"
    # Ragged wire: each image ships tight (h·w·3 bytes, no canvas padding)
    # in one flat byte arena per batch, and the device rebuilds the canvases
    # before the resize. rgb wire only: the engine serves yuv420 on the
    # classic wire and logs a warning. Off here as in the reference's
    # dataclass; the server's CLI turns it on by default.
    ragged: bool = False
    warmup: bool = True

    def __post_init__(self):
        # pick_bucket relies on ascending order
        self.canvas_buckets = tuple(sorted(set(self.canvas_buckets)))
        if self.wire_format not in ("rgb", "yuv420"):
            raise ValueError(f"wire_format must be 'rgb' or 'yuv420', got {self.wire_format!r}")
        if self.resize not in ("matmul", "gather", "kernel"):
            raise ValueError(
                f"resize must be 'matmul', 'gather' or 'kernel', got {self.resize!r}")
        if self.resize == "kernel":
            if self.wire_format != "yuv420":
                raise ValueError("resize='kernel' requires wire_format='yuv420'")
            if self.model.preprocess not in ("inception", "zero_one", "raw"):
                raise ValueError(
                    "resize='kernel' supports preprocess inception/zero_one/raw, "
                    f"not {self.model.preprocess!r}"
                )
        if self.wire_format == "yuv420":
            bad = [s for s in self.canvas_buckets if s % 4]
            if bad:
                raise ValueError(
                    f"yuv420 wire format needs canvas buckets divisible by 4; got {bad}"
                )


def model_config(name_or_path: str) -> ModelConfig:
    """Resolve ``native:<zoo name>`` or a JSON config path."""
    if name_or_path.startswith("native:"):
        from ..models import get as zoo_get, names as zoo_names

        try:
            spec = zoo_get(name_or_path[len("native:"):])
        except KeyError:
            raise ValueError(
                f"unknown native model '{name_or_path}' — have "
                + ", ".join(f"native:{n}" for n in zoo_names())
            ) from None
        return ModelConfig(
            name=spec.name,
            input_size=(spec.input_size, spec.input_size),
            preprocess=spec.preprocess,
            labels_path=str(_ARTIFACTS / "imagenet_labels.txt"),
        )
    p = Path(name_or_path)
    if p.suffix == ".json":
        data = json.loads(p.read_text())
        data["input_size"] = tuple(data.get("input_size", (299, 299)))
        return ModelConfig(**data)
    raise ValueError(
        f"unknown model '{name_or_path}' — expected native:<zoo name> or a .json config"
    )
