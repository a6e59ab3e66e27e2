"""Zoo model construction and weight carry-over (counterpart of the JAX
package's ``models/adapter.py``).

Weights travel in the JAX package's flat layout: ``"params/stem1/conv/
kernel"`` (HWIO), ``"params/<block>/bn/{scale,bias}"``,
``"batch_stats/<block>/bn/{mean,var}"``, ``"params/logits/{kernel,bias}"``
(kernel [in, out]). :func:`from_jax_params` maps such a dict onto this
port's state dict by name; :func:`init_variables` draws the seeded init
with the reference's rule, so ``native:<name>`` with one seed is the same
network in both packages.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..graphdef import convert_graphdef, load_pb
from ..ops.quant import QSCALE_SUFFIX, Int8Conv2d, Int8Linear, quantize_params
from . import get
from .common import ConvBNCell, fold_bn, set_fused_dw


def _flax_key(torch_key: str) -> str:
    """Port state-dict key → the JAX package's flat key."""
    path, leaf = torch_key.rsplit(".", 1)
    path = path.replace(".", "/")
    if path.endswith("/bn") and leaf in ("mean", "var"):
        return f"batch_stats/{path}/{leaf}"
    if leaf == "weight":
        leaf = "kernel"
    return f"params/{path}/{leaf}"


def _torch_key(flax_key: str) -> str:
    collection, rest = flax_key.split("/", 1)
    path, leaf = rest.rsplit("/", 1)
    if leaf == "kernel":
        leaf = "weight"
    return f"{path.replace('/', '.')}.{leaf}"


def _to_flax_layout(value: torch.Tensor) -> np.ndarray:
    a = value.detach().cpu().numpy()
    if a.ndim == 4:  # OIHW → HWIO
        return a.transpose(2, 3, 1, 0)
    if a.ndim == 2:  # Linear [out, in] → Dense [in, out]
        return a.T
    return a


def _from_flax_layout(a: np.ndarray) -> torch.Tensor:
    """Float leaves become float32; int8 (quantized) kernels stay int8."""
    a = np.asarray(a)
    if a.dtype != np.int8:
        a = a.astype(np.float32)
    if a.ndim == 4:  # HWIO → OIHW
        a = a.transpose(3, 2, 0, 1)
    elif a.ndim == 2:
        a = a.T
    return torch.from_numpy(np.ascontiguousarray(a))


def from_jax_params(params_flat: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """The JAX package's flat params → this port's (unfolded) state dict."""
    return {_torch_key(k): _from_flax_layout(v) for k, v in params_flat.items()}


def to_jax_params(module: nn.Module) -> dict[str, np.ndarray]:
    """An unfolded module's state dict → the JAX package's flat layout."""
    return {_flax_key(k): _to_flax_layout(v) for k, v in module.state_dict().items()}


def init_variables(spec, num_classes: int | None = None, width: float = 1.0,
                   seed: int = 0) -> tuple[nn.Module, dict[str, np.ndarray]]:
    """Build a zoo model with its seeded init; returns (module, flat params
    in the JAX layout).

    The reference's rule: over the flattened keys in sorted order, one
    ``np.random.RandomState(seed)`` draws He-normal ``randn·sqrt(2/fan_in)``
    for every ``kernel`` (fan_in = product of all but the last HWIO/[in,
    out] dim); ``scale`` and ``var`` are ones, everything else zeros.
    """
    module = spec.build(num_classes=num_classes or spec.num_classes, width=width)
    shapes = {k: _to_flax_layout(v).shape for k, v in module.state_dict().items()}
    rs = np.random.RandomState(seed)
    flat = {}
    for key in sorted(shapes, key=lambda k: tuple(_flax_key(k).split("/"))):
        shape, name = shapes[key], key.rsplit(".", 1)[1]
        if name == "weight":
            fan_in = int(np.prod(shape[:-1])) or 1
            value = (rs.randn(*shape) * np.sqrt(2.0 / fan_in)).astype(np.float32)
        elif name in ("scale", "var"):
            value = np.ones(shape, np.float32)
        else:
            value = np.zeros(shape, np.float32)
        flat[_flax_key(key)] = value
    module.load_state_dict(from_jax_params(flat))
    return module, flat


class Classifier(nn.Module):
    """Serving wrapper: NHWC float images → softmax probabilities, as the
    reference's ``fn`` (softmax runs in the model's dtype)."""

    output_names = ["probs"]

    def __init__(self, backbone: nn.Module):
        super().__init__()
        self.backbone = backbone

    def forward(self, x_nhwc):
        # NHWC → NCHW as a view: the result is already channels_last.
        logits = self.backbone(x_nhwc.permute(0, 3, 1, 2))
        return torch.softmax(logits, dim=-1)


class Detector(nn.Module):
    """Serving wrapper of a detector: NHWC float images → (raw_boxes [B, A,
    4], raw_scores [B, A, C+1], anchors [A, 4]), as the reference's ``fn``.
    The anchors are a float32 buffer computed at the configured input
    size; a cast of the module moves them and keeps them float32 (the
    reference closes over them as a float32 constant, so box coordinates
    keep full precision whatever the serving dtype)."""

    output_names = ["raw_boxes", "raw_scores", "anchors"]

    def __init__(self, backbone: nn.Module, anchors: np.ndarray):
        super().__init__()
        self.backbone = backbone
        self.register_buffer("anchors", torch.from_numpy(np.asarray(anchors, np.float32)))

    def _apply(self, fn, recurse=True):
        anchors = self.anchors
        super()._apply(fn, recurse)
        self.anchors = anchors.to(self.anchors.device)
        return self

    def forward(self, x_nhwc):
        raw_boxes, raw_scores = self.backbone(x_nhwc.permute(0, 3, 1, 2))
        return raw_boxes, raw_scores, self.anchors


@torch.no_grad()
def quantize_int8(module: nn.Module, params_flat: dict[str, np.ndarray]) -> nn.Module:
    """The int8 tier's serving form of an unfolded module holding
    ``params_flat``: every conv and dense kernel becomes the reference's
    ``quantize_params`` int8 ``q`` (bit for bit the JAX package's, since it
    quantizes the same unfolded kernels) with its per-output-channel scale;
    each BN is folded into its conv's dequant scale (scale·s) and bias (t)
    rather than into the kernel. Weights stay int8 and are dequantized on
    every call (``ops/quant.py``). A plain conv with a bias outside a cell
    (the detector's heads) becomes an :class:`Int8Conv2d` with its bias
    as is."""
    qp = quantize_params(params_flat)

    def quant(torch_key):
        key = _flax_key(torch_key)
        return _from_flax_layout(qp[key]), torch.from_numpy(qp[key + QSCALE_SUFFIX])

    for name, m in list(module.named_modules()):
        parent, _, attr = name.rpartition(".")
        if isinstance(m, ConvBNCell) and not m.folded:
            m.fold(quant(f"{name}.{m.conv_attr}.weight"))
        elif isinstance(m, nn.Linear):
            setattr(module.get_submodule(parent), attr,
                    Int8Linear(*quant(f"{name}.weight"), m.bias.detach().clone()))
        elif isinstance(m, nn.Conv2d) and not isinstance(module.get_submodule(parent),
                                                         ConvBNCell):
            setattr(module.get_submodule(parent), attr,
                    Int8Conv2d(m, *quant(f"{name}.weight"), m.bias.detach().clone()))
    return module


def native_converted(name: str, num_classes: int | None = None, width: float = 1.0,
                     seed: int = 0, params_flat: dict[str, np.ndarray] | None = None,
                     fused_dw: bool = False, int8: bool = False,
                     input_size: int | None = None) -> Classifier | Detector:
    """A zoo model ready to serve: seeded init (or ``params_flat`` in the
    JAX layout), BN folded into the convs, eval mode, no gradients. A
    classifier becomes a :class:`Classifier`, the detector a
    :class:`Detector` whose anchors are those of ``input_size`` (the
    spec's unless given: it must be the size the serving preprocess
    resizes to).

    ``fused_dw=True`` serves the depthwise cells fused (one op each, the
    kernel on the card); the parameters are the same, and a model without
    depthwise cells ignores it. ``int8=True`` stores the kernels int8
    (:func:`quantize_int8`). Stays on the CPU in float32 (int8 kernels
    int8); the caller moves and casts it."""
    spec = get(name)
    module, flat = init_variables(spec, num_classes=num_classes, width=width, seed=seed)
    if params_flat is not None:
        module.load_state_dict(from_jax_params(params_flat))
        flat = params_flat
    if int8:
        quantize_int8(module, flat)
    else:
        fold_bn(module)
    set_fused_dw(module, fused_dw)
    if spec.task == "detect":
        model = Detector(module, module.anchors_for(input_size or spec.input_size)).eval()
    else:
        model = Classifier(module).eval()
    model.requires_grad_(False)
    return model


class ConvertedClassifier(nn.Module):
    """Serving wrapper of a converted frozen graph that classifies: NHWC
    float images → the graph's first output, its own softmax
    probabilities (the reference's serve function reads ``outs[0]``)."""

    def __init__(self, graph):
        super().__init__()
        self.graph = graph
        self.output_names = graph.output_names

    def forward(self, x_nhwc):
        return self.graph(x_nhwc)[0]


class ConvertedDetector(nn.Module):
    """Serving wrapper of a converted detector graph: NHWC float images →
    (raw_boxes, raw_scores, anchors) looked up by ``output_names``; anchors
    of shape [1, N, 4] are taken as [N, 4], as the reference's detect
    branch does."""

    def __init__(self, graph):
        super().__init__()
        self.graph = graph
        self.output_names = graph.output_names

    def forward(self, x_nhwc):
        by_name = dict(zip(self.output_names, self.graph(x_nhwc)))
        anchors = by_name["anchors"]
        return by_name["raw_boxes"], by_name["raw_scores"], (
            anchors[0] if anchors.dim() == 3 else anchors)


def converted_graph(cfg, graph=None, dtype: torch.dtype = torch.float32,
                    int8: bool = False) -> ConvertedClassifier | ConvertedDetector:
    """A frozen graph ready to serve, with the interface
    :func:`native_converted` gives the engine: ``cfg`` (a ``ModelConfig``
    with ``source="pb"``) names the file, its inputs and outputs; ``graph``
    is the parsed ``GraphDef`` when the caller has it. Built on the CPU in
    ``dtype`` (``int8``: the reference's eligible kernels int8,
    dequantized on every call); the caller moves it."""
    graph = load_pb(cfg.pb_path) if graph is None else graph
    model = convert_graphdef(graph, outputs=cfg.output_names,
                             inputs=[cfg.input_name] if cfg.input_name else None,
                             dtype=dtype, int8=int8)
    wrap = ConvertedDetector if cfg.task == "detect" else ConvertedClassifier
    return wrap(model).eval().requires_grad_(False)
