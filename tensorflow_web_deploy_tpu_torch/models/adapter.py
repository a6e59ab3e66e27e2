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

from . import get
from .common import fold_bn


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
    a = np.asarray(a, np.float32)
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

    def __init__(self, backbone: nn.Module):
        super().__init__()
        self.backbone = backbone

    def forward(self, x_nhwc):
        # NHWC → NCHW as a view: the result is already channels_last.
        logits = self.backbone(x_nhwc.permute(0, 3, 1, 2))
        return torch.softmax(logits, dim=-1)


def native_converted(name: str, num_classes: int | None = None, width: float = 1.0,
                     seed: int = 0, params_flat: dict[str, np.ndarray] | None = None
                     ) -> Classifier:
    """A zoo classifier ready to serve: seeded init (or ``params_flat`` in
    the JAX layout), BN folded into the convs, eval
    mode, no gradients. Stays on the CPU in float32; the caller moves it."""
    spec = get(name)
    if spec.task != "classify":
        raise NotImplementedError(f"{name}: only classifiers are ported")
    module, _ = init_variables(spec, num_classes=num_classes, width=width, seed=seed)
    if params_flat is not None:
        module.load_state_dict(from_jax_params(params_flat))
    fold_bn(module)
    model = Classifier(module).eval()
    model.requires_grad_(False)
    return model
