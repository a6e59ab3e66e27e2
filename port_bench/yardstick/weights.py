"""Weights made from the seed, in the flat layout of the program's serving
export (``variables.npz`` beside ``labels.txt``, which ``--ckpt`` reads).

Every leaf comes from one NumPy generator seeded by ``--seed``, in three
large draws over the leaves in sorted key order: normals for every kernel,
uniforms for the batch norms' scales and variances, normals for their
shifts. A kernel is scaled by ``conv_gain / sqrt(fan_in)`` (He's rule with
the configuration's gain). The configuration's ``multipliers`` scale the
leaves whose key ends with a given suffix: they keep the activations and
the logits in a range where the softmax is not one-hot, so that answers
carry the digits a comparison can read (with He's rule alone, ResNet-50's
sixteen residual sums double the variance each and every answer would be
one class at probability 1).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from .arch import walk_shapes

EXPORT_FILE = "variables.npz"


def rng(seed: int, *salt: int) -> np.random.Generator:
    """A generator for ``seed`` (any integer) and a fixed salt per use."""
    return np.random.default_rng(np.random.SeedSequence([seed % 2**64, *salt]))


def make_weights(arch: str, seed: int, spec: dict, width: float = 1.0,
                 classes: int = 1000) -> dict[str, np.ndarray]:
    shapes = walk_shapes(arch, width, classes).params
    keys = sorted(shapes)
    g = rng(seed, 1)
    kernels = [k for k in keys if k.endswith("/kernel")]
    bn = [k for k in keys if "/bn/" in k]
    z = g.standard_normal(sum(int(np.prod(shapes[k])) for k in kernels), dtype=np.float32)
    u = g.random(sum(shapes[k][0] for k in bn), dtype=np.float32)
    n = g.standard_normal(len(u), dtype=np.float32)
    out, zi, bi = {}, 0, 0
    for k in keys:
        shape = shapes[k]
        size = int(np.prod(shape))
        if k.endswith("/kernel"):
            fan_in = int(np.prod(shape[:-1]))
            a = z[zi : zi + size].reshape(shape) * np.float32(spec["conv_gain"] / np.sqrt(fan_in))
            zi += size
        elif "/bn/" in k:
            leaf = k.rsplit("/", 1)[1]
            uu, nn = u[bi : bi + size], n[bi : bi + size]
            bi += size
            if leaf in ("scale", "var"):
                lo, hi = spec[f"bn_{leaf}"]
                a = np.float32(lo) + uu * np.float32(hi - lo)
            else:  # bias, mean
                a = nn * np.float32(spec["bn_shift_std"])
        else:  # the dense head's bias
            a = np.zeros(shape, np.float32)
        for suffix, m in spec.get("multipliers", {}).items():
            if k.endswith(suffix):
                a = a * np.float32(m)
        out[k] = np.ascontiguousarray(a, dtype=np.float32)
    return out


def write_export(export_dir: str, params: dict[str, np.ndarray], classes: int) -> None:
    """The serving export: ``variables.npz`` and ``labels.txt``."""
    out = Path(export_dir)
    out.mkdir(parents=True, exist_ok=True)
    with open(out / EXPORT_FILE, "wb") as f:
        np.savez(f, **params)
    (out / "labels.txt").write_text("".join(f"class_{i}\n" for i in range(classes)))
