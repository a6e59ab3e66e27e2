"""Label-map loading and top-k postprocess (copy of the JAX package's
``utils/labels.py``).

One label per line, line number = class index; without a label file the
classes are named ``class_0000``...
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def load_labels(path: str | None, num_classes: int | None = None) -> list[str]:
    if path and Path(path).exists():
        labels = Path(path).read_text().splitlines()
        return [ln.strip() for ln in labels]
    n = num_classes or 1000
    return [f"class_{i:04d}" for i in range(n)]


def topk_labels(probs, labels: list[str], k: int = 5) -> list[dict]:
    """probs: 1-D numpy array of class scores → top-k [{label, index, score}]."""
    probs = np.asarray(probs)
    idx = np.argsort(probs)[::-1][:k]
    return [
        {
            "label": labels[i] if i < len(labels) else f"class_{i}",
            "index": int(i),
            "score": float(probs[i]),
        }
        for i in idx
    ]
