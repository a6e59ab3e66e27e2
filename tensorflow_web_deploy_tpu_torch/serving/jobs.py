"""Result formatting shared by the request path and, later, bulk jobs
(counterpart of the formatting section of the JAX package's
``serving/jobs.py``).

One image's row of the engine's output arrays becomes its JSON payload:
the classifier's top-k predictions, or the detector's boxes scaled to the
upload's original size. The bulk job runner of the reference's module
(``POST /jobs`` and its manifests) is ROADMAP Queue 1, item 14.
"""

from __future__ import annotations

import numpy as np


def clamp_topk(topk: int | None, model_cfg) -> int:
    """THE topk clamp (None = the model's default; both bounds enforced — a
    negative topk would slice labels from the wrong end)."""
    if topk is None:
        return model_cfg.topk
    return min(max(topk, 0), model_cfg.topk)


def format_result_row(row, orig_hw, topk: int, mv, trace_id=None) -> dict:
    """The task's payload for one image (the task and label map belong to
    the resolved model version ``mv``). Classify: ``row`` is (scores [K],
    indices [K]) and the first ``topk`` become ``predictions``. Detect:
    :func:`format_detections` against the upload's original (h, w).
    ``trace_id`` stamps the trace that computed the payload into it."""
    labels = mv.labels
    if mv.model_cfg.task == "detect":
        out = format_detections(row, orig_hw, labels)
    else:
        scores, idx = (np.asarray(r) for r in row)
        out = {
            "predictions": [
                {
                    "label": labels[i] if i < len(labels) else f"class_{i}",
                    "index": int(i),
                    "score": float(s),
                }
                for s, i in zip(scores[:topk], idx[:topk])
            ]
        }
    if trace_id is not None:
        out["trace_id"] = trace_id
    return out


def format_detections(row, image_hw, labels) -> dict:
    """(boxes [D, 4] normalized (ymin, xmin, ymax, xmax), scores [D],
    classes [D], num) → the first ``num`` detections with each box scaled
    by the image's (h, w)."""
    boxes, scores, classes, num = (np.asarray(r) for r in row)
    n = int(num)
    h, w = image_hw
    dets = []
    for i in range(n):
        y0, x0, y1, x1 = (float(v) for v in boxes[i])
        cls = int(classes[i])
        dets.append(
            {
                "box": [y0 * h, x0 * w, y1 * h, x1 * w],
                "class": cls,
                "label": labels[cls] if cls < len(labels) else f"class_{cls}",
                "score": float(scores[i]),
            }
        )
    return {"detections": dets, "num_detections": n}
