"""Detection postprocess: anchor box decode + static-shape multi-class NMS
(counterpart of the JAX package's ``ops/detection.py``).

The same output contract as the reference's: per-class top-k candidate
pruning, NMS over a fixed candidate count, a fixed ``max_detections``
output zero-padded past an explicit ``num_detections`` count, so every
batch has the same shapes and one CUDA graph serves it.

The per-(image, class) NMS is :func:`nms_fixed`. On a CUDA tensor it is one
launch of the hand-written kernel ``csrc/nms_fixed.cu`` for all of a
batch's (image, class) rows; on a CPU tensor it is
:func:`nms_fixed_plain`, the reference's parallel fixpoint (``keep ← cand
∧ ¬∃ higher-priority kept overlapper``, iterated until it stops changing).
The fixpoint's test reads a device bool on the host, which a CUDA graph
cannot capture; the kernel walks the candidates greedily in priority order
instead, which gives the fixpoint's result (the reference's docstring:
priority is a strict total order, so the suppression DAG is acyclic and
its fixpoint is the greedy result).

Candidates are ordered as the reference's ``lax.top_k`` orders them:
descending score, the lower index first among equal scores. ``torch.topk``
makes no promise about ties on CUDA, and a bf16 forward gives many equal
sigmoid scores, so both selections here are a stable descending
``torch.sort`` and a slice. The reference's one-hot matmul row fetch is a
TPU device; ``torch.gather`` is exact and takes its place.
"""

from __future__ import annotations

import ctypes

import torch

from . import launches
from .image import _divide

# SSD box-coder variances (standard TF object-detection values).
SCALE_FACTORS = (10.0, 10.0, 5.0, 5.0)
# the kernel's largest candidate count per (image, class) (csrc/nms_fixed.cu)
MAX_CANDIDATES = 256


def decode_boxes(rel_codes: torch.Tensor, anchors: torch.Tensor,
                 scale_factors=SCALE_FACTORS) -> torch.Tensor:
    """SSD faster-rcnn box coder: [..., A, 4] (ty, tx, th, tw) + anchors
    [A, 4] (cy, cx, h, w) → [..., A, 4] (ymin, xmin, ymax, xmax), in the
    reference's float32 operations and order (true divisions by the
    scale factors)."""
    ty, tx, th, tw = rel_codes.unbind(-1)
    cy, cx, h, w = anchors.unbind(-1)
    ty = _divide(ty, scale_factors[0])
    tx = _divide(tx, scale_factors[1])
    th = _divide(th, scale_factors[2])
    tw = _divide(tw, scale_factors[3])
    ncy = ty * h + cy
    ncx = tx * w + cx
    nh = torch.exp(th) * h
    nw = torch.exp(tw) * w
    return torch.stack([ncy - nh / 2, ncx - nw / 2, ncy + nh / 2, ncx + nw / 2], dim=-1)


def _area(b: torch.Tensor) -> torch.Tensor:
    return (b[..., 2] - b[..., 0]).clamp(min=0.0) * (b[..., 3] - b[..., 1]).clamp(min=0.0)


def _inter_union(boxes_a: torch.Tensor, boxes_b: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Pairwise intersection and union areas: [..., N, 4] × [..., M, 4] →
    two [..., N, M]."""
    a, b = boxes_a[..., :, None, :], boxes_b[..., None, :, :]
    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:], b[..., 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = _area(boxes_a)[..., :, None] + _area(boxes_b)[..., None, :] - inter
    return inter, union


def iou_matrix(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """[N, 4] × [M, 4] → [N, M] IoU (boxes as ymin, xmin, ymax, xmax)."""
    inter, union = _inter_union(boxes_a, boxes_b)
    return inter / union.clamp(min=1e-8)


def nms_fixed_plain(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
                    score_threshold: float) -> torch.Tensor:
    """Exact greedy NMS over K candidates in any order, per row: boxes
    [..., K, 4], scores [..., K] → keep mask bool [..., K].

    The reference's parallel fixpoint: priority is (score, then lower
    index); ``iou > thr`` is evaluated as ``inter > thr·union``; the keep
    mask is recomputed from the candidates until no row changes (at most
    K + 1 passes, the reference's bound). Each pass's test is a host read,
    so this runs eagerly, never inside a CUDA graph."""
    k = boxes.shape[-2]
    inter, union = _inter_union(boxes, boxes)
    overlap = inter > iou_threshold * union  # [..., K, K]
    idx = torch.arange(k, device=scores.device)
    si, sj = scores[..., :, None], scores[..., None, :]
    prio = (si > sj) | ((si == sj) & (idx[:, None] < idx[None, :]))
    m = overlap & prio  # m[i, j]: a kept i suppresses j
    cand = scores > score_threshold
    keep = cand
    for _ in range(k + 1):
        new = cand & ~(m & keep[..., :, None]).any(dim=-2)
        done = torch.equal(new, keep)
        keep = new
        if done:
            break
    return keep


_nms_fn = None  # the C entry, resolved once per process


def _nms_kernel():
    global _nms_fn
    if _nms_fn is None:
        from . import _build

        fn = _build.load("nms_fixed").twd_nms_fixed
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _nms_fn = fn
    return _nms_fn


def nms_fixed(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
              score_threshold: float) -> torch.Tensor:
    """Greedy NMS per row over candidates already in priority order (the
    selection's order: scores non-increasing, ties by position): boxes
    float32 [N, K, 4], scores float32 [N, K] → keep mask bool [N, K].

    On CUDA tensors, one launch of the hand-written kernel in
    ``csrc/nms_fixed.cu`` (one block per row, K ≤ ``MAX_CANDIDATES``); it
    reads nothing on the host, so a CUDA graph captures it. On CPU tensors,
    :func:`nms_fixed_plain`, which gives the same mask for rows in priority
    order. ``nms_fixed.launches`` counts kernel launches."""
    if boxes.device.type == "cpu":
        return nms_fixed_plain(boxes, scores, iou_threshold, score_threshold)
    if boxes.device.type != "cuda":
        raise ValueError(f"nms_fixed runs on CUDA or CPU tensors, not {boxes.device}")
    if (boxes.dtype != torch.float32 or boxes.dim() != 3 or boxes.shape[2] != 4
            or not boxes.is_contiguous() or boxes.data_ptr() % 16):
        raise TypeError("boxes must be a contiguous, 16-byte aligned float32 [N, K, 4] tensor")
    n, k = boxes.shape[:2]
    if (scores.dtype != torch.float32 or tuple(scores.shape) != (n, k)
            or not scores.is_contiguous() or scores.device != boxes.device):
        raise TypeError("scores must be a contiguous float32 [N, K] tensor on the boxes' device")
    if k > MAX_CANDIDATES or n > 2**31 - 1:
        raise ValueError(f"the kernel takes at most {MAX_CANDIDATES} candidates a row, got {k}")
    keep = torch.empty((n, k), dtype=torch.uint8, device=boxes.device)
    if n == 0 or k == 0:
        return keep.view(torch.bool)
    stream = torch._C._cuda_getCurrentRawStream(boxes.device.index)
    err = _nms_kernel()(boxes.data_ptr(), scores.data_ptr(), keep.data_ptr(), n, k,
                        iou_threshold, score_threshold, stream)
    if err != 0:
        raise RuntimeError(f"nms_fixed kernel launch failed: CUDA error {err}")
    launches.count(nms_fixed)
    return keep.view(torch.bool)  # the kernel writes 0 or 1


nms_fixed.launches = 0


def _sorted_top(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last dim: the k largest, descending, the
    lower index first among equal values (a stable sort, then a slice)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def select_candidates(boxes: torch.Tensor, class_scores: torch.Tensor, k: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Each (image, class)'s NMS candidates in priority order: the top
    ``k`` scores (stable, as ``lax.top_k``) and their boxes gathered, boxes
    [B, A, 4] × scores [B, A, C] → (boxes [B, C, k, 4], scores [B, C, k])."""
    b, a, c = class_scores.shape
    s, idx = _sorted_top(class_scores.transpose(1, 2), k)
    cand = torch.gather(boxes[:, None].expand(b, c, a, 4), 2, idx[..., None].expand(b, c, k, 4))
    return cand, s


def multiclass_nms(boxes: torch.Tensor, class_scores: torch.Tensor, max_detections: int = 100,
                   pre_nms_topk: int = 100, iou_threshold: float = 0.6,
                   score_threshold: float = 1e-8, nms=None):
    """Batched multi-class NMS with static shapes.

    Args:
        boxes: float32 [B, A, 4] decoded boxes (shared across classes).
        class_scores: float32 [B, A, C] per-class scores (background
            excluded by the caller).
        nms: the per-(image, class) NMS, :func:`nms_fixed` unless given
            (``nms_fixed_plain`` runs the fixpoint on any device).
    Returns:
        (boxes [B, D, 4], scores [B, D], classes [B, D] int32, num [B]
        int32), zero-padded past ``num`` detections; D is
        ``max_detections`` clamped as the reference clamps it.
    """
    nms = nms_fixed if nms is None else nms
    b, _, c = class_scores.shape
    # the reference's clamps: tiny variants have fewer anchors than the defaults
    k = min(pre_nms_topk, boxes.shape[1])
    d = min(max_detections, c * k)
    cand, s = select_candidates(boxes, class_scores, k)
    keep = nms(cand.reshape(b * c, k, 4).contiguous(), s.reshape(b * c, k).contiguous(),
               iou_threshold, score_threshold).view(b, c, k)
    flat_boxes = cand.reshape(b, c * k, 4)
    flat_scores = torch.where(keep, s, torch.zeros_like(s)).reshape(b, c * k)
    top_scores, top_idx = _sorted_top(flat_scores, d)
    valid = top_scores > score_threshold
    out_boxes = torch.gather(flat_boxes, 1, top_idx[..., None].expand(b, d, 4))
    return (
        torch.where(valid[..., None], out_boxes, torch.zeros_like(out_boxes)),
        torch.where(valid, top_scores, torch.zeros_like(top_scores)),
        torch.where(valid, top_idx // k, torch.zeros_like(top_idx)).to(torch.int32),
        valid.sum(dim=1, dtype=torch.int32),
    )
