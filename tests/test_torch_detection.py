"""The port's detection postprocess (``ops/detection.py``) against the JAX
package's, on the CPU: box decode and IoU within float32 rounding (atol
1e-6), the plain NMS fixpoint's keep mask equal to the reference's
``nms_fixed`` and to a sequential greedy walk on the reference test's
adversarial generator (clustered boxes, quantized scores, degenerate
boxes), and ``multiclass_nms`` equal to the reference's, output for
output, on inputs full of exact ties across anchors and across classes,
where only a selection that orders ties by index as ``lax.top_k`` does
agrees. The kernel (``csrc/nms_fixed.cu``) runs on the card only: its test
is marked ``cuda`` and ``chip_smoke.py`` holds it against the plain
version at the served shapes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_web_deploy_tpu.ops import detection as jdet
from tensorflow_web_deploy_tpu_torch.ops import detection as tdet
from tensorflow_web_deploy_tpu_torch.ops.detection import (
    decode_boxes,
    iou_matrix,
    multiclass_nms,
    nms_fixed,
    nms_fixed_plain,
)

torch.set_num_threads(2)

KMAX = 48  # the reference test's padded candidate count


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _boxes(rs, shape):
    """Valid (ymin, xmin, ymax, xmax) boxes in [0, 1.2]."""
    b = rs.rand(*shape, 4).astype(np.float32)
    return np.concatenate([np.minimum(b[..., :2], b[..., 2:]),
                           np.maximum(b[..., :2], b[..., 2:]) + 0.05], -1).astype(np.float32)


def test_iou_matrix_basics():
    a = torch.tensor([[0, 0, 1, 1], [0, 0, 0.5, 0.5]], dtype=torch.float32)
    m = iou_matrix(a, a).numpy()
    np.testing.assert_allclose(np.diag(m), [1.0, 1.0], atol=1e-6)
    np.testing.assert_allclose(m[0, 1], 0.25, atol=1e-6)


def test_decode_boxes_matches_manual():
    anchors = torch.tensor([[0.5, 0.5, 0.2, 0.4]])
    codes = torch.tensor([[1.0, -2.0, 0.5, 0.25]])
    out = decode_boxes(codes, anchors).numpy()
    cy = 1.0 / 10 * 0.2 + 0.5
    cx = -2.0 / 10 * 0.4 + 0.5
    h = np.exp(0.5 / 5) * 0.2
    w = np.exp(0.25 / 5) * 0.4
    np.testing.assert_allclose(out[0], [cy - h / 2, cx - w / 2, cy + h / 2, cx + w / 2],
                               rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_decode_boxes_equals_jax(seed):
    """Batched codes against one anchor table, as the engine decodes them."""
    rs = np.random.RandomState(seed)
    codes = (rs.randn(3, 57, 4) * 2).astype(np.float32)
    anchors = np.concatenate([rs.rand(57, 2), 0.05 + rs.rand(57, 2)], 1).astype(np.float32)
    want = np.stack([np.asarray(jdet.decode_boxes(c, anchors)) for c in codes])
    got = decode_boxes(_t(codes), _t(anchors)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("seed", [0, 1])
def test_iou_matrix_equals_jax(seed):
    rs = np.random.RandomState(seed)
    a, b = _boxes(rs, (23,)), _boxes(rs, (31,))
    a[0, 2] = a[0, 0]  # a degenerate box: union 0 with itself
    got = iou_matrix(_t(a), _t(b)).numpy()
    np.testing.assert_allclose(got, np.asarray(jdet.iou_matrix(a, b)), atol=1e-6, rtol=0)
    inter, union = tdet._inter_union(_t(a), _t(b))
    jinter, junion = jdet._inter_union(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(inter.numpy(), np.asarray(jinter), atol=1e-6, rtol=0)
    np.testing.assert_allclose(union.numpy(), np.asarray(junion), atol=1e-6, rtol=0)


def _greedy_ref(boxes, scores, iou_thr, score_thr):
    """The reference test's sequential greedy walk (stable best-first)."""
    order = np.argsort(-scores, kind="stable")
    kept: list[int] = []
    keep = np.zeros(len(scores), bool)
    for i in order:
        if scores[i] <= score_thr:
            continue
        ok = True
        for j in kept:
            a = boxes[i], boxes[j]
            area = [max(b[2] - b[0], 0) * max(b[3] - b[1], 0) for b in a]
            lt = np.maximum(a[0][:2], a[1][:2])
            rb = np.minimum(a[0][2:], a[1][2:])
            wh = np.maximum(rb - lt, 0.0)
            inter = wh[0] * wh[1]
            if inter > iou_thr * (area[0] + area[1] - inter):
                ok = False
                break
        if ok:
            kept.append(i)
            keep[i] = True
    return keep


def adversarial(rs, trial: int, kmax: int = KMAX):
    """The reference test's generator: clustered centers (deep suppression
    chains), quantized scores (ties), a degenerate box every fifth trial,
    padded to ``kmax`` with score-0 entries (never candidates)."""
    k = int(rs.randint(4, kmax))
    centers = rs.rand(max(1, k // 6), 2)
    pick = centers[rs.randint(0, len(centers), k)]
    jitter = rs.randn(k, 2) * 0.03
    size = 0.05 + rs.rand(k, 2) * 0.15
    ymin = pick[:, 0] + jitter[:, 0]
    xmin = pick[:, 1] + jitter[:, 1]
    boxes = np.stack([ymin, xmin, ymin + size[:, 0], xmin + size[:, 1]], 1).astype(np.float32)
    if trial % 5 == 0:
        boxes[0, 2] = boxes[0, 0]
    scores = (rs.randint(0, 8, k) / 8.0 + rs.rand(k) * (trial % 2)).astype(np.float32)
    boxes = np.concatenate([boxes, np.zeros((kmax - k, 4), np.float32)])
    scores = np.concatenate([scores, np.zeros(kmax - k, np.float32)])
    return boxes, scores


@pytest.mark.parametrize("block", range(5))
def test_nms_fixed_plain_equals_jax_and_greedy(block):
    """25 adversarial trials in 5 cases: the keep mask equals the
    reference's fixpoint and the greedy walk, unsorted (the fixpoint's own
    priority) and sorted as the kernel takes its rows."""
    rs = np.random.RandomState(100 + block)
    for trial in range(5 * block, 5 * block + 5):
        boxes, scores = adversarial(rs, trial)
        want = np.asarray(jdet.nms_fixed(boxes, scores, iou_threshold=0.5, score_threshold=0.05))
        np.testing.assert_array_equal(want, _greedy_ref(boxes, scores, 0.5, 0.05))
        got = nms_fixed_plain(_t(boxes), _t(scores), 0.5, 0.05).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"trial {trial}")
        order = np.argsort(-scores, kind="stable")
        sorted_keep = nms_fixed(_t(boxes[order]), _t(scores[order]), 0.5, 0.05).numpy()
        np.testing.assert_array_equal(sorted_keep, want[order], err_msg=f"trial {trial}")


def test_nms_fixed_plain_is_batched_per_row():
    """Rows of a batch are independent: the batched mask is each row's."""
    rs = np.random.RandomState(7)
    rows = [adversarial(rs, t) for t in range(6)]
    boxes = np.stack([b for b, _ in rows])
    scores = np.stack([s for _, s in rows])
    got = nms_fixed_plain(_t(boxes), _t(scores), 0.6, 1e-8).numpy()
    for i, (b, s) in enumerate(rows):
        np.testing.assert_array_equal(got[i], np.asarray(jdet.nms_fixed(b, s, 0.6, 1e-8)))


def test_nms_fixed_on_cpu_runs_the_plain_version_and_checks_devices():
    rs = np.random.RandomState(3)
    boxes, scores = adversarial(rs, 1)
    before = nms_fixed.launches
    keep = nms_fixed(_t(boxes)[None], _t(scores)[None], 0.5, 0.05)
    assert keep.dtype == torch.bool and keep.shape == (1, KMAX)
    assert nms_fixed.launches == before  # no kernel on the CPU
    with pytest.raises(ValueError, match="CUDA or CPU"):
        nms_fixed(_t(boxes)[None].to("meta"), _t(scores)[None].to("meta"), 0.5, 0.05)


@pytest.mark.parametrize("k", [33, 65, 99, 100, 256])
def test_nms_fixed_equals_jax_either_side_of_a_candidate_word(k):
    """At candidate counts either side of a 32-candidate word (the kernel
    has one instance per word count) and at its largest, ``nms_fixed`` on
    sorted rows equals the reference's fixpoint row by row."""
    rs = np.random.RandomState(200 + k)
    rows = [adversarial(rs, trial, kmax=k) for trial in range(4)]
    boxes = np.stack([b for b, _ in rows])
    scores = np.stack([s for _, s in rows])
    order = np.argsort(-scores, axis=1, kind="stable")
    boxes = np.take_along_axis(boxes, order[..., None], 1)
    scores = np.take_along_axis(scores, order, 1)
    got = nms_fixed(_t(boxes), _t(scores), 0.5, 0.05).numpy()
    for i, (b, s) in enumerate(zip(boxes, scores)):
        np.testing.assert_array_equal(got[i], np.asarray(jdet.nms_fixed(b, s, 0.5, 0.05)))


def _tied_inputs(rs, b: int, a: int, c: int):
    """Boxes, and scores quantized to eighths (with some exact zeros):
    equal scores across anchors of one class and across classes."""
    boxes = _boxes(rs, (b, a))
    scores = (rs.randint(0, 9, (b, a, c)) / 8.0).astype(np.float32)
    scores[:, ::7, :] = scores[:, :1, :]  # whole anchor rows repeated
    scores[..., 1] = scores[..., 0]  # two classes tie everywhere
    return boxes, scores


@pytest.mark.parametrize("b,a,c,d,k,thr", [
    (2, 40, 3, 10, 16, 0.5),     # the reference test's sizes
    (3, 57, 6, 100, 100, 0.6),   # the serving defaults, clamped (K = A = 57)
    (2, 130, 4, 100, 100, 0.6),  # K < A: the top-100 selection decides
    (1, 15, 10, 100, 100, 0.6),  # the engine's 64 px anchors
])
def test_multiclass_nms_equals_jax_on_ties(b, a, c, d, k, thr):
    """Every output equal to the reference's: scores tie across anchors and
    classes, so the candidates and the final detections differ unless ties
    go to the lower index in both selections."""
    rs = np.random.RandomState(a)
    boxes, scores = _tied_inputs(rs, b, a, c)
    want = [np.asarray(o) for o in jdet.multiclass_nms(
        boxes, scores, max_detections=d, pre_nms_topk=k, iou_threshold=thr)]
    got = [o.numpy() for o in multiclass_nms(_t(boxes), _t(scores), max_detections=d,
                                             pre_nms_topk=k, iou_threshold=thr)]
    assert [g.dtype for g in got] == [np.float32, np.float32, np.int32, np.int32]
    for g, w, name in zip(got, want, ("boxes", "scores", "classes", "num")):
        assert g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert (got[3] > 0).all()


def test_multiclass_nms_shapes_and_padding():
    """The reference's own case: shapes, sorted scores, zero padding."""
    rs = np.random.RandomState(0)
    b, a, c = 2, 40, 3
    boxes = np.sort(rs.rand(b, a, 4).astype(np.float32), axis=-1)
    scores = rs.rand(b, a, c).astype(np.float32) * 0.5
    scores[:, 0, 1] = 0.99
    out_boxes, out_scores, out_classes, num = (
        o.numpy() for o in multiclass_nms(_t(boxes), _t(scores), max_detections=10,
                                          pre_nms_topk=16))
    assert out_boxes.shape == (b, 10, 4) and out_scores.shape == (b, 10)
    assert out_classes.shape == (b, 10) and num.shape == (b,)
    assert (num > 0).all() and (num <= 10).all()
    for i in range(b):
        n = int(num[i])
        assert (np.diff(out_scores[i, :n]) <= 1e-6).all()
        assert out_scores[i, n:].sum() == 0 and out_boxes[i, n:].sum() == 0
        assert np.isclose(out_scores[i, 0], 0.99, atol=1e-3)
        assert out_classes[i, 0] == 1


def test_multiclass_nms_plain_and_wrapper_agree_on_cpu():
    """``nms=nms_fixed_plain`` (what chip_smoke.py holds the kernel's
    multiclass_nms against) gives the same outputs as the default."""
    rs = np.random.RandomState(5)
    boxes, scores = _tied_inputs(rs, 2, 60, 5)
    a = multiclass_nms(_t(boxes), _t(scores))
    b = multiclass_nms(_t(boxes), _t(scores), nms=nms_fixed_plain)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
def test_nms_kernel_matches_plain_on_card():
    """On a machine with a CUDA card and nvcc: the kernel's keep mask equals
    the plain fixpoint's, bit for bit, on sorted adversarial rows and on a
    batch's candidates (chip_smoke.py's ``ssd`` phase holds the served
    shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    rs = np.random.RandomState(0)
    for trial in range(20):
        rows = [adversarial(rs, trial) for _ in range(8)]
        boxes = torch.from_numpy(np.stack([b for b, _ in rows])).cuda()
        scores = torch.from_numpy(np.stack([s for _, s in rows])).cuda()
        scores, order = torch.sort(scores, dim=-1, descending=True, stable=True)
        boxes = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4)).contiguous()
        got = nms_fixed(boxes, scores.contiguous(), 0.5, 0.05)
        torch.cuda.synchronize()
        assert torch.equal(got, nms_fixed_plain(boxes, scores, 0.5, 0.05))
