"""Glue between pipeline-DAG stages on the device: boxes → crop batch
(counterpart of the JAX package's ``ops/dag_glue.py``).

A detect → classify pipeline (``serving/dag.py``) never brings the
detector's boxes to the host before stage 2 runs: the boxes stay on the
device, select regions of the canvas the detector was given, and
:func:`crop_resize` builds the classifier's ``[n_crops, out_s, out_s, 3]``
uint8 batch there, which the classifier's engine dispatches as it is
(``InferenceEngine.dispatch_device``).

Geometry, the reference's: boxes are ``(ymin, xmin, ymax, xmax)``
normalized to the image's valid region ``hw``, clipped to [0, 1]. Output
pixel ``o`` samples input coordinate ``(o + 0.5 - t) / s - 0.5``
(half-pixel centres) with ``s = out_s / extent`` and ``t = -origin · s``,
so the box's top-left maps to output 0 and its bottom-right to ``out_s``.
A hole row (index ≥ ``num``) or a box less than ``_MIN_EXTENT_PX`` on a
side falls back to the full valid region: the classifier reads
well-formed pixels and the host drops those rows.

The sampling is the reference host mirror's (:func:`crop_resize_host`),
operation for operation in float32: ``floor`` of the sample coordinate,
two taps clamped to the canvas edge, two lerps, ``round`` (half to even),
then the clip to [0, 255]; the device version equals the mirror bit for
bit. One repair: each tap is clamped on its own, as the reference's jitted
``jax.image.scale_and_translate`` reads the edge. The reference's mirror
clamps the first tap and then adds 1, so a sample coordinate in [-0.5, 0)
(the first row or column of an upscaled crop whose box starts at the
edge, every full-region fallback among them) blends in pixel 1: up to 239
LSB off its own jitted glue. Here both versions lie within 1 LSB of the
jitted glue (it renormalizes its weights, an ulp that can flip a round at
.5), and equal the reference's mirror wherever its sample coordinates are
not negative. The reference's glue is XLA work, not a Pallas kernel; here
it is a few eager tensor operations on the caller's stream, and takes
``hw`` and ``num`` as tensors, so nothing in it reads the device from the
host.
"""

from __future__ import annotations

import numpy as np
import torch

# bumped on any change to the sampling geometry or dtypes (the reference's
# stamp for persisted glue and the parity tests' identity)
DAG_GLUE_VERSION = 1

# a box smaller than this many pixels on a side has nothing to classify and
# would make the resize scale explode: it takes the full-region fallback
_MIN_EXTENT_PX = 1.0


def _box_geometry(boxes, hw, num, n_crops: int, xp=torch):
    """``(y0, x0, y1, x1)`` in pixels, one per crop, with the hole and
    degenerate rows remapped to the full valid region. ``xp`` is ``torch``
    (tensors, on their device) or ``np`` (the host mirror): the same
    float32 operations either way."""
    if xp is torch:
        h = hw[0].to(torch.float32)
        w = hw[1].to(torch.float32)
        b = boxes.to(torch.float32).clamp(0.0, 1.0)
        index = torch.arange(n_crops, device=boxes.device)
    else:
        h = np.float32(hw[0])
        w = np.float32(hw[1])
        b = np.clip(np.asarray(boxes, np.float32), np.float32(0.0), np.float32(1.0))
        index = np.arange(n_crops)
    y0, x0 = b[:, 0] * h, b[:, 1] * w
    y1, x1 = b[:, 2] * h, b[:, 3] * w
    hole = (index >= num) | (y1 - y0 < _MIN_EXTENT_PX) | (x1 - x0 < _MIN_EXTENT_PX)
    zero = xp.zeros_like(y0)
    return (xp.where(hole, zero, y0), xp.where(hole, zero, x0),
            xp.where(hole, h + zero, y1), xp.where(hole, w + zero, x1))


def crop_resize(canvas: torch.Tensor, hw: torch.Tensor, boxes: torch.Tensor, num,
                *, out_s: int, n_crops: int) -> torch.Tensor:
    """The next stage's crop batch, on the tensors' device.

    ``canvas``: uint8 ``[S, S, 3]`` rgb, the detector's canvas. ``hw``:
    integer ``[2]``, its valid (h, w). ``boxes``: ``[≥ n_crops, 4]``
    normalized boxes in score order (NMS's output). ``num``: the detection
    count, a 0-d tensor (integer or float) or a number. Returns uint8
    ``[n_crops, out_s, out_s, 3]``, each row a full canvas for the next
    engine."""
    y0, x0, y1, x1 = _box_geometry(boxes[:n_crops], hw, num, n_crops)
    # a tensor numerator: torch computes ``number / tensor`` as a reciprocal
    # and a product, an ulp off the mirror's division
    side = torch.full_like(y0, out_s)
    sy = side / (y1 - y0)
    sx = side / (x1 - x0)
    ty, tx = -y0 * sy, -x0 * sx
    o = torch.arange(out_s, dtype=torch.float32, device=canvas.device)
    # half-pixel centres: output o samples input (o + .5 - t) / s - .5
    yy = (o[None, :] + 0.5 - ty[:, None]) / sy[:, None] - 0.5  # [n, out_s]
    xx = (o[None, :] + 0.5 - tx[:, None]) / sx[:, None] - 0.5
    yf, xf = torch.floor(yy), torch.floor(xx)
    wy = (yy - yf)[:, :, None, None]
    wx = (xx - xf)[:, None, :, None]
    last = canvas.shape[0] - 1
    # each tap clamped to the canvas edge on its own, as jax.image clamps
    yi0, xi0 = yf.to(torch.int64), xf.to(torch.int64)
    yi1, xi1 = (yi0 + 1).clamp(0, last), (xi0 + 1).clamp(0, last)
    yi0, xi0 = yi0.clamp(0, last), xi0.clamp(0, last)

    def taps(yi, xi):
        return canvas[yi[:, :, None], xi[:, None, :]].to(torch.float32)

    top = taps(yi0, xi0) * (1 - wx) + taps(yi0, xi1) * wx
    bot = taps(yi1, xi0) * (1 - wx) + taps(yi1, xi1) * wx
    crop = top * (1 - wy) + bot * wy
    return torch.round(crop).clamp(0.0, 255.0).to(torch.uint8)


def crop_resize_host(canvas, hw, boxes, num, *, out_s: int, n_crops: int) -> np.ndarray:
    """The numpy mirror of :func:`crop_resize`, the reference's host
    reference step for step (taps clamped one by one, see the module's
    docstring): the stage-by-stage check a pipeline's answer is held to.
    Same geometry, same half-pixel bilinear sampling, same round and clip,
    in numpy only."""
    y0, x0, y1, x1 = _box_geometry(np.asarray(boxes, np.float32)[:n_crops], np.asarray(hw),
                                   num, n_crops, xp=np)
    img = np.asarray(canvas, np.float32)
    s = img.shape[0]
    out = np.empty((n_crops, out_s, out_s, 3), np.uint8)
    o = np.arange(out_s, dtype=np.float32)
    for i in range(n_crops):
        sy = out_s / (y1[i] - y0[i])
        sx = out_s / (x1[i] - x0[i])
        ty, tx = -y0[i] * sy, -x0[i] * sx
        yy = (o + 0.5 - ty) / sy - 0.5
        xx = (o + 0.5 - tx) / sx - 0.5
        yf = np.floor(yy)
        xf = np.floor(xx)
        wy = (yy - yf)[:, None, None]
        wx = (xx - xf)[None, :, None]
        yi1 = np.clip(yf.astype(np.int64) + 1, 0, s - 1)
        xi1 = np.clip(xf.astype(np.int64) + 1, 0, s - 1)
        yi0 = np.clip(yf.astype(np.int64), 0, s - 1)
        xi0 = np.clip(xf.astype(np.int64), 0, s - 1)
        top = img[yi0][:, xi0] * (1 - wx) + img[yi0][:, xi1] * wx
        bot = img[yi1][:, xi0] * (1 - wx) + img[yi1][:, xi1] * wx
        crop = top * (1 - wy) + bot * wy
        out[i] = np.clip(np.round(crop), 0.0, 255.0).astype(np.uint8)
    return out
