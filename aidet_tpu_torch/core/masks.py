"""Mask post-processing on the host: paste a roi's mask into the image
and fit oriented boxes to predicted masks (MaskOBB's and CenterMap's
OBBs).

Port of `aidet_tpu/core/masks.py` (`paste_mask` :21,
`mask_crop_to_thetaobb` :41, `masks_to_thetaobbs` :75) without OpenCV:

- `cv2.resize` (INTER_LINEAR) of the float crop is `resize_linear`,
  OpenCV's float path: half-pixel centres, source positions and
  weights rounded to float32, clamped at the borders, a horizontal then
  a vertical pass in float32;
- `cv2.connectedComponentsWithStats(connectivity=4)` is
  `scipy.ndimage.label` with its default cross structure (4-connected).
  Both number the components in raster order of their first pixel, so
  the largest component, the first of the largest on a tie, is the
  same blob (tests/test_torch_port_mask_targets.py holds both to
  OpenCV);
- the min-area rectangle is `data.np_rboxes.min_area_rect_np`.

`masks_to_thetaobbs` is a Python loop over the detections: one label
and one hull per mask, on the host.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage

from ..data.np_rboxes import min_area_rect_np, thetaobb2pointobb


def _linear_taps(src_size: int, dst_size: int):
    """OpenCV's INTER_LINEAR taps along one axis: (first source index,
    its weight, the second's weight) per output pixel, float32."""
    scale = 1.0 / (dst_size / src_size)
    f = ((np.arange(dst_size) + 0.5) * scale - 0.5).astype(np.float32)
    i = np.floor(f).astype(np.int64)
    f = f - i.astype(np.float32)
    low = i < 0
    f[low], i[low] = 0.0, 0
    high = i >= src_size - 1
    f[high], i[high] = 0.0, src_size - 1
    return i, (1.0 - f).astype(np.float32), f


def resize_linear(src: np.ndarray, dsize) -> np.ndarray:
    """`cv2.resize(src, dsize)` (INTER_LINEAR) of a float32 [H, W] map,
    ``dsize`` = (width, height)."""
    src = np.asarray(src, np.float32)
    w, h = dsize
    if (h, w) == src.shape:
        return src.copy()
    xi, xa, xb = _linear_taps(src.shape[1], w)
    yi, ya, yb = _linear_taps(src.shape[0], h)
    x1 = np.minimum(xi + 1, src.shape[1] - 1)
    y1 = np.minimum(yi + 1, src.shape[0] - 1)
    rows = src[:, xi] * xa + src[:, x1] * xb
    return (rows[yi] * ya[:, None] + rows[y1] * yb[:, None]).astype(
        np.float32)


def paste_mask(mask_crop: np.ndarray, box, img_hw, thr: float = 0.5):
    """Resize an SxS mask crop into ``box`` on an (H, W) uint8 canvas,
    thresholded at ``thr``; a box wholly outside the canvas pastes
    nothing."""
    h, w = img_hw
    x1, y1, x2, y2 = [int(round(float(v))) for v in box[:4]]
    canvas = np.zeros((h, w), np.uint8)
    if x2 < 0 or y2 < 0 or x1 > w - 1 or y1 > h - 1:
        return canvas
    x1, y1 = max(x1, 0), max(y1, 0)
    x2, y2 = min(x2, w - 1), min(y2, h - 1)
    bw, bh = max(x2 - x1 + 1, 1), max(y2 - y1 + 1, 1)
    resized = resize_linear(mask_crop, (bw, bh))
    canvas[y1:y1 + bh, x1:x1 + bw] = (resized > thr).astype(np.uint8)
    return canvas


def largest_component(binary: np.ndarray) -> np.ndarray:
    """The largest 4-connected component of a boolean map (the first in
    raster order of the largest on a tie); the map itself when it has
    one component."""
    lbl, n = ndimage.label(binary)
    if n < 2:
        return binary
    area = np.bincount(lbl.ravel(), minlength=n + 1)[1:]
    return lbl == 1 + int(np.argmax(area))


def mask_crop_to_thetaobb(mask_crop: np.ndarray, box, thr: float = 0.5):
    """OBB (cx, cy, w, h, theta) in image pixels of a predicted roi mask
    [S, S] over ``box``: the largest 4-connected blob above ``thr``,
    each of its pixel centres mapped into the box frame, then their
    min-area rectangle.  None if no pixel passes ``thr``."""
    s_h, s_w = mask_crop.shape
    binary = mask_crop > thr
    if not binary.any():
        return None
    ys, xs = np.nonzero(largest_component(binary))
    x1, y1, x2, y2 = [float(v) for v in box[:4]]
    sx = max(x2 - x1 + 1, 1.0) / s_w
    sy = max(y2 - y1 + 1, 1.0) / s_h
    # into image pixels first (an anisotropic box scale would bend a
    # rectangle fitted in crop pixels), then the fit
    pts = np.stack([x1 + (xs + 0.5) * sx,
                    y1 + (ys + 0.5) * sy], -1).astype(np.float64)
    cx, cy, w, h, theta = min_area_rect_np(pts)
    return float(cx), float(cy), float(w), float(h), float(theta)


def masks_to_thetaobbs(mask_crops, boxes, valid=None, thr: float = 0.5):
    """[K, 5] thetaobbs (float32) of [K, S, S] masks over [K, 4+] boxes;
    zero rows where the mask is empty or the slot invalid."""
    k = len(mask_crops)
    out = np.zeros((k, 5), np.float32)
    for i in range(k):
        if valid is not None and not valid[i]:
            continue
        r = mask_crop_to_thetaobb(np.asarray(mask_crops[i]),
                                  np.asarray(boxes[i]), thr)
        if r is not None:
            out[i] = r
    return out


def mask_quads(mask_crops, boxes, valid=None, thr: float = 0.5):
    """The corners [K, 8] of `masks_to_thetaobbs`' rectangles: the OBB
    results of the mask family (the reference's tools/test.py:150-161
    and tools/dota_eval.py:46-54), zero where the mask is empty."""
    return thetaobb2pointobb(masks_to_thetaobbs(mask_crops, boxes, valid,
                                                thr))
