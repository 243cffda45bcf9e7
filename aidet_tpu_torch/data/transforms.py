"""Host augmentations of the train pipeline.

Port of `aidet_tpu/data/transforms.py::random_rotate90` (:141), the one
transform of that module that `TrainPipeline` reaches (its
``rotate90_ratio``).  The reference's `PhotoMetricDistortion`,
`Expand`, `MinIoURandomCrop`, `seg_rescale` and `corrupt` are not
ported yet (ROADMAP queue 1 item 11).
"""

from __future__ import annotations

import numpy as np


def random_rotate90(img, pointobbs=None, boxes=None, k=None, rng=None):
    """Rotate by a multiple of 90° (RandomRotate, transforms.py:1113):
    image + polygons + re-axis-aligned boxes."""
    rng = rng or np.random
    if k is None:
        k = rng.randint(4)
    if k == 0:
        return img, pointobbs, boxes, 0
    h, w = img.shape[:2]
    out = np.ascontiguousarray(np.rot90(img, k))

    def rot_pts(x, y):
        if k == 1:    # 90° ccw (np.rot90 convention)
            return y, w - 1 - x
        if k == 2:
            return w - 1 - x, h - 1 - y
        return h - 1 - y, x  # k == 3

    new_p = None
    if pointobbs is not None and len(pointobbs):
        xs = pointobbs[:, 0::2]
        ys = pointobbs[:, 1::2]
        nx, ny = rot_pts(xs, ys)
        new_p = np.empty_like(pointobbs)
        new_p[:, 0::2] = nx
        new_p[:, 1::2] = ny
    new_b = None
    if boxes is not None and len(boxes):
        x1, y1 = boxes[:, 0], boxes[:, 1]
        x2, y2 = boxes[:, 2], boxes[:, 3]
        ax, ay = rot_pts(x1, y1)
        bx, by = rot_pts(x2, y2)
        new_b = np.stack([np.minimum(ax, bx), np.minimum(ay, by),
                          np.maximum(ax, bx), np.maximum(ay, by)], -1)
    return out, new_p, new_b, k
