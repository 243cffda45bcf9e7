"""The InstaBoost train stage (Fang et al., "InstaBoost: Boosting Instance
Segmentation via Probability Map Guided Copy-Pasting").

Port of `aidet_tpu/data/instaboost.py::InstaBoost` (:30-158): for an
augmented sample each instance with a polygon segmentation is lifted
off the canvas by its mask, the hole is inpainted, and the instance is
pasted back under a small random affine (translate within dx / dy
pixels, scale in ``scale``, rotate within ``theta`` degrees about its
centre; "horizontal" also mirrors it).  Boxes, polygons and pointobbs
go through the same affine.  The draws come from the stage's own
`RandomState` in the reference's order, so one seed gives the
reference's affines.

Without OpenCV: the mask is `raster.fill_poly`, the affine
`raster.rotation_matrix_2d`, the warps `raster.warp_affine` (nearest
for the mask, linear with a zero border for the instance, computed only
in the box the warped mask can reach), and the hole's fill Telea's
inpaint of radius 3 (`hostlib.inpaint_telea`, the host library's C++).
"""

from __future__ import annotations

import math

import numpy as np

from .hostlib import inpaint_telea
from .raster import fill_poly, rotation_matrix_2d, warp_affine


def _poly_mask(segs, h, w):
    m = np.zeros((h, w), np.uint8)
    for poly in segs:
        pts = np.asarray(poly, np.float64).reshape(-1, 2)
        fill_poly(m, np.round(pts).astype(np.int32), 1)
    return m


def _polys_box(segs, h, w):
    """(row slice, column slice) holding every pixel `_poly_mask` can
    set: the rounded points' box, grown by 1 and clipped."""
    pts = np.round(np.concatenate([np.asarray(p, np.float64).reshape(-1, 2)
                                   for p in segs]))
    lo, hi = pts.min(0).astype(int) - 1, pts.max(0).astype(int) + 2
    return (slice(max(lo[1], 0), max(min(hi[1], h), 0)),
            slice(max(lo[0], 0), max(min(hi[0], w), 0)))


def _reach(xs, ys, m, h, w):
    """(x0, y0, x1, y1): the pixels of an h x w output that a nearest
    warp by ``m`` of a mask set at (xs, ys) can set, grown by 2."""
    corners = np.array([[xs.min() - 1, ys.min() - 1], [xs.max() + 1,
                        ys.min() - 1], [xs.max() + 1, ys.max() + 1],
                        [xs.min() - 1, ys.max() + 1]], np.float64)
    out = corners @ m[:, :2].T + m[:, 2]
    lo, hi = out.min(0), out.max(0)
    return (max(math.floor(lo[0]) - 2, 0), max(math.floor(lo[1]) - 2, 0),
            min(math.ceil(hi[0]) + 2, w - 1), min(math.ceil(hi[1]) + 2, h - 1))


class InstaBoost:
    def __init__(self, action_candidate=("normal", "horizontal", "skip"),
                 action_prob=(1, 0, 0), scale=(0.8, 1.2), dx=15, dy=15,
                 theta=(-1, 1), color_prob=0.5, hflag=False,
                 aug_ratio=0.5, seed=0):
        self.actions = tuple(action_candidate)
        p = np.asarray(action_prob, np.float64)
        self.action_p = p / p.sum()
        self.scale = scale
        self.dx = dx
        self.dy = dy
        self.theta = theta
        self.color_prob = color_prob
        self.aug_ratio = aug_ratio
        self.rng = np.random.RandomState(seed)

    def _sample_affine(self, cx, cy, flip):
        """2x3 affine about the instance centre (cx, cy)."""
        ang = self.rng.uniform(*self.theta)
        s = self.rng.uniform(*self.scale)
        m = rotation_matrix_2d((float(cx), float(cy)), ang, s)
        m[0, 2] += self.rng.uniform(-self.dx, self.dx)
        m[1, 2] += self.rng.uniform(-self.dy, self.dy)
        if flip:  # mirror about the instance's vertical centre line
            f = np.array([[-1.0, 0.0, 2.0 * cx],
                          [0.0, 1.0, 0.0]])
            m = np.vstack([m, [0, 0, 1]]) @ np.vstack([f, [0, 0, 1]])
            m = m[:2]
        return m

    def _augment_one(self, img, segs, rng):
        """Lift one instance, inpaint its hole, paste it back jittered.

        Returns (img, m), m the 2x3 affine applied, or None when the
        instance has no usable mask."""
        h, w = img.shape[:2]
        mask = _poly_mask(segs, h, w)
        rows, cols = _polys_box(segs, h, w)
        ys, xs = np.nonzero(mask[rows, cols])
        if len(ys) < 4:
            return img, None
        ys, xs = ys + rows.start, xs + cols.start
        cx, cy = xs.mean(), ys.mean()
        act = self.actions[rng.choice(len(self.actions), p=self.action_p)]
        if act == "skip":
            return img, None
        m = self._sample_affine(cx, cy, flip=(act == "horizontal"))

        # the instance, the warps and the paste only where they can be
        # non-zero: the same pixels as over the whole image
        inst = np.zeros_like(img)
        inst[rows, cols] = img[rows, cols] * mask[rows, cols, None]
        out = inpaint_telea(img, mask, 3)
        x0, y0, x1, y1 = window = _reach(xs, ys, m, h, w)
        wm = warp_affine(mask, m, (h, w), nearest=True, window=window)
        wi = warp_affine(inst, m, (h, w), window=window)
        if rng.rand() < self.color_prob:
            gain = rng.uniform(0.8, 1.2, size=(1, 1, 3))
            wi = np.clip(wi[y0:y1 + 1, x0:x1 + 1].astype(np.float32) * gain,
                         0, 255).astype(img.dtype)
        else:
            wi = wi[y0:y1 + 1, x0:x1 + 1]
        win = out[y0:y1 + 1, x0:x1 + 1]
        win[...] = np.where(wm[y0:y1 + 1, x0:x1 + 1, None].astype(bool), wi,
                            win)
        return out, m

    @staticmethod
    def _map_pts(pts, m):
        return pts @ m[:, :2].T + m[:, 2]

    def __call__(self, img, anns):
        """img: HWC uint8; anns: a dataset's `parse_anns` dict.  Instances
        without a polygon segmentation ride through unchanged."""
        if self.rng.rand() >= self.aug_ratio:
            return img, anns
        segs_all = anns.get("segmentations")
        if not segs_all or all(not s for s in segs_all):
            return img, anns

        boxes = np.array(anns["bboxes"], np.float32, copy=True)
        pobbs = anns.get("pointobbs")
        pobbs = (np.array(pobbs, np.float32, copy=True)
                 if pobbs is not None and len(pobbs) else None)
        segs_out = [list(s) if s else s for s in segs_all]
        h, w = img.shape[:2]
        for i, segs in enumerate(segs_all):
            if not segs:
                continue
            img, m = self._augment_one(img, segs, self.rng)
            if m is None:
                continue
            new_polys = []
            for poly in segs:
                pts = np.asarray(poly, np.float32).reshape(-1, 2)
                pts = self._map_pts(pts, m)
                pts[:, 0] = np.clip(pts[:, 0], 0, w - 1)
                pts[:, 1] = np.clip(pts[:, 1], 0, h - 1)
                new_polys.append(pts.reshape(-1).tolist())
            segs_out[i] = new_polys
            b = boxes[i]
            corners = np.asarray([[b[0], b[1]], [b[2], b[1]],
                                  [b[2], b[3]], [b[0], b[3]]], np.float32)
            wc = self._map_pts(corners, m)
            boxes[i] = [max(wc[:, 0].min(), 0), max(wc[:, 1].min(), 0),
                        min(wc[:, 0].max(), w - 1),
                        min(wc[:, 1].max(), h - 1)]
            if pobbs is not None:
                pobbs[i] = self._map_pts(
                    pobbs[i].reshape(4, 2), m).reshape(8)

        anns = dict(anns, bboxes=boxes, segmentations=segs_out)
        if pobbs is not None:
            anns["pointobbs"] = pobbs
        return img, anns
