"""The albumentations subset that the repo's albu config uses, in numpy.

Port of `aidet_tpu/data/_vendor_albu.py` (:26-197): `BboxParams`,
`KeypointParams`, `ShiftScaleRotate`, `RandomBrightnessContrast`,
`ChannelShuffle`, `Blur`, `MedianBlur`, `OneOf` and `Compose` with the
call protocol that `albu.AlbuTransform` drives (pascal_voc boxes with
one label field, clipped to the canvas and dropped under
``min_visibility``; 'xy' keypoints riding along unfiltered).  The card's
machine has neither OpenCV nor `albumentations`, so the port always
takes this subset, and each transform draws from the pipeline's
`RandomState` in the reference's order: one seed gives the reference's
geometry exactly.

Without OpenCV: ShiftScaleRotate's matrix and warp are
`raster.rotation_matrix_2d` and `raster.warp_affine` (reflect-101
border), Blur is OpenCV's normalised box filter (integer window sums
over a reflect-101 border, rounded), MedianBlur the median of each
window over a replicated border.
"""

from __future__ import annotations

import numpy as np

from .raster import reflect101, rotation_matrix_2d, warp_affine


class BboxParams:
    def __init__(self, format="pascal_voc", label_fields=(),
                 min_visibility=0.0, **_):
        assert format == "pascal_voc", format
        self.label_fields = list(label_fields)
        self.min_visibility = float(min_visibility)


class KeypointParams:
    def __init__(self, format="xy", remove_invisible=False, **_):
        assert format == "xy", format
        assert not remove_invisible, (
            "vendored subset supports remove_invisible=False only")


class _Transform:
    """Base: subclasses implement apply(data, rng) in place."""

    def __init__(self, p=0.5):
        self.p = float(p)

    def maybe(self, data, rng):
        if rng.rand() < self.p:
            self.apply(data, rng)


class ShiftScaleRotate(_Transform):
    def __init__(self, shift_limit=0.0625, scale_limit=0.1,
                 rotate_limit=45, interpolation=1, p=0.5, **_):
        super().__init__(p)
        if interpolation not in (0, 1):
            raise ValueError(f"ShiftScaleRotate interpolation "
                             f"{interpolation}: only 0 (nearest) and 1 "
                             f"(linear) are ported")
        self.shift_limit = shift_limit
        self.scale_limit = scale_limit
        self.rotate_limit = rotate_limit
        self.interpolation = interpolation

    def apply(self, data, rng):
        img = data["image"]
        h, w = img.shape[:2]
        dx = rng.uniform(-self.shift_limit, self.shift_limit) * w
        dy = rng.uniform(-self.shift_limit, self.shift_limit) * h
        s = 1.0 + rng.uniform(-self.scale_limit, self.scale_limit)
        ang = rng.uniform(-self.rotate_limit, self.rotate_limit)
        m = rotation_matrix_2d((w / 2, h / 2), ang, s)
        m[:, 2] += (dx, dy)
        data["image"] = warp_affine(img, m, (h, w),
                                    nearest=self.interpolation == 0,
                                    reflect=True)

        def warp_pts(pts):                       # [K, 2]
            return pts @ m[:, :2].T + m[:, 2]

        if len(data["bboxes"]):
            b = data["bboxes"]
            corners = np.stack([b[:, [0, 1]], b[:, [2, 1]],
                                b[:, [2, 3]], b[:, [0, 3]]], 1)
            wc = warp_pts(corners.reshape(-1, 2)).reshape(-1, 4, 2)
            data["bboxes"] = np.concatenate(
                [wc.min(1), wc.max(1)], -1).astype(np.float32)
        if len(data["keypoints"]):
            data["keypoints"] = warp_pts(
                data["keypoints"]).astype(np.float32)


class RandomBrightnessContrast(_Transform):
    def __init__(self, brightness_limit=0.2, contrast_limit=0.2,
                 p=0.5, **_):
        super().__init__(p)
        self.b = (brightness_limit if isinstance(brightness_limit,
                                                 (tuple, list))
                  else (-brightness_limit, brightness_limit))
        self.c = (contrast_limit if isinstance(contrast_limit,
                                               (tuple, list))
                  else (-contrast_limit, contrast_limit))

    def apply(self, data, rng):
        alpha = 1.0 + rng.uniform(*self.c)
        beta = rng.uniform(*self.b) * 255.0
        img = data["image"].astype(np.float32) * alpha + beta
        data["image"] = np.clip(img, 0, 255).astype(np.uint8)


class ChannelShuffle(_Transform):
    def __init__(self, p=0.5, **_):
        super().__init__(p)

    def apply(self, data, rng):
        data["image"] = data["image"][..., rng.permutation(3)]


def box_blur(img: np.ndarray, k: int) -> np.ndarray:
    """`cv2.blur(img, (k, k))` of a uint8 HxWxC image: each k x k
    window's integer sum over a reflect-101 border, divided by k^2 and
    rounded (k odd: no ties)."""
    h, w = img.shape[:2]
    r = k // 2
    rows = reflect101(np.arange(-r, h + r), h)
    cols = reflect101(np.arange(-r, w + r), w)
    p = img[rows][:, cols].astype(np.int64)
    c = np.zeros((h + 2 * r + 1, w + 2 * r + 1) + img.shape[2:], np.int64)
    c[1:, 1:] = p.cumsum(0).cumsum(1)
    s = c[k:k + h, k:k + w] - c[:h, k:k + w] - c[k:k + h, :w] + c[:h, :w]
    return ((2 * s + k * k) // (2 * k * k)).astype(np.uint8)


def median_blur(img: np.ndarray, k: int) -> np.ndarray:
    """`cv2.medianBlur(img, k)` of a uint8 HxWxC image: each k x k
    window's median over a replicated border."""
    r = k // 2
    pad = ((r, r), (r, r)) + ((0, 0),) * (img.ndim - 2)
    p = np.pad(img, pad, mode="edge")
    win = np.lib.stride_tricks.sliding_window_view(p, (k, k), axis=(0, 1))
    win = win.reshape(win.shape[:img.ndim] + (k * k,))
    return np.partition(win, k * k // 2, axis=-1)[..., k * k // 2]


class Blur(_Transform):
    def __init__(self, blur_limit=7, p=0.5, **_):
        super().__init__(p)
        self.blur_limit = int(blur_limit)

    def _ksize(self, rng):
        k = rng.randint(3, max(self.blur_limit, 3) + 1)
        return k if k % 2 else k + 1

    def apply(self, data, rng):
        data["image"] = box_blur(data["image"], self._ksize(rng))


class MedianBlur(Blur):
    def apply(self, data, rng):
        data["image"] = median_blur(data["image"], self._ksize(rng))


class OneOf(_Transform):
    def __init__(self, transforms, p=0.5):
        super().__init__(p)
        self.transforms = list(transforms)
        probs = np.asarray([t.p for t in self.transforms], np.float64)
        self._probs = probs / probs.sum() if probs.sum() else None

    def apply(self, data, rng):
        if self._probs is None:
            return
        t = self.transforms[rng.choice(len(self.transforms),
                                       p=self._probs)]
        t.apply(data, rng)


class Compose:
    def __init__(self, transforms, bbox_params=None,
                 keypoint_params=None, seed=0, **_):
        self.transforms = list(transforms)
        self.bbox_params = bbox_params
        self.keypoint_params = keypoint_params
        self._rng = np.random.RandomState(seed)

    def __call__(self, image=None, bboxes=(), keypoints=(), **fields):
        label_fields = (self.bbox_params.label_fields
                        if self.bbox_params else [])
        data = dict(
            image=image,
            bboxes=np.asarray(bboxes, np.float32).reshape(-1, 4),
            keypoints=np.asarray(keypoints, np.float32).reshape(-1, 2))
        pre_area = np.maximum(
            (data["bboxes"][:, 2] - data["bboxes"][:, 0])
            * (data["bboxes"][:, 3] - data["bboxes"][:, 1]), 1e-6)
        for t in self.transforms:
            t.maybe(data, self._rng)
        # pascal_voc post-processing: clip to the canvas, drop boxes whose
        # visible area fell under min_visibility
        h, w = data["image"].shape[:2]
        b = data["bboxes"]
        keep = np.ones(len(b), bool)
        if len(b):
            clipped = np.stack([np.clip(b[:, 0], 0, w),
                                np.clip(b[:, 1], 0, h),
                                np.clip(b[:, 2], 0, w),
                                np.clip(b[:, 3], 0, h)], -1)
            vis_area = (np.maximum(clipped[:, 2] - clipped[:, 0], 0)
                        * np.maximum(clipped[:, 3] - clipped[:, 1], 0))
            minv = (self.bbox_params.min_visibility
                    if self.bbox_params else 0.0)
            keep = vis_area / pre_area >= minv
            b = clipped[keep]
        out = dict(image=data["image"],
                   bboxes=[tuple(x) for x in b],
                   keypoints=[tuple(k) for k in data["keypoints"]])
        for f, v in fields.items():
            if f in label_fields:
                out[f] = [x for x, k in zip(v, keep) if k]
            else:
                out[f] = v
        return out
