"""The albu train stage (parity: pipelines/transforms.py:865-1010 Albu).

Port of `aidet_tpu/data/albu.py::AlbuTransform` (:30-94).  The
reference prefers the real `albumentations` package and falls back to
its vendored subset; the card's machine has no `albumentations`, so the
port always builds the vendored subset (`_vendor_albu`:
ShiftScaleRotate, RandomBrightnessContrast, ChannelShuffle, Blur,
MedianBlur, OneOf), and a transform outside it raises at construction,
as the reference's fallback does.
"""

from __future__ import annotations

import numpy as np

from . import _vendor_albu


def _albu_builder(cfg, albumentations):
    """{'type': 'ShiftScaleRotate', ...} -> a transform of the subset."""
    args = dict(cfg)
    obj_type = args.pop("type")
    cls = (getattr(albumentations, obj_type)
           if isinstance(obj_type, str) else obj_type)
    if "transforms" in args:
        args["transforms"] = [_albu_builder(t, albumentations)
                              for t in args["transforms"]]
    return cls(**args)


class AlbuTransform:
    """Apply the albu transforms to (img, boxes, labels, pointobbs).

    Boxes ride the pascal_voc bbox protocol; pointobbs ride the keypoint
    protocol (4 keypoints per box, 'xy') so that rotated annotations
    survive geometric transforms.  Instances whose box the transform
    drops are filtered from every field.
    """

    def __init__(self, transforms, min_visibility: float = 0.1):
        albumentations = _vendor_albu
        self._check_vendored_subset(transforms, albumentations)
        self._albu = albumentations
        self.aug = albumentations.Compose(
            [_albu_builder(t, albumentations) for t in transforms],
            bbox_params=albumentations.BboxParams(
                format="pascal_voc", label_fields=["idx"],
                min_visibility=min_visibility),
            keypoint_params=albumentations.KeypointParams(
                format="xy", remove_invisible=False),
        )

    @staticmethod
    def _check_vendored_subset(transforms, vendor):
        def walk(cfgs):
            for cfg in cfgs:
                t = cfg["type"] if isinstance(cfg, dict) else cfg
                if isinstance(t, str) and not hasattr(vendor, t):
                    raise ImportError(
                        f"the port's albu stage takes the vendored subset "
                        f"of albumentations, which has no {t!r}; restrict "
                        f"the pipeline to ShiftScaleRotate, "
                        f"RandomBrightnessContrast, ChannelShuffle, Blur, "
                        f"MedianBlur and OneOf")
                if isinstance(cfg, dict) and "transforms" in cfg:
                    walk(cfg["transforms"])
        walk(transforms)

    def __call__(self, img, boxes, labels, pointobbs=None):
        n = len(boxes)
        kps = (np.asarray(pointobbs, np.float32).reshape(-1, 2)
               if pointobbs is not None and len(pointobbs)
               else np.zeros((0, 2), np.float32))
        h, w = img.shape[:2]
        safe = np.stack([
            np.clip(boxes[:, 0], 0, w - 2),
            np.clip(boxes[:, 1], 0, h - 2),
            np.clip(boxes[:, 2], 1, w - 1),
            np.clip(boxes[:, 3], 1, h - 1)], -1) if n else boxes
        res = self.aug(image=img, bboxes=[tuple(b) for b in safe],
                       idx=list(range(n)),
                       keypoints=[tuple(k) for k in kps])
        img = res["image"]
        keep = np.asarray(res["idx"], np.int64)
        new_boxes = (np.asarray(res["bboxes"], np.float32)
                     .reshape(-1, 4))
        labels = np.asarray(labels)[keep] if n else labels
        out_pobbs = None
        if pointobbs is not None and len(pointobbs):
            out_pobbs = (np.asarray(res["keypoints"], np.float32)
                         .reshape(-1, 8)[keep])
        return img, new_boxes, labels, out_pobbs
