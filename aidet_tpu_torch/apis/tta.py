"""Test-time augmentation: multi-scale and flip inference of one image,
the detections of every variant merged.

Port of `aidet_tpu/apis/tta.py` (`flip_boxes_back` :24,
`aug_test_image` :31; parity: MultiScaleFlipAug, datasets/pipelines/
test_aug.py:8-38, and core/post_processing/merge_augs.py): each (scale,
flip) variant goes through the test pipeline at its scale, is padded
onto the model's canvas (``img_size``^2, as the reference's
`aug_predict` takes its variants) and goes through `predict`; its boxes
come back in the original frame (a flipped variant's mirrored about the
original width), its quads from the rboxes or, for the mask family,
from the masks' rectangles fitted on the pre-flip boxes and then
flipped; boxes and quads are then merged by per-class NMS
(`data.tiling.merge_patch_detections`), each on its own.  The model
holds its weights, so the port passes the model where the reference
passes (model, variables).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.masks import mask_quads
from ..data.np_rboxes import pointobb_flip, rbox_quads
from ..data.pipeline import TestPipeline
from ..data.tiling import merge_patch_detections
from .inference import to_numpy


def flip_boxes_back(boxes, img_w):
    """Boxes [..., 4] mirrored about a width of ``img_w``: x -> w - x - 1
    (`core.boxes.bbox_flip` of the reference)."""
    boxes = np.asarray(boxes)
    return np.stack([img_w - boxes[..., 2] - 1, boxes[..., 1],
                     img_w - boxes[..., 0] - 1, boxes[..., 3]], -1)


def _variant(model, img, scale):
    """One variant as predict's batch-1 arguments: ``img`` through the
    test pipeline at ``scale``, padded with zeros (the pipeline's own
    padding of normalized pixels) onto the model's canvas."""
    size = model.img_size
    if scale > size:
        raise ValueError(f"TTA scale {scale} exceeds the model's canvas "
                         f"img_size {size}")
    s = TestPipeline(img_size=scale)(img)
    canvas = np.zeros((size, size, 3), np.float32)
    canvas[:scale, :scale] = s["imgs"]
    device = model.anchors.device
    return (torch.from_numpy(canvas[None]).to(device),
            torch.from_numpy(s["img_shapes"][None]).to(device),
            torch.from_numpy(s["scale_factors"].reshape(1)).to(device))


def aug_test_image(model, img, scales=(1024,), flip: bool = True,
                   iou_thr: float = 0.5, num_classes: int = 15,
                   rbox_encode: str | None = None):
    """(scales x {identity, flip}) inference of one BGR uint8 image
    [H, W, 3], merged.  ``rbox_encode``: the encode of predict's rboxes
    (their quads are merged too), or None; a model with masks gets its
    quads from them.  Every scale must be at most the model's
    ``img_size``: the reference predicts each variant on a canvas of its
    own scale, which its static anchors (those of ``img_size``) fit only
    at ``img_size`` (ROADMAP section 3).  Returns dict(boxes, scores,
    labels) in the original frame, and with quads also quads,
    quad_scores and quad_labels."""
    h0, w0 = img.shape[:2]
    dets = []
    for s in scales:
        for f in ((False, True) if flip else (False,)):
            im = np.ascontiguousarray(img[:, ::-1] if f else img)
            out = to_numpy(model.predict(*_variant(model, im, s)))
            v = out["valid"][0]
            raw_boxes = out["boxes"][0][v]
            det = dict(boxes=flip_boxes_back(raw_boxes, w0) if f
                       else raw_boxes, scores=out["scores"][0][v],
                       labels=out["labels"][0][v],
                       valid=np.ones(int(v.sum()), bool))
            quads = None
            if rbox_encode is not None and "rboxes" in out:
                quads = rbox_quads(out["rboxes"][0][v], rbox_encode)
            elif "masks" in out:
                # crops are roi-relative: fit on the pre-flip boxes, then
                # flip the rectangles
                quads = mask_quads(out["masks"][0][v], raw_boxes)
            if quads is not None:
                det["quads"] = pointobb_flip(quads, (h0, w0)) if f else quads
            dets.append(det)

    out = dict(merge_patch_detections(
        dets, np.zeros((len(dets), 2), np.float32), num_classes=num_classes,
        iou_thr=iou_thr, box_type="box"))
    qdets = [dict(boxes=d["quads"], scores=d["scores"], labels=d["labels"],
                  valid=d["valid"]) for d in dets if "quads" in d]
    if qdets:
        qm = merge_patch_detections(
            qdets, np.zeros((len(qdets), 2), np.float32),
            num_classes=num_classes, iou_thr=iou_thr, box_type="quad")
        out.update(quads=qm["boxes"], quad_scores=qm["scores"],
                   quad_labels=qm["labels"])
    return out
