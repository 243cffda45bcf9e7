"""DOTA scene helpers: patch names and the patch -> scene merge.

Port of the functions of `aidet_tpu/data/dota.py` that scene serving
needs: `parse_patch_name` (:26) and `DOTADataset.merge_patches_to_scenes`
(:80-107) as a function of the class names.  The dataset class itself
is not ported yet.
"""

from __future__ import annotations

import os
import re

import numpy as np

from ..core.eval.dota import HBB_MERGE_NMS_THR, OBB_MERGE_NMS_THR
from .tiling import merge_patch_detections

_PATCH_RE = re.compile(r"(.+?)__([\d.]+)__(\d+)___(\d+)$")


def parse_patch_name(name: str):
    """'P0001__1__0___512' (scene__scale__x___y) patch names →
    (scene, x_off, y_off, scale).

    The DOTA devkit encodes the patch origin and the scene scale in
    the filename; scene coords = (patch coords + offset) / scale.
    Falls back to (name, 0, 0, 1) when the pattern is absent.
    """
    stem = os.path.basename(name)
    root, ext = os.path.splitext(stem)
    if ext.lower() in (".png", ".jpg", ".jpeg", ".tif", ".tiff", ".bmp"):
        stem = root
    m = _PATCH_RE.match(stem)
    if not m:
        return stem, 0.0, 0.0, 1.0
    return m.group(1), float(m.group(3)), float(m.group(4)), \
        float(m.group(2))


def merge_patches_to_scenes(dets_by_patch: list, patch_names: list,
                            classes, task: str = "obb",
                            classwise_nms: bool = True):
    """Group patch detections by scene and merge each scene with a
    global per-class rotated (task "obb", quads) or HBB NMS at the
    per-class thresholds of ``classes`` (merge_txt, dota.py:310-336).
    Returns {scene: dict(boxes, scores, labels)}."""
    thr_table = (OBB_MERGE_NMS_THR if task == "obb"
                 else HBB_MERGE_NMS_THR)
    if classwise_nms:
        iou_thr = {i: thr_table[c] for i, c in enumerate(classes)}
    else:
        iou_thr = 0.3
    by_scene: dict = {}
    for det, name in zip(dets_by_patch, patch_names):
        scene, ox, oy, rate = parse_patch_name(name)
        if rate != 1.0:  # scene coords = (patch + offset) / scale
            det = dict(det)
            det["boxes"] = np.asarray(det["boxes"]) / rate
            ox, oy = ox / rate, oy / rate
        by_scene.setdefault(scene, ([], []))
        by_scene[scene][0].append(det)
        by_scene[scene][1].append((ox, oy))
    merged = {}
    for scene, (dets, offs) in by_scene.items():
        merged[scene] = merge_patch_detections(
            dets, np.asarray(offs, np.float32),
            num_classes=len(classes), iou_thr=iou_thr,
            box_type="quad" if task == "obb" else "box")
    return merged
