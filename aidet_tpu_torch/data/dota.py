"""DOTA dataset: patch-level training, scene-level evaluation.

Port of `aidet_tpu/data/dota.py`: `parse_patch_name` (:26) and
`DOTADataset(CocoDataset)` (:45-158: `parse_anns`, `format_results_txt`
:56, `merge_patches_to_scenes` :80 as a method over the module's
function of the class names, which scene serving calls directly, and
`evaluate_scenes` :109).  Labels may be int32 (the reference's) or
int64 (the port's).
"""

from __future__ import annotations

import os
import re

import numpy as np

from ..core.eval.class_names import DOTA_CLASSES
from ..core.eval.dota import HBB_MERGE_NMS_THR, OBB_MERGE_NMS_THR, dota_eval
from .coco import CocoDataset
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


class DOTADataset(CocoDataset):
    """The 15 DOTA classes; `parse_anns` is `CocoDataset`'s, which reads
    the 'pointobb' that DOTA patch jsons carry per annotation."""
    CLASSES = DOTA_CLASSES

    def format_results_txt(self, dets_by_patch: dict, out_dir: str,
                           task: str = "obb"):
        """Write per-class DOTA submission txt (scene-level inputs).

        Task1 (obb): 'scene score x1 y1 ... x4 y4'; Task2 (hbb):
        'scene score xmin ymin xmax ymax' (format_dota_results,
        dota.py:278-308).
        """
        os.makedirs(out_dir, exist_ok=True)
        per_class: dict = {c: [] for c in range(len(self.CLASSES))}
        for scene, det in dets_by_patch.items():
            boxes = np.asarray(det["boxes"])
            scores = np.asarray(det["scores"])
            labels = np.asarray(det["labels"])
            for b, s, l in zip(boxes, scores, labels):
                per_class[int(l)].append((scene, float(s), b))
        task_id = "1" if task == "obb" else "2"
        for c, rows in per_class.items():
            fname = os.path.join(out_dir,
                                 f"Task{task_id}_{self.CLASSES[c]}.txt")
            with open(fname, "w") as f:
                for scene, s, b in rows:
                    coords = " ".join(f"{v:.2f}"
                                      for v in np.asarray(b).ravel())
                    f.write(f"{scene} {s:.4f} {coords}\n")
        return out_dir

    def merge_patches_to_scenes(self, dets_by_patch: list,
                                patch_names: list, task: str = "obb",
                                classwise_nms: bool = True):
        """Group patch detections by scene and merge with global
        per-class rotated/HBB NMS (merge_txt, dota.py:310-336)."""
        return merge_patches_to_scenes(dets_by_patch, patch_names,
                                       self.CLASSES, task=task,
                                       classwise_nms=classwise_nms)

    def evaluate_scenes(self, merged: dict, gts_by_scene: dict,
                        task: str = "obb", iou_thr: float = 0.5):
        """VOC-07 DOTA AP (evaluate -> _evaluation_dota,
        dota.py:338-440): (mAP, {class: AP})."""
        return dota_eval(merged, gts_by_scene, self.CLASSES, task=task,
                         iou_thr=iou_thr, use_07_metric=True)
