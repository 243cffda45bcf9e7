"""DOTA evaluation: VOC-07 AP over scene-level detections.

A copy of `aidet_tpu/core/eval/dota.py`.  Parity: the wwtool dota_eval_task1/task2 path invoked from
mmdet/datasets/dota.py:416-440 (_evaluation_dota, use_07_metric=True):
Task1 scores OBB quads with polygon IoU, Task2 scores HBB with box IoU,
both at IoU 0.5 with 11-point AP.
"""

from __future__ import annotations

import numpy as np

from .mean_ap import (average_precision, bbox_overlaps_np, quad_overlaps_np,
                      tpfp_default)

# per-class merge NMS thresholds (datasets/dota.py:321-324)
HBB_MERGE_NMS_THR = {
    "harbor": 0.4, "ship": 0.4, "small-vehicle": 0.4,
    "large-vehicle": 0.5, "storage-tank": 0.1, "plane": 0.25,
    "soccer-ball-field": 0.2, "bridge": 0.5, "baseball-diamond": 0.15,
    "tennis-court": 0.2, "helicopter": 0.2, "roundabout": 0.15,
    "swimming-pool": 0.2, "ground-track-field": 0.15,
    "basketball-court": 0.2}
OBB_MERGE_NMS_THR = {
    "harbor": 0.1, "ship": 0.05, "small-vehicle": 0.15,
    "large-vehicle": 0.5, "storage-tank": 0.35, "plane": 0.2,
    "soccer-ball-field": 0.2, "bridge": 0.45, "baseball-diamond": 0.2,
    "tennis-court": 0.1, "helicopter": 0.1, "roundabout": 0.15,
    "swimming-pool": 0.05, "ground-track-field": 0.4,
    "basketball-court": 0.2}


def export_dota_results(aps: dict, mean_ap: float, out_prefix: str,
                        pr_curves: dict | None = None):
    """Write per-class AP tables (+optional PR curves) to disk.

    Parity: DOTADataset.evaluate's Excel/PR export (datasets/dota.py:
    385-411) — CSV always, .xlsx when pandas is available, PR-curve
    PNG when matplotlib is available (neither need be installed).
    """
    import os
    os.makedirs(os.path.dirname(os.path.abspath(out_prefix)) or ".",
                exist_ok=True)
    rows = sorted(aps.items())
    with open(out_prefix + ".csv", "w") as f:
        f.write("class,ap\n")
        for name, ap in rows:
            f.write(f"{name},{ap:.4f}\n")
        f.write(f"mAP,{mean_ap:.4f}\n")
    try:
        import pandas as pd
        pd.DataFrame(rows + [("mAP", mean_ap)],
                     columns=["class", "ap"]).to_excel(
            out_prefix + ".xlsx", index=False)
    except ImportError:     # pandas, or its Excel writer, is absent
        pass
    if pr_curves:
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
            for name, (rec, prec) in pr_curves.items():
                plt.plot(rec, prec, label=name)
            plt.xlabel("recall")
            plt.ylabel("precision")
            plt.legend(fontsize=6)
            plt.savefig(out_prefix + "_pr.png", dpi=120)
            plt.close()
        except ImportError:
            pass
    return out_prefix + ".csv"


def dota_eval(dets_by_scene: dict, gts_by_scene: dict, classes,
              task: str = "obb", iou_thr: float = 0.5,
              use_07_metric: bool = True):
    """Evaluate scene-level detections.

    Args:
      dets_by_scene: {scene_id: dict(boxes [K, 8|4], scores [K],
        labels [K] 0-based)}.
      gts_by_scene: {scene_id: dict(boxes [M, 8|4], labels [M] 0-based,
        difficult optional [M] bool)}.
      task: 'obb' (polygon IoU) or 'hbb'.
    Returns (mAP, {class_name: ap}).
    """
    iou_fn = quad_overlaps_np if task == "obb" else bbox_overlaps_np
    dim = 8 if task == "obb" else 4
    aps = {}
    for c, name in enumerate(classes):
        all_tp, all_fp, all_scores = [], [], []
        num_gts = 0
        # union of scene keys: a detected scene with no gt entry must
        # still contribute its detections as false positives (VOC
        # semantics) instead of being silently dropped
        for scene in sorted(set(gts_by_scene) | set(dets_by_scene)):
            gt = gts_by_scene.get(scene)
            if gt is not None and len(gt["labels"]):
                gmask = np.asarray(gt["labels"]) == c
                g = (np.asarray(gt["boxes"], np.float32)[gmask]
                     if gmask.any() else np.zeros((0, dim), np.float32))
                # coerce: an int difficulty column (the natural DOTA
                # labelTxt parse) under ~ would integer-fancy-index
                diff = np.asarray(gt.get(
                    "difficult",
                    np.zeros(len(gt["labels"]), bool))).astype(bool)
                gd = diff[gmask] if gmask.any() else np.zeros(0, bool)
            else:
                g = np.zeros((0, dim), np.float32)
                gd = np.zeros(0, bool)
            easy = g[~gd]
            hard = g[gd]
            num_gts += len(easy)

            det = dets_by_scene.get(scene)
            if det is None or len(det["labels"]) == 0:
                continue
            dmask = np.asarray(det["labels"]) == c
            if not dmask.any():
                continue
            db = np.asarray(det["boxes"], np.float32)[dmask]
            ds = np.asarray(det["scores"], np.float32)[dmask]
            d = np.concatenate([db, ds[:, None]], -1)
            tp, fp = tpfp_default(d, easy, hard, iou_thr, iou_fn)
            all_tp.append(tp)
            all_fp.append(fp)
            all_scores.append(ds)
        if num_gts == 0:
            # VOC convention: classes absent from the gt don't take
            # part in the mean (they'd otherwise drag mAP to 0 on
            # subsets that lack some classes)
            continue
        if not all_scores:
            aps[name] = 0.0
            continue
        scores = np.concatenate(all_scores)
        order = np.argsort(-scores)
        tp = np.cumsum(np.concatenate(all_tp)[order])
        fp = np.cumsum(np.concatenate(all_fp)[order])
        recalls = tp / max(num_gts, 1)
        precisions = tp / np.maximum(tp + fp, np.finfo(np.float32).eps)
        aps[name] = average_precision(
            recalls, precisions, "11points" if use_07_metric else "area")
    valid = list(aps.values())
    mean_ap = float(np.mean(valid)) if valid else 0.0
    return mean_ap, aps
