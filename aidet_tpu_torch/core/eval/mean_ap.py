"""mAP evaluation (host-side numpy).

A copy of `aidet_tpu/core/eval/mean_ap.py`.  Parity: mmdet/core/evaluation/mean_ap.py (average_precision:12 area/
11points modes, tpfp_default:153 greedy matching, eval_map:266) with a
pluggable pairwise-IoU function so the same machinery scores HBB
(legacy +1 IoU) and OBB (polygon IoU) detections.
"""

from __future__ import annotations

import numpy as np


def bbox_overlaps_np(b1, b2):
    """Legacy +1 HBB IoU (core/evaluation/bbox_overlaps.py)."""
    if len(b1) == 0 or len(b2) == 0:
        return np.zeros((len(b1), len(b2)), np.float32)
    area1 = (b1[:, 2] - b1[:, 0] + 1) * (b1[:, 3] - b1[:, 1] + 1)
    area2 = (b2[:, 2] - b2[:, 0] + 1) * (b2[:, 3] - b2[:, 1] + 1)
    xx1 = np.maximum(b1[:, None, 0], b2[None, :, 0])
    yy1 = np.maximum(b1[:, None, 1], b2[None, :, 1])
    xx2 = np.minimum(b1[:, None, 2], b2[None, :, 2])
    yy2 = np.minimum(b1[:, None, 3], b2[None, :, 3])
    inter = (np.clip(xx2 - xx1 + 1, 0, None)
             * np.clip(yy2 - yy1 + 1, 0, None))
    return inter / (area1[:, None] + area2[None] - inter)


def quad_overlaps_np(q1, q2):
    """Polygon IoU between [N,8] and [M,8] quads (host path).

    Pure numpy (data/np_rboxes.quad_overlaps_np_host): a full DOTA eval
    calls this with thousands of distinct ragged (N, M) shapes, which
    stay on the host."""
    n, m = len(q1), len(q2)
    if n == 0 or m == 0:
        return np.zeros((n, m), np.float32)
    from ...data.np_rboxes import quad_overlaps_np_host
    return quad_overlaps_np_host(np.asarray(q1, np.float32),
                                 np.asarray(q2, np.float32))


def average_precision(recalls, precisions, mode="area"):
    """Parity: mean_ap.py:12-57."""
    recalls = np.asarray(recalls, np.float32)
    precisions = np.asarray(precisions, np.float32)
    if mode == "area":
        mrec = np.concatenate([[0.0], recalls, [1.0]])
        mpre = np.concatenate([[0.0], precisions, [0.0]])
        for i in range(len(mpre) - 2, -1, -1):
            mpre[i] = max(mpre[i], mpre[i + 1])
        idx = np.where(mrec[1:] != mrec[:-1])[0]
        return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))
    if mode == "11points":
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = precisions[recalls >= t]
            ap += (p.max() if p.size else 0.0) / 11.0
        return float(ap)
    raise ValueError(mode)


def tpfp_default(det, gt, gt_ignore, iou_thr=0.5, iou_fn=bbox_overlaps_np):
    """Greedy TP/FP flags for one image+class.

    Parity: tpfp_default (mean_ap.py:153-214): dets sorted by score,
    each matched to its best unmatched gt above thr; matches to ignore
    regions are neither TP nor FP.

    Args:
      det: [K, D+1] (coords..., score); gt: [M, D]; gt_ignore: [I, D].
    Returns (tp [K], fp [K]) float arrays in the det order given.
    """
    k = len(det)
    tp = np.zeros(k, np.float32)
    fp = np.zeros(k, np.float32)
    if k == 0:
        return tp, fp
    coords = det[:, :-1]
    if len(gt) == 0 and len(gt_ignore) == 0:
        fp[:] = 1
        return tp, fp
    ious = iou_fn(coords, gt) if len(gt) else np.zeros((k, 0))
    ious_ig = (iou_fn(coords, gt_ignore) if len(gt_ignore)
               else np.zeros((k, 0)))
    covered = np.zeros(len(gt), bool)
    order = np.argsort(-det[:, -1])
    for i in order:
        if len(gt):
            j = int(np.argmax(ious[i])) if ious.shape[1] else -1
            if j >= 0 and ious[i, j] >= iou_thr:
                if not covered[j]:
                    covered[j] = True
                    tp[i] = 1
                else:
                    fp[i] = 1
                continue
        if ious_ig.shape[1] and ious_ig[i].max() >= iou_thr:
            continue  # matches an ignore region: neither tp nor fp
        fp[i] = 1
    return tp, fp


def eval_map(det_results, gt_results, iou_thr=0.5, use_07_metric=False,
             iou_fn=bbox_overlaps_np, num_classes=None):
    """Mean AP over classes.

    Args:
      det_results: list over images; each a list over classes of
        [K, D+1] arrays (reference bbox2result layout).
      gt_results: list over images of dict(boxes [M, D], labels [M]
        1-based, ignore optional [I, D], ignore_labels optional).
    Returns (mAP, per-class list of dicts).
    """
    num_imgs = len(det_results)
    if num_classes is None:
        num_classes = max(len(d) for d in det_results)
    eval_results = []
    for c in range(num_classes):
        cls_dets, cls_tp, cls_fp = [], [], []
        num_gts = 0
        for i in range(num_imgs):
            det = np.asarray(det_results[i][c]) if c < len(det_results[i]) \
                else np.zeros((0, 5), np.float32)
            g = gt_results[i]
            mask = np.asarray(g["labels"]) == c + 1
            gt = np.asarray(g["boxes"])[mask] if mask.any() else \
                np.zeros((0, det.shape[-1] - 1 if det.size else 4))
            n_ig = len(g.get("ignore", []))
            if n_ig and len(g.get("ignore_labels", [])):
                ig_mask = np.asarray(g["ignore_labels"]) == c + 1
            else:
                # no ignore_labels → class-agnostic ignore regions
                # (the VOC 'difficult' convention): count them for
                # every class
                ig_mask = np.ones(n_ig, bool)
            ig = (np.asarray(g["ignore"])[ig_mask] if n_ig
                  else np.zeros((0, gt.shape[-1] if gt.size else 4)))
            num_gts += len(gt)
            tp, fp = tpfp_default(det, gt, ig, iou_thr, iou_fn)
            cls_dets.append(det)
            cls_tp.append(tp)
            cls_fp.append(fp)
        dets = np.concatenate(cls_dets) if cls_dets else np.zeros((0, 5))
        tp = np.concatenate(cls_tp)
        fp = np.concatenate(cls_fp)
        order = np.argsort(-dets[:, -1]) if len(dets) else np.array([], int)
        tp = np.cumsum(tp[order])
        fp = np.cumsum(fp[order])
        recalls = tp / max(num_gts, 1)
        precisions = tp / np.maximum(tp + fp, np.finfo(np.float32).eps)
        ap = average_precision(recalls, precisions,
                               "11points" if use_07_metric else "area") \
            if num_gts > 0 and len(dets) else 0.0
        eval_results.append(dict(
            num_gts=num_gts, num_dets=len(dets), ap=ap,
            recall=float(recalls[-1]) if len(recalls) else 0.0,
            precision=float(precisions[-1]) if len(precisions) else 0.0))
    valid = [r["ap"] for r in eval_results if r["num_gts"] > 0]
    mean_ap = float(np.mean(valid)) if valid else 0.0
    return mean_ap, eval_results
