"""Instance-segmentation (mask) mAP without pycocotools.

Port of `aidet_tpu/core/eval/segm.py` (parity target:
CocoDataset.evaluate(metric='segm'), the reference's datasets/coco.py
:291-392 via COCOeval) without OpenCV: a mask is a box-bounded record
(xyxy box, binary crop within the box, pixel area) and the IoU of two
records touches only the intersection of their boxes.  The predicted
crop is resized as `cv2.resize` by `core.masks.resize_linear`, and a
polygon filled as `cv2.fillPoly` by `data.raster.fill_poly` (exact
inside its record's box; tests/test_torch_port_mask_targets.py).
"""

from __future__ import annotations

import numpy as np

from ...data.raster import fill_poly
from ..masks import resize_linear


def mask_record(box, crop, img_hw, thr: float = 0.5):
    """(box, SxS soft crop) -> (int box, binary crop at the box's
    resolution, area), as `core.masks.paste_mask` without the canvas."""
    h, w = img_hw
    x1 = max(int(round(float(box[0]))), 0)
    y1 = max(int(round(float(box[1]))), 0)
    x2 = min(int(round(float(box[2]))), w - 1)
    y2 = min(int(round(float(box[3]))), h - 1)
    bw, bh = max(x2 - x1 + 1, 1), max(y2 - y1 + 1, 1)
    m = resize_linear(np.asarray(crop, np.float32), (bw, bh)) > thr
    return (x1, y1, x1 + bw, y1 + bh), m, int(m.sum())


def polygon_record(seg, img_hw):
    """A polygon segmentation (flat [2k], or COCO's list of parts, all
    filled into one record) -> box-bounded binary record."""
    h, w = img_hw
    if (isinstance(seg, (list, tuple)) and seg
            and isinstance(seg[0], (list, tuple, np.ndarray))):
        parts = [np.asarray(p, np.float32).reshape(-1, 2) for p in seg]
    else:
        parts = [np.asarray(seg, np.float32).reshape(-1, 2)]
    allpts = np.concatenate(parts)
    x1 = int(np.clip(np.floor(allpts[:, 0].min()), 0, w - 1))
    y1 = int(np.clip(np.floor(allpts[:, 1].min()), 0, h - 1))
    x2 = int(np.clip(np.ceil(allpts[:, 0].max()) + 1, x1 + 1, w))
    y2 = int(np.clip(np.ceil(allpts[:, 1].max()) + 1, y1 + 1, h))
    m = np.zeros((y2 - y1, x2 - x1), np.uint8)
    for pts in parts:
        fill_poly(m, np.round(pts - [x1, y1]).astype(np.int32), 1)
    m = m.astype(bool)
    return (x1, y1, x2, y2), m, int(m.sum())


def mask_iou_matrix(preds, gts):
    """IoU between box-bounded mask records, [P, G]."""
    out = np.zeros((len(preds), len(gts)), np.float32)
    for i, (pb, pm, pa) in enumerate(preds):
        for j, (gb, gm, ga) in enumerate(gts):
            ix1, iy1 = max(pb[0], gb[0]), max(pb[1], gb[1])
            ix2, iy2 = min(pb[2], gb[2]), min(pb[3], gb[3])
            if ix1 >= ix2 or iy1 >= iy2 or pa == 0 or ga == 0:
                continue
            a = pm[iy1 - pb[1]:iy2 - pb[1], ix1 - pb[0]:ix2 - pb[0]]
            b = gm[iy1 - gb[1]:iy2 - gb[1], ix1 - gb[0]:ix2 - gb[0]]
            inter = int(np.logical_and(a, b).sum())
            out[i, j] = inter / max(pa + ga - inter, 1)
    return out


def _tpfp_masks(scores, ious, num_gt, iou_thr, ious_ignore=None):
    """Greedy matching (mean_ap.tpfp_default semantics, mask IoUs).

    Detections whose best remaining match is an ignore/crowd mask are
    neither TP nor FP (COCOeval crowd handling)."""
    k = len(scores)
    tp = np.zeros(k, np.float32)
    fp = np.zeros(k, np.float32)
    covered = np.zeros(num_gt, bool)
    for i in np.argsort(-scores):
        j = int(ious[i].argmax()) if num_gt else -1
        if j >= 0 and ious[i, j] >= iou_thr and not covered[j]:
            covered[j] = True
            tp[i] = 1
        elif (ious_ignore is not None and ious_ignore.shape[1]
                and ious_ignore[i].max() >= iou_thr):
            pass                      # matched a crowd region: skip
        else:
            fp[i] = 1
    return tp, fp


def eval_segm(pred_per_img, gt_per_img, num_classes: int,
              iou_thrs=None, use_07_metric: bool = False):
    """Mask mAP.

    Args:
      pred_per_img: list over images of dict(records [K triples],
        scores [K], labels [K] 0-based).
      gt_per_img: list over images of dict(records [M], labels [M]
        0-based).
      iou_thrs: scalar or iterable (default COCO 0.5:0.95).
    Returns (mAP averaged over thresholds, {thr: (mAP, per-class)}).
    """
    from .mean_ap import average_precision
    if iou_thrs is None:
        iou_thrs = np.arange(0.5, 1.0, 0.05)
    iou_thrs = np.atleast_1d(np.asarray(iou_thrs, np.float64))

    # IoU matrices are threshold-independent: compute once per
    # (image, class) and sweep thresholds over them
    per_img_cls = []
    for pred, gt in zip(pred_per_img, gt_per_img):
        by_cls = {}
        p_labels = np.asarray(pred["labels"])
        g_labels = np.asarray(gt["labels"])
        ig_records = gt.get("ignore_records", [])
        for c in range(num_classes):
            pi = np.nonzero(p_labels == c)[0]
            gi = np.nonzero(g_labels == c)[0]
            if len(pi) == 0 and len(gi) == 0:
                continue
            ious = mask_iou_matrix([pred["records"][i] for i in pi],
                                   [gt["records"][j] for j in gi])
            ious_ig = mask_iou_matrix(
                [pred["records"][i] for i in pi], ig_records)
            by_cls[c] = (np.asarray(pred["scores"])[pi], ious,
                         len(gi), ious_ig)
        per_img_cls.append(by_cls)

    results = {}
    for thr in iou_thrs:
        aps = {}
        for c in range(num_classes):
            all_tp, all_fp, all_s = [], [], []
            num_gts = 0
            for by_cls in per_img_cls:
                if c not in by_cls:
                    continue
                scores, ious, n_gt, ious_ig = by_cls[c]
                num_gts += n_gt
                if len(scores) == 0:
                    continue
                tp, fp = _tpfp_masks(scores, ious, n_gt, thr, ious_ig)
                all_tp.append(tp)
                all_fp.append(fp)
                all_s.append(scores)
            if num_gts == 0:
                continue
            if not all_s:
                aps[c] = 0.0
                continue
            s = np.concatenate(all_s)
            order = np.argsort(-s)
            tp = np.cumsum(np.concatenate(all_tp)[order])
            fp = np.cumsum(np.concatenate(all_fp)[order])
            rec = tp / max(num_gts, 1)
            prec = tp / np.maximum(tp + fp, np.finfo(np.float32).eps)
            aps[c] = average_precision(
                rec, prec, "11points" if use_07_metric else "area")
        results[round(float(thr), 2)] = (
            float(np.mean(list(aps.values()))) if aps else 0.0, aps)
    mean = float(np.mean([v[0] for v in results.values()]))
    return mean, results
