"""Proposal recall evaluation (parity: mmdet/core/evaluation/recall.py).

A copy of `aidet_tpu/core/eval/recall.py`."""

from __future__ import annotations

import numpy as np

from .mean_ap import bbox_overlaps_np


def eval_recalls(gts, proposals, proposal_nums=(100, 300, 1000),
                 iou_thrs=(0.5,)):
    """Recall at (num_proposals × iou_thr).

    Args:
      gts: list over images of [M, 4] gt arrays.
      proposals: list over images of [K, 4] or [K, 5] (with scores,
        assumed score-sorted descending if 5 columns).
    Returns recalls [len(proposal_nums), len(iou_thrs)].
    """
    proposal_nums = np.asarray(proposal_nums, int)
    iou_thrs = np.asarray(iou_thrs, np.float32)
    all_ious = []
    for gt, prop in zip(gts, proposals):
        prop = np.asarray(prop)
        if prop.shape[-1] == 5:
            prop = prop[np.argsort(-prop[:, 4])][:, :4]
        img_ious = []
        for k in proposal_nums:
            p = prop[:k]
            if len(gt) == 0:
                img_ious.append(np.zeros((0, 1), np.float32))
            elif len(p) == 0:
                img_ious.append(np.zeros((len(gt), 1), np.float32))
            else:
                img_ious.append(
                    bbox_overlaps_np(np.asarray(gt, np.float32),
                                     np.asarray(p, np.float32)))
        all_ious.append(img_ious)

    recalls = np.zeros((len(proposal_nums), len(iou_thrs)))
    for ki in range(len(proposal_nums)):
        max_ious = []
        for img_ious in all_ious:
            m = img_ious[ki]
            if m.shape[0]:
                max_ious.append(m.max(axis=1) if m.shape[1]
                                else np.zeros(m.shape[0]))
        gt_ious = (np.concatenate(max_ious) if max_ious
                   else np.zeros(0, np.float32))
        for ti, thr in enumerate(iou_thrs):
            recalls[ki, ti] = ((gt_ious >= thr).mean()
                               if len(gt_ious) else 0.0)
    return recalls
