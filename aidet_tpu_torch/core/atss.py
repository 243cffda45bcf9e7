"""ATSS assignment (adaptive training sample selection).

Port of `aidet_tpu/core/atss.py::atss_assign` :17 (parity: mmdet's
atss_assigner.py), batched over images: per gt and level the ``topk``
anchors whose centres lie closest to the gt's centre are candidates;
the gt's IoU threshold is the mean plus the Bessel-corrected standard
deviation of its candidates' IoUs; a candidate at or above it whose
centre lies inside the gt (by 0.01 px) is positive, and an anchor
positive for several gts goes to the one of highest IoU.
"""

from __future__ import annotations

from typing import Sequence

import torch

from .assign import _claim_closest
from .boxes import bbox_overlaps


def atss_assign(anchors, level_sizes: Sequence[int], gt_boxes, gt_valid,
                gt_labels=None, topk: int = 9):
    """anchors [A, 4]; gt_boxes [B, G, 4], gt_valid [B, G], gt_labels
    [B, G] (1-based) or None.  Returns (assigned [B, A] int32: 0
    background, k > 0 gt k - 1; labels [B, A] int32).  The closest
    anchors are ranked by a stable sort (ties to the lower index, as the
    reference's top_k): a gt centred midway between anchor centres has
    exactly tied distances."""
    g = gt_boxes.shape[-2]
    valid = gt_valid.bool()[..., None]
    overlaps = bbox_overlaps(gt_boxes, anchors.expand(
        gt_boxes.shape[0], -1, -1))                          # [B, G, A]
    overlaps = torch.where(valid, overlaps, overlaps.new_zeros(()))
    ax = (anchors[:, 0] + anchors[:, 2]) * 0.5
    ay = (anchors[:, 1] + anchors[:, 3]) * 0.5
    gx = ((gt_boxes[..., 0] + gt_boxes[..., 2]) * 0.5)[..., None]
    gy = ((gt_boxes[..., 1] + gt_boxes[..., 3]) * 0.5)[..., None]
    dist = torch.sqrt((ax - gx) ** 2 + (ay - gy) ** 2)       # [B, G, A]
    cand = torch.cat([_claim_closest(d, min(topk, d.shape[-1]))
                      for d in dist.split(list(level_sizes), -1)], -1)
    cnt = cand.sum(-1).clamp(min=1)
    zero = overlaps.new_zeros(())
    mean = torch.where(cand, overlaps, zero).sum(-1) / cnt
    var = (torch.where(cand, (overlaps - mean[..., None]) ** 2, zero)
           .sum(-1) / (cnt - 1).clamp(min=1))
    thr = mean + torch.sqrt(var)
    inside = ((ax - gt_boxes[..., 0, None] > 0.01)
              & (ay - gt_boxes[..., 1, None] > 0.01)
              & (gt_boxes[..., 2, None] - ax > 0.01)
              & (gt_boxes[..., 3, None] - ay > 0.01))
    pos = cand & (overlaps >= thr[..., None]) & inside & valid
    best, best_gt = torch.where(pos, overlaps,
                                overlaps.new_tensor(-1.0)).max(-2)
    assigned = torch.where(best > -0.5, best_gt.to(torch.int32) + 1, 0)
    if gt_labels is None:
        labels = (assigned > 0).to(torch.int32)
    else:
        safe = (assigned.long() - 1).clamp(0, g - 1)
        labels = torch.where(assigned > 0, torch.gather(
            gt_labels.to(torch.int32), -1, safe), 0)
    return assigned.to(torch.int32), labels.to(torch.int32)
