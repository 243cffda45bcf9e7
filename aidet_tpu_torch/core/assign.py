"""MaxIoU label assignment over padded gt sets.

Port of `aidet_tpu/core/assign.py::max_iou_assign` in float32.  The
reference's opt-in bfloat16 IoU matrix (`AIDET_ASSIGN_BF16`) is not
ported.  Leading batch dimensions are written out instead of vmapped:
boxes [..., N, 4] against gts [..., G, 4].
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .boxes import bbox_overlaps


class AssignResult(NamedTuple):
    gt_inds: torch.Tensor       # [..., N] int32: -1 ignore, 0 neg, k > 0 gt k-1
    max_overlaps: torch.Tensor  # [..., N] best IoU with any valid gt
    labels: torch.Tensor        # [..., N] int32 class of the gt (0 if none)


def max_iou_assign(boxes, gt_boxes, gt_valid, gt_labels=None,
                   pos_iou_thr=0.7, neg_iou_thr=0.3, min_pos_iou=0.0,
                   gt_max_assign_all=True, box_valid=None) -> AssignResult:
    """Assign each box to a gt, to background (0) or to ignore (-1).

    1. every box starts at -1;
    2. max IoU in [0, neg_iou_thr) (or in a (lo, hi) range) -> 0;
    3. max IoU >= pos_iou_thr -> its best gt;
    4. each valid gt claims the boxes that reach its own best IoU (when
       that is >= min_pos_iou); where several gts claim one box the
       later gt wins, as in the reference's loop.
    Padding gts count as IoU 0 (background, not ignore); invalid boxes
    always get -1.
    """
    overlaps = bbox_overlaps(gt_boxes, boxes)               # [..., G, N]
    overlaps = torch.where(gt_valid[..., :, None], overlaps,
                           overlaps.new_zeros(()))
    if box_valid is not None:
        overlaps = torch.where(box_valid[..., None, :], overlaps,
                               overlaps.new_full((), -1.0))
    # argmax returns the first maximal index, as jnp.argmax
    max_overlaps, argmax = overlaps.max(dim=-2)             # [..., N]

    assigned = torch.full_like(argmax, -1, dtype=torch.int32)
    if isinstance(neg_iou_thr, (tuple, list)):
        lo, hi = neg_iou_thr
        is_neg = (max_overlaps >= lo) & (max_overlaps < hi)
    else:
        is_neg = (max_overlaps >= 0) & (max_overlaps < neg_iou_thr)
    assigned = torch.where(is_neg, 0, assigned)
    assigned = torch.where(max_overlaps >= pos_iou_thr,
                           (argmax + 1).to(torch.int32), assigned)

    gt_max = overlaps.max(dim=-1, keepdim=True).values       # [..., G, 1]
    claim = ((overlaps == gt_max) & (gt_max >= min_pos_iou)
             & gt_valid[..., :, None])
    if not gt_max_assign_all:
        only_best = torch.zeros_like(claim).scatter_(
            -1, overlaps.argmax(dim=-1, keepdim=True), True)
        claim &= only_best
    g = claim.shape[-2]
    gt_ids = torch.arange(1, g + 1, dtype=torch.int32,
                          device=boxes.device)[:, None]
    claimed = (claim * gt_ids).amax(dim=-2)                 # 0: unclaimed
    assigned = torch.where(claimed > 0, claimed.to(torch.int32), assigned)
    if box_valid is not None:
        assigned = torch.where(box_valid, assigned, -1)

    pos = assigned > 0
    if gt_labels is None:
        labels = pos.to(torch.int32)
    else:
        safe = (assigned.long() - 1).clamp(0, g - 1)
        labels = torch.where(pos, torch.gather(gt_labels.to(torch.int32),
                                               -1, safe), 0)
    return AssignResult(assigned, max_overlaps.clamp(min=0.0).float(),
                        labels.to(torch.int32))
