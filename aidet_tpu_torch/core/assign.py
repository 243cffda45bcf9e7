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


def _claim_closest(dist, k):
    """[..., G, N] bool: each gt's ``k`` closest entries of ``dist`` (a
    stable sort, ties to the lower index, as the reference's top_k)."""
    idx = torch.sort(dist, dim=-1, stable=True).indices[..., :k]
    return torch.zeros_like(dist, dtype=torch.bool).scatter_(-1, idx, True)


def point_assign(points, point_strides, gt_boxes, gt_valid, gt_labels=None,
                 scale=4.0, pos_num=1) -> AssignResult:
    """RepPoints' init-stage PointAssigner (reference
    `core/assign.py::point_assign` :128): each valid gt goes to the
    pyramid level floor(log2(sqrt(w h) / scale)), clamped into the
    levels of ``point_strides``; its ``pos_num`` closest points of that
    level claim it, and a point claimed by several gts takes the closest
    (the first of equal distances).

    points [P, 2]; point_strides [P]; gt_boxes [B, G, 4], gt_valid [B,
    G], gt_labels [B, G] or None.  Returns an `AssignResult` [B, P]
    (``max_overlaps`` zero)."""
    gw = gt_boxes[..., 2] - gt_boxes[..., 0]
    gh = gt_boxes[..., 3] - gt_boxes[..., 1]
    gt_scale = torch.sqrt((gw * gh).clamp(min=1e-6))
    pt_lvl = torch.log2(point_strides)
    gt_lvl = torch.minimum(torch.maximum(
        torch.floor(torch.log2(gt_scale / scale + 1e-6)), pt_lvl.min()),
        pt_lvl.max())                                       # [B, G]
    cx = (gt_boxes[..., 0] + gt_boxes[..., 2]) / 2
    cy = (gt_boxes[..., 1] + gt_boxes[..., 3]) / 2
    dist = torch.sqrt((points[:, 0] - cx[..., None]) ** 2
                      + (points[:, 1] - cy[..., None]) ** 2)  # [B, G, P]
    lvl_match = (pt_lvl - gt_lvl[..., None]).abs() < 0.5
    dist = torch.where(lvl_match & gt_valid.bool()[..., None], dist,
                       dist.new_tensor(1e10))
    claim = _claim_closest(dist, pos_num) & (dist < 1e9)
    claimed = torch.where(claim, dist, dist.new_tensor(1e10))
    best, best_gt = claimed.min(-2)                          # [B, P]
    assigned = torch.where(best < 1e9, best_gt.to(torch.int32) + 1, 0)
    pos = assigned > 0
    if gt_labels is None:
        labels = pos.to(torch.int32)
    else:
        safe = (assigned.long() - 1).clamp(0, gt_boxes.shape[-2] - 1)
        labels = torch.where(pos, torch.gather(gt_labels.to(torch.int32),
                                               -1, safe), 0)
    return AssignResult(assigned.to(torch.int32),
                        torch.zeros(assigned.shape, device=points.device),
                        labels.to(torch.int32))
