"""Flattening of dense head outputs, the anchor head's loss and RPN
proposal generation.

Port of `flatten_level_outputs`, `anchor_head_loss` and
`rpn_proposals` from `aidet_tpu/models/heads/anchor_head.py`.  Shapes
stay fixed: every image yields `max_num` proposal slots with a
validity mask.
"""

from __future__ import annotations

import torch

from ...core.anchors import anchor_target
from ...core.boxes import delta2bbox
from ...ops.nms import NEG_INF, nms, topk


def flatten_level_outputs(cls_scores, bbox_preds, cls_channels: int,
                          box_dim: int = 4):
    """Per-level NHWC maps -> ([B, A_total, C], [B, A_total, box_dim]),
    in the (h, w, anchor) order of `build_pyramid_anchors`."""
    b = cls_scores[0].shape[0]
    cls_flat = torch.cat([c.reshape(b, -1, cls_channels)
                          for c in cls_scores], 1)
    box_flat = torch.cat([p.reshape(b, -1, box_dim) for p in bbox_preds], 1)
    return cls_flat, box_flat


def anchor_head_loss(cls_flat, box_flat, anchors, gt_boxes, gt_valid,
                     img_shapes, generator: torch.Generator,
                     gt_labels=None, target_means=(0., 0., 0., 0.),
                     target_stds=(1., 1., 1., 1.), cls_loss=None,
                     bbox_loss=None, assigner_cfg=None, sampler_cfg=None,
                     allowed_border=0.0, pos_weight=-1.0):
    """Dense-head loss over flattened predictions (the sampling
    variant): classification and regression both averaged by the
    sampled anchors' count, num_total_pos + num_total_neg.

    cls_flat [B, A, C] and box_flat [B, A, 4] in the loss's dtype
    (float32 in the detector).  Returns dict(loss_cls, loss_bbox).
    """
    tg = anchor_target(anchors, gt_boxes, gt_valid, img_shapes, generator,
                       gt_labels=gt_labels, target_means=target_means,
                       target_stds=target_stds,
                       allowed_border=allowed_border, pos_weight=pos_weight,
                       **(assigner_cfg or {}), **(sampler_cfg or {}))
    num_total = (tg.num_total_pos + tg.num_total_neg).float()
    return dict(
        loss_cls=cls_loss(cls_flat, tg.labels, weight=tg.label_weights,
                          avg_factor=num_total),
        loss_bbox=bbox_loss(box_flat, tg.bbox_targets,
                            weight=tg.bbox_weights, avg_factor=num_total))


def rpn_proposals(cls_flat, box_flat, anchors, level_sizes, img_shapes,
                  nms_pre=2000, nms_post=2000, max_num=2000, nms_thr=0.7,
                  min_bbox_size=0.0, target_means=(0., 0., 0., 0.),
                  target_stds=(1., 1., 1., 1.)):
    """Batched fixed-shape proposals.

    Per image and level: top nms_pre by score, decode and clip to the
    image, optional min-size filter, NMS (all (image, level) pairs in
    one batched call, padded to a common k), then at most nms_post per
    level; then the global top max_num.  The reference's approximate
    top-k on the large levels is exact on its CPU backend; this port
    uses an exact top-k everywhere.

    cls_flat [B, A, 1] (sigmoid objectness logits), box_flat [B, A, 4],
    anchors [A, 4],
    img_shapes [B, 2] (h, w).  Returns (boxes [B, max_num, 4],
    scores [B, max_num], valid [B, max_num]).
    """
    k_list = [min(nms_pre, n) if nms_pre > 0 else n for n in level_sizes]
    k_max = max(k_list)
    scores_all = torch.sigmoid(cls_flat[..., 0])
    b = cls_flat.shape[0]
    max_shape = img_shapes[:, None, :]
    lvl_boxes, lvl_scores, lvl_valid = [], [], []
    start = 0
    for n_lvl, k in zip(level_sizes, k_list):
        sl = slice(start, start + n_lvl)
        start += n_lvl
        top_s, top_i = topk(scores_all[:, sl], k)
        a = anchors[sl][top_i]
        d = torch.gather(box_flat[:, sl], 1,
                         top_i[..., None].expand(b, k, 4))
        props = delta2bbox(a, d, target_means, target_stds,
                           max_shape=max_shape)
        valid = torch.ones(b, k, dtype=torch.bool, device=props.device)
        if min_bbox_size > 0:
            w = props[..., 2] - props[..., 0] + 1
            h = props[..., 3] - props[..., 1] + 1
            valid &= (w >= min_bbox_size) & (h >= min_bbox_size)
        if k < k_max:      # pad short levels (P6) to the common k
            pad = k_max - k
            props = torch.cat([props, props.new_zeros(b, pad, 4)], 1)
            top_s = torch.cat([top_s, top_s.new_full((b, pad), NEG_INF)], 1)
            valid = torch.cat([valid, valid.new_zeros(b, pad)], 1)
        lvl_boxes.append(props)
        lvl_scores.append(top_s)
        lvl_valid.append(valid)
    boxes_l = torch.stack(lvl_boxes, 1)            # [B, L, k_max, 4]
    scores_l = torch.stack(lvl_scores, 1)
    valid_l = torch.stack(lvl_valid, 1)
    num_lvls = boxes_l.shape[1]

    # topk output is score-descending with padding last: presorted NMS
    keep = nms(boxes_l, scores_l, nms_thr, valid_l, presorted=True)
    if 0 < nms_post < k_max:
        # kept candidates are still in score order: rank = running count
        rank = torch.cumsum(keep.to(torch.int32), -1) - 1
        keep &= rank < nms_post
    kept_s = torch.where(keep, scores_l, scores_l.new_tensor(NEG_INF))

    all_scores = kept_s.reshape(b, num_lvls * k_max)
    all_boxes = boxes_l.reshape(b, num_lvls * k_max, 4)
    k_out = min(max_num, all_scores.shape[1])
    top_s, top_i = topk(all_scores, k_out)
    out_boxes = torch.gather(all_boxes, 1,
                             top_i[..., None].expand(b, k_out, 4))
    out_valid = top_s > NEG_INF / 2
    return (torch.where(out_valid[..., None], out_boxes,
                        out_boxes.new_zeros(())),
            torch.where(out_valid, top_s, top_s.new_zeros(())), out_valid)
