"""FreeAnchor's bag-of-anchors likelihood loss for RetinaNet.

Port of `aidet_tpu/models/heads/free_anchor.py::free_anchor_loss` :27
(parity: mmdet's free_anchor_retina_head.py:35-188), batched over
images: each valid gt's bag is its ``pre_anchor_topk`` anchors of
highest IoU (a stable sort: ties to the lower index, as the reference's
top_k); the positive bag likelihood weighs each anchor's class x box
probability by 1 / (1 - p) (a smooth max); the negative term is a focal
penalty on every anchor's class probability times the chance that the
anchor is no object's of that class, the per-class max over the gts of
the predicted boxes' IoU ramp (no gradient).
"""

from __future__ import annotations

import torch

from ...core.boxes import bbox2delta, bbox_overlaps, delta2bbox
from ...ops.nms import topk
from ...parallel.dist import global_count


def _smooth_l1(x, beta):
    ax = x.abs()
    return torch.where(ax < beta, 0.5 * ax * ax / beta, ax - 0.5 * beta)


def free_anchor_loss(cls_flat, box_flat, anchors, gt_boxes, gt_valid,
                     gt_labels, target_means=(0., 0., 0., 0.),
                     target_stds=(1., 1., 1., 1.), pre_anchor_topk=50,
                     bbox_thr=0.6, gamma=2.0, alpha=0.5, smoothl1_beta=0.11,
                     bbox_loss_weight=0.75):
    """cls_flat [B, A, C] sigmoid logits (C foreground classes), box_flat
    [B, A, 4] deltas, anchors [A, 4]; gt_boxes [B, G, 4], gt_valid [B,
    G], gt_labels [B, G] (1-based).  Returns dict(positive_bag_loss,
    negative_bag_loss), the first over the valid gts, the second over
    them times ``pre_anchor_topk``."""
    b, a, c = cls_flat.shape
    g = gt_boxes.shape[1]
    valid = gt_valid.bool()
    cls_prob = torch.sigmoid(cls_flat)
    lbl0 = (gt_labels.long() - 1).clamp(0, c - 1)            # [B, G]
    zero = cls_flat.new_zeros(())
    with torch.no_grad():
        pred = delta2bbox(anchors.expand(b, -1, -1), box_flat,
                          target_means, target_stds)
        obj_iou = torch.where(valid[..., None],
                              bbox_overlaps(gt_boxes, pred), zero)
        t2 = obj_iou.amax(-1, keepdim=True).clamp(min=bbox_thr + 1e-12)
        obj_prob = ((obj_iou - bbox_thr) / (t2 - bbox_thr)).clamp(0.0, 1.0)
        obj_prob = torch.where(valid[..., None], obj_prob, zero)
        # the max over the gts of each class, at least 0
        image_prob = cls_flat.new_zeros(b, c, a).scatter_reduce(
            1, lbl0[..., None].expand(b, g, a), obj_prob, reduce="amax",
            include_self=True).transpose(1, 2)               # [B, A, C]

    qual = bbox_overlaps(gt_boxes, anchors.expand(b, -1, -1))
    matched = topk(qual, pre_anchor_topk)[1]                 # [B, G, K]
    bi = torch.arange(b, device=cls_flat.device)[:, None, None]
    m_cls = cls_prob[bi, matched]                            # [B, G, K, C]
    m_cls_prob = torch.gather(m_cls, -1, lbl0[..., None, None].expand(
        b, g, pre_anchor_topk, 1))[..., 0]
    m_anchors = anchors[matched]                             # [B, G, K, 4]
    m_targets = bbox2delta(m_anchors, gt_boxes[:, :, None].expand_as(
        m_anchors), target_means, target_stds)
    l_bbox = bbox_loss_weight * _smooth_l1(
        box_flat[bi, matched] - m_targets, smoothl1_beta).sum(-1)
    m_prob = m_cls_prob * torch.exp(-l_bbox)
    w = 1.0 / (1.0 - m_prob).clamp(min=1e-12)
    w = w / w.sum(-1, keepdim=True)
    bag_prob = (w * m_prob).sum(-1)                          # [B, G]
    pos = alpha * -torch.log(bag_prob.clamp(1e-12, 1.0))
    pos = torch.where(valid, pos, zero).sum()

    neg_prob = cls_prob * (1.0 - image_prob)
    neg = (1.0 - alpha) * (neg_prob ** gamma * -torch.log(
        (1.0 - neg_prob).clamp(1e-12, 1.0))).sum()
    num_pos = global_count(valid.sum()).clamp(min=1).float()
    return dict(positive_bag_loss=pos / num_pos,
                negative_bag_loss=neg / (num_pos * pre_anchor_topk))
