"""Flattening of dense head outputs, the anchor head's loss, RPN
proposal generation and the single-stage detections.

Port of `flatten_level_outputs`, `anchor_head_loss`, `rpn_proposals`,
`anchor_head_bboxes` and `anchor_head_rboxes` from
`aidet_tpu/models/heads/anchor_head.py`.  Shapes stay fixed: every
image yields `max_num` proposal slots, or `max_per_img` detection
slots, with a validity mask; all images of a batch are solved
together, on the tensors' device.
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

from ...core.anchors import anchor_target
from ...core.boxes import delta2bbox
from ...core.rboxes import RBBOX_CODECS
from ...ops.nms import NEG_INF, multiclass_nms, nms, topk
from ...parallel.dist import global_count


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
                     allowed_border=0.0, pos_weight=-1.0, sampling=True,
                     gt_rboxes=None, rbox_encode=None, global_avg=True):
    """Dense-head loss over flattened predictions: classification and
    regression both averaged by the sampled anchors' count,
    num_total_pos + num_total_neg, or with ``sampling=False`` (the
    focal-loss heads: every anchor weighed) by num_total_pos; the count
    is the global batch's in a data-parallel step (`global_count`),
    unless ``global_avg`` is False (a loss of one image, which its
    caller averages over the images).  The cls loss handles its sigmoid
    or softmax channels itself.
    ``gt_rboxes`` [B, G, D] with ``rbox_encode``: rotated-codec
    regression targets against the anchors (`anchor_target`).

    cls_flat [B, A, C] and box_flat [B, A, D] in the loss's dtype
    (float32 in the detectors).  Returns dict(loss_cls, loss_bbox).
    """
    tg = anchor_target(anchors, gt_boxes, gt_valid, img_shapes, generator,
                       gt_labels=gt_labels, target_means=target_means,
                       target_stds=target_stds,
                       allowed_border=allowed_border, pos_weight=pos_weight,
                       sampling=sampling, gt_rboxes=gt_rboxes,
                       rbox_encode=rbox_encode,
                       **(assigner_cfg or {}), **(sampler_cfg or {}))
    num_total = (tg.num_total_pos + (tg.num_total_neg if sampling
                                     else 0)).float()
    if global_avg:
        num_total = global_count(num_total)
    return dict(
        loss_cls=cls_loss(cls_flat, tg.labels, weight=tg.label_weights,
                          avg_factor=num_total),
        loss_bbox=bbox_loss(box_flat, tg.bbox_targets,
                            weight=tg.bbox_weights, avg_factor=num_total))


def sigmoid(x):
    """1 / (1 + exp(-x)), each operation in x's dtype: the reference's
    sigmoid (XLA's logistic) bit for bit in bfloat16, where
    `torch.sigmoid` rounds once and differs by an ulp in a third of
    the values."""
    return 1.0 / (1.0 + torch.exp(-x))


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
    in the heads' dtype: the scores are computed, ranked and returned
    in cls_flat's dtype, the boxes promote to the anchors' float32;
    anchors [A, 4], or [B, A, 4] for anchors of each image,
    img_shapes [B, 2] (h, w).  Returns (boxes [B, max_num, 4],
    scores [B, max_num], valid [B, max_num]).
    """
    k_list = [min(nms_pre, n) if nms_pre > 0 else n for n in level_sizes]
    k_max = max(k_list)
    scores_all = sigmoid(cls_flat[..., 0])
    b = cls_flat.shape[0]
    max_shape = img_shapes[:, None, :]
    lvl_boxes, lvl_scores, lvl_valid = [], [], []
    start = 0
    for n_lvl, k in zip(level_sizes, k_list):
        sl = slice(start, start + n_lvl)
        start += n_lvl
        top_s, top_i = topk(scores_all[:, sl], k)
        if anchors.dim() == 3:      # each image's own (GA-RPN's guided)
            a = torch.gather(anchors[:, sl], 1,
                             top_i[..., None].expand(b, k, 4))
        else:
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


def topk_per_level(cls_flat, box_flat, anchors, level_sizes, nms_pre):
    """Each image's top ``nms_pre`` anchors of each level by their best
    sigmoid class score (stable: ties to the lower index), levels
    concatenated: (anchors [B, K, 4], deltas [B, K, D], scores [B, K, C])
    with the scores in cls_flat's dtype."""
    scores_all = sigmoid(cls_flat)
    b, d = box_flat.shape[0], box_flat.shape[-1]
    c = scores_all.shape[-1]
    out_a, out_d, out_s = [], [], []
    start = 0
    for n_lvl in level_sizes:
        sl = slice(start, start + n_lvl)
        start += n_lvl
        s = scores_all[:, sl]
        k = min(nms_pre, n_lvl) if nms_pre > 0 else n_lvl
        _, top_i = topk(s.amax(-1), k)
        out_a.append(anchors[sl][top_i])
        out_d.append(torch.gather(box_flat[:, sl], 1,
                                  top_i[..., None].expand(b, k, d)))
        out_s.append(torch.gather(s, 1, top_i[..., None].expand(b, k, c)))
    return torch.cat(out_a, 1), torch.cat(out_d, 1), torch.cat(out_s, 1)


def _with_background(scores):
    """[B, K, C] sigmoid scores with a zero background column at 0, the
    layout of `multiclass_nms`."""
    return torch.cat([scores.new_zeros(scores.shape[:-1] + (1,)), scores],
                     -1)


def anchor_head_bboxes(cls_flat, box_flat, anchors, level_sizes, img_shapes,
                       nms_pre=1000, score_thr=0.05, nms_thr=0.5,
                       max_per_img=100, target_means=(0., 0., 0., 0.),
                       target_stds=(1., 1., 1., 1.), rescale_factors=None,
                       nms_kwargs=None):
    """The single-stage detections (RetinaNet): `topk_per_level`, box
    decode clipped to each image's (h, w) [B, 2], then multiclass NMS of
    the class-agnostic boxes (``nms_kwargs`` from `nms_cfg_kwargs`
    override ``nms_thr``).  With ``rescale_factors`` [B] the boxes are
    divided back to the original images.  Returns an `NMSResult` [B,
    max_per_img]."""
    with record_function("topk_decode"):
        a, d, s = topk_per_level(cls_flat, box_flat, anchors, level_sizes,
                                 nms_pre)
        boxes = delta2bbox(a, d, target_means, target_stds,
                           max_shape=img_shapes[:, None, :])
    nkw = dict(iou_thr=nms_thr)
    nkw.update(nms_kwargs or {})
    with record_function("multiclass_nms"):
        res = multiclass_nms(boxes, _with_background(s), score_thr,
                             max_num=max_per_img, **nkw)
    if rescale_factors is not None:
        res = res._replace(boxes=res.boxes / rescale_factors.to(
            res.boxes).reshape(-1, 1, 1))
    return res


def anchor_head_rboxes(cls_flat, box_flat, anchors, level_sizes,
                       encode="thetaobb", nms_pre=1000, score_thr=0.05,
                       nms_thr=0.1, max_per_img=100, target_means=None,
                       target_stds=None, rescale_factors=None):
    """The rotated single-stage detections (RetinaNetOBB):
    `topk_per_level`, the ``encode`` codec decoded against the
    axis-aligned anchors, then multiclass NMS of the rboxes' quads by
    polygon IoU (``box_dim=8``, each class's top 256 candidates), all on
    the tensors' device; rboxes are not clipped to the image (the
    reference's takes img_shapes and does not read them).  Returns (`NMSResult` with quads [B, K, 8], rboxes [B, K,
    D] at the same keep decisions, zero where invalid); with
    ``rescale_factors`` both are divided back (a thetaobb's theta
    kept)."""
    dim, _, decode, to_quad = RBBOX_CODECS[encode]
    with record_function("topk_decode"):
        a, d, s = topk_per_level(cls_flat, box_flat, anchors, level_sizes,
                                 nms_pre)
        rboxes = decode(a, d, target_means or (0.,) * dim,
                        target_stds or (1.,) * dim)
        quads = to_quad(rboxes)
    with record_function("rotated_nms"):
        res, rboxes = rotated_detections(rboxes, quads, s, score_thr,
                                         nms_thr, max_per_img)
    if rescale_factors is not None:
        sf = rescale_factors.to(res.boxes).reshape(-1, 1, 1)
        res = res._replace(boxes=res.boxes / sf)
        if encode == "thetaobb":
            rboxes = torch.cat([rboxes[..., :4] / sf, rboxes[..., 4:]], -1)
        else:
            rboxes = rboxes / sf
    return res, rboxes


def rotated_detections(rboxes, quads, scores, score_thr, nms_thr,
                       max_per_img):
    """Multiclass NMS of quads [B, K, 8] by polygon IoU with the sigmoid
    scores [B, K, C]; returns the `NMSResult` and the rboxes [B, K, D]
    of its detections (zero where invalid)."""
    res = multiclass_nms(quads, _with_background(scores), score_thr,
                         iou_thr=nms_thr, max_num=max_per_img, box_dim=8)
    roi = res.roi_idx.clamp(0, rboxes.shape[1] - 1)
    out = torch.gather(rboxes, 1, roi[..., None].expand(
        -1, -1, rboxes.shape[-1]))
    return res, torch.where(res.valid[..., None], out, out.new_zeros(()))
