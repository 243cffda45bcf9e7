"""Cascade R-CNN and the Hybrid Task Cascade.

Port of `aidet_tpu/models/detectors/cascade.py` (`CascadeRCNN` :49-460,
`HTC` :462-472; parity: mmdet's cascade_rcnn.py and htc.py) without its
C4 shared head:

- three RoI stages at IoU thresholds `STAGE_IOU_THRS`, each with its
  own class-agnostic box head, its loss weight and its target stds;
  each stage assigns and samples its candidates (the gts, then the
  previous stage's boxes), and the boxes it refines, decoded by
  `delta2bbox` and clipped to the image without gradient, are the next
  stage's candidates;
- at test time the stages' softmax scores are averaged, and the last
  stage's regression is decoded with the last stds (the reference's
  `STAGE_TARGET_STDS[-1]`, also with fewer stages);
- a mask branch: one `FCNMaskHead` trained on the last stage's sample
  (Cascade Mask R-CNN), or, for HTC, one `HTCMaskHead` per stage,
  trained interleaved (on the boxes its stage refined, re-sampled) with
  the mask information flow (each head's trunk fed the earlier heads'
  chain through ``conv_res``), the masks of all stages sigmoided and
  averaged at test time;
- HTC's semantic branch (`FusedSemanticHead`): its map at
  ``semantic_level`` (1, stride 8) cropped by a single-level RoIAlign
  and added to the box crops and the mask crops, and its segmentation
  loss ``loss_semantic_seg``.

Every RoI crop is `AnchorDetector._roi_features` (the semantic one
`_fuse_semantic`): on the card, K1 at predict (one launch per stage,
one for the masks, and as many for the semantic map), K2's forward and
backward in training.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.profiler import record_function

from ...core.assign import max_iou_assign
from ...core.boxes import delta2bbox
from ...core.sample import sample_fixed
from ...core.targets import bbox_target, mask_target
from ...ops.nms import multiclass_nms, nms_cfg_kwargs
from ..heads.bbox_head import bbox_head_loss, softmax
from ..heads.semantic_head import semantic_loss
from ..losses import CrossEntropyLoss, SmoothL1Loss, mask_cross_entropy
from .two_stage import (DEFAULT_TEST_CFG, DEFAULT_TRAIN_CFG, MASK_ROI_SIZE,
                        RCNN_TARGET_MEANS, AnchorDetector, _dq, _merge)

STAGE_IOU_THRS = (0.5, 0.6, 0.7)
STAGE_LOSS_WEIGHTS = (1.0, 0.5, 0.25)
STAGE_TARGET_STDS = ((0.1, 0.1, 0.2, 0.2),
                     (0.05, 0.05, 0.1, 0.1),
                     (0.033, 0.033, 0.067, 0.067))


class CascadeRCNN(AnchorDetector):
    """``bbox_heads``: one class-agnostic box head per stage;
    ``mask_heads``: None, one head (Cascade Mask R-CNN), or one per
    stage with ``per_stage_masks`` (HTC, with ``interleaved`` and
    ``mask_info_flow``); ``semantic_head``: None or HTC's
    `FusedSemanticHead`, fused into the crops named in
    ``semantic_fusion`` ("bbox", "mask")."""

    def __init__(self, backbone, neck, rpn_head, bbox_heads, mask_heads=None,
                 semantic_head=None, per_stage_masks=False,
                 interleaved=False, mask_info_flow=False,
                 semantic_fusion=("bbox", "mask"), semantic_level=1,
                 img_size=1024, train_cfg=None, test_cfg=None,
                 compute_dtype=None):
        super().__init__(backbone, neck, rpn_head, img_size, compute_dtype)
        self.bbox_heads = nn.ModuleList(bbox_heads)
        self.num_stages = len(bbox_heads)
        if self.num_stages > len(STAGE_IOU_THRS):
            raise ValueError(f"{self.num_stages} stages: the cascade's "
                             f"constants cover {len(STAGE_IOU_THRS)}")
        self.mask_heads = nn.ModuleList(mask_heads) if mask_heads else None
        self.semantic_head = semantic_head
        self.per_stage_masks = per_stage_masks
        self.interleaved = interleaved
        self.mask_info_flow = mask_info_flow
        self.semantic_fusion = tuple(semantic_fusion)
        self.semantic_level = semantic_level
        self.train_cfg = _merge(DEFAULT_TRAIN_CFG, train_cfg)
        self.test_cfg = _merge(DEFAULT_TEST_CFG, test_cfg)
        self.rcnn_cls_loss = CrossEntropyLoss()
        self.rcnn_bbox_loss = SmoothL1Loss(beta=1.0)

    def _crops(self, feats, sem_feat, rois, out_size, branch, infer=False):
        """The RoI crops [B, R, s, s, C], with the semantic map fused in
        where ``branch`` ("bbox" or "mask") is in semantic_fusion."""
        crops = self._roi_features(feats, rois, out_size, infer=infer)
        if sem_feat is not None and branch in self.semantic_fusion:
            crops = self._fuse_semantic(crops, sem_feat, rois, out_size)
        return crops

    def _mask_forward(self, stage, x):
        """The mask logits of stage ``stage``'s head on crops x [N, s, s,
        C]; with the information flow, the earlier heads' trunks first
        build its input chain (reference :144-160)."""
        if not (self.mask_info_flow and self.per_stage_masks):
            out = self.mask_heads[min(stage, len(self.mask_heads) - 1)](x)
            return out[0] if isinstance(out, tuple) else out
        last = None
        for j in range(stage):
            last = self.mask_heads[j](x, last, return_logits=False,
                                      return_feat=True)
        return self.mask_heads[stage](x, last, return_logits=True,
                                      return_feat=False)

    def _sample_stage(self, cand, cand_valid, gt_boxes, gt_valid, thr,
                      generator):
        """Assign the candidates at IoU ``thr`` (positive, negative and
        min_pos_iou alike) and take the fixed sample: (sample, rois [B,
        num_samples, 4])."""
        rc = self.train_cfg["rcnn"]
        res = max_iou_assign(cand, gt_boxes, gt_valid, None,
                             pos_iou_thr=thr, neg_iou_thr=thr,
                             min_pos_iou=thr, box_valid=cand_valid)
        sample = sample_fixed(res.gt_inds, rc["num_samples"],
                              rc["pos_fraction"], generator,
                              rc["neg_pos_ub"])
        if sample.inds.shape[1] != rc["num_samples"]:
            raise ValueError(f"rcnn num_samples {rc['num_samples']} exceeds "
                             f"the {cand.shape[1]} candidates of a stage")
        rois = torch.gather(cand, 1, sample.inds[..., None].expand(-1, -1, 4))
        return sample, rois

    def _mask_loss_stage(self, stage, feats, sem_feat, sample, rois,
                         gt_masks, gt_labels, amp):
        """The mask BCE of ``stage``'s head (reference :206-235) on the
        first p_max = int(num_samples * pos_fraction) sampled rois (the
        positives come first) at 14x14, against `mask_target` of the gt
        masks; rois that are not positive weigh 0, the average is over
        max(#positives, 1) * S^2."""
        rc = self.train_cfg["rcnn"]
        b = rois.shape[0]
        p_max = int(rc["num_samples"] * rc["pos_fraction"])
        pos_rois = rois[:, :p_max]
        pos = sample._make(x[:, :p_max] for x in sample)
        mcrops = self._crops(feats, sem_feat, pos_rois, MASK_ROI_SIZE, "mask")
        with amp:
            pred = self._mask_forward(
                stage, mcrops.reshape((b * p_max,) + mcrops.shape[2:]))
        pred = pred.float()
        msize = pred.shape[1]
        tgt = mask_target(pos, pos_rois * (gt_masks.shape[-1] / self.img_size),
                          gt_masks, msize).reshape(b * p_max, msize, msize)
        g = gt_labels.shape[1]
        labels = torch.where(pos.is_pos, torch.gather(
            gt_labels.long(), 1, pos.gt_inds.clamp(0, g - 1)), 0).reshape(-1)
        is_pos = pos.is_pos.reshape(-1).float()
        navg = is_pos.sum().clamp(min=1.0) * msize ** 2
        return mask_cross_entropy(pred, tgt, labels,
                                  weight=is_pos[:, None, None],
                                  avg_factor=navg)

    def loss(self, imgs, gt_boxes, gt_valid, gt_labels, img_shapes,
             gt_masks=None, gt_semantic=None,
             generator: torch.Generator = None):
        """The cascade's training losses (reference :237-376): the RPN's
        (loss_rpn_cls, loss_rpn_bbox), each stage's s{i}.loss_cls and
        s{i}.loss_bbox (times its stage weight; the regression averaged
        by the count of sampled rois), with masks s{i}.loss_mask (HTC)
        or loss_mask (on the last stage's sample), with a semantic head
        and gt_semantic [B, Hs, Ws] loss_semantic_seg.  Inputs as
        `TwoStageDetector.loss`'s; gt_masks [B, G, Hm, Wm] may be uint8
        quantized.  Sampling draws from ``generator``: the RPN's, then
        each stage's (and its interleaved mask sample's) in turn."""
        if generator is None:
            raise TypeError("loss needs the sampling generator")
        gt_masks = _dq(gt_masks)
        tc = self.train_cfg
        rc = tc["rcnn"]
        img_shapes = img_shapes.float()
        gt_boxes = gt_boxes.float()
        b, r = imgs.shape[0], rc["num_samples"]
        feats, cls_flat, reg_flat, losses, amp = self._rpn_loss(
            imgs, gt_boxes, gt_valid, img_shapes, generator, tc["rpn"])
        props, _, prop_valid = self._proposals(cls_flat, reg_flat,
                                               img_shapes, tc["rpn_proposal"])
        sem_feat = None
        if self.semantic_head is not None:
            sh = self.semantic_head
            with amp, record_function("semantic_head"):
                seg_logits, sem_feat = sh(feats)
            if gt_semantic is not None:
                losses["loss_semantic_seg"] = semantic_loss(
                    seg_logits.float(), gt_semantic,
                    loss_weight=getattr(sh, "loss_weight", 0.2),
                    use_focal=getattr(sh, "use_focal", False))
        masks = self.mask_heads is not None and gt_masks is not None
        cur, cur_valid = props, prop_valid
        for stage, head in enumerate(self.bbox_heads):
            thr, lw = STAGE_IOU_THRS[stage], STAGE_LOSS_WEIGHTS[stage]
            stds = STAGE_TARGET_STDS[stage]
            with record_function("rcnn_sample"):
                sample, rois = self._sample_stage(
                    torch.cat([gt_boxes, cur], 1),
                    torch.cat([gt_valid, cur_valid], 1), gt_boxes, gt_valid,
                    thr, generator)
            with record_function("roi_align"):
                crops = self._crops(feats, sem_feat, rois,
                                    head.roi_feat_size, "bbox")
            with amp, record_function("roi_heads"):
                cls_score, bbox_pred = head(
                    crops.reshape((b * r,) + crops.shape[2:]))
            tgt = bbox_target(sample, rois, gt_boxes, gt_labels,
                              RCNN_TARGET_MEANS, stds, rc["pos_weight"])
            tgt = tgt._make(x.reshape((b * r,) + x.shape[2:]) for x in tgt)
            loss_cls, loss_bbox = bbox_head_loss(
                cls_score.float(), bbox_pred.float(), tgt,
                self.rcnn_cls_loss, self.rcnn_bbox_loss,
                reg_class_agnostic=True)
            losses[f"s{stage}.loss_cls"] = lw * loss_cls
            losses[f"s{stage}.loss_bbox"] = lw * loss_bbox
            last = stage == self.num_stages - 1
            refined = None
            if not last or (masks and self.interleaved):
                refined = delta2bbox(
                    rois, bbox_pred.detach().float().reshape(b, r, -1),
                    RCNN_TARGET_MEANS, stds, max_shape=img_shapes[:, None, :])
            if masks and self.per_stage_masks:
                msample, mrois = sample, rois
                if self.interleaved:
                    # the mask trains on the boxes this stage refined,
                    # assigned and sampled again (reference :288-297)
                    msample, mrois = self._sample_stage(
                        torch.cat([gt_boxes, refined], 1),
                        torch.cat([gt_valid, sample.valid], 1), gt_boxes,
                        gt_valid, thr, generator)
                with record_function("mask_loss"):
                    losses[f"s{stage}.loss_mask"] = lw * \
                        self._mask_loss_stage(stage, feats, sem_feat,
                                              msample, mrois, gt_masks,
                                              gt_labels, amp)
            if not last:
                cur, cur_valid = refined, sample.valid
        if masks and not self.per_stage_masks:
            with record_function("mask_loss"):
                losses["loss_mask"] = self._mask_loss_stage(
                    0, feats, sem_feat, sample, rois, gt_masks, gt_labels,
                    amp)
        return losses

    @torch.no_grad()
    def predict(self, imgs, img_shapes, scale_factors=None):
        """The cascade's detections (reference :378-460): boxes [B, K,
        4], scores, labels (0-based, -1 if invalid) and valid [B, K];
        with masks, masks [B, K, 28, 28] (every mask head's sigmoid at
        the detection's class, averaged; in the crop's frame).  The
        boxes are divided by ``scale_factors`` [B] when given."""
        ec = self.test_cfg
        img_shapes = img_shapes.float()
        feats = self.extract_feat(imgs)
        cls_flat, reg_flat = self._rpn_outputs(feats)
        props, _, prop_valid = self._proposals(cls_flat, reg_flat,
                                               img_shapes, ec["rpn"])
        b, p = props.shape[:2]
        max_shape = img_shapes[:, None, :]
        sem_feat = None
        if self.semantic_head is not None:
            with record_function("semantic_head"):
                sem_feat = self.semantic_head(feats)[1]
        rois, scores = props, []
        for stage, head in enumerate(self.bbox_heads):
            with record_function("roi_align"):
                crops = self._crops(feats, sem_feat, rois,
                                    head.roi_feat_size, "bbox", infer=True)
            with record_function("bbox_head"):
                cls_score, bbox_pred = head(
                    crops.reshape((b * p,) + crops.shape[2:]))
            scores.append(softmax(cls_score.reshape(b, p, -1)))
            bbox_pred = bbox_pred.reshape(b, p, -1)
            if stage < self.num_stages - 1:
                rois = delta2bbox(rois, bbox_pred, RCNN_TARGET_MEANS,
                                  STAGE_TARGET_STDS[stage],
                                  max_shape=max_shape)
        rc = ec["rcnn"]
        with record_function("bbox_decode_nms"):
            boxes = delta2bbox(rois, bbox_pred, RCNN_TARGET_MEANS,
                               STAGE_TARGET_STDS[-1], max_shape=max_shape)
            dets = multiclass_nms(boxes, sum(scores) / self.num_stages,
                                  rc["score_thr"], max_num=rc["max_per_img"],
                                  valid=prop_valid, **nms_cfg_kwargs(rc))
        out = dict(boxes=dets.boxes, scores=dets.scores,
                   labels=dets.labels, valid=dets.valid)
        if self.mask_heads is not None:
            with record_function("mask_head"):
                out["masks"] = self._predict_masks(feats, sem_feat, dets)
        if scale_factors is not None:
            out["boxes"] = out["boxes"] / scale_factors.to(
                out["boxes"]).reshape(-1, 1, 1)
        return out

    def _predict_masks(self, feats, sem_feat, dets):
        """The detections' boxes cropped at 14x14 (K1 on the card), every
        mask head's sigmoid (with the information flow, each head fed
        the chain of the ones before), averaged, at each detection's
        label's channel: [B, K, S, S]."""
        det_rois = dets.boxes[..., :4]
        b, k = det_rois.shape[:2]
        mcrops = self._crops(feats, sem_feat, det_rois, MASK_ROI_SIZE,
                             "mask", infer=True)
        x = mcrops.reshape((b * k,) + mcrops.shape[2:])
        n = len(self.mask_heads) if self.per_stage_masks else 1
        probs, last = [], None
        for stage in range(n):
            head = self.mask_heads[stage]
            if self.mask_info_flow and self.per_stage_masks:
                logits, last = head(x, last, return_logits=True,
                                    return_feat=True)
            else:
                logits = head(x)
                logits = logits[0] if isinstance(logits, tuple) else logits
            probs.append(torch.sigmoid(logits))
        merged = sum(probs) / len(probs)
        lbl = dets.labels.reshape(-1).long().clamp(0, merged.shape[-1] - 1)
        sel = torch.gather(merged, -1, lbl[:, None, None, None].expand(
            merged.shape[:-1] + (1,)))[..., 0]
        return sel.reshape((b, k) + sel.shape[1:])
