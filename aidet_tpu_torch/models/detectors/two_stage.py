"""Two-stage detector: the RBBoxRCNN and RBBoxRCNNRRoI predict paths
and training losses.

Port of `aidet_tpu/models/detectors/two_stage.py::TwoStageDetector`
for the RBBoxRCNN branch of

- `predict`: uint8 normalize, backbone, FPN, RPN proposals, multi-level
  RoIAlign, SharedFC bbox head, HBB decode and multiclass NMS, then the
  rbbox head on the kept crops only and the rotated decode (thetaobb or
  pointobb) chosen through the NMS keep provenance; with a refinement
  head (RBBoxRCNNRRoI), the selected rboxes are re-cropped by rotated
  RoIAlign (kernel K4 on the card) and refined by rtheta deltas;
- `loss`: the RPN's anchor-target loss, proposals without gradient,
  gt boxes prepended as candidates, MaxIoU assignment and fixed random
  sampling per image, one RoIAlign (kernel K2 on the card) whose crops
  feed both the bbox and the rbbox head, and their losses; with a
  refinement head, the class-selected first-stage rboxes of the
  positive rois are re-cropped by rotated RoIAlign (kernel K4, forward
  and backward, on the card) and the refinement head's rtheta and
  classification losses are added.

The GA-RPN, OHEM and combined samplers, and the grid, semantic,
shared-head and mask branches are not ported.
"""

from __future__ import annotations

import os
from collections.abc import Mapping

import torch
from torch import nn
from torch.profiler import record_function

from ...core.anchors import build_pyramid_anchors
from ...core.assign import max_iou_assign
from ...core.rboxes import (RBBOX_CODECS, delta2rtheta, pointobb2thetaobb,
                            rtheta2delta)
from ...core.sample import sample_fixed
from ...core.targets import bbox_target, rbbox_target
from ...ops.nms import multiclass_nms, select_parallel_rboxes
from ...ops.roi_align import roi_align_bandx_forward, roi_align_forward
from ...ops.rroi_align import rroi_align_forward
from ..heads.anchor_head import (anchor_head_loss, flatten_level_outputs,
                                 rpn_proposals)
from ..heads.bbox_head import (bbox_head_decode, bbox_head_loss,
                               rbbox_head_decode)
from ..losses import CrossEntropyLoss, SmoothL1Loss
from ..preprocess import device_normalize

# the reference's defaults (configs/dota/dota_v002_theta_obb_r50_v1_train.py)
DEFAULT_TRAIN_CFG: dict = dict(
    rpn=dict(pos_iou_thr=0.7, neg_iou_thr=0.3, min_pos_iou=0.3,
             num_samples=256, pos_fraction=0.5, neg_pos_ub=-1,
             allowed_border=0, pos_weight=-1),
    rpn_proposal=dict(nms_pre=2000, nms_post=2000, max_num=2000,
                      nms_thr=0.7, min_bbox_size=0),
    rcnn=dict(pos_iou_thr=0.5, neg_iou_thr=0.5, min_pos_iou=0.5,
              num_samples=512, pos_fraction=0.25, neg_pos_ub=-1,
              pos_weight=-1, sampler="random"),
)

DEFAULT_TEST_CFG: dict = dict(
    rpn=dict(nms_pre=2000, nms_post=2000, max_num=2000, nms_thr=0.7,
             min_bbox_size=0),
    rcnn=dict(score_thr=0.05, nms_thr=0.5, max_per_img=100),
)

RPN_TARGET_STDS = (1.0, 1.0, 1.0, 1.0)
RCNN_TARGET_MEANS = (0.0, 0.0, 0.0, 0.0)
RCNN_TARGET_STDS = (0.1, 0.1, 0.2, 0.2)


def _merge(default: dict, override) -> dict:
    out = {k: dict(v) if isinstance(v, Mapping) else v
           for k, v in default.items()}
    for k, v in (override or {}).items():
        if isinstance(v, Mapping) and isinstance(out.get(k), dict):
            out[k].update(v)
        else:
            out[k] = v
    return out


class TwoStageDetector(nn.Module):
    """RBBoxRCNN: backbone + FPN + RPN + bbox head + rbbox head, and
    with ``rbbox_refine_head`` (an rtheta `RBBoxHead`) RBBoxRCNNRRoI.
    The first-stage rbbox codec (the reference's ``rbbox_encode``) is
    the rbbox head's ``encode``: thetaobb or pointobb.

    compute_dtype: the dtype of `loss`'s convolutions and matrix
    products when it differs from the parameters' (the training build
    keeps float32 parameters and computes in bfloat16, as the
    reference's flax modules with dtype=bfloat16 do); None means the
    parameters' dtype.  `predict` computes in the parameters' dtype.
    """

    # pyramid strides P2..P6; 3 anchors per location (scale 8, ratios
    # 0.5 / 1 / 2), the reference's defaults
    strides = (4, 8, 16, 32, 64)

    def __init__(self, backbone, neck, rpn_head, bbox_head, rbbox_head,
                 img_size=1024, train_cfg=None, test_cfg=None,
                 compute_dtype=None, rbbox_refine_head=None):
        super().__init__()
        self.backbone = backbone
        self.neck = neck
        self.rpn_head = rpn_head
        self.bbox_head = bbox_head
        self.rbbox_head = rbbox_head
        if rbbox_refine_head is not None \
                and rbbox_refine_head.encode != "rtheta":
            raise ValueError("rbbox_refine_head regresses against rotated "
                             "proposals; encode must be 'rtheta'")
        self.rbbox_refine_head = rbbox_refine_head
        self.img_size = img_size
        self.train_cfg = _merge(DEFAULT_TRAIN_CFG, train_cfg)
        self.test_cfg = _merge(DEFAULT_TEST_CFG, test_cfg)
        self.compute_dtype = compute_dtype
        self.rpn_cls_loss = CrossEntropyLoss(use_sigmoid=True)
        self.rpn_bbox_loss = SmoothL1Loss(beta=1.0 / 9.0)
        self.rcnn_cls_loss = CrossEntropyLoss()
        self.rcnn_bbox_loss = SmoothL1Loss(beta=1.0)
        anchors, sizes = build_pyramid_anchors(img_size, self.strides)
        self.register_buffer("anchors", anchors, persistent=False)
        self.level_sizes = sizes

    def _apply(self, fn, recurse=True):
        """Module.to and friends: the anchors follow the device but stay
        float32 in a bfloat16 model, as the reference's, so that the
        proposals decode in float32."""
        super()._apply(fn, recurse)
        if self.anchors.dtype != torch.float32:
            self.anchors = build_pyramid_anchors(
                self.img_size, self.strides)[0].to(self.anchors.device)
        return self

    @property
    def dtype(self):
        return self.bbox_head.fc_cls.weight.dtype

    def extract_feat(self, imgs):
        with record_function("backbone"):
            feats = self.backbone(device_normalize(imgs, dtype=self.dtype))
        with record_function("neck"):
            return self.neck(feats)

    def _roi_features(self, feats, rois_b, out_size, infer=False):
        """Multi-level RoIAlign over the first 4 levels: [B, R, s, s, C].
        On CUDA tensors this launches kernel K1 under no_grad and K2
        (forward, then its backward kernel) when the features need a
        gradient.  ``infer`` on bfloat16 features with AIDET_ROI_BAND=x
        (read at each call, as the reference does) takes K3 instead of
        K1: the same function, reduced from band-chunked rois."""
        levels = [f.contiguous() for f in feats[:4]]
        if (infer and levels[0].dtype == torch.bfloat16
                and os.environ.get("AIDET_ROI_BAND", "1") == "x"):
            return roi_align_bandx_forward(levels, rois_b.float(), out_size,
                                           self.strides[:4])
        return roi_align_forward(levels, rois_b.float(), out_size,
                                 self.strides[:4])

    @torch.no_grad()
    def predict(self, imgs, img_shapes):
        """imgs [B, H, W, 3] (uint8 BGR, or normalized floats),
        img_shapes [B, 2] (h, w).  Returns fixed-size results: boxes
        [B, K, 4], rboxes [B, K, D] (D = 5 thetaobbs, or 8 pointobb
        corners without a refinement head), and scores, labels (0-based,
        -1 if invalid) and valid [B, K].
        Heads run in the model's dtype, and so do the sigmoid and softmax
        scores, their ranking (stable, ties to the lower index) and the
        returned ``scores``, as in the reference; box decodes promote to
        float32 against the float32 anchors and proposals.
        Each stage is a `torch.profiler.record_function` span (read by
        tools/torch_profile_predict.py; no cost beyond the call when no
        profiler runs)."""
        ec = self.test_cfg
        img_shapes = img_shapes.float()
        feats = self.extract_feat(imgs)
        with record_function("rpn_head"):
            rpn_cls, rpn_reg = self.rpn_head(feats)
        with record_function("rpn_proposals"):
            cls_flat, reg_flat = flatten_level_outputs(
                rpn_cls, rpn_reg, self.rpn_head.cls_out_channels)
            props, _, prop_valid = rpn_proposals(
                cls_flat, reg_flat, self.anchors, self.level_sizes,
                img_shapes, target_stds=RPN_TARGET_STDS, **ec["rpn"])

        b, p = props.shape[:2]
        with record_function("roi_align"):
            crops = self._roi_features(feats, props,
                                       self.bbox_head.roi_feat_size,
                                       infer=True)
        with record_function("bbox_head"):
            cls_score, bbox_pred = self.bbox_head(
                crops.reshape((b * p,) + crops.shape[2:]))
        rc = ec["rcnn"]
        with record_function("bbox_decode_nms"):
            boxes, scores = bbox_head_decode(
                props, cls_score.reshape(b, p, -1),
                bbox_pred.reshape(b, p, -1), RCNN_TARGET_MEANS,
                RCNN_TARGET_STDS, img_shape=img_shapes[:, None, :])
            dets = multiclass_nms(boxes, scores, rc["score_thr"],
                                  iou_thr=rc["nms_thr"],
                                  max_num=rc["max_per_img"],
                                  valid=prop_valid)
        out = dict(boxes=dets.boxes, scores=dets.scores,
                   labels=dets.labels, valid=dets.valid)

        # the parallel rbbox decode only reads the rows the HBB NMS
        # kept, so the rbbox head runs on those K crops alone
        with record_function("rbbox_head"):
            k = dets.boxes.shape[1]
            bi = torch.arange(b, device=props.device)[:, None]
            roi = dets.roi_idx.clamp(0, p - 1)
            kcrops = crops[bi, roi]
            _, rreg = self.rbbox_head(
                kcrops.reshape((b * k,) + kcrops.shape[2:]))
            rboxes, _ = rbbox_head_decode(
                props[bi, roi], rreg.new_zeros(b, k, 1),
                rreg.reshape(b, k, -1), self.rbbox_head.encode)
            local = dets._replace(roi_idx=torch.arange(
                k, device=props.device).expand(b, k))
            out["rboxes"] = select_parallel_rboxes(
                rboxes, local, self.rbbox_head.out_dim_reg)
        if self.rbbox_refine_head is not None:
            with record_function("rroi_refine"):
                out["rboxes"] = self._refine(feats, out["rboxes"], dets)
        return out

    def _clip_rboxes(self, rb):
        """Thetaobbs [..., 5] with w and h clipped to [2, img_size]:
        sane geometry for the rotated crop."""
        return torch.cat([rb[..., :2], rb[..., 2:4].clamp(2.0, self.img_size),
                          rb[..., 4:]], -1)

    def _refine(self, feats, rboxes, dets):
        """The rotated-RoI refinement of RBBoxRCNNRRoI's predict
        (reference two_stage.py:1052-1086): the selected first-stage
        rboxes as thetaobbs, w and h clipped to [2, img_size], re-cropped
        by rotated RoIAlign over the first 4 levels in the model's
        dtype (kernel K4 on the card), the refinement head's rtheta
        deltas of each detection's class (group labels + 1) applied to
        them, invalid rows zero."""
        rb = rboxes
        if self.rbbox_head.encode == "pointobb":
            rb = pointobb2thetaobb(rb)
        rb = self._clip_rboxes(rb)
        head = self.rbbox_refine_head
        b, k = rb.shape[:2]
        with record_function("rroi_align"):
            rcrops = rroi_align_forward(
                [f.contiguous() for f in feats[:4]], rb.float(),
                head.roi_feat_size, self.strides[:4])
        _, ref_reg = head(rcrops.reshape((b * k,) + rcrops.shape[2:]))
        d2 = head.out_dim_reg
        grp = ref_reg.reshape(b, k, -1, d2)
        cls = (dets.labels + 1).clamp(0, grp.shape[2] - 1)
        ref_sel = torch.gather(
            grp, 2, cls[..., None, None].expand(b, k, 1, d2))[:, :, 0]
        refined = delta2rtheta(rb, ref_sel)
        return torch.where(dets.valid[..., None], refined,
                           refined.new_zeros(()))

    def _mixed_precision(self, device):
        """Autocast to ``compute_dtype`` (convolutions and linears in it,
        parameters kept as they are), or nothing when it is the
        parameters' dtype."""
        cd = self.compute_dtype or self.dtype
        return torch.autocast(torch.device(device).type, dtype=cd,
                              enabled=cd != self.dtype)

    def loss(self, imgs, gt_boxes, gt_valid, gt_labels, img_shapes,
             gt_rboxes, generator: torch.Generator):
        """The RBBoxRCNN and RBBoxRCNNRRoI training loss (reference:
        `loss`, two_stage.py:367-760, without its other optional
        branches).

        imgs [B, S, S, 3] (uint8 BGR or normalized floats); gt_boxes
        [B, G, 4]; gt_valid [B, G]; gt_labels [B, G] (1-based);
        img_shapes [B, 2] (h, w); gt_rboxes [B, G, D] in the rbbox
        head's encode: thetaobbs [B, G, 5] or pointobbs [B, G, 8].
        Sampling draws from ``generator`` (on the images' device): the
        RPN's positives and negatives, then the RoI sample's.
        Returns float32 scalars: loss_rpn_cls, loss_rpn_bbox, loss_cls,
        loss_bbox, loss_rbbox_cls, loss_rbbox, and with a refinement
        head loss_rbbox_refine and loss_rbbox_refine_cls (`_refine_loss`).

        Mixed precision: the backbone, FPN, RPN head and RoI heads run
        under `_mixed_precision`; the heads' outputs are cast to float32
        and every loss computes in float32.
        Each stage is a `torch.profiler.record_function` span (read by
        tools/torch_profile_train.py).
        """
        tc = self.train_cfg
        rc = tc["rcnn"]
        if rc.get("sampler", "random") != "random":
            raise NotImplementedError(f"rcnn sampler {rc['sampler']!r} "
                                      "is not ported; 'random' is")
        img_shapes = img_shapes.float()
        gt_boxes = gt_boxes.float()
        b = imgs.shape[0]
        amp = self._mixed_precision(imgs.device)
        with amp:
            feats = self.extract_feat(imgs)
            with record_function("rpn_head"):
                rpn_cls, rpn_reg = self.rpn_head(feats)
        cls_flat, reg_flat = flatten_level_outputs(
            rpn_cls, rpn_reg, self.rpn_head.cls_out_channels)
        cls_flat, reg_flat = cls_flat.float(), reg_flat.float()

        rpn = tc["rpn"]
        with record_function("rpn_loss"):
            rpn_losses = anchor_head_loss(
                cls_flat, reg_flat, self.anchors, gt_boxes, gt_valid,
                img_shapes, generator, target_stds=RPN_TARGET_STDS,
                cls_loss=self.rpn_cls_loss, bbox_loss=self.rpn_bbox_loss,
                assigner_cfg=dict(pos_iou_thr=rpn["pos_iou_thr"],
                                  neg_iou_thr=rpn["neg_iou_thr"],
                                  min_pos_iou=rpn["min_pos_iou"]),
                sampler_cfg=dict(num_samples=rpn["num_samples"],
                                 pos_fraction=rpn["pos_fraction"],
                                 neg_pos_ub=rpn["neg_pos_ub"]),
                allowed_border=rpn["allowed_border"],
                pos_weight=rpn["pos_weight"])
        losses = dict(loss_rpn_cls=rpn_losses["loss_cls"],
                      loss_rpn_bbox=rpn_losses["loss_bbox"])

        # proposals carry no gradient, as in the reference
        with torch.no_grad(), record_function("rpn_proposals"):
            props, _, prop_valid = rpn_proposals(
                cls_flat, reg_flat, self.anchors, self.level_sizes,
                img_shapes, target_stds=RPN_TARGET_STDS,
                **tc["rpn_proposal"])

        # the gt boxes join the proposals as candidates
        with record_function("rcnn_sample"):
            cand = torch.cat([gt_boxes, props], 1)
            cand_valid = torch.cat([gt_valid, prop_valid], 1)
            res = max_iou_assign(cand, gt_boxes, gt_valid, None,
                                 pos_iou_thr=rc["pos_iou_thr"],
                                 neg_iou_thr=rc["neg_iou_thr"],
                                 min_pos_iou=rc["min_pos_iou"],
                                 box_valid=cand_valid)
            sample = sample_fixed(res.gt_inds, rc["num_samples"],
                                  rc["pos_fraction"], generator,
                                  rc["neg_pos_ub"])
        r = rc["num_samples"]
        if sample.inds.shape[1] != r:
            # sample_fixed returns min(num_samples, candidates) rows; the
            # reference reshapes by num_samples, which then fails too
            raise ValueError(f"rcnn num_samples {r} exceeds the "
                             f"{cand.shape[1]} candidates (gts + "
                             "rpn_proposal max_num)")
        rois = torch.gather(cand, 1, sample.inds[..., None].expand(-1, -1, 4))

        # one RoIAlign: both heads read the same crops, so the step has
        # one K2 forward and one K2 backward launch
        with record_function("roi_align"):
            crops = self._roi_features(feats, rois,
                                       self.bbox_head.roi_feat_size)
        crops = crops.reshape((b * r,) + crops.shape[2:])
        with amp, record_function("roi_heads"):
            cls_score, bbox_pred = self.bbox_head(crops)
            rcls, rreg = self.rbbox_head(crops)

        def flat(t):
            return t._make(x.reshape((b * r,) + x.shape[2:]) for x in t)

        tgt = flat(bbox_target(sample, rois, gt_boxes, gt_labels,
                               RCNN_TARGET_MEANS, RCNN_TARGET_STDS,
                               rc["pos_weight"]))
        losses["loss_cls"], losses["loss_bbox"] = bbox_head_loss(
            cls_score.float(), bbox_pred.float(), tgt,
            self.rcnn_cls_loss, self.rcnn_bbox_loss)
        rtgt = flat(rbbox_target(sample, rois, gt_rboxes.float(), gt_labels,
                                 self.rbbox_head.encode,
                                 pos_weight=rc["pos_weight"]))
        losses["loss_rbbox_cls"], losses["loss_rbbox"] = bbox_head_loss(
            rcls.float(), rreg.float(), rtgt, self.rcnn_cls_loss,
            self.rcnn_bbox_loss, box_dim=self.rbbox_head.out_dim_reg)
        if self.rbbox_refine_head is not None:
            with record_function("rroi_refine"):
                losses.update(self._refine_loss(
                    feats, rois, rreg.float().reshape(b, r, -1), sample,
                    gt_rboxes.float(), gt_labels, amp))
        return losses

    def _refine_loss(self, feats, rois, rreg, sample, gt_rboxes, gt_labels,
                     amp):
        """The rotated-RoI refinement's losses (reference two_stage.py:
        683-760).  The first p_max = int(num_samples * pos_fraction)
        sampled rois (the positives come first) are decoded by the first
        stage at their target labels (rreg [B, R, C * D]), as thetaobbs
        without gradient, w and h clipped to [2, img_size]; rotated
        RoIAlign re-crops them from the first 4 levels in the model's
        compute dtype (kernel K4 on the card, its backward kernel in the
        backward pass), and the refinement head regresses rtheta deltas
        against the matched gts (converted to thetaobbs) and classifies.
        loss_rbbox_refine: smooth L1 (beta 1) summed over the 5 deltas of
        the positives, over their count (at least 1);
        loss_rbbox_refine_cls: CE at the labels (0 off the positives)
        over the valid samples of those rows."""
        rc = self.train_cfg["rcnn"]
        b, r = rois.shape[:2]
        p_max = int(rc["num_samples"] * rc["pos_fraction"])
        g = gt_labels.shape[1]
        first, head = self.rbbox_head, self.rbbox_refine_head
        lbl = torch.where(sample.is_pos, torch.gather(
            gt_labels.long(), 1, sample.gt_inds.clamp(0, g - 1)), 0)
        grp = rreg.reshape(b, r, -1, first.out_dim_reg)
        cls = lbl.clamp(0, grp.shape[2] - 1)
        sel = torch.gather(grp, 2, cls[..., None, None].expand(
            b, r, 1, first.out_dim_reg))[:, :, 0]
        dec = RBBOX_CODECS[first.encode][2](rois, sel)
        if first.encode == "pointobb":
            dec = pointobb2thetaobb(dec)
        stage1 = self._clip_rboxes(dec[:, :p_max].detach())

        with record_function("rroi_align"):
            rcrops = rroi_align_forward(
                [f.contiguous() for f in feats[:4]], stage1,
                head.roi_feat_size, self.strides[:4])
        with amp:
            ref_cls, ref_reg = head(
                rcrops.reshape((b * p_max,) + rcrops.shape[2:]))
        ref_cls, ref_reg = ref_cls.float(), ref_reg.float()

        pos = sample.is_pos[:, :p_max]
        gt_inds = sample.gt_inds[:, :p_max].clamp(0, g - 1)
        gtm = torch.gather(gt_rboxes, 1, gt_inds[..., None].expand(
            -1, -1, gt_rboxes.shape[-1]))
        if first.encode == "pointobb":
            gtm = pointobb2thetaobb(gtm)
        target = rtheta2delta(stage1, gtm).reshape(b * p_max, -1)
        is_pos = pos.reshape(-1).float()
        lbl_pos = lbl[:, :p_max].reshape(-1)
        d2 = head.out_dim_reg
        grp2 = ref_reg.reshape(b * p_max, -1, d2)
        ref_sel = torch.gather(grp2, 1, lbl_pos.clamp(
            0, grp2.shape[1] - 1)[:, None, None].expand(-1, 1, d2))[:, 0]
        diff = ref_sel - target
        sl1 = torch.where(diff.abs() < 1.0, 0.5 * diff * diff,
                          diff.abs() - 0.5)
        npos = is_pos.sum().clamp(min=1.0)
        ce = -torch.log_softmax(ref_cls, -1).gather(
            1, lbl_pos[:, None])[:, 0]
        lw = sample.valid[:, :p_max].reshape(-1).float()
        return dict(
            loss_rbbox_refine=(sl1.sum(-1) * is_pos).sum() / npos,
            loss_rbbox_refine_cls=(ce * lw).sum() / lw.sum().clamp(min=1.0))
