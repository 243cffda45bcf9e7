"""Two-stage detector: the FasterRCNN, FastRCNN, MaskRCNN, RBBoxRCNN,
RBBoxRCNNRRoI, MaskOBB, CenterMapOBB and CenterMap-Net predict paths
and training losses, and `AnchorDetector`, the parts that the RPN, the
two-stage detectors and the cascades share.

Port of `aidet_tpu/models/detectors/two_stage.py::TwoStageDetector`
for those branches of

- `predict`: uint8 normalize, backbone, FPN, RPN proposals, multi-level
  RoIAlign, SharedFC bbox head, HBB decode and multiclass NMS (its IoU
  threshold from test_cfg.rcnn's ``nms`` dict or ``nms_thr``), then the
  rbbox head on the kept crops only and the rotated decode (thetaobb or
  pointobb) chosen through the NMS keep provenance; with a refinement
  head (RBBoxRCNNRRoI), the selected rboxes are re-cropped by rotated
  RoIAlign (kernel K4 on the card) and refined by rtheta deltas; with
  a mask head (MaskOBB, CenterMapOBB, CenterMap-Net), the detections'
  boxes are cropped at 14x14 (K1) and the head's map of each
  detection's class is returned as ``masks`` (sigmoid for the BCE
  head, raw for the CenterMap head); with a semantic head
  (CenterMap-Net), its map is cropped by a single-level RoIAlign at
  level 0's stride (K1 on one level) and added to every RoI crop;
- `loss`: the RPN's anchor-target loss, proposals without gradient,
  gt boxes prepended as candidates, MaxIoU assignment and fixed random
  sampling per image (or with ``sampler="ohem"`` the candidates with
  the highest classification loss under the bbox head, scored without
  gradient over all of them: a K2 forward launch), one RoIAlign
  (kernel K2 on the card) whose crops feed the bbox head and the rbbox
  head, and their losses; with a
  refinement head, the class-selected first-stage rboxes of the
  positive rois are re-cropped by rotated RoIAlign (kernel K4, forward
  and backward, on the card) and the refinement head's rtheta and
  classification losses are added; with a semantic head, its
  pseudo-segmentation loss and the fusion into the crops (K2 on one
  level); with a mask head, its crops of the positive rois at 14x14
  (K2) against `core.targets.mask_target` of the gt masks: BCE or the
  CenterMap loss with mask weights.

- `predict_from_proposals`: FastRCNN's test path, detections from given
  proposals;
- `aug_predict`: the reference's multi-augmentation test of one image
  (proposals merged in the original frame, every augmentation scoring
  the same merged proposals, boxes and softmax scores averaged before
  one multiclass NMS).

The other branches of this slice:

- the C4 detectors: one backbone level at stride 16, its anchors at
  the config's scales, crops at the box head's size times the res5
  ``shared_head``'s stride (14 for 7) run through it before the box
  head, the mask crops (14) through it before the mask head;
- GA-RPN (`GARPNHead`; GAFasterRCNN): the guided anchors of each image
  and the location filter feed the proposals, and its location and
  shape losses join the RPN's (`AnchorDetector._ga_loss`);
- Grid R-CNN (``grid_head``): the detections' boxes are replaced by
  the grid heatmaps' (`_grid_refine`, K1 at ``grid_roi_size``), and the
  jittered positives train it (`_grid_loss`, K2);
- Mask Scoring R-CNN (``mask_iou_head``): ``mask_scores``, the
  detection scores times the predicted mask IoU, and loss_mask_iou;
- Libra R-CNN's ``sampler="combined"`` (`core.sample.
  sample_fixed_combined`).

Double-Head R-CNN is a box head (`DoubleConvFCBBoxHead`) and BFP a neck.
The cascades are `detectors/cascade.py`, the proposal-only RPN
`detectors/rpn.py`.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import torch
from torch import nn
from torch.profiler import record_function

from ...core.anchors import build_pyramid_anchors
from ...core.assign import max_iou_assign
from ...core.points import build_pyramid_points
from ...core.rboxes import (RBBOX_CODECS, delta2rtheta, hobb2thetaobb,
                            hobb_rolls, pointobb2thetaobb, rtheta2delta)
from ...core.sample import ohem_sample, sample_fixed, sample_fixed_combined
from ...core.targets import bbox_target, mask_target, rbbox_target
from ...ops.nms import (NEG_INF, multiclass_nms, nms, nms_cfg_kwargs,
                        select_parallel_rboxes, topk)
from ...ops.roi_align import roi_align_bandx_forward, roi_align_forward
from ...ops.rroi_align import rroi_align_forward
from ...parallel.dist import global_count, global_mean
from ..heads.anchor_head import (anchor_head_loss, flatten_level_outputs,
                                 rpn_proposals)
from ..heads.bbox_head import (bbox_head_decode, bbox_head_loss,
                               rbbox_head_decode)
from ..heads.grid_head import grid_loss, grid_target, grid_to_boxes
from ..heads.guided_anchor_head import GARPNHead, ga_targets
from ..heads.semantic_head import semantic_loss
from ..losses import (CenterMapLoss, CrossEntropyLoss, FocalLoss,
                      SmoothL1Loss, mask_cross_entropy)
from ..preprocess import device_normalize
from .dense import _merge

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
# the mask branch's RoIAlign size (the head upsamples it to 28)
MASK_ROI_SIZE = 14


def _as_thetaobb(rb, encode):
    """First-stage rboxes in ``encode`` as thetaobbs (for the rotated
    crop and the rtheta codec)."""
    if encode == "pointobb":
        return pointobb2thetaobb(rb)
    if encode == "hobb":
        return hobb2thetaobb(rb)
    return rb


def _clip_to_image(boxes, img_shapes):
    """Boxes [B, K, 4] clipped to [0, w - 1] x [0, h - 1] of each image's
    (h, w) [B, 2]."""
    w = img_shapes[:, None, 1] - 1
    h = img_shapes[:, None, 0] - 1
    zero = boxes.new_zeros(())
    return torch.stack([
        torch.minimum(torch.maximum(boxes[..., 0], zero), w),
        torch.minimum(torch.maximum(boxes[..., 1], zero), h),
        torch.minimum(torch.maximum(boxes[..., 2], zero), w),
        torch.minimum(torch.maximum(boxes[..., 3], zero), h)], -1)


def jitter_rois(rois, img_shapes, generator: torch.Generator):
    """Grid R-CNN's training jitter (reference two_stage.py:604-621):
    each roi [B, R, 4] moved by up to 0.15 of its size and rescaled by a
    factor in [0.85, 1.15] (uniform draws from ``generator``), then
    clipped to its image."""
    off = torch.rand(rois.shape, generator=generator, device=rois.device)
    off = off * 0.3 - 0.15
    cxcy = (rois[..., 2:4] + rois[..., :2]) / 2
    wh = (rois[..., 2:4] - rois[..., :2]).abs()
    c = cxcy + wh * off[..., :2]
    half = wh * (1 + off[..., 2:]) / 2
    return _clip_to_image(torch.cat([c - half, c + half], -1), img_shapes)


def _dq(x):
    """uint8 targets quantized by the pipeline as value / 255 in float32
    (the reference's ``_dq``, two_stage.py:385-390); others as they
    are."""
    return x.float() / 255.0 if x is not None and x.dtype == torch.uint8 \
        else x


class RPNOutputs(NamedTuple):
    """The RPN head's outputs flattened over the levels, and the anchors
    they regress from."""
    cls: torch.Tensor            # [B, A, 1] objectness logits
    reg: torch.Tensor            # [B, A, 4] deltas
    anchors: torch.Tensor        # [A, 4], or GA-RPN's guided [B, A, 4]
    loc_keep: torch.Tensor = None    # GA-RPN: [B, A] sigmoid(loc) > thr
    shape: torch.Tensor = None       # GA-RPN: [B, A, 2] shape logits
    loc: torch.Tensor = None         # GA-RPN: [B, A] location logits


class AnchorDetector(nn.Module):
    """What the RPN, the two-stage detectors and the cascades share: a
    backbone, a neck (a list of necks in the config is an
    `nn.Sequential` that runs them in order, as the reference's
    two_stage.py:203-211), the RPN head over the pyramid anchors (by
    default strides P2..P6, 3 anchors per location: scale 8, ratios 0.5
    / 1 / 2, the reference's defaults; the C4 detectors' one level at
    stride 16 with 5 scales), or a `GARPNHead` over one guided anchor
    per point of each level, the uint8 normalize, the mixed precision
    of `loss`, the RPN's loss and proposals, the RoI crops, and the C4
    detectors' res5 ``shared_head`` over them.  ``dtype`` is the
    parameters' (the RPN head's)."""

    strides = (4, 8, 16, 32, 64)
    # the pyramid level of a semantic head's map (`_fuse_semantic`)
    semantic_level = 0

    def __init__(self, backbone, neck, rpn_head, img_size=1024,
                 compute_dtype=None, strides=None, anchor_scales=(8,),
                 anchor_ratios=(0.5, 1.0, 2.0), shared_head=None,
                 ga_target_stds=(0.07, 0.07, 0.14, 0.14),
                 ga_loc_filter_thr=0.01):
        super().__init__()
        self.backbone = backbone
        self.neck = neck
        self.rpn_head = rpn_head
        self.shared_head = shared_head
        self.img_size = img_size
        self.compute_dtype = compute_dtype
        if strides is not None:
            self.strides = tuple(strides)
        self.anchor_scales = tuple(anchor_scales)
        self.anchor_ratios = tuple(anchor_ratios)
        self.rpn_cls_loss = CrossEntropyLoss(use_sigmoid=True)
        self.rpn_bbox_loss = SmoothL1Loss(beta=1.0 / 9.0)
        anchors, self.level_sizes = build_pyramid_anchors(
            img_size, self.strides, self.anchor_scales, self.anchor_ratios)
        self.register_buffer("anchors", anchors, persistent=False)
        self.ga = isinstance(rpn_head, GARPNHead)
        self.rpn_target_stds = RPN_TARGET_STDS
        if self.ga:
            # GA-RPN: one guided anchor per point, its shape predicted
            pts, sizes, pstrides = build_pyramid_points(img_size,
                                                        self.strides)
            self.register_buffer("points", pts, persistent=False)
            self.register_buffer("pstrides", pstrides, persistent=False)
            self.level_sizes = sizes
            self.rpn_target_stds = tuple(ga_target_stds)
            self.ga_loc_filter_thr = ga_loc_filter_thr
            self.ga_loc_loss = FocalLoss(gamma=2.0, alpha=0.25)
            self.ga_shape_loss = SmoothL1Loss(beta=0.2)

    def _pyramid_anchors(self):
        return build_pyramid_anchors(self.img_size, self.strides,
                                     self.anchor_scales,
                                     self.anchor_ratios)[0]

    def _apply(self, fn, recurse=True):
        """Module.to and friends: the anchors (and GA-RPN's points) follow
        the device but stay float32 in a bfloat16 model, as the
        reference's, so that the proposals decode in float32."""
        super()._apply(fn, recurse)
        if self.anchors.dtype != torch.float32:
            self.anchors = self._pyramid_anchors().to(self.anchors.device)
        if self.ga and self.points.dtype != torch.float32:
            pts, _, pstrides = build_pyramid_points(self.img_size,
                                                    self.strides)
            self.points = pts.to(self.anchors.device)
            self.pstrides = pstrides.to(self.anchors.device)
        return self

    @property
    def dtype(self):
        return self.rpn_head.rpn_cls.weight.dtype

    @property
    def pool_scale(self):
        """The factor from a box head's input size to its crop size: the
        shared head's stride, or 1."""
        return 1 if self.shared_head is None else self.shared_head.stride

    def extract_feat(self, imgs):
        with record_function("backbone"):
            feats = self.backbone(device_normalize(imgs, dtype=self.dtype))
        with record_function("neck"):
            return self.neck(feats)

    def _mixed_precision(self, device):
        """Autocast to ``compute_dtype`` (convolutions and linears in it,
        parameters kept as they are), or nothing when it is the
        parameters' dtype."""
        cd = self.compute_dtype or self.dtype
        return torch.autocast(torch.device(device).type, dtype=cd,
                              enabled=cd != self.dtype)

    def _rpn_outputs(self, feats, masked=False):
        """The RPN head's outputs flattened over the levels, as
        `RPNOutputs`.  GA-RPN (reference two_stage.py:266-299): the
        guided anchors of each image, the points' 8-stride base shape
        scaled by exp of the shape logits, and the location filter;
        ``masked``, the test path, gates the head's outputs by it."""
        with record_function("rpn_head"):
            if not self.ga:
                rpn_cls, rpn_reg = self.rpn_head(feats)
                return RPNOutputs(*flatten_level_outputs(
                    rpn_cls, rpn_reg, self.rpn_head.cls_out_channels),
                    self.anchors)
            cls_out, shape_out, loc_out, reg_out = self.rpn_head(
                feats, masked=masked)
        b = cls_out[0].shape[0]

        def flat(xs, d):
            return torch.cat([x.reshape(b, -1, d) for x in xs], 1)
        shape, loc = flat(shape_out, 2), flat(loc_out, 1)[..., 0]
        base = self.pstrides * 8.0
        w = base * torch.exp(shape[..., 0])
        h = base * torch.exp(shape[..., 1])
        cx, cy = self.points[:, 0], self.points[:, 1]
        anchors = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2,
                               cy + h / 2], -1)
        return RPNOutputs(flat(cls_out, 1), flat(reg_out, 4), anchors,
                          torch.sigmoid(loc) > self.ga_loc_filter_thr,
                          shape, loc)

    def _rpn_loss(self, imgs, gt_boxes, gt_valid, img_shapes, generator,
                  rpn):
        """The features (under `_mixed_precision`), the RPN's float32
        outputs (`RPNOutputs`) and its losses under the assigner and
        sampler of the ``rpn`` train_cfg (loss_rpn_cls, loss_rpn_bbox;
        GA-RPN adds loss_rpn_loc and loss_rpn_shape, `_ga_loss`).
        Returns (feats, outputs, losses, the autocast context)."""
        amp = self._mixed_precision(imgs.device)
        with amp:
            feats = self.extract_feat(imgs)
            out = self._rpn_outputs(feats)
        out = out._replace(**{k: getattr(out, k).float() for k in
                              ("cls", "reg", "shape", "loc")
                              if getattr(out, k) is not None})
        if self.ga:
            with record_function("rpn_loss"):
                losses = self._ga_loss(out, gt_boxes, gt_valid, img_shapes,
                                       generator, rpn)
            return feats, out, losses, amp
        with record_function("rpn_loss"):
            res = anchor_head_loss(
                out.cls, out.reg, self.anchors, gt_boxes, gt_valid,
                img_shapes, generator, target_stds=RPN_TARGET_STDS,
                cls_loss=self.rpn_cls_loss, bbox_loss=self.rpn_bbox_loss,
                assigner_cfg=_assigner(rpn), sampler_cfg=_sampler(rpn),
                allowed_border=rpn["allowed_border"],
                pos_weight=rpn["pos_weight"])
        return feats, out, dict(loss_rpn_cls=res["loss_cls"],
                                loss_rpn_bbox=res["loss_bbox"]), amp

    def _ga_loss(self, out, gt_boxes, gt_valid, img_shapes, generator, rpn):
        """GA-RPN's losses (reference two_stage.py:401-450,
        rpn.py:123-171): the focal location loss and the smooth L1 (beta
        0.2) shape loss against `ga_targets`, then each image's
        objectness and delta losses on its guided anchors without
        gradient (every anchor inside the border rule, the ``rpn``
        assigner and sampler, averaged by that image's sample count),
        averaged over the images."""
        loc_tgt, loc_w, shape_tgt, pos = ga_targets(
            self.points, self.pstrides, gt_boxes, gt_valid)
        losses = dict(
            loss_rpn_loc=self.ga_loc_loss(
                out.loc[..., None], loc_tgt.long(), weight=loc_w[..., None],
                avg_factor=global_count(loc_tgt.sum()).clamp(min=1.0)),
            loss_rpn_shape=self.ga_shape_loss(
                out.shape, shape_tgt,
                weight=pos[..., None].expand_as(out.shape).float(),
                avg_factor=global_count(pos.sum()).clamp(min=1.0)))
        per = [anchor_head_loss(
            out.cls[i:i + 1], out.reg[i:i + 1], out.anchors[i].detach(),
            gt_boxes[i:i + 1], gt_valid[i:i + 1], img_shapes[i:i + 1],
            generator, target_stds=self.rpn_target_stds,
            cls_loss=self.rpn_cls_loss, bbox_loss=self.rpn_bbox_loss,
            assigner_cfg=_assigner(rpn), sampler_cfg=_sampler(rpn),
            allowed_border=-1, pos_weight=rpn["pos_weight"],
            global_avg=False)
            for i in range(gt_boxes.shape[0])]
        losses["loss_rpn_cls"] = global_mean(
            torch.stack([p["loss_cls"] for p in per]))
        losses["loss_rpn_bbox"] = global_mean(
            torch.stack([p["loss_bbox"] for p in per]))
        return losses

    def _proposals(self, out, img_shapes, cfg):
        """The RPN's proposals from `RPNOutputs` under ``cfg`` (nms_pre,
        nms_post, max_num, nms_thr, min_bbox_size), without gradient;
        GA-RPN's locations below the filter score -1e4: (boxes [B, N,
        4], scores [B, N], valid [B, N])."""
        cls = out.cls
        if out.loc_keep is not None:
            cls = torch.where(out.loc_keep[..., None], cls,
                              cls.new_tensor(-1e4))
        with torch.no_grad(), record_function("rpn_proposals"):
            return rpn_proposals(cls, out.reg, out.anchors,
                                 self.level_sizes, img_shapes,
                                 target_stds=self.rpn_target_stds, **cfg)

    def _roi_features(self, feats, rois_b, out_size, infer=False):
        """Multi-level RoIAlign over the first 4 levels (the C4
        detectors' one): [B, R, s, s, C].
        On CUDA tensors this launches kernel K1 under no_grad and K2
        (forward, then its backward kernel) when the features need a
        gradient; a training pass without gradient (``infer`` False
        under no_grad: OHEM's scoring) is K2's forward too.  ``infer``
        on bfloat16 features with AIDET_ROI_BAND=x (read at each call,
        as the reference does) takes K3 instead of K1: the same
        function, reduced from band-chunked rois."""
        levels = [f.contiguous() for f in feats[:4]]
        if (infer and levels[0].dtype == torch.bfloat16
                and os.environ.get("AIDET_ROI_BAND", "1") == "x"):
            return roi_align_bandx_forward(levels, rois_b.float(), out_size,
                                           self.strides[:4])
        return roi_align_forward(levels, rois_b.float(), out_size,
                                 self.strides[:4], train=not infer)

    def _apply_shared(self, crops):
        """The shared head (res5) over crops [B, R, s, s, C] (reference
        two_stage.py:342-350), or the crops without one."""
        if self.shared_head is None:
            return crops
        b, r = crops.shape[:2]
        with record_function("shared_head"):
            out = self.shared_head(crops.reshape((b * r,) + crops.shape[2:]))
        return out.reshape((b, r) + out.shape[1:])

    def _fuse_semantic(self, crops, sem_feat, rois_b, out_size):
        """The semantic map [B, H, W, C] cropped at the rois [B, R, 4] by
        the single-level RoIAlign at the stride of `semantic_level`
        (sampling ratio 2, aligned: the reference's
        `ops/roi_align.py::roi_align`, two_stage.py:352-365,
        cascade.py:134-142) and added to the crops [B, R, s, s, C].  The
        crop is the multi-level RoIAlign over one level: K1 on the card
        under no_grad, K2 (forward and backward) when the map needs a
        gradient, the plain version on the CPU."""
        lvl = self.semantic_level
        with record_function("semantic_roi_align"):
            sem = roi_align_forward([sem_feat.contiguous()], rois_b.float(),
                                    out_size, self.strides[lvl:lvl + 1])
        return crops + sem


def _assigner(rpn):
    return dict(pos_iou_thr=rpn["pos_iou_thr"],
                neg_iou_thr=rpn["neg_iou_thr"],
                min_pos_iou=rpn["min_pos_iou"])


def _sampler(rpn):
    return dict(num_samples=rpn["num_samples"],
                pos_fraction=rpn["pos_fraction"],
                neg_pos_ub=rpn["neg_pos_ub"])


class TwoStageDetector(AnchorDetector):
    """RBBoxRCNN: backbone + FPN + RPN + bbox head + rbbox head, and
    with ``rbbox_refine_head`` (an rtheta `RBBoxHead`) RBBoxRCNNRRoI.
    The first-stage rbbox codec (the reference's ``rbbox_encode``) is
    the rbbox head's ``encode``: thetaobb, pointobb or hobb; with
    ``hobb_robust_loss`` a hobb head's regression loss is the smallest
    over the 4 rolls of each gt (`core.rboxes.hobb_rolls`), predict
    unchanged.  Without an rbbox
    head and with a ``mask_head`` (an `FCNMaskHead` trained with BCE,
    ``mask_loss_type="bce"``, or a `CenterMapHead` trained with the
    CenterMap loss, "centermap") it is MaskOBB or CenterMapOBB, whose
    rotated boxes come from the masks on the host
    (`core.masks.masks_to_thetaobbs`); with a ``semantic_head`` (a
    `WPSGAHead`) too, CenterMap-Net: its map at pyramid level 0 is
    cropped with every RoI and added to the crops (the reference's
    default fusion and level, the only ones its configs use).  With
    neither an rbbox head nor a mask head it is FasterRCNN (or
    FastRCNN, whose test path is `predict_from_proposals`): boxes
    alone.

    compute_dtype: the dtype of `loss`'s convolutions and matrix
    products when it differs from the parameters' (the training build
    keeps float32 parameters and computes in bfloat16, as the
    reference's flax modules with dtype=bfloat16 do); None means the
    parameters' dtype.  `predict` computes in the parameters' dtype.
    """

    def __init__(self, backbone, neck, rpn_head, bbox_head, rbbox_head=None,
                 img_size=1024, train_cfg=None, test_cfg=None,
                 compute_dtype=None, rbbox_refine_head=None, mask_head=None,
                 mask_loss_type="bce", semantic_head=None,
                 hobb_robust_loss=False, shared_head=None,
                 mask_iou_head=None, grid_head=None, grid_roi_size=14,
                 **anchor_options):
        super().__init__(backbone, neck, rpn_head, img_size, compute_dtype,
                         shared_head=shared_head, **anchor_options)
        self.bbox_head = bbox_head
        self.rbbox_head = rbbox_head
        if rbbox_refine_head is not None \
                and rbbox_refine_head.encode != "rtheta":
            raise ValueError("rbbox_refine_head regresses against rotated "
                             "proposals; encode must be 'rtheta'")
        self.rbbox_refine_head = rbbox_refine_head
        if rbbox_refine_head is not None and rbbox_head is None:
            raise ValueError("rbbox_refine_head refines the rbbox head's "
                             "boxes; it needs an rbbox_head")
        if mask_loss_type not in ("bce", "centermap"):
            raise ValueError(f"mask_loss_type {mask_loss_type!r}: 'bce' or "
                             "'centermap'")
        if mask_iou_head is not None and mask_head is None:
            raise ValueError("mask_iou_head scores the mask head's masks; it "
                             "needs a mask_head")
        self.hobb_robust_loss = hobb_robust_loss
        self.mask_head = mask_head
        self.mask_loss_type = mask_loss_type
        self.mask_iou_head = mask_iou_head
        self.semantic_head = semantic_head
        self.grid_head = grid_head
        self.grid_roi_size = grid_roi_size
        self.train_cfg = _merge(DEFAULT_TRAIN_CFG, train_cfg)
        self.test_cfg = _merge(DEFAULT_TEST_CFG, test_cfg)
        self.rcnn_cls_loss = CrossEntropyLoss()
        self.rcnn_bbox_loss = SmoothL1Loss(beta=1.0)
        self.centermap_loss = CenterMapLoss()

    @property
    def bbox_pool_size(self):
        """The box crops' size: the box head's input size times the
        shared head's stride (reference two_stage.py:158-162)."""
        return self.bbox_head.roi_feat_size * self.pool_scale

    @property
    def dtype(self):
        return self.bbox_head.fc_cls.weight.dtype

    @property
    def result_encode(self):
        """The encode of predict's ``rboxes`` (a refinement head's are
        thetaobbs whatever the first stage's), or None without them."""
        if self.rbbox_head is None:
            return None
        return ("thetaobb" if self.rbbox_refine_head is not None
                else self.rbbox_head.encode)

    @torch.no_grad()
    def predict(self, imgs, img_shapes, scale_factors=None):
        """imgs [B, H, W, 3] (uint8 BGR, or normalized floats),
        img_shapes [B, 2] (h, w), scale_factors [B] (the test
        pipeline's resize factor of each image, or None).  Returns
        fixed-size results: boxes [B, K, 4]; with an rbbox head rboxes
        [B, K, D] (D = 5 thetaobbs, or 8 pointobb corners without a
        refinement head); with a mask head masks [B, K, 28, 28]
        (`_predict_masks`, in the crop's frame: not rescaled); and
        scores, labels (0-based, -1 if invalid) and valid [B, K].
        With ``scale_factors`` the boxes and rboxes are divided back to
        the original image (`_rescale`).
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
        props, _, prop_valid = self._proposals(
            self._rpn_outputs(feats, masked=True), img_shapes, ec["rpn"])

        b, p = props.shape[:2]
        sem_feat = None
        if self.semantic_head is not None:
            with record_function("semantic_head"):
                sem_feat = self.semantic_head(feats)[1]
        with record_function("roi_align"):
            crops = self._roi_features(feats, props, self.bbox_pool_size,
                                       infer=True)
        if sem_feat is not None:
            crops = self._fuse_semantic(crops, sem_feat, props,
                                        self.bbox_pool_size)
        crops = self._apply_shared(crops)
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
                                  max_num=rc["max_per_img"],
                                  valid=prop_valid, **nms_cfg_kwargs(rc))
        out = dict(boxes=dets.boxes, scores=dets.scores,
                   labels=dets.labels, valid=dets.valid)
        if self.grid_head is not None:
            with record_function("grid_head"):
                out["boxes"] = self._grid_refine(feats, dets, img_shapes)
        if self.rbbox_head is not None:
            out["rboxes"] = self._predict_rboxes(feats, crops, props, dets)
        if self.mask_head is not None:
            with record_function("mask_head"):
                out["masks"], iou = self._predict_masks(feats, sem_feat,
                                                        dets)
            if iou is not None:
                out["mask_scores"] = out["scores"] * iou.clamp(0.0, 1.0)
        if scale_factors is not None:
            self._rescale(out, scale_factors)
        return out

    @torch.no_grad()
    def predict_from_proposals(self, imgs, proposals, prop_valid, img_shapes,
                               scale_factors=None):
        """Fast R-CNN's test path (reference two_stage.py:841-870; parity:
        mmdet's fast_rcnn.py): detections from given proposals [B, P, 4]
        with validity [B, P] (an RPN's `predict`, or a file's), through
        the RoI crops (K1 on the card), the bbox head, its decode and
        multiclass NMS.  Returns boxes [B, K, 4] (divided by
        ``scale_factors`` [B] when given), scores, labels and valid."""
        img_shapes = img_shapes.float()
        feats = self.extract_feat(imgs)
        b, p = proposals.shape[:2]
        with record_function("roi_align"):
            crops = self._roi_features(feats, proposals,
                                       self.bbox_pool_size, infer=True)
        crops = self._apply_shared(crops)
        with record_function("bbox_head"):
            cls_score, bbox_pred = self.bbox_head(
                crops.reshape((b * p,) + crops.shape[2:]))
        rc = self.test_cfg["rcnn"]
        with record_function("bbox_decode_nms"):
            boxes, scores = bbox_head_decode(
                proposals.float(), cls_score.reshape(b, p, -1),
                bbox_pred.reshape(b, p, -1), RCNN_TARGET_MEANS,
                RCNN_TARGET_STDS, img_shape=img_shapes[:, None, :])
            dets = multiclass_nms(boxes, scores, rc["score_thr"],
                                  max_num=rc["max_per_img"],
                                  valid=prop_valid.bool(),
                                  **nms_cfg_kwargs(rc))
        out = dict(boxes=dets.boxes, scores=dets.scores,
                   labels=dets.labels, valid=dets.valid)
        if scale_factors is not None:
            out["boxes"] = out["boxes"] / scale_factors.to(
                out["boxes"]).reshape(-1, 1, 1)
        return out

    @torch.no_grad()
    def aug_predict(self, imgs, img_shapes, flips, scale_factors):
        """Multi-augmentation (scale x flip) test of ONE image: the
        reference's `aug_predict` (two_stage.py:872; parity:
        TwoStageDetector.aug_test with merge_aug_proposals and
        merge_aug_bboxes).  Every variant's proposals are mapped back to
        the original frame and merged by one NMS (the rpn test_cfg's
        nms_thr, its top max_num); every variant's bbox head then scores
        the same merged proposals, mapped into its frame; the boxes,
        mapped back, and the softmax scores are averaged over the
        variants before one multiclass NMS.  A flip mirrors about the
        variant's content width (``w - x - 1``), not the canvas.

        imgs [A, S, S, 3] the variants; img_shapes [A, 2]; flips [A]
        bool; scale_factors [A].  Returns predict's boxes, scores,
        labels and valid with a leading dim of 1 (boxes only: no rbbox,
        mask or semantic branch, as in the reference)."""
        ec = self.test_cfg
        img_shapes = img_shapes.float()
        flips = flips.bool()
        sf = scale_factors.to(img_shapes)
        w_img = img_shapes[:, 1]
        feats = self.extract_feat(imgs)
        props, scores, valid = self._proposals(
            self._rpn_outputs(feats, masked=True), img_shapes, ec["rpn"])
        a, p = props.shape[:2]

        def flipped(boxes, f, w):
            """boxes [A, ..., 4] mirrored where f [A] about w [A]."""
            shape = (a,) + (1,) * (boxes.dim() - 2)
            f, w = f.reshape(shape), w.reshape(shape)
            x1 = torch.where(f, w - boxes[..., 2] - 1, boxes[..., 0])
            x2 = torch.where(f, w - boxes[..., 0] - 1, boxes[..., 2])
            return torch.stack([x1, boxes[..., 1], x2, boxes[..., 3]], -1)

        def per_aug(x):
            return x.reshape((a,) + (1,) * 2)

        flat_p = (flipped(props, flips, w_img) / per_aug(sf)).reshape(a * p, 4)
        flat_s = scores.reshape(a * p)
        keep = nms(flat_p, flat_s, ec["rpn"]["nms_thr"], valid.reshape(a * p))
        k = min(ec["rpn"]["max_num"], a * p)
        top_s, top_i = topk(torch.where(keep, flat_s,
                                        flat_s.new_tensor(NEG_INF)), k)
        merged = flat_p[top_i]
        merged_valid = top_s > NEG_INF / 2

        props_aug = flipped(merged[None] * per_aug(sf), flips, w_img)
        crops = self._apply_shared(self._roi_features(
            feats, props_aug, self.bbox_pool_size, infer=True))
        cls_score, bbox_pred = self.bbox_head(
            crops.reshape((a * k,) + crops.shape[2:]))
        boxes, cls_prob = bbox_head_decode(
            props_aug, cls_score.reshape(a, k, -1),
            bbox_pred.reshape(a, k, -1), RCNN_TARGET_MEANS,
            RCNN_TARGET_STDS, img_shape=img_shapes[:, None, :])
        grp = boxes.reshape(a, k, -1, 4)
        grp = flipped(grp, flips, w_img) / sf.reshape(a, 1, 1, 1)
        rc = ec["rcnn"]
        res = multiclass_nms(grp.reshape(a, k, -1).mean(0), cls_prob.mean(0),
                             rc["score_thr"], max_num=rc["max_per_img"],
                             valid=merged_valid, **nms_cfg_kwargs(rc))
        return dict(boxes=res.boxes[None], scores=res.scores[None],
                    labels=res.labels[None], valid=res.valid[None])

    def _predict_rboxes(self, feats, crops, props, dets):
        """The rbbox head's rotated boxes of the kept detections [B, K,
        D], refined by the refinement head if there is one."""
        b, p = props.shape[:2]
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
            rboxes = select_parallel_rboxes(
                rboxes, local, self.rbbox_head.out_dim_reg)
        if self.rbbox_refine_head is not None:
            with record_function("rroi_refine"):
                rboxes = self._refine(feats, rboxes, dets)
        return rboxes

    def _predict_masks(self, feats, sem_feat, dets):
        """The mask branch of predict (reference two_stage.py:1088-1121):
        the detections' boxes cropped at 14x14 (K1 on the card; with a
        semantic head its map fused in; with a shared head through it,
        to 7x7), the mask head, and each detection's map at its label's
        channel (0-based labels, clamped to the head's channels): raw
        for the CenterMap head, sigmoid for the BCE head.  Returns
        (masks [B, K, S, S] (S = 28, 14 after a shared head), the mask
        IoU head's IoU of each detection's class [B, K], or None
        without one)."""
        det_rois = dets.boxes[..., :4]
        b, k = det_rois.shape[:2]
        mcrops = self._roi_features(feats, det_rois, MASK_ROI_SIZE,
                                    infer=True)
        if sem_feat is not None:
            mcrops = self._fuse_semantic(mcrops, sem_feat, det_rois,
                                         MASK_ROI_SIZE)
        mcrops = self._apply_shared(mcrops)
        mcrops = mcrops.reshape((b * k,) + mcrops.shape[2:])
        pred = self.mask_head(mcrops)
        c = pred.shape[-1]
        lbl = dets.labels.reshape(-1).long().clamp(0, c - 1)
        sel = torch.gather(pred, -1, lbl[:, None, None, None].expand(
            pred.shape[:-1] + (1,)))[..., 0]
        if self.mask_loss_type != "centermap":
            sel = torch.sigmoid(sel)
        iou = None
        if self.mask_iou_head is not None:
            iou = torch.gather(self.mask_iou_head(mcrops, sel), 1,
                               lbl[:, None])[:, 0].reshape(b, k)
        return sel.reshape((b, k) + sel.shape[1:]), iou

    def _grid_refine(self, feats, dets, img_shapes):
        """Grid R-CNN's boxes (reference two_stage.py:1006-1025): the
        detections cropped at ``grid_roi_size`` (K1 on the card), the grid
        head's heatmaps, `grid_to_boxes`, clipped to each image; invalid
        rows keep their boxes."""
        det_rois = dets.boxes[..., :4]
        b, k = det_rois.shape[:2]
        gcrops = self._roi_features(feats, det_rois, self.grid_roi_size,
                                    infer=True)
        heat = self.grid_head(gcrops.reshape((b * k,) + gcrops.shape[2:]))
        refined = _clip_to_image(grid_to_boxes(
            heat.reshape((b, k) + heat.shape[1:]), det_rois), img_shapes)
        return torch.where(dets.valid[..., None], refined, dets.boxes)

    def _rescale(self, out, scale_factors):
        """Divide ``out``'s boxes and rboxes by each image's scale
        factor, in place (reference two_stage.py:1122-1135): thetaobbs
        (a thetaobb head's, or any refinement head's, which always
        gives thetaobbs) have their centre, w and h scaled and theta
        kept; pointobb corners are all divided."""
        sf = scale_factors.to(out["boxes"]).reshape(-1, 1, 1)
        out["boxes"] = out["boxes"] / sf
        if "rboxes" not in out:
            return
        rb = out["rboxes"]
        if rb.shape[-1] == 5 and (self.rbbox_head.encode == "thetaobb"
                                  or self.rbbox_refine_head is not None):
            out["rboxes"] = torch.cat([rb[..., :4] * (1.0 / sf),
                                       rb[..., 4:]], -1)
        else:
            out["rboxes"] = rb / sf

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
        rb = self._clip_rboxes(_as_thetaobb(rboxes, self.rbbox_head.encode))
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

    def loss(self, imgs, gt_boxes, gt_valid, gt_labels, img_shapes,
             gt_rboxes=None, generator: torch.Generator = None,
             gt_masks=None, gt_mask_weights=None, gt_semantic=None,
             gt_seg_weights=None):
        """The training loss of the ported branches (reference: `loss`,
        two_stage.py:367-832, without its other optional branches).

        imgs [B, S, S, 3] (uint8 BGR or normalized floats); gt_boxes
        [B, G, 4]; gt_valid [B, G]; gt_labels [B, G] (1-based);
        img_shapes [B, 2] (h, w); gt_rboxes [B, G, D] in the rbbox
        head's encode: thetaobbs [B, G, 5], pointobbs [B, G, 8] or hobbs
        [B, G, 5] (read only with an rbbox head); gt_masks [B, G, Hm, Wm] (binary
        masks for the BCE head, soft centermaps for the CenterMap head)
        and gt_mask_weights [B, G, Hm, Wm] (CenterMap only, optional),
        over the whole padded image at Hm / S of its scale; gt_semantic
        [B, Hs, Ws] class indices (255 ignored) and gt_seg_weights
        [B, Hs, Ws] (optional) for the semantic head.  Mask-type targets
        may be uint8 quantized by the pipeline (`_dq`: value / 255 on
        the card).  Sampling draws from ``generator`` (on the images'
        device): the RPN's positives and negatives, then the RoI
        sample's.  Returns float32 scalars: loss_rpn_cls, loss_rpn_bbox,
        loss_cls, loss_bbox; with an rbbox head loss_rbbox_cls and
        loss_rbbox, and with a refinement head loss_rbbox_refine and
        loss_rbbox_refine_cls (`_refine_loss`); with a semantic head and
        gt_semantic loss_seg; with a mask head loss_mask (`_mask_loss`).

        Mixed precision: the backbone, FPN, RPN head and RoI heads run
        under `_mixed_precision`; the heads' outputs are cast to float32
        and every loss computes in float32.
        Each stage is a `torch.profiler.record_function` span (read by
        tools/torch_profile_train.py).
        """
        tc = self.train_cfg
        rc = tc["rcnn"]
        sampler = rc.get("sampler", "random")
        if sampler not in ("random", "ohem", "combined"):
            raise ValueError(f"rcnn sampler {sampler!r}: 'random', 'ohem' "
                             "or 'combined'")
        if generator is None:
            raise TypeError("loss needs the sampling generator")
        gt_masks = _dq(gt_masks)
        gt_mask_weights = _dq(gt_mask_weights)
        gt_seg_weights = _dq(gt_seg_weights)
        img_shapes = img_shapes.float()
        gt_boxes = gt_boxes.float()
        b = imgs.shape[0]
        feats, rpn_out, losses, amp = self._rpn_loss(
            imgs, gt_boxes, gt_valid, img_shapes, generator, tc["rpn"])
        # proposals carry no gradient, as in the reference
        props, _, prop_valid = self._proposals(rpn_out, img_shapes,
                                               tc["rpn_proposal"])

        # the gt boxes join the proposals as candidates
        with record_function("rcnn_sample"):
            cand = torch.cat([gt_boxes, props], 1)
            cand_valid = torch.cat([gt_valid, prop_valid], 1)
            res = max_iou_assign(cand, gt_boxes, gt_valid, None,
                                 pos_iou_thr=rc["pos_iou_thr"],
                                 neg_iou_thr=rc["neg_iou_thr"],
                                 min_pos_iou=rc["min_pos_iou"],
                                 box_valid=cand_valid)
            if sampler == "ohem":
                sample = ohem_sample(
                    res.gt_inds, self._ohem_loss(feats, cand, res, amp),
                    rc["num_samples"], rc["pos_fraction"])
            elif sampler == "combined":
                sample = sample_fixed_combined(
                    res.gt_inds, res.max_overlaps, rc["num_samples"],
                    rc["pos_fraction"], generator, rc["neg_pos_ub"],
                    num_gts=gt_boxes.shape[1],
                    floor_thr=rc.get("floor_thr", -1.0),
                    floor_fraction=rc.get("floor_fraction", 0.0),
                    num_bins=rc.get("num_bins", 3))
            else:
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

        sem_feat = None
        if self.semantic_head is not None:
            with amp, record_function("semantic_head"):
                seg_logits, sem_feat = self.semantic_head(feats)
            if gt_semantic is not None:
                sh = self.semantic_head
                losses["loss_seg"] = semantic_loss(
                    seg_logits.float(), gt_semantic, gt_seg_weights,
                    loss_weight=sh.loss_weight, use_focal=sh.use_focal,
                    focal_gamma=sh.focal_gamma)

        # one RoIAlign: both box heads read the same crops, so the step
        # has one multi-level K2 forward and backward launch for them
        with record_function("roi_align"):
            crops = self._roi_features(feats, rois, self.bbox_pool_size)
        if sem_feat is not None:
            crops = self._fuse_semantic(crops, sem_feat, rois,
                                        self.bbox_pool_size)
        with amp:
            crops = self._apply_shared(crops)
        crops = crops.reshape((b * r,) + crops.shape[2:])
        with amp, record_function("roi_heads"):
            cls_score, bbox_pred = self.bbox_head(crops)

        def flat(t):
            return t._make(x.reshape((b * r,) + x.shape[2:]) for x in t)

        tgt = flat(bbox_target(sample, rois, gt_boxes, gt_labels,
                               RCNN_TARGET_MEANS, RCNN_TARGET_STDS,
                               rc["pos_weight"]))
        losses["loss_cls"], losses["loss_bbox"] = bbox_head_loss(
            cls_score.float(), bbox_pred.float(), tgt,
            self.rcnn_cls_loss, self.rcnn_bbox_loss,
            reg_class_agnostic=self.bbox_head.reg_class_agnostic)
        if self.grid_head is not None:
            with record_function("grid_loss"):
                p_max = int(rc["num_samples"] * rc["pos_fraction"])
                pos = sample._make(x[:, :p_max] for x in sample)
                losses["loss_grid"] = self._grid_loss(
                    feats, jitter_rois(rois[:, :p_max], img_shapes,
                                       generator), pos, gt_boxes, amp)
        if self.rbbox_head is not None:
            with amp, record_function("roi_heads"):
                rcls, rreg = self.rbbox_head(crops)
            enc = self.rbbox_head.encode
            rtgt = flat(rbbox_target(sample, rois, gt_rboxes.float(),
                                     gt_labels, enc,
                                     pos_weight=rc["pos_weight"]))
            alt = None
            if self.hobb_robust_loss and enc == "hobb":
                # targets for the 4 first-edge rolls of each gt
                rolled = hobb_rolls(gt_rboxes.float())      # [B, G, 4, 5]
                alt = torch.stack([rbbox_target(
                    sample, rois, rolled[:, :, k], gt_labels, enc,
                    pos_weight=rc["pos_weight"]).bbox_targets.reshape(
                        b * r, -1) for k in range(4)])
            losses["loss_rbbox_cls"], losses["loss_rbbox"] = bbox_head_loss(
                rcls.float(), rreg.float(), rtgt, self.rcnn_cls_loss,
                self.rcnn_bbox_loss, box_dim=self.rbbox_head.out_dim_reg,
                alt_bbox_targets=alt)
            if self.rbbox_refine_head is not None:
                with record_function("rroi_refine"):
                    losses.update(self._refine_loss(
                        feats, rois, rreg.float().reshape(b, r, -1), sample,
                        gt_rboxes.float(), gt_labels, amp))
        if self.mask_head is not None:
            with record_function("mask_loss"):
                losses.update(self._mask_loss(
                    feats, sem_feat, rois, sample, gt_masks,
                    gt_mask_weights, gt_labels, amp))
        return losses

    def _grid_loss(self, feats, jit_rois, pos, gt_boxes, amp):
        """The grid branch's loss (reference two_stage.py:599-645) on the
        jittered positive rois [B, P, 4] of the sample's first rows
        ``pos``: their crops at ``grid_roi_size`` (K2 on the card), the
        fused and unfused heatmaps against `grid_target`'s at twice that
        size, `grid_loss`."""
        b, p = jit_rois.shape[:2]
        gcrops = self._roi_features(feats, jit_rois, self.grid_roi_size)
        with amp:
            heat, unfused = self.grid_head(
                gcrops.reshape((b * p,) + gcrops.shape[2:]),
                return_unfused=True)
        target = grid_target(pos, jit_rois, gt_boxes, 2 * self.grid_roi_size,
                             self.grid_head.grid_points)
        return grid_loss(heat.float(), unfused.float(),
                         target.reshape(heat.shape), pos.is_pos.reshape(-1))

    @torch.no_grad()
    def _ohem_loss(self, feats, cand, res, amp):
        """OHEM's ranking score of every candidate [B, C] (the reference's
        two_stage.py:498-540): the bbox head without gradient on the
        crops of all candidates (gts, then proposals), and the
        cross-entropy of its scores at the assigned label, which is the
        reference's: 1 for a positive (the assignment runs without gt
        labels), 0 otherwise."""
        b, c = cand.shape[:2]
        crops = self._roi_features([f.detach() for f in feats], cand,
                                   self.bbox_pool_size)
        with amp:
            crops = self._apply_shared(crops)
            cls_score, _ = self.bbox_head(
                crops.reshape((b * c,) + crops.shape[2:]))
        logp = torch.log_softmax(cls_score.float().reshape(b, c, -1), -1)
        lab = torch.where(res.gt_inds > 0, res.labels, 0).long()
        return -torch.gather(logp, -1, lab[..., None])[..., 0]

    def _mask_loss(self, feats, sem_feat, rois, sample, gt_masks,
                   gt_mask_weights, gt_labels, amp):
        """The mask branch's loss (reference two_stage.py:761-814): the
        first p_max = int(num_samples * pos_fraction) sampled rois (the
        positives come first) cropped at 14x14 (K2 on the card; with a
        semantic head its map fused in), the mask head, and the targets
        of `mask_target`: the gt masks cropped at the rois scaled into
        mask pixels (by gt_masks' width over img_size) at the head's
        output size.  loss_mask, averaged over max(#positives, 1) * S^2:
        the CenterMap loss at each roi's class, with the mask weights
        cropped the same way entering as w + 1, or the class-sliced
        sigmoid BCE; rois that are not positive weigh 0.  With a shared
        head the crops go through it (14 -> 7) and the targets are at
        the head's 14.  With a mask IoU head (reference :815-837),
        loss_mask_iou: half the squared error of its IoU at each
        positive's class against the IoU of the binarized (0.5) mask
        and target, over the positives' count.  Returns the losses'
        dict."""
        rc = self.train_cfg["rcnn"]
        b = rois.shape[0]
        p_max = int(rc["num_samples"] * rc["pos_fraction"])
        pos_rois = rois[:, :p_max]
        pos = sample._make(x[:, :p_max] for x in sample)
        mcrops = self._roi_features(feats, pos_rois, MASK_ROI_SIZE)
        if sem_feat is not None:
            mcrops = self._fuse_semantic(mcrops, sem_feat, pos_rois,
                                         MASK_ROI_SIZE)
        with amp:
            mcrops = self._apply_shared(mcrops)
            mcrops = mcrops.reshape((b * p_max,) + mcrops.shape[2:])
            pred = self.mask_head(mcrops)
        pred = pred.float()
        msize = pred.shape[1]
        mrois = pos_rois * (gt_masks.shape[-1] / self.img_size)
        tgt = mask_target(pos, mrois, gt_masks, msize).reshape(
            b * p_max, msize, msize)
        g = gt_labels.shape[1]
        labels = torch.where(pos.is_pos, torch.gather(
            gt_labels.long(), 1, pos.gt_inds.clamp(0, g - 1)), 0).reshape(-1)
        is_pos = pos.is_pos.reshape(-1).float()
        npos = global_count(is_pos.sum()).clamp(min=1.0)
        navg = npos * msize ** 2
        if self.mask_loss_type == "centermap":
            mw = None
            if gt_mask_weights is not None:
                mw = mask_target(pos, mrois, gt_mask_weights, msize).reshape(
                    tgt.shape) + 1.0
            return dict(loss_mask=self.centermap_loss(
                pred, tgt, labels, mask_weight=mw, roi_weight=is_pos,
                avg_factor=navg))
        losses = dict(loss_mask=mask_cross_entropy(
            pred, tgt, labels, weight=is_pos[:, None, None],
            avg_factor=navg))
        if self.mask_iou_head is not None:
            # Mask Scoring R-CNN: regress the IoU of the binarized
            # class-sliced mask with the binarized target
            c = pred.shape[-1]
            idx = (labels - 1).clamp(0, c - 1)
            pred_c = torch.sigmoid(torch.gather(
                pred, -1, idx[:, None, None, None].expand(
                    pred.shape[:-1] + (1,)))[..., 0])
            pb, tb = pred_c > 0.5, tgt > 0.5
            iou_tgt = (pb & tb).sum((1, 2)) / (pb | tb).sum((1, 2)).clamp(
                min=1)
            with amp:
                iou_pred = self.mask_iou_head(mcrops, pred_c.detach())
            iou_pred = torch.gather(iou_pred.float(), 1, idx[:, None])[:, 0]
            diff = (iou_pred - iou_tgt) * is_pos
            losses["loss_mask_iou"] = 0.5 * (diff ** 2).sum() / npos
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
        dec = _as_thetaobb(RBBOX_CODECS[first.encode][2](rois, sel),
                           first.encode)
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
        gtm = _as_thetaobb(torch.gather(gt_rboxes, 1, gt_inds[..., None]
                                        .expand(-1, -1, gt_rboxes.shape[-1])),
                           first.encode)
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
        npos = global_count(is_pos.sum()).clamp(min=1.0)
        ce = -torch.log_softmax(ref_cls, -1).gather(
            1, lbl_pos[:, None])[:, 0]
        lw = sample.valid[:, :p_max].reshape(-1).float()
        return dict(
            loss_rbbox_refine=(sl1.sum(-1) * is_pos).sum() / npos,
            loss_rbbox_refine_cls=(ce * lw).sum()
            / global_count(lw.sum()).clamp(min=1.0))
