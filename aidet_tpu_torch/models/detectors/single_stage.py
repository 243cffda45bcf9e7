"""Single-stage detectors: RetinaNet and the rotated RetinaNetOBB.

Port of `aidet_tpu/models/detectors/single_stage.py::SingleStageDetector`
(parity: mmdet/models/detectors/single_stage.py + retinanet.py) with
its `RetinaNet` and `RetinaNetOBB` presets:

- `predict`: uint8 normalize, backbone, FPN (P3-P7 with extra convs),
  `RetinaHead`, each level's top ``nms_pre`` anchors by their best
  sigmoid score, then either the box decode clipped to the image and
  multiclass NMS (RetinaNet), or the rotated codec's decode against the
  axis-aligned anchors and multiclass NMS of the rboxes' quads by
  polygon IoU on the card's tensors (RetinaNetOBB, ``with_rbox``);
- `loss`: every anchor assigned by MaxIoU and weighed (no sampler),
  sigmoid focal loss and smooth L1 (beta 0.11) averaged by the
  positives, the rotated codec's deltas as the regression targets with
  ``with_rbox``.

With ``loss_type="free_anchor"`` (the `FreeAnchorRetinaNet` preset,
reference single_stage.py:159-168) the loss is FreeAnchor's bag
likelihood (`heads.free_anchor.free_anchor_loss`).  The cls loss is the
focal loss or GHMC, the box loss smooth L1, balanced L1 or GHMR; each
weighs every anchor (no sampler).

No RoIAlign runs on these paths, so none of the port's kernels is
launched.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.profiler import record_function

from ...core.anchors import build_pyramid_anchors
from ...core.rboxes import RBBOX_CODECS, pointobb2bbox
from ...ops.nms import nms_cfg_kwargs
from ..heads.anchor_head import (anchor_head_bboxes, anchor_head_loss,
                                 anchor_head_rboxes, flatten_level_outputs)
from ..heads.free_anchor import free_anchor_loss
from ..losses import FocalLoss, SmoothL1Loss
from ..preprocess import device_normalize
from .dense import _merge

DEFAULT_TRAIN_CFG = dict(
    assigner=dict(pos_iou_thr=0.5, neg_iou_thr=0.4, min_pos_iou=0),
    allowed_border=-1, pos_weight=-1)
DEFAULT_TEST_CFG = dict(nms_pre=1000, score_thr=0.05, nms_thr=0.5,
                        max_per_img=100)


class SingleStageDetector(nn.Module):
    """backbone + FPN + a dense head (``bbox_head``, a `RetinaHead`).

    Anchors: base size half the stride of each level (8..128), scales
    4 x 2^(0, 1/3, 2/3), ratios 0.5 / 1 / 2, as the reference's.  With
    ``with_rbox`` the head regresses ``rbox_encode``'s deltas (its
    ``reg_dim`` must be the codec's width) and predict suppresses
    rotated detections by polygon IoU at test_cfg's ``rnms_thr`` (else
    ``rnms_thr``).  ``compute_dtype``: as `TwoStageDetector`'s.
    """

    def __init__(self, backbone, neck, bbox_head, img_size=1024,
                 strides=(8, 16, 32, 64, 128),
                 anchor_scales=(4, 5.0396842, 6.3496042),
                 anchor_ratios=(0.5, 1.0, 2.0),
                 target_means=(0., 0., 0., 0.),
                 target_stds=(1., 1., 1., 1.), train_cfg=None,
                 test_cfg=None, with_rbox=False, rbox_encode="thetaobb",
                 rnms_thr=0.1, cls_loss=None, bbox_loss=None,
                 compute_dtype=None, loss_type="standard",
                 free_anchor_cfg=None):
        super().__init__()
        if loss_type not in ("standard", "free_anchor"):
            raise ValueError(f"loss_type {loss_type!r}: 'standard' or "
                             "'free_anchor'")
        if loss_type == "free_anchor" and with_rbox:
            raise ValueError("free_anchor regresses boxes: no with_rbox")
        self.loss_type = loss_type
        self.free_anchor_cfg = dict(free_anchor_cfg or {})
        self.backbone = backbone
        self.neck = neck
        self.bbox_head = bbox_head
        self.img_size = img_size
        self.strides = tuple(strides)
        self.anchor_scales = tuple(anchor_scales)
        self.anchor_ratios = tuple(anchor_ratios)
        self.train_cfg = _merge(DEFAULT_TRAIN_CFG, train_cfg)
        self.test_cfg = _merge(DEFAULT_TEST_CFG, test_cfg)
        self.with_rbox = with_rbox
        self.rbox_encode = rbox_encode
        self.rnms_thr = rnms_thr
        self.cls_loss = cls_loss or FocalLoss(gamma=2.0, alpha=0.25)
        self.bbox_loss = bbox_loss or SmoothL1Loss(beta=0.11)
        self.compute_dtype = compute_dtype
        dim = 4
        if with_rbox:
            dim = RBBOX_CODECS[rbox_encode][0]
            if bbox_head.reg_dim != dim:
                raise ValueError(
                    f"with_rbox={rbox_encode} needs a head with reg_dim="
                    f"{dim}, got {bbox_head.reg_dim}: set bbox_head=dict("
                    f"..., reg_dim={dim})")
        # the means and stds padded to the codec's width (0 and 1)
        self.target_means = (tuple(target_means) + (0.,) * dim)[:dim]
        self.target_stds = (tuple(target_stds) + (1.,) * dim)[:dim]
        anchors, sizes = self._anchors()
        self.register_buffer("anchors", anchors, persistent=False)
        self.level_sizes = sizes

    def _anchors(self):
        return build_pyramid_anchors(
            self.img_size, self.strides, self.anchor_scales,
            self.anchor_ratios, base_sizes=[s // 2 for s in self.strides])

    def _apply(self, fn, recurse=True):
        """Module.to and friends: the anchors follow the device but stay
        float32, as `TwoStageDetector`'s."""
        super()._apply(fn, recurse)
        if self.anchors.dtype != torch.float32:
            self.anchors = self._anchors()[0].to(self.anchors.device)
        return self

    @property
    def dtype(self):
        return self.bbox_head.retina_cls.weight.dtype

    @property
    def result_encode(self):
        """The encode of predict's ``rboxes``, or None without them."""
        return self.rbox_encode if self.with_rbox else None

    def extract_feat(self, imgs):
        with record_function("backbone"):
            feats = self.backbone(device_normalize(imgs, dtype=self.dtype))
        with record_function("neck"):
            return self.neck(feats)

    def _head(self, feats):
        with record_function("retina_head"):
            cls_out, reg_out = self.bbox_head(feats)
            return flatten_level_outputs(
                cls_out, reg_out, self.bbox_head.cls_out_channels,
                box_dim=self.bbox_head.reg_dim)

    @torch.no_grad()
    def predict(self, imgs, img_shapes, scale_factors=None):
        """imgs [B, H, W, 3] (uint8 BGR, or normalized floats),
        img_shapes [B, 2] (h, w), scale_factors [B] or None.  Returns
        boxes [B, K, 4], scores, labels (0-based, -1 if invalid) and
        valid [B, K]; with ``with_rbox`` also rboxes [B, K, D] in
        ``rbox_encode``, and the boxes are the axis-aligned hulls of
        their quads.  The heads, the sigmoid scores and their ranking
        run in the model's dtype; the decodes promote to float32
        against the float32 anchors."""
        ec = self.test_cfg
        img_shapes = img_shapes.float()
        cls_flat, reg_flat = self._head(self.extract_feat(imgs))
        common = dict(nms_pre=ec["nms_pre"], score_thr=ec["score_thr"],
                      max_per_img=ec["max_per_img"],
                      target_means=self.target_means,
                      target_stds=self.target_stds,
                      rescale_factors=scale_factors)
        if self.with_rbox:
            res, rboxes = anchor_head_rboxes(
                cls_flat, reg_flat, self.anchors, self.level_sizes,
                encode=self.rbox_encode,
                nms_thr=ec.get("rnms_thr", self.rnms_thr), **common)
            return dict(boxes=pointobb2bbox(res.boxes), scores=res.scores,
                        labels=res.labels, valid=res.valid, rboxes=rboxes)
        res = anchor_head_bboxes(cls_flat, reg_flat, self.anchors,
                                 self.level_sizes, img_shapes,
                                 nms_thr=ec["nms_thr"],
                                 nms_kwargs=nms_cfg_kwargs(ec), **common)
        return dict(boxes=res.boxes, scores=res.scores, labels=res.labels,
                    valid=res.valid)

    def loss(self, imgs, gt_boxes, gt_valid, gt_labels, img_shapes,
             gt_rboxes=None, generator: torch.Generator = None):
        """The training loss: imgs [B, S, S, 3] (uint8 BGR or normalized
        floats), gt_boxes [B, G, 4], gt_valid [B, G], gt_labels [B, G]
        (1-based), img_shapes [B, 2]; gt_rboxes [B, G, D] in
        ``rbox_encode`` (read only with ``with_rbox``).  ``generator``
        is not drawn from: no anchor is sampled.  The backbone, FPN and
        head run under autocast to ``compute_dtype``; the losses in
        float32.  Returns float32 scalars loss_cls and loss_bbox."""
        del generator
        if self.with_rbox and gt_rboxes is None:
            raise ValueError("a with_rbox detector needs gt_rboxes")
        cd = self.compute_dtype or self.dtype
        with torch.autocast(imgs.device.type, dtype=cd,
                            enabled=cd != self.dtype):
            cls_flat, reg_flat = self._head(self.extract_feat(imgs))
        tc = self.train_cfg
        if self.loss_type == "free_anchor":
            with record_function("free_anchor_loss"):
                return free_anchor_loss(
                    cls_flat.float(), reg_flat.float(), self.anchors,
                    gt_boxes.float(), gt_valid, gt_labels,
                    target_means=self.target_means,
                    target_stds=self.target_stds, **self.free_anchor_cfg)
        with record_function("retina_loss"):
            return anchor_head_loss(
                cls_flat.float(), reg_flat.float(), self.anchors,
                gt_boxes.float(), gt_valid, img_shapes.float(), None,
                gt_labels=gt_labels, target_means=self.target_means,
                target_stds=self.target_stds, cls_loss=self.cls_loss,
                bbox_loss=self.bbox_loss, assigner_cfg=tc["assigner"],
                allowed_border=tc["allowed_border"],
                pos_weight=tc["pos_weight"], sampling=False,
                gt_rboxes=gt_rboxes.float() if self.with_rbox else None,
                rbox_encode=self.rbox_encode if self.with_rbox else None)
