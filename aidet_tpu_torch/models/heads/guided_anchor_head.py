"""The guided-anchoring RPN head and its location and shape targets.

Port of `aidet_tpu/models/heads/guided_anchor_head.py::GARPNHead` :119
and `ga_targets` :182 (parity: mmdet's ga_rpn_head.py and
guided_anchor_target.py).  Each location of each level predicts an
anchor-presence logit (``conv_loc``) and an anchor shape (``conv_shape``:
log-width and log-height over 8 strides); the shape, without gradient,
drives the offsets (``adaption_offset``) of a 3x3 deformable conv
(``adapt``, `ops.deform_conv.deform_conv2d`) that adapts the features,
on which the objectness (``rpn_cls``) and the deltas (``rpn_reg``) of the
one guided anchor per location are predicted.  NHWC in and out.

`GARetinaHead` (reference :33) and the `GARetinaNet` detector (:238)
are the single-stage twins: RetinaNet's towers, the location logit from
the cls tower and the shape from the reg tower, one offset conv driving
a deformable conv on each tower (``adapt_cls``, ``adapt_reg``), then
3x3 class logits (``ga_cls``) and deltas (``ga_reg``) of the one guided
anchor a point; ``masked`` (the test path) zeroes both where the
location filter drops the point.  GARetinaNet's loss: the location focal
loss and the shape smooth L1 (beta 0.2) of `ga_targets`, then each
image's guided anchors (without gradient) assigned by MaxIoU (0.5 /
0.4), the focal loss and smooth L1 (beta 0.04) of each image by its
positives, averaged over the images.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ...core.anchors import anchor_target
from ...core.boxes import delta2bbox
from ...ops.deform_conv import deform_conv2d
from ...parallel.dist import global_count, global_mean
from ..detectors.dense import DenseDetector, level_topk
from ..losses import FocalLoss, SmoothL1Loss
from .anchor_head import sigmoid
from .fcos_head import Towers, nhwc, prior_bias


class GARPNHead(nn.Module):
    """``masked`` (the test path) multiplies the objectness and deltas by
    the location mask sigmoid(loc) > ``loc_filter_thr``, the dense form
    of the reference's masked convolution.  `init_prior` sets the
    reference's initial values that differ from `flagship.init_weights`':
    the location prior bias, N(0, 0.01) shape weights and zero
    offsets (the adaption is then a plain conv)."""

    cls_out_channels = 1

    def __init__(self, in_channels=256, feat_channels=256, prior_prob=0.01,
                 loc_filter_thr=0.01):
        super().__init__()
        self.prior_prob = prior_prob
        self.loc_filter_thr = loc_filter_thr
        self.rpn_conv = nn.Conv2d(in_channels, feat_channels, 3, padding=1)
        self.conv_loc = nn.Conv2d(feat_channels, 1, 1)
        self.conv_shape = nn.Conv2d(feat_channels, 2, 1)
        self.adaption_offset = nn.Conv2d(2, 2 * 9, 1, bias=False)
        self.adapt = nn.Conv2d(feat_channels, feat_channels, 3, padding=1,
                               bias=False)
        self.rpn_cls = nn.Conv2d(feat_channels, 1, 1)
        self.rpn_reg = nn.Conv2d(feat_channels, 4, 1)
        self.init_prior()

    @torch.no_grad()
    def init_prior(self):
        self.conv_loc.bias.fill_(
            -math.log((1 - self.prior_prob) / self.prior_prob))
        w = self.conv_shape.weight
        w.mul_(0.01 / w.std().clamp(min=1e-12))
        self.adaption_offset.weight.zero_()

    def forward(self, feats, masked=False):
        """feats: list of [B, H, W, C] -> (cls, shape, loc, reg) lists of
        [B, H, W, 1], [B, H, W, 2], [B, H, W, 1] and [B, H, W, 4]."""
        cls_out, shape_out, loc_out, reg_out = [], [], [], []
        for f in feats:
            x = F.relu(self.rpn_conv(f.permute(0, 3, 1, 2)))
            loc = self.conv_loc(x)
            shape = self.conv_shape(x)
            off = self.adaption_offset(shape.detach())
            adapted = F.relu(deform_conv2d(
                x.permute(0, 2, 3, 1), off.permute(0, 2, 3, 1),
                self.adapt.weight).permute(0, 3, 1, 2).to(x.dtype))
            cls = self.rpn_cls(adapted)
            reg = self.rpn_reg(adapted)
            if masked:
                m = (torch.sigmoid(loc) > self.loc_filter_thr).to(cls.dtype)
                cls = cls * m
                reg = reg * m
            for out, t in ((cls_out, cls), (shape_out, shape),
                           (loc_out, loc), (reg_out, reg)):
                out.append(t.permute(0, 2, 3, 1))
        return cls_out, shape_out, loc_out, reg_out


def ga_targets(points, pstrides, gt_boxes, gt_valid, center_ratio=0.2,
               ignore_ratio=0.5):
    """Location and shape targets of a batch (reference :182; parity:
    ga_loc_target and ga_shape_target).

    Each gt goes to the one level nearest its scale sqrt(w h) in log2
    over 8 strides; the points of that level inside the gt's central
    ``center_ratio`` box are positive, those inside its ``ignore_ratio``
    box on that level or the adjacent ones (and not positive) weigh 0.
    A positive point's shape target is log(w / 8s), log(h / 8s) of its
    smallest matching gt.

    points [P, 2], pstrides [P]; gt_boxes [B, G, 4], gt_valid [B, G].
    Returns (loc_tgt [B, P] float, loc_weight [B, P], shape_tgt [B, P,
    2], pos [B, P] bool)."""
    x = points[None, :, 0, None]                       # [1, P, 1]
    y = points[None, :, 1, None]
    cx = ((gt_boxes[..., 0] + gt_boxes[..., 2]) / 2)[:, None]   # [B, 1, G]
    cy = ((gt_boxes[..., 1] + gt_boxes[..., 3]) / 2)[:, None]
    w = (gt_boxes[..., 2] - gt_boxes[..., 0])[:, None]
    h = (gt_boxes[..., 3] - gt_boxes[..., 1])[:, None]
    scale = torch.sqrt((w * h).clamp(min=1e-6))
    min_stride = pstrides.min()
    gt_lvl = torch.minimum(
        torch.floor(torch.log2(scale[:, 0] / (min_stride * 8.0)) + 0.5)
        .clamp(min=0), torch.log2(pstrides.max() / min_stride))   # [B, G]
    pt_lvl = torch.log2(pstrides / min_stride)               # [P]
    lvl_match = pt_lvl[None, :, None] == gt_lvl[:, None]
    adj_match = (pt_lvl[None, :, None] - gt_lvl[:, None]).abs() == 1
    valid = gt_valid.bool()[:, None]

    def region(ratio):
        return (((x - cx).abs() <= 0.5 * ratio * w)
                & ((y - cy).abs() <= 0.5 * ratio * h))

    center = region(center_ratio) & lvl_match & valid
    ignore = region(ignore_ratio) & (lvl_match | adj_match) & valid
    pos = center.any(-1)
    loc_tgt = pos.float()
    loc_weight = torch.where(ignore.any(-1) & ~pos, 0.0, 1.0)
    areas = torch.where(center, w * h, w.new_tensor(1e10))
    gt_idx = areas.argmin(-1)                                # [B, P]
    base = pstrides * 8.0
    tw = torch.log((torch.gather(w[:, 0], 1, gt_idx) / base).clamp(min=1e-6))
    th = torch.log((torch.gather(h[:, 0], 1, gt_idx) / base).clamp(min=1e-6))
    shape_tgt = torch.stack([tw, th], -1) * pos[..., None]
    return loc_tgt, loc_weight, shape_tgt, pos


def adapt(x, off, weight):
    """ReLU of the 3x3 deformable conv of NCHW x with NCHW tap offsets
    ``off`` and ``weight`` [Cout, Cin, 3, 3], NCHW out."""
    return F.relu(deform_conv2d(nhwc(x), nhwc(off), weight).to(x.dtype)
                  .permute(0, 3, 1, 2))


class GARetinaHead(Towers):
    """`init_prior`: the location and class prior biases, N(0, 0.01)
    shape weights and zero offsets, as the reference initializes them."""

    def __init__(self, num_classes=16, in_channels=256, feat_channels=256,
                 stacked_convs=4, prior_prob=0.01, loc_filter_thr=0.01):
        super().__init__(in_channels, feat_channels, stacked_convs)
        self.num_classes = num_classes
        self.prior_prob = prior_prob
        self.loc_filter_thr = loc_filter_thr
        self.conv_loc = nn.Conv2d(feat_channels, 1, 1)
        self.conv_shape = nn.Conv2d(feat_channels, 2, 1)
        self.adaption_offset = nn.Conv2d(2, 2 * 9, 1, bias=False)
        self.adapt_cls = nn.Conv2d(feat_channels, feat_channels, 3,
                                   bias=False)
        self.adapt_reg = nn.Conv2d(feat_channels, feat_channels, 3,
                                   bias=False)
        self.ga_cls = nn.Conv2d(feat_channels, self.cls_out_channels, 3,
                                padding=1)
        self.ga_reg = nn.Conv2d(feat_channels, 4, 3, padding=1)
        self.init_prior()

    @property
    def cls_out_channels(self):
        return self.num_classes - 1

    @torch.no_grad()
    def init_prior(self):
        self.conv_loc.bias.fill_(prior_bias(self.prior_prob))
        self.ga_cls.bias.fill_(prior_bias(self.prior_prob))
        w = self.conv_shape.weight
        w.mul_(0.01 / w.std().clamp(min=1e-12))
        self.adaption_offset.weight.zero_()

    def forward(self, feats, masked=False):
        """feats: list of [B, H, W, C] -> (cls, shape, loc, reg) lists of
        [B, H, W, C'], [B, H, W, 2], [B, H, W, 1] and [B, H, W, 4]."""
        cls_out, shape_out, loc_out, reg_out = [], [], [], []
        for f in feats:
            c, r = self.towers(f)
            loc = self.conv_loc(c)
            shape = self.conv_shape(r)
            off = self.adaption_offset(shape.detach())
            cls = self.ga_cls(adapt(c, off, self.adapt_cls.weight))
            reg = self.ga_reg(adapt(r, off, self.adapt_reg.weight))
            if masked:
                m = (torch.sigmoid(loc) > self.loc_filter_thr).to(cls.dtype)
                cls = cls * m
                reg = reg * m
            for out, t in ((cls_out, cls), (shape_out, shape),
                           (loc_out, loc), (reg_out, reg)):
                out.append(nhwc(t))
        return cls_out, shape_out, loc_out, reg_out


class GARetinaNet(DenseDetector):
    test_defaults = dict(nms_pre=1000, score_thr=0.05, nms_thr=0.5,
                         max_per_img=100, loc_filter_thr=0.01)

    def __init__(self, backbone, neck, bbox_head, octave_base=8.0,
                 target_stds=(0.1, 0.1, 0.2, 0.2), **kwargs):
        super().__init__(backbone, neck, bbox_head, **kwargs)
        self.octave_base = octave_base
        self.target_stds = tuple(target_stds)
        self.cls_loss = FocalLoss(gamma=2.0, alpha=0.25)
        self.reg_loss = SmoothL1Loss(beta=0.04)
        self.loc_loss = FocalLoss(gamma=2.0, alpha=0.25)
        self.shape_loss = SmoothL1Loss(beta=0.2)

    def out_dims(self):
        return self.bbox_head.cls_out_channels, 2, 1, 4

    def guided_anchors(self, shape):
        """Each point's anchor [B, P, 4]: ``octave_base`` strides scaled
        by exp of the shape logits [B, P, 2], centred on the point."""
        base = self.pstrides * self.octave_base
        w = base * torch.exp(shape[..., 0])
        h = base * torch.exp(shape[..., 1])
        cx, cy = self.points[:, 0], self.points[:, 1]
        return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                           -1)

    def loss(self, imgs, gt_boxes, gt_valid, gt_labels, img_shapes,
             generator: torch.Generator = None):
        """loss_cls, loss_bbox, loss_shape and loss_loc of a batch
        (``img_shapes`` is not read: each image's anchors are all
        inside; ``generator`` is not drawn from, no anchor is
        sampled)."""
        cls_flat, shape_flat, loc_flat, reg_flat = self.head_outputs(
            imgs, train=True)
        gt_boxes = gt_boxes.float()
        loc_tgt, loc_w, shape_tgt, pos = ga_targets(
            self.points, self.pstrides, gt_boxes, gt_valid)
        out = dict(
            loss_loc=self.loc_loss(loc_flat, loc_tgt.to(torch.int32),
                                   weight=loc_w[..., None],
                                   avg_factor=global_count(
                                       loc_tgt.sum()).clamp(min=1.0)),
            loss_shape=self.shape_loss(
                shape_flat, shape_tgt,
                weight=pos[..., None].expand_as(shape_flat).float(),
                avg_factor=global_count(pos.sum().float()).clamp(min=1.0)))
        anchors = self.guided_anchors(shape_flat).detach()
        far = gt_boxes.new_full((1, 2), 1e4)
        lc, lb = [], []
        for i in range(imgs.shape[0]):
            tg = anchor_target(
                anchors[i], gt_boxes[i:i + 1], gt_valid[i:i + 1], far,
                generator, gt_labels=gt_labels[i:i + 1],
                target_stds=self.target_stds, allowed_border=-1,
                pos_iou_thr=0.5, neg_iou_thr=0.4, min_pos_iou=0.0,
                sampling=False)
            num = tg.num_total_pos.float()
            lc.append(self.cls_loss(cls_flat[i], tg.labels[0],
                                    weight=tg.label_weights[0],
                                    avg_factor=num))
            lb.append(self.reg_loss(reg_flat[i], tg.bbox_targets[0],
                                    weight=tg.bbox_weights[0],
                                    avg_factor=num))
        return dict(loss_cls=global_mean(torch.stack(lc)),
                    loss_bbox=global_mean(torch.stack(lb)), **out)

    @torch.no_grad()
    def predict(self, imgs, img_shapes, scale_factors=None):
        """The masked head; each level's top ``nms_pre`` points by
        sigmoid score where sigmoid(loc) > the test_cfg's
        loc_filter_thr (0 elsewhere), their guided anchors' decodes
        (stds 0.1 / 0.2) clipped to [0, w - 1] x [0, h - 1], then
        multiclass NMS."""
        cls_flat, shape_flat, loc_flat, reg_flat = self.head_outputs(
            imgs, masked=True)
        anchors = self.guided_anchors(shape_flat)
        keep = sigmoid(loc_flat) > self.test_cfg["loc_filter_thr"]
        scores = sigmoid(cls_flat) * keep
        idx = level_topk(scores, self.level_sizes, self.test_cfg["nms_pre"])
        bi = torch.arange(idx.shape[0], device=idx.device)[:, None]
        boxes = delta2bbox(anchors[bi, idx], reg_flat[bi, idx],
                           (0., 0., 0., 0.), self.target_stds,
                           max_shape=img_shapes.float()[:, None])
        return self.detections(boxes, scores[bi, idx], scale_factors)
