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

The reference's GARetinaHead (its single-stage twin) is not ported.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.deform_conv import deform_conv2d


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
