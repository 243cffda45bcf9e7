"""FCOS: the anchor-free head and detector.

Port of `aidet_tpu/models/heads/fcos_head.py` (`FCOSHead` :26, `FCOS`
:71; parity: mmdet's fcos_head.py and detectors/fcos.py): per point
sigmoid class logits, (l, t, r, b) distances exp(reg x scale{l}) with a
learnable scalar per level, and a centerness logit from the cls tower.
The loss: `core.points.fcos_target` (with ``center_sampling`` the
centre region of each gt, radius ``center_sample_radius`` strides), the
focal loss over every point by the positives, the IoU loss of the
decoded boxes weighted by the centerness targets, the centerness BCE
over the positives.  NHWC in and out.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ...core.boxes import distance2bbox
from ...core.points import fcos_target, level_values
from ...parallel.dist import global_count
from ..detectors.dense import DenseDetector, level_topk
from ..losses import CrossEntropyLoss, FocalLoss, IoULoss
from .anchor_head import sigmoid

FCOS_REGRESS_RANGES = ((-1, 64), (64, 128), (128, 256), (256, 512),
                       (512, 1e8))


def prior_bias(prior_prob):
    """The focal loss's prior as a logit, -log((1 - p) / p)."""
    return -math.log((1 - prior_prob) / prior_prob)


class Towers(nn.Module):
    """``stacked_convs`` 3x3 convs with ReLU in a cls and a reg tower
    (``cls_conv{i}``, ``reg_conv{i}``), shared by every level; with
    ``norms`` a norm after each conv (``{cls,reg}_{norm_name}{i}``, the
    convs then without bias)."""

    def __init__(self, in_channels, feat_channels, stacked_convs,
                 norms=None, norm_name="gn"):
        super().__init__()
        self.stacked_convs = stacked_convs
        self.norm_name = norm_name if norms else None
        for i in range(stacked_convs):
            cin = in_channels if i == 0 else feat_channels
            for kind in ("cls", "reg"):
                self.add_module(f"{kind}_conv{i}", nn.Conv2d(
                    cin, feat_channels, 3, padding=1, bias=not norms))
                if norms:
                    self.add_module(f"{kind}_{norm_name}{i}", norms())

    def towers(self, f):
        """NHWC f -> the cls and reg towers' NCHW maps."""
        c = r = f.permute(0, 3, 1, 2)
        for i in range(self.stacked_convs):
            c = getattr(self, f"cls_conv{i}")(c)
            r = getattr(self, f"reg_conv{i}")(r)
            if self.norm_name:
                c = getattr(self, f"cls_{self.norm_name}{i}")(c)
                r = getattr(self, f"reg_{self.norm_name}{i}")(r)
            c, r = F.relu(c), F.relu(r)
        return c, r


def nhwc(x):
    return x.permute(0, 2, 3, 1)


class FCOSHead(Towers):
    def __init__(self, num_classes=16, in_channels=256, feat_channels=256,
                 stacked_convs=4, prior_prob=0.01, num_levels=5):
        super().__init__(in_channels, feat_channels, stacked_convs)
        self.num_classes = num_classes
        self.prior_prob = prior_prob
        self.fcos_cls = nn.Conv2d(feat_channels, self.cls_out_channels, 3,
                                  padding=1)
        self.fcos_reg = nn.Conv2d(feat_channels, 4, 3, padding=1)
        self.fcos_centerness = nn.Conv2d(feat_channels, 1, 3, padding=1)
        for lvl in range(num_levels):
            self.register_parameter(f"scale{lvl}",
                                    nn.Parameter(torch.ones(())))
        self.init_prior()

    @property
    def cls_out_channels(self):
        return self.num_classes - 1

    @torch.no_grad()
    def init_prior(self):
        self.fcos_cls.bias.fill_(prior_bias(self.prior_prob))

    def forward(self, feats):
        """feats: list of [B, H, W, C] -> (cls [B, H, W, C'], distances
        [B, H, W, 4], centerness [B, H, W, 1]) lists."""
        cls_out, reg_out, ctr_out = [], [], []
        for lvl, f in enumerate(feats):
            c, r = self.towers(f)
            scale = getattr(self, f"scale{lvl}")
            cls_out.append(nhwc(self.fcos_cls(c)))
            reg_out.append(nhwc(torch.exp(self.fcos_reg(r) * scale)))
            ctr_out.append(nhwc(self.fcos_centerness(c)))
        return cls_out, reg_out, ctr_out


class FCOS(DenseDetector):
    def __init__(self, backbone, neck, bbox_head, center_sampling=False,
                 center_sample_radius=1.5, **kwargs):
        super().__init__(backbone, neck, bbox_head, **kwargs)
        self.center_sample_radius = (center_sample_radius
                                     if center_sampling else 0.0)
        self.cls_loss = FocalLoss(gamma=2.0, alpha=0.25)
        self.iou_loss = IoULoss()
        self.ctr_loss = CrossEntropyLoss(use_sigmoid=True)

    def constants(self):
        out = super().constants()
        out["regress_ranges"] = level_values(self.level_sizes,
                                             FCOS_REGRESS_RANGES)
        return out

    def out_dims(self):
        return self.bbox_head.cls_out_channels, 4, 1

    def loss(self, imgs, gt_boxes, gt_valid, gt_labels, img_shapes,
             generator: torch.Generator = None):
        """The training losses (loss_cls, loss_bbox, loss_centerness) of
        a batch: imgs [B, S, S, 3], gt_boxes [B, G, 4], gt_valid [B, G],
        gt_labels [B, G] (1-based); ``img_shapes`` and ``generator``
        are not read."""
        cls_flat, reg_flat, ctr_flat = self.head_outputs(imgs, train=True)
        labels, tgts, ctr = fcos_target(
            self.points, self.regress_ranges, gt_boxes.float(), gt_valid,
            gt_labels, strides=self.pstrides,
            center_sample_radius=self.center_sample_radius)
        pos = labels > 0
        num_pos = global_count(pos.sum().float()).clamp(min=1.0)
        decoded = distance2bbox(self.points, reg_flat)
        target = distance2bbox(self.points, tgts)
        return dict(
            loss_cls=self.cls_loss(cls_flat, labels, avg_factor=num_pos),
            loss_bbox=self.iou_loss(decoded.reshape(-1, 4),
                                    target.reshape(-1, 4),
                                    weight=ctr.reshape(-1),
                                    avg_factor=global_count(
                                        ctr.sum()).clamp(min=1e-6)),
            loss_centerness=self.ctr_loss(
                ctr_flat.reshape(-1, 1), ctr.reshape(-1, 1),
                weight=pos.reshape(-1, 1).float(), avg_factor=num_pos))

    @torch.no_grad()
    def predict(self, imgs, img_shapes, scale_factors=None):
        """imgs [B, H, W, 3] (uint8 or float, fed to the backbone as
        they are), img_shapes [B, 2] (h, w).  Returns boxes [B, K, 4]
        clipped to [0, w] x [0, h], scores, labels (0-based, -1
        invalid) and valid [B, K]: each level's top ``nms_pre`` points
        by sigmoid(cls) x sigmoid(centerness), then multiclass NMS."""
        cls_flat, reg_flat, ctr_flat = self.head_outputs(imgs)
        scores = sigmoid(cls_flat) * sigmoid(ctr_flat)
        idx = level_topk(scores, self.level_sizes, self.test_cfg["nms_pre"])
        bi = torch.arange(idx.shape[0], device=idx.device)[:, None]
        boxes = distance2bbox(self.points[idx], reg_flat[bi, idx],
                              max_shape=img_shapes.float()[:, None])
        return self.detections(boxes, scores[bi, idx], scale_factors)
