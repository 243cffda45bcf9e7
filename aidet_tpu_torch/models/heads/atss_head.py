"""ATSS: the head and detector.

Port of `aidet_tpu/models/heads/atss_head.py` (`ATSSHead` :24, `ATSS`
:68; parity: mmdet's atss_head.py and detectors/atss.py): RetinaNet's
towers over one square anchor a location (8 strides), sigmoid class
logits, deltas x scale{l} (a learnable scalar per level, no exp) and a
centerness logit from the reg tower.  The loss: `core.atss.atss_assign`,
the focal loss over every anchor by the positives, the GIoU loss
(weight 2) of the decoded boxes (stds 0.1 / 0.2) weighted by the
centerness of each anchor's centre in its gt (`centerness_target`),
and the centerness BCE over the positives.  NHWC in and out.
"""

from __future__ import annotations

import torch
from torch import nn

from ...core.anchors import build_pyramid_anchors
from ...core.atss import atss_assign
from ...core.boxes import delta2bbox
from ...parallel.dist import global_count
from ..detectors.dense import DenseDetector, level_topk
from ..losses import CrossEntropyLoss, FocalLoss, GIoULoss
from .anchor_head import sigmoid
from .fcos_head import Towers, nhwc, prior_bias

ATSS_STDS = (0.1, 0.1, 0.2, 0.2)


class ATSSHead(Towers):
    def __init__(self, num_classes=16, in_channels=256, feat_channels=256,
                 stacked_convs=4, num_anchors=1, prior_prob=0.01,
                 num_levels=5):
        super().__init__(in_channels, feat_channels, stacked_convs)
        self.num_classes = num_classes
        self.prior_prob = prior_prob
        self.atss_cls = nn.Conv2d(feat_channels,
                                  num_anchors * self.cls_out_channels, 3,
                                  padding=1)
        self.atss_reg = nn.Conv2d(feat_channels, num_anchors * 4, 3,
                                  padding=1)
        self.atss_centerness = nn.Conv2d(feat_channels, num_anchors, 3,
                                         padding=1)
        for lvl in range(num_levels):
            self.register_parameter(f"scale{lvl}",
                                    nn.Parameter(torch.ones(())))
        self.init_prior()

    @property
    def cls_out_channels(self):
        return self.num_classes - 1

    @torch.no_grad()
    def init_prior(self):
        self.atss_cls.bias.fill_(prior_bias(self.prior_prob))

    def forward(self, feats):
        cls_out, reg_out, ctr_out = [], [], []
        for lvl, f in enumerate(feats):
            c, r = self.towers(f)
            cls_out.append(nhwc(self.atss_cls(c)))
            reg_out.append(nhwc(self.atss_reg(r)
                                * getattr(self, f"scale{lvl}")))
            ctr_out.append(nhwc(self.atss_centerness(r)))
        return cls_out, reg_out, ctr_out


def centerness_target(anchors, gts):
    """ATSS's centerness of each anchor's centre in its matched gt:
    sqrt(min(l, r) / max(l, r) x min(t, b) / max(t, b)) (reference
    :119)."""
    ax = (anchors[..., 0] + anchors[..., 2]) * 0.5
    ay = (anchors[..., 1] + anchors[..., 3]) * 0.5
    lr = torch.stack([ax - gts[..., 0], gts[..., 2] - ax], -1)
    tb = torch.stack([ay - gts[..., 1], gts[..., 3] - ay], -1)
    c = (lr.amin(-1) / lr.amax(-1).clamp(min=1e-6)
         * (tb.amin(-1) / tb.amax(-1).clamp(min=1e-6)))
    return torch.sqrt(c.clamp(0.0, 1.0))


class ATSS(DenseDetector):
    test_defaults = dict(nms_pre=1000, score_thr=0.05, nms_thr=0.6,
                         max_per_img=100)
    train_defaults = dict(topk=9)

    def __init__(self, backbone, neck, bbox_head, **kwargs):
        super().__init__(backbone, neck, bbox_head, **kwargs)
        self.cls_loss = FocalLoss(gamma=2.0, alpha=0.25)
        self.reg_loss = GIoULoss(loss_weight=2.0)
        self.ctr_loss = CrossEntropyLoss(use_sigmoid=True)

    def constants(self):
        # one anchor a location, 8 strides square
        anchors, self.level_sizes = build_pyramid_anchors(
            self.img_size, self.strides, scales=(1.0,), ratios=(1.0,),
            base_sizes=[8 * s for s in self.strides])
        return dict(anchors=anchors)

    def out_dims(self):
        return self.bbox_head.cls_out_channels, 4, 1

    def loss(self, imgs, gt_boxes, gt_valid, gt_labels, img_shapes,
             generator: torch.Generator = None):
        """loss_cls, loss_bbox and loss_centerness of a batch (as
        `FCOS.loss`; ``img_shapes`` and ``generator`` are not read)."""
        cls_flat, reg_flat, ctr_flat = self.head_outputs(imgs, train=True)
        gt_boxes = gt_boxes.float()
        assigned, labels = atss_assign(self.anchors, self.level_sizes,
                                       gt_boxes, gt_valid, gt_labels,
                                       topk=self.train_cfg["topk"])
        pos = assigned > 0
        num_pos = global_count(pos.sum().float()).clamp(min=1.0)
        safe = (assigned.long() - 1).clamp(0, gt_boxes.shape[1] - 1)
        matched = torch.gather(gt_boxes, 1, safe[..., None].expand(-1, -1,
                                                                  4))
        decoded = delta2bbox(self.anchors, reg_flat, (0., 0., 0., 0.),
                             ATSS_STDS)
        ctr = centerness_target(self.anchors, matched) * pos
        return dict(
            loss_cls=self.cls_loss(cls_flat, labels, avg_factor=num_pos),
            loss_bbox=self.reg_loss(decoded.reshape(-1, 4),
                                    matched.reshape(-1, 4),
                                    weight=ctr.reshape(-1),
                                    avg_factor=global_count(
                                        ctr.sum()).clamp(min=1e-6)),
            loss_centerness=self.ctr_loss(
                ctr_flat.reshape(-1, 1), ctr.reshape(-1, 1),
                weight=pos.reshape(-1, 1).float(), avg_factor=num_pos))

    @torch.no_grad()
    def predict(self, imgs, img_shapes, scale_factors=None):
        """As `FCOS.predict`, the boxes decoded from the anchors (stds
        0.1 / 0.2) and clipped to [0, w - 1] x [0, h - 1]."""
        cls_flat, reg_flat, ctr_flat = self.head_outputs(imgs)
        scores = sigmoid(cls_flat) * sigmoid(ctr_flat)
        idx = level_topk(scores, self.level_sizes, self.test_cfg["nms_pre"])
        bi = torch.arange(idx.shape[0], device=idx.device)[:, None]
        boxes = delta2bbox(self.anchors[idx], reg_flat[bi, idx],
                           (0., 0., 0., 0.), ATSS_STDS,
                           max_shape=img_shapes.float()[:, None])
        return self.detections(boxes, scores[bi, idx], scale_factors)
