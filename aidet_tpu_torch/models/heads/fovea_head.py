"""FoveaBox: the head, its targets and the detector.

Port of `aidet_tpu/models/heads/fovea_head.py` (`FoveaHead` :27,
`fovea_target` :65, `FOVEA` :114; parity: mmdet's fovea_head.py and
detectors/fovea.py): per point sigmoid class logits and log-space
edge distances in strides; a point is positive inside the sigma-shrunk
fovea of a gt whose sqrt-area lies in its level's scale range.  The
loss: the focal loss (gamma 1.5, alpha 0.4) by the positives and smooth
L1 (beta 0.11, weight 0.75) over the positives' four targets.  NHWC in
and out.
"""

from __future__ import annotations

import torch
from torch import nn

from ...core.points import level_values
from ...parallel.dist import global_count
from ..detectors.dense import DenseDetector, level_topk
from ..losses import FocalLoss, SmoothL1Loss
from .anchor_head import sigmoid
from .fcos_head import Towers, nhwc, prior_bias

FOVEA_SCALE_RANGES = ((1, 64), (32, 128), (64, 256), (128, 512),
                      (256, 2048))
INF = 1e8


class FoveaHead(Towers):
    def __init__(self, num_classes=16, in_channels=256, feat_channels=256,
                 stacked_convs=4, prior_prob=0.01):
        super().__init__(in_channels, feat_channels, stacked_convs)
        self.num_classes = num_classes
        self.prior_prob = prior_prob
        self.fovea_cls = nn.Conv2d(feat_channels, self.cls_out_channels, 3,
                                   padding=1)
        self.fovea_reg = nn.Conv2d(feat_channels, 4, 3, padding=1)
        self.init_prior()

    @property
    def cls_out_channels(self):
        return self.num_classes - 1

    @torch.no_grad()
    def init_prior(self):
        self.fovea_cls.bias.fill_(prior_bias(self.prior_prob))

    def forward(self, feats):
        cls_out, reg_out = [], []
        for f in feats:
            c, r = self.towers(f)
            cls_out.append(nhwc(self.fovea_cls(c)))
            reg_out.append(nhwc(self.fovea_reg(r)))
        return cls_out, reg_out


def fovea_target(points, pstrides, scale_ranges, gt_boxes, gt_valid,
                 gt_labels, sigma=0.4):
    """Fovea targets of a batch: points [P, 2], pstrides [P],
    scale_ranges [P, 2]; gt_boxes [B, G, 4], gt_valid [B, G], gt_labels
    [B, G].  A point is positive inside the fovea (the gt's box shrunk
    to ``sigma`` of its size about its centre) of a valid gt whose
    sqrt(w h) lies in the point's scale range; the smallest such gt wins
    (the first of equal areas).  Returns (labels [B, P] int32, targets
    [B, P, 4]: log of the point's distances to the gt's x1, y1, x2, y2
    in strides (at least 1e-6), zero where negative; pos [B, P])."""
    x = points[None, :, 0, None]
    y = points[None, :, 1, None]
    g = gt_boxes[:, None]                               # [B, 1, G, 4]
    gx1, gy1, gx2, gy2 = g.unbind(-1)
    cx = (gx1 + gx2) / 2
    cy = (gy1 + gy2) / 2
    w = gx2 - gx1
    h = gy2 - gy1
    inside = ((x >= cx - 0.5 * sigma * w) & (x <= cx + 0.5 * sigma * w)
              & (y >= cy - 0.5 * sigma * h) & (y <= cy + 0.5 * sigma * h))
    scale = torch.sqrt((w * h).clamp(min=1e-6))
    in_range = ((scale >= scale_ranges[None, :, 0, None])
                & (scale <= scale_ranges[None, :, 1, None]))
    areas = torch.where(inside & in_range & gt_valid.bool()[:, None],
                        w * h, w.new_tensor(INF))
    min_area, gt_idx = areas.min(-1)                    # [B, P]
    pos = min_area < INF
    labels = torch.where(pos, torch.gather(gt_labels.to(torch.int32), 1,
                                           gt_idx), 0)
    m = torch.gather(gt_boxes, 1, gt_idx[..., None].expand(-1, -1, 4))
    px, py = points[:, 0], points[:, 1]
    eps = 1e-6
    tgt = torch.stack([
        torch.log(((px - m[..., 0]) / pstrides).clamp(min=eps)),
        torch.log(((py - m[..., 1]) / pstrides).clamp(min=eps)),
        torch.log(((m[..., 2] - px) / pstrides).clamp(min=eps)),
        torch.log(((m[..., 3] - py) / pstrides).clamp(min=eps))], -1)
    return labels.to(torch.int32), tgt * pos[..., None], pos


class FOVEA(DenseDetector):
    def __init__(self, backbone, neck, bbox_head, **kwargs):
        super().__init__(backbone, neck, bbox_head, **kwargs)
        self.cls_loss = FocalLoss(gamma=1.5, alpha=0.4)
        self.reg_loss = SmoothL1Loss(beta=0.11, loss_weight=0.75)

    def constants(self):
        out = super().constants()
        out["scale_ranges"] = level_values(self.level_sizes,
                                           FOVEA_SCALE_RANGES)
        return out

    def out_dims(self):
        return self.bbox_head.cls_out_channels, 4

    def loss(self, imgs, gt_boxes, gt_valid, gt_labels, img_shapes,
             generator: torch.Generator = None):
        """loss_cls and loss_bbox of a batch (``img_shapes`` and
        ``generator`` are not read)."""
        cls_flat, reg_flat = self.head_outputs(imgs, train=True)
        labels, tgts, pos = fovea_target(
            self.points, self.pstrides, self.scale_ranges, gt_boxes.float(),
            gt_valid, gt_labels)
        num_pos = global_count(pos.sum().float()).clamp(min=1.0)
        return dict(
            loss_cls=self.cls_loss(cls_flat, labels, avg_factor=num_pos),
            loss_bbox=self.reg_loss(reg_flat, tgts,
                                    weight=pos[..., None].expand_as(tgts)
                                    .float(), avg_factor=num_pos * 4))

    @torch.no_grad()
    def predict(self, imgs, img_shapes, scale_factors=None):
        """Each level's top ``nms_pre`` points by sigmoid score, boxes
        point -+ exp(reg) x stride clipped to [0, w] x [0, h], then
        multiclass NMS (as `FCOS.predict`)."""
        cls_flat, reg_flat = self.head_outputs(imgs)
        scores = sigmoid(cls_flat)
        idx = level_topk(scores, self.level_sizes, self.test_cfg["nms_pre"])
        bi = torch.arange(idx.shape[0], device=idx.device)[:, None]
        pts = self.points[idx]
        d = torch.exp(reg_flat[bi, idx]) * self.pstrides[idx][..., None]
        shape = img_shapes.float()[:, None]
        h, w = shape[..., 0], shape[..., 1]
        boxes = torch.stack([
            torch.minimum((pts[..., 0] - d[..., 0]).clamp(min=0), w),
            torch.minimum((pts[..., 1] - d[..., 1]).clamp(min=0), h),
            torch.minimum((pts[..., 0] + d[..., 2]).clamp(min=0), w),
            torch.minimum((pts[..., 1] + d[..., 3]).clamp(min=0), h)], -1)
        return self.detections(boxes, scores[bi, idx], scale_factors)
