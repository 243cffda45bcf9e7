"""SSD300: the anchors, the head and the detector.

Port of `aidet_tpu/models/heads/ssd_head.py` (`build_ssd_anchors` :30,
`SSDHead` :77, `SSD` :97; parity: mmdet's ssd_head.py and the SSD300
config): 8732 anchors on the six maps (38, 19, 10, 5, 3, 1) of a 300^2
input, per-level 3x3 class (softmax, background at 0) and delta convs.
The loss: MaxIoU (0.5 / 0.5, each gt its one best anchor), softmax
cross entropy over the positives and the 3x as many negatives of
highest loss (`core.sample.topk_mask_by_score`), smooth L1 (beta 1) of
the deltas (stds 0.1 / 0.2) over the positives, each image's by its
positives, averaged over the images.  The detector reads the images as
they are (no normalize), as the reference's.  The anchors are SSD300's
whatever ``input_size``, as the reference builds them; an input whose
maps are not SSD300's raises a ValueError when the detector is built
(the reference fails on the same configs, SSD512's, in its loss and
predict).  NHWC in and out.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...core.anchors import AnchorGenerator
from ...core.assign import max_iou_assign
from ...core.boxes import bbox2delta, delta2bbox
from ...core.sample import topk_mask_by_score
from ...parallel.dist import global_mean
from ..backbones.ssd_vgg import ssd_feat_sizes
from ..detectors.dense import DenseDetector

SSD300_FEAT_SIZES = (38, 19, 10, 5, 3, 1)
SSD300_STRIDES = (8, 16, 32, 64, 100, 300)
SSD300_RATIOS = ((2,), (2, 3), (2, 3), (2, 3), (2,), (2,))
SSD300_BASESIZE_RANGE = (0.15, 0.9)   # of the input size
SSD_STDS = (0.1, 0.1, 0.2, 0.2)


def build_ssd_anchors(input_size=300, feat_sizes=SSD300_FEAT_SIZES,
                      strides=SSD300_STRIDES, ratios_per_level=SSD300_RATIOS,
                      basesize_range=SSD300_BASESIZE_RANGE):
    """(anchors [A, 4] float32 CPU tensor, anchors per level): each
    level's min and max sizes from the base-size range, scales 1 and
    sqrt(max / min), ratios 1, 1 / r, r; ratio 1 at both scales, the
    others at scale 1, centred at ((stride - 1) / 2) of each cell."""
    min_ratio, max_ratio = basesize_range
    step = (max_ratio - min_ratio) / (len(feat_sizes) - 2)
    min_sizes = [input_size * (0.07 if input_size == 300 else 0.04)]
    max_sizes = []
    r = min_ratio
    for _ in range(len(feat_sizes) - 1):
        min_sizes.append(round(input_size * r))
        max_sizes.append(round(input_size * (r + step)))
        r += step
    max_sizes = [round(input_size * min_ratio)] + max_sizes
    anchors, sizes = [], []
    for k, fs in enumerate(feat_sizes):
        mn, mx = float(min_sizes[k]), float(max_sizes[k])
        ratios = [1.0]
        for rr in ratios_per_level[k]:
            ratios += [1.0 / rr, rr]
        stride = strides[k]
        gen = AnchorGenerator(mn, [1.0, math.sqrt(mx / mn)], ratios,
                              scale_major=False,
                              ctr=((stride - 1) / 2.0, (stride - 1) / 2.0))
        n_r = len(ratios)
        gen.base_anchors = gen.base_anchors[[0, n_r] + list(range(1, n_r))]
        a = gen.grid_anchors((fs, fs), stride)
        anchors.append(a)
        sizes.append(a.shape[0])
    return torch.from_numpy(np.concatenate(anchors)), sizes


class SSDHead(nn.Module):
    def __init__(self, num_classes=21,
                 in_channels=(512, 1024, 512, 256, 256, 256),
                 num_anchors=(4, 6, 6, 6, 4, 4)):
        super().__init__()
        self.num_classes = num_classes
        self.num_anchors = tuple(num_anchors)
        for i, (c, a) in enumerate(zip(in_channels, num_anchors)):
            self.add_module(f"cls{i}", nn.Conv2d(c, a * num_classes, 3,
                                                 padding=1))
            self.add_module(f"reg{i}", nn.Conv2d(c, a * 4, 3, padding=1))

    def forward(self, feats):
        """feats: six [B, H, W, C] -> (cls [B, H, W, A x classes], deltas
        [B, H, W, A x 4]) lists."""
        cls_out, reg_out = [], []
        for i, f in enumerate(feats):
            x = f.permute(0, 3, 1, 2)
            cls_out.append(getattr(self, f"cls{i}")(x).permute(0, 2, 3, 1))
            reg_out.append(getattr(self, f"reg{i}")(x).permute(0, 2, 3, 1))
        return cls_out, reg_out


class SSD(DenseDetector):
    test_defaults = dict(nms_pre=1000, score_thr=0.02, nms_thr=0.45,
                         max_per_img=200, target_stds=SSD_STDS)
    train_defaults = dict(pos_iou_thr=0.5, neg_iou_thr=0.5, min_pos_iou=0.0,
                          neg_pos_ratio=3.0, target_stds=SSD_STDS)

    def __init__(self, backbone, bbox_head, input_size=300, **kwargs):
        kwargs.setdefault("img_size", input_size)
        self.input_size = input_size
        maps = ssd_feat_sizes(input_size)
        if maps != SSD300_FEAT_SIZES:
            n = sum(s * s * a for s, a in zip(maps, bbox_head.num_anchors))
            raise ValueError(
                f"SSD input_size {input_size}: the backbone's maps {maps} "
                f"give {n} anchors, but the anchors are SSD300's 8732 on "
                f"{SSD300_FEAT_SIZES} (the reference's build_ssd_anchors "
                "ladder)")
        super().__init__(backbone, None, bbox_head, strides=(), **kwargs)

    def constants(self):
        anchors, self.level_sizes = build_ssd_anchors(self.input_size)
        return dict(anchors=anchors)

    def out_dims(self):
        return self.bbox_head.num_classes, 4

    def loss(self, imgs, gt_boxes, gt_valid, gt_labels, img_shapes,
             generator: torch.Generator = None):
        """loss_cls and loss_bbox of a batch (``img_shapes`` and
        ``generator`` are not read)."""
        tc = self.train_cfg
        cls_flat, reg_flat = self.head_outputs(imgs, train=True)
        gt_boxes = gt_boxes.float()
        b = gt_boxes.shape[0]
        res = max_iou_assign(self.anchors.expand(b, -1, -1), gt_boxes,
                             gt_valid, gt_labels,
                             pos_iou_thr=tc["pos_iou_thr"],
                             neg_iou_thr=tc["neg_iou_thr"],
                             min_pos_iou=tc["min_pos_iou"],
                             gt_max_assign_all=False)
        pos = res.gt_inds > 0
        neg = res.gt_inds == 0
        labels = torch.where(pos, res.labels, 0).long()
        ce = -torch.gather(F.log_softmax(cls_flat, -1), -1,
                           labels[..., None])[..., 0]
        num_pos = pos.sum(-1)
        k_neg = (tc["neg_pos_ratio"] * num_pos.clamp(min=1)).long()
        hard_neg = topk_mask_by_score(neg, ce.detach(), k_neg)
        denom = num_pos.clamp(min=1).float()
        loss_cls = (ce * (pos | hard_neg)).sum(-1) / denom
        safe = (res.gt_inds.long() - 1).clamp(0, gt_boxes.shape[1] - 1)
        matched = torch.gather(gt_boxes, 1, safe[..., None].expand(-1, -1, 4))
        deltas = bbox2delta(self.anchors, matched, (0., 0., 0., 0.),
                            tc["target_stds"])
        diff = (reg_flat - deltas).abs()
        sl1 = torch.where(diff < 1.0, 0.5 * diff * diff, diff - 0.5)
        loss_bbox = (sl1.sum(-1) * pos).sum(-1) / denom
        return dict(loss_cls=global_mean(loss_cls),
                    loss_bbox=global_mean(loss_bbox))

    @torch.no_grad()
    def predict(self, imgs, img_shapes, scale_factors=None):
        """Every anchor's softmax scores and decoded box (clipped to [0, w
        - 1] x [0, h - 1]) into multiclass NMS at the test_cfg's
        score_thr (0.02), nms_thr (0.45) and max_per_img (200)."""
        cls_flat, reg_flat = self.head_outputs(imgs)
        boxes = delta2bbox(self.anchors, reg_flat, (0., 0., 0., 0.),
                           self.test_cfg["target_stds"],
                           max_shape=img_shapes.float()[:, None])
        return self.detections(boxes, torch.softmax(cls_flat, -1),
                               scale_factors, background=True)
