"""RepPoints: the head, the point-to-box transforms and the detector.

Port of `aidet_tpu/models/heads/reppoints_head.py` (`points2bbox_minmax`
:25, `points2bbox_moment` :34, `RepPointsHead` :58, `RepPointsDetector`
:151; parity: mmdet's reppoints_head.py and reppoints_detector.py).
Each point of each level predicts ``num_points`` (dy, dx) offsets in
strides twice: an initial set from the reg tower (``pts_init_*``), and
a refinement added to it (``pts_refine_out``, the initial set without
gradient); both the classification and the refinement read their
tower through a 3x3 deformable conv (`ops.deform_conv.deform_conv2d`,
weights ``cls_dconv`` and ``refine_dconv``) whose tap offsets are the
initial points minus the 3x3 grid, through ``gradient_mul`` of their
gradient.  The towers carry GroupNorm (epsilon 1e-6, flax's default)
with ``norm_cfg=dict(type="GN", num_groups=N)`` (the builder takes no
other norm).  The detector turns a point set into a box by
``transform_method``: "minmax", "partial_minmax" (the first 4 points) or
"moment" (mean -+ std x exp(moment_transfer), a learned 2-vector that
receives ``moment_mul`` of its gradient).  The loss: the init set
assigned by `core.assign.point_assign`, the refined set by MaxIoU of
the (detached) init boxes, smooth L1 (beta 0.11, weights 0.5 and 1) of
the boxes over 4 strides, the focal loss by the refined positives.
NHWC in and out.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...core.assign import max_iou_assign, point_assign
from ...ops.deform_conv import deform_conv2d
from ...parallel.dist import global_count
from ..backbones.resnet import GroupNorm
from ..detectors.dense import DenseDetector, level_topk
from ..losses import FocalLoss, SmoothL1Loss
from .anchor_head import sigmoid
from .fcos_head import Towers, nhwc, prior_bias

# the 3x3 deformable conv's taps as (dy, dx), row-major
GRID = tuple(v for dy in (-1, 0, 1) for dx in (-1, 0, 1) for v in (dy, dx))


def partial_grad(x, mul):
    """x forward, ``mul`` of its gradient backward: x m + x.detach() (1 -
    m), as the reference writes it."""
    return x * mul + x.detach() * (1 - mul)


def points2bbox_minmax(pts):
    """[..., 2 N] point offsets (x, y pairs) -> [..., 4] min-max boxes."""
    xs, ys = pts[..., 0::2], pts[..., 1::2]
    return torch.stack([xs.amin(-1), ys.amin(-1), xs.amax(-1),
                        ys.amax(-1)], -1)


def points2bbox_moment(x, y, moment_transfer, moment_mul):
    """The moment transform of points x, y [..., N]: mean -+ std x
    exp(transfer), the std unbiased (ddof 1) with its variance clamped
    at 1e-12 (so that coincident points have a finite gradient), the
    transfer through ``moment_mul`` of its gradient."""
    mt = partial_grad(moment_transfer, moment_mul)
    n = x.shape[-1]
    x_mean, y_mean = x.mean(-1), y.mean(-1)
    x_std = torch.sqrt((((x - x_mean[..., None]) ** 2).sum(-1) / (n - 1))
                       .clamp(min=1e-12))
    y_std = torch.sqrt((((y - y_mean[..., None]) ** 2).sum(-1) / (n - 1))
                       .clamp(min=1e-12))
    half_w = x_std * torch.exp(mt[0])
    half_h = y_std * torch.exp(mt[1])
    return torch.stack([x_mean - half_w, y_mean - half_h,
                        x_mean + half_w, y_mean + half_h], -1)


class RepPointsHead(Towers):
    def __init__(self, num_classes=16, in_channels=256, feat_channels=256,
                 point_feat_channels=256, stacked_convs=3, num_points=9,
                 gradient_mul=0.1, prior_prob=0.01, norm_cfg=None):
        groups = (norm_cfg or {}).get("num_groups", 32)
        super().__init__(
            in_channels, feat_channels, stacked_convs,
            norms=(lambda: GroupNorm(groups, feat_channels, eps=1e-6))
            if norm_cfg else None)
        if num_points != 9:
            raise ValueError("the deformable convs take 9 points (3x3)")
        self.num_classes = num_classes
        self.num_points = num_points
        self.gradient_mul = gradient_mul
        self.prior_prob = prior_prob
        n_off = 2 * num_points
        self.pts_init_conv = nn.Conv2d(feat_channels, point_feat_channels,
                                       3, padding=1)
        self.pts_init_out = nn.Conv2d(point_feat_channels, n_off, 1)
        # the deformable convs' weights
        self.cls_dconv = nn.Conv2d(feat_channels, point_feat_channels, 3,
                                   bias=False)
        self.refine_dconv = nn.Conv2d(feat_channels, point_feat_channels, 3,
                                      bias=False)
        self.cls_out = nn.Conv2d(point_feat_channels, self.cls_out_channels,
                                 1)
        self.pts_refine_out = nn.Conv2d(point_feat_channels, n_off, 1)
        self.init_prior()

    @property
    def cls_out_channels(self):
        return self.num_classes - 1

    @torch.no_grad()
    def init_prior(self):
        self.cls_out.bias.fill_(prior_bias(self.prior_prob))

    def forward(self, feats):
        """feats: list of [B, H, W, C] -> (cls [B, H, W, C'], init points
        [B, H, W, 2N], refined points [B, H, W, 2N]) lists."""
        cls_out, init_out, refine_out = [], [], []
        for f in feats:
            c, r = self.towers(f)
            o1 = self.pts_init_out(F.relu(self.pts_init_conv(r)))
            off = nhwc(partial_grad(o1, self.gradient_mul)
                       - o1.new_tensor(GRID)[:, None, None])
            c_feat = F.relu(deform_conv2d(nhwc(c), off, self.cls_dconv.weight)
                            .to(c.dtype)).permute(0, 3, 1, 2)
            r_feat = F.relu(deform_conv2d(nhwc(r), off,
                                          self.refine_dconv.weight)
                            .to(r.dtype)).permute(0, 3, 1, 2)
            cls_out.append(nhwc(self.cls_out(c_feat)))
            init_out.append(nhwc(o1))
            refine_out.append(nhwc(self.pts_refine_out(r_feat)
                                   + o1.detach()))
        return cls_out, init_out, refine_out


class RepPointsDetector(DenseDetector):
    def __init__(self, backbone, neck, bbox_head, point_base_scale=4,
                 transform_method="minmax", moment_mul=0.01, **kwargs):
        super().__init__(backbone, neck, bbox_head, **kwargs)
        if transform_method not in ("minmax", "partial_minmax", "moment"):
            raise ValueError(f"transform_method {transform_method!r}")
        self.point_base_scale = point_base_scale
        self.transform_method = transform_method
        self.moment_mul = moment_mul
        if transform_method == "moment":
            self.moment_transfer = nn.Parameter(torch.zeros(2))
        self.cls_loss = FocalLoss(gamma=2.0, alpha=0.25)
        self.init_loss = SmoothL1Loss(beta=0.11, loss_weight=0.5)
        self.refine_loss = SmoothL1Loss(beta=0.11, loss_weight=1.0)

    def out_dims(self):
        n2 = 2 * self.bbox_head.num_points
        return self.bbox_head.cls_out_channels, n2, n2

    def decode(self, pts):
        """Point offsets [B, P, 2N] ((dy, dx) pairs in strides) -> image
        boxes [B, P, 4] by ``transform_method``."""
        st = self.pstrides[:, None]
        x = self.points[:, 0, None] + pts[..., 1::2] * st
        y = self.points[:, 1, None] + pts[..., 0::2] * st
        if self.transform_method == "moment":
            return points2bbox_moment(x, y, self.moment_transfer,
                                      self.moment_mul)
        if self.transform_method == "partial_minmax":
            x, y = x[..., :4], y[..., :4]
        return torch.stack([x.amin(-1), y.amin(-1), x.amax(-1),
                            y.amax(-1)], -1)

    def loss(self, imgs, gt_boxes, gt_valid, gt_labels, img_shapes,
             generator: torch.Generator = None):
        """loss_cls, loss_pts_init and loss_pts_refine of a batch
        (``img_shapes`` and ``generator`` are not read)."""
        cls_flat, init_flat, refine_flat = self.head_outputs(imgs,
                                                             train=True)
        gt_boxes = gt_boxes.float()
        init_boxes = self.decode(init_flat)
        refine_boxes = self.decode(refine_flat)
        a_init = point_assign(self.points, self.pstrides, gt_boxes,
                              gt_valid, gt_labels,
                              scale=self.point_base_scale).gt_inds
        ref = max_iou_assign(init_boxes.detach(), gt_boxes, gt_valid,
                             gt_labels, pos_iou_thr=0.5, neg_iou_thr=0.4,
                             min_pos_iou=0.0)
        norm = (self.pstrides * self.point_base_scale)[:, None]

        def box_loss(fn, boxes, assigned):
            safe = (assigned.long() - 1).clamp(0, gt_boxes.shape[1] - 1)
            matched = torch.gather(gt_boxes, 1,
                                   safe[..., None].expand(-1, -1, 4))
            pos = (assigned > 0)[..., None].expand_as(boxes).float()
            n = global_count((assigned > 0).sum().float()).clamp(min=1.0)
            return fn(boxes / norm, matched / norm, weight=pos,
                      avg_factor=n * 4), n

        loss_init, _ = box_loss(self.init_loss, init_boxes, a_init)
        loss_refine, n_r = box_loss(self.refine_loss, refine_boxes,
                                    ref.gt_inds)
        return dict(
            loss_cls=self.cls_loss(cls_flat, ref.labels, avg_factor=n_r),
            loss_pts_init=loss_init, loss_pts_refine=loss_refine)

    @torch.no_grad()
    def predict(self, imgs, img_shapes, scale_factors=None):
        """The refined point sets' boxes: each level's top ``nms_pre``
        points by sigmoid score, boxes clipped to [0, w] x [0, h], then
        multiclass NMS (as `FCOS.predict`)."""
        cls_flat, _, refine_flat = self.head_outputs(imgs)
        boxes = self.decode(refine_flat)
        scores = sigmoid(cls_flat)
        idx = level_topk(scores, self.level_sizes, self.test_cfg["nms_pre"])
        bi = torch.arange(idx.shape[0], device=idx.device)[:, None]
        b = boxes[bi, idx]
        shape = img_shapes.float()[:, None]
        wh = torch.stack([shape[..., 1], shape[..., 0]] * 2, -1)
        boxes = torch.minimum(b.clamp(min=0), wh)
        return self.detections(boxes, scores[bi, idx], scale_factors)
