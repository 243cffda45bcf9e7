"""RetinaNet head: 4-conv classification and regression towers shared
across the pyramid levels, then 3x3 convs to the anchors' sigmoid class
logits and their regression.

Port of `aidet_tpu/models/heads/retina_head.py::RetinaHead` (parity:
mmdet/models/anchor_heads/retina_head.py).  ``reg_dim`` is 4 (box
deltas) or a rotated codec's width (5 for thetaobb and hobb, 8 for
pointobb: the rotated RetinaNet).  `retina_cls`'s bias starts at the
focal loss's prior, -log((1 - prior_prob) / prior_prob) (`init_prior`;
`flagship.init_weights` zeroes every bias, so the builder calls it
after).  NHWC in and out, so a level's outputs flatten in (h, w,
anchor) order.

`RetinaSepBNHead` (reference :65; parity: retina_sepbn_head.py): the
same towers and output convs shared by every level, with a separate
affine norm per level after each tower conv (``cls_bn_l{lvl}_{i}``,
``reg_bn_l{lvl}_{i}``: a scale and a bias, the reference's frozen
statistics); the tower convs then have no bias.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


class RetinaHead(nn.Module):
    def __init__(self, num_classes=16, in_channels=256, feat_channels=256,
                 stacked_convs=4, num_anchors=9, prior_prob=0.01,
                 reg_dim=4):
        super().__init__()
        self.num_classes = num_classes
        self.stacked_convs = stacked_convs
        self.prior_prob = prior_prob
        self.reg_dim = reg_dim
        for i in range(stacked_convs):
            cin = in_channels if i == 0 else feat_channels
            self.add_module(f"cls_conv{i}",
                            nn.Conv2d(cin, feat_channels, 3, padding=1))
            self.add_module(f"reg_conv{i}",
                            nn.Conv2d(cin, feat_channels, 3, padding=1))
        self.retina_cls = nn.Conv2d(
            feat_channels, num_anchors * self.cls_out_channels, 3, padding=1)
        self.retina_reg = nn.Conv2d(feat_channels, num_anchors * reg_dim, 3,
                                    padding=1)
        self.init_prior()

    @property
    def cls_out_channels(self):
        return self.num_classes - 1      # sigmoid classes, no background

    @torch.no_grad()
    def init_prior(self):
        self.retina_cls.bias.fill_(
            -math.log((1 - self.prior_prob) / self.prior_prob))

    def forward(self, feats):
        """feats: list of [B, H, W, C] -> (cls list [B, H, W, A * C'],
        reg list [B, H, W, A * reg_dim])."""
        cls_out, reg_out = [], []
        for f in feats:
            c = r = f.permute(0, 3, 1, 2)
            for i in range(self.stacked_convs):
                c = F.relu(getattr(self, f"cls_conv{i}")(c))
                r = F.relu(getattr(self, f"reg_conv{i}")(r))
            cls_out.append(self.retina_cls(c).permute(0, 2, 3, 1))
            reg_out.append(self.retina_reg(r).permute(0, 2, 3, 1))
        return cls_out, reg_out


class Affine(nn.Module):
    """x * weight + bias per channel of an NCHW map, the parameters
    applied in x's dtype."""

    def __init__(self, channels):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        return (x * self.weight.to(x.dtype)[:, None, None]
                + self.bias.to(x.dtype)[:, None, None])


class RetinaSepBNHead(RetinaHead):
    """``num_ins`` levels, each with its own norms; ``with_norm=False``
    is the plain `RetinaHead` with shared convs."""

    def __init__(self, num_classes=16, num_ins=5, in_channels=256,
                 feat_channels=256, stacked_convs=4, num_anchors=9,
                 prior_prob=0.01, with_norm=True):
        super().__init__(num_classes, in_channels, feat_channels,
                         stacked_convs, num_anchors, prior_prob)
        self.num_ins = num_ins
        self.with_norm = with_norm
        for i in range(stacked_convs):
            cin = in_channels if i == 0 else feat_channels
            for kind in ("cls", "reg"):
                self.add_module(f"{kind}_conv{i}", nn.Conv2d(
                    cin, feat_channels, 3, padding=1, bias=not with_norm))
                if with_norm:
                    for lvl in range(num_ins):
                        self.add_module(f"{kind}_bn_l{lvl}_{i}",
                                        Affine(feat_channels))

    def forward(self, feats):
        if len(feats) != self.num_ins:
            raise ValueError(f"RetinaSepBNHead of {self.num_ins} levels "
                             f"got {len(feats)}")
        cls_out, reg_out = [], []
        for lvl, f in enumerate(feats):
            c = r = f.permute(0, 3, 1, 2)
            for i in range(self.stacked_convs):
                c = getattr(self, f"cls_conv{i}")(c)
                r = getattr(self, f"reg_conv{i}")(r)
                if self.with_norm:
                    c = getattr(self, f"cls_bn_l{lvl}_{i}")(c)
                    r = getattr(self, f"reg_bn_l{lvl}_{i}")(r)
                c, r = F.relu(c), F.relu(r)
            cls_out.append(self.retina_cls(c).permute(0, 2, 3, 1))
            reg_out.append(self.retina_reg(r).permute(0, 2, 3, 1))
        return cls_out, reg_out
