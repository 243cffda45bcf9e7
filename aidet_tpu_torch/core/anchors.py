"""Grid anchors with mmdet-v1 semantics, and the dense heads' anchor
targets.

Port of `AnchorGenerator`, `build_pyramid_anchors`, `AnchorTargets`
and `anchor_target` from `aidet_tpu/core/anchors.py`: the RPN's
(random sampling) and the single-stage heads' (every anchor weighed,
box or rotated-codec regression targets).  The anchors of one level are ordered
row-major over the grid with the anchor index fastest, i.e. the
(h, w, anchor) order of an NHWC head output flattened by
`models.heads.anchor_head.flatten_level_outputs`.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from .assign import max_iou_assign
from .boxes import bbox2delta
from .rboxes import RBBOX_CODECS
from .sample import pseudo_sample_masks, random_sample_masks


class AnchorGenerator:
    """Rounded base anchors centred at (base - 1) / 2, or at ``ctr`` (x,
    y); ``scale_major`` orders them ratios outer, scales inner, else
    scales outer (SSD's)."""

    def __init__(self, base_size, scales, ratios, scale_major=True,
                 ctr=None):
        self.base_size = base_size
        self.scales = np.asarray(scales, np.float32)
        self.ratios = np.asarray(ratios, np.float32)
        self.scale_major = scale_major
        self.ctr = ctr
        self.base_anchors = self._gen_base_anchors()

    @property
    def num_base_anchors(self):
        return self.base_anchors.shape[0]

    def _gen_base_anchors(self):
        w = h = self.base_size
        x_ctr, y_ctr = self.ctr or (0.5 * (w - 1), 0.5 * (h - 1))
        h_ratios = np.sqrt(self.ratios)
        w_ratios = 1.0 / h_ratios
        if self.scale_major:
            ws = (w * w_ratios[:, None] * self.scales[None, :]).reshape(-1)
            hs = (h * h_ratios[:, None] * self.scales[None, :]).reshape(-1)
        else:
            ws = (w * self.scales[:, None] * w_ratios[None, :]).reshape(-1)
            hs = (h * self.scales[:, None] * h_ratios[None, :]).reshape(-1)
        return np.round(np.stack([
            x_ctr - 0.5 * (ws - 1), y_ctr - 0.5 * (hs - 1),
            x_ctr + 0.5 * (ws - 1), y_ctr + 0.5 * (hs - 1)], -1))

    def grid_anchors(self, featmap_size, stride):
        """[feat_h * feat_w * A, 4] numpy anchors."""
        fh, fw = featmap_size
        sx = np.arange(fw, dtype=np.float32) * stride
        sy = np.arange(fh, dtype=np.float32) * stride
        shift_x, shift_y = np.meshgrid(sx, sy)
        shifts = np.stack([shift_x, shift_y, shift_x, shift_y],
                          -1).reshape(-1, 4)
        all_anchors = (self.base_anchors[None, :, :]
                       + shifts[:, None, :]).reshape(-1, 4)
        return all_anchors.astype(np.float32)


def build_pyramid_anchors(img_size: int, strides: Sequence[int],
                          scales=(8,), ratios=(0.5, 1.0, 2.0),
                          device="cpu", base_sizes=None):
    """Flat anchors for all pyramid levels of a square input, with
    base size ``base_sizes`` per level (default: the stride).

    Returns (anchors [A_total, 4] float32 tensor on ``device``,
    per-level anchor counts).
    """
    anchors, sizes = [], []
    for stride, base in zip(strides, base_sizes or strides):
        gen = AnchorGenerator(base, scales, ratios)
        fs = img_size // stride
        a = gen.grid_anchors((fs, fs), stride)
        anchors.append(a)
        sizes.append(a.shape[0])
    return (torch.from_numpy(np.concatenate(anchors, 0)).to(device),
            sizes)


class AnchorTargets(NamedTuple):
    """Anchor targets of a batch, [B, A, ...]."""
    labels: torch.Tensor         # [B, A] int32 (0 = bg, 1..C = fg class)
    label_weights: torch.Tensor  # [B, A]
    bbox_targets: torch.Tensor   # [B, A, D] (D = 4, or the codec's)
    bbox_weights: torch.Tensor   # [B, A, D]
    num_total_pos: torch.Tensor  # scalar
    num_total_neg: torch.Tensor  # scalar


def anchor_target(anchors, gt_boxes, gt_valid, img_shapes,
                  generator: torch.Generator, gt_labels=None,
                  target_means=(0., 0., 0., 0.),
                  target_stds=(1., 1., 1., 1.), allowed_border=0.0,
                  pos_iou_thr=0.7, neg_iou_thr=0.3, min_pos_iou=0.3,
                  num_samples=256, pos_fraction=0.5, neg_pos_ub=-1.0,
                  pos_weight=-1.0, sampling=True, gt_rboxes=None,
                  rbox_encode=None) -> AnchorTargets:
    """Anchor targets of dense heads: the inside-border filter (when
    allowed_border >= 0), MaxIoU assignment, random sampling (or with
    ``sampling=False`` every positive and negative anchor, the
    single-stage heads'; ``generator`` is then not drawn from), delta
    regression targets on the sampled positives, and per-image
    max(count, 1) totals.

    anchors [A, 4]; gt_boxes [B, G, 4]; gt_valid [B, G]; img_shapes
    [B, 2] (h, w); gt_labels [B, G] 1-based, or None for a binary RPN.
    gt_rboxes [B, G, D] with ``rbox_encode`` (a codec of
    `RBBOX_CODECS`): the rotated single-stage heads' targets, the
    codec's deltas of the matched gt rbox against the axis-aligned
    anchor (the assignment still uses the gt boxes); target_means and
    target_stds then have the codec's width.
    """
    b = gt_boxes.shape[0]
    if allowed_border >= 0:
        h = img_shapes[:, 0:1]
        w = img_shapes[:, 1:2]
        inside = ((anchors[:, 0] >= -allowed_border)
                  & (anchors[:, 1] >= -allowed_border)
                  & (anchors[:, 2] < w + allowed_border)
                  & (anchors[:, 3] < h + allowed_border))    # [B, A]
    else:
        inside = torch.ones(b, anchors.shape[0], dtype=torch.bool,
                            device=anchors.device)
    batch_anchors = anchors.expand(b, -1, -1)
    res = max_iou_assign(batch_anchors, gt_boxes, gt_valid, gt_labels,
                         pos_iou_thr=pos_iou_thr, neg_iou_thr=neg_iou_thr,
                         min_pos_iou=min_pos_iou, box_valid=inside)
    if sampling:
        sm = random_sample_masks(res.gt_inds, num_samples, pos_fraction,
                                 generator, neg_pos_ub)
    else:
        sm = pseudo_sample_masks(res.gt_inds)

    safe_gt = (res.gt_inds.long() - 1).clamp(0, gt_boxes.shape[1] - 1)
    if rbox_encode is not None:
        d = gt_rboxes.shape[-1]
        matched = torch.gather(gt_rboxes, 1,
                               safe_gt[..., None].expand(-1, -1, d))
        deltas = RBBOX_CODECS[rbox_encode][1](batch_anchors, matched,
                                              target_means, target_stds)
    else:
        matched = torch.gather(gt_boxes, 1,
                               safe_gt[..., None].expand(-1, -1, 4))
        deltas = bbox2delta(batch_anchors, matched, target_means,
                            target_stds)
    posf = sm.pos.float()
    pw = 1.0 if pos_weight <= 0 else pos_weight
    return AnchorTargets(
        labels=torch.where(sm.pos, res.labels, 0),
        label_weights=posf * pw + sm.neg.float(),
        bbox_targets=deltas * posf[..., None],
        bbox_weights=posf[..., None].expand_as(deltas),
        num_total_pos=sm.num_pos.clamp(min=1).sum(),
        num_total_neg=sm.num_neg.clamp(min=1).sum())
