"""Second-stage (RoI head) targets over fixed-size samples.

Port of `bbox_target` and `rbbox_target` (thetaobb) from
`aidet_tpu/core/targets.py`, over a batch: the sample's fields are
[B, R], the rois [B, R, 4] and the gts [B, G, ...].
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .boxes import bbox2delta
from .rboxes import RBBOX_CODECS
from .sample import FixedSample


class RoiTargets(NamedTuple):
    labels: torch.Tensor         # [B, R] int64 (0 bg, 1..C fg)
    label_weights: torch.Tensor  # [B, R]
    bbox_targets: torch.Tensor   # [B, R, D]
    bbox_weights: torch.Tensor   # [B, R, D]


def _targets(sample: FixedSample, gt, gt_labels, encode, pos_weight):
    """Encode each sampled roi against its gt; zero targets and weights
    outside the positives, label weight 1 (or pos_weight) on positives
    and 1 on valid negatives."""
    safe_gt = sample.gt_inds.clamp(0, gt.shape[1] - 1)
    matched = torch.gather(gt, 1, safe_gt[..., None].expand(
        -1, -1, gt.shape[-1]))
    deltas = encode(matched)
    posf = sample.is_pos.float()
    labels = torch.where(sample.is_pos,
                         torch.gather(gt_labels.long(), 1, safe_gt), 0)
    pw = 1.0 if pos_weight <= 0 else pos_weight
    label_weights = torch.where(sample.is_pos, pw, sample.valid.float())
    return RoiTargets(labels, label_weights, deltas * posf[..., None],
                      posf[..., None].expand_as(deltas))


def bbox_target(sample: FixedSample, rois, gt_boxes, gt_labels,
                target_means=(0., 0., 0., 0.),
                target_stds=(0.1, 0.1, 0.2, 0.2),
                pos_weight=-1.0) -> RoiTargets:
    """Delta targets of the sampled rois [B, R, 4] against the gt
    boxes [B, G, 4]; gt_labels [B, G] 1-based."""
    return _targets(sample, gt_boxes, gt_labels,
                    lambda m: bbox2delta(rois, m, target_means,
                                         target_stds), pos_weight)


def rbbox_target(sample: FixedSample, rois, gt_rboxes, gt_labels,
                 encode="thetaobb", target_means=None, target_stds=None,
                 pos_weight=-1.0) -> RoiTargets:
    """Rotated-box delta targets against the gt rboxes [B, G, D] in
    the ``encode`` format (thetaobb, the only codec ported)."""
    if encode not in RBBOX_CODECS:
        raise NotImplementedError(f"rbbox encode {encode!r} is not "
                                  "ported; thetaobb is")
    dim, encode_fn, _ = RBBOX_CODECS[encode]
    means = target_means or (0.,) * dim
    stds = target_stds or (1.,) * dim
    return _targets(sample, gt_rboxes, gt_labels,
                    lambda m: encode_fn(rois, m, means, stds), pos_weight)
