"""Second-stage (RoI head) targets over fixed-size samples.

Port of `bbox_target`, `rbbox_target` (thetaobb, pointobb, hobb) and
`mask_target` from `aidet_tpu/core/targets.py`, over a batch: the
sample's fields are [B, R], the rois [B, R, 4] and the gts
[B, G, ...].
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
    the ``encode`` format (thetaobb, pointobb or hobb)."""
    if encode == "rtheta":
        raise ValueError(
            "rbbox_target encodes against HBB rois; the 'rtheta' codec "
            "needs rotated proposals (rtheta2delta)")
    if encode not in RBBOX_CODECS:
        raise ValueError(f"rbbox encode {encode!r}: one of "
                         f"{sorted(RBBOX_CODECS)}")
    dim, encode_fn, _, _ = RBBOX_CODECS[encode]
    means = target_means or (0.,) * dim
    stds = target_stds or (1.,) * dim
    return _targets(sample, gt_rboxes, gt_labels,
                    lambda m: encode_fn(rois, m, means, stds), pos_weight)


def mask_target(sample: FixedSample, rois, gt_masks,
                mask_size: int = 28) -> torch.Tensor:
    """Each sampled roi's gt mask, cropped and resized to
    ``mask_size``^2 by bilinear samples at the cell centres of an
    S x S grid over the roi (parity: the reference's `mask_target`
    :99-141, which serves the binary masks and the CenterMap soft
    targets alike).

    rois [B, R, 4] in the masks' pixels; gt_masks [B, G, H, W] float
    (the detector's `loss` dequantizes the pipeline's uint8 first).
    Returns [B, R, S, S] float32, zero where the roi is not positive.
    Only the sampled corners are gathered, not the rois' whole masks."""
    b, r = rois.shape[:2]
    g, hh, ww = gt_masks.shape[1:]
    gi = sample.gt_inds.clamp(0, g - 1)
    x1, y1, x2, y2 = rois.float().unbind(-1)
    w = (x2 - x1 + 1.0).clamp(min=1.0)
    h = (y2 - y1 + 1.0).clamp(min=1.0)
    grid = (torch.arange(mask_size, dtype=torch.float32,
                         device=rois.device) + 0.5) / mask_size
    ys = (y1[..., None] + grid * h[..., None] - 0.5).clamp(0, hh - 1)
    xs = (x1[..., None] + grid * w[..., None] - 0.5).clamp(0, ww - 1)
    y0, x0 = torch.floor(ys), torch.floor(xs)
    ly, lx = (ys - y0)[..., :, None], (xs - x0)[..., None, :]
    y0, x0 = y0.long(), x0.long()
    y1i, x1i = (y0 + 1).clamp(max=hh - 1), (x0 + 1).clamp(max=ww - 1)
    bi = torch.arange(b, device=rois.device)[:, None, None, None]
    gi = gi[..., None, None]

    def take(yi, xi):
        return gt_masks[bi, gi, yi[..., :, None], xi[..., None, :]].float()

    top = take(y0, x0) * (1 - lx) + take(y0, x1i) * lx
    bot = take(y1i, x0) * (1 - lx) + take(y1i, x1i) * lx
    crops = top * (1 - ly) + bot * ly
    return crops * sample.is_pos[..., None, None]
