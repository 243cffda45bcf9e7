"""RoI box heads, their loss and their decodes.

Port of `SharedFCBBoxHead`, `RBBoxHead`, `bbox_head_loss`,
`bbox_head_decode` and `rbbox_head_decode` from
`aidet_tpu/models/heads/bbox_head.py`.  The
heads take roi crops [N, s, s, C] and flatten them in (h, w, c) order,
the reference's order, so the first FC's weight is the reference
kernel transposed and needs no row permutation.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...core.boxes import delta2bbox
from ...core.rboxes import RBBOX_CODECS


class SharedFCBBoxHead(nn.Module):
    """Shared FCs, then classification and per-class box regression
    (the reference's class-agnostic option is not ported: the flagship
    does not use it)."""

    def __init__(self, num_classes=16, in_channels=256, fc_out_channels=1024,
                 num_fcs=2, roi_feat_size=7, out_dim_reg=4):
        super().__init__()
        self.num_fcs = num_fcs
        self.roi_feat_size = roi_feat_size
        self.out_dim_reg = out_dim_reg
        cin = in_channels * roi_feat_size * roi_feat_size
        for i in range(num_fcs):
            self.add_module(f"shared_fc{i}", nn.Linear(cin, fc_out_channels))
            cin = fc_out_channels
        self.fc_cls = nn.Linear(cin, num_classes)
        self.fc_reg = nn.Linear(cin, out_dim_reg * num_classes)

    def forward(self, x):
        """x: [N, s, s, C] -> (cls_score [N, classes], pred [N, D])."""
        x = x.reshape(x.shape[0], -1)
        for i in range(self.num_fcs):
            x = F.relu(getattr(self, f"shared_fc{i}")(x))
        return self.fc_cls(x), self.fc_reg(x)


class RBBoxHead(SharedFCBBoxHead):
    """Rotated-box head: the same FC trunk with per-class rotated
    regression of ``RBBOX_CODECS[encode]``'s width: 5 for thetaobb, hobb
    and rtheta (the refinement head on rotated crops), 8 for pointobb.  The
    reference's class-agnostic option is not ported: no configuration
    of the ported paths sets it."""

    def __init__(self, num_classes=16, in_channels=256, fc_out_channels=1024,
                 num_shared_fcs=2, roi_feat_size=7, encode="thetaobb"):
        if encode not in RBBOX_CODECS:
            raise NotImplementedError(f"rbbox encode {encode!r} is not "
                                      f"ported; {sorted(RBBOX_CODECS)} are")
        super().__init__(num_classes, in_channels, fc_out_channels,
                         num_shared_fcs, roi_feat_size,
                         RBBOX_CODECS[encode][0])
        self.encode = encode


def bbox_head_loss(cls_score, bbox_pred, targets, cls_loss, bbox_loss,
                   box_dim: int = 4, alt_bbox_targets=None):
    """Second-stage loss over the sampled rois of a batch: CE over all
    of them and smooth L1 on the class-specific slice of the
    regression, both averaged by the count of valid samples (the
    label-weight sum, at least 1).

    cls_score [N, C], bbox_pred [N, C * box_dim]; ``targets`` a
    `core.targets.RoiTargets` with leading dim N.  ``alt_bbox_targets``
    [K, N, box_dim]: equivalent targets (the 4 rolls of a hobb, which
    decode to one rectangle); the regression loss is then each
    sample's smallest summed loss over them, on the positives (the
    reference's sort-robust hobb loss).
    """
    avg = targets.label_weights.sum().clamp(min=1.0)
    loss_cls = cls_loss(cls_score, targets.labels,
                        weight=targets.label_weights, avg_factor=avg)
    per = bbox_pred.reshape(bbox_pred.shape[0], -1, box_dim)
    idx = targets.labels.long().clamp(0, per.shape[1] - 1)
    pred = torch.gather(per, 1, idx[:, None, None].expand(
        -1, 1, box_dim))[:, 0]
    if alt_bbox_targets is None:
        loss_bbox = bbox_loss(pred, targets.bbox_targets,
                              weight=targets.bbox_weights, avg_factor=avg)
    else:
        elem = bbox_loss(pred.expand_as(alt_bbox_targets), alt_bbox_targets,
                         reduction_override="none")        # [K, N, D]
        best = elem.sum(-1).amin(0)
        loss_bbox = (best * targets.bbox_weights[..., 0]).sum() / avg
    return loss_cls, loss_bbox


def softmax(x):
    """Softmax over the last dim as the reference computes it in x's
    dtype: exp(x - max) rounded to x's dtype over the sum of the
    unrounded exps rounded to x's dtype (XLA keeps the float32 exps of
    a bfloat16 softmax for the sum); bit for bit with the reference in
    bfloat16 up to the order of that float32 sum."""
    z = x - x.amax(-1, keepdim=True)
    e = torch.exp(z.float())
    return e.to(x.dtype) / e.sum(-1, keepdim=True).to(x.dtype)


def bbox_head_decode(rois, cls_score, bbox_pred,
                     target_means=(0., 0., 0., 0.),
                     target_stds=(0.1, 0.1, 0.2, 0.2), img_shape=None):
    """Per-class boxes [..., C*4] and softmax scores [..., C].
    img_shape: None or (h, w) [..., 2] broadcasting like the rois'
    leading dims (see `core.boxes.delta2bbox`).  The softmax runs in
    cls_score's dtype (bfloat16 in the full model), as the reference's;
    the boxes promote to float32 against float32 rois."""
    scores = softmax(cls_score)
    boxes = delta2bbox(rois, bbox_pred, target_means, target_stds,
                       max_shape=img_shape)
    return boxes, scores


def rbbox_head_decode(rois, cls_score, rbbox_pred, encode="thetaobb",
                      target_means=None, target_stds=None):
    """Per-class rotated boxes [..., C*D] in the ``encode`` format (D =
    5 for thetaobb, hobb and rtheta, 8 for pointobb; rtheta decodes onto
    rotated rois [..., 5], the others onto HBB rois [..., 4]) and
    softmax scores in cls_score's dtype."""
    dim, _, decode, _ = RBBOX_CODECS[encode]
    target_means = target_means or (0.,) * dim
    target_stds = target_stds or (1.,) * dim
    scores = softmax(cls_score)
    return decode(rois, rbbox_pred, target_means, target_stds), scores
