"""The proposal-only RPN detector.

Port of `aidet_tpu/models/detectors/rpn.py::RPN` (:28-215; parity:
mmdet/models/detectors/rpn.py) without its guided-anchoring branch
(`GARPNHead` is not registered in the port, so such a config raises
`build_detector`'s `KeyError`): backbone, neck, `RPNHead` over the pyramid
anchors; `loss` is the RPN's anchor-target loss, `predict` returns the
proposals.  The train_cfg and test_cfg may be flat or nested under
``rpn`` (configs/rpn_r50_fpn_1x.py), as the reference reads them
(:63-87).
"""

from __future__ import annotations

import torch

from .two_stage import AnchorDetector

DEFAULT_TRAIN_CFG = dict(pos_iou_thr=0.7, neg_iou_thr=0.3, min_pos_iou=0.3,
                         num_samples=256, pos_fraction=0.5, neg_pos_ub=-1,
                         allowed_border=0, pos_weight=-1)
DEFAULT_TEST_CFG = dict(nms_pre=2000, nms_post=2000, max_num=2000,
                        nms_thr=0.7, min_bbox_size=0)


def _flat(default: dict, cfg) -> dict:
    """``default`` updated by ``cfg``'s flat keys, then by its ``rpn``
    dict's (the reference's order)."""
    cfg = dict(cfg or {})
    cfg.update(cfg.pop("rpn", {}))
    return dict(default, **cfg)


class RPN(AnchorDetector):
    """``train_cfg``: the RPN's assigner and sampler keys;
    ``test_cfg``: `rpn_proposals`' keys (nms_pre, nms_post, max_num,
    nms_thr, min_bbox_size)."""

    def __init__(self, backbone, neck, rpn_head, img_size=1024,
                 train_cfg=None, test_cfg=None, compute_dtype=None):
        super().__init__(backbone, neck, rpn_head, img_size, compute_dtype)
        self.train_cfg = _flat(DEFAULT_TRAIN_CFG, train_cfg)
        self.test_cfg = _flat(DEFAULT_TEST_CFG, test_cfg)

    def loss(self, imgs, gt_boxes, gt_valid, img_shapes,
             generator: torch.Generator = None):
        """The RPN's losses (reference :173-196): imgs [B, S, S, 3]
        (uint8 BGR or normalized floats), gt_boxes [B, G, 4], gt_valid
        [B, G], img_shapes [B, 2]; no labels.  The anchor sample draws
        from ``generator``.  Returns float32 scalars loss_rpn_cls and
        loss_rpn_bbox."""
        if generator is None:
            raise TypeError("loss needs the sampling generator")
        _, _, _, losses, _ = self._rpn_loss(
            imgs, gt_boxes.float(), gt_valid, img_shapes.float(), generator,
            self.train_cfg)
        return losses

    @torch.no_grad()
    def predict(self, imgs, img_shapes):
        """The proposals of each image (reference :198-215): boxes [B, N,
        4] (N = max_num), their objectness scores [B, N] and valid [B,
        N]."""
        img_shapes = img_shapes.float()
        cls_flat, reg_flat = self._rpn_outputs(self.extract_feat(imgs))
        boxes, scores, valid = self._proposals(cls_flat, reg_flat,
                                               img_shapes, self.test_cfg)
        return dict(boxes=boxes, scores=scores, valid=valid)
