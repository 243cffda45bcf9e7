"""What the port's detectors share: the config merge, and the frame of
the reference's anchor-free detectors and SSD.

`DenseDetector` is that frame (FCOS, ATSS, FOVEA, RepPointsDetector,
GARetinaNet and SSD subclass it, each in its head's module, as the
reference's `models/heads/*.py` hold them): a backbone, a neck and a
dense head with no uint8 normalize, as those reference detectors have
none (their images reach the backbone as they are, cast to its dtype),
each level's top ``nms_pre`` of predict (`level_topk`) and its
multiclass NMS.
"""

from __future__ import annotations

from collections.abc import Mapping

import torch
from torch import nn
from torch.profiler import record_function

from ...ops.nms import multiclass_nms, topk
from ..heads.anchor_head import _with_background


def _merge(default: dict, override) -> dict:
    """``default`` with ``override``'s entries; a dict entry of both is
    updated key by key, one level deep."""
    out = {k: dict(v) if isinstance(v, Mapping) else v
           for k, v in default.items()}
    for k, v in (override or {}).items():
        if isinstance(v, Mapping) and isinstance(out.get(k), dict):
            out[k].update(v)
        else:
            out[k] = v
    return out


def level_topk(scores, level_sizes, nms_pre):
    """Indices [B, K] of each image's top ``nms_pre`` points of each
    level by their best class score ``scores`` [B, P, C] (a stable
    sort: ties to the lower index, as the reference's top_k), levels
    concatenated."""
    out, start = [], 0
    for n in level_sizes:
        k = min(nms_pre, n) if nms_pre > 0 else n
        out.append(topk(scores[:, start:start + n].amax(-1), k)[1] + start)
        start += n
    return torch.cat(out, 1)


class DenseDetector(nn.Module):
    """backbone -> neck (None: SSD's maps as they are) -> a dense head,
    with the points, strides, anchors or ranges of `constants` as
    float32 buffers (they stay float32 in a bfloat16 model, as
    `SingleStageDetector`'s anchors).  ``compute_dtype``: as
    `TwoStageDetector`'s; `loss` runs the network under autocast to it
    and the losses in float32."""

    test_defaults = dict(nms_pre=1000, score_thr=0.05, nms_thr=0.5,
                         max_per_img=100)
    train_defaults: dict = {}

    def __init__(self, backbone, neck, bbox_head, img_size=1024,
                 strides=(8, 16, 32, 64, 128), train_cfg=None,
                 test_cfg=None, compute_dtype=None):
        super().__init__()
        self.backbone = backbone
        self.neck = neck
        self.bbox_head = bbox_head
        self.img_size = img_size
        self.strides = tuple(strides)
        self.train_cfg = _merge(self.train_defaults, train_cfg)
        self.test_cfg = _merge(self.test_defaults, test_cfg)
        self.compute_dtype = compute_dtype
        for name, t in self.constants().items():
            self.register_buffer(name, t, persistent=False)

    def constants(self) -> dict:
        """The float32 buffers (CPU tensors) by name, setting
        ``level_sizes`` (the points or anchors of each level); by
        default the pyramid points of ``strides``."""
        from ...core.points import build_pyramid_points
        pts, self.level_sizes, pstrides = build_pyramid_points(
            self.img_size, self.strides)
        return dict(points=pts, pstrides=pstrides)

    def _apply(self, fn, recurse=True):
        super()._apply(fn, recurse)
        for name, t in self.constants().items():
            cur = getattr(self, name)
            if cur.dtype != torch.float32:
                setattr(self, name, t.to(cur.device))
        return self

    @property
    def dtype(self):
        return next(self.bbox_head.parameters()).dtype

    def extract_feat(self, imgs):
        with record_function("backbone"):
            feats = self.backbone(imgs)
        if self.neck is None:
            return feats
        with record_function("neck"):
            return self.neck(feats)

    def head_outputs(self, imgs, train=False, **head_kwargs):
        """The head's outputs flattened over the levels (`flatten`), in
        float32 under autocast to ``compute_dtype`` when ``train``."""
        cd = self.compute_dtype or self.dtype
        with torch.autocast(imgs.device.type, dtype=cd,
                            enabled=train and cd != self.dtype):
            feats = self.extract_feat(imgs)
            with record_function("dense_head"):
                outs = self.flatten(self.bbox_head(feats, **head_kwargs))
        return tuple(o.float() for o in outs) if train else outs

    def flatten(self, outs):
        """The head's per-level NHWC lists -> [B, P, D] tensors in (h, w,
        anchor) order, D of each output from `out_dims`."""
        b = outs[0][0].shape[0]
        return tuple(torch.cat([x.reshape(b, -1, d) for x in xs], 1)
                     for xs, d in zip(outs, self.out_dims()))

    def out_dims(self):
        """The channels of one point (anchor) of each head output."""
        raise NotImplementedError

    def detections(self, boxes, scores, scale_factors=None,
                   background=False):
        """Multiclass NMS of the candidates boxes [B, K, 4] with their
        class scores [B, K, C] (with ``background`` [B, K, C + 1], column
        0 the background's) at the test_cfg's score_thr, nms_thr and
        max_per_img; boxes divided by ``scale_factors`` [B]."""
        ec = self.test_cfg
        with record_function("multiclass_nms"):
            res = multiclass_nms(
                boxes, scores if background else _with_background(scores),
                ec["score_thr"], ec["nms_thr"], ec["max_per_img"])
        boxes = res.boxes
        if scale_factors is not None:
            boxes = boxes / scale_factors.to(boxes).reshape(-1, 1, 1)
        return dict(boxes=boxes, scores=res.scores, labels=res.labels,
                    valid=res.valid)
