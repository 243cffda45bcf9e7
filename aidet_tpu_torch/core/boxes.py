"""Horizontal box (HBB) geometry with the mmdet-v1 legacy "+1"
convention: a box [x1, y1, x2, y2] has width x2 - x1 + 1.

Port of `aidet_tpu/core/boxes.py` (bbox_wh, bbox_area, bbox_center,
bbox2delta, delta2bbox, bbox_overlaps, distance2bbox).  Boxes are float
tensors [..., 4].
"""

from __future__ import annotations

import math

import torch

LEGACY_OFFSET = 1.0


def bbox_wh(boxes: torch.Tensor):
    """Width/height under the legacy +1 convention."""
    w = boxes[..., 2] - boxes[..., 0] + LEGACY_OFFSET
    h = boxes[..., 3] - boxes[..., 1] + LEGACY_OFFSET
    return w, h


def bbox_area(boxes: torch.Tensor) -> torch.Tensor:
    w, h = bbox_wh(boxes)
    return w * h


def bbox_center(boxes: torch.Tensor):
    cx = (boxes[..., 0] + boxes[..., 2]) * 0.5
    cy = (boxes[..., 1] + boxes[..., 3]) * 0.5
    return cx, cy


def bbox2delta(proposals: torch.Tensor, gt: torch.Tensor,
               means=(0., 0., 0., 0.), stds=(1., 1., 1., 1.)):
    """Encode gt boxes as (dx, dy, dw, dh) deltas against proposals."""
    px, py = bbox_center(proposals)
    pw, ph = bbox_wh(proposals)
    gx, gy = bbox_center(gt)
    gw, gh = bbox_wh(gt)
    deltas = torch.stack([(gx - px) / pw, (gy - py) / ph,
                          torch.log(gw / pw), torch.log(gh / ph)], dim=-1)
    return (deltas - deltas.new_tensor(means)) / deltas.new_tensor(stds)


def delta2bbox(rois: torch.Tensor, deltas: torch.Tensor,
               means=(0., 0., 0., 0.), stds=(1., 1., 1., 1.),
               max_shape=None, wh_ratio_clip=16.0 / 1000.0):
    """Decode (dx, dy, dw, dh) deltas onto rois.

    ``deltas`` may be [..., 4*K] (per-class regression); rois [..., 4]
    are broadcast across the K groups.  ``max_shape`` is None or an
    (h, w) tensor [..., 2] whose leading dims broadcast against the
    rois' leading dims (e.g. [B, 1, 2] for rois [B, N, 4]); boxes are
    clipped to [0, w-1] x [0, h-1].
    """
    shape = deltas.shape
    k = shape[-1] // 4
    d = deltas.reshape(shape[:-1] + (k, 4))
    d = (d * d.new_tensor(stds) + d.new_tensor(means))

    dx, dy, dw, dh = d.unbind(-1)
    max_ratio = abs(math.log(wh_ratio_clip))
    dw = dw.clamp(-max_ratio, max_ratio)
    dh = dh.clamp(-max_ratio, max_ratio)

    px, py = bbox_center(rois)
    pw, ph = bbox_wh(rois)
    px, py, pw, ph = (v[..., None] for v in (px, py, pw, ph))

    # exp in the rois' dtype: for bfloat16 deltas on float32 rois the
    # reference's XLA drops the exp's bfloat16 rounding before the
    # float32 product
    gw = pw * torch.exp(dw.to(pw.dtype))
    gh = ph * torch.exp(dh.to(ph.dtype))
    gx = px + pw * dx
    gy = py + ph * dy

    half = 0.5 * LEGACY_OFFSET
    x1 = gx - gw * 0.5 + half
    y1 = gy - gh * 0.5 + half
    x2 = gx + gw * 0.5 - half
    y2 = gy + gh * 0.5 - half
    if max_shape is not None:
        hmax = max_shape[..., 0:1].to(x1.dtype) - 1
        wmax = max_shape[..., 1:2].to(x1.dtype) - 1
        x1 = torch.minimum(x1.clamp(min=0), wmax)
        y1 = torch.minimum(y1.clamp(min=0), hmax)
        x2 = torch.minimum(x2.clamp(min=0), wmax)
        y2 = torch.minimum(y2.clamp(min=0), hmax)
    return torch.stack([x1, y1, x2, y2], dim=-1).reshape(shape)


def bbox_overlaps(boxes1: torch.Tensor, boxes2: torch.Tensor,
                  mode: str = "iou", aligned: bool = False):
    """Pairwise IoU ('iou') or intersection over the area of boxes1
    ('iof') with the legacy +1 sizes: [..., N, 4] x [..., M, 4] ->
    [..., N, M], or [..., N] when ``aligned``."""
    if mode not in ("iou", "iof"):
        raise ValueError(mode)
    if not aligned:
        boxes1 = boxes1[..., :, None, :]
        boxes2 = boxes2[..., None, :, :]
    lt = torch.maximum(boxes1[..., :2], boxes2[..., :2])
    rb = torch.minimum(boxes1[..., 2:], boxes2[..., 2:])
    wh = (rb - lt + LEGACY_OFFSET).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    area1 = bbox_area(boxes1)
    union = area1 + bbox_area(boxes2) - inter if mode == "iou" else area1
    return inter / union.clamp(min=torch.finfo(inter.dtype).tiny)


def distance2bbox(points: torch.Tensor, distance: torch.Tensor,
                  max_shape=None):
    """(l, t, r, b) distances [..., 4] from points [..., 2] -> boxes
    [..., 4] (the FCOS family's decode).  ``max_shape`` None, or an (h,
    w) tensor [..., 2] whose leading dims broadcast against the points'
    leading dims: boxes are clipped to [0, w] x [0, h] (no - 1, unlike
    `delta2bbox`)."""
    x1 = points[..., 0] - distance[..., 0]
    y1 = points[..., 1] - distance[..., 1]
    x2 = points[..., 0] + distance[..., 2]
    y2 = points[..., 1] + distance[..., 3]
    if max_shape is not None:
        h = max_shape[..., 0].to(x1.dtype)
        w = max_shape[..., 1].to(x1.dtype)
        x1 = torch.minimum(x1.clamp(min=0), w)
        y1 = torch.minimum(y1.clamp(min=0), h)
        x2 = torch.minimum(x2.clamp(min=0), w)
        y2 = torch.minimum(y2.clamp(min=0), h)
    return torch.stack([x1, y1, x2, y2], dim=-1)
