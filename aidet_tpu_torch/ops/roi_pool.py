"""Quantised max RoI pooling (the legacy Fast R-CNN op).

Port of `aidet_tpu/ops/roi_pool.py::roi_pool` (:20-58; parity:
mmdet/ops/roi_pool's CUDA kernel): roi corners rounded to the map's
cells, integer bin edges (floor of the start, ceil of the end, in exact
integer arithmetic), the max over each bin, 0 for an empty bin.  The
reference writes it as XLA code (masked maxima over bin membership
masks), so it is plain PyTorch here, `CHUNK` rois at a time (each
holds a [P, H, W, C] mask of the map).  RoIAlign replaced it in every
config; it is kept for parity, not speed.
"""

from __future__ import annotations

import torch

CHUNK = 8


def roi_pool(feat, rois, out_size: int = 7, spatial_scale: float = 1.0):
    """Max-pool each roi [R, 4] (image pixels) of feat [H, W, C] into a
    [P, P] grid: [R, P, P, C]."""
    if not rois.shape[0]:
        return feat.new_zeros((0, out_size, out_size, feat.shape[-1]))
    return torch.cat([_roi_pool(feat, part, out_size, spatial_scale)
                      for part in rois.split(CHUNK)])


def _roi_pool(feat, rois, out_size, spatial_scale):
    h, w, _ = feat.shape
    p = out_size
    corners = torch.round(rois * spatial_scale).long()
    x1, y1, x2, y2 = corners.unbind(-1)
    rw = (x2 - x1 + 1).clamp(min=1)[:, None]
    rh = (y2 - y1 + 1).clamp(min=1)[:, None]
    bins = torch.arange(p, device=feat.device)[None]
    xs = (bins * rw).div(p, rounding_mode="floor") + x1[:, None]
    xe = ((bins + 1) * rw + p - 1).div(p, rounding_mode="floor") + x1[:, None]
    ys = (bins * rh).div(p, rounding_mode="floor") + y1[:, None]
    ye = ((bins + 1) * rh + p - 1).div(p, rounding_mode="floor") + y1[:, None]
    gx = torch.arange(w, device=feat.device)
    gy = torch.arange(h, device=feat.device)
    mx = ((gx >= xs.clamp(0, w)[..., None])
          & (gx < xe.clamp(0, w)[..., None]))              # [R, P, W]
    my = ((gy >= ys.clamp(0, h)[..., None])
          & (gy < ye.clamp(0, h)[..., None]))              # [R, P, H]
    neg = torch.finfo(feat.dtype).min
    # the max over x within each x bin [R, Px, H, C], then over y
    fx = torch.where(mx[:, :, None, :, None], feat[None, None],
                     neg).amax(3)
    out = torch.where(my[:, :, None, :, None], fx[:, None],
                      neg).amax(3)                          # [R, Py, Px, C]
    empty = ~(my.any(-1)[:, :, None] & mx.any(-1)[:, None, :])
    return torch.where(empty[..., None], 0.0, out)
