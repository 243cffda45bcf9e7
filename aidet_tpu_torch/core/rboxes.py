"""Oriented box (thetaobb) codec.

Port of the thetaobb part of `aidet_tpu/core/rboxes.py`:
thetaobb2pointobb, thetaobb2delta and delta2thetaobb.  A thetaobb is
(cx, cy, w, h, theta) with theta in radians in [-pi/2, 0) (the legacy
cv2.minAreaRect convention).  The codec measures proposals with the
legacy +1 width/height, and encode adds +1 to the gt w/h, so a decode
of an encode returns w+1 / h+1 by design.
"""

from __future__ import annotations

import math

import torch

HALF_PI = math.pi / 2.0


def thetaobb2pointobb(thetaobb: torch.Tensor) -> torch.Tensor:
    """(cx, cy, w, h, theta) -> 4 corners [..., 8] in cv2.boxPoints
    order."""
    cx, cy, w, h, theta = thetaobb.unbind(-1)
    a = torch.sin(theta) * 0.5
    b = torch.cos(theta) * 0.5
    x0 = cx - a * h - b * w
    y0 = cy + b * h - a * w
    x1 = cx + a * h - b * w
    y1 = cy - b * h - a * w
    x2 = 2.0 * cx - x0
    y2 = 2.0 * cy - y0
    x3 = 2.0 * cx - x1
    y3 = 2.0 * cy - y1
    return torch.stack([x0, y0, x1, y1, x2, y2, x3, y3], dim=-1)


def _proposal_geometry(proposals):
    px = (proposals[..., 0] + proposals[..., 2]) * 0.5
    py = (proposals[..., 1] + proposals[..., 3]) * 0.5
    pw = proposals[..., 2] - proposals[..., 0] + 1.0
    ph = proposals[..., 3] - proposals[..., 1] + 1.0
    return px, py, pw, ph


def thetaobb2delta(proposals, gt, means=(0.,) * 5, stds=(1.,) * 5):
    """Encode thetaobb gt [..., 5] against HBB proposals [..., 4]; the
    proposal's theta is fixed at -pi/2 and gt w/h get the legacy +1."""
    px, py, pw, ph = _proposal_geometry(proposals)
    dx = (gt[..., 0] - px) / pw
    dy = (gt[..., 1] - py) / ph
    dw = torch.log((gt[..., 2] + 1.0) / pw)
    dh = torch.log((gt[..., 3] + 1.0) / ph)
    dtheta = gt[..., 4] - (-HALF_PI)
    deltas = torch.stack([dx, dy, dw, dh, dtheta], dim=-1)
    return (deltas - deltas.new_tensor(means)) / deltas.new_tensor(stds)


def delta2thetaobb(rois, deltas, means=(0.,) * 5, stds=(1.,) * 5,
                   wh_ratio_clip=16.0 / 1000.0):
    """Decode deltas [..., 5*K] (per-class groups) onto HBB rois
    [..., 4]; returns thetaobbs [..., 5*K]."""
    shape = deltas.shape
    k = shape[-1] // 5
    d = deltas.reshape(shape[:-1] + (k, 5))
    d = d * d.new_tensor(stds) + d.new_tensor(means)
    dx, dy, dw, dh, dtheta = d.unbind(-1)
    max_ratio = abs(math.log(wh_ratio_clip))
    dw = dw.clamp(-max_ratio, max_ratio)
    dh = dh.clamp(-max_ratio, max_ratio)
    px, py, pw, ph = (v[..., None] for v in _proposal_geometry(rois))
    gx = px + pw * dx
    gy = py + ph * dy
    gw = pw * torch.exp(dw)
    gh = ph * torch.exp(dh)
    gtheta = dtheta + (-HALF_PI)
    return torch.stack([gx, gy, gw, gh, gtheta], dim=-1).reshape(shape)


# the ported codecs (the reference's RBBOX_CODECS): name -> (regression
# dims, encode, decode); pointobb and hobb are not ported
RBBOX_CODECS = {"thetaobb": (5, thetaobb2delta, delta2thetaobb)}
