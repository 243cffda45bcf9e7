"""Oriented box codecs.

Port of `aidet_tpu/core/rboxes.py`'s conversions (thetaobb2pointobb,
pointobb2thetaobb, pointobb2bbox, pointobb_best_point_sort, the hobb
family: thetaobb2hobb, hobb2pointobb, hobb2thetaobb, pointobb2hobb,
hobb_rolls, pointobb_flip, hobb_flip, hobb_rescale) and its delta
codecs thetaobb2delta / delta2thetaobb, pointobb2delta /
delta2pointobb, hobb2delta / delta2hobb (HBB proposals) and
rtheta2delta / delta2rtheta (rotated proposals, the refinement stage
of RBBoxRCNNRRoI).  A thetaobb is (cx, cy, w, h, theta) with theta in
radians in [-pi/2, 0) (the legacy cv2.minAreaRect convention); a
pointobb its 4 corners [..., 8]; a hobb (x1, y1, x2, y2, h) its first
edge, after the best-point sort, and the distance from the first
corner to the fourth.  The HBB codecs measure proposals with the
legacy +1 width/height, and thetaobb encode adds +1 to the gt w/h (hobb
encode to the gt h), so a decode of an encode returns w+1 / h+1 by
design.
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


def pointobb2thetaobb(pointobb: torch.Tensor) -> torch.Tensor:
    """Min-area rotated rect of a quad [..., 8] -> (cx, cy, w, h, theta).

    The minimum-area rectangle of a convex quad has a side parallel to
    one of its edges, so the 4 edge directions are the candidates;
    theta is folded into [-pi/2, 0) with a floor modulo (the reference's
    jnp.mod: `torch.remainder`, not `torch.fmod`, which differ on
    negative angles) and (w, h) are the extents along (theta,
    theta + pi/2).  Near-square quads tie between two candidates; the
    first smallest area wins, as the reference's argmin.
    """
    pts = pointobb.reshape(pointobb.shape[:-1] + (4, 2))
    edges = torch.roll(pts, -1, dims=-2) - pts              # [..., 4, 2]
    ang = torch.atan2(edges[..., 1], edges[..., 0])
    ang = torch.remainder(ang, HALF_PI) - HALF_PI           # [..., 4]
    cos = torch.cos(ang)[..., None]                         # [..., 4, 1]
    sin = torch.sin(ang)[..., None]
    x = pts[..., None, :, 0]                                # [..., 1, 4]
    y = pts[..., None, :, 1]
    u = x * cos + y * sin                                   # [..., 4, 4]
    v = -x * sin + y * cos
    umin, umax = u.amin(-1), u.amax(-1)                     # [..., 4]
    vmin, vmax = v.amin(-1), v.amax(-1)
    w = umax - umin
    h = vmax - vmin
    k = torch.argmin(w * h, dim=-1, keepdim=True)

    def take(arr):
        return torch.gather(arr, -1, k)[..., 0]

    theta = take(ang)
    w, h = take(w), take(h)
    uc = (take(umin) + take(umax)) * 0.5
    vc = (take(vmin) + take(vmax)) * 0.5
    ct, st = torch.cos(theta), torch.sin(theta)
    cx = uc * ct - vc * st
    cy = uc * st + vc * ct
    return torch.stack([cx, cy, w, h, theta], dim=-1)


def pointobb2bbox(pointobb: torch.Tensor) -> torch.Tensor:
    """4 corners [..., 8] -> their axis-aligned hull [..., 4]."""
    xs, ys = pointobb[..., 0::2], pointobb[..., 1::2]
    return torch.stack([xs.amin(-1), ys.amin(-1), xs.amax(-1),
                        ys.amax(-1)], dim=-1)


def pointobb_best_point_sort(pointobb: torch.Tensor) -> torch.Tensor:
    """The cyclic roll of the corners [..., 8] nearest (in summed
    squared distance) to the axis-aligned hull's (tl, tr, br, bl); the
    first of equally near rolls wins, as the reference's argmin."""
    xmin, ymin, xmax, ymax = pointobb2bbox(pointobb).unbind(-1)
    ref = torch.stack([xmin, ymin, xmax, ymin, xmax, ymax, xmin, ymax],
                      dim=-1)
    rolls = torch.stack([torch.roll(pointobb, 2 * s, dims=-1)
                         for s in range(4)], dim=-2)        # [..., 4, 8]
    best = ((rolls - ref[..., None, :]) ** 2).sum(-1).argmin(-1)
    return torch.gather(rolls, -2, best[..., None, None].expand(
        best.shape + (1, 8)))[..., 0, :]


def _first_edge(p):
    """A best-sorted pointobb [..., 8] as a hobb: its first edge and the
    distance from corner 1 to corner 4."""
    h = torch.sqrt((p[..., 6] - p[..., 0]) ** 2 + (p[..., 7] - p[..., 1]) ** 2)
    return torch.stack([p[..., 0], p[..., 1], p[..., 2], p[..., 3], h], -1)


def thetaobb2hobb(thetaobb: torch.Tensor) -> torch.Tensor:
    """(cx, cy, w, h, theta) -> (x1, y1, x2, y2, h)."""
    return _first_edge(pointobb_best_point_sort(thetaobb2pointobb(thetaobb)))


def hobb2pointobb(hobb: torch.Tensor) -> torch.Tensor:
    """(x1, y1, x2, y2, h) -> 4 corners: the fourth lies h from the
    first, perpendicular to the first edge (the reference's, without
    its source's int() of the output).  Degenerate where the first two
    corners coincide."""
    x1, y1, x2, y2, h = hobb.unbind(-1)
    ang = HALF_PI - torch.atan2(y2 - y1, x2 - x1)
    dx = h * torch.cos(ang)
    dy = h * torch.sin(ang)
    return torch.stack([x1, y1, x2, y2, x2 - dx, y2 + dy, x1 - dx, y1 + dy],
                       dim=-1)


def hobb2thetaobb(hobb: torch.Tensor) -> torch.Tensor:
    return pointobb2thetaobb(hobb2pointobb(hobb))


def pointobb2hobb(pointobb: torch.Tensor) -> torch.Tensor:
    return thetaobb2hobb(pointobb2thetaobb(pointobb))


def hobb_rolls(hobb: torch.Tensor) -> torch.Tensor:
    """The 4 cyclic first-edge representations of each hobb [..., 5] ->
    [..., 4, 5], slot 0 the input itself.  All decode to the same
    rectangle, so a sort-robust loss may regress to the nearest."""
    p = hobb2pointobb(hobb)
    rolls = torch.stack([torch.roll(p, -2 * s, dims=-1) for s in range(4)],
                        dim=-2)                             # [..., 4, 8]
    return _first_edge(rolls)


def pointobb_flip(pointobb: torch.Tensor, img_shape) -> torch.Tensor:
    """Horizontal flip in an image of ``img_shape`` (h, w): x mirrored
    to w - x - 1, corners 2 and 4 swapped to keep the winding, then the
    best-point sort."""
    p = pointobb.reshape(pointobb.shape[:-1] + (4, 2))
    p = torch.stack([img_shape[1] - p[..., 0] - 1, p[..., 1]], dim=-1)
    p = p[..., [0, 3, 2, 1], :].reshape(pointobb.shape)
    return pointobb_best_point_sort(p)


def hobb_flip(hobb: torch.Tensor, img_shape) -> torch.Tensor:
    """Horizontal flip of hobbs through their corners."""
    return thetaobb2hobb(pointobb2thetaobb(pointobb_flip(
        hobb2pointobb(hobb), img_shape)))


def hobb_rescale(hobb: torch.Tensor, scale_factor, reverse=False):
    """Every hobb coordinate, h included, times the scale factor (over
    it with ``reverse``)."""
    return hobb * (1.0 / scale_factor if reverse else scale_factor)


def _proposal_geometry(proposals):
    px = (proposals[..., 0] + proposals[..., 2]) * 0.5
    py = (proposals[..., 1] + proposals[..., 3]) * 0.5
    pw = proposals[..., 2] - proposals[..., 0] + 1.0
    ph = proposals[..., 3] - proposals[..., 1] + 1.0
    return px, py, pw, ph


def _normalize(deltas, means, stds):
    return (deltas - deltas.new_tensor(means)) / deltas.new_tensor(stds)


def _denormalize_grouped(deltas, means, stds, d):
    """[..., K*d] -> [..., K, d], denormalised in the deltas' dtype."""
    k = deltas.shape[-1] // d
    out = deltas.reshape(deltas.shape[:-1] + (k, d))
    return out * out.new_tensor(stds) + out.new_tensor(means)


def thetaobb2delta(proposals, gt, means=(0.,) * 5, stds=(1.,) * 5):
    """Encode thetaobb gt [..., 5] against HBB proposals [..., 4]; the
    proposal's theta is fixed at -pi/2 and gt w/h get the legacy +1."""
    px, py, pw, ph = _proposal_geometry(proposals)
    dx = (gt[..., 0] - px) / pw
    dy = (gt[..., 1] - py) / ph
    dw = torch.log((gt[..., 2] + 1.0) / pw)
    dh = torch.log((gt[..., 3] + 1.0) / ph)
    dtheta = gt[..., 4] - (-HALF_PI)
    return _normalize(torch.stack([dx, dy, dw, dh, dtheta], dim=-1), means,
                      stds)


def delta2thetaobb(rois, deltas, means=(0.,) * 5, stds=(1.,) * 5,
                   wh_ratio_clip=16.0 / 1000.0):
    """Decode deltas [..., 5*K] (per-class groups) onto HBB rois
    [..., 4]; returns thetaobbs [..., 5*K]."""
    shape = deltas.shape
    dx, dy, dw, dh, dtheta = _denormalize_grouped(deltas, means, stds,
                                                  5).unbind(-1)
    max_ratio = abs(math.log(wh_ratio_clip))
    dw = dw.clamp(-max_ratio, max_ratio)
    dh = dh.clamp(-max_ratio, max_ratio)
    px, py, pw, ph = (v[..., None] for v in _proposal_geometry(rois))
    gx = px + pw * dx
    gy = py + ph * dy
    gw = pw * torch.exp(dw.to(pw.dtype))    # as in boxes.delta2bbox
    gh = ph * torch.exp(dh.to(ph.dtype))
    gtheta = dtheta + (-HALF_PI)
    return torch.stack([gx, gy, gw, gh, gtheta], dim=-1).reshape(shape)


def _proposal_corners(proposals):
    """The HBB proposals' corners (tl, tr, br, bl) [..., 8] and the
    divisors (w, h) * 4 of the pointobb codec [..., 8]."""
    px, py, pw, ph = _proposal_geometry(proposals)
    x1, y1, x2, y2 = proposals.unbind(-1)
    return (torch.stack([x1, y1, x2, y1, x2, y2, x1, y2], dim=-1),
            torch.stack([pw, ph] * 4, dim=-1))


def pointobb2delta(proposals, gt, means=(0.,) * 8, stds=(1.,) * 8):
    """Encode 4-corner gt [..., 8] against the HBB proposals' own
    corners; x offsets over the proposal w, y offsets over its h."""
    corners, denom = _proposal_corners(proposals)
    return _normalize((gt - corners) / denom, means, stds)


def delta2pointobb(rois, deltas, means=(0.,) * 8, stds=(1.,) * 8,
                   wh_ratio_clip=16.0 / 1000.0):
    """Decode deltas [..., 8*K] onto HBB rois [..., 4]: pointobbs
    [..., 8*K].  ``wh_ratio_clip`` is ignored, as in the reference."""
    del wh_ratio_clip
    shape = deltas.shape
    d = _denormalize_grouped(deltas, means, stds, 8)
    corners, denom = _proposal_corners(rois)
    return (d * denom[..., None, :] + corners[..., None, :]).reshape(shape)


def hobb2delta(proposals, gt, means=(0.,) * 5, stds=(1.,) * 5):
    """Encode hobb gt [..., 5] against HBB proposals [..., 4]: the
    first edge's ends as offsets from the proposal's top-left (x1, y1)
    and top-right (x2, y1) corners over its w / h, and the gt's h + 1
    relative to the proposal's h."""
    _, _, pw, ph = _proposal_geometry(proposals)
    px1, py1, px2 = proposals[..., 0], proposals[..., 1], proposals[..., 2]
    deltas = torch.stack([(gt[..., 0] - px1) / pw, (gt[..., 1] - py1) / ph,
                          (gt[..., 2] - px2) / pw, (gt[..., 3] - py1) / ph,
                          (gt[..., 4] + 1.0 - ph) / ph], dim=-1)
    return _normalize(deltas, means, stds)


def delta2hobb(rois, deltas, means=(0.,) * 5, stds=(1.,) * 5,
               wh_ratio_clip=16.0 / 1000.0):
    """Decode deltas [..., 5*K] onto HBB rois [..., 4]: hobbs [..., 5*K],
    the h delta clipped to |log(wh_ratio_clip)|."""
    shape = deltas.shape
    dx1, dy1, dx2, dy2, dh = _denormalize_grouped(deltas, means, stds,
                                                  5).unbind(-1)
    max_ratio = abs(math.log(wh_ratio_clip))
    dh = dh.clamp(-max_ratio, max_ratio)
    _, _, pw, ph = (v[..., None] for v in _proposal_geometry(rois))
    px1, py1, px2 = (rois[..., i][..., None] for i in range(3))
    return torch.stack([pw * dx1 + px1, ph * dy1 + py1, pw * dx2 + px2,
                        ph * dy2 + py1, ph * dh + ph],
                       dim=-1).reshape(shape)


def rtheta2delta(rrois, gt, means=(0.,) * 5, stds=(1.,) * 5):
    """Encode thetaobb gt [..., 5] against rotated proposals [..., 5]:
    centre offsets rotated into the proposal's frame over its (w, h),
    log size ratios, raw angle difference."""
    px, py, pw, ph, pt = rrois.unbind(-1)
    pw = pw.clamp(min=1e-4)
    ph = ph.clamp(min=1e-4)
    cos, sin = torch.cos(pt), torch.sin(pt)
    ox = gt[..., 0] - px
    oy = gt[..., 1] - py
    dx = (cos * ox + sin * oy) / pw
    dy = (-sin * ox + cos * oy) / ph
    dw = torch.log(gt[..., 2].clamp(min=1e-4) / pw)
    dh = torch.log(gt[..., 3].clamp(min=1e-4) / ph)
    dt = gt[..., 4] - pt
    return _normalize(torch.stack([dx, dy, dw, dh, dt], dim=-1), means,
                      stds)


def delta2rtheta(rrois, deltas, means=(0.,) * 5, stds=(1.,) * 5,
                 wh_ratio_clip=16.0 / 1000.0):
    """Inverse of `rtheta2delta`: deltas [..., 5*K] (per-class groups)
    onto rotated rois [..., 5]; returns thetaobbs [..., 5*K]."""
    shape = deltas.shape
    dx, dy, dw, dh, dt = _denormalize_grouped(deltas, means, stds,
                                              5).unbind(-1)
    max_ratio = abs(math.log(wh_ratio_clip))
    dw = dw.clamp(-max_ratio, max_ratio)
    dh = dh.clamp(-max_ratio, max_ratio)
    px, py, pw, ph, pt = (v[..., None] for v in rrois.unbind(-1))
    cos, sin = torch.cos(pt), torch.sin(pt)
    ox = cos * (pw * dx) - sin * (ph * dy)
    oy = sin * (pw * dx) + cos * (ph * dy)
    return torch.stack([px + ox, py + oy, pw * torch.exp(dw.to(pw.dtype)),
                        ph * torch.exp(dh.to(ph.dtype)), pt + dt],
                       dim=-1).reshape(shape)


def _same(x):
    return x


# the reference's RBBOX_CODECS: name -> (regression dims, encode,
# decode, to the 4 corners); rtheta encodes against rotated proposals
RBBOX_CODECS = {
    "thetaobb": (5, thetaobb2delta, delta2thetaobb, thetaobb2pointobb),
    "pointobb": (8, pointobb2delta, delta2pointobb, _same),
    "hobb": (5, hobb2delta, delta2hobb, hobb2pointobb),
    "rtheta": (5, rtheta2delta, delta2rtheta, thetaobb2pointobb)}
