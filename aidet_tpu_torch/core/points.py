"""Pyramid points: the centre of every feature-map cell, and the FCOS
targets of each point.

Port of `aidet_tpu/core/points.py::build_pyramid_points` :20 (parity:
mmdet's point_generator.py), which the guided-anchoring heads and the
anchor-free detectors use, and `fcos_target` :36 (parity:
FCOSHead.fcos_target_single), batched over images.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

INF = 1e8


def build_pyramid_points(img_size: int, strides: Sequence[int],
                         device="cpu"):
    """(points [P, 2] (x, y) float32 over every level of a square
    ``img_size`` input, level by level in row-major order; the points
    per level; each point's stride [P]), the point of cell (i, j) of a
    level of stride s at (j * s + s // 2, i * s + s // 2)."""
    pts, sizes, pstrides = [], [], []
    for s in strides:
        fs = img_size // s
        xs = np.arange(fs, dtype=np.float32) * s + s // 2
        gx, gy = np.meshgrid(xs, xs)
        p = np.stack([gx.reshape(-1), gy.reshape(-1)], -1)
        pts.append(p)
        sizes.append(p.shape[0])
        pstrides.append(np.full(p.shape[0], s, np.float32))
    return (torch.from_numpy(np.concatenate(pts)).to(device), sizes,
            torch.from_numpy(np.concatenate(pstrides)).to(device))


def level_values(sizes: Sequence[int], values, device="cpu"):
    """[P, len(values[0])] float32: row l of ``values`` repeated for the
    ``sizes[l]`` points of level l (the regress or scale ranges)."""
    return torch.cat([torch.tensor(v, dtype=torch.float32,
                                   device=device).expand(n, -1)
                      for n, v in zip(sizes, values)])


def fcos_target(points, regress_ranges, gt_boxes, gt_valid, gt_labels,
                strides=None, center_sample_radius=0.0):
    """FCOS targets of a batch.

    A point is positive for a valid gt that contains it (all four
    distances > 0) and whose largest distance lies in the point's
    regress range; with ``center_sample_radius`` > 0 it must also lie
    inside the gt's centre box, centre +- radius x the point's stride,
    clipped to the gt.  Among several gts the smallest (legacy +1 area)
    wins, the first of equal ones.  The centerness target is
    sqrt(min(l, r) / max(l, r) x min(t, b) / max(t, b)).

    points [P, 2]; regress_ranges [P, 2] (lo, hi); gt_boxes [B, G, 4],
    gt_valid [B, G], gt_labels [B, G] (1-based); strides [P] (needed for
    centre sampling).  Returns (labels [B, P] int32, bbox_targets [B, P,
    4] (l, t, r, b), centerness [B, P]), zero where negative."""
    x = points[None, :, 0, None]                        # [1, P, 1]
    y = points[None, :, 1, None]
    g = gt_boxes[:, None]                               # [B, 1, G, 4]
    ltrb = torch.stack([x - g[..., 0], y - g[..., 1], g[..., 2] - x,
                        g[..., 3] - y], -1)             # [B, P, G, 4]
    inside = ltrb.amin(-1) > 0
    if center_sample_radius > 0:
        if strides is None:
            raise ValueError("centre sampling needs the points' strides")
        cx = (g[..., 0] + g[..., 2]) * 0.5
        cy = (g[..., 1] + g[..., 3]) * 0.5
        rad = strides[None, :, None] * center_sample_radius
        cx1 = torch.maximum(cx - rad, g[..., 0])
        cy1 = torch.maximum(cy - rad, g[..., 1])
        cx2 = torch.minimum(cx + rad, g[..., 2])
        cy2 = torch.minimum(cy + rad, g[..., 3])
        inside = inside & (x > cx1) & (x < cx2) & (y > cy1) & (y < cy2)
    max_dist = ltrb.amax(-1)
    in_range = ((max_dist >= regress_ranges[None, :, 0, None])
                & (max_dist <= regress_ranges[None, :, 1, None]))
    areas = ((g[..., 2] - g[..., 0] + 1) * (g[..., 3] - g[..., 1] + 1))
    cand = inside & in_range & gt_valid.bool()[:, None]
    areas = torch.where(cand, areas, areas.new_tensor(INF))
    min_area, gt_idx = areas.min(-1)                    # first minimum
    pos = min_area < INF
    labels = torch.where(pos, torch.gather(gt_labels.to(torch.int32), 1,
                                           gt_idx), 0)
    tgt = torch.gather(ltrb, 2, gt_idx[..., None, None].expand(
        -1, -1, 1, 4))[:, :, 0]                          # [B, P, 4]
    lr = tgt[..., [0, 2]]
    tb = tgt[..., [1, 3]]
    centerness = torch.sqrt(
        (lr.amin(-1) / lr.amax(-1).clamp(min=1e-6)
         * (tb.amin(-1) / tb.amax(-1).clamp(min=1e-6))).clamp(0.0, 1.0))
    return (labels.to(torch.int32), tgt * pos[..., None],
            centerness * pos)
