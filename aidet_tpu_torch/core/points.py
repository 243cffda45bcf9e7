"""Pyramid points: the centre of every feature-map cell.

Port of `aidet_tpu/core/points.py::build_pyramid_points` :20 (parity:
mmdet's point_generator.py), which the guided-anchoring heads use.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


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
