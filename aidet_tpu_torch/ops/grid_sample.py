"""Affine grids, bilinear grid sampling and the masked conv.

Port of `aidet_tpu/ops/grid_sample.py` (`affine_grid` :14,
`grid_sample` :34, `masked_conv2d` :93; parity: mmdet/ops/grid_sampler,
affine_grid and masked_conv).  The reference writes them as XLA code,
so they are plain PyTorch here: the grid by hand, as the reference
builds it, the sampling by `F.grid_sample` (bilinear; ``"zeros"``
padding fades each tap outside the map to 0, ``"border"`` clamps the
coordinates, as the reference's two modes), and the masked conv as a
dense conv times the mask.  Maps are NHWC, as the reference's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def affine_grid(theta, size, align_corners: bool = False):
    """The sampling grid [B, H, W, 2] of normalised (x, y) of 2x3 affine
    matrices theta [B, 2, 3] over ``size`` (B, H, W)."""
    _, h, w = size
    kw = dict(dtype=theta.dtype, device=theta.device)
    if align_corners:
        xs = torch.linspace(-1.0, 1.0, w, **kw)
        ys = torch.linspace(-1.0, 1.0, h, **kw)
    else:
        xs = (torch.arange(w, **kw) + 0.5) * 2.0 / w - 1.0
        ys = (torch.arange(h, **kw) + 0.5) * 2.0 / h - 1.0
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], -1)     # [H, W, 3]
    return torch.einsum("hwk,bjk->bhwj", base, theta)


def grid_sample(x, grid, align_corners: bool = False,
                padding_mode: str = "zeros"):
    """Bilinear samples of x [B, H, W, C] at grid [B, Ho, Wo, 2]
    (normalised (x, y) in [-1, 1]): [B, Ho, Wo, C]."""
    if padding_mode not in ("zeros", "border"):
        raise ValueError(f"padding_mode {padding_mode!r}: 'zeros' or "
                         "'border'")
    out = F.grid_sample(x.permute(0, 3, 1, 2), grid.to(x.dtype),
                        mode="bilinear", padding_mode=padding_mode,
                        align_corners=align_corners)
    return out.permute(0, 2, 3, 1)


def masked_conv2d(x, mask, weight, bias=None, padding: int = 1):
    """The conv of x [B, H, W, C] with weight [O, C, kh, kw] (and bias
    [O]), 0 where ``mask`` (broadcast to [B, H, W, O]) is not positive:
    numerically the masked conv, which computes only the masked
    positions."""
    out = F.conv2d(x.permute(0, 3, 1, 2), weight, bias,
                   padding=padding).permute(0, 2, 3, 1)
    return out * (mask > 0).to(out.dtype)
