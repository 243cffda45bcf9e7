"""Deformable RoI pooling (DCN's position-sensitive pooling with group
size 1) and its learned-offset modules.

Port of `aidet_tpu/ops/deform_pool.py` (`deform_roi_pool` :48,
`DeformRoIPoolingPack` :121, `ModulatedDeformRoIPoolingPack` :155;
parity: mmdet/ops/dcn/deform_pool.py and its CUDA kernel): each output
bin averages ``sample_per_part``^2 bilinear samples on its sub-grid,
shifted by a per-bin offset times ``trans_std`` and the roi's size;
samples outside the map leave the average.  The reference writes it as
XLA code (one gather and a masked mean), so it is plain PyTorch here,
differentiable through autograd for the features and the offsets, with
the rois taken in chunks of ``chunk`` to bound the gather's memory.
Maps are [H, W, C], as the reference's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def _bilinear_gather(feat, ys, xs):
    """feat [H, W, C]; ys, xs [...] inside the map: the bilinear samples
    [..., C]."""
    h, w, _ = feat.shape
    flat = feat.reshape(h * w, -1)
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    ly = (ys - y0)[..., None]
    lx = (xs - x0)[..., None]
    y0i = y0.long().clamp(0, h - 1)
    x0i = x0.long().clamp(0, w - 1)
    y1i = (y0i + 1).clamp(max=h - 1)
    x1i = (x0i + 1).clamp(max=w - 1)

    def g(yy, xx):
        return flat[yy * w + xx]
    return ((1 - ly) * ((1 - lx) * g(y0i, x0i) + lx * g(y0i, x1i))
            + ly * ((1 - lx) * g(y1i, x0i) + lx * g(y1i, x1i)))


def deform_roi_pool(feat, rois, offsets=None, out_size: int = 7,
                    spatial_scale: float = 1.0, sample_per_part: int = 4,
                    trans_std: float = 0.0, chunk: int = 64):
    """Deformable RoI pooling of rois [R, 4] (image pixels, rounded as
    the CUDA kernel does) on feat [H, W, C]; offsets [R, P, P, 2] are the
    normalised per-bin (x, y) shifts, or None.  Returns [R, P, P, C]."""
    hh, ww, _ = feat.shape
    r, p, s = rois.shape[0], out_size, sample_per_part
    x1 = torch.round(rois[:, 0]) * spatial_scale - 0.5
    y1 = torch.round(rois[:, 1]) * spatial_scale - 0.5
    x2 = (torch.round(rois[:, 2]) + 1.0) * spatial_scale - 0.5
    y2 = (torch.round(rois[:, 3]) + 1.0) * spatial_scale - 0.5
    rw = (x2 - x1).clamp(min=0.1)
    rh = (y2 - y1).clamp(min=0.1)
    bw, bh = rw / p, rh / p
    if offsets is None:
        tx = ty = rois.new_zeros((r, p, p))
    else:
        tx = offsets[..., 0] * trans_std
        ty = offsets[..., 1] * trans_std
    grid = torch.arange(p, dtype=rois.dtype, device=rois.device)
    # each bin's start plus its shift (in roi sizes): [R, P (h), P (w)]
    wstart = (grid[None, None, :] * bw[:, None, None] + x1[:, None, None]
              + tx * rw[:, None, None])
    hstart = (grid[None, :, None] * bh[:, None, None] + y1[:, None, None]
              + ty * rh[:, None, None])
    sub = torch.arange(s, dtype=rois.dtype, device=rois.device)
    xs = (wstart[..., None, None]
          + sub[None, None, None, None, :] * (bw / s)[:, None, None, None,
                                                       None])
    ys = (hstart[..., None, None]
          + sub[None, None, None, :, None] * (bh / s)[:, None, None, None,
                                                       None])
    inside = ((xs >= -0.5) & (xs <= ww - 0.5)
              & (ys >= -0.5) & (ys <= hh - 0.5)).to(feat.dtype)
    xs = xs.clamp(0.0, ww - 1.0)
    ys = ys.clamp(0.0, hh - 1.0)
    outs = []
    for i in range(0, max(r, 1), chunk):
        cin = inside[i:i + chunk]
        vals = _bilinear_gather(feat, ys[i:i + chunk],
                                xs[i:i + chunk]) * cin[..., None]
        cnt = cin.sum(dim=(-1, -2)).clamp(min=1.0)
        outs.append(vals.sum(dim=(-2, -3)) / cnt[..., None])
    return torch.cat(outs)


class _OffsetPool(nn.Module):
    """The shared part of the learned-offset packs: an unshifted pool
    through ``num_offset_fcs`` linears (``offset_fc{i}`` with ReLU, then
    ``offset_out``, zero-initialised) to per-bin offsets, laid out as
    the reference's [R, 2, P, P] x-plane, y-plane."""

    def __init__(self, out_size, out_channels, spatial_scale,
                 sample_per_part, trans_std, num_offset_fcs,
                 deform_fc_channels):
        super().__init__()
        self.out_size = out_size
        self.spatial_scale = spatial_scale
        self.sample_per_part = sample_per_part
        self.trans_std = trans_std
        self.num_offset_fcs = num_offset_fcs
        cin = out_size * out_size * out_channels
        for i in range(num_offset_fcs - 1):
            self.add_module(f"offset_fc{i}",
                            nn.Linear(cin, deform_fc_channels))
            cin = deform_fc_channels
        self.offset_out = nn.Linear(cin, out_size * out_size * 2)
        nn.init.zeros_(self.offset_out.weight)
        nn.init.zeros_(self.offset_out.bias)

    def _fcs(self, x, prefix, n):
        for i in range(n - 1):
            x = F.relu(getattr(self, f"{prefix}{i}")(x))
        return x

    def pools(self, feat, rois):
        """(the unshifted pool flattened [R, P * P * C], the shifted
        pool [R, P, P, C])."""
        p = self.out_size
        base = deform_roi_pool(feat, rois, None, p, self.spatial_scale,
                               self.sample_per_part).reshape(rois.shape[0],
                                                             -1)
        off = self.offset_out(self._fcs(base, "offset_fc",
                                        self.num_offset_fcs))
        off = off.reshape(-1, 2, p, p).permute(0, 2, 3, 1)
        return base, deform_roi_pool(feat, rois, off, p, self.spatial_scale,
                                     self.sample_per_part, self.trans_std)


class DeformRoIPoolingPack(_OffsetPool):
    """Learned-offset deformable RoI pooling (deform_pool.py:113-175):
    feat [H, W, C], rois [R, 4] -> [R, P, P, C]."""

    def __init__(self, out_size=7, out_channels=256, spatial_scale=1.0,
                 sample_per_part=4, trans_std=0.1, num_offset_fcs=3,
                 deform_fc_channels=1024):
        super().__init__(out_size, out_channels, spatial_scale,
                         sample_per_part, trans_std, num_offset_fcs,
                         deform_fc_channels)

    def forward(self, feat, rois):
        return self.pools(feat, rois)[1]


class ModulatedDeformRoIPoolingPack(_OffsetPool):
    """`DeformRoIPoolingPack` times a learned per-bin sigmoid mask
    (``mask_fc{i}`` with ReLU, then ``mask_out``, zero-initialised) of
    the unshifted pool (deform_pool.py:177-254)."""

    def __init__(self, out_size=7, out_channels=256, spatial_scale=1.0,
                 sample_per_part=4, trans_std=0.1, num_offset_fcs=3,
                 num_mask_fcs=2, deform_fc_channels=1024):
        super().__init__(out_size, out_channels, spatial_scale,
                         sample_per_part, trans_std, num_offset_fcs,
                         deform_fc_channels)
        self.num_mask_fcs = num_mask_fcs
        cin = out_size * out_size * out_channels
        for i in range(num_mask_fcs - 1):
            self.add_module(f"mask_fc{i}", nn.Linear(cin, deform_fc_channels))
            cin = deform_fc_channels
        self.mask_out = nn.Linear(cin, out_size * out_size)
        nn.init.zeros_(self.mask_out.weight)
        nn.init.zeros_(self.mask_out.bias)

    def forward(self, feat, rois):
        base, pooled = self.pools(feat, rois)
        p = self.out_size
        mask = torch.sigmoid(self.mask_out(self._fcs(base, "mask_fc",
                                                     self.num_mask_fcs)))
        return pooled * mask.reshape(-1, p, p, 1)
