"""Grid R-CNN's grid head, its targets and its box decode.

Port of `aidet_tpu/models/heads/grid_head.py` (`_neighbor_edges` :17,
`_grouped_deconv2x` :35, `GridHead` :51, `grid_target` :139,
`grid_to_boxes` :175; parity: mmdet's grid_head.py and grid_rcnn.py):
box regression is replaced by heatmaps of ``grid_points`` (3 x 3)
points per roi, and boxes are recovered from the heatmaps' argmax
locations.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...parallel.dist import global_count
from ..backbones.resnet import GroupNorm


def neighbor_edges(grid_points: int):
    """The directed (dst, src) 4-neighbour edges of the row-major
    lattice of ``grid_points`` points."""
    side = int(grid_points ** 0.5)
    edges = []
    for p in range(grid_points):
        iy, ix = divmod(p, side)
        if ix > 0:
            edges.append((p, p - 1))
        if iy > 0:
            edges.append((p, p - side))
        if iy < side - 1:
            edges.append((p, p + side))
        if ix < side - 1:
            edges.append((p, p + 1))
    return edges


class GridHead(nn.Module):
    """Grid R-CNN Plus's head: ``num_convs`` 3x3 convs with GroupNorm
    (``norm_groups``, epsilon 1e-6 as flax's) and ReLU, the first
    strided 2, give ``point_feat_channels`` per point; the first- and
    second-order fusion pass each point's features along every lattice
    edge (a 5x5 depthwise conv ``{f,s}order_dw`` and a 1x1 conv grouped
    by edge ``{f,s}order_pw``) and add them into the edge's destination
    (a one-hot matrix product); two 4x4 stride-2 transposed convs
    grouped by point (``deconv1``, GroupNorm ``deconv_norm`` and ReLU,
    ``deconv2``) give the heatmaps.  The unfused trunk shares the
    deconvs for the training loss.  `init_prior` sets the reference's
    N(0, 1e-3) deconv weights and the deconv2 bias -log(0.99 / 0.01)."""

    # the reference declares the deconv biases as raw leaves
    # deconv{1,2}_bias, which its optimizer's paramwise options count
    # as norm affines (`parallel.train.param_kinds`)
    param_kind_overrides = {"deconv1.bias": "norm", "deconv2.bias": "norm"}

    def __init__(self, grid_points=9, num_convs=8, in_channels=256,
                 point_feat_channels=64, norm_groups=36, fusion=True):
        super().__init__()
        self.grid_points = grid_points
        self.num_convs = num_convs
        self.fusion = fusion
        p, c = grid_points, point_feat_channels
        cout = p * c
        cin = in_channels
        for i in range(num_convs):
            self.add_module(f"conv{i}", nn.Conv2d(
                cin, cout, 3, stride=2 if i == 0 else 1, padding=1))
            self.add_module(f"GroupNorm_{i}", GroupNorm(norm_groups, cout,
                                                        eps=1e-6))
            cin = cout
        if fusion:
            edges = neighbor_edges(p)
            e = len(edges)
            for name in ("forder", "sorder"):
                self.add_module(f"{name}_dw", nn.Conv2d(
                    e * c, e * c, 5, padding=2, groups=e * c))
                self.add_module(f"{name}_pw", nn.Conv2d(e * c, e * c, 1,
                                                        groups=e))
            src = torch.tensor([s for _, s in edges])
            self.register_buffer("src_channels", (
                src[:, None] * c + torch.arange(c)).reshape(-1),
                persistent=False)
            self.register_buffer("scatter", F.one_hot(
                torch.tensor([d for d, _ in edges]), p).float(),
                persistent=False)
        self.deconv1 = nn.ConvTranspose2d(cout, cout, 4, 2, 1, groups=p)
        self.deconv_norm = GroupNorm(p, cout, eps=1e-6)
        self.deconv2 = nn.ConvTranspose2d(cout, p, 4, 2, 1, groups=p)
        self.init_prior()

    @torch.no_grad()
    def init_prior(self):
        for m in (self.deconv1, self.deconv2):
            m.weight.mul_(1e-3 / m.weight.std().clamp(min=1e-12))
        self.deconv2.bias.fill_(-4.59511985)

    def _edge_fuse(self, x, name):
        """x [N, P * c, H, W] gathered at the edges' sources, through
        the depthwise and grouped 1x1 convs, summed into the edges'
        destinations: [N, P * c, H, W]."""
        g = getattr(self, f"{name}_pw")(getattr(self, f"{name}_dw")(
            x[:, self.src_channels]))
        n, _, h, w = g.shape
        e, p = self.scatter.shape
        g = torch.einsum("nechw,ep->npchw", g.reshape(n, e, -1, h, w),
                         self.scatter.to(g.dtype))
        return g.reshape(n, -1, h, w)

    def _decode(self, x):
        h = F.relu(self.deconv_norm(self.deconv1(x)))
        return self.deconv2(h).permute(0, 2, 3, 1)

    def forward(self, x, return_unfused=False):
        """x: [N, s, s, C] -> heatmaps [N, 2s, 2s, grid_points] (the trunk
        halves, the deconvs quadruple); with ``return_unfused`` also the
        unfused trunk's."""
        x = x.permute(0, 3, 1, 2)
        for i in range(self.num_convs):
            x = F.relu(getattr(self, f"GroupNorm_{i}")(
                getattr(self, f"conv{i}")(x)))
        fused = x
        if self.fusion:
            x_fo = x + self._edge_fuse(x, "forder")
            fused = x + self._edge_fuse(x_fo, "sorder")
        heat = self._decode(fused)
        if return_unfused:
            return heat, self._decode(x)
        return heat


def grid_target(sample, rois, gt_boxes, heatmap_size=14, grid_points=9,
                sigma=1.0):
    """Gaussian heatmap targets [B, R, S, S, grid_points] of the matched
    gts' grid points (the 3 x 3 lattice over each gt box), in the roi's
    frame on the 0..S-1 lattice (the roi's corners on the border
    pixels), 0 for a point outside the roi and for rois that are not
    positive.  sample: a `core.sample.FixedSample` [B, R]; rois [B, R,
    4]; gt_boxes [B, G, 4]."""
    g = gt_boxes.shape[1]
    safe = sample.gt_inds.clamp(0, g - 1)
    gt = torch.gather(gt_boxes, 1, safe[..., None].expand(-1, -1, 4))
    side = int(grid_points ** 0.5)
    fr = torch.linspace(0.0, 1.0, side, device=rois.device)
    gx = gt[..., 0:1] + fr * (gt[..., 2:3] - gt[..., 0:1])     # [B, R, 3]
    gy = gt[..., 1:2] + fr * (gt[..., 3:4] - gt[..., 1:2])
    px = gx.repeat(1, 1, side)                                 # [B, R, 9]
    py = gy.repeat_interleave(side, -1)
    w = (rois[..., 2:3] - rois[..., 0:1]).clamp(min=1.0)
    h = (rois[..., 3:4] - rois[..., 1:2]).clamp(min=1.0)
    u = (px - rois[..., 0:1]) / w * (heatmap_size - 1)
    v = (py - rois[..., 1:2]) / h * (heatmap_size - 1)
    ii = torch.arange(heatmap_size, dtype=torch.float32, device=rois.device)
    dy = ii[:, None, None] - v[..., None, None, :]             # [B,R,S,1,9]
    dx = ii[None, :, None] - u[..., None, None, :]             # [B,R,1,S,9]
    heat = torch.exp(-(dx ** 2 + dy ** 2) / (2 * sigma ** 2))
    inside = (u >= 0) & (u <= heatmap_size - 1) & (v >= 0) \
        & (v <= heatmap_size - 1)
    heat = heat * inside[..., None, None, :]
    return heat * sample.is_pos[..., None, None, None]


def grid_to_boxes(heatmaps, rois):
    """Boxes [B, K, 4] from heatmaps [B, K, S, S, P] on rois [B, K, 4]:
    each point's first argmax cell mapped into the roi, then the min
    and max over the points."""
    b, k, s = heatmaps.shape[:3]
    idx = heatmaps.reshape(b, k, s * s, -1).argmax(2)          # [B, K, P]
    vy = torch.div(idx, s, rounding_mode="floor").float()
    vx = (idx % s).float()
    w = (rois[..., 2:3] - rois[..., 0:1]).clamp(min=1.0)
    h = (rois[..., 3:4] - rois[..., 1:2]).clamp(min=1.0)
    gx = rois[..., 0:1] + vx / (s - 1) * w
    gy = rois[..., 1:2] + vy / (s - 1) * h
    return torch.stack([gx.amin(-1), gy.amin(-1), gx.amax(-1), gy.amax(-1)],
                       -1)


def grid_loss(heat, heat_unfused, target, is_pos):
    """The grid branch's loss (reference two_stage.py:628-645): the
    whole-map sigmoid BCE of the fused and of the unfused heatmaps [N,
    S, S, P] against the targets, each over the positives' count (at
    least 1) times S^2 P, their sum times 15."""
    w = is_pos.float()
    n, s, _, p = heat.shape
    navg = global_count(w.sum()).clamp(min=1.0) * s * s * p

    def bce(hm):
        loss = (hm.clamp(min=0) - hm * target
                + torch.log1p(torch.exp(-hm.abs())))
        return (loss * w[:, None, None, None]).sum() / navg
    return 15.0 * (bce(heat) + bce(heat_unfused))
