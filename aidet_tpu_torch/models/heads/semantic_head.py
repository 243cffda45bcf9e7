"""The semantic branches: CenterMap-Net's WPSGA head, HTC's fused
semantic head, and their loss.

Port of `aidet_tpu/models/heads/semantic_head.py` (`FusedSemanticHead`
:30-63, `ChannelAttention` :66-78, `SpatialAttention` :81-91,
`WPSGAHead` :94-131, `semantic_loss` :134-168; parity: the reference's
wpsga_head.py and fused_semantic_head.py).  WPSGA: semantic-FPN scale
heads summed at the finest level, a channel gate and a spatial gate,
and a 1x1 predictor of per-pixel class logits.  Level i runs its first
3x3 conv at its own resolution, is resized to level 0's, then runs its
remaining convs there (:116-124), as the reference does.  The fused
head: a 1x1 lateral per level, each resized to the fusion level's size
and summed, a 3x3 conv stack, then a 1x1 embedding (ReLU) and 1x1
logits.  NHWC in and out.  Submodule names follow the reference's
parameter tree (scale{i}_conv{k}, ca.fc1, ca.fc2, sa.conv, predictor;
lateral{i}, conv{i}, conv_embedding, conv_logits).

`jax.image.resize`'s "bilinear" antialiases when it shrinks (a
triangle filter stretched by the scale, renormalized at the border);
torch's bilinear interpolation is the same function, without antialias
where it enlarges or keeps the size and with ``antialias=True`` where
it shrinks (the fused head's finer levels; `semantic_loss`'s weight
map already has the logits' size at ``seg_scale`` 4).  Its "nearest"
takes half-pixel centres: torch's "nearest-exact".
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def resize_bilinear(x, hw):
    """NCHW x to spatial size ``hw``, bilinear with half-pixel centres,
    antialiased where it shrinks (`jax.image.resize(method="bilinear")`).
    A shrink in one axis and a stretch in the other raises: torch
    antialiases both axes or neither."""
    shrink = x.shape[-2] > hw[0], x.shape[-1] > hw[1]
    if tuple(x.shape[-2:]) == tuple(hw):
        return x
    if any(shrink) and not (x.shape[-2] >= hw[0] and x.shape[-1] >= hw[1]):
        raise NotImplementedError(
            f"a bilinear resize {tuple(x.shape[-2:])} -> {tuple(hw)} "
            "that shrinks one axis and stretches the other is not ported")
    return F.interpolate(x, size=tuple(hw), mode="bilinear",
                         align_corners=False, antialias=any(shrink))


class FusedSemanticHead(nn.Module):
    """HTC's semantic branch: returns (seg_logits [B, Hf, Wf,
    num_classes], semantic_feat [B, Hf, Wf, C]) at the fusion level's
    size; `semantic_loss` at the reference's settings for it (CE, weight
    0.2, ignore 255)."""
    loss_weight, use_focal, focal_gamma = 0.2, False, 2.0

    def __init__(self, num_ins=5, fusion_level=1, num_convs=4,
                 in_channels=256, conv_out_channels=256, num_classes=183):
        super().__init__()
        self.num_ins = num_ins
        self.fusion_level = fusion_level
        self.num_convs = num_convs
        for i in range(num_ins):
            self.add_module(f"lateral{i}",
                            nn.Conv2d(in_channels, in_channels, 1))
        cin = in_channels
        for i in range(num_convs):
            self.add_module(f"conv{i}", nn.Conv2d(cin, conv_out_channels, 3,
                                                  padding=1))
            cin = conv_out_channels
        self.conv_embedding = nn.Conv2d(cin, conv_out_channels, 1)
        self.conv_logits = nn.Conv2d(cin, num_classes, 1)

    def forward(self, feats):
        """feats: [B, H_l, W_l, C] levels."""
        ref = feats[self.fusion_level].permute(0, 3, 1, 2)
        hw = ref.shape[-2:]
        x = getattr(self, f"lateral{self.fusion_level}")(ref)
        for i, f in enumerate(feats[:self.num_ins]):
            if i != self.fusion_level:
                lat = getattr(self, f"lateral{i}")(f.permute(0, 3, 1, 2))
                x = x + resize_bilinear(lat, hw)
        for i in range(self.num_convs):
            x = F.relu(getattr(self, f"conv{i}")(x))
        embedding = F.relu(self.conv_embedding(x))
        logits = self.conv_logits(x)
        return logits.permute(0, 2, 3, 1), embedding.permute(0, 2, 3, 1)


class ChannelAttention(nn.Module):
    """Squeeze-excite channel gate: the map's mean per channel through
    two linears (ReLU, sigmoid) scales its channels."""

    def __init__(self, channels, reduction=16):
        super().__init__()
        hidden = max(channels // reduction, 4)
        self.fc1 = nn.Linear(channels, hidden)
        self.fc2 = nn.Linear(hidden, channels)

    def forward(self, x):
        """x: NCHW."""
        g = F.relu(self.fc1(x.mean(dim=(2, 3))))
        g = torch.sigmoid(self.fc2(g))
        return x * g[:, :, None, None]


class SpatialAttention(nn.Module):
    """A 7x7 conv over the channels' mean and max, sigmoid, scales
    every pixel."""

    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(2, 1, 7, padding=3)

    def forward(self, x):
        s = torch.cat([x.mean(1, keepdim=True), x.amax(1, keepdim=True)], 1)
        return x * torch.sigmoid(self.conv(s))


class WPSGAHead(nn.Module):
    """Weighted pseudo-segmentation head with global attention.
    ``loss_weight``, ``use_focal`` and ``focal_gamma`` configure
    `semantic_loss` (the reference's defaults: 1.0, focal, 2.0)."""

    def __init__(self, in_channels=256, channels=128, num_levels=4,
                 num_classes=16, with_attention=True, loss_weight=1.0,
                 use_focal=True, focal_gamma=2.0):
        super().__init__()
        self.num_levels = num_levels
        self.loss_weight = loss_weight
        self.use_focal = use_focal
        self.focal_gamma = focal_gamma
        for i in range(num_levels):
            cin = in_channels
            for k in range(max(i, 1)):
                self.add_module(f"scale{i}_conv{k}",
                                nn.Conv2d(cin, channels, 3, padding=1))
                cin = channels
        self.with_attention = with_attention
        if with_attention:
            self.ca = ChannelAttention(channels)
            self.sa = SpatialAttention()
        self.predictor = nn.Conv2d(channels, num_classes, 1)

    def forward(self, feats):
        """feats: [B, H_l, W_l, C] levels -> (seg_logits [B, H0, W0,
        num_classes], semantic_feat [B, H0, W0, channels]) at the
        finest level."""
        hw = feats[0].shape[1:3]
        acc = None
        for i, f in enumerate(feats[:self.num_levels]):
            x = f.permute(0, 3, 1, 2)
            for k in range(max(i, 1)):
                x = F.relu(getattr(self, f"scale{i}_conv{k}")(x))
                x = resize_bilinear(x, hw)
            acc = x if acc is None else acc + x
        if self.with_attention:
            acc = self.sa(self.ca(acc))
        logits = self.predictor(acc)
        return logits.permute(0, 2, 3, 1), acc.permute(0, 2, 3, 1)


def semantic_loss(seg_logits, gt_seg, weight_map=None, ignore_label=255,
                  loss_weight=0.2, use_focal=False, focal_gamma=2.0):
    """Per-pixel CE over seg_logits [B, H, W, C] at gt_seg [B, Hs, Ws]
    (int labels resized nearest, half-pixel centres, to H x W), focal
    ((1 - pt)^gamma) if ``use_focal``; with ``weight_map`` [B, Hs, Ws]
    in [0, 1] (resized bilinear) the mean over every pixel of ce *
    (w + 1) * loss_weight, ignored pixels 0; else loss_weight times the
    CE summed over the valid pixels over their count (at least 1)."""
    h, w = seg_logits.shape[1:3]
    gt = F.interpolate(gt_seg[:, None].float(), size=(h, w),
                       mode="nearest-exact")[:, 0].long()
    valid = gt != ignore_label
    gt_safe = torch.where(valid, gt, 0)
    logp = F.log_softmax(seg_logits, -1)
    ce = -torch.gather(logp, -1, gt_safe[..., None])[..., 0]
    if use_focal:
        pt = torch.exp(-ce)
        ce = (1.0 - pt) ** focal_gamma * ce
    ce = torch.where(valid, ce, 0.0)
    if weight_map is not None:
        wm = resize_bilinear(weight_map[:, None].float(), (h, w))[:, 0]
        return (ce * (wm + 1.0) * loss_weight).mean()
    return loss_weight * ce.sum() / valid.float().sum().clamp(min=1.0)
