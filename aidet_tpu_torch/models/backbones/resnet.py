"""ResNet backbone with frozen batch-norm.

Port of `aidet_tpu/models/backbones/resnet.py` (FrozenBN, BasicBlock,
Bottleneck, ResNet) at the flagship's settings: pytorch-style
bottlenecks (stride on the 3x3), stage strides (1, 2, 2, 2), symmetric
padding (k - 1) // 2 as in its `conv`, the optional space-to-depth
stem, and `frozen_stages`.  Submodule names follow the reference's
parameter tree (`stem_conv`, `layer1_block0.conv1`, ...),
so `aidet_tpu_torch.convert` maps weights one to one.

The public layout is NHWC: `ResNet.forward` takes [B, H, W, C] and
returns the C2..C5 maps as [B, H_l, W_l, C_l].  Inside, the maps are
NCHW views of NHWC memory (PyTorch's channels_last), so no copy is made
at either end.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class FrozenBN(nn.Module):
    """Affine transform with frozen running statistics; the folded
    scale and shift are computed in float32, then applied in the
    input's dtype."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x):
        inv = torch.rsqrt(self.running_var.float() + self.eps)
        w = self.weight.float()
        scale = w * inv
        shift = self.bias.float() - self.running_mean.float() * inv * w
        return (x * scale.to(x.dtype)[:, None, None]
                + shift.to(x.dtype)[:, None, None])


def conv(cin, cout, kernel, stride=1):
    return nn.Conv2d(cin, cout, kernel, stride, padding=(kernel - 1) // 2,
                     bias=False)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin, planes, stride=1, downsample=False):
        super().__init__()
        self.conv1 = conv(cin, planes, 3, stride)
        self.bn1 = FrozenBN(planes)
        self.conv2 = conv(planes, planes, 3)
        self.bn2 = FrozenBN(planes)
        if downsample:
            self.ds_conv = conv(cin, planes, 1, stride)
            self.ds_bn = FrozenBN(planes)
        self.downsample = downsample

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = self.ds_bn(self.ds_conv(x)) if self.downsample else x
        return F.relu(out + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin, planes, stride=1, downsample=False):
        super().__init__()
        self.conv1 = conv(cin, planes, 1)
        self.bn1 = FrozenBN(planes)
        self.conv2 = conv(planes, planes, 3, stride)
        self.bn2 = FrozenBN(planes)
        self.conv3 = conv(planes, planes * 4, 1)
        self.bn3 = FrozenBN(planes * 4)
        if downsample:
            self.ds_conv = conv(cin, planes * 4, 1, stride)
            self.ds_bn = FrozenBN(planes * 4)
        self.downsample = downsample

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = self.ds_bn(self.ds_conv(x)) if self.downsample else x
        return F.relu(out + identity)


# the depths the flagship's two configurations use
ARCH_SETTINGS = {
    18: (BasicBlock, (2, 2, 2, 2)),
    50: (Bottleneck, (3, 4, 6, 3)),
}
BASE_CHANNELS = 64


class ResNet(nn.Module):
    """Multi-stage ResNet returning C2..C5 (strides 4, 8, 16, 32).

    stem_space_to_depth: the 7x7/s2 stem is replaced by a 2x2
    pixel-unshuffle in (row, col, channel) order followed by a 4x4/s1
    conv over 12 channels with padding (2, 1), over a [64, 12, 4, 4]
    weight.  The reference's `stem_s2d_phase` variant is the same math
    over the same weight, relaid for the TPU's matrix unit, and needs no
    port of its own.

    frozen_stages=k detaches the stem's output and the output of each
    of the first k stages, as the reference's stop_gradients
    (resnet.py:264-268, :306-307).  Their parameters then get no
    gradient; the train step gives them the reference's zero gradient,
    so weight decay and momentum still move them.
    """

    def __init__(self, depth=50, stem_space_to_depth=False,
                 frozen_stages=1):
        super().__init__()
        block_cls, stage_blocks = ARCH_SETTINGS[depth]
        self.stem_space_to_depth = stem_space_to_depth
        self.frozen_stages = frozen_stages
        if stem_space_to_depth:
            self.stem_conv = nn.Conv2d(12, BASE_CHANNELS, 4, bias=False)
        else:
            self.stem_conv = conv(3, BASE_CHANNELS, 7, 2)
        self.stem_bn = FrozenBN(BASE_CHANNELS)
        self.stage_names = []
        cur = BASE_CHANNELS
        for i, n_blocks in enumerate(stage_blocks):
            planes = BASE_CHANNELS * 2 ** i
            out_c = planes * block_cls.expansion
            names = []
            for b in range(n_blocks):
                stride = 2 if b == 0 and i > 0 else 1
                ds = b == 0 and (stride != 1 or cur != out_c)
                name = f"layer{i + 1}_block{b}"
                self.add_module(name, block_cls(cur, planes, stride, ds))
                names.append(name)
                cur = out_c
            self.stage_names.append(names)

    def forward(self, x):
        """x: [B, H, W, C] -> tuple of [B, H_l, W_l, C_l]."""
        x = x.to(self.stem_conv.weight.dtype)
        if self.stem_space_to_depth:
            b, h, w, c = x.shape
            x = x.reshape(b, h // 2, 2, w // 2, 2, c)
            x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, h // 2, w // 2, 4 * c)
            # taps span [-2, 1] around each output pixel
            x = self.stem_conv(F.pad(x.permute(0, 3, 1, 2), (2, 1, 2, 1)))
        else:
            x = self.stem_conv(x.permute(0, 3, 1, 2))
        x = F.relu(self.stem_bn(x))
        x = F.max_pool2d(x, 3, 2, 1)
        if self.frozen_stages >= 0:
            x = x.detach()
        outs = []
        for i, names in enumerate(self.stage_names):
            for name in names:
                x = getattr(self, name)(x)
            if i + 1 <= self.frozen_stages:
                x = x.detach()
            outs.append(x.permute(0, 2, 3, 1))
        return tuple(outs)
