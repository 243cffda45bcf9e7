"""SSD's VGG-16 backbone.

Port of `aidet_tpu/models/backbones/ssd_vgg.py` (`L2Norm` :17, `SSDVGG`
:30; parity: mmdet's ssd_vgg.py): VGG-16's five conv blocks, each block
but the last followed by a 2x2 stride-2 max-pool with ceil mode (flax's
"SAME" padding: 300 -> 150 -> 75 -> 38 -> 19), pool5 3x3 stride 1 pad
1, fc6 (3x3, dilation 6) and fc7 (1x1) as convs, then four extra
stages of a 1x1 and a 3x3 (stride 2 pad 1, then stride 1 pad 0).  The
maps out: conv4_3 through `L2Norm`, fc7 and the four extras.  NHWC in
(cast to the weights' dtype, no normalize) and out.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

VGG16_CFG = (2, 2, 3, 3, 3)           # convs per block
VGG16_CHANNELS = (64, 128, 256, 512, 512)
EXTRA_CFG = ((256, 512, 2), (128, 256, 2), (128, 256, 1), (128, 256, 1))


class L2Norm(nn.Module):
    """x / sqrt(sum(x^2) + 1e-10) over the channels, times ``gamma``
    (one per channel, ``scale`` at first)."""

    def __init__(self, channels, scale=20.0):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((channels,), float(scale)))

    def forward(self, x):
        norm = torch.sqrt((x * x).sum(1, keepdim=True) + 1e-10)
        return x / norm * self.gamma.to(x.dtype)[:, None, None]


def ssd_feat_sizes(input_size: int):
    """The sides of the six maps SSDVGG gives for a square input: conv4_3
    after three ceil-mode halvings, fc7 after a fourth, then the extras
    (two stride-2 pad-1 3x3s, two pad-0 3x3s)."""
    s = input_size
    for _ in range(3):
        s = -(-s // 2)
    sizes = [s, -(-s // 2)]
    for _, _, stride in EXTRA_CFG:
        sizes.append((sizes[-1] - 1) // 2 + 1 if stride == 2
                     else sizes[-1] - 2)
    return tuple(sizes)


class SSDVGG(nn.Module):
    def __init__(self, input_size=300):
        super().__init__()
        self.input_size = input_size
        cin = 3
        for b, (n, c) in enumerate(zip(VGG16_CFG, VGG16_CHANNELS)):
            for k in range(n):
                self.add_module(f"conv{b + 1}_{k + 1}",
                                nn.Conv2d(cin, c, 3, padding=1))
                cin = c
        self.l2norm = L2Norm(512)
        self.fc6 = nn.Conv2d(512, 1024, 3, padding=6, dilation=6)
        self.fc7 = nn.Conv2d(1024, 1024, 1)
        cin = 1024
        for i, (c1, c2, s) in enumerate(EXTRA_CFG):
            self.add_module(f"extra{i}_1", nn.Conv2d(cin, c1, 1))
            self.add_module(f"extra{i}_2", nn.Conv2d(
                c1, c2, 3, stride=s, padding=1 if s == 2 else 0))
            cin = c2

    def forward(self, x):
        """x: [B, H, W, 3] -> six [B, H_l, W_l, C_l] maps."""
        x = x.to(self.fc7.weight.dtype).permute(0, 3, 1, 2)
        outs = []
        for b, n in enumerate(VGG16_CFG):
            for k in range(n):
                x = F.relu(getattr(self, f"conv{b + 1}_{k + 1}")(x))
            if b == 3:
                outs.append(self.l2norm(x))
            if b < 4:
                x = F.max_pool2d(x, 2, 2, ceil_mode=True)
            else:
                x = F.max_pool2d(x, 3, 1, 1)
        x = F.relu(self.fc7(F.relu(self.fc6(x))))
        outs.append(x)
        for i in range(len(EXTRA_CFG)):
            x = F.relu(getattr(self, f"extra{i}_1")(x))
            x = F.relu(getattr(self, f"extra{i}_2")(x))
            outs.append(x)
        return tuple(o.permute(0, 2, 3, 1) for o in outs)
