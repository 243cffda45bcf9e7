"""ResNeXt backbone: the ResNet with grouped 3x3 bottlenecks.

Port of `aidet_tpu/models/backbones/resnext.py` (`XBottleneck` :16-54,
`ResNeXt` :57-96; parity: mmdet/models/backbones/resnext.py): each
bottleneck's 3x3 conv is grouped (``groups``), over a width of
``int(planes * base_width / 64) * groups`` channels; the plain 7x7
stem (no space-to-depth), FrozenBN in every norm slot, caffe or
pytorch style, `frozen_stages`, and every stage's first block with a
projection shortcut.  The grouped conv is an XLA convolution in the
reference, so it is `nn.Conv2d` with ``groups`` here.
Submodule names follow the reference's parameter tree, as the ResNet's
do.  NHWC in and out.
"""

from __future__ import annotations

from torch import nn

from .resnet import (ARCH_SETTINGS, BASE_CHANNELS, Bottleneck,
                     FrozenBN, ResNet, conv)


class XBottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin, planes, stride=1, downsample=False, groups=32,
                 base_width=4, style="pytorch"):
        super().__init__()
        width = int(planes * (base_width / 64.0)) * groups
        # 'caffe' strides the first 1x1, 'pytorch' the 3x3
        s1, s2 = (stride, 1) if style == "caffe" else (1, stride)
        self.conv1 = conv(cin, width, 1, s1)
        self.bn1 = FrozenBN(width)
        self.conv2 = nn.Conv2d(width, width, 3, s2, padding=1, groups=groups,
                               bias=False)
        self.bn2 = FrozenBN(width)
        self.conv3 = conv(width, planes * 4, 1)
        self.bn3 = FrozenBN(planes * 4)
        if downsample:
            self.ds_conv = conv(cin, planes * 4, 1, stride)
            self.ds_bn = FrozenBN(planes * 4)
        self.downsample = downsample

    forward = Bottleneck.forward


class ResNeXt(ResNet):
    """`ResNet`'s stem, stages and forward over `XBottleneck`s: C2..C5
    (strides 4, 8, 16, 32) of ``depth`` 50 or 101."""

    def __init__(self, depth=101, groups=32, base_width=4, frozen_stages=1,
                 style="pytorch"):
        nn.Module.__init__(self)
        _, stage_blocks = ARCH_SETTINGS[depth]
        self.stem_space_to_depth = False
        self.frozen_stages = frozen_stages
        self.out_indices = (0, 1, 2, 3)
        self.stem_conv = conv(3, BASE_CHANNELS, 7, 2)
        self.stem_bn = FrozenBN(BASE_CHANNELS)
        self.stage_names = []
        cur = BASE_CHANNELS
        for i, n_blocks in enumerate(stage_blocks):
            planes = BASE_CHANNELS * 2 ** i
            names = []
            for b in range(n_blocks):
                name = f"layer{i + 1}_block{b}"
                self.add_module(name, XBottleneck(
                    cur, planes, 2 if b == 0 and i > 0 else 1, b == 0,
                    groups, base_width, style))
                names.append(name)
                cur = planes * 4
            self.stage_names.append(names)
