"""HRNet backbone: parallel multi-resolution branches with repeated
cross-resolution fusion, returning the 4 resolution streams.

Port of `aidet_tpu/models/backbones/hrnet.py` (`HRModule` :23, `HRNet`
:74; parity: mmdet/models/backbones/hrnet.py:12-195): a stem of two
stride-2 3x3 convs, stage 1 of four Bottlenecks at 1/4 resolution, then
transitions and stages 2-4 of HRModules (BasicBlock branches and full
fusion), FrozenBN everywhere, nothing detached.  Submodule names follow
the reference's parameter tree (`stem1`, `layer1_block0.conv1`,
`t1_0`, `stage2_module0.branch0_block0`, `stage2_module0.fuse0_1`,
...), so `aidet_tpu_torch.convert` maps weights one to one.  NHWC in,
NHWC out, as the ResNet.
"""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from .resnet import BasicBlock, Bottleneck, FrozenBN, conv


def _resize_to(x, like):
    """Nearest resize of NCHW x to like's size with half-pixel centres:
    `jax.image.resize(method="nearest")` (plain "nearest" differs where
    the ratio is not an integer)."""
    return F.interpolate(x, size=like.shape[-2:], mode="nearest-exact")


class HRModule(nn.Module):
    """One multi-branch stage: ``num_blocks`` BasicBlocks per branch,
    then every output sums every branch: lower resolutions through a
    1x1 conv, FrozenBN and a nearest upsample; higher ones through a
    chain of stride-2 3x3 convs with FrozenBN (ReLU between, not after
    the last), then a ReLU."""

    def __init__(self, num_branches, num_blocks, in_channels, channels):
        super().__init__()
        self.num_branches = num_branches
        self.num_blocks = num_blocks
        for b in range(num_branches):
            cin = in_channels[b]
            for k in range(num_blocks):
                self.add_module(f"branch{b}_block{k}", BasicBlock(
                    cin, channels[b], downsample=(k == 0
                                                  and cin != channels[b])))
                cin = channels[b]
        for i in range(num_branches):
            for j in range(num_branches):
                if j > i:
                    self.add_module(f"fuse{i}_{j}",
                                    conv(channels[j], channels[i], 1))
                    self.add_module(f"fuse_bn{i}_{j}", FrozenBN(channels[i]))
                for s in range(i - j):
                    cout = channels[i] if s == i - j - 1 else channels[j]
                    self.add_module(f"fuse{i}_{j}_{s}",
                                    conv(channels[j], cout, 3, 2))
                    self.add_module(f"fuse_bn{i}_{j}_{s}", FrozenBN(cout))

    def forward(self, xs):
        outs = []
        for b, x in enumerate(xs):
            for k in range(self.num_blocks):
                x = getattr(self, f"branch{b}_block{k}")(x)
            outs.append(x)
        fused = []
        for i in range(self.num_branches):
            acc = outs[i]
            for j in range(self.num_branches):
                y = outs[j]
                if j > i:
                    y = getattr(self, f"fuse_bn{i}_{j}")(
                        getattr(self, f"fuse{i}_{j}")(y))
                    y = _resize_to(y, acc)
                for s in range(i - j):
                    y = getattr(self, f"fuse_bn{i}_{j}_{s}")(
                        getattr(self, f"fuse{i}_{j}_{s}")(y))
                    if s < i - j - 1:
                        y = F.relu(y)
                if j != i:
                    acc = acc + y
            fused.append(F.relu(acc))
        return fused


class HRNet(nn.Module):
    """HRNet-W``width``: branch channels (w, 2w, 4w, 8w); stage
    ``s`` (2..4) has ``stage_modules[s - 1]`` HRModules of
    ``stage_blocks`` blocks per branch (stage 1 is always four
    Bottlenecks of 64 planes)."""

    def __init__(self, width=32, stage_modules=(1, 1, 4, 3), stage_blocks=4):
        super().__init__()
        chans = (width, width * 2, width * 4, width * 8)
        self.stem1 = conv(3, 64, 3, 2)
        self.stem_bn1 = FrozenBN(64)
        self.stem2 = conv(64, 64, 3, 2)
        self.stem_bn2 = FrozenBN(64)
        cin = 64
        for k in range(4):
            self.add_module(f"layer1_block{k}",
                            Bottleneck(cin, 64, downsample=(k == 0)))
            cin = 256
        self.stage_modules = stage_modules
        prev = [256]
        for stage in range(1, 4):
            # a transition conv where a branch's channels change, and a
            # stride-2 one from the last branch for the new branch
            for b in range(stage + 1):
                if b < len(prev) and prev[b] == chans[b]:
                    continue
                src, stride = (prev[b], 1) if b < len(prev) else (prev[-1], 2)
                self.add_module(f"t{stage}_{b}",
                                conv(src, chans[b], 3, stride))
                self.add_module(f"t_bn{stage}_{b}", FrozenBN(chans[b]))
            for m in range(stage_modules[stage]):
                self.add_module(f"stage{stage + 1}_module{m}", HRModule(
                    stage + 1, stage_blocks, chans[:stage + 1],
                    chans[:stage + 1]))
            prev = chans[:stage + 1]

    def forward(self, x):
        """x: [B, H, W, 3] -> the 4 streams [B, H / 4 / 2^i, ..., C_i]."""
        x = x.to(self.stem1.weight.dtype).permute(0, 3, 1, 2)
        x = F.relu(self.stem_bn1(self.stem1(x)))
        x = F.relu(self.stem_bn2(self.stem2(x)))
        for k in range(4):
            x = getattr(self, f"layer1_block{k}")(x)
        xs = [x]
        for stage in range(1, 4):
            new = []
            for b in range(stage + 1):
                if f"t{stage}_{b}" not in self._modules:
                    new.append(xs[b])
                    continue
                src = xs[b] if b < len(xs) else xs[-1]
                new.append(F.relu(getattr(self, f"t_bn{stage}_{b}")(
                    getattr(self, f"t{stage}_{b}")(src))))
            xs = new
            for m in range(self.stage_modules[stage]):
                xs = getattr(self, f"stage{stage + 1}_module{m}")(xs)
        return tuple(y.permute(0, 2, 3, 1) for y in xs)
