"""HRFPN neck: every HRNet stream upsampled to the finest resolution and
concatenated, a 1x1 ``reduce`` conv, then a pyramid of average pools
with a 3x3 conv each.

Port of `aidet_tpu/models/necks/hrfpn.py::HRFPN` :17 (parity:
mmdet/models/necks/hrfpn.py:12-100).  The upsampling is bilinear with
half-pixel centres and no antialiasing, as `jax.image.resize(method=
"bilinear")` upsamples; output i is the reduced map average-pooled by
2^i (no padding), then conv ``fpn{i}`` (with bias, as ``reduce``).
NHWC in, NHWC out.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class HRFPN(nn.Module):
    def __init__(self, in_channels=(32, 64, 128, 256), out_channels=256,
                 num_outs=5):
        super().__init__()
        self.num_outs = num_outs
        self.reduce = nn.Conv2d(sum(in_channels), out_channels, 1)
        for i in range(num_outs):
            self.add_module(f"fpn{i}", nn.Conv2d(out_channels, out_channels,
                                                 3, padding=1))

    def forward(self, inputs):
        """inputs: the streams [B, H_i, W_i, C_i] -> num_outs maps."""
        xs = [x.permute(0, 3, 1, 2) for x in inputs]
        size = xs[0].shape[-2:]
        ups = [xs[0]] + [F.interpolate(x, size=size, mode="bilinear",
                                       align_corners=False)
                         for x in xs[1:]]
        x = self.reduce(torch.cat(ups, 1))
        outs = []
        for i in range(self.num_outs):
            y = F.avg_pool2d(x, 2 ** i) if i else x
            outs.append(getattr(self, f"fpn{i}")(y))
        return tuple(o.permute(0, 2, 3, 1) for o in outs)
