"""NAS-FPN: the searched merging-cell pyramid.

Port of `aidet_tpu/models/necks/nas_fpn.py` (`MergingCell` :24, `NASFPN`
:45; parity: mmdet's nas_fpn.py): 1x1 laterals on the inputs from
``start_level``, extra levels by a 1x1 max-pool of stride 2, then
``stack_times`` repeats of the published cell wiring over P3..P7.  A
cell resizes both inputs to its output's size (nearest, half-pixel
centres: `jax.image.resize`'s, torch's "nearest-exact"), sums them ("sum")
or adds the second gated by the sigmoid of the first's global mean
("gp"), then ReLU and a 3x3 conv (``conv``).  NHWC in and out.

`FPN_CARAFE` (:88-118; parity: mmdet's fpn_carafe.py) is the FPN with
a `CARAFEPack` upsampling each level in the top-down path (each
lateral's CARAFE of the already merged coarser one, resized to it by
`_resize_to` where the sizes differ), 3x3 output convs with their bias,
and the extra levels by the 1x1 stride-2 max-pool.

The reference registers NASFPN and FPN_CARAFE only when its module is
imported, which its `necks/__init__` does not do (ROADMAP section 3);
the port's builder registers both.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.carafe import CARAFEPack

# (name, op, first input, second input, the level whose size it takes,
# the level it writes) of one stack, in order
CELLS = (("gp64_4", "gp", "p6", "p4", "p4", "p4_1"),
         ("sum44", "sum", "p4_1", "p4", "p4", "p4_2"),
         ("sum43", "sum", "p4_2", "p3", "p3", "p3"),
         ("sum34", "sum", "p3", "p4_2", "p4", "p4"),
         ("gp43", "gp", "p4_2", "p3", "p5", "p5_tmp"),
         ("sum55", "sum", "p5_tmp", "p5", "p5", "p5"),
         ("gp54", "gp", "p5", "p4_2", "p7", "p7_tmp"),
         ("sum77", "sum", "p7_tmp", "p7", "p7", "p7"),
         ("gp75", "gp", "p7", "p5", "p6", "p6"))


def _resize_to(x, like):
    if x.shape[-2:] == like.shape[-2:]:
        return x
    return F.interpolate(x, size=like.shape[-2:], mode="nearest-exact")


class MergingCell(nn.Module):
    def __init__(self, channels=256, binary_op="sum"):
        super().__init__()
        if binary_op not in ("sum", "gp"):
            raise ValueError(f"binary_op {binary_op!r}: 'sum' or 'gp'")
        self.binary_op = binary_op
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, a, b, out_like):
        a = _resize_to(a, out_like)
        b = _resize_to(b, out_like)
        if self.binary_op == "gp":
            x = a + b * torch.sigmoid(a.mean((-2, -1), keepdim=True))
        else:
            x = a + b
        return self.conv(F.relu(x))


class NASFPN(nn.Module):
    def __init__(self, in_channels=(256, 512, 1024, 2048), out_channels=256,
                 num_outs=5, stack_times=7, start_level=0):
        super().__init__()
        if num_outs != 5:
            raise ValueError("NASFPN's cells wire P3..P7: num_outs 5")
        self.start_level = start_level
        self.num_outs = num_outs
        self.stack_times = stack_times
        for i, c in enumerate(in_channels[start_level:]):
            self.add_module(f"lateral{i}", nn.Conv2d(c, out_channels, 1))
        for t in range(stack_times):
            for name, op, *_ in CELLS:
                self.add_module(f"s{t}_{name}",
                                MergingCell(out_channels, op))

    def forward(self, inputs):
        """inputs: C2..C5 [B, H, W, C] -> P3..P7 [B, H, W, out]."""
        feats = [getattr(self, f"lateral{i}")(x.permute(0, 3, 1, 2))
                 for i, x in enumerate(inputs[self.start_level:])]
        while len(feats) < self.num_outs:
            feats.append(feats[-1][:, :, ::2, ::2])
        p = dict(zip(("p3", "p4", "p5", "p6", "p7"), feats))
        for t in range(self.stack_times):
            for name, _, a, b, like, out in CELLS:
                p[out] = getattr(self, f"s{t}_{name}")(p[a], p[b], p[like])
        return tuple(p[k].permute(0, 2, 3, 1)
                     for k in ("p3", "p4", "p5", "p6", "p7"))


class FPN_CARAFE(nn.Module):
    def __init__(self, in_channels=(256, 512, 1024, 2048), out_channels=256,
                 num_outs=5):
        super().__init__()
        self.num_ins = len(in_channels)
        self.num_outs = num_outs
        for i, c in enumerate(in_channels):
            self.add_module(f"lateral{i}", nn.Conv2d(c, out_channels, 1))
            self.add_module(f"fpn{i}", nn.Conv2d(out_channels, out_channels,
                                                 3, padding=1))
            if i:
                self.add_module(f"carafe{i}", CARAFEPack(out_channels))

    def forward(self, inputs):
        """inputs: C2..C5 [B, H, W, C] -> num_outs maps [B, H, W, out]."""
        laterals = [getattr(self, f"lateral{i}")(x.permute(0, 3, 1, 2))
                    for i, x in enumerate(inputs)]
        for i in range(len(laterals) - 1, 0, -1):
            up = getattr(self, f"carafe{i}")(laterals[i])
            laterals[i - 1] = laterals[i - 1] + _resize_to(up,
                                                           laterals[i - 1])
        outs = [getattr(self, f"fpn{i}")(lat)
                for i, lat in enumerate(laterals)]
        while len(outs) < self.num_outs:
            outs.append(outs[-1][:, :, ::2, ::2])
        return tuple(o.permute(0, 2, 3, 1) for o in outs)
