"""Feature Pyramid Network.

Port of `aidet_tpu/models/necks/fpn.py::FPN`: lateral 1x1 convs over
the inputs ``start_level`` to ``end_level``, nearest 2x top-down merge,
3x3 output convs, and the extra levels either by stride-2 subsampling
(a 1x1 max-pool with stride 2: the two-stage detectors) or, with
``add_extra_convs`` (RetinaNet's P6 and P7), by stride-2 3x3 convs
``extra{i}`` with symmetric padding 1: the first on the last used input
(``extra_convs_on_inputs``, C5) or on the last output, each further
one on the previous extra level, after a ReLU with
``relu_before_extra_convs``.  With ``norm_cfg`` (GroupNorm, the
reference's configs/gn) every lateral and output conv has no bias and a
norm after it (``lateral_norm{i}``, ``fpn_norm{i}``); the extra convs
keep their bias and get no norm, as in the reference.  NHWC in, NHWC
out.
"""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from ..backbones.resnet import make_norm


def _upsample_nearest(x, like):
    """Nearest-neighbour resize of NCHW x to like's spatial size, with
    half-pixel centres (`jax.image.resize(method="nearest")`)."""
    return F.interpolate(x, size=like.shape[-2:], mode="nearest-exact")


class FPN(nn.Module):
    def __init__(self, in_channels=(256, 512, 1024, 2048), out_channels=256,
                 num_outs=5, start_level=0, end_level=-1,
                 add_extra_convs=False, extra_convs_on_inputs=True,
                 relu_before_extra_convs=False, norm_cfg=None):
        super().__init__()
        self.num_ins = len(in_channels)
        self.num_outs = num_outs
        self.start_level = start_level
        self.end = self.num_ins if end_level == -1 else end_level + 1
        self.add_extra_convs = add_extra_convs
        self.extra_convs_on_inputs = extra_convs_on_inputs
        self.relu_before_extra_convs = relu_before_extra_convs
        used = in_channels[start_level:self.end]
        self.norm = norm_cfg is not None
        for i, c in enumerate(used):
            self.add_module(f"lateral{i}", nn.Conv2d(
                c, out_channels, 1, bias=not self.norm))
            self.add_module(f"fpn{i}", nn.Conv2d(
                out_channels, out_channels, 3, padding=1,
                bias=not self.norm))
            if self.norm:
                self.add_module(f"lateral_norm{i}",
                                make_norm(out_channels, norm_cfg))
                self.add_module(f"fpn_norm{i}",
                                make_norm(out_channels, norm_cfg))
        self.num_extra = max(num_outs - len(used), 0)
        if add_extra_convs:
            for i in range(self.num_extra):
                cin = (used[-1] if i == 0 and extra_convs_on_inputs
                       else out_channels)
                self.add_module(f"extra{i}", nn.Conv2d(
                    cin, out_channels, 3, stride=2, padding=1))

    def _conv(self, kind, i, x):
        """Conv ``{kind}{i}``, then its norm with a ``norm_cfg``."""
        x = getattr(self, f"{kind}{i}")(x)
        return getattr(self, f"{kind}_norm{i}")(x) if self.norm else x

    def forward(self, inputs):
        """inputs: C2..C5 [B, H, W, C] -> num_outs maps [B, H, W, C_out]."""
        used = [x.permute(0, 3, 1, 2)
                for x in inputs[self.start_level:self.end]]
        laterals = [self._conv("lateral", i, x) for i, x in enumerate(used)]
        for i in range(len(laterals) - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + _upsample_nearest(
                laterals[i], laterals[i - 1])
        outs = [self._conv("fpn", i, lat) for i, lat in enumerate(laterals)]
        for i in range(self.num_extra):
            if not self.add_extra_convs:
                outs.append(outs[-1][:, :, ::2, ::2])
                continue
            if i == 0:
                src = used[-1] if self.extra_convs_on_inputs else outs[-1]
            else:
                src = outs[-1]
                if self.relu_before_extra_convs:
                    src = F.relu(src)
            outs.append(getattr(self, f"extra{i}")(src))
        return tuple(o.permute(0, 2, 3, 1) for o in outs)


class Identity(nn.Module):
    """The C4 detectors' neck (the reference's `necks/fpn.py::Identity`
    :20): the backbone's maps as they are."""

    def forward(self, feats):
        return feats
