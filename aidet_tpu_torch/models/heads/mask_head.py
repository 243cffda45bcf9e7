"""Mask heads: the FCN mask head, the CenterMap head and HTC's.

Port of `aidet_tpu/models/heads/mask_head.py` (`FCNMaskHead` :20-50,
`CenterMapHead` :53-76, `HTCMaskHead` :78-123): ``num_convs`` 3x3 convs with
ReLU, a 2x2 stride-2 transposed conv with ReLU (the reference's
``upsample_ratio`` 2, the only one its configs use), then 1x1 logits, one map
per foreground class (``num_classes - 1``).  The FCN head's logits go through a
sigmoid at test time, the CenterMap head's raw maps are the soft centerness
itself (centermap_head.py:34-47).  NHWC in and out: crops [N, s, s, C] ->
maps [N, 2s, 2s, classes].  Submodule names follow the reference's
parameter tree (conv0.., upsample, conv_logits), so
`aidet_tpu_torch.convert` maps the weights one to one; a flax
ConvTranspose kernel is flipped in space there.  The FCN head's GN
``norm_cfg`` and class-agnostic logits are not ported.
"""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn


class FCNMaskHead(nn.Module):
    def __init__(self, num_convs=4, in_channels=256, conv_out_channels=256,
                 num_classes=81):
        super().__init__()
        self.num_convs = num_convs
        cin = in_channels
        for i in range(num_convs):
            self.add_module(f"conv{i}", nn.Conv2d(cin, conv_out_channels, 3,
                                                  padding=1))
            cin = conv_out_channels
        self.upsample = nn.ConvTranspose2d(cin, conv_out_channels, 2,
                                           stride=2)
        self.conv_logits = nn.Conv2d(conv_out_channels, num_classes - 1, 1)

    def forward(self, x):
        """x: [N, s, s, C] -> [N, 2s, 2s, classes - 1]."""
        x = x.permute(0, 3, 1, 2)
        for i in range(self.num_convs):
            x = F.relu(getattr(self, f"conv{i}")(x))
        x = F.relu(self.upsample(x))
        return self.conv_logits(x).permute(0, 2, 3, 1)


class CenterMapHead(FCNMaskHead):
    """The CenterMap regression head: `FCNMaskHead`'s topology, raw
    maps per foreground class (16 classes -> 15 maps)."""

    def __init__(self, num_convs=4, in_channels=256, conv_out_channels=256,
                 num_classes=16):
        super().__init__(num_convs, in_channels, conv_out_channels,
                         num_classes)


class HTCMaskHead(FCNMaskHead):
    """HTC's mask head with mask information flow (the reference's
    htc_mask_head.py): `FCNMaskHead`'s layers, and with
    ``with_conv_res`` a 1x1 ``conv_res`` through which the previous
    stage's trunk feature, after a ReLU, is added to the input.  The
    reference creates ``conv_res`` where a head is first called with a
    feature (every stage but the first under info flow); the port
    builds it where ``with_conv_res`` says."""

    def __init__(self, num_convs=4, in_channels=256, conv_out_channels=256,
                 num_classes=81, with_conv_res=True):
        super().__init__(num_convs, in_channels, conv_out_channels,
                         num_classes)
        if with_conv_res:
            self.conv_res = nn.Conv2d(conv_out_channels, conv_out_channels, 1)

    def forward(self, x, res_feat=None, return_logits=True,
                return_feat=True):
        """x: [N, s, s, C]; res_feat: None or the previous stage's trunk
        feature [N, s, s, C'].  Returns the logits [N, 2s, 2s, classes -
        1] and/or this stage's trunk feature [N, s, s, C'] (before the
        upsample), a tuple when both."""
        x = x.permute(0, 3, 1, 2)
        if res_feat is not None:
            x = x + F.relu(self.conv_res(res_feat.permute(0, 3, 1, 2)))
        for i in range(self.num_convs):
            x = F.relu(getattr(self, f"conv{i}")(x))
        outs = []
        if return_logits:
            y = F.relu(self.upsample(x))
            outs.append(self.conv_logits(y).permute(0, 2, 3, 1))
        if return_feat:
            outs.append(x.permute(0, 2, 3, 1))
        return tuple(outs) if len(outs) > 1 else outs[0]
