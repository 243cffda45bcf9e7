"""Shared RoI heads: the res5 stage over RoI crops (the C4 detectors).

Port of `aidet_tpu/models/shared_heads.py::ResLayer` (parity: mmdet's
shared_heads/res_layer.py): the ResNet stage ``stage`` (res5 for
stage 3) of ``depth``, its first block strided by ``stride`` with a
projection shortcut, pytorch or caffe style.  Its blocks are named
``layer{stage + 1}_block{b}``, as the reference's parameter tree, so
`aidet_tpu_torch.convert` maps the weights one to one.  NHWC in and
out: crops [N, s, s, C] -> [N, s / stride, s / stride, C'].
"""

from __future__ import annotations

from torch import nn

from .backbones.resnet import ARCH_SETTINGS, BASE_CHANNELS


class ResLayer(nn.Module):
    def __init__(self, depth=50, stage=3, stride=2, style="pytorch",
                 norm_cfg=None):
        super().__init__()
        block_cls, stage_blocks = ARCH_SETTINGS[depth]
        self.stride = stride
        planes = BASE_CHANNELS * 2 ** stage
        cin = BASE_CHANNELS * 2 ** (stage - 1) * block_cls.expansion
        self.names = []
        for b in range(stage_blocks[stage]):
            name = f"layer{stage + 1}_block{b}"
            self.add_module(name, block_cls(
                cin, planes, stride if b == 0 else 1, b == 0, norm_cfg,
                style))
            self.names.append(name)
            cin = planes * block_cls.expansion
        self.out_channels = cin

    def forward(self, x):
        """x: [N, s, s, C] -> [N, s / stride, s / stride, C']."""
        x = x.permute(0, 3, 1, 2)
        for name in self.names:
            x = getattr(self, name)(x)
        return x.permute(0, 2, 3, 1)
