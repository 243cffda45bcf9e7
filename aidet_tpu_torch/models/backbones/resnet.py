"""ResNet backbone with frozen batch-norm or GroupNorm.

Port of `aidet_tpu/models/backbones/resnet.py` (FrozenBN, `make_norm`,
BasicBlock, Bottleneck, ResNet): pytorch-style bottlenecks (stride on
the 3x3) or caffe-style ones (stride on the first 1x1), stage strides
(1, 2, 2, 2), symmetric padding (k - 1) // 2 as in its `conv`, the
optional space-to-depth stem, `frozen_stages`, FrozenBN or, with
``norm_cfg=dict(type="GN", num_groups=N)``, GroupNorm (epsilon 1e-5,
its own weight and bias) in every norm slot, the deformable 3x3
(``dcn``, `ops.deform_conv.DeformConv2d`) as the bottlenecks' conv2 in
the stages ``stage_with_dcn`` names (reference resnet.py:114-145), and
the plug-ins of `models.plugins`: with ``conv_cfg=dict(type="ConvWS")``
every conv is weight-standardised (the 7x7 stem, the blocks' convs and
their downsample convs; not the space-to-depth stem nor a deformable
conv2), with ``gcb`` a ContextBlock after each bottleneck's bn3, before
the residual add, in the stages ``stage_with_gcb`` names
(resnet.py:151-154), and with ``gen_attention`` a GeneralizedAttention
after every block of the stages ``gen_attention_stages`` names
(resnet.py:299-305).  Submodule names follow
the reference's parameter tree (`stem_conv`, `layer1_block0.conv1`,
...), so `aidet_tpu_torch.convert` maps weights one to one.

The public layout is NHWC: `ResNet.forward` takes [B, H, W, C] and
returns the C2..C5 maps as [B, H_l, W_l, C_l].  Inside, the maps are
NCHW views of NHWC memory (PyTorch's channels_last), so no copy is made
at either end.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.deform_conv import DeformConv2d
from ..plugins import ContextBlock, ConvWS, GeneralizedAttention


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


class GroupNorm(nn.GroupNorm):
    """GroupNorm computed in float32 and returned in the input's dtype
    (flax's `nn.GroupNorm` computes its statistics in float32)."""

    def forward(self, x):
        return F.group_norm(x.float(), self.num_groups, self.weight.float(),
                            self.bias.float(), self.eps).to(x.dtype)


def make_norm(channels: int, norm_cfg=None):
    """FrozenBN, or GroupNorm for ``norm_cfg=dict(type="GN",
    num_groups=N)`` (N defaults to 32, as in the reference)."""
    if norm_cfg and norm_cfg.get("type") == "GN":
        return GroupNorm(norm_cfg.get("num_groups", 32), channels, eps=1e-5)
    return FrozenBN(channels)


def conv(cin, cout, kernel, stride=1, conv_cfg=None):
    """A bias-free conv with padding (kernel - 1) // 2: `ConvWS` for
    ``conv_cfg=dict(type="ConvWS")``, else a plain one."""
    if conv_cfg is not None and conv_cfg.get("type") != "ConvWS":
        raise ValueError(f"conv_cfg {conv_cfg!r}: None or type 'ConvWS'")
    cls = nn.Conv2d if conv_cfg is None else ConvWS
    return cls(cin, cout, kernel, stride, padding=(kernel - 1) // 2,
               bias=False)


class BasicBlock(nn.Module):
    """``style``, ``dcn`` and ``gcb`` are taken for a uniform signature:
    a BasicBlock has no 1x1 to stride, and `ResNet` gives it no dcn or
    context block (the reference's BasicBlock has neither)."""
    expansion = 1

    def __init__(self, cin, planes, stride=1, downsample=False,
                 norm_cfg=None, style="pytorch", dcn=None, conv_cfg=None,
                 gcb=None):
        super().__init__()
        self.conv1 = conv(cin, planes, 3, stride, conv_cfg)
        self.bn1 = make_norm(planes, norm_cfg)
        self.conv2 = conv(planes, planes, 3, conv_cfg=conv_cfg)
        self.bn2 = make_norm(planes, norm_cfg)
        if downsample:
            self.ds_conv = conv(cin, planes, 1, stride, conv_cfg)
            self.ds_bn = make_norm(planes, norm_cfg)
        self.downsample = downsample

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = self.ds_bn(self.ds_conv(x)) if self.downsample else x
        return F.relu(out + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin, planes, stride=1, downsample=False,
                 norm_cfg=None, style="pytorch", dcn=None, conv_cfg=None,
                 gcb=None):
        super().__init__()
        # 'caffe' strides the first 1x1, 'pytorch' the 3x3
        s1, s2 = (stride, 1) if style == "caffe" else (1, stride)
        self.conv1 = conv(cin, planes, 1, s1, conv_cfg)
        self.bn1 = make_norm(planes, norm_cfg)
        self.conv2 = (conv(planes, planes, 3, s2, conv_cfg) if dcn is None
                      else DeformConv2d(planes, planes, 3, s2, 1, **dcn))
        self.bn2 = make_norm(planes, norm_cfg)
        self.conv3 = conv(planes, planes * 4, 1, conv_cfg=conv_cfg)
        self.bn3 = make_norm(planes * 4, norm_cfg)
        if gcb is not None:
            self.context_block = ContextBlock(planes * 4, **gcb)
        if downsample:
            self.ds_conv = conv(cin, planes * 4, 1, stride, conv_cfg)
            self.ds_bn = make_norm(planes * 4, norm_cfg)
        self.downsample = downsample

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if hasattr(self, "context_block"):
            out = self.context_block(out)
        identity = self.ds_bn(self.ds_conv(x)) if self.downsample else x
        return F.relu(out + identity)


# the depths the flagship's two configurations and the CenterMap-Net
# TGRS configs use
ARCH_SETTINGS = {
    18: (BasicBlock, (2, 2, 2, 2)),
    50: (Bottleneck, (3, 4, 6, 3)),
    101: (Bottleneck, (3, 4, 23, 3)),
}
BASE_CHANNELS = 64


class ResNet(nn.Module):
    """Multi-stage ResNet returning C2..C5 (strides 4, 8, 16, 32), or
    the maps of ``out_indices``.

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

    norm_cfg: None (FrozenBN) or dict(type="GN", num_groups=N), in the
    stem and every block; style: "pytorch" or "caffe" (the
    bottlenecks' stride on the first 1x1).

    num_stages: the first stages built (3 for the C4 detectors, whose
    res5 is the shared RoI head); out_indices: the stages whose maps
    are returned (0 -> C2 ... 3 -> C5).

    dcn: None, or dict(modulated=...) (the `DeformConv2d` keywords) for
    the 3x3 of every bottleneck of each stage whose ``stage_with_dcn``
    entry is true; BasicBlocks take none (a ValueError, as the
    reference's).

    conv_cfg: None or dict(type="ConvWS"); gcb: None or the
    `ContextBlock` keywords (``ratio``, ``pooling_type``) for the
    bottlenecks of each stage ``stage_with_gcb`` flags (a BasicBlock
    takes none, as the reference's); gen_attention: None or the
    `GeneralizedAttention` keywords but ``in_dim``, for a
    ``layer{i}_block{b}_gen_attention`` after every block of each
    stage ``gen_attention_stages`` flags.
    """

    def __init__(self, depth=50, stem_space_to_depth=False,
                 frozen_stages=1, norm_cfg=None, style="pytorch",
                 num_stages=4, out_indices=(0, 1, 2, 3), dcn=None,
                 stage_with_dcn=(False, False, False, False), conv_cfg=None,
                 gcb=None, stage_with_gcb=(False, False, False, False),
                 gen_attention=None,
                 gen_attention_stages=(False, False, False, False)):
        super().__init__()
        block_cls, stage_blocks = ARCH_SETTINGS[depth]
        if dcn is not None and block_cls is not Bottleneck:
            raise ValueError(f"dcn needs bottleneck blocks (depth >= 50), "
                             f"not depth {depth}, as in the reference")
        stage_blocks = stage_blocks[:num_stages]
        self.stem_space_to_depth = stem_space_to_depth
        self.frozen_stages = frozen_stages
        self.out_indices = tuple(out_indices)
        if stem_space_to_depth:
            self.stem_conv = nn.Conv2d(12, BASE_CHANNELS, 4, bias=False)
        else:
            self.stem_conv = conv(3, BASE_CHANNELS, 7, 2, conv_cfg)
        self.stem_bn = make_norm(BASE_CHANNELS, norm_cfg)
        bottleneck = block_cls is Bottleneck
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
                self.add_module(name, block_cls(
                    cur, planes, stride, ds, norm_cfg, style,
                    dcn if stage_with_dcn[i] else None, conv_cfg,
                    gcb if bottleneck and stage_with_gcb[i] else None))
                names.append(name)
                cur = out_c
                if gen_attention is not None and gen_attention_stages[i]:
                    self.add_module(f"{name}_gen_attention",
                                    GeneralizedAttention(out_c,
                                                         **gen_attention))
                    names.append(f"{name}_gen_attention")
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
            if i in self.out_indices:
                outs.append(x.permute(0, 2, 3, 1))
        return tuple(outs)
