"""The flagship model: RBBoxRCNN, a theta-OBB Faster R-CNN.

`build_flagship` mirrors `_build_flagship` of the reference's
`__graft_entry__.py`, with its two configurations:

- full (``small=False``): ResNet-50 with the space-to-depth stem, a
  5-level FPN at 256 channels, RPN, SharedFC and thetaobb RBBox heads
  at 1024 FC channels, 16 classes, in bfloat16, with test_cfg
  nms_pre 2000 / nms_post 1000 / max_num 1000 and 100 detections per
  image;
- small (``small=True``): ResNet-18, 64 channels, 128-wide FCs and
  caps 128 / 64 / 64 / 16, in float32, for the CPU tests.

Both carry the reference's train_cfg: `DEFAULT_TRAIN_CFG` for the full
model (the flagship train step of `bench.py`), rpn_proposal
128 / 64 / 64 and 16 RoI samples for the small one.

``train=False`` builds the predict model: every parameter in the
compute dtype.  ``train=True`` builds the trainer's model, with the
reference's mixed precision: flax keeps parameters in float32 and
computes in the modules' dtype, so here the parameters stay float32
and `TwoStageDetector.loss` computes convolutions and FCs in
``compute_dtype`` (bfloat16 for the full model) under autocast.

Weights are random, drawn from a seeded `torch.Generator` (or loaded
later from converted reference weights, see `aidet_tpu_torch.convert`).
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from .core.rboxes import thetaobb2hobb, thetaobb2pointobb
from .models.backbones.resnet import ResNet
from .models.detectors.two_stage import TwoStageDetector, _merge
from .models.heads.bbox_head import RBBoxHead, SharedFCBBoxHead
from .models.heads.rpn_head import RPNHead
from .models.necks.fpn import FPN


def init_weights(model: nn.Module, generator: torch.Generator):
    """Conv, transposed-conv and linear weights ~ N(0, 1 / fan_in) (a
    LeCun-normal draw, as the reference's default initializer; a
    transposed conv's [in, out, kh, kw] weight has fan_in in * kh * kw,
    as flax counts it), biases 0, then each module's ``init_prior``
    (RetinaHead's classification prior, the zero kernels of the
    reference's plug-ins) and ``init_seeded(generator)`` (the parameters
    a module draws itself: GeneralizedAttention's biases); frozen-BN
    statistics stay the identity."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
                fan_in = m.weight[0].numel()
                if isinstance(m, nn.ConvTranspose2d):
                    fan_in = m.weight[:, 0].numel()
                w = torch.randn(m.weight.shape, generator=generator)
                m.weight.copy_(w / math.sqrt(fan_in))
                if m.bias is not None:
                    m.bias.zero_()
        for m in model.modules():
            if hasattr(m, "init_prior"):
                m.init_prior()
            if hasattr(m, "init_seeded"):
                m.init_seeded(generator)
    return model


def build_flagship(img_size: int, small: bool = False, device="cuda",
                   dtype=None, seed: int = 0, train: bool = False,
                   train_cfg=None) -> TwoStageDetector:
    """The flagship detector on ``device``, computing in ``dtype``
    (default: bfloat16 for the full model, float32 for the small one),
    with random weights from ``torch.Generator().manual_seed(seed)``.
    Parameters are in ``dtype`` too, unless ``train``: then they stay
    float32.  ``train_cfg`` overrides the flagship's train_cfg."""
    parts = build_parts(small, encode="thetaobb")
    if small:
        test_cfg = dict(rpn=dict(nms_pre=128, nms_post=64, max_num=64),
                        rcnn=dict(max_per_img=16))
        flagship_train_cfg = dict(
            rpn_proposal=dict(nms_pre=128, nms_post=64, max_num=64),
            rcnn=dict(num_samples=16))
    else:
        test_cfg = dict(rpn=dict(nms_pre=2000, nms_post=1000,
                                 max_num=1000),
                        rcnn=dict(max_per_img=100))
        flagship_train_cfg = None
    model = TwoStageDetector(
        *parts, img_size=img_size,
        train_cfg=_merge(flagship_train_cfg or {}, train_cfg),
        test_cfg=test_cfg, compute_dtype=default_dtype(small, dtype))
    return finish(model, small, device, dtype, seed, train)


def build_parts(small: bool, encode: str):
    """(backbone, neck, rpn_head, bbox_head, rbbox_head) of the full
    configuration (ResNet-50 with the space-to-depth stem, 256-channel
    FPN, 1024-wide heads, 16 classes) or of the small one (ResNet-18,
    64 channels, 128-wide heads), with an ``encode`` rbbox head."""
    if small:
        return (ResNet(depth=18),
                FPN(in_channels=(64, 128, 256, 512), out_channels=64,
                    num_outs=5),
                RPNHead(in_channels=64, feat_channels=64, num_anchors=3),
                SharedFCBBoxHead(num_classes=16, in_channels=64,
                                 fc_out_channels=128),
                RBBoxHead(num_classes=16, in_channels=64,
                          fc_out_channels=128, encode=encode))
    return (ResNet(depth=50, stem_space_to_depth=True), FPN(num_outs=5),
            RPNHead(num_anchors=3), SharedFCBBoxHead(num_classes=16),
            RBBoxHead(num_classes=16, encode=encode))


def default_dtype(small: bool, dtype=None):
    """bfloat16 for the full model, float32 for the small one."""
    return dtype or (torch.float32 if small else torch.bfloat16)


def finish(model: TwoStageDetector, small: bool, device, dtype, seed: int,
           train: bool = False) -> TwoStageDetector:
    """Seeded weights, then ``model`` on ``device`` in its dtype (float32
    parameters if ``train``), in eval mode, channels-last on the card."""
    init_weights(model, torch.Generator().manual_seed(seed))
    dtype = default_dtype(small, dtype)
    model = model.to(device=device,
                     dtype=torch.float32 if train else dtype).eval()
    if torch.device(device).type == "cuda":
        # NHWC convolutions: the permuted views the modules pass around
        # are then contiguous and cuDNN runs its channels-last kernels
        model = model.to(memory_format=torch.channels_last)
    return model


def keep_every_candidate_cfg(img_size: int, num_gts: int,
                             max_num: int) -> dict:
    """A train_cfg under which both samplers keep every candidate: the
    RPN samples up to 2x the anchor count at pos_fraction 0.5, and the
    RoI sampler takes all num_gts + max_num candidates (gts and
    proposals) at pos_fraction 1.0.  The samples are then the same sets
    in the same order whatever the random stream, so two runs (two
    devices, or this port and the reference) can be compared step for
    step.  ``max_num`` is the train_cfg's rpn_proposal max_num."""
    anchors = 3 * sum((img_size // s) ** 2
                      for s in TwoStageDetector.strides)
    return dict(rpn=dict(num_samples=2 * anchors, pos_fraction=0.5),
                rcnn=dict(num_samples=num_gts + max_num,
                          pos_fraction=1.0))


def synthetic_train_batch(batch, img, max_gt, seed, device,
                          encode="thetaobb"):
    """A seeded batch of `TwoStageDetector.loss`'s inputs like the
    reference bench's (bench.py measure_train): normalized float images
    and ``max_gt`` valid gts per image, boxes of 1/64 to 5/32 of the
    image with matching rotated boxes in the rbbox head's ``encode``
    (thetaobbs, their corners for "pointobb", their first edges and
    heights for "hobb"), labels 1..15."""
    rs = np.random.RandomState(seed)
    xy = rs.uniform(img / 32, img * 0.8, (batch, max_gt, 2))
    wh = rs.uniform(img / 64, img * 5 / 32, (batch, max_gt, 2))
    theta = rs.uniform(-1.5, -0.01, (batch, max_gt, 1))
    arrays = dict(
        imgs=rs.randn(batch, img, img, 3),
        gt_boxes=np.concatenate([xy, xy + wh], -1),
        gt_rboxes=np.concatenate([xy + wh / 2, wh, theta], -1),
        gt_valid=np.ones((batch, max_gt), bool),
        gt_labels=rs.randint(1, 16, (batch, max_gt)),
        img_shapes=np.full((batch, 2), float(img)))
    out = {}
    for k, v in arrays.items():
        t = torch.from_numpy(v)
        out[k] = (t.float() if t.is_floating_point() else t).to(device)
    if encode == "pointobb":
        out["gt_rboxes"] = thetaobb2pointobb(out["gt_rboxes"])
    elif encode == "hobb":
        out["gt_rboxes"] = thetaobb2hobb(out["gt_rboxes"])
    elif encode != "thetaobb":
        raise ValueError(f"encode {encode!r}: thetaobb, pointobb or hobb")
    return out
