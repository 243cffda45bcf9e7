"""Builders (parity: mmdet/models/builder.py:18-43): torch modules from
the configs' ``dict(type=..., ...)`` entries.

Port of `aidet_tpu/models/builder.py`.  The registries hold the port's
modules under the reference's type names, each behind a factory that
reads the reference's keyword names: the backbones `ResNet` (FrozenBN
or GroupNorm, pytorch or caffe style, the C4 detectors' 3 stages, the
deformable ``dcn`` stages, the plug-ins ``conv_cfg`` (ConvWS), ``gcb``
and ``gen_attention``), `ResNeXt`, `HRNet` and `SSDVGG`, the necks
`FPN` (optionally with GroupNorm), `HRFPN`, `BFP`, `NASFPN`,
`FPN_CARAFE` and `Identity` (a config's list of necks runs them in
order), the shared
head `ResLayer`, the heads `RPNHead`, `GARPNHead`, `BBoxHead`,
`SharedFCBBoxHead` (and `ConvFCBBoxHead`), `DoubleConvFCBBoxHead`,
`RBBoxHead`, `MaskIoUHead`, `GridHead`, the mask and semantic heads,
the dense heads (`RetinaHead`, `RetinaSepBNHead`, `FCOSHead`,
`ATSSHead`, `FoveaHead`, `RepPointsHead`, `GARetinaHead`, `SSDHead`),
and the detectors (`RPN`, the two-stage presets from `FasterRCNN` to
`CenterMapNet`, `MaskScoringRCNN`, `GAFasterRCNN`, `GridRCNN`,
`DoubleHeadRCNN`, `CascadeRCNN`, `HTC`, the single-stage ones with
`FreeAnchorRetinaNet`, `FCOS`, `ATSS`, `FOVEA`, `RepPointsDetector`,
`GARetinaNet` and `SSD`).  The reference's own build failures stay
failures: ResNeXt takes no ``dcn``, ``norm_cfg`` or ``conv_cfg`` (a
TypeError), and SSD at an
``input_size`` whose maps are not SSD300's raises a ValueError.  An
option the port does not implement raises `NotImplementedError` unless
it holds the reference's default; a type that is not registered raises
`KeyError`.

`build_detector` returns the predict model with seeded random weights
(`aidet_tpu_torch.flagship.init_weights`) on ``device``, every
parameter in the config's dtype: the detector's ``dtype``, else its
sub-modules' (they must agree), else float32 (the reference's
default); with ``train=True`` the trainer's model, whose parameters
stay float32 while its loss computes in that dtype.  Its weights may
then be replaced by a state_dict
(`aidet_tpu_torch.convert.flax_to_state_dict` of the reference's
variables, or a saved port model).
"""

from __future__ import annotations

import torch
from torch import nn

from ..flagship import finish
from ..utils.registry import build_from_cfg
from .backbones.hrnet import HRNet
from .backbones.resnet import ARCH_SETTINGS, ResNet
from .backbones.resnext import ResNeXt
from .detectors.cascade import CascadeRCNN
from .detectors.rpn import RPN
from .detectors.single_stage import SingleStageDetector
from .detectors.two_stage import TwoStageDetector
from .backbones.ssd_vgg import SSDVGG
from .heads.atss_head import ATSS, ATSSHead
from .heads.bbox_head import (BBoxHead, DoubleConvFCBBoxHead, MaskIoUHead,
                              RBBoxHead, SharedFCBBoxHead)
from .heads.fcos_head import FCOS, FCOSHead
from .heads.fovea_head import FOVEA, FoveaHead
from .heads.grid_head import GridHead
from .heads.guided_anchor_head import GARetinaHead, GARetinaNet, GARPNHead
from .heads.mask_head import CenterMapHead, FCNMaskHead, HTCMaskHead
from .heads.reppoints_head import RepPointsDetector, RepPointsHead
from .heads.retina_head import RetinaHead, RetinaSepBNHead
from .heads.rpn_head import RPNHead
from .heads.semantic_head import FusedSemanticHead, WPSGAHead
from .heads.ssd_head import SSD, SSDHead
from .losses import (GHMC, GHMR, BalancedL1Loss, BoundedIoULoss, FocalLoss,
                     GIoULoss, IoULoss, SmoothL1Loss)
from .necks.bfp import BFP
from .necks.fpn import FPN, Identity
from .necks.hrfpn import HRFPN
from .necks.nas_fpn import FPN_CARAFE, NASFPN
from .registry import BACKBONES, DETECTORS, HEADS, NECKS, SHARED_HEADS
from .shared_heads import ResLayer

NOT_PORTED = "not yet ported to aidet_tpu_torch"
NO_STAGES = (False, False, False, False)


def _same(a, b):
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(map(_same, a, b))
    return a == b


def _only_defaults(type_name: str, options: dict, defaults: dict):
    """Raise unless every option in ``options`` is one of ``defaults``
    at its value there (the reference's default, which the port
    implements)."""
    for k, v in options.items():
        if k not in defaults:
            raise NotImplementedError(f"{type_name} option {k!r} is "
                                      f"{NOT_PORTED}")
        if not _same(v, defaults[k]):
            raise NotImplementedError(
                f"{type_name} {k}={v!r} is {NOT_PORTED}; it builds "
                f"{k}={defaults[k]!r}")


def torch_dtype(value):
    """A config's dtype as a torch dtype: a torch dtype, its name, or a
    scalar type with that ``__name__`` (the reference configs'
    ``jnp.bfloat16``); None stays None."""
    if value is None or isinstance(value, torch.dtype):
        return value
    name = value if isinstance(value, str) else getattr(value, "__name__",
                                                        str(value))
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"dtype {value!r} is not a torch dtype")
    return dtype


def _norm_cfg(type_name, norm_cfg):
    """A norm_cfg the port builds: None (FrozenBN) or GroupNorm."""
    if norm_cfg is not None and norm_cfg.get("type") != "GN":
        raise NotImplementedError(f"{type_name} norm_cfg {norm_cfg!r} is "
                                  f"{NOT_PORTED}; None and type 'GN' are")
    return norm_cfg


@BACKBONES.register(name="ResNet")
def _resnet(depth=50, stem_space_to_depth=False, stem_s2d_phase=False,
            frozen_stages=1, norm_cfg=None, style="pytorch", num_stages=4,
            out_indices=(0, 1, 2, 3), dcn=None, stage_with_dcn=NO_STAGES,
            conv_cfg=None, gcb=None, stage_with_gcb=NO_STAGES,
            gen_attention=None, gen_attention_stages=NO_STAGES,
            dtype=None, **options):
    # stem_s2d_phase is the same function over the same weight, relaid
    # for the TPU's matrix unit; the port has one s2d stem
    if depth not in ARCH_SETTINGS:
        raise NotImplementedError(f"ResNet depth {depth} is {NOT_PORTED}; "
                                  f"{sorted(ARCH_SETTINGS)} are")
    if style not in ("pytorch", "caffe"):
        raise ValueError(f"ResNet style {style!r}: 'pytorch' or 'caffe'")
    _only_defaults("ResNet", options, dict(
        strides=(1, 2, 2, 2), dilations=(1, 1, 1, 1),
        base_channels=64, norm_eval=True, pretrained=None))
    return ResNet(depth=depth, stem_space_to_depth=stem_space_to_depth,
                  frozen_stages=frozen_stages,
                  norm_cfg=_norm_cfg("ResNet", norm_cfg), style=style,
                  num_stages=num_stages, out_indices=tuple(out_indices),
                  dcn=dcn, stage_with_dcn=tuple(stage_with_dcn),
                  conv_cfg=conv_cfg, gcb=gcb,
                  stage_with_gcb=tuple(stage_with_gcb),
                  gen_attention=gen_attention,
                  gen_attention_stages=tuple(gen_attention_stages))


@BACKBONES.register(name="HRNet")
def _hrnet(width=32, stage_modules=(1, 1, 4, 3), stage_blocks=4,
           norm_eval=True, pretrained=None, dtype=None, **options):
    # norm_eval and pretrained are fields the reference's forward does
    # not read: its norms are FrozenBN, and weights come from a
    # checkpoint
    _only_defaults("HRNet", options, {})
    return HRNet(width=width, stage_modules=tuple(stage_modules),
                 stage_blocks=stage_blocks)


# the ResNet fields the reference's ResNeXt lacks, with what they build
RESNEXT_LACKS = dict(conv_cfg="weight-standardised convs",
                     dcn="deformable stages",
                     norm_cfg="norm other than FrozenBN",
                     stage_with_dcn="deformable stages")


@BACKBONES.register(name="ResNeXt")
def _resnext(depth=101, groups=32, base_width=4, frozen_stages=1,
             style="pytorch", dtype=None, **options):
    for key in sorted(options):
        if key in RESNEXT_LACKS:
            # a field the reference's ResNeXt does not have: it raises
            # the same TypeError when it builds
            raise TypeError(f"ResNeXt got an unexpected keyword argument "
                            f"{key!r} (the reference's ResNeXt has no "
                            f"{RESNEXT_LACKS[key]})")
    if depth not in (50, 101):
        raise NotImplementedError(f"ResNeXt depth {depth} is {NOT_PORTED}; "
                                  "50 and 101 are")
    if style not in ("pytorch", "caffe"):
        raise ValueError(f"ResNeXt style {style!r}: 'pytorch' or 'caffe'")
    _only_defaults("ResNeXt", options, dict(
        num_stages=4, strides=(1, 2, 2, 2), dilations=(1, 1, 1, 1),
        out_indices=(0, 1, 2, 3), base_channels=64, norm_eval=True,
        pretrained=None))
    return ResNeXt(depth=depth, groups=groups, base_width=base_width,
                   frozen_stages=frozen_stages, style=style)


@NECKS.register(name="FPN")
def _fpn(in_channels=(256, 512, 1024, 2048), out_channels=256, num_outs=5,
         start_level=0, end_level=-1, add_extra_convs=False,
         extra_convs_on_inputs=True, relu_before_extra_convs=False,
         norm_cfg=None, dtype=None, **options):
    _only_defaults("FPN", options, {})
    return FPN(in_channels=tuple(in_channels), out_channels=out_channels,
               num_outs=num_outs, start_level=start_level,
               end_level=end_level, add_extra_convs=add_extra_convs,
               extra_convs_on_inputs=extra_convs_on_inputs,
               relu_before_extra_convs=relu_before_extra_convs,
               norm_cfg=_norm_cfg("FPN", norm_cfg))


@NECKS.register(name="NASFPN")
def _nas_fpn(in_channels=(256, 512, 1024, 2048), out_channels=256,
             num_outs=5, stack_times=7, start_level=0, dtype=None,
             **options):
    _only_defaults("NASFPN", options, {})
    return NASFPN(in_channels=tuple(in_channels), out_channels=out_channels,
                  num_outs=num_outs, stack_times=stack_times,
                  start_level=start_level)


@BACKBONES.register(name="SSDVGG")
def _ssd_vgg(input_size=300, dtype=None, **options):
    # depth and out_feature_indices are fields the reference's SSDVGG
    # does not read: it builds VGG-16 and its two taps
    _only_defaults("SSDVGG", options, dict(depth=16,
                                           out_feature_indices=(22, 34),
                                           pretrained=None))
    return SSDVGG(input_size=input_size)


@NECKS.register(name="Identity")
def _identity(dtype=None, **options):
    _only_defaults("Identity", options, {})
    return Identity()


@NECKS.register(name="BFP")
def _bfp(in_channels=256, num_levels=5, refine_level=2, refine_type="conv",
         dtype=None, **options):
    _only_defaults("BFP", options, {})
    return BFP(in_channels=in_channels, num_levels=num_levels,
               refine_level=refine_level, refine_type=refine_type)


@NECKS.register(name="FPN_CARAFE")
def _fpn_carafe(in_channels=(256, 512, 1024, 2048), out_channels=256,
                num_outs=5, dtype=None, **options):
    _only_defaults("FPN_CARAFE", options, {})
    return FPN_CARAFE(in_channels=tuple(in_channels),
                      out_channels=out_channels, num_outs=num_outs)


@SHARED_HEADS.register(name="ResLayer")
def _res_layer(depth=50, stage=3, stride=2, style="pytorch", norm_cfg=None,
               dtype=None, **options):
    _only_defaults("ResLayer", options, {})
    if depth not in ARCH_SETTINGS:
        raise NotImplementedError(f"ResLayer depth {depth} is {NOT_PORTED}; "
                                  f"{sorted(ARCH_SETTINGS)} are")
    return ResLayer(depth=depth, stage=stage, stride=stride, style=style,
                    norm_cfg=_norm_cfg("ResLayer", norm_cfg))


@NECKS.register(name="HRFPN")
def _hrfpn(in_channels=(32, 64, 128, 256), out_channels=256, num_outs=5,
           dtype=None, **options):
    _only_defaults("HRFPN", options, {})
    return HRFPN(in_channels=tuple(in_channels), out_channels=out_channels,
                 num_outs=num_outs)


@HEADS.register(name="RPNHead")
def _rpn_head(in_channels=256, feat_channels=256, num_anchors=3,
              dtype=None, **options):
    _only_defaults("RPNHead", options, dict(use_sigmoid_cls=True))
    return RPNHead(in_channels=in_channels, feat_channels=feat_channels,
                   num_anchors=num_anchors)


@HEADS.register(name="GARPNHead")
def _ga_rpn_head(in_channels=256, feat_channels=256, prior_prob=0.01,
                 loc_filter_thr=0.01, dtype=None, **options):
    _only_defaults("GARPNHead", options, {})
    return GARPNHead(in_channels=in_channels, feat_channels=feat_channels,
                     prior_prob=prior_prob, loc_filter_thr=loc_filter_thr)


@HEADS.register(name="BBoxHead")
def _bbox_head(num_classes=81, in_channels=256, roi_feat_size=7,
               with_avg_pool=False, reg_class_agnostic=False, dtype=None,
               **options):
    _only_defaults("BBoxHead", options, {})
    return BBoxHead(num_classes=num_classes, in_channels=in_channels,
                    roi_feat_size=roi_feat_size, with_avg_pool=with_avg_pool,
                    reg_class_agnostic=reg_class_agnostic)


@HEADS.register(name="DoubleConvFCBBoxHead")
def _double_bbox_head(num_classes=81, in_channels=256, num_convs=4,
                      num_fcs=2, conv_out_channels=1024,
                      fc_out_channels=1024, roi_feat_size=7,
                      reg_class_agnostic=False, dtype=None, **options):
    _only_defaults("DoubleConvFCBBoxHead", options, {})
    return DoubleConvFCBBoxHead(
        num_classes=num_classes, in_channels=in_channels,
        num_convs=num_convs, num_fcs=num_fcs,
        conv_out_channels=conv_out_channels,
        fc_out_channels=fc_out_channels, roi_feat_size=roi_feat_size,
        reg_class_agnostic=reg_class_agnostic)


@HEADS.register(name="MaskIoUHead")
def _mask_iou_head(num_convs=4, num_fcs=2, in_channels=256,
                   conv_out_channels=256, fc_out_channels=1024,
                   num_classes=81, dtype=None, **options):
    _only_defaults("MaskIoUHead", options, {})
    return MaskIoUHead(num_convs=num_convs, num_fcs=num_fcs,
                       in_channels=in_channels,
                       conv_out_channels=conv_out_channels,
                       fc_out_channels=fc_out_channels,
                       num_classes=num_classes)


@HEADS.register(name="GridHead")
def _grid_head(grid_points=9, num_convs=8, in_channels=256,
               point_feat_channels=64, norm_groups=36, fusion=True,
               dtype=None, **options):
    _only_defaults("GridHead", options, {})
    return GridHead(grid_points=grid_points, num_convs=num_convs,
                    in_channels=in_channels,
                    point_feat_channels=point_feat_channels,
                    norm_groups=norm_groups, fusion=fusion)


@HEADS.register(name="ConvFCBBoxHead")
@HEADS.register(name="SharedFCBBoxHead")
def _shared_fc_bbox_head(num_classes=81, in_channels=256,
                         fc_out_channels=1024, num_fcs=2, roi_feat_size=7,
                         num_shared_convs=0, conv_out_channels=256,
                         norm_cfg=None, reg_class_agnostic=False, dtype=None,
                         **options):
    _only_defaults("SharedFCBBoxHead", options, {})
    return SharedFCBBoxHead(
        num_classes=num_classes, in_channels=in_channels,
        fc_out_channels=fc_out_channels, num_fcs=num_fcs,
        roi_feat_size=roi_feat_size, num_shared_convs=num_shared_convs,
        conv_out_channels=conv_out_channels,
        norm_cfg=_norm_cfg("SharedFCBBoxHead", norm_cfg),
        reg_class_agnostic=reg_class_agnostic)


@HEADS.register(name="RBBoxHead")
def _rbbox_head(num_classes=16, in_channels=256, fc_out_channels=1024,
                num_shared_fcs=2, roi_feat_size=7, encode="thetaobb",
                dtype=None, conv_out_channels=256, **options):
    _only_defaults("RBBoxHead", options, dict(num_shared_convs=0,
                                              reg_class_agnostic=False))
    return RBBoxHead(num_classes=num_classes, in_channels=in_channels,
                     fc_out_channels=fc_out_channels,
                     num_shared_fcs=num_shared_fcs,
                     roi_feat_size=roi_feat_size, encode=encode)


@HEADS.register(name="FCNMaskHead")
def _fcn_mask_head(num_convs=4, in_channels=256, conv_out_channels=256,
                   num_classes=81, class_agnostic=False, norm_cfg=None,
                   dtype=None, **options):
    _only_defaults("FCNMaskHead", options, dict(upsample_ratio=2))
    return FCNMaskHead(num_convs=num_convs, in_channels=in_channels,
                       conv_out_channels=conv_out_channels,
                       num_classes=num_classes,
                       class_agnostic=class_agnostic,
                       norm_cfg=_norm_cfg("FCNMaskHead", norm_cfg))


@HEADS.register(name="HTCMaskHead")
def _htc_mask_head(num_convs=4, in_channels=256, conv_out_channels=256,
                   num_classes=81, with_conv_res=True, dtype=None, **options):
    _only_defaults("HTCMaskHead", options, dict(upsample_ratio=2,
                                                class_agnostic=False))
    return HTCMaskHead(num_convs=num_convs, in_channels=in_channels,
                       conv_out_channels=conv_out_channels,
                       num_classes=num_classes, with_conv_res=with_conv_res)


@HEADS.register(name="FusedSemanticHead")
def _fused_semantic_head(num_ins=5, fusion_level=1, num_convs=4,
                         in_channels=256, conv_out_channels=256,
                         num_classes=183, dtype=None, **options):
    _only_defaults("FusedSemanticHead", options, {})
    return FusedSemanticHead(num_ins=num_ins, fusion_level=fusion_level,
                             num_convs=num_convs, in_channels=in_channels,
                             conv_out_channels=conv_out_channels,
                             num_classes=num_classes)


@HEADS.register(name="CenterMapHead")
def _centermap_head(num_convs=4, in_channels=256, conv_out_channels=256,
                    num_classes=16, dtype=None, **options):
    _only_defaults("CenterMapHead", options, dict(upsample_ratio=2))
    return CenterMapHead(num_convs=num_convs, in_channels=in_channels,
                         conv_out_channels=conv_out_channels,
                         num_classes=num_classes)


@HEADS.register(name="WPSGAHead")
def _wpsga_head(in_channels=256, channels=128, num_levels=4, num_classes=16,
                with_attention=True, loss_weight=1.0, use_focal=True,
                focal_gamma=2.0, dtype=None, **options):
    # common_stride is a field of the reference's head that its forward
    # does not read
    _only_defaults("WPSGAHead", options, dict(common_stride=8))
    return WPSGAHead(in_channels=in_channels, channels=channels,
                     num_levels=num_levels, num_classes=num_classes,
                     with_attention=with_attention, loss_weight=loss_weight,
                     use_focal=use_focal, focal_gamma=focal_gamma)


@HEADS.register(name="RetinaHead")
def _retina_head(num_classes=16, in_channels=256, feat_channels=256,
                 stacked_convs=4, num_anchors=9, prior_prob=0.01, reg_dim=4,
                 dtype=None, **options):
    _only_defaults("RetinaHead", options, {})
    return RetinaHead(num_classes=num_classes, in_channels=in_channels,
                      feat_channels=feat_channels,
                      stacked_convs=stacked_convs, num_anchors=num_anchors,
                      prior_prob=prior_prob, reg_dim=reg_dim)


@HEADS.register(name="RetinaSepBNHead")
def _retina_sepbn_head(num_classes=16, num_ins=5, in_channels=256,
                       feat_channels=256, stacked_convs=4, num_anchors=9,
                       prior_prob=0.01, with_norm=True, dtype=None,
                       **options):
    _only_defaults("RetinaSepBNHead", options, {})
    return RetinaSepBNHead(
        num_classes=num_classes, num_ins=num_ins, in_channels=in_channels,
        feat_channels=feat_channels, stacked_convs=stacked_convs,
        num_anchors=num_anchors, prior_prob=prior_prob, with_norm=with_norm)


def _towers_head(cls, type_name, defaults=None):
    """Register ``cls`` (a head over `Towers`) under ``type_name``: its
    keywords as they are, ``dtype`` dropped, any other option raising
    unless it is one of ``defaults`` at its value there."""
    import inspect
    names = set(inspect.signature(cls).parameters)

    def factory(dtype=None, **kwargs):
        _only_defaults(type_name, {k: v for k, v in kwargs.items()
                                   if k not in names}, defaults or {})
        return cls(**{k: v for k, v in kwargs.items() if k in names})
    HEADS.register(factory, name=type_name)


_towers_head(FCOSHead, "FCOSHead")
_towers_head(ATSSHead, "ATSSHead")
_towers_head(FoveaHead, "FoveaHead")
_towers_head(GARetinaHead, "GARetinaHead", dict(deformable_groups=1))


@HEADS.register(name="RepPointsHead")
def _reppoints_head(norm_cfg=None, dtype=None, **kwargs):
    return RepPointsHead(norm_cfg=_norm_cfg("RepPointsHead", norm_cfg),
                         **kwargs)


@HEADS.register(name="SSDHead")
def _ssd_head(num_classes=21, in_channels=(512, 1024, 512, 256, 256, 256),
              num_anchors=(4, 6, 6, 6, 4, 4), dtype=None, **options):
    _only_defaults("SSDHead", options, {})
    return SSDHead(num_classes=num_classes, in_channels=tuple(in_channels),
                   num_anchors=tuple(num_anchors))


# the reference TwoStageDetector's fields that the port's detector
# implements only at their defaults (roi_align_impl picks among
# implementations of one function: the port has its own)
DETECTOR_DEFAULTS = dict(semantic_fusion="add", semantic_level=0,
                         img_norm=None)


# the anchor keywords of the reference's RPN, two-stage and cascade
# detectors, with their defaults (strides None: `AnchorDetector`'s)
ANCHOR_DEFAULTS = dict(strides=None, anchor_scales=(8,),
                       anchor_ratios=(0.5, 1.0, 2.0),
                       ga_target_stds=(0.07, 0.07, 0.14, 0.14),
                       ga_loc_filter_thr=0.01)


def _anchor_options(options: dict) -> dict:
    """Pops the anchor keywords out of ``options``, as `AnchorDetector`
    takes them."""
    return {k: tuple(v) if isinstance(v, (list, tuple)) else v
            for k, v in ((k, options.pop(k, d))
                         for k, d in ANCHOR_DEFAULTS.items())}


def build_shared_head(cfg):
    return build(cfg, SHARED_HEADS)


def _compute_dtype(type_name, dtype, cfgs: dict):
    """The detector's dtype, else its sub-modules' (they must agree; a
    list of configs, such as a sequence of necks, counts each),
    else float32."""
    dtype = torch_dtype(dtype)
    if dtype is not None:
        return dtype
    flat = [c for v in cfgs.values()
            for c in (v if isinstance(v, (list, tuple)) else [v])]
    subs = {torch_dtype(c["dtype"]) for c in flat
            if c and c.get("dtype") is not None}
    if len(subs) > 1:
        raise NotImplementedError(f"{type_name}: sub-modules in several "
                                  f"dtypes {subs} are {NOT_PORTED}")
    return subs.pop() if subs else torch.float32


def _neck(cfg):
    """The neck of ``cfg``, or of a list of configs an `nn.Sequential`
    that runs them in order (reference two_stage.py:203-211)."""
    neck = build_neck(cfg)
    return nn.Sequential(*neck) if isinstance(neck, list) else neck


def _two_stage(type_name, backbone=None, neck=None, rpn_head=None,
               bbox_head=None, rbbox_head=None, rbbox_refine_head=None,
               mask_head=None, semantic_head=None, mask_loss_type="bce",
               shared_head=None, mask_iou_head=None, grid_head=None,
               grid_roi_size=14, train_cfg=None, test_cfg=None,
               img_size=1024, rbbox_encode="thetaobb", roi_align_impl="auto",
               dtype=None, hobb_robust_loss=False, **options):
    """A `TwoStageDetector` from the reference's detector keywords, with
    its defaults for the sub-modules a config leaves out
    (two_stage.py:126-177); its ``compute_dtype`` is the config's
    dtype.  Without an rbbox head or a mask head it predicts boxes
    alone (FasterRCNN, FastRCNN)."""
    anchors = _anchor_options(options)
    _only_defaults(type_name, options, DETECTOR_DEFAULTS)
    if roi_align_impl not in ("auto", "xla", "pallas"):
        raise ValueError(f"roi_align_impl {roi_align_impl!r}")
    cfgs = dict(
        backbone=backbone or dict(type="ResNet", depth=50),
        neck=neck or dict(type="FPN", num_outs=5),
        rpn_head=rpn_head or dict(type="RPNHead", num_anchors=len(
            anchors["anchor_scales"]) * len(anchors["anchor_ratios"])),
        bbox_head=bbox_head or dict(type="SharedFCBBoxHead",
                                    num_classes=16))
    for key, cfg in (("rbbox_head", rbbox_head), ("mask_head", mask_head),
                     ("semantic_head", semantic_head),
                     ("shared_head", shared_head), ("grid_head", grid_head)):
        if cfg:
            cfgs[key] = cfg
    if rbbox_refine_head:
        cfgs["rbbox_refine_head"] = dict(rbbox_refine_head)
        cfgs["rbbox_refine_head"].setdefault("type", "RBBoxHead")
        cfgs["rbbox_refine_head"].setdefault("encode", "rtheta")
    if mask_iou_head:
        cfgs["mask_iou_head"] = mask_iou_head
    dtype = _compute_dtype(type_name, dtype, cfgs)
    build_fn = dict(backbone=build_backbone, neck=_neck,
                    shared_head=build_shared_head)
    mods = {k: build_fn.get(k, build_head)(c) for k, c in cfgs.items()}
    if "rbbox_head" in mods and mods["rbbox_head"].encode != rbbox_encode:
        raise NotImplementedError(
            f"{type_name}: rbbox_encode {rbbox_encode!r} differs from the "
            f"rbbox head's encode {mods['rbbox_head'].encode!r}, which is "
            f"{NOT_PORTED}")
    model = TwoStageDetector(
        mods["backbone"], mods["neck"], mods["rpn_head"], mods["bbox_head"],
        mods.get("rbbox_head"), img_size=img_size, train_cfg=train_cfg,
        test_cfg=test_cfg, compute_dtype=dtype,
        rbbox_refine_head=mods.get("rbbox_refine_head"),
        mask_head=mods.get("mask_head"), mask_loss_type=mask_loss_type,
        semantic_head=mods.get("semantic_head"),
        hobb_robust_loss=hobb_robust_loss,
        shared_head=mods.get("shared_head"),
        mask_iou_head=mods.get("mask_iou_head"),
        grid_head=mods.get("grid_head"), grid_roi_size=grid_roi_size,
        **anchors)
    return model


@DETECTORS.register(name="RBBoxRCNN")
def _rbbox_rcnn(rbbox_head=None, **kwargs):
    return _two_stage("RBBoxRCNN", rbbox_head=rbbox_head
                      or dict(type="RBBoxHead"), **kwargs)


@DETECTORS.register(name="RBBoxRCNNRRoI")
def _rbbox_rcnn_rroi(rbbox_head=None, rbbox_refine_head=None, **kwargs):
    return _two_stage(
        "RBBoxRCNNRRoI", rbbox_head=rbbox_head or dict(type="RBBoxHead"),
        rbbox_refine_head=rbbox_refine_head
        or dict(type="RBBoxHead", encode="rtheta"), **kwargs)


def _preset(type_name, build=None, **preset):
    """A detector type built by ``build`` (default `_two_stage`) whose
    keywords default to ``preset`` (a config's keyword replaces the
    preset's entry, as the reference's `_two_stage_factory`)."""
    def factory(**kwargs):
        return (build or _two_stage)(type_name, **dict(preset, **kwargs))
    DETECTORS.register(factory, name=type_name)
    return factory


_preset("FasterRCNN")
# Fast R-CNN: the same model, whose test path is predict_from_proposals
_preset("FastRCNN")
_preset("MaskRCNN", mask_head=dict(type="FCNMaskHead"))
_preset("MaskOBB", mask_head=dict(type="FCNMaskHead"))
_preset("CenterMapOBB", mask_head=dict(type="CenterMapHead"),
        mask_loss_type="centermap")
# CenterMap-Net: CenterMapOBB and the WPSGA semantic branch fused into
# the RoI features by addition
_preset("CenterMapNet", mask_head=dict(type="CenterMapHead"),
        mask_loss_type="centermap",
        semantic_head=dict(type="WPSGAHead", channels=256))
_preset("MaskScoringRCNN", mask_head=dict(type="FCNMaskHead"),
        mask_iou_head=dict(type="MaskIoUHead"))
# GA-Faster R-CNN: the guided-anchoring RPN before the usual second stage
_preset("GAFasterRCNN", rpn_head=dict(type="GARPNHead"))
_preset("GridRCNN", grid_head=dict(type="GridHead"))
_preset("DoubleHeadRCNN", bbox_head=dict(type="DoubleConvFCBBoxHead"))


@DETECTORS.register(name="RPN")
def _rpn(backbone=None, neck=None, rpn_head=None, train_cfg=None,
         test_cfg=None, img_size=1024, dtype=None, **options):
    """The proposal-only RPN (reference detectors/rpn.py) with its
    defaults for the sub-modules a config leaves out: an `RPNHead` over
    the anchors of its ``strides`` and scales, or a `GARPNHead`."""
    anchors = _anchor_options(options)
    _only_defaults("RPN", options, dict(img_norm=None))
    cfgs = dict(backbone=backbone or dict(type="ResNet", depth=50),
                neck=neck or dict(type="FPN", num_outs=5),
                rpn_head=rpn_head or dict(type="RPNHead", num_anchors=len(
                    anchors["anchor_scales"]) * len(
                        anchors["anchor_ratios"])))
    dtype = _compute_dtype("RPN", dtype, cfgs)
    return RPN(build_backbone(cfgs["backbone"]), _neck(cfgs["neck"]),
               build_head(cfgs["rpn_head"]), img_size=img_size,
               train_cfg=train_cfg, test_cfg=test_cfg, compute_dtype=dtype,
               **anchors)


def _cascade(type_name, backbone=None, neck=None, rpn_head=None,
             bbox_head=None, shared_head=None, mask_head=None,
             per_stage_masks=False, interleaved=False, mask_info_flow=False,
             semantic_head=None, semantic_fusion=("bbox", "mask"),
             semantic_level=1, num_stages=3, train_cfg=None, test_cfg=None,
             img_size=1024, dtype=None, **options):
    """A `CascadeRCNN` from the reference's keywords (cascade.py:49-96):
    ``num_stages`` copies of the bbox head's config, each forced
    class-agnostic (the cascade's convention, :85-88), one mask head or
    one per stage.  Under the mask information flow every mask head
    must be an `HTCMaskHead` (the reference calls it with the previous
    stage's feature, which an `FCNMaskHead` does not take: a TypeError
    there too), and every one but the first gets its ``conv_res``."""
    anchors = _anchor_options(options)
    _only_defaults(type_name, options, dict(img_norm=None))
    cfgs = dict(
        backbone=backbone or dict(type="ResNet", depth=50),
        neck=neck or dict(type="FPN", num_outs=5),
        rpn_head=rpn_head or dict(type="RPNHead", num_anchors=3),
        bbox_head=dict(bbox_head or dict(type="SharedFCBBoxHead",
                                         num_classes=16),
                       reg_class_agnostic=True))
    n_masks = (num_stages if per_stage_masks else 1) if mask_head else 0
    flow = mask_info_flow and per_stage_masks
    masks = []
    for i in range(n_masks):
        c = dict(mask_head)
        if flow:
            if c.get("type") != "HTCMaskHead" or not c.get("with_conv_res",
                                                           True):
                raise TypeError(
                    f"{type_name}: the mask information flow feeds each "
                    "mask head the previous stage's feature, which needs an "
                    f"HTCMaskHead with conv_res, not {c.get('type')!r}")
            c["with_conv_res"] = i > 0
        elif c.get("type") == "HTCMaskHead":
            c["with_conv_res"] = False
        masks.append(c)
    if semantic_head:
        cfgs["semantic_head"] = semantic_head
    if shared_head:
        cfgs["shared_head"] = shared_head
    dtype = _compute_dtype(type_name, dtype, dict(cfgs, masks=masks))
    return CascadeRCNN(
        build_backbone(cfgs["backbone"]), _neck(cfgs["neck"]),
        build_head(cfgs["rpn_head"]),
        [build_head(dict(cfgs["bbox_head"])) for _ in range(num_stages)],
        mask_heads=[build_head(c) for c in masks] or None,
        semantic_head=semantic_head and build_head(semantic_head),
        per_stage_masks=per_stage_masks, interleaved=interleaved,
        mask_info_flow=mask_info_flow, semantic_fusion=semantic_fusion,
        semantic_level=semantic_level, img_size=img_size,
        train_cfg=train_cfg, test_cfg=test_cfg, compute_dtype=dtype,
        shared_head=shared_head and build_shared_head(shared_head),
        **anchors)


_preset("CascadeRCNN", build=_cascade)
# Hybrid Task Cascade: per-stage HTC mask heads, interleaved, with the
# mask information flow (cascade.py:462-472)
_preset("HTC", build=_cascade, mask_head=dict(type="HTCMaskHead"),
        per_stage_masks=True, interleaved=True, mask_info_flow=True)


def _loss(cfg: dict, ported: dict):
    """A single-stage detector's loss from its config dict, of the types
    in ``ported``."""
    cfg = dict(cfg)
    t = cfg.pop("type")
    if t not in ported:
        raise NotImplementedError(f"single-stage loss {t!r} is {NOT_PORTED}; "
                                  f"{sorted(ported)} are")
    return ported[t](**cfg)


def _single_stage(type_name, backbone=None, neck=None, bbox_head=None,
                  train_cfg=None, test_cfg=None, img_size=1024,
                  strides=(8, 16, 32, 64, 128),
                  anchor_scales=(4, 5.0396842, 6.3496042),
                  anchor_ratios=(0.5, 1.0, 2.0),
                  target_means=(0., 0., 0., 0.),
                  target_stds=(1., 1., 1., 1.), with_rbox=False,
                  rbox_encode="thetaobb", rnms_thr=0.1, loss_cls=None,
                  loss_bbox=None, loss_type="standard", free_anchor_cfg=None,
                  dtype=None, **options):
    """A `SingleStageDetector` from the reference's keywords, with its
    defaults for the sub-modules a config leaves out
    (single_stage.py:70-79): ResNet-50, FPN P3-P7 with extra convs, a
    16-class RetinaHead with one anchor per scale and ratio; the losses
    default to the detector's (the focal loss, smooth L1 at beta 0.11)."""
    _only_defaults(type_name, options, dict(img_norm=None))
    num_anchors = len(anchor_scales) * len(anchor_ratios)
    cfgs = dict(
        backbone=backbone or dict(type="ResNet", depth=50),
        neck=neck or dict(type="FPN", num_outs=5, start_level=1,
                          add_extra_convs=True),
        bbox_head=bbox_head or dict(type="RetinaHead", num_classes=16,
                                    num_anchors=num_anchors))
    dtype = _compute_dtype(type_name, dtype, cfgs)
    return SingleStageDetector(
        build_backbone(cfgs["backbone"]), _neck(cfgs["neck"]),
        build_head(cfgs["bbox_head"]), img_size=img_size, strides=strides,
        anchor_scales=anchor_scales, anchor_ratios=anchor_ratios,
        target_means=target_means, target_stds=target_stds,
        train_cfg=train_cfg, test_cfg=test_cfg, with_rbox=with_rbox,
        rbox_encode=rbox_encode, rnms_thr=rnms_thr,
        cls_loss=loss_cls and _loss(loss_cls, dict(FocalLoss=FocalLoss,
                                                   GHMC=GHMC)),
        bbox_loss=loss_bbox and _loss(
            loss_bbox, dict(SmoothL1Loss=SmoothL1Loss,
                            BalancedL1Loss=BalancedL1Loss, GHMR=GHMR,
                            IoULoss=IoULoss, BoundedIoULoss=BoundedIoULoss,
                            GIoULoss=GIoULoss)),
        compute_dtype=dtype, loss_type=loss_type,
        free_anchor_cfg=free_anchor_cfg)


_preset("SingleStageDetector", build=_single_stage)
_preset("RetinaNet", build=_single_stage)
# the rotated RetinaNet: the head regresses rbox_encode's deltas
_preset("RetinaNetOBB", build=_single_stage, with_rbox=True)
# RetinaNet trained by FreeAnchor's bag likelihood
_preset("FreeAnchorRetinaNet", build=_single_stage, loss_type="free_anchor",
        target_stds=(0.1, 0.1, 0.2, 0.2))

# the reference's default neck of its anchor-free detectors: P3-P7, the
# extra levels by convs on P5
DENSE_NECK = dict(type="FPN", num_outs=5, start_level=1,
                  add_extra_convs=True, extra_convs_on_inputs=False)
# the heads whose per-level scales need the number of levels
LEVEL_HEADS = ("FCOSHead", "ATSSHead")


def _dense(type_name, cls, backbone=None, neck=None, bbox_head=None,
           train_cfg=None, test_cfg=None, img_size=1024,
           strides=(8, 16, 32, 64, 128), dtype=None, default_neck=DENSE_NECK,
           default_head=None, **options):
    """A `DenseDetector` subclass ``cls`` from the reference's keywords,
    with its defaults for the sub-modules a config leaves out (a
    ResNet-50, ``default_neck``, ``default_head``); ``options`` are
    ``cls``'s own keywords (FCOS's center_sampling, RepPoints'
    transform_method, ...)."""
    cfgs = dict(backbone=backbone or dict(type="ResNet", depth=50),
                neck=neck or default_neck,
                bbox_head=dict(bbox_head or default_head))
    if cfgs["bbox_head"]["type"] in LEVEL_HEADS:
        cfgs["bbox_head"].setdefault("num_levels", len(strides))
    dtype = _compute_dtype(type_name, dtype, cfgs)
    return cls(build_backbone(cfgs["backbone"]), _neck(cfgs["neck"]),
               build_head(cfgs["bbox_head"]), img_size=img_size,
               strides=strides, train_cfg=train_cfg, test_cfg=test_cfg,
               compute_dtype=dtype, **options)


_preset("FCOS", build=_dense, cls=FCOS,
        default_neck=dict(DENSE_NECK, relu_before_extra_convs=True),
        default_head=dict(type="FCOSHead", num_classes=16))
_preset("ATSS", build=_dense, cls=ATSS,
        default_head=dict(type="ATSSHead", num_classes=16))
_preset("FOVEA", build=_dense, cls=FOVEA,
        default_head=dict(type="FoveaHead", num_classes=16))
_preset("RepPointsDetector", build=_dense, cls=RepPointsDetector,
        default_head=dict(type="RepPointsHead", num_classes=16))
_preset("GARetinaNet", build=_dense, cls=GARetinaNet,
        default_neck=dict(type="FPN", num_outs=5, start_level=1,
                          add_extra_convs=True),
        default_head=dict(type="GARetinaHead", num_classes=16))


@DETECTORS.register(name="SSD")
def _ssd(backbone=None, bbox_head=None, neck=None, train_cfg=None,
         test_cfg=None, input_size=300, img_size=300, dtype=None,
         **options):
    """SSD from the reference's keywords: SSDVGG at ``input_size`` and a
    21-class SSDHead unless the config names others; ``neck`` is a field
    the reference keeps and does not read, and ``img_size`` its alias of
    ``input_size``."""
    _only_defaults("SSD", options, {})
    cfgs = dict(backbone=backbone or dict(type="SSDVGG",
                                          input_size=input_size),
                bbox_head=bbox_head or dict(type="SSDHead", num_classes=21))
    dtype = _compute_dtype("SSD", dtype, cfgs)
    return SSD(build_backbone(cfgs["backbone"]),
               build_head(cfgs["bbox_head"]), input_size=input_size,
               train_cfg=train_cfg, test_cfg=test_cfg, compute_dtype=dtype)


def build(cfg, registry, default_args=None):
    if isinstance(cfg, (list, tuple)):
        return [build_from_cfg(c, registry, default_args) for c in cfg]
    return build_from_cfg(cfg, registry, default_args)


def build_backbone(cfg):
    return build(cfg, BACKBONES)


def build_neck(cfg):
    return build(cfg, NECKS)


def build_head(cfg):
    return build(cfg, HEADS)


def build_detector(cfg, train_cfg=None, test_cfg=None, device="cuda",
                   seed: int = 0, train: bool = False):
    """The detector of ``cfg`` on ``device`` in eval mode, with random
    weights from ``torch.Generator().manual_seed(seed)``, every
    parameter in the config's dtype (see the module docstring), or with
    ``train`` the trainer's build: float32 parameters, computing in the
    config's dtype (as `flagship.build_flagship(train=True)`).
    ``train_cfg`` and ``test_cfg`` apply where ``cfg`` has none."""
    model = build(cfg, DETECTORS,
                  dict(train_cfg=train_cfg, test_cfg=test_cfg))
    return finish(model, False, device, model.compute_dtype, seed, train)


def apply_fp16_cfg(cfg, model_cfg: dict) -> dict:
    """A config's ``fp16 = dict(...)`` sets the detector's dtype to
    bfloat16 where the model config names none (the reference's
    `utils/precision.py::apply_fp16_cfg` :17: bf16, no loss scaling)."""
    if cfg.get("fp16"):
        model_cfg.setdefault("dtype", torch.bfloat16)
    return model_cfg
