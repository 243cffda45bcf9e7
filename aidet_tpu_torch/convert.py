"""Weight bridge: the reference's flax variables -> the port's
state_dict.

`flax_to_state_dict` takes the variables of a reference
`TwoStageDetector` (a nested mapping of arrays under "params" and
"batch_stats", e.g. `model.init(...)` of the flagship) and returns the
state_dict of the matching `aidet_tpu_torch` model.  It is the inverse
of the mapping in the reference's `tools/torch2jax.py`:

- conv kernels HWIO -> OIHW, dense kernels [in, out] -> [out, in]
  (the semantic head's attention linears among them);
- a flax ConvTranspose kernel (the mask heads' ``upsample``) [kh, kw,
  in, out] is flipped in space, then relaid [in, out, kh, kw]:
  `torch.nn.ConvTranspose2d` correlates with the flipped kernel of
  what flax's ``transpose_kernel=False`` layer applies;
- FrozenBN: scale -> weight, bias -> bias, and the batch stats
  mean / var -> running_mean / running_var; GroupNorm (the ResNet's
  ``stem_bn``, ``bn1``-``bn3`` and ``ds_bn`` and the FPN's
  ``lateral_norm{i}`` / ``fpn_norm{i}`` under a GN norm_cfg): scale ->
  weight, bias -> bias, no statistics;
- top-level modules _backbone / _neck / _rpn / _bbox_head / _rbbox_head
  / _rbbox_refine_head / _mask_head / _semantic_head / _shared_head /
  _mask_iou_head / _grid_head -> backbone / neck / rpn_head / bbox_head
  / rbbox_head / rbbox_refine_head / mask_head / semantic_head /
  shared_head / mask_iou_head / grid_head, a single-stage detector's
  dense head _head ->
  bbox_head, and the lists _neck_{i} (a sequence of necks), _heads_{i}
  and _mask_heads_{i} (a cascade's stages) -> neck.{i}, bbox_heads.{i}
  and mask_heads.{i}; the inner names are the same on both sides
  (the plug-ins' too: ConvWS's ``kernel`` as any conv's; ContextBlock's
  conv_mask, channel_add_conv{1,2} and LayerNorm ``ln``, scale ->
  weight; GeneralizedAttention's query/key/value/proj convs, its Dense
  ``appr_geom_fc_{x,y}`` and its own ``appr_bias``, ``geom_bias`` and
  scalar ``gamma``, which keep their names; FPN_CARAFE's carafe{i}
  with channel_compressor and content_encoder; the GN mask head's
  norm{i}; ResNeXt's as ResNet's; the GN conv head's shared_conv{i} and
  shared_norm{i}; the HTC mask head's conv_res; the fused semantic
  head's lateral{i}, conv{i}, conv_embedding and conv_logits; RetinaHead's
  cls_conv{i}, reg_conv{i}, retina_cls, retina_reg; FPN's lateral{i},
  fpn{i} over the used levels and extra{i}; HRNet's stem1/2,
  stem_bn1/2, layer1_block{k}, t{stage}_{b}, t_bn{stage}_{b} and
  stage{s}_module{m} with its branch{b}_block{k}, fuse{i}_{j}[_{s}] and
  fuse_bn{i}_{j}[_{s}]; HRFPN's reduce and fpn{i}; the res5 shared
  head's layer4_block{b}; BFP's refine; the double head's conv_in,
  res{i}_reduce / _conv / _expand, cls_fc{i}; the mask IoU head's
  conv{i}, fc{i} and fc_mask_iou; GA-RPN's conv_loc, conv_shape and
  adaption_offset; the grid head's conv{i}, GroupNorm_{i},
  {f,s}order_dw / _pw and deconv_norm);
- the parameters a reference module declares itself (`RAW_PARAMS`):
  GA-RPN's ``adapt_kernel`` and GA-RetinaNet's ``adapt_{cls,reg}_kernel``,
  RepPoints' ``cls_dconv_kernel`` and ``refine_dconv_kernel`` (HWIO ->
  OIHW), the grid head's ``deconv{1,2}_kernel`` (grouped transposed
  convs, relaid by `grouped_transpose_kernel`, not flipped: the
  reference flips them in its op) and ``deconv{1,2}_bias``; and by
  pattern (`RAW_PATTERNS`) the FCOS and ATSS heads' per-level
  ``scale{l}`` scalars and RetinaSepBNHead's per-level norms
  ``{cls,reg}_bn_l{l}_{i}_{scale,bias}`` -> ``{cls,reg}_bn_l{l}_{i}``'s
  weight and bias;
- a detector's own parameter (RepPoints' ``moment_transfer``) keeps its
  name; each `DeformConv2d` (ResNet's dcn conv2: ``conv_offset``,
  ``kernel``, ``bias``) maps through the layer names above, and
  SSD-VGG's ``l2norm.gamma`` keeps its leaf name.

The first FC after the RoI crop needs no row permutation: the port's
heads flatten [s, s, C] crops in (h, w, c) order, as the reference
does.  Leaves are copied with `numpy.array`, so jax arrays work
without this module importing jax.

Given the target ``model``, a 7x7 stem kernel (a config's plain
``ResNet``) is relaid for a model whose stem is space-to-depth
(`stem_s2d_weights`), so that a config's weights load into the serving
build, `aidet_tpu_torch.rroi.build_rroi`.

`mmdet_to_state_dict` maps a torch checkpoint with mmdet's names
(`load_torch_state_dict` reads one) to the port's state_dict.
"""

from __future__ import annotations

import re
from collections.abc import Mapping

import numpy as np
import torch

TOP_LEVEL = {"_backbone": "backbone", "_neck": "neck", "_rpn": "rpn_head",
             "_bbox_head": "bbox_head", "_rbbox_head": "rbbox_head",
             "_rbbox_refine_head": "rbbox_refine_head",
             "_mask_head": "mask_head", "_semantic_head": "semantic_head",
             "_shared_head": "shared_head",
             "_mask_iou_head": "mask_iou_head", "_grid_head": "grid_head",
             "_head": "bbox_head"}
# flax lists of submodules: _name_{i} -> name.{i}
TOP_LEVEL_LISTS = {"_neck": "neck", "_heads": "bbox_heads",
                   "_mask_heads": "mask_heads"}
# the flax ConvTranspose layers of the ported modules, by name
CONV_TRANSPOSE = {"upsample"}
LEAF = {("params", "bias"): "bias", ("params", "scale"): "weight",
        ("batch_stats", "mean"): "running_mean",
        ("batch_stats", "var"): "running_var",
        ("params", "gamma"): "gamma",
        ("params", "appr_bias"): "appr_bias",
        ("params", "geom_bias"): "geom_bias"}
# parameters a reference module declares itself, not through a layer:
# GA-RPN's adaption conv kernel (HWIO) and the grid head's grouped
# transposed-conv kernels [kh, kw, in / groups, out] with their biases,
# by name -> (the port's name, the number of groups of the kernel of
# that shape, or None for a plain conv kernel)
RAW_PARAMS = {"adapt_kernel": ("adapt.weight", None),
              "adapt_cls_kernel": ("adapt_cls.weight", None),
              "adapt_reg_kernel": ("adapt_reg.weight", None),
              "cls_dconv_kernel": ("cls_dconv.weight", None),
              "refine_dconv_kernel": ("refine_dconv.weight", None),
              "deconv1_kernel": ("deconv1.weight",
                                 lambda shape: shape[3] // shape[2]),
              "deconv1_bias": ("deconv1.bias", None),
              "deconv2_kernel": ("deconv2.weight", lambda shape: shape[3]),
              "deconv2_bias": ("deconv2.bias", None)}
# a module's own parameters by name pattern -> the port's name
RAW_PATTERNS = ((r"scale(\d+)", r"scale\1"),
                (r"(cls|reg)_bn_l(\d+)_(\d+)_scale", r"\1_bn_l\2_\3.weight"),
                (r"(cls|reg)_bn_l(\d+)_(\d+)_bias", r"\1_bn_l\2_\3.bias"))
# a detector's own parameters (no module above them)
DETECTOR_PARAMS = {"moment_transfer"}


def grouped_transpose_kernel(arr, groups):
    """A kernel [kh, kw, in / G, out] of the reference's grouped stride-2
    transposed conv (`_grouped_deconv2x`: a conv of the dilated input
    with this kernel flipped in space) as `torch.nn.ConvTranspose2d`'s
    weight [in, out / G, kh, kw], which that layer flips itself: group
    g's input channel i and output j take tap [kh, kw, i, g * out / G +
    j]."""
    kh, kw, cin_g, cout = arr.shape
    w = arr.reshape(kh, kw, cin_g, groups, cout // groups)
    return w.transpose(3, 2, 4, 0, 1).reshape(groups * cin_g,
                                              cout // groups, kh, kw)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def stem_s2d_weights(w7):
    """Relayout a [F, C, 7, 7] OIHW stem kernel (7x7, stride 2, padding
    3) into the [F, 4C, 4, 4] kernel of the space-to-depth stem
    (`ResNet(stem_space_to_depth=True)`: channels in (row phase p,
    column phase q, c) order, taps u, v in [-2, 1]).

    out[i] = sum_a w[a] x[2i + a - 3]; writing the input index as
    2(i + u) + p gives a = 2u + p + 3, so the 4-tap kernel's entries are
    the original taps permuted, and the (u=-2, p=0) slots, a = -1, stay
    zero.  The same relayout as the reference's
    `models/backbones/resnet.py::stem_s2d_weights` (HWIO), for OIHW."""
    w7 = np.asarray(w7)
    f, c = w7.shape[:2]
    w4 = np.zeros((f, 4 * c, 4, 4), w7.dtype)
    for u in range(-2, 2):
        for p in range(2):
            a = 2 * u + p + 3
            if not 0 <= a <= 6:
                continue
            for v in range(-2, 2):
                for q in range(2):
                    b = 2 * v + q + 3
                    if 0 <= b <= 6:
                        ch = p * 2 * c + q * c
                        w4[:, ch:ch + c, u + 2, v + 2] = w7[:, :, a, b]
    return w4


STEM = "backbone.stem_conv.weight"


def _top_level(name):
    """The port's module path of a top-level flax module, or None."""
    if name in TOP_LEVEL:
        return TOP_LEVEL[name]
    m = re.fullmatch(r"(_\w+?)_(\d+)", name)
    if m and m.group(1) in TOP_LEVEL_LISTS:
        return f"{TOP_LEVEL_LISTS[m.group(1)]}.{m.group(2)}"
    return None


def _raw_pattern(leaf):
    """The port's name of a leaf that matches `RAW_PATTERNS`, or None."""
    for pattern, repl in RAW_PATTERNS:
        m = re.fullmatch(pattern, leaf)
        if m:
            return m.expand(repl)
    return None


def flax_to_state_dict(variables, model=None):
    """Returns (state_dict of float32 tensors, unmapped leaf paths).
    With ``model``, a 7x7 stem kernel is relaid when ``model``'s stem
    is space-to-depth."""
    sd, unmapped = {}, []
    for path, value in _leaves(variables):
        arr = np.array(value, np.float32)
        if len(path) == 2 and path[1] in DETECTOR_PARAMS:
            sd[path[1]] = torch.from_numpy(arr)
            continue
        collection, top, *mid, leaf = path
        top = _top_level(top)
        raw = _raw_pattern(leaf)
        if top is not None and not mid and raw is not None:
            sd[f"{top}.{raw}"] = torch.from_numpy(arr)
            continue
        if top is not None and not mid and leaf in RAW_PARAMS:
            name, groups = RAW_PARAMS[leaf]
            if groups is not None:
                arr = grouped_transpose_kernel(arr, groups(arr.shape))
            elif arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)
            sd[f"{top}.{name}"] = torch.from_numpy(np.ascontiguousarray(arr))
            continue
        if top is None or not mid:
            unmapped.append("/".join(path))
            continue
        if collection == "params" and leaf == "kernel":
            name = "weight"
            if arr.ndim == 4 and mid[-1] in CONV_TRANSPOSE:
                arr = arr[::-1, ::-1].transpose(2, 3, 0, 1)
            elif arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)
            elif arr.ndim == 2:
                arr = arr.T
            else:
                unmapped.append("/".join(path))
                continue
        elif (collection, leaf) in LEAF:
            name = LEAF[(collection, leaf)]
        else:
            unmapped.append("/".join(path))
            continue
        key = ".".join([top, *mid, name])
        # (ascontiguousarray makes a 0-d leaf, gamma, 1-d)
        sd[key] = torch.from_numpy(np.ascontiguousarray(arr).reshape(
            arr.shape))
    if model is not None and STEM in sd and sd[STEM].shape[-1] == 7 \
            and getattr(model.backbone, "stem_space_to_depth", False):
        sd[STEM] = torch.from_numpy(stem_s2d_weights(sd[STEM].numpy()))
    return sd, unmapped


# mmdet's names of a ResNet-FPN two-stage detector's weights (a torch
# checkpoint) -> the port's, as regular expressions; the FPN's output
# convs past its laterals are its extra levels, and the first FC of a
# box head is relaid from torch's (c, h, w) flatten to the port's
# (h, w, c) (`mmdet_to_state_dict`)
_NORM = r"(weight|bias|running_mean|running_var)"
_LATERAL = r"neck\.lateral_convs\.(\d+)\.conv\.(weight|bias)"
MMDET_NAMES = (
    (r"backbone\.conv1\.weight", r"backbone.stem_conv.weight"),
    (rf"backbone\.bn1\.{_NORM}", r"backbone.stem_bn.\1"),
    (rf"backbone\.layer(\d)\.(\d+)\.((?:conv|bn)\d)\.{_NORM}",
     r"backbone.layer\1_block\2.\3.\4"),
    (r"backbone\.layer(\d)\.(\d+)\.downsample\.0\.weight",
     r"backbone.layer\1_block\2.ds_conv.weight"),
    (rf"backbone\.layer(\d)\.(\d+)\.downsample\.1\.{_NORM}",
     r"backbone.layer\1_block\2.ds_bn.\3"),
    (_LATERAL, r"neck.lateral\1.\2"),
    (r"neck\.fpn_convs\.(\d+)\.conv\.(weight|bias)", None),
    (r"rpn_head\.(rpn_conv|rpn_cls|rpn_reg)\.(weight|bias)",
     r"rpn_head.\1.\2"),
    (r"(r?bbox_head)\.shared_fcs\.(\d+)\.(weight|bias)",
     r"\1.shared_fc\2.\3"),
    (r"(r?bbox_head)\.(fc_cls|fc_reg)\.(weight|bias)", r"\1.\2.\3"),
)


def mmdet_to_state_dict(state_dict, model=None, roi_size: int = 7):
    """An mmdet-named torch state_dict of a ResNet-FPN two-stage detector
    (Faster R-CNN, RBBoxRCNN: backbone, FPN, RPN head, bbox head and
    rbbox head) -> (the port's state_dict of float32 tensors, the keys
    it could not map).  The port's own copy of the reference's
    `tools/torch2jax.py::convert_detector` (:146, with `convert_resnet`
    :25, `convert_fpn` :93, `convert_rpn` :114 and `convert_fc_head`
    :123), mapping to the port's names directly: torch's OIHW and [out,
    in] layouts are the port's, so only the box heads' first FC is
    relaid (torch flattens a crop in (c, h, w) order, the port in (h,
    w, c); ``roi_size`` is the crop's side), and with ``model`` whose
    stem is space-to-depth the 7x7 stem through `stem_s2d_weights`.
    A BatchNorm's ``num_batches_tracked`` counter has no slot in
    FrozenBN and is left out; every other key that matches no name of
    `MMDET_NAMES` is returned, not dropped."""
    sd, unmapped = {}, []
    n_lateral = sum(1 for k in state_dict
                    if re.fullmatch(_LATERAL, k)) // 2
    for key, value in state_dict.items():
        arr = (value.detach().float().cpu().numpy()
               if isinstance(value, torch.Tensor)
               else np.asarray(value, np.float32))
        if key.endswith(".num_batches_tracked"):
            continue
        for pattern, repl in MMDET_NAMES:
            m = re.fullmatch(pattern, key)
            if m is None:
                continue
            if repl is None:        # an FPN output conv: fpn{i} or extra
                i = int(m.group(1))
                name = (f"neck.fpn{i}" if i < n_lateral
                        else f"neck.extra{i - n_lateral}")
                new = f"{name}.{m.group(2)}"
            else:
                new = m.expand(repl)
            if new.endswith("shared_fc0.weight"):
                out = arr.shape[0]
                c = arr.shape[1] // (roi_size * roi_size)
                arr = arr.reshape(out, c, roi_size, roi_size).transpose(
                    0, 2, 3, 1).reshape(out, -1)
            sd[new] = torch.from_numpy(np.ascontiguousarray(arr))
            break
        else:
            unmapped.append(key)
    if model is not None and STEM in sd and sd[STEM].shape[-1] == 7 \
            and getattr(model.backbone, "stem_space_to_depth", False):
        sd[STEM] = torch.from_numpy(stem_s2d_weights(sd[STEM].numpy()))
    return sd, unmapped


def load_torch_state_dict(path: str) -> dict:
    """The state_dict of a ``.pth`` / ``.pt`` file (a bare state_dict, or
    a checkpoint holding one under ``state_dict``, as mmdet saves it),
    with DataParallel's ``module.`` prefixes removed (the reference's
    `tools/torch2jax.py::load_torch_state_dict` :175)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return {k.replace("module.", ""): v for k, v in sd.items()
            if isinstance(v, torch.Tensor)}
