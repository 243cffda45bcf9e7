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
  / _rbbox_refine_head / _mask_head / _semantic_head -> backbone / neck
  / rpn_head / bbox_head / rbbox_head / rbbox_refine_head / mask_head /
  semantic_head, a single-stage detector's dense head _head ->
  bbox_head, and the lists _neck_{i} (a sequence of necks), _heads_{i}
  and _mask_heads_{i} (a cascade's stages) -> neck.{i}, bbox_heads.{i}
  and mask_heads.{i}; the inner names are the same on both sides
  (ResNeXt's as ResNet's; the GN conv head's shared_conv{i} and
  shared_norm{i}; the HTC mask head's conv_res; the fused semantic
  head's lateral{i}, conv{i}, conv_embedding and conv_logits; RetinaHead's
  cls_conv{i}, reg_conv{i}, retina_cls, retina_reg; FPN's lateral{i},
  fpn{i} over the used levels and extra{i}; HRNet's stem1/2,
  stem_bn1/2, layer1_block{k}, t{stage}_{b}, t_bn{stage}_{b} and
  stage{s}_module{m} with its branch{b}_block{k}, fuse{i}_{j}[_{s}] and
  fuse_bn{i}_{j}[_{s}]; HRFPN's reduce and fpn{i}).

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
             "_head": "bbox_head"}
# flax lists of submodules: _name_{i} -> name.{i}
TOP_LEVEL_LISTS = {"_neck": "neck", "_heads": "bbox_heads",
                   "_mask_heads": "mask_heads"}
# the flax ConvTranspose layers of the ported modules, by name
CONV_TRANSPOSE = {"upsample"}
LEAF = {("params", "bias"): "bias", ("params", "scale"): "weight",
        ("batch_stats", "mean"): "running_mean",
        ("batch_stats", "var"): "running_var"}


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


def flax_to_state_dict(variables, model=None):
    """Returns (state_dict of float32 tensors, unmapped leaf paths).
    With ``model``, a 7x7 stem kernel is relaid when ``model``'s stem
    is space-to-depth."""
    sd, unmapped = {}, []
    for path, value in _leaves(variables):
        collection, top, *mid, leaf = path
        arr = np.array(value, np.float32)
        top = _top_level(top)
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
        sd[key] = torch.from_numpy(np.ascontiguousarray(arr))
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
