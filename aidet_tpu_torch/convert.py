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
  semantic_head, and a single-stage detector's dense head _head ->
  bbox_head; the inner names are the same on both sides (RetinaHead's
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
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

TOP_LEVEL = {"_backbone": "backbone", "_neck": "neck", "_rpn": "rpn_head",
             "_bbox_head": "bbox_head", "_rbbox_head": "rbbox_head",
             "_rbbox_refine_head": "rbbox_refine_head",
             "_mask_head": "mask_head", "_semantic_head": "semantic_head",
             "_head": "bbox_head"}
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


def flax_to_state_dict(variables, model=None):
    """Returns (state_dict of float32 tensors, unmapped leaf paths).
    With ``model``, a 7x7 stem kernel is relaid when ``model``'s stem
    is space-to-depth."""
    sd, unmapped = {}, []
    for path, value in _leaves(variables):
        collection, top, *mid, leaf = path
        arr = np.array(value, np.float32)
        if top not in TOP_LEVEL or not mid:
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
        key = ".".join([TOP_LEVEL[top], *mid, name])
        sd[key] = torch.from_numpy(np.ascontiguousarray(arr))
    if model is not None and STEM in sd and sd[STEM].shape[-1] == 7 \
            and getattr(model.backbone, "stem_space_to_depth", False):
        sd[STEM] = torch.from_numpy(stem_s2d_weights(sd[STEM].numpy()))
    return sd, unmapped
