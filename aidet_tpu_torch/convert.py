"""Weight bridge: the reference's flax variables -> the port's
state_dict.

`flax_to_state_dict` takes the variables of a reference
`TwoStageDetector` (a nested mapping of arrays under "params" and
"batch_stats", e.g. `model.init(...)` of the flagship) and returns the
state_dict of the matching `aidet_tpu_torch` model.  It is the inverse
of the mapping in the reference's `tools/torch2jax.py`:

- conv kernels HWIO -> OIHW, dense kernels [in, out] -> [out, in];
- FrozenBN: scale -> weight, bias -> bias, and the batch stats
  mean / var -> running_mean / running_var;
- top-level modules _backbone / _neck / _rpn / _bbox_head / _rbbox_head
  / _rbbox_refine_head -> backbone / neck / rpn_head / bbox_head /
  rbbox_head / rbbox_refine_head; the inner names are the same on both
  sides.

The first FC after the RoI crop needs no row permutation: the port's
heads flatten [s, s, C] crops in (h, w, c) order, as the reference
does.  Leaves are copied with `numpy.array`, so jax arrays work
without this module importing jax.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

TOP_LEVEL = {"_backbone": "backbone", "_neck": "neck", "_rpn": "rpn_head",
             "_bbox_head": "bbox_head", "_rbbox_head": "rbbox_head",
             "_rbbox_refine_head": "rbbox_refine_head"}
LEAF = {("params", "bias"): "bias", ("params", "scale"): "weight",
        ("batch_stats", "mean"): "running_mean",
        ("batch_stats", "var"): "running_var"}


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def flax_to_state_dict(variables):
    """Returns (state_dict of float32 tensors, unmapped leaf paths)."""
    sd, unmapped = {}, []
    for path, value in _leaves(variables):
        collection, top, *mid, leaf = path
        arr = np.array(value, np.float32)
        if top not in TOP_LEVEL or not mid:
            unmapped.append("/".join(path))
            continue
        if collection == "params" and leaf == "kernel":
            name = "weight"
            if arr.ndim == 4:
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
    return sd, unmapped
