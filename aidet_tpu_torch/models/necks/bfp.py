"""Balanced Feature Pyramid (Libra R-CNN).

Port of `aidet_tpu/models/necks/bfp.py::BFP` (parity: mmdet's
necks/bfp.py): every level resized to the ``refine_level``'s size by
nearest neighbour with half-pixel centres (as `jax.image.resize(method=
"nearest")`, the FPN's `_upsample_nearest`), averaged, refined by a 3x3
conv ``refine`` (``refine_type="conv"``) or not ("none"), then resized
back to each level and added to it.  NHWC in and out.
"""

from __future__ import annotations

from torch import nn

from .fpn import _upsample_nearest


class BFP(nn.Module):
    def __init__(self, in_channels=256, num_levels=5, refine_level=2,
                 refine_type="conv"):
        super().__init__()
        if refine_type not in ("conv", "none"):
            raise NotImplementedError(f"BFP refine_type {refine_type!r} is "
                                      "not ported; 'conv' and 'none' are")
        self.num_levels = num_levels
        self.refine_level = refine_level
        if refine_type == "conv":
            self.refine = nn.Conv2d(in_channels, in_channels, 3, padding=1)
        else:
            self.refine = None

    def forward(self, inputs):
        """inputs: num_levels maps [B, H_l, W_l, C] -> the same shapes."""
        if len(inputs) != self.num_levels:
            raise ValueError(f"BFP takes {self.num_levels} levels, not "
                             f"{len(inputs)}")
        xs = [x.permute(0, 3, 1, 2) for x in inputs]
        ref = xs[self.refine_level]
        gathered = sum(_upsample_nearest(x, ref) for x in xs) / self.num_levels
        if self.refine is not None:
            gathered = self.refine(gathered)
        return tuple((x + _upsample_nearest(gathered, x)).permute(0, 2, 3, 1)
                     for x in xs)
