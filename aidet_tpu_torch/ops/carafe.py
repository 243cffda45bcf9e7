"""CARAFE: content-aware reassembly of features (the upsampling of
FPN_CARAFE).

Port of `aidet_tpu/ops/carafe.py` (`carafe` :16, `CARAFEPack` :44;
parity: mmdet/ops/carafe): a kernel-prediction branch emits, for every
output pixel, a softmax-normalised ``k_up`` x ``k_up`` kernel, and each
output pixel is that kernel applied to the ``k_up`` x ``k_up``
neighbourhood of its source pixel.  The reference writes it as XLA
code (patch extraction and an einsum), so it is plain PyTorch here: the
patches come from `F.unfold`, whose channels are channel-major (c, then
kernel tap), as `conv_general_dilated_patches`' are.  NCHW in and out.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def carafe(x, kernels, up_factor: int = 2, k_up: int = 5):
    """Reassemble-upsample x [B, C, H, W] with ``kernels`` [B, k_up^2,
    H * up, W * up] (softmax-normalised over dim 1): output pixel (i, j)
    reads the neighbourhood of source pixel (i // up, j // up).
    Returns [B, C, H * up, W * up]."""
    b, c, h, w = x.shape
    up, kk = up_factor, k_up * k_up
    patches = F.unfold(x, k_up, padding=k_up // 2).reshape(b, c, kk, h, w)
    kern = kernels.reshape(b, kk, h, up, w, up)
    out = torch.einsum("bckhw,bkhuwv->bchuwv", patches, kern)
    return out.reshape(b, c, h * up, w * up)


class CARAFEPack(nn.Module):
    """The kernel prediction and the reassembly: a 1x1
    ``channel_compressor`` to ``compressed_channels``, a ``k_enc`` x
    ``k_enc`` ``content_encoder`` to up^2 * k_up^2 channels, ordered
    (u, v, tap) as the reference's NHWC reshape, shuffled to the
    upsampled grid (not `torch.pixel_shuffle`'s (tap, u, v) order), a
    softmax over the taps, then `carafe`."""

    def __init__(self, channels: int, up_factor: int = 2, k_up: int = 5,
                 k_enc: int = 3, compressed_channels: int = 64):
        super().__init__()
        self.up_factor = up_factor
        self.k_up = k_up
        self.channel_compressor = nn.Conv2d(channels, compressed_channels, 1)
        self.content_encoder = nn.Conv2d(
            compressed_channels, up_factor * up_factor * k_up * k_up, k_enc,
            padding=k_enc // 2)

    def forward(self, x):
        up, kk = self.up_factor, self.k_up * self.k_up
        enc = self.content_encoder(self.channel_compressor(x))
        b, _, h, w = enc.shape
        kern = enc.reshape(b, up, up, kk, h, w).permute(0, 3, 4, 1, 5, 2)
        kern = torch.softmax(kern.reshape(b, kk, h * up, w * up), dim=1)
        return carafe(x, kern, up, self.k_up)
