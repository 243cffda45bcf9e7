"""Deformable convolution (v1, and v2's modulation) as a bilinear gather
and a matrix product.

Port of `aidet_tpu/ops/deform_conv.py::deform_conv2d` :40, `_bilinear`
:19 and the `DeformConv2d` layer :74, which the JAX package writes as
XLA code, not as a Pallas kernel: each output pixel's kh x kw taps are
sampled at their offset positions by bilinear interpolation, then
contracted with the weight.  Batched over images; NHWC maps, but the
layer's NCHW.
"""

from __future__ import annotations

import torch
from torch import nn


def bilinear(img, ys, xs):
    """img [B, H, W, C]; ys, xs [B, ...] -> [B, ..., C]: bilinear samples
    of each image with the reference's border rule: a point at or past
    -1 or H (W) is 0, any other is clamped into [0, H - 1] x [0, W - 1]
    and interpolated between its floor and the next row and column
    (clamped)."""
    b, h, w, c = img.shape
    oob = (ys <= -1.0) | (ys >= h) | (xs <= -1.0) | (xs >= w)
    y = ys.clamp(0.0, h - 1)
    x = xs.clamp(0.0, w - 1)
    y0 = torch.floor(y)
    x0 = torch.floor(x)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    ly = (y - y0)[..., None]
    lx = (x - x0)[..., None]
    flat = img.reshape(b, h * w, c)

    def at(yi, xi):
        idx = (yi.long() * w + xi.long()).reshape(b, -1, 1)
        return torch.gather(flat, 1, idx.expand(-1, -1, c)).reshape(
            yi.shape + (c,))
    v = (at(y0, x0) * (1 - ly) * (1 - lx)
         + at(y0, x1) * (1 - ly) * lx
         + at(y1, x0) * ly * (1 - lx)
         + at(y1, x1) * ly * lx)
    return torch.where(oob[..., None], v.new_zeros(()), v)


def deform_conv2d(x, offset, weight, mask=None, stride=1, padding=1,
                  dilation=1):
    """Deformable convolution without bias.

    x [B, H, W, Cin]; offset [B, Ho, Wo, 2 * kh * kw]: (dy, dx) of each
    tap, taps in row-major order; weight [Cout, Cin, kh, kw] (a
    `torch.nn.Conv2d`'s); mask None or [B, Ho, Wo, kh * kw], DCNv2's
    modulation.  Returns [B, Ho, Wo, Cout].  With zero offsets and no
    mask it is the plain convolution."""
    cout, cin, kh, kw = weight.shape
    b, h, w = x.shape[:3]
    ho = (h + 2 * padding - dilation * (kh - 1) - 1) // stride + 1
    wo = (w + 2 * padding - dilation * (kw - 1) - 1) // stride + 1
    dev = x.device
    base_y = (torch.arange(ho, device=dev) * stride - padding).float()
    base_x = (torch.arange(wo, device=dev) * stride - padding).float()
    tap_y = (torch.arange(kh, device=dev) * dilation).float()
    tap_x = (torch.arange(kw, device=dev) * dilation).float()
    off = offset.reshape(b, ho, wo, kh * kw, 2).float()
    yy = (base_y[:, None, None] + tap_y.repeat_interleave(kw)) + off[..., 0]
    xx = (base_x[None, :, None] + tap_x.repeat(kh)) + off[..., 1]
    patches = bilinear(x, yy, xx)                    # [B, Ho, Wo, K, Cin]
    if mask is not None:
        patches = patches * mask[..., None]
    w_flat = weight.permute(2, 3, 1, 0).reshape(kh * kw * cin, cout)
    return patches.reshape(b, ho, wo, kh * kw * cin) @ w_flat.to(
        patches.dtype)


class DeformConv2d(nn.Conv2d):
    """The reference's DCN layer (DeformConvPack; with ``modulated``
    DCNv2's ModulatedDeformConvPack): a conv ``conv_offset`` (same
    kernel, stride, padding and dilation, with bias) predicts each
    output pixel's 2 kh kw tap offsets, and with ``modulated`` kh kw
    more channels whose sigmoid is the modulation; then `deform_conv2d`
    with this layer's weight and bias.  `init_prior` zeroes the offset
    conv, as the reference initializes it: the layer then starts as the
    plain conv.  NCHW in and out, as a `torch.nn.Conv2d`."""

    def __init__(self, in_channels, out_channels, kernel_size=3, stride=1,
                 padding=1, dilation=1, modulated=False):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, bias=True)
        k = kernel_size
        self.modulated = modulated
        self.conv_offset = nn.Conv2d(
            in_channels, (3 if modulated else 2) * k * k, k, stride,
            padding, dilation)
        self.init_prior()

    @torch.no_grad()
    def init_prior(self):
        self.conv_offset.weight.zero_()
        self.conv_offset.bias.zero_()

    def forward(self, x):
        kk = self.kernel_size[0] * self.kernel_size[1]
        out = self.conv_offset(x).permute(0, 2, 3, 1)
        offset, mask = out[..., :2 * kk], None
        if self.modulated:
            mask = torch.sigmoid(out[..., 2 * kk:])
        y = deform_conv2d(x.permute(0, 2, 3, 1), offset, self.weight, mask,
                          self.stride[0], self.padding[0], self.dilation[0])
        return (y + self.bias.to(y.dtype)).permute(0, 3, 1, 2).to(x.dtype)
