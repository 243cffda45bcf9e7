"""Plug-in feature modules of the ResNet: the weight-standardised conv,
a learnable scale, GCNet's context block, the non-local block and the
generalized (empirical) attention.

Port of `aidet_tpu/models/plugins.py` (`ContextBlock` :12-37,
`NonLocal2D` :40-60, `ConvWS` :63-90, `Scale` :93-101,
`GeneralizedAttention` :104-233; parity: mmdet/ops/{conv_ws,
context_block, non_local, generalized_attention, scale}.py).  The
reference writes them as XLA code, so they are plain PyTorch here: the
attention's energy is materialised and reduced by einsum, as there.

The modules take and return NCHW maps (inside the ResNet those are
views of NHWC memory).  Submodule and parameter names follow the
reference's parameter tree, so `aidet_tpu_torch.convert` maps weights
one to one: a flax LayerNorm's ``scale`` and `Scale`'s ``scale`` land
on ``weight``, the attention's raw ``appr_bias``, ``geom_bias`` and
``gamma`` keep their names.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


class ConvWS(nn.Conv2d):
    """Weight-standardised conv (configs/gn+ws): each output channel's
    kernel minus its mean over (in, kh, kw), over its population std
    plus 1e-5 (the reference adds the epsilon to the std, not to the
    variance)."""

    def forward(self, x):
        w = self.weight
        mean = w.mean(dim=(1, 2, 3), keepdim=True)
        std = w.std(dim=(1, 2, 3), keepdim=True, unbiased=False) + 1e-5
        return self._conv_forward(x, (w - mean) / std, self.bias)


class Scale(nn.Module):
    """A learnable scalar multiplier (``weight``, the reference's
    ``scale``)."""

    def __init__(self, init_value: float = 1.0):
        super().__init__()
        self.weight = nn.Parameter(torch.tensor(float(init_value)))

    def forward(self, x):
        return x * self.weight


class ContextBlock(nn.Module):
    """GCNet's global-context block: a context vector pooled by a
    softmax attention over the positions (``pooling_type="att"``) or
    by the mean ("avg"), through a 1x1 bottleneck of ``ratio`` * C
    channels with flax's LayerNorm (over the channels, epsilon 1e-6),
    added to every position."""

    def __init__(self, channels: int, ratio: float = 1.0 / 16,
                 pooling_type: str = "att"):
        super().__init__()
        if pooling_type not in ("att", "avg"):
            raise ValueError(f"pooling_type {pooling_type!r}: 'att' or "
                             "'avg'")
        planes = max(int(channels * ratio), 1)
        self.pooling_type = pooling_type
        if pooling_type == "att":
            self.conv_mask = nn.Conv2d(channels, 1, 1)
        self.channel_add_conv1 = nn.Conv2d(channels, planes, 1)
        self.ln = nn.LayerNorm(planes, eps=1e-6)
        self.channel_add_conv2 = nn.Conv2d(planes, channels, 1)
        self.init_prior()

    @torch.no_grad()
    def init_prior(self):
        """The reference's zero kernel of ``channel_add_conv2``: the
        block starts as the identity."""
        self.channel_add_conv2.weight.zero_()

    def forward(self, x):
        b, c = x.shape[:2]
        if self.pooling_type == "att":
            att = torch.softmax(self.conv_mask(x).reshape(b, -1), dim=1)
            ctx = torch.einsum("bcn,bn->bc", x.reshape(b, c, -1), att)
        else:
            ctx = x.mean(dim=(2, 3))
        t = self.channel_add_conv1(ctx[:, :, None, None])
        t = F.relu(self.ln(t.permute(0, 2, 3, 1)).permute(0, 3, 1, 2))
        return x + self.channel_add_conv2(t)


class NonLocal2D(nn.Module):
    """The non-local block (embedded Gaussian, no scaling of the
    product): C / ``reduction`` channels for theta, phi and g, a
    softmax over the positions, then ``conv_out`` back to C, added to
    the input."""

    def __init__(self, channels: int, reduction: int = 2):
        super().__init__()
        inter = max(channels // reduction, 1)
        self.theta = nn.Conv2d(channels, inter, 1)
        self.phi = nn.Conv2d(channels, inter, 1)
        self.g = nn.Conv2d(channels, inter, 1)
        self.conv_out = nn.Conv2d(inter, channels, 1)
        self.init_prior()

    @torch.no_grad()
    def init_prior(self):
        """The reference's zero kernel of ``conv_out``."""
        self.conv_out.weight.zero_()

    def forward(self, x):
        b, _, h, w = x.shape
        theta = self.theta(x).flatten(2)             # [B, I, N]
        phi = self.phi(x).flatten(2)
        g = self.g(x).flatten(2)
        att = torch.softmax(torch.einsum("bcn,bcm->bnm", theta, phi), -1)
        y = torch.einsum("bnm,bcm->bcn", att, g).reshape(b, -1, h, w)
        return x + self.conv_out(y)


def position_embedding(n_q: int, n_kv: int, q_stride: int, kv_stride: int,
                       feat_dim: int, magnitude: float, device=None):
    """The sinusoidal relative-position embedding along one axis
    [n_q, n_kv, 2 * (feat_dim // 4)]: the offset between query i * q_stride
    and key j * kv_stride (times ``magnitude``) over 1000 ** (4 / feat_dim
    * f), sines then cosines."""
    q_idx = torch.arange(n_q, dtype=torch.float32, device=device) * q_stride
    kv_idx = torch.arange(n_kv, dtype=torch.float32,
                          device=device) * kv_stride
    diff = (q_idx[:, None] - kv_idx[None, :]) * magnitude
    feat_range = torch.arange(feat_dim // 4, dtype=torch.float32,
                              device=device)
    dim_mat = torch.pow(torch.tensor(1000.0, device=device),
                        (4.0 / feat_dim) * feat_range)
    phase = diff[..., None] / dim_mat
    return torch.cat([torch.sin(phase), torch.cos(phase)], -1)


def spatial_range_mask(h, w, h_kv, w_kv, q_stride, kv_stride,
                       spatial_range, device=None):
    """[h, w, h_kv, w_kv] bool: the keys within ``spatial_range`` of each
    query (in input pixels), as the reference's integer arithmetic."""
    def ok(n_q, n_kv):
        q = torch.arange(n_q, device=device)[:, None] * q_stride
        kv = torch.arange(n_kv, device=device)[None, :]
        lo = torch.div(q - spatial_range, kv_stride,
                       rounding_mode="floor").clamp(min=0)
        hi = torch.div(q + spatial_range + 1, kv_stride,
                       rounding_mode="floor") + 1
        return (kv >= lo) & (kv < hi)
    return ok(h, h_kv)[:, None, :, None] & ok(w, w_kv)[None, :, None, :]


class GeneralizedAttention(nn.Module):
    """Generalized (empirical) attention.

    Multi-head attention of each query position (every ``q_stride``-th)
    over a key grid of every ``kv_stride``-th position, whose energy
    sums the terms ``attention_type`` switches on: '1000' query and key
    content, '0100' query and relative position, '0010' key content
    alone (``appr_bias``), '0001' relative position alone
    (``geom_bias``).  The position terms are separable: an x term over
    (w, w_kv) and a y term over (h, h_kv), each through its own linear
    (``appr_geom_fc_x``, ``_y``) of the sinusoidal embedding, scaled by
    1 / sqrt(2).  ``spatial_range`` >= 0 masks the keys farther than
    that from the query (energy -inf).  The result, through
    ``proj_conv``, is added to the input times ``gamma``, which starts
    at zero.  As in the reference, a ``q_stride`` that shrinks the map
    gives an output that does not add to the input: a TypeError.
    """

    def __init__(self, in_dim: int = 256, spatial_range: int = -1,
                 num_heads: int = 9, position_embedding_dim: int = -1,
                 position_magnitude: float = 1.0, kv_stride: int = 2,
                 q_stride: int = 1, attention_type: str = "1111"):
        super().__init__()
        if len(attention_type) != 4 or set(attention_type) - {"0", "1"}:
            raise ValueError(f"attention_type {attention_type!r}: four "
                             "0/1 flags")
        self.terms = [c == "1" for c in attention_type]
        self.num_heads = num_heads
        self.qk_dim = in_dim // num_heads
        self.spatial_range = spatial_range
        self.pe_dim = (position_embedding_dim if position_embedding_dim > 0
                       else in_dim)
        self.position_magnitude = position_magnitude
        self.kv_stride = kv_stride
        self.q_stride = q_stride
        width = num_heads * self.qk_dim
        content, query_geom, key_bias, geom_bias = self.terms
        if content or query_geom:
            self.query_conv = nn.Conv2d(in_dim, width, 1, bias=False)
        if content or key_bias:
            self.key_conv = nn.Conv2d(in_dim, width, 1, bias=False)
            self.appr_bias = nn.Parameter(torch.zeros(width))
        if query_geom or geom_bias:
            emb = 2 * (self.pe_dim // 4)
            self.appr_geom_fc_x = nn.Linear(emb, width, bias=False)
            self.appr_geom_fc_y = nn.Linear(emb, width, bias=False)
            self.geom_bias = nn.Parameter(torch.zeros(width))
        self.value_conv = nn.Conv2d(in_dim, width, 1, bias=False)
        self.proj_conv = nn.Conv2d(width, in_dim, 1)
        self.gamma = nn.Parameter(torch.zeros(()))
        self.init_seeded(None)

    @torch.no_grad()
    def init_seeded(self, generator):
        """The reference's draws of ``appr_bias`` and ``geom_bias``, U(0,
        2 / sqrt(2 * qk_dim)), from ``generator``; ``gamma`` stays 0."""
        bound = 2.0 / math.sqrt(self.qk_dim * 2)
        for name in ("appr_bias", "geom_bias"):
            if hasattr(self, name):
                p = getattr(self, name)
                device = p.device if generator is None else generator.device
                p.copy_(torch.rand(p.shape, generator=generator,
                                   device=device) * bound)

    def _heads(self, conv, x):
        """A 1x1 conv of NCHW x as [n, h, w, heads, d]."""
        y = conv(x).permute(0, 2, 3, 1)
        return y.reshape(y.shape[:3] + (self.num_heads, self.qk_dim))

    def _geometry(self, fc, n_q, n_kv, device):
        emb = position_embedding(n_q, n_kv, self.q_stride, self.kv_stride,
                                 self.pe_dim, self.position_magnitude,
                                 device).to(fc.weight.dtype)
        out = fc(emb) / math.sqrt(2.0)
        return out.reshape(n_q, n_kv, self.num_heads, self.qk_dim)

    def forward(self, x):
        content, query_geom, key_bias, geom_bias = self.terms
        heads, d = self.num_heads, self.qk_dim
        x_q = x[:, :, ::self.q_stride, ::self.q_stride]
        x_kv = x[:, :, ::self.kv_stride, ::self.kv_stride]
        n, _, h, w = x_q.shape
        h_kv, w_kv = x_kv.shape[2:]
        energy = x.new_zeros((n, heads, h, w, h_kv, w_kv),
                             dtype=torch.float32)
        q = (self._heads(self.query_conv, x_q) if content or query_geom
             else None)
        if content or key_bias:
            k = self._heads(self.key_conv, x_kv)
            appr = self.appr_bias.reshape(heads, d)
            if content:
                qq = q + appr if key_bias else q
                energy = energy + torch.einsum("nhwad,nHWad->nahwHW", qq, k)
            else:
                energy = energy + torch.einsum(
                    "ad,nHWad->naHW", appr, k)[:, :, None, None]
        if query_geom or geom_bias:
            px = self._geometry(self.appr_geom_fc_x, w, w_kv, x.device)
            py = self._geometry(self.appr_geom_fc_y, h, h_kv, x.device)
            geom = self.geom_bias.reshape(heads, d)
            if query_geom:
                qg = q + geom if geom_bias else q
                energy = energy + torch.einsum(
                    "nhwad,wWad->nahwW", qg, px)[..., None, :]
                energy = energy + torch.einsum(
                    "nhwad,hHad->nahwH", qg, py)[..., None]
            else:
                ex = torch.einsum("wWad,ad->awW", px, geom)
                ey = torch.einsum("hHad,ad->ahH", py, geom)
                energy = energy + ex[None, :, None, :, None, :]
                energy = energy + ey[None, :, :, None, :, None]
        if self.spatial_range >= 0:
            ok = spatial_range_mask(h, w, h_kv, w_kv, self.q_stride,
                                    self.kv_stride, self.spatial_range,
                                    x.device)
            energy = energy.masked_fill(~ok, float("-inf"))
        attn = torch.softmax(energy.reshape(n, heads, h, w, h_kv * w_kv), -1)
        v = self._heads(self.value_conv, x_kv).reshape(n, h_kv * w_kv,
                                                       heads, d)
        out = torch.einsum("nahwK,nKad->nhwad", attn.to(v.dtype), v)
        out = self.proj_conv(out.reshape(n, h, w, heads * d)
                             .permute(0, 3, 1, 2))
        if out.shape != x.shape:
            raise TypeError(f"GeneralizedAttention: the {tuple(out.shape)} "
                            f"output of q_stride {self.q_stride} does not "
                            f"add to the {tuple(x.shape)} input (as in the "
                            "reference)")
        return self.gamma * out + x
