"""Rotated multi-level RoIAlign: level routing, the plain PyTorch
version, and the wrapper of the hand-written CUDA kernel K4.

Ports `aidet_tpu/ops/rroi_align.py` (`map_rroi_levels`,
`rroi_align_fused`, `batched_rroi_align`) and replaces the forward of
the TPU kernel `aidet_tpu/ops/rroi_align_pallas.py::rroi_align_pallas`
(K4) by `csrc/rroi_align.cu`.

Feature maps are NHWC `[B, H_l, W_l, C]`, rotated rois `[B, R, 5]`
(cx, cy, w, h, theta) in image pixels, theta in radians (any value:
the rotation is evaluated directly), crops `[B, R, s, s, C]`.  A P x P
bin grid is sampled in the roi's rotated frame, `sampling_ratio`^2
aligned bilinear samples per bin; a sample outside the map contributes
0 and still counts in the bin's mean.

`rroi_align_forward` is the entry point: on CPU tensors it runs the
plain version, on CUDA tensors it launches K4 (forward only; the
reference's backward is the XLA vjp, ported with the RRoI train step)
and raises on anything the kernel does not take.
"""

from __future__ import annotations

import torch

from .roi_align import ALIGN, CSRC, WIN_X, WIN_Y, _I, _KernelLibrary, _P


def map_rroi_levels(rrois: torch.Tensor, num_levels: int,
                    finest_scale: int = 56) -> torch.Tensor:
    """Pyramid level per rotated roi [K, 5] from sqrt(w * h):
    floor(log2(sqrt(max(wh, 1e-6)) / finest_scale + 1e-6)), clamped
    (int32)."""
    scale = torch.sqrt((rrois[:, 2] * rrois[:, 3]).clamp(min=1e-6))
    lvl = torch.floor(torch.log2(scale / finest_scale + 1e-6))
    return lvl.clamp(0, num_levels - 1).to(torch.int32)


def route_rrois(rrois: torch.Tensor, level_hw, featmap_strides,
                finest_scale: int = 56, bump_to_window: bool = False):
    """Level per rotated roi [K] (int32).

    bump_to_window=False is `map_rroi_levels`, the routing of the
    reference's XLA `batched_rroi_align`, which the RRoI detector runs.
    bump_to_window=True reproduces the TPU kernel's forward
    (`rroi_align_pallas._prepare_rot`): a roi moves one level coarser
    at a time until its rotated box's axis-aligned span fits the
    32 x 48 window, so that K4 can be held to `rroi_align_pallas`.
    """
    num_levels = len(featmap_strides)
    lvls = map_rroi_levels(rrois, num_levels, finest_scale).long()
    if not bump_to_window:
        return lvls.to(torch.int32)
    strides = rrois.new_tensor(featmap_strides)
    win_ys = rrois.new_tensor([min(WIN_Y, h) for h, _ in level_hw])
    win_xs = rrois.new_tensor([min(WIN_X, w) for _, w in level_hw])
    cw, ch, th = rrois[:, 2], rrois[:, 3], rrois[:, 4]
    cos, sin = torch.cos(th).abs(), torch.sin(th).abs()
    span_x = cw * cos + ch * sin
    span_y = cw * sin + ch * cos
    for _ in range(num_levels - 1):
        inv_l = 1.0 / strides[lvls]
        fits = ((span_y * inv_l <= win_ys[lvls] - 2)
                & (span_x * inv_l <= win_xs[lvls] - ALIGN - 1)
                | (lvls >= num_levels - 1))
        lvls = torch.where(fits, lvls, lvls + 1)
    return lvls.to(torch.int32)


def rroi_align_plain(feats, rrois, bidx, lvls, out_size, featmap_strides,
                     sampling_ratio=2, aligned=True):
    """The plain rotated RoIAlign of rois [K, 5] routed by the caller:
    image ``bidx`` [K], level ``lvls`` [K].  All levels of the batch
    flatten into one [B * sum(HW), C] table and every sample's four
    bilinear corners are gathered from it, in float32 (float64 for
    float64 features), as the reference's `rroi_align_fused`.  Returns
    [K, out_size, out_size, C] in the features' dtype."""
    c = feats[0].shape[-1]
    dev = rrois.device
    compute = torch.promote_types(feats[0].dtype, torch.float32)
    rrois = rrois.to(compute)
    lvls = lvls.long()
    level_hw = [tuple(f.shape[1:3]) for f in feats]
    hs = torch.tensor([h for h, _ in level_hw], dtype=compute, device=dev)
    ws = torch.tensor([w for _, w in level_hw], dtype=compute, device=dev)
    sizes = [h * w for h, w in level_hw]
    level_off = torch.tensor([sum(sizes[:i]) for i in range(len(sizes))],
                             dtype=torch.long, device=dev)
    table = torch.cat([f.reshape(f.shape[0], -1, c) for f in feats],
                      1).reshape(-1, c).to(compute)
    base = (bidx.long() * sum(sizes) + level_off[lvls])[:, None, None]

    ys, xs = sample_coords(rrois, lvls, featmap_strides, out_size,
                           sampling_ratio, aligned)
    s = sampling_ratio
    k = rrois.shape[0]

    h_l = hs[lvls][:, None, None]
    w_l = ws[lvls][:, None, None]
    oob = (ys < -1.0) | (ys > h_l) | (xs < -1.0) | (xs > w_l)
    y = torch.minimum(ys.clamp(min=0.0), h_l - 1)
    x = torch.minimum(xs.clamp(min=0.0), w_l - 1)
    y0 = torch.floor(y)
    x0 = torch.floor(x)
    y1 = torch.minimum(y0 + 1, h_l - 1)
    x1 = torch.minimum(x0 + 1, w_l - 1)
    ly = (y - y0)[..., None]
    lx = (x - x0)[..., None]

    def take(yi, xi):
        return table[base + (yi * w_l + xi).long()]

    out = (take(y0, x0) * (1 - ly) * (1 - lx)
           + take(y0, x1) * (1 - ly) * lx
           + take(y1, x0) * ly * (1 - lx)
           + take(y1, x1) * ly * lx)
    out = torch.where(oob[..., None], 0.0, out)
    out = out.reshape(k, out_size, s, out_size, s, c).mean(dim=(2, 4))
    return out.to(feats[0].dtype)


def sample_coords(rrois, lvls, featmap_strides, out_size, sampling_ratio=2,
                  aligned=True):
    """The bilinear sample points of rotated rois [K, 5] on their
    levels ``lvls``: (y, x) [K, n, n] in level pixels, n = out_size *
    sampling_ratio, before the out-of-map test and the clamp, in the
    rois' dtype."""
    dtype, dev = rrois.dtype, rrois.device
    inv = 1.0 / torch.tensor(featmap_strides, dtype=dtype,
                             device=dev)[lvls.long()]
    offset = 0.5 if aligned else 0.0
    cx = rrois[:, 0] * inv - offset
    cy = rrois[:, 1] * inv - offset
    rw = (rrois[:, 2] * inv).clamp(min=1e-3)
    rh = (rrois[:, 3] * inv).clamp(min=1e-3)
    # cos and sin rounded from float64: correctly rounded, as XLA's
    # float32 ones nearly always are (torch's float32 ones are within an
    # ulp); one ulp moves a sample by up to 1e-5 px on the coarse levels
    theta = rrois[:, 4].double()
    cos_t = torch.cos(theta).to(dtype)[:, None, None]
    sin_t = torch.sin(theta).to(dtype)[:, None, None]
    n_pts = out_size * sampling_ratio
    k = rrois.shape[0]
    grid = (torch.arange(n_pts, dtype=dtype, device=dev) + 0.5) \
        / sampling_ratio
    # local (unrotated) sample offsets from the roi centre; XLA folds
    # the reference's grid / out_size into a product with 1 / out_size
    frac = grid * (1.0 / out_size) - 0.5
    yy = (frac[None, :] * rh[:, None])[:, :, None].expand(k, n_pts, n_pts)
    xx = (frac[None, :] * rw[:, None])[:, None, :].expand(k, n_pts, n_pts)
    xs = cx[:, None, None] + xx * cos_t - yy * sin_t
    ys = cy[:, None, None] + xx * sin_t + yy * cos_t
    return ys, xs


def batched_rroi_align(feats, rrois_b, out_size=7,
                       featmap_strides=(4, 8, 16, 32), sampling_ratio=2,
                       finest_scale=56, aligned=True, bump_to_window=False):
    """Plain batched rotated RoIAlign (the version K4 is held to):
    levels [B, H_l, W_l, C], rrois_b [B, R, 5] -> [B, R, s, s, C] in
    the features' dtype."""
    feats = list(feats)
    if len(feats) != len(featmap_strides):
        raise ValueError(f"{len(feats)} levels for "
                         f"{len(featmap_strides)} strides")
    b, r = rrois_b.shape[:2]
    compute = torch.promote_types(feats[0].dtype, torch.float32)
    rrois = rrois_b.reshape(b * r, 5).to(compute)
    lvls = route_rrois(rrois, [tuple(f.shape[1:3]) for f in feats],
                       featmap_strides, finest_scale, bump_to_window)
    bidx = torch.arange(b, device=rrois.device).repeat_interleave(r)
    out = rroi_align_plain(feats, rrois, bidx, lvls, out_size,
                           featmap_strides, sampling_ratio, aligned)
    return out.reshape((b, r) + out.shape[1:])


class RRoIAlignKernel(_KernelLibrary):
    """K4 (`csrc/rroi_align.cu`): the rotated RoIAlign forward, one
    block per (roi, bin row), samples gathered directly."""

    def __init__(self):
        super().__init__(CSRC / "rroi_align.cu", "aidet_rroi_align_forward",
                         [_I, _I] + [_P] * 4 + [_I] * 8 + [_I] * 4
                         + [_I, _I] + [_P] * 3 + [_I] * 4 + [_P, _P])

    def __call__(self, feats, rrois, bidx, lvls, out, featmap_strides,
                 sampling_ratio, aligned):
        """Launch on the current stream; rrois [K, 5] f32, bidx/lvls [K]
        int32, out [K, s, s, C] (all contiguous, on the card)."""
        ptrs = [f.data_ptr() for f in feats] + [None] * (4 - len(feats))
        stream = torch.cuda.current_stream(rrois.device).cuda_stream
        self._launch(
            "rroi_align forward", rrois.device.index,
            self._DTYPE_CODE[feats[0].dtype], *ptrs,
            *self._level_args([f.shape for f in feats], featmap_strides),
            len(feats), feats[0].shape[-1], rrois.data_ptr(),
            bidx.data_ptr(), lvls.data_ptr(), rrois.shape[0], out.shape[1],
            sampling_ratio, int(aligned), out.data_ptr(), stream)
        return out


rroi_align_kernel = RRoIAlignKernel()


def rroi_align_forward(feats, rrois_b, out_size=7,
                       featmap_strides=(4, 8, 16, 32), sampling_ratio=2,
                       finest_scale=56, aligned=True, bump_to_window=False):
    """Batched rotated RoIAlign, forward only: [B, R, out_size,
    out_size, C].  On CPU tensors: the plain version.  On CUDA tensors,
    in the features' dtype (bfloat16 or float32), or an exception: the
    rois are routed by plain torch and K4 launches once."""
    feats = list(feats)
    devices = {f.device for f in feats} | {rrois_b.device}
    if devices == {torch.device("cpu")}:
        return batched_rroi_align(feats, rrois_b, out_size, featmap_strides,
                                  sampling_ratio, finest_scale, aligned,
                                  bump_to_window)
    if torch.is_grad_enabled() and any(f.requires_grad for f in feats):
        raise ValueError("the rotated RoIAlign kernel (K4) is forward "
                         "only; its backward comes with the RRoI train "
                         "step")
    rroi_align_kernel.check(feats, rrois_b, featmap_strides, out_size,
                            sampling_ratio, roi_dim=5)
    b, r = rrois_b.shape[:2]
    c = feats[0].shape[-1]
    out = torch.empty((b * r, out_size, out_size, c), dtype=feats[0].dtype,
                      device=rrois_b.device)
    if b * r:
        rrois = rrois_b.detach().reshape(b * r, 5).contiguous()
        lvls = route_rrois(rrois, [tuple(f.shape[1:3]) for f in feats],
                           featmap_strides, finest_scale,
                           bump_to_window).contiguous()
        bidx = torch.arange(b, dtype=torch.int32,
                            device=rrois.device).repeat_interleave(r)
        rroi_align_kernel(feats, rrois, bidx, lvls, out, featmap_strides,
                          sampling_ratio, aligned)
    return out.reshape(b, r, out_size, out_size, c)

