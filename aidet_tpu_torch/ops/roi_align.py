"""Multi-level RoIAlign: level routing, the plain PyTorch version, and
the wrappers of the hand-written CUDA kernels K1 and K2.

Ports `aidet_tpu/ops/roi_align.py` (`map_roi_levels`,
`batched_multilevel_roi_align`) and replaces two TPU kernels:

- K1, `aidet_tpu/ops/roi_align_band.py::roi_align_band` (predict), by
  `csrc/roi_align.cu`;
- K2, `aidet_tpu/ops/roi_align_pallas.py::roi_align_pallas` with its
  custom_vjp (training), by `RoIAlignFunction`: its forward launches
  the same CUDA forward as K1 (the function is the same; the TPU
  kernels' window and band split is a caching layout), its backward
  the CUDA kernel of `csrc/roi_align_backward.cu`.

Feature maps are NHWC `[B, H_l, W_l, C]`, rois `[B, R, 4]` (x1, y1,
x2, y2) in image pixels, crops `[B, R, s, s, C]`.

`roi_align_forward` is the one entry point: on CPU tensors it runs the
plain version (differentiable through autograd: its gradient is the
plain backward), on CUDA tensors it launches the kernels (and raises
on anything they do not take): K1 when no gradient is wanted, else
`RoIAlignFunction`.  Level routing is plain torch in all cases.
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from ..cuda_build import BuildResult, build_shared_library

CSRC = Path(__file__).resolve().parents[1] / "csrc"

# the TPU kernels' window (aidet_tpu/ops/roi_align_pallas.py): rois are
# bumped to coarser levels until their span fits WIN_Y x WIN_X, with
# ALIGN - 1 columns of the x window lost to the DMA alignment
WIN_Y = 32
WIN_X = 48
ALIGN = 16


def map_roi_levels(rois: torch.Tensor, num_levels: int,
                   finest_scale: int = 56) -> torch.Tensor:
    """Pyramid level per roi [K, 4]:
    floor(log2(sqrt(area) / finest_scale + 1e-6)), clamped (int32)."""
    scale = torch.sqrt((rois[:, 2] - rois[:, 0] + 1.0)
                       * (rois[:, 3] - rois[:, 1] + 1.0))
    lvl = torch.floor(torch.log2(scale / finest_scale + 1e-6))
    return lvl.clamp(0, num_levels - 1).to(torch.int32)


def route_rois(rois: torch.Tensor, level_hw, featmap_strides,
               finest_scale: int = 56, bump_to_window: bool = False):
    """Level per roi [K] (int32).

    bump_to_window=False is the routing of `map_roi_levels`, which the
    reference's XLA RoIAlign, its Pallas kernels' backward and mmdet
    use.  bump_to_window=True reproduces the TPU kernels' forward
    (`roi_align_pallas._prepare`): a roi moves one level coarser at a
    time until its span fits the 32 x 48 window, so that K1 can be held
    to `roi_align_band`.
    """
    num_levels = len(featmap_strides)
    lvls = map_roi_levels(rois, num_levels, finest_scale).long()
    if not bump_to_window:
        return lvls.to(torch.int32)
    strides = rois.new_tensor(featmap_strides)
    win_ys = rois.new_tensor([min(WIN_Y, h) for h, _ in level_hw])
    win_xs = rois.new_tensor([min(WIN_X, w) for _, w in level_hw])
    h_px = rois[:, 3] - rois[:, 1]
    w_px = rois[:, 2] - rois[:, 0]
    for _ in range(num_levels - 1):
        inv_l = 1.0 / strides[lvls]
        fit_y = h_px * inv_l <= win_ys[lvls] - 2
        fit_x = w_px * inv_l <= win_xs[lvls] - ALIGN - 1
        fits = (fit_y & fit_x) | (lvls >= num_levels - 1)
        lvls = torch.where(fits, lvls, lvls + 1)
    return lvls.to(torch.int32)


def batched_multilevel_roi_align(feats, rois_b, out_size=7,
                                 featmap_strides=(4, 8, 16, 32),
                                 sampling_ratio=2, finest_scale=56,
                                 aligned=True, bump_to_window=False):
    """Plain PyTorch multi-level RoIAlign (the version K1 is held to).

    All levels of the batch flatten into one [B * sum(HW), C] table and
    every sample's four bilinear corners are gathered from it, computed
    in float32 (float64 for float64 features); the result is cast to
    the features' dtype.  Its autograd gradient with respect to the
    features is the plain version of K2's backward: the cotangent cast
    to the compute dtype, scattered and summed there, and cast once to
    the features' dtype, as the reference's linear transpose.
    Returns [B, R, out_size, out_size, C].
    """
    feats = list(feats)
    if len(feats) != len(featmap_strides):
        raise ValueError(f"{len(feats)} levels for "
                         f"{len(featmap_strides)} strides")
    b, r = rois_b.shape[:2]
    c = feats[0].shape[-1]
    dev = rois_b.device
    compute = torch.promote_types(feats[0].dtype, torch.float32)
    rois = rois_b.reshape(b * r, 4).to(compute)
    level_hw = [tuple(f.shape[1:3]) for f in feats]
    lvls = route_rois(rois, level_hw, featmap_strides, finest_scale,
                      bump_to_window).long()

    hs = torch.tensor([h for h, _ in level_hw], dtype=torch.float32,
                      device=dev)
    ws = torch.tensor([w for _, w in level_hw], dtype=torch.float32,
                      device=dev)
    sizes = [h * w for h, w in level_hw]
    level_off = torch.tensor([sum(sizes[:i]) for i in range(len(sizes))],
                             dtype=torch.long, device=dev)
    table = torch.cat([f.reshape(b, -1, c) for f in feats],
                      1).reshape(-1, c).to(compute)
    img_off = torch.arange(b, device=dev).repeat_interleave(r) * sum(sizes)
    base = (img_off + level_off[lvls])[:, None, None]

    stride = torch.tensor(featmap_strides, dtype=torch.float32,
                          device=dev)[lvls]
    h_l = hs[lvls][:, None, None]
    w_l = ws[lvls][:, None, None]
    offset = 0.5 if aligned else 0.0
    inv = 1.0 / stride
    x1 = rois[:, 0] * inv - offset
    y1 = rois[:, 1] * inv - offset
    roi_w = rois[:, 2] * inv - offset - x1
    roi_h = rois[:, 3] * inv - offset - y1
    if not aligned:   # v1 clamps the size at 1; aligned mode does not
        roi_w = roi_w.clamp(min=1.0)
        roi_h = roi_h.clamp(min=1.0)

    s = sampling_ratio
    n_pts = out_size * s
    k = b * r
    grid = (torch.arange(n_pts, dtype=torch.float32, device=dev) + 0.5) / s
    ys = y1[:, None] + grid[None] * (roi_h / out_size)[:, None]
    xs = x1[:, None] + grid[None] * (roi_w / out_size)[:, None]
    yy = ys[:, :, None].expand(k, n_pts, n_pts)
    xx = xs[:, None, :].expand(k, n_pts, n_pts)
    oob = (yy < -1.0) | (yy > h_l) | (xx < -1.0) | (xx > w_l)
    y = torch.minimum(yy.clamp(min=0.0), h_l - 1)
    x = torch.minimum(xx.clamp(min=0.0), w_l - 1)
    y0 = torch.floor(y)
    x0 = torch.floor(x)
    y1i = torch.minimum(y0 + 1, h_l - 1)
    x1i = torch.minimum(x0 + 1, w_l - 1)
    ly = (y - y0)[..., None]
    lx = (x - x0)[..., None]

    def take(yi, xi):
        return table[base + (yi * w_l + xi).long()]

    out = (take(y0, x0) * (1 - ly) * (1 - lx)
           + take(y0, x1i) * (1 - ly) * lx
           + take(y1i, x0) * ly * (1 - lx)
           + take(y1i, x1i) * ly * lx)
    out = torch.where(oob[..., None], 0.0, out)
    out = out.reshape(k, out_size, s, out_size, s, c).mean(dim=(2, 4))
    return out.reshape(b, r, out_size, out_size, c).to(feats[0].dtype)


class _KernelLibrary:
    """ctypes handle on one kernel library of `csrc/`, built with nvcc
    at first use.  ``launches`` counts the launches made through this
    handle, and nothing else; two handles may share one library."""

    _VEC = {torch.bfloat16: 8, torch.float32: 4}
    _DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

    def __init__(self, source: Path, symbol: str, argtypes):
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self.build: BuildResult | None = None
        self._fn = None

    def load(self, build: BuildResult | None = None) -> BuildResult:
        """Load the library, from ``build`` if given (a build of this
        handle's source), else built or found by `build_shared_library`."""
        if self._fn is None:
            build = build or build_shared_library(self.source)
            lib = ctypes.CDLL(str(build.path))
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._lib, self._fn, self.build = lib, fn, build
        return self.build

    def _launch(self, name, *args):
        self.load()
        err = self._fn(*args)
        if err != 0:
            raise RuntimeError(f"{name} launch failed: CUDA error {err}")
        self.launches += 1

    @staticmethod
    def _level_args(shapes, featmap_strides):
        """(h0, w0, .., h3, w3, st0, .., st3) with unused levels 0 / 1."""
        n = len(shapes)
        hw = []
        for j in range(4):
            hw += list(shapes[j][1:3]) if j < n else [0, 0]
        return hw + list(featmap_strides) + [1] * (4 - n)


_I, _P = ctypes.c_int, ctypes.c_void_p


class RoIAlignKernel(_KernelLibrary):
    """The CUDA RoIAlign forward (`csrc/roi_align.cu`): K1 on the
    predict path, and K2's forward inside `RoIAlignFunction`."""

    def __init__(self):
        super().__init__(CSRC / "roi_align.cu", "aidet_roi_align_forward",
                         [_I, _I] + [_P] * 4 + [_I] * 8 + [_I] * 4
                         + [_I, _I] + [_P] * 3 + [_I] * 4 + [_P, _P])

    def check(self, feats, rois_b, featmap_strides, out_size,
              sampling_ratio):
        """Raise on anything the kernel does not take."""
        if not 1 <= len(feats) <= 4 or len(feats) != len(featmap_strides):
            raise ValueError("the kernels take 1 to 4 levels, one per "
                             f"stride; got {len(feats)} levels, "
                             f"{len(featmap_strides)} strides")
        dev, dtype = rois_b.device, feats[0].dtype
        if dev.type != "cuda":
            raise ValueError(f"the kernels need CUDA tensors, rois are on "
                             f"{dev}")
        if dtype not in self._VEC:
            raise TypeError(f"the kernels take bfloat16 or float32 "
                            f"features, not {dtype}")
        if rois_b.dtype != torch.float32 or rois_b.dim() != 3 \
                or rois_b.shape[-1] != 4:
            raise ValueError("rois must be float32 [B, R, 4], got "
                             f"{rois_b.dtype} {tuple(rois_b.shape)}")
        b, c = rois_b.shape[0], feats[0].shape[-1]
        if c % self._VEC[dtype]:
            raise ValueError(f"the kernels read {self._VEC[dtype]} "
                             f"channels per 16-byte vector; C={c} is not "
                             "a multiple")
        for f in feats:
            if f.device != dev or f.dtype != dtype:
                raise ValueError("all levels must share the rois' device "
                                 "and one dtype")
            if f.dim() != 4 or f.shape[0] != b or f.shape[-1] != c:
                raise ValueError("levels must be [B, H, W, C] with the "
                                 f"rois' B={b} and one C; got "
                                 f"{tuple(f.shape)}")
            if not f.is_contiguous() or f.data_ptr() % 16:
                raise ValueError("levels must be contiguous NHWC and "
                                 "16-byte aligned")
        if not 1 <= out_size <= 32 or sampling_ratio < 1:
            raise ValueError(f"out_size {out_size} not in [1, 32] or "
                             f"sampling_ratio {sampling_ratio} < 1")
        if rois_b.shape[0] * rois_b.shape[1] * out_size >= 2 ** 31:
            raise ValueError("too many rois for one launch")

    def __call__(self, feats, rois, bidx, lvls, out, featmap_strides,
                 sampling_ratio, aligned):
        """Launch on the current stream; rois [K, 4] f32, bidx/lvls [K]
        int32, out [K, s, s, C] (all contiguous, on the card)."""
        ptrs = [f.data_ptr() for f in feats] + [None] * (4 - len(feats))
        stream = torch.cuda.current_stream(rois.device).cuda_stream
        self._launch(
            "roi_align forward", rois.device.index,
            self._DTYPE_CODE[feats[0].dtype], *ptrs,
            *self._level_args([f.shape for f in feats], featmap_strides),
            len(feats), feats[0].shape[-1], rois.data_ptr(),
            bidx.data_ptr(), lvls.data_ptr(), rois.shape[0], out.shape[1],
            sampling_ratio, int(aligned), out.data_ptr(), stream)
        return out


class RoIAlignBackwardKernel(_KernelLibrary):
    """K2's backward (`csrc/roi_align_backward.cu`): the features'
    gradient from grad_out, summed in one float32 table for all levels
    and cast once to the features' dtype."""

    def __init__(self):
        super().__init__(CSRC / "roi_align_backward.cu",
                         "aidet_roi_align_backward",
                         [_I, _I, _P, ctypes.c_longlong, _P] + [_I] * 8
                         + [_I] * 4 + [_I] * 3 + [_P] * 3 + [_I] * 4
                         + [_P, _P])

    def __call__(self, grad_out, rois, bidx, lvls, level_shapes,
                 featmap_strides, sampling_ratio, aligned):
        """grad_out [K, s, s, C] (bfloat16 or float32, the features'
        dtype), rois [K, 4] f32, bidx/lvls [K] int32 as for the
        forward, level_shapes the levels' [B, H, W, C].  Returns the
        levels' gradients, [B, H, W, C] each in grad_out's dtype."""
        dtype = grad_out.dtype
        if grad_out.device.type != "cuda" or rois.device != grad_out.device:
            raise ValueError("the backward needs grad_out and rois on one "
                             f"CUDA device, not {grad_out.device} and "
                             f"{rois.device}")
        if dtype not in self._VEC:
            raise TypeError(f"the backward takes bfloat16 or float32 "
                            f"gradients, not {dtype}")
        k, s = rois.shape[0], grad_out.shape[1]
        c = level_shapes[0][-1]
        if tuple(grad_out.shape) != (k, s, s, c) or c % self._VEC[dtype]:
            raise ValueError(f"grad_out {tuple(grad_out.shape)} is not "
                             f"[{k}, s, s, {c}] with C a multiple of "
                             f"{self._VEC[dtype]}")
        if not grad_out.is_contiguous() or grad_out.data_ptr() % 16:
            raise ValueError("grad_out must be contiguous and 16-byte "
                             "aligned")
        sizes = [math.prod(shape) for shape in level_shapes]
        total = sum(sizes)
        dev = grad_out.device
        table = torch.empty(total, dtype=torch.float32, device=dev)
        grads = (table if dtype == torch.float32
                 else torch.empty(total, dtype=dtype, device=dev))
        stream = torch.cuda.current_stream(dev).cuda_stream
        self._launch(
            "roi_align backward", dev.index, self._DTYPE_CODE[dtype],
            table.data_ptr(), total,
            None if grads is table else grads.data_ptr(),
            *self._level_args(level_shapes, featmap_strides),
            len(level_shapes), level_shapes[0][0], c, rois.data_ptr(),
            bidx.data_ptr(), lvls.data_ptr(), k, s, sampling_ratio,
            int(aligned), grad_out.data_ptr(), stream)
        return [g.view(shape) for g, shape in
                zip(grads.split(sizes), level_shapes)]


# K1 on the predict path; the same CUDA forward counted apart as K2's
# forward on the train path; K2's backward
roi_align_kernel = RoIAlignKernel()
roi_align_train_kernel = RoIAlignKernel()
roi_align_backward_kernel = RoIAlignBackwardKernel()


class RoIAlignFunction(torch.autograd.Function):
    """K2: the multi-level RoIAlign with a gradient for the features.

    Forward: the CUDA forward (counted on `roi_align_train_kernel`).
    Backward: `roi_align_backward_kernel` with the forward's rois and
    routing, so both directions route alike (without the TPU kernels'
    window bump by default), which makes the gradient the reference's
    linear transpose.  The rois get no gradient (the reference's _bwd
    returns zeros for them).
    """

    @staticmethod
    def forward(ctx, rois, bidx, lvls, out_size, featmap_strides,
                sampling_ratio, aligned, *feats):
        out = torch.empty((rois.shape[0], out_size, out_size,
                           feats[0].shape[-1]), dtype=feats[0].dtype,
                          device=rois.device)
        roi_align_train_kernel(feats, rois, bidx, lvls, out,
                               featmap_strides, sampling_ratio, aligned)
        ctx.save_for_backward(rois, bidx, lvls)
        ctx.level_shapes = [tuple(f.shape) for f in feats]
        ctx.config = (featmap_strides, sampling_ratio, aligned)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_out):
        rois, bidx, lvls = ctx.saved_tensors
        grads = roi_align_backward_kernel(
            grad_out.contiguous(), rois, bidx, lvls, ctx.level_shapes,
            *ctx.config)
        return (None,) * 7 + tuple(grads)


def roi_align_forward(feats, rois_b, out_size=7,
                      featmap_strides=(4, 8, 16, 32), sampling_ratio=2,
                      finest_scale=56, aligned=True, bump_to_window=False):
    """Batched multi-level RoIAlign: [B, R, out_size, out_size, C].

    On CPU tensors: the plain version.  On CUDA tensors, in the
    features' dtype (bfloat16 or float32), or an exception: K1 when no
    gradient is wanted (predict, under no_grad), else K2
    (`RoIAlignFunction`), whose backward is a CUDA kernel too.
    """
    feats = list(feats)
    devices = {f.device for f in feats} | {rois_b.device}
    if devices == {torch.device("cpu")}:
        return batched_multilevel_roi_align(
            feats, rois_b, out_size, featmap_strides, sampling_ratio,
            finest_scale, aligned, bump_to_window)
    roi_align_kernel.check(feats, rois_b, featmap_strides, out_size,
                           sampling_ratio)
    b, r = rois_b.shape[:2]
    rois = rois_b.detach().reshape(b * r, 4).contiguous()
    lvls = route_rois(rois, [tuple(f.shape[1:3]) for f in feats],
                      featmap_strides, finest_scale,
                      bump_to_window).contiguous()
    bidx = torch.arange(b, dtype=torch.int32,
                        device=rois.device).repeat_interleave(r)
    if torch.is_grad_enabled() and any(f.requires_grad for f in feats):
        out = RoIAlignFunction.apply(rois, bidx, lvls, out_size,
                                     tuple(featmap_strides), sampling_ratio,
                                     aligned, *feats)
    else:
        out = torch.empty((b * r, out_size, out_size, feats[0].shape[-1]),
                          dtype=feats[0].dtype, device=rois.device)
        roi_align_kernel(feats, rois, bidx, lvls, out, featmap_strides,
                         sampling_ratio, aligned)
    return out.reshape(b, r, out_size, out_size, -1)
