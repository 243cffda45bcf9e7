"""Multi-level RoIAlign: level routing, the plain PyTorch version, and
the wrappers of the hand-written CUDA kernels K1, K2 and K3.

Ports `aidet_tpu/ops/roi_align.py` (`map_roi_levels`,
`batched_multilevel_roi_align`, `multilevel_roi_align_fused` :142 and
`roi_rescale` :315) and replaces three TPU kernels:

- K1, `aidet_tpu/ops/roi_align_band.py::roi_align_band` (predict), by
  `csrc/roi_align.cu`;
- K2, `aidet_tpu/ops/roi_align_pallas.py::roi_align_pallas` with its
  custom_vjp (training), by `RoIAlignFunction`: its forward launches
  the same CUDA forward as K1 (the function is the same; the TPU
  kernels' window and band split is a caching layout), its backward
  the CUDA kernel of `csrc/roi_align_backward.cu`;
- K3, `aidet_tpu/ops/roi_align_bandx.py::roi_align_bandx` (predict
  under AIDET_ROI_BAND=x), by `csrc/roi_align_bandx.cu` behind
  `roi_align_bandx_forward`: K1's function, computed chunk by chunk of
  rois that share an (image, level, band) key, planned on the card
  (`bandx_chunks` is the plan's plain twin).

Feature maps are NHWC `[B, H_l, W_l, C]`, rois `[B, R, 4]` (x1, y1,
x2, y2) in image pixels, crops `[B, R, s, s, C]`.

`roi_align_forward` is the entry point of K1 and K2 (and
`multilevel_roi_align_fused`, its single-image form): on CPU tensors it
runs the plain version (differentiable through autograd: its gradient
is the plain backward), on CUDA tensors it launches the kernels (and
raises on anything they do not take): K1 when no gradient is wanted,
else `RoIAlignFunction`.  `roi_align_bandx_forward` is K3's, forward
only.  Level routing is plain torch in all cases.  A
``roi_scale_factor`` scales each roi about its centre after its level
is chosen from its own size (`roi_rescale`; the reference's
SingleRoIExtractor order).
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import NamedTuple, Optional

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


def roi_rescale(rois: torch.Tensor, scale_factor: float) -> torch.Tensor:
    """Rois [K, 4] scaled by ``scale_factor`` about their centres, in the
    inclusive-pixel convention (sizes x2 - x1 + 1)."""
    cx = (rois[:, 0] + rois[:, 2]) * 0.5
    cy = (rois[:, 1] + rois[:, 3]) * 0.5
    w = (rois[:, 2] - rois[:, 0] + 1.0) * scale_factor
    h = (rois[:, 3] - rois[:, 1] + 1.0) * scale_factor
    return torch.stack([cx - 0.5 * (w - 1), cy - 0.5 * (h - 1),
                        cx + 0.5 * (w - 1), cy + 0.5 * (h - 1)], dim=-1)


def batched_multilevel_roi_align(feats, rois_b, out_size=7,
                                 featmap_strides=(4, 8, 16, 32),
                                 sampling_ratio=2, finest_scale=56,
                                 aligned=True, bump_to_window=False,
                                 roi_scale_factor=None):
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
    compute = torch.promote_types(feats[0].dtype, torch.float32)
    rois = rois_b.reshape(b * r, 4).to(compute)
    lvls = route_rois(rois, [tuple(f.shape[1:3]) for f in feats],
                      featmap_strides, finest_scale, bump_to_window)
    if roi_scale_factor is not None:
        rois = roi_rescale(rois, roi_scale_factor)
    bidx = torch.arange(b, device=rois.device).repeat_interleave(r)
    out = roi_align_plain(feats, rois, bidx, lvls, out_size,
                          featmap_strides, sampling_ratio, aligned)
    return out.reshape((b, r) + out.shape[1:])


def roi_align_plain(feats, rois, bidx, lvls, out_size, featmap_strides,
                    sampling_ratio=2, aligned=True):
    """The plain RoIAlign of rois [K, 4] routed by the caller: image
    ``bidx`` [K], level ``lvls`` [K].  Each roi's result depends on its
    own inputs only, in any order.  Returns [K, out_size, out_size, C]
    in the features' dtype."""
    c = feats[0].shape[-1]
    dev = rois.device
    compute = torch.promote_types(feats[0].dtype, torch.float32)
    rois = rois.to(compute)
    lvls = lvls.long()
    level_hw = [tuple(f.shape[1:3]) for f in feats]
    hs = torch.tensor([h for h, _ in level_hw], dtype=torch.float32,
                      device=dev)
    ws = torch.tensor([w for _, w in level_hw], dtype=torch.float32,
                      device=dev)
    sizes = [h * w for h, w in level_hw]
    level_off = torch.tensor([sum(sizes[:i]) for i in range(len(sizes))],
                             dtype=torch.long, device=dev)
    table = torch.cat([f.reshape(f.shape[0], -1, c) for f in feats],
                      1).reshape(-1, c).to(compute)
    img_off = bidx.long() * sum(sizes)
    base = (img_off + level_off[lvls])[:, None, None]

    h_l = hs[lvls][:, None, None]
    w_l = ws[lvls][:, None, None]
    yy, xx = sample_coords(rois, lvls, featmap_strides, out_size,
                           sampling_ratio, aligned)
    s = sampling_ratio
    k = rois.shape[0]
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
    return out.to(feats[0].dtype)


def sample_coords(rois, lvls, featmap_strides, out_size, sampling_ratio=2,
                  aligned=True):
    """The bilinear sample points of rois [K, 4] on their levels
    ``lvls``: (y, x) [K, n, n] in level pixels, n = out_size *
    sampling_ratio, before the out-of-map test and the clamp."""
    lvls = lvls.long()
    stride = torch.tensor(featmap_strides, dtype=torch.float32,
                          device=rois.device)[lvls]
    offset = 0.5 if aligned else 0.0
    inv = 1.0 / stride
    x1 = rois[:, 0] * inv - offset
    y1 = rois[:, 1] * inv - offset
    roi_w = rois[:, 2] * inv - offset - x1
    roi_h = rois[:, 3] * inv - offset - y1
    if not aligned:   # v1 clamps the size at 1; aligned mode does not
        roi_w = roi_w.clamp(min=1.0)
        roi_h = roi_h.clamp(min=1.0)
    n_pts = out_size * sampling_ratio
    k = rois.shape[0]
    grid = (torch.arange(n_pts, dtype=torch.float32, device=rois.device)
            + 0.5) / sampling_ratio
    ys = y1[:, None] + grid[None] * (roi_h / out_size)[:, None]
    xs = x1[:, None] + grid[None] * (roi_w / out_size)[:, None]
    return (ys[:, :, None].expand(k, n_pts, n_pts),
            xs[:, None, :].expand(k, n_pts, n_pts))


# K3's grouping (aidet_tpu/ops/roi_align_bandx.py): a band starts every
# BAND_S rows of a level and is BAND_H rows high, so it holds the 32-row
# window of every roi whose window starts in its first BAND_S rows
BAND_S = 16
BAND_H = 48


class BandChunks(NamedTuple):
    """Rois grouped as K3 reduces them.  ``perm`` [K]: the caller's roi
    index of each sorted position; chunk ``i`` holds sorted positions
    ``start[i] .. start[i] + count[i] - 1`` (count 0: unused, the
    chunk count is a static bound) whose band starts at row
    ``row0[i]``; ``pos`` [K]: each sorted roi's slot ``chunk * size +
    slot`` in a chunk-major layout of ``size`` rois per chunk;
    ``box`` [chunks, 4]: the staged box of each chunk (first row, rows,
    first column, columns; rows or columns 0: nothing staged), or None
    where the caller asked for no boxes."""
    perm: torch.Tensor
    start: torch.Tensor
    count: torch.Tensor
    row0: torch.Tensor
    pos: torch.Tensor
    size: int
    box: Optional[torch.Tensor]

    def table(self) -> torch.Tensor:
        """The chunk table as K3's plan kernel packs it, [chunks, 7]
        (long): start, count, row0, then the box."""
        return torch.cat([torch.stack([self.start, self.count, self.row0],
                                      1), self.box], 1)


def bandx_chunk_size(out_size: int) -> int:
    """Rois per chunk: out_size rows each, ~128 rows a chunk (the
    reference's `_chunk_size`)."""
    return max(1, 128 // out_size)


def bandx_chunk_bound(num_rois, level_hw, num_images, out_size) -> int:
    """The static chunk count of K rois: ceil(K / size) + B *
    sum(ceil(H_l / 16)) (every (image, level, band) key may end in a
    partial chunk)."""
    size = bandx_chunk_size(out_size)
    return -(-num_rois // size) + num_images * sum(-(-h // BAND_S)
                                                   for h, _ in level_hw)


def bandx_roi_extents(rois, lvls, level_hw, featmap_strides, out_size=7,
                      sampling_ratio=2, aligned=True):
    """Each roi's first sample row and column, floored and clamped to
    its map, and the box of the cells its samples read: (first row,
    last row, first column, last column) [K] each (long), the corners
    of its samples inside the map (`roi_align_plain`'s test); last <
    first where no sample lies inside."""
    dev = rois.device
    lv = lvls.long()
    hs = torch.tensor([h for h, _ in level_hw], device=dev)[lv]
    ws = torch.tensor([w for _, w in level_hw], device=dev)[lv]
    ys, xs = sample_coords(rois.float(), lvls, featmap_strides, out_size,
                           sampling_ratio, aligned)

    def axis(p, size):
        size = size[:, None]
        fsize = size.float()
        inside = (p >= -1.0) & (p <= fsize)
        c0 = torch.floor(torch.minimum(p.clamp(min=0.0), fsize - 1)).long()
        c1 = torch.minimum(c0 + 1, size - 1)
        lo = torch.where(inside, c0, size).amin(1)
        hi = torch.where(inside, c1, -1).amax(1)
        return c0[:, 0], lo, hi

    first_y, y_lo, y_hi = axis(ys[:, :, 0], hs)
    first_x, x_lo, x_hi = axis(xs[:, 0, :], ws)
    none = (y_hi < y_lo) | (x_hi < x_lo)
    y_lo = torch.where(none, hs, y_lo)
    x_lo = torch.where(none, ws, x_lo)
    return (first_y, first_x,
            (y_lo, torch.where(none, -1, y_hi), x_lo,
             torch.where(none, -1, x_hi)))


def bandx_chunks(rois, bidx, lvls, level_hw, featmap_strides, num_images,
                 out_size=7, sampling_ratio=2, aligned=True,
                 stage_cells=None, boxes=True) -> BandChunks:
    """Sort rois [K, 4], K >= 0 (routed by the caller: ``bidx`` <
    ``num_images``, ``lvls`` [K])
    by their (image, level, band) key, and within a key by their first
    sample column, with a stable argsort, and cut each key's run into
    chunks of `bandx_chunk_size` rois, as `roi_align_bandx` does (the
    reference sorts by the key alone; the column order makes a chunk's
    rois neighbours in x).  The band of a roi is that of its window's
    first row (`roi_align_pallas._prepare`): the floor of its first
    sample row, clamped so that a min(32, H)-row window stays on the
    map.  Each chunk's staged box holds the cells that its rois'
    samples read inside its band (rows ``row0 .. min(row0 + 48, H) -
    1``); where that box exceeds ``stage_cells`` cells (the kernel's
    budget; None: no cap) it keeps its rows and its first columns;
    ``boxes`` False skips the boxes (``box`` None), which the plain
    version does not read.
    No host synchronisation: the chunk count is `bandx_chunk_bound`.
    The plain twin of K3's plan kernel (`RoIAlignBandxKernel.plan`),
    which computes the same table on the card."""
    k = rois.shape[0]
    dev = rois.device
    num_levels = len(level_hw)
    size = bandx_chunk_size(out_size)
    lv = lvls.long()
    hs = [h for h, _ in level_hw]
    hps = [-(-h // BAND_S) * BAND_S for h in hs]
    rows = [min(BAND_H, hp) for hp in hps]

    def per_level(values, dtype=torch.long):
        return torch.tensor(values, dtype=dtype, device=dev)[lv]

    first_y, first_x, (y_lo, y_hi, x_lo, x_hi) = bandx_roi_extents(
        rois, lvls, level_hw, featmap_strides, out_size, sampling_ratio,
        aligned)
    h_l = per_level(hs)
    wy = torch.minimum(first_y, (h_l - per_level([min(32, h) for h in hs]))
                       .clamp(min=0))
    band = wy // BAND_S
    row0 = torch.minimum(band * BAND_S,
                         (per_level(hps) - per_level(rows)).clamp(min=0))
    max_bands = max(hps) // BAND_S + 1
    max_cols = max(w for _, w in level_hw)
    group = (bidx.long() * num_levels + lv) * max_bands + band
    perm = torch.argsort(group * max_cols + first_x, stable=True)

    key_s = group[perm]
    ar = torch.arange(k, device=dev)
    is_start = torch.ones(k, dtype=torch.bool, device=dev)
    is_start[1:] = key_s[1:] != key_s[:-1]
    group_start = torch.cummax(torch.where(is_start, ar, 0), 0).values
    slot = (ar - group_start) % size
    chunk = torch.cumsum((is_start | (slot == 0)).long(), 0) - 1
    n_chunks = bandx_chunk_bound(k, level_hw, num_images, out_size)
    start = torch.full((n_chunks,), k, dtype=torch.long, device=dev)
    start.scatter_reduce_(0, chunk, ar, "amin")
    count = torch.zeros(n_chunks, dtype=torch.long, device=dev)
    count.scatter_add_(0, chunk, torch.ones_like(chunk))

    # per chunk: its band's origin, and the union of its members' boxes
    # clipped to the band
    def reduce(values, how, empty=0):
        out = torch.full((n_chunks,), empty, dtype=torch.long, device=dev)
        return out.scatter_reduce_(0, chunk, values[perm], how,
                                   include_self=how == "sum")
    chunk_row0 = reduce(row0, "amax")
    if not boxes:
        return BandChunks(perm, start, count, chunk_row0,
                          chunk * size + slot, size, None)
    used = count > 0
    by0 = torch.maximum(reduce(y_lo, "amin"), chunk_row0)
    by1 = torch.minimum(reduce(y_hi, "amax", -1),
                        reduce(torch.minimum(row0 + BAND_H, h_l), "amax") - 1)
    bx0 = reduce(x_lo, "amin")
    bx1 = reduce(x_hi, "amax", -1)
    staged = used & (by1 >= by0) & (bx1 >= bx0)
    nrows = torch.where(staged, by1 - by0 + 1, 0)
    ncols = torch.where(staged, bx1 - bx0 + 1, 0)
    if stage_cells is not None:
        ncols = torch.minimum(ncols, stage_cells // nrows.clamp(min=1))
    box = torch.stack([torch.where(staged, by0, 0), nrows,
                       torch.where(staged, bx0, 0), ncols], 1)
    return BandChunks(perm, start, count, chunk_row0, chunk * size + slot,
                      size, box)


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

    def check(self, feats, rois_b, featmap_strides, out_size,
              sampling_ratio, roi_dim=4):
        """Raise on anything the forward kernels do not take (rois
        [B, R, roi_dim] float32 on the card)."""
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
                or rois_b.shape[-1] != roi_dim:
            raise ValueError(f"rois must be float32 [B, R, {roi_dim}], got "
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
    predict path, and K2's forward inside `RoIAlignFunction`: one block
    per roi, its window staged once in shared memory."""

    MAX_SAMPLES = 1024      # out_size * sampling_ratio (kMaxSamples)

    def __init__(self):
        super().__init__(CSRC / "roi_align.cu", "aidet_roi_align_forward",
                         [_I, _I] + [_P] * 4 + [_I] * 8 + [_I] * 4
                         + [_I, _I] + [_P] * 3 + [_I] * 4 + [_P, _P])

    def __call__(self, feats, rois, bidx, lvls, out, featmap_strides,
                 sampling_ratio, aligned):
        """Launch on the current stream; rois [K, 4] f32, bidx/lvls [K]
        int32, out [K, s, s, C] (all contiguous, on the card)."""
        if out.shape[1] * sampling_ratio > self.MAX_SAMPLES:
            raise ValueError(f"out_size {out.shape[1]} x sampling_ratio "
                             f"{sampling_ratio} exceeds the kernel's "
                             f"{self.MAX_SAMPLES} samples per roi side")
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


# K2's backward cuts each level into BWD_TILE x BWD_TILE-cell tiles
# (kTile of csrc/roi_align_backward.cu)
BWD_TILE = 4


def backward_tile_count(level_shapes) -> int:
    """Tiles of K2's backward over levels [B, H, W, C]."""
    return sum(b * -(-h // BWD_TILE) * -(-w // BWD_TILE)
               for b, h, w, _ in level_shapes)


def backward_scratch_ints(level_shapes, num_rois, out_size,
                          sampling_ratio) -> int:
    """int32 values of K2's backward scratch: counts per tile, a
    running total, offsets and cursors per tile, then the entry lists
    at their upper bound, 4 * K * (out_size * ratio)^2 (every sample of
    every bin in a tile of its own)."""
    n = out_size * sampling_ratio
    return (3 * backward_tile_count(level_shapes) + 1
            + 4 * num_rois * n * n)


class RoIAlignBackwardKernel(_KernelLibrary):
    """K2's backward (`csrc/roi_align_backward.cu`): the features'
    gradient from grad_out, binned into 4x4-cell tiles and summed tile
    by tile in shared memory, written once in grad_out's dtype.  K4's
    backward (`csrc/rroi_align_backward.cu`, rotated rois) has the same
    C interface and bookkeeping: a handle on it passes its ``source``,
    ``symbol``, ``name`` and ``roi_dim`` (the floats per roi: 4, or 5
    for a rotated roi).

    ``scratch`` keeps the last launch's int32 bookkeeping (sized by
    `backward_scratch_ints`): its first ``tiles`` values are the
    entries per tile."""

    def __init__(self, source=CSRC / "roi_align_backward.cu",
                 symbol="aidet_roi_align_backward",
                 name="roi_align backward", roi_dim=4):
        super().__init__(source, symbol,
                         [_I, _I, _P, ctypes.c_longlong, _P,
                          ctypes.c_longlong] + [_I] * 8
                         + [_I] * 4 + [_I] * 3 + [_P] * 3 + [_I] * 4
                         + [_P, _P])
        self.name = name
        self.roi_dim = roi_dim
        self.scratch: torch.Tensor | None = None
        self.tiles = 0

    def __call__(self, grad_out, rois, bidx, lvls, level_shapes,
                 featmap_strides, sampling_ratio, aligned):
        """grad_out [K, s, s, C] (bfloat16 or float32, the features'
        dtype), rois [K, roi_dim] f32, bidx/lvls [K] int32 as for the
        forward (all contiguous), level_shapes the levels' [B, H, W, C].
        Returns the levels' gradients, [B, H, W, C] each in grad_out's
        dtype."""
        dtype = grad_out.dtype
        if grad_out.device.type != "cuda" or rois.device != grad_out.device:
            raise ValueError("the backward needs grad_out and rois on one "
                             f"CUDA device, not {grad_out.device} and "
                             f"{rois.device}")
        if dtype not in self._VEC:
            raise TypeError(f"the backward takes bfloat16 or float32 "
                            f"gradients, not {dtype}")
        k, s = rois.shape[0], grad_out.shape[1]
        if rois.dtype != torch.float32 or rois.dim() != 2 \
                or rois.shape[1] != self.roi_dim or not rois.is_contiguous():
            raise ValueError(f"rois must be contiguous float32 [K, "
                             f"{self.roi_dim}], got {rois.dtype} "
                             f"{tuple(rois.shape)}")
        for t in (bidx, lvls):
            if t.dtype != torch.int32 or tuple(t.shape) != (k,) \
                    or t.device != rois.device or not t.is_contiguous():
                raise ValueError(f"bidx and lvls must be contiguous int32 "
                                 f"[{k}] on the rois' device")
        c = level_shapes[0][-1]
        if tuple(grad_out.shape) != (k, s, s, c) or c % self._VEC[dtype]:
            raise ValueError(f"grad_out {tuple(grad_out.shape)} is not "
                             f"[{k}, s, s, {c}] with C a multiple of "
                             f"{self._VEC[dtype]}")
        if not grad_out.is_contiguous() or grad_out.data_ptr() % 16:
            raise ValueError("grad_out must be contiguous and 16-byte "
                             "aligned")
        if 4 * k * (s * sampling_ratio) ** 2 >= 2 ** 31:
            raise ValueError("too many rois for one launch")
        sizes = [math.prod(shape) for shape in level_shapes]
        total = sum(sizes)
        dev = grad_out.device
        grads = torch.empty(total, dtype=dtype, device=dev)
        n_scratch = backward_scratch_ints(level_shapes, k, s, sampling_ratio)
        self.scratch = torch.empty(n_scratch, dtype=torch.int32, device=dev)
        self.tiles = backward_tile_count(level_shapes)
        stream = torch.cuda.current_stream(dev).cuda_stream
        self._launch(
            self.name, dev.index, self._DTYPE_CODE[dtype],
            grads.data_ptr(), total, self.scratch.data_ptr(), n_scratch,
            *self._level_args(level_shapes, featmap_strides),
            len(level_shapes), level_shapes[0][0], c, rois.data_ptr(),
            bidx.data_ptr(), lvls.data_ptr(), k, s, sampling_ratio,
            int(aligned), grad_out.data_ptr(), stream)
        return [g.view(shape) for g, shape in
                zip(grads.split(sizes), level_shapes)]


class BandPlan(NamedTuple):
    """K3's plan as the card computes it (`RoIAlignBandxKernel.plan`):
    ``perm`` [K] int32, as `BandChunks.perm`; ``chunks`` [chunks, 8]
    int32, one row per chunk: start, count, row0, the staged box (first
    row, rows, first column, columns) and one unused int.  Equal to
    `bandx_chunks` with the kernel's budget."""
    perm: torch.Tensor
    chunks: torch.Tensor


class RoIAlignBandxKernel(_KernelLibrary):
    """K3 (`csrc/roi_align_bandx.cu`): K1's function, planned and reduced
    by two kernels of one library.  `plan` sorts the rois and writes the
    chunk table on the card (`bandx_chunks` is its plain twin); the call
    launches the reduction, a block per (chunk, two 32-byte channel
    slices), each reducing its chunk's rois out of the chunk's staged
    box.  ``launches`` counts the reductions, ``plan_launches`` the
    plans."""

    PLAN_SMEM = 200 * 1024  # shared memory the plan's counts may take
    SLICE_BYTES = 32        # bytes of each cell staged at a time (kSlice)
    # a stage of the reduction's two-stage ring: boxes of at most 1664
    # cells (52 KB measured fastest on an H100 among 16 to 104 KB:
    # PERF.md)
    STAGE_BYTES = 52 * 1024

    def __init__(self):
        super().__init__(CSRC / "roi_align_bandx.cu",
                         "aidet_roi_align_bandx_forward",
                         [_I, _I] + [_P] * 4 + [_I] * 8 + [_I] * 4
                         + [_I, _I] + [_P] * 3 + [_I] + [_P] * 2
                         + [_I] * 6 + [_P, _P])
        self.plan_launches = 0
        self._plan_fn = self._occupancy_fn = None

    def load(self, build: BuildResult | None = None) -> BuildResult:
        build = super().load(build)
        if self._plan_fn is None:
            self._plan_fn = self._lib.aidet_roi_align_bandx_plan
            self._plan_fn.argtypes = [_I] * 14 + [_P] * 3 + [_I] * 9 \
                + [_P] * 3 + [_I, _P]
            self._occupancy_fn = self._lib.aidet_roi_align_bandx_occupancy
            self._occupancy_fn.argtypes = [_I] * 6 + [_P]
            for fn in (self._plan_fn, self._occupancy_fn):
                fn.restype = ctypes.c_int
        return build

    def blocks_per_sm(self, dtype, out_size=7, sampling_ratio=2) -> int:
        """Blocks of the reduction that fit on one SM at once in
        ``dtype`` (cudaOccupancyMaxActiveBlocksPerMultiprocessor), on the
        current device."""
        self.load()
        blocks = ctypes.c_int(0)
        err = self._occupancy_fn(
            torch.cuda.current_device(), self._DTYPE_CODE[dtype],
            bandx_chunk_size(out_size), self.STAGE_BYTES, out_size,
            sampling_ratio, ctypes.addressof(blocks))
        if err != 0:
            raise RuntimeError(f"occupancy query failed: CUDA error {err}")
        return blocks.value

    @staticmethod
    def _check_rois(rois, bidx, lvls):
        k, dev = rois.shape[0], rois.device
        if dev.type != "cuda" or rois.dtype != torch.float32 \
                or tuple(rois.shape) != (k, 4) or not rois.is_contiguous():
            raise ValueError(f"rois must be contiguous float32 [K, 4] on the "
                             f"card, got {rois.dtype} {tuple(rois.shape)} on "
                             f"{dev}")
        for t in (bidx, lvls):
            if t.dtype != torch.int32 or tuple(t.shape) != (k,) \
                    or t.device != dev or not t.is_contiguous():
                raise ValueError(f"bidx and lvls must be contiguous int32 "
                                 f"[{k}] on the rois' device")

    @property
    def stage_cells(self) -> int:
        """Cells a staged box may hold."""
        return self.STAGE_BYTES // self.SLICE_BYTES

    def plan(self, rois, bidx, lvls, level_hw, featmap_strides, num_images,
             out_size=7, sampling_ratio=2, aligned=True) -> BandPlan:
        """Launch the plan on the current stream: rois [K, 4] f32,
        bidx/lvls [K] int32 (contiguous, on the card), routed by the
        caller to ``num_images`` images and the levels ``level_hw``."""
        self._check_rois(rois, bidx, lvls)
        k = rois.shape[0]
        dev = rois.device
        size = bandx_chunk_size(out_size)
        n_chunks = bandx_chunk_bound(k, level_hw, num_images, out_size)
        groups = num_images * len(level_hw) * (
            max(-(-h // BAND_S) for h, _ in level_hw) + 1)
        bins = max(groups, max(w for _, w in level_hw))
        extra = 2 * (groups + 1) + 32
        segs = min(32, (self.PLAN_SMEM // 4 - extra) // bins)
        if segs < 1:
            raise ValueError(f"K3's plan cannot count {groups} band keys "
                             f"of {num_images} images in shared memory")
        perm = torch.empty(k, dtype=torch.int32, device=dev)
        chunks = torch.empty((n_chunks, 8), dtype=torch.int32, device=dev)
        work = torch.empty(7 * k, dtype=torch.int32, device=dev)
        self.load()
        err = self._plan_fn(
            dev.index, *self._level_args([(0, h, w) for h, w in level_hw],
                                         featmap_strides),
            len(level_hw), rois.data_ptr(), bidx.data_ptr(), lvls.data_ptr(),
            k, num_images, out_size, sampling_ratio, int(aligned), size,
            self.stage_cells, segs, 4 * (bins * segs + extra),
            work.data_ptr(), perm.data_ptr(), chunks.data_ptr(), n_chunks,
            torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"roi_align_bandx plan launch failed: CUDA "
                               f"error {err}")
        self.plan_launches += 1
        return BandPlan(perm, chunks)

    def __call__(self, feats, rois, bidx, lvls, plan: BandPlan, out,
                 featmap_strides, sampling_ratio, aligned):
        """Launch the reduction on the current stream; rois [K, 4] f32,
        bidx/lvls [K] int32, ``plan`` from `plan` on the same rois, out
        [K, s, s, C] (all contiguous, on the card)."""
        self._check_rois(rois, bidx, lvls)
        s = out.shape[1]
        size = bandx_chunk_size(s)
        smem = 2 * self.STAGE_BYTES + 4 * size * (1 + 6 * s * sampling_ratio)
        if smem > 227 * 1024:
            raise ValueError(f"out_size {s} x sampling_ratio "
                             f"{sampling_ratio}: the plans of a chunk do not "
                             "fit in shared memory beside the stages")
        ptrs = [f.data_ptr() for f in feats] + [None] * (4 - len(feats))
        stream = torch.cuda.current_stream(rois.device).cuda_stream
        self._launch(
            "roi_align_bandx forward", rois.device.index,
            self._DTYPE_CODE[feats[0].dtype], *ptrs,
            *self._level_args([f.shape for f in feats], featmap_strides),
            len(feats), feats[0].shape[-1], rois.data_ptr(),
            bidx.data_ptr(), lvls.data_ptr(), rois.shape[0],
            plan.perm.data_ptr(), plan.chunks.data_ptr(),
            plan.chunks.shape[0], size, self.STAGE_BYTES, s,
            sampling_ratio, int(aligned), out.data_ptr(), stream)
        return out


# K1 on the predict path; the same CUDA forward counted apart as K2's
# forward on the train path; K2's backward; K3
roi_align_kernel = RoIAlignKernel()
roi_align_train_kernel = RoIAlignKernel()
roi_align_backward_kernel = RoIAlignBackwardKernel()
roi_align_bandx_kernel = RoIAlignBandxKernel()


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
                      finest_scale=56, aligned=True, bump_to_window=False,
                      train=False, roi_scale_factor=None):
    """Batched multi-level RoIAlign: [B, R, out_size, out_size, C].

    On CPU tensors: the plain version.  On CUDA tensors, in the
    features' dtype (bfloat16 or float32), or an exception: K1 when no
    gradient is wanted (predict, under no_grad), else K2
    (`RoIAlignFunction`), whose backward is a CUDA kernel too.  With
    ``train`` a pass that wants no gradient is still K2's forward (the
    same kernel, counted on the train path's handle): the reference's
    OHEM scores its candidates with its train-path RoIAlign.
    """
    feats = list(feats)
    devices = {f.device for f in feats} | {rois_b.device}
    if devices == {torch.device("cpu")}:
        return batched_multilevel_roi_align(
            feats, rois_b, out_size, featmap_strides, sampling_ratio,
            finest_scale, aligned, bump_to_window, roi_scale_factor)
    roi_align_kernel.check(feats, rois_b, featmap_strides, out_size,
                           sampling_ratio)
    b, r = rois_b.shape[:2]
    rois = rois_b.detach().reshape(b * r, 4).contiguous()
    lvls = route_rois(rois, [tuple(f.shape[1:3]) for f in feats],
                      featmap_strides, finest_scale,
                      bump_to_window).contiguous()
    if roi_scale_factor is not None:
        rois = roi_rescale(rois, roi_scale_factor).contiguous()
    bidx = torch.arange(b, dtype=torch.int32,
                        device=rois.device).repeat_interleave(r)
    if torch.is_grad_enabled() and any(f.requires_grad for f in feats):
        out = RoIAlignFunction.apply(rois, bidx, lvls, out_size,
                                     tuple(featmap_strides), sampling_ratio,
                                     aligned, *feats)
    else:
        out = torch.empty((b * r, out_size, out_size, feats[0].shape[-1]),
                          dtype=feats[0].dtype, device=rois.device)
        kernel = roi_align_train_kernel if train else roi_align_kernel
        kernel(feats, rois, bidx, lvls, out, featmap_strides,
               sampling_ratio, aligned)
    return out.reshape(b, r, out_size, out_size, -1)


def multilevel_roi_align_fused(feats, rois, out_size=7,
                               featmap_strides=(4, 8, 16, 32),
                               sampling_ratio=2, finest_scale=56,
                               aligned=True, roi_scale_factor=None):
    """The multi-level RoIAlign of one image: feats, its levels [H_l,
    W_l, C]; rois [K, 4] -> [K, out_size, out_size, C].  The function of
    `roi_align_forward` (K1 on the card without a gradient, K2 with
    one, the plain version on the CPU) on a batch of one, with the
    reference's ``roi_scale_factor``."""
    return roi_align_forward(
        [f[None] for f in feats], rois[None], out_size, featmap_strides,
        sampling_ratio, finest_scale, aligned,
        roi_scale_factor=roi_scale_factor)[0]


def roi_align_bandx_plain(feats, rois_b, out_size=7,
                          featmap_strides=(4, 8, 16, 32), sampling_ratio=2,
                          finest_scale=56, aligned=True,
                          bump_to_window=False):
    """K3's plain version: the rois regrouped as K3 takes them
    (`bandx_chunks`), each reduced by `roi_align_plain` in its chunk's
    slot, and gathered back to the caller's order.  Equal to
    `batched_multilevel_roi_align` with the same routing, bit for bit.
    Returns [B, R, out_size, out_size, C]."""
    feats = list(feats)
    b, r = rois_b.shape[:2]
    rois = rois_b.reshape(b * r, 4)
    level_hw = [tuple(f.shape[1:3]) for f in feats]
    lvls = route_rois(rois.float(), level_hw, featmap_strides, finest_scale,
                      bump_to_window)
    bidx = torch.arange(b, device=rois.device).repeat_interleave(r)
    ch = bandx_chunks(rois, bidx, lvls, level_hw, featmap_strides, b,
                      out_size, sampling_ratio, aligned, boxes=False)
    p = ch.perm
    sorted_out = roi_align_plain(feats, rois[p], bidx[p], lvls[p], out_size,
                                 featmap_strides, sampling_ratio, aligned)
    slots = sorted_out.new_zeros((ch.start.shape[0] * ch.size,)
                                 + sorted_out.shape[1:])
    slots[ch.pos] = sorted_out
    inv = torch.empty_like(p)
    inv[p] = torch.arange(p.shape[0], device=p.device)
    return slots[ch.pos[inv]].reshape((b, r) + sorted_out.shape[1:])


def roi_align_bandx_forward(feats, rois_b, out_size=7,
                            featmap_strides=(4, 8, 16, 32),
                            sampling_ratio=2, finest_scale=56, aligned=True,
                            bump_to_window=False):
    """K3, forward only: [B, R, out_size, out_size, C], the function of
    `roi_align_forward` without a gradient.  On CPU tensors: the plain
    version (`roi_align_bandx_plain`).  On CUDA tensors, in the
    features' dtype (bfloat16 or float32), or an exception: the rois
    are routed by elementwise torch ops, then `roi_align_bandx_kernel`
    launches its plan and its reduction, with no sort, scan or scatter
    of torch between them."""
    feats = list(feats)
    devices = {f.device for f in feats} | {rois_b.device}
    if devices == {torch.device("cpu")}:
        return roi_align_bandx_plain(
            feats, rois_b, out_size, featmap_strides, sampling_ratio,
            finest_scale, aligned, bump_to_window)
    if torch.is_grad_enabled() and any(f.requires_grad for f in feats):
        raise ValueError("the band-chunked RoIAlign (K3) has no backward; "
                         "roi_align_forward takes gradients")
    roi_align_bandx_kernel.check(feats, rois_b, featmap_strides, out_size,
                                 sampling_ratio)
    b, r = rois_b.shape[:2]
    c = feats[0].shape[-1]
    out = torch.empty((b * r, out_size, out_size, c), dtype=feats[0].dtype,
                      device=rois_b.device)
    if b * r:
        rois = rois_b.detach().reshape(b * r, 4).contiguous()
        level_hw = [tuple(f.shape[1:3]) for f in feats]
        lvls = route_rois(rois, level_hw, featmap_strides, finest_scale,
                          bump_to_window).contiguous()
        bidx = torch.arange(b * r, dtype=torch.int32,
                            device=rois.device) // r
        plan = roi_align_bandx_kernel.plan(rois, bidx, lvls, level_hw,
                                           featmap_strides, b, out_size,
                                           sampling_ratio, aligned)
        roi_align_bandx_kernel(feats, rois, bidx, lvls, plan, out,
                               featmap_strides, sampling_ratio, aligned)
    return out.reshape(b, r, out_size, out_size, c)
