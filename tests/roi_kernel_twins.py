"""Torch twins of the integer bookkeeping of three CUDA kernels of the
port, for the CPU tests only (the port itself never calls them).

K1, `aidet_tpu_torch/csrc/roi_align.cu`: each roi's window is the
product of its distinct clamped corner rows and columns
(`window_plan`, and `scan_axis`, the kernel's `plan_axis` rule as a
serial walk), walked in tiles of at most ``cap`` cells (`stripe_plan`,
the kernel's loop bounds) and reduced in x then in y
(`separable_roi_align`).

K2's backward, `aidet_tpu_torch/csrc/roi_align_backward.cu`: every
(roi, bin) is an entry of each 4x4-cell tile that a corner of one of
its samples falls in (`tile_binning`), and each tile sums its entries'
corners that lie in it (`binned_backward`).

K4, `aidet_tpu_torch/csrc/rroi_align.cu` and
`csrc/rroi_align_backward.cu`: both plan every sample of a rotated roi
once from the roi's geometry (`rotated_sample_twin`, the operations of
`roi_common.cuh` in numpy float32, which equal the plain version's
`ops/rroi_align.py::sample_coords` bit for bit).  The forward's plan
gives each sample four corner cells and weights with 1 / ratio^2 folded
in, or cell -1 outside the map (`rotated_forward_plan`), and sums them
per bin (`planned_rroi_align`).  The backward's plan gives each sample
(y0, x0, ly, lx), or y0 = -1 outside the map (`rotated_sample_plan`);
its lists and sums are K2's for rotated rois, whose bins' samples are
no grid: a bin is listed in each distinct tile of its samples' corners,
at the first sample that reaches it (`rotated_tile_binning`,
`rotated_binned_backward`).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from aidet_tpu_torch.ops import rroi_align
from aidet_tpu_torch.ops.roi_align import BWD_TILE, sample_coords


def axis_samples(rois, lvls, strides, out_size, ratio, aligned):
    """The sample rows ys [K, n] and columns xs [K, n] of the kernels'
    geometry (the plain version's `sample_coords`)."""
    ys, xs = sample_coords(rois, lvls, strides, out_size, ratio, aligned)
    return ys[:, :, 0], xs[:, 0, :]


def corners(p, size):
    """(inside [n] bool, c0, c1 [n] long, weight of c1 [n]) of samples
    p [n] on an axis of ``size`` cells."""
    inside = (p >= -1.0) & (p <= size)
    c = p.clamp(min=0.0, max=size - 1)
    c0 = torch.floor(c)
    return inside, c0.long(), torch.clamp(c0 + 1, max=size - 1).long(), \
        c - c0


def window_axis(p, size):
    """K1's plan of one axis by sorting: the distinct corners of the
    samples p [n] inside the map, and each sample's two list indices
    idx [2, n] (-1 outside the map) and weights w [2, n]."""
    inside, c0, c1, l = corners(p, size)
    listed = torch.unique(torch.cat([c0[inside], c1[inside]]))
    idx = torch.stack([torch.searchsorted(listed, c0),
                       torch.searchsorted(listed, c1)])
    idx = torch.where(inside, idx, -1)
    w = torch.where(inside, torch.stack([1.0 - l, l]), 0.0)
    return listed, idx, w


def scan_axis(p, size):
    """The rule of the kernel's `plan_axis` as one serial walk in
    increasing coordinate: a corner is listed when it exceeds the
    largest listed so far, and one that is not is the last or the one
    before it (the kernel decides this for 32 samples at a time with a
    ballot).  Returns what `window_axis` returns."""
    n = p.shape[0]
    rev = bool(n > 1 and p[-1] < p[0])
    listed, idx = [], [[-1] * n, [-1] * n]
    w = torch.zeros(2, n, dtype=p.dtype)
    for t in range(n):
        m = n - 1 - t if rev else t
        if p[m] < -1.0 or p[m] > size:
            continue
        c = min(max(float(p[m]), 0.0), size - 1.0)
        c0 = math.floor(c)
        c1 = min(c0 + 1, size - 1)
        if not listed or c0 > listed[-1]:
            listed.append(c0)
        i0 = len(listed) - 1 if listed[-1] == c0 else len(listed) - 2
        if c1 > listed[-1]:
            listed.append(c1)
        idx[0][m], idx[1][m] = i0, (i0 if c1 == c0 else i0 + 1)
        w[0, m], w[1, m] = 1.0 - (c - c0), c - c0
    return torch.tensor(listed, dtype=torch.long), torch.tensor(idx), w


def window_plan(rois, lvls, level_hw, strides, out_size, ratio, aligned):
    """Per roi: (rows, row idx, row w, cols, col idx, col w) of
    `window_axis`."""
    ys, xs = axis_samples(rois, lvls, strides, out_size, ratio, aligned)
    plans = []
    for k in range(rois.shape[0]):
        h, w = level_hw[int(lvls[k])]
        plans.append(window_axis(ys[k], h) + window_axis(xs[k], w))
    return plans


def stripe_plan(nrows, ncols, cap):
    """K1's tiles of a nrows x ncols window, in its order: (first row,
    rows, first column, columns).  Whole rows, cap // ncols of them at a
    time, when a row fits ``cap`` cells; else one row at a time in
    stripes of ``cap`` columns."""
    if nrows == 0 or ncols == 0:
        return []
    rows_per = cap // ncols if ncols <= cap else 1
    width = min(ncols, cap)
    return [(q0, min(rows_per, nrows - q0), s0, min(width, ncols - s0))
            for q0 in range(0, nrows, rows_per)
            for s0 in range(0, ncols, width)]


def bin_rows_span(idx, ratio):
    """The most listed rows one bin row reads (the kernel keeps a ring
    of 2 * ratio of them)."""
    span = 0
    for b in range(idx.shape[1] // ratio):
        i = idx[:, b * ratio:(b + 1) * ratio]
        i = i[i >= 0]
        if i.numel():
            span = max(span, int(i.max() - i.min()) + 1)
    return span


def separable_roi_align(feats, rois, bidx, lvls, out_size, strides,
                        ratio=2, aligned=True, cap=32):
    """K1's reduction over its planned windows: every tile of cells
    staged from the level, reduced in x at the bin columns, then in y
    at the bin rows; the result [K, s, s, C] in the features' dtype
    (sums in float32, float64 for float64)."""
    compute = torch.promote_types(feats[0].dtype, torch.float32)
    level_hw = [tuple(f.shape[1:3]) for f in feats]
    plans = window_plan(rois.to(compute), lvls, level_hw, strides,
                        out_size, ratio, aligned)
    c = feats[0].shape[-1]
    out = torch.zeros(rois.shape[0], out_size, out_size, c, dtype=compute)
    n = out_size * ratio
    for k, (rows, ri, rw, cols, ci, cw) in enumerate(plans):
        fmap = feats[int(lvls[k])][int(bidx[k])].to(compute)
        x_rows = torch.zeros(rows.numel(), out_size, c, dtype=compute)
        for q0, nr, s0, ns in stripe_plan(rows.numel(), cols.numel(), cap):
            staged = fmap[rows[q0:q0 + nr]][:, cols[s0:s0 + ns]]
            wx = torch.zeros(out_size, ns, dtype=compute)
            for m in range(n):
                for corner in range(2):
                    j = int(ci[corner, m]) - s0
                    if 0 <= j < ns:
                        wx[m // ratio, j] += cw[corner, m]
            x_rows[q0:q0 + nr] += torch.einsum("pj,rjc->rpc", wx, staged)
        wy = torch.zeros(out_size, rows.numel(), dtype=compute)
        for m in range(n):
            for corner in range(2):
                if ri[corner, m] >= 0:
                    wy[m // ratio, ri[corner, m]] += rw[corner, m]
        out[k] = torch.einsum("yr,rpc->ypc", wy, x_rows) / ratio ** 2
    return out.to(feats[0].dtype)


def tile_layout(level_shapes, tile=BWD_TILE):
    """(first tile id per level and the total, tiles across per level,
    tiles per image per level) of K2's backward."""
    first, across, per_image, total = [], [], [], 0
    for b, h, w, _ in level_shapes:
        first.append(total)
        across.append(-(-w // tile))
        per_image.append(across[-1] * -(-h // tile))
        total += b * per_image[-1]
    return first + [total], across, per_image


def tile_binning(rois, bidx, lvls, level_shapes, strides, out_size,
                 ratio=2, aligned=True, tile=BWD_TILE):
    """K2's backward's lists: every (roi, bin), e = k * out_size^2 + py
    * out_size + px, once in each tile that a corner of one of its
    samples inside the map falls in: its distinct tile rows times its
    distinct tile columns.  Returns dict(entries [E] bin ids and tiles
    [E] tile ids, sorted by tile then bin; counts [T]; offsets [T + 1];
    bound, the kernel's 4 K n^2).  The geometry is computed in the
    rois' dtype."""
    k, s = rois.shape[0], out_size
    first, across, per_image = tile_layout(level_shapes, tile)
    ys, xs = axis_samples(rois, lvls, strides, s, ratio, aligned)
    pairs = []
    for kk in range(k):
        l = int(lvls[kk])
        _, h, w, _ = level_shapes[l]
        base = first[l] + int(bidx[kk]) * per_image[l]
        tiles_y = _bin_tiles(ys[kk], h, s, ratio, tile)
        tiles_x = _bin_tiles(xs[kk], w, s, ratio, tile)
        for py in range(s):
            for px in range(s):
                e = (kk * s + py) * s + px
                pairs += [(base + ty * across[l] + tx, e)
                          for ty in tiles_y[py] for tx in tiles_x[px]]
    return _lists(pairs, first[-1], k * s * s, 4 * k * (s * ratio) ** 2)


def _bin_tiles(p, size, out_size, ratio, tile):
    """Per bin of one axis (samples p [n]): the sorted distinct tiles of
    its samples' corners inside the map."""
    inside, c0, c1, _ = corners(p, size)
    return [sorted({int(c) // tile for m in range(b * ratio, (b + 1) * ratio)
                    if inside[m] for c in (c0[m], c1[m])})
            for b in range(out_size)]


def binned_backward(grad_out, rois, bidx, lvls, level_shapes, strides,
                    ratio=2, aligned=True, tile=BWD_TILE):
    """K2's backward from its lists: each tile adds, for each of its
    entries, the bin's grad_out times the weight of every corner of the
    bin's samples that lies in the tile (sums in float32, float64 for
    float64), and every tile is written once.  Returns the levels'
    gradients [B, H, W, C] in grad_out's dtype."""
    k, s = rois.shape[0], grad_out.shape[1]
    compute = torch.promote_types(grad_out.dtype, torch.float32)
    rois = rois.to(compute)
    lists = tile_binning(rois, bidx, lvls, level_shapes, strides, s, ratio,
                         aligned, tile)
    ys, xs = axis_samples(rois, lvls, strides, s, ratio, aligned)
    n = s * ratio
    return tile_sums(grad_out, lists, ys[:, :, None].expand(k, n, n),
                     xs[:, None, :].expand(k, n, n), lvls, level_shapes,
                     ratio, tile)


def rotated_sample_twin(rrois, lvls, strides, out_size, ratio=2,
                        aligned=True):
    """The sample points of rotated rois [K, 5] on their levels ``lvls``
    as K4's kernels compute them (`roi_common.cuh`): the roi's geometry
    once (`rotated_roi_at`: 1 / stride rounded, cos and sin rounded from
    float64), then each sample (`rotated_sample`), in numpy float32 with
    one rounding per operation (float64 for float64 rois, as the plain
    version computes them).  Returns (ys, xs) [K, n, n] arrays of that
    dtype, n = out_size * ratio."""
    f = np.float64 if rrois.dtype == torch.float64 else np.float32
    r = np.asarray(rrois, f).reshape(-1, 5)
    inv = f(1) / np.asarray(strides, f)[np.asarray(lvls, np.int64)]
    off = f(0.5) if aligned else f(0)
    cx = (r[:, 0] * inv - off)[:, None, None]
    cy = (r[:, 1] * inv - off)[:, None, None]
    rw = np.maximum(r[:, 2] * inv, f(1e-3))[:, None, None]
    rh = np.maximum(r[:, 3] * inv, f(1e-3))[:, None, None]
    theta = r[:, 4].astype(np.float64)
    cos_t = np.cos(theta).astype(f)[:, None, None]
    sin_t = np.sin(theta).astype(f)[:, None, None]
    n = out_size * ratio
    g = (np.arange(n, dtype=f) + f(0.5)) / f(ratio)
    frac = g * (f(1) / f(out_size)) - f(0.5)
    yl = frac[None, :, None] * rh
    xl = frac[None, None, :] * rw
    xs = (cx + xl * cos_t) - yl * sin_t
    ys = (cy + xl * sin_t) + yl * cos_t
    return ys, xs


def _plan_corners(rrois, lvls, level_hw, strides, out_size, ratio,
                  aligned):
    """(inside, y0, x0, y1, x1, ly, lx) [K, n, n] of the kernels'
    `sample_corners` on `rotated_sample_twin`'s points (numpy)."""
    ys, xs = rotated_sample_twin(rrois, lvls, strides, out_size, ratio,
                                 aligned)
    lv = np.asarray(lvls, np.int64)
    h = np.array([hw[0] for hw in level_hw], ys.dtype)[lv][:, None, None]
    w = np.array([hw[1] for hw in level_hw], ys.dtype)[lv][:, None, None]
    inside = (ys >= -1) & (ys <= h) & (xs >= -1) & (xs <= w)
    y = np.minimum(np.maximum(ys, 0), h - 1)
    x = np.minimum(np.maximum(xs, 0), w - 1)
    y0, x0 = np.floor(y), np.floor(x)
    y1, x1 = np.minimum(y0 + 1, h - 1), np.minimum(x0 + 1, w - 1)
    return inside, y0, x0, y1, x1, y - y0, x - x0


def rotated_forward_plan(rrois, lvls, level_hw, strides, out_size, ratio=2,
                         aligned=True):
    """K4's forward's plan: for every sample [K, n, n] its four corner
    cells (y * W + x on the roi's level), in the order (y0, x0),
    (y0, x1), (y1, x0), (y1, x1), and their weights times 1 / ratio^2;
    cells -1 and weights 0 for a sample outside the map.  Returns
    (cells [K, n, n, 4] int64, weights [K, n, n, 4] float32) tensors."""
    inside, y0, x0, y1, x1, ly, lx = _plan_corners(
        rrois, lvls, level_hw, strides, out_size, ratio, aligned)
    w = np.array([hw[1] for hw in level_hw], np.int64)[
        np.asarray(lvls, np.int64)][:, None, None]
    y0, x0, y1, x1 = (a.astype(np.int64) for a in (y0, x0, y1, x1))
    hy, hx = np.float32(1) - ly, np.float32(1) - lx
    inv_count = np.float32(1) / np.float32(ratio * ratio)
    cells = np.stack([y0 * w + x0, y0 * w + x1, y1 * w + x0, y1 * w + x1],
                     -1)
    wts = np.stack([hy * hx * inv_count, hy * lx * inv_count,
                    ly * hx * inv_count, ly * lx * inv_count], -1)
    cells = np.where(inside[..., None], cells, -1)
    wts = np.where(inside[..., None], wts, np.float32(0))
    return torch.from_numpy(cells), torch.from_numpy(wts)


def planned_rroi_align(feats, rrois, bidx, lvls, out_size, strides, ratio=2,
                       aligned=True):
    """K4's forward from its plan: each bin sums its samples' planned
    corners times their weights (float32; float64 for float64 levels).
    Returns [K, out_size, out_size, C] in the levels' dtype."""
    compute = torch.promote_types(feats[0].dtype, torch.float32)
    level_hw = [tuple(f.shape[1:3]) for f in feats]
    cells, wts = rotated_forward_plan(rrois, lvls, level_hw, strides,
                                      out_size, ratio, aligned)
    k, c, s = cells.shape[0], feats[0].shape[-1], out_size
    out = torch.zeros(k, s, s, c, dtype=compute)
    for kk in range(k):
        fmap = feats[int(lvls[kk])][int(bidx[kk])].reshape(-1, c)
        got = fmap.to(compute)[cells[kk].clamp(min=0)] \
            * wts[kk, ..., None].to(compute)
        out[kk] = got.sum(2).reshape(s, ratio, s, ratio, c).sum((1, 3))
    return out.to(feats[0].dtype)


def rotated_sample_plan(rrois, lvls, level_hw, strides, out_size, ratio=2,
                        aligned=True):
    """K4's backward's plan, as its plan pass writes it to its work buffer:
    one int32 quadruple (y0, x0, ly, lx) per sample [K, n, n, 4] of
    float32 rois, the weights as their float32 bits, or (-1, 0, 0, 0)
    outside the map."""
    inside, y0, x0, _, _, ly, lx = _plan_corners(
        rrois, lvls, level_hw, strides, out_size, ratio, aligned)
    plan = np.stack([y0.astype(np.int32), x0.astype(np.int32),
                     ly.astype(np.float32).view(np.int32),
                     lx.astype(np.float32).view(np.int32)], -1)
    plan = np.where(inside[..., None], plan,
                    np.array([-1, 0, 0, 0], np.int32))
    return torch.from_numpy(plan)


def rotated_tile_binning(rrois, bidx, lvls, level_shapes, strides,
                         out_size, ratio=2, aligned=True, tile=BWD_TILE):
    """K4's backward's lists: every (roi, bin) of rotated rois [K, 5]
    once in each tile that a corner of one of its samples inside the map
    falls in, counted at the first sample (row-major in the bin) whose
    corners reach it, as the kernel's binning walks its plan (the
    corners of `rotated_sample_plan`).  Returns what `tile_binning` returns
    (bound: the same 4 K n^2)."""
    k, s = rrois.shape[0], out_size
    first, across, per_image = tile_layout(level_shapes, tile)
    inside, y0s, x0s = _plan_corners(rrois, lvls,
                                     [q[1:3] for q in level_shapes], strides,
                                     s, ratio, aligned)[:3]
    y0s = np.where(inside, y0s, -1).astype(np.int64).tolist()
    x0s = x0s.astype(np.int64).tolist()
    pairs = []
    for kk in range(k):
        l = int(lvls[kk])
        _, h, w, _ = level_shapes[l]
        base = first[l] + int(bidx[kk]) * per_image[l]
        for py in range(s):
            for px in range(s):
                e = (kk * s + py) * s + px
                seen = []
                for i in range(py * ratio, (py + 1) * ratio):
                    for j in range(px * ratio, (px + 1) * ratio):
                        y0, x0 = y0s[kk][i][j], x0s[kk][i][j]
                        if y0 < 0:
                            continue
                        for ty in sorted({y0 // tile,
                                          min(y0 + 1, h - 1) // tile}):
                            for tx in sorted({x0 // tile,
                                              min(x0 + 1, w - 1) // tile}):
                                t = base + ty * across[l] + tx
                                if t not in seen:
                                    seen.append(t)
                pairs += [(t, e) for t in seen]
    return _lists(pairs, first[-1], k * s * s, 4 * k * (s * ratio) ** 2)


def rotated_binned_backward(grad_out, rrois, bidx, lvls, level_shapes,
                            strides, ratio=2, aligned=True, tile=BWD_TILE):
    """K4's backward from its lists (`rotated_tile_binning`), summed
    tile by tile as `binned_backward` sums K2's.  Returns the levels'
    gradients [B, H, W, C] in grad_out's dtype."""
    s = grad_out.shape[1]
    compute = torch.promote_types(grad_out.dtype, torch.float32)
    rrois = rrois.to(compute)
    lists = rotated_tile_binning(rrois, bidx, lvls, level_shapes, strides, s,
                                 ratio, aligned, tile)
    ys, xs = rroi_align.sample_coords(rrois, lvls, strides, s, ratio,
                                      aligned)
    return tile_sums(grad_out, lists, ys, xs, lvls, level_shapes, ratio,
                     tile)


def _lists(pairs, num_tiles, num_bins, bound):
    """dict(entries, tiles, counts, offsets, bound) of (tile, bin id)
    pairs, sorted by tile then bin."""
    t = torch.tensor([p[0] for p in pairs], dtype=torch.long)
    e = torch.tensor([p[1] for p in pairs], dtype=torch.long)
    order = torch.argsort(t * max(num_bins, 1) + e)
    counts = torch.bincount(t, minlength=num_tiles)
    offsets = torch.zeros(num_tiles + 1, dtype=torch.long)
    offsets[1:] = torch.cumsum(counts, 0)
    return dict(entries=e[order], tiles=t[order], counts=counts,
                offsets=offsets, bound=bound)


def tile_sums(grad_out, lists, ys, xs, lvls, level_shapes, ratio=2,
              tile=BWD_TILE):
    """The accumulate pass of both backward kernels: each tile adds, for
    each of its entries (``lists``), the bin's grad_out times the
    weight of every corner of the bin's samples (ys, xs [K, n, n], the
    sample points) that lies in the tile (sums in float32, float64 for
    float64), and every tile is written once.  Returns the levels'
    gradients [B, H, W, C] in grad_out's dtype."""
    k, s = grad_out.shape[0], grad_out.shape[1]
    c = grad_out.shape[-1]
    compute = torch.promote_types(grad_out.dtype, torch.float32)
    first, across, per_image = tile_layout(level_shapes, tile)
    e, t = lists["entries"], lists["tiles"]
    kk, py, px = e // (s * s), (e // s) % s, e % s
    lv = lvls.long()[kk]
    # every entry's ratio x ratio samples: [E, ratio, ratio]
    iy = (py[:, None] * ratio + torch.arange(ratio))[:, :, None]
    ix = (px[:, None] * ratio + torch.arange(ratio))[:, None, :]
    y_s = ys.to(compute)[kk[:, None, None], iy, ix]
    x_s = xs.to(compute)[kk[:, None, None], iy, ix]
    hs = torch.tensor([q[1] for q in level_shapes])[lv][:, None, None]
    ws = torch.tensor([q[2] for q in level_shapes])[lv][:, None, None]
    inside = (y_s >= -1) & (y_s <= hs) & (x_s >= -1) & (x_s <= ws)
    y = torch.minimum(y_s.clamp(min=0.0), hs - 1)
    x = torch.minimum(x_s.clamp(min=0.0), ws - 1)
    y0, x0 = torch.floor(y), torch.floor(x)
    ly, lx = y - y0, x - x0
    y0, x0 = y0.long(), x0.long()
    y1, x1 = torch.minimum(y0 + 1, hs - 1), torch.minimum(x0 + 1, ws - 1)
    local = t - torch.tensor(first[:-1])[lv]
    img = (local // torch.tensor(per_image)[lv])[:, None, None]
    r = local % torch.tensor(per_image)[lv]
    ty = ((r // torch.tensor(across)[lv]) * tile)[:, None, None]
    tx = ((r % torch.tensor(across)[lv]) * tile)[:, None, None]
    g = grad_out.reshape(k * s * s, c).to(compute)[e]
    sizes = [math.prod(q) for q in level_shapes]
    level_off = torch.tensor([sum(sizes[:i]) for i in range(len(sizes))])
    grad = torch.zeros(sum(sizes) // c, c, dtype=compute)
    lo = (level_off[lv] // c)[:, None, None]
    for yc, xc, wgt in ((y0, x0, (1 - ly) * (1 - lx)),
                        (y0, x1, (1 - ly) * lx),
                        (y1, x0, ly * (1 - lx)), (y1, x1, ly * lx)):
        keep = (inside & (yc >= ty) & (yc < ty + tile) & (xc >= tx)
                & (xc < tx + tile))
        cell = lo + (img * hs + yc) * ws + xc
        rows = torch.arange(e.shape[0])[:, None, None].expand_as(keep)
        grad.index_add_(0, cell[keep],
                        g[rows[keep]] * (wgt[keep] / ratio ** 2)[:, None])
    grads = grad.reshape(-1).to(grad_out.dtype).split(sizes)
    return [q.view(shape) for q, shape in zip(grads, level_shapes)]
