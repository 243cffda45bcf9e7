"""The integer bookkeeping of kernels K1, K2's backward and K4's
backward, on the CPU.

The CUDA kernels run only on the card (tests/test_torch_port_kernels.py
holds them to the plain versions there); their plans are held here
through torch twins (tests/roi_kernel_twins.py):

- K1 (`csrc/roi_align.cu`): the kernel's one-pass listing of a roi's
  distinct corner rows and columns (`scan_axis`) equals a sort of them;
  a bin row reads at most 2 * ratio listed rows (the kernel's ring);
  the tiles cover a window's cells once, each within the budget; and a
  separable x-then-y reduction over the planned windows equals
  `roi_align_plain` (atol 1e-5, float32) and the JAX reference's XLA
  RoIAlign (atol 1e-5).
- K2's backward (`csrc/roi_align_backward.cu`): the tile of each
  corner, the entries per tile and their upper bound, and per-tile sums
  over the binned entries equal the autograd gradient of
  `batched_multilevel_roi_align` (1e-5 of the largest, float32; 1e-13
  float64) and the JAX reference's linear transpose (1e-5 of the
  largest).
- K4 (`csrc/rroi_align.cu`, `csrc/rroi_align_backward.cu`): the
  kernels' sample points, the roi's geometry once then each sample
  (`rotated_sample_twin`), equal the plain `sample_coords` bit for bit;
  the forward's plan (four corner cells and weights per sample, 1 /
  ratio^2 folded in, -1 outside the map) has the plain version's
  corners, and its per-bin sums equal `rroi_align_plain` and the JAX
  reference's `batched_rroi_align` (atol 1e-5, float32).  The
  backward's per-sample plan holds the same corners and weights' bits;
  each rotated bin is listed once in each distinct tile of its samples'
  corners (held to a brute-force listing of every corner), within the
  same bound, and the per-tile sums over the binned entries equal the
  autograd gradient of the plain `batched_rroi_align` (1e-5 of the
  largest, float32; 1e-13 float64) and the JAX reference's linear
  transpose (1e-5 of the largest).  Edge cases for both plans: theta a
  multiple of pi/2 with samples on cell and tile edges and on the map's
  edges, a roi wholly off the map, every roi on one tile, no rois.
"""

import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aidet_tpu_torch.ops import roi_align, rroi_align
from roi_kernel_twins import (BWD_TILE, axis_samples, bin_rows_span,
                              binned_backward, corners, planned_rroi_align,
                              rotated_binned_backward, rotated_forward_plan,
                              rotated_sample_plan, rotated_sample_twin,
                              rotated_tile_binning, scan_axis,
                              separable_roi_align, stripe_plan, tile_binning,
                              tile_layout, window_axis, window_plan)
from torch_port_helpers import (STRIDES, make_inputs, make_rroi_inputs,
                                to_np)

j_roi_align = importlib.import_module("aidet_tpu.ops.roi_align")
j_rroi_align = importlib.import_module("aidet_tpu.ops.rroi_align")

# K1's edge cases: a whole-image roi (level 3 by its size), 1:40 rois
# across and down, rois partly and fully outside the map, a tiny roi
EDGE_ROIS = [[0., 0., 255., 255.], [4., 100., 244., 106.],
             [120., 2., 126., 242.], [-30., -20., 40., 60.],
             [300., 310., 380., 400.], [200., 230., 290., 300.],
             [50., 50., 51.5, 50.5]]


def routed(seed, b=2, r=24, c=16, edge=True):
    feats, rois = make_inputs(seed, b=b, r=r, c=c)
    if edge:
        rois[0, :len(EDGE_ROIS)] = EDGE_ROIS
    tf = [torch.from_numpy(f) for f in feats]
    flat = torch.from_numpy(rois.reshape(-1, 4))
    lvls = roi_align.route_rois(flat, [f.shape[1:3] for f in tf], STRIDES)
    bidx = torch.arange(b).repeat_interleave(r)
    return tf, torch.from_numpy(rois), flat, lvls, bidx


@pytest.mark.parametrize("out_size,ratio,aligned", [
    (7, 2, True), (14, 1, True), (14, 3, True), (7, 2, False),
    (32, 2, True)])
def test_k1_scan_lists_distinct_corners(out_size, ratio, aligned):
    """The kernel's walk gives the sorted distinct corners and the same
    indices and weights as a sort, for every roi and both axes."""
    feats, _, flat, lvls, _ = routed(30)
    ys, xs = axis_samples(flat, lvls, STRIDES, out_size, ratio, aligned)
    for k in range(flat.shape[0]):
        h, w = feats[int(lvls[k])].shape[1:3]
        for p, size in ((ys[k], h), (xs[k], w)):
            listed, idx, wts = window_axis(p, size)
            s_listed, s_idx, s_wts = scan_axis(p, size)
            assert torch.equal(s_listed, listed)
            assert torch.equal(s_idx, idx)
            torch.testing.assert_close(s_wts, wts.to(s_wts.dtype),
                                       atol=1e-6, rtol=0)
            assert listed.numel() <= 2 * out_size * ratio


def test_k1_scan_walks_reversed_rois():
    """A roi with x2 < x1 (aligned mode does not clamp its size) has
    decreasing samples: the kernel walks them from the end."""
    p = 10.0 - torch.arange(14, dtype=torch.float32) * 0.7
    listed, idx, _ = window_axis(p, 16)
    s_listed, s_idx, _ = scan_axis(p, 16)
    assert torch.equal(s_listed, listed) and torch.equal(s_idx, idx)


@pytest.mark.parametrize("ratio", [1, 2, 3])
def test_k1_bin_row_fits_the_ring(ratio):
    """Every bin row reads at most 2 * ratio consecutive listed rows,
    which the kernel's ring of X rows holds."""
    feats, _, flat, lvls, _ = routed(31)
    for rows, ri, _, cols, ci, _ in window_plan(
            flat, lvls, [f.shape[1:3] for f in feats], STRIDES, 7, ratio,
            True):
        assert bin_rows_span(ri, ratio) <= 2 * ratio
        assert bin_rows_span(ci, ratio) <= 2 * ratio


@pytest.mark.parametrize("nrows,ncols,cap", [
    (28, 28, 32), (5, 6, 32), (3, 100, 32), (1, 1, 1), (40, 7, 16),
    (17, 33, 33), (0, 5, 8)])
def test_k1_stripes_cover_the_window_once(nrows, ncols, cap):
    seen = torch.zeros(nrows, ncols, dtype=torch.long)
    for q0, nr, s0, ns in stripe_plan(nrows, ncols, cap):
        assert 1 <= nr * ns <= cap
        seen[q0:q0 + nr, s0:s0 + ns] += 1
    assert bool((seen == 1).all())


@pytest.mark.parametrize("out_size,ratio,aligned,cap", [
    (7, 2, True, 32), (7, 2, True, 3), (14, 1, True, 32),
    (14, 3, True, 16), (7, 2, False, 32)])
def test_k1_separable_matches_plain(out_size, ratio, aligned, cap):
    """x-then-y over the planned windows, in tiles of ``cap`` cells (3:
    every row in stripes), equals the plain gather."""
    feats, _, flat, lvls, bidx = routed(32)
    got = separable_roi_align(feats, flat, bidx, lvls, out_size, STRIDES,
                              ratio, aligned, cap)
    ref = roi_align.roi_align_plain(feats, flat, bidx, lvls, out_size,
                                    STRIDES, ratio, aligned)
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=0)


def test_k1_separable_one_image_float64():
    """All rois on one image, in float64: equal to rounding."""
    feats, _, flat, lvls, bidx = routed(33, b=1, r=30)
    feats = [f.double() for f in feats]
    got = separable_roi_align(feats, flat, bidx, lvls, 7, STRIDES)
    ref = roi_align.roi_align_plain(feats, flat, bidx, lvls, 7, STRIDES)
    assert got.dtype == torch.float64
    torch.testing.assert_close(got, ref, atol=1e-12, rtol=0)


@pytest.mark.parametrize("out_size,aligned", [(7, True), (7, False)])
def test_k1_separable_matches_jax_reference(out_size, aligned):
    feats, rois, flat, lvls, bidx = routed(34)
    got = separable_roi_align(feats, flat, bidx, lvls, out_size, STRIDES,
                              aligned=aligned)
    ref = j_roi_align.batched_multilevel_roi_align(
        [jnp.asarray(to_np(f)) for f in feats], jnp.asarray(to_np(rois)),
        out_size, STRIDES, aligned=aligned)
    np.testing.assert_allclose(to_np(got).reshape(ref.shape),
                               np.asarray(ref), atol=1e-5)


def brute_force_tiles(flat, lvls, bidx, level_shapes, out_size, ratio):
    """{(bin id, tile id)} by walking every corner of every sample."""
    first, across, per_image = tile_layout(level_shapes)
    ys, xs = axis_samples(flat, lvls, STRIDES, out_size, ratio, True)
    pairs = set()
    for k in range(flat.shape[0]):
        l = int(lvls[k])
        _, h, w, _ = level_shapes[l]
        yin, y0, y1, _ = (t.tolist() for t in corners(ys[k], h))
        xin, x0, x1, _ = (t.tolist() for t in corners(xs[k], w))
        base = first[l] + int(bidx[k]) * per_image[l]
        for i in range(out_size * ratio):
            for j in range(out_size * ratio):
                if not (yin[i] and xin[j]):
                    continue
                e = (k * out_size + i // ratio) * out_size + j // ratio
                for yy in (y0[i], y1[i]):
                    for xx in (x0[j], x1[j]):
                        pairs.add((e, base + int(yy) // BWD_TILE * across[l]
                                   + int(xx) // BWD_TILE))
    return pairs


@pytest.mark.parametrize("ratio", [1, 2, 3])
def test_k2_tile_binning_counts(ratio):
    """One entry per (bin, tile) that a corner of the bin's samples
    falls in, found by the product of its tile rows and columns."""
    feats, _, flat, lvls, bidx = routed(35, r=12)
    shapes = [tuple(f.shape) for f in feats]
    lists = tile_binning(flat, bidx, lvls, shapes, STRIDES, 7, ratio)
    got = set(zip(lists["entries"].tolist(), lists["tiles"].tolist()))
    assert got == brute_force_tiles(flat, lvls, bidx, shapes, 7, ratio)
    assert len(got) == lists["entries"].numel()      # no duplicates
    counts = lists["counts"]
    assert counts.shape[0] == roi_align.backward_tile_count(shapes)
    assert int(counts.sum()) <= lists["bound"] \
        == 4 * flat.shape[0] * (7 * ratio) ** 2
    assert torch.equal(lists["offsets"][1:] - lists["offsets"][:-1], counts)


def test_k2_tiles_partition_the_cells():
    """Every cell of every level and image lies in exactly one tile, so
    writing each tile once writes the gradient once."""
    shapes = [(2, 13, 21, 8), (2, 7, 11, 8), (2, 4, 6, 8), (2, 2, 3, 8)]
    first, across, per_image = tile_layout(shapes)
    hits = torch.zeros(first[-1], dtype=torch.long)
    for l, (b, h, w, _) in enumerate(shapes):
        y, x = torch.meshgrid(torch.arange(h), torch.arange(w),
                              indexing="ij")
        for img in range(b):
            t = (first[l] + img * per_image[l] + y // BWD_TILE * across[l]
                 + x // BWD_TILE)
            hits += torch.bincount(t.flatten(), minlength=first[-1])
    cells = torch.tensor([min(BWD_TILE, h - ty * BWD_TILE)
                          * min(BWD_TILE, w - tx * BWD_TILE)
                          for b, h, w, _ in shapes for _ in range(b)
                          for ty in range(-(-h // BWD_TILE))
                          for tx in range(-(-w // BWD_TILE))])
    assert torch.equal(hits, cells)


def test_k2_scratch_size_matches_the_lists():
    feats, _, flat, lvls, bidx = routed(36, r=8)
    shapes = [tuple(f.shape) for f in feats]
    lists = tile_binning(flat, bidx, lvls, shapes, STRIDES, 7)
    t = lists["counts"].shape[0]
    assert roi_align.backward_scratch_ints(shapes, flat.shape[0], 7, 2) \
        == 3 * t + 1 + lists["bound"]


def plain_gradient(feats, rois, grad_out, out_size=7, aligned=True):
    leaves = [f.detach().clone().requires_grad_() for f in feats]
    out = roi_align.batched_multilevel_roi_align(leaves, rois, out_size,
                                                 aligned=aligned)
    return torch.autograd.grad(out, leaves, grad_out.reshape(out.shape))


@pytest.mark.parametrize("out_size,ratio_aligned", [
    (7, True), (14, True), (7, False)])
def test_k2_binned_backward_matches_autograd(out_size, ratio_aligned):
    feats, rois, flat, lvls, bidx = routed(37)
    g = torch.from_numpy(np.random.RandomState(37).randn(
        flat.shape[0], out_size, out_size, feats[0].shape[-1])
        .astype(np.float32))
    shapes = [tuple(f.shape) for f in feats]
    got = binned_backward(g, flat, bidx, lvls, shapes, STRIDES,
                          aligned=ratio_aligned)
    ref = plain_gradient(feats, rois, g, out_size, ratio_aligned)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and a.shape == b.shape
        scale = float(b.abs().max())
        torch.testing.assert_close(a, b, atol=1e-5 * scale, rtol=0)


def test_k2_binned_backward_float64_hot_tile():
    """200 rois stacked on one tile (a cluster on one gt), on one image,
    in float64: one tile's list dominates and the sums stay exact to
    rounding."""
    rng = np.random.RandomState(38)
    feats = [torch.from_numpy(rng.randn(1, 256 // s, 256 // s, 4))
             for s in STRIDES]
    xy = rng.uniform(100.5, 101.5, (200, 2))
    rois = np.concatenate([xy, xy + rng.uniform(2, 6, (200, 2))], -1)
    rois_b = torch.from_numpy(rois[None].astype(np.float32))
    flat = rois_b.reshape(-1, 4)
    shapes = [tuple(f.shape) for f in feats]
    lvls = roi_align.route_rois(flat, [s[1:3] for s in shapes], STRIDES)
    bidx = torch.zeros(200, dtype=torch.long)
    lists = tile_binning(flat, bidx, lvls, shapes, STRIDES, 7)
    counts = lists["counts"]
    assert int(counts.max()) >= 0.9 * int(counts.sum())
    g = torch.from_numpy(rng.randn(200, 7, 7, 4))
    got = binned_backward(g, flat, bidx, lvls, shapes, STRIDES)
    ref = plain_gradient([f for f in feats], rois_b.double(), g)
    for a, b in zip(got, ref):   # sums of ~800 terms: 1e-13 of the largest
        torch.testing.assert_close(a, b, atol=1e-13 * float(b.abs().max()),
                                   rtol=0)


def test_k2_binned_backward_no_rois():
    shapes = [(2, 64 // s, 64 // s, 8) for s in STRIDES]
    empty = torch.zeros(0, 4)
    lists = tile_binning(empty, torch.zeros(0, dtype=torch.long),
                         torch.zeros(0, dtype=torch.int32), shapes, STRIDES,
                         7)
    assert int(lists["counts"].sum()) == 0 and lists["bound"] == 0
    got = binned_backward(torch.zeros(0, 7, 7, 8, dtype=torch.bfloat16),
                          empty, torch.zeros(0, dtype=torch.long),
                          torch.zeros(0, dtype=torch.int32), shapes, STRIDES)
    for g, shape in zip(got, shapes):
        assert g.dtype == torch.bfloat16 and tuple(g.shape) == shape
        assert not bool(g.any())


def test_k2_binned_backward_matches_jax_transpose():
    """Against jax.vjp of the reference's XLA RoIAlign: its linear
    transpose, which the TPU kernel's custom_vjp returns."""
    feats, rois, flat, lvls, bidx = routed(39)
    c = feats[0].shape[-1]
    g = np.random.RandomState(39).randn(
        rois.shape[0], rois.shape[1], 7, 7, c).astype(np.float32)
    _, vjp = jax.vjp(
        lambda fs: j_roi_align.batched_multilevel_roi_align(
            fs, jnp.asarray(to_np(rois)), 7, STRIDES),
        [jnp.asarray(to_np(f)) for f in feats])
    ref = vjp(jnp.asarray(g))[0]
    got = binned_backward(torch.from_numpy(g.reshape(-1, 7, 7, c)), flat,
                          bidx, lvls, [tuple(f.shape) for f in feats],
                          STRIDES)
    for a, b in zip(got, ref):
        b = np.asarray(b)
        np.testing.assert_allclose(to_np(a), b,
                                   atol=1e-5 * np.abs(b).max())


def rotated_routed(seed, b=2, r=24, c=8):
    feats, rr = make_rroi_inputs(seed, b=b, r=r, c=c)
    tf = [torch.from_numpy(f) for f in feats]
    flat = torch.from_numpy(rr.reshape(-1, 5))
    lvls = rroi_align.route_rrois(flat, [f.shape[1:3] for f in tf], STRIDES)
    bidx = torch.arange(b).repeat_interleave(r)
    return tf, torch.from_numpy(rr), flat, lvls, bidx


def brute_force_rotated_tiles(flat, lvls, bidx, level_shapes, out_size,
                              ratio):
    """{(bin id, tile id)} by walking every corner of every sample."""
    first, across, per_image = tile_layout(level_shapes)
    ys, xs = rroi_align.sample_coords(flat, lvls, STRIDES, out_size, ratio)
    n = out_size * ratio
    pairs = set()
    for k in range(flat.shape[0]):
        l = int(lvls[k])
        _, h, w, _ = level_shapes[l]
        yin, y0, y1, _ = (t.tolist() for t in corners(ys[k], h))
        xin, x0, x1, _ = (t.tolist() for t in corners(xs[k], w))
        base = first[l] + int(bidx[k]) * per_image[l]
        for i in range(n):
            for j in range(n):
                if not (yin[i][j] and xin[i][j]):
                    continue
                e = (k * out_size + i // ratio) * out_size + j // ratio
                for yy in (y0[i][j], y1[i][j]):
                    for xx in (x0[i][j], x1[i][j]):
                        pairs.add((e, base + yy // BWD_TILE * across[l]
                                   + xx // BWD_TILE))
    return pairs


@pytest.mark.parametrize("ratio", [1, 2, 3])
def test_k4_rotated_binning_lists_every_corner_tile_once(ratio):
    """One entry per (bin, tile) that a corner of the rotated bin's
    samples falls in, whatever theta; the edge rois include a turned
    whole-image roi, rois across the map's last row and column, partly
    outside it, and smaller than a cell."""
    feats, _, flat, lvls, bidx = rotated_routed(50, r=12)
    shapes = [tuple(f.shape) for f in feats]
    lists = rotated_tile_binning(flat, bidx, lvls, shapes, STRIDES, 7, ratio)
    got = set(zip(lists["entries"].tolist(), lists["tiles"].tolist()))
    assert got == brute_force_rotated_tiles(flat, lvls, bidx, shapes, 7,
                                            ratio)
    assert len(got) == lists["entries"].numel()      # no duplicates
    counts = lists["counts"]
    assert counts.shape[0] == roi_align.backward_tile_count(shapes)
    assert int(counts.sum()) <= lists["bound"] \
        == 4 * flat.shape[0] * (7 * ratio) ** 2
    assert roi_align.backward_scratch_ints(shapes, flat.shape[0], 7, ratio) \
        == 3 * counts.shape[0] + 1 + lists["bound"]
    assert torch.equal(lists["offsets"][1:] - lists["offsets"][:-1], counts)


def rotated_plain_gradient(feats, rrois, grad_out, out_size=7, ratio=2,
                           aligned=True):
    leaves = [f.detach().clone().requires_grad_() for f in feats]
    out = rroi_align.batched_rroi_align(leaves, rrois, out_size, STRIDES,
                                        ratio, aligned=aligned)
    return torch.autograd.grad(out, leaves, grad_out.reshape(out.shape))


@pytest.mark.parametrize("out_size,ratio,aligned", [
    (7, 2, True), (7, 3, True), (5, 2, False)])
def test_k4_binned_backward_matches_autograd(out_size, ratio, aligned):
    feats, rr, flat, lvls, bidx = rotated_routed(51)
    g = torch.from_numpy(np.random.RandomState(51).randn(
        flat.shape[0], out_size, out_size, feats[0].shape[-1])
        .astype(np.float32))
    shapes = [tuple(f.shape) for f in feats]
    got = rotated_binned_backward(g, flat, bidx, lvls, shapes, STRIDES,
                                  ratio, aligned)
    ref = rotated_plain_gradient(feats, rr, g, out_size, ratio, aligned)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and a.shape == b.shape
        scale = float(b.abs().max())
        torch.testing.assert_close(a, b, atol=1e-5 * scale, rtol=0)


def test_k4_binned_backward_float64_hot_tile():
    """150 rotated rois stacked on one spot of one image (a cluster on
    one gt), in float64: one tile's list dominates and the sums stay
    exact to rounding."""
    rng = np.random.RandomState(52)
    feats = [torch.from_numpy(rng.randn(1, 256 // s, 256 // s, 4))
             for s in STRIDES]
    rr = np.concatenate([rng.uniform(100.5, 101.5, (150, 2)),
                         rng.uniform(2, 6, (150, 2)),
                         rng.uniform(-np.pi, np.pi, (150, 1))], -1)
    rr_b = torch.from_numpy(rr[None])
    flat = rr_b.reshape(-1, 5)
    shapes = [tuple(f.shape) for f in feats]
    lvls = rroi_align.route_rrois(flat, [q[1:3] for q in shapes], STRIDES)
    bidx = torch.zeros(150, dtype=torch.long)
    lists = rotated_tile_binning(flat, bidx, lvls, shapes, STRIDES, 7)
    counts = lists["counts"]
    assert int(counts.max()) >= 0.5 * int(counts.sum())
    g = torch.from_numpy(rng.randn(150, 7, 7, 4))
    got = rotated_binned_backward(g, flat, bidx, lvls, shapes, STRIDES)
    ref = rotated_plain_gradient(feats, rr_b, g)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, atol=1e-13 * float(b.abs().max()),
                                   rtol=0)


def test_k4_binned_backward_matches_jax_transpose():
    """Against jax.vjp of the reference's XLA rotated RoIAlign: its
    linear transpose, which the TPU kernel's _vjp_bwd returns."""
    feats, rr, flat, lvls, bidx = rotated_routed(53)
    c = feats[0].shape[-1]
    g = np.random.RandomState(53).randn(
        rr.shape[0], rr.shape[1], 7, 7, c).astype(np.float32)
    _, vjp = jax.vjp(
        lambda fs: j_rroi_align.batched_rroi_align(
            fs, jnp.asarray(to_np(rr)), 7, STRIDES),
        [jnp.asarray(to_np(f)) for f in feats])
    ref = vjp(jnp.asarray(g))[0]
    got = rotated_binned_backward(torch.from_numpy(g.reshape(-1, 7, 7, c)),
                                  flat, bidx, lvls,
                                  [tuple(f.shape) for f in feats], STRIDES)
    for a, b in zip(got, ref):
        b = np.asarray(b)
        np.testing.assert_allclose(to_np(a), b,
                                   atol=1e-5 * np.abs(b).max())


@pytest.mark.parametrize("out_size,ratio,aligned,dtype", [
    (7, 2, True, torch.float32), (7, 3, True, torch.float32),
    (5, 2, False, torch.float32), (14, 2, True, torch.float32),
    (7, 2, True, torch.float64)])
def test_k4_twin_points_equal_sample_coords(out_size, ratio, aligned, dtype):
    """The kernels' order of operations (geometry once per roi, then
    each sample) gives the plain version's sample points bit for bit,
    for any theta, routed with and without the window bump."""
    feats, _, flat, _, _ = rotated_routed(54)
    flat = flat.to(dtype)
    for bump in (False, True):
        lvls = rroi_align.route_rrois(flat, [f.shape[1:3] for f in feats],
                                      STRIDES, bump_to_window=bump)
        ys, xs = rroi_align.sample_coords(flat, lvls, STRIDES, out_size,
                                          ratio, aligned)
        ty, tx = rotated_sample_twin(flat, lvls, STRIDES, out_size, ratio,
                                     aligned)
        assert ty.dtype == tx.dtype == to_np(ys).dtype
        assert np.array_equal(ty, to_np(ys)) and np.array_equal(tx, to_np(xs))


@pytest.mark.parametrize("out_size,ratio,aligned", [
    (7, 2, True), (7, 3, True), (5, 2, False)])
def test_k4_forward_plan_holds_the_plain_corners(out_size, ratio, aligned):
    """Cell -1 exactly for the samples outside the map; else the plain
    version's clamped corners, and weights that sum to 1 / ratio^2."""
    feats, _, flat, lvls, _ = rotated_routed(55)
    level_hw = [tuple(f.shape[1:3]) for f in feats]
    cells, wts = rotated_forward_plan(flat, lvls, level_hw, STRIDES,
                                      out_size, ratio, aligned)
    ys, xs = rroi_align.sample_coords(flat, lvls, STRIDES, out_size, ratio,
                                      aligned)
    for k in range(flat.shape[0]):
        h, w = level_hw[int(lvls[k])]
        yin, y0, y1, _ = corners(ys[k], h)
        xin, x0, x1, _ = corners(xs[k], w)
        inside = yin & xin
        assert torch.equal(cells[k, ..., 0] >= 0, inside)
        want = torch.stack([y0 * w + x0, y0 * w + x1, y1 * w + x0,
                            y1 * w + x1], -1)
        assert torch.equal(cells[k][inside], want[inside])
        assert bool((cells[k][~inside] == -1).all())
        assert not bool(wts[k][~inside].any())
        torch.testing.assert_close(
            wts[k][inside].sum(-1),
            torch.full((int(inside.sum()),), 1.0 / ratio ** 2), atol=1e-6,
            rtol=0)


@pytest.mark.parametrize("out_size,ratio,aligned,bump", [
    (7, 2, True, False), (7, 2, True, True), (7, 3, True, False),
    (5, 2, False, False), (14, 2, True, False)])
def test_k4_forward_plan_matches_plain(out_size, ratio, aligned, bump):
    """The per-bin sums over the forward's plan equal the plain gather
    (float32, atol 1e-5: the two sum in other orders)."""
    feats, _, flat, _, bidx = rotated_routed(56)
    lvls = rroi_align.route_rrois(flat, [f.shape[1:3] for f in feats],
                                  STRIDES, bump_to_window=bump)
    got = planned_rroi_align(feats, flat, bidx, lvls, out_size, STRIDES,
                             ratio, aligned)
    ref = rroi_align.rroi_align_plain(feats, flat, bidx, lvls, out_size,
                                      STRIDES, ratio, aligned)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("aligned", [True, False])
def test_k4_forward_plan_matches_jax_reference(aligned):
    feats, rr, flat, lvls, bidx = rotated_routed(57)
    got = planned_rroi_align(feats, flat, bidx, lvls, 7, STRIDES,
                             aligned=aligned)
    ref = j_rroi_align.batched_rroi_align(
        [jnp.asarray(to_np(f)) for f in feats], jnp.asarray(to_np(rr)), 7,
        STRIDES, aligned=aligned)
    np.testing.assert_allclose(to_np(got).reshape(ref.shape),
                               np.asarray(ref), atol=1e-5)


def test_k4_backward_plan_holds_the_plain_corners():
    """The backward's plan entry of a sample: the plain version's (y0,
    x0) and the bits of its float32 (ly, lx), or y0 = -1 outside."""
    feats, _, flat, lvls, _ = rotated_routed(58)
    level_hw = [tuple(f.shape[1:3]) for f in feats]
    plan = rotated_sample_plan(flat, lvls, level_hw, STRIDES, 7)
    ys, xs = rroi_align.sample_coords(flat, lvls, STRIDES, 7)
    for k in range(flat.shape[0]):
        h, w = level_hw[int(lvls[k])]
        yin, y0, _, ly = corners(ys[k], h)
        xin, x0, _, lx = corners(xs[k], w)
        inside = yin & xin
        want = torch.stack([y0.int(), x0.int(), ly.view(torch.int32),
                            lx.view(torch.int32)], -1)
        assert torch.equal(plan[k][inside], want[inside])
        assert bool((plan[k][~inside] == torch.tensor([-1, 0, 0, 0],
                                                      dtype=torch.int32))
                    .all())


def test_k4_backward_work_buffer_size():
    """K4's backward keeps K2's scratch as it is, and sizes its own work
    buffer: one int4 per sample, 16 floats per possible entry, one int4
    per tile and 4 ints (the C interface's check)."""
    feats, _, flat, _, _ = rotated_routed(59, r=8)
    shapes = [tuple(f.shape) for f in feats]
    k, t = flat.shape[0], roi_align.backward_tile_count(shapes)
    kernel = rroi_align.rroi_align_backward_kernel
    for s, ratio in ((7, 2), (5, 3), (1, 1)):
        n = s * ratio
        assert roi_align.backward_scratch_ints(shapes, k, s, ratio) \
            == 3 * t + 1 + 4 * k * n * n
        work = kernel.work_ints(shapes, k, s, ratio)
        assert work == 4 * k * n * n + 16 * 4 * k * n * n + 4 * t + 4
        assert work % 4 == 0


# rotated rois of K4's edge cases on a 256^2 image (levels 64^2..8^2):
# at out_size 8, ratio 2, a roi of 64 px (level 0, 16 cells) or 128 px
# (level 1) puts its samples one cell apart at j - 7.5 cells from its
# centre, exactly; a centre at cell m + 0.5 then puts them on whole
# cells, every fourth on a tile edge: exactly at theta 0, and within an
# ulp on either side at the other multiples of pi/2 (a float32 theta
# is pi/2 to within 4.4e-8, so its cos is not 0)
HALF_PI = math.pi / 2
AXIS_EDGE_RROIS = (
    [[64., 64., 64., 64., q * HALF_PI] for q in (0, 1, 2, -1, 3, -2)]
    + [[128., 96., 128., 128., q * HALF_PI] for q in (0, 1, -3)]
    # across the map's last row (ys up to 64 = H) and its first (-1)
    + [[100., 228., 64., 64., 0.], [228., 100., 64., 64., HALF_PI],
       [100., 28., 64., 64., 0.], [28., 100., 64., 64., -HALF_PI]])


def edge_case_rrois(case):
    """Rotated rois [1, R, 5] of one of K4's edge cases, with the
    levels of a 256^2 image (C=4)."""
    rng = np.random.RandomState(60)
    feats = [torch.from_numpy(rng.randn(1, 256 // s, 256 // s, 4)
                              .astype(np.float32)) for s in STRIDES]
    if case == "axis_edges":
        rr = np.array(AXIS_EDGE_RROIS)
    elif case == "off_map":   # wholly off the map, and one on it
        rr = np.array([[-400., 120., 60., 40., 0.3],
                       [120., 900., 300., 200., -2.0],
                       [120., 120., 60., 40., 0.3]])
    elif case == "one_tile":  # level 0's tile (6, 6): cells 24..27
        rr = np.concatenate([rng.uniform(102, 106, (12, 2)),
                             rng.uniform(0.5, 2, (12, 2)),
                             rng.uniform(-np.pi, np.pi, (12, 1))], -1)
    else:                     # no rois
        rr = np.zeros((0, 5))
    return feats, torch.from_numpy(rr[None].astype(np.float32))


@pytest.mark.parametrize("case", ["axis_edges", "off_map", "one_tile",
                                  "no_rois"])
def test_k4_plans_edge_cases(case):
    """Both plans on K4's edge cases: the forward's sums equal the plain
    version (atol 1e-5), the backward's lists equal the brute-force
    listing and its sums the autograd gradient (1e-5 of the largest)."""
    feats, rr = edge_case_rrois(case)
    flat = rr.reshape(-1, 5)
    k = flat.shape[0]
    shapes = [tuple(f.shape) for f in feats]
    level_hw = [q[1:3] for q in shapes]
    lvls = rroi_align.route_rrois(flat, level_hw, STRIDES)
    bidx = torch.zeros(k, dtype=torch.long)
    for s in (8, 7):
        got = planned_rroi_align(feats, flat, bidx, lvls, s, STRIDES)
        ref = rroi_align.rroi_align_plain(feats, flat, bidx, lvls, s,
                                          STRIDES)
        assert got.shape == ref.shape == (k, s, s, 4)
        torch.testing.assert_close(got, ref, atol=1e-5, rtol=0)
        lists = rotated_tile_binning(flat, bidx, lvls, shapes, STRIDES, s)
        pairs = set(zip(lists["entries"].tolist(), lists["tiles"].tolist()))
        assert pairs == brute_force_rotated_tiles(flat, lvls, bidx, shapes,
                                                  s, 2)
        assert len(pairs) == lists["entries"].numel()
        g = torch.from_numpy(np.random.RandomState(61).randn(k, s, s, 4)
                             .astype(np.float32))
        grads = rotated_binned_backward(g, flat, bidx, lvls, shapes, STRIDES)
        leaves = [f.clone().requires_grad_() for f in feats]
        ref_g = torch.autograd.grad(
            rroi_align.batched_rroi_align(leaves, rr, s, STRIDES), leaves,
            g[None], allow_unused=True)
        for a, b in zip(grads, ref_g):
            b = torch.zeros_like(a) if b is None else b
            torch.testing.assert_close(
                a, b, atol=1e-5 * max(float(b.abs().max()), 1e-30), rtol=0)
    ys, xs = rotated_sample_twin(flat, lvls, STRIDES, 8)
    cells = rotated_forward_plan(flat, lvls, level_hw, STRIDES, 8)[0]
    counts = rotated_tile_binning(flat, bidx, lvls, shapes, STRIDES,
                                  8)["counts"]
    if case == "axis_edges":
        off = np.maximum(np.abs(ys - np.round(ys)), np.abs(xs - np.round(xs)))
        assert off[:9].max() <= 4e-6 and not off[[0, 6]].any()
        assert ((ys % BWD_TILE == 0) & (xs % BWD_TILE == 0)).any()
        below = (ys < np.round(ys)) & (off < 4e-6)   # floor one cell lower
        assert below.any() and (ys[~below] == np.round(ys[~below])).any()
        assert (ys == 64.0).any() and (ys == -1.0).any()
    elif case == "off_map":
        assert bool((cells[:2] == -1).all()) and bool((cells[2] >= 0).any())
        assert not bool(got[:2].any())
        assert int(counts.sum()) > 0
    elif case == "one_tile":
        assert int((counts > 0).sum()) == 1
        assert int(counts.max()) == k * 8 * 8
    else:
        assert int(counts.sum()) == 0 and lists["bound"] == 0


# K3 (`csrc/roi_align_bandx.cu`): its plan kernel sorts the rois by
# (image, level, band) key and first sample column and writes each
# chunk's staged box; `roi_align.bandx_chunks` is its twin, which the
# card's plan equals (tests/test_torch_port_kernels.py)
def k3_rois(case, seed=70):
    """Rois [2, R, 4] on a 256^2 image, routed without the window bump:
    "mixed" (make_inputs, with EDGE_ROIS), "hot" (one image's 500 rois
    of 8..40 px whose first sample rows all fall in level 0's band 1,
    rows 16..31), "tall" (rois that reach beyond their band), or
    "none"."""
    rng = np.random.RandomState(seed)
    if case == "mixed":
        return routed(seed, r=40)[1]
    if case == "none":
        return torch.zeros((2, 0, 4))
    if case == "hot":
        n = 500
        y = rng.uniform(66, 126, n)
        x = rng.uniform(0, 210, n)
        s = rng.uniform(8, 40, (n, 2))
        rois = np.stack([x, y, x + s[:, 0], y + s[:, 1]], -1)
        other = np.array(make_inputs(seed, b=1, r=n)[1][0])
        return torch.from_numpy(np.stack([rois, other]).astype(np.float32))
    x = rng.uniform(0, 200, (2, 30))
    y = rng.uniform(0, 60, (2, 30))
    rois = np.stack([x, y, x + rng.uniform(4, 12, (2, 30)),
                     y + rng.uniform(150, 250, (2, 30))], -1)
    return torch.from_numpy(rois.astype(np.float32))


def k3_plan(rois_b, stage_cells=None, out_size=7, ratio=2, aligned=True):
    level_hw = [(256 // s, 256 // s) for s in STRIDES]
    b, r = rois_b.shape[:2]
    flat = rois_b.reshape(b * r, 4)
    lvls = roi_align.route_rois(flat, level_hw, STRIDES)
    bidx = torch.arange(b).repeat_interleave(r)
    ch = roi_align.bandx_chunks(flat, bidx, lvls, level_hw, STRIDES, b,
                                out_size, ratio, aligned, stage_cells)
    return ch, flat, lvls, bidx, level_hw


def k3_corners(flat, lvls, level_hw, out_size, ratio, aligned):
    """Per roi the (row, column) cells [K, 4 n^2, 2] that its samples
    inside the map read (the plain version's corners), and which of
    them are read [K, 4 n^2] (bool)."""
    ys, xs = roi_align.sample_coords(flat, lvls, STRIDES, out_size, ratio,
                                     aligned)
    hs = torch.tensor([h for h, _ in level_hw])[lvls.long()][:, None, None]
    ws = torch.tensor([w for _, w in level_hw])[lvls.long()][:, None, None]
    inside = (ys >= -1) & (ys <= hs) & (xs >= -1) & (xs <= ws)
    y0 = torch.floor(torch.minimum(ys.clamp(min=0), hs - 1.0)).long()
    x0 = torch.floor(torch.minimum(xs.clamp(min=0), ws - 1.0)).long()
    y1, x1 = torch.minimum(y0 + 1, hs - 1), torch.minimum(x0 + 1, ws - 1)
    k = flat.shape[0]
    cells = torch.stack([torch.stack([yy, xx], -1).reshape(k, -1, 2)
                         for yy in (y0, y1) for xx in (x0, x1)], 1)
    return cells.reshape(k, -1, 2), inside.reshape(k, 1, -1).expand(
        k, 4, -1).reshape(k, -1)


@pytest.mark.parametrize("case,stage_cells,out_size,ratio,aligned", [
    ("mixed", None, 7, 2, True), ("mixed", 64, 7, 2, True),
    ("mixed", 150, 7, 3, False), ("hot", None, 7, 2, True),
    ("hot", 96, 14, 2, True), ("tall", 2048, 7, 2, True)])
def test_k3_boxes_hold_their_chunks_samples(case, stage_cells, out_size,
                                             ratio, aligned):
    """Every cell that a chunk's rois read inside its band lies in the
    chunk's staged box, and the uncapped box is the hull of the cells
    they read, its rows clipped to the band;
    where the budget caps a box (rows x columns <= stage_cells), the
    cells it loses are the box's last columns, counted here, and they
    are all that the kernel reads from global memory within the band."""
    rois_b = k3_rois(case)
    ch, flat, lvls, bidx, level_hw = k3_plan(rois_b, stage_cells, out_size,
                                             ratio, aligned)
    full = k3_plan(rois_b, None, out_size, ratio, aligned)[0]
    cells, read = k3_corners(flat, lvls, level_hw, out_size, ratio, aligned)
    hs = torch.tensor([h for h, _ in level_hw])
    lost = beyond_band = 0
    for c in torch.nonzero(ch.count).flatten().tolist():
        members = ch.perm[ch.start[c]:ch.start[c] + ch.count[c]]
        y0, rows, x0, cols = ch.box[c].tolist()
        fy0, frows, fx0, fcols = full.box[c].tolist()
        assert (fy0, frows, fx0) == (y0, rows, x0) and cols <= fcols
        assert stage_cells is None or rows * cols <= stage_cells
        band_end = min(int(ch.row0[c]) + roi_align.BAND_H,
                       int(hs[lvls[members[0]]]))
        got = cells[members][read[members]]
        in_band = (got[:, 0] >= ch.row0[c]) & (got[:, 0] < band_end)
        beyond_band += int((~in_band).sum())
        if not bool(in_band.any()):
            assert rows * cols == 0
            continue
        # the hull of the cells read, its rows clipped to the band
        assert (fy0, fy0 + frows - 1, fx0, fx0 + fcols - 1) == (
            max(int(got[:, 0].min()), int(ch.row0[c])),
            min(int(got[:, 0].max()), band_end - 1),
            int(got[:, 1].min()), int(got[:, 1].max()))
        got = got[in_band]
        out = got[:, 1] >= x0 + cols
        assert bool((got[:, 0] >= y0).all() and (got[:, 0] < y0 + rows).all()
                    and (got[:, 1] >= x0).all())
        lost += int(out.sum())
    if stage_cells is None:
        assert lost == 0
    elif case != "tall":
        assert lost > 0            # the budget bites in these cases
    if case == "tall":
        assert beyond_band > 0 and lost == 0


@pytest.mark.parametrize("case", ["mixed", "hot", "tall", "none"])
def test_k3_chunks_stay_within_the_static_bound(case):
    """The chunks in use never exceed `bandx_chunk_bound`, the grid the
    wrapper launches without a host synchronisation; each holds at most
    `bandx_chunk_size` rois of one key, in order, and every roi once."""
    rois_b = k3_rois(case)
    ch, flat, lvls, bidx, level_hw = k3_plan(rois_b)
    k = flat.shape[0]
    bound = roi_align.bandx_chunk_bound(k, level_hw, 2, 7)
    assert ch.start.shape[0] == bound == -(-k // 18) + 2 * (4 + 2 + 1 + 1)
    used = ch.count > 0
    assert int(used.sum()) <= bound
    n_used = int(used.sum())
    assert bool(used[:n_used].all()) and not bool(used[n_used:].any())
    assert bool((ch.count <= 18).all()) and int(ch.count.sum()) == k
    assert bool((ch.start[~used] == k).all())
    assert sorted(ch.perm.tolist()) == list(range(k))
    if case == "hot":
        # one image's 500 rois in one key: 28 chunks, full but the last
        hot = (ch.count > 0) & (bidx[ch.perm[ch.start.clamp(max=k - 1)]]
                                == 0)
        counts = ch.count[hot].tolist()
        assert counts == [18] * 27 + [500 - 27 * 18]
    if case == "none":
        assert k == 0 and n_used == 0 and bool((ch.box == 0).all())


@pytest.mark.parametrize("case", ["mixed", "hot"])
def test_k3_chunks_follow_x_within_a_key(case):
    """Within an (image, level, band) key the rois are sorted by their
    first sample column, ties in the caller's order: a chunk's rois are
    neighbours in x."""
    rois_b = k3_rois(case)
    ch, flat, lvls, bidx, level_hw = k3_plan(rois_b)
    first_y, first_x, _ = roi_align.bandx_roi_extents(flat, lvls, level_hw,
                                                      STRIDES)
    ys, xs = roi_align.sample_coords(flat, lvls, STRIDES, 7, 2, True)
    ws = torch.tensor([w for _, w in level_hw])[lvls.long()]
    assert torch.equal(first_x, torch.floor(torch.minimum(
        xs[:, 0, 0].clamp(min=0), ws - 1.0)).long())
    hs = torch.tensor([h for h, _ in level_hw])[lvls.long()]
    band = torch.minimum(first_y, (hs - hs.clamp(max=32)).clamp(min=0)) \
        // roi_align.BAND_S
    p = ch.perm
    key = torch.stack([bidx[p], lvls[p].long(), band[p]], 1)
    same = (key[1:] == key[:-1]).all(1)
    step = first_x[p][1:] - first_x[p][:-1]
    assert bool((step[same] >= 0).all())
    tie = same & (step == 0)
    assert bool((p[1:][tie] > p[:-1][tie]).all())
    if case == "hot":
        assert int(same.sum()) >= 499 - 1 and bool((step[same] > 0).any())
