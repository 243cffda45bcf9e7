"""The RRoI slice's codecs and RoIAlign ops in the PyTorch port, on the
CPU against the JAX package.

- Codecs (`core/rboxes.py`): pointobb2thetaobb, pointobb2delta /
  delta2pointobb and rtheta2delta / delta2rtheta against the
  reference's in float32, within 1e-5 (absolute, and relative for
  pixel coordinates of up to a few hundred, whose float32 ulp is up to
  3e-5).  The quads are rectangles of aspect 1.3 and more, perturbed
  by up to 2 px, with angles 0.05 rad or more away from the fold at
  -pi/2 and 0, and kept only where the smallest candidate rectangle's
  area is 1e-3 below the next: away from the ties where float rounding
  may flip pointobb2thetaobb's choice between two candidate edges (two
  nearly parallel edges, or near-square quads, whose rectangle comes
  back with theta shifted by pi/2 and w, h swapped).  Quads drawn
  without that filter are compared as corner sets, through
  thetaobb2pointobb.
- K4's plain version (`ops/rroi_align.py::batched_rroi_align`) against
  the reference's XLA `batched_rroi_align` in float32 (atol 1e-5),
  with rois partly off the map and thetas over [-pi/2, 0); with
  bump_to_window=True, its routing against `_prepare_rot` (exact) and
  its output against the TPU kernel `rroi_align_pallas` in interpret
  mode in bfloat16 (atol 0.06, the TPU kernel's bfloat16 interpolation
  matrix; tests/test_rroi_pallas.py holds that kernel to XLA alike).
- K3's plain version (`ops/roi_align.py::roi_align_bandx_plain`): its
  chunks against the reference's band assignment, its output equal to
  K1's plain version bit for bit, and against the TPU kernel
  `roi_align_bandx` in interpret mode in bfloat16 (atol 0.05, as K1 is
  held to `roi_align_band`).
The kernels themselves are tested on the card by
tests/test_torch_port_kernels.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aidet_tpu.core import rboxes as jrb
from aidet_tpu.ops.roi_align_pallas import _prepare
from aidet_tpu.ops.rroi_align import batched_rroi_align as j_rroi
from aidet_tpu.ops.rroi_align_pallas import _prepare_rot

import chip_smoke
from aidet_tpu_torch.core import rboxes as trb
from aidet_tpu_torch.ops import roi_align, rroi_align
from torch_port_helpers import STRIDES, make_inputs, to_np

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def _rects(rng, n, min_aspect=1.3, tie_free=True):
    """thetaobbs of aspect >= min_aspect, angles 0.05 rad or more from
    the fold, and their corners perturbed by up to 2 px.  ``tie_free``
    keeps the quads whose smallest candidate area is 1e-3 (relative)
    below the next one, so that float rounding cannot flip the pick."""
    w = rng.uniform(10, 120, 4 * n)
    h = w / rng.uniform(min_aspect, 4.0, 4 * n)
    swap = rng.rand(4 * n) < 0.5
    w, h = np.where(swap, h, w), np.where(swap, w, h)
    tob = np.stack([rng.uniform(50, 400, 4 * n),
                    rng.uniform(50, 400, 4 * n), w, h,
                    rng.uniform(-np.pi / 2 + 0.05, -0.05, 4 * n)], -1)
    quad = np.asarray(jrb.thetaobb2pointobb(jnp.asarray(tob, jnp.float32)))
    quad = quad + rng.uniform(-2.0, 2.0, quad.shape)
    if tie_free:
        clear = chip_smoke.rbox_clear_of_ties(torch.from_numpy(quad[None]))
        keep = np.nonzero(to_np(clear[0]))[0][:n]
        assert len(keep) == n
        tob, quad = tob[keep], quad[keep]
    return tob[:n], quad[:n].astype(np.float32)


def test_pointobb2thetaobb_matches_reference():
    _, quad = _rects(np.random.RandomState(0), 256)
    got = trb.pointobb2thetaobb(_t(quad))
    ref = jrb.pointobb2thetaobb(jnp.asarray(quad, jnp.float32))
    np.testing.assert_allclose(to_np(got), np.asarray(ref), **TOL)


def test_pointobb2thetaobb_near_square_as_corner_sets():
    """Quads near the tie: the two frameworks may pick either candidate
    edge, so the rectangles are compared as sets of 4 corners."""
    _, quad = _rects(np.random.RandomState(1), 128, min_aspect=1.0,
                     tie_free=False)
    got = to_np(trb.thetaobb2pointobb(trb.pointobb2thetaobb(_t(quad))))
    ref = np.asarray(jrb.thetaobb2pointobb(
        jrb.pointobb2thetaobb(jnp.asarray(quad, jnp.float32))))
    g, r = got.reshape(-1, 4, 1, 2), ref.reshape(-1, 1, 4, 2)
    nearest = np.abs(g - r).max(-1).min(-1)       # each corner's partner
    assert nearest.max() < 1e-3


def test_pointobb_codec_matches_reference():
    rng = np.random.RandomState(2)
    n, k = 64, 3
    _, quad = _rects(rng, n)
    xy = quad.reshape(n, 4, 2)
    rois = np.concatenate([xy.min(1) - rng.uniform(0, 9, (n, 2)),
                           xy.max(1) + rng.uniform(0, 9, (n, 2))], -1)
    means, stds = (0.01,) * 8, (0.1,) * 4 + (0.2,) * 4
    got = trb.pointobb2delta(_t(rois), _t(quad), means, stds)
    ref = jrb.pointobb2delta(jnp.asarray(rois, jnp.float32),
                             jnp.asarray(quad, jnp.float32), means, stds)
    np.testing.assert_allclose(to_np(got), np.asarray(ref), **TOL)
    deltas = rng.randn(n, 8 * k).astype(np.float32)
    got = trb.delta2pointobb(_t(rois), _t(deltas), means, stds,
                             wh_ratio_clip=1e-9)    # ignored on both sides
    ref = jrb.delta2pointobb(jnp.asarray(rois, jnp.float32),
                             jnp.asarray(deltas), means, stds)
    np.testing.assert_allclose(to_np(got), np.asarray(ref), **TOL)


def test_rtheta_codec_matches_reference_and_round_trips():
    rng = np.random.RandomState(3)
    n, k = 64, 2
    rrois, _ = _rects(rng, n)
    gt = rrois + np.stack([rng.uniform(-8, 8, n), rng.uniform(-8, 8, n),
                           rng.uniform(-4, 4, n), rng.uniform(-3, 3, n),
                           rng.uniform(-0.2, 0.2, n)], -1)
    means, stds = (0.0,) * 5, (0.1, 0.1, 0.2, 0.2, 0.1)
    got = trb.rtheta2delta(_t(rrois), _t(gt), means, stds)
    ref = jrb.rtheta2delta(jnp.asarray(rrois, jnp.float32),
                           jnp.asarray(gt, jnp.float32), means, stds)
    np.testing.assert_allclose(to_np(got), np.asarray(ref), **TOL)
    back = trb.delta2rtheta(_t(rrois), got, means, stds)
    np.testing.assert_allclose(to_np(back), gt, rtol=1e-4, atol=1e-3)
    deltas = rng.randn(n, 5 * k).astype(np.float32)
    got = trb.delta2rtheta(_t(rrois), _t(deltas), means, stds)
    ref = jrb.delta2rtheta(jnp.asarray(rrois, jnp.float32),
                           jnp.asarray(deltas), means, stds)
    np.testing.assert_allclose(to_np(got), np.asarray(ref), **TOL)


def _rrois(rng, b, r, img, big=0):
    """Rotated rois [b, r, 5]: centres up to 20 px off the map, sizes
    2..160 px, thetas over [-pi/2, 0); the first ``big`` of each image
    large and elongated, which the TPU kernel bumps to coarser levels."""
    cxcy = rng.uniform(-20, img + 20, (b, r, 2))
    wh = rng.uniform(2, 160, (b, r, 2))
    th = rng.uniform(-np.pi / 2, 0, (b, r, 1))
    th[:, 0] = -np.pi / 2
    out = np.concatenate([cxcy, wh, th], -1)
    if big:
        out[:, :big, 2:4] = [[200.0, 40.0], [60.0, 150.0],
                             [230.0, 230.0]][:big]
        out[:, :big, :2] = img / 2
    return out.astype(np.float32)


def _levels(rng, b, c, img):
    return [rng.randn(b, img // s, img // s, c).astype(np.float32)
            for s in STRIDES]


def test_map_rroi_levels_matches_reference():
    from aidet_tpu.ops.rroi_align import map_rroi_levels
    rr = _rrois(np.random.RandomState(4), 2, 40, 256).reshape(-1, 5)
    np.testing.assert_array_equal(
        to_np(rroi_align.map_rroi_levels(_t(rr), 4)),
        np.asarray(map_rroi_levels(jnp.asarray(rr), 4)))


def test_rroi_plain_matches_xla_reference():
    rng = np.random.RandomState(5)
    feats = _levels(rng, 2, 16, 256)
    rr = _rrois(rng, 2, 24, 256, big=3)
    got = rroi_align.rroi_align_forward([_t(f) for f in feats], _t(rr), 7,
                                        STRIDES)
    ref = j_rroi([jnp.asarray(f) for f in feats], jnp.asarray(rr), 7,
                 STRIDES)
    assert got.shape == ref.shape and got.dtype == torch.float32
    np.testing.assert_allclose(to_np(got), np.asarray(ref), atol=1e-5)


def test_bumped_rroi_routing_matches_tpu_prepare():
    rng = np.random.RandomState(6)
    feats = _levels(rng, 2, 8, 256)
    rr = _rrois(rng, 2, 24, 256, big=3).reshape(-1, 5)
    ref = _prepare_rot([jnp.asarray(f) for f in feats], jnp.asarray(rr), 7,
                       STRIDES, 2, 56, True)[0]
    hw = [f.shape[1:3] for f in feats]
    got = rroi_align.route_rrois(_t(rr), hw, STRIDES, bump_to_window=True)
    np.testing.assert_array_equal(to_np(got), np.asarray(ref))
    plain = rroi_align.route_rrois(_t(rr), hw, STRIDES)
    assert (to_np(got) != to_np(plain)).sum() >= 4    # the big rois


@pytest.fixture()
def rroi_interpret(monkeypatch):
    """The TPU kernel in interpret mode, as tests/test_rroi_pallas.py
    runs it."""
    monkeypatch.setenv("AIDET_RROI_INTERPRET", "1")


def test_bumped_rroi_plain_matches_tpu_kernel(rroi_interpret):
    from aidet_tpu.ops.rroi_align_pallas import rroi_align_pallas
    rng = np.random.RandomState(7)
    feats = _levels(rng, 2, 128, 256)
    rr = _rrois(rng, 2, 12, 256, big=3)
    rr[..., :2] = np.clip(rr[..., :2], 0, 255)
    got = rroi_align.rroi_align_forward(
        [_t(f).bfloat16() for f in feats], _t(rr), 7, STRIDES,
        bump_to_window=True)
    assert got.dtype == torch.bfloat16
    ref = rroi_align_pallas([jnp.asarray(f).astype(jnp.bfloat16)
                             for f in feats], jnp.asarray(rr), 7, STRIDES)
    np.testing.assert_allclose(to_np(got.float()),
                               np.asarray(ref, np.float32), atol=0.06)


def _routed(seed, r=32, c=16):
    feats, rois = make_inputs(seed, r=r, c=c)
    rois = np.clip(rois, 0, 255)
    tf = [_t(f) for f in feats]
    flat = _t(rois.reshape(-1, 4))
    lvls = roi_align.route_rois(flat, [f.shape[1:3] for f in feats],
                                STRIDES, bump_to_window=True)
    bidx = torch.arange(2).repeat_interleave(r)
    return feats, rois, tf, flat, lvls, bidx


def test_bandx_chunks_follow_the_reference_bands():
    """Every chunk holds at most 128 // 7 rois of one (image, level,
    band) key, in sorted order; the bands are those of the reference's
    `_prepare`, each chunk's row0 the reference's band origin."""
    feats, rois, tf, flat, lvls, bidx = _routed(8, r=40)
    ch = roi_align.bandx_chunks(flat, bidx, lvls,
                                [f.shape[1:3] for f in feats], STRIDES, 2)
    k = flat.shape[0]
    assert ch.size == 18
    assert sorted(to_np(ch.perm).tolist()) == list(range(k))
    _, _, wy, *_ = _prepare([jnp.asarray(f) for f in feats],
                            jnp.asarray(rois), 7, STRIDES, 2, 56, True,
                            use_small=False, with_coords=True)
    band = np.asarray(wy) // roi_align.BAND_S
    key = np.stack([to_np(bidx), to_np(lvls), band], -1)
    hps = [-(-f.shape[1] // 16) * 16 for f in feats]
    used = to_np(ch.count) > 0
    covered = []
    for start, count, row0 in zip(to_np(ch.start)[used],
                                  to_np(ch.count)[used],
                                  to_np(ch.row0)[used]):
        assert 1 <= count <= ch.size
        idx = to_np(ch.perm)[start:start + count]
        assert (key[idx] == key[idx[0]]).all()
        b, lvl, bd = key[idx[0]]
        assert row0 == min(bd * 16, max(hps[lvl] - min(48, hps[lvl]), 0))
        covered += list(range(start, start + count))
    assert covered == list(range(k))
    assert len(set(to_np(ch.pos).tolist())) == k


def test_bandx_plain_equals_k1_plain():
    _, rois, tf, *_ = _routed(9)
    for bump in (False, True):
        got = roi_align.roi_align_bandx_forward(tf, _t(rois), 7, STRIDES,
                                                bump_to_window=bump)
        ref = roi_align.batched_multilevel_roi_align(tf, _t(rois), 7,
                                                     STRIDES,
                                                     bump_to_window=bump)
        assert torch.equal(got, ref)


def test_bandx_plain_matches_tpu_kernel(monkeypatch):
    from aidet_tpu.ops.roi_align_bandx import roi_align_bandx
    monkeypatch.setenv("AIDET_BANDX_INTERPRET", "1")
    feats, rois = make_inputs(10, r=16, c=128)
    rois = np.clip(rois, 0, 255)
    tf = [_t(f).bfloat16() for f in feats]
    jf = [jnp.asarray(f).astype(jnp.bfloat16) for f in feats]
    before = roi_align.roi_align_bandx_kernel.launches
    got = roi_align.roi_align_bandx_forward(tf, _t(rois), 7, STRIDES,
                                            bump_to_window=True)
    assert got.dtype == torch.bfloat16
    assert roi_align.roi_align_bandx_kernel.launches == before
    ref = roi_align_bandx(jf, jnp.asarray(rois), 7, STRIDES)
    np.testing.assert_allclose(to_np(got.float()),
                               np.asarray(ref, np.float32), atol=0.05)
