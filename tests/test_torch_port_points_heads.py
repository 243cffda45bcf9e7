"""The anchor-free detectors of the PyTorch port against the JAX
reference on the CPU: `distance2bbox`, `fcos_target` (with and without
centre sampling, two gts of equal area), `point_assign`, `atss_assign`
(a gt centred midway between anchor centres: tied distances), the IoU,
bounded IoU and GIoU losses, the FCOS, ATSS, Fovea and RepPoints heads,
`fovea_target`, the moment transform (its gradient finite at
coincident points), and the small FCOS (with and without centre
sampling), ATSS (with a tied gt), FOVEA and RepPoints (minmax,
partial_minmax and moment, with GN towers and without) detectors whole:
predict and one loss.

The detectors are tests/torch_port_pairs.py's `dense_cfg`: ResNet-18, a
64-channel FPN P3-P7, one tower conv of 64 channels, 16 classes, 128^2
images of zero-mean noise (`dense_batch`; these detectors read their
images as they are), the reference's variables from `dense_variables`
(the per-level scales near 1).

Bounds, float32: targets and assignments equal (centerness and box
targets within 1e-5); boxes of `distance2bbox` within 1e-5 px; losses
of the loss functions within 1e-5 relative; heads' outputs within 1e-5
of their largest magnitude (2e-4 with GroupNorm, whose flax statistics
are E[x^2] - E[x]^2); detections' valid and labels equal, boxes within
1e-2 px and scores within 1e-4, paired in any order
(`assert_matched`: scores a rounding apart may rank either way); each
loss within 1e-4 relative.  The
gpu-marked case runs chip_smoke's reference phases of these families
(the card against the CPU).
"""

import numpy as np
import pytest
import torch

from aidet_tpu_torch.core.assign import point_assign
from aidet_tpu_torch.core.atss import atss_assign
from aidet_tpu_torch.core.boxes import distance2bbox
from aidet_tpu_torch.core.points import (build_pyramid_points, fcos_target,
                                         level_values)
from aidet_tpu_torch.models.heads.reppoints_head import (points2bbox_minmax,
                                                        points2bbox_moment)
from aidet_tpu_torch.models import losses as tl
from torch_port_helpers import to_np
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

try:
    import jax
    import jax.numpy as jnp

    from aidet_tpu.core.anchors import build_pyramid_anchors as j_anchors
    from aidet_tpu.core.assign import point_assign as j_point_assign
    from aidet_tpu.core.atss import atss_assign as j_atss_assign
    from aidet_tpu.core.boxes import distance2bbox as j_distance2bbox
    from aidet_tpu.core.points import fcos_target as j_fcos_target
    from aidet_tpu.models.heads import atss_head as j_atss
    from aidet_tpu.models.heads import fcos_head as j_fcos
    from aidet_tpu.models.heads import fovea_head as j_fovea
    from aidet_tpu.models.heads import reppoints_head as j_rep
    from aidet_tpu.models import losses as j_iou
    from aidet_tpu_torch.core.anchors import build_pyramid_anchors
    from aidet_tpu_torch.models.heads.atss_head import ATSSHead
    from aidet_tpu_torch.models.heads.fcos_head import (FCOS_REGRESS_RANGES,
                                                        FCOSHead)
    from aidet_tpu_torch.models.heads.fovea_head import (
        FOVEA_SCALE_RANGES, FoveaHead, fovea_target)
    from aidet_tpu_torch.models.heads.reppoints_head import RepPointsHead
    from torch_port_helpers import load_flax
    from torch_port_pairs import (GN, assert_losses_close, assert_matched,
                                  dense_batch, dense_cfg, dense_pair,
                                  port_loss, port_predict, ref_loss,
                                  ref_predict, seeded_variables)
except ImportError:     # the card's machine: the gpu case runs alone
    jax = None
needs_reference = pytest.mark.skipif(jax is None,
                                     reason="needs the JAX reference")
T = torch.from_numpy
STRIDES = (8, 16, 32, 64, 128)
DET_LIMITS = dict(boxes=1e-2, scores=1e-4)


def assert_close(got, ref, rel=1e-5):
    got, ref = to_np(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert np.abs(got - ref).max() <= rel * max(np.abs(ref).max(), 1e-12)


def gts(seed, n=6, img=128):
    """Seeded gts [2, n, 4] of 4..120 px with their validity and labels,
    the first two of image 0 of equal area (a tie of the targets'
    smallest-gt rule)."""
    rs = np.random.RandomState(seed)
    xy = rs.uniform(0, img * 0.6, (2, n, 2))
    boxes = np.concatenate([xy, xy + rs.uniform(4, img * 0.9, (2, n, 2))],
                           -1).astype(np.float32)
    boxes[0, 1] = [30, 40, 30 + 50, 40 + 60]
    boxes[0, 0] = [20, 30, 20 + 60, 30 + 50]
    valid = np.asarray([[True] * n, [True] * (n - 2) + [False] * 2])
    return boxes, valid, rs.randint(1, 16, (2, n)).astype(np.int32)


@needs_reference
def test_distance2bbox_matches_the_reference():
    rs = np.random.RandomState(1)
    pts = rs.uniform(0, 128, (2, 50, 2)).astype(np.float32)
    d = rs.uniform(0, 90, (2, 50, 4)).astype(np.float32)
    shapes = np.asarray([[128, 128], [100, 120]], np.float32)
    got = distance2bbox(T(pts), T(d), max_shape=T(shapes)[:, None])
    ref = jax.vmap(j_distance2bbox)(jnp.asarray(pts), jnp.asarray(d),
                                    jnp.asarray(shapes))
    assert_close(got, ref)
    assert_close(distance2bbox(T(pts), T(d)),
                 j_distance2bbox(jnp.asarray(pts), jnp.asarray(d)))


@needs_reference
@pytest.mark.parametrize("radius", [0.0, 1.5])
def test_fcos_target_matches_the_reference(radius):
    pts, sizes, pstrides = build_pyramid_points(128, STRIDES)
    rr = level_values(sizes, FCOS_REGRESS_RANGES)
    boxes, valid, labels = gts(2)
    got = fcos_target(pts, rr, T(boxes), T(valid), T(labels),
                      strides=pstrides, center_sample_radius=radius)
    ref = jax.jit(jax.vmap(lambda g, v, lb: j_fcos_target(
        jnp.asarray(pts.numpy()), jnp.asarray(rr.numpy()), g, v, lb,
        strides=jnp.asarray(pstrides.numpy()),
        center_sample_radius=radius)))(jnp.asarray(boxes),
                                       jnp.asarray(valid),
                                       jnp.asarray(labels))
    np.testing.assert_array_equal(to_np(got[0]), np.asarray(ref[0]))
    assert_close(got[1], ref[1])
    assert_close(got[2], ref[2])
    assert (to_np(got[0]) > 0).sum() > 0


@needs_reference
def test_point_assign_matches_the_reference():
    pts, _, pstrides = build_pyramid_points(128, STRIDES)
    boxes, valid, labels = gts(3)
    boxes[1, 0] = [60, 60, 62, 61]        # below the finest level: clamped
    got = point_assign(pts, pstrides, T(boxes), T(valid), T(labels))
    ref = jax.jit(jax.vmap(lambda g, v, lb: j_point_assign(
        jnp.asarray(pts.numpy()), jnp.asarray(pstrides.numpy()), g, v,
        lb)))(jnp.asarray(boxes), jnp.asarray(valid), jnp.asarray(labels))
    np.testing.assert_array_equal(to_np(got.gt_inds), np.asarray(ref.gt_inds))
    np.testing.assert_array_equal(to_np(got.labels), np.asarray(ref.labels))
    assert (to_np(got.gt_inds) > 0).sum() == valid.sum()


def tie_gts():
    """gts of which the first is centred midway between four anchor
    centres of every level (its distances to them tie exactly)."""
    boxes, valid, labels = gts(4)
    boxes[0, 0] = [44, 44, 84, 84]       # centre (64, 64)
    boxes[1, 0] = [16, 8, 48, 56]        # centre (32, 32)
    return boxes, valid, labels


@needs_reference
def test_atss_assign_matches_the_reference_with_ties():
    anchors, sizes = build_pyramid_anchors(128, STRIDES, scales=(1.0,),
                                           ratios=(1.0,),
                                           base_sizes=[8 * s for s in STRIDES])
    boxes, valid, labels = tie_gts()
    got = atss_assign(anchors, sizes, T(boxes), T(valid), T(labels))
    ja, js = j_anchors(128, STRIDES, base_sizes=[8 * s for s in STRIDES],
                       scales=(1.0,), ratios=(1.0,))
    ref = jax.jit(jax.vmap(lambda g, v, lb: j_atss_assign(ja, js, g, v,
                                                          lb)))(
        jnp.asarray(boxes), jnp.asarray(valid), jnp.asarray(labels))
    np.testing.assert_array_equal(to_np(anchors), np.asarray(ja))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(to_np(g), np.asarray(r))
    assert (to_np(got[0]) == 1).sum() > 0     # the tied gt's anchors


@needs_reference
@pytest.mark.parametrize("name", ["IoULoss", "BoundedIoULoss", "GIoULoss"])
def test_iou_losses_match_the_reference(name):
    rs = np.random.RandomState(5)
    xy = rs.uniform(0, 100, (2, 40, 2))
    pred = np.concatenate([xy, xy + rs.uniform(1, 60, (2, 40, 2))], -1)
    tgt = pred + rs.normal(0, 8, pred.shape)
    tgt[..., 2:] = np.maximum(tgt[..., 2:], tgt[..., :2] + 1)
    pred = pred.reshape(-1, 4).astype(np.float32)
    tgt = tgt.reshape(-1, 4).astype(np.float32)
    # a weight per box (FCOS's and ATSS's centerness) or per coordinate,
    # averaged over the four
    w = rs.uniform(0, 1, (80, 4) if name == "BoundedIoULoss" else 80)
    w = w.astype(np.float32)
    got_fn, ref_fn = getattr(tl, name)(), getattr(j_iou, name)()
    pt = T(pred).requires_grad_()
    got = got_fn(pt, T(tgt), weight=T(w), avg_factor=7.0)
    ref = ref_fn(jnp.asarray(pred), jnp.asarray(tgt), weight=jnp.asarray(w),
                 avg_factor=7.0)
    assert abs(float(got.detach()) - float(ref)) <= 1e-5 * abs(float(ref))
    g, = torch.autograd.grad(got, pt)
    rg = jax.grad(lambda p: ref_fn(p, jnp.asarray(tgt),
                                   weight=jnp.asarray(w), avg_factor=7.0))(
        jnp.asarray(pred))
    assert_close(g, rg, 1e-4)


def test_moment_transform_is_finite_at_coincident_points():
    """Nine coincident points: zero variance, clamped at 1e-12 inside
    the sqrt, so the box and every gradient are finite."""
    x = torch.full((3, 9), 5.0, requires_grad=True)
    y = torch.full((3, 9), -2.0, requires_grad=True)
    mt = torch.zeros(2, requires_grad=True)
    box = points2bbox_moment(x, y, mt, 0.01)
    gx, gy, gm = torch.autograd.grad(box.sum() + box[:, 2].pow(2).sum(),
                                     (x, y, mt))
    for t in (box, gx, gy, gm):
        assert torch.isfinite(t).all()
    np.testing.assert_allclose(to_np(box[0]), [5 - 1e-6, -2 - 1e-6,
                                               5 + 1e-6, -2 + 1e-6],
                               atol=1e-6)


@needs_reference
def test_minmax_transform_matches_the_reference():
    pts = np.random.RandomState(7).uniform(-30, 30, (3, 5, 18))
    pts = pts.astype(np.float32)
    assert_close(points2bbox_minmax(T(pts)),
                 j_rep.points2bbox_minmax(jnp.asarray(pts)))


@needs_reference
def test_moment_transform_matches_the_reference():
    rs = np.random.RandomState(8)
    x, y = (rs.uniform(0, 50, (4, 9)).astype(np.float32) for _ in range(2))
    x[0] = 3.0                                    # coincident x
    mt = np.asarray([0.3, -0.2], np.float32)
    tx, ty, tm = (T(a).requires_grad_() for a in (x, y, mt))
    got = points2bbox_moment(tx, ty, tm, 0.01)
    grads = torch.autograd.grad((got * torch.arange(4.0)).sum(), (tx, ty, tm))

    def ref(a, b, m):
        return j_rep.points2bbox_moment(a, b, m, 0.01)
    assert_close(got, ref(x, y, mt))
    rg = jax.grad(lambda a, b, m: (ref(a, b, m) * jnp.arange(4.0)).sum(),
                  argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(y),
                                     jnp.asarray(mt))
    for g, r in zip(grads, rg):
        assert np.isfinite(to_np(g)).all()
        assert_close(g, r, 1e-4)


@needs_reference
def test_fovea_target_matches_the_reference():
    pts, sizes, pstrides = build_pyramid_points(128, STRIDES)
    sr = level_values(sizes, FOVEA_SCALE_RANGES)
    boxes, valid, labels = gts(9)
    got = fovea_target(pts, pstrides, sr, T(boxes), T(valid), T(labels))
    ref = jax.jit(jax.vmap(lambda g, v, lb: j_fovea.fovea_target(
        jnp.asarray(pts.numpy()), jnp.asarray(pstrides.numpy()),
        jnp.asarray(sr.numpy()), g, v, lb)))(
            jnp.asarray(boxes), jnp.asarray(valid), jnp.asarray(labels))
    np.testing.assert_array_equal(to_np(got[0]), np.asarray(ref[0]))
    np.testing.assert_array_equal(to_np(got[2]), np.asarray(ref[2]))
    assert_close(got[1], ref[1])
    assert to_np(got[2]).sum() > 0


def head_pair(j_cls, t_cls, feats, top="_head", **kw):
    jm = j_cls(**kw)
    jf = [jnp.asarray(f) for f in feats]
    v = seeded_variables(jm, jf)
    return jm, v, load_flax(t_cls(**kw), v, top)


@needs_reference
@pytest.mark.parametrize("kind", ["fcos", "atss", "fovea", "reppoints",
                                  "reppoints_gn"])
def test_heads_match_the_reference(kind):
    """Each head on a three-level pyramid of zero-mean maps, seeded
    weights (RepPoints' deformable kernels among them)."""
    rs = np.random.RandomState(10)
    feats = [rs.randn(2, s, s, 16).astype(np.float32) for s in (12, 6, 3)]
    kw = dict(num_classes=5, in_channels=16, feat_channels=16,
              stacked_convs=2)
    cls = dict(fcos=(j_fcos.FCOSHead, FCOSHead),
               atss=(j_atss.ATSSHead, ATSSHead),
               fovea=(j_fovea.FoveaHead, FoveaHead)).get(
                   kind, (j_rep.RepPointsHead, RepPointsHead))
    if kind.startswith("reppoints"):
        kw.update(point_feat_channels=8,
                  norm_cfg=dict(type="GN", num_groups=4)
                  if kind == "reppoints_gn" else None)
    jm = cls[0](**kw)
    jf = [jnp.asarray(f) for f in feats]
    v = seeded_variables(jm, jf)
    tkw = dict(kw, num_levels=3) if kind in ("fcos", "atss") else kw
    tm = load_flax(cls[1](**tkw), v, "_head")
    ref = jax.jit(jm.apply)(v, jf)
    with torch.no_grad():
        got = tm([T(f) for f in feats])
    rel = 2e-4 if kind == "reppoints_gn" else 1e-5
    for g_lvls, r_lvls in zip(got, ref):
        for g, r in zip(g_lvls, r_lvls):
            assert_close(g, r, rel)


FCOS_HEAD = dict(type="FCOSHead")
DETECTORS = dict(
    fcos=lambda: dense_cfg("FCOS", FCOS_HEAD),
    fcos_center=lambda: dense_cfg("FCOS", FCOS_HEAD, center_sampling=True),
    atss=lambda: dense_cfg("ATSS", dict(type="ATSSHead")),
    fovea=lambda: dense_cfg("FOVEA", dict(type="FoveaHead")),
    reppoints_minmax=lambda: dense_cfg(
        "RepPointsDetector", dict(type="RepPointsHead", norm_cfg=GN,
                                  point_feat_channels=64),
        neck=dict(dense_cfg("", {})["neck"], norm_cfg=GN)),
    reppoints_partial_minmax=lambda: dense_cfg(
        "RepPointsDetector", dict(type="RepPointsHead",
                                  point_feat_channels=64),
        transform_method="partial_minmax"),
    reppoints_moment=lambda: dense_cfg(
        "RepPointsDetector", dict(type="RepPointsHead", norm_cfg=GN,
                                  point_feat_channels=64),
        transform_method="moment"))


@needs_reference
@pytest.mark.parametrize("kind", sorted(DETECTORS))
def test_detector_matches_the_reference(kind):
    """predict (detections paired) and one loss; ATSS's batch holds the
    tied gt of `tie_gts`."""
    jm, v, tm = dense_pair(DETECTORS[kind]())
    boxes = None
    if kind == "atss":
        boxes = tie_gts()[0][:, :4]
    batch = dense_batch(boxes=boxes)
    assert_matched(port_predict(tm, batch), ref_predict(jm, v, batch),
                   DET_LIMITS)
    assert_losses_close(port_loss(tm, batch), ref_loss(jm, v, batch), 1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["fcos", "atss", "fovea", "reppoints"])
def test_card_matches_cpu(kind):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the chip with python -m "
                    "pytest -m gpu tests/test_torch_port_points_heads.py")
    import chip_smoke
    out = chip_smoke.run_hbb_reference(kind=kind)
    assert out["max_abs_err"]["unpaired"] == 0 and out["n_valid"] > 0
