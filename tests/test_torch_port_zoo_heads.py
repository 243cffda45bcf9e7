"""Mask Scoring R-CNN, Grid R-CNN and Double-Head R-CNN in the PyTorch
port against the JAX reference on the CPU: `MaskIoUHead`, `GridHead`
(fused and unfused heatmaps: the grouped transposed convs carried over
by the weight bridge), `grid_target`, `grid_to_boxes`, the grid loss on
given jittered rois, the jitter's bounds, `DoubleConvFCBBoxHead`, and
the three small detectors whole (predict and loss).

The detectors are tests/torch_port_pairs.py's small architecture
(ResNet-18, a 64-channel FPN, 128^2 images, 16 classes) with narrow
heads, the reference's seeded variables carried over by the weight
bridge (`shaped_pair`); the reference runs its XLA RoIAlign, the port
its plain version.  `HBB_TRAIN_CFG` keeps every candidate, so both
sides sample the same rois.  Grid R-CNN's training jitter draws from
each side's random stream, which differ: its detector's loss_grid is
held by its bounds (finite, positive, within 10% of the reference's),
and the loss itself on the same jittered rois by
`test_grid_loss_on_given_rois_matches_the_reference`.

Bounds, float32: the heads' outputs within 1e-5 of their largest
magnitude (the grid heatmaps 1e-4: two GroupNorms); grid targets within
1e-6, grid boxes within 1e-4 px; detections' valid and labels equal,
boxes within 1e-2 px (2e-2 for Double-Head R-CNN's, whose deltas come
from its conv branch: seen 1.0e-2 on one thread; 5e-2 for Grid
R-CNN's, whose boxes rescale the detections' through the heatmaps'
lattice), scores within 2e-4, Mask Scoring's mask_scores (the scores
times the IoU head's output) within 5e-4 (seen 2.1e-4), masks within
1e-3; each loss within 1e-4 relative.  The gpu-marked case runs chip_smoke's hbb_reference phase
for the three (the card against the CPU, Grid's jitter drawn alike).
"""

import functools

import numpy as np
import pytest
import torch

from aidet_tpu_torch.core.sample import FixedSample
from aidet_tpu_torch.models.detectors.two_stage import jitter_rois
from aidet_tpu_torch.models.heads.bbox_head import (DoubleConvFCBBoxHead,
                                                    MaskIoUHead)
from aidet_tpu_torch.models.heads.grid_head import (GridHead, grid_target,
                                                    grid_to_boxes)
from torch_port_helpers import to_np
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

try:
    import jax
    import jax.numpy as jnp

    from aidet_tpu.core.sample import FixedSample as JFixedSample
    from aidet_tpu.models.heads.bbox_head import \
        DoubleConvFCBBoxHead as JDoubleConvFCBBoxHead
    from aidet_tpu.models.heads.bbox_head import MaskIoUHead as JMaskIoUHead
    from aidet_tpu.models.heads.grid_head import GridHead as JGridHead
    from aidet_tpu.models.heads.grid_head import grid_target as j_grid_target
    from aidet_tpu.models.heads.grid_head import \
        grid_to_boxes as j_grid_to_boxes
    from torch_port_helpers import load_flax
    from torch_port_pairs import (SMALL_MASK_HEAD, assert_bridge_loads,
                                  assert_losses_close,
                                  assert_pairs, hbb_batch, hbb_cfg,
                                  port_loss, port_predict, ref_loss,
                                  ref_predict, seeded_variables,
                                  shaped_pair)
except ImportError:     # the card's machine: the gpu case runs alone
    jax = None
needs_reference = pytest.mark.skipif(jax is None,
                                     reason="needs the JAX reference")
T = torch.from_numpy
SMALL_GRID = dict(type="GridHead", num_convs=2, in_channels=64,
                  point_feat_channels=8, norm_groups=9)
SMALL_MASK_IOU = dict(type="MaskIoUHead", num_convs=2, num_fcs=1,
                      in_channels=64, conv_out_channels=32,
                      fc_out_channels=64, num_classes=16)
SMALL_DH = dict(type="DoubleConvFCBBoxHead", num_classes=16, in_channels=64,
                num_convs=2, conv_out_channels=128, fc_out_channels=128)


def assert_close(got, ref, rel=1e-5):
    got, ref = to_np(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= rel * np.abs(ref).max()


def kw(cfg):
    return {k: v for k, v in cfg.items() if k != "type"}


@needs_reference
def test_double_head_matches_the_reference():
    jm = JDoubleConvFCBBoxHead(**kw(SMALL_DH))
    x = np.random.RandomState(1).randn(5, 7, 7, 64).astype(np.float32)
    v = seeded_variables(jm, jnp.asarray(x))
    tm = load_flax(DoubleConvFCBBoxHead(**kw(SMALL_DH)), v, "_bbox_head")
    with torch.no_grad():
        got = tm(T(x))
    for g, r in zip(got, jax.jit(jm.apply)(v, jnp.asarray(x))):
        assert_close(g, r)


@needs_reference
def test_mask_iou_head_matches_the_reference():
    """14x14 crops and a 28x28 mask whose 2x2 max-pool keeps its
    one-pixel lines."""
    jm = JMaskIoUHead(**kw(SMALL_MASK_IOU))
    rs = np.random.RandomState(2)
    x = rs.randn(4, 14, 14, 64).astype(np.float32)
    m = (rs.uniform(0, 1, (4, 28, 28)) > 0.97).astype(np.float32)
    v = seeded_variables(jm, jnp.asarray(x), jnp.asarray(m))
    tm = load_flax(MaskIoUHead(**kw(SMALL_MASK_IOU)), v, "_mask_iou_head")
    with torch.no_grad():
        got = tm(T(x), T(m))
    assert got.shape == (4, 15)
    assert_close(got, jax.jit(jm.apply)(v, jnp.asarray(x), jnp.asarray(m)))


@needs_reference
def test_grid_head_matches_the_reference():
    """The fused and the unfused heatmaps of 14x14 crops [N, 28, 28, 9]."""
    jm = JGridHead(**kw(SMALL_GRID))
    x = np.random.RandomState(3).randn(3, 14, 14, 64).astype(np.float32)
    v = seeded_variables(jm, jnp.asarray(x))
    tm = load_flax(GridHead(**kw(SMALL_GRID)), v, "_grid_head")
    ref = jax.jit(functools.partial(jm.apply, return_unfused=True))(
        v, jnp.asarray(x))
    with torch.no_grad():
        got = tm(T(x), return_unfused=True)
    assert got[0].shape == (3, 28, 28, 9)
    for g, r in zip(got, ref):
        assert_close(g, r, 1e-4)


def grid_case(seed=4, b=2, r=6):
    """Seeded rois [b, r, 4], gts [b, 3, 4] and a sample whose rows
    alternate positive (matched to gt r % 3) and negative."""
    rs = np.random.RandomState(seed)
    xy = rs.uniform(0, 80, (b, r, 2))
    rois = np.concatenate([xy, xy + rs.uniform(8, 40, (b, r, 2))], -1)
    gxy = rs.uniform(0, 80, (b, 3, 2))
    gts = np.concatenate([gxy, gxy + rs.uniform(8, 40, (b, 3, 2))], -1)
    is_pos = np.arange(r)[None].repeat(b, 0) % 2 == 0
    gt_inds = np.where(is_pos, np.arange(r) % 3, -1).astype(np.int32)
    return (rois.astype(np.float32), gts.astype(np.float32), is_pos,
            gt_inds)


@needs_reference
def test_grid_target_and_grid_to_boxes_match_the_reference():
    rois, gts, is_pos, gt_inds = grid_case()
    inds = np.zeros_like(gt_inds)
    got = grid_target(FixedSample(T(inds).long(), T(is_pos), T(is_pos),
                                  T(gt_inds).long()), T(rois), T(gts), 28)
    ref = jax.vmap(lambda i, p, g, ro, gt: j_grid_target(
        JFixedSample(i, p, p, g), ro, gt, heatmap_size=28))(
            *map(jnp.asarray, (inds, is_pos, gt_inds, rois, gts)))
    assert np.abs(to_np(got) - np.asarray(ref)).max() <= 1e-6
    assert to_np(got).max() > 0.5
    heat = np.random.RandomState(5).randn(2, 6, 28, 28, 9).astype(np.float32)
    got = grid_to_boxes(T(heat), T(rois))
    ref = jax.vmap(j_grid_to_boxes)(jnp.asarray(heat), jnp.asarray(rois))
    assert np.abs(to_np(got) - np.asarray(ref)).max() <= 1e-4


def test_jitter_stays_within_its_bounds():
    """Grid R-CNN's training jitter: each centre moved by at most 0.15 of
    the roi's size, each side scaled by 0.85..1.15, clipped to the
    image; the draws come from the generator alone."""
    rois = torch.tensor([[[20., 30., 60., 50.], [0., 0., 127., 127.]]])
    shapes = torch.tensor([[128., 128.]])
    a = jitter_rois(rois, shapes, torch.Generator().manual_seed(0))
    b = jitter_rois(rois, shapes, torch.Generator().manual_seed(0))
    assert torch.equal(a, b)
    c0, wh0 = (rois[0, 0, :2] + rois[0, 0, 2:]) / 2, rois[0, 0, 2:] - \
        rois[0, 0, :2]
    c1, wh1 = (a[0, 0, :2] + a[0, 0, 2:]) / 2, a[0, 0, 2:] - a[0, 0, :2]
    assert ((c1 - c0).abs() <= 0.15 * wh0 + 1e-4).all()
    assert ((wh1 >= 0.85 * wh0 - 1e-4) & (wh1 <= 1.15 * wh0 + 1e-4)).all()
    assert a.min() >= 0 and a.max() <= 127


@pytest.fixture(scope="module")
def grid():
    jm, v, tm = shaped_pair(hbb_cfg("GridRCNN", grid_head=SMALL_GRID))
    return jm, v, tm, hbb_batch()


@needs_reference
def test_grid_rcnn_predict_matches_the_reference(grid):
    jm, v, tm, batch = grid
    assert_pairs(port_predict(tm, batch), ref_predict(jm, v, batch),
                 dict(boxes=5e-2, scores=2e-4))


@needs_reference
def test_grid_rcnn_loss_matches_the_reference(grid):
    jm, v, tm, batch = grid
    got, ref = port_loss(tm, batch), ref_loss(jm, v, batch)
    g, r = got.pop("loss_grid"), ref.pop("loss_grid")
    assert_losses_close(got, ref, 1e-4)
    assert 0 < g and abs(g - r) <= 0.1 * r


@needs_reference
def test_grid_loss_on_given_rois_matches_the_reference(grid):
    """`TwoStageDetector._grid_loss` on jittered rois drawn here, against
    the reference's grid branch (two_stage.py:622-645) on the same rois,
    features and sample."""
    jm, v, tm, batch = grid
    rois, gts, is_pos, gt_inds = grid_case(seed=8, r=8)
    imgs = batch["imgs"]
    sample = FixedSample(torch.zeros(2, 8, dtype=torch.long), T(is_pos),
                         T(is_pos), T(gt_inds).long())
    with torch.no_grad():
        feats = tm.extract_feat(T(imgs))
        got = float(tm._grid_loss(feats, T(rois), sample, T(gts),
                                  torch.autocast("cpu", enabled=False)))

    def reference(m, imgs, rois, is_pos, gt_inds, gts):
        feats = m.extract_feat(imgs)
        b, p = rois.shape[:2]
        gcrops = m._roi_features(feats, rois, m.grid_roi_size)
        heat, unfused = m._grid_head(
            gcrops.reshape((b * p,) + gcrops.shape[2:]), return_unfused=True)
        hm = 2 * m.grid_roi_size
        tgt = jax.vmap(lambda pp, gi, ro, g: j_grid_target(
            JFixedSample(gi, pp, pp, gi), ro, g, heatmap_size=hm))(
                is_pos, gt_inds, rois, gts).reshape(heat.shape)
        w = is_pos.reshape(-1).astype(jnp.float32)
        navg = jnp.maximum(w.sum(), 1.0) * hm ** 2 * 9

        def bce(h):
            x = (jnp.maximum(h, 0) - h * tgt + jnp.log1p(jnp.exp(-jnp.abs(h))))
            return (x * w[:, None, None, None]).sum() / navg
        return 15.0 * (bce(heat) + bce(unfused))
    ref = float(jax.jit(functools.partial(jm.apply, method=reference))(
        v, *map(jnp.asarray, (imgs, rois, is_pos, gt_inds, gts))))
    assert abs(got - ref) <= 1e-4 * abs(ref) and got > 0


@pytest.fixture(scope="module")
def mask_scoring():
    jm, v, tm = shaped_pair(hbb_cfg(
        "MaskScoringRCNN", mask_head=dict(type="FCNMaskHead",
                                          **SMALL_MASK_HEAD),
        mask_iou_head=SMALL_MASK_IOU))
    return jm, v, tm, hbb_batch(masks=True)


@needs_reference
def test_mask_scoring_predict_matches_the_reference(mask_scoring):
    jm, v, tm, batch = mask_scoring
    got, ref = port_predict(tm, batch), ref_predict(jm, v, batch)
    assert set(got) == set(ref) and "mask_scores" in got
    assert_pairs(got, ref, dict(boxes=1e-2, scores=2e-4, masks=1e-3,
                                mask_scores=5e-4))


@needs_reference
def test_mask_scoring_loss_matches_the_reference(mask_scoring):
    jm, v, tm, batch = mask_scoring
    got = port_loss(tm, batch)
    assert "loss_mask_iou" in got
    assert_losses_close(got, ref_loss(jm, v, batch), 1e-4)


@needs_reference
def test_double_head_rcnn_matches_the_reference():
    jm, v, tm = shaped_pair(hbb_cfg("DoubleHeadRCNN", bbox_head=SMALL_DH))
    batch = hbb_batch()
    assert_pairs(port_predict(tm, batch), ref_predict(jm, v, batch),
                 dict(boxes=2e-2, scores=2e-4))
    assert_losses_close(port_loss(tm, batch), ref_loss(jm, v, batch), 1e-4)


@needs_reference
@pytest.mark.parametrize("config", ["grid_rcnn_r50_fpn_2x", "ms_rcnn_r50_fpn_1x"])
def test_config_weights_load_through_the_bridge(config):
    """The reference's variables of Grid R-CNN's and Mask Scoring
    R-CNN's configs (their shapes from a trace, seeded values) load
    strictly into the port's builds of them, every leaf mapped by
    `flax_to_state_dict`: the grid head's grouped transposed convs and
    ``GroupNorm_{i}``, the mask IoU head."""
    tm, sd = assert_bridge_loads(f"configs/{config}.py")
    assert any(k.startswith(("grid_head.deconv2", "mask_iou_head.fc_mask_iou"))
               for k in sd)


@pytest.mark.gpu
def test_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the chip with python -m "
                    "pytest -m gpu tests/test_torch_port_zoo_heads.py")
    import chip_smoke
    for kind in ("ms", "grid", "dh"):
        out = chip_smoke.run_hbb_reference(kind=kind)
        assert out["max_abs_err"]["unpaired"] == 0 and out["n_valid"] > 0
