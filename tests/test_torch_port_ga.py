"""Guided anchoring in the PyTorch port against the JAX reference on the
CPU: the deformable convolution at non-zero offsets (and with DCNv2's
modulation), the pyramid points, `ga_targets`, `GARPNHead` on its train
and test (masked) paths, and the small GA-Faster R-CNN and GA-RPN
detectors whole (predict and loss).

The reference's offset conv starts at zero, where the deformable conv
is a plain conv; here the offsets are seeded (the heads' variables from
`shaped_variables`, every kernel N(0, 1 / fan_in), GA-RPN's
``adapt_kernel`` among them), so that the bilinear sampling runs off the
grid and past the map's border.  The detectors are tests/
torch_port_pairs.py's small architecture (ResNet-18, a 64-channel FPN,
128^2 images, 16 classes) with a 64-channel `GARPNHead` whose shape
kernel is at the reference's initial N(0, 0.01) (`ga_pair`); the train_cfg
keeps every candidate (`HBB_TRAIN_CFG`), so both sides sample the same
anchors and rois.

Bounds, float32: the deformable conv within 1e-5 of its largest
magnitude; points equal; ga_targets' location targets and weights equal,
shape targets within 1e-6; the head's outputs within 1e-5 of their
largest magnitude; detections' valid and labels equal, boxes within 1e-2
px, scores within 1e-4; the RPN's proposals within 1e-2 px and scores
within 1e-5; each loss within 1e-4 relative.  The gpu-marked case runs
chip_smoke's hbb_reference phase for GA-Faster R-CNN (the card against
the CPU, its offset conv seeded too).
"""

import numpy as np
import pytest
import torch

from aidet_tpu_torch.core.points import build_pyramid_points
from aidet_tpu_torch.models.heads.guided_anchor_head import (GARPNHead,
                                                             ga_targets)
from aidet_tpu_torch.ops.deform_conv import deform_conv2d
from torch_port_helpers import to_np
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

try:
    import jax
    import jax.numpy as jnp

    from aidet_tpu.core.points import \
        build_pyramid_points as j_build_pyramid_points
    from aidet_tpu.models.heads.guided_anchor_head import \
        GARPNHead as JGARPNHead
    from aidet_tpu.models.heads.guided_anchor_head import \
        ga_targets as j_ga_targets
    from aidet_tpu.ops.deform_conv import deform_conv2d as j_deform_conv2d
    from aidet_tpu_torch.convert import flax_to_state_dict
    from torch_port_helpers import load_flax
    from torch_port_pairs import (assert_bridge_loads, assert_losses_close,
                                  assert_pairs,
                                  hbb_batch, hbb_cfg, port_loss,
                                  port_predict, ref_loss, ref_predict,
                                  seeded_variables, shaped_pair)
except ImportError:     # the card's machine: the gpu case runs alone
    jax = None
needs_reference = pytest.mark.skipif(jax is None,
                                     reason="needs the JAX reference")
T = torch.from_numpy
SMALL_GA = dict(type="GARPNHead", in_channels=64, feat_channels=64)


def assert_close(got, ref, rel=1e-5):
    got, ref = to_np(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= rel * np.abs(ref).max()


@needs_reference
@pytest.mark.parametrize("modulated", [False, True])
def test_deform_conv2d_matches_the_reference(modulated):
    """3x3 (stride 1) and 3x3 stride 2, offsets of up to 4 cells that
    reach past every border of a 12x10 map, with and without DCNv2's
    modulation."""
    rs = np.random.RandomState(3)
    x = rs.randn(2, 12, 10, 8).astype(np.float32)
    w = rs.randn(16, 8, 3, 3).astype(np.float32)
    for stride in (1, 2):
        ho, wo = (12 - 1) // stride + 1, (10 - 1) // stride + 1
        off = rs.uniform(-4, 4, (2, ho, wo, 18)).astype(np.float32)
        mask = (rs.uniform(0, 1, (2, ho, wo, 9)).astype(np.float32)
                if modulated else None)
        got = deform_conv2d(T(x), T(off), T(w),
                            None if mask is None else T(mask), stride=stride)
        ref = jax.vmap(lambda i, o, m: j_deform_conv2d(
            i, o, jnp.asarray(w.transpose(2, 3, 1, 0)), m, stride=stride),
            in_axes=(0, 0, 0 if modulated else None))(
                jnp.asarray(x), jnp.asarray(off),
                None if mask is None else jnp.asarray(mask))
        assert_close(got, ref)


def test_deform_conv2d_without_offsets_is_the_conv():
    rs = np.random.RandomState(4)
    x = rs.randn(2, 9, 7, 6).astype(np.float32)
    w = rs.randn(5, 6, 3, 3).astype(np.float32)
    got = deform_conv2d(T(x), torch.zeros(2, 9, 7, 18), T(w))
    ref = torch.nn.functional.conv2d(T(x).permute(0, 3, 1, 2), T(w),
                                     padding=1).permute(0, 2, 3, 1)
    assert_close(got, ref)


@needs_reference
def test_points_and_ga_targets_match_the_reference():
    pts, sizes, pstrides = build_pyramid_points(128, (4, 8, 16, 32, 64))
    jp, js, jst = j_build_pyramid_points(128, (4, 8, 16, 32, 64))
    np.testing.assert_array_equal(to_np(pts), np.asarray(jp))
    np.testing.assert_array_equal(to_np(pstrides), np.asarray(jst))
    assert sizes == js
    rs = np.random.RandomState(5)
    xy = rs.uniform(0, 100, (2, 6, 2))
    boxes = np.concatenate([xy, xy + rs.uniform(4, 120, (2, 6, 2))],
                           -1).astype(np.float32)
    valid = np.asarray([[True] * 6, [True] * 4 + [False] * 2])
    got = ga_targets(pts, pstrides, T(boxes), T(valid))
    ref = jax.vmap(lambda g, v: j_ga_targets(jp, jst, g, v, None))(
        jnp.asarray(boxes), jnp.asarray(valid))
    for k, (g, r) in enumerate(zip(got, ref)):
        g, r = to_np(g), np.asarray(r)
        if k == 2:
            assert np.abs(g - r).max() <= 1e-6
        else:
            np.testing.assert_array_equal(g, r)
    assert got[3].sum() > 0 and (got[1] == 0).sum() > 0


@needs_reference
def test_garpn_head_matches_the_reference():
    """Both paths of the head on a two-level pyramid, with seeded
    offsets and adaption kernel (`seeded_variables`)."""
    jm = JGARPNHead(in_channels=16, feat_channels=16)
    rs = np.random.RandomState(6)
    feats = [rs.randn(2, s, s, 16).astype(np.float32) for s in (16, 8)]
    jf = [jnp.asarray(f) for f in feats]
    v = seeded_variables(jm, jf)
    # a location prior near the filter's threshold, so that the masked
    # path keeps some locations and drops others
    v["params"]["conv_loc"]["bias"] = np.full((1,), -4.6, np.float32)
    tm = load_flax(GARPNHead(in_channels=16, feat_channels=16), v, "_rpn")
    for masked in (False, True):
        ref = jax.jit(lambda vv, ff, m=masked: jm.apply(vv, ff, masked=m))(
            v, jf)
        with torch.no_grad():
            got = tm([T(f) for f in feats], masked=masked)
        for g_lvls, r_lvls in zip(got, ref):
            for g, r in zip(g_lvls, r_lvls):
                assert_close(g, r)
        if masked:      # some locations filtered, some kept
            assert 0 < float((got[0][0] == 0).float().mean()) < 1


def ga_pair(cfg):
    """`shaped_pair` of ``cfg`` with the GA head's shape kernel at the
    reference's initial N(0, 0.01): guided anchors near their base size
    (8 strides), so that some match the gts and the RPN regresses."""
    jm, v, tm = shaped_pair(cfg)
    shape = v["params"]["_rpn"]["conv_shape"]
    shape["kernel"] = (0.01 * np.random.RandomState(7).randn(
        *shape["kernel"].shape)).astype(np.float32)
    tm.load_state_dict(flax_to_state_dict(v)[0], strict=True)
    return jm, v, tm


@pytest.fixture(scope="module")
def ga_faster():
    jm, v, tm = ga_pair(hbb_cfg("GAFasterRCNN", rpn_head=SMALL_GA))
    return jm, v, tm, hbb_batch()


@needs_reference
def test_ga_faster_rcnn_predict_matches_the_reference(ga_faster):
    jm, v, tm, batch = ga_faster
    assert_pairs(port_predict(tm, batch), ref_predict(jm, v, batch),
                 dict(boxes=1e-2, scores=1e-4))


@needs_reference
def test_ga_faster_rcnn_loss_matches_the_reference(ga_faster):
    jm, v, tm, batch = ga_faster
    got = port_loss(tm, batch)
    assert {"loss_rpn_loc", "loss_rpn_shape"} <= set(got)
    assert_losses_close(got, ref_loss(jm, v, batch), 1e-4)


@needs_reference
def test_ga_rpn_matches_the_reference():
    """The proposal-only GA-RPN (configs/ga_rpn_r50_caffe_fpn_1x.py)."""
    jm, v, tm = ga_pair(hbb_cfg("RPN", rpn_head=SMALL_GA))
    batch = hbb_batch()
    del batch["gt_labels"]
    got, ref = port_predict(tm, batch), ref_predict(jm, v, batch)
    assert got["valid"].sum() > 0
    np.testing.assert_array_equal(got["valid"], ref["valid"])
    assert np.abs(got["boxes"] - ref["boxes"]).max() <= 1e-2
    assert np.abs(got["scores"] - ref["scores"]).max() <= 1e-5
    assert_losses_close(port_loss(tm, batch), ref_loss(jm, v, batch), 1e-4)


@needs_reference
@pytest.mark.parametrize("config", ["ga_faster_rcnn_r50_fpn_1x"])
def test_config_weights_load_through_the_bridge(config):
    """The reference's variables of GA-Faster R-CNN's config (their
    shapes from a trace, seeded values) load strictly into the port's
    build of it, every leaf mapped by `flax_to_state_dict`: GA-RPN's
    ``adapt_kernel`` relaid HWIO -> OIHW."""
    tm, sd = assert_bridge_loads(f"configs/{config}.py")
    assert sd["rpn_head.adapt.weight"].shape == (256, 256, 3, 3)


@pytest.mark.gpu
def test_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the chip with "
                    "python -m pytest -m gpu tests/test_torch_port_ga.py")
    import chip_smoke
    out = chip_smoke.run_hbb_reference(kind="ga_faster")
    assert out["max_abs_err"]["unpaired"] == 0 and out["n_valid"] > 0
