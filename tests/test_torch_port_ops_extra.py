"""The XLA-only ops and heads of the PyTorch port against the reference:
CARAFE, CARAFEPack and FPN_CARAFE, the FCN mask head with GroupNorm and
with class-agnostic logits, deformable RoI pooling (chunked, with its
two learned-offset packs, forward and gradient), RoI pooling, affine
grids, grid sampling, the masked conv, `multiclass_nms_with_index`,
`batched_nms`, `multilevel_roi_align_fused` with ``roi_scale_factor``,
the MSE loss and the accuracy; and the small CARAFE Mask R-CNN end to
end (predict and a train step's losses).

Inputs are made with numpy from a seed; module weights are the
reference's (`seeded_variables`: kernels N(0, 1 / fan_in), every other
leaf N(0, 0.1), so the packs' zero-started offset and mask linears are
not zero), carried over by `flax_to_state_dict`.  Tolerances (float32):
outputs and gradients within 1e-5 of their largest magnitude (1e-4
for gradients that sum over many samples), integer results and keep
masks equal; detections paired in any order with boxes within 2e-2 px,
scores within 2e-4, masks within 1e-3, losses within 1e-4 of their
value.  On the card these ops run in chip_smoke's slice-16 ops phase.
"""

import importlib

import numpy as np
import pytest
import torch

from aidet_tpu_torch.models.heads.mask_head import FCNMaskHead
from aidet_tpu_torch.models.losses import MSELoss, accuracy, mse_loss
from aidet_tpu_torch.models.necks.nas_fpn import FPN_CARAFE
from aidet_tpu_torch.ops import deform_pool as tdp
from aidet_tpu_torch.ops.carafe import CARAFEPack, carafe
from aidet_tpu_torch.ops.grid_sample import (affine_grid, grid_sample,
                                             masked_conv2d)
from aidet_tpu_torch.ops.nms import batched_nms, multiclass_nms_with_index
from aidet_tpu_torch.ops.roi_align import multilevel_roi_align_fused
from aidet_tpu_torch.ops.roi_pool import roi_pool
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)
from torch_port_helpers import STRIDES, make_inputs, to_np

try:
    import jax
    import jax.numpy as jnp

    # registers the reference's FPN_CARAFE (its necks/__init__ does not)
    import aidet_tpu.models.necks.nas_fpn as jnas
    from aidet_tpu.models.heads.mask_head import FCNMaskHead as JFCNMaskHead
    from aidet_tpu.models.losses.accuracy import accuracy as j_accuracy
    from aidet_tpu.models.losses.mse_loss import MSELoss as JMSELoss
    from aidet_tpu.ops import deform_pool as jdp
    from aidet_tpu.ops.roi_align import multilevel_roi_align_fused as j_fused
    from aidet_tpu.ops.roi_pool import roi_pool as j_roi_pool
    from aidet_tpu_torch.convert import flax_to_state_dict
    from torch_port_helpers import load_flax
    from torch_port_pairs import (SMALL_MASK_HEAD, assert_bridge_loads,
                                  assert_losses_close, assert_matched,
                                  hbb_batch, hbb_cfg, port_loss,
                                  port_predict, ref_loss, ref_predict,
                                  seeded_variables, shaped_pair)
    # (the package re-exports functions under these modules' names)
    jcarafe, jgs, jnms = (importlib.import_module(f"aidet_tpu.ops.{m}")
                          for m in ("carafe", "grid_sample", "nms"))
except ImportError:     # the card's machine: the gpu case runs alone
    jax = None
needs_reference = pytest.mark.skipif(jax is None,
                                     reason="needs the JAX reference")
T = torch.from_numpy
GN = dict(type="GN", num_groups=32)


def assert_close(got, ref, rel=1e-5):
    got, ref = to_np(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref).max()
    assert err <= rel * max(np.abs(ref).max(), 1e-12), err


def load_module(module, variables):
    """The variables of one reference module into ``module`` through the
    weight bridge (as a submodule "m" of a neck)."""
    sd, unmapped = flax_to_state_dict(
        {col: {"_neck": {"m": tree}} for col, tree in variables.items()})
    assert not unmapped, unmapped
    module.load_state_dict({k[len("neck.m."):]: v for k, v in sd.items()},
                           strict=True)
    return module.eval()


def rng_array(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@needs_reference
@pytest.mark.parametrize("up,k_up", [(2, 5), (2, 3), (3, 3)])
def test_carafe_matches_the_reference(up, k_up):
    """`F.unfold`'s channel-major patches against
    `conv_general_dilated_patches`', on softmax-normalised kernels."""
    x = rng_array(1, 2, 7, 9, 6)
    kern = jax.nn.softmax(jnp.asarray(rng_array(2, 2, 7 * up, 9 * up,
                                                k_up * k_up)), -1)
    ref = jcarafe.carafe(jnp.asarray(x), kern, up, k_up)
    got = carafe(T(x).permute(0, 3, 1, 2),
                 T(np.asarray(kern)).permute(0, 3, 1, 2), up, k_up)
    assert_close(got.permute(0, 2, 3, 1), ref)


@needs_reference
@pytest.mark.parametrize("up", [2, 3])
def test_carafe_pack_matches_the_reference(up):
    """The kernel groups shuffled (h, w, u, v, K) -> (h, u, w, v, K), not
    in `torch.pixel_shuffle`'s order."""
    x = rng_array(3, 2, 6, 5, 16)
    jm = jcarafe.CARAFEPack(channels=16, up_factor=up,
                            compressed_channels=8)
    v = seeded_variables(jm, jnp.asarray(x))
    tm = load_module(CARAFEPack(16, up, compressed_channels=8), v)
    with torch.no_grad():
        got = tm(T(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert_close(got, jm.apply(v, jnp.asarray(x)))


@needs_reference
@pytest.mark.parametrize("sizes", [(32, 16, 8, 4), (30, 15, 8, 4)],
                         ids=["even", "odd"])
def test_fpn_carafe_matches_the_reference(sizes):
    """Top-down CARAFE, `_resize_to` nearest where an upsampled level
    is not its target's size (odd sides), extra levels by the 1x1
    stride-2 max-pool."""
    chans = (8, 16, 24, 32)
    xs = [rng_array(4 + i, 2, s, s, c)
          for i, (s, c) in enumerate(zip(sizes, chans))]
    jm = jnas.FPN_CARAFE(in_channels=chans, out_channels=16, num_outs=5)
    v = seeded_variables(jm, [jnp.asarray(x) for x in xs])
    tm = load_module(FPN_CARAFE(chans, 16, 5), v)
    ref = jm.apply(v, [jnp.asarray(x) for x in xs])
    with torch.no_grad():
        got = tm([T(x) for x in xs])
    assert len(got) == len(ref) == 5
    for g, r in zip(got, ref):
        assert_close(g, r)


@needs_reference
@pytest.mark.parametrize("norm,agnostic", [(True, False), (False, True),
                                           (True, True)])
def test_fcn_mask_head_matches_the_reference(norm, agnostic):
    """The GN head (bias-free convs, GroupNorm ``norm{i}`` before each
    ReLU) and the class-agnostic logits (one map)."""
    kw = dict(num_convs=2, in_channels=32, conv_out_channels=32,
              num_classes=5, class_agnostic=agnostic,
              norm_cfg=dict(GN, num_groups=8) if norm else None)
    x = rng_array(5, 3, 7, 7, 32)
    jm = JFCNMaskHead(**kw)
    v = seeded_variables(jm, jnp.asarray(x))
    tm = load_flax(FCNMaskHead(**kw), v, "_mask_head")
    assert not norm or tm.conv0.bias is None
    with torch.no_grad():
        got = tm(T(x))
    assert got.shape == (3, 14, 14, 1 if agnostic else 4)
    assert_close(got, jm.apply(v, jnp.asarray(x)))


def pool_inputs(seed, r=70):
    """A 20x24 map of 8 channels and rois [r, 4] of 1..60 px on a 80x96
    image at stride 4, some partly outside."""
    rs = np.random.RandomState(seed)
    feat = rs.randn(20, 24, 8).astype(np.float32)
    xy = rs.uniform(-10, 80, (r, 2))
    rois = np.concatenate([xy, xy + rs.uniform(1, 60, (r, 2))], -1)
    return feat, rois.astype(np.float32)


@needs_reference
@pytest.mark.parametrize("chunk", [16, 64, 128])
@pytest.mark.parametrize("offsets", [False, True])
def test_deform_roi_pool_matches_the_reference(chunk, offsets):
    """70 rois in chunks of 16 (a last partial chunk), 64 and 128 (one
    call), without and with per-bin offsets; the gradient of a seeded
    cotangent for the features and the offsets."""
    feat, rois = pool_inputs(6)
    off = 0.5 * rng_array(7, 70, 5, 5, 2) if offsets else None
    cot = rng_array(8, 70, 5, 5, 8)

    def jf(f, o):
        out = jdp.deform_roi_pool(f, jnp.asarray(rois), o, 5, 0.25, 3, 0.3,
                                  chunk=chunk)
        return (out * cot).sum(), out
    args = (jnp.asarray(feat), None if off is None else jnp.asarray(off))
    (_, ref), (gf, go) = jax.value_and_grad(jf, (0, 1), has_aux=True)(*args)
    tf = T(feat).requires_grad_()
    to = None if off is None else T(off).requires_grad_()
    got = tdp.deform_roi_pool(tf, T(rois), to, 5, 0.25, 3, 0.3, chunk=chunk)
    assert_close(got.detach(), ref)
    (got * T(cot)).sum().backward()
    assert_close(tf.grad, gf, 1e-4)
    if offsets:
        assert_close(to.grad, go, 1e-4)


@needs_reference
@pytest.mark.parametrize("modulated", [False, True])
def test_deform_roi_pool_packs_match_the_reference(modulated):
    """The packs' offset (and mask) linears, seeded nonzero, forward and
    the gradient of a seeded cotangent for the features and every
    parameter."""
    feat, rois = pool_inputs(9, r=20)
    kw = dict(out_size=3, out_channels=8, spatial_scale=0.25,
              sample_per_part=2, trans_std=0.2, num_offset_fcs=3,
              deform_fc_channels=16)
    if modulated:
        jm = jdp.ModulatedDeformRoIPoolingPack(num_mask_fcs=2, **kw)
        tm = tdp.ModulatedDeformRoIPoolingPack(num_mask_fcs=2, **kw)
    else:
        jm = jdp.DeformRoIPoolingPack(**kw)
        tm = tdp.DeformRoIPoolingPack(**kw)
    v = seeded_variables(jm, jnp.asarray(feat), jnp.asarray(rois))
    tm = load_module(tm, v)
    cot = rng_array(10, 20, 3, 3, 8)

    def jf(params, f):
        out = jm.apply({"params": params}, f, jnp.asarray(rois))
        return (out * cot).sum(), out
    (_, ref), (gp, gf) = jax.value_and_grad(jf, (0, 1), has_aux=True)(
        v["params"], jnp.asarray(feat))
    tf = T(feat).requires_grad_()
    got = tm(tf, T(rois))
    assert_close(got.detach(), ref)
    (got * T(cot)).sum().backward()
    assert_close(tf.grad, gf, 1e-4)
    sd, _ = flax_to_state_dict({"params": {"_neck": {"m": gp}}})
    for name, p in tm.named_parameters():
        assert_close(p.grad, sd[f"neck.m.{name}"], 1e-4)


@needs_reference
@pytest.mark.parametrize("scale", [1.0, 0.25])
def test_roi_pool_matches_the_reference(scale):
    """Integer bin edges, the max over each bin, 0 for an empty bin (rois
    past the map's edge)."""
    feat, rois = pool_inputs(11)
    if scale == 1.0:
        rois = rois / 4
    ref = j_roi_pool(jnp.asarray(feat), jnp.asarray(rois), 7, scale)
    got = roi_pool(T(feat), T(rois), 7, scale)
    assert (np.asarray(ref) == 0).any()
    np.testing.assert_array_equal(to_np(got), np.asarray(ref))


@needs_reference
@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
def test_grid_sample_matches_the_reference(align_corners, padding_mode):
    """An affine grid reaching past the map's border, then bilinear
    sampling of a 9x11 map."""
    theta = np.asarray([[[1.3, 0.2, 0.1], [-0.1, 0.9, -0.3]],
                        [[0.7, -0.4, 0.5], [0.3, 1.2, 0.2]]], np.float32)
    ref_grid = jgs.affine_grid(jnp.asarray(theta), (2, 6, 8), align_corners)
    grid = affine_grid(T(theta), (2, 6, 8), align_corners)
    assert_close(grid, ref_grid)
    x = rng_array(12, 2, 9, 11, 5)
    ref = jgs.grid_sample(jnp.asarray(x), ref_grid, align_corners,
                          padding_mode)
    assert_close(grid_sample(T(x), grid, align_corners, padding_mode), ref)


@needs_reference
def test_masked_conv2d_matches_the_reference():
    x = rng_array(13, 2, 9, 11, 6)
    w = rng_array(14, 3, 3, 6, 4)
    b = rng_array(15, 4)
    mask = (rng_array(16, 2, 9, 11, 1) > 0).astype(np.float32)
    ref = jgs.masked_conv2d(jnp.asarray(x), jnp.asarray(mask),
                            jnp.asarray(w), jnp.asarray(b))
    got = masked_conv2d(T(x), T(mask), T(w.transpose(3, 2, 0, 1).copy()),
                        T(b))
    assert_close(got, ref)


def nms_inputs(seed, n=60, classes=4):
    rs = np.random.RandomState(seed)
    xy = rs.uniform(0, 80, (n, 2))
    boxes = np.concatenate([xy, xy + rs.uniform(8, 40, (n, 2))], -1)
    per_class = (boxes[:, None] + rs.normal(0, 3, (n, classes + 1, 4)))
    scores = rs.dirichlet(np.ones(classes + 1), n)
    return (boxes.astype(np.float32),
            per_class.reshape(n, -1).astype(np.float32),
            scores.astype(np.float32))


@needs_reference
def test_multiclass_nms_with_index_matches_the_reference():
    """Per-class boxes; the kept detections with their classes and source
    rois (``roi_idx``), equal to the reference's."""
    _, boxes, scores = nms_inputs(17)
    valid = np.arange(60) < 55
    ref = jnms.multiclass_nms_with_index(
        jnp.asarray(boxes), jnp.asarray(scores), 0.05, 0.5, 30,
        jnp.asarray(valid))
    got = multiclass_nms_with_index(T(boxes), T(scores), 0.05, 0.5, 30,
                                    T(valid))
    assert bool(got.valid.any())
    for name in ("valid", "labels", "roi_idx"):
        np.testing.assert_array_equal(to_np(getattr(got, name)),
                                      np.asarray(getattr(ref, name)))
    assert_close(got.scores, ref.scores)
    assert_close(got.boxes, ref.boxes)


@needs_reference
@pytest.mark.parametrize("iou_thr", [0.2, 0.4])
def test_batched_nms_matches_the_reference(iou_thr):
    """Boxes of other categories never suppress each other; some
    candidates invalid."""
    boxes, _, _ = nms_inputs(18)
    rs = np.random.RandomState(19)
    scores = rs.uniform(0, 1, 60).astype(np.float32)
    idxs = rs.randint(0, 3, 60)
    valid = rs.uniform(0, 1, 60) > 0.1
    ref = jnms.batched_nms(jnp.asarray(boxes), jnp.asarray(scores),
                           jnp.asarray(idxs), iou_thr, jnp.asarray(valid))
    got = batched_nms(T(boxes), T(scores), T(idxs), iou_thr, T(valid))
    assert 0 < int(got.sum()) < int(valid.sum())
    np.testing.assert_array_equal(to_np(got), np.asarray(ref))


@needs_reference
@pytest.mark.parametrize("roi_scale_factor", [None, 1.0, 1.5])
def test_multilevel_roi_align_fused_matches_the_reference(roi_scale_factor):
    """One image's four levels, levels chosen from each roi's own size,
    then the roi scaled about its centre; on the CPU K1's plain
    version."""
    feats, rois = make_inputs(20, b=1)
    ref = j_fused([jnp.asarray(f[0]) for f in feats], jnp.asarray(rois[0]),
                  7, STRIDES, roi_scale_factor=roi_scale_factor)
    got = multilevel_roi_align_fused([T(f[0]) for f in feats], T(rois[0]),
                                     7, STRIDES,
                                     roi_scale_factor=roi_scale_factor)
    assert_close(got, ref)


@needs_reference
@pytest.mark.parametrize("reduction,avg", [("mean", None), ("sum", None),
                                           ("none", None), ("mean", 7.0)])
def test_mse_loss_matches_the_reference(reduction, avg):
    pred, target = rng_array(21, 5, 6), rng_array(22, 5, 6)
    weight = np.abs(rng_array(23, 5, 6))
    ref = JMSELoss(reduction, 0.5)(jnp.asarray(pred), jnp.asarray(target),
                                   jnp.asarray(weight), avg_factor=avg)
    got = MSELoss(reduction, 0.5)(T(pred), T(target), T(weight),
                                  avg_factor=avg)
    assert_close(got, ref)
    assert_close(mse_loss(T(pred), T(target)), ((pred - target) ** 2).mean())


@needs_reference
@pytest.mark.parametrize("topk", [1, (1, 3)])
@pytest.mark.parametrize("weighted", [False, True])
def test_accuracy_matches_the_reference(topk, weighted):
    """Top-k accuracy with tied logits (the lower class first)."""
    pred = np.round(rng_array(24, 40, 6), 1)
    target = np.random.RandomState(25).randint(0, 6, 40)
    weight = ((np.arange(40) % 3) > 0).astype(np.float32) if weighted \
        else None
    ref = j_accuracy(jnp.asarray(pred), jnp.asarray(target), topk,
                     None if weight is None else jnp.asarray(weight))
    got = accuracy(T(pred), T(target), topk,
                   None if weight is None else T(weight))
    for g, r in zip(np.atleast_1d(got), np.atleast_1d(ref)):
        assert float(g) == pytest.approx(float(r), rel=1e-6)


@needs_reference
def test_small_carafe_mask_rcnn_matches_the_reference():
    """The small CARAFE Mask R-CNN (as chip_smoke's "carafe" kind:
    ResNet-18, FPN_CARAFE at 64 channels, the small mask head, 128^2):
    predict (every detection paired, masks too) and one train step's
    losses against the reference, same weights."""
    jm, v, tm = shaped_pair(hbb_cfg(
        "MaskRCNN", neck=dict(type="FPN_CARAFE",
                              in_channels=(64, 128, 256, 512),
                              out_channels=64, num_outs=5),
        mask_head=dict(type="FCNMaskHead", **SMALL_MASK_HEAD)))
    batch = hbb_batch(masks=True)
    assert_matched(port_predict(tm, batch), ref_predict(jm, v, batch),
                   dict(boxes=2e-2, scores=2e-4, masks=1e-3))
    assert_losses_close(port_loss(tm, batch), ref_loss(jm, v, batch), 1e-4)


@needs_reference
@pytest.mark.parametrize("config", ["mask_rcnn_r50_fpn_carafe_1x",
                                    "scratch_mask_rcnn_r50_fpn_gn_6x"])
def test_config_weights_load_through_the_bridge(config):
    """Every leaf of the config's reference variables mapped and loaded
    strictly: FPN_CARAFE's carafe{i}, the GN mask head's norm{i}."""
    tm, sd = assert_bridge_loads(f"configs/{config}.py")
    if "carafe" in config:
        assert sd["neck.carafe3.content_encoder.weight"].shape == (
            100, 64, 3, 3)
    else:
        assert "mask_head.norm0.weight" in sd
        assert tm.mask_head.conv0.bias is None


@pytest.mark.gpu
def test_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the chip with python -m "
                    "pytest -m gpu tests/test_torch_port_ops_extra.py")
    import chip_smoke
    out = chip_smoke.run_hbb_reference(kind="carafe")
    assert out["max_abs_err"]["unpaired"] == 0 and out["n_valid"] > 0
    ops = chip_smoke.run_slice16_ops()
    assert ops["launches"]["roi_align"] == 2, ops
