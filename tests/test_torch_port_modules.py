"""Modules of the PyTorch port against the JAX reference, in float32 on
the CPU: normalize, ResNet, FPN, RPN head, anchors, proposals, box and
thetaobb codecs, and the RoI heads with their decodes.

Tolerance: atol 1e-4 on float outputs (both sides compute in float32;
convolutions and matrix products sum in different orders), exact for
masks, indices and anchors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aidet_tpu.core import anchors as j_anchors
from aidet_tpu.core import boxes as j_boxes
from aidet_tpu.core import rboxes as j_rboxes
from aidet_tpu.models.backbones.resnet import ResNet as JResNet
from aidet_tpu.models.heads import anchor_head as j_anchor_head
from aidet_tpu.models.heads import bbox_head as j_bbox_head
from aidet_tpu.models.heads.rpn_head import RPNHead as JRPNHead
from aidet_tpu.models.necks.fpn import FPN as JFPN
from aidet_tpu.models.preprocess import device_normalize as j_normalize

from aidet_tpu_torch.core import anchors, boxes, rboxes
from aidet_tpu_torch.models.backbones.resnet import ResNet
from aidet_tpu_torch.models.heads import anchor_head, bbox_head
from aidet_tpu_torch.models.heads.rpn_head import RPNHead
from aidet_tpu_torch.models.necks.fpn import FPN
from aidet_tpu_torch.models.preprocess import device_normalize
from torch_port_helpers import load_flax, perturb_norms, to_np
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

ATOL = 1e-4


def close(got, ref, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(to_np(got), np.asarray(ref), atol=atol,
                               rtol=rtol)


def test_device_normalize_matches_reference():
    img = np.random.RandomState(0).randint(0, 256, (2, 16, 16, 3), np.uint8)
    close(device_normalize(torch.from_numpy(img)),
          j_normalize(jnp.asarray(img)), atol=1e-6)
    custom = dict(mean=(10, 20, 30), std=(2, 3, 4), to_rgb=False)
    close(device_normalize(torch.from_numpy(img), custom),
          j_normalize(jnp.asarray(img), custom), atol=1e-6)
    x = torch.ones(1, 4, 4, 3)
    assert device_normalize(x) is x


@pytest.mark.parametrize("depth,s2d", [(18, False), (50, True)])
def test_resnet_c2_to_c5(depth, s2d):
    """Depth 18, and depth 50 with the space-to-depth stem: the
    reference runs its phase-decomposed stem conv, the port the plain
    4x4 conv over the same [4, 4, 12, 64] weight.  The maps of the
    random depth-50 net grow to ~1e3, so atol 1e-4 applies after
    dividing both sides by the map's largest magnitude (when above 1)."""
    x = np.random.RandomState(depth).randn(2, 64, 64, 3).astype(np.float32)
    jm = JResNet(depth=depth, stem_space_to_depth=s2d, stem_s2d_phase=s2d)
    v = perturb_norms(jax.jit(jm.init)(jax.random.PRNGKey(depth),
                                       jnp.asarray(x)), depth)
    ref = jax.jit(jm.apply)(v, jnp.asarray(x))
    tm = load_flax(ResNet(depth=depth, stem_space_to_depth=s2d), v,
                   "_backbone")
    with torch.no_grad():
        out = tm(torch.from_numpy(x))
    assert len(out) == 4
    for a, b in zip(out, ref):
        assert a.shape == b.shape
        scale = max(1.0, float(np.abs(np.asarray(b)).max()))
        close(a / scale, np.asarray(b) / scale)


@pytest.mark.parametrize("base", [16, 10])
def test_fpn_levels(base):
    """Even sizes (the flagship's exact 2x upsampling) and odd ones
    (nearest resize with half-pixel centres)."""
    rs = np.random.RandomState(base)
    chans = (64, 128, 256, 512)
    xs = [rs.randn(2, max(1, -(-base // 2 ** i)), max(1, -(-base // 2 ** i)),
                   c).astype(np.float32) for i, c in enumerate(chans)]
    jm = JFPN(in_channels=chans, out_channels=64, num_outs=5)
    jx = [jnp.asarray(x) for x in xs]
    v = jax.jit(jm.init)(jax.random.PRNGKey(1), jx)
    ref = jax.jit(jm.apply)(v, jx)
    tm = load_flax(FPN(in_channels=chans, out_channels=64), v, "_neck")
    with torch.no_grad():
        out = tm([torch.from_numpy(x) for x in xs])
    assert len(out) == 5
    for a, b in zip(out, ref):
        assert a.shape == b.shape
        close(a, b)


def test_rpn_head_outputs():
    rs = np.random.RandomState(2)
    xs = [rs.randn(2, s, s, 64).astype(np.float32) for s in (16, 8, 4, 2, 1)]
    jm = JRPNHead(in_channels=64, feat_channels=64, num_anchors=3)
    jx = [jnp.asarray(x) for x in xs]
    v = jax.jit(jm.init)(jax.random.PRNGKey(2), jx)
    ref_cls, ref_reg = jax.jit(jm.apply)(v, jx)
    tm = load_flax(RPNHead(64, 64, 3), v, "_rpn")
    with torch.no_grad():
        cls, reg = tm([torch.from_numpy(x) for x in xs])
    for a, b in zip(cls + reg, list(ref_cls) + list(ref_reg)):
        assert a.shape == b.shape
        close(a, b)


@pytest.mark.parametrize("img", [256, 1024])
def test_pyramid_anchors(img):
    a, sizes = anchors.build_pyramid_anchors(img, (4, 8, 16, 32, 64))
    ref, ref_sizes = j_anchors.build_pyramid_anchors(img, (4, 8, 16, 32, 64))
    assert sizes == ref_sizes
    np.testing.assert_array_equal(to_np(a), np.asarray(ref))


def _rpn_inputs(img, seed):
    rs = np.random.RandomState(seed)
    sizes = [img // s for s in (4, 8, 16, 32, 64)]
    cls = [rs.randn(2, s, s, 3).astype(np.float32) for s in sizes]
    reg = [(0.3 * rs.randn(2, s, s, 12)).astype(np.float32) for s in sizes]
    return cls, reg


def test_flatten_level_outputs_order():
    cls, reg = _rpn_inputs(64, 3)
    c, r = anchor_head.flatten_level_outputs(
        [torch.from_numpy(x) for x in cls], [torch.from_numpy(x) for x in reg],
        1)
    jc, jr = j_anchor_head.flatten_level_outputs(
        [jnp.asarray(x) for x in cls], [jnp.asarray(x) for x in reg], 1)
    np.testing.assert_array_equal(to_np(c), np.asarray(jc))
    np.testing.assert_array_equal(to_np(r), np.asarray(jr))


@pytest.mark.parametrize("cfg", [
    dict(nms_pre=128, nms_post=64, max_num=64),
    dict(nms_pre=1000, nms_post=500, max_num=300),
    dict(nms_pre=200, nms_post=2000, max_num=1000, min_bbox_size=12.0),
])
def test_rpn_proposals(cfg):
    img = 128
    cls, reg = _rpn_inputs(img, 4)
    a, sizes = anchors.build_pyramid_anchors(img, (4, 8, 16, 32, 64))
    shapes = np.asarray([[128, 100], [90, 128]], np.float32)
    c, r = anchor_head.flatten_level_outputs(
        [torch.from_numpy(x) for x in cls], [torch.from_numpy(x) for x in reg],
        1)
    got = anchor_head.rpn_proposals(c, r, a, sizes, torch.from_numpy(shapes),
                                    **cfg)
    jc, jr = j_anchor_head.flatten_level_outputs(
        [jnp.asarray(x) for x in cls], [jnp.asarray(x) for x in reg], 1)
    ja, _ = j_anchors.build_pyramid_anchors(img, (4, 8, 16, 32, 64))
    ref = j_anchor_head.rpn_proposals(jc, jr, ja, sizes,
                                      jnp.asarray(shapes), **cfg)
    np.testing.assert_array_equal(to_np(got[2]), np.asarray(ref[2]))
    assert to_np(got[2]).sum() > 0
    close(got[0], ref[0])
    close(got[1], ref[1], atol=1e-6)


def test_delta2bbox_per_class_with_clip():
    rs = np.random.RandomState(5)
    xy = rs.uniform(0, 200, (2, 30, 2))
    rois = np.concatenate([xy, xy + rs.uniform(1, 80, (2, 30, 2))],
                          -1).astype(np.float32)
    deltas = rs.randn(2, 30, 16).astype(np.float32)
    shapes = np.asarray([[200, 180], [150, 210]], np.float32)
    got = boxes.delta2bbox(torch.from_numpy(rois), torch.from_numpy(deltas),
                           (0.1, 0., 0., -0.1), (0.1, 0.1, 0.2, 0.2),
                           max_shape=torch.from_numpy(shapes)[:, None])
    for i in range(2):
        ref = j_boxes.delta2bbox(jnp.asarray(rois[i]), jnp.asarray(deltas[i]),
                                 (0.1, 0., 0., -0.1), (0.1, 0.1, 0.2, 0.2),
                                 max_shape=jnp.asarray(shapes[i]))
        close(got[i], ref)
    ref = j_boxes.delta2bbox(jnp.asarray(rois), jnp.asarray(deltas))
    close(boxes.delta2bbox(torch.from_numpy(rois), torch.from_numpy(deltas)),
          ref)


def _thetaobbs(rs, n):
    return np.stack([rs.uniform(0, 300, n), rs.uniform(0, 300, n),
                     rs.uniform(2, 90, n), rs.uniform(2, 90, n),
                     rs.uniform(-np.pi / 2, -1e-3, n)], -1).astype(np.float32)


def test_thetaobb_codec():
    rs = np.random.RandomState(6)
    xy = rs.uniform(0, 250, (40, 2))
    props = np.concatenate([xy, xy + rs.uniform(4, 90, (40, 2))],
                           -1).astype(np.float32)
    gt = _thetaobbs(rs, 40)
    means, stds = (0., 0., 0., 0., 0.), (0.1, 0.1, 0.2, 0.2, 0.1)
    enc = rboxes.thetaobb2delta(torch.from_numpy(props), torch.from_numpy(gt),
                                means, stds)
    close(enc, j_rboxes.thetaobb2delta(jnp.asarray(props), jnp.asarray(gt),
                                       means, stds))
    dec = rboxes.delta2thetaobb(torch.from_numpy(props), enc, means, stds)
    close(dec, j_rboxes.delta2thetaobb(jnp.asarray(props),
                                       jnp.asarray(to_np(enc)), means, stds))
    # the legacy pair: decode(encode(gt)) = gt with w+1, h+1
    close(dec, gt + np.asarray([0, 0, 1, 1, 0], np.float32), atol=1e-3)
    theta = to_np(dec)[:, 4]
    assert ((theta >= -np.pi / 2) & (theta < 0)).all()
    close(rboxes.thetaobb2pointobb(torch.from_numpy(gt)),
          j_rboxes.thetaobb2pointobb(jnp.asarray(gt)))


@pytest.mark.parametrize("kind", ["bbox", "rbbox"])
def test_roi_heads_and_decodes(kind):
    rs = np.random.RandomState(7)
    crops = rs.randn(12, 7, 7, 64).astype(np.float32)
    if kind == "bbox":
        jm = j_bbox_head.SharedFCBBoxHead(num_classes=16, in_channels=64,
                                          fc_out_channels=128)
        tm = bbox_head.SharedFCBBoxHead(num_classes=16, in_channels=64,
                                        fc_out_channels=128)
        top = "_bbox_head"
    else:
        jm = j_bbox_head.RBBoxHead(num_classes=16, in_channels=64,
                                   fc_out_channels=128, encode="thetaobb")
        tm = bbox_head.RBBoxHead(num_classes=16, in_channels=64,
                                 fc_out_channels=128, encode="thetaobb")
        top = "_rbbox_head"
    v = jax.jit(jm.init)(jax.random.PRNGKey(7), jnp.asarray(crops))
    ref_cls, ref_reg = jax.jit(jm.apply)(v, jnp.asarray(crops))
    load_flax(tm, v, top)
    with torch.no_grad():
        cls, reg = tm(torch.from_numpy(crops))
    close(cls, ref_cls)
    close(reg, ref_reg)

    xy = rs.uniform(0, 200, (12, 2))
    rois = np.concatenate([xy, xy + rs.uniform(4, 60, (12, 2))],
                          -1).astype(np.float32)
    shape = np.asarray([220, 230], np.float32)
    if kind == "bbox":
        got = bbox_head.bbox_head_decode(
            torch.from_numpy(rois), cls, reg,
            img_shape=torch.from_numpy(shape))
        ref = j_bbox_head.bbox_head_decode(
            jnp.asarray(rois), ref_cls, ref_reg,
            target_stds=(0.1, 0.1, 0.2, 0.2), img_shape=jnp.asarray(shape))
    else:
        got = bbox_head.rbbox_head_decode(torch.from_numpy(rois), cls, reg)
        ref = j_bbox_head.rbbox_head_decode(jnp.asarray(rois), ref_cls,
                                            ref_reg)
    close(got[0], ref[0], atol=1e-3)
    close(got[1], ref[1], atol=1e-5)
