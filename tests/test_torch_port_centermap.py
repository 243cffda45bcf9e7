"""The CenterMap OBB slice: the mask and semantic heads, their losses and
targets, the semantic map's single-level crop, and the small
CenterMap-Net (ResNet-18, 64-channel FPN, 128^2 input;
`torch_port_mask_models`, which tests/test_torch_port_maskobb.py runs
for MaskOBB and CenterMapOBB) of the reference and of the PyTorch port
end to end, with the reference's weights carried over by the weight
bridge, on the same seeded inputs, in float32 on the CPU.

Tolerances:
- heads (FCNMaskHead, CenterMapHead, WPSGAHead with its attention):
  1e-5 absolute on outputs of order 1 (float32 summation order);
- losses (CenterMapLoss, mask_cross_entropy, semantic_loss) and
  mask_target: 1e-6 relative, and mask_target 1e-6 absolute;
- the semantic map's crop (`_fuse_semantic` through the port's
  multi-level RoIAlign over one level) against the reference's
  single-level `ops/roi_align.py::roi_align`: 1e-5 absolute;
- the small models' predict: equal labels and valid, boxes within 1e-2
  px, scores within 1e-4, masks within 1e-3 (raw CenterMap maps and
  sigmoids); the loss: each term within 1e-4 relative, under a
  train_cfg that keeps every candidate so that both sides sample the
  same rois (`keep_every_candidate_cfg`), the targets uint8 as the
  pipeline ships them.
- `test_cfg.rcnn.nms`: the small flagship with a dict's iou_thr against
  the reference's with the same test_cfg and weights, at check_predict's
  limits (the port read only ``nms_thr`` before); `nms_cfg_kwargs`
  equal to the reference's on hard-NMS dicts; soft-NMS raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aidet_tpu.models.heads import mask_head as j_mask
from aidet_tpu.models.heads import semantic_head as j_sem
from aidet_tpu.models.losses import CenterMapLoss as JCenterMapLoss
from aidet_tpu.models.losses import mask_cross_entropy as j_mask_ce
from aidet_tpu.core.sample import FixedSample as JSample
from aidet_tpu.core.targets import mask_target as j_mask_target
from aidet_tpu.ops.roi_align import roi_align as j_roi_align

from aidet_tpu_torch.convert import flax_to_state_dict
from aidet_tpu_torch.core.sample import FixedSample
from aidet_tpu_torch.core.targets import mask_target
from aidet_tpu_torch.models.builder import build_detector
from aidet_tpu_torch.models.detectors.two_stage import _dq
from aidet_tpu_torch.models.heads import mask_head, semantic_head
from aidet_tpu_torch.models.losses import CenterMapLoss, mask_cross_entropy
from aidet_tpu_torch.ops.nms import nms_cfg_kwargs
from torch_port_helpers import to_np
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)
from torch_port_mask_models import (_centermap_cfg, check_loss,
                                    check_predict, run_pair)

def _load(module, variables, top):
    sd, unmapped = flax_to_state_dict({"params": {top: variables["params"]}})
    assert not unmapped
    prefix = {"_mask_head": "mask_head.",
              "_semantic_head": "semantic_head."}[top]
    module.load_state_dict({k[len(prefix):]: v for k, v in sd.items()},
                           strict=True)
    return module.eval()


@pytest.mark.parametrize("kind", ["fcn", "centermap"])
def test_mask_heads_match(kind):
    """The transposed conv's kernel is flipped in space by the bridge;
    without the flip the outputs differ by O(1)."""
    kw = dict(num_convs=2, in_channels=16, conv_out_channels=16,
              num_classes=5)
    if kind == "centermap":
        jm, tm = j_mask.CenterMapHead(**kw), mask_head.CenterMapHead(**kw)
    else:
        jm, tm = j_mask.FCNMaskHead(**kw), mask_head.FCNMaskHead(**kw)
    x = np.random.RandomState(0).randn(3, 7, 7, 16).astype(np.float32)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    ref = np.asarray(jm.apply(v, jnp.asarray(x)))
    with torch.no_grad():
        got = to_np(_load(tm, v, "_mask_head")(torch.from_numpy(x)))
    assert got.shape == ref.shape == (3, 14, 14, 4)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("attention", [True, False])
def test_wpsga_head_matches(attention):
    kw = dict(in_channels=16, channels=16, num_classes=6,
              with_attention=attention)
    jm, tm = j_sem.WPSGAHead(**kw), semantic_head.WPSGAHead(**kw)
    rs = np.random.RandomState(1)
    feats = [rs.randn(2, 32 // 2 ** i, 32 // 2 ** i, 16).astype(np.float32)
             for i in range(5)]
    v = jm.init(jax.random.PRNGKey(1), [jnp.asarray(f) for f in feats])
    ref = jm.apply(v, [jnp.asarray(f) for f in feats])
    with torch.no_grad():
        got = _load(tm, v, "_semantic_head")(
            [torch.from_numpy(f) for f in feats])
    for a, b in zip(got, ref):
        assert a.shape == b.shape
        np.testing.assert_allclose(to_np(a), np.asarray(b), atol=1e-5,
                                   rtol=0)


def test_bilinear_resize_raises_on_a_shrink():
    """jax.image.resize antialiases a bilinear shrink: the port's shrink
    (HTC's fused semantic head resizes its finer levels down) is that
    function within 1e-6, at 2x and at a ratio that is no integer; a
    resize that shrinks one axis and stretches the other, which torch
    cannot antialias on one axis alone, raises."""
    x = np.random.RandomState(3).randn(1, 16, 16, 3).astype(np.float32)
    for hw in ((8, 8), (5, 7)):
        ref = np.asarray(jax.image.resize(jnp.asarray(x), (1,) + hw + (3,),
                                          method="bilinear"))
        got = semantic_head.resize_bilinear(
            torch.from_numpy(x).permute(0, 3, 1, 2), hw).permute(0, 2, 3, 1)
        np.testing.assert_allclose(to_np(got), ref, atol=1e-6, rtol=0)
    with pytest.raises(NotImplementedError, match="shrinks"):
        semantic_head.resize_bilinear(torch.zeros(1, 1, 8, 8), (4, 16))


def _sample(rs, r, g):
    gt_inds = rs.randint(-1, g, r)
    return gt_inds, gt_inds >= 0


def test_mask_target_matches():
    """Soft masks, and the pipeline's uint8 levels as `loss`
    dequantizes them (/255) before `mask_target` reads them."""
    rs = np.random.RandomState(2)
    b, r, g, m = 2, 12, 5, 24
    xy = rs.uniform(-4, m - 6, (b, r, 2))
    rois = np.concatenate([xy, xy + rs.uniform(1, 14, (b, r, 2))],
                          -1).astype(np.float32)
    masks = rs.rand(b, g, m, m).astype(np.float32)
    q = np.round(masks * 255).astype(np.uint8)
    gt_inds, is_pos = _sample(rs, b * r, g)
    gt_inds, is_pos = gt_inds.reshape(b, r), is_pos.reshape(b, r)
    for gm in (masks, to_np(_dq(torch.from_numpy(q)))):
        ref = np.stack([np.asarray(j_mask_target(
            JSample(jnp.zeros(r, jnp.int32), jnp.asarray(is_pos[i]),
                    jnp.asarray(is_pos[i]), jnp.asarray(gt_inds[i])),
            jnp.asarray(rois[i]), jnp.asarray(gm[i]), 28))
            for i in range(b)])
        t = FixedSample(torch.zeros(b, r, dtype=torch.long),
                        torch.from_numpy(is_pos), torch.from_numpy(is_pos),
                        torch.from_numpy(gt_inds))
        got = to_np(mask_target(t, torch.from_numpy(rois),
                                torch.from_numpy(gm), 28))
        np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
        assert np.all(got[~is_pos] == 0)


def test_mask_losses_match():
    rs = np.random.RandomState(3)
    r, s, c = 10, 8, 15
    pred = rs.randn(r, s, s, c).astype(np.float32)
    tgt = rs.rand(r, s, s).astype(np.float32)
    mw = (rs.rand(r, s, s) + 1).astype(np.float32)
    label = rs.randint(0, c + 2, r)        # 0 and c + 1 clamp
    pos = (rs.rand(r) > 0.3).astype(np.float32)
    navg = max(pos.sum(), 1.0) * s * s
    cases = [
        (JCenterMapLoss()(jnp.asarray(pred), jnp.asarray(tgt),
                          jnp.asarray(label), mask_weight=jnp.asarray(mw),
                          roi_weight=jnp.asarray(pos), avg_factor=navg),
         CenterMapLoss()(torch.from_numpy(pred), torch.from_numpy(tgt),
                         torch.from_numpy(label),
                         mask_weight=torch.from_numpy(mw),
                         roi_weight=torch.from_numpy(pos), avg_factor=navg)),
        (JCenterMapLoss()(jnp.asarray(pred), jnp.asarray(tgt),
                          jnp.asarray(label)),
         CenterMapLoss()(torch.from_numpy(pred), torch.from_numpy(tgt),
                         torch.from_numpy(label))),
        (j_mask_ce(jnp.asarray(pred), jnp.asarray(tgt), jnp.asarray(label),
                   weight=jnp.asarray(pos)[:, None, None], avg_factor=navg),
         mask_cross_entropy(torch.from_numpy(pred), torch.from_numpy(tgt),
                            torch.from_numpy(label),
                            weight=torch.from_numpy(pos)[:, None, None],
                            avg_factor=navg))]
    for ref, got in cases:
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)


@pytest.mark.parametrize("weighted,focal,size", [
    (True, True, 16), (False, True, 16), (False, False, 8),
    (True, False, 8)])
def test_semantic_loss_matches(weighted, focal, size):
    """``size`` 16: the targets at twice the logits' resolution (nearest
    with half-pixel centres); the weights stay at the logits' size, as
    the configs give them."""
    rs = np.random.RandomState(4)
    logits = rs.randn(2, 8, 8, 6).astype(np.float32)
    gt = rs.randint(0, 6, (2, size, size)).astype(np.int32)
    gt[0, :2] = 255
    wm = rs.rand(2, 8, 8).astype(np.float32) if weighted else None
    kw = dict(loss_weight=0.7, use_focal=focal, focal_gamma=2.0)
    ref = j_sem.semantic_loss(jnp.asarray(logits), jnp.asarray(gt),
                              None if wm is None else jnp.asarray(wm), **kw)
    got = semantic_head.semantic_loss(
        torch.from_numpy(logits), torch.from_numpy(gt),
        None if wm is None else torch.from_numpy(wm), **kw)
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)


def test_semantic_crop_is_the_single_level_roi_align():
    """`_fuse_semantic`'s crop (the port's multi-level RoIAlign on one
    level: K1 / K2 on the card, the plain version here) against the
    reference's single-level XLA roi_align at 1 / stride, sampling 2,
    aligned, rois partly outside the map included."""
    rs = np.random.RandomState(5)
    sem = rs.randn(2, 32, 32, 8).astype(np.float32)
    xy = rs.uniform(-20, 110, (2, 9, 2))
    rois = np.concatenate([xy, xy + rs.uniform(1, 90, (2, 9, 2))],
                          -1).astype(np.float32)
    model = build_detector(dict(type="CenterMapNet", **_centermap_cfg()),
                           device="cpu")
    for size in (7, 14):
        ref = np.stack([np.asarray(j_roi_align(
            jnp.asarray(sem[i]), jnp.asarray(rois[i]), size, 0.25))
            for i in range(2)])
        crops = torch.zeros(2, 9, size, size, 8)
        got = model._fuse_semantic(crops, torch.from_numpy(sem),
                                   torch.from_numpy(rois), size)
        np.testing.assert_allclose(to_np(got), ref, atol=1e-5, rtol=0)


@pytest.fixture(scope="module")
def pair():
    return run_pair("CenterMapNet")


def test_predict_matches(pair):
    check_predict(pair)


def test_loss_matches(pair):
    check_loss(pair)


def test_nms_cfg_is_honoured():
    """The small flagship with ``test_cfg.rcnn.nms=dict(type='nms',
    iou_thr=0.3)``, the reference's and the port's on the same weights,
    keep the same detections (check_predict's limits); the port at its
    default 0.5 keeps others, so the test fails where the port reads
    only ``nms_thr`` (as it did before)."""
    import copy

    from __graft_entry__ import _build_flagship
    from aidet_tpu_torch.flagship import build_flagship
    from torch_port_helpers import perturb_norms

    img = 128
    rc = dict(nms=dict(type="nms", iou_thr=0.3), max_per_img=64)
    base = _build_flagship(img, small=True)
    test_cfg = copy.deepcopy(base.test_cfg)
    test_cfg["rcnn"].update(rc)
    jm = base.clone(test_cfg=test_cfg)
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, img, img, 3)))
    v = perturb_norms(v, 3)
    sd, unmapped = flax_to_state_dict(v)
    assert not unmapped
    imgs = np.random.RandomState(4).randint(0, 256, (2, img, img, 3),
                                            np.uint8)
    shapes = np.asarray([[img, img], [img, 112]], np.float32)
    ref = jax.jit(lambda v, i, s: jm.apply(v, i, s, method="predict"))(
        v, jnp.asarray(imgs), jnp.asarray(shapes))
    ref = {k: np.asarray(x) for k, x in ref.items()}
    outs = {}
    for name, upd in (("dict", rc), ("default", dict(max_per_img=64))):
        m = build_flagship(img, small=True, device="cpu")
        m.load_state_dict(sd, strict=True)
        m.test_cfg["rcnn"].update(upd)
        outs[name] = {k: to_np(x) for k, x in m.predict(
            torch.from_numpy(imgs), torch.from_numpy(shapes)).items()}
    got = outs["dict"]
    assert got["valid"].sum() > 0
    np.testing.assert_array_equal(got["valid"], ref["valid"])
    np.testing.assert_array_equal(got["labels"], ref["labels"])
    assert np.abs(got["boxes"] - ref["boxes"]).max() < 1e-2
    assert np.abs(got["scores"] - ref["scores"]).max() < 1e-4
    assert np.abs(outs["default"]["boxes"] - ref["boxes"]).max() > 1.0


@pytest.mark.parametrize("cfg", [
    dict(nms_thr=0.4), dict(nms_thr=0.4, nms=dict(type="nms", iou_thr=0.6)),
    dict(nms=dict(type="nms", iou_thr=0.3)), dict(nms=dict(type="nms")),
    dict(nms=dict(iou_thr=0.7)), {}])
def test_nms_cfg_kwargs_match(cfg):
    from aidet_tpu.ops.nms import nms_cfg_kwargs as j_nms_cfg_kwargs
    assert nms_cfg_kwargs(cfg) == j_nms_cfg_kwargs(cfg)


def test_nms_cfg_kwargs():
    """soft-NMS parses to its method, sigma and min_score (the
    reference's defaults where the config names none); an unknown type
    raises as in the reference."""
    from aidet_tpu.ops.nms import nms_cfg_kwargs as j_nms_cfg_kwargs
    for cfg in (dict(nms=dict(type="soft_nms", iou_thr=0.5)),
                dict(nms=dict(type="soft_nms", method="gaussian", sigma=0.3,
                              min_score=0.01))):
        assert nms_cfg_kwargs(cfg) == j_nms_cfg_kwargs(cfg)
    assert nms_cfg_kwargs(dict(nms=dict(type="soft_nms", iou_thr=0.5))) == \
        dict(iou_thr=0.5, nms_type="soft_nms", soft_method="linear",
             sigma=0.5, min_score=1e-3)
    with pytest.raises(ValueError):
        nms_cfg_kwargs(dict(nms=dict(type="matrix_nms")))
