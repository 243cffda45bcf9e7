"""Building from a config and single-image inference in the port,
against the JAX package, on the CPU: the test pipeline
(`data/pipeline.py`), the config loader and registries
(`utils/config.py`, `utils/registry.py`, `models/builder.py`), predict's
``scale_factors``, and `apis/inference.py` / `apis/async_inference.py`.

Tolerances:
- the resize without OpenCV is within 1 grey level of cv2.INTER_LINEAR
  (uint8; cv2 rounds in fixed point: about 12% of the pixels differ by
  one, none by more), within 1e-2 of it on float32 images of 0..255
  (the two round their weights differently: up to 8.6e-3 seen); an
  image that already has the target size comes back untouched;
- `TestPipeline`: at the target size, both branches equal the
  reference's (uint8 bit for bit; the normalized floats within 1e-6 of
  the reference's native normalize_pad); resized, within one grey level
  (1 / 57.12 after normalizing);
- predict with ``scale_factors`` (thetaobb, pointobb and refined
  heads) and a detector built from the small flagship's config dict:
  every detection paired (`chip_smoke.match_detections`) with equal
  labels, scores within 1e-4, boxes and rboxes within 2e-2 px (1e-2
  px at the input's scale, divided by the smaller factor, 0.5) plus
  1e-3 of their largest coordinate (random weights decode rboxes
  thousands of pixels wide; a refined one was seen 0.75 px apart at
  3400 px), theta within 1e-3 (float32); pointobb corners, held with
  the boxes, within 0.1 px (their random-weight corners reach 2822 px
  at the input's scale, 2.9e-2 px apart there, 5.8e-2 after / 0.5);
- `inference_detector` on a 600x800 image of 25-px blocks, which both
  pipelines resize to 192x256 exactly (every sample's neighbours lie in
  one block), so the rest is float32: per class, every detection is
  paired with one of the reference's within 5e-2 px (in the image's
  frame, 1 / 0.32 times the input's) and 1e-4 in score;
- `AsyncInferencer`: the same outputs, bit for bit and in order, as
  `inference_detector`'s.
"""

import asyncio
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aidet_tpu.apis.inference import \
    inference_detector as ref_inference_detector
from aidet_tpu.data import pipeline as ref_pipeline
from aidet_tpu.models import build_detector as ref_build_detector
from aidet_tpu.utils.config import Config as RefConfig

import chip_smoke
from aidet_tpu_torch.apis.async_inference import (AsyncInferencer,
                                                  async_inference_detector)
from aidet_tpu_torch.apis.inference import inference_detector, init_detector
from aidet_tpu_torch.convert import flax_to_state_dict
from aidet_tpu_torch.data import pipeline
from aidet_tpu_torch.flagship import build_flagship
from aidet_tpu_torch.models.builder import build_detector
from aidet_tpu_torch.utils.config import Config
from torch_port_helpers import perturb_norms
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

IMG = 256
LIMITS = dict(boxes=2e-2, scores=1e-4, rboxes=2e-2, rboxes_rel=1e-3,
              theta=1e-3)


def small_flagship_cfg(img_size):
    """The small flagship's config dict (__graft_entry__.py:23-40)."""
    return dict(
        type="RBBoxRCNN",
        backbone=dict(type="ResNet", depth=18),
        neck=dict(type="FPN", in_channels=(64, 128, 256, 512),
                  out_channels=64, num_outs=5),
        rpn_head=dict(type="RPNHead", in_channels=64, feat_channels=64,
                      num_anchors=3),
        bbox_head=dict(type="SharedFCBBoxHead", num_classes=16,
                       in_channels=64, fc_out_channels=128),
        rbbox_head=dict(type="RBBoxHead", num_classes=16,
                        in_channels=64, fc_out_channels=128,
                        encode="thetaobb"),
        train_cfg=dict(
            rpn_proposal=dict(nms_pre=128, nms_post=64, max_num=64),
            rcnn=dict(num_samples=16)),
        test_cfg=dict(rpn=dict(nms_pre=128, nms_post=64, max_num=64),
                      rcnn=dict(max_per_img=16)),
        img_size=img_size)


def _image(h, w, seed=0):
    """A uint8 BGR image with smooth structure and noise."""
    rs = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = 120 + 60 * np.sin(x / 37.0)[..., None] * np.cos(y / 23.0)[..., None]
    img = base + rs.randint(-40, 40, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("hw,target", [((600, 800), 1024), ((600, 800), 256),
                                       ((700, 900), 512), ((80, 50), 256)])
def test_resize_within_one_grey_level_of_cv2(hw, target):
    img = np.random.RandomState(1).randint(0, 256, hw + (3,), np.uint8)
    got, scale = pipeline.resize_keep_ratio(img, target)
    ref, ref_scale = ref_pipeline.resize_keep_ratio(img, target)
    assert scale == ref_scale and got.shape == ref.shape
    assert got.dtype == np.uint8
    diff = np.abs(got.astype(int) - ref.astype(int))
    assert diff.max() <= 1
    assert diff.mean() < 0.2
    f = img.astype(np.float32)
    got_f, _ = pipeline.resize_keep_ratio(f, target)
    ref_f = cv2.resize(f, got.shape[1::-1], interpolation=cv2.INTER_LINEAR)
    assert got_f.dtype == np.float32
    np.testing.assert_allclose(got_f, ref_f, rtol=0, atol=1e-2)


def test_resize_at_target_size_is_untouched():
    img = _image(1024, 700)
    got, scale = pipeline.resize_keep_ratio(img, 1024)
    assert got is img and scale == 1.0
    np.testing.assert_array_equal(got,
                                  ref_pipeline.resize_keep_ratio(img, 1024)[0])


@pytest.mark.parametrize("hw", [(IMG, IMG), (IMG, 200), (600, 800)])
@pytest.mark.parametrize("device_normalize", [False, True])
def test_test_pipeline_equal_reference(hw, device_normalize):
    img = _image(*hw)
    got = pipeline.TestPipeline(IMG, device_normalize=device_normalize)(img)
    ref = ref_pipeline.TestPipeline(IMG,
                                    device_normalize=device_normalize)(img)
    assert got.keys() == ref.keys()
    for k in ("img_shapes", "scale_factors"):
        np.testing.assert_array_equal(got[k], ref[k])
    assert got["imgs"].dtype == ref["imgs"].dtype
    resized = max(hw) != IMG
    if device_normalize:
        diff = np.abs(got["imgs"].astype(int) - ref["imgs"].astype(int))
        assert diff.max() <= (1 if resized else 0)
    else:
        np.testing.assert_allclose(got["imgs"], ref["imgs"], rtol=0,
                                   atol=1 / 57.12 + 1e-5 if resized
                                   else 1e-6)


@pytest.mark.parametrize("path", [
    "configs/dota_rroi_point_obb_r50_fpn_1x.py",
    "configs/bc_v002_mask_rcnn_r50_v2_jinan_roof.py",
    "configs/faster_rcnn_r50_fpn_fp16_1x.py"])
def test_config_fromfile_equal_reference(path):
    got, ref = Config.fromfile(path), RefConfig.fromfile(path)
    assert got.to_dict() == ref.to_dict()
    assert got.model.type == ref.model.type
    assert got.get("fp16") == ref.get("fp16")


def test_registry_names_what_is_not_ported():
    """Unregistered types raise the registry's KeyError naming them (a
    PAFPN neck, which neither package has; FasterRCNN, GridRCNN,
    GARetinaNet and the FPN_CARAFE neck, which this test named before
    they were ported, now build), a config's list of necks too (Libra's
    FPN then BFP now builds; FPN then the unregistered PAFPN is built in
    order and raises the KeyError, not an AttributeError; NASFPN, which
    it named before, now builds), unported options raise
    NotImplementedError (a BN norm_cfg of the FCN mask head, ResNet
    strides other than the reference's default, a mismatched
    rbbox_encode; Mask Scoring R-CNN's mask_iou_head, the C4
    shared_head, the ResNet's dcn, gcb and gen_attention and the FCN
    mask head's GN norm_cfg, which it named before they were ported,
    now build)."""
    with pytest.raises(KeyError, match="PAFPN.*not yet ported"):
        build_detector(dict(type="FasterRCNN", neck=dict(
            type="PAFPN")), device="cpu")
    build_detector(dict(type="FasterRCNN", neck=dict(type="FPN_CARAFE")),
                   device="meta")
    build_detector(dict(type="GARetinaNet"), device="meta")
    build_detector(dict(type="GridRCNN"), device="meta")
    libra = Config.fromfile("configs/libra_retinanet_r50_fpn_1x.py")
    assert [n["type"] for n in libra.model.neck] == ["FPN", "BFP"]
    with torch.device("meta"):
        built = build_detector(dict(libra.model), device="meta")
    assert [type(n).__name__ for n in built.neck] == ["FPN", "BFP"]
    with pytest.raises(KeyError, match="PAFPN.*not yet ported"):
        with torch.device("meta"):
            build_detector(dict(libra.model, neck=[
                libra.model.neck[0], dict(type="PAFPN")]),
                device="meta")
    build_detector(dict(type="MaskScoringRCNN", mask_head=dict(
        type="FCNMaskHead"), mask_iou_head=dict(type="MaskIoUHead")),
        device="meta")
    build_detector(dict(type="MaskRCNN", mask_head=dict(
        type="FCNMaskHead", norm_cfg=dict(type="GN", num_groups=32))),
        device="meta")
    with pytest.raises(NotImplementedError, match="norm_cfg"):
        build_detector(dict(type="MaskRCNN", mask_head=dict(
            type="FCNMaskHead", norm_cfg=dict(type="BN"))), device="meta")
    cfg = small_flagship_cfg(IMG)
    build_detector(dict(cfg, type="FasterRCNN", rbbox_head=None,
                        shared_head=dict(type="ResLayer", depth=18)),
                   device="meta")
    build_detector(dict(cfg, backbone=dict(type="ResNet", depth=50,
                                           gcb=dict(ratio=0.25))),
                   device="meta")
    build_detector(dict(cfg, backbone=dict(
        type="ResNet", depth=50, gen_attention=dict(attention_type="1111"),
        gen_attention_stages=(False, False, True, True))), device="meta")
    with pytest.raises(NotImplementedError, match="strides"):
        build_detector(dict(cfg, backbone=dict(type="ResNet", depth=50,
                                               strides=(1, 2, 2, 1))),
                       device="cpu")
    build_detector(dict(cfg, backbone=dict(type="ResNet", depth=50,
                                           dcn=dict(modulated=True))),
                   device="meta")
    with pytest.raises(NotImplementedError, match="rbbox_encode"):
        build_detector(dict(cfg, rbbox_encode="pointobb"), device="cpu")
    hrnet = build_detector(dict(
        cfg, backbone=dict(type="HRNet", width=8, stage_modules=(1, 1, 1, 1),
                           stage_blocks=1),
        neck=dict(type="HRFPN", in_channels=(8, 16, 32, 64),
                  out_channels=64)), device="cpu")
    assert type(hrnet.backbone).__name__ == "HRNet"
    assert hrnet.neck.reduce.in_channels == 120


def test_fp16_and_dtype_names_map_to_bfloat16():
    model_cfg = dict(small_flagship_cfg(64))
    cfg = Config(dict(model=model_cfg, fp16=dict(loss_scale=512.0)))
    model, _ = init_detector(cfg, device="cpu")
    assert model.dtype == torch.bfloat16
    assert next(model.parameters()).dtype == torch.bfloat16
    sub = dict(small_flagship_cfg(64))
    for k in ("backbone", "neck", "rpn_head", "bbox_head", "rbbox_head"):
        sub[k] = dict(sub[k], dtype=jnp.bfloat16)
    assert build_detector(sub, device="cpu").dtype == torch.bfloat16
    sub["neck"] = dict(sub["neck"], dtype="float32")
    with pytest.raises(NotImplementedError, match="several dtypes"):
        build_detector(sub, device="cpu")


@pytest.fixture(scope="module")
def flagship():
    """The small flagship from its config dict in both packages, the
    reference's variables carried over by the weight bridge."""
    jm = ref_build_detector(small_flagship_cfg(IMG))
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)))
    v = perturb_norms(v, 0)
    tm = build_detector(small_flagship_cfg(IMG), device="cpu")
    sd, unmapped = flax_to_state_dict(v, tm)
    assert unmapped == []
    tm.load_state_dict(sd, strict=True)
    return jm, v, tm


def test_config_build_is_the_small_flagship(flagship):
    _, _, tm = flagship
    want = build_flagship(IMG, small=True, device="cpu")
    assert {k: tuple(t.shape) for k, t in tm.state_dict().items()} == \
        {k: tuple(t.shape) for k, t in want.state_dict().items()}
    assert tm.test_cfg == want.test_cfg and tm.train_cfg == want.train_cfg
    assert tm.dtype == torch.float32 and tm.rbbox_head.encode == "thetaobb"


def _ref_predict(jm, v, imgs, shapes, sf=None):
    args = [jnp.asarray(imgs), jnp.asarray(shapes)]
    if sf is not None:
        args.append(jnp.asarray(sf))
    out = jax.jit(lambda v, *a: jm.apply(v, *a, method="predict"))(v, *args)
    return {k: torch.from_numpy(np.array(x)) for k, x in out.items()}


def _small_rroi_cfgs():
    """A small RBBoxRCNN with a pointobb head, and the same with the
    rtheta refinement head (RBBoxRCNNRRoI)."""
    first = dict(small_flagship_cfg(IMG), rbbox_encode="pointobb")
    first["rbbox_head"] = dict(first["rbbox_head"], encode="pointobb")
    refine = dict(first, type="RBBoxRCNNRRoI", rbbox_refine_head=dict(
        type="RBBoxHead", num_classes=16, in_channels=64,
        fc_out_channels=128, encode="rtheta"))
    return first, refine


@pytest.fixture(scope="module")
def rroi_variables():
    """The reference's variables of the small RBBoxRCNNRRoI, which hold
    the pointobb RBBoxRCNN's too (its parameters less the refinement
    head): one init for both."""
    jm = ref_build_detector(_small_rroi_cfgs()[1])
    return perturb_norms(jax.jit(jm.init)(jax.random.PRNGKey(0),
                                          jnp.zeros((1, IMG, IMG, 3))), 1)


@pytest.mark.parametrize("which", ["thetaobb", "pointobb", "refined"])
def test_predict_scale_factors_match_reference(flagship, rroi_variables,
                                               which):
    """Boxes / sf; thetaobbs (a thetaobb head's or the refinement
    head's) have centre, w and h / sf and theta kept; pointobbs / sf."""
    imgs = np.random.RandomState(2).randint(0, 256, (2, IMG, IMG, 3),
                                            np.uint8)
    shapes = np.asarray([[IMG, IMG], [IMG, 200]], np.float32)
    sf = np.asarray([1.28, 0.5], np.float32)
    if which == "thetaobb":
        jm, v, tm = flagship
    else:
        cfg = _small_rroi_cfgs()[which == "refined"]
        jm, v = ref_build_detector(cfg), rroi_variables
        tm = build_detector(cfg, device="cpu")
        sd = flax_to_state_dict(v, tm)[0]
        tm.load_state_dict({k: sd[k] for k in tm.state_dict()}, strict=True)
    ref = _ref_predict(jm, v, imgs, shapes, sf)
    t_args = (torch.from_numpy(imgs), torch.from_numpy(shapes))
    got = tm.predict(*t_args, torch.from_numpy(sf))
    plain = tm.predict(*t_args)
    assert got["rboxes"].shape[-1] == (8 if which == "pointobb" else 5)
    assert int(ref["valid"].sum()) > 0
    limits = dict(LIMITS)
    clear = None
    if which == "pointobb":     # 8 corners: held as boxes, all / sf
        for d in (got, ref):
            d["boxes"] = torch.cat([d["boxes"], d.pop("rboxes")], -1)
        del limits["rboxes"], limits["rboxes_rel"], limits["theta"]
        limits["boxes"] = 0.1
        np.testing.assert_allclose(
            (got["boxes"][..., 4:] * torch.from_numpy(sf)[:, None, None]),
            plain["rboxes"], rtol=1e-6, atol=1e-3)
    else:
        np.testing.assert_array_equal(got["rboxes"][..., 4],
                                      plain["rboxes"][..., 4])
        if which == "refined":
            clear = chip_smoke.rbox_clear_of_ties(
                chip_smoke.first_stage_quads(tm, *t_args))
            # the clear mask indexes the port's detections: hold the
            # reference to the port
            got, ref = ref, got
    errs = chip_smoke.match_detections(got, ref, limits, rbox_clear=clear)
    assert errs["unpaired"] == 0 and errs["at_cut"] == 0, errs


def test_inference_detector_matches_reference_on_600x800(flagship):
    """A 600x800 image is resized to 192x256 (scale 0.32) by each
    package's own pipeline, to the same bytes; the results come back in
    the image's frame (boxes reach past the 256-px input)."""
    jm, v, tm = flagship
    blocks = np.random.RandomState(3).randint(0, 256, (24, 32, 3))
    img = np.kron(blocks, np.ones((25, 25, 1))).astype(np.uint8)
    np.testing.assert_array_equal(pipeline.resize_keep_ratio(img, IMG)[0],
                                  ref_pipeline.resize_keep_ratio(img, IMG)[0])
    ref, ref_out = ref_inference_detector(jm, v, img, num_classes=15)
    got, out = inference_detector(tm, img, num_classes=15)
    assert len(got) == len(ref) == 15
    assert out.keys() == {k for k in ref_out}
    assert int(out["valid"].sum()) == int(np.asarray(ref_out["valid"]).sum())
    assert max(r[:, 2].max() for r in got if len(r)) > IMG
    for c, (g, r) in enumerate(zip(got, ref)):
        assert g.shape == r.shape, c
        free = list(range(len(r)))
        for row in g:
            d = [(np.abs(row[:4] - r[j, :4]).max(), abs(row[4] - r[j, 4]), j)
                 for j in free]
            best = min(d) if d else None
            assert best is not None and best[0] <= 5e-2 and best[1] <= 1e-4, \
                (c, row, best)
            free.remove(best[2])


def test_async_inferencer_equals_inference_detector(flagship):
    _, _, tm = flagship
    imgs = [_image(IMG, IMG, seed=s) for s in range(3)] + [_image(600, 800)]
    want = [inference_detector(tm, img)[1] for img in imgs]
    inf = AsyncInferencer(tm, depth=2)
    drained = []
    for i, img in enumerate(imgs):
        out = inf.submit(img, tag=i)
        assert (out is None) == (i < 2)
        if out is not None:
            drained.append(out)
    drained += inf.drain_all()
    assert inf.drain_one() is None
    assert [t for t, _ in drained] == [0, 1, 2, 3]
    for (_, got), ref in zip(drained, want):
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k])
    tag, out = asyncio.run(async_inference_detector(tm, imgs[0]))
    for k in want[0]:
        np.testing.assert_array_equal(out[k], want[0][k])


def test_init_detector_from_config_and_checkpoint(tmp_path):
    path = "configs/dota_theta_obb_r50_fpn_1x.py"
    model, cfg = init_detector(path, device="cpu", seed=3)
    assert cfg.model.type == "RBBoxRCNN"
    assert tuple(model.backbone.stem_conv.weight.shape) == (64, 3, 7, 7)
    assert model.img_size == 1024 and model.dtype == torch.float32
    ckpt = tmp_path / "model.pth"
    torch.save(model.state_dict(), ckpt)
    again, _ = init_detector(path, checkpoint=str(ckpt), device="cpu",
                             seed=4)
    for k, t in model.state_dict().items():
        assert torch.equal(t, again.state_dict()[k]), k
    other, _ = init_detector(path, device="cpu", seed=4)
    assert not torch.equal(other.backbone.stem_conv.weight,
                           model.backbone.stem_conv.weight)
    orbax = tmp_path / "orbax"
    orbax.mkdir()
    with pytest.raises(NotImplementedError, match="orbax"):
        init_detector(path, checkpoint=str(orbax), device="cpu")
    assert os.listdir(orbax) == []
