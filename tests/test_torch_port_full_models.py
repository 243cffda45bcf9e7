"""The full-width models end to end in float32 on the CPU, reference
against port, and the space-to-depth stem relayout that lets a
config's 7x7 stem weights load into the serving build.

- The stem relayout (`aidet_tpu_torch.convert.stem_s2d_weights`) equals
  the reference's HWIO one, transposed, bit for bit, and a 7x7/2 stem
  convolution equals the s2d stem convolution over the relaid kernel to
  1e-12 in float64 (exact but for summation order) and 1e-5 in float32.
- The RBBoxRCNNRRoI of `configs/dota_rroi_point_obb_r50_fpn_1x.py`
  (ResNet-50, 7x7 stem), built from the config file by both packages at
  256^2, its seeded variables carried over by the weight bridge with
  the relayout and loaded with strict=True into the port's serving
  build `build_rroi(small=False)` (s2d stem) in float32; predict on 2
  seeded uint8 images.  Bar: equal valid, every detection paired (as
  chip_smoke.py's `match_detections`) with one of the same image and
  label, boxes within 0.05 px and scores within 5e-4 (the worst seen:
  0.016 px and 1.78e-4), refined rboxes within 0.05 px plus 5e-3 of
  their largest coordinate (random weights decode boxes thousands of
  pixels wide; the worst seen, 1.28 px, is within 1e-3 of its size)
  and theta within 2e-2 (seen 4.5e-3), compared where the reference's
  first-stage quad is clear of a tie (`chip_smoke.rbox_clear_of_ties`).
  The config as written, built by the port's `build_detector` (7x7
  stem), loads the same weights unrelaid and predicts the same
  detections as the serving build, within the same limits (rboxes
  where the serving build's first-stage quad is clear of a tie).
- The full flagship (`__graft_entry__._build_flagship`, s2d stem, every
  dtype float32, the XLA RoIAlign) against `build_flagship(small=False,
  dtype=float32)`, 256^2, 2 images.  Bar: equal valid, every detection
  paired, boxes within 0.25 px, scores within 2e-4, rboxes within
  0.25 px plus 1e-3 of their largest coordinate, theta within 1e-2
  (the worst seen: 0.026 px, 7.3e-5, 1.75 px on a box thousands of
  pixels wide, 8.9e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from __graft_entry__ import _build_flagship
from aidet_tpu.models import build_detector as ref_build_detector
from aidet_tpu.models.backbones.resnet import \
    stem_s2d_weights as ref_stem_s2d_weights
from aidet_tpu.utils.config import Config as RefConfig

import chip_smoke
from aidet_tpu_torch.convert import flax_to_state_dict, stem_s2d_weights
from aidet_tpu_torch.flagship import build_flagship
from aidet_tpu_torch.models.builder import build_detector
from aidet_tpu_torch.rroi import build_rroi
from aidet_tpu_torch.utils.config import Config
from torch_port_helpers import perturb_norms

IMG = 256
RROI_CONFIG = "configs/dota_rroi_point_obb_r50_fpn_1x.py"
RROI_LIMITS = dict(boxes=0.05, scores=5e-4, rboxes=0.05, rboxes_rel=5e-3,
                   theta=2e-2)
FLAGSHIP_LIMITS = dict(boxes=0.25, scores=2e-4, rboxes=0.25,
                       rboxes_rel=1e-3, theta=1e-2)


def _inputs():
    imgs = np.random.RandomState(0).randint(0, 256, (2, IMG, IMG, 3),
                                            np.uint8)
    shapes = np.asarray([[IMG, IMG], [IMG, 200]], np.float32)
    return imgs, shapes


def _ref_predict(model, variables, imgs, shapes):
    out = jax.jit(lambda v, i, s: model.apply(v, i, s, method="predict"))(
        variables, jnp.asarray(imgs), jnp.asarray(shapes))
    return {k: torch.from_numpy(np.array(x)) for k, x in out.items()}


def test_stem_relayout_is_the_reference_one():
    w7 = np.random.RandomState(0).randn(64, 3, 7, 7).astype(np.float32)
    ref = ref_stem_s2d_weights(w7.transpose(2, 3, 1, 0))     # HWIO
    np.testing.assert_array_equal(stem_s2d_weights(w7),
                                  ref.transpose(3, 2, 0, 1))


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
def test_stem_relayout_is_exact_on_one_convolution(dtype, tol):
    """conv 7x7/2 (padding 3) of x equals the s2d stem: 2x2 pixel
    unshuffle in (row, col, channel) order, pad (2, 1), conv 4x4/1 over
    the relaid kernel, as `ResNet(stem_space_to_depth=True)` runs it."""
    rs = np.random.RandomState(1)
    w7 = torch.from_numpy(rs.randn(64, 3, 7, 7)).to(dtype)
    x = torch.from_numpy(rs.randn(2, 3, 40, 56)).to(dtype)
    want = F.conv2d(x, w7, stride=2, padding=3)
    b, c, h, w = x.shape
    s2d = x.permute(0, 2, 3, 1).reshape(b, h // 2, 2, w // 2, 2, c)
    s2d = s2d.permute(0, 1, 3, 2, 4, 5).reshape(b, h // 2, w // 2, 4 * c)
    w4 = torch.from_numpy(stem_s2d_weights(w7.numpy()))
    got = F.conv2d(F.pad(s2d.permute(0, 3, 1, 2), (2, 1, 2, 1)), w4)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) < tol * float(want.abs().max())


@pytest.fixture(scope="module")
def rroi():
    """The config's reference model and variables at 256^2, its
    first-stage reference (the same variables without the refinement
    head), and the port's serving build."""
    cfg = RefConfig.fromfile(RROI_CONFIG)
    model_cfg = dict(cfg.model, img_size=IMG)
    jm = ref_build_detector(model_cfg, train_cfg=cfg.get("train_cfg"),
                            test_cfg=cfg.get("test_cfg"))
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)))
    v = perturb_norms(v, 0)
    first_cfg = {k: x for k, x in model_cfg.items()
                 if k != "rbbox_refine_head"}
    j1 = ref_build_detector(dict(first_cfg, type="RBBoxRCNN"),
                            test_cfg=cfg.get("test_cfg"))
    v1 = {col: {k: t for k, t in tree.items() if k != "_rbbox_refine_head"}
          for col, tree in v.items()}
    tm = build_rroi(IMG, small=False, dtype=torch.float32, device="cpu")
    return jm, v, j1, v1, tm


def test_rroi_config_weights_load_into_build_rroi(rroi):
    """The config's 7x7 stem kernel is relaid for build_rroi's s2d stem,
    and every leaf loads with strict=True."""
    _, v, _, _, tm = rroi
    sd, unmapped = flax_to_state_dict(v, tm)
    assert unmapped == []
    assert tuple(sd["backbone.stem_conv.weight"].shape) == (64, 12, 4, 4)
    tm.load_state_dict(sd, strict=True)


@pytest.fixture(scope="module")
def rroi_outputs(rroi):
    jm, v, j1, v1, tm = rroi
    tm.load_state_dict(flax_to_state_dict(v, tm)[0], strict=True)
    imgs, shapes = _inputs()
    ref = _ref_predict(jm, v, imgs, shapes)
    quads = _ref_predict(j1, v1, imgs, shapes)["rboxes"]
    got = tm.predict(torch.from_numpy(imgs), torch.from_numpy(shapes))
    got_clear = chip_smoke.rbox_clear_of_ties(chip_smoke.first_stage_quads(
        tm, torch.from_numpy(imgs), torch.from_numpy(shapes)))
    return ref, got, chip_smoke.rbox_clear_of_ties(quads), got_clear


def test_rroi_config_predict_matches_reference(rroi_outputs):
    ref, got, clear, _ = rroi_outputs
    n_valid = int(ref["valid"].sum())
    assert n_valid > 0
    assert int((clear & ref["valid"]).sum()) >= n_valid / 2
    errs = chip_smoke.match_detections(got, ref, RROI_LIMITS,
                                       rbox_clear=clear)
    assert errs["unpaired"] == 0 and errs["at_cut"] == 0, errs


def test_rroi_config_as_written_predicts_the_same(rroi, rroi_outputs):
    """The port's build_detector builds the config's 7x7 stem: the
    weights load unrelaid, and it predicts what the s2d build does
    (float32: the same function summed in another order)."""
    _, v, _, _, _ = rroi
    _, got, _, clear = rroi_outputs
    cfg = Config.fromfile(RROI_CONFIG)
    plain = build_detector(dict(cfg.model, img_size=IMG),
                           train_cfg=cfg.get("train_cfg"),
                           test_cfg=cfg.get("test_cfg"), device="cpu")
    assert not plain.backbone.stem_space_to_depth
    sd, unmapped = flax_to_state_dict(v, plain)
    assert unmapped == []
    assert tuple(sd["backbone.stem_conv.weight"].shape) == (64, 3, 7, 7)
    plain.load_state_dict(sd, strict=True)
    imgs, shapes = _inputs()
    out = plain.predict(torch.from_numpy(imgs), torch.from_numpy(shapes))
    errs = chip_smoke.match_detections(out, got, RROI_LIMITS,
                                       rbox_clear=clear)
    assert errs["unpaired"] == 0 and errs["at_cut"] == 0, errs


def _full_flagship_f32():
    """The reference's full flagship with every dtype float32 and the
    XLA RoIAlign (the CPU's)."""
    m = _build_flagship(IMG)

    def f32(c):
        return dict(c, dtype=jnp.float32)
    return m.clone(backbone=f32(m.backbone), neck=f32(m.neck),
                   rpn_head=f32(m.rpn_head), bbox_head=f32(m.bbox_head),
                   rbbox_head=f32(m.rbbox_head), roi_align_impl="xla")


def test_full_flagship_predict_matches_reference():
    jm = _full_flagship_f32()
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)))
    v = perturb_norms(v, 0)
    tm = build_flagship(IMG, small=False, dtype=torch.float32, device="cpu")
    sd, unmapped = flax_to_state_dict(v, tm)
    assert unmapped == []
    tm.load_state_dict(sd, strict=True)
    imgs, shapes = _inputs()
    ref = _ref_predict(jm, v, imgs, shapes)
    got = tm.predict(torch.from_numpy(imgs), torch.from_numpy(shapes))
    assert int(ref["valid"].sum()) > 0
    errs = chip_smoke.match_detections(got, ref, FLAGSHIP_LIMITS)
    assert errs["unpaired"] == 0 and errs["at_cut"] == 0, errs
