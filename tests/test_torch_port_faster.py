"""The HBB two-stage family of the PyTorch port against the JAX
reference on the CPU: FasterRCNN (predict and loss), FastRCNN's
`predict_from_proposals`, the proposal-only RPN (predict and loss),
the ResNeXt backbone and the GN conv box head, and every config of
the five new detector types built on the meta device.

`test_every_config_of_the_slice_builds` takes in the two-stage types of
the later slices too (MaskRCNN, MaskScoringRCNN, GAFasterRCNN,
GridRCNN, DoubleHeadRCNN) and RetinaNet's (libra_retinanet).

The models are tests/torch_port_pairs.py's small architecture
(ResNet-18, a 64-channel FPN, 128^2 images, 16 classes; the ResNeXt
a depth-50 one with groups 4) with the reference's seeded variables
carried over by the weight bridge; the reference runs its XLA
RoIAlign, the port its plain version.  The train_cfg keeps every
candidate (`HBB_TRAIN_CFG`), so both sides sample the same anchors
and rois.

Bounds, float32: detections' valid and labels equal, boxes within 1e-2 px,
scores within 1e-4 (the MaskOBB pair's); the RPN's proposals within 1e-2 px and
their scores within 1e-5; losses within 1e-4 relative; the ResNeXt's maps and
the conv head's outputs within 1e-5 of their largest magnitude.  The gpu-marked
case runs chip_smoke's hbb_reference phase for FasterRCNN, RPN -> FastRCNN and
the ResNeXt FasterRCNN (the card against the CPU).
"""

import glob
import os

import numpy as np
import pytest
import torch

from aidet_tpu_torch.models.builder import build
from aidet_tpu_torch.models.registry import DETECTORS
from aidet_tpu_torch.utils.config import Config
from torch_port_helpers import to_np
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

try:
    import functools

    import jax
    import jax.numpy as jnp

    from aidet_tpu.models.backbones.resnext import ResNeXt as JResNeXt
    from aidet_tpu.models.backbones.resnext import \
        XBottleneck as JXBottleneck
    from aidet_tpu.models.heads.bbox_head import \
        SharedFCBBoxHead as JSharedFCBBoxHead
    from aidet_tpu_torch.models.backbones.resnext import (ResNeXt,
                                                          XBottleneck)
    from aidet_tpu_torch.models.heads.bbox_head import SharedFCBBoxHead
    from torch_port_helpers import load_flax
    from torch_port_pairs import (GN, assert_losses_close, hbb_batch, hbb_cfg,
                                  perturb_all_norms, port_loss, port_predict,
                                  ref_loss, ref_predict, shaped_pair,
                                  shaped_variables)
except ImportError:     # the card's machine: the gpu case runs alone
    jax = None
needs_reference = pytest.mark.skipif(jax is None,
                                     reason="needs the JAX reference")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = torch.from_numpy
DET_LIMITS = dict(boxes=1e-2, scores=1e-4)


def assert_detections_match(got, ref):
    assert got["valid"].sum() > 0
    np.testing.assert_array_equal(got["valid"], ref["valid"])
    np.testing.assert_array_equal(got["labels"], ref["labels"])
    for k, lim in DET_LIMITS.items():
        assert np.abs(got[k] - ref[k]).max() <= lim, k


@pytest.fixture(scope="module")
def faster():
    """The small FasterRCNN pair and a seeded batch."""
    jm, v, tm = shaped_pair(hbb_cfg())
    return jm, v, tm, hbb_batch()


@needs_reference
def test_faster_rcnn_predict_matches_the_reference(faster):
    jm, v, tm, batch = faster
    got, ref = port_predict(tm, batch), ref_predict(jm, v, batch)
    assert set(got) == set(ref) == {"boxes", "scores", "labels", "valid"}
    assert_detections_match(got, ref)


@needs_reference
def test_faster_rcnn_loss_matches_the_reference(faster):
    jm, v, tm, batch = faster
    assert_losses_close(port_loss(tm, batch), ref_loss(jm, v, batch), 1e-4)


def seeded_proposals(seed=3, p=48):
    """Proposals [2, p, 4] inside the image, the last 8 of each image
    invalid."""
    rs = np.random.RandomState(seed)
    xy = rs.uniform(0, 100, (2, p, 2))
    boxes = np.concatenate([xy, xy + rs.uniform(6, 60, (2, p, 2))], -1)
    valid = np.arange(p)[None].repeat(2, 0) < p - 8
    return np.minimum(boxes, 127).astype(np.float32), valid


@needs_reference
def test_fast_rcnn_predict_from_proposals_matches_the_reference(faster):
    jm, v, tm, batch = faster
    props, valid = seeded_proposals()
    ref = jax.jit(functools.partial(jm.apply,
                                    method="predict_from_proposals"))(
        v, jnp.asarray(batch["imgs"]), jnp.asarray(props),
        jnp.asarray(valid), jnp.asarray(batch["img_shapes"]))
    got = tm.predict_from_proposals(
        T(batch["imgs"]), T(props), T(valid), T(batch["img_shapes"]))
    assert_detections_match({k: to_np(x) for k, x in got.items()},
                            {k: np.asarray(x) for k, x in ref.items()})


@pytest.fixture(scope="module")
def rpn():
    """The small RPN pair (the FasterRCNN's backbone, neck and RPN
    head's variables) and a seeded batch without labels."""
    jm, v, tm = shaped_pair(hbb_cfg("RPN"))
    batch = hbb_batch()
    del batch["gt_labels"]
    return jm, v, tm, batch


@needs_reference
def test_rpn_predict_and_loss_match_the_reference(rpn):
    jm, v, tm, batch = rpn
    got, ref = port_predict(tm, batch), ref_predict(jm, v, batch)
    assert set(got) == set(ref) == {"boxes", "scores", "valid"}
    assert got["valid"].sum() > 0
    np.testing.assert_array_equal(got["valid"], ref["valid"])
    assert np.abs(got["boxes"] - ref["boxes"]).max() <= 1e-2
    assert np.abs(got["scores"] - ref["scores"]).max() <= 1e-5
    assert_losses_close(port_loss(tm, batch), ref_loss(jm, v, batch), 1e-4)
    assert set(port_loss(tm, batch)) == {"loss_rpn_cls", "loss_rpn_bbox"}


def run_backbone(jm, tm, x, v=None):
    """The reference module ``jm`` (its variables ``v``, else its init
    with seeded norms) and the port's ``tm`` (NHWC, or an NCHW block)
    on the same input x: (port outputs, reference's)."""
    if v is None:
        v = perturb_all_norms(jax.jit(jm.init)(jax.random.PRNGKey(0),
                                               jnp.asarray(x)), 1)
    ref = jax.jit(jm.apply)(v, jnp.asarray(x))
    load_flax(tm, v, "_backbone")
    with torch.no_grad():
        if isinstance(tm, XBottleneck):
            got = (tm(T(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1),)
        else:
            got = tm(T(x))
    ref = ref if isinstance(ref, tuple) else (ref,)
    return [to_np(g) for g in got], [np.asarray(r) for r in ref]


@needs_reference
def test_resnext_matches_the_reference():
    """The depth-50 ResNeXt with groups 4 at 64^2 (pytorch style, its
    variables from `shaped_variables`: no compile of its init)."""
    jm = JResNeXt(depth=50, groups=4, base_width=4)
    x = np.random.RandomState(0).randn(2, 64, 64, 3).astype(np.float32)
    tm = ResNeXt(50, groups=4, base_width=4)
    got, ref = run_backbone(jm, tm, x, shaped_variables(jm))
    assert len(got) == len(ref) == 4
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        assert np.abs(g - r).max() <= 1e-5 * np.abs(r).max()
    assert tm.layer2_block0.conv2.groups == 4
    assert tm.layer2_block0.conv2.in_channels == 8 * 4


@needs_reference
@pytest.mark.parametrize("style", ["pytorch", "caffe"])
def test_resnext_block_matches_the_reference(style):
    """One strided `XBottleneck` with its projection: the caffe style
    strides its first 1x1, the pytorch style its grouped 3x3."""
    jm = JXBottleneck(planes=16, stride=2, downsample=True, groups=4,
                      style=style)
    x = np.random.RandomState(2).randn(2, 16, 16, 32).astype(np.float32)
    tm = XBottleneck(32, 16, 2, True, groups=4, style=style)
    got, ref = run_backbone(jm, tm, x)
    assert got[0].shape == ref[0].shape == (2, 8, 8, 64)
    assert np.abs(got[0] - ref[0]).max() <= 1e-5 * np.abs(ref[0]).max()
    assert tm.conv1.stride == ((2, 2) if style == "caffe" else (1, 1))


@needs_reference
@pytest.mark.parametrize("agnostic", [False, True])
def test_gn_conv_bbox_head_matches_the_reference(agnostic):
    """The 4conv1fc GN head (configs/*_gn_*: ConvFCBBoxHead) and the
    cascade's class-agnostic regression."""
    kw = dict(num_classes=16, in_channels=32, fc_out_channels=64, num_fcs=1,
              num_shared_convs=2, conv_out_channels=32, norm_cfg=GN,
              reg_class_agnostic=agnostic)
    jm = JSharedFCBBoxHead(**kw)
    x = np.random.RandomState(1).randn(6, 7, 7, 32).astype(np.float32)
    v = perturb_all_norms(jax.jit(jm.init)(jax.random.PRNGKey(0),
                                           jnp.asarray(x)), 2)
    ref = jax.jit(jm.apply)(v, jnp.asarray(x))
    tm = load_flax(SharedFCBBoxHead(**kw), v, "_bbox_head")
    with torch.no_grad():
        got = tm(T(x))
    assert got[1].shape[-1] == (4 if agnostic else 64)
    for g, r in zip(got, ref):
        r = np.asarray(r)
        assert np.abs(to_np(g) - r).max() <= 1e-5 * np.abs(r).max()


# the configs of the two-stage detector types (and RetinaNet's, for
# libra_retinanet); those that still raise are listed with what stops
# them: the reference's own failures
TYPES = ("FasterRCNN", "FastRCNN", "RPN", "CascadeRCNN", "HTC", "MaskRCNN",
         "MaskScoringRCNN", "GAFasterRCNN", "GridRCNN", "DoubleHeadRCNN",
         "RetinaNet")
STILL_RAISE = {
    # an FCNMaskHead under HTC's mask information flow: the reference
    # raises too (its FCNMaskHead takes no previous-stage feature)
    "htc_dconv_c3-c5_mstrain_400_1400_x101_64x4d_fpn_20e.py": "FCNMaskHead",
    "htc_r101_fpn_20e.py": "FCNMaskHead",
    "htc_r50_fpn_1x.py": "FCNMaskHead",
    "htc_r50_fpn_20e.py": "FCNMaskHead",
    "htc_without_semantic_r50_fpn_1x.py": "FCNMaskHead",
    "htc_x101_32x4d_fpn_20e.py": "FCNMaskHead",
    "htc_x101_64x4d_fpn_20e.py": "FCNMaskHead",
    # the reference's ResNeXt has no conv_cfg (nor norm_cfg) field
    "mask_rcnn_x101_32x4d_fpn_gn_ws_2x.py": "unexpected keyword argument",
}
SLICE_CONFIGS = sorted(
    os.path.basename(p) for p in glob.glob(os.path.join(REPO, "configs",
                                                        "*.py"))
    if Config.fromfile(p).get("model", {}).get("type") in TYPES)


@pytest.mark.parametrize("name", SLICE_CONFIGS)
def test_every_config_of_the_slice_builds(name):
    cfg = Config.fromfile(os.path.join(REPO, "configs", name))
    args = dict(train_cfg=cfg.get("train_cfg"), test_cfg=cfg.get("test_cfg"))
    if name in STILL_RAISE:
        with pytest.raises((KeyError, NotImplementedError, TypeError),
                           match=STILL_RAISE[name]):
            with torch.device("meta"):
                build(dict(cfg.model), DETECTORS, args)
        return
    with torch.device("meta"):
        model = build(dict(cfg.model), DETECTORS, args)
    assert sum(p.numel() for p in model.parameters()) > 0


@pytest.mark.gpu
def test_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the chip with "
                    "python -m pytest -m gpu tests/test_torch_port_faster.py")
    import chip_smoke
    for kind in ("faster", "fast", "resnext"):
        out = chip_smoke.run_hbb_reference(kind=kind)
        assert out["max_abs_err"]["unpaired"] == 0 and out["n_valid"] > 0
