"""ResNet's deformable stages in the PyTorch port against the JAX
reference on the CPU: the `DeformConv2d` layer (DCNv1, and DCNv2's
sigmoid modulation) with a seeded offset conv, a ResNet-50 with
deformable C3-C5, and the small FasterRCNN whole (predict and one loss)
with a dcn stage and with an mdconv one; the weight bridge on the
slice's configs; and every config of the single-stage types this slice
ports, built on the meta device, with the whole sweep's count.

The reference's offset conv starts at zero, where the layer is a plain
conv: here every kernel is seeded N(0, 1 / fan_in) (`shaped_variables`),
so that the taps sample off the grid.  The detectors are
tests/torch_port_pairs.py's small FasterRCNN (`hbb_cfg`: a 64-channel
FPN, 128^2 images, every candidate kept) on a ResNet-50 with the
deformable 3x3 in its last ``stage_with_dcn`` stages.

Bounds, float32: the layer within 1e-5 of its largest magnitude, the
backbone's maps within 1e-4; detections paired (valid and labels equal,
boxes within 1e-2 px, scores within 2e-4, in any order: the DCNv2
FasterRCNN's worst score differed by 1.07e-4, its box by 3.4e-3 px,
after the random ResNet-50's sampled maps); each loss within 1e-4
relative.  The gpu-marked case runs chip_smoke's dcn
reference phase (the card against the CPU).
"""

import glob
import os

import numpy as np
import pytest
import torch

from aidet_tpu_torch.models.builder import build
from aidet_tpu_torch.models.registry import DETECTORS
from aidet_tpu_torch.ops.deform_conv import DeformConv2d
from aidet_tpu_torch.utils.config import Config
from torch_port_helpers import to_np
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

try:
    import jax
    import jax.numpy as jnp

    # registers the reference's NASFPN (its necks/__init__ does not)
    import aidet_tpu.models.necks.nas_fpn  # noqa: F401
    from aidet_tpu.models.backbones.resnet import ResNet as JResNet
    from aidet_tpu.ops.deform_conv import DeformConv2d as JDeformConv2d
    from aidet_tpu_torch.models.backbones.resnet import ResNet
    from torch_port_helpers import load_flax
    from torch_port_pairs import (assert_bridge_loads, assert_losses_close,
                                  assert_matched, hbb_batch, hbb_cfg,
                                  port_loss, port_predict, ref_loss,
                                  ref_predict, seeded_variables, shaped_pair,
                                  shaped_variables)
except ImportError:     # the card's machine: the gpu case runs alone
    jax = None
needs_reference = pytest.mark.skipif(jax is None,
                                     reason="needs the JAX reference")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = torch.from_numpy


def assert_close(got, ref, rel=1e-5):
    got, ref = to_np(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert np.abs(got - ref).max() <= rel * max(np.abs(ref).max(), 1e-12)


@needs_reference
@pytest.mark.parametrize("modulated", [False, True])
@pytest.mark.parametrize("stride", [1, 2])
def test_deform_conv_layer_matches_the_reference(modulated, stride):
    """The layer on a 13x11 map, offsets of a few cells from the seeded
    offset conv (its bias N(0, 0.1))."""
    x = np.random.RandomState(1).randn(2, 13, 11, 8).astype(np.float32)
    jm = JDeformConv2d(features=12, stride=stride, modulated=modulated)
    v = seeded_variables(jm, jnp.asarray(x))
    v["params"]["conv_offset"]["kernel"] *= 6.0
    tm = DeformConv2d(8, 12, 3, stride, 1, modulated=modulated)
    sd = {"weight": T(v["params"]["kernel"].transpose(3, 2, 0, 1).copy()),
          "bias": T(v["params"]["bias"]),
          "conv_offset.weight": T(v["params"]["conv_offset"]["kernel"]
                                  .transpose(3, 2, 0, 1).copy()),
          "conv_offset.bias": T(v["params"]["conv_offset"]["bias"])}
    tm.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = tm(T(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert_close(got, jm.apply(v, jnp.asarray(x)))


@needs_reference
def test_resnet_with_deformable_stages_matches_the_reference():
    """ResNet-50 with DCNv2 in C3-C5 at 64^2, seeded offsets."""
    kw = dict(depth=50, dcn=dict(modulated=True),
              stage_with_dcn=(False, True, True, True))
    jm = JResNet(**kw)
    x = np.random.RandomState(2).randn(2, 64, 64, 3).astype(np.float32)
    v = shaped_variables(jm, img=64)
    tm = load_flax(ResNet(depth=50, dcn=dict(modulated=True),
                          stage_with_dcn=(False, True, True, True)), v,
                   "_backbone")
    ref = jax.jit(jm.apply)(v, jnp.asarray(x))
    with torch.no_grad():
        got = tm(T(x))
    for g, r in zip(got, ref):
        assert_close(g, r, 1e-4)


def dcn_cfg(modulated, stages):
    return hbb_cfg(backbone=dict(type="ResNet", depth=50,
                                 dcn=dict(modulated=modulated),
                                 stage_with_dcn=stages),
                   neck=dict(type="FPN", in_channels=(256, 512, 1024, 2048),
                             out_channels=64, num_outs=5))


@needs_reference
@pytest.mark.parametrize("modulated,stages", [
    (False, (False, False, False, True)), (True, (False, False, True, False))])
def test_faster_rcnn_with_dcn_matches_the_reference(modulated, stages):
    jm, v, tm = shaped_pair(dcn_cfg(modulated, stages))
    batch = hbb_batch()
    assert_matched(port_predict(tm, batch), ref_predict(jm, v, batch),
                   dict(boxes=1e-2, scores=2e-4))
    assert_losses_close(port_loss(tm, batch), ref_loss(jm, v, batch), 1e-4)


@needs_reference
@pytest.mark.parametrize("config", ["reppoints_moment_r50_fpn_1x",
                                    "mask_rcnn_mdconv_c3-c5_r50_fpn_1x",
                                    "retinanet_nasfpn_r50_1x",
                                    "fcos_r50_fpn_1x"])
def test_config_weights_load_through_the_bridge(config):
    """The reference's variables of the config (their shapes from a
    trace, seeded values) load strictly into the port's build of it,
    every leaf mapped: each DeformConv2d's conv_offset, kernel and bias,
    RepPoints' deformable kernels and moment_transfer, SepBN's per-level
    norms, NAS-FPN's cells, FCOS's per-level scales."""
    tm, sd = assert_bridge_loads(f"configs/{config}.py")
    if "mdconv" in config:
        off = sd["backbone.layer2_block0.conv2.conv_offset.weight"]
        assert off.shape == (27, 128, 3, 3)
    if "reppoints" in config:
        assert sd["moment_transfer"].shape == (2,)
        assert sd["bbox_head.cls_dconv.weight"].shape == (256, 256, 3, 3)
    if "nasfpn" in config:
        assert "bbox_head.cls_bn_l4_3.weight" in sd
        assert "neck.s6_gp75.conv.weight" in sd
    if "fcos" in config:
        assert sd["bbox_head.scale4"].shape == ()


# the single-stage detector types this slice ports; the configs of them
# that still raise, with what stops them (both the reference's own
# failures: its ResNeXt has no dcn field, and SSD512's maps do not fit
# SSD300's anchors)
TYPES = ("RepPointsDetector", "SSD", "FCOS", "GARetinaNet",
         "FreeAnchorRetinaNet", "ATSS", "FOVEA")
STILL_RAISE = {
    "reppoints_moment_x101_dcn_fpn_2x.py": "ResNeXt.*'dcn'",
    "reppoints_moment_x101_dcn_fpn_2x_mt.py": "ResNeXt.*'dcn'",
    "ssd512_coco.py": "24656 anchors.*8732",
    "ssd512_voc.py": "24656 anchors.*8732",
}
SLICE_CONFIGS = sorted(
    os.path.basename(p) for p in glob.glob(os.path.join(REPO, "configs",
                                                        "*.py"))
    if Config.fromfile(p).get("model", {}).get("type") in TYPES)


def build_config(name):
    cfg = Config.fromfile(os.path.join(REPO, "configs", name))
    with torch.device("meta"):
        return build(dict(cfg.model), DETECTORS, dict(
            train_cfg=cfg.get("train_cfg"), test_cfg=cfg.get("test_cfg")))


@pytest.mark.parametrize("name", SLICE_CONFIGS)
def test_every_single_stage_config_builds(name):
    if name in STILL_RAISE:
        with pytest.raises((TypeError, ValueError), match=STILL_RAISE[name]):
            build_config(name)
        return
    assert sum(p.numel() for p in build_config(name).parameters()) > 0


# what stops each config of the repo that the port does not build: the
# reference's own failures (HTC's FCNMaskHead under the mask
# information flow, ResNeXt's dcn and conv_cfg, SSD512), none of them
# "not ported"
SWEEP_RAISES = {"mask information flow": 7, "ResNeXt got an unexpected": 3,
                "24656 anchors": 2}


def test_the_config_sweep_builds_all_but_the_named():
    """Every config of the repo on the meta device: 191 of 203 build, and
    each of the other 12 raises for one of `SWEEP_RAISES`' reasons."""
    built, reasons = 0, dict.fromkeys(SWEEP_RAISES, 0)
    paths = sorted(glob.glob(os.path.join(REPO, "configs", "*.py")))
    for p in paths:
        try:
            build_config(os.path.basename(p))
            built += 1
        except (KeyError, NotImplementedError, TypeError, ValueError) as e:
            hit = [r for r in SWEEP_RAISES if r in str(e)]
            assert len(hit) == 1 and "not ported" not in str(e), (p, e)
            reasons[hit[0]] += 1
    assert (len(paths), built) == (203, 191)
    assert reasons == SWEEP_RAISES


@pytest.mark.gpu
def test_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the chip with "
                    "python -m pytest -m gpu tests/test_torch_port_dcn.py")
    import chip_smoke
    out = chip_smoke.run_hbb_reference(kind="dcn")
    assert out["max_abs_err"]["unpaired"] == 0 and out["n_valid"] > 0
