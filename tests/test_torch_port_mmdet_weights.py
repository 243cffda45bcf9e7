"""The port's loader of mmdet-named torch checkpoints
(`aidet_tpu_torch.convert.mmdet_to_state_dict`, through `init_detector`
on a ``.pth`` file) against the reference's converter
(`tools/torch2jax.py::convert_detector`) on the CPU.

One seeded, mmdet-named state_dict of a small Faster R-CNN (ResNet-18 with
torchvision's names and seeded BatchNorm statistics, a 256-channel FPN, as the
reference's converter assumes of the box head's input, a 64-channel RPN head, a
2-FC box head of 16 classes, 128^2) is loaded into the port by
`mmdet_to_state_dict` and into the reference by `convert_detector`, whose
variables the weight bridge carries over: the two state_dicts are equal tensor
for tensor; the stray key comes back unmapped from both, the BatchNorm step
counters from neither.  On a seeded uint8 image pair the port (loaded by
`init_detector` from the ``.pth`` file) gives the reference's detections: valid
and labels equal, boxes within 2e-2 px and scores within 1e-3 (seen: 1.03e-2
and 2.0e-4: the 256-channel FPN's and the 12544-wide first FC's float32 sums in
another order).  The 7x7 stem is relaid for a space-to-depth stem as the
reference's converter relays it.  The gpu-marked case runs chip_smoke's
hbb_reference phase for the FasterRCNN, whose weights load through
`mmdet_to_state_dict`.
"""

import os
import sys

import numpy as np
import pytest
import torch

from aidet_tpu_torch.apis.inference import init_detector
from aidet_tpu_torch.convert import (flax_to_state_dict, mmdet_to_state_dict,
                                     stem_s2d_weights)
from aidet_tpu_torch.utils.config import Config
from torch_port_helpers import to_np
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

try:
    import jax.numpy as jnp

    from aidet_tpu.models import build_detector as j_build
    from test_models_forward import _small_cfg
    from torch_port_pairs import hbb_batch, ref_predict

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "tools"))
    from torch2jax import convert_detector, convert_resnet
except ImportError:     # the card's machine: the gpu case runs alone
    jnp = None
needs_reference = pytest.mark.skipif(jnp is None,
                                     reason="needs the JAX reference")
STRAY = "roi_head.stray.weight"


def model_cfg():
    cfg = _small_cfg(
        neck=dict(type="FPN", in_channels=(64, 128, 256, 512),
                  out_channels=256, num_outs=5),
        rpn_head=dict(type="RPNHead", in_channels=256, feat_channels=64,
                      num_anchors=3),
        bbox_head=dict(type="SharedFCBBoxHead", num_classes=16,
                       in_channels=256, fc_out_channels=128))
    return dict(type="FasterRCNN", **cfg)


def mmdet_state_dict(seed=0):
    """The small Faster R-CNN's weights under mmdet's names (torchvision's
    in the backbone), seeded: kernels ~ N(0, 1 / fan_in), BatchNorms'
    affine and statistics around the identity, with their step counters,
    and one key of no known module."""
    rs = np.random.RandomState(seed)
    sd = {}

    def conv(name, cout, cin, k, bias=False):
        sd[f"{name}.weight"] = rs.randn(cout, cin, k, k) / np.sqrt(cin * k * k)
        if bias:
            sd[f"{name}.bias"] = rs.normal(0, 0.1, cout)

    def linear(name, cout, cin):
        sd[f"{name}.weight"] = rs.randn(cout, cin) / np.sqrt(cin)
        sd[f"{name}.bias"] = rs.normal(0, 0.1, cout)

    def bn(name, c):
        sd.update({f"{name}.weight": rs.uniform(0.5, 1.5, c),
                   f"{name}.bias": rs.normal(0, 0.1, c),
                   f"{name}.running_mean": rs.normal(0, 0.1, c),
                   f"{name}.running_var": rs.uniform(0.5, 1.5, c),
                   f"{name}.num_batches_tracked": np.asarray(7)})

    conv("backbone.conv1", 64, 3, 7)
    bn("backbone.bn1", 64)
    cin = 64
    for s, planes in enumerate((64, 128, 256, 512)):
        for b in range(2):
            p = f"backbone.layer{s + 1}.{b}"
            conv(f"{p}.conv1", planes, cin, 3)
            bn(f"{p}.bn1", planes)
            conv(f"{p}.conv2", planes, planes, 3)
            bn(f"{p}.bn2", planes)
            if b == 0 and s > 0:
                conv(f"{p}.downsample.0", planes, cin, 1)
                bn(f"{p}.downsample.1", planes)
            cin = planes
    for i, c in enumerate((64, 128, 256, 512)):
        conv(f"neck.lateral_convs.{i}.conv", 256, c, 1, bias=True)
        conv(f"neck.fpn_convs.{i}.conv", 256, 256, 3, bias=True)
    conv("rpn_head.rpn_conv", 64, 256, 3, bias=True)
    conv("rpn_head.rpn_cls", 3, 64, 1, bias=True)
    conv("rpn_head.rpn_reg", 12, 64, 1, bias=True)
    linear("bbox_head.shared_fcs.0", 128, 256 * 7 * 7)
    linear("bbox_head.shared_fcs.1", 128, 128)
    linear("bbox_head.fc_cls", 16, 128)
    linear("bbox_head.fc_reg", 64, 128)
    sd[STRAY] = rs.randn(4)
    return {k: torch.from_numpy(np.asarray(v, np.float32)
                                if k.split(".")[-1] != "num_batches_tracked"
                                else np.asarray(v, np.int64))
            for k, v in sd.items()}


@pytest.fixture(scope="module")
def converted():
    sd = mmdet_state_dict()
    variables, ref_unmapped = convert_detector(
        {k: v.numpy() for k, v in sd.items()}, depth=18)
    return sd, variables, ref_unmapped


@needs_reference
def test_mmdet_state_dict_is_the_reference_converters(converted):
    sd, variables, ref_unmapped = converted
    got, unmapped = mmdet_to_state_dict(sd)
    want, bridge_unmapped = flax_to_state_dict(variables)
    assert unmapped == ref_unmapped == [STRAY] and not bridge_unmapped
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(to_np(got[k]), to_np(want[k]), k)


@needs_reference
def test_mmdet_weights_give_the_reference_detections(converted, tmp_path):
    sd, variables, _ = converted
    path = str(tmp_path / "faster_rcnn_mmdet.pth")
    torch.save(dict(state_dict={k: v for k, v in sd.items() if k != STRAY},
                    meta=dict(epoch=12)), path)
    cfg = model_cfg()
    model, _ = init_detector(Config(dict(model=cfg)), path, device="cpu")
    batch = hbb_batch(seed=8)
    ref = ref_predict(j_build(cfg), variables, batch)
    with torch.no_grad():
        got = {k: to_np(v) for k, v in model.predict(
            torch.from_numpy(batch["imgs"]),
            torch.from_numpy(batch["img_shapes"])).items()}
    assert got["valid"].sum() > 0
    np.testing.assert_array_equal(got["valid"], ref["valid"])
    np.testing.assert_array_equal(got["labels"], ref["labels"])
    assert np.abs(got["boxes"] - ref["boxes"]).max() <= 2e-2
    assert np.abs(got["scores"] - ref["scores"]).max() <= 1e-3
    torch.save(sd, path)        # the stray key: init_detector raises
    with pytest.raises(KeyError, match="stray"):
        init_detector(Config(dict(model=cfg)), path, device="cpu")


@needs_reference
def test_mmdet_stem_is_relaid_for_a_space_to_depth_stem(converted):
    sd, _, _ = converted
    cfg = dict(model_cfg(), backbone=dict(type="ResNet", depth=18,
                                          stem_space_to_depth=True))
    model, _ = init_detector(Config(dict(model=cfg)), device="cpu")
    got = mmdet_to_state_dict(sd, model)[0]["backbone.stem_conv.weight"]
    params, _ = convert_resnet(
        {k[len("backbone."):]: v.numpy() for k, v in sd.items()
         if k.startswith("backbone.")}, 18, stem_space_to_depth=True)
    want = np.asarray(params["stem_conv"]["kernel"]).transpose(3, 2, 0, 1)
    assert got.shape == (64, 12, 4, 4)
    np.testing.assert_array_equal(to_np(got), want)
    np.testing.assert_array_equal(to_np(got), stem_s2d_weights(
        sd["backbone.conv1.weight"].numpy()))
    model.load_state_dict(mmdet_to_state_dict(sd, model)[0], strict=True)


@pytest.mark.gpu
def test_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the chip with python -m "
                    "pytest -m gpu tests/test_torch_port_mmdet_weights.py")
    import chip_smoke
    out = chip_smoke.run_hbb_reference(kind="faster")
    assert out["weights"] == "mmdet_to_state_dict"
    assert out["max_abs_err"]["unpaired"] == 0 and out["n_valid"] > 0
