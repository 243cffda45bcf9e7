"""GroupNorm and the caffe style in the PyTorch port's ResNet and FPN,
the GroupNorm r18_e2e recipes, and every DOTA config of the repo,
against the JAX reference on the CPU.

Bounds:
- ResNet-18 with GroupNorm (the r18_e2e backbone) at 64^2 and the
  caffe-style ResNet-50 (stride on the first 1x1) at 64^2, zero-mean
  seeded inputs, the reference's weights with seeded norms: every
  stage within 1e-4 (1e-5 of its largest value);
- the FPN with GroupNorm, two-stage (start_level 0, max-pool extras)
  and RetinaNet's (start_level 1, extra convs, which keep their bias
  and get no norm): within 1e-5;
- GroupNorm against float64: at zero-mean inputs the port and flax's
  `nn.GroupNorm` within 2e-6 of it; at a mean of 30 and a std of 0.5
  neither is exact (flax computes E[x^2] - E[x]^2 by default, torch
  sums in another order): both within 1e-2 (measured 3.3e-3 and
  2.4e-3);
- the small thetaobb RBBoxRCNN with the r18_e2e recipe's GroupNorm
  (tests/torch_port_pairs.py): predict's valid and labels equal, boxes
  and rboxes within 1e-2 px, scores within 1e-5; every loss within 1e-5
  relative under a train_cfg that keeps every candidate;
- every `configs/dota_*.py` builds in the port (on the meta device: the
  module tree, no weights), and the reference's variables (their
  shapes from `jax.eval_shape`, filled with seeded values) of each
  architecture that did not build before (R18-GN two-stage and
  RetinaNetOBB, caffe R50) load strictly through the weight bridge,
  nothing unmapped (the OHEM and soft-NMS configs differ from their
  base configs in the train_cfg or test_cfg alone, not in the
  parameter tree).
The gpu-marked case runs chip_smoke's gn_reference phase (the small
GroupNorm models, thetaobb and RRoI, on the card against the CPU).
"""

import glob
import os

import numpy as np
import pytest
import torch

from aidet_tpu_torch.models.backbones.resnet import GroupNorm, ResNet
from aidet_tpu_torch.models.builder import build
from aidet_tpu_torch.models.necks.fpn import FPN
from aidet_tpu_torch.models.registry import DETECTORS
from aidet_tpu_torch.utils.config import Config
from torch_port_helpers import load_flax, to_np

try:
    import flax.linen as nn
    import jax
    import jax.numpy as jnp

    from aidet_tpu.models.backbones.resnet import ResNet as JResNet
    from aidet_tpu.models.necks.fpn import FPN as JFPN
    from torch_port_pairs import (GN, assert_bridge_loads,
                                  assert_losses_close, pair,
                                  perturb_all_norms, port_loss, port_predict,
                                  ref_loss, ref_predict, theta_batch,
                                  theta_cfg)
except ImportError:     # the card's machine: the gpu case runs alone
    jax = None
needs_reference = pytest.mark.skipif(jax is None,
                                     reason="needs the JAX reference")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = torch.from_numpy
LEVELS = (64, 128, 256, 512)


def run_module(jm, tm, inputs, top):
    """The reference module ``jm`` (seeded norms) and the port's ``tm``
    with its weights on the same inputs: (port outputs, reference's)."""
    v = perturb_all_norms(jax.jit(jm.init)(jax.random.PRNGKey(0), inputs), 1)
    ref = jax.jit(jm.apply)(v, inputs)
    load_flax(tm, v, top)
    with torch.no_grad():
        got = tm([T(np.array(x)) for x in inputs]
                 if isinstance(inputs, list) else T(np.array(inputs)))
    return [to_np(g) for g in got], [np.asarray(r) for r in ref]


@needs_reference
@pytest.mark.parametrize("depth,kw", [
    (18, dict(norm_cfg=GN if jax else None)), (50, dict(style="caffe"))])
def test_resnet_matches_the_reference(depth, kw):
    x = np.random.RandomState(0).randn(2, 64, 64, 3).astype(np.float32)
    got, ref = run_module(JResNet(depth=depth, **kw), ResNet(depth, **kw),
                          jnp.asarray(x), "_backbone")
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        assert np.abs(g - r).max() <= 1e-5 * np.abs(r).max() + 1e-5
    if depth == 50:      # caffe: the first 1x1 of each stage strides
        assert ResNet(50, style="caffe").layer2_block0.conv1.stride == (2, 2)
    else:
        assert isinstance(ResNet(18, norm_cfg=GN).layer1_block0.bn1,
                          GroupNorm)


@needs_reference
@pytest.mark.parametrize("kw", [dict(), dict(start_level=1,
                                             add_extra_convs=True)])
def test_fpn_with_group_norm_matches_the_reference(kw):
    rs = np.random.RandomState(1)
    feats = [jnp.asarray(rs.randn(2, 64 // s, 64 // s, c).astype(np.float32))
             for s, c in zip((4, 8, 16, 32), LEVELS)]
    tm = FPN(LEVELS, 64, norm_cfg=GN, **kw)
    got, ref = run_module(JFPN(in_channels=LEVELS, out_channels=64,
                               norm_cfg=GN, **kw), tm, feats, "_neck")
    assert len(got) == len(ref) == 5
    for g, r in zip(got, ref):
        assert g.shape == r.shape and np.abs(g - r).max() <= 1e-5
    assert tm.lateral0.bias is None and tm.fpn0.bias is None
    if kw:
        assert tm.extra0.bias is not None
        assert not any("extra" in n and "norm" in n
                       for n, _ in tm.named_modules())


@needs_reference
@pytest.mark.parametrize("mean,limit", [(0.0, 2e-6), (30.0, 1e-2)])
def test_group_norm_against_float64(mean, limit):
    x = (mean + 0.5 * np.random.RandomState(2).randn(2, 8, 8, 64)).astype(
        np.float32)
    m = nn.GroupNorm(num_groups=32, epsilon=1e-5)
    ref = np.asarray(m.apply(m.init(jax.random.PRNGKey(0), x), x))
    with torch.no_grad():
        got = to_np(GroupNorm(32, 64, eps=1e-5)(
            T(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1))
    x64 = x.astype(np.float64).reshape(2, 64, 32, 2)
    want = ((x64 - x64.mean((1, 3), keepdims=True))
            / np.sqrt(x64.var((1, 3), keepdims=True) + 1e-5)).reshape(x.shape)
    assert np.abs(got - want).max() <= limit
    assert np.abs(ref - want).max() <= limit


@pytest.fixture(scope="module")
def gn_pair():
    jm, v, tm = pair(theta_cfg(gn=True))
    batch = theta_batch()
    return tm, batch, ref_predict(jm, v, batch), ref_loss(jm, v, batch)


@needs_reference
def test_small_gn_detector_matches_the_reference(gn_pair):
    tm, batch, ref, ref_l = gn_pair
    got = port_predict(tm, batch)
    assert set(got) == set(ref) and got["valid"].sum() > 0
    np.testing.assert_array_equal(got["valid"], ref["valid"])
    np.testing.assert_array_equal(got["labels"], ref["labels"])
    for k, lim in (("boxes", 1e-2), ("rboxes", 1e-2), ("scores", 1e-5)):
        assert np.abs(got[k] - ref[k]).max() <= lim, k
    assert_losses_close(port_loss(tm, batch), ref_l, 1e-5)


DOTA_CONFIGS = sorted(os.path.relpath(p, REPO) for p in glob.glob(
    os.path.join(REPO, "configs", "dota_*.py")))


@pytest.mark.parametrize("path", DOTA_CONFIGS)
def test_every_dota_config_builds(path):
    cfg = Config.fromfile(os.path.join(REPO, path))
    with torch.device("meta"):
        model = build(dict(cfg.model), DETECTORS, dict(
            train_cfg=cfg.get("train_cfg"), test_cfg=cfg.get("test_cfg")))
    assert sum(p.numel() for p in model.parameters()) > 0


@needs_reference
@pytest.mark.parametrize("path", [
    "configs/dota_rroi_point_obb_r18_e2e.py",
    "configs/dota_centermap_net_r18_e2e.py",
    "configs/dota_retinanet_theta_obb_r18_e2e.py",
    "configs/dota_centermap_obb_r50_caffe_fpn_1x.py"])
def test_bridge_loads_the_reference_weights(path):
    tm, sd = assert_bridge_loads(path)
    norms = [k for k in sd if "norm" in k or "bn" in k]
    if "r18_e2e" in path:    # GroupNorm: weight and bias, no statistics
        assert isinstance(tm.backbone.stem_bn, GroupNorm)
        assert isinstance(tm.neck.lateral_norm0, GroupNorm)
        assert not any(k.endswith("running_mean") for k in norms)
    np.testing.assert_array_equal(to_np(tm.state_dict()[norms[0]]),
                                  to_np(sd[norms[0]]))


@pytest.mark.gpu
def test_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the chip with "
                    "python -m pytest -m gpu tests/test_torch_port_gn.py")
    import chip_smoke
    for kind in ("gn_theta", "gn_rroi"):
        out = chip_smoke.run_detector_reference(kind=kind)
        assert out["max_abs_err"]["unpaired"] == 0 and out["n_valid"] > 0
        assert "card_against_float64" in out["train"]["plain"]
