"""SSD300 in the PyTorch port against the JAX reference on the CPU: the
8732 anchors of `build_ssd_anchors` (on the port's `AnchorGenerator`
with SSD's scale order and centre), `L2Norm`, `SSDVGG` at 300^2 (its
ceil-mode pools: 75 -> 38), `SSDHead`, and the SSD300 detector whole
(predict and one loss, with the 3:1 hard-negative mining); SSD512's
input raises the port's ValueError where the reference fails later.

The reference's variables come from `dense_variables` (every kernel
N(0, 1 / fan_in), L2Norm's gamma near its initial 20); the images are
zero-mean noise at 300^2 (SSD reads them as they are).

Bounds, float32: anchors equal; the backbone's maps and the head's
outputs within 1e-5 of their largest magnitude (1e-4 for the six VGG
maps: thirteen convs deep); detections paired (valid and labels equal,
boxes within 1e-2 px, scores within 1e-4, in any order); each loss
within 1e-4 relative.  The gpu-marked case runs chip_smoke's SSD
reference phase (the card against the CPU).
"""

import numpy as np
import pytest
import torch

from aidet_tpu_torch.models.backbones.ssd_vgg import (L2Norm, SSDVGG,
                                                      ssd_feat_sizes)
from aidet_tpu_torch.models.builder import build_detector
from aidet_tpu_torch.models.heads.ssd_head import SSDHead, build_ssd_anchors
from torch_port_helpers import to_np
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

try:
    import jax
    import jax.numpy as jnp

    from aidet_tpu.models.backbones.ssd_vgg import L2Norm as JL2Norm
    from aidet_tpu.models.backbones.ssd_vgg import SSDVGG as JSSDVGG
    from aidet_tpu.models.heads.ssd_head import SSDHead as JSSDHead
    from aidet_tpu.models.heads.ssd_head import \
        build_ssd_anchors as j_build_ssd_anchors
    from torch_port_helpers import load_flax
    from torch_port_pairs import (assert_losses_close, assert_matched,
                                  dense_batch, dense_pair, dense_variables,
                                  port_loss, port_predict, ref_loss,
                                  ref_predict, seeded_variables)
except ImportError:     # the card's machine: the gpu case runs alone
    jax = None
needs_reference = pytest.mark.skipif(jax is None,
                                     reason="needs the JAX reference")
T = torch.from_numpy
SSD300 = dict(type="SSD", backbone=dict(type="SSDVGG", input_size=300),
              bbox_head=dict(type="SSDHead", num_classes=21),
              input_size=300, img_size=300)


def assert_close(got, ref, rel=1e-5):
    got, ref = to_np(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert np.abs(got - ref).max() <= rel * max(np.abs(ref).max(), 1e-12)


@needs_reference
def test_ssd_anchors_match_the_reference():
    got, sizes = build_ssd_anchors(300)
    ref, ref_sizes = j_build_ssd_anchors(300)
    np.testing.assert_array_equal(to_np(got), np.asarray(ref))
    assert sizes == ref_sizes and sum(sizes) == 8732
    assert ssd_feat_sizes(300) == (38, 19, 10, 5, 3, 1)


@needs_reference
def test_l2norm_matches_the_reference():
    x = np.random.RandomState(1).randn(2, 5, 5, 12).astype(np.float32)
    jm = JL2Norm()
    v = seeded_variables(jm, jnp.asarray(x))
    v["params"]["gamma"] = np.linspace(15, 25, 12).astype(np.float32)
    tm = L2Norm(12)
    with torch.no_grad():
        tm.gamma.copy_(T(v["params"]["gamma"]))
        got = tm(T(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert_close(got, jm.apply(v, jnp.asarray(x)))


@needs_reference
def test_ssd_vgg_and_head_match_the_reference():
    """The backbone's six maps of a 300^2 image, then the head on them."""
    x = np.random.RandomState(2).randn(1, 300, 300, 3).astype(np.float32)
    jm = JSSDVGG(input_size=300)
    v = dense_variables(jm, img=300)
    tm = load_flax(SSDVGG(300), v, "_backbone")
    ref = jax.jit(jm.apply)(v, jnp.asarray(x))
    with torch.no_grad():
        got = tm(T(x))
    assert [g.shape[1] for g in got] == [38, 19, 10, 5, 3, 1]
    for g, r in zip(got, ref):
        assert_close(g, r, 1e-4)
    jh = JSSDHead(num_classes=7)
    feats = [np.array(r) for r in ref]
    vh = seeded_variables(jh, [jnp.asarray(f) for f in feats])
    th = load_flax(SSDHead(num_classes=7), vh, "_head")
    href = jax.jit(jh.apply)(vh, [jnp.asarray(f) for f in feats])
    with torch.no_grad():
        hgot = th([T(f) for f in feats])
    for g_lvls, r_lvls in zip(hgot, href):
        for g, r in zip(g_lvls, r_lvls):
            assert_close(g, r)


@needs_reference
def test_ssd300_matches_the_reference():
    jm, v, tm = dense_pair(SSD300, img=300)
    batch = dense_batch(img=300)
    assert_matched(port_predict(tm, batch), ref_predict(jm, v, batch),
                   dict(boxes=1e-2, scores=1e-4))
    assert_losses_close(port_loss(tm, batch), ref_loss(jm, v, batch), 1e-4)


def test_ssd512_raises_at_build():
    """SSD512's maps (64, 32, 16, 8, 6, 4) against SSD300's 8732 anchors:
    the port names both when it builds; the reference fails in its loss
    and predict (a shape mismatch of 8732 against 24656 anchors)."""
    with pytest.raises(ValueError, match="24656 anchors.*8732"):
        build_detector(dict(SSD300, input_size=512, img_size=512,
                            backbone=dict(type="SSDVGG", input_size=512)),
                       device="meta")


@pytest.mark.gpu
def test_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the chip with "
                    "python -m pytest -m gpu tests/test_torch_port_ssd.py")
    import chip_smoke
    out = chip_smoke.run_hbb_reference(kind="ssd")
    assert out["max_abs_err"]["unpaired"] == 0 and out["n_valid"] > 0
