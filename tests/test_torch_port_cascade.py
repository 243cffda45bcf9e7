"""Cascade R-CNN and HTC in the PyTorch port against the JAX reference
on the CPU: the cascade's predict with and without its mask head, the
Cascade Mask R-CNN loss and its gradients, HTC's predict and loss with
its semantic branch and its predict without it, and `HTCMaskHead`'s
information-flow chain alone.

The models are tests/torch_port_pairs.py's small architecture
(ResNet-18, a 64-channel FPN, 128^2 images, 16 classes) at the
cascade's 3 stages, narrow (a 128-wide box head, 2-conv 64-channel
mask heads, a 64-channel fused semantic head), with the reference's
seeded variables carried over by the weight bridge (`shaped_pair`);
the reference runs its XLA RoIAlign, the port its plain version.  The
train_cfg (`HBB_TRAIN_CFG`) keeps every candidate of every stage and
of HTC's interleaved mask samples, so both sides sample the same rois
although their random streams differ.

Bounds, float32: detections' valid and labels equal, boxes within 2e-2 px,
scores within 1e-4, masks within 1e-3 (`LIMITS`: three stages of decodes); each
loss within 1e-4 relative; every gradient leaf within 1e-3 of the leaf's
largest magnitude; the info-flow chain's logits and features within 1e-5 of
their largest magnitude.  The gpu-marked case runs chip_smoke's hbb_reference
phase for the cascade and HTC (the card against the CPU).
"""

import numpy as np
import pytest
import torch

from torch_port_helpers import to_np
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

try:
    import flax.linen as nn
    import jax
    import jax.numpy as jnp

    from aidet_tpu.models import build_detector as j_build
    from aidet_tpu.models.heads.mask_head import HTCMaskHead as JHTCMaskHead
    from aidet_tpu_torch.models.builder import build_detector
    from aidet_tpu_torch.models.heads.mask_head import HTCMaskHead
    from torch_port_helpers import load_flax
    from torch_port_pairs import (SMALL_MASK_HEAD, SMALL_SEMANTIC_HEAD,
                                  assert_grads_close, assert_losses_close,
                                  hbb_batch, hbb_cfg, port_loss,
                                  port_loss_and_grads, port_predict,
                                  ref_loss, ref_loss_and_grads, ref_predict,
                                  shaped_pair)
except ImportError:     # the card's machine: the gpu case runs alone
    jax = None
needs_reference = pytest.mark.skipif(jax is None,
                                     reason="needs the JAX reference")
# each stage decodes onto the last one's float32 boxes, and random
# weights regress large deltas: the two sides' roundings part further
# than in a single-stage pair (seen: 1.3e-2 px), and the masks are
# cropped at those boxes (seen: 3.4e-4 in HTC's, 1.0e-4 in the
# cascade's)
LIMITS = dict(boxes=2e-2, scores=1e-4, masks=1e-3)


def assert_detections_match(got, ref):
    assert set(got) == set(ref)
    assert got["valid"].sum() > 0
    np.testing.assert_array_equal(got["valid"], ref["valid"])
    np.testing.assert_array_equal(got["labels"], ref["labels"])
    for k, lim in LIMITS.items():
        if k in ref:
            assert np.abs(got[k] - ref[k]).max() <= lim, k


def without(cfg_key, pair_cfg, jm_v_tm):
    """The pair of ``pair_cfg`` with its ``cfg_key`` sub-module left out:
    the reference module and the port's model built without it, on the
    same variables and weights (the module's own left unused: flax
    ignores variables that a module does not read)."""
    _, v, tm = jm_v_tm
    cfg = dict(pair_cfg, **{cfg_key: None})
    small = build_detector(cfg, device="cpu", train=True)
    sd = tm.state_dict()
    small.load_state_dict({k: sd[k] for k in small.state_dict()}, strict=True)
    return j_build(cfg), v, small.eval()


MASK_CFG = None if jax is None else hbb_cfg(
    "CascadeRCNN", mask_head=dict(type="FCNMaskHead", **SMALL_MASK_HEAD))
HTC_CFG = None if jax is None else hbb_cfg(
    "HTC", mask_head=dict(type="HTCMaskHead", **SMALL_MASK_HEAD),
    semantic_head=SMALL_SEMANTIC_HEAD)


@pytest.fixture(scope="module")
def cascade_mask():
    """The Cascade Mask R-CNN pair, and the reference's predict on
    `hbb_batch`."""
    jm, v, tm = shaped_pair(MASK_CFG)
    return jm, v, tm, ref_predict(jm, v, hbb_batch())


@needs_reference
def test_cascade_predict_matches_the_reference(cascade_mask):
    """The cascade without a mask head (3 stages' scores averaged, the
    last stage's boxes decoded with the last stds) against the
    reference's detections of the same weights with the mask head,
    which are the same: its mask branch runs on them after."""
    jm, v, tm = without("mask_head", MASK_CFG, cascade_mask[:3])
    ref = {k: x for k, x in cascade_mask[3].items() if k != "masks"}
    got = port_predict(tm, hbb_batch())
    assert set(got) == {"boxes", "scores", "labels", "valid"}
    assert_detections_match(got, ref)
    assert len(tm.bbox_heads) == 3
    assert all(h.fc_reg.out_features == 4 for h in tm.bbox_heads)


@needs_reference
def test_cascade_mask_predict_matches_the_reference(cascade_mask):
    _, _, tm, ref = cascade_mask
    got = port_predict(tm, hbb_batch())
    assert got["masks"].shape == (2, 20, 28, 28)
    assert_detections_match(got, ref)


@needs_reference
def test_cascade_loss_and_gradients_match_the_reference(cascade_mask):
    jm, v, tm, _ = cascade_mask
    batch = hbb_batch(masks=True)
    ref, ref_grads = ref_loss_and_grads(jm, v, batch)
    got, grads = port_loss_and_grads(tm, batch)
    assert {"s0.loss_cls", "s2.loss_bbox", "loss_mask"} <= set(got)
    assert_losses_close(got, ref, 1e-4)
    assert_grads_close(grads, ref_grads, 1e-3)


@pytest.fixture(scope="module")
def htc():
    return shaped_pair(HTC_CFG)


@needs_reference
def test_htc_predict_matches_the_reference(htc):
    jm, v, tm = htc
    batch = hbb_batch()
    assert_detections_match(port_predict(tm, batch),
                            ref_predict(jm, v, batch))
    assert "conv_res" not in dict(tm.mask_heads[0].named_children())
    assert tm.mask_heads[2].conv_res is not None


@needs_reference
def test_htc_loss_matches_the_reference(htc):
    jm, v, tm = htc
    batch = hbb_batch(masks=True, semantic=True)
    got = port_loss(tm, batch)
    assert {"s0.loss_mask", "s2.loss_mask", "loss_semantic_seg"} <= set(got)
    assert_losses_close(got, ref_loss(jm, v, batch), 1e-4)


@needs_reference
def test_htc_without_semantic_matches_the_reference(htc):
    """HTC without its semantic branch (htc_without_semantic's form):
    predict against the reference; its loss, which has no
    loss_semantic_seg, is HTC's loss without the fusion, whose absence
    the Cascade Mask R-CNN loss above holds to the reference."""
    jm, v, tm = without("semantic_head", HTC_CFG, htc)
    batch = hbb_batch()
    assert_detections_match(port_predict(tm, batch),
                            ref_predict(jm, v, batch))
    got = port_loss(tm, hbb_batch(masks=True))
    assert {"s0.loss_mask", "s2.loss_mask"} <= set(got)
    assert "loss_semantic_seg" not in got
    assert all(np.isfinite(x) and x > 0 for x in got.values())


class _Chain(nn.Module if jax else object):
    """Three reference HTCMaskHeads chained as HTC's predict chains them
    (cascade.py:430-438): each fed the trunk feature of the one before,
    each giving its logits and its feature."""

    def setup(self):
        self.heads = [JHTCMaskHead(**SMALL_MASK_HEAD) for _ in range(3)]

    def __call__(self, x):
        outs, last = [], None
        for head in self.heads:
            logits, last = head(x, last, return_logits=True,
                                return_feat=True)
            outs.append(logits)
        return outs + [last]


@needs_reference
def test_htc_mask_head_info_flow_chain_matches_the_reference():
    x = np.random.RandomState(4).randn(6, 14, 14, 64).astype(np.float32)
    jm = _Chain()
    v = jax.jit(jm.init)(jax.random.PRNGKey(2), jnp.asarray(x))
    ref = jax.jit(jm.apply)(v, jnp.asarray(x))
    heads = [load_flax(HTCMaskHead(**SMALL_MASK_HEAD, with_conv_res=i > 0),
                       {"params": v["params"][f"heads_{i}"]}, "_mask_head")
             for i in range(3)]
    got, last = [], None
    with torch.no_grad():
        t = torch.from_numpy(x)
        for head in heads:
            logits, last = head(t, last, return_logits=True,
                                return_feat=True)
            got.append(logits)
        trunk = heads[1](t, got and heads[0](t, None, return_logits=False),
                         return_logits=False)
    got.append(last)
    assert got[0].shape == (6, 28, 28, 15) and last.shape == (6, 14, 14, 64)
    for g, r in zip(got, ref):
        r = np.asarray(r)
        assert np.abs(to_np(g) - r).max() <= 1e-5 * np.abs(r).max()
    # trunk-only calls (training's chain) give the same feature
    assert torch.equal(trunk, heads[1](t, heads[0](t)[1])[1])
    assert "conv_res" not in dict(heads[0].named_children())


@pytest.mark.gpu
def test_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the chip with "
                    "python -m pytest -m gpu tests/test_torch_port_cascade.py")
    import chip_smoke
    for kind in ("cascade", "htc"):
        out = chip_smoke.run_hbb_reference(kind=kind)
        assert out["max_abs_err"]["unpaired"] == 0 and out["n_valid"] > 0
