"""The C4 detectors of the PyTorch port against the JAX reference on the
CPU: the res5 shared head (`ResLayer`, pytorch and caffe style), the
average-pooled `BBoxHead`, and the small C4 detectors whole: Mask R-CNN
(predict: boxes and the masks through res5; loss and its gradients),
the proposal-only RPN at stride 16, and Cascade Mask R-CNN with the
shared head in every stage (predict).

The detectors are tests/torch_port_pairs.py's `C4_SMALL` (ResNet-18's
first 3 stages, caffe style, no neck, the RPN on C4 at stride 16 with 2
anchor scales, crops of 14 through ResNet-18's res5 into an
average-pooled box head; 128^2 images, 16 classes) with the reference's
seeded variables carried over by the weight bridge (`shaped_pair`); the
reference runs its XLA RoIAlign, the port its plain version.
`C4_TRAIN_CFG` keeps every candidate, so both sides sample the same
anchors and rois.

Bounds, float32: the heads' outputs within 1e-5 of their largest
magnitude; detections' valid and labels equal, boxes within 1e-2 px
(2e-2 for the cascade's three decodes), scores within 1e-4, masks within
1e-3; the RPN's proposals within 1e-2 px and their scores within 1e-5;
each loss within 1e-4 relative; every gradient leaf within 1e-3 of the
leaf's largest magnitude.  The gpu-marked case runs chip_smoke's
hbb_reference phase for the C4 Mask R-CNN (the card against the CPU).
"""

import numpy as np
import pytest
import torch

from torch_port_helpers import to_np
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

try:
    import jax
    import jax.numpy as jnp

    from aidet_tpu.models.heads.bbox_head import BBoxHead as JBBoxHead
    from aidet_tpu.models.shared_heads import ResLayer as JResLayer
    from aidet_tpu_torch.models.heads.bbox_head import BBoxHead
    from aidet_tpu_torch.models.shared_heads import ResLayer
    from torch_port_helpers import load_flax
    from torch_port_pairs import (assert_bridge_loads, assert_grads_close,
                                  assert_losses_close, assert_pairs, c4_cfg, hbb_batch,
                                  perturb_all_norms, port_loss,
                                  port_loss_and_grads, port_predict,
                                  ref_loss, ref_loss_and_grads, ref_predict,
                                  shaped_pair)
except ImportError:     # the card's machine: the gpu case runs alone
    jax = None
needs_reference = pytest.mark.skipif(jax is None,
                                     reason="needs the JAX reference")
T = torch.from_numpy
C4_MASK_HEAD = dict(type="FCNMaskHead", num_convs=0, in_channels=512,
                    conv_out_channels=64, num_classes=16)


def assert_close(got, ref, rel=1e-5):
    got, ref = to_np(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= rel * np.abs(ref).max()


@needs_reference
@pytest.mark.parametrize("style", ["pytorch", "caffe"])
def test_res_layer_matches_the_reference(style):
    """ResNet-50's res5 (the 3 bottlenecks of stage 3, 1024 -> 2048
    channels) on two 14x14 crops, strided to 7x7: the C4 configs'
    shared head."""
    jm = JResLayer(depth=50, stage=3, stride=2, style=style)
    x = np.random.RandomState(0).randn(2, 14, 14, 1024).astype(np.float32)
    v = perturb_all_norms(jax.jit(jm.init)(jax.random.PRNGKey(0),
                                           jnp.asarray(x)), 1)
    tm = load_flax(ResLayer(depth=50, stage=3, stride=2, style=style), v,
                   "_shared_head")
    with torch.no_grad():
        got = tm(T(x))
    assert got.shape == (2, 7, 7, 2048)
    assert_close(got, jax.jit(jm.apply)(v, jnp.asarray(x)))
    stride = (2, 2)
    assert (tm.layer4_block0.conv1.stride if style == "caffe"
            else tm.layer4_block0.conv2.stride) == stride


@needs_reference
@pytest.mark.parametrize("avg_pool", [True, False])
def test_bbox_head_matches_the_reference(avg_pool):
    kw = dict(num_classes=16, in_channels=32, roi_feat_size=7,
              with_avg_pool=avg_pool)
    jm = JBBoxHead(**kw)
    x = np.random.RandomState(1).randn(5, 7, 7, 32).astype(np.float32)
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    tm = load_flax(BBoxHead(**kw), v, "_bbox_head")
    with torch.no_grad():
        got = tm(T(x))
    for g, r in zip(got, jax.jit(jm.apply)(v, jnp.asarray(x))):
        assert_close(g, r)


@pytest.fixture(scope="module")
def c4_mask():
    """The small C4 Mask R-CNN pair and a seeded batch with box masks."""
    jm, v, tm = shaped_pair(c4_cfg("MaskRCNN", mask_head=C4_MASK_HEAD))
    return jm, v, tm, hbb_batch(masks=True)


@needs_reference
def test_c4_mask_rcnn_predict_matches_the_reference(c4_mask):
    jm, v, tm, batch = c4_mask
    got, ref = port_predict(tm, batch), ref_predict(jm, v, batch)
    assert got["masks"].shape[-2:] == (14, 14)      # res5 halves the crop
    assert_pairs(got, ref, dict(boxes=1e-2, scores=1e-4, masks=1e-3))


@needs_reference
def test_c4_mask_rcnn_loss_and_gradients_match_the_reference(c4_mask):
    jm, v, tm, batch = c4_mask
    ref, ref_grads = ref_loss_and_grads(jm, v, batch)
    got, got_grads = port_loss_and_grads(tm, batch)
    assert_losses_close(got, ref, 1e-4)
    assert got_grads["shared_head.layer4_block0.conv1.weight"] is not None
    assert_grads_close(got_grads, ref_grads)


@needs_reference
def test_c4_rpn_matches_the_reference():
    """The proposal-only RPN on the one C4 level (configs/
    rpn_r50_caffe_c4_1x.py's strides=(16,))."""
    jm, v, tm = shaped_pair(c4_cfg("RPN"))
    batch = hbb_batch()
    del batch["gt_labels"]
    got, ref = port_predict(tm, batch), ref_predict(jm, v, batch)
    assert got["valid"].sum() > 0
    np.testing.assert_array_equal(got["valid"], ref["valid"])
    assert np.abs(got["boxes"] - ref["boxes"]).max() <= 1e-2
    assert np.abs(got["scores"] - ref["scores"]).max() <= 1e-5
    assert_losses_close(port_loss(tm, batch), ref_loss(jm, v, batch), 1e-4)
    assert tm.level_sizes == [(128 // 16) ** 2 * 6]


@needs_reference
def test_c4_cascade_predict_matches_the_reference():
    """Cascade Mask R-CNN on C4: each stage's crops and the mask crops
    through the shared head (configs/cascade_mask_rcnn_r50_caffe_c4_1x
    .py)."""
    jm, v, tm = shaped_pair(c4_cfg("CascadeRCNN", mask_head=C4_MASK_HEAD))
    batch = hbb_batch()
    got, ref = port_predict(tm, batch), ref_predict(jm, v, batch)
    assert_pairs(got, ref, dict(boxes=2e-2, scores=1e-4, masks=1e-3))


@needs_reference
@pytest.mark.parametrize("config", ["mask_rcnn_r50_caffe_c4_1x"])
def test_config_weights_load_through_the_bridge(config):
    """The reference's variables of the C4 Mask R-CNN config (their
    shapes from a trace, seeded values) load strictly into the port's
    build of it, every leaf mapped by `flax_to_state_dict`: res5's
    ``layer4_block{b}`` under ``_shared_head``."""
    tm, sd = assert_bridge_loads(f"configs/{config}.py")
    assert any(k.startswith("shared_head.layer4_block2.") for k in sd)


@pytest.mark.gpu
def test_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the chip with "
                    "python -m pytest -m gpu tests/test_torch_port_c4.py")
    import chip_smoke
    out = chip_smoke.run_hbb_reference(kind="c4")
    assert out["max_abs_err"]["unpaired"] == 0 and out["n_valid"] > 0
