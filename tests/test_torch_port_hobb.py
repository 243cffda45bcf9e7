"""The hobb codec family and the H-OBB RBBoxRCNN of the PyTorch port
against the JAX reference on the CPU.

Bounds:
- every hobb conversion, `hobb_rolls`, `hobb_flip`, `hobb_rescale` and
  the delta codec `hobb2delta` / `delta2hobb`: within 1e-4 px (deltas
  within 1e-5) of `aidet_tpu.core.rboxes`' on seeded thetaobbs whose
  corners are clear of a best-point-sort tie;
- the hobb RoI targets (`rbbox_target(encode="hobb")`) and the four
  rolled targets of the sort-robust loss: within 1e-5;
- the small H-OBB RBBoxRCNN (`configs/dota_h_obb_r50_fpn_1x.py`'s
  heads on the ResNet-18 architecture of tests/test_models_forward.py,
  float32), the reference's weights carried over by the weight bridge:
  predict's valid and labels equal, boxes and hobb rboxes within 0.03
  px (plus 1e-5 of the largest coordinate: random weights decode hobbs
  thousands of pixels long), scores within 2e-4; every loss within
  1e-4 relative, with and without ``hobb_robust_loss``, under a
  train_cfg that keeps every candidate (both sides sample the same
  rois).
The gpu-marked case runs chip_smoke's h_obb_reference phase (the small
H-OBB model's predict and train step, plain and robust, on the card
against the CPU); it needs no JAX, so it runs on the card's machine
alone: python -m pytest -m gpu tests/test_torch_port_hobb.py.
"""

import functools

import numpy as np
import pytest
import torch

from aidet_tpu_torch.convert import flax_to_state_dict
from aidet_tpu_torch.core import rboxes as tr
from aidet_tpu_torch.core.sample import FixedSample
from aidet_tpu_torch.core.targets import rbbox_target
from aidet_tpu_torch.flagship import keep_every_candidate_cfg
from aidet_tpu_torch.models.builder import build_detector
from torch_port_helpers import perturb_norms, to_np
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

try:
    import jax
    import jax.numpy as jnp

    from aidet_tpu.core import rboxes as jr
    from aidet_tpu.core.sample import FixedSample as JFixedSample
    from aidet_tpu.core.targets import rbbox_target as j_rbbox_target
    from aidet_tpu.models import build_detector as j_build
    from test_models_forward import IMG, _small_cfg
    J = jnp.asarray
except ImportError:     # the card's machine: the gpu case runs alone
    jax = None
needs_reference = pytest.mark.skipif(jax is None,
                                     reason="needs the JAX reference")
T = torch.from_numpy
G, MAX_NUM = 4, 100


def thetaobbs(seed, n=64):
    rs = np.random.RandomState(seed)
    t = np.concatenate([rs.uniform(50, 400, (n, 2)), rs.uniform(4, 120, (n, 2)),
                        rs.uniform(-np.pi / 2, -1e-3, (n, 1))], -1)
    return t.astype(np.float32)


def best_sort_clear(pointobbs, gap=1e-3):
    """Quads whose best roll is ``gap`` (relative) nearer the hull's
    corners than the next: elsewhere two roundings may pick another
    first edge, a tie and no defect."""
    p = pointobbs.astype(np.float64)
    xs, ys = p[:, 0::2], p[:, 1::2]
    ref = np.stack([xs.min(1), ys.min(1), xs.max(1), ys.min(1), xs.max(1),
                    ys.max(1), xs.min(1), ys.max(1)], 1)
    d = np.sort(np.stack([((np.roll(p, 2 * s, 1) - ref) ** 2).sum(1)
                          for s in range(4)], 1), 1)
    return d[:, 1] - d[:, 0] > gap * np.maximum(d[:, 1], 1e-9)


@pytest.fixture(scope="module")
def boxes():
    t = thetaobbs(0)
    keep = best_sort_clear(np.array(jr.thetaobb2pointobb(J(t))))
    assert keep.mean() > 0.9
    return t[keep]


def close(got, ref, atol=1e-4):
    np.testing.assert_allclose(to_np(got), np.asarray(ref), atol=atol,
                               rtol=0)


@needs_reference
def test_hobb_conversions_match_the_reference(boxes):
    h_ref = jr.thetaobb2hobb(J(boxes))
    close(tr.thetaobb2hobb(T(boxes)), h_ref)
    h = np.array(h_ref)
    close(tr.hobb2pointobb(T(h)), jr.hobb2pointobb(J(h)))
    close(tr.hobb2thetaobb(T(h)), jr.hobb2thetaobb(J(h)))
    p = np.array(jr.thetaobb2pointobb(J(boxes)))
    close(tr.pointobb2hobb(T(p)), jr.pointobb2hobb(J(p)))
    close(tr.pointobb_best_point_sort(T(p)), jr.pointobb_best_point_sort(J(p)))
    close(tr.pointobb2bbox(T(p)), jr.pointobb2bbox(J(p)))
    close(tr.hobb_rolls(T(h)), jr.hobb_rolls(J(h)))
    close(to_np(tr.hobb_rolls(T(h)))[:, 0], h)
    close(tr.hobb_rescale(T(h), 0.5), jr.hobb_rescale(J(h), 0.5))
    close(tr.hobb_rescale(T(h), 0.5, reverse=True),
          jr.hobb_rescale(J(h), 0.5, reverse=True))
    close(tr.pointobb_flip(T(p), (512, 600)), jr.pointobb_flip(J(p), (512, 600)))
    flipped = np.array(jr.hobb_flip(J(h), (512, 600)))
    clear = best_sort_clear(np.array(jr.hobb2pointobb(J(flipped))))
    close(to_np(tr.hobb_flip(T(h), (512, 600)))[clear], flipped[clear])
    # every roll decodes to the same rectangle
    rolls = np.array(jr.hobb_rolls(J(h)))
    area = np.array(jr.hobb2thetaobb(J(rolls)))
    np.testing.assert_allclose(area[..., 2] * area[..., 3],
                               (area[:, :1, 2] * area[:, :1, 3]).repeat(4, 1),
                               rtol=1e-4)


@needs_reference
def test_hobb_delta_codec_matches_the_reference(boxes):
    rs = np.random.RandomState(1)
    h = np.array(jr.thetaobb2hobb(J(boxes)))
    xy = rs.uniform(0, 300, (len(h), 2))
    rois = np.concatenate([xy, xy + rs.uniform(8, 200, (len(h), 2))],
                          -1).astype(np.float32)
    means, stds = (0.1, 0.0, -0.1, 0.0, 0.05), (0.1, 0.1, 0.2, 0.2, 0.3)
    d_ref = jr.hobb2delta(J(rois), J(h), means, stds)
    close(tr.hobb2delta(T(rois), T(h), means, stds), d_ref, atol=1e-5)
    close(tr.delta2hobb(T(rois), T(np.array(d_ref)), means, stds),
          jr.delta2hobb(J(rois), d_ref, means, stds))
    grouped = rs.randn(len(h), 15).astype(np.float32)   # 3 class groups
    close(tr.delta2hobb(T(rois), T(grouped)),
          jr.delta2hobb(J(rois), J(grouped)))
    assert tr.RBBOX_CODECS["hobb"][0] == 5
    close(tr.RBBOX_CODECS["hobb"][3](T(h)), jr.RBBOX_CODECS["hobb"][3](J(h)))


@needs_reference
def test_hobb_targets_and_rolled_targets_match_the_reference(boxes):
    """`rbbox_target` in hobb against the reference's, per image, for
    the gt hobbs and each of their 4 rolls (the robust loss's
    alternatives)."""
    rs = np.random.RandomState(2)
    b, r, g = 2, 24, 6
    gt = np.array(jr.thetaobb2hobb(J(boxes[:b * g]))).reshape(b, g, 5)
    xy = rs.uniform(0, 300, (b, r, 2))
    rois = np.concatenate([xy, xy + rs.uniform(8, 200, (b, r, 2))],
                          -1).astype(np.float32)
    is_pos = rs.rand(b, r) < 0.5
    valid = is_pos | (rs.rand(b, r) < 0.7)
    gt_inds = np.where(is_pos, rs.randint(0, g, (b, r)), -1)
    labels = rs.randint(1, 16, (b, g))
    sample = FixedSample(T(np.arange(r)).expand(b, r), T(is_pos), T(valid),
                         T(gt_inds))
    rolled = np.array(jr.hobb_rolls(J(gt)))
    for k in range(5):
        g_k = gt if k == 4 else rolled[:, :, k]
        got = rbbox_target(sample, T(rois), T(g_k), T(labels), "hobb")
        for i in range(b):
            ref = j_rbbox_target(
                JFixedSample(J(np.arange(r)), J(is_pos[i]), J(valid[i]),
                             J(gt_inds[i])),
                J(rois[i]), J(g_k[i]), J(labels[i]), "hobb")
            close(got.bbox_targets[i], ref.bbox_targets, atol=1e-5)
            close(got.bbox_weights[i], ref.bbox_weights, atol=0)
            np.testing.assert_array_equal(to_np(got.labels[i]),
                                          np.asarray(ref.labels))
    close(tr.hobb_rolls(T(gt)), rolled)


def hobb_cfg(robust=False):
    cfg = _small_cfg(rbbox_head=dict(type="RBBoxHead", num_classes=16,
                                     in_channels=64, fc_out_channels=128,
                                     encode="hobb"),
                     rbbox_encode="hobb", hobb_robust_loss=robust)
    cfg["train_cfg"] = dict(
        keep_every_candidate_cfg(IMG, G, MAX_NUM),
        rpn_proposal=dict(nms_pre=200, nms_post=MAX_NUM, max_num=MAX_NUM))
    return dict(type="RBBoxRCNN", **cfg)


def hobb_batch():
    rs = np.random.RandomState(6)
    t = np.concatenate([rs.uniform(20, IMG - 20, (2, G, 2)),
                        rs.uniform(8, 40, (2, G, 2)),
                        rs.uniform(-1.5, -0.05, (2, G, 1))], -1)
    gt_rboxes = to_np(tr.thetaobb2hobb(T(t.astype(np.float32))))
    p = to_np(tr.thetaobb2pointobb(T(t.astype(np.float32))))
    return dict(
        imgs=rs.randint(0, 256, (2, IMG, IMG, 3)).astype(np.uint8),
        gt_boxes=np.concatenate([p[..., 0::2].min(-1, keepdims=True),
                                 p[..., 1::2].min(-1, keepdims=True),
                                 p[..., 0::2].max(-1, keepdims=True),
                                 p[..., 1::2].max(-1, keepdims=True)], -1),
        gt_rboxes=gt_rboxes,
        gt_valid=np.asarray([[True] * G, [True] * (G - 1) + [False]]),
        gt_labels=rs.randint(1, 16, (2, G)).astype(np.int32),
        img_shapes=np.asarray([[IMG, IMG], [IMG, IMG - 16]], np.float32))


@pytest.fixture(scope="module")
def models():
    """The reference's variables and its predict and losses (plain and
    robust), and the port's model with those weights."""
    jm = j_build(hobb_cfg())
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)))
    v = perturb_norms(v, 9)
    sd, unmapped = flax_to_state_dict(v)
    assert not unmapped
    batch = hobb_batch()
    ref_pred = jax.jit(functools.partial(jm.apply, method="predict"))(
        v, J(batch["imgs"]), J(batch["img_shapes"]))
    ref_loss = {}
    for robust in (False, True):
        m = j_build(hobb_cfg(robust))
        ref_loss[robust] = {k: float(x) for k, x in jax.jit(
            functools.partial(m.apply, method="loss"))(
                v, rngs={"sampling": jax.random.PRNGKey(1)},
                **{k: J(x) for k, x in batch.items()}).items()}
    ports = {}
    for robust in (False, True):
        tm = build_detector(hobb_cfg(robust), device="cpu", train=True)
        tm.load_state_dict(sd, strict=True)
        ports[robust] = tm.eval()
    return dict(batch=batch, ref_pred={k: np.asarray(x)
                                       for k, x in ref_pred.items()},
                ref_loss=ref_loss, ports=ports)


@needs_reference
def test_h_obb_predict_matches_the_reference(models):
    batch, ref = models["batch"], models["ref_pred"]
    got = {k: to_np(x) for k, x in models["ports"][False].predict(
        T(batch["imgs"]), T(batch["img_shapes"])).items()}
    assert set(got) == set(ref) == {"boxes", "scores", "labels", "valid",
                                    "rboxes"}
    assert got["rboxes"].shape == (2, 20, 5)
    assert got["valid"].sum() > 0
    np.testing.assert_array_equal(got["valid"], ref["valid"])
    np.testing.assert_array_equal(got["labels"], ref["labels"])
    assert np.abs(got["boxes"] - ref["boxes"]).max() < 0.03
    assert np.abs(got["scores"] - ref["scores"]).max() < 2e-4
    lim = 0.03 + 1e-5 * np.abs(ref["rboxes"]).max(-1, keepdims=True)
    assert (np.abs(got["rboxes"] - ref["rboxes"]) <= lim).all()


@needs_reference
@pytest.mark.parametrize("robust", [False, True])
def test_h_obb_loss_matches_the_reference(models, robust):
    batch, ref = models["batch"], models["ref_loss"][robust]
    got = {k: float(x) for k, x in models["ports"][robust].loss(
        **{k: T(x) for k, x in batch.items()},
        generator=torch.Generator().manual_seed(0)).items()}
    assert set(got) == set(ref) == {"loss_rpn_cls", "loss_rpn_bbox",
                                    "loss_cls", "loss_bbox", "loss_rbbox_cls",
                                    "loss_rbbox"}
    for k in ref:
        assert abs(got[k] - ref[k]) <= 1e-4 * abs(ref[k]), (k, got[k], ref[k])
        assert got[k] > 0, k
    if robust:   # the smallest over the rolls, slot 0 among them
        plain = models["ref_loss"][False]["loss_rbbox"]
        assert got["loss_rbbox"] <= plain * (1 + 1e-6)


@needs_reference
def test_h_obb_configs_build_and_load():
    """`configs/dota_h_obb_r50_fpn_1x.py` as written and with
    hobb_robust_loss builds; `configs/dota_h_obb_robust_r18_e2e.py`
    (GroupNorm R18) builds and loads the reference's variables of it
    (shapes from `jax.eval_shape`) strictly through the bridge; a
    ConvWS backbone builds and loads through the bridge too."""
    from aidet_tpu_torch.models.backbones.resnet import GroupNorm
    from aidet_tpu_torch.utils.config import Config
    from torch_port_pairs import assert_bridge_loads
    cfg = Config.fromfile("configs/dota_h_obb_r50_fpn_1x.py")
    for robust in (False, True):
        model = build_detector(dict(cfg.model, hobb_robust_loss=robust),
                               device="cpu")
        assert model.rbbox_head.encode == "hobb"
        assert model.hobb_robust_loss is robust
    model, _ = assert_bridge_loads("configs/dota_h_obb_robust_r18_e2e.py")
    assert model.hobb_robust_loss and model.rbbox_head.encode == "hobb"
    assert isinstance(model.backbone.stem_bn, GroupNorm)
    from aidet_tpu_torch.models.plugins import ConvWS
    model = build_detector(dict(cfg.model, backbone=dict(
        type="ResNet", depth=50, conv_cfg=dict(type="ConvWS"))),
        device="cpu")
    assert isinstance(model.backbone.layer1_block0.conv1, ConvWS)
    model, _ = assert_bridge_loads("configs/mask_rcnn_r50_fpn_gn_ws_2x.py")
    assert isinstance(model.backbone.stem_conv, ConvWS)


@pytest.mark.gpu
def test_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the chip with "
                    "python -m pytest -m gpu tests/test_torch_port_hobb.py")
    import chip_smoke
    out = chip_smoke.run_detector_reference(kind="h_obb")
    assert out["max_abs_err"]["unpaired"] == 0 and out["n_valid"] > 0
    assert set(out["train"]) == {"plain", "robust"}
