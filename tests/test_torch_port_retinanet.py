"""The single-stage detectors of the PyTorch port (RetinaNet and the
rotated RetinaNetOBB) and their parts against the JAX reference on the
CPU.

Bounds (float32):
- FPN with ``start_level=1`` and extra convs (on C5, and on P5 with a
  ReLU before the second), and `RetinaHead` (cls and reg towers, reg_dim
  5): within 1e-4 of the reference's outputs;
- `sigmoid_focal_loss` and `FocalLoss` (labels and one-hot targets,
  per-anchor weights): the value within 1e-6 relative and the gradient
  within 1e-6 of `jax.grad`'s;
- `anchor_target` without sampling, with thetaobb gt_rboxes: labels,
  weights and totals equal, targets within 1e-5;
- `anchor_head_bboxes` and `anchor_head_rboxes` (hobb) on seeded head
  outputs: valid, labels and indices equal, boxes, quads and
  rboxes within 1e-3 px, scores within 1e-6;
- the small RetinaNet and RetinaNetOBB (ResNet-18, FPN P3-P7 at 64
  channels, a 2-conv RetinaHead of 5 classes, 128^2), the reference's
  weights carried over by the weight bridge with `retina_cls`'s bias
  set to 0 in both (the prior bias of -log(99) puts every random-weight score near 0.01,
  under score_thr 0.05, and predict would keep nothing): predict's
  detections paired by label (`chip_smoke.match_detections`: scores
  within 2e-4, boxes and rboxes within 0.03 px, theta within 1e-4),
  every loss within 1e-4 relative;
- `configs/dota_retinanet_theta_obb_r50_fpn_1x.py`,
  `configs/retinanet_r50_fpn_1x.py` and `configs/dota_h_obb_r50_fpn_1x.py`
  (as written, and with hobb_robust_loss) build and load the bridge's
  weights of the reference's parameter tree strictly.
The gpu-marked case runs chip_smoke's retinanet_obb_reference phase (the
small RetinaNetOBB's predict and train step on the card against the
CPU); it needs no JAX, so it runs on the card's machine alone:
python -m pytest -m gpu tests/test_torch_port_retinanet.py.
"""

import functools

import numpy as np
import pytest
import torch

from aidet_tpu_torch.convert import flax_to_state_dict
from aidet_tpu_torch.core import anchors
from aidet_tpu_torch.core.rboxes import thetaobb2pointobb
from aidet_tpu_torch.models.builder import build_detector
from aidet_tpu_torch.models.heads import anchor_head
from aidet_tpu_torch.models.heads.retina_head import RetinaHead
from aidet_tpu_torch.models.losses import FocalLoss
from aidet_tpu_torch.models.necks.fpn import FPN
from aidet_tpu_torch.ops.focal_loss import sigmoid_focal_loss
from aidet_tpu_torch.utils.config import Config
from chip_smoke import match_detections
from torch_port_helpers import load_flax, perturb_norms, to_np
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

try:
    import jax
    import jax.numpy as jnp

    from aidet_tpu.core import anchors as j_anchors
    from aidet_tpu.models import build_detector as j_build
    from aidet_tpu.models.heads import anchor_head as j_anchor_head
    from aidet_tpu.models.heads.retina_head import RetinaHead as JRetinaHead
    from aidet_tpu.models.losses.focal_loss import FocalLoss as JFocalLoss
    from aidet_tpu.models.necks.fpn import FPN as JFPN
    from aidet_tpu.ops.focal_loss import sigmoid_focal_loss as j_focal
    J = jnp.asarray
except ImportError:     # the card's machine: the gpu case runs alone
    jax = None
needs_reference = pytest.mark.skipif(jax is None,
                                     reason="needs the JAX reference")
T = torch.from_numpy
IMG = 128
STRIDES = (8, 16, 32, 64, 128)


def close(got, ref, atol=1e-4, rtol=0.0):
    np.testing.assert_allclose(to_np(got), np.asarray(ref), atol=atol,
                               rtol=rtol)


@needs_reference
@pytest.mark.parametrize("on_inputs,relu", [(True, False), (False, True)])
def test_fpn_start_level_and_extra_convs(on_inputs, relu):
    rs = np.random.RandomState(1)
    chans = (64, 128, 256, 512)
    xs = [rs.randn(2, 32 // 2 ** i, 32 // 2 ** i, c).astype(np.float32)
          for i, c in enumerate(chans)]
    kw = dict(in_channels=chans, out_channels=64, num_outs=5, start_level=1,
              add_extra_convs=True, extra_convs_on_inputs=on_inputs,
              relu_before_extra_convs=relu)
    jm = JFPN(**kw)
    v = jax.jit(jm.init)(jax.random.PRNGKey(1), [J(x) for x in xs])
    ref = jax.jit(jm.apply)(v, [J(x) for x in xs])
    tm = load_flax(FPN(**kw), v, "_neck")
    with torch.no_grad():
        out = tm([T(x) for x in xs])
    assert [o.shape[1] for o in out] == [16, 8, 4, 2, 1]
    for a, b in zip(out, ref):
        assert a.shape == b.shape
        close(a, b)


@needs_reference
def test_retina_head_outputs():
    rs = np.random.RandomState(2)
    xs = [rs.randn(2, s, s, 64).astype(np.float32) for s in (16, 8, 4, 2, 1)]
    kw = dict(num_classes=16, in_channels=64, feat_channels=64,
              stacked_convs=2, num_anchors=9, reg_dim=5)
    jm = JRetinaHead(**kw)
    v = jax.jit(jm.init)(jax.random.PRNGKey(2), [J(x) for x in xs])
    ref_cls, ref_reg = jax.jit(jm.apply)(v, [J(x) for x in xs])
    tm = load_flax(RetinaHead(**kw), v, "_head")
    with torch.no_grad():
        cls, reg = tm([T(x) for x in xs])
    for a, b in zip(cls + reg, list(ref_cls) + list(ref_reg)):
        assert a.shape == b.shape
        close(a, b)
    # the prior: -log(99) until weights are loaded over it
    np.testing.assert_allclose(to_np(RetinaHead(**kw).retina_cls.bias),
                               -np.log(99.0), rtol=1e-6)


@needs_reference
@pytest.mark.parametrize("one_hot", [False, True])
def test_focal_loss_and_its_gradient(one_hot):
    rs = np.random.RandomState(3)
    x = (3 * rs.randn(2, 50, 15)).astype(np.float32)
    labels = rs.randint(0, 16, (2, 50))
    tgt = (np.eye(16)[labels][..., 1:].astype(np.float32) if one_hot
           else labels)
    w = rs.rand(2, 50).astype(np.float32)
    close(sigmoid_focal_loss(T(x), T(tgt)), j_focal(J(x), J(tgt)),
          atol=0, rtol=1e-6)
    floss, jloss = FocalLoss(gamma=2.0, alpha=0.25), JFocalLoss()

    def j_total(xx):
        return jloss(xx, J(tgt), weight=J(w), avg_factor=7.0)
    tx = T(x).requires_grad_()
    got = floss(tx, T(tgt), weight=T(w), avg_factor=7.0)
    got.backward()
    close(got.detach(), j_total(J(x)), atol=0, rtol=1e-6)
    close(tx.grad, jax.grad(j_total)(J(x)), atol=1e-6)


def gts(seed, b=2, g=6):
    rs = np.random.RandomState(seed)
    t = np.concatenate([rs.uniform(16, IMG - 16, (b, g, 2)),
                        rs.uniform(8, 60, (b, g, 2)),
                        rs.uniform(-1.5, -0.05, (b, g, 1))], -1)
    t = t.astype(np.float32)
    p = to_np(thetaobb2pointobb(T(t)))
    boxes = np.stack([p[..., 0::2].min(-1), p[..., 1::2].min(-1),
                      p[..., 0::2].max(-1), p[..., 1::2].max(-1)], -1)
    valid = np.ones((b, g), bool)
    valid[1, -2:] = False
    return dict(gt_boxes=boxes, gt_rboxes=t, gt_valid=valid,
                gt_labels=rs.randint(1, 16, (b, g)).astype(np.int32))


@needs_reference
def test_anchor_target_every_anchor_and_rotated_targets():
    a, sizes = anchors.build_pyramid_anchors(
        IMG, STRIDES, (4, 5.0396842, 6.3496042), (0.5, 1.0, 2.0),
        base_sizes=[s // 2 for s in STRIDES])
    ja, jsizes = j_anchors.build_pyramid_anchors(
        IMG, STRIDES, base_sizes=[s // 2 for s in STRIDES],
        scales=(4, 5.0396842, 6.3496042), ratios=(0.5, 1.0, 2.0))
    assert sizes == jsizes
    np.testing.assert_array_equal(to_np(a), np.asarray(ja))
    g = gts(4)
    shapes = np.full((2, 2), float(IMG), np.float32)
    kw = dict(target_means=(0.,) * 5, target_stds=(1.,) * 5,
              allowed_border=-1, pos_iou_thr=0.5, neg_iou_thr=0.4,
              min_pos_iou=0, sampling=False, rbox_encode="thetaobb")
    ref = j_anchors.anchor_target(
        ja, J(g["gt_boxes"]), J(g["gt_valid"]), J(shapes),
        jax.random.PRNGKey(0), gt_labels=J(g["gt_labels"]),
        gt_rboxes=J(g["gt_rboxes"]), **kw)
    got = anchors.anchor_target(
        a, T(g["gt_boxes"]), T(g["gt_valid"]), T(shapes), None,
        gt_labels=T(g["gt_labels"]).long(), gt_rboxes=T(g["gt_rboxes"]),
        **kw)
    np.testing.assert_array_equal(to_np(got.labels), np.asarray(ref.labels))
    for f in ("label_weights", "bbox_weights", "num_total_pos",
              "num_total_neg"):
        np.testing.assert_array_equal(to_np(getattr(got, f)),
                                      np.asarray(getattr(ref, f)), f)
    close(got.bbox_targets, ref.bbox_targets, atol=1e-5)
    assert 0 < int(got.num_total_pos) < int(got.num_total_neg)


def head_outputs(seed, d, a_total, c=5):
    rs = np.random.RandomState(seed)
    return ((2 * rs.randn(2, a_total, c)).astype(np.float32),
            (0.3 * rs.randn(2, a_total, d)).astype(np.float32))


@needs_reference
@pytest.mark.parametrize("encode", ["hbb", "hobb"])
def test_single_stage_decodes(encode):
    """`anchor_head_bboxes` (boxes, rescaled) and `anchor_head_rboxes`
    (rotated NMS of the decoded quads; with hobbs here, whose rescale
    divides all five coordinates: the RetinaNetOBB predict below takes
    the thetaobb path)."""
    a, sizes = anchors.build_pyramid_anchors(
        IMG, STRIDES, (4, 5.0396842, 6.3496042), (0.5, 1.0, 2.0),
        base_sizes=[s // 2 for s in STRIDES])
    d = 4 if encode == "hbb" else 5
    cls, reg = head_outputs(5, d, a.shape[0])
    shapes = np.asarray([[IMG, IMG], [IMG - 8, IMG]], np.float32)
    sf = np.asarray([1.0, 0.5], np.float32)
    kw = dict(nms_pre=300, score_thr=0.3, max_per_img=40)
    if encode == "hbb":
        ref = j_anchor_head.anchor_head_bboxes(
            J(cls), J(reg), J(to_np(a)), sizes, J(shapes), nms_thr=0.5,
            rescale_factors=J(sf), **kw)
        got = anchor_head.anchor_head_bboxes(
            T(cls), T(reg), a, sizes, T(shapes), nms_thr=0.5,
            rescale_factors=T(sf), **kw)
        ref_rb = got_rb = None
    else:
        ref, ref_rb = j_anchor_head.anchor_head_rboxes(
            J(cls), J(reg), J(to_np(a)), sizes, J(shapes), encode=encode,
            nms_thr=0.1, rescale_factors=J(sf), **kw)
        got, got_rb = anchor_head.anchor_head_rboxes(
            T(cls), T(reg), a, sizes, encode=encode,
            nms_thr=0.1, rescale_factors=T(sf), **kw)
    for f in ("valid", "labels", "roi_idx"):
        np.testing.assert_array_equal(to_np(getattr(got, f)),
                                      np.asarray(getattr(ref, f)), f)
    assert to_np(got.valid).sum() > 40
    close(got.scores, ref.scores, atol=1e-6)
    close(got.boxes, ref.boxes, atol=1e-3)
    if ref_rb is not None:
        close(got_rb, ref_rb, atol=1e-3)


def small_cfg(kind):
    cfg = dict(
        type=kind,
        backbone=dict(type="ResNet", depth=18),
        neck=dict(type="FPN", in_channels=(64, 128, 256, 512),
                  out_channels=64, num_outs=5, start_level=1,
                  add_extra_convs=True),
        bbox_head=dict(type="RetinaHead", num_classes=6, in_channels=64,
                       feat_channels=64, stacked_convs=2, num_anchors=9,
                       reg_dim=5 if kind == "RetinaNetOBB" else 4),
        test_cfg=dict(nms_pre=200, score_thr=0.05, max_per_img=50,
                      rnms_thr=0.1, nms_thr=0.5),
        img_size=IMG)
    return cfg


def zero_cls_bias(v):
    """The reference's variables with `retina_cls`'s bias set to 0."""
    v = jax.tree.map(np.asarray, v)
    v["params"]["_head"]["retina_cls"]["bias"] = np.zeros_like(
        v["params"]["_head"]["retina_cls"]["bias"])
    return v


def batch():
    g = gts(7)
    rs = np.random.RandomState(8)
    return dict(imgs=rs.randint(0, 256, (2, IMG, IMG, 3)).astype(np.uint8),
                img_shapes=np.asarray([[IMG, IMG], [IMG, IMG - 16]],
                                      np.float32), **g)


@pytest.fixture(scope="module", params=["RetinaNet", "RetinaNetOBB"])
def pair(request):
    kind = request.param
    jm = j_build(small_cfg(kind))
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)))
    v = zero_cls_bias(perturb_norms(v, 3))
    sd, unmapped = flax_to_state_dict(v)
    assert not unmapped
    tm = build_detector(small_cfg(kind), device="cpu", train=True)
    tm.load_state_dict(sd, strict=True)
    tm.eval()
    b = batch()
    if kind == "RetinaNet":
        b.pop("gt_rboxes")
    ref_pred = jax.jit(functools.partial(jm.apply, method="predict"))(
        v, J(b["imgs"]), J(b["img_shapes"]))
    ref_loss = jax.jit(functools.partial(jm.apply, method="loss"))(
        v, rngs={"sampling": jax.random.PRNGKey(1)},
        **{k: J(x) for k, x in b.items()})
    return dict(kind=kind, model=tm, batch=b,
                ref_pred={k: torch.from_numpy(np.array(x))
                          for k, x in ref_pred.items()},
                ref_loss={k: float(x) for k, x in ref_loss.items()})


@needs_reference
def test_predict_matches_the_reference(pair):
    b = pair["batch"]
    got = pair["model"].predict(T(b["imgs"]), T(b["img_shapes"]))
    ref = pair["ref_pred"]
    want = {"boxes", "scores", "labels", "valid"}
    if pair["kind"] == "RetinaNetOBB":
        want.add("rboxes")
    assert set(got) == set(ref) == want
    assert int(got["valid"].sum()) == 100    # 50 an image: the NMS full
    limits = dict(boxes=0.03, scores=2e-4)
    if "rboxes" in want:
        limits.update(rboxes=0.03, theta=1e-4)
    match_detections(got, ref, limits)


@needs_reference
def test_loss_matches_the_reference(pair):
    b = pair["batch"]
    got = {k: float(x) for k, x in pair["model"].loss(
        **{k: T(x) for k, x in b.items()}).items()}
    ref = pair["ref_loss"]
    assert set(got) == set(ref) == {"loss_cls", "loss_bbox"}
    for k in ref:
        assert abs(got[k] - ref[k]) <= 1e-4 * abs(ref[k]), (k, got[k], ref[k])
        assert got[k] > 0, k


@functools.lru_cache(maxsize=None)
def reference_tree(path):
    """The shapes of the reference's variables of the config at ``path``
    (hobb_robust_loss changes the loss alone, not the tree)."""
    jm = j_build(dict(Config.fromfile(path).model))
    return jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                          jnp.zeros((1, 64, 64, 3)))


@pytest.mark.parametrize("path,extra", [
    ("configs/dota_retinanet_theta_obb_r50_fpn_1x.py", {}),
    ("configs/retinanet_r50_fpn_1x.py", {}),
    ("configs/dota_h_obb_r50_fpn_1x.py", {}),
    ("configs/dota_h_obb_r50_fpn_1x.py", dict(hobb_robust_loss=True))])
@needs_reference
def test_configs_build_and_load_the_bridges_weights(path, extra):
    """The reference's parameter tree of the config (its shapes, from
    `jax.eval_shape`, filled with seeded values) carried over by
    `flax_to_state_dict` loads strictly, the GroupNorm r18_e2e
    RetinaNetOBB's too; a PAFPN neck is not registered (ResNeXt, the
    SSD VGG backbone and the FPN_CARAFE neck, which this test named
    before they were ported, now are)."""
    cfg = Config.fromfile(path)
    model_cfg = dict(cfg.model, **extra)
    tm = build_detector(model_cfg, train_cfg=cfg.get("train_cfg"),
                        test_cfg=cfg.get("test_cfg"), device="cpu")
    shapes = reference_tree(path)
    rs = np.random.RandomState(0)
    v = jax.tree.map(lambda s: rs.randn(*s.shape).astype(np.float32),
                     shapes)
    sd, unmapped = flax_to_state_dict(v, tm)
    assert not unmapped
    tm.load_state_dict(sd, strict=True)
    key = next(k for k in sd if k.endswith("weight") and sd[k].ndim == 4)
    np.testing.assert_array_equal(to_np(tm.state_dict()[key]),
                                  to_np(sd[key]))
    if "retinanet_theta" in path:
        from torch_port_pairs import assert_bridge_loads
        gn, _ = assert_bridge_loads(
            "configs/dota_retinanet_theta_obb_r18_e2e.py")
        assert gn.neck.lateral_norm0.num_groups == 32
        assert gn.neck.extra0.bias is not None
        with pytest.raises(KeyError, match="PAFPN.*not yet ported"):
            build_detector(dict(model_cfg, neck=dict(type="PAFPN")),
                           device="cpu")
        build_detector(dict(model_cfg, neck=dict(type="FPN_CARAFE")),
                       device="meta")


def test_train_detector_takes_a_single_stage_config(tmp_path):
    """`train_detector` trains RetinaNetOBB from a config as it trains
    the two-stage models: thetaobb gts from `TrainPipeline`, a step,
    the head moved, a checkpoint written."""
    import chip_smoke
    from aidet_tpu_torch.apis.train import train_detector
    from aidet_tpu_torch.data.builder import build_dataset
    from aidet_tpu_torch.data.pipeline import TrainPipeline
    ann, prefix, _ = chip_smoke.write_patch_set(str(tmp_path), 0, 2, 256, 8,
                                                seed=0)
    cfg = Config(dict(model=chip_smoke.SMALL_RETINA_OBB))
    model = build_detector(cfg.model, device="cpu", train=True)
    before = model.bbox_head.retina_reg.weight.detach().clone()
    state = train_detector(model, build_dataset(dict(
        type="DOTADataset", ann_file=ann, img_prefix=prefix)), dict(
        batch_size=2, total_epochs=1, num_workers=1, log_interval=1,
        pipeline=TrainPipeline(img_size=256, with_rbox=True,
                               rbox_encode="thetaobb")),
        work_dir=str(tmp_path / "w"), device="cpu")
    assert state.step == 1
    assert not torch.equal(before, model.bbox_head.retina_reg.weight)
    assert (tmp_path / "w" / "ckpt").is_dir()


@pytest.mark.gpu
def test_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the chip with python -m "
                    "pytest -m gpu tests/test_torch_port_retinanet.py")
    import chip_smoke
    out = chip_smoke.run_detector_reference(kind="retinanet_obb")
    assert out["max_abs_err"]["unpaired"] == 0 and out["n_valid"] > 0
