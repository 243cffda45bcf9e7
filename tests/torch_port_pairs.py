"""Small detectors of the reference and of the PyTorch port with the same
weights, shared by tests/test_torch_port_gn.py, test_torch_port_ohem.py,
test_torch_port_soft_nms.py, test_torch_port_tta.py,
test_torch_port_faster.py, test_torch_port_cascade.py,
test_torch_port_mmdet_weights.py, test_torch_port_c4.py,
test_torch_port_ga.py, test_torch_port_zoo_heads.py,
test_torch_port_libra.py and slice 15's test_torch_port_points_heads.py,
test_torch_port_retina_zoo.py, test_torch_port_ssd.py and
test_torch_port_dcn.py: the small architecture of
tests/test_models_forward.py (ResNet-18, a 64-channel FPN, 128^2), the
reference's variables with seeded norms carried over by the weight
bridge, and a seeded batch of uint8 images and thetaobb gts (or HBB
gts, with box masks and a semantic map, for the HBB family).
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from aidet_tpu.models import build_detector as j_build

from aidet_tpu_torch.convert import flax_to_state_dict
from aidet_tpu_torch.core import rboxes as tr
from aidet_tpu_torch.flagship import keep_every_candidate_cfg
from aidet_tpu_torch.models.builder import build_detector
from aidet_tpu_torch.utils.config import Config
from test_models_forward import IMG, _small_cfg
from torch_port_helpers import to_np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
G, MAX_NUM = 4, 100
GN = dict(type="GN", num_groups=32)
THETA_HEAD = dict(type="RBBoxHead", num_classes=16, in_channels=64,
                  fc_out_channels=128, encode="thetaobb")


def perturb_all_norms(variables, seed):
    """Seeded scales, biases and statistics for every FrozenBN and
    GroupNorm of flax variables (a GroupNorm's scope names end in
    "bn{i}" or "norm{i}")."""
    rng = np.random.RandomState(seed)

    def walk(tree, name=""):
        out = {}
        for k, v in tree.items():
            if hasattr(v, "items"):
                out[k] = walk(v, k)
            elif k in ("scale", "var"):
                out[k] = rng.uniform(0.5, 1.5, np.shape(v)).astype(np.float32)
            elif k == "mean" or (k == "bias" and ("bn" in name
                                                  or "norm" in name)):
                out[k] = rng.normal(0, 0.1, np.shape(v)).astype(np.float32)
            else:
                out[k] = np.asarray(v)
        return out
    return walk(variables)


def theta_cfg(gn=False, **extra):
    """The small thetaobb RBBoxRCNN (with ``gn`` its ResNet-18 and FPN in
    GroupNorm, the r18_e2e recipe at 64 channels), under a train_cfg
    that keeps every candidate unless ``extra`` sets another."""
    cfg = _small_cfg(rbbox_head=THETA_HEAD)
    if gn:
        cfg["backbone"] = dict(cfg["backbone"], norm_cfg=GN)
        cfg["neck"] = dict(cfg["neck"], norm_cfg=GN)
    cfg["train_cfg"] = dict(
        keep_every_candidate_cfg(IMG, G, MAX_NUM),
        rpn_proposal=dict(nms_pre=200, nms_post=MAX_NUM, max_num=MAX_NUM))
    cfg.update(extra)
    return dict(type="RBBoxRCNN", **cfg)


def theta_batch(seed=6):
    rs = np.random.RandomState(seed)
    t = np.concatenate([rs.uniform(20, IMG - 20, (2, G, 2)),
                        rs.uniform(8, 40, (2, G, 2)),
                        rs.uniform(-1.5, -0.05, (2, G, 1))],
                       -1).astype(np.float32)
    p = to_np(tr.thetaobb2pointobb(torch.from_numpy(t)))
    return dict(
        imgs=rs.randint(0, 256, (2, IMG, IMG, 3)).astype(np.uint8),
        gt_boxes=np.concatenate([p[..., 0::2].min(-1, keepdims=True),
                                 p[..., 1::2].min(-1, keepdims=True),
                                 p[..., 0::2].max(-1, keepdims=True),
                                 p[..., 1::2].max(-1, keepdims=True)], -1),
        gt_rboxes=t,
        gt_valid=np.asarray([[True] * G, [True] * (G - 1) + [False]]),
        gt_labels=rs.randint(1, 16, (2, G)).astype(np.int32),
        img_shapes=np.asarray([[IMG, IMG], [IMG, IMG - 16]], np.float32))


def pair(cfg, seed=0):
    """(reference module, its variables, the port's model in eval mode
    with the same weights) of the detector config ``cfg``."""
    jm = j_build(cfg)
    v = jax.jit(jm.init)(jax.random.PRNGKey(seed),
                         jnp.zeros((1, cfg["img_size"], cfg["img_size"], 3)))
    v = perturb_all_norms(v, 9)
    sd, unmapped = flax_to_state_dict(v)
    assert not unmapped
    tm = build_detector(cfg, device="cpu", train=True)
    tm.load_state_dict(sd, strict=True)
    return jm, v, tm.eval()


def ref_predict(jm, v, batch):
    out = jax.jit(functools.partial(jm.apply, method="predict"))(
        v, jnp.asarray(batch["imgs"]), jnp.asarray(batch["img_shapes"]))
    return {k: np.asarray(x) for k, x in out.items()}


def ref_loss(jm, v, batch):
    out = jax.jit(functools.partial(jm.apply, method="loss"))(
        v, rngs={"sampling": jax.random.PRNGKey(1)},
        **{k: jnp.asarray(x) for k, x in batch.items()})
    return {k: float(x) for k, x in out.items()}


def port_predict(tm, batch):
    return {k: to_np(x) for k, x in tm.predict(
        torch.from_numpy(batch["imgs"]),
        torch.from_numpy(batch["img_shapes"])).items()}


def port_loss(tm, batch):
    return {k: float(x.detach()) for k, x in tm.loss(
        **{k: torch.from_numpy(x) for k, x in batch.items()},
        generator=torch.Generator().manual_seed(0)).items()}


def assert_losses_close(got, ref, rel):
    assert set(got) == set(ref)
    for k in ref:
        assert abs(got[k] - ref[k]) <= rel * abs(ref[k]), (k, got[k], ref[k])
        assert got[k] > 0, k


@functools.lru_cache(maxsize=None)
def reference_tree(path):
    """The shapes of the reference's variables of the config at ``path``
    (relative to the repo)."""
    jm = j_build(dict(Config.fromfile(os.path.join(REPO, path)).model))
    return jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                          jnp.zeros((1, 64, 64, 3)))


def assert_bridge_loads(path):
    """The reference's variables of the config at ``path`` (its shapes,
    filled with seeded values) load strictly into the port's build of
    it through `flax_to_state_dict`, nothing unmapped.  Returns (model,
    state_dict)."""
    cfg = Config.fromfile(os.path.join(REPO, path))
    tm = build_detector(dict(cfg.model), train_cfg=cfg.get("train_cfg"),
                        test_cfg=cfg.get("test_cfg"), device="cpu")
    rs = np.random.RandomState(0)
    v = jax.tree.map(lambda s: np.asarray(rs.randn(*s.shape), np.float32),
                     reference_tree(path))
    sd, unmapped = flax_to_state_dict(v, tm)
    assert not unmapped
    tm.load_state_dict(sd, strict=True)
    return tm, sd


# the HBB family (FasterRCNN, RPN, the cascades): proposals capped so
# that each image keeps at most 50 valid ones (10 a level after NMS) in
# its 64 rows, so that every cascade stage's valid candidates (the gts,
# then the previous stage's sample, up to 4 x 4 + 50 in HTC's last
# interleaved mask sample) fit in the 4 + 64 samples: every stage
# keeps all its candidates, in candidate order, whatever the random
# stream
HBB_MAX_NUM = 64
HBB_TRAIN_CFG = dict(
    keep_every_candidate_cfg(IMG, G, HBB_MAX_NUM),
    rpn_proposal=dict(nms_pre=16, nms_post=10, max_num=HBB_MAX_NUM))
SMALL_MASK_HEAD = dict(num_convs=2, in_channels=64, conv_out_channels=64,
                       num_classes=16)
SMALL_SEMANTIC_HEAD = dict(type="FusedSemanticHead", num_ins=5,
                           fusion_level=1, in_channels=64,
                           conv_out_channels=64, num_classes=16)


def hbb_cfg(type_name="FasterRCNN", **extra):
    """The small HBB detector ``type_name`` under `HBB_TRAIN_CFG`; an RPN
    without its bbox head, its test_cfg its rpn's alone."""
    cfg = _small_cfg(train_cfg=HBB_TRAIN_CFG)
    if type_name == "RPN":
        del cfg["bbox_head"]
        cfg["test_cfg"] = dict(rpn=cfg["test_cfg"]["rpn"])
    cfg.update(extra)
    return dict(type=type_name, **cfg)


def hbb_batch(seed=6, masks=False, semantic=False):
    """Two seeded uint8 images with G gt boxes each (the second image's
    last invalid), labels 1..15; with ``masks`` each gt's box filled in
    a [G, IMG, IMG] mask, with ``semantic`` a seeded [IMG / 4]^2 map of
    classes 0..15 with an ignored (255) band."""
    rs = np.random.RandomState(seed)
    xy = rs.uniform(4, IMG - 60, (2, G, 2))
    boxes = np.concatenate([xy, xy + rs.uniform(16, 56, (2, G, 2))], -1)
    out = dict(
        imgs=rs.randint(0, 256, (2, IMG, IMG, 3)).astype(np.uint8),
        gt_boxes=boxes.astype(np.float32),
        gt_valid=np.asarray([[True] * G, [True] * (G - 1) + [False]]),
        gt_labels=rs.randint(1, 16, (2, G)).astype(np.int32),
        img_shapes=np.asarray([[IMG, IMG], [IMG, IMG - 16]], np.float32))
    if masks:
        yy, xx = np.mgrid[:IMG, :IMG]
        b = boxes[..., None, None]
        out["gt_masks"] = ((xx >= b[:, :, 0]) & (xx <= b[:, :, 2])
                           & (yy >= b[:, :, 1]) & (yy <= b[:, :, 3])
                           ).astype(np.float32)
    if semantic:
        sem = rs.randint(0, 16, (2, IMG // 4, IMG // 4))
        sem[:, :3] = 255
        out["gt_semantic"] = sem.astype(np.int32)
    return out


def shaped_variables(jm, seed=0, img=IMG):
    """Seeded variables of the reference module ``jm`` from the shapes
    of its init on an ``img``^2 input (`jax.eval_shape`, a trace without
    a compile): kernels ~ N(0, 1 / fan_in), as its initializer, other
    leaves 0 (scales and variances 1), then every norm
    seeded as `perturb_all_norms` does."""
    tree = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                          jnp.zeros((1, img, img, 3)))
    rs = np.random.RandomState(seed)

    def fill(path, s):
        name = getattr(path[-1], "key", "")
        # a layer's "kernel", or one a module declares itself
        # ("adapt_kernel", "deconv1_kernel")
        if name.endswith("kernel"):
            fan_in = int(np.prod(s.shape[:-1]))
            return (rs.randn(*s.shape) / np.sqrt(fan_in)).astype(np.float32)
        return np.full(s.shape, 1.0 if name in ("scale", "var") else 0.0,
                       np.float32)
    v = jax.tree_util.tree_map_with_path(fill, tree)
    return perturb_all_norms(v, seed + 9)


def shaped_pair(cfg, seed=0):
    """`pair` with the reference's variables from `shaped_variables`
    (no compile of its init)."""
    jm = j_build(cfg)
    v = shaped_variables(jm, seed)
    sd, unmapped = flax_to_state_dict(v)
    assert not unmapped, unmapped
    tm = build_detector(cfg, device="cpu", train=True)
    tm.load_state_dict(sd, strict=True)
    return jm, v, tm.eval()


def ref_loss_and_grads(jm, v, batch):
    """The reference's losses and the gradient of their sum, mapped to
    the port's parameter names by the weight bridge."""
    jb = {k: jnp.asarray(x) for k, x in batch.items()}

    def total(params):
        losses = jm.apply(dict(v, params=params), method="loss",
                          rngs={"sampling": jax.random.PRNGKey(1)}, **jb)
        return sum(jax.tree.leaves(losses)), losses

    (_, losses), grads = jax.jit(jax.value_and_grad(total, has_aux=True))(
        v["params"])
    return ({k: float(x) for k, x in losses.items()},
            flax_to_state_dict({"params": grads})[0])


def port_loss_and_grads(tm, batch):
    """The port's losses and the gradient of their sum by parameter."""
    losses = tm.loss(**{k: torch.from_numpy(x) for k, x in batch.items()},
                     generator=torch.Generator().manual_seed(0))
    names, params = zip(*tm.named_parameters())
    grads = torch.autograd.grad(sum(losses.values()), params,
                                allow_unused=True)
    return ({k: float(x.detach()) for k, x in losses.items()},
            dict(zip(names, grads)))


def assert_grads_close(got, ref, rel=1e-3):
    """Every gradient leaf within ``rel`` of the leaf's largest magnitude
    (a leaf without a gradient on one side is zero on the other)."""
    assert set(ref) <= set(got), set(ref) - set(got)
    for k, r in ref.items():
        r = to_np(r)
        g = np.zeros_like(r) if got[k] is None else to_np(got[k])
        scale = max(np.abs(r).max(), 1e-12)
        assert np.abs(g - r).max() <= rel * scale, (
            k, np.abs(g - r).max() / scale)


# the C4 detectors (slice 14): ResNet-18's first 3 stages (caffe style),
# no neck, the RPN on C4 at stride 16 with 2 scales, crops of 14 through
# ResNet-18's res5 (512 channels, 7x7) into an average-pooled box head;
# one level gives up to 60 proposals, so that the 4 gts and them fill
# the 64 samples of a train_cfg that keeps every candidate
C4_SMALL = dict(
    backbone=dict(type="ResNet", depth=18, num_stages=3, out_indices=(2,),
                  style="caffe"),
    neck=dict(type="Identity"),
    shared_head=dict(type="ResLayer", depth=18, stage=3, stride=2,
                     style="caffe"),
    rpn_head=dict(type="RPNHead", in_channels=256, feat_channels=64,
                  num_anchors=6),
    bbox_head=dict(type="BBoxHead", with_avg_pool=True, num_classes=16,
                   in_channels=512, roi_feat_size=7),
    strides=(16,), anchor_scales=(4, 8))
C4_MAX_NUM = 60
C4_TRAIN_CFG = dict(
    keep_every_candidate_cfg(IMG, G, C4_MAX_NUM),
    rpn_proposal=dict(nms_pre=C4_MAX_NUM, nms_post=C4_MAX_NUM,
                      max_num=C4_MAX_NUM))


def c4_cfg(type_name="FasterRCNN", **extra):
    """`hbb_cfg` of the small C4 detector ``type_name`` under
    `C4_TRAIN_CFG` (an RPN without its shared and box heads)."""
    cfg = hbb_cfg(type_name, **dict(C4_SMALL, train_cfg=C4_TRAIN_CFG))
    if type_name == "RPN":
        del cfg["shared_head"], cfg["bbox_head"]
    cfg.update(extra)
    return cfg


def assert_pairs(got, ref, limits):
    """Every detection of ``got`` equal to ``ref``'s in valid and labels,
    each other key of ``limits`` within its bound, some valid."""
    assert got["valid"].sum() > 0
    np.testing.assert_array_equal(got["valid"], ref["valid"])
    np.testing.assert_array_equal(got["labels"], ref["labels"])
    for k, lim in limits.items():
        assert np.abs(got[k] - ref[k]).max() <= lim, (
            k, np.abs(got[k] - ref[k]).max())


def seeded_variables(jm, *args, seed=0):
    """Variables of the reference module ``jm`` from the shapes of its
    init on ``args``: every kernel (a layer's, or one the module declares
    itself) ~ N(0, 1 / fan_in), every other leaf ~ N(0, 0.1)."""
    tree = jax.eval_shape(jm.init, jax.random.PRNGKey(0), *args)
    rs = np.random.RandomState(seed)

    def fill(path, s):
        if getattr(path[-1], "key", "").endswith("kernel"):
            fan_in = int(np.prod(s.shape[:-1]))
            return (rs.randn(*s.shape) / np.sqrt(fan_in)).astype(np.float32)
        return np.asarray(0.1 * rs.randn(*s.shape), np.float32)
    return jax.tree_util.tree_map_with_path(fill, tree)


# the single-stage zoo (slice 15): ResNet-18, a 64-channel FPN P3-P7
# with its extra levels by convs on P5, a dense head of 64 channels and
# one tower conv, 16 classes, 128^2 images
DENSE_NECK = dict(type="FPN", in_channels=(64, 128, 256, 512),
                  out_channels=64, num_outs=5, start_level=1,
                  add_extra_convs=True, extra_convs_on_inputs=False)


def dense_cfg(type_name, head, **extra):
    """The small ``type_name`` detector with the head config ``head`` (its
    type and own keywords) at 64 channels."""
    cfg = dict(type=type_name, backbone=dict(type="ResNet", depth=18),
               neck=dict(DENSE_NECK),
               bbox_head=dict(dict(num_classes=16, in_channels=64,
                                   feat_channels=64, stacked_convs=1),
                              **head),
               img_size=IMG)
    cfg.update(extra)
    return cfg


def dense_variables(jm, seed=0, img=IMG):
    """`shaped_variables`, then the leaves it would leave at 0 that scale a
    whole map set to values near the reference's initial ones: the FCOS
    and ATSS heads' per-level ``scale{l}`` in [0.8, 1.2], SepBN's per-level
    norms (scales in [0.5, 1.5], biases N(0, 0.1)), SSD's L2Norm ``gamma``
    in [16, 24], RepPoints' ``moment_transfer`` N(0, 0.2)."""
    import re
    v = shaped_variables(jm, seed, img)
    rs = np.random.RandomState(seed + 1)

    def fix(tree):
        for k, x in tree.items():
            if hasattr(x, "items"):
                fix(x)
            elif re.fullmatch(r"scale\d+", k):
                tree[k] = rs.uniform(0.8, 1.2, np.shape(x)).astype(np.float32)
            elif re.fullmatch(r"\w+_bn_l\d+_\d+_scale", k):
                tree[k] = rs.uniform(0.5, 1.5, np.shape(x)).astype(np.float32)
            elif re.fullmatch(r"\w+_bn_l\d+_\d+_bias", k):
                tree[k] = rs.normal(0, 0.1, np.shape(x)).astype(np.float32)
            elif k == "gamma":
                tree[k] = rs.uniform(16, 24, np.shape(x)).astype(np.float32)
            elif k == "moment_transfer":
                tree[k] = rs.normal(0, 0.2, np.shape(x)).astype(np.float32)
    fix(v)
    return v


def dense_pair(cfg, seed=0, img=IMG):
    """`shaped_pair` with `dense_variables`."""
    jm = j_build(cfg)
    v = dense_variables(jm, seed, img)
    sd, unmapped = flax_to_state_dict(v)
    assert not unmapped, unmapped
    tm = build_detector(cfg, device="cpu", train=True)
    tm.load_state_dict(sd, strict=True)
    return jm, v, tm.eval()


def dense_batch(seed=6, img=IMG, n_gt=G, boxes=None):
    """Two images of zero-mean float32 noise (the anchor-free detectors
    and SSD read their images as they are: floats keep flax's and torch's
    GroupNorm within their bounds) with ``n_gt`` gts each (the second
    image's last invalid; ``boxes`` [2, n_gt, 4] replaces the seeded
    ones), labels 1..15."""
    rs = np.random.RandomState(seed)
    if boxes is None:
        xy = rs.uniform(4, img - img * 0.45, (2, n_gt, 2))
        boxes = np.concatenate(
            [xy, xy + rs.uniform(img / 8, img * 0.43, (2, n_gt, 2))], -1)
    return dict(
        imgs=rs.randn(2, img, img, 3).astype(np.float32),
        gt_boxes=np.asarray(boxes, np.float32),
        gt_valid=np.asarray([[True] * n_gt, [True] * (n_gt - 1) + [False]]),
        gt_labels=rs.randint(1, 16, (2, n_gt)).astype(np.int32),
        img_shapes=np.asarray([[img, img], [img, img - 16]], np.float32))


def assert_matched(got, ref, limits):
    """Every valid detection of ``got`` paired with one of ``ref`` of the
    same image and label, scores and boxes within ``limits``, in any
    order (`chip_smoke.match_detections`: random weights give scores a
    rounding apart, which the two runs may rank either way); some
    valid."""
    import chip_smoke

    def t(d):
        return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}
    assert got["valid"].sum() > 0
    errs = chip_smoke.match_detections(t(got), t(ref), limits)
    assert errs["unpaired"] == 0, errs
    return errs
