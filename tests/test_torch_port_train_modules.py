"""Modules of the train step in the PyTorch port against the JAX
reference, in float32 on the CPU: losses, box encoding and overlaps,
MaxIoU assignment, the samplers, anchor and RoI targets, the heads'
losses, the ResNet's frozen stages and the learning-rate schedule.

Tolerances: atol 1e-5 (rtol 1e-5) on float outputs, which both sides
compute in float32 with the same formulas; exact for labels, indices
and masks.  The samplers draw from different random streams (JAX's
threefry against a torch.Generator), so they are held by their
properties, and by equality where every candidate is kept.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aidet_tpu.core import anchors as j_anchors
from aidet_tpu.core import assign as j_assign
from aidet_tpu.core import boxes as j_boxes
from aidet_tpu.core import sample as j_sample
from aidet_tpu.core import targets as j_targets
from aidet_tpu.models.backbones.resnet import ResNet as JResNet
from aidet_tpu.models.heads import anchor_head as j_anchor_head
from aidet_tpu.models.heads import bbox_head as j_bbox_head
from aidet_tpu.parallel import train as j_train

from aidet_tpu_torch.core import anchors, assign, boxes, sample, targets
from aidet_tpu_torch.models import losses
from aidet_tpu_torch.models.backbones.resnet import ResNet
from aidet_tpu_torch.models.heads import anchor_head, bbox_head
from aidet_tpu_torch.parallel import train
from torch_port_helpers import load_flax, perturb_norms, to_np
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

# modules whose names the losses package rebinds to functions
j_ce = importlib.import_module("aidet_tpu.models.losses.cross_entropy_loss")
j_sl1 = importlib.import_module("aidet_tpu.models.losses.smooth_l1_loss")
j_loss_utils = importlib.import_module("aidet_tpu.models.losses.utils")

ATOL = 1e-5


def close(got, ref, atol=ATOL, rtol=1e-5):
    np.testing.assert_allclose(to_np(got), np.asarray(ref), atol=atol,
                               rtol=rtol)


def t(x):
    return torch.from_numpy(np.array(x))


def random_boxes(rs, shape, img=128.0, lo=2.0, hi=60.0):
    xy = rs.uniform(-10, img - 20, shape + (2,))
    wh = rs.uniform(lo, hi, shape + (2,))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def gen(seed=0):
    return torch.Generator().manual_seed(seed)


# ---------------------------------------------------------------- losses

@pytest.mark.parametrize("weighted,reduction,avg", [
    (False, "mean", None), (True, "mean", None), (True, "sum", None),
    (True, "none", None), (True, "mean", 7.0), (False, "none", 3.0)])
def test_weight_reduce_loss(weighted, reduction, avg):
    rs = np.random.RandomState(0)
    loss = rs.rand(5, 3).astype(np.float32)
    w = rs.rand(5, 3).astype(np.float32) if weighted else None
    got = losses.weight_reduce_loss(t(loss), None if w is None else t(w),
                                    reduction, avg)
    ref = j_loss_utils.weight_reduce_loss(
        jnp.asarray(loss), None if w is None else jnp.asarray(w),
        reduction, avg)
    close(got, ref)


@pytest.mark.parametrize("sigmoid", [False, True])
def test_cross_entropy(sigmoid):
    """Softmax CE over C + 1 logits, and sigmoid BCE over C logits with
    integer labels expanded to one-hot (label 0 sets no channel), with
    a per-sample weight and an avg_factor, and the loss classes."""
    rs = np.random.RandomState(1)
    c = 4 if sigmoid else 5
    pred = (3 * rs.randn(2, 30, c)).astype(np.float32)
    label = rs.randint(0, 5, (2, 30)).astype(np.int32)
    w = rs.rand(2, 30).astype(np.float32)
    fn = losses.binary_cross_entropy if sigmoid else losses.cross_entropy
    j_fn = j_ce.binary_cross_entropy if sigmoid else j_ce.cross_entropy
    close(fn(t(pred), t(label), t(w), avg_factor=13.0),
          j_fn(jnp.asarray(pred), jnp.asarray(label), jnp.asarray(w),
               avg_factor=13.0))
    close(fn(t(pred), t(label)), j_fn(jnp.asarray(pred), jnp.asarray(label)))
    got = losses.CrossEntropyLoss(use_sigmoid=sigmoid, loss_weight=0.5)(
        t(pred), t(label), t(w), avg_factor=13.0)
    ref = j_ce.CrossEntropyLoss(use_sigmoid=sigmoid, loss_weight=0.5)(
        jnp.asarray(pred), jnp.asarray(label), jnp.asarray(w),
        avg_factor=13.0)
    close(got, ref)


def test_binary_cross_entropy_same_shape_labels():
    rs = np.random.RandomState(2)
    pred = (4 * rs.randn(40, 3)).astype(np.float32)
    label = (rs.rand(40, 3) > 0.5).astype(np.float32)
    close(losses.binary_cross_entropy(t(pred), t(label), reduction="none"),
          j_ce.binary_cross_entropy(jnp.asarray(pred), jnp.asarray(label),
                                    reduction="none"))


@pytest.mark.parametrize("beta", [1.0 / 9.0, 1.0])
def test_smooth_l1(beta):
    rs = np.random.RandomState(3)
    pred = rs.randn(50, 4).astype(np.float32)
    tgt = rs.randn(50, 4).astype(np.float32)
    w = (rs.rand(50, 4) > 0.3).astype(np.float32)
    got = losses.SmoothL1Loss(beta=beta)(t(pred), t(tgt), t(w),
                                         avg_factor=9.0)
    ref = j_sl1.SmoothL1Loss(beta=beta)(jnp.asarray(pred), jnp.asarray(tgt),
                                        jnp.asarray(w), avg_factor=9.0)
    close(got, ref)
    close(losses.SmoothL1Loss(beta=beta)(t(pred), t(tgt),
                                         reduction_override="none"),
          j_sl1.SmoothL1Loss(beta=beta)(jnp.asarray(pred), jnp.asarray(tgt),
                                        reduction_override="none"))


# ------------------------------------------------------------------ boxes

def test_bbox2delta():
    rs = np.random.RandomState(4)
    p, g = random_boxes(rs, (3, 20)), random_boxes(rs, (3, 20))
    means, stds = (0.1, -0.1, 0.0, 0.2), (0.1, 0.1, 0.2, 0.2)
    close(boxes.bbox2delta(t(p), t(g), means, stds),
          j_boxes.bbox2delta(jnp.asarray(p), jnp.asarray(g), means, stds))


@pytest.mark.parametrize("mode,aligned", [("iou", False), ("iof", False),
                                          ("iou", True)])
def test_bbox_overlaps(mode, aligned):
    rs = np.random.RandomState(5)
    a = random_boxes(rs, (2, 7))
    b = random_boxes(rs, (2, 7 if aligned else 11))
    b[0, 0] = a[0, 0]                      # an exact match
    b[0, 1] = [200, 200, 150, 150]         # degenerate: no overlap
    close(boxes.bbox_overlaps(t(a), t(b), mode, aligned),
          j_boxes.bbox_overlaps(jnp.asarray(a), jnp.asarray(b), mode,
                                aligned))


# ------------------------------------------------------------- assignment

def assign_case(seed):
    """Candidates that match some gts closely, two identical gts (the
    later must win its claims), padding gts and invalid candidates."""
    rs = np.random.RandomState(seed)
    gt = random_boxes(rs, (2, 6), lo=10)
    gt[:, 5] = gt[:, 4]
    cand = random_boxes(rs, (2, 40), lo=10)
    cand[:, :6] = gt + rs.uniform(-2, 2, gt.shape).astype(np.float32)
    gt_valid = np.ones((2, 6), bool)
    gt_valid[1, 2] = False
    box_valid = rs.rand(2, 40) > 0.1
    labels = rs.randint(1, 16, (2, 6)).astype(np.int32)
    return gt, cand, gt_valid, box_valid, labels


@pytest.mark.parametrize("with_labels,with_valid,neg,assign_all", [
    (False, True, 0.3, True), (True, False, 0.5, True),
    (True, True, (0.1, 0.4), True), (True, True, 0.3, False)])
def test_max_iou_assign(with_labels, with_valid, neg, assign_all):
    gt, cand, gt_valid, box_valid, labels = assign_case(6)
    kw = dict(pos_iou_thr=0.6, neg_iou_thr=neg, min_pos_iou=0.2,
              gt_max_assign_all=assign_all)
    got = assign.max_iou_assign(
        t(cand), t(gt), t(gt_valid), t(labels) if with_labels else None,
        box_valid=t(box_valid) if with_valid else None, **kw)
    ref = jax.vmap(lambda c, g, gv, lb, bv: j_assign.max_iou_assign(
        c, g, gv, lb if with_labels else None,
        box_valid=bv if with_valid else None, **kw))(
            jnp.asarray(cand), jnp.asarray(gt), jnp.asarray(gt_valid),
            jnp.asarray(labels), jnp.asarray(box_valid))
    for a, b in zip(got, ref):
        assert a.shape == b.shape
    np.testing.assert_array_equal(to_np(got.gt_inds), np.asarray(ref.gt_inds))
    np.testing.assert_array_equal(to_np(got.labels), np.asarray(ref.labels))
    close(got.max_overlaps, ref.max_overlaps)


# --------------------------------------------------------------- sampling

def test_random_topk_mask_properties():
    rs = np.random.RandomState(7)
    mask = t(rs.rand(3, 500) > 0.6)
    k = torch.tensor([10, 1000, 0])
    got = sample.random_topk_mask(mask, k, gen(0))
    assert not (got & ~mask).any()
    counts = got.sum(-1)
    assert counts.tolist() == [10, int(mask[1].sum()), 0]
    assert torch.equal(got, sample.random_topk_mask(mask, k, gen(0)))
    assert not torch.equal(got, sample.random_topk_mask(mask, k, gen(1)))
    # uniform: over many draws every candidate is picked about as often
    hits = sum(sample.random_topk_mask(mask[0], 50, gen(s)).float()
               for s in range(200))
    frac = hits[mask[0]] / 200
    assert abs(float(frac.mean()) - 50 / float(mask[0].sum())) < 0.01
    assert float(frac.min()) > 0.0


@pytest.mark.parametrize("num,pos_fraction,neg_pos_ub", [
    (64, 0.5, -1.0), (32, 0.25, 2.0), (400, 0.5, -1.0)])
def test_random_sample_masks_properties(num, pos_fraction, neg_pos_ub):
    rs = np.random.RandomState(8)
    assigned = t(rs.choice([-1, 0, 0, 0, 1, 2], (2, 300)).astype(np.int32))
    sm = sample.random_sample_masks(assigned, num, pos_fraction, gen(3),
                                    neg_pos_ub)
    n_pos_cand = (assigned > 0).sum(-1)
    n_neg_cand = (assigned == 0).sum(-1)
    want_pos = torch.clamp(n_pos_cand, max=int(num * pos_fraction))
    assert torch.equal(sm.num_pos, want_pos)
    want_neg = num - want_pos
    if neg_pos_ub >= 0:
        want_neg = torch.minimum(want_neg,
                                 (neg_pos_ub * want_pos.clamp(min=1)).long())
    assert torch.equal(sm.num_neg, torch.minimum(want_neg, n_neg_cand))
    assert torch.equal(sm.pos.sum(-1), sm.num_pos)
    assert not (sm.pos & (assigned <= 0)).any()
    assert not (sm.neg & (assigned != 0)).any()


def test_sample_fixed_properties():
    rs = np.random.RandomState(9)
    assigned = t(rs.choice([-1, 0, 0, 1, 3], (2, 80)).astype(np.int32))
    fs = sample.sample_fixed(assigned, 32, 0.25, gen(4))
    assert fs.inds.shape == (2, 32)
    n_pos = fs.is_pos.sum(-1)
    assert torch.equal(n_pos, torch.clamp((assigned > 0).sum(-1), max=8))
    a = torch.gather(assigned, 1, fs.inds)
    for i in range(2):
        p = int(n_pos[i])
        assert fs.is_pos[i, :p].all() and not fs.is_pos[i, p:].any()
        assert (a[i, :p] > 0).all()
        assert fs.valid[i].all()            # enough negatives to fill
        assert (a[i, p:] == 0).all()
        assert len(set(fs.inds[i].tolist())) == 32
    assert torch.equal(fs.gt_inds, torch.where(fs.is_pos, a.long() - 1, -1))
    again = sample.sample_fixed(assigned, 32, 0.25, gen(4))
    assert all(torch.equal(x, y) for x, y in zip(fs, again))


def test_sample_fixed_keeping_everything_matches_reference():
    """num = N and pos_fraction 1: every positive and negative is kept,
    in candidate order, then the ignored ones as padding, as in the
    reference whatever its random stream."""
    rs = np.random.RandomState(10)
    assigned = rs.choice([-1, 0, 1, 2], (2, 50)).astype(np.int32)
    got = sample.sample_fixed(t(assigned), 50, 1.0, gen(5))
    ref = jax.vmap(lambda k, a: j_sample.sample_fixed(k, a, 50, 1.0))(
        jax.random.split(jax.random.PRNGKey(0), 2), jnp.asarray(assigned))
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(to_np(a), np.asarray(b))


# ---------------------------------------------------------------- targets

RPN_KW = dict(pos_iou_thr=0.7, neg_iou_thr=0.3, min_pos_iou=0.3,
              pos_fraction=0.5, target_stds=(1.0, 1.0, 1.0, 1.0))


def rpn_case(seed, img=128):
    """Anchors of 32, 64 and 128 px on a 128^2 image (many of them
    across its border), five gts of 8 to 48 px, one of them padding."""
    a, _ = j_anchors.build_pyramid_anchors(img, (4, 8, 16))
    rs = np.random.RandomState(seed)
    gt = random_boxes(rs, (2, 5), img=img, lo=8, hi=48)
    gt_valid = np.ones((2, 5), bool)
    gt_valid[0, 4] = False
    shapes = np.asarray([[img, img], [img - 10, img - 20]], np.float32)
    return np.asarray(a), gt, gt_valid, shapes


@pytest.mark.parametrize("allowed_border", [0.0, -1.0])
def test_anchor_target_keeping_everything_matches_reference(allowed_border):
    anc, gt, gt_valid, shapes = rpn_case(11)
    kw = dict(RPN_KW, num_samples=2 * len(anc),
              allowed_border=allowed_border)
    got = anchors.anchor_target(t(anc), t(gt), t(gt_valid), t(shapes),
                                gen(0), **kw)
    ref = j_anchors.anchor_target(jnp.asarray(anc), jnp.asarray(gt),
                                  jnp.asarray(gt_valid), jnp.asarray(shapes),
                                  jax.random.PRNGKey(0), **kw)
    assert int((got.labels > 0).sum()) > 10
    assert int((got.label_weights > 0).sum()) > 1000
    np.testing.assert_array_equal(to_np(got.labels), np.asarray(ref.labels))
    for a, b in zip(got[1:], ref[1:]):
        close(a, b)


def test_anchor_target_sampling_properties():
    anc, gt, gt_valid, shapes = rpn_case(12)
    tg = anchors.anchor_target(t(anc), t(gt), t(gt_valid), t(shapes),
                               gen(1), num_samples=64, **RPN_KW)
    pos = tg.labels > 0
    neg = (tg.label_weights > 0) & ~pos
    assert (pos.sum(-1) <= 32).all()
    assert torch.equal((pos | neg).sum(-1), torch.full((2,), 64))
    assert torch.equal(tg.bbox_weights[..., 0] > 0, pos)
    assert (tg.bbox_targets[~pos] == 0).all()
    # nothing sampled outside the image (allowed_border 0)
    a = t(anc)
    outside = ((a[:, 2] >= t(shapes)[:, 1:2]) | (a[:, 3] >= t(shapes)[:, 0:1])
               | (a[:, 0] < 0) | (a[:, 1] < 0))
    assert not (tg.label_weights[outside] > 0).any()
    assert int(tg.num_total_pos) == int(pos.sum(-1).clamp(min=1).sum())


def fixed_sample(seed, r=12, g=5, n_cand=30):
    rs = np.random.RandomState(seed)
    is_pos = np.zeros((2, r), bool)
    is_pos[:, :4] = True
    valid = np.ones((2, r), bool)
    valid[1, -3:] = False
    gt_inds = np.where(is_pos, rs.randint(0, g, (2, r)), -1)
    inds = np.stack([rs.permutation(n_cand)[:r] for _ in range(2)])
    return inds, is_pos, valid, gt_inds


@pytest.mark.parametrize("kind", ["bbox", "rbbox"])
def test_roi_targets(kind):
    rs = np.random.RandomState(13)
    fields = fixed_sample(13)
    rois = random_boxes(rs, (2, 12), lo=10)
    gt = random_boxes(rs, (2, 5), lo=10)
    if kind == "rbbox":
        wh = rs.uniform(5, 50, (2, 5, 2))
        theta = rs.uniform(-1.5, -0.01, (2, 5, 1))
        gt = np.concatenate([gt[..., :2] + 20, wh, theta],
                            -1).astype(np.float32)
    labels = rs.randint(1, 16, (2, 5)).astype(np.int32)
    ts = sample.FixedSample(*(t(x) for x in fields))
    js = j_sample.FixedSample(*(jnp.asarray(x) for x in fields))
    if kind == "bbox":
        got = targets.bbox_target(ts, t(rois), t(gt), t(labels),
                                  pos_weight=2.0)
        ref = jax.vmap(lambda s, ro, g, gl: j_targets.bbox_target(
            s, ro, g, gl, pos_weight=2.0))(js, jnp.asarray(rois),
                                           jnp.asarray(gt),
                                           jnp.asarray(labels))
    else:
        got = targets.rbbox_target(ts, t(rois), t(gt), t(labels))
        ref = jax.vmap(lambda s, ro, g, gl: j_targets.rbbox_target(
            s, ro, g, gl, "thetaobb"))(js, jnp.asarray(rois),
                                       jnp.asarray(gt), jnp.asarray(labels))
    np.testing.assert_array_equal(to_np(got.labels), np.asarray(ref.labels))
    for a, b in zip(got[1:], ref[1:]):
        close(a, b)


# ------------------------------------------------------------ head losses

def test_anchor_head_loss_keeping_everything_matches_reference():
    anc, gt, gt_valid, shapes = rpn_case(14)
    rs = np.random.RandomState(14)
    cls = (2 * rs.randn(2, len(anc), 1)).astype(np.float32)
    reg = rs.randn(2, len(anc), 4).astype(np.float32)
    assigner = dict(pos_iou_thr=0.7, neg_iou_thr=0.3, min_pos_iou=0.3)
    sampler = dict(num_samples=2 * len(anc), pos_fraction=0.5,
                   neg_pos_ub=-1)
    got = anchor_head.anchor_head_loss(
        t(cls), t(reg), t(anc), t(gt), t(gt_valid), t(shapes), gen(0),
        cls_loss=losses.CrossEntropyLoss(use_sigmoid=True),
        bbox_loss=losses.SmoothL1Loss(beta=1.0 / 9.0),
        assigner_cfg=assigner, sampler_cfg=sampler)
    ref = j_anchor_head.anchor_head_loss(
        jnp.asarray(cls), jnp.asarray(reg), jnp.asarray(anc),
        jnp.asarray(gt), jnp.asarray(gt_valid), jnp.asarray(shapes),
        jax.random.PRNGKey(0),
        cls_loss=j_ce.CrossEntropyLoss(use_sigmoid=True),
        bbox_loss=j_sl1.SmoothL1Loss(beta=1.0 / 9.0),
        assigner_cfg=assigner, sampler_cfg=sampler, use_sigmoid_cls=True)
    assert set(got) == set(ref)
    for k in ref:
        close(got[k], ref[k])


@pytest.mark.parametrize("box_dim", [4, 5])
def test_bbox_head_loss(box_dim):
    rs = np.random.RandomState(15)
    n, c = 24, 16
    cls = (2 * rs.randn(n, c)).astype(np.float32)
    pred = rs.randn(n, c * box_dim).astype(np.float32)
    labels = np.where(rs.rand(n) > 0.6, rs.randint(1, c, n), 0)
    lw = (rs.rand(n) > 0.1).astype(np.float32)
    pos = (labels > 0).astype(np.float32)
    tg = (rs.randn(n, box_dim) * pos[:, None]).astype(np.float32)
    bw = np.repeat(pos[:, None], box_dim, 1)
    fields = (labels.astype(np.int32), lw, tg, bw)
    got = bbox_head.bbox_head_loss(
        t(cls), t(pred), targets.RoiTargets(*(t(x) for x in fields)),
        losses.CrossEntropyLoss(), losses.SmoothL1Loss(), box_dim=box_dim)
    ref = j_bbox_head.bbox_head_loss(
        jnp.asarray(cls), jnp.asarray(pred),
        j_targets.RoiTargets(*(jnp.asarray(x) for x in fields)),
        j_ce.CrossEntropyLoss(), j_sl1.SmoothL1Loss(), c, box_dim=box_dim)
    for a, b in zip(got, ref):
        close(a, b)


# --------------------------------------------------- backbone and schedule

def test_resnet_frozen_stages_gradients():
    """frozen_stages=1: the stem's and the first stage's parameters get
    no gradient (zero in the reference), the others the reference's
    gradient (atol 1e-4 over the leaf's largest magnitude)."""
    x = np.random.RandomState(16).randn(1, 32, 32, 3).astype(np.float32)
    jm = JResNet(depth=18)
    v = perturb_norms(jax.jit(jm.init)(jax.random.PRNGKey(0),
                                       jnp.asarray(x)), 16)

    def j_loss(params):
        outs = jm.apply({"params": params, "batch_stats": v["batch_stats"]},
                        jnp.asarray(x))
        return sum((o ** 2).mean() for o in outs)

    j_grads = jax.jit(jax.grad(j_loss))(v["params"])
    tm = load_flax(ResNet(depth=18), v, "_backbone")
    params = dict(tm.named_parameters())
    total = sum((o ** 2).mean() for o in tm(t(x)))
    grads = torch.autograd.grad(total, list(params.values()),
                                allow_unused=True)
    ref = load_flax(ResNet(depth=18), {"params": j_grads,
                                       "batch_stats": v["batch_stats"]},
                    "_backbone").state_dict()
    for (name, _), g in zip(params.items(), grads):
        frozen = name.startswith(("stem_", "layer1_"))
        assert (g is None) == frozen, name
        r = to_np(ref[name])
        if frozen:
            assert not r.any(), name
        else:
            scale = max(float(np.abs(r).max()), 1e-12)
            close(g / scale, r / scale, atol=1e-4, rtol=0)


def test_lr_schedule_matches_reference():
    kw = dict(base_lr=0.02, warmup_iters=500, warmup_ratio=1.0 / 3.0,
              decay_steps=(8, 11), iters_per_epoch=1000)
    got = train.build_lr_schedule(**kw)
    ref = j_train.build_lr_schedule(**kw)
    for step in (0, 1, 2, 250, 499, 500, 7999, 8000, 10999, 11000, 20000):
        np.testing.assert_allclose(got(step), float(ref(jnp.int32(step))),
                                   rtol=1e-6)
    assert got(0) == pytest.approx(0.02 / 3)
