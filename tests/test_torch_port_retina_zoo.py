"""RetinaNet's zoo in the PyTorch port against the JAX reference on the
CPU: `RetinaSepBNHead` (convs shared, norms per level), the GHMC and
GHMR losses, FreeAnchor's `free_anchor_loss` (anchors whose IoUs with a
gt tie), `GARetinaHead` on its train and masked test paths, NAS-FPN's
`MergingCell` and `NASFPN`, and the small GA-RetinaNet (masked
predict), FreeAnchorRetinaNet, RetinaNet with the SepBN head, with GHMC
and GHMR, and with NAS-FPN and the SepBN head, whole: predict and one
loss.

The reference registers its NASFPN only once its module is imported
(its `necks/__init__` does not import it): this module imports
`aidet_tpu.models.necks.nas_fpn` on the reference's side.  The
detectors are tests/torch_port_pairs.py's `dense_cfg` (ResNet-18, a
64-channel FPN P3-P7, one tower conv of 64 channels, 16 classes, 128^2
images of zero-mean noise), the reference's variables from
`dense_variables`; GA-RetinaNet's offset conv is seeded (its kernel,
as every kernel, N(0, 1 / fan_in)) and its shape kernel at the
reference's initial N(0, 0.01).

Bounds, float32: heads' and necks' outputs within 1e-5 of their largest
magnitude; the losses of the loss functions within 1e-5 relative and
their gradients within 1e-4 of the largest; detections paired (valid
and labels equal, boxes within 1e-2 px, scores within 1e-4, in any
order); each loss within 1e-4 relative.  The gpu-marked case runs
chip_smoke's reference phases of these families (the card against the
CPU).
"""

import numpy as np
import pytest
import torch

from aidet_tpu_torch.models.heads.free_anchor import free_anchor_loss
from aidet_tpu_torch.models.losses import GHMC, GHMR
from torch_port_helpers import to_np
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

try:
    import jax
    import jax.numpy as jnp

    import aidet_tpu.models.necks.nas_fpn as j_nas
    from aidet_tpu.core.anchors import build_pyramid_anchors as j_anchors
    from aidet_tpu.models import losses as j_losses
    from aidet_tpu.models.heads.free_anchor import \
        free_anchor_loss as j_free_anchor_loss
    from aidet_tpu.models.heads.guided_anchor_head import \
        GARetinaHead as JGARetinaHead
    from aidet_tpu.models.heads.retina_head import \
        RetinaSepBNHead as JRetinaSepBNHead
    from aidet_tpu_torch.convert import flax_to_state_dict
    from aidet_tpu_torch.models.heads.guided_anchor_head import GARetinaHead
    from aidet_tpu_torch.models.heads.retina_head import RetinaSepBNHead
    from aidet_tpu_torch.models.necks.nas_fpn import NASFPN
    from torch_port_helpers import load_flax
    from torch_port_pairs import (DENSE_NECK, assert_losses_close,
                                  assert_matched, dense_batch, dense_cfg,
                                  dense_pair, port_loss, port_predict,
                                  ref_loss, ref_predict, seeded_variables)
except ImportError:     # the card's machine: the gpu case runs alone
    jax = None
needs_reference = pytest.mark.skipif(jax is None,
                                     reason="needs the JAX reference")
T = torch.from_numpy
DET_LIMITS = dict(boxes=1e-2, scores=1e-4)


def assert_close(got, ref, rel=1e-5):
    got, ref = to_np(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert np.abs(got - ref).max() <= rel * max(np.abs(ref).max(), 1e-12)


def pyramid(seed, c=16, sizes=(16, 8, 4, 2, 1), b=2):
    rs = np.random.RandomState(seed)
    return [rs.randn(b, s, s, c).astype(np.float32) for s in sizes]


@needs_reference
def test_sepbn_head_matches_the_reference():
    """Five levels through shared convs and per-level norms (their scales
    and biases seeded)."""
    kw = dict(num_classes=5, num_ins=5, in_channels=16, feat_channels=16,
              stacked_convs=2, num_anchors=3)
    jm = JRetinaSepBNHead(**kw)
    feats = pyramid(1)
    jf = [jnp.asarray(f) for f in feats]
    v = seeded_variables(jm, jf)
    tm = load_flax(RetinaSepBNHead(**kw), v, "_head")
    ref = jax.jit(jm.apply)(v, jf)
    with torch.no_grad():
        got = tm([T(f) for f in feats])
    for g_lvls, r_lvls in zip(got, ref):
        for g, r in zip(g_lvls, r_lvls):
            assert_close(g, r)


@needs_reference
@pytest.mark.parametrize("name", ["GHMC", "GHMR"])
def test_ghm_losses_match_the_reference(name):
    """Both on a batch of anchors with weights 0 (ignored) and 1, their
    gradients too; the bins' density is the batch's (momentum unread)."""
    rs = np.random.RandomState(2)
    pred = rs.normal(0, 2, (2, 60, 5 if name == "GHMC" else 4))
    pred = pred.astype(np.float32)
    if name == "GHMC":
        target = rs.randint(0, 6, (2, 60)).astype(np.int32)
        weight = (rs.uniform(0, 1, (2, 60)) > 0.2).astype(np.float32)
        kw = dict(bins=30, momentum=0.75)
    else:
        target = rs.normal(0, 0.3, pred.shape).astype(np.float32)
        weight = (rs.uniform(0, 1, pred.shape) > 0.5).astype(np.float32)
        kw = dict(mu=0.02, bins=10, momentum=0.7, loss_weight=10.0)
    got_fn = dict(GHMC=GHMC, GHMR=GHMR)[name](**kw)
    ref_fn = getattr(j_losses, name)(**kw)
    p = T(pred).requires_grad_()
    got = got_fn(p, T(target), weight=T(weight), avg_factor=3.0)
    ref = ref_fn(jnp.asarray(pred), jnp.asarray(target),
                 weight=jnp.asarray(weight), avg_factor=3.0)
    assert abs(float(got.detach()) - float(ref)) <= 1e-5 * abs(float(ref))
    g, = torch.autograd.grad(got, p)
    rg = jax.grad(lambda x: ref_fn(x, jnp.asarray(target),
                                   weight=jnp.asarray(weight)))(
        jnp.asarray(pred))
    assert_close(g, rg, 1e-4)


@needs_reference
def test_free_anchor_loss_matches_the_reference():
    """Two images of 128^2 anchors (9 a location, P3-P7), gts of which one
    sits on the anchor grid (its bag holds anchors of tied IoU), the
    second image's last gt invalid; both bag losses and their
    gradients."""
    strides = (8, 16, 32, 64, 128)
    anchors, _ = j_anchors(128, strides,
                           base_sizes=[s // 2 for s in strides],
                           scales=(4, 5.0396842, 6.3496042),
                           ratios=(0.5, 1.0, 2.0))
    a = np.array(anchors)
    rs = np.random.RandomState(3)
    cls = rs.normal(-2, 1, (2, a.shape[0], 7)).astype(np.float32)
    box = rs.normal(0, 0.3, (2, a.shape[0], 4)).astype(np.float32)
    xy = rs.uniform(0, 70, (2, 4, 2))
    gt = np.concatenate([xy, xy + rs.uniform(10, 56, (2, 4, 2))], -1)
    gt[0, 0] = a[2000]                      # an anchor itself
    gt = gt.astype(np.float32)
    valid = np.asarray([[True] * 4, [True] * 3 + [False]])
    labels = rs.randint(1, 8, (2, 4)).astype(np.int32)
    stds = (0.1, 0.1, 0.2, 0.2)
    tc, tb = T(cls).requires_grad_(), T(box).requires_grad_()
    got = free_anchor_loss(tc, tb, T(a), T(gt), T(valid), T(labels),
                           target_stds=stds)
    grads = torch.autograd.grad(sum(got.values()), (tc, tb))

    def ref_fn(c, b):
        return j_free_anchor_loss(c, b, anchors, jnp.asarray(gt),
                                  jnp.asarray(valid), jnp.asarray(labels),
                                  num_classes=7, target_stds=stds)
    ref = jax.jit(ref_fn)(jnp.asarray(cls), jnp.asarray(box))
    for k, r in ref.items():
        assert abs(float(got[k].detach()) - float(r)) <= 1e-5 * abs(float(r))
    rg = jax.jit(jax.grad(lambda c, b: sum(ref_fn(c, b).values()),
                          argnums=(0, 1)))(jnp.asarray(cls), jnp.asarray(box))
    for g, r in zip(grads, rg):
        assert_close(g, r, 1e-4)


@needs_reference
def test_ga_retina_head_matches_the_reference():
    """Both paths of the head on a three-level pyramid with seeded offsets
    and adaption kernels; the location prior near the filter's
    threshold, so that the masked path keeps some points and drops
    others."""
    kw = dict(num_classes=5, in_channels=16, feat_channels=16,
              stacked_convs=2)
    jm = JGARetinaHead(**kw)
    feats = pyramid(4, sizes=(12, 6, 3))
    jf = [jnp.asarray(f) for f in feats]
    v = seeded_variables(jm, jf)
    v["params"]["conv_loc"]["bias"] = np.full((1,), -4.6, np.float32)
    tm = load_flax(GARetinaHead(**kw), v, "_head")
    for masked in (False, True):
        ref = jax.jit(lambda vv, ff, m=masked: jm.apply(vv, ff, masked=m))(
            v, jf)
        with torch.no_grad():
            got = tm([T(f) for f in feats], masked=masked)
        for g_lvls, r_lvls in zip(got, ref):
            for g, r in zip(g_lvls, r_lvls):
                assert_close(g, r)
        if masked:
            assert 0 < float((got[0][0] == 0).float().mean()) < 1


@needs_reference
def test_nas_fpn_matches_the_reference():
    """Two stacks over C3-C5 of a 64^2 input (its P7 1x1, the cells'
    nearest resizes both ways)."""
    kw = dict(in_channels=(8, 16, 32, 64), out_channels=16, num_outs=5,
              stack_times=2, start_level=1)
    jm = j_nas.NASFPN(**kw)
    rs = np.random.RandomState(5)
    feats = [rs.randn(2, 64 // s, 64 // s, c).astype(np.float32)
             for s, c in zip((4, 8, 16, 32), (8, 16, 32, 64))]
    jf = tuple(jnp.asarray(f) for f in feats)
    v = seeded_variables(jm, jf)
    tm = load_flax(NASFPN(**kw), v, "_neck")
    ref = jax.jit(jm.apply)(v, jf)
    with torch.no_grad():
        got = tm([T(f) for f in feats])
    assert [g.shape[1] for g in got] == [8, 4, 2, 1, 1]
    for g, r in zip(got, ref):
        assert_close(g, r)


SEPBN = dict(type="RetinaSepBNHead", num_ins=5, num_anchors=9)
RETINA = dict(type="RetinaHead", num_anchors=9)


def retina_neck():
    """RetinaNet's FPN: P6 from C5."""
    return dict(DENSE_NECK, extra_convs_on_inputs=True)


DETECTORS = dict(
    ga_retina=lambda: dense_cfg("GARetinaNet", dict(type="GARetinaHead"),
                                neck=retina_neck()),
    free_anchor=lambda: dense_cfg(
        "FreeAnchorRetinaNet", RETINA, neck=retina_neck(),
        free_anchor_cfg=dict(pre_anchor_topk=20, bbox_thr=0.6)),
    sepbn=lambda: dense_cfg("RetinaNet", SEPBN, neck=retina_neck()),
    ghm=lambda: dense_cfg(
        "RetinaNet", RETINA, neck=retina_neck(),
        loss_cls=dict(type="GHMC", bins=30, momentum=0.75,
                      use_sigmoid=True, loss_weight=1.0),
        loss_bbox=dict(type="GHMR", mu=0.02, bins=10, momentum=0.7,
                       loss_weight=10.0)),
    nasfpn=lambda: dense_cfg(
        "RetinaNet", SEPBN, neck=dict(
            type="NASFPN", in_channels=(64, 128, 256, 512), out_channels=64,
            num_outs=5, stack_times=2, start_level=1)))


def ga_shape_small(jm, v, tm):
    """The GA head's shape kernel at the reference's initial N(0, 0.01):
    guided anchors near their base size, so that some match the gts."""
    shape = v["params"]["_head"]["conv_shape"]
    shape["kernel"] = (0.01 * np.random.RandomState(7).randn(
        *shape["kernel"].shape)).astype(np.float32)
    tm.load_state_dict(flax_to_state_dict(v)[0], strict=True)


@needs_reference
@pytest.mark.parametrize("kind", sorted(DETECTORS))
def test_detector_matches_the_reference(kind):
    jm, v, tm = dense_pair(DETECTORS[kind]())
    if kind == "ga_retina":
        ga_shape_small(jm, v, tm)
    batch = dense_batch()
    assert_matched(port_predict(tm, batch), ref_predict(jm, v, batch),
                   DET_LIMITS)
    got = port_loss(tm, batch)
    if kind == "free_anchor":
        assert set(got) == {"positive_bag_loss", "negative_bag_loss"}
    assert_losses_close(got, ref_loss(jm, v, batch), 1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["ga_retina", "free_anchor", "sepbn_ghm",
                                  "nasfpn"])
def test_card_matches_cpu(kind):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the chip with python -m "
                    "pytest -m gpu tests/test_torch_port_retina_zoo.py")
    import chip_smoke
    out = chip_smoke.run_hbb_reference(kind=kind)
    assert out["max_abs_err"]["unpaired"] == 0 and out["n_valid"] > 0
