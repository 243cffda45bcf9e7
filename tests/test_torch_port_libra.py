"""Libra R-CNN in the PyTorch port against the JAX reference on the CPU:
the balanced feature pyramid (`BFP`), the balanced L1 loss and its
place in the single-stage detectors (libra_retinanet), the combined
sampler (instance-balanced positives, IoU-balanced negatives) held by
its properties, and the small Libra Faster R-CNN whole (FPN then BFP,
the combined sampler; predict and loss).

The combined sampler draws from the generator the caller passes, and
JAX's random streams cannot be reproduced, so it is held to the
reference's counts and rules; where every candidate is kept (the
detector's `HBB_TRAIN_CFG`) its sample is the same set in the same
order on both sides, and the detector's losses are step-locked.  The
detector is tests/torch_port_pairs.py's small architecture (ResNet-18,
a 64-channel FPN and BFP, 128^2 images, 16 classes) with the
reference's seeded variables carried over by the weight bridge.

Bounds, float32: BFP's maps within 1e-5 of their largest magnitude; the
balanced L1 within 1e-6 relative; detections' valid and labels equal,
boxes within 1e-2 px, scores within 1e-4; each loss within 1e-4
relative.  The gpu-marked case runs chip_smoke's hbb_reference phase
for Libra R-CNN (the card against the CPU).
"""

import os

import numpy as np
import pytest
import torch

from aidet_tpu_torch.core.sample import (instance_balanced_pos_masks,
                                         iou_balanced_neg_masks,
                                         sample_fixed_combined)
from aidet_tpu_torch.models.builder import build
from aidet_tpu_torch.models.losses import BalancedL1Loss
from aidet_tpu_torch.models.necks.bfp import BFP
from aidet_tpu_torch.models.registry import DETECTORS
from aidet_tpu_torch.utils.config import Config
from torch_port_helpers import to_np
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

try:
    import jax
    import jax.numpy as jnp

    from aidet_tpu.models.losses.balanced_l1_loss import \
        BalancedL1Loss as JBalancedL1Loss
    from aidet_tpu.models.necks.bfp import BFP as JBFP
    from torch_port_helpers import load_flax
    from torch_port_pairs import (assert_losses_close, assert_pairs,
                                  hbb_batch, hbb_cfg, port_loss,
                                  port_predict, ref_loss, ref_predict,
                                  seeded_variables, shaped_pair)
except ImportError:     # the card's machine: the gpu case runs alone
    jax = None
needs_reference = pytest.mark.skipif(jax is None,
                                     reason="needs the JAX reference")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = torch.from_numpy
SMALL_FPN = dict(type="FPN", in_channels=(64, 128, 256, 512),
                 out_channels=64, num_outs=5)


@needs_reference
@pytest.mark.parametrize("refine_level", [1, 2])
def test_bfp_matches_the_reference(refine_level):
    """Five levels of a 128^2 pyramid (32^2 .. 2^2) gathered at level
    ``refine_level``'s size by nearest neighbour, refined and scattered
    back."""
    rs = np.random.RandomState(refine_level)
    xs = [rs.randn(2, 32 // 2 ** i, 32 // 2 ** i, 16).astype(np.float32)
          for i in range(5)]
    jm = JBFP(in_channels=16, num_levels=5, refine_level=refine_level)
    jx = tuple(jnp.asarray(x) for x in xs)
    v = seeded_variables(jm, jx)
    tm = load_flax(BFP(in_channels=16, refine_level=refine_level), v,
                   "_neck")
    ref = jax.jit(jm.apply)(v, jx)
    with torch.no_grad():
        got = tm(tuple(T(x) for x in xs))
    for g, r in zip(got, ref):
        r = np.asarray(r)
        assert np.abs(to_np(g) - r).max() <= 1e-5 * np.abs(r).max()


@needs_reference
def test_balanced_l1_matches_the_reference():
    """libra_retinanet's loss (alpha 0.5, gamma 1.5, beta 0.11) on both
    sides of beta, weighted and averaged."""
    rs = np.random.RandomState(3)
    pred = rs.randn(50, 4).astype(np.float32) * 0.3
    target = rs.randn(50, 4).astype(np.float32) * 0.3
    weight = (rs.uniform(0, 1, (50, 4)) > 0.3).astype(np.float32)
    kw = dict(alpha=0.5, gamma=1.5, beta=0.11, loss_weight=1.0)
    got = BalancedL1Loss(**kw)(T(pred), T(target), weight=T(weight),
                               avg_factor=17.0)
    ref = JBalancedL1Loss(**kw)(jnp.asarray(pred), jnp.asarray(target),
                                weight=jnp.asarray(weight), avg_factor=17.0)
    assert abs(float(got) - float(ref)) <= 1e-6 * abs(float(ref))


def test_libra_retinanet_builds_with_balanced_l1():
    cfg = Config.fromfile(os.path.join(REPO, "configs",
                                       "libra_retinanet_r50_fpn_1x.py"))
    with torch.device("meta"):
        model = build(dict(cfg.model), DETECTORS,
                      dict(train_cfg=cfg.get("train_cfg"),
                           test_cfg=cfg.get("test_cfg")))
    loss = model.bbox_loss
    assert isinstance(loss, BalancedL1Loss)
    assert (loss.alpha, loss.gamma, loss.beta) == (0.5, 1.5, 0.11)
    assert isinstance(model.neck[1], BFP) and model.neck[1].refine_level == 1


def sampler_case(seed=0, n=400, gts=4):
    """Seeded assignments [2, n] (-1 ignored, 0 negative, 1..gts) with
    their best IoUs (positives above 0.5, negatives spread over [0,
    0.5))."""
    rs = np.random.RandomState(seed)
    assigned = rs.choice(np.arange(-1, gts + 1), (2, n),
                         p=[0.05, 0.75] + [0.2 / gts] * gts)
    iou = np.where(assigned > 0, rs.uniform(0.5, 1, (2, n)),
                   rs.uniform(0, 0.5, (2, n)))
    return T(assigned), T(iou.astype(np.float32))


def test_instance_balanced_positives():
    """Up to max(num // gts, 1) positives of each gt, the shortfall from
    the others, never more than num, only positives; with room for all,
    all."""
    assigned, _ = sampler_case()
    gen = torch.Generator().manual_seed(0)
    pos = instance_balanced_pos_masks(assigned, 20, 4, gen)
    assert (pos.sum(-1) == 20).all() and not (pos & (assigned <= 0)).any()
    per_gt = torch.stack([(pos & (assigned == g)).sum(-1)
                          for g in range(1, 5)], -1)
    avail = torch.stack([(assigned == g).sum(-1) for g in range(1, 5)], -1)
    assert (per_gt >= torch.minimum(avail, torch.tensor(5))).all()
    every = instance_balanced_pos_masks(assigned, 400, 4, gen)
    assert torch.equal(every, assigned > 0)


def test_iou_balanced_negatives():
    """int(num / 3) negatives from each of the bins [0, 1/6), [1/6,
    1/3), [1/3, 1/2) where they have that many, the shortfall from the
    rest, num in all; only negatives."""
    assigned, iou = sampler_case(1)
    gen = torch.Generator().manual_seed(1)
    num = torch.tensor([60, 30])
    neg = iou_balanced_neg_masks(assigned, iou, num, gen)
    assert torch.equal(neg.sum(-1), num)
    assert not (neg & (assigned != 0)).any()
    for lo in (0.0, 1 / 6, 1 / 3):
        in_bin = (assigned == 0) & (iou >= lo) & (iou < lo + 1 / 6)
        got = (neg & in_bin).sum(-1)
        assert (got >= torch.minimum(in_bin.sum(-1), num // 3)).all()


def test_combined_sample_layout():
    """The fixed-size sample: positives first, then negatives, then
    padding; every candidate kept, in candidate order, when num holds
    them all."""
    assigned, iou = sampler_case(2, n=40)
    gen = torch.Generator().manual_seed(2)
    s = sample_fixed_combined(assigned, iou, 16, 0.25, gen, num_gts=4)
    assert s.inds.shape == (2, 16)
    assert (s.is_pos.sum(-1) <= 4).all() and s.valid.all()
    first_neg = (~s.is_pos).int().argmax(-1)
    assert all(not s.is_pos[b, first_neg[b]:].any() for b in range(2))
    every = sample_fixed_combined(assigned, iou, 40, 1.0, gen, num_gts=4)
    keep = assigned >= 0
    for b in range(2):
        pos = (assigned[b] > 0).nonzero().flatten()
        neg = (assigned[b] == 0).nonzero().flatten()
        assert torch.equal(every.inds[b, :int(keep[b].sum())],
                           torch.cat([pos, neg]))


@pytest.fixture(scope="module")
def libra():
    cfg = hbb_cfg("FasterRCNN", neck=[SMALL_FPN, dict(type="BFP",
                                                       in_channels=64,
                                                       num_levels=5)])
    cfg["train_cfg"] = dict(cfg["train_cfg"], rcnn=dict(
        cfg["train_cfg"]["rcnn"], sampler="combined"))
    jm, v, tm = shaped_pair(cfg)
    return jm, v, tm, hbb_batch()


@needs_reference
def test_libra_faster_rcnn_predict_matches_the_reference(libra):
    jm, v, tm, batch = libra
    assert_pairs(port_predict(tm, batch), ref_predict(jm, v, batch),
                 dict(boxes=1e-2, scores=1e-4))


@needs_reference
def test_libra_faster_rcnn_loss_matches_the_reference(libra):
    jm, v, tm, batch = libra
    assert_losses_close(port_loss(tm, batch), ref_loss(jm, v, batch), 1e-4)


@pytest.mark.gpu
def test_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the chip with "
                    "python -m pytest -m gpu tests/test_torch_port_libra.py")
    import chip_smoke
    out = chip_smoke.run_hbb_reference(kind="libra")
    assert out["max_abs_err"]["unpaired"] == 0 and out["n_valid"] > 0
