"""The OHEM sampler of the PyTorch port against the JAX reference on the
CPU.

Bounds:
- `topk_mask_by_score` on seeded scores with ties and masked entries,
  batched, with an int and a per-row k: equal to the reference's mask
  (ties go to the lower index, masked entries never selected);
- `ohem_sample`: the reference's packing (positives by loss, then
  negatives by loss, then padding), equal on the reference's masks;
- the small thetaobb RBBoxRCNN (tests/torch_port_pairs.py) under
  ``train_cfg.rcnn.sampler="ohem"`` (32 of 104 candidates): OHEM's
  choice is deterministic given the head, so every loss is compared
  directly, within 1e-5 relative, and the step backpropagates;
- ``sampler="combined"`` (Libra R-CNN) still raises.
The gpu-marked case runs chip_smoke's ohem_reference phase (the small
model's OHEM step on the card against the CPU).
"""

import numpy as np
import pytest
import torch

from aidet_tpu_torch.core.sample import ohem_sample, topk_mask_by_score
from torch_port_helpers import to_np
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

try:
    import jax
    import jax.numpy as jnp

    from aidet_tpu.core.sample import \
        topk_mask_by_score as j_topk_mask_by_score
    from torch_port_pairs import (MAX_NUM, assert_losses_close, pair,
                                  port_loss, ref_loss, theta_batch, theta_cfg)
except ImportError:     # the card's machine: the gpu case runs alone
    jax = None
needs_reference = pytest.mark.skipif(jax is None,
                                     reason="needs the JAX reference")
T = torch.from_numpy


def scores_with_ties(seed, b=3, n=64):
    rs = np.random.RandomState(seed)
    score = rs.randint(0, 12, (b, n)).astype(np.float32) / 4   # many ties
    mask = rs.rand(b, n) > 0.3
    return score, mask


@needs_reference
@pytest.mark.parametrize("k", [0, 5, 17, 64])
def test_topk_mask_by_score_matches_the_reference(k):
    score, mask = scores_with_ties(0)
    per_row = np.asarray([k, max(k - 3, 0), min(k + 4, 64)])
    for kk in (k, T(per_row)):
        got = to_np(topk_mask_by_score(T(mask), T(score), kk))
        for i in range(len(score)):
            want = j_topk_mask_by_score(
                jnp.asarray(mask[i]), jnp.asarray(score[i]),
                kk if isinstance(kk, int) else int(per_row[i]))
            np.testing.assert_array_equal(got[i], np.asarray(want))
        assert not (got & ~mask).any()


@needs_reference
def test_ohem_sample_packs_as_the_reference():
    rs = np.random.RandomState(1)
    b, n, num = 2, 80, 24
    assigned = rs.choice([-1, 0, 0, 0, 1, 2, 3], (b, n)).astype(np.int32)
    loss = (rs.randint(0, 20, (b, n)) / 7).astype(np.float32)
    got = ohem_sample(T(assigned), T(loss), num, 0.25)
    p_max = int(num * 0.25)
    for i in range(b):
        pos = np.asarray(j_topk_mask_by_score(
            jnp.asarray(assigned[i] > 0), jnp.asarray(loss[i]), p_max))
        neg = np.asarray(j_topk_mask_by_score(
            jnp.asarray(assigned[i] == 0), jnp.asarray(loss[i]),
            num - pos.sum()))
        rank = np.where(pos, 0, np.where(neg, 1, 2)) * n + np.arange(n)
        order = np.argsort(rank, kind="stable")[:num]
        np.testing.assert_array_equal(to_np(got.inds[i]), order)
        np.testing.assert_array_equal(to_np(got.is_pos[i]), pos[order])
        np.testing.assert_array_equal(to_np(got.valid[i]),
                                      pos[order] | neg[order])
        np.testing.assert_array_equal(
            to_np(got.gt_inds[i]),
            np.where(pos[order], assigned[i][order] - 1, -1))
    assert int(got.is_pos.sum()) == 2 * p_max


def ohem_cfg():
    cfg = theta_cfg()
    cfg["train_cfg"] = dict(
        rpn=cfg["train_cfg"]["rpn"],
        rpn_proposal=dict(nms_pre=200, nms_post=MAX_NUM, max_num=MAX_NUM),
        rcnn=dict(sampler="ohem", num_samples=32))
    return cfg


@pytest.fixture(scope="module")
def ohem_pair():
    jm, v, tm = pair(ohem_cfg())
    batch = theta_batch()
    return tm, batch, ref_loss(jm, v, batch)


@needs_reference
def test_ohem_loss_matches_the_reference(ohem_pair):
    tm, batch, ref = ohem_pair
    got = port_loss(tm, batch)
    assert set(ref) == {"loss_rpn_cls", "loss_rpn_bbox", "loss_cls",
                        "loss_bbox", "loss_rbbox_cls", "loss_rbbox"}
    assert_losses_close(got, ref, 1e-5)


@needs_reference
def test_ohem_step_backpropagates_and_combined_raises(ohem_pair):
    tm, batch, _ = ohem_pair
    tm.zero_grad()
    losses = tm.loss(**{k: T(x) for k, x in batch.items()},
                     generator=torch.Generator().manual_seed(0))
    sum(losses.values()).backward()
    for name in ("bbox_head.fc_cls.weight", "rbbox_head.fc_reg.weight",
                 "neck.fpn0.weight"):
        assert tm.get_parameter(name).grad.abs().sum() > 0, name
    tm.zero_grad()
    tm.train_cfg["rcnn"]["sampler"] = "combined"
    try:
        with pytest.raises(NotImplementedError, match="combined"):
            tm.loss(**{k: T(x) for k, x in batch.items()},
                    generator=torch.Generator().manual_seed(0))
    finally:
        tm.train_cfg["rcnn"]["sampler"] = "ohem"


@pytest.mark.gpu
def test_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the chip with "
                    "python -m pytest -m gpu tests/test_torch_port_ohem.py")
    import chip_smoke
    out = chip_smoke.run_detector_reference(kind="ohem")
    assert out["max_abs_err"]["unpaired"] == 0 and out["n_valid"] > 0
    step = out["train"]["plain"]
    assert step["max_rel_err"] <= step["limits"]["losses_rel"]
