"""Soft-NMS of the PyTorch port against the JAX reference on the CPU.

Bounds:
- `soft_nms` in its three methods (linear, gaussian, naive) on seeded
  boxes with clusters of overlaps and tied scores, several problems at
  once: the same keep mask, decayed scores within 1e-6;
- `multiclass_nms(nms_type="soft_nms")` with and without
  ``pre_nms_top_k``: the same labels, roi provenance and valid, boxes
  equal, decayed scores within 1e-6; rotated candidates raise as in
  the reference;
- `nms_cfg_kwargs` parses a soft-NMS test_cfg as the reference does;
- the small CenterMap-Net (tests/torch_port_mask_models.py) under
  ``test_cfg.rcnn.nms=dict(type="soft_nms")``: predict's valid, labels
  equal, boxes within 1e-2 px, decayed scores within 1e-4 and masks
  within 1e-3 of the reference's.
The gpu-marked case runs chip_smoke's soft_nms_reference phase (the
small CenterMap-Net under soft-NMS on the card against the CPU).
"""

import numpy as np
import pytest
import torch

from aidet_tpu_torch.ops.nms import multiclass_nms, nms_cfg_kwargs, soft_nms
from torch_port_helpers import to_np
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

try:
    import jax
    import jax.numpy as jnp

    import importlib
    j_nms = importlib.import_module("aidet_tpu.ops.nms")
    from torch_port_mask_models import run_pair
except ImportError:     # the card's machine: the gpu case runs alone
    jax = None
needs_reference = pytest.mark.skipif(jax is None,
                                     reason="needs the JAX reference")
T = torch.from_numpy
SOFT = dict(type="soft_nms", iou_thr=0.3, method="gaussian", sigma=0.4,
            min_score=0.05)


def boxes_and_scores(seed, p=3, n=48):
    """[p, n, 4] boxes in clusters (many overlaps), [p, n] scores with
    ties, and a validity mask."""
    rs = np.random.RandomState(seed)
    centres = rs.uniform(20, 200, (p, 6, 2))
    c = centres[:, rs.randint(0, 6, n)] + rs.normal(0, 6, (p, n, 2))
    wh = rs.uniform(10, 40, (p, n, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    scores = rs.uniform(0.01, 1, (p, n)).astype(np.float32)
    scores[:, 5] = scores[:, 3]          # ties: the first index wins
    valid = rs.rand(p, n) > 0.1
    return boxes, scores, valid


@needs_reference
@pytest.mark.parametrize("method", ["linear", "gaussian", "naive"])
def test_soft_nms_matches_the_reference(method):
    boxes, scores, valid = boxes_and_scores(0)
    s, keep = soft_nms(T(boxes), T(scores), 0.3, method, 0.5, 0.05,
                       T(valid))
    assert s.shape == keep.shape == scores.shape
    for i in range(len(boxes)):
        rs, rk = j_nms.soft_nms(jnp.asarray(boxes[i]), jnp.asarray(scores[i]),
                                0.3, method, 0.5, 0.05,
                                jnp.asarray(valid[i]))
        np.testing.assert_array_equal(to_np(keep[i]), np.asarray(rk))
        np.testing.assert_allclose(to_np(s[i]), np.asarray(rs), atol=1e-6,
                                   rtol=0)
    kept = to_np(keep)
    assert 0 < kept.sum() < valid.sum()
    if method != "naive":    # decayed scores below their originals
        assert (to_np(s)[kept] < scores[kept] - 1e-6).any()


@needs_reference
@pytest.mark.parametrize("pre_nms_top_k", [0, 16])
def test_multiclass_soft_nms_matches_the_reference(pre_nms_top_k):
    rs = np.random.RandomState(1)
    n, c = 40, 4
    boxes, _, valid = boxes_and_scores(2, p=1, n=n)
    per_class = np.concatenate(
        [boxes[0] + rs.normal(0, 2, (n, 4)) for _ in range(c + 1)],
        -1).astype(np.float32)
    probs = rs.dirichlet(np.ones(c + 1) * 0.3, n).astype(np.float32)
    kw = nms_cfg_kwargs(dict(nms=SOFT))
    got = multiclass_nms(T(per_class), T(probs), 0.02, max_num=30,
                         valid=T(valid[0]), pre_nms_top_k=pre_nms_top_k, **kw)
    ref = j_nms.multiclass_nms(jnp.asarray(per_class), jnp.asarray(probs),
                               0.02, max_num=30, valid=jnp.asarray(valid[0]),
                               pre_nms_top_k=pre_nms_top_k,
                               **j_nms.nms_cfg_kwargs(dict(nms=SOFT)))
    for k in ("valid", "labels", "roi_idx"):
        np.testing.assert_array_equal(to_np(getattr(got, k)),
                                      np.asarray(getattr(ref, k)), err_msg=k)
    np.testing.assert_array_equal(to_np(got.boxes), np.asarray(ref.boxes))
    np.testing.assert_allclose(to_np(got.scores), np.asarray(ref.scores),
                               atol=1e-6, rtol=0)
    assert 0 < int(got.valid.sum()) <= 30
    with pytest.raises(ValueError, match="horizontal"):
        multiclass_nms(torch.zeros(n, 8), T(probs), 0.05, box_dim=8, **kw)


@needs_reference
def test_nms_cfg_kwargs_parse_soft_nms():
    for cfg in (dict(nms=dict(type="soft_nms")), dict(nms=SOFT),
                dict(nms_thr=0.4, nms=dict(type="soft_nms", method="naive"))):
        assert nms_cfg_kwargs(cfg) == j_nms.nms_cfg_kwargs(cfg)
    assert nms_cfg_kwargs(dict(nms=SOFT)) == dict(
        iou_thr=0.3, nms_type="soft_nms", soft_method="gaussian",
        sigma=0.4, min_score=0.05)
    with pytest.raises(ValueError, match="method"):
        soft_nms(torch.zeros(2, 4), torch.ones(2), method="cubic")


@pytest.fixture(scope="module")
def centermap_pair():
    return run_pair("CenterMapNet", test_cfg=dict(
        rpn=dict(nms_pre=200, nms_post=100, max_num=100),
        rcnn=dict(max_per_img=20, nms=dict(type="soft_nms"))),
        loss=False)


@needs_reference
def test_centermap_net_predicts_under_soft_nms(centermap_pair):
    """The mask branch runs on the soft-NMS keeps through their roi
    provenance, with the decayed scores."""
    _, ref, got, _, _ = centermap_pair
    assert set(got) == set(ref) == {"boxes", "scores", "labels", "valid",
                                    "masks"}
    assert got["valid"].sum() > 0
    np.testing.assert_array_equal(got["valid"], ref["valid"])
    np.testing.assert_array_equal(got["labels"], ref["labels"])
    assert np.abs(got["boxes"] - ref["boxes"]).max() < 1e-2
    assert np.abs(got["scores"] - ref["scores"]).max() < 1e-4
    assert np.abs(got["masks"] - ref["masks"]).max() < 1e-3


@pytest.mark.gpu
def test_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the chip with python -m "
                    "pytest -m gpu tests/test_torch_port_soft_nms.py")
    import chip_smoke
    out = chip_smoke.run_soft_nms_reference()
    assert out["max_abs_err"]["unpaired"] == 0 and out["n_valid"] > 0

