"""NMS of the PyTorch port against the JAX reference on the CPU, on the
cases of tests/test_nms.py.  Keep masks, labels and indices must be
equal; boxes and scores are gathered, so they must be equal too
(atol 0)."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch


from aidet_tpu_torch.ops import nms
from torch_port_helpers import to_np
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

j_nms = importlib.import_module("aidet_tpu.ops.nms")


def random_dets(n, seed, spread=100.0, size=(5, 60)):
    rng = np.random.RandomState(seed)
    b = rng.uniform(0, spread, (n, 2)).astype(np.float32)
    boxes = np.concatenate([b, b + rng.uniform(*size, (n, 2))], -1)
    scores = rng.uniform(0.01, 1.0, n).astype(np.float32)
    return boxes.astype(np.float32), scores


def dense_scene(n_clusters, per_cluster, seed):
    """tests/test_nms.py::_dense_scene: clusters of near-duplicates."""
    rng = np.random.RandomState(seed)
    centers = rng.uniform(0, 1000, (n_clusters, 2))
    boxes, scores = [], []
    for c in centers:
        for _ in range(per_cluster):
            jit = c + rng.uniform(-1.5, 1.5, 2)
            wh = rng.uniform(12, 16, 2)
            boxes.append([jit[0], jit[1], jit[0] + wh[0], jit[1] + wh[1]])
            scores.append(rng.uniform(0.05, 1.0))
    return np.asarray(boxes, np.float32), np.asarray(scores, np.float32)


T = torch.from_numpy
J = jnp.asarray


def same(got, ref):
    np.testing.assert_array_equal(to_np(got), np.asarray(ref))


@pytest.mark.parametrize("seed", range(5))
def test_nms_random(seed):
    boxes, scores = random_dets(60, seed)
    same(nms.nms(T(boxes), T(scores), 0.5), j_nms.nms(J(boxes), J(scores), 0.5))


def test_nms_reference_docstring_case():
    dets = np.array([[49.1, 32.4, 51.0, 35.9, 0.9],
                     [49.3, 32.9, 51.0, 35.3, 0.9],
                     [49.2, 31.8, 51.0, 35.4, 0.5],
                     [35.1, 11.5, 39.1, 15.7, 0.5],
                     [35.6, 11.8, 39.3, 14.2, 0.5],
                     [35.3, 11.5, 39.9, 14.5, 0.4],
                     [35.2, 11.7, 39.7, 15.7, 0.3]], np.float32)
    keep = nms.nms(T(dets[:, :4]), T(dets[:, 4]), 0.7)
    assert int(keep.sum()) == 3
    same(keep, j_nms.nms(J(dets[:, :4]), J(dets[:, 4]), 0.7))


def test_nms_long_chains():
    """600 heavily overlapping boxes: long suppression chains (several
    of the reference's 256-box tiles)."""
    boxes, scores = random_dets(600, 42, spread=60, size=(5, 30))
    same(nms.nms(T(boxes), T(scores), 0.5), j_nms.nms(J(boxes), J(scores), 0.5))


def test_nms_valid_mask():
    boxes, scores = random_dets(30, 7)
    valid = np.zeros(30, bool)
    valid[:10] = True
    keep = nms.nms(T(boxes), T(scores), 0.5, T(valid))
    assert not to_np(keep)[10:].any()
    same(keep, j_nms.nms(J(boxes), J(scores), 0.5, J(valid)))


def test_nms_presorted_and_batched():
    """presorted=True on descending scores (padding last), solved for a
    stack of problems in one call."""
    stack_b, stack_s, stack_v, refs = [], [], [], []
    for seed in range(3):
        boxes, scores = random_dets(64, 11 + seed)
        valid = np.ones(64, bool)
        valid[50 - 10 * seed:] = False
        s2 = np.where(valid, scores, -1e10).astype(np.float32)
        order = np.argsort(-s2, kind="stable")
        stack_b.append(boxes[order])
        stack_s.append(s2[order])
        stack_v.append(valid[order])
        refs.append(np.asarray(j_nms.nms(J(boxes[order]), J(s2[order]), 0.5,
                                         J(valid[order]), presorted=True)))
    got = nms.nms(T(np.stack(stack_b)), T(np.stack(stack_s)), 0.5,
                  T(np.stack(stack_v)), presorted=True)
    same(got, np.stack(refs))
    rev = [np.ascontiguousarray(np.stack(a)[:, ::-1])
           for a in (stack_b, stack_s, stack_v)]
    unsorted = nms.nms(T(rev[0]), T(rev[1]), 0.5, T(rev[2]))
    same(unsorted, np.stack(refs)[:, ::-1])


def check_result(got, ref):
    for name in ("valid", "labels", "roi_idx", "scores", "boxes"):
        same(getattr(got, name), getattr(ref, name))


def _basic():
    boxes = np.array([[0, 0, 10, 10], [1, 1, 11, 11], [0, 0, 10, 10],
                      [40, 40, 50, 50]], np.float32)
    scores = np.array([[0.1, 0.9, 0.05], [0.1, 0.8, 0.05],
                       [0.1, 0.05, 0.85], [0.1, 0.7, 0.05]], np.float32)
    return boxes, scores, None, dict(score_thr=0.3, iou_thr=0.5, max_num=10)


def _threshold_padding():
    boxes, s1 = random_dets(16, 9)
    scores = np.stack([1 - s1, s1], -1).astype(np.float32)
    valid = np.zeros(16, bool)
    valid[:8] = True
    return boxes, scores, valid, dict(score_thr=0.99, max_num=5)


def _per_class_boxes():
    n = 6
    rng = np.random.RandomState(10)
    base = rng.uniform(0, 50, (n, 2))
    c0 = np.concatenate([base, base + 10], -1)
    multi = np.concatenate([np.zeros_like(c0), c0, c0 + 100],
                           -1).astype(np.float32)
    scores = np.tile(np.array([[0.1, 0.6, 0.3]], np.float32), (n, 1))
    return multi, scores, None, dict(score_thr=0.2, iou_thr=0.5, max_num=20)


def _dense(top_k):
    def make():
        boxes, s1 = dense_scene(150, 6, seed=3)
        scores = np.stack([1 - s1, s1], -1).astype(np.float32)
        return boxes, scores, None, dict(score_thr=0.05, iou_thr=0.5,
                                         max_num=100, pre_nms_top_k=top_k)
    return make


def _many_classes():
    rng = np.random.RandomState(12)
    boxes, _ = random_dets(400, 12, spread=300)
    multi = np.concatenate([boxes + rng.uniform(-3, 3, boxes.shape)
                            for _ in range(6)], -1).astype(np.float32)
    logits = rng.randn(400, 6).astype(np.float32) * 2
    scores = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    valid = rng.rand(400) < 0.9
    return multi, scores.astype(np.float32), valid, dict(
        score_thr=0.05, iou_thr=0.5, max_num=100)


CASES = dict(basic=_basic, threshold_padding=_threshold_padding,
             per_class_boxes=_per_class_boxes, dense_truncated=_dense(256),
             dense_exact=_dense(0), many_classes=_many_classes)


@pytest.mark.parametrize("case", list(CASES))
def test_multiclass_nms(case):
    boxes, scores, valid, kw = CASES[case]()
    got = nms.multiclass_nms(T(boxes), T(scores),
                             valid=None if valid is None else T(valid), **kw)
    ref = j_nms.multiclass_nms(J(boxes), J(scores),
                               valid=None if valid is None else J(valid), **kw)
    check_result(got, ref)
    if case == "dense_truncated":   # the reference's own check
        exact = nms.multiclass_nms(T(boxes), T(scores),
                                   **dict(kw, pre_nms_top_k=0))
        same(got.valid, exact.valid)
        same(got.boxes, exact.boxes)


def test_multiclass_nms_batched_equals_per_image():
    cases = [_many_classes() for _ in range(2)]
    multi = np.stack([cases[0][0], cases[1][0][::-1]])
    scores = np.stack([cases[0][1], cases[1][1][::-1]])
    valid = np.stack([cases[0][2], cases[1][2][::-1]])
    got = nms.multiclass_nms(T(multi.copy()), T(scores.copy()), 0.05,
                             valid=T(valid.copy()))
    for i in range(2):
        ref = j_nms.multiclass_nms(J(multi[i]), J(scores[i]), 0.05,
                                   valid=J(valid[i]))
        check_result(nms.NMSResult(*(t[i] for t in got)), ref)


def test_select_parallel_rboxes():
    n = 5
    rng = np.random.RandomState(11)
    boxes, s1 = random_dets(n, 11)
    scores = np.stack([1 - s1, s1], -1).astype(np.float32)
    kw = dict(score_thr=0.0, iou_thr=0.5, max_num=8)
    dec = rng.uniform(0, 100, (n, 10)).astype(np.float32)
    got = nms.select_parallel_rboxes(
        T(dec), nms.multiclass_nms(T(boxes), T(scores), **kw), 5)
    ref = j_nms.select_parallel_rboxes(
        J(dec), j_nms.multiclass_nms(J(boxes), J(scores), **kw), 5)
    same(got, ref)
    agnostic = nms.select_parallel_rboxes(
        T(dec[:, :5]), nms.multiclass_nms(T(boxes), T(scores), **kw), 5)
    same(agnostic, j_nms.select_parallel_rboxes(
        J(dec[:, :5]), j_nms.multiclass_nms(J(boxes), J(scores), **kw), 5))


def test_topk_breaks_ties_by_lower_index():
    x = torch.tensor([[0.5, 0.75, 0.5, 0.75, 0.25, 0.5]])
    vals, idx = nms.topk(x, 4)
    assert idx.tolist() == [[1, 3, 0, 2]]
    assert vals.tolist() == [[0.75, 0.75, 0.5, 0.5]]
