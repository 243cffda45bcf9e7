"""Rotated IoU and rotated NMS of the PyTorch port against the JAX
reference on the CPU.

Bounds:
- `core.riou.quad_overlaps` (iou and iof, aligned and all-pairs, below
  and past the chunk threshold n*m > 4096 with n > 32): within 1e-5
  absolute of `aidet_tpu.core.riou.quad_overlaps` on random quads,
  near-duplicates, containment and `tests/test_riou.py`'s degenerate
  suite (parallel, collinear, touching and zero-area quads), whose
  expected IoUs hold within 1e-4 as there;
- `ops.nms.rnms` keep masks and `multiclass_nms(box_dim=8)` with
  ``pre_nms_top_k`` 256 and 0: equal to the reference's (the kept
  quads, scores, labels and indices are gathered, so atol 0).
The gpu-marked case holds the card's overlaps (within 1e-5) and NMS
(equal) to the CPU's; it needs no JAX, so it runs on the card's machine
alone: python -m pytest -m gpu tests/test_torch_port_riou.py.
"""

import importlib

import numpy as np
import pytest
import torch

from aidet_tpu_torch.core import riou
from aidet_tpu_torch.core.rboxes import thetaobb2pointobb
from aidet_tpu_torch.ops import nms
from torch_port_helpers import to_np
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

try:
    import jax.numpy as jnp

    from aidet_tpu.core import riou as j_riou
    from test_riou import _degenerate_suite
    j_nms = importlib.import_module("aidet_tpu.ops.nms")
    J = jnp.asarray
except ImportError:     # the card's machine: the gpu case runs alone
    j_riou = None
needs_reference = pytest.mark.skipif(j_riou is None,
                                     reason="needs the JAX reference")
T = torch.from_numpy


def quads(seed, n, spread=200.0, size=(4, 80), jitter=None):
    """n seeded thetaobbs' corners [n, 8] (float32); with ``jitter``,
    n near-duplicates of one box, moved by up to that many px and
    radians."""
    rs = np.random.RandomState(seed)
    if jitter is None:
        t = np.concatenate([rs.uniform(0, spread, (n, 2)),
                            rs.uniform(*size, (n, 2)),
                            rs.uniform(-np.pi / 2, 0, (n, 1))], -1)
    else:
        base = np.array([100.0, 80.0, 60.0, 25.0, -0.6])
        t = base + rs.uniform(-jitter, jitter, (n, 5))
    return to_np(thetaobb2pointobb(T(t.astype(np.float32))))


def degenerate_pairs():
    cases = _degenerate_suite()
    return (np.stack([c[0] for c in cases]), np.stack([c[1] for c in cases]),
            np.array([c[2] for c in cases], np.float32))


def containment():
    """Quads inside others at several angles, and their swaps."""
    outer = np.array([[50, 50, 80, 60, -0.3], [50, 50, 80, 60, -1.2]],
                     np.float32)
    inner = np.array([[52, 49, 20, 10, -0.7], [50, 50, 30, 30, -0.1]],
                     np.float32)
    a = to_np(thetaobb2pointobb(T(np.concatenate([outer, inner]))))
    return a, a[[2, 3, 0, 1]]


def special():
    """Containment, then the degenerate suite, as aligned pairs."""
    (a, b), (c, d) = containment(), degenerate_pairs()[:2]
    return np.concatenate([a, c]), np.concatenate([b, d])


CASES = dict(
    # random quads, then near-duplicates of one box
    random=(np.concatenate([quads(0, 20), quads(4, 24, jitter=0.5)]),
            np.concatenate([quads(1, 20), quads(5, 24, jitter=0.5)])),
    past_chunk=(quads(2, 100, spread=120), quads(3, 60, spread=120)),
    containment=containment())
if j_riou is not None:
    CASES["special"] = special()


# (case, mode, aligned): iou and iof, aligned and all-pairs, past the
# chunk threshold; one reference compile each
OVERLAPS = [("random", "iou", False), ("random", "iof", True),
            ("past_chunk", "iou", False), ("past_chunk", "iof", False),
            ("special", "iou", True), ("special", "iof", False)]


@pytest.fixture(scope="module")
def reference():
    """The reference's overlaps of each of `OVERLAPS`."""
    return {(name, mode, aligned): np.asarray(j_riou.quad_overlaps(
        J(CASES[name][0]), J(CASES[name][1]), mode=mode, aligned=aligned))
        for name, mode, aligned in OVERLAPS}


@needs_reference
@pytest.mark.parametrize("name,mode,aligned", OVERLAPS)
def test_quad_overlaps_match_the_reference(reference, name, mode, aligned):
    a, b = CASES[name]
    got = riou.quad_overlaps(T(a), T(b), mode=mode, aligned=aligned)
    np.testing.assert_allclose(to_np(got), reference[name, mode, aligned],
                               atol=1e-5, rtol=0)


def test_chunking_and_batching_do_not_change_overlaps(monkeypatch):
    """Rows solved in chunks (here 32 rows of 60 pairs, 4 chunks) equal
    the rows solved at once; batched problems equal the same problems
    one at a time."""
    a, b = CASES["past_chunk"]
    whole = riou.quad_overlaps(T(a), T(b))
    monkeypatch.setattr(riou, "CHUNK_PAIRS", 32 * 60)
    assert riou._rows_per_chunk(100, 60, 1) == 32
    np.testing.assert_array_equal(to_np(riou.quad_overlaps(T(a), T(b))),
                                  to_np(whole))
    batched = riou.quad_overlaps(T(np.stack([a[:50], a[50:]])),
                                 T(np.stack([b, b[::-1].copy()])))
    np.testing.assert_array_equal(to_np(batched[0]), to_np(whole[:50]))
    np.testing.assert_array_equal(to_np(batched[1]), to_np(
        riou.quad_overlaps(T(a[50:]), T(b[::-1].copy()))))


@needs_reference
def test_degenerate_suite_expected_ious():
    a, b, expect = degenerate_pairs()
    got = riou.quad_overlaps(T(a), T(b), aligned=True)
    np.testing.assert_allclose(to_np(got), expect, atol=1e-4)
    assert np.isfinite(to_np(riou.quad_overlaps(T(a), T(b)))).all()


def nms_inputs(seed, n=60):
    """Clusters of near-duplicate quads with seeded scores."""
    rs = np.random.RandomState(seed)
    q = np.concatenate([quads(seed * 7 + k, n // 4, jitter=3.0)
                        + np.tile(rs.uniform(0, 300, 2), 4)
                        for k in range(4)])
    return q.astype(np.float32), rs.uniform(0.05, 1, len(q)).astype(
        np.float32)


@needs_reference
@pytest.mark.parametrize("seed", range(3))
def test_rnms_matches_the_reference(seed, thr=0.1):
    """At the configs' rnms_thr."""
    q, s = nms_inputs(seed)
    valid = np.random.RandomState(seed).rand(len(s)) > 0.1
    ref = j_nms.rnms(J(q), J(s), thr, J(valid))
    got = nms.rnms(T(q), T(s), thr, T(valid))
    np.testing.assert_array_equal(to_np(got), np.asarray(ref))
    assert 0 < to_np(got).sum() < valid.sum()
    order = np.argsort(-np.where(valid, s, -1e10), kind="stable")
    ref_p = j_nms.rnms(J(q[order]), J(s[order]), thr, J(valid[order]),
                       presorted=True)
    got_p = nms.rnms(T(q[order]), T(s[order]), thr, T(valid[order]),
                     presorted=True)
    np.testing.assert_array_equal(to_np(got_p), np.asarray(ref_p))


def multiclass_inputs(seed, n=300, classes=4):
    """n candidates of ``classes`` classes: quads scattered over 400^2,
    scores [n, classes + 1] with a background column."""
    q = quads(seed + 20, n, spread=400, size=(10, 60))
    rs = np.random.RandomState(seed + 50)
    scores = rs.uniform(0, 1, (n, classes + 1)).astype(np.float32)
    return q, scores


@pytest.fixture(scope="module")
def multiclass_reference():
    q, sc = multiclass_inputs(0)
    return {k: j_nms.multiclass_nms(J(q), J(sc), 0.3, iou_thr=0.1,
                                    max_num=50, box_dim=8, pre_nms_top_k=k)
            for k in (256, 0)}


@needs_reference
@pytest.mark.parametrize("pre_nms_top_k", [256, 0])
def test_multiclass_rotated_nms_matches_the_reference(multiclass_reference,
                                                      pre_nms_top_k):
    q, sc = multiclass_inputs(0)
    ref = multiclass_reference[pre_nms_top_k]
    got = nms.multiclass_nms(T(q), T(sc), 0.3, iou_thr=0.1, max_num=50,
                             box_dim=8, pre_nms_top_k=pre_nms_top_k)
    for f in nms.NMSResult._fields:
        np.testing.assert_array_equal(to_np(getattr(got, f)),
                                      np.asarray(getattr(ref, f)), f)
    assert to_np(got.valid).sum() == 50


@pytest.mark.gpu
def test_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the chip with "
                    "python -m pytest -m gpu tests/test_torch_port_riou.py")
    for a, b in CASES.values():
        for aligned in (False, True) if len(a) == len(b) else (False,):
            cpu = riou.quad_overlaps(T(a), T(b), aligned=aligned)
            card = riou.quad_overlaps(T(a).cuda(), T(b).cuda(),
                                      aligned=aligned)
            np.testing.assert_allclose(to_np(card), to_np(cpu), atol=1e-5)
    q, sc = multiclass_inputs(1)
    cpu = nms.multiclass_nms(T(q), T(sc), 0.3, iou_thr=0.1, max_num=50,
                             box_dim=8)
    card = nms.multiclass_nms(T(q).cuda(), T(sc).cuda(), 0.3, iou_thr=0.1,
                              max_num=50, box_dim=8)
    for f in nms.NMSResult._fields:
        np.testing.assert_array_equal(to_np(getattr(card, f)),
                                      to_np(getattr(cpu, f)), f)
