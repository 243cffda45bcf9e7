"""The bf16 predict's scores, stage by stage, in the PyTorch port against
the JAX package.

The reference (`aidet_tpu/models/detectors/two_stage.py::predict`)
computes the RPN's sigmoid (`anchor_head.py::rpn_proposals`) and the
RCNN's softmax (`bbox_head.py::bbox_head_decode`) in the heads' dtype,
bfloat16 in the full model, ranks those scores (ties to the lower
index) and returns them in bfloat16; box decodes promote to float32
against the float32 anchors and proposals.

Random weights make two bf16 stacks' scores nearly tie, so the heads
are taken out of the comparison: the small flagship's reference heads
(float32 weights, seeded, 128^2 input) give the RPN's per-level logits
and deltas, cast to bfloat16; the reference ranks and decodes them into
proposals, crops those and gives the RCNN's cls_score and bbox_pred,
cast to bfloat16, and decodes them with multiclass NMS.  The port's
`TwoStageDetector.predict` runs with its RPN head and bbox head
returning those same bfloat16 tensors (forward hooks) and must give
the same proposals in the same order (boxes within 1e-3 px, scores
bfloat16 and equal) and the same detections in the same order (labels
equal, boxes within 1e-3 px, scores bfloat16 and equal), except that
positions whose bfloat16 scores differ between the two by one ulp may
swap within the run of scores that lie within one ulp of each other.

nms_pre is 768, so that every level's top-k is the reference's exact
`top_k` (a level of n anchors takes `approx_max_k` when n > 4 k, whose
order of tied scores on the CPU is not the index order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _build_flagship
from aidet_tpu.models.detectors.two_stage import (RCNN_TARGET_MEANS,
                                                  RCNN_TARGET_STDS,
                                                  RPN_TARGET_STDS)
from aidet_tpu.models.heads.anchor_head import (flatten_level_outputs,
                                                rpn_proposals)
from aidet_tpu.models.heads.bbox_head import bbox_head_decode
from aidet_tpu.ops.nms import multiclass_nms

from aidet_tpu_torch.convert import flax_to_state_dict
from aidet_tpu_torch.flagship import build_flagship
from aidet_tpu_torch.models.detectors import two_stage
from torch_port_helpers import perturb_norms, to_np
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

IMG = 128
RPN_CFG = dict(nms_pre=768, nms_post=64, max_num=64, nms_thr=0.7)


def _reference_stages(m, imgs, img_shapes):
    """The reference's predict with its head outputs cast to bf16."""
    feats = m.extract_feat(imgs)
    rpn_cls, rpn_reg = m._rpn(feats)
    rpn_cls = [c.astype(jnp.bfloat16) for c in rpn_cls]
    rpn_reg = [r.astype(jnp.bfloat16) for r in rpn_reg]
    cls_flat, reg_flat = flatten_level_outputs(rpn_cls, rpn_reg, 1)
    props, prop_scores, prop_valid = rpn_proposals(
        cls_flat, reg_flat, m._anchors, m._level_sizes, img_shapes,
        target_stds=RPN_TARGET_STDS, **RPN_CFG)
    b, p = props.shape[:2]
    crops = m._roi_features(feats, props, m._bbox_pool_size, infer=True)
    cls_score, bbox_pred = m._bbox_head(
        crops.reshape((b * p,) + crops.shape[2:]))
    cls_score = cls_score.astype(jnp.bfloat16).reshape(b, p, -1)
    bbox_pred = bbox_pred.astype(jnp.bfloat16).reshape(b, p, -1)
    rc = m._ec["rcnn"]

    def decode_one(rois_i, cls_i, pred_i, shape_i, valid_i):
        boxes, scores = bbox_head_decode(
            rois_i, cls_i, pred_i, RCNN_TARGET_MEANS, RCNN_TARGET_STDS,
            img_shape=shape_i)
        return multiclass_nms(boxes, scores, rc["score_thr"],
                              iou_thr=rc["nms_thr"],
                              max_num=rc["max_per_img"], valid=valid_i)
    dets = jax.vmap(decode_one)(props, cls_score, bbox_pred, img_shapes,
                                prop_valid)
    return dict(rpn_cls=rpn_cls, rpn_reg=rpn_reg, props=props,
                prop_scores=prop_scores, cls_score=cls_score,
                bbox_pred=bbox_pred,
                boxes=dets.boxes, scores=dets.scores, labels=dets.labels,
                valid=dets.valid)


def _bf16(x):
    """A bf16 jax array as the same bf16 torch tensor (exact)."""
    return torch.from_numpy(np.asarray(x, np.float32)).bfloat16()


@pytest.fixture(scope="module")
def stages():
    jm = _build_flagship(IMG, small=True)
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)))
    v = perturb_norms(v, 0)
    imgs = np.random.RandomState(0).randint(0, 256, (2, IMG, IMG, 3),
                                            np.uint8)
    shapes = np.asarray([[IMG, IMG], [IMG, 100]], np.float32)
    ref = jax.jit(lambda v, i, s: jm.apply(
        v, i, s, method=_reference_stages))(v, jnp.asarray(imgs),
                                             jnp.asarray(shapes))

    tm = build_flagship(IMG, small=True, device="cpu")
    tm.test_cfg["rpn"].update(RPN_CFG)
    sd, _ = flax_to_state_dict(v)
    tm.load_state_dict(sd, strict=True)
    b, p = ref["props"].shape[:2]
    hooks = [
        tm.rpn_head.register_forward_hook(lambda *_: (
            [_bf16(c) for c in ref["rpn_cls"]],
            [_bf16(r) for r in ref["rpn_reg"]])),
        tm.bbox_head.register_forward_hook(lambda *_: (
            _bf16(ref["cls_score"]).reshape(b * p, -1),
            _bf16(ref["bbox_pred"]).reshape(b * p, -1)))]
    seen = []
    proposals = two_stage.rpn_proposals

    def record(*args, **kwargs):
        seen.append(proposals(*args, **kwargs))
        return seen[-1]
    two_stage.rpn_proposals = record
    try:
        got = tm.predict(torch.from_numpy(imgs), torch.from_numpy(shapes))
    finally:
        two_stage.rpn_proposals = proposals
        for h in hooks:
            h.remove()
    got["props"], got["prop_scores"], _ = seen[0]
    return ref, got


def _ulp(x):
    """One bfloat16 ulp at each |x| (x as float32)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


def _tie_runs(scores):
    """Run id per position: consecutive positions whose scores are
    within one bfloat16 ulp of each other share a run."""
    step = np.abs(np.diff(scores)) > _ulp(scores[:-1])
    return np.concatenate([[0], np.cumsum(step)])


def _same_order(got_keys, ref_keys, got_s, ref_s, what):
    """Rows equal position by position, except where the two scores at
    a position differ by one ulp: there the rows may be permuted within
    the reference's run of scores within one ulp of each other."""
    assert np.all(np.abs(got_s - ref_s) <= _ulp(ref_s)), what
    runs = _tie_runs(ref_s)
    for run in np.unique(runs):
        sel = runs == run
        g, r = got_keys[sel], ref_keys[sel]
        if np.array_equal(got_s[sel], ref_s[sel]):
            np.testing.assert_allclose(g, r, atol=1e-3, err_msg=what)
        else:
            np.testing.assert_allclose(g[np.lexsort(g.T[::-1])],
                                       r[np.lexsort(r.T[::-1])], atol=1e-3,
                                       err_msg=what)


def test_proposals_rank_bf16_scores_as_the_reference(stages):
    ref, got = stages
    assert got["props"].dtype == torch.float32
    assert got["prop_scores"].dtype == torch.bfloat16
    ref_s = np.asarray(ref["prop_scores"], np.float32)
    got_s = to_np(got["prop_scores"].float())
    for b in range(ref_s.shape[0]):
        _same_order(to_np(got["props"][b]), np.asarray(ref["props"][b]),
                    got_s[b], ref_s[b], f"image {b}")


def test_detections_rank_bf16_scores_as_the_reference(stages):
    ref, got = stages
    assert got["scores"].dtype == torch.bfloat16
    assert got["boxes"].dtype == torch.float32
    np.testing.assert_array_equal(to_np(got["valid"]),
                                  np.asarray(ref["valid"]))
    assert int(got["valid"].sum()) > 0
    ref_s = np.asarray(ref["scores"], np.float32)
    got_s = to_np(got["scores"].float())
    for b in range(ref_s.shape[0]):
        keys_g = np.concatenate([to_np(got["labels"][b])[:, None],
                                 to_np(got["boxes"][b])], 1)
        keys_r = np.concatenate([np.asarray(ref["labels"][b])[:, None],
                                 np.asarray(ref["boxes"][b])], 1)
        _same_order(keys_g, keys_r, got_s[b], ref_s[b], f"image {b}")
