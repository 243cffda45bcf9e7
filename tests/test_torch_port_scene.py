"""Scene serving and DOTA eval of the port against the JAX package, on
the CPU: the host numpy geometry (`data/np_rboxes.py`), tiling and the
merge (`data/tiling.py`), the DOTA merge helpers (`data/dota.py`), the
evaluation (`core/eval/`), and one scene end to end on the small
flagship.

Tolerances: the host numpy copies give equal outputs (bit for bit, or
`assert_array_equal` on float arrays); tiles are equal bytes.  The
scene end to end: every merged detection of the port paired (as
chip_smoke.py's `match_detections`) with one of the reference's of the
same label, score within 1e-4 and quad within 0.05 px (float32; the
two frameworks' FPN outputs differ by up to 1e-4), and the two DOTA
mAPs within 1e-6.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _build_flagship
from aidet_tpu.core.eval import mean_ap as ref_mean_ap
from aidet_tpu.core.eval import recall as ref_recall
from aidet_tpu.core.eval.class_names import DOTA_CLASSES as REF_CLASSES
from aidet_tpu.core.eval.dota import dota_eval as ref_dota_eval
from aidet_tpu.core.eval.dota import \
    export_dota_results as ref_export_dota_results
from aidet_tpu.data import np_rboxes as ref_np
from aidet_tpu.data import tiling as ref_tiling
from aidet_tpu.data.dota import DOTADataset
from aidet_tpu.data.dota import parse_patch_name as ref_parse_patch_name

import chip_smoke
from aidet_tpu_torch.convert import flax_to_state_dict
from aidet_tpu_torch.core.eval import class_names, mean_ap, recall
from aidet_tpu_torch.core.eval.dota import dota_eval, export_dota_results
from aidet_tpu_torch.data import np_rboxes, tiling
from aidet_tpu_torch.data.dota import (merge_patches_to_scenes,
                                       parse_patch_name)
from aidet_tpu_torch.flagship import build_flagship
from torch_port_helpers import perturb_norms, to_np
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)


def _quads(rs, n, lo=0.0, hi=300.0):
    """Rotated rectangles as quads, some degenerate (zero width, a
    repeated corner) and some self-intersecting (corners shuffled)."""
    tob = np.concatenate([rs.uniform(lo, hi, (n, 2)),
                          rs.uniform(2, 80, (n, 2)),
                          rs.uniform(-np.pi / 2, 0, (n, 1))], -1)
    q = ref_np.thetaobb2pointobb(tob.astype(np.float32))
    q[0, 2:4] = q[0, 0:2]                       # a repeated corner
    q[1] = np.tile(q[1, :2], 4)                 # a point
    q[2] = q[2].reshape(4, 2)[[0, 2, 1, 3]].reshape(8)   # bow tie
    return q.astype(np.float32)


def _boxes(rs, n, hi=300.0):
    xy = rs.uniform(0, hi, (n, 2))
    return np.concatenate([xy, xy + rs.uniform(1, 80, (n, 2))],
                          -1).astype(np.float32)


def test_np_rboxes_equal_reference():
    rs = np.random.RandomState(0)
    tob = np.concatenate([rs.uniform(0, 500, (64, 2)),
                          rs.uniform(1, 100, (64, 2)),
                          rs.uniform(-np.pi / 2, 0, (64, 1))],
                         -1).astype(np.float32)
    np.testing.assert_array_equal(np_rboxes.thetaobb2pointobb(tob),
                                  ref_np.thetaobb2pointobb(tob))
    q1, q2 = _quads(rs, 60), _quads(rs, 45)
    np.testing.assert_array_equal(np_rboxes.pointobb2bbox(q1),
                                  ref_np.pointobb2bbox(q1))
    np.testing.assert_array_equal(np_rboxes.quad_areas_np(q1),
                                  ref_np.quad_areas_np(q1))
    np.testing.assert_array_equal(np_rboxes.quad_overlaps_np_host(q1, q2),
                                  ref_np.quad_overlaps_np_host(q1, q2))
    np.testing.assert_array_equal(
        np_rboxes.quad_overlaps_np_host(q1, q2, chunk=7),
        ref_np.quad_overlaps_np_host(q1, q2))
    np.testing.assert_array_equal(np_rboxes.quad_iou_one_many_np(q1[5], q2),
                                  ref_np.quad_iou_one_many_np(q1[5], q2))
    scores = rs.rand(60).astype(np.float32)
    scores[10:14] = scores[9]                    # ties keep their order
    for thr in (0.05, 0.3, 0.7):
        np.testing.assert_array_equal(
            np_rboxes.quad_nms_np(q1, scores, thr),
            ref_np.quad_nms_np(q1, scores, thr))
        b = _boxes(rs, 60)
        np.testing.assert_array_equal(np_rboxes.bbox_nms_np(b, scores, thr),
                                      ref_np.bbox_nms_np(b, scores, thr))
    assert np_rboxes.quad_overlaps_np_host(q1[:0], q2).shape == (0, 45)


def _det_results(rs, n_imgs, n_classes, quads):
    """eval_map's inputs: per image, per class [K, D + 1] detections,
    and gts with 1-based labels, ignore regions on some images."""
    dets, gts = [], []
    for i in range(n_imgs):
        make = (lambda n: _quads(rs, n)) if quads else \
            (lambda n: _boxes(rs, n))
        g = make(12)
        labels = rs.randint(1, n_classes + 1, 12)
        gt = dict(boxes=g, labels=labels)
        if i % 2:
            gt["ignore"] = make(3)
            if i % 4 == 1:
                gt["ignore_labels"] = rs.randint(1, n_classes + 1, 3)
        per_class = []
        for c in range(n_classes):
            # some detections near this class's gts, some elsewhere
            near = g[labels == c + 1] + rs.normal(0, 3, g[labels == c + 1]
                                                   .shape).astype(np.float32)
            d = np.concatenate([near, make(4)])
            per_class.append(np.concatenate(
                [d, rs.rand(len(d), 1).astype(np.float32)], -1))
        dets.append(per_class)
        gts.append(gt)
    return dets, gts


@pytest.mark.parametrize("quads", [False, True])
@pytest.mark.parametrize("use_07", [False, True])
def test_eval_map_equal_reference(quads, use_07):
    dets, gts = _det_results(np.random.RandomState(1), 6, 4, quads)
    got = mean_ap.eval_map(dets, gts, use_07_metric=use_07,
                           iou_fn=mean_ap.quad_overlaps_np if quads
                           else mean_ap.bbox_overlaps_np)
    ref = ref_mean_ap.eval_map(dets, gts, use_07_metric=use_07,
                               iou_fn=ref_mean_ap.quad_overlaps_np if quads
                               else ref_mean_ap.bbox_overlaps_np)
    assert got == ref
    assert 0.0 < got[0] < 1.0


def test_average_precision_and_recalls_equal_reference():
    rs = np.random.RandomState(2)
    rec = np.sort(rs.rand(30))
    prec = rs.rand(30)
    for mode in ("area", "11points"):
        assert mean_ap.average_precision(rec, prec, mode) == \
            ref_mean_ap.average_precision(rec, prec, mode)
    gts = [_boxes(rs, 10), _boxes(rs, 0), _boxes(rs, 7)]
    props = [np.concatenate([_boxes(rs, 300), rs.rand(300, 1)], -1),
             _boxes(rs, 50), _boxes(rs, 0)]
    for nums, thrs in (((100, 300, 1000), (0.5,)), ((10, 50), (0.3, 0.7))):
        np.testing.assert_array_equal(
            recall.eval_recalls(gts, props, nums, thrs),
            ref_recall.eval_recalls(gts, props, nums, thrs))


def test_class_names_equal_reference():
    from aidet_tpu.core.eval import class_names as ref_names
    assert class_names.dataset_aliases == ref_names.dataset_aliases
    assert class_names.get_classes("dota") == REF_CLASSES


def test_dota_eval_int_difficult_and_orphan_scene():
    """As tests/test_eval.py's case: an int difficult column and
    detections in a scene without ground truth, both tasks."""
    quad = np.array([[10., 10., 50., 10., 50., 30., 10., 30.]])
    gts = {"P1": dict(boxes=np.concatenate([quad, quad + 100]),
                      labels=np.array([0, 0]),
                      difficult=np.array([0, 1]))}
    dets = {"P1": dict(boxes=quad, scores=np.array([0.9]),
                       labels=np.array([0])),
            "P_orphan": dict(boxes=quad, scores=np.array([0.95]),
                             labels=np.array([0]))}
    for d in ({"P1": dets["P1"]}, dets):
        got = dota_eval(d, gts, ("harbor",), task="obb")
        assert got == ref_dota_eval(d, gts, ("harbor",), task="obb")
    assert abs(dota_eval({"P1": dets["P1"]}, gts, ("harbor",))[0] - 1) < 1e-6
    assert dota_eval(dets, gts, ("harbor",))[0] < 1.0 - 1e-6


@pytest.mark.parametrize("task", ["obb", "hbb"])
def test_dota_eval_equal_reference(task):
    rs = np.random.RandomState(3)
    classes = REF_CLASSES[:5]
    dets, gts = {}, {}
    for s in range(4):
        g = _quads(rs, 20, hi=800) if task == "obb" else _boxes(rs, 20, 800)
        labels = rs.randint(0, 5, 20)
        gts[f"S{s}"] = dict(boxes=g, labels=labels,
                            difficult=rs.rand(20) < 0.2)
        d = np.concatenate([g + rs.normal(0, 2, g.shape), g[:5] + 40])
        dets[f"S{s}"] = dict(boxes=d.astype(np.float32),
                             scores=rs.rand(len(d)).astype(np.float32),
                             labels=np.concatenate([labels,
                                                    labels[:5]]))
    got = dota_eval(dets, gts, classes, task=task)
    assert got == ref_dota_eval(dets, gts, classes, task=task)
    assert 0.0 < got[0] < 1.0


def test_export_dota_results_csv_equal_reference(tmp_path):
    aps = {"plane": 0.5, "ship": 0.25}
    got = export_dota_results(aps, 0.375, str(tmp_path / "port"))
    ref = ref_export_dota_results(aps, 0.375, str(tmp_path / "ref"))
    assert open(got).read() == open(ref).read()


@pytest.mark.parametrize("hw", [(700, 900), (1024, 1024), (300, 1500),
                                (100, 80), (3072, 3072)])
def test_tile_coords_and_tile_image_equal_reference(hw):
    for patch, overlap in ((512, 100), (1024, 200)):
        assert tiling.tile_coords(*hw, patch, overlap) == \
            ref_tiling.tile_coords(*hw, patch, overlap)
    if hw[0] * hw[1] > 2 ** 22:
        return
    img = np.random.RandomState(4).randint(0, 256, hw + (3,), np.uint8)
    for arr in (img, img[..., 0]):
        got, offs = tiling.tile_image(arr, 512, 100)
        ref, ref_offs = ref_tiling.tile_image(arr, 512, 100)
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(offs, ref_offs)


def test_device_tiler_on_cpu_equal_bytes():
    """700x900, patch 512, overlap 100: the port's tiler on a CPU tensor
    gives the bytes of the reference's `tile_image` and of its jitted
    `device_tiler`; too small a scene raises as the reference does."""
    img = np.random.RandomState(5).randint(0, 256, (700, 900, 3), np.uint8)
    fn, offs = tiling.device_tiler(700, 900, 512, 100, device="cpu")
    got = fn(torch.from_numpy(img))
    assert got.dtype == torch.uint8 and got.device.type == "cpu"
    ref, ref_offs = ref_tiling.tile_image(img, 512, 100)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(offs, ref_offs)
    jfn, joffs = ref_tiling.device_tiler(700, 900, 512, 100)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jfn(img)))
    np.testing.assert_array_equal(offs, joffs)
    with pytest.raises(ValueError):
        fn(torch.from_numpy(img[:600]))
    with pytest.raises(ValueError):
        tiling.device_tiler(400, 900, 512, 100, device="cpu")


def _patch_dets(rs, n_patch, k, n_classes, box_type):
    dets = []
    for _ in range(n_patch):
        b = (_quads(rs, k, 50, 900) if box_type == "quad"
             else _boxes(rs, k, 900))
        dets.append(dict(boxes=b, scores=rs.rand(k).astype(np.float32),
                         labels=rs.randint(0, n_classes, k).astype(np.int64),
                         valid=rs.rand(k) < 0.9))
    dets[1]["valid"][:] = False                  # a patch without any
    offs = np.asarray([(824 * (i % 2), 824 * (i // 2))
                       for i in range(n_patch)], np.float32)
    return dets, offs


@pytest.mark.parametrize("box_type", ["quad", "box"])
def test_merge_serial_and_pooled_equal_reference(box_type):
    """Per-class thresholds; 4 patches of 150 candidates over 4 classes
    (every class busy enough for the pool); labels come out int32."""
    dets, offs = _patch_dets(np.random.RandomState(6), 4, 150, 4, box_type)
    thr = {0: 0.1, 1: 0.3, 2: 0.5, 3: 0.05}
    ref = ref_tiling.merge_patch_detections(dets, offs, 4, thr, box_type,
                                            workers=0)
    try:
        for workers in (0, 3, None):
            got = tiling.merge_patch_detections(dets, offs, 4, thr, box_type,
                                                workers=workers)
            assert got["labels"].dtype == np.int32
            for k in ("boxes", "scores", "labels"):
                np.testing.assert_array_equal(got[k], ref[k])
        assert tiling._MERGE_POOL is not None
    finally:
        tiling.close_merge_pool()
    assert tiling._MERGE_POOL is None
    small = tiling.merge_patch_detections(dets, offs, 4, thr, box_type,
                                          max_keep=50, workers=0)
    ref_small = ref_tiling.merge_patch_detections(dets, offs, 4, thr,
                                                  box_type, max_keep=50,
                                                  workers=0)
    for k in ("boxes", "scores", "labels"):
        np.testing.assert_array_equal(small[k], ref_small[k])
    empty = tiling.merge_patch_detections(dets[1:2], offs[:1], 4)
    assert empty["boxes"].shape == (0, 8)


def test_merge_patches_to_scenes_equal_reference():
    rs = np.random.RandomState(7)
    dets, _ = _patch_dets(rs, 4, 40, 15, "quad")
    names = ["P0001__1__0___0.png", "P0001__1__824___0.png",
             "P0002__0.5__0___824", "lonely"]
    assert [parse_patch_name(n) for n in names] == \
        [ref_parse_patch_name(n) for n in names]
    ref_self = types.SimpleNamespace(CLASSES=REF_CLASSES)
    for task in ("obb", "hbb"):
        d = dets if task == "obb" else [
            dict(x, boxes=ref_np.pointobb2bbox(x["boxes"])) for x in dets]
        for classwise in (True, False):
            got = merge_patches_to_scenes(d, names, REF_CLASSES, task,
                                          classwise)
            ref = DOTADataset.merge_patches_to_scenes(ref_self, d, names,
                                                      task, classwise)
            assert sorted(got) == sorted(ref) == ["P0001", "P0002",
                                                  "lonely"]
            for scene in got:
                for k in ("boxes", "scores", "labels"):
                    np.testing.assert_array_equal(got[scene][k],
                                                  ref[scene][k])


SCENE, PATCH, OVERLAP = 512, 256, 56
SCENE_LIMITS = dict(boxes=0.05, scores=1e-4)


@pytest.fixture(scope="module")
def scene_runs():
    """One seeded scene through both packages' small flagship (float32)
    with the same weights: (reference, port) merged detections, mAPs
    and tiles."""
    scene, gt = chip_smoke.synth_scene(0, SCENE, 12)
    jm = _build_flagship(PATCH, small=True)
    v = jax.jit(jm.init)(jax.random.PRNGKey(0),
                         jnp.zeros((1, PATCH, PATCH, 3)))
    v = perturb_norms(v, 0)
    jtile, joffs = ref_tiling.device_tiler(SCENE, SCENE, PATCH, OVERLAP)
    jtiles = jtile(jnp.asarray(scene))
    n = len(joffs)
    shapes = np.full((n, 2), PATCH, np.float32)
    out = jax.jit(lambda v, i, s: jm.apply(v, i, s, method="predict"))(
        v, jtiles, jnp.asarray(shapes))
    out = {k: np.asarray(x) for k, x in out.items()}
    quads = ref_np.thetaobb2pointobb(out["rboxes"])
    ref = ref_tiling.merge_patch_detections(
        [dict(boxes=quads[i], scores=out["scores"][i],
              labels=out["labels"][i], valid=out["valid"][i])
         for i in range(n)], joffs, num_classes=15, box_type="quad")
    ref_map = ref_dota_eval({"s": ref}, {"s": gt}, REF_CLASSES)[0]

    tm = build_flagship(PATCH, small=True, device="cpu")
    tm.load_state_dict(flax_to_state_dict(v)[0], strict=True)
    tile, offs = tiling.device_tiler(SCENE, SCENE, PATCH, OVERLAP,
                                     device="cpu")
    tiles = tile(torch.from_numpy(scene))
    got = chip_smoke.merge(chip_smoke.lift(tm.predict(
        tiles, torch.from_numpy(shapes))), offs)
    got_map = chip_smoke.scene_map(got, gt)
    return dict(ref=ref, got=got, ref_map=ref_map, got_map=got_map,
                tiles=(to_np(tiles), np.asarray(jtiles)), gt=gt)


def test_scene_tiles_equal(scene_runs):
    got, ref = scene_runs["tiles"]
    assert got.shape == (9, PATCH, PATCH, 3)
    np.testing.assert_array_equal(got, ref)


def test_scene_merged_detections_pair_up(scene_runs):
    got, ref = scene_runs["got"], scene_runs["ref"]
    assert len(got["scores"]) == len(ref["scores"]) > 0
    errs = chip_smoke.match_detections(chip_smoke.as_batch(got),
                                       chip_smoke.as_batch(ref),
                                       SCENE_LIMITS)
    assert errs["unpaired"] == 0 and errs["at_cut"] == 0, errs


def test_scene_dota_map_equal(scene_runs):
    assert abs(scene_runs["got_map"] - scene_runs["ref_map"]) <= 1e-6
    gt = scene_runs["gt"]
    as_dets = dict(gt, scores=np.ones(len(gt["labels"]), np.float32))
    assert abs(chip_smoke.scene_map(as_dets, gt) - 1.0) <= 1e-6
