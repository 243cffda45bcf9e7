"""The mask family's host side in the PyTorch port: the rasterisation
that replaces OpenCV (`data/raster.py`), the CenterMap targets
(`data/centermap.py`), `TrainPipeline`'s mask, mask-weight, semantic and
heatmap targets, and the mask-to-OBB fit (`core/masks.py`,
`np_rboxes.min_area_rect_np`), held to OpenCV (which the tests import;
the port never does) and to the reference package.

Bounds:
- `fill_poly` against `cv2.fillPoly` (OpenCV 5.0): equal, pixel for
  pixel, on polygons inside the image, convex or not; on 3000 seeded
  rotated rectangles with centres inside 64^2, 128^2 and 256^2 canvases
  and sides up to twice the canvas; on the centre-outside family
  (centres in [-0.2, 1.2] x the canvas, sides up to 1.5 x: no residual
  case, since the fill rebuilds each clipped edge as OpenCV's
  `CollectPolyEdges` does, a clip to one point included) and on the
  300 rectangles of sides 1-40 px on 64^2 that bounded the fill at 12
  pixels before that repair;
- `warp_perspective` against `cv2.warpPerspective` of the centerness
  template: within 2e-3 (OpenCV's 1/32-pixel coordinate and 15-bit
  weight tables, which the port does not copy); the homography
  within 1e-9 of `cv2.getPerspectiveTransform`'s relative to its
  largest entry; `contour_area` equal to `cv2.contourArea` within
  1e-9 relative;
- `resize_linear` against `cv2.resize` (INTER_LINEAR, float32): within
  2e-6 (OpenCV's vectorised float32 sums), so `paste_mask` pastes the
  same pixels except where a value lies within 2e-6 of the threshold
  (none here);
- `largest_component` picks `cv2.connectedComponentsWithStats`'s
  largest 4-connected blob, ties included;
- the CenterMap maps and `TrainPipeline`'s targets against the
  reference's: the float maps within 2e-3 (the warp), the uint8 ones
  within one grey level and equal on 99.9% of the pixels, the binary
  masks and the pseudo-segmentation equal, quads that leave the image
  included;
- `min_area_rect_np` and `masks_to_thetaobbs` equal to the reference's
  to float32 rounding;
- `core/eval/segm.py` and `CocoDataset`'s segm eval: the polygon
  records of gts inside their image equal, every mAP within 1e-6.
"""

import cv2
import numpy as np
import pytest

from aidet_tpu.core import masks as j_masks
from aidet_tpu.core.riou import min_area_rect_np as j_min_area_rect
from aidet_tpu.data import centermap as j_cm
from aidet_tpu.data.pipeline import TrainPipeline as JTrainPipeline

from aidet_tpu_torch.core import masks
from aidet_tpu_torch.data import centermap, raster
from aidet_tpu_torch.data.np_rboxes import min_area_rect_np
from aidet_tpu_torch.data.pipeline import TrainPipeline

S = 64
CORNERS = np.array([[-1, -1], [1, -1], [1, 1], [-1, 1]]) / 2.0


def rect(rs, centre_lo, centre_hi, side_lo, side_hi):
    c = rs.uniform(centre_lo, centre_hi, 2)
    wh = rs.uniform(side_lo, side_hi, 2)
    t = rs.uniform(-np.pi, np.pi)
    r = np.array([[np.cos(t), -np.sin(t)], [np.sin(t), np.cos(t)]])
    return c + (CORNERS * wh) @ r.T


def fills(pts):
    a = np.zeros((S, S), np.int32)
    cv2.fillPoly(a, [pts.astype(np.int32)], 7)
    b = raster.fill_poly(np.zeros((S, S), np.int32), pts, 7)
    return a, b


@pytest.mark.parametrize("kind", ["rect", "polygon"])
def test_fill_poly_inside_the_image_is_opencvs(kind):
    rs = np.random.RandomState(0 if kind == "rect" else 1)
    for _ in range(300):
        if kind == "rect":
            pts = np.clip(np.round(rect(rs, 20, S - 20, 1, 40)), 0, S - 1)
        else:   # 3-6 vertices anywhere inside: concave and self-crossing
            pts = rs.randint(0, S, (rs.randint(3, 7), 2))
        a, b = fills(pts.astype(np.int64))
        np.testing.assert_array_equal(a, b, err_msg=str(pts.tolist()))


def fill_diffs(rs, n, canvases, centre, side):
    """Pixels where `fill_poly` differs from `cv2.fillPoly` on each of
    ``n`` seeded rotated rectangles, cycling through ``canvases``:
    centres in [centre[0], centre[1]] x the canvas, sides 1 to ``side``
    x the canvas."""
    out = []
    for i in range(n):
        s = canvases[i % len(canvases)]
        pts = np.round(rect(rs, centre[0] * s, centre[1] * s, 1, side * s))
        a = np.zeros((s, s), np.int32)
        cv2.fillPoly(a, [pts.astype(np.int32)], 7)
        b = raster.fill_poly(np.zeros((s, s), np.int32),
                             pts.astype(np.int64), 7)
        out.append(int(np.not_equal(a, b).sum()))
    return out


@pytest.mark.parametrize("canvas", [64, 128, 256])
def test_fill_poly_across_the_border_is_opencvs(canvas):
    """1000 rectangles a canvas, centres inside it, sides up to twice
    it: DOTA objects cut by a patch border."""
    diffs = fill_diffs(np.random.RandomState(canvas), 1000, [canvas],
                       (0.0, 1.0), 2.0)
    assert max(diffs) == 0, (sum(d > 0 for d in diffs), max(diffs))


def test_fill_poly_across_the_border_within_bound():
    """The bound is 0: the centre-outside family (3000 rectangles over
    64^2-256^2, centres in [-0.2, 1.2] x the canvas, sides up to 1.5 x)
    and the 300 rectangles of sides 1-40 px on 64^2 that held the fill
    within 12 pixels before the clipped edges were rebuilt."""
    rs = np.random.RandomState(2)
    diffs = [int(np.not_equal(*fills(np.round(rect(rs, 0, S, 1, 40))
                                     .astype(np.int64))).sum())
             for _ in range(300)]
    diffs += fill_diffs(np.random.RandomState(6), 3000, [64, 128, 256],
                        (-0.2, 1.2), 1.5)
    assert max(diffs) == 0, (sum(d > 0 for d in diffs), max(diffs))


def test_lines_are_opencvs():
    """The 8-connected edge lines, clipped where they leave the image."""
    rs = np.random.RandomState(3)
    for _ in range(500):
        p = rs.randint(-40, S + 40, (2, 2))
        a = cv2.line(np.zeros((S, S), np.uint8), tuple(map(int, p[0])),
                     tuple(map(int, p[1])), 1, 1, cv2.LINE_8)
        b = np.zeros((S, S), np.uint8)
        raster._line(b, tuple(map(int, p[0])), tuple(map(int, p[1])), 1)
        np.testing.assert_array_equal(a, b, err_msg=str(p.tolist()))


def test_warp_and_homography_and_area():
    tmpl = centermap._template(512, 4.0, 0.5, "centerness")
    rs = np.random.RandomState(4)
    s = 511
    src = np.array([[0, 0], [s, 0], [s, s], [0, s]], np.float32)
    for _ in range(20):
        q = rect(rs, 0, 256, 4, 80).astype(np.float32)
        m_cv = cv2.getPerspectiveTransform(src, q)
        m = raster.perspective_transform(src, q)
        assert np.abs(m - m_cv).max() <= 1e-9 * np.abs(m_cv).max()
        a = cv2.warpPerspective(tmpl, m_cv, (256, 256),
                                flags=cv2.INTER_LINEAR,
                                borderMode=cv2.BORDER_CONSTANT,
                                borderValue=0.0)
        b = centermap.pointobb2pseudomask(q.reshape(8), (256, 256),
                                          rate=0.5)
        assert np.abs(a - b).max() < 2e-3
        np.testing.assert_allclose(raster.contour_area(q),
                                   cv2.contourArea(q), rtol=1e-9)


def test_resize_and_paste_are_opencvs():
    rs = np.random.RandomState(5)
    for _ in range(30):
        crop = rs.rand(28, 28).astype(np.float32)
        w, h = rs.randint(1, 120, 2)
        a = cv2.resize(crop, (int(w), int(h)))
        b = masks.resize_linear(crop, (int(w), int(h)))
        assert a.shape == b.shape
        assert np.abs(a.astype(np.float64) - b).max() < 2e-6
        box = np.array([rs.uniform(-20, 200), rs.uniform(-20, 200), 0, 0])
        box[2:] = box[:2] + rs.uniform(1, 90, 2)
        np.testing.assert_array_equal(
            masks.paste_mask(crop, box, (160, 180)),
            j_masks.paste_mask(crop, box, (160, 180)))


def test_largest_component_is_opencvs():
    """Random maps with many blobs, and two blobs of one area (the tie
    goes to the first in raster order on both sides)."""
    rs = np.random.RandomState(6)
    maps = [rs.rand(28, 28) > 0.6 for _ in range(40)]
    tie = np.zeros((28, 28), bool)
    tie[20:23, 2:5] = tie[3:6, 20:23] = True
    for binary in maps + [tie]:
        n, lbl, stats, _ = cv2.connectedComponentsWithStats(
            binary.astype(np.uint8), connectivity=4)
        want = lbl == 1 + int(np.argmax(stats[1:, cv2.CC_STAT_AREA]))
        np.testing.assert_array_equal(masks.largest_component(binary), want)


def test_min_area_rect_and_masks_to_thetaobbs_match_the_reference():
    rs = np.random.RandomState(7)
    for n in (1, 2, 3, 7, 40):
        pts = rs.uniform(-50, 50, (n, 2))
        np.testing.assert_allclose(min_area_rect_np(pts),
                                   j_min_area_rect(pts), rtol=0, atol=1e-9)
    crops = rs.rand(12, 28, 28).astype(np.float32)
    crops[3] = 0.0                                      # empty
    xy = rs.uniform(0, 200, (12, 2))
    boxes = np.concatenate([xy, xy + rs.uniform(4, 80, (12, 2))], 1)
    valid = np.arange(12) != 5
    got = masks.masks_to_thetaobbs(crops, boxes, valid)
    ref = j_masks.masks_to_thetaobbs(crops, boxes, valid)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-4)
    assert not got[3].any() and not got[5].any()


def quads_of(rs, n, size, margin):
    return np.stack([rect(rs, -margin, size + margin, 6, size / 4)
                     .reshape(8) for _ in range(n)]).astype(np.float32)


def test_centermap_maps_match_the_reference():
    rs = np.random.RandomState(8)
    q = quads_of(rs, 12, 256, 0)
    labels = rs.randint(1, 16, 12)
    for kind in ("centerness", "weight", "reverse"):
        np.testing.assert_allclose(
            centermap.pointobbs2centermap(q, (256, 256), 64, kind=kind,
                                          rate=0.5),
            j_cm.pointobbs2centermap(q, (256, 256), 64, kind=kind,
                                     rate=0.5), atol=2e-3, rtol=0)
    np.testing.assert_allclose(centermap.heatmap_weight(q, (256, 256), 64),
                               j_cm.heatmap_weight(q, (256, 256), 64),
                               atol=2e-3, rtol=0)
    np.testing.assert_array_equal(
        centermap.pseudo_segmentation(q, labels, (256, 256), 64,
                                      valid_hw=(256, 200)),
        j_cm.pseudo_segmentation(q, labels, (256, 256), 64,
                                 valid_hw=(256, 200)))


def patch(seed, size=256, n=24):
    rs = np.random.RandomState(seed)
    q = quads_of(rs, n, size, 10)
    x, y = q[:, 0::2], q[:, 1::2]
    anns = dict(bboxes=np.stack([x.min(1), y.min(1), x.max(1), y.max(1)],
                                1), labels=rs.randint(1, 16, n),
                pointobbs=q)
    return rs.randint(0, 256, (size, size, 3)).astype(np.uint8), anns


@pytest.mark.parametrize("mask_type,device_normalize", [
    ("centermap", True), ("centermap", False), ("binary", True)])
def test_train_pipeline_targets_match_the_reference(mask_type,
                                                    device_normalize):
    """Every key of the reference's sample, over 3 patches of 24 quads
    (some across the border) with flips; the same draws from one seed."""
    kw = dict(img_size=256, max_gt=32, flip_ratio=0.5, with_mask=True,
              mask_type=mask_type,
              with_mask_weight=mask_type == "centermap",
              with_semantic=True, with_heatmap_weight=True,
              device_normalize=device_normalize, seed=9)
    jp, tp = JTrainPipeline(**kw), TrainPipeline(**kw)
    for seed in range(3):
        img, anns = patch(seed)
        ref, got = jp(img, anns), tp(img, anns)
        assert set(got) == set(ref)
        # quads that leave the mask's image are among them, and fill
        # OpenCV's pixels like the others
        n = len(anns["labels"])
        assert got["gt_valid"][:n].all() and not got["gt_valid"][n:].any()
        q = anns["pointobbs"] / 4
        cross = (q.min(1) < 0) | (q.max(1) > 63)
        assert 0 < cross.sum() < n
        for k in ref:
            a, b = np.asarray(ref[k]), got[k]
            assert a.dtype == b.dtype and a.shape == b.shape, k
            d = np.abs(a.astype(np.float64) - b)
            if k == "gt_semantic" or (k == "gt_masks"
                                      and mask_type == "binary"):
                assert not d.any(), k
            elif a.dtype == np.uint8:
                assert d.max() <= 1 and (d > 0).mean() < 1e-3, k
            elif k.startswith("gt_") and a.ndim >= 2 and k not in (
                    "gt_boxes", "gt_rboxes"):
                assert d.max() < 2e-3, (k, d.max())
            else:
                assert d.max() == 0, k


def test_reverse_heatmap_and_reverse_mask_weight():
    kw = dict(img_size=256, max_gt=32, with_mask=True,
              mask_type="centermap", with_reverse_mask_weight=True,
              with_heatmap_weight=True, reverse_heatmap_weight=True,
              seed=3)
    img, anns = patch(11)
    ref, got = JTrainPipeline(**kw)(img, anns), TrainPipeline(**kw)(img, anns)
    for k in ("gt_mask_weights", "gt_seg_weights"):
        assert np.abs(np.asarray(ref[k]) - got[k]).max() < 2e-3
    with pytest.raises(ValueError):
        TrainPipeline(with_mask_weight=True, with_reverse_mask_weight=True)


def test_segm_records_and_eval_match_the_reference():
    """`core/eval/segm.py` and `CocoDataset.evaluate`'s segm branch on
    the DOTA val patches: each detection's mask the gt polygon filled
    into its crop, with noise.  Every gt's polygon record equals the
    reference's; every mAP within 1e-6."""
    import os
    from aidet_tpu.core.eval import segm as j_segm
    from aidet_tpu.data.builder import build_dataset as ref_build_dataset
    from aidet_tpu_torch.core.eval import segm
    from aidet_tpu_torch.data.builder import build_dataset
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    split = dict(type="DOTADataset", ann_file=os.path.join(
        repo, "data", "dota", "val_patches.json"), img_prefix="")
    got_ds, ref_ds = build_dataset(split), ref_build_dataset(split)
    rs = np.random.RandomState(12)
    results, inside = [], 0
    for i in range(len(ref_ds)):
        anns = ref_ds.parse_anns(i)
        n = min(20, len(anns["bboxes"]))
        boxes = anns["bboxes"][:n] + rs.normal(0, 1.0, (n, 4))
        crops = np.zeros((n, 28, 28), np.float32)
        for k in range(n):
            q = np.asarray(anns["pointobbs"][k], np.float64).reshape(4, 2)
            x1, y1, x2, y2 = boxes[k]
            scale = [28 / max(x2 - x1 + 1, 1), 28 / max(y2 - y1 + 1, 1)]
            raster.fill_poly(crops[k], np.round((q - [x1, y1]) * scale)
                             .astype(np.int32), 1.0)
            seg = anns["segmentations"][k]
            hw = (anns["height"], anns["width"])
            pts = np.asarray(seg[0] if isinstance(seg[0], list) else seg)
            inside += bool(pts.min() >= 0 and pts[0::2].max() < hw[1] - 1
                           and pts[1::2].max() < hw[0] - 1)
            a, b = segm.polygon_record(seg, hw), \
                j_segm.polygon_record(seg, hw)
            assert a[0] == b[0] and a[2] == b[2]
            np.testing.assert_array_equal(a[1], b[1])
        crops = np.clip(crops + rs.normal(0, 0.2, crops.shape), 0, 1)
        results.append(dict(
            boxes=boxes.astype(np.float32), masks=crops.astype(np.float32),
            scores=rs.uniform(0, 1, n).astype(np.float32),
            labels=(anns["labels"][:n] - 1).astype(np.int64),
            valid=np.ones(n, bool)))
    assert inside > 20
    a, b = got_ds.evaluate(results), ref_ds.evaluate(results)
    assert a.keys() == b.keys() and 0.05 < b["segm_mAP"] < 1
    for k in b:
        assert abs(a[k] - b[k]) <= 1e-6, (k, a[k], b[k])
