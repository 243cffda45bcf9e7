"""The train stages of the PyTorch port against the JAX package on the
CPU: the vendored albumentations subset (`data/_vendor_albu.py`), the
albu stage (`data/albu.py`), InstaBoost (`data/instaboost.py`) with its
Telea inpaint (`csrc/inpaint.cpp` through `data/hostlib.py`) and affine
warp (`data/raster.py`), and `TrainPipeline` with each stage.

Geometry is exact: for one seed each transform draws the reference's
numbers, so boxes, labels, keypoints, polygons and pointobbs equal the
reference's bit for bit.  Pixel limits:
- RandomBrightnessContrast, ChannelShuffle, Blur (OpenCV's box filter)
  and MedianBlur: equal.
- ShiftScaleRotate (`raster.warp_affine` against cv2.warpAffine,
  INTER_LINEAR, BORDER_REFLECT_101): equal on images whose width is a
  multiple of 16, where OpenCV's vectorised loop covers every column
  whatever its SIMD width; elsewhere at most 1 grey level off on at
  most 0.1% of the values (OpenCV's scalar tail rounds its coordinates
  once more where its SIMD width ends: equal where OpenCV runs its
  AVX-512 code).
- InstaBoost: outside the instances' holes equal; inside them the
  Telea fill against cv2.inpaint's within 1 grey level with a mean
  |difference| of at most 0.02 (equal here), limits that filling a hole
  with the mean of its border fails (checked); `inpaint_telea` alone
  equals `cv2.inpaint(..., 3, INPAINT_TELEA)` on seeded images and
  masks, across the image border too.
- `TrainPipeline` with InstaBoost or albu: every array of the sample
  equal to the reference's.
"""

import os

import cv2
import numpy as np
import pytest

from aidet_tpu.data import _vendor_albu as ref_vendor
from aidet_tpu.data.albu import AlbuTransform as RefAlbu
from aidet_tpu.data.instaboost import InstaBoost as RefInstaBoost
from aidet_tpu.data.pipeline import TrainPipeline as RefTrainPipeline

from aidet_tpu_torch.data import _vendor_albu as vendor
from aidet_tpu_torch.data.albu import AlbuTransform
from aidet_tpu_torch.data.hostlib import inpaint_telea
from aidet_tpu_torch.data.imio import imread
from aidet_tpu_torch.data.instaboost import InstaBoost, _poly_mask
from aidet_tpu_torch.data.pipeline import TrainPipeline
from aidet_tpu_torch.data.raster import rotation_matrix_2d, warp_affine
from aidet_tpu_torch.utils.config import Config
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALBU_CONFIG = os.path.join(REPO, "configs", "mask_rcnn_r50_fpn_albu_1x.py")
FIXTURE = os.path.join(REPO, "tests", "fixtures", "jpeg", "dota",
                       "P0212__1.0__384___384.jpg")
TAIL_MAX, TAIL_SHARE = 1, 1e-3      # warps of widths not a multiple of 16
HOLE_MAX, HOLE_MEAN = 1, 0.02       # the Telea fill against cv2.inpaint


def scene(h, w, seed):
    rs = np.random.RandomState(seed)
    img = rs.randint(0, 256, (h, w, 3)).astype(np.uint8)
    return cv2.GaussianBlur(img, (7, 7), 2.5)


def sample(seed, h=192, w=256, n=6, segs=True):
    """A seeded image with ``n`` convex hexagon instances: boxes, labels,
    pointobbs and (with ``segs``) their polygons, one of them without."""
    rs = np.random.RandomState(seed)
    polys, boxes, pobbs = [], [], []
    for i in range(n):
        cx, cy = rs.uniform(20, w - 20), rs.uniform(20, h - 20)
        r = rs.uniform(6, 24)
        ang = np.sort(rs.uniform(0, 2 * np.pi, 6))
        pts = np.stack([cx + r * np.cos(ang), cy + r * np.sin(ang)], 1)
        polys.append([pts.reshape(-1).tolist()] if i != 2 else [])
        boxes.append([*pts.min(0), *pts.max(0)])
        pobbs.append(pts[:4].reshape(-1))
    anns = dict(bboxes=np.asarray(boxes, np.float32),
                labels=rs.randint(1, 9, n).astype(np.int32),
                pointobbs=np.asarray(pobbs, np.float32))
    if segs:
        anns["segmentations"] = polys
    return scene(h, w, seed), anns


def assert_warp_close(got, want, w):
    if w % 16 == 0:
        np.testing.assert_array_equal(got, want)
        return
    d = np.abs(got.astype(int) - want.astype(int))
    assert d.max() <= TAIL_MAX and (d > 0).mean() <= TAIL_SHARE


# ---------------------------------------------------------------------
# the vendored albumentations subset
# ---------------------------------------------------------------------

TRANSFORMS = {
    "ShiftScaleRotate": dict(shift_limit=0.1, scale_limit=0.2,
                             rotate_limit=40, interpolation=1),
    "ShiftScaleRotate_nearest": dict(shift_limit=0.0625, scale_limit=0.0,
                                     rotate_limit=15, interpolation=0),
    "RandomBrightnessContrast": dict(brightness_limit=(0.1, 0.3),
                                     contrast_limit=0.3),
    "ChannelShuffle": dict(),
    "Blur": dict(blur_limit=7),
    "MedianBlur": dict(blur_limit=7),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
@pytest.mark.parametrize("hw", [(96, 128), (77, 101)], ids=["w128", "w101"])
def test_vendored_transform_equals_reference(name, hw):
    kind = name.split("_")[0]
    got_t = getattr(vendor, kind)(p=1.0, **TRANSFORMS[name])
    want_t = getattr(ref_vendor, kind)(p=1.0, **TRANSFORMS[name])
    for seed in range(3):
        img, anns = sample(seed, *hw)
        data = [dict(image=img.copy(), bboxes=anns["bboxes"].copy(),
                     keypoints=anns["pointobbs"].reshape(-1, 2).copy())
                for _ in range(2)]
        rngs = [np.random.RandomState(seed) for _ in range(2)]
        got_t.apply(data[0], rngs[0])
        want_t.apply(data[1], rngs[1])
        assert rngs[0].randint(1 << 30) == rngs[1].randint(1 << 30)
        for k in ("bboxes", "keypoints"):
            assert data[0][k].dtype == data[1][k].dtype, k
            np.testing.assert_array_equal(data[0][k], data[1][k], err_msg=k)
        if kind == "ShiftScaleRotate":
            assert_warp_close(data[0]["image"], data[1]["image"], hw[1])
        else:
            np.testing.assert_array_equal(data[0]["image"], data[1]["image"])


def test_rotation_matrix_equals_opencv():
    rs = np.random.RandomState(0)
    for _ in range(20):
        c = tuple(rs.uniform(0, 500, 2))
        ang, s = rs.uniform(-180, 180), rs.uniform(0.5, 2)
        np.testing.assert_array_equal(rotation_matrix_2d(c, ang, s),
                                      cv2.getRotationMatrix2D(c, ang, s))


@pytest.mark.parametrize("w", [96, 131])
def test_warp_affine_equals_opencv(w):
    """Linear (3 channels) with a reflect-101 and a zero border, nearest
    (1 and 3 channels), a window that covers what the mask can reach."""
    rs = np.random.RandomState(w)
    for _ in range(4):
        h = rs.randint(20, 120)
        img = scene(h, w, rs.randint(1000))
        m = cv2.getRotationMatrix2D(tuple(rs.uniform(0, 100, 2)),
                                    rs.uniform(-60, 60), rs.uniform(0.7, 1.4))
        m[:, 2] += rs.uniform(-20, 20, 2)
        for flags, border, reflect in (
                (cv2.INTER_LINEAR, cv2.BORDER_REFLECT_101, True),
                (cv2.INTER_LINEAR, cv2.BORDER_CONSTANT, False)):
            assert_warp_close(
                warp_affine(img, m, (h, w), reflect=reflect),
                cv2.warpAffine(img, m, (w, h), flags=flags,
                               borderMode=border), w)
        mask = (rs.rand(h, w) > 0.6).astype(np.uint8)
        for src in (mask, img):
            np.testing.assert_array_equal(
                warp_affine(src, m, (h, w), nearest=True),
                cv2.warpAffine(src, m, (w, h), flags=cv2.INTER_NEAREST))


def albu_list():
    cfg = Config.fromfile(ALBU_CONFIG)
    return cfg.train_pipeline.albu


@pytest.mark.parametrize("transforms", ["config", "strong"])
def test_albu_transform_equals_reference(transforms):
    """The albu config's list, and one whose every transform fires often
    (a rotation that pushes boxes off the canvas, so that some drop)."""
    if transforms == "config":
        cfgs = albu_list()
    else:
        cfgs = [dict(type="ShiftScaleRotate", shift_limit=0.45,
                     scale_limit=0.3, rotate_limit=60, p=0.9),
                dict(type="RandomBrightnessContrast", p=0.5),
                dict(type="ChannelShuffle", p=0.5),
                dict(type="OneOf", p=0.8, transforms=[
                    dict(type="Blur", blur_limit=5, p=1.0),
                    dict(type="MedianBlur", blur_limit=5, p=2.0)])]
    got, want = AlbuTransform(cfgs), RefAlbu(cfgs)
    dropped = changed = 0
    for seed in range(8):
        img, anns = sample(seed, 128, 176)
        a = got(img, anns["bboxes"], anns["labels"], anns["pointobbs"])
        b = want(img, anns["bboxes"], anns["labels"], anns["pointobbs"])
        np.testing.assert_array_equal(a[0], b[0])
        for x, y in zip(a[1:], b[1:]):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
        dropped += len(a[1]) < len(anns["bboxes"])
        changed += not np.array_equal(a[0], img)
    assert changed > 0
    assert transforms == "config" or dropped > 0


def test_albu_outside_the_subset_raises():
    for cls in (AlbuTransform, RefAlbu):
        with pytest.raises(ImportError, match="'CLAHE'"):
            cls([dict(type="OneOf", transforms=[dict(type="CLAHE")])])


# ---------------------------------------------------------------------
# InstaBoost
# ---------------------------------------------------------------------

def test_inpaint_equals_opencv():
    """Seeded masks inside the image and across its border, 1 and 3
    channels, radius 3 and 5."""
    rs = np.random.RandomState(0)
    for k in range(12):
        h, w = rs.randint(16, 90, 2)
        img = scene(h, w, k)
        img = img[..., 0].copy() if k % 4 == 3 else img
        mask = np.zeros((h, w), np.uint8)
        for _ in range(rs.randint(1, 4)):
            pts = rs.randint(-8, max(h, w) + 8, (rs.randint(3, 7), 2))
            cv2.fillPoly(mask, [pts.astype(np.int32)], 1)
        radius = 5 if k % 3 == 2 else 3
        np.testing.assert_array_equal(
            inpaint_telea(img, mask, radius),
            cv2.inpaint(img, mask, radius, cv2.INPAINT_TELEA), err_msg=str(k))


def _hole_errors(got, want, hole):
    d = np.abs(got.astype(int) - want.astype(int))[hole]
    return d.max(initial=0), d.mean() if d.size else 0.0


def test_inpaint_limits_catch_a_mean_fill():
    """The hole limits hold for the port's fill, and a fill of the hole
    with the mean of its border ring fails them."""
    img = imread(FIXTURE)
    anns_mask = np.zeros(img.shape[:2], np.uint8)
    cv2.fillPoly(anns_mask, [np.array([[100, 120], [180, 110], [200, 190],
                                       [120, 210]], np.int32)], 1)
    want = cv2.inpaint(img, anns_mask, 3, cv2.INPAINT_TELEA)
    hole = anns_mask.astype(bool)
    got = inpaint_telea(img, anns_mask, 3)
    m, mean = _hole_errors(got, want, hole)
    assert m <= HOLE_MAX and mean <= HOLE_MEAN
    ring = cv2.dilate(anns_mask, np.ones((3, 3), np.uint8)).astype(bool) & ~hole
    flat = img.copy()
    flat[hole] = np.round(img[ring].mean(0)).astype(np.uint8)
    m, mean = _hole_errors(flat, want, hole)
    assert m > HOLE_MAX and mean > HOLE_MEAN


@pytest.mark.parametrize("kw", [
    dict(aug_ratio=1.0),
    dict(aug_ratio=1.0, action_candidate=("normal", "horizontal", "skip"),
         action_prob=(1, 1, 1), dx=30, dy=30, theta=(-20, 20)),
    dict(aug_ratio=0.5, color_prob=1.0)], ids=["default", "actions", "half"])
def test_instaboost_equals_reference(kw):
    """Affines, boxes, polygons and pointobbs exact; the pixels outside
    the instances' holes exact, inside them within the hole limits."""
    got_t, want_t = InstaBoost(seed=4, **kw), RefInstaBoost(seed=4, **kw)
    augmented = 0
    for seed in range(6):
        img, anns = sample(seed)
        a_img, a = got_t(img.copy(), anns)
        b_img, b = want_t(img.copy(), anns)
        assert a.keys() == b.keys()
        for k in ("bboxes", "labels", "pointobbs"):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert a["segmentations"] == b["segmentations"]
        holes = np.zeros(img.shape[:2], bool)
        for segs in anns["segmentations"]:
            if segs:
                holes |= _poly_mask(segs, *img.shape[:2]).astype(bool)
        np.testing.assert_array_equal(a_img[~holes], b_img[~holes])
        m, mean = _hole_errors(a_img, b_img, holes)
        assert m <= HOLE_MAX and mean <= HOLE_MEAN
        augmented += a["segmentations"] != anns["segmentations"]
    assert augmented > 0
    assert got_t.rng.randint(1 << 30) == want_t.rng.randint(1 << 30)


def test_instaboost_on_a_dota_patch_equals_reference():
    """A real 512^2 patch (a fixture JPEG) with its instances, every
    action: the whole image equal."""
    img = imread(FIXTURE)
    _, anns = sample(11, 512, 512, n=8)
    kw = dict(aug_ratio=1.0, action_prob=(1, 1, 0))
    a_img, a = InstaBoost(seed=2, **kw)(img.copy(), anns)
    b_img, b = RefInstaBoost(seed=2, **kw)(img.copy(), anns)
    np.testing.assert_array_equal(a_img, b_img)
    np.testing.assert_array_equal(a["bboxes"], b["bboxes"])
    assert not np.array_equal(a_img, img)


# ---------------------------------------------------------------------
# TrainPipeline with each stage
# ---------------------------------------------------------------------

@pytest.mark.parametrize("stage", ["instaboost", "albu", "both"])
def test_train_pipeline_stages_equal_reference(stage):
    """InstaBoost first, then albu, before the resize (192 x 256 images
    into 256^2, so no resize); albu on samples without polygons or
    ignored boxes, as the stage requires."""
    kw = dict(img_size=256, max_gt=8, seed=5, rotate90_ratio=0.5)
    if stage in ("instaboost", "both"):
        kw["instaboost"] = dict(aug_ratio=1.0, dx=8, dy=8)
    if stage in ("albu", "both"):
        kw["albu"] = [dict(type="ShiftScaleRotate", rotate_limit=20, p=0.8),
                      dict(type="ChannelShuffle", p=0.5)]
    got, want = TrainPipeline(**kw), RefTrainPipeline(**kw)
    for seed in range(4):
        img, anns = sample(seed, segs=stage == "instaboost")
        if stage == "both":
            # InstaBoost moves the polygons; albu then refuses the sample
            # that carries them, as the reference does
            for pipe in (got, want):
                with pytest.raises(ValueError, match="'segmentations'"):
                    pipe(*sample(seed))
        a, b = got(img, anns), want(img, anns)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
