"""The data layer of the train loop, port against the JAX package (and
OpenCV), on the CPU: PNG read and write (`data/imio.py`), the pipeline's
numpy geometry (`data/np_rboxes.py`, `data/transforms.py`), the train
pipeline (`data/pipeline.py`), the datasets and their builder
(`data/coco.py`, `data/dota.py`, `data/builder.py`) and the loader
(`data/loader.py`).

Tolerances: `imread` equals `cv2.imread` byte for byte; the numpy
copies give equal arrays; `parse_anns` equal arrays; train samples at
1024^2 without a resize: images equal, boxes and rboxes within 1e-5;
with a ``scale_range`` resize (torch bilinear against cv2's fixed
point) images within 1 grey level before normalize and gts within
1e-4; loader batch indices equal for every seed, epoch, shard, shuffle
and drop_last; evaluations within 1e-6.
"""

import glob
import json
import logging
import os
import struct
import zlib

import cv2
import numpy as np
import pytest

from aidet_tpu.data import np_rboxes as ref_np
from aidet_tpu.data import transforms as ref_transforms
from aidet_tpu.data.builder import build_dataset as ref_build_dataset
from aidet_tpu.data.coco import CocoDataset as RefCoco
from aidet_tpu.data.loader import GroupedLoader as RefLoader
from aidet_tpu.data.pipeline import TrainPipeline as RefTrainPipeline
from aidet_tpu.data.pipeline import collate_batch as ref_collate

from aidet_tpu_torch.data import np_rboxes, transforms
from aidet_tpu_torch.data.builder import build_dataset
from aidet_tpu_torch.data.coco import CocoDataset
from aidet_tpu_torch.data.dota import DOTADataset
from aidet_tpu_torch.data.imio import imread, imwrite
from aidet_tpu_torch.data.loader import GroupedLoader
from aidet_tpu_torch.data.pipeline import TrainPipeline, collate_batch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DOTA = os.path.join(REPO, "data", "dota")
# every PNG under data/dota once (train_patches and val_patches link to
# one directory)
PNGS = sorted({os.path.realpath(p) for p in
               glob.glob(os.path.join(DOTA, "**", "*.png"), recursive=True)})
SPLITS = {s: dict(type="DOTADataset",
                  ann_file=os.path.join(DOTA, f"{s}_patches.json"),
                  img_prefix=os.path.join(DOTA, f"{s}_patches"))
          for s in ("train", "val")}


# ---------------------------------------------------------------------
# imio
# ---------------------------------------------------------------------

def test_the_repo_has_pngs():
    assert len(PNGS) >= 16


@pytest.mark.parametrize("path", PNGS, ids=os.path.basename)
def test_imread_equals_cv2(path):
    got, want = imread(path), cv2.imread(path, cv2.IMREAD_COLOR)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(37, 53, 3), (16, 9), (1, 1, 3)])
def test_imwrite_then_imread_is_the_input(tmp_path, shape):
    img = np.random.RandomState(0).randint(0, 256, shape).astype(np.uint8)
    path = str(tmp_path / "x.png")
    imwrite(path, img)
    want = img if img.ndim == 3 else np.repeat(img[..., None], 3, 2)
    np.testing.assert_array_equal(imread(path), want)
    np.testing.assert_array_equal(cv2.imread(path), want)


def _chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _filter_rows(raw, bpp, kinds):
    """PNG row filters of ``raw`` [h, n] uint8 as the spec writes them,
    one filter kind per row."""
    out = []
    prev = np.zeros(raw.shape[1], np.int64)
    for row, kind in zip(raw.astype(np.int64), kinds):
        f = np.zeros_like(row)
        for x in range(len(row)):
            a = row[x - bpp] if x >= bpp else 0
            b, c = prev[x], (prev[x - bpp] if x >= bpp else 0)
            pred = [0, a, b, (a + b) // 2, _paeth(a, b, c)][kind]
            f[x] = (row[x] - pred) % 256
        out.append(bytes([kind]) + f.astype(np.uint8).tobytes())
        prev = row
    return b"".join(out)


def _hand_png(path, colour, kinds, h=6, w=7, seed=0):
    """A PNG of ``colour`` type with the rows filtered by ``kinds`` (one
    per row, cycled); returns the BGR image cv2 reads from it."""
    rs = np.random.RandomState(seed)
    palette = rs.randint(0, 256, (5, 3)).astype(np.uint8)
    channels = {0: 1, 2: 3, 3: 1, 6: 4}[colour]
    pix = rs.randint(0, 5 if colour == 3 else 256,
                     (h, w, channels)).astype(np.uint8)
    rows = _filter_rows(pix.reshape(h, -1), channels,
                        [kinds[y % len(kinds)] for y in range(h)])
    body = [_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0,
                                        0))]
    if colour == 3:
        body.append(_chunk(b"PLTE", palette.tobytes()))
    body += [_chunk(b"IDAT", zlib.compress(rows, 9)), _chunk(b"IEND", b"")]
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + b"".join(body))
    rgb = {0: lambda p: np.repeat(p, 3, 2), 2: lambda p: p,
           3: lambda p: palette[p[..., 0]], 6: lambda p: p[..., :3]}[colour]
    return rgb(pix)[..., ::-1]


@pytest.mark.parametrize("kinds", [[0], [1], [2], [3], [4], [0, 1, 2, 3, 4]],
                         ids=["none", "sub", "up", "average", "paeth",
                              "mixed"])
@pytest.mark.parametrize("colour", [0, 2, 3, 6])
def test_imread_every_filter_and_colour_type(tmp_path, colour, kinds):
    path = str(tmp_path / "hand.png")
    want = _hand_png(path, colour, kinds)
    np.testing.assert_array_equal(imread(path), want)
    np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_COLOR), want)


def test_imread_refuses_what_it_does_not_read(tmp_path):
    path = str(tmp_path / "x.png")
    img = np.zeros((4, 4, 3), np.uint8)
    imwrite(path, img)
    data = open(path, "rb").read()
    ihdr = data.index(b"IHDR") + 4
    for byte, value in ((8, 16), (12, 1), (9, 4)):  # depth, interlace, type
        bad = bytearray(data)
        bad[ihdr + byte] = value
        with open(path, "wb") as f:
            f.write(bytes(bad))
        with pytest.raises(ValueError, match="x.png"):
            imread(path)
    # a JPEG is read now (the host library's decoder): cv2's array
    jpeg = str(tmp_path / "x.jpg")
    cv2.imwrite(jpeg, np.random.RandomState(0).randint(0, 256, (9, 13, 3))
                .astype(np.uint8))
    np.testing.assert_array_equal(imread(jpeg), cv2.imread(jpeg))
    e2e = os.path.join(REPO, "data", "dota_e2e_xl", "train_patches",
                       "P0000__1.0__0___0.jpg")
    np.testing.assert_array_equal(imread(e2e), cv2.imread(e2e))
    with pytest.raises(FileNotFoundError):
        imread(str(tmp_path / "missing.png"))


# ---------------------------------------------------------------------
# numpy geometry and transforms
# ---------------------------------------------------------------------

def _quads(seed, n=40):
    rs = np.random.RandomState(seed)
    tob = np.concatenate([rs.uniform(0, 500, (n, 2)),
                          rs.uniform(2, 90, (n, 2)),
                          rs.uniform(-np.pi / 2, 0, (n, 1))], -1)
    q = ref_np.thetaobb2pointobb(tob.astype(np.float32))
    return np.roll(q, 2 * rs.randint(4), -1).astype(np.float32)


@pytest.mark.parametrize("name", ["pointobb_best_point_sort",
                                  "pointobb2thetaobb", "pointobb2hobb"])
def test_np_rboxes_equal_reference(name):
    q = _quads(0)
    np.testing.assert_array_equal(getattr(np_rboxes, name)(q),
                                  getattr(ref_np, name)(q))
    tob = np_rboxes.pointobb2thetaobb(q)
    np.testing.assert_array_equal(np_rboxes.thetaobb2hobb(tob),
                                  ref_np.thetaobb2hobb(tob))


def test_pointobb_flip_equal_reference():
    q = _quads(1)
    np.testing.assert_array_equal(np_rboxes.pointobb_flip(q, (600, 700)),
                                  ref_np.pointobb_flip(q, (600, 700)))


@pytest.mark.parametrize("k", [0, 1, 2, 3])
def test_random_rotate90_equal_reference(k):
    rs = np.random.RandomState(k)
    img = rs.randint(0, 256, (30, 40, 3)).astype(np.uint8)
    q, b = _quads(k, 5) / 20, rs.uniform(0, 25, (5, 4)).astype(np.float32)
    got = transforms.random_rotate90(img, q, b, k=k)
    want = ref_transforms.random_rotate90(img, q, b, k=k)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------
# datasets
# ---------------------------------------------------------------------

def _assert_anns_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        if isinstance(want[k], np.ndarray):
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k])
        else:
            assert got[k] == want[k], k


@pytest.mark.parametrize("min_area,max_small_length",
                         [(0, 0), (1500, 0), (0, 40)])
@pytest.mark.parametrize("split", ["train", "val"])
def test_parse_anns_equal_reference(split, min_area, max_small_length):
    cfg = dict(SPLITS[split], min_area=min_area,
               max_small_length=max_small_length)
    got, want = build_dataset(cfg), ref_build_dataset(cfg)
    assert len(got) == len(want) and got.CLASSES == want.CLASSES
    assert got.cat2label == want.cat2label
    np.testing.assert_array_equal(got.flag, want.flag)
    kept = 0
    for i in range(len(want)):
        a, b = got.parse_anns(i), want.parse_anns(i)
        _assert_anns_equal(a, b)
        kept += len(a["bboxes"])
    unfiltered = build_dataset(SPLITS[split])
    full = sum(len(unfiltered.parse_anns(i)["bboxes"])
               for i in range(len(unfiltered)))
    assert (kept < full) == bool(min_area or max_small_length)


def _mixed_json(path):
    """Annotations mixing OBB and HBB, crowd, ignored and tiny ones, an
    empty image and a small one."""
    anns = [dict(bbox=[10, 10, 30, 20], category_id=2, area=600,
                 pointobb=[10, 10, 40, 10, 40, 30, 10, 30]),
            dict(bbox=[50, 50, 10, 40], category_id=1, area=400),
            dict(bbox=[5, 5, 8, 8], category_id=2, area=64, iscrowd=1,
                 segmentation=[[5, 5, 13, 5, 13, 13, 5, 13]]),
            dict(bbox=[7, 7, 9, 9], category_id=1, area=81, ignore=1),
            dict(bbox=[1, 1, 0.5, 9], category_id=1, area=4.5),
            dict(bbox=[60, 5, 20, 20], category_id=2, area=400,
                 pointobb=[60, 5, 80, 5, 80, 25, 60, 25])]
    for i, a in enumerate(anns):
        a.update(id=i + 1, image_id=1)
    anns.append(dict(id=9, image_id=3, bbox=[1, 1, 5, 5], category_id=1,
                     area=25))
    data = dict(images=[dict(id=1, file_name="a.png", width=120, height=90),
                        dict(id=2, file_name="b.png", width=90, height=120),
                        dict(id=3, file_name="c.png", width=20, height=20)],
                annotations=anns,
                categories=[dict(id=1, name="x"), dict(id=2, name="y")])
    with open(path, "w") as f:
        json.dump(data, f)


@pytest.mark.parametrize("test_mode", [False, True])
def test_coco_mixed_annotations_equal_reference(tmp_path, test_mode):
    path = str(tmp_path / "mixed.json")
    _mixed_json(path)
    got, want = (C(path, test_mode=test_mode, min_size=32)
                 for C in (CocoDataset, RefCoco))
    assert len(got) == len(want) == (3 if test_mode else 1)
    assert got.CLASSES == want.CLASSES == ("x", "y")
    np.testing.assert_array_equal(got.flag, want.flag)
    for i in range(len(want)):
        _assert_anns_equal(got.parse_anns(i), want.parse_anns(i))


def _results(ds, seed, n=12, labels=np.int64):
    """Per-image padded results near each image's gt boxes."""
    rs = np.random.RandomState(seed)
    out = []
    for i in range(len(ds)):
        anns = ds.parse_anns(i)
        k = min(n, len(anns["bboxes"]))
        boxes = np.zeros((n, 4), np.float32)
        boxes[:k] = anns["bboxes"][:k] + rs.normal(0, 2, (k, 4))
        lab = np.zeros(n, labels)
        lab[:k] = anns["labels"][:k] - 1
        lab[k // 2:k] = rs.randint(0, 15, k - k // 2)
        valid = np.zeros(n, bool)
        valid[:k] = True
        out.append(dict(boxes=boxes, scores=rs.uniform(0, 1, n).astype(
            np.float32), labels=lab, valid=valid))
    return out


@pytest.mark.parametrize("labels", [np.int32, np.int64])
def test_coco_results2json_and_evaluate_equal_reference(tmp_path, labels):
    got, want = build_dataset(SPLITS["val"]), ref_build_dataset(SPLITS["val"])
    results = _results(want, 0, labels=labels)
    got.results2json(results, str(tmp_path / "a.json"))
    want.results2json(results, str(tmp_path / "b.json"))
    assert json.load(open(tmp_path / "a.json")) == json.load(
        open(tmp_path / "b.json"))
    a, b = got.evaluate(results), want.evaluate(results)
    assert a.keys() == b.keys() and 0 < b["mAP"] < 1
    for k in b:
        assert abs(a[k] - b[k]) <= 1e-6, (k, a[k], b[k])


def test_dota_format_merge_and_evaluate_equal_reference(tmp_path):
    got, want = build_dataset(SPLITS["val"]), ref_build_dataset(SPLITS["val"])
    rs = np.random.RandomState(3)
    dets, names = [], []
    for i in range(len(want)):
        anns = want.parse_anns(i)
        q = anns["pointobbs"] + rs.normal(0, 1.5, anns["pointobbs"].shape)
        dets.append(dict(boxes=q.astype(np.float32),
                         scores=rs.uniform(0, 1, len(q)).astype(np.float32),
                         labels=(anns["labels"] - 1).astype(np.int64),
                         valid=np.ones(len(q), bool)))
        names.append(want.img_infos[i]["file_name"])
    names[1] = "P9__0.5__100___200.png"   # a rescaled patch
    a = got.merge_patches_to_scenes(dets, names)
    b = want.merge_patches_to_scenes(dets, names)
    assert a.keys() == b.keys()
    for scene in b:
        for k in b[scene]:
            np.testing.assert_array_equal(a[scene][k], b[scene][k])
    gts = json.load(open(os.path.join(DOTA, "val_patches_scene_gt_obb.json")))
    gts = {k: {f: np.asarray(v) for f, v in g.items()} for k, g in gts.items()}
    (ma, aps_a), (mb, aps_b) = (d.evaluate_scenes(a, gts)
                                for d in (got, want))
    assert 0 < mb < 1 and abs(ma - mb) <= 1e-6 and aps_a.keys() == aps_b.keys()
    got.format_results_txt(a, str(tmp_path / "a"))
    want.format_results_txt(b, str(tmp_path / "b"))
    files = sorted(os.listdir(tmp_path / "b"))
    assert sorted(os.listdir(tmp_path / "a")) == files and len(files) == 15
    for f in files:
        assert (open(tmp_path / "a" / f).read()
                == open(tmp_path / "b" / f).read()), f


@pytest.mark.parametrize("cfg", [dict(type="RepeatDataset", times=2,
                                      dataset=SPLITS["train"]),
                                 dict(type="VOCDataset", ann_file="x"),
                                 [SPLITS["train"], SPLITS["val"]]],
                         ids=["repeat", "voc", "concat"])
def test_build_dataset_names_what_is_not_ported(cfg):
    """The wrappers and the VOC dataset are ported: a RepeatDataset
    config and a list build as the reference builds them, and a VOC
    config whose id list is missing raises the reference's
    FileNotFoundError.  A type no package registers still raises the
    KeyError that names it not ported."""
    with pytest.raises(KeyError, match="LVISDataset .*not yet ported"):
        build_dataset(dict(type="LVISDataset", ann_file="x"))
    if isinstance(cfg, dict) and cfg["type"] == "VOCDataset":
        for build in (build_dataset, ref_build_dataset):
            with pytest.raises(FileNotFoundError):
                build(cfg)
        return
    got, want = build_dataset(cfg), ref_build_dataset(cfg)
    assert type(got).__name__ == type(want).__name__
    assert len(got) == len(want) > 0
    np.testing.assert_array_equal(got.flag, want.flag)
    assert got.img_infos == want.img_infos
    for i in (0, len(got) - 1):
        assert got.img_path(i) == want.img_path(i)
        _assert_anns_equal(got.parse_anns(i), want.parse_anns(i))


# ---------------------------------------------------------------------
# train pipeline
# ---------------------------------------------------------------------

PIPELINES = {
    "default": dict(),
    "flip": dict(flip_ratio=1.0, max_gt=32),
    "rotate90": dict(rotate90_ratio=1.0),
    "pointobb": dict(rbox_encode="pointobb", flip_ratio=1.0,
                     rotate90_ratio=0.5),
    "hobb": dict(rbox_encode="hobb", rotate90_ratio=0.5),
    "device_normalize": dict(device_normalize=True, rotate90_ratio=1.0),
}


@pytest.fixture(scope="module")
def train_samples():
    """Three train patches (1024^2) with their annotations, read by
    both packages' readers."""
    ds = ref_build_dataset(SPLITS["train"])
    return [(imread(ds.img_path(i)), cv2.imread(ds.img_path(i)),
             ds.parse_anns(i)) for i in (0, 5, 9)]


@pytest.mark.parametrize("name", PIPELINES)
def test_train_pipeline_equal_reference(train_samples, name):
    kw = dict(PIPELINES[name], seed=7)
    got, want = TrainPipeline(**kw), RefTrainPipeline(**kw)
    for ours, theirs, anns in train_samples * 2:
        a, b = got(ours, anns), want(theirs, anns)
        assert a.keys() == b.keys()
        for k in ("imgs", "gt_labels", "gt_valid", "img_shapes"):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        for k in ("gt_boxes", "gt_rboxes"):
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-5,
                                       err_msg=k)


def test_train_pipeline_scale_range_within_a_grey_level(train_samples):
    kw = dict(scale_range=(600, 900), device_normalize=True, seed=3,
              rotate90_ratio=0.5)
    got, want = TrainPipeline(**kw), RefTrainPipeline(**kw)
    for ours, theirs, anns in train_samples:
        a, b = got(ours, anns), want(theirs, anns)
        np.testing.assert_array_equal(a["img_shapes"], b["img_shapes"])
        assert a["img_shapes"][0] < 1024
        diff = np.abs(a["imgs"].astype(int) - b["imgs"].astype(int))
        assert diff.max() <= 1
        for k in ("gt_boxes", "gt_rboxes"):
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-4,
                                       err_msg=k)


def test_train_pipeline_without_pointobbs_has_the_zero_slot(train_samples):
    img, _, anns = train_samples[0]
    anns = {k: v for k, v in anns.items() if k != "pointobbs"}
    a = TrainPipeline(max_gt=64)(img, anns)
    b = RefTrainPipeline(max_gt=64)(img, anns)
    assert a["gt_rboxes"].shape == (64, 5) and not a["gt_rboxes"].any()
    np.testing.assert_array_equal(a["gt_boxes"], b["gt_boxes"])


@pytest.mark.parametrize("option", [
    "with_mask", "with_mask_weight", "with_reverse_mask_weight",
    "with_semantic", "with_heatmap_weight", "albu", "instaboost"])
def test_train_pipeline_later_options_raise(option, train_samples):
    """Every option is ported now.  albu: a DOTA sample carries its
    polygons, which the stage cannot move, so both packages raise the
    same ValueError; without them both give the same sample.
    InstaBoost: the same sample as the reference's (held stage by stage
    in tests/test_torch_port_augment.py).  The mask family's options
    came with the CenterMap slice: each makes its target, as the
    reference's pipeline does (held value by value in
    tests/test_torch_port_mask_targets.py)."""
    if option in ("albu", "instaboost"):
        img, _, anns = train_samples[1]
        kw = dict(max_gt=64, seed=3, **{option: (
            [dict(type="ChannelShuffle", p=1.0)] if option == "albu"
            else dict(aug_ratio=1.0, dx=4, dy=4))})
        got, want = TrainPipeline(**kw), RefTrainPipeline(**kw)
        if option == "albu":
            for pipe in (got, want):
                with pytest.raises(ValueError, match="'bboxes_ignore'"):
                    pipe(img, anns)
            anns = {k: v for k, v in anns.items()
                    if k not in ("segmentations", "bboxes_ignore")}
        a, b = got(img, anns), want(img, anns)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        return
    key = dict(with_mask="gt_masks", with_mask_weight="gt_mask_weights",
               with_reverse_mask_weight="gt_mask_weights",
               with_semantic="gt_semantic",
               with_heatmap_weight="gt_seg_weights")[option]
    img, _, anns = train_samples[0]
    kw = dict(max_gt=64, img_size=256, **{option: True})
    got = TrainPipeline(**kw)(img, anns)
    want = RefTrainPipeline(**kw)(img, anns)
    assert set(got) == set(want) and key in got
    assert got[key].shape == want[key].shape and got[key].any()


def test_collate_batch_equal_reference(train_samples):
    img, _, anns = train_samples[1]
    samples = [TrainPipeline(flip_ratio=1.0, seed=s)(img, anns)
               for s in range(2)]
    a, b = collate_batch(samples), ref_collate(samples)
    for k in b:
        assert a[k].flags["C_CONTIGUOUS"]
        np.testing.assert_array_equal(a[k], b[k])


# ---------------------------------------------------------------------
# loader
# ---------------------------------------------------------------------

@pytest.mark.parametrize("num_shards", [1, 2, 3])
@pytest.mark.parametrize("drop_last", [True, False])
def test_loader_batches_equal_reference(num_shards, drop_last):
    ds = ref_build_dataset(SPLITS["train"])
    ds.flag = (np.arange(len(ds)) % 3 == 0).astype(np.uint8)
    for seed in (0, 5):
        for epoch in (0, 1, 7):
            for shuffle in (True, False):
                for bs in (2, 3):
                    for shard in range(num_shards):
                        kw = dict(batch_size=bs, shuffle=shuffle, seed=seed,
                                  num_shards=num_shards, shard_id=shard,
                                  drop_last=drop_last)
                        a, b = GroupedLoader(ds, None, **kw), RefLoader(
                            ds, None, **kw)
                        a.set_epoch(epoch)
                        b.set_epoch(epoch)
                        ca, cb = a._chunks(), b._chunks()
                        assert len(a) == len(b) == len(cb)
                        assert [c.tolist() for c in ca] == [
                            c.tolist() for c in cb], kw


def test_loader_yields_the_reference_batches():
    """One decode worker, so that the pipelines' shared random stream
    gives each sample the same draw (with more workers, which sample
    takes which draw follows the threads' timing, in both packages)."""
    kw = dict(batch_size=3, seed=2, num_workers=1, drop_last=False,
              shuffle=False)
    a = GroupedLoader(build_dataset(SPLITS["val"]),
                      TrainPipeline(img_size=1024, seed=4), **kw)
    b = RefLoader(ref_build_dataset(SPLITS["val"]),
                  RefTrainPipeline(img_size=1024, seed=4), **kw)
    got, want = list(a), list(b)
    assert len(got) == len(want) == 4
    for x, y in zip(got, want):
        for k in y:
            np.testing.assert_allclose(x[k], y[k], rtol=0, atol=1e-5)


def test_loader_reads_a_missing_image_as_zeros_and_logs_it_once(
        tmp_path, caplog):
    ann = json.load(open(SPLITS["val"]["ann_file"]))
    ann["images"] = ann["images"][:2]
    ann["images"][1]["file_name"] = "missing.png"
    path = tmp_path / "two.json"
    path.write_text(json.dumps(ann))
    ds = DOTADataset(str(path), img_prefix=SPLITS["val"]["img_prefix"])
    loader = GroupedLoader(ds, TrainPipeline(device_normalize=True), 1,
                           shuffle=False, num_workers=2)
    with caplog.at_level(logging.WARNING, logger="aidet_tpu_torch"):
        for epoch in range(2):
            loader.set_epoch(epoch)
            batches = list(loader)
    assert len(batches) == 2
    assert not batches[1]["imgs"].any() and batches[0]["imgs"].any()
    missing = [r for r in caplog.records if "missing.png" in r.getMessage()]
    assert len(missing) == 1
