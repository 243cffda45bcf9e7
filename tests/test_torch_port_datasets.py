"""The data layer's datasets and wrappers of the PyTorch port against the
JAX package on the CPU: `XMLDataset`, `VOCDataset` and
`WIDERFaceDataset` on XML trees written here, `BuildChangeDataset` and
`CityscapesDataset` on COCO-format JSON written here, `ConcatDataset`
and `RepeatDataset` through `build_dataset`, the loader's batches over
a `ConcatDataset`, and the VOC config's path as a whole: its list of two
VOC datasets over JPEGs, the first loader batch, and one train step of
its small architecture.

Tolerances: the datasets' `len`, `img_infos`, `flag`, `img_path` and
`parse_anns` equal (arrays of the same dtype, bit for bit); the loader's
batch indices equal for 2 seeds and 2 epochs; the first batch equal
array for array (the JPEGs are read by the port's decoder and by
cv2.imread, which agree bit for bit); the train step of the small
FasterRCNN with 21 classes (ResNet-18, a 64-channel FPN, 128^2, the
reference's seeded variables carried over by the weight bridge, a
train_cfg that keeps every candidate): losses within 1e-4 relative (the
HBB family's limit, tests/test_torch_port_faster.py), the gradient of
their sum within 1e-3 relative L2 and each leaf within 1e-2 of its
largest magnitude (chip_smoke's reference_train limits for an update;
read here: 4.9e-4, and 7.5e-3 on layer2's first conv, whose gradient is
small beside its weights').
"""

import glob
import json
import os

import cv2
import numpy as np
import pytest

from aidet_tpu.core.eval.class_names import VOC_CLASSES
from aidet_tpu.data import voc as ref_voc
from aidet_tpu.data.buildchange import BuildChangeDataset as RefBuildChange
from aidet_tpu.data.buildchange import CityscapesDataset as RefCityscapes
from aidet_tpu.data.builder import build_dataset as ref_build_dataset
from aidet_tpu.data.loader import GroupedLoader as RefLoader
from aidet_tpu.data.pipeline import TrainPipeline as RefTrainPipeline

from aidet_tpu_torch.data import voc
from aidet_tpu_torch.data.buildchange import (BuildChangeDataset,
                                              CityscapesDataset)
from aidet_tpu_torch.data.builder import build_dataset
from aidet_tpu_torch.data.loader import GroupedLoader
from aidet_tpu_torch.data.pipeline import TrainPipeline
from aidet_tpu_torch.utils.config import Config
from torch_port_helpers import to_np
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)
from torch_port_pairs import (G, IMG, assert_grads_close,
                              assert_losses_close, hbb_cfg,
                              port_loss_and_grads, ref_loss_and_grads,
                              shaped_pair)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOC_CONFIG = os.path.join(REPO, "configs", "faster_rcnn_r50_fpn_1x_voc0712.py")
ALBU_CONFIG = os.path.join(REPO, "configs", "mask_rcnn_r50_fpn_albu_1x.py")


def write_xml(path, w, h, objects):
    """A VOC annotation: its size and (name, difficult or None, box)
    objects."""
    rows = [f"<annotation><size><width>{w}</width><height>{h}</height>"
            "<depth>3</depth></size>"]
    for name, difficult, (x1, y1, x2, y2) in objects:
        d = "" if difficult is None else f"<difficult>{difficult}</difficult>"
        rows.append(f"<object><name>{name}</name>{d}<bndbox><xmin>{x1}"
                    f"</xmin><ymin>{y1}</ymin><xmax>{x2}</xmax><ymax>{y2}"
                    "</ymax></bndbox></object>")
    rows.append("</annotation>")
    with open(path, "w") as f:
        f.write("".join(rows))


def write_xml_tree(root, seed, n, names, sizes=None, images=False,
                   max_objects=6, missing=True, sides=(4, 16, 17, 80)):
    """A VOC-style directory under ``root``: ``train.txt`` (ids, a blank
    line, with ``missing`` a last id without an XML),
    Annotations/<id>.xml with seeded objects of ``names`` and one unknown
    name, some difficult, some without a difficult tag, their sides in
    [sides[0], sides[1]) or [sides[2], sides[3]) (under 17 px or not by
    default); with ``images`` the JPEGImages/<id>.jpg of each size.
    Returns the txt's path."""
    rs = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, "Annotations"), exist_ok=True)
    os.makedirs(os.path.join(root, "JPEGImages"), exist_ok=True)
    ids = [f"{seed:02d}_{i:04d}" for i in range(n)]
    for k, i in enumerate(ids[:-1] if missing else ids):
        h, w = sizes[k % len(sizes)] if sizes else rs.randint(60, 400, 2)
        objects = []
        for _ in range(rs.randint(1, max_objects + 1)):
            x1, y1 = rs.randint(0, w - 12), rs.randint(0, h - 12)
            bw, bh = (rs.choice([rs.randint(*sides[:2]),
                                 rs.randint(*sides[2:])]) for _ in "wh")
            box = (x1, y1, min(x1 + bw, w - 1), min(y1 + bh, h - 1))
            name = names[rs.randint(len(names))] if rs.rand() > 0.1 \
                else "unicorn"
            objects.append((name, [0, 1, None][rs.choice(3, p=[.7, .2, .1])],
                            box))
        write_xml(os.path.join(root, "Annotations", f"{i}.xml"), w, h,
                  objects)
        if images:
            img = rs.randint(0, 256, (h, w, 3)).astype(np.uint8)
            img = cv2.GaussianBlur(img, (5, 5), 1.5)
            cv2.imwrite(os.path.join(root, "JPEGImages", f"{i}.jpg"), img,
                        [cv2.IMWRITE_JPEG_QUALITY, 90])
    txt = os.path.join(root, "train.txt")
    with open(txt, "w") as f:
        f.write("\n".join(ids[:2] + [""] + ids[2:]) + "\n")
    return txt


def write_coco(path, seed, n, categories):
    """COCO-format JSON of ``n`` seeded images with polygon instances of
    ``categories`` ((id, name) pairs), some crowd, some ignored, some
    tiny, and one image without annotations."""
    rs = np.random.RandomState(seed)
    images, anns = [], []
    for i in range(n):
        h, w = rs.randint(40, 300, 2)
        images.append(dict(id=i + 1, file_name=f"img{i}.jpg", width=int(w),
                           height=int(h)))
        if i == n - 1:
            continue
        for _ in range(rs.randint(1, 6)):
            x, y = rs.uniform(0, w - 20), rs.uniform(0, h - 20)
            bw, bh = rs.uniform(0.5, 40, 2)
            poly = [x, y, x + bw, y, x + bw, y + bh, x, y + bh]
            anns.append(dict(
                id=len(anns) + 1, image_id=i + 1,
                category_id=int(categories[rs.randint(len(categories))][0]),
                bbox=[x, y, bw, bh], area=bw * bh, segmentation=[poly],
                iscrowd=int(rs.rand() < 0.15), ignore=int(rs.rand() < 0.1)))
    with open(path, "w") as f:
        json.dump(dict(images=images, annotations=anns, categories=[
            dict(id=int(c), name=nm) for c, nm in categories]), f)
    return path


def assert_anns_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        if isinstance(want[k], np.ndarray):
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            assert got[k] == want[k], k


def assert_datasets_equal(got, want):
    assert type(got).__name__ == type(want).__name__
    assert len(got) == len(want) > 0
    assert tuple(got.CLASSES) == tuple(want.CLASSES)
    assert got.img_infos == want.img_infos
    np.testing.assert_array_equal(got.flag, want.flag)
    assert got.flag.dtype == want.flag.dtype
    for i in range(len(want)):
        assert got.img_path(i) == want.img_path(i)
        assert_anns_equal(got.parse_anns(i), want.parse_anns(i))


@pytest.mark.parametrize("name", ["VOCDataset", "WIDERFaceDataset",
                                  "XMLDataset"])
@pytest.mark.parametrize("test_mode", [False, True])
def test_xml_datasets_equal_reference(tmp_path, name, test_mode):
    names = ("face",) if name == "WIDERFaceDataset" else VOC_CLASSES
    txt = write_xml_tree(str(tmp_path), 3, 12, names)
    kw = dict(ann_file=txt, img_prefix=str(tmp_path), test_mode=test_mode)
    got, want = getattr(voc, name)(**kw), getattr(ref_voc, name)(**kw)
    assert_datasets_equal(got, want)
    if name == "WIDERFaceDataset":
        assert got.min_size == 17
    if name != "XMLDataset":       # no class of its own: nothing kept
        assert sum(len(got.parse_anns(i)["bboxes_ignore"])
                   for i in range(len(got))) > 0


@pytest.mark.parametrize("cls,ref_cls,cats", [
    (BuildChangeDataset, RefBuildChange, [(1, "building")]),
    (CityscapesDataset, RefCityscapes,
     [(24 + k, n) for k, n in enumerate(RefCityscapes.CLASSES)])],
    ids=["buildchange", "cityscapes"])
@pytest.mark.parametrize("test_mode", [False, True])
def test_coco_format_datasets_equal_reference(tmp_path, cls, ref_cls, cats,
                                              test_mode):
    path = write_coco(str(tmp_path / "a.json"), 5, 10, cats)
    kw = dict(ann_file=path, img_prefix="images", test_mode=test_mode)
    got, want = cls(**kw), ref_cls(**kw)
    assert_datasets_equal(got, want)
    assert got.CLASSES == want.CLASSES == tuple(
        n for _, n in cats if cls is BuildChangeDataset) or \
        got.CLASSES == RefCityscapes.CLASSES


def _voc_pair(root):
    """Two VOC datasets' configs (VOC2007, VOC2012) under ``root``."""
    cfgs = []
    for k, year in enumerate(("VOC2007", "VOC2012")):
        d = os.path.join(root, year)
        txt = write_xml_tree(d, 10 + k, 7 + 2 * k, VOC_CLASSES)
        cfgs.append(dict(type="VOCDataset", ann_file=txt, img_prefix=d))
    return cfgs


def test_build_dataset_wrappers_equal_reference(tmp_path):
    """A list of configs is a ConcatDataset, a RepeatDataset config wraps
    its dataset (itself a list here) ``times`` times; the port builds
    the ConcatDataset's img_infos once, the reference on every read: the
    same list."""
    cfgs = _voc_pair(str(tmp_path))
    cases = [cfgs, dict(type="RepeatDataset", times=3, dataset=cfgs[0]),
             dict(type="RepeatDataset", times=2, dataset=cfgs)]
    for cfg in cases:
        got, want = build_dataset(cfg), ref_build_dataset(cfg)
        assert_datasets_equal(got, want)
    concat = build_dataset(cfgs)
    assert concat.img_infos is concat.img_infos
    assert len(concat) == len(concat.img_infos) == sum(
        len(build_dataset(c)) for c in cfgs)


@pytest.mark.parametrize("seed", [0, 1])
def test_loader_over_concat_equals_reference_batches(tmp_path, seed):
    cfgs = _voc_pair(str(tmp_path))
    got, want = build_dataset(cfgs), ref_build_dataset(cfgs)
    assert 0 < got.flag.sum() < len(got)        # both aspect groups
    for bs in (2, 3):
        a = GroupedLoader(got, None, bs, seed=seed)
        b = RefLoader(want, None, bs, seed=seed)
        for epoch in (0, 1):
            a.set_epoch(epoch)
            b.set_epoch(epoch)
            ca, cb = a._chunks(), b._chunks()
            assert len(ca) == len(cb) > 0
            for x, y in zip(ca, cb):
                np.testing.assert_array_equal(x, y)


VOC_SMALL_CFG = hbb_cfg(bbox_head=dict(hbb_cfg()["bbox_head"], num_classes=21))


@pytest.fixture(scope="module")
def voc_config_batches(tmp_path_factory):
    """The VOC config's data (its list of two VOC datasets) over a
    test-written tree of 128^2 JPEGs with at most G objects an image:
    the first batch of each package's loader (batch 2, one worker, the
    small model's pipeline: 128^2, G gts, no rbox, raw uint8)."""
    root = str(tmp_path_factory.mktemp("voc"))
    cfg = Config.fromfile(VOC_CONFIG)
    assert [d["type"] for d in cfg.data.train] == ["VOCDataset"] * 2
    assert cfg.model.bbox_head.num_classes == 21
    train = []
    for k, d in enumerate(cfg.data.train):
        year = os.path.basename(d["img_prefix"])
        prefix = os.path.join(root, year)
        txt = write_xml_tree(prefix, 20 + k, 4, VOC_CLASSES,
                             sizes=[(IMG, IMG)], images=True, max_objects=G,
                             missing=False, sides=(24, 48, 48, 96))
        train.append(dict(d, ann_file=txt, img_prefix=prefix))
    pipe = dict(img_size=IMG, max_gt=G, with_rbox=False,
                device_normalize=True, seed=0)
    batches = []
    for build, loader, pipeline in (
            (build_dataset, GroupedLoader, TrainPipeline),
            (ref_build_dataset, RefLoader, RefTrainPipeline)):
        ds = build(train)
        assert type(ds).__name__ == "ConcatDataset" and len(ds) == 8
        batches.append(next(iter(loader(ds, pipeline(**pipe), 2, seed=0,
                                        num_workers=1))))
    return batches


def test_voc_config_first_batch_equals_reference(voc_config_batches):
    got, want = voc_config_batches
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["gt_valid"].any() and got["imgs"].dtype == np.uint8


def test_voc_config_train_step_matches_reference(voc_config_batches):
    batch = voc_config_batches[1]
    assert batch["gt_labels"].max() <= 20
    jm, v, tm = shaped_pair(VOC_SMALL_CFG)
    tm.train()
    losses, grads = port_loss_and_grads(tm, batch)
    ref_losses, ref_grads = ref_loss_and_grads(jm, v, batch)
    assert_losses_close(losses, ref_losses, 1e-4)
    assert_grads_close(grads, ref_grads, 1e-2)
    got = {k: 0.0 if g is None else to_np(g) for k, g in grads.items()}
    diff = sum(float(((got[k] - to_np(r)) ** 2).sum())
               for k, r in ref_grads.items())
    norm = sum(float((to_np(r) ** 2).sum()) for r in ref_grads.values())
    assert diff ** 0.5 <= 1e-3 * norm ** 0.5


def _dataset_types(cfg):
    """The dataset type names of a data.train / data.test config: a list's
    every entry, a RepeatDataset's wrapper and its dataset."""
    if isinstance(cfg, (list, tuple)):
        return [t for c in cfg for t in _dataset_types(c)]
    if cfg.get("type") == "RepeatDataset":
        return ["RepeatDataset"] + _dataset_types(cfg["dataset"])
    return [cfg.get("type")]


def test_the_data_sweep_registers_every_config_dataset_and_pipeline():
    """The data side of every config of the repo (the config sweep of
    tests/test_torch_port_dcn.py builds their models): each data.train
    and data.test type, or list of types, is one the port's builder
    takes, and each train_pipeline constructs; none says "not ported".
    The albu config's pipeline raises, on a COCO sample with instances,
    the reference's ValueError: parse_anns lists one segmentation per
    instance, which the albu stage cannot move."""
    from aidet_tpu_torch.data.builder import DATASETS
    paths = sorted(glob.glob(os.path.join(REPO, "configs", "*.py")))
    assert len(paths) == 203
    types = {}
    for p in paths:
        cfg = Config.fromfile(p)
        for split in ("train", "test"):
            for t in _dataset_types(cfg.data[split]):
                types[t] = types.get(t, 0) + 1
                assert t == "RepeatDataset" or DATASETS.get(t), (p, t)
        if cfg.get("train_pipeline") is not None:
            TrainPipeline(**cfg.train_pipeline)
    assert {"VOCDataset", "WIDERFaceDataset", "BuildChangeDataset",
            "CityscapesDataset"} <= set(types)
    albu = Config.fromfile(ALBU_CONFIG).train_pipeline
    img = np.zeros((64, 64, 3), np.uint8)
    anns = dict(bboxes=np.array([[4, 4, 30, 30]], np.float32),
                labels=np.array([1], np.int32),
                bboxes_ignore=np.zeros((0, 4), np.float32),
                segmentations=[None])
    errors = []
    for pipe in (TrainPipeline(**albu), RefTrainPipeline(**albu)):
        with pytest.raises(ValueError, match="'segmentations'") as e:
            pipe(img, anns)
        errors.append(str(e.value))
    assert errors[0] == errors[1]
