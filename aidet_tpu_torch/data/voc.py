"""Pascal-VOC-style XML datasets and the generic dataset wrappers.

Port of `aidet_tpu/data/voc.py` (parity: mmdet/datasets/voc.py,
xml_style.py, wider_face.py and dataset_wrappers.py): `XMLDataset`
(:17, a txt of image ids, ``Annotations/<id>.xml`` and
``JPEGImages/<id>.jpg``, difficult or too-small objects as ignored
boxes), `VOCDataset`, `WIDERFaceDataset` (one 'face' class, min_size
17), `ConcatDataset` (:108) and `RepeatDataset` (:141).  The reference's
`ConcatDataset.img_infos` builds its list anew on every access; the
port's loader reads it once for each image (`loader.py`,
`apis/test.py`), so the port builds it once: the same list.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET

import numpy as np

from ..core.eval.class_names import VOC_CLASSES


class XMLDataset:
    CLASSES: tuple = ()

    def __init__(self, ann_file: str, img_prefix: str = "",
                 img_subdir: str = "JPEGImages",
                 ann_subdir: str = "Annotations",
                 min_size: int = 0, test_mode: bool = False):
        """ann_file: txt of image ids (one per line)."""
        self.img_prefix = img_prefix
        self.img_subdir = img_subdir
        self.ann_subdir = ann_subdir
        self.min_size = min_size
        self.test_mode = test_mode
        with open(ann_file) as f:
            ids = [line.strip() for line in f if line.strip()]
        self.img_ids = ids
        self.cat2label = {c: i + 1 for i, c in enumerate(self.CLASSES)}
        self.img_infos = []
        for i in ids:
            xml_path = os.path.join(img_prefix, ann_subdir, f"{i}.xml")
            w = h = 0
            if os.path.exists(xml_path):
                root = ET.parse(xml_path).getroot()
                size = root.find("size")
                if size is not None:
                    w = int(size.find("width").text)
                    h = int(size.find("height").text)
            self.img_infos.append(dict(
                id=i, file_name=os.path.join(img_subdir, f"{i}.jpg"),
                width=w, height=h))
        self.flag = np.array(
            [1 if inf["width"] / max(inf["height"], 1) > 1 else 0
             for inf in self.img_infos], np.uint8)

    def __len__(self):
        return len(self.img_infos)

    def img_path(self, idx):
        return os.path.join(self.img_prefix,
                            self.img_infos[idx]["file_name"])

    def parse_anns(self, idx):
        i = self.img_ids[idx]
        xml_path = os.path.join(self.img_prefix, self.ann_subdir,
                                f"{i}.xml")
        boxes, labels, ignores = [], [], []
        if os.path.exists(xml_path):
            root = ET.parse(xml_path).getroot()
            for obj in root.findall("object"):
                name = obj.find("name").text
                if name not in self.cat2label:
                    continue
                difficult = int((obj.find("difficult").text
                                 if obj.find("difficult") is not None
                                 else 0))
                bb = obj.find("bndbox")
                box = [float(bb.find(t).text) for t in
                       ("xmin", "ymin", "xmax", "ymax")]
                w = box[2] - box[0]
                h = box[3] - box[1]
                if difficult or w < self.min_size or h < self.min_size:
                    ignores.append(box)
                else:
                    boxes.append(box)
                    labels.append(self.cat2label[name])
        info = self.img_infos[idx]
        return dict(
            bboxes=(np.asarray(boxes, np.float32) if boxes
                    else np.zeros((0, 4), np.float32)),
            labels=(np.asarray(labels, np.int32) if labels
                    else np.zeros((0,), np.int32)),
            bboxes_ignore=(np.asarray(ignores, np.float32) if ignores
                           else np.zeros((0, 4), np.float32)),
            segmentations=[],
            width=info["width"], height=info["height"],
            filename=info["file_name"])


class VOCDataset(XMLDataset):
    CLASSES = VOC_CLASSES


class WIDERFaceDataset(XMLDataset):
    """WIDER Face: XML-style with a single 'face' class and min-size
    filtering."""
    CLASSES = ("face",)

    def __init__(self, *args, min_size=17, **kwargs):
        super().__init__(*args, min_size=min_size, **kwargs)


class ConcatDataset:
    """The datasets one after the other (a list of dataset configs)."""

    def __init__(self, datasets):
        self.datasets = datasets
        self.cum = np.cumsum([len(d) for d in datasets])
        self.CLASSES = getattr(datasets[0], "CLASSES", ())
        self.flag = np.concatenate(
            [getattr(d, "flag", np.zeros(len(d), np.uint8))
             for d in datasets])
        self.img_infos = [info for d in datasets for info in d.img_infos]

    def __len__(self):
        return int(self.cum[-1])

    def _locate(self, idx):
        d = int(np.searchsorted(self.cum, idx, side="right"))
        base = 0 if d == 0 else int(self.cum[d - 1])
        return self.datasets[d], idx - base

    def img_path(self, idx):
        d, i = self._locate(idx)
        return d.img_path(i)

    def parse_anns(self, idx):
        d, i = self._locate(idx)
        return d.parse_anns(i)


class RepeatDataset:
    """A dataset repeated ``times`` times."""

    def __init__(self, dataset, times: int):
        self.dataset = dataset
        self.times = times
        self.CLASSES = getattr(dataset, "CLASSES", ())
        self.flag = np.tile(getattr(dataset, "flag",
                                    np.zeros(len(dataset), np.uint8)),
                            times)

    def __len__(self):
        return len(self.dataset) * self.times

    def img_path(self, idx):
        return self.dataset.img_path(idx % len(self.dataset))

    def parse_anns(self, idx):
        return self.dataset.parse_anns(idx % len(self.dataset))

    @property
    def img_infos(self):
        return list(self.dataset.img_infos) * self.times
