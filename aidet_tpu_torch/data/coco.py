"""COCO-format dataset on plain json (no pycocotools).

Port of `aidet_tpu/data/coco.py::CocoDataset` (:17-121: `cat2label`,
`filter_empty` and `min_size`, the aspect ``flag``, `parse_anns` with
its ignore, crowd, ``min_area`` and ``max_small_length`` rules and the
pointobb alignment of mixed OBB/HBB annotations at :93-101;
`results2json` :122; `evaluate` :148 through the port's
`core/eval/mean_ap.py`, and `evaluate_segm` :193-226 through
`core/eval/segm.py` when the results carry masks).  Labels of results
may be int32 (the reference's) or int64 (the port's).
"""

from __future__ import annotations

import json
import os

import numpy as np


class CocoDataset:
    CLASSES: tuple = ()

    def __init__(self, ann_file: str, img_prefix: str = "",
                 filter_empty: bool = True, min_size: int = 32,
                 min_area: float = 0, max_small_length: float = 0,
                 test_mode: bool = False):
        # min_area / max_small_length drop tiny instances (the
        # reference's `exclude_small` config family)
        self.ann_file = ann_file
        self.img_prefix = img_prefix
        self.test_mode = test_mode
        self.min_area = min_area
        self.max_small_length = max_small_length
        with open(ann_file) as f:
            coco = json.load(f)

        cats = sorted(coco.get("categories", []), key=lambda c: c["id"])
        if not self.CLASSES:
            self.CLASSES = tuple(c["name"] for c in cats)
        # category id -> contiguous 1-based label
        self.cat2label = {c["id"]: i + 1 for i, c in enumerate(cats)}

        self.img_infos = coco.get("images", [])
        anns_by_img: dict = {}
        for a in coco.get("annotations", []):
            anns_by_img.setdefault(a["image_id"], []).append(a)
        self.anns_by_img = anns_by_img

        if not test_mode and filter_empty:
            self.img_infos = [
                info for info in self.img_infos
                if len(anns_by_img.get(info["id"], [])) > 0
                and min(info.get("width", 1e9),
                        info.get("height", 1e9)) >= min_size]

        # aspect-ratio group flag: 1 where wider than high
        self.flag = np.array(
            [1 if i.get("width", 1) / max(i.get("height", 1), 1) > 1 else 0
             for i in self.img_infos], np.uint8)

    def __len__(self):
        return len(self.img_infos)

    def img_path(self, idx):
        return os.path.join(self.img_prefix,
                            self.img_infos[idx]["file_name"])

    def parse_anns(self, idx):
        """Per-image annotation dict with numpy arrays: crowd and
        ignored boxes go to bboxes_ignore, xywh becomes corners."""
        info = self.img_infos[idx]
        anns = self.anns_by_img.get(info["id"], [])
        boxes, labels, segs, ignores, pointobbs = [], [], [], [], []
        segs_ignore = []
        for a in anns:
            x, y, w, h = a["bbox"]
            if a.get("area", w * h) <= 0 or w < 1 or h < 1:
                continue
            if (a.get("area", w * h) <= self.min_area
                    or max(w, h) < self.max_small_length):
                continue
            box = [x, y, x + w - 1, y + h - 1]
            if a.get("iscrowd", 0) or a.get("ignore", 0):
                ignores.append(box)
                if a.get("segmentation"):
                    segs_ignore.append(a["segmentation"])
                continue
            boxes.append(box)
            labels.append(self.cat2label[a["category_id"]])
            segs.append(a.get("segmentation"))
            if "pointobb" in a:
                pointobbs.append(a["pointobb"])
            elif pointobbs or any("pointobb" in a2 for a2 in anns):
                # a dataset that mixes OBB and HBB annotations: the
                # missing pointobb is the HBB's corners, so pointobbs
                # stay index-aligned with boxes and labels
                pointobbs.append([box[0], box[1], box[2], box[1],
                                  box[2], box[3], box[0], box[3]])

        def arr(x, d, dt=np.float32):
            return (np.asarray(x, dt) if x
                    else np.zeros((0, d), dt))
        out = dict(
            bboxes=arr(boxes, 4),
            labels=(np.asarray(labels, np.int32) if labels
                    else np.zeros((0,), np.int32)),
            bboxes_ignore=arr(ignores, 4),
            segmentations=segs,
            segmentations_ignore=segs_ignore,
            width=info.get("width"), height=info.get("height"),
            filename=info["file_name"])
        if pointobbs:
            out["pointobbs"] = arr(pointobbs, 8)
        return out

    def results2json(self, results, out_file: str):
        """Padded per-image result dicts -> COCO detection json."""
        label2cat = {v: k for k, v in self.cat2label.items()}
        out = []
        for i, r in enumerate(results):
            valid = np.asarray(r["valid"]).astype(bool)
            boxes = np.asarray(r["boxes"])[valid]
            scores = np.asarray(r["scores"])[valid]
            labels = np.asarray(r["labels"])[valid]
            img_id = self.img_infos[i]["id"]
            for b, s, l in zip(boxes, scores, labels):
                out.append(dict(
                    image_id=int(img_id),
                    bbox=[float(b[0]), float(b[1]),
                          float(b[2] - b[0] + 1), float(b[3] - b[1] + 1)],
                    score=float(s),
                    category_id=int(label2cat.get(int(l) + 1,
                                                  int(l) + 1))))
        with open(out_file, "w") as f:
            json.dump(out, f)
        return out_file

    def evaluate(self, results, iou_thrs=None):
        """COCO-style box mAP without pycocotools: the mean of `eval_map`
        over IoU 0.5:0.95, and AP50 / AP75."""
        from ..core.eval.mean_ap import eval_map
        if iou_thrs is None:
            iou_thrs = np.arange(0.5, 1.0, 0.05)
        num_classes = len(self.CLASSES)
        det_lists, gt_lists = [], []
        for i, r in enumerate(results):
            valid = np.asarray(r["valid"]).astype(bool)
            boxes = np.asarray(r["boxes"])[valid]
            scores = np.asarray(r["scores"])[valid]
            labels = np.asarray(r["labels"])[valid]
            per_cls = []
            for c in range(num_classes):
                m = labels == c
                per_cls.append(
                    np.concatenate([boxes[m], scores[m, None]], -1)
                    if m.any() else np.zeros((0, 5), np.float32))
            det_lists.append(per_cls)
            anns = self.parse_anns(i)
            gt_lists.append(dict(boxes=anns["bboxes"],
                                 labels=anns["labels"],
                                 ignore=anns["bboxes_ignore"]))
        aps = {}
        for thr in iou_thrs:
            m, _ = eval_map(det_lists, gt_lists, iou_thr=float(thr),
                            num_classes=num_classes)
            aps[round(float(thr), 2)] = m
        result = dict(
            mAP=float(np.mean(list(aps.values()))),
            AP50=aps.get(0.5, 0.0),
            AP75=aps.get(0.75, 0.0))
        if results and "masks" in results[0]:
            result.update(self.evaluate_segm(results, iou_thrs=iou_thrs))
        return result

    def evaluate_segm(self, results, iou_thrs=None, mask_thr=0.5):
        """Instance-mask mAP (parity: metric='segm' via COCOeval): each
        valid detection's [S, S] mask crop over its box against the gt
        polygons, box-bounded mask IoU; crowd polygons are ignore
        regions (a detection matched to one is neither TP nor FP)."""
        from ..core.eval.segm import eval_segm, mask_record, polygon_record
        num_classes = len(self.CLASSES)
        preds, gts = [], []
        for i, r in enumerate(results):
            anns = self.parse_anns(i)
            hw = (anns.get("height") or 10 ** 9,
                  anns.get("width") or 10 ** 9)
            valid = np.asarray(r["valid"]).astype(bool)
            boxes = np.asarray(r["boxes"])[valid]
            crops = np.asarray(r["masks"])[valid]
            preds.append(dict(
                records=[mask_record(b, m, hw, mask_thr)
                         for b, m in zip(boxes, crops)],
                scores=np.asarray(r["scores"])[valid],
                labels=np.asarray(r["labels"])[valid]))
            g_records, g_labels = [], []
            for seg, lab in zip(anns.get("segmentations", []),
                                anns["labels"]):
                if not seg:
                    continue
                g_records.append(polygon_record(seg, hw))
                g_labels.append(int(lab) - 1)        # 1-based -> 0-based
            ig_records = [polygon_record(seg, hw)
                          for seg in anns.get("segmentations_ignore", [])
                          if seg]
            gts.append(dict(records=g_records,
                            labels=np.asarray(g_labels, np.int64),
                            ignore_records=ig_records))
        mean, by_thr = eval_segm(preds, gts, num_classes, iou_thrs=iou_thrs)
        return dict(
            segm_mAP=mean,
            segm_AP50=by_thr.get(0.5, (0.0,))[0],
            segm_AP75=by_thr.get(0.75, (0.0,))[0])
