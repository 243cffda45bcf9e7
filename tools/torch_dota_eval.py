"""Offline DOTA evaluation of saved results with the PyTorch port (the
port's counterpart of tools/dota_eval.py; parity: reference
tools/dota/dota_eval.py).

    python tools/torch_dota_eval.py RESULTS.pkl --gt-json SCENE_GT.json
        [--task obb|hbb] [--encode thetaobb|pointobb|hobb]
        [--export PREFIX]

RESULTS.pkl is tools/torch_test.py's (or tools/test.py's) ``--out``:
{"results": per-patch dicts, "names": patch file names}.  The patch
detections (obb: the rboxes' quads through the port's codecs, or the
min-area rectangles of the mask family's masks, `core.masks.mask_quads`;
hbb: the boxes) are merged into scenes and scored with the VOC-07 DOTA AP
against the scene-level ground truth json {scene: {boxes, labels,
difficult}}; each class's AP and the mAP are printed, and ``--export``
writes them as CSV.  Labels may be int32 or int64.  It runs on the host
alone.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("results_pkl", help="pkl from tools/torch_test.py --out")
    p.add_argument("--gt-json", required=True,
                   help="scene-level gt json: {scene: {boxes, labels}}")
    p.add_argument("--task", default="obb", choices=["obb", "hbb"])
    p.add_argument("--encode", default="thetaobb",
                   choices=["thetaobb", "pointobb", "hobb"])
    p.add_argument("--export", default=None,
                   help="prefix for the csv AP export")
    args = p.parse_args()

    import numpy as np

    from aidet_tpu_torch.core.eval.class_names import DOTA_CLASSES
    from aidet_tpu_torch.core.eval.dota import dota_eval, export_dota_results
    from aidet_tpu_torch.core.masks import mask_quads
    from aidet_tpu_torch.data.dota import merge_patches_to_scenes
    from aidet_tpu_torch.data.np_rboxes import rbox_quads

    with open(args.results_pkl, "rb") as f:
        saved = pickle.load(f)
    results, names = saved["results"], saved["names"]

    dets = []
    for r in results:
        if args.task == "obb" and "rboxes" in r:
            boxes = rbox_quads(np.asarray(r["rboxes"]), args.encode)
        elif args.task == "obb" and "masks" in r:
            boxes = mask_quads(r["masks"], r["boxes"], r["valid"])
        else:
            boxes = np.asarray(r["boxes"])
        dets.append(dict(boxes=boxes, scores=r["scores"],
                         labels=r["labels"], valid=r["valid"]))
    merged = merge_patches_to_scenes(dets, names, DOTA_CLASSES,
                                     task=args.task)

    with open(args.gt_json) as f:
        raw = json.load(f)
    gts = {k: dict(boxes=np.asarray(v["boxes"], np.float32),
                   labels=np.asarray(v["labels"], np.int32),
                   **({"difficult": np.asarray(v["difficult"], bool)}
                      if "difficult" in v else {}))
           for k, v in raw.items()}
    mean_ap, aps = dota_eval(merged, gts, DOTA_CLASSES, task=args.task)
    for k, v in sorted(aps.items()):
        print(f"{k:>22s}: {v:.4f}")
    print(f"{'mAP':>22s}: {mean_ap:.4f}")
    if args.export:
        path = export_dota_results(aps, mean_ap, args.export)
        print("exported", path)


if __name__ == "__main__":
    main()
