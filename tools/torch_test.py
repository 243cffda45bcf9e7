"""Test a detector with the PyTorch port (the port's counterpart of
tools/test.py; parity: reference tools/test.py + tools/dota/
dota_test.py: inference -> format -> merge).

    python tools/torch_test.py CONFIG [--checkpoint DIR/ckpt | FILE]
        [--out results.pkl] [--eval hbb obb | bbox] [--submit-dir DIR]
        [--batch-size 8] [--tta] [--device cuda|cpu]
    torchrun --nproc_per_node N tools/torch_test.py CONFIG ...
    tools/torch_dist_test.sh CONFIG N [torch_test.py args...]

It builds the config's detector with the weights of ``--checkpoint`` (a
checkpoint directory of tools/torch_train.py: its latest model_N; or a
saved state_dict), runs `apis.test.run_inference` over the config's
``data.test`` at ``--batch-size`` through its ``test_pipeline``, saves
{"results", "names"} to ``--out``, then merges each ``--eval`` task's
patch detections into scenes (obb: the rboxes' quads in the encode
predict gives them, `result_encode`: a two-stage model's rbbox head's,
thetaobbs after a refinement head, a RetinaNetOBB's ``rbox_encode``; or
for the mask family (MaskOBB, CenterMapOBB, CenterMap-Net) the min-area
rectangles of the predicted masks, `core.masks.mask_quads`; hbb: the
boxes) and
writes DOTA submission txt under ``--submit-dir/<task>``; on a COCO
dataset the ``bbox`` task (the default there) prints
`CocoDataset.evaluate`'s box mAP, AP50 and AP75.  A dataset with
neither (VOC's and the other XML datasets, which the reference's
tools/test.py:128-170 does not score either) is only written to
``--out``.  With
``--tta`` each test image goes instead through `apis.tta.aug_test_image`
at the config's ``tta = dict(scales=..., flip=...)`` (default: the
model's img_size, flip on): its merged boxes, and its merged quads,
which the obb task then takes as they are.  It runs on the CUDA card
unless ``--device cpu``, and raises when there is none.  Under torchrun
(the reference's multi-process run, tools/test.py:116-122) each process
predicts its shard of the dataset on card ``LOCAL_RANK`` (NCCL; gloo
with ``--device cpu``), the results are gathered in dataset order, and
process 0 writes and scores them; ``--tta`` runs in one process.  The
reference's ``--precompile`` and ``--n-devices`` (a mesh over one
process's devices) are not ported: one process drives one card.
"""

from __future__ import annotations

import argparse
import os
import pickle
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def parse_args():
    p = argparse.ArgumentParser(description="Test a detector")
    p.add_argument("config")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--out", default=None, help="save raw results (.pkl)")
    p.add_argument("--eval", nargs="*", default=None,
                   choices=["hbb", "obb", "bbox"],
                   help="DOTA tasks (default hbb obb), or bbox: the COCO "
                        "box mAP (the default on a COCO dataset)")
    p.add_argument("--submit-dir", default=None,
                   help="write DOTA submission txt files here")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--tta", action="store_true",
                   help="multi-scale/flip TTA per image, driven by the "
                        "config's tta = dict(scales=..., flip=...)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    return p.parse_args()


def main():
    args = parse_args()
    import numpy as np
    import torch
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("torch_test: no CUDA card found; pass --device "
                         "cpu to test on the CPU")
    from aidet_tpu_torch.parallel.dist import (init_distributed,
                                               is_main_process)
    _, world = init_distributed(device=args.device)
    if args.tta and world > 1:
        raise SystemExit("torch_test: --tta runs in one process")
    from aidet_tpu_torch.apis.inference import init_detector
    from aidet_tpu_torch.apis.test import run_inference
    from aidet_tpu_torch.core.masks import mask_quads
    from aidet_tpu_torch.data.builder import build_dataset
    from aidet_tpu_torch.data.imio import imread
    from aidet_tpu_torch.data.np_rboxes import rbox_quads
    from aidet_tpu_torch.utils.logging import get_root_logger

    logger = get_root_logger()
    model, cfg = init_detector(args.config, args.checkpoint,
                               device=args.device)
    dataset = build_dataset(cfg.data["test"])
    if args.tta:
        from aidet_tpu_torch.apis.tta import aug_test_image
        tta_cfg = dict(cfg.get("tta") or {})
        scales = tuple(tta_cfg.get("scales", (model.img_size,)))
        flip = bool(tta_cfg.get("flip", True))
        logger.info("TTA: scales=%s flip=%s", scales, flip)
        results, names = [], []
        for i in range(len(dataset)):
            m = aug_test_image(model, imread(dataset.img_path(i)),
                               scales=scales, flip=flip,
                               rbox_encode=model.result_encode)
            r = dict(boxes=m["boxes"], scores=m["scores"],
                     labels=m["labels"],
                     valid=np.ones(len(m["scores"]), bool))
            if "quads" in m:
                r.update(quads=m["quads"], quad_scores=m["quad_scores"],
                         quad_labels=m["quad_labels"])
            results.append(r)
            names.append(dataset.img_infos[i]["file_name"])
    else:
        results, names = run_inference(
            model, dataset, batch_size=args.batch_size,
            pipeline_cfg=cfg.get("test_pipeline"))
    logger.info("ran inference on %d images", len(results))
    if not is_main_process():
        return
    coco = not hasattr(dataset, "merge_patches_to_scenes")
    tasks = args.eval if args.eval is not None else (
        ["bbox"] if coco else ["hbb", "obb"])
    if "bbox" in tasks and coco and results and hasattr(dataset, "evaluate"):
        m = dataset.evaluate(results)
        logger.info("bbox: mAP %.4f AP50 %.4f AP75 %.4f", m["mAP"],
                    m["AP50"], m["AP75"])
    if args.out:
        with open(args.out, "wb") as f:
            pickle.dump({"results": results, "names": names}, f)

    if hasattr(dataset, "merge_patches_to_scenes") and results:
        encode = model.result_encode
        for task in (t for t in tasks if t != "bbox"):
            dets = []
            for r in results:
                if task == "obb" and "quads" in r:
                    # TTA: the quads come merged, with their own scores
                    # and labels
                    dets.append(dict(
                        boxes=np.asarray(r["quads"]),
                        scores=np.asarray(r["quad_scores"]),
                        labels=np.asarray(r["quad_labels"]),
                        valid=np.ones(len(r["quad_scores"]), bool)))
                    continue
                if task == "obb" and "rboxes" in r:
                    boxes = rbox_quads(np.asarray(r["rboxes"]), encode)
                elif task == "obb" and "masks" in r:
                    boxes = mask_quads(r["masks"], r["boxes"], r["valid"])
                else:
                    boxes = np.asarray(r["boxes"])
                dets.append(dict(boxes=boxes, scores=r["scores"],
                                 labels=r["labels"], valid=r["valid"]))
            merged = dataset.merge_patches_to_scenes(dets, names, task=task)
            if args.submit_dir:
                dataset.format_results_txt(
                    merged, os.path.join(args.submit_dir, task), task=task)
            logger.info("%s: merged %d scenes", task, len(merged))


if __name__ == "__main__":
    main()
