"""Single-image inference API.

Port of `aidet_tpu/apis/inference.py` (`init_detector` :20,
`inference_detector` :71; parity: mmdet/apis/inference.py:16-117):
build a detector from a config, load its weights, run one image through
the test pipeline and the predict path.  The torch model holds its
weights, so the port passes the model where the reference passes
(model, variables).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..data.pipeline import TestPipeline
from ..models.builder import apply_fp16_cfg, build_detector
from ..utils.checkpoint import load_checkpoint
from ..utils.config import Config


def init_detector(config, checkpoint: str | None = None, device="cuda",
                  seed: int = 0):
    """The config's detector on ``device`` in eval mode, with random
    weights from ``seed`` or those of ``checkpoint``: a checkpoint
    directory of the train loop (its latest ``model_N``, and the meta's
    classes as ``model.CLASSES``, as mmdet's init_detector sets them),
    or a state_dict of the port's model saved by `torch.save`.
    ``config`` is a path or a `Config`.  Returns (model, config)."""
    if isinstance(config, str):
        config = Config.fromfile(config)
    model_cfg = apply_fp16_cfg(config, dict(config.model))
    model = build_detector(model_cfg, train_cfg=config.get("train_cfg"),
                           test_cfg=config.get("test_cfg"), device=device,
                           seed=seed)
    if checkpoint and os.path.isdir(checkpoint):
        state, meta = load_checkpoint(checkpoint, prefix="model_",
                                      map_location=model.anchors.device)
        model.load_state_dict(state, strict=True)
        if meta and meta.get("classes"):
            model.CLASSES = tuple(meta["classes"])
    elif checkpoint:
        state = torch.load(checkpoint, map_location=model.anchors.device,
                           weights_only=True)
        model.load_state_dict(state, strict=True)
    return model, config


def prepare(model, pipe: TestPipeline, img: np.ndarray):
    """One image through ``pipe`` as predict's batch-1 arguments on the
    model's device: (imgs, img_shapes, scale_factors)."""
    s = pipe(img)
    device = model.anchors.device
    return (torch.from_numpy(s["imgs"][None]).to(device),
            torch.from_numpy(s["img_shapes"][None]).to(device),
            torch.from_numpy(s["scale_factors"].reshape(1)).to(device))


def to_numpy(out: dict) -> dict:
    """Predict's outputs as host numpy arrays (bfloat16 as float32,
    which holds it exactly)."""
    return {k: (v.float() if v.dtype == torch.bfloat16 else v).cpu().numpy()
            for k, v in out.items()}


def inference_detector(model, img, num_classes=None):
    """Run one BGR uint8 image; returns the reference's result format —
    a list over classes of [k, 5] (x1, y1, x2, y2, score) arrays in the
    original image's frame, plus the raw padded dict as numpy (parity:
    bbox2result, core/bbox/transforms.py:181)."""
    pipe = TestPipeline(img_size=model.img_size)
    out = to_numpy(model.predict(*prepare(model, pipe, img)))
    valid = out["valid"][0]
    boxes = out["boxes"][0][valid]
    scores = out["scores"][0][valid]
    labels = out["labels"][0][valid]
    if num_classes is None:
        num_classes = int(labels.max()) + 1 if len(labels) else 1
    results = []
    for c in range(num_classes):
        m = labels == c
        results.append(
            np.concatenate([boxes[m], scores[m, None]], -1)
            if m.any() else np.zeros((0, 5), np.float32))
    return results, out
