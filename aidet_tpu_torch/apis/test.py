"""Batch inference over a dataset.

Port of `aidet_tpu/apis/test.py::run_inference` (:18-153; parity:
mmdet/apis/test.py:12-72) for one device: the `TestPipeline` with the
reference's ``device_normalize`` default (:40-47: uint8 images go to
the card and are normalized there unless the pipeline names its own
mean, std or to_rgb), decode in 4 threads with one batch of prefetch,
the last batch padded to the static batch size, one predict per batch
(K1 once on the card), and per-image result dicts of numpy arrays with
the file names.  Labels are int64 (the reference's are int32).  A
``mesh`` or ``num_shards`` > 1 raises `NotImplementedError` until the
data-parallel slice (ROADMAP queue 1).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..data.loader import MissingImages
from ..data.pipeline import TestPipeline
from .inference import to_numpy


def run_inference(model, dataset, batch_size: int = 8,
                  img_size: int | None = None, progress=None, mesh=None,
                  num_shards: int = 1, shard_id: int = 0,
                  pipeline_cfg: dict | None = None):
    """Run ``model``'s predict over ``dataset`` on the model's device.

    ``pipeline_cfg``: the config's ``test_pipeline`` dict (mean, std,
    to_rgb, img_size, device_normalize).  ``progress(done, total)`` is
    called after each batch.  Returns (results, names): a dict per image
    of predict's outputs as numpy (boxes, scores, labels and valid, and
    rboxes or, for the mask family, masks [K, 28, 28]), and the file
    names."""
    if mesh is not None or num_shards > 1:
        raise NotImplementedError(
            "run_inference over a mesh or several shards is not yet ported "
            "to aidet_tpu_torch (data parallelism)")
    pcfg = dict(pipeline_cfg or {})
    pcfg.setdefault("img_size", img_size or getattr(model, "img_size", 1024))
    pcfg.setdefault(
        "device_normalize",
        not any(k in pcfg for k in ("mean", "std", "to_rgb"))
        or getattr(model, "img_norm", None) is not None)
    pipe = TestPipeline(**pcfg)
    device = model.anchors.device
    images = MissingImages()

    def load_one(i):
        return pipe(images.read(dataset.img_path(i), dataset.img_infos[i]))

    results, names = [], []
    idxs = list(range(shard_id, len(dataset), num_shards))
    batches = [idxs[s:s + batch_size] for s in range(0, len(idxs),
                                                     batch_size)]
    # the next batch decodes while the device runs the current one
    with ThreadPoolExecutor(4) as pool:
        next_futs = ([pool.submit(load_one, i) for i in batches[0]]
                     if batches else [])
        for bi, chunk in enumerate(batches):
            samples = [f.result() for f in next_futs]
            if bi + 1 < len(batches):
                next_futs = [pool.submit(load_one, i)
                             for i in batches[bi + 1]]
            while len(samples) < batch_size:  # static batch padding
                samples.append(samples[-1])
            batch = {k: torch.from_numpy(np.stack([s[k] for s in samples]))
                     .to(device) for k in samples[0]}
            out = to_numpy(model.predict(batch["imgs"], batch["img_shapes"],
                                         batch["scale_factors"]))
            for j, i in enumerate(chunk):
                results.append({k: v[j] for k, v in out.items()})
                names.append(dataset.img_infos[i]["file_name"])
            if progress:
                progress(len(results), len(idxs))
    return results, names
