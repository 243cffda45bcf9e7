"""Batch inference over a dataset.

Port of `aidet_tpu/apis/test.py::run_inference` (:18-153; parity:
mmdet/apis/test.py:12-146): the `TestPipeline` with the reference's
``device_normalize`` default (:40-47: uint8 images go to the card and
are normalized there unless the pipeline names its own mean, std or
to_rgb), decode in 4 threads with one batch of prefetch, the last batch
padded to the static batch size, one predict per batch (K1 once on the
card), and per-image result dicts of numpy arrays with the file names.
Labels are int64 (the reference's are int32).  Under a process group
each rank predicts its shard of the dataset (images rank::world) on its
own card, and the results are gathered densely and put back in dataset
order on every rank (`parallel.dist.gather_results`, :133-153).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..data.loader import MissingImages
from ..data.pipeline import TestPipeline
from ..parallel.dist import gather_results, rank, world_size
from .inference import to_numpy


def run_inference(model, dataset, batch_size: int = 8,
                  img_size: int | None = None, progress=None, mesh=None,
                  num_shards: int | None = None, shard_id: int | None = None,
                  pipeline_cfg: dict | None = None):
    """Run ``model``'s predict over ``dataset`` on the model's device.

    ``pipeline_cfg``: the config's ``test_pipeline`` dict (mean, std,
    to_rgb, img_size, device_normalize).  ``progress(done, total)`` is
    called after each batch of this process's shard.  ``num_shards`` and
    ``shard_id`` default to the process group's world size and rank (1
    and 0 without a group): this process predicts images
    shard_id::num_shards, ``batch_size`` at a time.  A ``mesh``
    (`parallel.mesh.create_mesh`) shards the dataset over its ranks
    instead, and ``batch_size`` is then the global batch, of which each
    rank predicts its share (it must divide the mesh's size, as in the
    reference).  With more than one shard the results are gathered in
    dataset order on every process.  Returns (results, names): a dict
    per image of predict's outputs as numpy (boxes, scores, labels and
    valid, and rboxes or, for the mask family, masks [K, 28, 28]), and
    the file names."""
    if mesh is not None:
        if batch_size % mesh.size:
            raise ValueError(
                f"batch_size={batch_size} must be divisible by the "
                f"data-mesh device count ({mesh.size}); pass e.g. "
                f"--batch-size {-(-batch_size // mesh.size) * mesh.size}")
        batch_size //= mesh.size
        num_shards, shard_id = mesh.size, mesh.rank
    num_shards = world_size() if num_shards is None else num_shards
    shard_id = rank() if shard_id is None else shard_id
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
    if num_shards > 1:
        example = None
        if not results:
            # an empty shard (more shards than images) still sends
            # zeros of the result's spec to the dense gather
            s = pipe.img_size
            imgs = torch.zeros((1, s, s, 3), dtype=torch.uint8
                               if pipe.device_normalize else torch.float32,
                               device=device)
            out = to_numpy(model.predict(
                imgs, torch.full((1, 2), float(s), device=device),
                torch.ones(1, device=device)))
            example = {k: np.zeros_like(v[0]) for k, v in out.items()}
        results = gather_results(results, num_shards, shard_id,
                                 len(dataset), example=example)
        names = [info["file_name"] for info in dataset.img_infos]
    return results, names
