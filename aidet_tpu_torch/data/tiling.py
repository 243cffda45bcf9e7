"""Scene serving on the host and the card: tiling, and the
patch -> scene merge.

Port of `aidet_tpu/data/tiling.py`: a sliding window cuts a large
scene into fixed-size patches (`tile_coords`, `tile_image` on the host,
`device_tiler` on the card), and `merge_patch_detections` lifts each
patch's detections to scene coordinates and runs a global per-class
NMS (rotated for quads) on the host.

This module imports numpy alone at the top, and torch only inside
`device_tiler`: the merge's process pool spawns its workers, which
import this module (for `_nms_task`) and must start without torch or
CUDA.  A fork after CUDA is initialised would break the children, so
the pool uses spawn.
"""

from __future__ import annotations

import os

import numpy as np

_MERGE_POOL = None
_MERGE_POOL_SIZE = 0


def _nms_task(args):
    """Worker for one class's scene-level NMS (top-level, so that a
    spawned worker imports it by name)."""
    boxes, scores, thr, box_type = args
    from .np_rboxes import bbox_nms_np, quad_nms_np
    if box_type == "quad":
        return quad_nms_np(boxes, scores, thr)
    return bbox_nms_np(boxes, scores, thr)


def _get_merge_pool(workers: int):
    """The persistent spawn-context process pool of the per-class merge
    NMS, made again when ``workers`` changes.  Spawn, not fork: the
    parent holds a live CUDA context, which must not leak into forked
    children; the pool is reused across scenes, so the workers' start
    is paid once."""
    global _MERGE_POOL, _MERGE_POOL_SIZE
    if _MERGE_POOL is None or _MERGE_POOL_SIZE != workers:
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor
        if _MERGE_POOL is not None:
            _MERGE_POOL.shutdown(wait=False)
        _MERGE_POOL = ProcessPoolExecutor(
            max_workers=workers, mp_context=mp.get_context("spawn"))
        _MERGE_POOL_SIZE = workers
    return _MERGE_POOL


def close_merge_pool():
    """Stop the merge's worker processes, if any were started."""
    global _MERGE_POOL, _MERGE_POOL_SIZE
    if _MERGE_POOL is not None:
        _MERGE_POOL.shutdown(wait=True)
    _MERGE_POOL, _MERGE_POOL_SIZE = None, 0


def tile_coords(height: int, width: int, patch: int = 1024,
                overlap: int = 200):
    """Top-left corners of a sliding window covering the scene."""
    stride = patch - overlap
    xs = list(range(0, max(width - overlap, 1), stride))
    ys = list(range(0, max(height - overlap, 1), stride))
    # snap last windows inside the scene
    if xs and xs[-1] + patch > width:
        xs[-1] = max(width - patch, 0)
    if ys and ys[-1] + patch > height:
        ys[-1] = max(height - patch, 0)
    return [(x, y) for y in sorted(set(ys)) for x in sorted(set(xs))]


def tile_image(img: np.ndarray, patch: int = 1024, overlap: int = 200):
    """Slice a scene into fixed-size patches (zero-padded at borders).

    Returns (patches [N, patch, patch, C], offsets [N, 2] (x, y)).
    """
    h, w = img.shape[:2]
    coords = tile_coords(h, w, patch, overlap)
    n = len(coords)
    c = img.shape[2] if img.ndim == 3 else 1
    # empty + zero-only-borders: tile_coords snaps the last windows
    # inside the scene, so every tile is full-size whenever the scene
    # is at least one patch wide — the big zero-fill would be pure
    # waste on the common path
    patches = np.empty((n, patch, patch, c), img.dtype)
    offs = np.zeros((n, 2), np.float32)
    for i, (x, y) in enumerate(coords):
        tile = img[y:y + patch, x:x + patch]
        th, tw = tile.shape[:2]
        if th < patch or tw < patch:
            patches[i, th:] = 0
            patches[i, :th, tw:] = 0
        patches[i, :th, :tw] = tile if tile.ndim == 3 else tile[..., None]
        offs[i] = (x, y)
    return patches, offs


def device_tiler(height: int, width: int, patch: int = 1024,
                 overlap: int = 200, device="cuda"):
    """An on-device scene -> patches tiler.

    Shipping the scene once and slicing it on the card saves the host's
    copy loop and the overlap's extra bytes over the host link (a
    3072^2 scene at 200 px overlap: 28 MB against 50 MB of patches).
    The windows are `tile_coords`'s, so the patches hold the same bytes
    as `tile_image`'s.  Scenes smaller than ``patch`` in either
    dimension need host-side padding: use `tile_image` there.

    Returns (fn, offsets [N, 2] (x, y)): fn takes a uint8 [H, W, C]
    tensor of this size on ``device`` and returns [N, patch, patch, C]
    on it (one stack of the windows' slices).
    """
    import torch
    if height < patch or width < patch:
        raise ValueError("device_tiler needs scene >= patch; "
                         "use tile_image for small scenes")
    coords = tile_coords(height, width, patch, overlap)
    device = torch.device(device)

    def tile(scene):
        if scene.device.type != device.type \
                or tuple(scene.shape[:2]) != (height, width):
            raise ValueError(f"device_tiler for {height}x{width} on "
                             f"{device}: got {tuple(scene.shape)} on "
                             f"{scene.device}")
        return torch.stack([scene[y:y + patch, x:x + patch]
                            for (x, y) in coords])

    return tile, np.asarray(coords, np.float32)


def merge_patch_detections(dets_per_patch, offsets, num_classes: int,
                           iou_thr=0.3, box_type: str = "quad",
                           score_thr: float = 0.05, max_keep: int = 2000,
                           workers: int | None = None):
    """Lift patch detections to scene coords + global per-class NMS.

    The reference's wwtool mergebypoly_mp / mergebyrec_mp
    (datasets/dota.py:310-336): per-class thresholds supported via an
    ``iou_thr`` dict {label: thr} or scalar.  Labels come out int32
    (the port's predict gives int64).

    Args:
      dets_per_patch: list of dicts with numpy 'boxes'([K,4] or quads
        [K,8]), 'scores'[K], 'labels'[K], 'valid'[K].
      offsets: [N, 2] patch origins (x, y).
      workers: per-class NMS process-pool size (the reference merge is
        multiprocessing: mergebypoly_mp).  None = auto — parallel when
        several classes are busy enough to pay the pickling; 0/1 =
        serial in-process.
    Returns dict(boxes, scores, labels) of scene-level detections.
    """
    from .np_rboxes import bbox_nms_np, quad_nms_np

    all_boxes, all_scores, all_labels = [], [], []
    for det, (ox, oy) in zip(dets_per_patch, offsets):
        v = np.asarray(det["valid"]).astype(bool)
        if not v.any():
            continue
        b = np.asarray(det["boxes"])[v].astype(np.float32)
        if box_type == "quad":
            shift = np.tile([ox, oy], b.shape[-1] // 2)
        else:
            shift = np.asarray([ox, oy, ox, oy], np.float32)
        all_boxes.append(b + shift)
        all_scores.append(np.asarray(det["scores"])[v])
        all_labels.append(np.asarray(det["labels"])[v])
    if not all_boxes:
        d = 8 if box_type == "quad" else 4
        return dict(boxes=np.zeros((0, d), np.float32),
                    scores=np.zeros((0,), np.float32),
                    labels=np.zeros((0,), np.int32))

    boxes = np.concatenate(all_boxes)
    scores = np.concatenate(all_scores).astype(np.float32)
    labels = np.concatenate(all_labels).astype(np.int32)

    # host numpy greedy NMS (np_rboxes): the merge runs on the host
    # between device batches and launches nothing on the card
    tasks = []
    for c in range(num_classes):
        sel = np.nonzero((labels == c) & (scores > score_thr))[0]
        if len(sel) == 0:
            continue
        thr = float(iou_thr[c] if isinstance(iou_thr, dict) else iou_thr)
        tasks.append((sel, (boxes[sel], scores[sel], thr, box_type)))

    if workers is None:
        busy = sum(len(sel) >= 64 for sel, _ in tasks)
        workers = min(busy, os.cpu_count() or 1, 8) if busy >= 2 else 0

    keep_mask = np.zeros(len(boxes), bool)
    if workers and workers > 1 and len(tasks) > 1:
        pool = _get_merge_pool(workers)
        for (sel, _), k in zip(tasks, pool.map(
                _nms_task, [t for _, t in tasks])):
            keep_mask[sel[k]] = True
    else:
        for sel, (b, s, thr, bt) in tasks:
            k = (quad_nms_np(b, s, thr) if bt == "quad"
                 else bbox_nms_np(b, s, thr))
            keep_mask[sel[k]] = True

    keep = np.nonzero(keep_mask)[0]
    if len(keep) > max_keep:
        keep = keep[np.argsort(-scores[keep])[:max_keep]]
    return dict(boxes=boxes[keep], scores=scores[keep],
                labels=labels[keep])
