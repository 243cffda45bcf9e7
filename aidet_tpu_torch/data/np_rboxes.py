"""Host numpy geometry of the scene merge and the DOTA eval.

A copy of the parts of `aidet_tpu/data/np_rboxes.py` that the merge's
per-class NMS and the eval's polygon IoU run: `thetaobb2pointobb`,
`quad_overlaps_np_host`, `quad_iou_one_many_np`, `quad_nms_np`,
`bbox_nms_np` and the helpers they use; and those that the train
pipeline runs: `pointobb_best_point_sort` (:31), `pointobb2thetaobb`
(:47), `thetaobb2hobb` (:91), `pointobb2hobb` (:99) and
`pointobb_flip` (:103); and `min_area_rect_np`, the mask-to-OBB fit,
from `aidet_tpu/core/riou.py` (:380-438).  It imports numpy alone, so the merge's
spawned worker processes start without torch or CUDA
(`aidet_tpu_torch.data.tiling`).  tests/test_torch_port_scene.py and
tests/test_torch_port_data.py hold each function equal to the
reference's.
"""

from __future__ import annotations

import math

import numpy as np

HALF_PI = math.pi / 2.0


def pointobb2bbox(pointobb: np.ndarray) -> np.ndarray:
    xs = pointobb[..., 0::2]
    ys = pointobb[..., 1::2]
    return np.stack([xs.min(-1), ys.min(-1), xs.max(-1), ys.max(-1)],
                    axis=-1)


def pointobb_best_point_sort(pointobb: np.ndarray) -> np.ndarray:
    """Cyclic-shift corners nearest the axis-aligned (tl,tr,br,bl)
    template (numpy twin of core/rboxes.pointobb_best_point_sort)."""
    pointobb = np.asarray(pointobb, np.float32)
    bbox = pointobb2bbox(pointobb)
    xmin, ymin, xmax, ymax = (bbox[..., i] for i in range(4))
    ref = np.stack([xmin, ymin, xmax, ymin, xmax, ymax, xmin, ymax],
                   axis=-1)
    rolls = np.stack([np.roll(pointobb, 2 * s, axis=-1) for s in range(4)],
                     axis=-2)                               # [..., 4, 8]
    dist = ((rolls - ref[..., None, :]) ** 2).sum(-1)
    best = dist.argmin(-1)
    return np.take_along_axis(rolls, best[..., None, None],
                              axis=-2)[..., 0, :]


def pointobb2thetaobb(pointobb: np.ndarray) -> np.ndarray:
    """Min-area rotated rect of a quad -> (cx,cy,w,h,theta), theta in
    [-pi/2, 0) (numpy twin of core/rboxes.pointobb2thetaobb)."""
    pointobb = np.asarray(pointobb, np.float32)
    pts = pointobb.reshape(pointobb.shape[:-1] + (4, 2))
    nxt = np.roll(pts, -1, axis=-2)
    edges = nxt - pts
    ang = np.arctan2(edges[..., 1], edges[..., 0])
    ang = np.mod(ang, HALF_PI) - HALF_PI

    cos = np.cos(ang)[..., None]
    sin = np.sin(ang)[..., None]
    x = pts[..., None, :, 0]
    y = pts[..., None, :, 1]
    u = x * cos + y * sin
    v = -x * sin + y * cos
    umin, umax = u.min(-1), u.max(-1)
    vmin, vmax = v.min(-1), v.max(-1)
    w = umax - umin
    h = vmax - vmin
    k = (w * h).argmin(-1)

    def take(a):
        return np.take_along_axis(a, k[..., None], axis=-1)[..., 0]
    theta = take(ang)
    w, h = take(w), take(h)
    uc = (take(umin) + take(umax)) * 0.5
    vc = (take(vmin) + take(vmax)) * 0.5
    ct, st = np.cos(theta), np.sin(theta)
    return np.stack([uc * ct - vc * st, uc * st + vc * ct, w, h, theta],
                    axis=-1)


def thetaobb2pointobb(thetaobb: np.ndarray) -> np.ndarray:
    """(cx, cy, w, h, theta) [..., 5] -> the rectangle's corners
    [..., 8]."""
    cx, cy, w, h, theta = (thetaobb[..., i] for i in range(5))
    a = np.sin(theta) * 0.5
    b = np.cos(theta) * 0.5
    x0 = cx - a * h - b * w
    y0 = cy + b * h - a * w
    x1 = cx + a * h - b * w
    y1 = cy - b * h - a * w
    return np.stack([x0, y0, x1, y1, 2 * cx - x0, 2 * cy - y0,
                     2 * cx - x1, 2 * cy - y1], axis=-1)


def hobb2pointobb(hobb: np.ndarray) -> np.ndarray:
    """(x1, y1, x2, y2, h) [..., 5] -> 4 corners [..., 8]: the fourth
    corner h from the first, perpendicular to the first edge (numpy
    twin of core/rboxes.hobb2pointobb)."""
    x1, y1, x2, y2, h = (hobb[..., i] for i in range(5))
    ang = np.pi / 2 - np.arctan2(y2 - y1, x2 - x1)
    dx, dy = h * np.cos(ang), h * np.sin(ang)
    return np.stack([x1, y1, x2, y2, x2 - dx, y2 + dy, x1 - dx, y1 + dy],
                    axis=-1)


def rbox_quads(rboxes: np.ndarray, encode: str) -> np.ndarray:
    """Rboxes of a head's ``encode`` as quads [..., 8] (the quad codec
    of the reference's `RBBOX_CODECS`): thetaobbs through their corners,
    hobbs through their first edge and height, pointobbs as they
    are."""
    if encode == "thetaobb":
        return thetaobb2pointobb(rboxes)
    if encode == "hobb":
        return hobb2pointobb(rboxes)
    if encode == "pointobb":
        return rboxes
    raise ValueError(f"rbox encode {encode!r}: thetaobb, hobb or pointobb")


def thetaobb2hobb(thetaobb: np.ndarray) -> np.ndarray:
    p = pointobb_best_point_sort(thetaobb2pointobb(thetaobb))
    h = np.sqrt((p[..., 6] - p[..., 0]) ** 2
                + (p[..., 7] - p[..., 1]) ** 2)
    return np.stack([p[..., 0], p[..., 1], p[..., 2], p[..., 3], h],
                    axis=-1)


def pointobb2hobb(pointobb: np.ndarray) -> np.ndarray:
    return thetaobb2hobb(pointobb2thetaobb(pointobb))


def pointobb_flip(pointobb: np.ndarray, img_shape) -> np.ndarray:
    """Horizontal flip + best-point re-sort (numpy twin of
    core/rboxes.pointobb_flip, default 'best' branch)."""
    pointobb = np.asarray(pointobb, np.float32)
    w_img = img_shape[1]
    p = pointobb.reshape(pointobb.shape[:-1] + (4, 2))
    x = w_img - p[..., 0] - 1
    p = np.stack([x, p[..., 1]], axis=-1)
    p = p[..., np.array([0, 3, 2, 1]), :].reshape(pointobb.shape)
    return pointobb_best_point_sort(p)


# ---------------------------------------------------------------------
# Host-side polygon IoU + greedy NMS.  The scene merge runs on the host
# between device batches, and <=2k candidates per (scene, class) is
# host work.
# ---------------------------------------------------------------------

_MAX_V = 8  # quad ∩ quad has ≤ 8 vertices


def _ensure_ccw_np(pts: np.ndarray) -> np.ndarray:
    """Orient [..., 4, 2] quads consistently (same sign rule as
    core/riou._ensure_ccw)."""
    x, y = pts[..., 0], pts[..., 1]
    area2 = np.sum(x * np.roll(y, -1, -1) - np.roll(x, -1, -1) * y, -1)
    return np.where((area2 < 0)[..., None, None], pts[..., ::-1, :], pts)


def _clip_halfplane_np(poly, cnt, a, b):
    """Clip M ragged polygons (8-slot buffers) by the half-plane left
    of directed edge a→b.  poly [M,8,2] f32, cnt [M] int; a/b either a
    single point (2,) shared by all rows or per-row points [M,2].
    Vectorized Sutherland–Hodgman step (numpy twin of
    core/riou._clip_halfplane)."""
    m = poly.shape[0]
    a = np.broadcast_to(np.asarray(a, np.float32), (m, 2))
    b = np.broadcast_to(np.asarray(b, np.float32), (m, 2))
    idx = np.arange(_MAX_V)
    valid = idx[None, :] < cnt[:, None]                      # [M,8]
    nxt = np.where(idx[None, :] + 1 < cnt[:, None], idx + 1, 0)
    nxt_p = np.take_along_axis(poly, nxt[..., None], axis=1)  # [M,8,2]

    ex = (b[:, 0] - a[:, 0])[:, None]                        # [M,1]
    ey = (b[:, 1] - a[:, 1])[:, None]
    ax = a[:, 0][:, None]
    ay = a[:, 1][:, None]
    s_cur = ex * (poly[..., 1] - ay) - ey * (poly[..., 0] - ax)
    s_nxt = ex * (nxt_p[..., 1] - ay) - ey * (nxt_p[..., 0] - ax)
    denom = s_cur - s_nxt
    # The intersection parameter is only meaningful in [0, 1]; outside
    # (parallel / collinear edges where denom ~ 0 makes t explode) the
    # emit mask below discards the point anyway, but letting ~1e30
    # products through fires RuntimeWarning(overflow) inside the DOTA
    # eval path.  Clamp before the multiply.
    t = np.clip(s_cur / np.where(denom == 0, 1e-30, denom), 0.0, 1.0)
    inter = poly + t[..., None] * (nxt_p - poly)

    emit_cur = valid & (s_cur >= 0)
    emit_int = valid & ((s_cur >= 0) != (s_nxt >= 0))

    # interleave (cur_i, inter_i) candidates, then compact per row
    cand = np.empty((m, 2 * _MAX_V, 2), np.float32)
    cand[:, 0::2] = poly
    cand[:, 1::2] = inter
    mask = np.empty((m, 2 * _MAX_V), bool)
    mask[:, 0::2] = emit_cur
    mask[:, 1::2] = emit_int

    pos = np.cumsum(mask, 1) - 1                            # [M,16]
    out = np.zeros((m, _MAX_V, 2), np.float32)
    rows, cols = np.nonzero(mask)
    out[rows, pos[rows, cols]] = cand[rows, cols]
    return out, mask.sum(1).astype(np.int32)


def _poly_areas_np(poly, cnt):
    """Shoelace areas of M ragged polygons (8-slot buffers)."""
    idx = np.arange(_MAX_V)
    nxt = np.where(idx[None, :] + 1 < cnt[:, None], idx + 1, 0)
    x, y = poly[..., 0], poly[..., 1]
    xn = np.take_along_axis(x, nxt, 1)
    yn = np.take_along_axis(y, nxt, 1)
    term = np.where(idx[None, :] < cnt[:, None], x * yn - xn * y, 0.0)
    return 0.5 * np.abs(term.sum(1))


def quad_areas_np(quads: np.ndarray) -> np.ndarray:
    """Shoelace areas of [..., 8] quads."""
    pts = quads.reshape(quads.shape[:-1] + (4, 2))
    x, y = pts[..., 0], pts[..., 1]
    return 0.5 * np.abs(np.sum(
        x * np.roll(y, -1, -1) - np.roll(x, -1, -1) * y, -1))


def _quad_inter_areas_np(subj: np.ndarray, clip: np.ndarray) -> np.ndarray:
    """Intersection areas of paired quads: subj/clip both [P, 4, 2]
    (already consistently oriented)."""
    p = subj.shape[0]
    poly = np.zeros((p, _MAX_V, 2), np.float32)
    poly[:, :4] = subj
    cnt = np.full(p, 4, np.int32)
    for k in range(4):
        poly, cnt = _clip_halfplane_np(poly, cnt,
                                       clip[:, k], clip[:, (k + 1) % 4])
    return _poly_areas_np(poly, cnt)


def quad_overlaps_np_host(quads1: np.ndarray, quads2: np.ndarray,
                          chunk: int = 1 << 16) -> np.ndarray:
    """Pairwise polygon IoU [N, M] of [N, 8] × [M, 8] quads, pure
    numpy (host twin of core/riou.quad_overlaps).  Pair rows are
    processed in chunks to bound the [P, 8, 2] clip buffers."""
    quads1 = np.asarray(quads1, np.float32)
    quads2 = np.asarray(quads2, np.float32)
    n, m = len(quads1), len(quads2)
    if n == 0 or m == 0:
        return np.zeros((n, m), np.float32)
    p1 = _ensure_ccw_np(quads1.reshape(n, 4, 2)).astype(np.float32)
    p2 = _ensure_ccw_np(quads2.reshape(m, 4, 2)).astype(np.float32)
    a1 = quad_areas_np(quads1)
    a2 = quad_areas_np(quads2)
    # AABB prefilter: the polygon clip only runs on pairs whose
    # axis-aligned hulls intersect — detections across a merged scene
    # are spatially sparse, so this cuts the pair count by orders of
    # magnitude vs the dense N×M clip
    bb1 = pointobb2bbox(quads1)
    bb2 = pointobb2bbox(quads2)
    hit = ((np.minimum(bb1[:, None, 2], bb2[None, :, 2])
            > np.maximum(bb1[:, None, 0], bb2[None, :, 0]))
           & (np.minimum(bb1[:, None, 3], bb2[None, :, 3])
              > np.maximum(bb1[:, None, 1], bb2[None, :, 1])))
    ri, ci = np.nonzero(hit)
    inter = np.zeros((n, m), np.float32)
    for s in range(0, len(ri), chunk):
        r = ri[s:s + chunk]
        c = ci[s:s + chunk]
        inter[r, c] = _quad_inter_areas_np(p1[r], p2[c])
    union = a1[:, None] + a2[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12),
                    0.0).astype(np.float32)


def quad_iou_one_many_np(q: np.ndarray, quads: np.ndarray) -> np.ndarray:
    """Polygon IoU of one [8] quad against [M, 8] quads (host path)."""
    return quad_overlaps_np_host(np.asarray(q, np.float32)[None],
                                 quads)[0]


def _greedy_keep_np(iou_sorted: np.ndarray, iou_thr: float) -> np.ndarray:
    """Sequential greedy keep over a descending-score-ordered IoU
    matrix (exact ops/nms._greedy_keep semantics)."""
    n = iou_sorted.shape[0]
    keep = np.zeros(n, bool)
    suppressed = np.zeros(n, bool)
    for i in range(n):
        if suppressed[i]:
            continue
        keep[i] = True
        suppressed |= iou_sorted[i] > iou_thr
    return keep


def quad_nms_np(quads: np.ndarray, scores: np.ndarray,
                iou_thr: float) -> np.ndarray:
    """Greedy rotated NMS on [N, 8] quads; returns keep mask [N]
    (same semantics as ops/nms.rnms: kept iff no higher-scoring kept
    quad overlaps it with IoU > thr).

    Lazy row evaluation: only *kept* candidates compute an IoU row,
    and only against still-alive, AABB-intersecting lower-ranked
    quads — dense clusters suppress early (few rows), sparse sets
    prefilter to nothing (cheap rows).
    """
    quads = np.asarray(quads, np.float32)
    scores = np.asarray(scores, np.float32)
    n = len(scores)
    order = np.argsort(-scores, kind="stable")
    qs = quads[order]
    p = _ensure_ccw_np(qs.reshape(n, 4, 2)).astype(np.float32)
    areas = quad_areas_np(qs)
    bb = pointobb2bbox(qs)
    alive = np.ones(n, bool)
    keep_sorted = np.zeros(n, bool)
    for i in range(n):
        if not alive[i]:
            continue
        keep_sorted[i] = True
        j = np.nonzero(alive[i + 1:])[0] + i + 1
        if len(j) == 0:
            continue
        hit = ((np.minimum(bb[i, 2], bb[j, 2])
                > np.maximum(bb[i, 0], bb[j, 0]))
               & (np.minimum(bb[i, 3], bb[j, 3])
                  > np.maximum(bb[i, 1], bb[j, 1])))
        j = j[hit]
        if len(j) == 0:
            continue
        inter = _quad_inter_areas_np(
            np.broadcast_to(p[i], (len(j), 4, 2)).copy(), p[j])
        union = areas[i] + areas[j] - inter
        iou = np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)
        alive[j[iou > iou_thr]] = False
    keep = np.zeros(n, bool)
    keep[order] = keep_sorted
    return keep


def bbox_nms_np(boxes: np.ndarray, scores: np.ndarray,
                iou_thr: float) -> np.ndarray:
    """Greedy HBB NMS with the legacy +1 IoU (ops/nms semantics)."""
    boxes = np.asarray(boxes, np.float32)
    scores = np.asarray(scores, np.float32)
    order = np.argsort(-scores, kind="stable")
    b = boxes[order]
    xx1 = np.maximum(b[:, None, 0], b[None, :, 0])
    yy1 = np.maximum(b[:, None, 1], b[None, :, 1])
    xx2 = np.minimum(b[:, None, 2], b[None, :, 2])
    yy2 = np.minimum(b[:, None, 3], b[None, :, 3])
    inter = (np.clip(xx2 - xx1 + 1, 0, None)
             * np.clip(yy2 - yy1 + 1, 0, None))
    area = (b[:, 2] - b[:, 0] + 1) * (b[:, 3] - b[:, 1] + 1)
    iou = inter / (area[:, None] + area[None, :] - inter)
    keep_sorted = _greedy_keep_np(iou, iou_thr)
    keep = np.zeros(len(scores), bool)
    keep[order] = keep_sorted
    return keep


# min-area rect of a point set: convex hull + rotating calipers, for the
# mask-to-OBB fit (reference: core/riou.py, replacing cv2.minAreaRect)
def min_area_rect_np(points):
    """Min-area rotated rect around a point set.

    Args:
      points: np.ndarray [N, 2] (N ≥ 1).
    Returns:
      (cx, cy, w, h, theta) with theta in [-pi/2, 0), matching the
      legacy cv2.minAreaRect convention used throughout the reference.
    """
    pts = np.asarray(points, dtype=np.float64)
    if len(pts) == 1:
        return float(pts[0, 0]), float(pts[0, 1]), 0.0, 0.0, -np.pi / 2

    # Andrew's monotone chain convex hull
    order = np.lexsort((pts[:, 1], pts[:, 0]))
    pts = pts[order]

    def half_hull(p):
        hull = []
        for q in p:
            while len(hull) >= 2:
                o, a = hull[-2], hull[-1]
                if (a[0] - o[0]) * (q[1] - o[1]) - (a[1] - o[1]) * (q[0] - o[0]) <= 0:
                    hull.pop()
                else:
                    break
            hull.append(q)
        return hull

    lower = half_hull(pts)
    upper = half_hull(pts[::-1])
    hull = np.array(lower[:-1] + upper[:-1])
    if len(hull) < 2:
        c = pts.mean(0)
        return float(c[0]), float(c[1]), 0.0, 0.0, -np.pi / 2

    edges = np.roll(hull, -1, axis=0) - hull
    ang = np.arctan2(edges[:, 1], edges[:, 0])
    ang = np.mod(ang, np.pi / 2) - np.pi / 2
    ang = np.unique(ang)

    best = None
    for a in ang:
        c, s = np.cos(a), np.sin(a)
        u = hull[:, 0] * c + hull[:, 1] * s
        v = -hull[:, 0] * s + hull[:, 1] * c
        w = u.max() - u.min()
        h = v.max() - v.min()
        area = w * h
        if best is None or area < best[0]:
            uc = (u.max() + u.min()) / 2
            vc = (v.max() + v.min()) / 2
            cx = uc * c - vc * s
            cy = uc * s + vc * c
            best = (area, cx, cy, w, h, a)
    _, cx, cy, w, h, a = best
    return float(cx), float(cy), float(w), float(h), float(a)
