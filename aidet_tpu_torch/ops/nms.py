"""Fixed-shape hard NMS, soft-NMS, rotated (polygon) NMS and the
multiclass orchestration of the detector heads.

Port of `aidet_tpu/ops/nms.py` (`_suppression_matrix`,
`_greedy_keep_presupp`, `nms`, `soft_nms`, `rnms`, `multiclass_nms`
with its ``box_dim=8`` rotated branch and its soft-NMS branch,
`multiclass_nms_with_index` :387, `batched_nms` :431, `NMSResult`,
`select_parallel_rboxes`, `nms_cfg_kwargs`), in plain
PyTorch: the reference writes these as XLA
code, not as Pallas kernels.  Every function takes any number of
leading batch dimensions, so all (image, level) or (image, class)
problems of a call are solved together, on the tensors' device.
Outputs are padded to a fixed size with a validity mask, as in the
reference.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.boxes import bbox_overlaps
from ..core.riou import quad_overlaps

NEG_INF = -1e10


def topk(x: torch.Tensor, k: int, dim: int = -1):
    """Top k along ``dim``, descending, ties broken by the lower index
    (the order of the reference's top_k); `torch.topk` does not fix the
    order of ties."""
    vals, idx = torch.sort(x, dim=dim, descending=True, stable=True)
    return vals.narrow(dim, 0, k), idx.narrow(dim, 0, k)


def _suppression_matrix(boxes: torch.Tensor, iou_thr: float):
    """[..., N, N] bool: IoU(i, j) > thr under the legacy +1 sizes,
    tested as ``inter > thr * union`` (no divide)."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    xx1 = torch.maximum(x1[..., :, None], x1[..., None, :])
    yy1 = torch.maximum(y1[..., :, None], y1[..., None, :])
    xx2 = torch.minimum(x2[..., :, None], x2[..., None, :])
    yy2 = torch.minimum(y2[..., :, None], y2[..., None, :])
    w = (xx2 - xx1 + 1.0).clamp(min=0)
    h = (yy2 - yy1 + 1.0).clamp(min=0)
    inter = w * h
    area = (x2 - x1 + 1.0) * (y2 - y1 + 1.0)
    union = area[..., :, None] + area[..., None, :] - inter
    return inter > iou_thr * union


def _greedy_keep_presupp(supp: torch.Tensor, valid_sorted: torch.Tensor):
    """Exact greedy keep over a pre-thresholded [..., N, N] suppression
    matrix whose rows and columns are in descending score order.

    A box is kept iff no higher-ranked kept box suppresses it.  That
    rule has a unique solution, found by iterating

        alive[j] = valid[j] and not any(alive[i] and supp[i, j], i < j)

    from alive = valid: after t rounds the first t positions are final,
    so the loop ends after at most N + 1 rounds, and in practice after
    the longest suppression chain (a few rounds).  The reference resolves
    the same fixpoint tile by tile; on the card one [N, N] product per
    round over all problems of the call is cheaper.
    """
    n = supp.shape[-1]
    upper = torch.ones(n, n, dtype=torch.bool,
                       device=supp.device).triu(1)
    m = (supp & upper).to(torch.float32)
    valid = valid_sorted.to(torch.bool)
    alive = valid
    for _ in range(n + 1):
        hit = torch.matmul(alive.to(torch.float32).unsqueeze(-2),
                           m).squeeze(-2) > 0
        new = valid & ~hit
        if torch.equal(new, alive):
            break
        alive = new
    return alive


def nms(boxes: torch.Tensor, scores: torch.Tensor, iou_thr: float = 0.5,
        valid: torch.Tensor | None = None, presorted: bool = False):
    """Hard greedy NMS on horizontal boxes [..., N, 4].

    presorted: the caller guarantees scores are already descending with
    invalid entries last (e.g. straight out of topk).
    Returns the keep mask [..., N] (bool).
    """
    if valid is None:
        valid = torch.ones(scores.shape, dtype=torch.bool,
                           device=scores.device)
    if presorted:
        return _greedy_keep_presupp(
            _suppression_matrix(boxes, iou_thr), valid)
    order = torch.argsort(-torch.where(valid, scores,
                                       scores.new_tensor(NEG_INF)),
                          dim=-1, stable=True)
    boxes_s = torch.gather(boxes, -2,
                           order[..., None].expand(boxes.shape))
    keep_sorted = _greedy_keep_presupp(
        _suppression_matrix(boxes_s, iou_thr),
        torch.gather(valid, -1, order))
    return torch.zeros_like(keep_sorted).scatter(-1, order, keep_sorted)


def rnms(quads: torch.Tensor, scores: torch.Tensor, iou_thr: float = 0.1,
         valid: torch.Tensor | None = None, presorted: bool = False):
    """Greedy NMS on quads [..., N, 8] by polygon IoU
    (`core.riou.quad_overlaps`): a quad is suppressed by a kept quad of
    higher rank whose IoU with it exceeds ``iou_thr``.  ``presorted`` as
    in `nms`; otherwise the quads are ranked by a stable descending sort
    of the scores (invalid last).  Returns the keep mask [..., N]."""
    if valid is None:
        valid = torch.ones(scores.shape, dtype=torch.bool,
                           device=scores.device)
    if presorted:
        return _greedy_keep_presupp(quad_overlaps(quads, quads) > iou_thr,
                                    valid)
    order = torch.argsort(-torch.where(valid, scores,
                                       scores.new_tensor(NEG_INF)),
                          dim=-1, stable=True)
    quads_s = torch.gather(quads, -2, order[..., None].expand(quads.shape))
    keep_sorted = _greedy_keep_presupp(
        quad_overlaps(quads_s, quads_s) > iou_thr,
        torch.gather(valid, -1, order))
    return torch.zeros_like(keep_sorted).scatter(-1, order, keep_sorted)


SOFT_NMS_METHODS = ("linear", "gaussian", "naive")


def soft_nms(boxes: torch.Tensor, scores: torch.Tensor, iou_thr: float = 0.3,
             method: str = "linear", sigma: float = 0.5,
             min_score: float = 1e-3, valid: torch.Tensor | None = None):
    """Soft-NMS on horizontal boxes [..., N, 4]: decay instead of
    suppress (the reference's `soft_nms` :178; parity: mmdet's
    soft_nms_cpu).  N rounds over every problem of the call at once:
    each round picks the highest live score of each problem (the first
    on a tie) and, while that score exceeds ``min_score``, decays the
    other live scores by its IoU row (legacy +1 sizes): "linear" by
    1 - IoU above ``iou_thr``, "gaussian" by exp(-IoU^2 / sigma),
    "naive" to 0 above ``iou_thr``.  The rounds run on the tensors'
    device without a host sync.  Returns (decayed scores [..., N], 0
    where not kept; keep [..., N] bool: picked while alive, with a
    final score above ``min_score``)."""
    if method not in SOFT_NMS_METHODS:
        raise ValueError(f"soft_nms method {method!r}: one of "
                         f"{SOFT_NMS_METHODS}")
    n = scores.shape[-1]
    if valid is None:
        valid = torch.ones(scores.shape, dtype=torch.bool,
                           device=scores.device)
    iou = bbox_overlaps(boxes, boxes)                     # [..., N, N]
    if method == "linear":
        decay = torch.where(iou > iou_thr, 1.0 - iou, 1.0)
    elif method == "gaussian":
        decay = torch.exp(-(iou * iou) / sigma)
    else:
        decay = torch.where(iou > iou_thr, 0.0, 1.0).to(iou.dtype)
    neg = scores.new_tensor(NEG_INF)
    cur = torch.where(valid, scores, neg)
    done = ~valid
    keep = torch.zeros_like(valid)
    cols = torch.arange(n, device=scores.device)
    for _ in range(n):
        i = torch.argmax(torch.where(done, neg, cur), -1, keepdim=True)
        alive = torch.gather(cur, -1, i) > min_score          # [..., 1]
        pick = cols == i                                      # [..., N]
        row = torch.gather(decay, -2, i[..., None].expand(
            i.shape[:-1] + (1, n)))[..., 0, :]
        decayed = torch.where(done | pick, cur, cur * row)
        cur = torch.where(alive, decayed, cur)
        done = done | pick
        keep = keep | (pick & alive)
    keep = keep & (cur > min_score)
    return torch.where(keep, cur, cur.new_zeros(())), keep


class NMSResult(NamedTuple):
    """Fixed-size multiclass NMS output (last dim ``max_num``)."""
    boxes: torch.Tensor    # [..., K, D]
    scores: torch.Tensor   # [..., K]
    labels: torch.Tensor   # [..., K] 0-based class (-1 if invalid)
    valid: torch.Tensor    # [..., K] bool
    roi_idx: torch.Tensor  # [..., K] source roi index (-1 if invalid)


def _per_class_boxes(multi_bboxes, num_classes, dim):
    """[B, N, G*dim] or [B, N, dim] -> [B, C, N, dim]; the background
    group 0 is dropped when the layout is per class."""
    b, n = multi_bboxes.shape[:2]
    if multi_bboxes.shape[-1] > dim:
        per = multi_bboxes.reshape(b, n, -1, dim)
        per = (per[:, :, 1:num_classes + 1] if per.shape[2] > num_classes
               else per[:, :, -num_classes:])
        return per.transpose(1, 2)
    return multi_bboxes[:, None].expand(b, num_classes, n, dim)


def nms_cfg_kwargs(cfg: dict) -> dict:
    """A test_cfg's NMS selection as `multiclass_nms` keywords (port of
    the reference's `ops/nms.py::nms_cfg_kwargs` :246-268; parity:
    bbox_nms.py:45-47): the flat ``nms_thr`` key, overridden by a
    reference-style ``nms=dict(type='nms', iou_thr=...)`` or
    ``nms=dict(type='soft_nms', iou_thr=..., method=..., sigma=...,
    min_score=...)`` (defaults linear, 0.5, 1e-3).
    """
    out: dict = dict(iou_thr=cfg.get("nms_thr", 0.5))
    ncfg = cfg.get("nms")
    if ncfg:
        d = dict(ncfg)
        t = d.pop("type", "nms")
        out["iou_thr"] = d.pop("iou_thr", out["iou_thr"])
        if t == "soft_nms":
            out["nms_type"] = "soft_nms"
            out["soft_method"] = d.pop("method", "linear")
            out["sigma"] = d.pop("sigma", 0.5)
            out["min_score"] = d.pop("min_score", 1e-3)
        elif t != "nms":
            raise ValueError(f"unknown nms type {t!r}")
    return out


def multiclass_nms(multi_bboxes, multi_scores, score_thr: float,
                   iou_thr: float = 0.5, max_num: int = 100,
                   valid: torch.Tensor | None = None,
                   pre_nms_top_k: int = 256, box_dim: int = 4,
                   nms_type: str = "nms", soft_method: str = "linear",
                   sigma: float = 0.5, min_score: float = 1e-3) -> NMSResult:
    """Per-class NMS over padded candidates, fixed-size top-K output.

    ``nms_type="soft_nms"`` runs each class through `soft_nms` (boxes
    only: ``box_dim`` 4); the kept detections carry their decayed
    scores into the global top-``max_num``.

    Args:
      multi_bboxes: [(B,) N, G*D] (group 0 = background) or [(B,) N, D]
        with D = ``box_dim``: 4 for boxes (`nms`), 8 for quads, which
        are suppressed by polygon IoU (`rnms`).
      multi_scores: [(B,) N, C+1], background in column 0.
      valid: [(B,) N] candidate validity.
      pre_nms_top_k: each class's NMS runs on its top max(k, max_num)
        candidates only; 0 disables.  Like the reference, this is an
        approximation where suppression removes more than k - max_num
        of a class's top k.
    """
    single = multi_scores.dim() == 2
    if single:
        multi_bboxes, multi_scores = multi_bboxes[None], multi_scores[None]
        valid = None if valid is None else valid[None]
    b, n, c1 = multi_scores.shape
    num_classes = c1 - 1
    dev = multi_scores.device
    if valid is None:
        valid = torch.ones(b, n, dtype=torch.bool, device=dev)

    scores_t = multi_scores[..., 1:].transpose(1, 2)       # [B, C, N]
    if box_dim not in (4, 8):
        raise ValueError(f"box_dim {box_dim}: 4 (boxes) or 8 (quads)")
    if nms_type not in ("nms", "soft_nms"):
        raise ValueError(f"nms_type {nms_type!r}: 'nms' or 'soft_nms'")
    soft = nms_type == "soft_nms"
    if soft and box_dim != 4:
        raise ValueError("soft_nms supports horizontal boxes only "
                         "(the reference's is HBB only)")
    suppress = nms if box_dim == 4 else rnms
    boxes_t = _per_class_boxes(multi_bboxes, num_classes, box_dim)
    cls_valid = valid[:, None, :] & (scores_t > score_thr)
    neg = scores_t.new_tensor(NEG_INF)

    def soft_keep(bx, sc, v):
        return soft_nms(bx, sc, iou_thr, soft_method, sigma, min_score, v)

    if pre_nms_top_k and pre_nms_top_k < n:
        k = min(max(pre_nms_top_k, max_num), n)
        top_s, top_i = topk(torch.where(cls_valid, scores_t, neg), k)
        boxes_k = torch.gather(
            boxes_t, 2, top_i[..., None].expand(b, num_classes, k, box_dim))
        if soft:
            dec_s, keep_k = soft_keep(boxes_k, top_s, top_s > NEG_INF / 2)
            scores_t = scores_t.scatter(-1, top_i, dec_s)
        else:
            keep_k = suppress(boxes_k, top_s, iou_thr, top_s > NEG_INF / 2,
                              presorted=True)
        keep = torch.zeros_like(cls_valid).scatter(-1, top_i, keep_k)
        keep &= cls_valid
    elif soft:
        scores_t, keep = soft_keep(boxes_t, scores_t, cls_valid)
        keep &= cls_valid
    else:
        keep = suppress(boxes_t, scores_t, iou_thr, cls_valid)

    flat = torch.where(keep, scores_t, neg).reshape(b, num_classes * n)
    k = min(max_num, flat.shape[1])
    top_scores, top_idx = topk(flat, k)
    if k < max_num:
        pad = max_num - k
        top_scores = torch.cat(
            [top_scores, top_scores.new_full((b, pad), NEG_INF)], 1)
        top_idx = torch.cat([top_idx, top_idx.new_zeros((b, pad))], 1)
    top_cls = top_idx // n
    top_roi = top_idx % n
    top_valid = top_scores > NEG_INF / 2
    bi = torch.arange(b, device=dev)[:, None]
    top_boxes = boxes_t[bi, top_cls, top_roi]
    res = NMSResult(
        boxes=torch.where(top_valid[..., None], top_boxes,
                          top_boxes.new_zeros(())),
        scores=torch.where(top_valid, top_scores,
                           top_scores.new_zeros(())),
        labels=torch.where(top_valid, top_cls, -1),
        valid=top_valid,
        roi_idx=torch.where(top_valid, top_roi, -1))
    if single:
        res = NMSResult(*(t[0] for t in res))
    return res


def multiclass_nms_with_index(multi_bboxes, multi_scores, score_thr: float,
                              iou_thr: float = 0.5, max_num: int = 100,
                              valid: torch.Tensor | None = None) -> NMSResult:
    """`multiclass_nms` of boxes, read for its provenance: each kept
    detection's class (``labels``) and source roi (``roi_idx``), at
    which a parallel rotated branch selects its own decode
    (`select_parallel_rboxes`: the reference's "rbbox NMS by bbox
    NMS", rbbox_nms.py:6-118)."""
    return multiclass_nms(multi_bboxes, multi_scores, score_thr,
                          iou_thr=iou_thr, max_num=max_num, valid=valid)


def batched_nms(boxes: torch.Tensor, scores: torch.Tensor,
                idxs: torch.Tensor, iou_thr: float,
                valid: torch.Tensor | None = None) -> torch.Tensor:
    """Category-aware NMS of boxes [N, 4]: boxes of different ``idxs``
    never suppress each other (torchvision's batched_nms).  The IoU is
    `bbox_overlaps`' (legacy +1 sizes) over ``iou_thr``, as the
    reference's.  Returns the keep mask [N]."""
    if valid is None:
        valid = torch.ones(scores.shape, dtype=torch.bool,
                           device=scores.device)
    order = torch.argsort(-torch.where(valid, scores,
                                       scores.new_tensor(NEG_INF)),
                          stable=True)
    boxes_s, idxs_s = boxes[order], idxs[order]
    supp = ((bbox_overlaps(boxes_s, boxes_s) > iou_thr)
            & (idxs_s[:, None] == idxs_s[None, :]))
    keep_sorted = _greedy_keep_presupp(supp, valid[order])
    return torch.zeros_like(keep_sorted).scatter(0, order, keep_sorted)


def select_parallel_rboxes(rbbox_decoded, res: NMSResult, box_dim: int):
    """Gather per-class rotated boxes at the HBB keep decisions.

    rbbox_decoded: [(B,) N, G*box_dim] with group c = foreground class
    c-1 (group 0 = background), or [(B,) N, box_dim] (class-agnostic).
    Returns [(B,) K, box_dim] aligned with ``res``, zero where invalid.
    """
    single = rbbox_decoded.dim() == 2
    if single:
        rbbox_decoded = rbbox_decoded[None]
        res = NMSResult(*(t[None] for t in res))
    b, n = rbbox_decoded.shape[:2]
    per = rbbox_decoded.reshape(b, n, -1, box_dim)        # [B, N, G, D]
    if per.shape[2] == 1:
        cls = torch.zeros_like(res.labels)
    else:
        cls = (res.labels + 1).clamp(0, per.shape[2] - 1)
    roi = res.roi_idx.clamp(0, n - 1)
    bi = torch.arange(b, device=per.device)[:, None]
    out = per[bi, roi, cls]
    out = torch.where(res.valid[..., None], out, out.new_zeros(()))
    return out[0] if single else out
