"""Losses of the train step: softmax and sigmoid cross entropy, smooth
L1, the sigmoid focal loss, the mask heads' class-sliced losses, and
their weighting and reduction.

Port of `aidet_tpu/models/losses/utils.py` (`weight_reduce_loss`),
`cross_entropy_loss.py` (`cross_entropy`, `binary_cross_entropy`,
`mask_cross_entropy`, `CrossEntropyLoss`), `smooth_l1_loss.py`
(`smooth_l1_loss`, `SmoothL1Loss`), `balanced_l1_loss.py`
(`balanced_l1_loss`, `BalancedL1Loss`: Libra R-CNN's),
`focal_loss.py` (`FocalLoss`), `mse_loss.py` (`mse_loss`, `MSELoss`),
`accuracy.py` (`accuracy`), `centermap_loss.py`
(`CenterMapLoss`), `iou_loss.py` (`IoULoss` :62, `BoundedIoULoss` :80,
`GIoULoss` :90) and `ghm_loss.py` (`GHMC` :48 and `GHMR` :83, which
recompute the bins' density on each batch: the reference's ignore
``momentum``, and so do these).  In a data-parallel step each
normaliser is the global batch's (`parallel.dist.global_count`,
`global_mean`): a 'mean' reduction, the GHM losses' bin counts and
totals.  Labels follow the reference: 0 is background,
1..C the classes; softmax logits carry C + 1 channels, sigmoid and
mask logits C.  `CrossEntropyLoss(use_mask=True)` is not ported: the
detector calls `mask_cross_entropy` itself, as the reference's does.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..core.boxes import bbox_overlaps
from ..ops.focal_loss import sigmoid_focal_loss
from ..parallel.dist import global_count, global_mean


def reduce_loss(loss: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "none":
        return loss
    if reduction == "mean":
        return global_mean(loss)
    if reduction == "sum":
        return loss.sum()
    raise ValueError(reduction)


def weight_reduce_loss(loss, weight=None, reduction="mean",
                       avg_factor=None):
    """Elementwise weight, then reduce; 'mean' with an ``avg_factor``
    divides the sum by it (mmdet's convention), without one it is the
    global batch's mean in a data-parallel step (`global_mean`)."""
    if weight is not None:
        loss = loss * weight
    if avg_factor is None:
        return reduce_loss(loss, reduction)
    if reduction == "mean":
        return loss.sum() / avg_factor
    if reduction == "none":
        return loss
    raise ValueError("avg_factor only valid with reduction='mean'/'none'")


def cross_entropy(pred, label, weight=None, reduction="mean",
                  avg_factor=None):
    """Softmax CE over the last dim; ``label`` holds class ids
    (background 0 included)."""
    logp = F.log_softmax(pred, dim=-1)
    ll = torch.gather(logp, -1, label[..., None].long())[..., 0]
    return weight_reduce_loss(-ll, weight, reduction, avg_factor)


def binary_cross_entropy(pred, label, weight=None, reduction="mean",
                         avg_factor=None):
    """Sigmoid BCE.  Integer class ids of one dim less than ``pred``
    expand to one-hot with channel c = class c + 1 (class 0, the
    background, sets no channel); a ``weight`` of the labels' shape
    broadcasts over the channels."""
    if label.dim() != pred.dim():
        c = pred.shape[-1]
        classes = torch.arange(1, c + 1, device=label.device)
        label = label[..., None] == classes
        if weight is not None and weight.dim() != pred.dim():
            weight = weight[..., None]
    label = label.to(pred.dtype)
    loss = (pred.clamp(min=0) - pred * label
            + torch.log1p(torch.exp(-pred.abs())))
    return weight_reduce_loss(loss, weight, reduction, avg_factor)


def _class_slice(pred, label):
    """The channel of each roi's 1-based class: pred [R, S, S, C],
    label [R] -> [R, S, S] (label - 1 clamped to [0, C - 1])."""
    c = pred.shape[-1]
    idx = (label.long() - 1).clamp(0, c - 1)
    return torch.gather(pred, -1, idx[:, None, None, None].expand(
        pred.shape[:-1] + (1,)))[..., 0]


def mask_cross_entropy(pred, target, label=None, reduction="mean",
                       avg_factor=None, weight=None):
    """Per-roi class-sliced sigmoid BCE of a mask head: pred [R, S, S,
    C] logits, target [R, S, S], label [R] (1-based class of each roi,
    which picks its channel; None when pred is already sliced)."""
    if label is not None:
        pred = _class_slice(pred, label)
    loss = (pred.clamp(min=0) - pred * target
            + torch.log1p(torch.exp(-pred.abs())))
    return weight_reduce_loss(loss, weight, reduction, avg_factor)


class CenterMapLoss:
    """The CenterMap head's regression (parity: the reference's
    centermap_loss.py:33-71): each roi's map at its class channel
    against the soft centerness target, squared error, times the
    per-pixel ``mask_weight`` [R, S, S] and the per-roi ``roi_weight``
    [R] when given, reduced with ``avg_factor``."""

    def __init__(self, reduction="mean", loss_weight=1.0):
        self.reduction = reduction
        self.loss_weight = loss_weight

    def __call__(self, pred, target, label, mask_weight=None,
                 roi_weight=None, avg_factor=None):
        loss = (_class_slice(pred, label) - target) ** 2
        if mask_weight is not None:
            loss = loss * mask_weight
        if roi_weight is not None:
            loss = loss * roi_weight[:, None, None]
        return self.loss_weight * weight_reduce_loss(
            loss, None, self.reduction, avg_factor)


class CrossEntropyLoss:
    def __init__(self, use_sigmoid=False, reduction="mean",
                 loss_weight=1.0):
        self.use_sigmoid = use_sigmoid
        self.reduction = reduction
        self.loss_weight = loss_weight
        self.criterion = (binary_cross_entropy if use_sigmoid
                          else cross_entropy)

    def __call__(self, pred, target, weight=None, avg_factor=None,
                 reduction_override=None):
        reduction = reduction_override or self.reduction
        return self.loss_weight * self.criterion(
            pred, target, weight=weight, reduction=reduction,
            avg_factor=avg_factor)


def smooth_l1_loss(pred, target, weight=None, beta=1.0, reduction="mean",
                   avg_factor=None):
    diff = (pred - target).abs()
    loss = torch.where(diff < beta, 0.5 * diff * diff / beta,
                       diff - 0.5 * beta)
    return weight_reduce_loss(loss, weight, reduction, avg_factor)


class SmoothL1Loss:
    def __init__(self, beta=1.0, reduction="mean", loss_weight=1.0):
        self.beta = beta
        self.reduction = reduction
        self.loss_weight = loss_weight

    def __call__(self, pred, target, weight=None, avg_factor=None,
                 reduction_override=None):
        reduction = reduction_override or self.reduction
        return self.loss_weight * smooth_l1_loss(
            pred, target, weight, beta=self.beta, reduction=reduction,
            avg_factor=avg_factor)


def mse_loss(pred, target, weight=None, reduction="mean", avg_factor=None):
    return weight_reduce_loss((pred - target) ** 2, weight, reduction,
                              avg_factor)


class MSELoss:
    def __init__(self, reduction="mean", loss_weight=1.0):
        self.reduction = reduction
        self.loss_weight = loss_weight

    def __call__(self, pred, target, weight=None, avg_factor=None,
                 reduction_override=None):
        reduction = reduction_override or self.reduction
        return self.loss_weight * mse_loss(pred, target, weight, reduction,
                                           avg_factor)


def accuracy(pred, target, topk=1, weight=None):
    """Top-k accuracy in percent of logits pred [..., C] for int labels
    target [...], over the ``weight``-ed entries (all by default): one
    value for an int ``topk``, a list for a tuple.  Ties rank the lower
    class first (a stable sort, as the reference's argsort)."""
    topks = (topk,) if isinstance(topk, int) else tuple(topk)
    idx = torch.sort(-pred, dim=-1, stable=True)[1][..., :max(topks)]
    correct = idx == target[..., None]
    if weight is None:
        weight = torch.ones(target.shape, dtype=pred.dtype,
                            device=pred.device)
    denom = weight.sum().clamp(min=1.0)
    res = [(correct[..., :k].any(-1).to(pred.dtype) * weight).sum() / denom
           * 100.0 for k in topks]
    return res[0] if isinstance(topk, int) else res


def balanced_l1_loss(pred, target, weight=None, beta=1.0, alpha=0.5,
                     gamma=1.5, reduction="mean", avg_factor=None):
    """Libra R-CNN's balanced L1: with b = e^(gamma / alpha) - 1, alpha /
    b (b |d| + 1) log(b |d| / beta + 1) - alpha |d| below beta, gamma
    |d| + gamma / b - alpha beta above."""
    diff = (pred - target).abs()
    b = math.e ** (gamma / alpha) - 1
    loss = torch.where(
        diff < beta,
        alpha / b * (b * diff + 1) * torch.log(b * diff / beta + 1)
        - alpha * diff,
        gamma * diff + gamma / b - alpha * beta)
    return weight_reduce_loss(loss, weight, reduction, avg_factor)


class BalancedL1Loss:
    def __init__(self, alpha=0.5, gamma=1.5, beta=1.0, reduction="mean",
                 loss_weight=1.0):
        self.alpha = alpha
        self.gamma = gamma
        self.beta = beta
        self.reduction = reduction
        self.loss_weight = loss_weight

    def __call__(self, pred, target, weight=None, avg_factor=None,
                 reduction_override=None):
        reduction = reduction_override or self.reduction
        return self.loss_weight * balanced_l1_loss(
            pred, target, weight, beta=self.beta, alpha=self.alpha,
            gamma=self.gamma, reduction=reduction, avg_factor=avg_factor)


class FocalLoss:
    """Sigmoid focal loss (`ops.focal_loss.sigmoid_focal_loss`) over
    [..., C] logits, labels 1..C at channel c - 1; a ``weight`` of one
    dim less than the loss (per anchor) broadcasts over the classes."""

    def __init__(self, use_sigmoid=True, gamma=2.0, alpha=0.25,
                 reduction="mean", loss_weight=1.0):
        if not use_sigmoid:
            raise ValueError("FocalLoss is the sigmoid focal loss")
        self.gamma = gamma
        self.alpha = alpha
        self.reduction = reduction
        self.loss_weight = loss_weight

    def __call__(self, pred, target, weight=None, avg_factor=None,
                 reduction_override=None):
        reduction = reduction_override or self.reduction
        loss = sigmoid_focal_loss(pred, target, self.gamma, self.alpha)
        if weight is not None and weight.dim() != loss.dim():
            weight = weight[..., None]
        return self.loss_weight * weight_reduce_loss(
            loss, weight, reduction, avg_factor)


def iou_loss(pred, target, eps=1e-6):
    """-log IoU of aligned boxes [..., 4] (legacy +1 sizes), the IoU
    clamped at ``eps``."""
    return -torch.log(bbox_overlaps(pred, target, aligned=True)
                      .clamp(min=eps))


def bounded_iou_loss(pred, target, beta=0.2, eps=1e-3):
    """The bounded IoU loss of aligned boxes: smooth L1 at ``beta`` of
    the centre and size terms, summed over the four."""
    def centre_size(b):
        return ((b[..., 0] + b[..., 2]) * 0.5, (b[..., 1] + b[..., 3]) * 0.5,
                b[..., 2] - b[..., 0] + 1.0, b[..., 3] - b[..., 1] + 1.0)
    px, py, pw, ph = centre_size(pred)
    tx, ty, tw, th = centre_size(target)
    dx, dy = (tx - px).abs(), (ty - py).abs()
    comb = torch.stack([
        1 - ((tw - 2 * dx) / (tw + 2 * dx + eps)).clamp(min=0),
        1 - ((th - 2 * dy) / (th + 2 * dy + eps)).clamp(min=0),
        1 - torch.minimum(tw / (pw + eps), pw / (tw + eps)),
        1 - torch.minimum(th / (ph + eps), ph / (th + eps))], -1)
    return torch.where(comb < beta, 0.5 * comb * comb / beta,
                       comb - 0.5 * beta).sum(-1)


def giou_loss(pred, target, eps=1e-7):
    """1 - GIoU of aligned boxes [..., 4] (legacy +1 sizes)."""
    lt = torch.minimum(pred[..., :2], target[..., :2])
    rb = torch.maximum(pred[..., 2:], target[..., 2:])
    wh = (rb - lt + 1.0).clamp(min=0)
    enclose = wh[..., 0] * wh[..., 1]
    area_p = ((pred[..., 2] - pred[..., 0] + 1)
              * (pred[..., 3] - pred[..., 1] + 1))
    area_t = ((target[..., 2] - target[..., 0] + 1)
              * (target[..., 3] - target[..., 1] + 1))
    inter_wh = (torch.minimum(pred[..., 2:], target[..., 2:])
                - torch.maximum(pred[..., :2], target[..., :2])
                + 1.0).clamp(min=0)
    inter = inter_wh[..., 0] * inter_wh[..., 1]
    union = (area_p + area_t - inter).clamp(min=eps)
    return 1 - (inter / union - (enclose - union) / enclose.clamp(min=eps))


class IoULoss:
    """A box-IoU loss over aligned boxes [..., 4]; a ``weight`` of the
    boxes' shape [..., 4] is averaged over the last dim first."""

    def __init__(self, eps=1e-6, reduction="mean", loss_weight=1.0):
        self.eps = eps
        self.reduction = reduction
        self.loss_weight = loss_weight

    def _loss(self, pred, target):
        return iou_loss(pred, target, self.eps)

    def __call__(self, pred, target, weight=None, avg_factor=None,
                 reduction_override=None):
        reduction = reduction_override or self.reduction
        if weight is not None and weight.dim() > 1:
            weight = weight.mean(-1)
        return self.loss_weight * weight_reduce_loss(
            self._loss(pred, target), weight, reduction, avg_factor)


class BoundedIoULoss(IoULoss):
    def __init__(self, beta=0.2, eps=1e-3, reduction="mean",
                 loss_weight=1.0):
        super().__init__(eps, reduction, loss_weight)
        self.beta = beta

    def _loss(self, pred, target):
        return bounded_iou_loss(pred, target, self.beta, self.eps)


class GIoULoss(IoULoss):
    def __init__(self, eps=1e-7, reduction="mean", loss_weight=1.0):
        super().__init__(eps, reduction, loss_weight)

    def _loss(self, pred, target):
        return giou_loss(pred, target, self.eps)


def ghm_edges(bins):
    """[bins + 1] float32 bin edges i / bins (each quotient rounded once,
    as the reference's)."""
    return torch.tensor([i / bins for i in range(bins + 1)],
                        dtype=torch.float32)


def ghm_weights(g, valid, edges, tot):
    """Each valid element's harmonizing weight: ``tot`` over the count
    of its gradient-length bin (``edges`` [bins + 1], bins half-open),
    divided by the number of non-empty bins; invalid elements 0.  ``g``
    carries no gradient."""
    idx = torch.bucketize(g, edges, right=True) - 1       # bin of each g
    inbin = valid & (idx >= 0) & (idx < edges.numel() - 1)
    idx = torch.where(inbin, idx, 0)
    counts = global_count(torch.zeros(
        edges.numel() - 1, dtype=g.dtype, device=g.device).index_add_(
            0, idx.reshape(-1), inbin.reshape(-1).to(g.dtype)))
    per_bin = torch.where(counts > 0, tot / counts.clamp(min=1.0), 0.0)
    n_nonempty = (counts > 0).sum().to(g.dtype).clamp(min=1.0)
    return torch.where(inbin, per_bin[idx], 0.0) / n_nonempty


class GHMC:
    """The gradient-harmonized sigmoid cross entropy over [..., C]
    logits; integer labels (1-based) expand to one-hot over the C
    channels, a per-anchor ``weight`` broadcasts over them.  Normalized
    by the count of weighted elements; ``avg_factor`` is not read."""

    def __init__(self, bins=10, momentum=0.0, use_sigmoid=True,
                 loss_weight=1.0):
        if not use_sigmoid:
            raise ValueError("GHMC is a sigmoid loss")
        self.bins = bins
        self.momentum = momentum
        self.loss_weight = loss_weight
        self.edges = ghm_edges(bins)
        self.edges[-1] += 1e-6

    def __call__(self, pred, target, weight=None, avg_factor=None):
        if target.dim() != pred.dim():
            classes = torch.arange(1, pred.shape[-1] + 1,
                                   device=target.device)
            target = target[..., None] == classes
            if weight is not None:
                weight = weight[..., None]
        target = target.to(pred.dtype)
        weight = (torch.ones_like(pred) if weight is None
                  else weight.to(pred.dtype).expand_as(pred))
        valid = weight > 0
        tot = global_count(valid.sum().to(pred.dtype)).clamp(min=1.0)
        g = (torch.sigmoid(pred) - target).abs().detach()
        w = ghm_weights(g, valid, self.edges.to(pred.device), tot)
        ce = (pred.clamp(min=0) - pred * target
              + torch.log1p(torch.exp(-pred.abs())))
        return (ce * w).sum() / tot * self.loss_weight


class GHMR:
    """The gradient-harmonized authentic smooth L1 (sqrt(d^2 + mu^2) -
    mu), normalized by the weights' sum; ``avg_factor`` is not read."""

    def __init__(self, mu=0.02, bins=10, momentum=0.0, loss_weight=1.0):
        self.mu = mu
        self.bins = bins
        self.momentum = momentum
        self.loss_weight = loss_weight
        self.edges = ghm_edges(bins)
        self.edges[-1] = 1e3

    def __call__(self, pred, target, weight=None, avg_factor=None):
        mu = self.mu
        diff = pred - target
        loss = torch.sqrt(diff * diff + mu * mu) - mu
        weight = (torch.ones_like(pred) if weight is None
                  else weight.to(pred.dtype).expand_as(pred))
        valid = weight > 0
        tot = global_count(weight.sum()).clamp(min=1.0)
        g = (diff / torch.sqrt(mu * mu + diff * diff)).abs().detach()
        w = ghm_weights(g, valid, self.edges.to(pred.device), tot)
        return (loss * w).sum() / tot * self.loss_weight
