"""Losses of the train step: softmax and sigmoid cross entropy, smooth
L1, the sigmoid focal loss, the mask heads' class-sliced losses, and
their weighting and reduction.

Port of `aidet_tpu/models/losses/utils.py` (`weight_reduce_loss`),
`cross_entropy_loss.py` (`cross_entropy`, `binary_cross_entropy`,
`mask_cross_entropy`, `CrossEntropyLoss`), `smooth_l1_loss.py`
(`smooth_l1_loss`, `SmoothL1Loss`), `balanced_l1_loss.py`
(`balanced_l1_loss`, `BalancedL1Loss`: Libra R-CNN's),
`focal_loss.py` (`FocalLoss`) and `centermap_loss.py`
(`CenterMapLoss`).  Labels follow the reference: 0 is background,
1..C the classes; softmax logits carry C + 1 channels, sigmoid and
mask logits C.  `CrossEntropyLoss(use_mask=True)` is not ported: the
detector calls `mask_cross_entropy` itself, as the reference's does.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..ops.focal_loss import sigmoid_focal_loss


def reduce_loss(loss: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "none":
        return loss
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    raise ValueError(reduction)


def weight_reduce_loss(loss, weight=None, reduction="mean",
                       avg_factor=None):
    """Elementwise weight, then reduce; 'mean' with an ``avg_factor``
    divides the sum by it (mmdet's convention)."""
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
