"""Losses of the flagship's train step: softmax and sigmoid cross
entropy, smooth L1, and their weighting and reduction.

Port of `aidet_tpu/models/losses/utils.py` (`weight_reduce_loss`),
`cross_entropy_loss.py` (`cross_entropy`, `binary_cross_entropy`,
`CrossEntropyLoss`) and `smooth_l1_loss.py` (`smooth_l1_loss`,
`SmoothL1Loss`).  Labels follow the reference: 0 is background,
1..C the classes; softmax logits carry C + 1 channels, sigmoid logits
C.  The mask variant of `CrossEntropyLoss` is not ported (no mask
branch in this slice).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


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
