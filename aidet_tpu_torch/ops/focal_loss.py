"""Sigmoid focal loss.

Port of `aidet_tpu/ops/focal_loss.py::sigmoid_focal_loss` (parity:
mmdet/ops/sigmoid_focal_loss).  The reference writes it as XLA code
that XLA fuses, not as a Pallas kernel, so it is plain PyTorch here,
its gradient from autograd.
"""

from __future__ import annotations

import torch


def sigmoid_focal_loss(logits: torch.Tensor, targets: torch.Tensor,
                       gamma: float = 2.0, alpha: float = 0.25):
    """Per-element focal loss [..., C] of sigmoid logits [..., C].

    ``targets``: integer labels [...] where 1..C are the classes (class
    c at channel c - 1) and 0 the background, or a [..., C] one-hot or
    soft target.  The cross entropy is the stable form on logits,
    max(x, 0) - x t + log1p(exp(-|x|)); it is weighed by
    alpha_t (1 - p_t)^gamma."""
    p = torch.sigmoid(logits)
    if targets.dim() == logits.dim():
        t = targets.to(logits.dtype)
    else:
        c = logits.shape[-1]
        classes = torch.arange(1, c + 1, device=targets.device)
        t = (targets[..., None] == classes).to(logits.dtype)
    ce = (logits.clamp(min=0) - logits * t
          + torch.log1p(torch.exp(-logits.abs())))
    p_t = p * t + (1 - p) * (1 - t)
    alpha_t = alpha * t + (1 - alpha) * (1 - t)
    return alpha_t * (1 - p_t) ** gamma * ce

