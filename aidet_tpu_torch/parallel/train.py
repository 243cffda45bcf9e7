"""The train step: learning-rate schedule, optimizer, train state and
one step of loss, gradients and update.

Port of `aidet_tpu/parallel/train.py` (`build_lr_schedule`,
`build_optimizer`, `create_train_state`, `make_train_step`) for one
device; the data-parallel mesh is not ported.  `schedule_from_cfg` is
the schedule that the reference's train loop builds from a config
(`aidet_tpu/apis/train.py:118-135`), warmup cap included.  The
optimizer is the reference's optax chain, written out:

    clip_by_global_norm(35) -> add_decayed_weights(1e-4)
        -> sgd(schedule, momentum=0.9)

g <- g * max / |g| when |g| >= max (no epsilon); g <- g + wd * p;
trace <- g + momentum * trace (from zeros); p <- p - lr(step) * trace,
with step counted from 0, so the first step runs at base_lr x the
warmup ratio.  Every parameter takes this update, including those that
no loss reaches (the frozen stem and first stage): their gradient is
zero, as a stop_gradient gives in the reference, and weight decay and
momentum still move them.  (`torch.optim.SGD` would skip them.)  The
reference's `paramwise_options` are not ported; the flagship does not
use them.
"""

from __future__ import annotations

import inspect

from dataclasses import dataclass, field

import torch
from torch import nn
from torch.profiler import record_function


def build_lr_schedule(base_lr: float = 0.02, warmup_iters: int = 500,
                      warmup_ratio: float = 1.0 / 3.0,
                      decay_steps=(8, 11), iters_per_epoch: int = 1000,
                      gamma: float = 0.1):
    """Linear warmup from base_lr * warmup_ratio, then a step decay by
    ``gamma`` at each epoch of ``decay_steps``: step (int) -> lr."""
    boundaries = [int(e * iters_per_epoch) for e in decay_steps]

    def schedule(step: int) -> float:
        lr = base_lr
        if warmup_iters > 0:
            alpha = min(step / warmup_iters, 1.0)
            lr = lr * (warmup_ratio + (1 - warmup_ratio) * alpha)
        for b in boundaries:
            if step >= b:
                lr = lr * gamma
        return lr
    return schedule


def schedule_from_cfg(cfg, iters_per_epoch: int):
    """The train loop's schedule from a run config's ``optimizer`` (lr),
    ``lr_config`` (warmup_iters, warmup_ratio, step) and
    ``total_epochs``.  A config's warmup_iters (500) assumes
    epoch-scale datasets; on a short run the ramp would swallow the
    schedule, so it is capped at a fifth of the run, as the reference
    caps it: min(warmup_iters, max(1, iters_per_epoch * total_epochs //
    5))."""
    opt_cfg = cfg.get("optimizer", {})
    lr_cfg = cfg.get("lr_config", {})
    total_epochs = cfg.get("total_epochs", 12)
    warmup_iters = min(int(lr_cfg.get("warmup_iters", 500)),
                       max(1, iters_per_epoch * total_epochs // 5))
    return build_lr_schedule(
        base_lr=opt_cfg.get("lr", 0.02), warmup_iters=warmup_iters,
        warmup_ratio=lr_cfg.get("warmup_ratio", 1.0 / 3),
        decay_steps=lr_cfg.get("step", (8, 11)),
        iters_per_epoch=iters_per_epoch)


@dataclass
class SGD:
    """SGD with momentum, weight decay and a global-norm clip, in the
    reference's order (clip, then decay, then momentum)."""
    lr_schedule: object
    momentum: float = 0.9
    weight_decay: float = 1e-4
    grad_clip_norm: float | None = 35.0

    def init(self, params):
        return [torch.zeros_like(p) for p in params]

    @torch.no_grad()
    def update(self, params, grads, trace, step: int, norm=None):
        """Update ``params`` and ``trace`` in place from ``grads`` (one
        tensor per parameter, none missing; the clip scales them in
        place).  ``norm`` is their `global_norm` if the caller has it.

        The clip stays on the device (no host sync): g / d * m with
        d = norm and m = max when norm >= max, else d = m = 1, which is
        optax's (g / norm) * max bit for bit."""
        if self.grad_clip_norm is not None:
            if norm is None:
                norm = global_norm(grads)
            clip = norm >= self.grad_clip_norm
            one = torch.ones_like(norm)
            torch._foreach_div_(grads, torch.where(clip, norm, one))
            torch._foreach_mul_(grads, torch.where(
                clip, torch.full_like(norm, self.grad_clip_norm), one))
        if self.weight_decay:
            grads = torch._foreach_add(grads, params,
                                       alpha=self.weight_decay)
        torch._foreach_mul_(trace, self.momentum)
        torch._foreach_add_(trace, grads)
        torch._foreach_add_(params, trace, alpha=-self.lr_schedule(step))


def build_optimizer(lr_schedule, momentum: float = 0.9,
                    weight_decay: float = 1e-4,
                    grad_clip_norm: float | None = 35.0) -> SGD:
    return SGD(lr_schedule, momentum, weight_decay, grad_clip_norm)


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares over all the tensors (float32)."""
    return torch.linalg.vector_norm(torch.stack(
        [n.float() for n in torch._foreach_norm(tensors)]))


@dataclass
class TrainState:
    """Step count (from 0), the model, whose parameters the step
    updates in place, and the optimizer's momentum buffers."""
    step: int
    model: nn.Module
    trace: list = field(default_factory=list)

    def state_dict(self) -> dict:
        """The step and the momentum trace (the model's parameters are
        the model's own state_dict)."""
        return dict(step=self.step, trace=list(self.trace))

    @torch.no_grad()
    def load_state_dict(self, state: dict):
        """Set the step and copy the trace in place (onto the trace's
        device and dtype)."""
        if len(state["trace"]) != len(self.trace):
            raise ValueError(f"a trace of {len(state['trace'])} tensors for "
                             f"{len(self.trace)} parameters")
        for t, saved in zip(self.trace, state["trace"]):
            t.copy_(saved)
        self.step = int(state["step"])


def create_train_state(model: nn.Module, optimizer: SGD) -> TrainState:
    return TrainState(0, model,
                      optimizer.init(list(model.parameters())))


def make_train_step(model: nn.Module, optimizer: SGD):
    """step(state, batch, generator) -> (state, metrics).

    ``batch`` holds the detector's `loss` inputs (imgs, gt_boxes, gt_valid,
    gt_labels, img_shapes, gt_rboxes, gt_masks, gt_semantic, ...: a
    `TwoStageDetector`'s, a `CascadeRCNN`'s, an `RPN`'s or a
    `SingleStageDetector`'s, whose loss samples nothing); the entries that the
    model's loss does not take (an RPN's gt_labels, a box model's gt_rboxes
    from a DOTA pipeline) are left out.  ``generator`` is the sampling's
    generator, on the batch's device.  The state's model is updated in place.
    ``metrics``: each loss, their sum ``loss`` and ``grad_norm``, the global
    norm of the gradients before the clip, as detached float32 tensors.  The
    backward and the update are `record_function` spans ("backward",
    "optimizer").
    """
    params = list(model.parameters())
    takes = set(inspect.signature(model.loss).parameters)

    def step(state: TrainState, batch: dict, generator: torch.Generator):
        losses = model.loss(**{k: v for k, v in batch.items() if k in takes},
                            generator=generator)
        total = sum(losses.values())
        with record_function("backward"):
            grads = torch.autograd.grad(total, params, allow_unused=True)
        with record_function("optimizer"):
            grads = [torch.zeros_like(p) if g is None else g
                     for p, g in zip(params, grads)]
            metrics = {k: v.detach() for k, v in losses.items()}
            metrics["loss"] = total.detach()
            metrics["grad_norm"] = global_norm(grads)
            optimizer.update(params, grads, state.trace, state.step,
                             metrics["grad_norm"])
        state.step += 1
        return state, metrics

    return step
