"""The train step: learning-rate schedule, optimizer, train state and
one step of loss, gradients and update, on one device or data-parallel
over the ranks of a process group.

Port of `aidet_tpu/parallel/train.py` (`build_lr_schedule`,
`_param_kinds`, `build_optimizer`, `create_train_state`,
`make_train_step`).  `schedule_from_cfg` is the schedule that the
reference's train loop builds from a config
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
``paramwise_options`` (`bias_lr_mult`, `bias_decay_mult`,
`norm_decay_mult`) scale each kind's decay and step (`param_kinds`).

Data parallelism: the reference's step is one program over the global
batch, sharded over a mesh, into which XLA puts the gradient
all-reduce.  Here each rank runs the step on its rows of the global
batch; the loss normalisers are global (`dist.global_losses`), the
gradients and the logged losses are summed over the ranks in one
flattened all-reduce, and the clip and the update then run on the same
gradients on every rank.
"""

from __future__ import annotations

import inspect

from dataclasses import dataclass, field

import torch
import torch.distributed as dist
from torch import nn
from torch.profiler import record_function

from .dist import global_losses, world_size


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


# the modules whose parameters are a norm's affine, as the reference's
# `_param_kinds` classes them (a flax leaf "scale" or "bias" beside a
# "scale"): FrozenBN, GroupNorm, LayerNorm, BatchNorm, RetinaSepBNHead's
# per-level `Affine` and the learnable `Scale` (whose flax leaf is "scale")
NORM_MODULES = ("FrozenBN", "Affine", "Scale")


def param_kinds(model: nn.Module) -> list:
    """The kind of each of ``model.parameters()``, in order: "norm" for a
    norm's affine (`NORM_MODULES`, torch's norms) and for a parameter
    that a module declares under a name ending in "_scale" or "_bias"
    (GeneralizedAttention's appr_bias and geom_bias), "bias" for any
    other ``bias``, else "weight": the reference's
    `_param_kinds` (parallel/train.py:50-70) on the same model.  A
    module's ``param_kind_overrides`` (its parameter's name -> kind)
    name the kinds of parameters that the reference declares under
    other names (the grid head's deconv biases)."""
    norms = (nn.GroupNorm, nn.LayerNorm, nn.modules.batchnorm._NormBase)
    kind = {}
    for m in model.modules():
        is_norm = (isinstance(m, norms)
                   or type(m).__name__ in NORM_MODULES)
        for name, p in m.named_parameters(recurse=False):
            if is_norm or name.endswith(("_scale", "_bias")):
                kind[id(p)] = "norm"
            elif name == "bias":
                kind[id(p)] = "bias"
            else:
                kind[id(p)] = "weight"
    for m in model.modules():
        for name, k in getattr(m, "param_kind_overrides", {}).items():
            kind[id(m.get_parameter(name))] = k
    return [kind[id(p)] for p in model.parameters()]


@dataclass
class SGD:
    """SGD with momentum, weight decay and a global-norm clip, in the
    reference's order (clip, then decay, then momentum).  With
    ``paramwise_options`` a parameter's decay is weight_decay times its
    kind's multiplier (``bias_decay_mult``, ``norm_decay_mult``) and a
    bias's step is ``bias_lr_mult`` times the others' (the reference's
    masked optax chain: a decay per kind, then the scaled update)."""
    lr_schedule: object
    momentum: float = 0.9
    weight_decay: float = 1e-4
    grad_clip_norm: float | None = 35.0
    paramwise_options: dict | None = None

    def init(self, params):
        return [torch.zeros_like(p) for p in params]

    def groups(self, kinds) -> dict:
        """The parameters' indices grouped by their (weight-decay, step)
        multipliers, from their kinds (`param_kinds`): a parameter's
        decay multiplier is its kind's ``*_decay_mult``, a bias's step
        multiplier ``bias_lr_mult``.  Without ``paramwise_options`` every
        parameter is in the one group (1, 1)."""
        pw = self.paramwise_options or {}
        decay = dict(weight=1.0, bias=pw.get("bias_decay_mult", 1.0),
                     norm=pw.get("norm_decay_mult", 1.0))
        lr = dict(weight=1.0, bias=pw.get("bias_lr_mult", 1.0), norm=1.0)
        out = {}
        for i, k in enumerate(kinds):
            out.setdefault((decay[k], lr[k]), []).append(i)
        return out

    @torch.no_grad()
    def update(self, params, grads, trace, step: int, norm=None,
               groups=None):
        """Update ``params`` and ``trace`` in place from ``grads`` (one
        tensor per parameter, none missing; the clip scales them in
        place).  ``norm`` is their `global_norm` if the caller has it;
        ``groups`` their `groups`, which ``paramwise_options`` need (by
        default all the parameters are one group (1, 1)).

        The clip stays on the device (no host sync): g / d * m with
        d = norm and m = max when norm >= max, else d = m = 1, which is
        optax's (g / norm) * max bit for bit.  Each group then takes the
        decay, momentum and step as a few `_foreach` launches."""
        if self.grad_clip_norm is not None:
            if norm is None:
                norm = global_norm(grads)
            clip = norm >= self.grad_clip_norm
            one = torch.ones_like(norm)
            torch._foreach_div_(grads, torch.where(clip, norm, one))
            torch._foreach_mul_(grads, torch.where(
                clip, torch.full_like(norm, self.grad_clip_norm), one))
        lr = self.lr_schedule(step)
        if groups is None:
            if self.paramwise_options:
                raise ValueError("paramwise_options need the parameters' "
                                 "groups (`SGD.groups` of their kinds)")
            groups = {(1.0, 1.0): None}
        for (decay, lr_mult), idx in groups.items():
            p, g, t = ((params, grads, trace) if idx is None else
                       [[x[i] for i in idx] for x in (params, grads, trace)])
            if self.weight_decay and decay:
                g = torch._foreach_add(g, p, alpha=self.weight_decay * decay)
            torch._foreach_mul_(t, self.momentum)
            torch._foreach_add_(t, g)
            torch._foreach_add_(p, t, alpha=-lr * lr_mult)


def build_optimizer(lr_schedule, momentum: float = 0.9,
                    weight_decay: float = 1e-4,
                    grad_clip_norm: float | None = 35.0,
                    paramwise_options: dict | None = None) -> SGD:
    """The reference's optimizer (parity: mmdet's SGD with momentum and
    weight decay, OptimizerHook's grad_clip, and
    core/optimizer/builder.py:10-98's paramwise_options)."""
    return SGD(lr_schedule, momentum, weight_decay, grad_clip_norm,
               paramwise_options)


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

    Over a process group of more than one rank (the data mesh of
    `parallel.mesh.create_mesh`), ``batch`` is this rank's rows of the
    global batch: the losses take global normalisers
    (`dist.global_losses`), then the gradients and the losses are summed
    over the ranks in one all-reduce of a flattened bucket per dtype (span
    "allreduce"), so every rank's metrics are the global batch's and every
    rank takes the same update.  The model must start from the same
    parameters on every rank (`mesh.replicate`).
    """
    params = list(model.parameters())
    groups = (optimizer.groups(param_kinds(model))
              if optimizer.paramwise_options else None)
    takes = set(inspect.signature(model.loss).parameters)
    size = world_size()

    def step(state: TrainState, batch: dict, generator: torch.Generator):
        with global_losses():
            losses = model.loss(**{k: v for k, v in batch.items()
                                   if k in takes}, generator=generator)
        total = sum(losses.values())
        with record_function("backward"):
            grads = torch.autograd.grad(total, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        metrics = {k: v.detach() for k, v in losses.items()}
        if size > 1:
            with record_function("allreduce"):
                names = list(metrics)
                summed = allreduce_sum(grads + [metrics[k] for k in names])
                grads = summed[:len(grads)]
                metrics = dict(zip(names, summed[len(grads):]))
        with record_function("optimizer"):
            metrics["loss"] = sum(metrics.values())
            metrics["grad_norm"] = global_norm(grads)
            optimizer.update(params, grads, state.trace, state.step,
                             metrics["grad_norm"], groups)
        state.step += 1
        return state, metrics

    return step


def allreduce_sum(tensors) -> list:
    """The tensors summed over the group's ranks: one all-reduce of a
    flattened bucket per dtype; returns new tensors in their order and
    shapes."""
    out = [None] * len(tensors)
    by_dtype = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        dist.all_reduce(flat)
        for i, part in zip(idx, flat.split([tensors[i].numel()
                                            for i in idx])):
            out[i] = part.view_as(tensors[i])
    return out
