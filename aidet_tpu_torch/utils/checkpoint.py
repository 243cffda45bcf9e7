"""Checkpoints of the train loop, in the reference's layout.

Port of `aidet_tpu/utils/checkpoint.py` (`save_checkpoint` :15,
`latest_step` :34, `load_checkpoint` :45; parity: mmcv's CheckpointHook
and runner.resume), written with `torch.save`:

- ``ckpt/step_N/state.pt``: the full train state for resume, a dict of
  the model's state_dict ("model"), the optimizer's momentum trace
  ("trace", one tensor per parameter), the step and the epoch;
- ``ckpt/model_N/model.pt``: the model's state_dict alone, for
  inference (`apis.inference.init_detector`);
- ``ckpt/meta.json``: the caller's meta (classes, epoch) and the
  checkpoint's number N as ``step``, as the reference writes it.

Each save writes under a temporary name and renames it at the end, so
an interrupted save leaves no complete-looking checkpoint, and
`latest_step` takes only names with a purely numeric suffix.  The
reference's orbax directories are not read (the card's machine has no
orbax): `load_checkpoint` of a directory without the port's
``<prefix>N/<file>`` raises `NotImplementedError`.
"""

from __future__ import annotations

import json
import os
import shutil

import torch

FILES = {"step_": "state.pt", "model_": "model.pt"}


def _replace_dir(tmp: str, final: str):
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)


def _save(obj, ckpt_dir: str, name: str, filename: str):
    tmp = os.path.join(ckpt_dir, f"{name}.tmp-{os.getpid()}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    torch.save(obj, os.path.join(tmp, filename))
    _replace_dir(tmp, os.path.join(ckpt_dir, name))


def save_checkpoint(ckpt_dir: str, state, step: int,
                    meta: dict | None = None):
    """Save ``state`` (a `parallel.train.TrainState`) as checkpoint
    ``step`` of ``ckpt_dir``: the full state, the model alone and, with
    ``meta``, the meta json."""
    ckpt_dir = os.path.abspath(ckpt_dir)
    os.makedirs(ckpt_dir, exist_ok=True)
    model = state.model.state_dict()
    full = dict(state.state_dict(), model=model,
                epoch=int((meta or {}).get("epoch", step)))
    _save(full, ckpt_dir, f"step_{step}", FILES["step_"])
    _save(model, ckpt_dir, f"model_{step}", FILES["model_"])
    if meta is not None:
        path = os.path.join(ckpt_dir, "meta.json")
        with open(path + ".tmp", "w") as f:
            json.dump(dict(meta, step=step), f)
        os.replace(path + ".tmp", path)


def latest_step(ckpt_dir: str, prefix: str = "step_") -> int:
    """The largest N of the complete ``<prefix>N`` checkpoints."""
    steps = [int(d[len(prefix):]) for d in os.listdir(ckpt_dir)
             if d.startswith(prefix) and d[len(prefix):].isdigit()]
    if not steps:
        raise FileNotFoundError(f"no '{prefix}*' checkpoints in {ckpt_dir}")
    return max(steps)


def load_checkpoint(ckpt_dir: str, step: int | None = None,
                    prefix: str = "step_", map_location="cpu"):
    """(payload, meta) of checkpoint ``step`` (default: the latest) of
    ``ckpt_dir``: with prefix "step_" the full state dict (model, trace,
    step, epoch), with "model_" the model's state_dict; meta is the
    meta json, or None."""
    ckpt_dir = os.path.abspath(ckpt_dir)
    not_ours = NotImplementedError(
        f"{ckpt_dir} holds no {prefix}N/{FILES[prefix]} checkpoint of "
        "aidet_tpu_torch (reading the JAX package's orbax checkpoints is "
        "not yet ported)")
    if step is None:
        try:
            step = latest_step(ckpt_dir, prefix)
        except FileNotFoundError:
            raise not_ours from None
    path = os.path.join(ckpt_dir, f"{prefix}{step}", FILES[prefix])
    if not os.path.exists(path):
        raise not_ours
    payload = torch.load(path, map_location=map_location, weights_only=True)
    meta_path = os.path.join(ckpt_dir, "meta.json")
    meta = None
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    return payload, meta
