"""Train a detector with the PyTorch port (the port's counterpart of
tools/train.py; parity: reference tools/train.py:64-151).

    python tools/torch_train.py CONFIG [--work-dir DIR] [--resume-from
        DIR/ckpt] [--load-from DIR/ckpt] [--seed N] [--total-epochs N]
        [--batch-size N] [--n-devices N] [--device cuda|cpu]
    torchrun --nproc_per_node N tools/torch_train.py CONFIG --n-devices N
    tools/torch_dist_train.sh CONFIG N [torch_train.py args...]

It builds the config's detector for training (float32 parameters,
computing in the config's dtype), its ``data.train`` dataset and its
``train_pipeline`` (raw uint8 transfer and normalize on the device by
default, as tools/train.py) and its ``run`` dict (num_workers,
log_interval, checkpoint_interval), and runs
`apis.train.train_detector`:
checkpoints in ``WORK_DIR/ckpt``, the log in ``WORK_DIR/train.log``.
``--total-epochs`` other than the config's scales the lr decay epochs
by the same ratio.  It runs on the CUDA card unless ``--device cpu``,
and raises when there is none.  Under torchrun each process trains on
card ``LOCAL_RANK`` (NCCL; gloo with ``--device cpu``) on its share of
the global ``--batch-size``.  ``--n-devices`` sets nothing: where given,
it is only checked against the number of processes.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def parse_args():
    p = argparse.ArgumentParser(description="Train a detector")
    p.add_argument("config", help="config file path")
    p.add_argument("--work-dir", default=None)
    p.add_argument("--resume-from", default=None,
                   help="a checkpoint directory: the full state of its "
                        "latest step_N")
    p.add_argument("--load-from", default=None,
                   help="a checkpoint directory: the weights of its latest "
                        "model_N")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--total-epochs", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None,
                   help="the global batch, over every process")
    p.add_argument("--n-devices", type=int, default=None,
                   help="only a check: the run fails unless it equals "
                        "the number of processes (torchrun's "
                        "--nproc_per_node); it sets nothing")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    return p.parse_args()


def scaled_steps(steps, total_epochs: int, cfg_epochs: int):
    """The lr decay epochs of a config written for ``cfg_epochs`` when
    the run takes ``total_epochs``, scaled by the same ratio (the mmdet
    1x -> 2x convention); a rounding collision moves a stage one epoch
    later instead of dropping it."""
    ratio = total_epochs / cfg_epochs
    out = []
    for s in steps:
        v = max(1, round(s * ratio))
        if out and v <= out[-1]:
            v = out[-1] + 1
        out.append(v)
    return tuple(out)


def main():
    args = parse_args()
    import torch
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("torch_train: no CUDA card found; pass --device "
                         "cpu to train on the CPU")
    from aidet_tpu_torch.parallel.dist import init_distributed
    # first, so that the logger knows its rank and the model is built
    # on this process's card
    init_distributed(device=args.device)
    from aidet_tpu_torch.apis.train import train_detector
    from aidet_tpu_torch.data.builder import build_dataset
    from aidet_tpu_torch.data.pipeline import TrainPipeline
    from aidet_tpu_torch.models.builder import apply_fp16_cfg, build_detector
    from aidet_tpu_torch.utils.config import Config
    from aidet_tpu_torch.utils.logging import collect_env, get_root_logger

    cfg = Config.fromfile(args.config)
    work_dir = args.work_dir or cfg.get(
        "work_dir", "work_dirs/"
        + os.path.splitext(os.path.basename(args.config))[0])
    logger = get_root_logger(os.path.join(work_dir, "train.log"))
    logger.info("env: %s", collect_env())
    logger.info("config: %s", cfg.filename)

    model_cfg = apply_fp16_cfg(cfg, dict(cfg.model))
    pipe_cfg = dict(cfg.get("train_pipeline", {}))
    pipe_cfg.setdefault("device_normalize", True)
    if pipe_cfg["device_normalize"] and any(
            k in pipe_cfg for k in ("mean", "std", "to_rgb")):
        from aidet_tpu_torch.models.preprocess import (DEFAULT_MEAN,
                                                       DEFAULT_STD)
        model_cfg.setdefault("img_norm", dict(
            mean=list(pipe_cfg.get("mean", DEFAULT_MEAN)),
            std=list(pipe_cfg.get("std", DEFAULT_STD)),
            to_rgb=pipe_cfg.get("to_rgb", True)))
    model = build_detector(model_cfg, train_cfg=cfg.get("train_cfg"),
                           test_cfg=cfg.get("test_cfg"), device=args.device,
                           seed=args.seed, train=True)
    dataset = build_dataset(cfg.data["train"])

    run_cfg = dict(cfg.get("run", {}))
    run_cfg.setdefault("seed", args.seed)
    run_cfg.setdefault("optimizer", cfg.get("optimizer", {}))
    run_cfg.setdefault("lr_config", cfg.get("lr_config", {}))
    cfg_epochs = cfg.get("total_epochs", 12)
    if args.total_epochs:
        run_cfg["total_epochs"] = args.total_epochs
        if args.total_epochs != cfg_epochs:
            lrc = dict(run_cfg.get("lr_config") or {})
            lrc["step"] = scaled_steps(lrc.get("step", (8, 11)),
                                       args.total_epochs, cfg_epochs)
            run_cfg["lr_config"] = lrc
            logger.info("total-epochs %d (config %d): lr steps -> %s",
                        args.total_epochs, cfg_epochs, lrc["step"])
    if args.n_devices:
        run_cfg["n_devices"] = args.n_devices
    if args.batch_size:
        run_cfg["batch_size"] = args.batch_size
    elif cfg.get("batch_size"):
        run_cfg.setdefault("batch_size", cfg.get("batch_size"))
    run_cfg.setdefault("total_epochs", cfg_epochs)
    pipe_cfg.setdefault("img_size", model.img_size)
    run_cfg["pipeline"] = TrainPipeline(**pipe_cfg)

    train_detector(model, dataset, run_cfg, work_dir=work_dir,
                   logger=logger, resume_from=args.resume_from,
                   load_from=args.load_from, device=args.device)


if __name__ == "__main__":
    main()
