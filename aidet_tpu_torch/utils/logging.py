"""Rank-aware logging and the environment's fingerprint.

Port of `aidet_tpu/utils/logging.py` (`get_root_logger` :9, parity:
mmdet/utils/logger.py:6-44; `collect_env` :37, parity:
mmdet/utils/collect_env.py), reporting torch, CUDA, nvcc and the card's
name and power limit where the reference reports jax.
"""

from __future__ import annotations

import logging
import os
import shutil
import subprocess


def get_root_logger(log_file: str | None = None,
                    log_level=logging.INFO) -> logging.Logger:
    """The port's logger: to stderr, and to ``log_file`` on rank 0 (the
    rank of an initialised `torch.distributed` group, else 0); other
    ranks log errors only."""
    logger = logging.getLogger("aidet_tpu_torch")
    if logger.handlers:
        return logger
    fmt = logging.Formatter(
        "%(asctime)s - %(name)s - %(levelname)s - %(message)s")
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    import torch.distributed as dist
    rank = dist.get_rank() if dist.is_available() \
        and dist.is_initialized() else 0
    if rank == 0:
        logger.setLevel(log_level)
        if log_file:
            os.makedirs(os.path.dirname(os.path.abspath(log_file)),
                        exist_ok=True)
            fh = logging.FileHandler(log_file)
            fh.setFormatter(fmt)
            logger.addHandler(fh)
    else:
        logger.setLevel(logging.ERROR)
    return logger


def _lines(cmd) -> list:
    """The lines of a local command's output; none where it is not
    installed or fails."""
    if shutil.which(cmd[0]) is None:
        return []
    try:
        return subprocess.run(cmd, capture_output=True, text=True,
                              timeout=30, check=True).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        return []


def collect_env() -> dict:
    """Python, platform, torch, its CUDA, nvcc, and each card's name and
    power limit (nvidia-smi's words)."""
    import platform
    import sys

    import torch
    info = {"python": sys.version.replace("\n", ""),
            "platform": platform.platform(),
            "torch": torch.__version__,
            "torch_cuda": torch.version.cuda,
            "cuda_available": torch.cuda.is_available()}
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    release = [line for line in _lines(
        [nvcc if os.path.exists(nvcc) else "nvcc", "--version"])
        if "release" in line]
    info["nvcc"] = release[0] if release else None
    if torch.cuda.is_available():
        info["gpus"] = [torch.cuda.get_device_name(i)
                        for i in range(torch.cuda.device_count())]
        info["nvidia_smi"] = _lines(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"])
    return info
