"""Build a CUDA source of the port into a shared library with nvcc.

Each kernel source under `aidet_tpu_torch/csrc/` has a plain
``extern "C"`` interface and includes no PyTorch header, so one nvcc
call builds it in seconds; the library is then loaded with ctypes.
Builds go to ``build/aidet_tpu_torch/`` in the checkout (git-ignored),
named by a hash of the source, the headers beside it (``*.cuh``) and
the flags, and happen at first use.
"""

from __future__ import annotations

import hashlib
import os
import re
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[1]
BUILD_DIR = REPO_ROOT / "build" / "aidet_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclass
class BuildResult:
    path: Path
    seconds: float     # 0.0 when an earlier build of the same source was found
    log: str           # nvcc's output, including ptxas's -v report


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"),
                 os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found: the port's CUDA kernels are built with the CUDA "
        "toolkit's nvcc (put it on PATH or set CUDA_HOME)")


def build_shared_library(source: Path) -> BuildResult:
    """nvcc ``source`` for sm_90a into a shared library (or reuse it)."""
    source = Path(source).resolve()
    text = source.read_bytes() + b"".join(
        h.read_bytes() for h in sorted(source.parent.glob("*.cuh")))
    text += " ".join(NVCC_FLAGS).encode()
    digest = hashlib.sha1(text).hexdigest()[:16]
    out = BUILD_DIR / f"{source.stem}-{digest}.so"
    if out.exists():
        return BuildResult(out, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed with code {proc.returncode}:\n"
                           f"{' '.join(cmd)}\n{log}")
    os.replace(tmp, out)
    return BuildResult(out, seconds, log)


def ptxas_report(log: str) -> list[dict]:
    """Registers, shared memory, stack frame and spills per kernel from
    ptxas -v."""
    kernels, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = dict(function=m.group(1))
            kernels.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            cur["smem_bytes"] = int(s.group(1)) if s else 0
        m = re.search(r"(\d+) bytes stack frame", line)
        if m:
            cur["stack_bytes"] = int(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["spill_store_bytes"] = int(m.group(1))
            cur["spill_load_bytes"] = int(m.group(2))
    return kernels


def build_all(sources=None) -> dict:
    """Build every kernel source of the port (``csrc/*.cu`` by default),
    one nvcc process per source, all started together: source ->
    `BuildResult`."""
    from concurrent.futures import ThreadPoolExecutor
    sources = sorted(sources or (Path(__file__).parent / "csrc").glob("*.cu"))
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        return dict(zip(sources, pool.map(build_shared_library, sources)))


if __name__ == "__main__":
    # python -m aidet_tpu_torch.cuda_build: build the kernels once before
    # several processes start (tools/torch_dist_train.sh)
    for src, res in build_all().items():
        print(f"{src.name}: {res.path.name}, nvcc {res.seconds:.1f} s")
