"""Build the port's native sources into shared libraries.

Each kernel source under `aidet_tpu_torch/csrc/` (``*.cu``) has a plain
``extern "C"`` interface and includes no PyTorch header, so one nvcc
call builds it in seconds; the library is then loaded with ctypes.
The host sources (``*.cpp``: the JPEG decoder and the Telea inpaint of
the data layer) are built together by g++ into one host library
(`build_host_library`).  Builds go to ``build/aidet_tpu_torch/`` in the
checkout (git-ignored), named by a hash of the sources, the headers
beside them and the flags, and happen at first use.
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
CSRC = Path(__file__).resolve().parent / "csrc"
HOST_SOURCES = ("jpeg_decode.cpp", "inpaint.cpp")
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")


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


def find_gxx() -> str:
    cand = os.environ.get("CXX") or shutil.which("g++")
    if cand and shutil.which(cand):
        return cand
    raise RuntimeError(
        "g++ not found: the port's host library (the JPEG decoder and the "
        "Telea inpaint, aidet_tpu_torch/csrc/*.cpp) is built with g++ "
        "(put it on PATH or set CXX)")


def _build(compiler, flags, sources, stem, headers) -> BuildResult:
    """``compiler flags -o build/<stem>-<hash>.so sources`` unless a build
    of the same sources, headers and flags exists."""
    text = b"".join(s.read_bytes() for s in sources) + b"".join(
        h.read_bytes() for h in headers) + " ".join(flags).encode()
    digest = hashlib.sha1(text).hexdigest()[:16]
    out = BUILD_DIR / f"{stem}-{digest}.so"
    if out.exists():
        return BuildResult(out, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [compiler(), *flags, "-o", str(tmp), *map(str, sources)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"{Path(cmd[0]).name} failed with code "
                           f"{proc.returncode}:\n{' '.join(cmd)}\n{log}")
    os.replace(tmp, out)
    return BuildResult(out, seconds, log)


def build_shared_library(source: Path) -> BuildResult:
    """nvcc ``source`` for sm_90a into a shared library (or reuse it)."""
    source = Path(source).resolve()
    return _build(find_nvcc, NVCC_FLAGS, [source], source.stem,
                  sorted(source.parent.glob("*.cuh")))


def build_host_library() -> BuildResult:
    """g++ the host sources (`HOST_SOURCES`) into one shared library (or
    reuse it)."""
    return _build(find_gxx, GXX_FLAGS, [CSRC / s for s in HOST_SOURCES],
                  "host", [])


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
    sources = sorted(sources or CSRC.glob("*.cu"))
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        return dict(zip(sources, pool.map(build_shared_library, sources)))


if __name__ == "__main__":
    # python -m aidet_tpu_torch.cuda_build: build the kernels once before
    # several processes start (tools/torch_dist_train.sh)
    for src, res in build_all().items():
        print(f"{src.name}: {res.path.name}, nvcc {res.seconds:.1f} s")
