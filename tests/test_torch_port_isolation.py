"""The PyTorch port and chip_smoke.py must run where JAX, flax, optax,
torchvision and the reference package are absent, as on the machine
with the card.  A subprocess makes every such import raise, imports
every module of `aidet_tpu_torch` and `chip_smoke`, and rehearses
chip_smoke's flagship predict and train phases and its RBBoxRCNNRRoI
predict (also under AIDET_ROI_BAND=x) on the CPU (small models, plain
versions, no kernel launch) to their ends.  The kernels' CUDA sources
include no framework header."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
BLOCKED = ("jax", "jaxlib", "flax", "optax", "torchvision", "aidet_tpu",
           "__graft_entry__", "torch2jax")

RUN_BLOCKED = f"""
import importlib, importlib.abc, pkgutil, sys
BLOCKED = {BLOCKED!r}

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ModuleNotFoundError("blocked import: " + name)
        return None

sys.meta_path.insert(0, Block())
import aidet_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(aidet_tpu_torch.__path__,
                                              "aidet_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
import chip_smoke
import aidet_tpu_torch.parallel.train
out = chip_smoke.run_predict(device="cpu", small=True)
assert set(out["launches"].values()) == {{0}}, out
train = chip_smoke.run_train(device="cpu", small=True, steps=1)
assert set(train["launches"].values()) == {{0}}, train
for band in ("1", "x"):
    rroi = chip_smoke.run_rroi_predict(device="cpu", small=True, calls=1,
                                       band=band)[0]
    assert set(rroi["launches"].values()) == {{0}}, rroi
    assert rroi["n_valid"] > 0, rroi
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
print("ISOLATED", len(mods), out["n_valid"], train["params_moved"])
"""


def _env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return env


def test_port_runs_with_reference_imports_blocked():
    proc = subprocess.run([sys.executable, "-c", RUN_BLOCKED], cwd=REPO,
                          env=_env(), capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    line = proc.stdout.strip().splitlines()[-1].split()
    assert line[0] == "ISOLATED" and int(line[1]) >= 15, proc.stdout
    assert int(line[3]) > 0, proc.stdout


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("root", ["aidet_tpu_torch", "chip_smoke.py"])
def test_no_reference_import_in_source(root):
    files = ([REPO / root] if root.endswith(".py")
             else sorted((REPO / root).rglob("*.py")))
    assert files
    for f in files:
        for name in _imports(f):
            top = name.split(".")[0]
            assert top not in BLOCKED + ("tools", "bench"), (f, name)
        assert "cpp_extension" not in f.read_text(), f


def test_chip_smoke_fails_without_card_or_repo(tmp_path):
    """Without a card, and alone in a directory, chip_smoke exits
    non-zero and prints no result line."""
    for cwd in (REPO, tmp_path):
        script = cwd / "chip_smoke.py"
        if cwd == tmp_path:
            shutil.copy(REPO / "chip_smoke.py", script)
        proc = subprocess.run([sys.executable, str(script)], cwd=cwd,
                              env=_env(), capture_output=True, text=True,
                              timeout=120)
        assert proc.returncode != 0, proc.stdout
        assert '"ok"' not in proc.stdout and '"kernels"' not in proc.stdout


SOURCES = ("roi_align.cu", "roi_align_backward.cu", "roi_align_bandx.cu",
           "rroi_align.cu", "roi_common.cuh")


@pytest.mark.parametrize("name", SOURCES)
def test_kernel_source_includes_no_framework_header(name):
    """Each kernel source is plain CUDA C++ with an extern "C" entry
    (built by nvcc alone and loaded with ctypes): its includes are the
    CUDA runtime's and the C library's, or the shared header."""
    csrc = REPO / "aidet_tpu_torch" / "csrc"
    assert sorted(p.name for p in csrc.iterdir()) == sorted(SOURCES)
    text = (csrc / name).read_text()
    includes = [line.split()[1].strip('<>"') for line in text.splitlines()
                if line.startswith("#include")]
    assert includes
    assert set(includes) <= {"cuda_bf16.h", "cuda_runtime.h", "stdint.h",
                             "roi_common.cuh"}, includes
    for word in ("torch", "ATen", "pybind", "jax", "aidet_tpu/"):
        assert word not in "".join(includes), (name, word)
    if name.endswith(".cu"):
        assert 'extern "C" int aidet_' in text
