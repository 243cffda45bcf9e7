"""What the isolation tests of the PyTorch port share
(tests/test_torch_port_isolation*.py): the list of modules that the
card's machine lacks, a prelude that makes each of them raise on
import and then imports every module of `aidet_tpu_torch`, and a runner
of a script after that prelude in a subprocess."""

import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
BLOCKED = ("jax", "jaxlib", "flax", "optax", "torchvision", "aidet_tpu",
           "__graft_entry__", "torch2jax", "cv2", "PIL", "pandas",
           "matplotlib")
# optional exports may import these inside a function
OPTIONAL = ("pandas", "matplotlib")

PRELUDE = f"""
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
"""

# the last lines of every script: nothing of the list was imported
LEAK_CHECK = """
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
"""


def env():
    """The subprocesses' environment: no PYTHONPATH, and in a
    pytest-xdist worker one OpenMP thread.  Beside the tier-1 run's
    pytest workers a subprocess with torch's default threads (one per
    core) spent most of its time in oversubscribed OpenMP waits: the
    detector phases' rehearsal took 218.6 s with them and 74.5 s with
    one thread, six busy processes beside it on 8 cores.  Alone, a
    subprocess runs with the default threads."""
    out = dict(os.environ)
    out.pop("PYTHONPATH", None)
    if os.environ.get("PYTEST_XDIST_WORKER"):
        out["OMP_NUM_THREADS"] = "1"
    return out


def run_blocked(script, last, timeout=300):
    """Run ``PRELUDE + script`` from the repository's root; assert that it
    exits 0 and that its last line of output starts with ``last``."""
    proc = subprocess.run([sys.executable, "-c", PRELUDE + script], cwd=REPO,
                          env=env(), capture_output=True, text=True,
                          timeout=timeout)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    out = proc.stdout.strip().splitlines()
    assert out and out[-1].startswith(last), proc.stdout
    return out[-1]
