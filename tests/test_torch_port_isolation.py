"""The PyTorch port, chip_smoke.py and the port's scripts must run where
JAX, flax, optax, torchvision, OpenCV, PIL, pandas, matplotlib and the
reference package are absent, as on the machine with the card.  A
subprocess makes every such import raise, imports every module of
`aidet_tpu_torch` and `chip_smoke` (`torch_port_isolation.PRELUDE`),
and rehearses chip_smoke's flagship predict and train phases, its
RBBoxRCNNRRoI predict (also under AIDET_ROI_BAND=x) and train, and its
scene_reference and scene phases on the CPU (small models, plain
versions, no kernel launch) to their ends, writes the DOTA eval's CSV
export without pandas and matplotlib, runs one `train_detector` step
and one `run_inference` batch over two PNG patches written by
`imwrite`, and rehearses chip_smoke's loop phase; a second subprocess,
with the same imports blocked, rehearses the mask family's phases
(centermap_reference and maskobb_reference CPU against CPU,
centermap_predict and centermap_train at the small architecture: the
targets of `TrainPipeline`, the mask-to-OBB fit and the losses); a
third the ddp phase (two rank processes over gloo, which check that
they imported none of the reference, and the one-process torchrun
launcher).  The other phases' rehearsals are in files of their own, so
that the tier-1 run's workers share them:
tests/test_torch_port_isolation_detectors.py (the single-stage and
H-OBB phases, the HBB family's, and slice 12's), _zoo.py (slices 14 and
16), _dense.py (slice 15) and _data.py (the data layer's, slice 18).
pandas and matplotlib may be imported only inside a function (the
export's optional xlsx and PNG); nothing else of the list anywhere, in
the port, chip_smoke.py or tools/torch_train.py, tools/torch_test.py
and tools/torch_dota_eval.py.  The kernels' CUDA sources and the host
library's C++ sources include no framework header."""

import ast
import shutil
import subprocess
import sys

import pytest

from torch_port_isolation import BLOCKED, OPTIONAL, REPO, env, run_blocked

RUN_BLOCKED = """
import chip_smoke
import aidet_tpu_torch.parallel.train
out = chip_smoke.run_predict(device="cpu", small=True)
assert set(out["launches"].values()) == {0}, out
train = chip_smoke.run_train(device="cpu", small=True, steps=1)
assert set(train["launches"].values()) == {0}, train
for band in ("1", "x"):
    rroi = chip_smoke.run_rroi_predict(device="cpu", small=True, calls=1,
                                       band=band)[0]
    assert set(rroi["launches"].values()) == {0}, rroi
    assert rroi["n_valid"] > 0, rroi
rtrain = chip_smoke.run_rroi_train(device="cpu", small=True, steps=1)
assert set(rtrain["launches"].values()) == {0}, rtrain
assert rtrain["params_moved"] > 0, rtrain
sref = chip_smoke.run_scene_reference(device="cpu", size=512, patch=256,
                                      overlap=56)
assert sref["tiles_equal"] and sref["max_abs_err"]["unpaired"] == 0, sref
scene = chip_smoke.run_scene(device="cpu", small=True, scenes=1, serial=1)
assert set(scene["launches"].values()) == {0}, scene
assert min(scene["merged_per_scene"]) > 0, scene
import os, tempfile
from aidet_tpu_torch.core.eval.dota import export_dota_results
with tempfile.TemporaryDirectory() as d:
    csv = export_dota_results({"plane": 0.5}, 0.5, os.path.join(d, "r"),
                              pr_curves={"plane": ([0.0, 1.0], [1.0, 0.0])})
    assert sorted(os.listdir(d)) == ["r.csv"], os.listdir(d)
from aidet_tpu_torch.apis.inference import init_detector
from aidet_tpu_torch.apis.test import run_inference
from aidet_tpu_torch.apis.train import train_detector
from aidet_tpu_torch.data.builder import build_dataset
from aidet_tpu_torch.data.pipeline import TrainPipeline
from aidet_tpu_torch.models.builder import build_detector
from aidet_tpu_torch.utils.config import Config
with tempfile.TemporaryDirectory() as d:
    ann, prefix, _ = chip_smoke.write_patch_set(d, 0, 2, 256, 12, seed=0)
    data = dict(type="DOTADataset", ann_file=ann, img_prefix=prefix)
    cfg = Config(dict(model=chip_smoke.SMALL_MODEL,
                      train_cfg=chip_smoke.SMALL_TRAIN_CFG,
                      test_cfg=chip_smoke.SMALL_TEST_CFG))
    model = build_detector(cfg.model, train_cfg=cfg.train_cfg,
                           test_cfg=cfg.test_cfg, device="cpu", train=True)
    state = train_detector(model, build_dataset(data), dict(
        batch_size=2, total_epochs=1, num_workers=1,
        pipeline=TrainPipeline(img_size=256)), work_dir=os.path.join(d, "w"),
        device="cpu")
    assert state.step == 1, state.step
    served, _ = init_detector(cfg, os.path.join(d, "w", "ckpt"),
                              device="cpu")
    results, names = run_inference(
        served, build_dataset(dict(data, test_mode=True)), batch_size=2)
    assert len(results) == 2 and results[0]["valid"].any(), names
loop = chip_smoke.run_loop(device="cpu", small=True)
assert loop["resume_rel"] == [0.0, 0.0] and loop["params_moved"] > 0, loop
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
print("ISOLATED", len(mods), out["n_valid"], train["params_moved"])
"""


RUN_MASK_PHASES = """
import chip_smoke
for kind in ("centermap", "maskobb"):
    ref = chip_smoke.run_mask_reference(device="cpu", kind=kind)
    assert ref["max_abs_err"]["unpaired"] == 0 and ref["n_valid"] > 0, ref
    assert "loss_mask" in ref["losses_cpu"], ref
pred = chip_smoke.run_centermap_predict(device="cpu", small=True)
assert set(pred["launches"].values()) == {0} and pred["n_valid"] > 0, pred
assert pred["nonempty_obbs_at_median_thr"] > 0, pred
train = chip_smoke.run_centermap_train(device="cpu", small=True)
assert set(train["launches"].values()) == {0}, train
assert {"loss_mask", "loss_seg"} <= set(train["losses"][0]), train
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
print("MASK PHASES", pred["n_valid"], len(train["losses"]))
"""


RUN_DDP_PHASE = """
import chip_smoke
out = chip_smoke.run_ddp(device="cpu", small=True)
assert out["against_one_process"]["update_rel_l2"] < 1e-4, out
assert out["test"]["against_one_process"]["unpaired"] == 0, out
assert out["launcher"]["backend"] == "gloo", out
assert set(out["train_path"]["launches"].values()) == {0}, out
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
print("DDP PHASE", out["test"]["n_valid"])
"""


def test_port_runs_with_reference_imports_blocked():
    line = run_blocked(RUN_BLOCKED, "ISOLATED").split()
    assert int(line[1]) >= 15 and int(line[3]) > 0, line


def test_mask_phases_run_with_reference_imports_blocked():
    run_blocked(RUN_MASK_PHASES, "MASK PHASES")


def test_ddp_phase_runs_with_reference_imports_blocked():
    """chip_smoke's ddp phase at the small architecture on the CPU: the
    launching process with the reference's imports blocked, its two
    rank processes checking that they imported none of it, and
    `tools/torch_dist_train.sh --device cpu` at one process."""
    run_blocked(RUN_DDP_PHASE, "DDP PHASE")


def _imports(path):
    """(absolute module name, imported at module level) of every import
    statement."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        top = node in tree.body
        if isinstance(node, ast.Import):
            yield from ((a.name, top) for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module, top


@pytest.mark.parametrize("root", ["aidet_tpu_torch", "chip_smoke.py",
                                  "tools/torch_train.py",
                                  "tools/torch_test.py",
                                  "tools/torch_dota_eval.py",
                                  "tests/torch_port_dist_worker.py"])
def test_no_reference_import_in_source(root):
    files = ([REPO / root] if root.endswith(".py")
             else sorted((REPO / root).rglob("*.py")))
    assert files
    for f in files:
        for name, at_module_level in _imports(f):
            top = name.split(".")[0]
            if top in OPTIONAL and not at_module_level:
                continue
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
                              env=env(), capture_output=True, text=True,
                              timeout=120)
        assert proc.returncode != 0, proc.stdout
        assert '"ok"' not in proc.stdout and '"kernels"' not in proc.stdout


SOURCES = ("roi_align.cu", "roi_align_backward.cu", "roi_align_bandx.cu",
           "rroi_align.cu", "rroi_align_backward.cu", "roi_common.cuh",
           "roi_tiles.cuh", "jpeg_decode.cpp", "inpaint.cpp")
# the host library's sources (g++, loaded with ctypes) include the C and
# C++ standard libraries' headers alone
HOST_INCLUDES = {"float.h", "math.h", "new", "stdarg.h", "stdint.h",
                 "stdio.h", "string.h", "vector"}


@pytest.mark.parametrize("name", SOURCES)
def test_kernel_source_includes_no_framework_header(name):
    """Each kernel source is plain CUDA C++ with an extern "C" entry
    (built by nvcc alone and loaded with ctypes): its includes are the
    CUDA runtime's and the C library's, or the shared headers.  The host
    library's C++ sources (the JPEG decoder and the Telea inpaint) have
    an extern "C" entry too and include the standard libraries' headers
    alone."""
    csrc = REPO / "aidet_tpu_torch" / "csrc"
    assert sorted(p.name for p in csrc.iterdir()) == sorted(SOURCES)
    text = (csrc / name).read_text()
    includes = [line.split()[1].strip('<>"') for line in text.splitlines()
                if line.startswith("#include")]
    assert includes
    allowed = HOST_INCLUDES if name.endswith(".cpp") else {
        "cuda_bf16.h", "cuda_runtime.h", "stdint.h", "roi_common.cuh",
        "roi_tiles.cuh"}
    assert set(includes) <= allowed, includes
    for word in ("torch", "ATen", "pybind", "jax", "aidet_tpu/"):
        assert word not in "".join(includes), (name, word)
    if not name.endswith(".cuh"):
        assert 'extern "C" int aidet_' in text
