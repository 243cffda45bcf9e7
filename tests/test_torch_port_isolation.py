"""The PyTorch port, chip_smoke.py and the port's scripts must run where
JAX, flax, optax, torchvision, OpenCV, PIL, pandas, matplotlib and the
reference package are absent, as on the machine with the card.  A
subprocess makes every such import raise, imports every module of
`aidet_tpu_torch` and `chip_smoke`, and rehearses chip_smoke's flagship
predict and train phases, its RBBoxRCNNRRoI predict (also under
AIDET_ROI_BAND=x) and train, and its scene_reference and scene phases
on the CPU (small models, plain versions, no kernel launch) to their
ends, writes the DOTA eval's CSV export without pandas and matplotlib,
runs one `train_detector` step and one `run_inference` batch over two
PNG patches written by `imwrite`, and rehearses chip_smoke's loop
phase; a second subprocess, with the same imports blocked, rehearses
the mask family's phases (centermap_reference and maskobb_reference
CPU against CPU, centermap_predict and centermap_train at the small
architecture: the targets of `TrainPipeline`, the mask-to-OBB fit and
the losses); a third rehearses the single-stage and H-OBB phases
(retinanet_obb_reference and h_obb_reference CPU against CPU, then
retinanet_obb and h_obb at the small architecture: predict in stages,
the rotated NMS, the train steps) and the HBB family's
(hbb_reference's five kinds CPU against CPU, then faster, faster_x101,
rpn_fast, cascade, cascade_mask and htc at the small architecture,
HTC's train step on `TrainPipeline` batches); a fourth rehearses the GroupNorm,
OHEM, soft-NMS, HRNet, TTA and learning phases (gn_reference's and
ohem_reference's models, soft_nms_reference, hrnet_reference and
tta_reference CPU against CPU, then theta_r18_e2e, rroi_r18_e2e, ohem,
soft_nms, hrnet and learn at the small architecture, and
rroi_reference_train CPU against CPU with its plain versions swapped
in); a fifth rehearses slice 14's (hbb_reference's Mask Scoring,
GA-Faster, Grid, Double-Head and Libra kinds CPU against CPU, then the
eight kinds of its configs at the small architecture; the C4 kind's
reference phase runs on the card; tests/test_torch_port_c4.py holds
its model to the reference); a sixth rehearses slice 15's (the
reference phases of the single-stage zoo and the dcn FasterRCNN CPU
against CPU; then ten kinds of its configs at the small
architecture, in a seventh); an eighth rehearses slice 16's (the
reference phases of the attention, GCNet, CARAFE and GN+WS R-CNNs CPU
against CPU, the seven kinds of its configs at the small architecture,
and the ops phase at its small shapes); a ninth rehearses the ddp
phase (two rank processes over gloo, which check that they imported
none of the reference, and the one-process torchrun launcher).  pandas
and matplotlib may be imported only inside a function (the export's
optional xlsx and PNG);
nothing else of the list anywhere, in the port, chip_smoke.py or
tools/torch_train.py, tools/torch_test.py and tools/torch_dota_eval.py.
The kernels' CUDA sources include no framework header."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
BLOCKED = ("jax", "jaxlib", "flax", "optax", "torchvision", "aidet_tpu",
           "__graft_entry__", "torch2jax", "cv2", "PIL", "pandas",
           "matplotlib")
# optional exports may import these inside a function
OPTIONAL = ("pandas", "matplotlib")

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
rtrain = chip_smoke.run_rroi_train(device="cpu", small=True, steps=1)
assert set(rtrain["launches"].values()) == {{0}}, rtrain
assert rtrain["params_moved"] > 0, rtrain
sref = chip_smoke.run_scene_reference(device="cpu", size=512, patch=256,
                                      overlap=56)
assert sref["tiles_equal"] and sref["max_abs_err"]["unpaired"] == 0, sref
scene = chip_smoke.run_scene(device="cpu", small=True, scenes=1, serial=1)
assert set(scene["launches"].values()) == {{0}}, scene
assert min(scene["merged_per_scene"]) > 0, scene
import os, tempfile
from aidet_tpu_torch.core.eval.dota import export_dota_results
with tempfile.TemporaryDirectory() as d:
    csv = export_dota_results({{"plane": 0.5}}, 0.5, os.path.join(d, "r"),
                              pr_curves={{"plane": ([0.0, 1.0], [1.0, 0.0])}})
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


RUN_MASK_PHASES = RUN_BLOCKED[:RUN_BLOCKED.index("import chip_smoke")] + """
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


RUN_DETECTOR_PHASES = RUN_BLOCKED[:RUN_BLOCKED.index("import chip_smoke")] \
    + """
import chip_smoke
for kind in ("retinanet_obb", "h_obb"):
    ref = chip_smoke.run_detector_reference(device="cpu", kind=kind,
                                            img=128)
    assert ref["max_abs_err"]["unpaired"] == 0 and ref["n_valid"] > 0, ref
    paths = chip_smoke.run_detector_paths(device="cpu", small=True,
                                          kind=kind)
    for part in ("predict", "train"):
        assert set(paths[part]["launches"].values()) == {0}, paths
    assert paths["predict"]["n_valid"] > 0, paths
assert set(ref["train"]) == {"plain", "robust"}, ref
for kind in ("faster", "fast", "resnext", "cascade", "htc"):
    ref = chip_smoke.run_hbb_reference(device="cpu", kind=kind, img=128)
    assert ref["max_abs_err"]["unpaired"] == 0 and ref["n_valid"] > 0, ref
for kind in ("faster", "faster_x101", "rpn_fast", "cascade",
             "cascade_mask", "htc"):
    hbb = chip_smoke.run_hbb_paths(device="cpu", small=True, kind=kind)
    for part in hbb.values():
        if isinstance(part, dict):
            assert set(part["launches"].values()) == {0}, hbb
assert {"s2.loss_mask", "loss_semantic_seg"} <= set(
    hbb["train"]["losses"][0]), hbb
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
print("DETECTOR PHASES", paths["predict"]["n_valid"])
"""


RUN_SLICE12_PHASES = RUN_BLOCKED[:RUN_BLOCKED.index("import chip_smoke")] \
    + """
import chip_smoke
for kind in ("gn_theta", "gn_rroi", "ohem"):
    ref = chip_smoke.run_detector_reference(device="cpu", kind=kind,
                                            img=128)
    assert ref["max_abs_err"]["unpaired"] == 0 and ref["n_valid"] > 0, ref
for kind in ("theta_r18_e2e", "rroi_r18_e2e", "ohem"):
    paths = chip_smoke.run_detector_paths(device="cpu", small=True,
                                          kind=kind)
    assert set(paths["train"]["launches"].values()) == {0}, paths
for run in (chip_smoke.run_soft_nms_reference,
            chip_smoke.run_hrnet_reference, chip_smoke.run_tta_reference):
    ref = run(device="cpu")
    assert ref["max_abs_err"]["unpaired"] == 0, ref
soft = chip_smoke.run_soft_nms(device="cpu", small=True)
assert soft["soft"]["n_valid"] > 0 and soft["hard"]["n_valid"] > 0, soft
hrnet = chip_smoke.run_hrnet(device="cpu", small=True)
assert hrnet["tta"]["variants"] == 4 and hrnet["tta"]["merged_quads"], hrnet
learn = chip_smoke.run_learn(device="cpu", small=True)
assert learn["steps"] == 2 and 0 <= learn["obb_map"] <= 1, learn
# the plain versions swapped in for the kernels take the train flag
chip_smoke.run_reference_train(device="cpu", model="rroi")
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
print("SLICE12 PHASES", hrnet["tta"]["merged_boxes"], learn["obb_map"])
"""


RUN_SLICE14_PHASES = RUN_BLOCKED[:RUN_BLOCKED.index("import chip_smoke")] \
    + """
import chip_smoke
# (the C4 kind's reference, res5 on every crop, is the slowest on one
# CPU thread: its paths below rehearse the same code)
for kind in ("ms", "ga_faster", "grid", "dh", "libra"):
    ref = chip_smoke.run_hbb_reference(device="cpu", kind=kind, img=128)
    assert ref["max_abs_err"]["unpaired"] == 0 and ref["n_valid"] > 0, ref
for kind in ("c4", "c4_mask", "ms", "ga_rpn", "ga_faster", "grid", "dh",
             "libra"):
    hbb = chip_smoke.run_hbb_paths(device="cpu", small=True, kind=kind)
    for part in hbb.values():
        if isinstance(part, dict):
            assert set(part["launches"].values()) == {0}, hbb
            assert part.get("n_valid", 1) > 0, hbb
    if kind == "ms":
        assert "loss_mask_iou" in hbb["train"]["losses"][0], hbb
assert "loss_grid" not in hbb["train"]["losses"][0], hbb
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
print("SLICE14 PHASES", hbb["predict"]["n_valid"])
"""


RUN_SLICE15_REFERENCES = RUN_BLOCKED[:RUN_BLOCKED.index(
    "import chip_smoke")] + """
import chip_smoke
for kind in chip_smoke.SLICE15_REFERENCES:
    ref = chip_smoke.run_hbb_reference(device="cpu", kind=kind)
    assert ref["max_abs_err"]["unpaired"] == 0 and ref["n_valid"] > 0, ref
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
print("SLICE15 REFERENCES", ref["n_valid"])
"""


RUN_SLICE15_PHASES = RUN_BLOCKED[:RUN_BLOCKED.index("import chip_smoke")] \
    + """
import chip_smoke
# (sepbn, ghm and reppoints_dcn share the small models of sepbn_ghm's
# reference and of reppoints)
for kind, _ in chip_smoke.SLICE15_PATHS:
    if kind in ("sepbn", "ghm", "reppoints_dcn"):
        continue
    paths = chip_smoke.run_hbb_paths(device="cpu", small=True, kind=kind)
    for part in paths.values():
        if isinstance(part, dict):
            assert set(part["launches"].values()) == {0}, paths
            assert part.get("n_valid", 1) > 0, paths
    if kind == "free_anchor":
        assert "positive_bag_loss" in paths["train"]["losses"][0], paths
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
print("SLICE15 PHASES", paths["predict"]["n_valid"])
"""


RUN_SLICE16_PHASES = RUN_BLOCKED[:RUN_BLOCKED.index("import chip_smoke")] \
    + """
import chip_smoke
for kind in chip_smoke.SLICE16_REFERENCES:
    ref = chip_smoke.run_hbb_reference(device="cpu", kind=kind)
    assert ref["max_abs_err"]["unpaired"] == 0 and ref["n_valid"] > 0, ref
for kind, _ in chip_smoke.SLICE16_PATHS:
    paths = chip_smoke.run_hbb_paths(device="cpu", small=True, kind=kind)
    for part in paths.values():
        if isinstance(part, dict):
            assert set(part["launches"].values()) == {0}, paths
            assert part.get("n_valid", 1) > 0, paths
    if kind in ("gcb", "carafe", "gn_ws"):
        assert "loss_mask" in paths["train"]["losses"][0], paths
ops = chip_smoke.run_slice16_ops(device="cpu", small=True)
assert set(ops["launches"].values()) == {0}, ops
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
print("SLICE16 PHASES", paths["predict"]["n_valid"])
"""

RUN_DDP_PHASE = RUN_BLOCKED[:RUN_BLOCKED.index("import chip_smoke")] + """
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


def _env():
    """The subprocesses' environment: no PYTHONPATH, and in a
    pytest-xdist worker one OpenMP thread.  Beside the tier-1 run's
    pytest workers a subprocess with torch's default threads (one per
    core) spent most of its time in oversubscribed OpenMP waits: the
    detector phases' rehearsal took 218.6 s with them and 74.5 s with
    one thread, six busy processes beside it on 8 cores.  Alone, a
    subprocess runs with the default threads."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    if os.environ.get("PYTEST_XDIST_WORKER"):
        env["OMP_NUM_THREADS"] = "1"
    return env


def test_port_runs_with_reference_imports_blocked():
    proc = subprocess.run([sys.executable, "-c", RUN_BLOCKED], cwd=REPO,
                          env=_env(), capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    line = proc.stdout.strip().splitlines()[-1].split()
    assert line[0] == "ISOLATED" and int(line[1]) >= 15, proc.stdout
    assert int(line[3]) > 0, proc.stdout


def test_mask_phases_run_with_reference_imports_blocked():
    proc = subprocess.run([sys.executable, "-c", RUN_MASK_PHASES], cwd=REPO,
                          env=_env(), capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().splitlines()[-1].startswith("MASK PHASES")


def test_detector_phases_run_with_reference_imports_blocked():
    proc = subprocess.run([sys.executable, "-c", RUN_DETECTOR_PHASES],
                          cwd=REPO, env=_env(), capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().splitlines()[-1].startswith("DETECTOR PHASES")


def test_slice12_phases_run_with_reference_imports_blocked():
    proc = subprocess.run([sys.executable, "-c", RUN_SLICE12_PHASES],
                          cwd=REPO, env=_env(), capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().splitlines()[-1].startswith("SLICE12 PHASES")


def test_slice14_phases_run_with_reference_imports_blocked():
    proc = subprocess.run([sys.executable, "-c", RUN_SLICE14_PHASES],
                          cwd=REPO, env=_env(), capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().splitlines()[-1].startswith("SLICE14 PHASES")


@pytest.mark.parametrize("script,last", [
    (RUN_SLICE15_REFERENCES, "SLICE15 REFERENCES"),
    (RUN_SLICE15_PHASES, "SLICE15 PHASES")], ids=["references", "paths"])
def test_slice15_phases_run_with_reference_imports_blocked(script, last):
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                          env=_env(), capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().splitlines()[-1].startswith(last)


def test_slice16_phases_run_with_reference_imports_blocked():
    proc = subprocess.run([sys.executable, "-c", RUN_SLICE16_PHASES],
                          cwd=REPO, env=_env(), capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().splitlines()[-1].startswith("SLICE16 PHASES")


def test_ddp_phase_runs_with_reference_imports_blocked():
    """chip_smoke's ddp phase at the small architecture on the CPU: the
    launching process with the reference's imports blocked, its two
    rank processes checking that they imported none of it, and
    `tools/torch_dist_train.sh --device cpu` at one process."""
    proc = subprocess.run([sys.executable, "-c", RUN_DDP_PHASE], cwd=REPO,
                          env=_env(), capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().splitlines()[-1].startswith("DDP PHASE")


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
                              env=_env(), capture_output=True, text=True,
                              timeout=120)
        assert proc.returncode != 0, proc.stdout
        assert '"ok"' not in proc.stdout and '"kernels"' not in proc.stdout


SOURCES = ("roi_align.cu", "roi_align_backward.cu", "roi_align_bandx.cu",
           "rroi_align.cu", "rroi_align_backward.cu", "roi_common.cuh",
           "roi_tiles.cuh")


@pytest.mark.parametrize("name", SOURCES)
def test_kernel_source_includes_no_framework_header(name):
    """Each kernel source is plain CUDA C++ with an extern "C" entry
    (built by nvcc alone and loaded with ctypes): its includes are the
    CUDA runtime's and the C library's, or the shared headers."""
    csrc = REPO / "aidet_tpu_torch" / "csrc"
    assert sorted(p.name for p in csrc.iterdir()) == sorted(SOURCES)
    text = (csrc / name).read_text()
    includes = [line.split()[1].strip('<>"') for line in text.splitlines()
                if line.startswith("#include")]
    assert includes
    assert set(includes) <= {"cuda_bf16.h", "cuda_runtime.h", "stdint.h",
                             "roi_common.cuh", "roi_tiles.cuh"}, includes
    for word in ("torch", "ATen", "pybind", "jax", "aidet_tpu/"):
        assert word not in "".join(includes), (name, word)
    if name.endswith(".cu"):
        assert 'extern "C" int aidet_' in text
