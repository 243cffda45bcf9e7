"""chip_smoke's single-stage, H-OBB and HBB phases and slice 12's run
where JAX, OpenCV, PIL and the reference package are absent (see
tests/test_torch_port_isolation.py): with every such import blocked, a
subprocess rehearses the retinanet_obb and h_obb phases
(retinanet_obb_reference and h_obb_reference CPU against CPU, then
retinanet_obb and h_obb at the small architecture: predict in stages,
the rotated NMS, the train steps) and the HBB family's (hbb_reference's
five kinds CPU against CPU, then faster, faster_x101, rpn_fast, cascade,
cascade_mask and htc at the small architecture, HTC's train step on
`TrainPipeline` batches); another the GroupNorm, OHEM, soft-NMS, HRNet,
TTA and learning phases (gn_reference's and ohem_reference's models,
soft_nms_reference, hrnet_reference and tta_reference CPU against CPU,
then theta_r18_e2e, rroi_r18_e2e, ohem, soft_nms, hrnet and learn at the
small architecture, and rroi_reference_train CPU against CPU with its
plain versions swapped in)."""

from torch_port_isolation import run_blocked

RUN_DETECTOR_PHASES = """
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


RUN_SLICE12_PHASES = """
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


def test_detector_phases_run_with_reference_imports_blocked():
    run_blocked(RUN_DETECTOR_PHASES, "DETECTOR PHASES")


def test_slice12_phases_run_with_reference_imports_blocked():
    run_blocked(RUN_SLICE12_PHASES, "SLICE12 PHASES")
