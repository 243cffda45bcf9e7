"""Slice 14's and slice 16's phases of chip_smoke run where JAX, OpenCV,
PIL and the reference package are absent (see
tests/test_torch_port_isolation.py): with every such import blocked, a
subprocess rehearses slice 14's (hbb_reference's Mask Scoring,
GA-Faster, Grid, Double-Head and Libra kinds CPU against CPU, then the
eight kinds of its configs at the small architecture; the C4 kind's
reference phase runs on the card; tests/test_torch_port_c4.py holds
its model to the reference), another slice 16's (the reference phases
of the attention, GCNet, CARAFE and GN+WS R-CNNs CPU against CPU, the
seven kinds of its configs at the small architecture, and the ops phase
at its small shapes)."""

from torch_port_isolation import run_blocked

RUN_SLICE14_PHASES = """
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


RUN_SLICE16_PHASES = """
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


def test_slice14_phases_run_with_reference_imports_blocked():
    run_blocked(RUN_SLICE14_PHASES, "SLICE14 PHASES")


def test_slice16_phases_run_with_reference_imports_blocked():
    run_blocked(RUN_SLICE16_PHASES, "SLICE16 PHASES")
