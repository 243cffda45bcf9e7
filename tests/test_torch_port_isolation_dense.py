"""Slice 15's phases of chip_smoke run where JAX, OpenCV, PIL and the
reference package are absent (see tests/test_torch_port_isolation.py):
with every such import blocked, a subprocess rehearses the reference
phases of the single-stage zoo and the dcn FasterRCNN CPU against CPU,
another ten kinds of its configs at the small architecture."""

import pytest

from torch_port_isolation import run_blocked

RUN_SLICE15_REFERENCES = """
import chip_smoke
for kind in chip_smoke.SLICE15_REFERENCES:
    ref = chip_smoke.run_hbb_reference(device="cpu", kind=kind)
    assert ref["max_abs_err"]["unpaired"] == 0 and ref["n_valid"] > 0, ref
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
print("SLICE15 REFERENCES", ref["n_valid"])
"""


RUN_SLICE15_PHASES = """
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


@pytest.mark.parametrize("script,last", [
    (RUN_SLICE15_REFERENCES, "SLICE15 REFERENCES"),
    (RUN_SLICE15_PHASES, "SLICE15 PHASES")], ids=["references", "paths"])
def test_slice15_phases_run_with_reference_imports_blocked(script, last):
    run_blocked(script, last)
