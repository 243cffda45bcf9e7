"""The data layer's train paths of the PyTorch port run where JAX,
OpenCV, PIL and the reference package are absent, as on the machine
with the card: a subprocess makes every such import raise, imports
every module of `aidet_tpu_torch`, and rehearses chip_smoke's jpeg
phase (the host library's C++ decoder built with g++ and run for real,
every JPEG fixture held to cv2's recorded decode) and its voc,
buildchange, instaboost and r18_e2e_jpeg phases at the small
architecture on the CPU: a ConcatDataset of VOCDatasets over JPEGs,
BuildChange's COCO roofs, InstaBoost (its Telea inpaint in the host
library), the albu stage, one epoch each, then the test run, with no
kernel launched."""

from torch_port_isolation import LEAK_CHECK, run_blocked

RUN_DATA_PHASES = """
import chip_smoke
jpeg = chip_smoke.run_jpeg(repeats=1)
assert jpeg["equal_to_cv2"] == jpeg["files"] - 1 == 13, jpeg
for kind in chip_smoke.DATA_PHASES:
    out = chip_smoke.run_data_phase(kind, device="cpu", small=True)
    runs = [out["train"], out["test"]] + [out[k] for k in ("albu",)
                                          if k in out]
    for run in runs:
        assert set(run["launches"].values()) == {0}, (kind, run)
    assert out["train"]["steps"] == (4 if kind == "voc" else 3), out
    assert out["test"]["images"] == 6, out
assert out["albu"]["stages"]["albu"]["changed"] > 0, out
""" + LEAK_CHECK + """
print("DATA PHASES", jpeg["ms_per_512_image_one_thread"])
"""


def test_data_phases_run_with_reference_imports_blocked():
    run_blocked(RUN_DATA_PHASES, "DATA PHASES")
