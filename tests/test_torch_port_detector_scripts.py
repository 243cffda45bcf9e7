"""The OBB results of a hobb head and of RetinaNetOBB through the port's
scripts against the reference's: `tools/torch_test.py` and
`tools/torch_dota_eval.py` on the small H-OBB RBBoxRCNN and the small
RetinaNetOBB (`chip_smoke.small_h_obb`, `chip_smoke.SMALL_RETINA_OBB`;
256^2 seeded PNG patches of `chip_smoke.write_patch_set`) against
`tools/test.py` and `tools/dota_eval.py`, with the reference's weights
carried over by the weight bridge (RetinaNetOBB's `retina_cls` bias set
to 0 in both, so that random-weight scores pass score_thr).

- `run_inference`'s saved results: the same names, detections paired
  by label (`chip_smoke.match_detections`: boxes and rboxes within 0.03
  px, hobbs plus 1e-5 of their largest coordinate, scores within 2e-4);
- both tools write an obb submission from the rboxes' quads (hobbs
  through `hobb2pointobb`, thetaobbs through their corners: the encode
  of the model's predict, `result_encode`, which for RetinaNetOBB is
  its ``rbox_encode``);
- both eval scripts score the port's saved results (``--encode`` hobb
  or thetaobb): the same mAP within 1e-6 and the same class APs.
"""

import importlib.util
import json
import os
import pickle
import sys

import jax
import numpy as np
import pytest
import torch

import aidet_tpu.apis.inference as ref_inference
import aidet_tpu.core.eval.dota as ref_dota
from aidet_tpu.utils.config import Config as RefConfig

import aidet_tpu_torch.core.eval.dota as port_dota
import chip_smoke
from aidet_tpu_torch.convert import flax_to_state_dict
from aidet_tpu_torch.models.builder import build_detector

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMG = 256
MODELS = dict(
    h_obb=dict(model=dict(chip_smoke.small_h_obb(), img_size=IMG),
               train_cfg=chip_smoke.SMALL_TRAIN_CFG,
               test_cfg=chip_smoke.SMALL_TEST_CFG),
    retinanet_obb=dict(model=dict(chip_smoke.SMALL_RETINA_OBB, img_size=IMG),
                       test_cfg=chip_smoke.SMALL_RETINA_TEST_CFG))
ENCODE = dict(h_obb="hobb", retinanet_obb="thetaobb")


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        f"tool_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module", params=sorted(MODELS))
def runs(request, tmp_path_factory):
    kind = request.param
    root = str(tmp_path_factory.mktemp(kind))
    ann, prefix, gt_json = chip_smoke.write_patch_set(root, 0, 2, IMG, 8,
                                                      seed=5)
    body = dict(MODELS[kind], data=dict(test=dict(
        type="DOTADataset", ann_file=ann, img_prefix=prefix,
        test_mode=True)))
    config = os.path.join(root, f"{kind}_small.py")
    with open(config, "w") as f:
        for k, v in body.items():
            f.write(f"{k} = {json.loads(json.dumps(v))!r}\n")

    ref_model, variables, cfg = ref_inference.init_detector(config)
    if kind == "retinanet_obb":
        params = jax.device_get(variables["params"])
        head = dict(params["_head"])
        head["retina_cls"] = dict(head["retina_cls"], bias=np.zeros_like(
            head["retina_cls"]["bias"]))
        variables = dict(variables, params=dict(params, _head=head))
    sd, unmapped = flax_to_state_dict(variables)
    assert not unmapped
    port = build_detector(RefConfig.fromfile(config).model, device="cpu")
    port.load_state_dict(sd, strict=True)
    assert port.result_encode == ENCODE[kind]
    ckpt = os.path.join(root, "weights.pt")
    torch.save(port.state_dict(), ckpt)

    out = {}
    argv = sys.argv
    saved_init = ref_inference.init_detector
    try:
        ref_inference.init_detector = lambda *a, **k: (ref_model, variables,
                                                       cfg)
        for name, extra in (("test", ["--n-devices", "1"]),
                            ("torch_test", ["--checkpoint", ckpt,
                                            "--device", "cpu"])):
            pkl = os.path.join(root, f"{name}.pkl")
            sys.argv = [name, config, "--out", pkl, "--batch-size", "2",
                        "--submit-dir", os.path.join(root, name), *extra]
            _tool(name).main()
            with open(pkl, "rb") as f:
                out[name] = pickle.load(f)
    finally:
        ref_inference.init_detector = saved_init
        sys.argv = argv
    return kind, root, gt_json, out


def test_saved_results_match(runs):
    kind, _, _, out = runs
    ref, got = out["test"], out["torch_test"]
    assert got["names"] == ref["names"] and len(got["results"]) == 2
    ref_t, got_t = ({k: torch.from_numpy(np.stack([r[k] for r in res]))
                     for k in res[0]}
                    for res in (ref["results"], got["results"]))
    assert set(got_t) == set(ref_t) == {"boxes", "scores", "labels",
                                        "valid", "rboxes"}
    assert int(got_t["valid"].sum()) > 0
    limits = dict(boxes=0.03, rboxes=0.03, scores=2e-4,
                  theta=0.03 if kind == "h_obb" else 1e-4)
    if kind == "h_obb":
        limits["rboxes_rel"] = 1e-5
    chip_smoke.match_detections(got_t, ref_t, limits)


def test_both_tools_submit_obbs_from_the_rboxes(runs):
    _, root, _, _ = runs
    for name in ("test", "torch_test"):
        files = sorted(os.listdir(os.path.join(root, name, "obb")))
        assert len(files) == 15
        lines = sum(open(os.path.join(root, name, "obb", f)).read().count(
            "\n") for f in files)
        assert lines > 0, name


def test_eval_scripts_agree_on_obb_results(runs, monkeypatch, capsys):
    kind, root, gt_json, _ = runs
    pkl = os.path.join(root, "torch_test.pkl")
    maps = {}
    for name, module in (("dota_eval", ref_dota),
                         ("torch_dota_eval", port_dota)):
        inner = module.dota_eval

        def record(*args, _inner=inner, _name=name, **kwargs):
            maps[_name] = _inner(*args, **kwargs)
            return maps[_name]
        monkeypatch.setattr(module, "dota_eval", record)
        monkeypatch.setattr(sys, "argv", [name, pkl, "--gt-json", gt_json,
                                          "--task", "obb", "--encode",
                                          ENCODE[kind]])
        _tool(name).main()
    (got, got_aps), (want, want_aps) = (maps["torch_dota_eval"],
                                        maps["dota_eval"])
    assert abs(got - want) <= 1e-6
    assert got_aps.keys() == want_aps.keys()
    for k in want_aps:
        assert abs(got_aps[k] - want_aps[k]) <= 1e-6, k
    assert "mAP" in capsys.readouterr().out
