"""The mask family's test run and offline eval through the port's
scripts against the reference's: `tools/torch_test.py` and
`tools/torch_dota_eval.py` on a small CenterMap-Net config (ResNet-18,
64-channel FPN, the CenterMap and WPSGA heads, 256^2 seeded PNG patches
of `chip_smoke.write_patch_set`) against `tools/test.py` and
`tools/dota_eval.py`, with the reference's weights carried over by the
weight bridge (its conv_logits bias set to 0.5, so that the random
CenterMap maps straddle the 0.5 threshold and the mask-to-OBB branch
fits real blobs).

- `run_inference`'s saved results: the same names, labels and valid,
  boxes within 1e-2 px, scores within 1e-4, masks within 1e-3;
- both tools write their obb submission through the mask-to-OBB branch
  (`masks_to_thetaobbs` -> corners -> the scene merge);
- both eval scripts score the port's saved results: the same mAP
  within 1e-6 and the same class APs.
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


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        f"tool_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("centermap_scripts"))
    ann, prefix, gt_json = chip_smoke.write_patch_set(root, 0, 3, IMG, 12,
                                                      seed=4)
    model = dict(chip_smoke.small_mask_model("centermap"), img_size=IMG)
    body = dict(model=model, train_cfg=chip_smoke.SMALL_TRAIN_CFG,
                test_cfg=dict(chip_smoke.SMALL_TEST_CFG, rcnn=dict(
                    max_per_img=16, score_thr=0.05,
                    nms=dict(type="nms", iou_thr=0.5))),
                data=dict(test=dict(type="DOTADataset", ann_file=ann,
                                    img_prefix=prefix, test_mode=True)))
    config = os.path.join(root, "centermap_small.py")
    with open(config, "w") as f:
        for k, v in body.items():
            f.write(f"{k} = {json.loads(json.dumps(v))!r}\n")

    ref_model, variables, cfg = ref_inference.init_detector(config)
    params = jax.device_get(variables["params"])
    logits = dict(params["_mask_head"]["conv_logits"])
    logits["bias"] = np.full(np.shape(logits["bias"]), 0.5, np.float32)
    params["_mask_head"] = dict(params["_mask_head"], conv_logits=logits)
    variables = dict(variables, params=params)
    sd, unmapped = flax_to_state_dict(variables)
    assert not unmapped
    port = build_detector(RefConfig.fromfile(config).model, device="cpu")
    port.load_state_dict(sd, strict=True)
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
    return root, gt_json, out


def test_saved_results_match(runs):
    _, _, out = runs
    ref, got = out["test"], out["torch_test"]
    assert got["names"] == ref["names"] and len(got["results"]) == 3
    for r, g in zip(ref["results"], got["results"]):
        assert set(g) == {"boxes", "scores", "labels", "valid", "masks"}
        np.testing.assert_array_equal(g["valid"], r["valid"])
        np.testing.assert_array_equal(g["labels"], r["labels"])
        assert np.abs(g["boxes"] - r["boxes"]).max() < 1e-2
        assert np.abs(g["scores"] - r["scores"]).max() < 1e-4
        assert np.abs(g["masks"] - r["masks"]).max() < 1e-3
    masks = np.stack([g["masks"] for g in got["results"]])
    assert 0.05 < (masks > 0.5).mean() < 0.95


def test_both_tools_submit_obbs_from_the_masks(runs):
    root, _, _ = runs
    for name in ("test", "torch_test"):
        files = sorted(os.listdir(os.path.join(root, name, "obb")))
        assert len(files) == 15
        lines = sum(open(os.path.join(root, name, "obb", f)).read().count(
            "\n") for f in files)
        assert lines > 0, name


def test_eval_scripts_agree_on_mask_results(runs, monkeypatch, capsys):
    root, gt_json, _ = runs
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
                                          "--task", "obb"])
        _tool(name).main()
    (got, got_aps), (want, want_aps) = (maps["torch_dota_eval"],
                                        maps["dota_eval"])
    assert abs(got - want) <= 1e-6
    assert got_aps.keys() == want_aps.keys()
    for k in want_aps:
        assert abs(got_aps[k] - want_aps[k]) <= 1e-6, k
    assert "mAP" in capsys.readouterr().out
