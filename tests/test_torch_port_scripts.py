"""The port's scripts end to end: `tools/torch_train.py` ->
`tools/torch_test.py --out` -> `tools/torch_dota_eval.py` on seeded
256^2 PNG patches and the small architecture (a config file written
from `chip_smoke.loop_config`), with ``--device cpu`` here and with the
default device on the card (marked gpu; run it there with ``python -m
pytest -m gpu tests/test_torch_port_scripts.py``).  Without a card the
two scripts that take ``--device`` refuse their default.  This file
imports nothing of JAX, so it runs on the card's machine.
"""

import importlib.util
import json
import os
import pickle
import subprocess
import sys

import pytest
import torch

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def config_file(tmp_path_factory):
    """The small loop config (4 train and 2 val patches) as a config
    file, one epoch at batch 2, with a run dict of one decode worker and
    a log record every step; and the val set's scene gt json."""
    root = str(tmp_path_factory.mktemp("scripts"))
    cfg, gt_json = chip_smoke.loop_config(root, small=True)
    body = {k: cfg.get(k) for k in ("model", "train_cfg", "test_cfg",
                                     "data", "train_pipeline", "optimizer",
                                     "lr_config")}
    body.update(total_epochs=1, batch_size=2,
                run=dict(num_workers=1, log_interval=1))
    path = os.path.join(root, "tiny_config.py")
    with open(path, "w") as f:
        for k, v in body.items():
            f.write(f"{k} = {json.loads(json.dumps(v))!r}\n")
    return path, gt_json


def _run_scripts(config, gt_json, root, device_args):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)

    def run(*args):
        proc = subprocess.run([sys.executable, *args], cwd=REPO, env=env,
                              capture_output=True, text=True, timeout=600)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        return proc.stdout + proc.stderr

    work = os.path.join(root, "work")
    log = run("tools/torch_train.py", config, "--work-dir", work,
              *device_args)
    assert "epoch 1 iter 2/2" in log
    assert sorted(os.listdir(os.path.join(work, "ckpt"))) == [
        "meta.json", "model_1", "step_1"]
    pkl = os.path.join(root, "results.pkl")
    submit = os.path.join(root, "submit")
    log = run("tools/torch_test.py", config, "--checkpoint",
              os.path.join(work, "ckpt"), "--out", pkl, "--submit-dir",
              submit, "--batch-size", "2", *device_args)
    assert "obb: merged 2 scenes" in log and "hbb: merged 2 scenes" in log
    with open(pkl, "rb") as f:
        saved = pickle.load(f)
    assert len(saved["results"]) == len(saved["names"]) == 2
    assert len(os.listdir(os.path.join(submit, "obb"))) == 15
    out = run("tools/torch_dota_eval.py", pkl, "--gt-json", gt_json,
              "--export", os.path.join(root, "aps"))
    assert "mAP" in out and os.path.exists(os.path.join(root, "aps.csv"))
    return log


def test_scripts_train_test_and_score_on_the_cpu(config_file, tmp_path):
    _run_scripts(*config_file, str(tmp_path), ["--device", "cpu"])


@pytest.mark.gpu
def test_scripts_train_test_and_score_on_the_card(config_file, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the chip with python -m "
                    "pytest -m gpu tests/test_torch_port_scripts.py")
    log = _run_scripts(*config_file, str(tmp_path), [])
    assert "ran inference on 2 images" in log


@pytest.mark.parametrize("name", ["torch_train", "torch_test"])
def test_scripts_refuse_their_default_without_a_card(config_file,
                                                     monkeypatch, name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device runs")
    spec = importlib.util.spec_from_file_location(
        f"tool_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    monkeypatch.setattr(sys, "argv", [name, config_file[0]])
    with pytest.raises(SystemExit, match="no CUDA card"):
        tool.main()
