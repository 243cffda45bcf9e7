"""The port's scripts end to end: `tools/torch_train.py` ->
`tools/torch_test.py --out` -> `tools/torch_dota_eval.py` on seeded
256^2 PNG patches and the small architecture (a config file written
from `chip_smoke.loop_config`), with ``--device cpu`` here and with the
default device on the card (marked gpu; run it there with ``python -m
pytest -m gpu tests/test_torch_port_scripts.py``).  Without a card the
two scripts that take ``--device`` refuse their default.  Under
torchrun (`tools/torch_dist_train.sh` and `tools/torch_dist_test.sh`,
two processes over gloo with ``--device cpu``) the train script splits
the global batch over the processes and writes one checkpoint, and the
test script's gathered results pair with the one-process run's; on a
COCO box-only config the test script prints the same bbox mAP in one
and in two processes; on a VOC config over JPEGs (tests/fixtures/jpeg)
it writes ``--out`` and scores nothing, as the reference's
tools/test.py does for an XML dataset.  This file imports nothing of
JAX, so it runs on the card's machine.
"""

import importlib.util
import json
import os
import pickle
import shutil
import subprocess
import sys

import numpy as np
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


def _env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return env


def _run(*args, env=None, launcher=(sys.executable,)):
    proc = subprocess.run([*launcher, *args], cwd=REPO, env=env or _env(),
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout + proc.stderr


def _run_scripts(config, gt_json, root, device_args):
    run = _run

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


def _stack(results):
    return {k: torch.from_numpy(np.stack([r[k] for r in results]))
            for k in results[0]}


def test_scripts_under_torchrun_on_the_cpu(config_file, tmp_path):
    """Two processes: one epoch of the 4 patches at a global batch of 2
    (2 steps of one image per process), one checkpoint; then the
    sharded test run, whose gathered results pair with one process's
    (`chip_smoke.LOOP_INFER_LIMITS`)."""
    config, _ = config_file
    work, root = str(tmp_path / "work"), str(tmp_path)
    env = dict(_env(), PYTHON=sys.executable)
    log = _run("tools/torch_dist_train.sh", config, "2", "--work-dir", work,
               "--device", "cpu",
               env=dict(env, PORT=str(chip_smoke.free_port())),
               launcher=("bash",))
    assert "epoch 1 iter 2/2" in log and "2 process(es)" in log
    assert sorted(os.listdir(os.path.join(work, "ckpt"))) == [
        "meta.json", "model_1", "step_1"]
    out = {}
    for n in (1, 2):
        pkl = os.path.join(root, f"results{n}.pkl")
        args = (config, "--checkpoint", os.path.join(work, "ckpt"), "--out",
                pkl, "--batch-size", "1", "--device", "cpu")
        if n == 1:
            log = _run("tools/torch_test.py", *args)
        else:
            log = _run("tools/torch_dist_test.sh", config, "2", *args[1:],
                       env=dict(env, PORT=str(chip_smoke.free_port())),
                       launcher=("bash",))
        assert log.count("obb: merged 2 scenes") == 1, log
        with open(pkl, "rb") as f:
            out[n] = pickle.load(f)
    assert out[2]["names"] == out[1]["names"] and len(out[2]["names"]) == 2
    errs = chip_smoke.match_detections(_stack(out[2]["results"]),
                                       _stack(out[1]["results"]),
                                       chip_smoke.LOOP_INFER_LIMITS)
    assert errs["unpaired"] == 0


def test_coco_test_run_in_one_and_two_processes(tmp_path):
    """`tools/torch_test.py` on a COCO box-only config (a tiny
    FasterRCNN with seeded weights over 3 patches of a COCO json): one
    process and `tools/torch_dist_test.sh` with two (shards of 2 and 1
    images) print the same `CocoDataset.evaluate` line, and their saved
    results pair."""
    import torch_port_dist_worker as worker
    ann, prefix, _ = chip_smoke.write_patch_set(str(tmp_path), 0, 3, 256, 6,
                                                seed=3)
    config = str(tmp_path / "coco_config.py")
    body = dict(model=worker.FAMILIES["FasterRCNN"], test_cfg=dict(
        rpn=dict(nms_pre=128, nms_post=64, max_num=64),
        rcnn=dict(max_per_img=32)), data=dict(test=dict(
            type="CocoDataset", ann_file=ann, img_prefix=prefix,
            test_mode=True)))
    with open(config, "w") as f:
        for k, v in body.items():
            f.write(f"{k} = {json.loads(json.dumps(v))!r}\n")
    out, lines = {}, {}
    for n in (1, 2):
        pkl = str(tmp_path / f"coco{n}.pkl")
        args = ("--out", pkl, "--batch-size", "1", "--device", "cpu")
        if n == 1:
            log = _run("tools/torch_test.py", config, *args)
        else:
            log = _run("tools/torch_dist_test.sh", config, "2", *args,
                       env=dict(_env(), PYTHON=sys.executable,
                                PORT=str(chip_smoke.free_port())),
                       launcher=("bash",))
        lines[n] = [line.split(" - ")[-1] for line in log.splitlines()
                    if "bbox: mAP" in line]
        assert "ran inference on 3 images" in log
        with open(pkl, "rb") as f:
            out[n] = pickle.load(f)
    assert len(lines[1]) == 1 and lines[2] == lines[1], lines
    errs = chip_smoke.match_detections(_stack(out[2]["results"]),
                                       _stack(out[1]["results"]),
                                       dict(boxes=1e-3, scores=1e-5))
    assert errs["unpaired"] == 0


def test_voc_test_run_writes_out_and_scores_nothing(tmp_path):
    """`tools/torch_test.py` on a VOC config (a tiny FasterRCNN of 21
    classes with seeded weights) over three fixture JPEGs and their
    test-written XML: ``--out`` holds a result per image, and no score
    is printed (an XML dataset has no `evaluate`)."""
    import torch_port_dist_worker as worker
    root = tmp_path / "VOC2007"
    (root / "JPEGImages").mkdir(parents=True)
    (root / "Annotations").mkdir()
    fixtures = os.path.join(REPO, "tests", "fixtures", "jpeg", "dota")
    ids = [n[:-4] for n in sorted(os.listdir(fixtures))[:3]]
    for i in ids:
        shutil.copy(os.path.join(fixtures, f"{i}.jpg"),
                    root / "JPEGImages" / f"{i}.jpg")
        (root / "Annotations" / f"{i}.xml").write_text(
            "<annotation><size><width>512</width><height>512</height>"
            "</size><object><name>boat</name><difficult>0</difficult>"
            "<bndbox><xmin>40</xmin><ymin>50</ymin><xmax>200</xmax>"
            "<ymax>180</ymax></bndbox></object></annotation>")
    (root / "val.txt").write_text("\n".join(ids) + "\n")
    model = dict(worker.FAMILIES["FasterRCNN"])
    model["bbox_head"] = dict(model["bbox_head"], num_classes=21)
    body = dict(model=model, test_cfg=dict(
        rpn=dict(nms_pre=128, nms_post=64, max_num=64),
        rcnn=dict(max_per_img=32)), data=dict(test=dict(
            type="VOCDataset", ann_file=str(root / "val.txt"),
            img_prefix=str(root), test_mode=True)))
    config = str(tmp_path / "voc_config.py")
    with open(config, "w") as f:
        for k, v in body.items():
            f.write(f"{k} = {json.loads(json.dumps(v))!r}\n")
    pkl = str(tmp_path / "voc.pkl")
    log = _run("tools/torch_test.py", config, "--out", pkl, "--batch-size",
               "2", "--device", "cpu")
    assert "ran inference on 3 images" in log and "mAP" not in log, log
    with open(pkl, "rb") as f:
        saved = pickle.load(f)
    assert saved["names"] == [f"JPEGImages/{i}.jpg" for i in ids]
    assert len(saved["results"]) == 3


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
