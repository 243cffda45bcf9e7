"""The train loop and the test run of the port on the CPU: the schedule
with its warmup cap, the train state and checkpoints, `train_detector`
(resume bit for bit, the RPN's classification loss falling),
`run_inference` against the JAX package's, and the DOTA scoring
script against the reference's (the three port scripts end to end:
tests/test_torch_port_scripts.py).

Tolerances: the schedule equals the reference's to float32 rounding
(rtol 1e-6); a run trained 2 epochs equals, bit for bit, the same run
interrupted after its epoch-1 checkpoint and resumed (under
torch.use_deterministic_algorithms: the CPU's plain RoIAlign backward
accumulates in thread order otherwise); `run_inference` of the small
flagship (float32, the reference's seeded weights carried over by
`convert.flax_to_state_dict`) pairs every detection with the
reference's within the limits of tests/test_torch_port_full_models.py
(boxes 0.25 px, scores 2e-4, rboxes 0.25 px plus 1e-3 of their largest
coordinate, theta 1e-2); the scoring scripts' mAPs agree within 1e-6.
"""

import importlib.util
import os
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _build_flagship
from aidet_tpu.apis.test import run_inference as ref_run_inference
from aidet_tpu.data.builder import build_dataset as ref_build_dataset
from aidet_tpu.parallel import build_lr_schedule as ref_build_lr_schedule

import chip_smoke
from aidet_tpu_torch.apis.inference import init_detector
from aidet_tpu_torch.apis.test import run_inference
from aidet_tpu_torch.apis.train import step_seed, train_detector
from aidet_tpu_torch.convert import flax_to_state_dict
from aidet_tpu_torch.data.builder import build_dataset
from aidet_tpu_torch.data.pipeline import TrainPipeline
from aidet_tpu_torch.flagship import build_flagship
from aidet_tpu_torch.models.builder import build_detector
from aidet_tpu_torch.parallel.mesh import Mesh
from aidet_tpu_torch.parallel.train import (build_optimizer,
                                            create_train_state,
                                            param_kinds, schedule_from_cfg)
from aidet_tpu_torch.utils.checkpoint import (latest_step, load_checkpoint,
                                              save_checkpoint)
from aidet_tpu_torch.utils.config import Config
from torch_port_helpers import perturb_norms
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP_LIMITS = dict(boxes=0.25, scores=2e-4, rboxes=0.25,
                       rboxes_rel=1e-3, theta=1e-2)


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        f"tool_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# ---------------------------------------------------------------------
# schedule, state, checkpoints
# ---------------------------------------------------------------------

@pytest.mark.parametrize("iters,epochs,warmup,step", [
    (12, 2, 500, (8, 11)), (100, 12, 500, (8, 11)), (3, 4, 0, (1, 3)),
    (1, 1, 500, (8, 11))])
def test_schedule_with_warmup_cap_equals_reference(iters, epochs, warmup,
                                                   step):
    cfg = dict(optimizer=dict(lr=0.02), total_epochs=epochs,
               lr_config=dict(warmup_iters=warmup, warmup_ratio=1.0 / 3,
                              step=step))
    got = schedule_from_cfg(cfg, iters)
    # the reference loop's formula (aidet_tpu/apis/train.py:118-135)
    capped = min(warmup, max(1, iters * epochs // 5))
    want = ref_build_lr_schedule(base_lr=0.02, warmup_iters=capped,
                                 warmup_ratio=1.0 / 3, decay_steps=step,
                                 iters_per_epoch=iters)
    for s in range(iters * epochs + 2):
        np.testing.assert_allclose(got(s), float(want(s)), rtol=1e-6)


def _small(device="cpu", seed=0):
    return build_flagship(256, small=True, device=device, seed=seed,
                          train=True)


def test_checkpoint_round_trip_and_latest_step(tmp_path):
    model = _small()
    opt = build_optimizer(lambda s: 0.1)
    state = create_train_state(model, opt)
    for t in state.trace:
        t.normal_()
    state.step = 7
    ckpt = str(tmp_path / "ckpt")
    save_checkpoint(ckpt, state, 1, meta=dict(classes=["a"], epoch=1))
    state.step = 9
    save_checkpoint(ckpt, state, 2, meta=dict(classes=["a"], epoch=2))
    os.makedirs(os.path.join(ckpt, "step_3.tmp-99"))    # an interrupted save
    assert latest_step(ckpt) == 2 and latest_step(ckpt, "model_") == 2
    full, meta = load_checkpoint(ckpt, step=1)
    assert meta == dict(classes=["a"], epoch=2, step=2)
    assert full["step"] == 7 and full["epoch"] == 1
    other = create_train_state(_small(seed=1), opt)
    other.model.load_state_dict(full["model"], strict=True)
    other.load_state_dict(full)
    assert other.step == 7
    for a, b in zip(state.trace, other.trace):
        assert torch.equal(a, b)
    for k, v in model.state_dict().items():
        assert torch.equal(v, other.model.state_dict()[k]), k
    weights, _ = load_checkpoint(ckpt, prefix="model_")
    assert weights.keys() == model.state_dict().keys()
    empty = tmp_path / "orbax"
    (empty / "step_4").mkdir(parents=True)
    for prefix in ("step_", "model_"):
        with pytest.raises(NotImplementedError, match="orbax"):
            load_checkpoint(str(empty), prefix=prefix)


def test_init_detector_reads_a_checkpoint_directory(tmp_path):
    cfg = Config(dict(model=chip_smoke.SMALL_MODEL,
                      train_cfg=chip_smoke.SMALL_TRAIN_CFG,
                      test_cfg=chip_smoke.SMALL_TEST_CFG))
    model = build_detector(cfg.model, train_cfg=cfg.train_cfg,
                           test_cfg=cfg.test_cfg, device="cpu", seed=5,
                           train=True)
    state = create_train_state(model, build_optimizer(lambda s: 0.1))
    save_checkpoint(str(tmp_path), state, 3, meta=dict(classes=["p", "q"],
                                                       epoch=3))
    got, _ = init_detector(cfg, str(tmp_path), device="cpu", seed=0)
    assert got.CLASSES == ("p", "q")
    for k, v in model.state_dict().items():
        assert torch.equal(v, got.state_dict()[k]), k


def test_build_detector_for_training_keeps_float32_parameters():
    cfg = dict(chip_smoke.SMALL_MODEL, dtype=torch.bfloat16)
    model = build_detector(cfg, device="cpu", train=True)
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    assert model.compute_dtype == torch.bfloat16
    served = build_detector(cfg, device="cpu")
    assert {p.dtype for p in served.parameters()} == {torch.bfloat16}


def test_step_seed_mixes_seed_and_step():
    seeds = {step_seed(s, t) for s in range(3) for t in range(50)}
    assert len(seeds) == 150 and all(0 <= x < 2 ** 64 for x in seeds)


# ---------------------------------------------------------------------
# train_detector
# ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def loop_data(tmp_path_factory):
    """Seeded 256^2 patches (6 train, 2 val) and the small-architecture
    config on them (`chip_smoke.loop_config`)."""
    root = str(tmp_path_factory.mktemp("loop"))
    sizes = dict(chip_smoke.LOOP_SMALL, train=6)
    old, chip_smoke.LOOP_SMALL = chip_smoke.LOOP_SMALL, sizes
    try:
        cfg, gt_json = chip_smoke.loop_config(root, small=True)
    finally:
        chip_smoke.LOOP_SMALL = old
    return root, cfg, gt_json


def _train(cfg, work_dir, epochs=2, resume_from=None, eval_hook=None,
           dataset=None):
    model = build_detector(cfg.model, train_cfg=cfg.train_cfg,
                           test_cfg=cfg.test_cfg, device="cpu", seed=0,
                           train=True)
    run = dict(seed=0, optimizer=cfg.optimizer, lr_config=cfg.lr_config,
               total_epochs=epochs, batch_size=2, log_interval=1,
               pipeline=TrainPipeline(**dict(cfg.train_pipeline,
                                             flip_ratio=0.0)))
    with chip_smoke.LoopRecords() as records:
        state = train_detector(model, dataset or build_dataset(
            cfg.data.train), run, work_dir=work_dir, device="cpu",
            resume_from=resume_from, eval_hook=eval_hook)
    return state, [r for r in records if "metrics" in r]


class Interrupted(Exception):
    pass


def test_resumed_run_equals_the_uninterrupted_one_bit_for_bit(loop_data):
    root, cfg, _ = loop_data

    def interrupt(state, epoch):
        raise Interrupted(epoch)

    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        whole, whole_steps = _train(cfg, os.path.join(root, "whole"))
        with pytest.raises(Interrupted):
            _train(cfg, os.path.join(root, "cut"), eval_hook=interrupt)
        ckpt = os.path.join(root, "cut", "ckpt")
        assert sorted(os.listdir(ckpt)) == ["meta.json", "model_1", "step_1"]
        resumed, resumed_steps = _train(cfg, os.path.join(root, "cut"),
                                        resume_from=ckpt)
    finally:
        torch.use_deterministic_algorithms(before)
    assert [r["step"] for r in whole_steps] == [1, 2, 3, 4, 5, 6]
    assert [r["step"] for r in resumed_steps] == [4, 5, 6]
    for r, w in zip(resumed_steps, whole_steps[3:]):
        assert r["metrics"] == w["metrics"] and r["lr"] == w["lr"]
    assert resumed.step == whole.step == 6
    for a, b in zip(resumed.trace, whole.trace):
        assert torch.equal(a, b)
    for k, v in whole.model.state_dict().items():
        assert torch.equal(v, resumed.model.state_dict()[k]), k


def test_losses_finite_and_rpn_loss_falling(loop_data):
    root, cfg, _ = loop_data
    dataset = build_dataset(cfg.data.train)
    dataset.img_infos = dataset.img_infos[:2]       # one batch a step
    dataset.flag = dataset.flag[:2]
    _, steps = _train(cfg, os.path.join(root, "fall"), epochs=5,
                      dataset=dataset)
    assert len(steps) == 5
    assert all(np.isfinite(v) for r in steps for v in r["metrics"].values())
    rpn = [r["metrics"]["loss_rpn_cls"] for r in steps]
    assert rpn[-1] < 0.8 * rpn[0], rpn


def test_train_detector_refuses_what_it_does_not_run(loop_data):
    _, cfg, _ = loop_data
    model = _small()
    run = dict(pipeline=TrainPipeline(img_size=256))
    with pytest.raises(RuntimeError, match="no CUDA card"):
        train_detector(model, None, run, device="cuda")
    # one process: a config's n_devices must be the world size, 1
    with pytest.raises(ValueError, match="n_devices 2 but the process "
                       "group's world size is 1"):
        train_detector(model, None, dict(run, n_devices=2), device="cpu")


def test_train_detector_takes_paramwise_options(loop_data, tmp_path):
    """The optimizer's paramwise_options reach the step: over one epoch
    with bias_lr_mult 0 no conv or fc bias moves, and with
    norm_decay_mult 0 no FrozenBN affine of the frozen stem and first
    stage does (they take no gradient, so only the decay could move
    them), while every weight moves."""
    root, cfg, _ = loop_data
    dataset = build_dataset(cfg.data.train)
    dataset.img_infos = dataset.img_infos[:2]
    dataset.flag = dataset.flag[:2]
    model = build_detector(cfg.model, train_cfg=cfg.train_cfg,
                           test_cfg=cfg.test_cfg, device="cpu", seed=0,
                           train=True)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    run = dict(seed=0, lr_config=cfg.lr_config, total_epochs=1,
               batch_size=2, log_interval=1, optimizer=dict(
                   cfg.optimizer, paramwise_options=dict(
                       bias_lr_mult=0.0, norm_decay_mult=0.0)),
               pipeline=TrainPipeline(**dict(cfg.train_pipeline,
                                             flip_ratio=0.0)))
    train_detector(model, dataset, run, work_dir=str(tmp_path),
                   device="cpu")
    kinds = dict(zip([n for n, _ in model.named_parameters()],
                     param_kinds(model)))
    moved = {n: not torch.equal(p.detach(), before[n])
             for n, p in model.named_parameters()}
    assert not any(moved[n] for n, k in kinds.items() if k == "bias")
    frozen = [n for n, k in kinds.items() if k == "norm"
              and n.startswith(("backbone.stem_", "backbone.layer1_"))]
    assert frozen and not any(moved[n] for n in frozen)
    assert all(moved[n] for n, k in kinds.items() if k == "weight")


# ---------------------------------------------------------------------
# run_inference and the scoring script against the reference
# ---------------------------------------------------------------------

def _stack(results):
    return {k: torch.from_numpy(np.stack([np.asarray(r[k]) for r in results]))
            for k in ("boxes", "rboxes", "scores", "labels", "valid")}


def test_run_inference_matches_reference(tmp_path):
    ann, prefix, _ = chip_smoke.write_patch_set(str(tmp_path), 0, 4, 256, 12,
                                                seed=3)
    cfg = dict(type="DOTADataset", ann_file=ann, img_prefix=prefix,
               test_mode=True)
    jm = _build_flagship(256, small=True)
    v = perturb_norms(jax.jit(jm.init)(jax.random.PRNGKey(0),
                                       jnp.zeros((1, 256, 256, 3))), 0)
    want, want_names = ref_run_inference(jm, v, ref_build_dataset(cfg),
                                         batch_size=3)
    model = build_flagship(256, small=True, device="cpu")
    model.load_state_dict(flax_to_state_dict(v)[0], strict=True)
    done = []
    got, names = run_inference(model, build_dataset(cfg), batch_size=3,
                               progress=lambda n, total: done.append(
                                   (n, total)))
    assert names == want_names and len(got) == 4 and done == [(3, 4), (4, 4)]
    assert got[0]["labels"].dtype == np.int64
    errs = chip_smoke.match_detections(_stack(got), _stack(want),
                                       FLAGSHIP_LIMITS)
    assert errs["unpaired"] == 0 and int(_stack(got)["valid"].sum()) > 0
    # over a data mesh of two ranks the global batch must divide in two
    with pytest.raises(ValueError, match="divisible by the data-mesh"):
        run_inference(model, build_dataset(cfg), batch_size=3,
                      mesh=Mesh(2, 0))


def _jittered_results(path, seed=0, k=40):
    """Per-patch results of the val set: its gt pointobbs jittered, as
    padded thetaobb rboxes with int64 labels, random scores."""
    from aidet_tpu_torch.data.np_rboxes import pointobb2thetaobb
    ds = build_dataset(dict(type="DOTADataset",
                            ann_file=os.path.join(REPO, "data", "dota",
                                                  "val_patches.json"),
                            img_prefix="", test_mode=True))
    rs = np.random.RandomState(seed)
    results, names = [], []
    for i in range(len(ds)):
        anns = ds.parse_anns(i)
        n = min(k, len(anns["pointobbs"]))
        q = anns["pointobbs"][:n] + rs.normal(0, 2.0, (n, 8))
        rboxes = np.zeros((k, 5), np.float32)
        rboxes[:n] = pointobb2thetaobb(q.astype(np.float32))
        boxes = np.zeros((k, 4), np.float32)
        boxes[:n] = anns["bboxes"][:n] + rs.normal(0, 2.0, (n, 4))
        labels = np.zeros(k, np.int64)
        labels[:n] = anns["labels"][:n] - 1
        labels[:n:7] = rs.randint(0, 15, len(labels[:n:7]))
        results.append(dict(boxes=boxes, rboxes=rboxes,
                            scores=rs.uniform(0, 1, k).astype(np.float32),
                            labels=labels, valid=np.arange(k) < n))
        names.append(ds.img_infos[i]["file_name"])
    with open(path, "wb") as f:
        pickle.dump(dict(results=results, names=names), f)


@pytest.mark.parametrize("task", ["obb", "hbb"])
def test_torch_dota_eval_equals_reference_script(tmp_path, monkeypatch,
                                                 task, capsys):
    import aidet_tpu.core.eval.dota as ref_dota
    import aidet_tpu_torch.core.eval.dota as port_dota
    pkl = str(tmp_path / "results.pkl")
    _jittered_results(pkl)
    gt = os.path.join(REPO, "data", "dota",
                      f"val_patches_scene_gt_{task}.json")
    maps = {}
    for name, module in (("dota_eval", ref_dota),
                         ("torch_dota_eval", port_dota)):
        inner = module.dota_eval

        def record(*args, _inner=inner, _name=name, **kwargs):
            maps[_name] = _inner(*args, **kwargs)
            return maps[_name]
        monkeypatch.setattr(module, "dota_eval", record)
        monkeypatch.setattr(sys, "argv", [name, pkl, "--gt-json", gt,
                                          "--task", task])
        _tool(name).main()
    (got, got_aps), (want, want_aps) = (maps["torch_dota_eval"],
                                        maps["dota_eval"])
    assert 0.05 < want < 1 and abs(got - want) <= 1e-6
    assert got_aps.keys() == want_aps.keys()
    assert "mAP" in capsys.readouterr().out
