"""The port's data parallelism (`aidet_tpu_torch/parallel/dist.py`,
`mesh.py`, the data-parallel `make_train_step`, the sharded
`run_inference`) on the CPU: two ranks in two processes over gloo
(`tests/torch_port_dist_worker.py`, spawned once per group of jobs, each
with a 120 s limit and its own ``file://`` rendezvous under the test's
temporary directory), held against the reference and against the
port's one-process run.

- `gather_results` against the reference's on the same numpy inputs
  with an injected all-gather (an uneven and an empty shard), and over
  the real gloo all-gather.
- The small flagship's 2-rank step against the reference's
  `make_train_step(mesh=create_mesh(2))` step on the same global batch
  and weights (the conftest's 8 CPU devices), with samplers that keep
  every candidate: the limits of tests/test_torch_port_train_flagship.py
  (each metric within 1e-4 relative, each parameter's update within
  1e-3 of its largest update).
- Each family of `__graft_entry__.dryrun_multichip` (and the tiny
  RBBoxRCNN), and 12 more kinds of the zoo (`worker.ZOO`: the dense
  detectors, SSD300, GA-Faster, Libra, Mask Scoring, HTC): the 2-rank
  step against the port's one-process step on the concatenated batch,
  whose halves hold 6 (the zoo: 4) gts and 1 gt per image, so that the
  ranks count different positives: each metric within 1e-5 relative
  and the update within 1e-5 relative L2 (float32 on one thread on
  both sides; the two runs differ only in the order of the gradient's
  sums, which moved the update by 0.7e-6 to 3.0e-6).  On the same
  batch, the mean of the two halves' one-process losses (each half
  normalised by its own counts, what a rank-local normaliser computes)
  is off the global loss by more than 1e-3 in some loss; with the
  counts left rank-local every case but SSD fails (SSD normalises each
  image by its own positives), with the means rank-local SSD's too.
- The 2-rank `run_inference` (sharded by the group, and over a mesh;
  an empty shard), gathered, equal to the one-process run, and a tiny
  COCO box-only FasterRCNN's bbox mAP (`CocoDataset.evaluate`) equal
  to the one-process run's.
- `build_optimizer`'s ``paramwise_options`` against the reference's
  optax chain, and `param_kinds` against the reference's
  `_param_kinds` through the weight bridge on seven configs.
"""

import inspect
import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chip_smoke
import torch_port_dist_worker as worker
from __graft_entry__ import _build_flagship
from aidet_tpu.parallel import create_mesh as j_create_mesh
from aidet_tpu.parallel import gather_results as j_gather_results
from aidet_tpu.parallel import replicate as j_replicate
from aidet_tpu.parallel import shard_batch as j_shard_batch
from aidet_tpu.parallel import train as j_train

from aidet_tpu_torch.apis.test import run_inference
from aidet_tpu_torch.apis.train import step_seed
from aidet_tpu_torch.convert import flax_to_state_dict
from aidet_tpu_torch.data.builder import build_dataset
from aidet_tpu_torch.flagship import build_flagship, keep_every_candidate_cfg
from aidet_tpu_torch.models.builder import build_detector
from aidet_tpu_torch.parallel import dist, mesh as t_mesh, train
from torch_port_helpers import perturb_norms, to_np
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)
from torch_port_pairs import reference_tree

WORKER_LIMIT_S = 120
IMG, G, MAX_NUM = 128, 4, 64
FLAGSHIP_CFG = keep_every_candidate_cfg(IMG, G, MAX_NUM)
# the 2-rank step against the one-process step on the same batch
FAMILY_REL = 1e-5


def run_ranks(jobs, root, world=2):
    """Run ``jobs`` on ``world`` worker processes; returns each rank's
    results.  A worker that fails or outlives `WORKER_LIMIT_S` fails the
    test (the others are killed)."""
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, "jobs.pt")
    torch.save(jobs, path)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([chip_smoke.__file__.rsplit(
                   os.sep, 1)[0], os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen(
        [sys.executable, worker.__file__, path, str(r), str(world),
         os.path.join(root, "store"), root], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    deadline = time.monotonic() + WORKER_LIMIT_S
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(deadline - time.monotonic(),
                                               1))
            logs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log[-4000:]}"
    return [torch.load(os.path.join(root, f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]


def flagship_batch(seed=0, b=4):
    """A seeded global batch of the small flagship: the first half's
    images hold G gts, the second half's one."""
    rs = np.random.RandomState(seed)
    xy = rs.uniform(8, IMG - 60, (b, G, 2))
    wh = rs.uniform(12, 50, (b, G, 2))
    theta = rs.uniform(-1.5, -0.01, (b, G, 1))
    valid = np.zeros((b, G), bool)
    valid[:b // 2] = True
    valid[b // 2:, 0] = True
    f32 = np.float32
    return dict(
        imgs=rs.randint(0, 256, (b, IMG, IMG, 3)).astype(np.uint8),
        gt_boxes=np.concatenate([xy, xy + wh], -1).astype(f32),
        gt_rboxes=np.concatenate([xy + wh / 2, wh, theta], -1).astype(f32),
        gt_valid=valid,
        gt_labels=rs.randint(1, 16, (b, G)).astype(np.int32),
        img_shapes=np.tile([[IMG, IMG]], (b, 1)).astype(f32))


@pytest.fixture(scope="module")
def flagship_pair():
    jm = _build_flagship(IMG, small=True)
    jm = jm.clone(train_cfg=dict(
        FLAGSHIP_CFG, rpn_proposal=dict(nms_pre=128, nms_post=MAX_NUM,
                                        max_num=MAX_NUM)))
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)))
    v = perturb_norms(v, 5)
    sd, unmapped = flax_to_state_dict(v)
    assert not unmapped
    return jm, v, sd


# the zoo kinds of the second worker run: SSD300 and the two-stage ones
# (the first run takes the dense detectors at 128^2), so that each run
# stays near 25 s alone
ZOO_SECOND = ("ssd", "ga_faster", "libra", "ms", "htc")
STEP_NAMES = list(worker.FAMILIES) + list(worker.ZOO)


@pytest.fixture(scope="module")
def step_runs(flagship_pair, tmp_path_factory):
    """Two worker runs of the step jobs: the small flagship from the
    reference's weights, each family and each zoo kind from the port's
    seeded weights, and the gloo gather.  Returns (jobs by name, each
    rank's results)."""
    _, _, sd = flagship_pair
    jobs = [dict(name="flagship", kind="step", flagship=True, img=IMG,
                 train_cfg=FLAGSHIP_CFG, state_dict=sd,
                 batch=flagship_batch())]
    for name in STEP_NAMES:
        jobs.append(dict(name=name, kind="step", family=name,
                         state_dict=worker.build_family(name).state_dict(),
                         batch=worker.family_batch(name)))
    jobs.append(dict(name="gather", kind="gather"))
    root = str(tmp_path_factory.mktemp("steps"))
    first = run_ranks([j for j in jobs if j["name"] not in ZOO_SECOND],
                      os.path.join(root, "first"))
    second = run_ranks([j for j in jobs if j["name"] in ZOO_SECOND],
                       os.path.join(root, "second"))
    return ({j["name"]: j for j in jobs},
            [dict(a, **b) for a, b in zip(first, second)])


# ---------------------------------------------------------------------
# gather_results
# ---------------------------------------------------------------------

def _result(i):
    return dict(boxes=np.full((3, 4), float(i), np.float32),
                scores=np.full((3,), float(i), np.float32),
                valid=np.arange(3) < i % 3)


def _injected(shards):
    """An all-gather over simulated processes: the arrays that the
    processes of ``shards`` (shard id -> results) would contribute,
    stacked, keyed by the order the keys are gathered in."""
    calls = []

    def allgather(arr):
        key = sorted(_result(0))[len(calls) % 3]
        calls.append(key)
        rows = []
        for s in sorted(shards):
            if not shards[s]:
                part = np.zeros((0,) + arr.shape[1:], arr.dtype)
            else:
                part = np.stack([np.asarray(r[key]) for r in shards[s]])
            pad = np.zeros((arr.shape[0] - len(part),) + arr.shape[1:],
                           arr.dtype)
            rows.append(np.concatenate([part, pad]))
        return np.stack(rows)
    return allgather


@pytest.mark.parametrize("total,num_shards", [(5, 2), (7, 3), (1, 2)])
def test_gather_results_matches_reference(total, num_shards):
    """Uneven shards ((5, 2): [0, 2, 4] and [1, 3]), three shards, and
    an empty shard (1 image over 2 processes, with the example spec)."""
    shards = {s: [_result(i) for i in range(s, total, num_shards)]
              for s in range(num_shards)}
    example = {k: np.zeros_like(v) for k, v in _result(0).items()}
    for s in range(num_shards):
        got = dist.gather_results(shards[s], num_shards, s, total,
                                  allgather=_injected(shards),
                                  example=example)
        ref = j_gather_results(shards[s], num_shards, s, total,
                               allgather=_injected(shards),
                               example=example)
        assert len(got) == len(ref) == total
        for i, (g, r) in enumerate(zip(got, ref)):
            assert set(g) == set(r)
            for k in r:
                np.testing.assert_array_equal(g[k], r[k], err_msg=(s, i, k))
                np.testing.assert_array_equal(g[k], _result(i)[k])


def test_gather_results_empty_shard_needs_the_example():
    with pytest.raises(ValueError, match="example"):
        dist.gather_results([], 2, 1, 1, allgather=lambda a: a)
    one = [_result(0)]
    assert dist.gather_results(one, 1, 0, 1) is one


def test_gather_results_over_gloo(step_runs):
    _, ranks = step_runs
    for r, res in enumerate(ranks):
        uneven, empty = res["gather"]["uneven"], res["gather"]["empty"]
        assert len(uneven) == 5 and len(empty) == 1, r
        for i, got in enumerate(uneven):
            for k, want in _result(i).items():
                np.testing.assert_array_equal(got[k], want, err_msg=(r, i))
                assert got[k].dtype == want.dtype
        for k, want in _result(0).items():
            np.testing.assert_array_equal(empty[0][k], want)


# ---------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference_mesh_step(flagship_pair):
    """The reference's step over a 2-device data mesh on the global
    batch: (metrics, parameters after, in the port's names)."""
    jm, v, _ = flagship_pair
    mesh = j_create_mesh(2)
    optimizer = j_train.build_optimizer(
        j_train.build_lr_schedule(0.02, warmup_iters=10))
    state = j_replicate(j_train.TrainState(
        step=jnp.zeros((), jnp.int32), params=v["params"],
        batch_stats=v["batch_stats"],
        opt_state=optimizer.init(v["params"])), mesh)
    step = j_train.make_train_step(jm, optimizer, mesh=mesh, donate=False)
    batch = j_shard_batch({k: jnp.asarray(x) for k, x in
                           flagship_batch().items()}, mesh)
    state, metrics = step(state, batch, jax.random.PRNGKey(2))
    after, _ = flax_to_state_dict({"params": state.params})
    return {k: float(x) for k, x in metrics.items()}, after


def test_flagship_two_rank_step_metrics_match_reference_mesh_step(
        step_runs, reference_mesh_step):
    _, ranks = step_runs
    ref, _ = reference_mesh_step
    for r in range(2):
        got = ranks[r]["flagship"]["metrics"]
        assert set(got) == set(ref)
        for k in ref:
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=1e-7,
                                       err_msg=(r, k))
    assert ref["grad_norm"] > 35        # the clip is exercised


def test_flagship_two_rank_update_matches_reference_mesh_step(
        step_runs, reference_mesh_step, flagship_pair):
    _, ranks = step_runs
    _, ref_after = reference_mesh_step
    sd = flagship_pair[2]
    names = [n for n, _ in build_flagship(IMG, small=True, device="cpu",
                                         train=True).named_parameters()]
    assert set(names) == set(ref_after)
    for name, after in zip(names, ranks[0]["flagship"]["params"]):
        before = np.asarray(sd[name])
        d = to_np(after) - before
        d_ref = np.asarray(ref_after[name]) - before
        scale = max(float(np.abs(d_ref).max()), 1e-12)
        np.testing.assert_allclose(d / scale, d_ref / scale, atol=1e-3,
                                   rtol=0, err_msg=name)


def _rel_l2(got, ref):
    num = sum(float((g - r).double().square().sum())
              for g, r in zip(got, ref))
    den = sum(float(r.double().square().sum()) for r in ref)
    return (num / den) ** 0.5


@pytest.fixture(scope="module")
def one_process_steps(step_runs):
    """Each family's one-process step on the whole global batch, from
    the same weights."""
    jobs, _ = step_runs
    out = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)        # as the workers: one order of sums
    try:
        _one_process_steps(jobs, out)
    finally:
        torch.set_num_threads(threads)
    return out


def _one_process_steps(jobs, out):
    for name in STEP_NAMES:
        model = worker.build_family(name)
        model.load_state_dict(jobs[name]["state_dict"])
        before = [p.detach().clone() for p in model.parameters()]
        metrics, after = worker.one_step(
            model, jobs[name]["batch"],
            torch.Generator().manual_seed(step_seed(0, 0)))
        out[name] = dict(metrics=metrics, before=before, after=after)


@pytest.mark.parametrize("name", STEP_NAMES)
def test_two_rank_step_equals_one_process_step(name, step_runs,
                                               one_process_steps):
    _, ranks = step_runs
    ref = one_process_steps[name]
    for r in range(2):
        got = ranks[r][name]["metrics"]
        assert set(got) == set(ref["metrics"])
        for k, want in ref["metrics"].items():
            assert abs(got[k] - want) <= FAMILY_REL * abs(want), (r, k, got[k],
                                                                  want)
    d = [a - b for a, b in zip(ranks[0][name]["params"], ref["before"])]
    d_ref = [a - b for a, b in zip(ref["after"], ref["before"])]
    assert _rel_l2(d, d_ref) <= FAMILY_REL
    assert any(float(x.abs().max()) > 0 for x in d_ref)


@pytest.mark.parametrize("name", [n for n in STEP_NAMES if n != "ssd"])
def test_rank_local_normalisers_would_differ(name, step_runs):
    """The batch discriminates: the mean over the two halves of each
    half's own losses (rank-local normalisers, averaged) is off the
    global batch's losses by more than 1e-3 in some loss.  (SSD
    normalises each image by its own positives and averages the images,
    as the reference does: there the two agree.)"""
    jobs, _ = step_runs
    model = worker.build_family(name)
    model.load_state_dict(jobs[name]["state_dict"])
    batch = worker.tensors(jobs[name]["batch"])
    gen = torch.Generator().manual_seed(0)
    n = len(jobs[name]["batch"]["imgs"])
    takes = set(inspect.signature(model.loss).parameters)
    with torch.no_grad():
        def losses(rows):
            return {k: float(v) for k, v in model.loss(**{
                k: v[rows] for k, v in batch.items() if k in takes},
                generator=gen).items()}
        whole = losses(slice(0, n))
        halves = [losses(slice(0, n // 2)), losses(slice(n // 2, n))]
    off = max(abs((halves[0][k] + halves[1][k]) / 2 - whole[k])
              / max(abs(whole[k]), 1e-6) for k in whole)
    assert off > 1e-3, off


def test_ranks_start_and_end_with_the_same_parameters(step_runs):
    """Rank 1 starts from perturbed weights: `replicate` broadcasts rank
    0's, so both ranks report the same metrics (from the all-reduce) and
    rank 0's update is the one-process one (above)."""
    _, ranks = step_runs
    for name in ["flagship", *STEP_NAMES]:
        assert ranks[0][name]["metrics"] == ranks[1][name]["metrics"], name


def test_global_normalisers_are_local_outside_a_data_parallel_step():
    x = torch.arange(6.0).reshape(2, 3)
    assert dist.global_count(x) is x
    torch.testing.assert_close(dist.global_mean(x), x.mean(), rtol=0, atol=0)
    with dist.global_losses():
        assert dist.global_count(x) is x


def test_step_seeds_by_rank():
    """Rank 0's sampling seed is the one-process run's (so a resumed
    run draws as before); the ranks' seeds, and their first draws,
    differ."""
    legacy = np.random.SeedSequence([7, 1, 3]).generate_state(2)
    assert step_seed(7, 3) == step_seed(7, 3, 0) == (
        int(legacy[0]) << 32) | int(legacy[1])
    seeds = {step_seed(7, s, r) for s in range(4) for r in range(4)}
    assert len(seeds) == 16
    draws = [torch.rand(8, generator=torch.Generator().manual_seed(
        step_seed(7, 3, r))) for r in range(2)]
    assert not torch.equal(*draws)


def test_mesh_of_one_process():
    assert dist.init_distributed(device="cpu") == (0, 1)
    assert dist.world_size() == 1 and dist.is_main_process()
    m = t_mesh.create_mesh()
    assert (m.size, m.rank) == (1, 0)
    with pytest.raises(ValueError, match="world size 1"):
        t_mesh.create_mesh(2)
    batch = dict(x=torch.arange(8).reshape(4, 2), s=torch.tensor(1.0))
    assert t_mesh.shard_batch(batch, m)["x"].shape == (4, 2)
    two = t_mesh.Mesh(2, 1)
    half = t_mesh.shard_batch(batch, two)
    assert half["x"].tolist() == [[4, 5], [6, 7]] and half["s"] == 1.0
    assert list(dist.global_rows(2, 1, 2)) == [2, 3]
    with pytest.raises(ValueError, match="global batch of 3"):
        t_mesh.shard_batch(dict(x=torch.zeros(3)), two)
    assert t_mesh.replicate([torch.ones(2)], m)[0].tolist() == [1.0, 1.0]


# ---------------------------------------------------------------------
# paramwise_options
# ---------------------------------------------------------------------

PARAMWISE = dict(bias_lr_mult=2.0, bias_decay_mult=0.5, norm_decay_mult=3.0)
# a weight decay at which each kind's decay is a tenth of its update or
# more, so that a multiplier applied to the wrong kind shows
PARAMWISE_DECAY = 0.05


def _reference_updates(v, grads, paramwise):
    """The reference's chain over ``grads`` from ``v``'s parameters: the
    parameters after, in the port's names."""
    tx = j_train.build_optimizer(
        j_train.build_lr_schedule(0.02, warmup_iters=10),
        weight_decay=PARAMWISE_DECAY, paramwise_options=paramwise)
    params = v["params"]
    opt_state = tx.init(params)
    for g in grads:
        updates, opt_state = tx.update(g, opt_state, params)
        params = optax.apply_updates(params, updates)
    return flax_to_state_dict({"params": params})[0]


def test_paramwise_update_matches_reference_chain(flagship_pair):
    """Two updates of the port's SGD with every multiplier set apart
    from 1 against the reference's optax chain on the same parameters
    and seeded gradients (clipped: their norm is far above 35): each
    parameter's update within 1e-3 of its largest, where the
    multipliers move every kind's update by more than 1e-2 of it."""
    _, v, sd = flagship_pair
    rs = np.random.RandomState(3)
    grads = [jax.tree.map(lambda x: rs.randn(*x.shape).astype(np.float32),
                          v["params"]) for _ in range(2)]
    ref = _reference_updates(v, grads, PARAMWISE)
    plain = _reference_updates(v, grads, None)

    model = build_flagship(IMG, small=True, device="cpu", train=True)
    model.load_state_dict(sd, strict=True)
    names = [n for n, _ in model.named_parameters()]
    opt = train.build_optimizer(
        train.build_lr_schedule(0.02, warmup_iters=10),
        weight_decay=PARAMWISE_DECAY, paramwise_options=PARAMWISE)
    kinds = train.param_kinds(model)
    plist = list(model.parameters())
    trace = opt.init(plist)
    groups = opt.groups(kinds)
    for i, g in enumerate(grads):
        gsd, _ = flax_to_state_dict({"params": g})
        opt.update(plist, [torch.as_tensor(np.asarray(gsd[n])).clone()
                           for n in names], trace, i, groups=groups)
    moved = dict.fromkeys(("weight", "bias", "norm"), 0.0)
    for n, p, k in zip(names, plist, kinds):
        before = np.asarray(sd[n])
        d_ref = np.asarray(ref[n]) - before
        scale = max(float(np.abs(d_ref).max()), 1e-12)
        np.testing.assert_allclose((to_np(p) - before) / scale,
                                   d_ref / scale, atol=1e-3, rtol=0,
                                   err_msg=n)
        off = np.abs(np.asarray(plain[n]) - np.asarray(ref[n])).max()
        moved[k] = max(moved[k], float(off) / scale)
    assert moved["weight"] == 0.0
    assert moved["bias"] > 1e-2 and moved["norm"] > 1e-2, moved
    with pytest.raises(ValueError, match="groups"):
        opt.update(plist, [torch.zeros_like(p) for p in plist], trace, 2)


KIND_CONFIGS = ["configs/dota_theta_obb_r50_fpn_1x.py",
                "configs/fcos_r50_fpn_1x.py",
                "configs/retinanet_sepbn_r50_fpn_1x.py",
                "configs/grid_rcnn_r50_fpn_2x.py",
                "configs/faster_rcnn_attention_1111_dcn_r50_fpn_1x.py",
                "configs/mask_rcnn_r16_gcb_c3-c5_r50_fpn_1x.py",
                "configs/dota_theta_obb_r18_e2e.py"]
KIND_CODES = dict(weight=1.0, bias=2.0, norm=3.0)


@pytest.mark.parametrize("path", KIND_CONFIGS)
def test_param_kinds_match_reference(path):
    """`param_kinds` of the port's build against the reference's
    `_param_kinds` on the same config: each reference leaf filled with
    its kind's code and carried over by the weight bridge."""
    from aidet_tpu_torch.utils.config import Config
    tree = reference_tree(path)
    ref_kinds = j_train._param_kinds(tree["params"])
    codes = dict(tree, params=jax.tree.map(
        lambda s, k: np.full(s.shape, KIND_CODES[k], np.float32),
        tree["params"], ref_kinds))
    codes = {c: (t if c == "params" else jax.tree.map(
        lambda s: np.zeros(s.shape, np.float32), t))
        for c, t in codes.items()}
    cfg = Config.fromfile(os.path.join(chip_smoke.__file__.rsplit(
        os.sep, 1)[0], path))
    model = build_detector(dict(cfg.model), train_cfg=cfg.get("train_cfg"),
                           test_cfg=cfg.get("test_cfg"), device="cpu")
    sd, unmapped = flax_to_state_dict(codes, model)
    assert not unmapped
    names = [n for n, _ in model.named_parameters()]
    got = dict(zip(names, train.param_kinds(model)))
    by_code = {c: k for k, c in KIND_CODES.items()}
    for n in names:
        vals = np.unique(np.asarray(sd[n]))
        assert len(vals) == 1, n
        assert got[n] == by_code[float(vals[0])], (n, got[n])
    assert len(set(got.values())) >= 2


# ---------------------------------------------------------------------
# run_inference and the COCO bbox eval
# ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def infer_runs(flagship_pair, tmp_path_factory):
    """One worker run of the inference jobs: the small flagship (at 128^2)
    over 5 seeded 256^2 DOTA patches (batch 2 by the group; batch 4 over
    a mesh), and
    over 1 patch (rank 1's shard empty); a tiny COCO FasterRCNN over 5
    patches of a COCO json.  Returns (jobs by name, each rank's
    results)."""
    root = str(tmp_path_factory.mktemp("infer"))
    ann, prefix, _ = chip_smoke.write_patch_set(root, 0, 5, 256, 6, seed=3)
    one, one_prefix, _ = chip_smoke.write_patch_set(
        os.path.join(root, "one"), 9, 1, 256, 6, seed=3)
    dota = dict(type="DOTADataset", ann_file=ann, img_prefix=prefix,
                test_mode=True)
    coco = dict(type="CocoDataset", ann_file=ann, img_prefix=prefix,
                test_mode=True)
    sd = flagship_pair[2]
    flag = dict(kind="infer", flagship=True, img=IMG, train_cfg=None,
                state_dict=sd)
    faster = build_detector(coco_cfg(), device="cpu", seed=1)
    jobs = [dict(flag, name="dota", dataset=dota, batch_size=2),
            dict(flag, name="dota_mesh", dataset=dota, batch_size=4,
                 mesh=True),
            dict(flag, name="dota_one", dataset=dict(
                dota, ann_file=one, img_prefix=one_prefix), batch_size=2),
            dict(name="coco", kind="infer", cfg=coco_cfg(),
                 state_dict=faster.state_dict(), dataset=coco,
                 batch_size=2)]
    ranks = run_ranks(jobs, os.path.join(root, "ranks"))
    return {j["name"]: j for j in jobs}, ranks


def coco_cfg():
    """The tiny box-only FasterRCNN: 15 classes and the background, as
    the COCO json's."""
    return dict(worker.FAMILIES["FasterRCNN"],
                test_cfg=dict(rpn=dict(nms_pre=128, nms_post=64, max_num=64),
                              rcnn=dict(max_per_img=32)))


# the gathered detections against the one-process run's, paired by
# `chip_smoke.match_detections` (the loop phase's limits: batches of
# other images round the crops' sums otherwise)
INFER_LIMITS = dict(boxes=1e-3, rboxes=1e-3, theta=1e-4, scores=1e-5)


def _one_process(job):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)        # as the workers
    try:
        return run_inference(worker.build_job_model(job),
                             build_dataset(job["dataset"]),
                             batch_size=job["batch_size"])
    finally:
        torch.set_num_threads(threads)


def _assert_same_results(got, want):
    assert len(got) == len(want)
    assert all(set(g) == set(w) for g, w in zip(got, want))

    def stack(results):
        return {k: torch.from_numpy(np.stack([np.asarray(r[k])
                                              for r in results]))
                for k in results[0]}
    limits = {k: v for k, v in INFER_LIMITS.items()
              if k in ("boxes", "scores") or "rboxes" in want[0]}
    errs = chip_smoke.match_detections(stack(got), stack(want), limits)
    assert errs["unpaired"] == 0, errs


@pytest.mark.parametrize("name", ["dota", "dota_mesh", "dota_one"])
def test_two_rank_run_inference_equals_one_process(name, infer_runs):
    jobs, ranks = infer_runs
    want, want_names = _one_process(jobs[name])
    n = len(want)
    assert int(sum(np.asarray(r["valid"]).sum() for r in want)) > 0
    for r in range(2):
        got = ranks[r][name]
        assert got["names"] == want_names
        _assert_same_results(got["results"], want)
    # each rank's progress counts its own shard
    if name == "dota":
        assert ranks[0][name]["progress"] == [(2, 3), (3, 3)]
        assert ranks[1][name]["progress"] == [(2, 2)]
    if name == "dota_one":
        assert n == 1 and ranks[1][name]["progress"] == []


def _annotate(dataset, results, path, k=3):
    """A COCO json of ``dataset``'s images whose objects are each
    image's ``k`` best valid detections of ``results`` (random weights
    find none of the synthetic objects, so this gives the bbox eval
    something to find)."""
    anns = []
    for info, r in zip(dataset.img_infos, results):
        top = np.argsort(-np.where(r["valid"], r["scores"], -1.0))[:k]
        for i in top[np.asarray(r["valid"])[top]]:
            x1, y1, x2, y2 = (float(v) for v in r["boxes"][i])
            w, h = x2 - x1 + 1, y2 - y1 + 1
            if w >= 1 and h >= 1:
                anns.append(dict(id=len(anns) + 1, image_id=info["id"],
                                 category_id=int(r["labels"][i]) + 1,
                                 bbox=[x1, y1, w, h], area=w * h,
                                 iscrowd=0))
    with open(path, "w") as f:
        json.dump(dict(images=dataset.img_infos, annotations=anns,
                       categories=[dict(id=i + 1, name=c) for i, c in
                                   enumerate(dataset.CLASSES)]), f)
    return len(anns)


def test_two_rank_coco_bbox_map_equals_one_process(infer_runs, tmp_path):
    """The tiny COCO FasterRCNN's gathered results score the bbox mAP
    of the one-process run's, on the patches' own json (where random
    weights score 0) and on a json whose objects are the one-process
    run's best detections."""
    jobs, ranks = infer_runs
    want, _ = _one_process(jobs["coco"])
    dataset = build_dataset(jobs["coco"]["dataset"])
    found = str(tmp_path / "found.json")
    assert _annotate(dataset, want, found) >= 10
    scored = build_dataset(dict(jobs["coco"]["dataset"], ann_file=found))
    refs = [dataset.evaluate(want), scored.evaluate(want)]
    assert refs[1]["mAP"] > 0.5, refs
    for r in range(2):
        got = ranks[r]["coco"]["results"]
        _assert_same_results(got, want)
        assert [dataset.evaluate(got), scored.evaluate(got)] == refs


def test_run_inference_mesh_batch_must_divide():
    m = t_mesh.Mesh(2, 0)
    with pytest.raises(ValueError, match="divisible"):
        run_inference(None, None, batch_size=3, mesh=m)
